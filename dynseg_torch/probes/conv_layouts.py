"""In which memory layout should each float conv of the nets reach cuDNN?

    python -m dynseg_torch.probes.conv_layouts [--sizes 25,65]
        [--dtypes float32] [--only PREFIXES] [--out FILE]

Times the forward, the input gradient (dgrad) and the weight gradient
(wgrad) of every conv of the five nets at full width (`shapes()`: each
block and head of the four sequential nets and of
dilated_icpr_rate6_densely), and of a grid of 3x3 convs at Cin 512, 576,
643 and 704 over dilations 1-8 (Cout 256), in two layouts: channels_last
(input, kernel and gradient, as the nets hold them) and NCHW (all
contiguous). cuDNN is set as the Trainer sets it: TF32 off, the
deterministic algorithms, no benchmark search. The batch is the training
mixes' 100. Each time is the mean of 5 calls between CUDA events after
one warm-up call, or one call where that takes over 100 ms. Beside them, `net` is the forward and
backward as the nets run it: `models.blocks.conv` on a channels_last
input in the layout `models.blocks.routes_nchw` picks, layout copies
included; and `kernel` names the forward's longest kernel in each layout.
The padding is SAME's, symmetric (an even kernel at an odd dilation
loses one output pixel a side, which the operations count).

Prints the card's name and power limit, then one line per shape, size
and dtype: ms and TFLOP/s of each pass in each layout, the route and the
`net` time; the last line is a JSON object with the same. Needs a CUDA
card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dynseg_torch.models.blocks import conv, routes_nchw
from dynseg_torch.models.dilated import _ARCH
from dynseg_torch.probes.int8_kernel_probe import card

BANDS, CLASSES = 3, 6
BATCH, REPS = 100, 5
GRID_CIN = (512, 576, 643, 704)
GRID_DILATIONS = tuple(range(1, 9))
LAYOUTS = {"channels_last": torch.channels_last, "nchw": torch.contiguous_format}
PASSES = ("fwd", "dgrad", "wgrad")
# (what, Cin, Cout, kernel, dilation)
Shape = Tuple[str, int, int, int, int]


def shapes() -> List[Shape]:
    """Every conv of the five nets at full width, then the 3x3 grid, each
    (Cin, Cout, k, d) once, under the first name that has it."""
    out: List[Shape] = []
    for net, arch in _ARCH.items():
        cin = BANDS
        for i, (k, feats, dil, _) in enumerate(arch):
            out.append((f"{net}.{i}", cin, feats, k, dil))
            cin = feats
        out.append((f"{net}.head", cin, CLASSES, 1, 1))
    total = BANDS
    for i, (k, feats, dil, _) in enumerate(_ARCH["dilated_icpr_rate6"]):
        out.append((f"densely.{i}", total, feats, k, dil))
        total += feats
    out.append(("densely.head", total - BANDS, CLASSES, 1, 1))
    out += [(f"grid.{cin}.d{d}", cin, 256, 3, d) for cin in GRID_CIN for d in GRID_DILATIONS]
    seen, unique = set(), []
    for s in out:
        if s[1:] not in seen:
            seen.add(s[1:])
            unique.append(s)
    return unique


def _time_ms(fn: Callable[[], object]) -> float:
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    first = start.elapsed_time(end)
    if first > 100.0:
        return first
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def _longest_kernel(fn: Callable[[], object]) -> str:
    from torch.autograd import DeviceType

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return "?"
    return max(kernels, key=lambda e: e.device_time_total).name[:60]


def measure(shape: Shape, size: int, dtype: torch.dtype) -> dict:
    """One shape at BATCH x size^2 in `dtype`: ms of each pass in each
    layout, the forward's longest kernel in each, and the `net` time."""
    what, cin, cout, k, dil = shape
    batch = BATCH
    pad = dil * (k - 1) // 2
    gen = torch.Generator("cuda").manual_seed(cin * 1000 + cout + k + dil)
    x0 = torch.randn(batch, cin, size, size, device="cuda", generator=gen).to(dtype)
    w0 = (torch.randn(cout, cin, k, k, device="cuda", generator=gen)
          / (k * k * cin) ** 0.5).to(dtype)
    hw = size + 2 * pad - dil * (k - 1)
    g0 = torch.randn(batch, cout, hw, hw, device="cuda", generator=gen).to(dtype)
    row = {"what": what, "cin": cin, "cout": cout, "k": k, "d": dil, "batch": batch,
           "size": size, "dtype": str(dtype)[6:],
           "route": "nchw" if routes_nchw(cin, k, dil, dtype) else "channels_last"}
    for name, fmt in LAYOUTS.items():
        x, w, g = (t.contiguous(memory_format=fmt) for t in (x0, w0, g0))

        def backward(mask):
            return lambda: torch.ops.aten.convolution_backward(
                g, x, w, None, (1, 1), (pad, pad), (dil, dil), False, (0, 0), 1, mask)

        fns = {"fwd": lambda: F.conv2d(x, w, None, 1, pad, dil),
               "dgrad": backward((True, False, False)),
               "wgrad": backward((False, True, False))}
        for p in PASSES:
            row[f"{name}.{p}"] = _time_ms(fns[p])
        row[f"{name}.kernel"] = _longest_kernel(fns["fwd"])
        del x, w, g
    layer = nn.Conv2d(cin, cout, k, padding="same", dilation=dil, bias=False, device="cuda",
                      dtype=dtype).to(memory_format=torch.channels_last)
    xl = x0.contiguous(memory_format=torch.channels_last).requires_grad_(True)
    gl = torch.randn(batch, cout, size, size, device="cuda", generator=gen,
                     dtype=dtype).contiguous(memory_format=torch.channels_last)
    nchw = row["route"] == "nchw"
    row["net"] = _time_ms(lambda: conv(layer, xl, nchw).backward(gl))
    flop = 2.0 * batch * hw * hw * cout * cin * k * k
    for key in list(row):
        if key.endswith(PASSES):
            row[key.replace(".", ".tflops_", 1)] = flop / (row[key] * 1e9)
    return row


def _line(r: dict) -> str:
    cols = " ".join(f"{lay[:4]}.{p} {r[f'{lay}.{p}']:.3f} ({r[f'{lay}.tflops_{p}']:.1f})"
                    for lay in LAYOUTS for p in PASSES)
    return (f"{r['what']:>24} {r['cin']:>4}->{r['cout']:<3} k{r['k']} d{r['d']} "
            f"{r['batch']}x{r['size']}^2 {r['dtype']}: {cols}; route {r['route']}, "
            f"net {r['net']:.3f}; kernels {r['channels_last.kernel']} | {r['nchw.kernel']}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dynseg_torch.probes.conv_layouts",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="25,65")
    ap.add_argument("--dtypes", default="float32", help="float32 and/or bfloat16")
    ap.add_argument("--only", default="",
                    help="comma-separated name prefixes: time only those shapes")
    ap.add_argument("--out", default="", help="write the JSON result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("conv_layouts: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    payload = {"card": card(), "torch": torch.__version__, "cuda": torch.version.cuda,
               "cudnn": torch.backends.cudnn.version(), "rows": []}
    print(f"card: {payload['card']}; torch {payload['torch']}, cuDNN {payload['cudnn']}",
          flush=True)
    for dtype in (getattr(torch, d) for d in args.dtypes.split(",")):
        for size in (int(s) for s in args.sizes.split(",")):
            for shape in shapes():
                if shape[0].startswith(tuple(args.only.split(","))):
                    row = measure(shape, size, dtype)
                    payload["rows"].append(row)
                    print(_line(row), flush=True)
    text = json.dumps(payload)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
