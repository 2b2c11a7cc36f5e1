"""How long does each hand-written kernel of the port take on the card,
alone, against the least time the card could take?

    python -m dynseg_torch.probes.kernel_times [--root DIR] [--reps 5]

One row per shape of PERF.md §6's kernel table (`ROWS`): K5 at the three
int8 blocks of a dense batch (8 x 336^2), with the int8 or float32 store
and with the bfloat16 one; K6 at the six pools of a dilated_grsl_rate8
dense batch; K7 at the four concat prefixes of dilated_icpr_rate6_densely's
feature buffer, float32 and bfloat16; K2 at B = 100, s = 25..65 on uint8
tiles; K4 at 100 x {25, 65}^2 x C {64, 128, 256}; P1 at 8 x 592^2 x 256,
dilation 6. Each row times the op by replaying a CUDA graph of 20 calls
`--reps` times between CUDA events (the device time, without the host's
cost per call), and beside it the plain version (CUDA events over eager
calls) and, where the table has a library column, ATen's function at the
same shape (by graph). K2 and K4, whose launches are short enough for the
host's call rate to bound an eager call, also give the eager call's time.

A row's bound is the larger of its operations over the H100 SXM's
published dense peak (int8 on the tensor cores for K5 and P1, float32
outside them for the rest) and its bytes over the memory rate, each input
byte read once and each output byte written once. Correctness is the
tests' (`tests/test_torch_cuda.py`, `-m gpu`): nothing is checked here.

The first lines give the card's name and power limit (`nvidia-smi`) and
the kernel build; each row then gives ms, the bound in ms, what sets it,
and the share of it; the last line is a JSON object with the same.

--root times the `dynseg_torch` package found in DIR (for example a `git
archive` of an earlier commit), so that two versions are timed in one
call on one card; the default is this checkout. Needs a CUDA card; exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
from types import SimpleNamespace
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dynseg_torch.probes import import_from
from dynseg_torch.probes.int8_kernel_probe import PEAK_INT8_TOPS, card

# The H100 SXM's published dense peaks: int8 on the tensor cores, float32
# outside them, and the memory rate (bytes/s).
INT8_PEAK = dict(PEAK_INT8_TOPS)["H100 SXM"] * 1e12
F32_PEAK = 67e12
HBM_RATE = 3.35e12
# A dense batch: 8 blocks of 256 + 2 * 40 halo pixels a side.
DENSE = (8, 336, 336)
# The feature buffer of dilated_icpr_rate6_densely: 13 zero lead channels,
# the 3 bands and six block slots.
K7_LEAD, K7_BUFFER = 13, 912
GRAPH_CALLS = 20

# (op, {what is timed beside it: fn}) of a row, from the package's ops.
Made = Tuple[Callable[[], object], dict]


@dataclasses.dataclass(frozen=True)
class Row:
    """One shape of one kernel: what it needs of the card (`ops`
    operations at `peak`, `nbytes` read and written once) and `make`,
    which builds its inputs on the card from the package's ops."""
    name: str
    ops: float
    nbytes: float
    peak: float
    make: Callable[[SimpleNamespace], Made]
    eager: bool = False

    def bound(self) -> Tuple[float, str]:
        """The least time in ms, and whether operations or bytes set it."""
        t_ops, t_bytes = self.ops / self.peak * 1e3, self.nbytes / HBM_RATE * 1e3
        return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _gen(seed: int) -> torch.Generator:
    return torch.Generator("cuda").manual_seed(seed)


def _codes(shape, mean: float, std: float, gen) -> torch.Tensor:
    """Int8 codes shaped like calibrated activations or weights."""
    return (torch.randn(shape, generator=gen, device="cuda") * std + mean
            ).round_().clamp_(-127, 127).to(torch.int8)


def _k5(name: str, cin: int, cout: int, k: int, dil: int, store: torch.dtype) -> Row:
    """K5 at a dense batch; `store` int8 (requant), float32 or bfloat16."""
    b, h, w = DENSE

    def make(m):
        gen = _gen(cin + cout + k)
        x = _codes((b, h, w, cin), 10, 38, gen)
        a = (torch.rand(cout, generator=gen, device="cuda") + 0.5) / (
            math.sqrt(k * k * cin) * 38 * 35)
        pc = m.int8_conv.pack_conv(
            _codes((k, k, cin, cout), 0, 35, gen), a,
            torch.randn(cout, generator=gen, device="cuda") * 0.1, dilation=dil,
            leaky_slope=0.1, out_scale=3.0 / 127 if store == torch.int8 else None,
            out_dtype=torch.float32 if store == torch.int8 else store)
        return (lambda: m.int8_conv.int8_block_conv_packed(x, pc),
                {"plain": lambda: m.int8_conv.int8_block_conv_packed_ref(x, pc)})

    px, out = b * h * w, torch.empty((), dtype=store).element_size()
    return Row(f"K5 {name} {cin}->{cout} k{k} d{dil} {str(store)[6:]} out x({b},{h},{w},{cin})",
               2.0 * px * k * k * cin * cout,
               px * cin + k * k * cin * cout + px * cout * out + 8 * cout, INT8_PEAK, make)


def _k6(block: int, c: int, mode: str) -> Row:
    """K6 at block `block`'s pool of a dense batch in `mode`: i8 codes,
    f32, or f32_i8 (f32 in, its quantize fused)."""
    shape = (*DENSE, c)

    def make(m):
        xf = torch.round(torch.randn(shape, device="cuda", generator=_gen(c + len(mode)))
                         * 64) / 16
        sx = torch.tensor(0.0371, device="cuda") if mode == "f32_i8" else None
        x = (m.pool.quantize_act(xf, torch.tensor(0.25, device="cuda")) if mode == "i8"
             else xf)
        xc, xl = x.permute(0, 3, 1, 2), xf.permute(0, 3, 1, 2)
        return (lambda: m.pool.max_pool_fwd(xc, 3, sx),
                {"plain": lambda: m.pool.max_pool_fwd_ref(x, 3, sx),
                 "ATen float32 max_pool2d": lambda: F.max_pool2d(xl, 3, 1, 1)})

    n = math.prod(shape)
    width = {"f32": 4 + 4, "f32_i8": 4 + 1, "i8": 1 + 1}[mode]
    return Row(f"K6 block{block} {mode} x({','.join(map(str, shape))})", 9.0 * n, n * width,
               F32_PEAK, make)


def _k7(c: int, dtype: torch.dtype) -> Row:
    """K7 on the channel prefix c of a dense batch's feature buffer, read
    in place."""
    shape = (*DENSE, K7_BUFFER)

    def make(m):
        sx = torch.tensor(0.0371, device="cuda")
        buf = (torch.round(torch.randn(shape, device="cuda", generator=_gen(c)) * 1024)
               / 128 * sx).to(dtype)
        buf[..., :K7_LEAD] = 0
        fm = buf.permute(0, 3, 1, 2)
        return (lambda: m.pool.quantize_s8(fm[:, :c], sx),
                {"plain": lambda: m.pool.quantize_act(buf[..., :c], sx)})

    n = math.prod(DENSE) * c
    return Row(f"K7 {str(dtype)[6:]} C {c} of {K7_BUFFER} x({','.join(map(str, DENSE))})",
               float(n), n * (torch.empty((), dtype=dtype).element_size() + 1), F32_PEAK,
               make)


def _k2(s: int, b: int = 100) -> Row:
    """K2: B windows of s^2 from four 600^2 uint8 tiles, every augment."""
    def make(m):
        rng = np.random.default_rng(5)
        images = torch.from_numpy(rng.integers(0, 256, (4, 600, 600, 3), dtype=np.uint8))
        masks = torch.from_numpy(rng.integers(0, 2, (4, 600, 600), dtype=np.uint8))
        half = s // 2
        pos = np.stack([rng.integers(0, 4, b), rng.integers(half, 600 - s + half + 1, b),
                        rng.integers(half, 600 - s + half + 1, b)], 1).astype(np.int32)
        args = [t.cuda() for t in (
            images, masks, torch.tensor([120.0, 110.5, 99.25]), torch.tensor([40.0, 37.3, 51.7]),
            torch.from_numpy(pos), torch.from_numpy((np.arange(b) % 8).astype(np.int32)))]
        return (lambda: m.gather.gather_batch(*args, s),
                {"plain": lambda: m.gather.gather_batch_ref(*args, s)})

    # Read: the windows' uint8 pixels and labels, positions and augment
    # ids; written: float32 patches and int64 labels. Two operations a
    # value (subtract the mean, scale by 1/std).
    px = b * s * s
    return Row(f"K2 B={b} s={s} uint8", 2.0 * px * 3,
               px * 3 + px + 16 * b + 4 * px * 3 + 8 * px, F32_PEAK, make, eager=True)


def _first_max_bwd(x, g) -> Callable[[], object]:
    """ATen's max-pool backward at K4's shape (window 3): each window's
    gradient to its first max. Not the same function as K4."""
    xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    _, idx = F.max_pool2d(xc, 3, 1, 1, return_indices=True)
    return lambda: torch.ops.aten.max_pool2d_with_indices_backward(
        gc, xc, [3, 3], [1, 1], [1, 1], [1, 1], False, idx)


def _k4(s: int, c: int, b: int = 100) -> Row:
    """K4 at a train step's pool: x on a 1/16 grid, so that stacked pools
    tie as the step's do."""
    shape = (b, s, s, c)

    def make(m):
        x = torch.round(torch.randn(shape, device="cuda", generator=_gen(s * c)) * 16) / 16
        y = m.pool.pool_forward(x.permute(0, 3, 1, 2), 3).permute(0, 2, 3, 1).contiguous()
        g = torch.randn(shape, device="cuda", generator=_gen(s * c + 1)) * 1e-3
        return (lambda: m.pool.pallas_pool_bwd(x, y, g, 3),
                {"plain": lambda: m.pool.pallas_pool_bwd_ref(x, y, g, 3),
                 "ATen first-max backward": _first_max_bwd(x, g)})

    # x, y, g read and dx written once; a compare and an add per tap in
    # each of two passes.
    n = math.prod(shape)
    return Row(f"K4 x({b},{s},{s},{c}) window 3", 36.0 * n, 16.0 * n, F32_PEAK, make,
               eager=True)


def _p1(b: int, hw: int, c: int, dil: int) -> Row:
    """P1, the int8 conv probe's 3x3 conv with its requant."""
    def make(m):
        gen = _gen(9)
        x = torch.randint(-128, 128, (b, hw, hw, c), generator=gen, device="cuda",
                          dtype=torch.int8)
        w = torch.randint(-128, 128, (3, 3, c, c), generator=gen, device="cuda",
                          dtype=torch.int8)
        scale = 64.0 / (math.sqrt(9 * c) * 73.9 ** 2)
        return (lambda: m.p1.int8_conv3x3_requant(x, w, scale, dil),
                {"plain": lambda: m.p1.int8_conv3x3_requant_ref(x, w, scale, dil)})

    n = b * hw * hw * c
    return Row(f"P1 x({b},{hw},{hw},{c}) d{dil}", 2.0 * n * 9 * c, 2.0 * n + 9 * c * c,
               INT8_PEAK, make)


# (name, Cin, Cout, k, dilation) of dilated_icpr_rate6's int8 blocks at
# width 1.0; blocks 3 and 4 requantize, block 5 stores float.
_K5_BLOCKS = (("block3", 128, 128, 4, 4), ("block4", 128, 256, 3, 5),
              ("block5", 256, 256, 3, 6))
# (Cin, mode) of dilated_grsl_rate8's six pools in a dense int8 forward
# (quant_min_ch 128, no int8 exit).
_K6_POOLS = ((64, "f32"), (64, "f32"), (128, "f32_i8"), (128, "i8"), (192, "i8"),
             (192, "f32"))
ROWS: Tuple[Row, ...] = (
    *[_k5(*g, torch.int8 if g[0] != "block5" else torch.float32) for g in _K5_BLOCKS],
    *[_k5(*g, torch.bfloat16) for g in _K5_BLOCKS],
    *[_k6(i, c, mode) for i, (c, mode) in enumerate(_K6_POOLS)],
    *[_k7(c, dtype) for dtype in (torch.float32, torch.bfloat16)
      for c in (144, 272, 400, 656)],
    *[_k2(s) for s in (25, 35, 45, 55, 65)],
    *[_k4(s, c) for s in (25, 65) for c in (64, 128, 256)],
    _p1(8, 592, 256, 6),
)


def events_ms(fn, calls: int) -> float:
    """Mean CUDA-event time of `calls` eager calls of `fn`, after one."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def graph_ms(fn, reps: int) -> float:
    """Device time of one `fn` call: GRAPH_CALLS calls captured in a CUDA
    graph and replayed `reps` times between CUDA events."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    ms = events_ms(graph.replay, reps) / GRAPH_CALLS
    del graph
    return ms


def time_row(row: Row, mods: SimpleNamespace, reps: int) -> dict:
    op, beside = row.make(mods)
    bound, bound_by = row.bound()
    out = {"name": row.name, "ms": graph_ms(op, reps), "bound_ms": bound,
           "bound_by": bound_by}
    out["share"] = bound / out["ms"]
    if row.eager:
        out["eager call"] = events_ms(op, 10 * reps)
    for what, fn in beside.items():
        out[what] = events_ms(fn, reps) if what == "plain" else graph_ms(fn, reps)
    del op, beside
    torch.cuda.empty_cache()
    return out


def _import_ops(root: str) -> SimpleNamespace:
    """The ops of the dynseg_torch package in `root`, in place of any
    already imported from elsewhere."""
    import_from(root)
    from dynseg_torch.ops import _build, gather, int8_conv, int8_probe_conv, pool

    return SimpleNamespace(build=_build, gather=gather, int8_conv=int8_conv,
                           p1=int8_probe_conv, pool=pool)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dynseg_torch.probes.kernel_times",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="directory whose dynseg_torch package is timed")
    ap.add_argument("--reps", type=int, default=5, help="replays of each graph")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    root = os.path.abspath(args.root or here)
    mods = _import_ops(root)
    mods.build.load_library()
    info = mods.build.build_info
    payload = {"card": card(), "torch": torch.__version__, "cuda": torch.version.cuda,
               "package": root, "build": {"path": info["path"], "seconds": info["seconds"]},
               "reps": args.reps, "rows": []}
    print(f"card: {payload['card']}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"package {root}; kernels built in {info['seconds']:.2f} s -> {info['path']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            print(f"  ptxas: {line.strip()}")
    for row in ROWS:
        r = time_row(row, mods, args.reps)
        payload["rows"].append(r)
        extra = "".join(f"; {k} {v:.4f} ms" for k, v in r.items()
                        if k not in ("name", "ms", "bound_ms", "bound_by", "share"))
        print(f"{r['name']}: {r['ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}), {r['share']:.3f} of it{extra}", flush=True)
    print(json.dumps(payload))
    return 0


if __name__ == "__main__":
    sys.exit(main())
