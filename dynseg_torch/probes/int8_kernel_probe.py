"""How much of the card's int8 peak does a hand-written shifted-matmul conv
reach at the int8 serving block's shape? (Counterpart of
scripts/int8_kernel_probe.py.)

Four legs at the arithmetic of the serving block, a 3x3 dilation-6
256 -> 256 int8 conv over 8 x hw x hw pixels:

  A   torch._int_mm at 4096^3: the library's int8 matmul on a friendly
      shape, a reference point for what the card reaches (not a ported
      kernel);
  A2  torch._int_mm at M = 8 * hw * 74, K = N = 256: the same at the
      conv's contraction shape (also a library reference point);
  B   K5 (dynseg_torch.ops.int8_conv.int8_block_conv_packed, requant
      on), the shipped int8 conv: its wgmma variant on the tensor cores;
  C   P1 (dynseg_torch.ops.int8_probe_conv.int8_conv3x3_requant): the
      probe's shifted-matmul conv on the tensor cores (mma.sync s8).

    python -m dynseg_torch.probes.int8_kernel_probe [--reps 20] [--hw 592]
        [--check_only] [--out PATH]

Times are CUDA-event means over `reps` launches after a warm-up; TOPS
counts 2 * M * N * K int8 operations. The percentage of peak is against
the card's published dense int8 rate, printed beside the card's name and
power limit. --check_only holds P1 against its plain version on the two
check shapes of the TPU probe and exits non-zero on any difference. Needs
a CUDA card; exits non-zero without one. A leg that fails is an error.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import List, Optional

import numpy as np
import torch

# Published dense int8 tensor-core rates (NVIDIA data sheets, without
# sparsity), by a substring of torch.cuda.get_device_name().
PEAK_INT8_TOPS = (("H100 80GB HBM3", 1979.0), ("H100 SXM", 1979.0),
                  ("H100 NVL", 1671.0), ("H100 PCIe", 1513.0),
                  ("H200", 1979.0))
# (B, H, W, C, dilation) of the TPU probe's correctness check.
CHECK_SHAPES = ((2, 16, 16, 128, 2), (1, 32, 32, 128, 6))
CHECK_SCALE = 1.0 / 512.0


def card_peak_tops(name: str) -> Optional[float]:
    for key, tops in PEAK_INT8_TOPS:
        if key in name:
            return tops
    return None


def time_s(fn, reps: int, warmup: int = 3) -> float:
    """Mean CUDA-event seconds of `fn` over `reps` launches."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / reps


def _leg(ops: float, seconds: float, peak: Optional[float], **shape) -> dict:
    tops = ops / seconds / 1e12
    return {**shape, "s": seconds, "tops": tops,
            "pct_int8_peak": None if peak is None else 100.0 * tops / peak}


def _int8(gen: torch.Generator, shape, lo: int, hi: int) -> torch.Tensor:
    return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                         dtype=torch.int8)


def probe_matmul(m: int, k: int, n: int, reps: int, peak) -> dict:
    """torch._int_mm with B row-major and with B column-major (the
    layout the library's int8 tensor-core GEMMs take); the leg is the
    faster of the two, both times kept."""
    gen = torch.Generator("cuda").manual_seed(0)
    a, b = _int8(gen, (m, k), -127, 127), _int8(gen, (k, n), -127, 127)
    b_col = b.t().contiguous().t()
    times = {"s_b_row_major": time_s(lambda: torch._int_mm(a, b), reps),
             "s_b_col_major": time_s(lambda: torch._int_mm(a, b_col), reps)}
    return {**_leg(2.0 * m * k * n, min(times.values()), peak, m=m, k=k, n=n),
            **times}


def _conv_inputs(batch: int, hw: int, c: int):
    gen = torch.Generator("cuda").manual_seed(0)
    return (_int8(gen, (batch, hw, hw, c), -127, 127),
            _int8(gen, (3, 3, c, c), -8, 8))


def probe_k5(batch: int, hw: int, c: int, dil: int, reps: int, peak) -> dict:
    from dynseg_torch.ops.int8_conv import int8_block_conv_packed, pack_conv

    x, w = _conv_inputs(batch, hw, c)
    a = torch.full((c,), 1.0 / 512.0, device="cuda")
    b = torch.zeros(c, device="cuda")
    # Operands packed once, as the serving path packs them.
    pc = pack_conv(w, a, b, dilation=dil, leaky_slope=1.0, out_scale=1.0)
    dt = time_s(lambda: int8_block_conv_packed(x, pc), reps)
    return _leg(2.0 * batch * hw * hw * 9 * c * c, dt, peak,
                batch=batch, hw=hw, c=c, dil=dil)


def probe_p1(batch: int, hw: int, c: int, dil: int, reps: int, peak) -> dict:
    from dynseg_torch.ops.int8_probe_conv import int8_conv3x3_requant

    x, w = _conv_inputs(batch, hw, c)
    dt = time_s(lambda: int8_conv3x3_requant(x, w, CHECK_SCALE, dil), reps)
    return _leg(2.0 * batch * hw * hw * 9 * c * c, dt, peak,
                batch=batch, hw=hw, c=c, dil=dil)


def check_kernel() -> dict:
    """P1 kernel vs plain, bitwise, on the TPU probe's check shapes."""
    from dynseg_torch.ops.int8_probe_conv import (int8_conv3x3_requant,
                                                  int8_conv3x3_requant_ref)

    rng = np.random.default_rng(1)
    results = {}
    for b, h, w_, c, dil in CHECK_SHAPES:
        x = torch.from_numpy(rng.integers(-127, 127, (b, h, w_, c), dtype=np.int8)).cuda()
        w = torch.from_numpy(rng.integers(-8, 8, (3, 3, c, c), dtype=np.int8)).cuda()
        got = int8_conv3x3_requant(x, w, CHECK_SCALE, dil)
        want = int8_conv3x3_requant_ref(x, w, CHECK_SCALE, dil)
        results[f"b{b}_h{h}_c{c}_d{dil}"] = bool(torch.equal(got, want))
    return results


def card() -> str:
    """`nvidia-smi`'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dynseg_torch.probes.int8_kernel_probe",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--hw", type=int, default=592)
    ap.add_argument("--check_only", action="store_true")
    ap.add_argument("--out", default="", help="write the JSON result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("int8_kernel_probe: no CUDA device", file=sys.stderr)
        return 1
    name = torch.cuda.get_device_name(0)
    peak = card_peak_tops(name)
    payload = {"card": card(), "device": name, "peak_int8_tops": peak,
               "torch": torch.__version__, "cuda": torch.version.cuda}
    print(f"card: {payload['card']}; dense int8 peak "
          f"{'unknown' if peak is None else f'{peak:.0f} TOPS'} (data sheet)",
          flush=True)
    payload["kernel_check"] = check_kernel()
    print("kernel check (P1 == plain, bitwise):", payload["kernel_check"], flush=True)
    if not all(payload["kernel_check"].values()):
        return 1
    if not args.check_only:
        legs = (("A_int_mm_4096", "library", lambda: probe_matmul(4096, 4096, 4096, args.reps, peak)),
                ("A2_int_mm_convshape", "library",
                 lambda: probe_matmul(8 * args.hw * 74, 256, 256, args.reps, peak)),
                ("B_k5_int8_block_conv", "K5 wgmma s8",
                 lambda: probe_k5(8, args.hw, 256, 6, args.reps, peak)),
                ("C_p1_int8_conv3x3", "P1 mma.sync s8",
                 lambda: probe_p1(8, args.hw, 256, 6, args.reps, peak)))
        for key, what, run in legs:
            leg = payload[key] = run()
            pct = leg["pct_int8_peak"]
            print(f"{key} ({what}): {leg['s']:.6f} s, {leg['tops']:.1f} TOPS, "
                  f"{'n/a' if pct is None else f'{pct:.1f}%'} of peak", flush=True)
            torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"-> wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
