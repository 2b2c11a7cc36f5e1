#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dynseg_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernel from dynseg_torch/csrc/, holds it against
its plain PyTorch version on the card, then drives the int8 serving path
through `dynseg_torch.infer.validate_test` at the full width of
dilated_icpr_rate6 with seeded random weights on synthetic tiles:

  1. the card's name and power limit, and the kernel build;
  2. K5 (int8_block_conv) kernel vs plain at the three quantized-block
     geometries of a dense batch (8 x 336^2, i.e. block 256 + halo 40):
     int8 output bitwise equal, float32 output within 1e-5 * max|y|,
     and the CUDA-event time of each;
  3. a small tile through the whole path on the card and on the CPU
     (plain versions): the same answer; then the three timed runs
     (window float and window int8 on a 1024^2 tile, 5 scales 25..65;
     dense int8 on a 2048^2 tile), with K5's launch count held to 3 per
     int8 forward;
  4. K5 kernel vs plain, bitwise, on the int8 activations of one real
     window batch.

The last two lines are a JSON object describing the kernel and
{"ok": true, "device": {...}}. Exits non-zero, before printing a result,
when there is no CUDA device or any check fails. Imports no JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

KERNEL_SOURCE = "dynseg_torch/csrc/int8_block_conv.cu"
KERNEL_REPLACES = "dynseg/ops/pallas_conv.py:59"
DEVICE = "cuda"
SCALES = (25, 35, 45, 55, 65)
# A dense batch: 8 blocks of 256 + 2 * 40 halo pixels a side.
DENSE_BATCH, DENSE_EXT = 8, 336
WINDOW_TILE, DENSE_TILE, SMALL_TILE = 1024, 2048, 48
# (name, cin, cout, k, dilation, requant) of blocks 3, 4, 5 at width 1.0.
GEOMETRIES = (("block3", 128, 128, 4, 4, True),
              ("block4", 128, 256, 3, 5, True),
              ("block5", 256, 256, 3, 6, False))


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of `fn` over `reps` launches, after a warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_kernel_geometries(int8_conv) -> dict:
    """Phase 2: kernel vs plain on random int8 data at the slice's shapes."""
    rng = np.random.default_rng(0)
    dev = torch.device(DEVICE)
    bsz, ext = DENSE_BATCH, DENSE_EXT
    total_ms = total_plain = 0.0
    worst = 0.0
    for name, cin, cout, k, dil, requant in GEOMETRIES:
        # Codes shaped like calibrated activations and per-channel
        # quantized weights; A scales acc to O(1), B like a folded BN.
        x = np.clip(np.rint(rng.normal(10, 38, (bsz, ext, ext, cin))), -127, 127)
        w = np.clip(np.rint(rng.normal(0, 35, (k, k, cin, cout))), -127, 127)
        a = rng.uniform(0.5, 1.5, cout) / (math.sqrt(k * k * cin) * 38 * 35)
        b = rng.normal(0, 0.1, cout)
        args = (torch.from_numpy(x.astype(np.int8)).to(dev),
                torch.from_numpy(w.astype(np.int8)).to(dev),
                torch.from_numpy(a.astype(np.float32)).to(dev),
                torch.from_numpy(b.astype(np.float32)).to(dev))
        kw = dict(dilation=dil, leaky_slope=0.1,
                  out_scale=3.0 / 127 if requant else None)
        got = int8_conv.int8_block_conv(*args, **kw)
        want = int8_conv.int8_block_conv_ref(*args, **kw)
        torch.cuda.synchronize()
        if requant:
            diff = (got.int() - want.int()).abs().max().item()
            clipped = (want.abs() == 127).float().mean().item()
            ok = diff == 0
            detail = f"int8 out, {clipped:.4f} of codes clipped"
        else:
            diff = (got - want).abs().max().item()
            bound = 1e-5 * want.abs().max().item()
            ok = diff <= bound
            detail = f"f32 out, bound {bound:.3e}"
        ms = time_ms(lambda: int8_conv.int8_block_conv(*args, **kw), 10)
        plain = time_ms(lambda: int8_conv.int8_block_conv_ref(*args, **kw), 3)
        macs = bsz * ext * ext * k * k * cin * cout
        log(f"K5 {name} {cin}->{cout} k{k} d{dil} x({bsz},{ext},{ext},{cin}): "
            f"max|kernel-plain|={diff} ({detail}) kernel {ms:.3f} ms "
            f"({2 * macs / ms / 1e9:.1f} TOPS) plain {plain:.3f} ms")
        if not ok:
            raise SystemExit(f"K5 {name}: kernel disagrees with plain ({diff})")
        worst = max(worst, float(diff))
        total_ms += ms
        total_plain += plain
        del args, got, want
    torch.cuda.empty_cache()
    return {"max_abs_err": worst, "ms": total_ms, "plain_ms": total_plain}


def seeded_weights(cfg, bands: int) -> dict:
    """Full-width random weights with non-trivial BatchNorm statistics."""
    from dynseg_torch.bridge import flax_to_torch, init_variables_np

    variables = init_variables_np(cfg, num_input_bands=bands, seed=0)
    rng = np.random.default_rng(1)
    for name, stats in variables["batch_stats"].items():
        bn, st = variables["params"][name]["BatchNorm_0"], stats["BatchNorm_0"]
        n = bn["scale"].shape[0]
        bn["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
        bn["bias"] = rng.normal(0, 0.1, n).astype(np.float32)
        st["mean"] = rng.normal(0, 0.2, n).astype(np.float32)
        st["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return flax_to_torch(variables)


def config(mode: str, quant: str, scales=SCALES):
    from dynseg.config import Config, InferConfig, ModelConfig

    return Config(
        model=ModelConfig(net_type="dilated_icpr_rate6", num_classes=2,
                          num_input_bands=3, width_multiplier=1.0),
        infer=InferConfig(scales=scales, mode=mode, quant=quant,
                          dense_block=256, dense_halo=40,
                          save_prediction_maps=False))


def expected_forwards(cfg, tiles) -> int:
    """Net forwards validate_test makes over `tiles`, counted from the
    window grid or the dense block grid."""
    from dynseg_torch.infer import window_origins

    pad = max(max(cfg.infer.scales), cfg.infer.dense_halo)
    H, W = tiles.images.shape[1:3]
    n = 0
    for h, w in tiles.valid_hw:
        if cfg.infer.mode == "dense":
            blk = max(1, min(cfg.infer.dense_block, H, W))

            def starts(extent):
                ss = list(range(0, max(1, extent - blk + 1), blk))
                return len(ss) + (ss[-1] + blk < extent)

            blocks = starts(int(h)) * starts(int(w))
            n += math.ceil(blocks / min(8, blocks))
            continue
        for s in cfg.infer.scales:
            stride = min(s, max(1, int(round(s * cfg.infer.stride_fraction))))
            rows = window_origins(pad, pad + int(h), s, stride, H + 2 * pad - s)
            cols = window_origins(pad, pad + int(w), s, stride, W + 2 * pad - s)
            n += math.ceil(len(rows) * len(cols) / cfg.infer.window_batch)
    return n


def check_against_cpu(weights) -> None:
    """Phase 3a: one small tile through the whole path on the card and on
    the CPU, where every op is a plain PyTorch version."""
    from dynseg.data.datasets import load_synthetic
    from dynseg_torch.infer import Inferencer

    tiles = load_synthetic(seed=2, num_tiles=2, size=SMALL_TILE)[1]
    cpu = {k: v.cpu() for k, v in weights.items()}
    for quant in ("none", "int8"):
        cfg = config("window", quant, scales=(25, 35))
        out = {}
        for dev, sd in ((DEVICE, weights), ("cpu", cpu)):
            inf = Inferencer(cfg, tiles, device=dev)
            out[dev] = inf.predict_tile(inf.enable_quant(sd), 0)
        (pg, prob_g), (pc, prob_c) = out[DEVICE], out["cpu"]
        if not (np.isfinite(prob_g).all()
                and prob_g.shape == (SMALL_TILE, SMALL_TILE, 2)):
            raise SystemExit(f"{quant}: bad probabilities on the card")
        dp = float(np.abs(prob_g - prob_c).max())
        agree = float(np.mean(pg == pc))
        log(f"small tile {SMALL_TILE}^2 scales 25,35 quant={quant}: card vs CPU "
            f"max|dprob|={dp:.2e} label agreement {agree:.5f}")
        # float: both float32, summation order only; int8: a calibration
        # range that moves by float32 rounding can flip a rare code (the
        # bound is the logits bound of tests/test_pallas_conv.py).
        if dp > (1e-4 if quant == "none" else 2e-2) or agree < 0.995:
            raise SystemExit(f"{quant}: card and CPU disagree")


def run_slice(weights, int8_conv, card: str) -> dict:
    """Phase 3b: the three timed validate_test runs."""
    from dynseg.data.datasets import load_synthetic
    from dynseg_torch.infer import validate_test

    t0 = time.perf_counter()
    tiles1k = load_synthetic(seed=0, num_tiles=2, size=WINDOW_TILE)[1]
    tiles2k = load_synthetic(seed=1, num_tiles=2, size=DENSE_TILE)[1]
    log(f"synthetic tiles made in {time.perf_counter() - t0:.1f} s")
    runs = (("window float", config("window", "none"), tiles1k),
            ("window int8", config("window", "int8"), tiles1k),
            ("dense int8", config("dense", "int8"), tiles2k))
    int8_forwards = 0
    int8_conv.launches = 0
    for name, cfg, tiles in runs:
        t0 = time.perf_counter()
        scores = validate_test(cfg, weights, tiles, log=lambda *_: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        px = int(np.prod(tiles.valid_hw, axis=1).sum())
        pred = scores["predictions"][0]
        if pred.shape != tuple(tiles.valid_hw[0]) or not (0 <= pred).all() \
                or not (pred < cfg.model.num_classes).all():
            raise SystemExit(f"{name}: malformed prediction map")
        fw = expected_forwards(cfg, tiles)
        if cfg.infer.quant == "int8":
            int8_forwards += fw
        log(f"{name}: tile {tiles.valid_hw[0][0]}x{tiles.valid_hw[0][1]} "
            f"OA={scores['oa']:.4f} kappa={scores['kappa']:.4f} "
            f"infer_wall_s={scores['infer_wall_s']} "
            f"({px / scores['infer_wall_s'] / 1e6:.3f} Mpx/s) "
            f"call wall {wall:.3f} s, {fw} forwards [{card}]")
    launches = int8_conv.launches
    log(f"K5 launches on the main path: {launches} "
        f"(3 quantized blocks x {int8_forwards} int8 forwards)")
    if launches == 0 or launches != 3 * int8_forwards:
        raise SystemExit("K5 launch count does not match the int8 forwards")
    return {"launches": launches}


def check_real_activations(weights, int8_conv) -> None:
    """Phase 4: capture K5's inputs in one real window batch, then hold
    each captured launch against the plain version."""
    from dynseg.data.datasets import load_synthetic
    from dynseg_torch.infer import Inferencer
    from dynseg_torch.ops import quant

    tiles = load_synthetic(seed=0, num_tiles=2, size=256)[1]
    inf = Inferencer(config("window", "int8"), tiles, device=DEVICE)
    qsd = inf.enable_quant(weights)
    captured = []

    def capture(*args, **kw):
        out = int8_conv.int8_block_conv(*args, **kw)
        captured.append((args, kw, out))
        return out

    quant.int8_block_conv = capture
    try:
        origins = np.stack(np.meshgrid(np.arange(0, 256, 16),
                                       np.arange(0, 256, 16)), -1).reshape(-1, 2)
        inf._probs(qsd, inf.images[0], origins, 65)
    finally:
        quant.int8_block_conv = int8_conv.int8_block_conv
    if len(captured) != 3:
        raise SystemExit(f"expected 3 K5 launches, captured {len(captured)}")
    for i, (args, kw, out) in enumerate(captured):
        want = int8_conv.int8_block_conv_ref(*args, **kw)
        same = torch.equal(out, want)
        log(f"real activations, block {3 + i} x{tuple(args[0].shape)} "
            f"-> {out.dtype}: kernel == plain bitwise: {same}")
        if not same:
            raise SystemExit(f"block {3 + i}: kernel disagrees on real data")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from dynseg_torch.ops import _build, int8_conv

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.load_library()
    log(f"K5 built from {KERNEL_SOURCE} in {time.perf_counter() - t0:.2f} s "
        f"-> {_build.build_info['path']}")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    k5 = check_kernel_geometries(int8_conv)
    weights = {k: v.to(DEVICE) for k, v in
               seeded_weights(config("window", "none").model, 3).items()}
    check_against_cpu(weights)
    k5.update(run_slice(weights, int8_conv, card))
    check_real_activations(weights, int8_conv)

    print(json.dumps({"kernels": [{
        "name": "int8_block_conv", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": k5["launches"],
        "max_abs_err": k5["max_abs_err"], "ms": k5["ms"],
        "plain_ms": k5["plain_ms"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
