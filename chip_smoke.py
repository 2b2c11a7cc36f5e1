#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dynseg_torch) on one NVIDIA card.

    python3 chip_smoke.py [--profile DIR]

Builds the port's CUDA kernels from dynseg_torch/csrc/, holds each against
its plain PyTorch version on the card, then drives the port's two paths at
the full width of dilated_icpr_rate6 with seeded random weights on
synthetic tiles. The JAX package and JAX are made absent first (a
meta-path finder refuses `dynseg`, `jax`, `flax` and `optax`): the port
runs without them.

  1. the card's name and power limit, and the kernel build;
  2. K5 (int8_block_conv) kernel vs plain at the three quantized-block
     geometries of a dense batch (8 x 336^2, i.e. block 256 + halo 40):
     each variant (wgmma, the serving path's; dp4a, PR 1's kernel) int8
     output bitwise equal, float32 output within 1e-5 * max|y|, with its
     CUDA-event time, TOPS and share of the bound;
  3. the serving path: a small tile through `validate_test` on the card
     and on the CPU (plain versions): the same answer; then the three
     timed runs (window float and window int8 on a 1024^2 tile, 5 scales
     25..65; dense int8 on a 2048^2 tile), with K5's launch count held to
     3 per int8 forward, all of them the wgmma variant; then window float
     again with DYNSEG_FOLD_MEM_GB at 0.02, under every scale's collected
     buffer, so that each scale folds in bands: the largest collected
     tensor (`Inferencer.fold_peak_bytes`) within the cap, the vote counts
     bitwise and the labels (but for ties) equal to the uncapped run's,
     and its Mpx/s beside the uncapped run's;
  4. K5 kernel vs plain, bitwise, on the int8 activations of one real
     window batch (256 windows of 65^2);
  5. a. K2 (gather_batch) kernel vs plain, bitwise, at B=100 for s in
        25..65 on uint8 tiles, every augment id and edge positions, with
        its device time (a CUDA graph of 20 calls, replayed) against PR
        4's kernel and its eager call time against PR 4's recorded one;
     b. K4 (pallas_pool_bwd) kernel vs plain, bitwise, at the pools of a
        100 x s^2 step (C 64, 128, 256; s 25 and 65): both variants
        (fused, the step's; twopass, PR 2's kernel), each with its device
        time, bytes/s and share of the bound, and ATen's first-max
        backward at the same shape (not the same function); then the fused
        variant on a constant image, which shows that TMA fills NaN
        outside the image;
  6. one train step of a width-0.25 net on the card and on the CPU
     (plain versions): loss within 1e-5 relative, params within 1e-6;
  7. the training path: `dynseg_torch.cli.run_training` on full-width
     dilated_icpr_rate6 (batch 100, multinomial over 25..65, balanced
     sampling, dihedral augment, EMA + BN recalibration), warm-up then
     TRAIN_STEPS timed steps with pool_backward="pallas", then a shorter
     run with "xla": ms/step and patches/s per scale, side by side, loss
     finite and falling, final OA, K2/K4 launches equal to the gathers and
     pool backwards the run made, every K4 launch the fused variant;
  8. K2 and K4 kernel vs plain, bitwise, on the tiles, positions and
     activations of one real train step at 65 px (all six pools fused),
     and whether the pool backward's inputs arrive channels_last (no copy);
  9. P1 (int8_conv3x3_requant) kernel vs plain, bitwise, both variants
     (wgmma, the warp-specialised kernel on a persistent grid; mma_sync,
     the first kernel), on the TPU probe's
     check shapes, on ragged ones (odd H and W, B=3, C 32 and 160,
     dilations 1, 2, 5, 6) and at the probe's shape 8 x 592^2 x 256,
     dilation 6, with each one's CUDA-event time, TOPS and share of the
     bound there;
 10. the int8 conv probe (`python -m dynseg_torch.probes.int8_kernel_probe`
     through its `main`, a few reps): one line per leg, P1's launches
     counted over the run by variant, every one the wgmma variant;
 11. the command line, `python -m dynseg_torch` in subprocesses at full
     width (3 bands, 2 classes, batch 100, the tiles of phase 7): training
     (40 iterations, checkpoints every 20, EMA + recalibration, K4), testing
     (restores iteration 40 with the recalibrated statistics and prints
     the training run's TOTAL line; differing label pixels are counted),
     training --resume to 60, then side by side testing --quant int8
     --quant_exit (K5 launches = 3 x the int8 forwards), predict on two
     rasters with --predict_chunk 1, and info. Every exit code must be 0;
     each run's K2/K4/K5 launches (its "kernel launches:" line) are held
     to the run; each run's output is in smoke_out/cli_<name>.log.

With --profile DIR, it also traces one warm call of each serving run and
one warm train step per pool backward with torch.profiler, and writes the
chrome traces and a kernel summary (span, busy, idle share, time by
kernel class) to DIR.

The last three lines are a JSON object describing the kernels (with each
one's bound: the larger of its operations over the card's peak and its
bytes over the memory rate, at this run's shapes), the card's name and
power limit, and {"ok": true, "device": {...}}. Exits non-zero, before
printing a result, when there is no CUDA device or any check fails.
"""

from __future__ import annotations

import argparse
import collections
import importlib.abc
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch


class _Absent(importlib.abc.MetaPathFinder):
    """The JAX package and JAX itself are absent here: importing them
    fails as it would on a machine without them."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("dynseg", "jax", "flax", "optax"):
            raise ModuleNotFoundError(f"No module named {name!r}", name=name)
        return None


sys.meta_path.insert(0, _Absent())

KERNEL_SOURCE = "dynseg_torch/csrc/int8_block_conv.cu"
KERNEL_REPLACES = "dynseg/ops/pallas_conv.py:59"
GATHER_SOURCE = "dynseg_torch/csrc/patch_gather.cu"
GATHER_REPLACES = "dynseg/ops/pallas_gather.py:92"
POOL_SOURCE = "dynseg_torch/csrc/pool_bwd.cu"
POOL_REPLACES = "dynseg/ops/pool.py:76"
P1_SOURCE = "dynseg_torch/csrc/int8_conv3x3.cu"
P1_REPLACES = "scripts/int8_kernel_probe.py:112"
DEVICE = "cuda"
OUT_DIR = "smoke_out"
SCALES = (25, 35, 45, 55, 65)
# A dense batch: 8 blocks of 256 + 2 * 40 halo pixels a side.
DENSE_BATCH, DENSE_EXT = 8, 336
WINDOW_TILE, DENSE_TILE, SMALL_TILE = 1024, 2048, 48
# (name, cin, cout, k, dilation, requant) of blocks 3, 4, 5 at width 1.0.
GEOMETRIES = (("block3", 128, 128, 4, 4, True),
              ("block4", 128, 256, 3, 5, True),
              ("block5", 256, 256, 3, 6, False))
# The training path: batch 100, timed steps of the pallas and xla runs,
# eval and recalibration batches, synthetic tiles (4 train, 2 test).
TRAIN_BATCH, TRAIN_STEPS, XLA_STEPS, EVAL_EVERY, RECALIB = 100, 40, 20, 20, 10
TRAIN_TILE = 512
# P1's (B, H, W, C, dilation): the TPU probe's check shapes, ragged ones,
# then the probe's shape.
P1_SHAPES = ((2, 16, 16, 128, 2), (1, 32, 32, 128, 6), (3, 17, 23, 32, 1),
             (3, 21, 15, 160, 2), (3, 19, 13, 32, 5), (3, 25, 11, 160, 6),
             (8, 592, 592, 256, 6))
PROBE_REPS = 5
# Phase 3's capped window fold: DYNSEG_FOLD_MEM_GB under every scale's
# collected buffer on the 1024^2 tile (34-39 MB) and over one window batch.
FOLD_CAP_GB = 0.02
# The H100 SXM's published dense peaks: int8 tensor-core operations, float32
# outside the tensor cores, and the memory rate (bytes/s).
INT8_PEAK, F32_PEAK, HBM_RATE = 1979e12, 67e12, 3.35e12
# PR 4's K2 times at B = 100, s = 25..65 (PERF.md, PR 4's run): the rate of
# eager wrapper calls between CUDA events, which the host's cost per call
# bounded, and the kernel's device time (its source built from the parent
# commit and replayed in a CUDA graph beside this kernel, PR 5's run).
PR4_K2_EAGER_MS = {25: 0.0348, 35: 0.0340, 45: 0.0348, 55: 0.0500, 65: 0.0391}
PR4_K2_DEVICE_MS = {25: 0.0073, 35: 0.0091, 45: 0.0142, 55: 0.0196, 65: 0.0249}
# The six pools of a full-width dilated_icpr_rate6 step: channels of its
# blocks (a 65 px step makes one backward at each).
POOL_CHANNELS = (64, 64, 128, 128, 256, 256)
# The command line: iterations of the first training run and of the resume.
CLI_NITER, CLI_RESUME_NITER, CLI_EVERY = 40, 60, 20


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


def graph_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time of one `fn` call: `calls` calls captured in a CUDA graph
    and replayed `reps` times between CUDA events, so that the host's cost
    per call (the wrapper and the launch) is not in it."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = time_ms(graph.replay, reps) / calls
    del graph
    return ms


def bound_ms(ops: float, nbytes: float, peak: float):
    """The least time the card could take: operations over `peak` or bytes
    over the memory rate, whichever is larger; and which one it is."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_RATE * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def bound_totals(bounds: collections.Counter) -> dict:
    """The bound of a kernel over several shapes: the sum of theirs, set
    by whichever of operations or bytes bounds the larger part of it."""
    return {"bound_ms": sum(bounds.values()), "bound_by": bounds.most_common(1)[0][0]}


def check_kernel_geometries(int8_conv) -> dict:
    """Phase 2: each K5 variant vs plain on random int8 data at the slice's
    shapes, timed; the serving path's variant (wgmma) sets the totals."""
    rng = np.random.default_rng(0)
    dev = torch.device(DEVICE)
    bsz, ext = DENSE_BATCH, DENSE_EXT
    total, bounds = collections.Counter(), collections.Counter()
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
        pc = int8_conv.pack_conv(*args[1:], **kw)
        xq = args[0]
        if int8_conv.variant_for(cin, cout, k, dil) != "wgmma":
            raise SystemExit(f"K5 {name}: the serving block does not take wgmma")
        want = int8_conv.int8_block_conv_ref(*args, **kw)
        macs = bsz * ext * ext * k * k * cin * cout
        out_bytes = want.numel() * want.element_size()
        bound, bound_by = bound_ms(2.0 * macs, xq.numel() + pc.w.numel() + out_bytes
                                   + 8 * cout, INT8_PEAK)
        times = {}
        for variant, reps in (("wgmma", 20), ("dp4a", 5)):
            got = int8_conv.int8_block_conv_packed(xq, pc, variant)
            torch.cuda.synchronize()
            if requant:
                diff = (got.int() - want.int()).abs().max().item()
                ok = diff == 0
            else:
                diff = (got - want).abs().max().item()
                ok = diff <= 1e-5 * want.abs().max().item()
            if not ok:
                raise SystemExit(f"K5 {name} {variant}: kernel disagrees with plain ({diff})")
            worst = max(worst, float(diff))
            times[variant] = time_ms(
                lambda: int8_conv.int8_block_conv_packed(xq, pc, variant), reps)
            del got
        # The public entry packs per call; the serving path packs once.
        public = int8_conv.int8_block_conv(*args, **kw)
        if not torch.equal(public, int8_conv.int8_block_conv_packed(xq, pc)):
            raise SystemExit(f"K5 {name}: int8_block_conv differs from the packed entry")
        plain = time_ms(lambda: int8_conv.int8_block_conv_packed_ref(xq, pc), 3)
        detail = (f"int8 out, {(want.abs() == 127).float().mean().item():.4f} of codes "
                  f"clipped" if requant else f"f32 out, max|y| {want.abs().max().item():.3g}")
        log(f"K5 {name} {cin}->{cout} k{k} d{dil} x({bsz},{ext},{ext},{cin}): "
            f"every variant == plain ({detail}); bound {bound:.4f} ms ({bound_by}: "
            f"{2 * macs:.3e} ops)")
        for variant, ms in times.items():
            tag = {"wgmma": "serving path", "dp4a": "PR 1's kernel"}[variant]
            log(f"    {variant:8s} ({tag}): {ms:.4f} ms, {2 * macs / ms / 1e9:.1f} TOPS, "
                f"{bound / ms:.3f} of the bound")
        log(f"    plain: {plain:.3f} ms; wgmma vs dp4a {times['dp4a'] / times['wgmma']:.2f}x")
        total.update(ms=times["wgmma"], plain_ms=plain)
        bounds[bound_by] += bound
        del args, want, pc, xq, public
    torch.cuda.empty_cache()
    return {"max_abs_err": worst, "ms": total["ms"], "plain_ms": total["plain_ms"],
            **bound_totals(bounds)}


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
    from dynseg_torch.config import Config, InferConfig, ModelConfig

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
    from dynseg_torch.data.datasets import load_synthetic
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
    from dynseg_torch.data.datasets import load_synthetic
    from dynseg_torch.infer import validate_test

    t0 = time.perf_counter()
    tiles1k = load_synthetic(seed=0, num_tiles=2, size=WINDOW_TILE)[1]
    tiles2k = load_synthetic(seed=1, num_tiles=2, size=DENSE_TILE)[1]
    log(f"synthetic tiles made in {time.perf_counter() - t0:.1f} s")
    runs = (("window float", config("window", "none"), tiles1k),
            ("window int8", config("window", "int8"), tiles1k),
            ("dense int8", config("dense", "int8"), tiles2k))
    int8_forwards = 0
    int8_conv.reset_launches()
    all_scores = {}
    for name, cfg, tiles in runs:
        t0 = time.perf_counter()
        scores = all_scores[name] = validate_test(cfg, weights, tiles, DEVICE,
                                                  log=lambda *_: None)
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
        f"(3 quantized blocks x {int8_forwards} int8 forwards), by variant "
        f"{int8_conv.variant_launches}")
    if launches == 0 or launches != 3 * int8_forwards:
        raise SystemExit("K5 launch count does not match the int8 forwards")
    if int8_conv.variant_launches["wgmma"] != launches:
        raise SystemExit("K5: a serving block did not take the wgmma variant")
    return {"launches": launches, "runs": runs, "scores": all_scores}


def check_capped_fold(weights, tiles, uncapped: dict, card: str) -> None:
    """Phase 3c: window float on the 1024^2 tiles with DYNSEG_FOLD_MEM_GB
    at FOLD_CAP_GB, so that every scale folds in bands. On tile 0, the
    uncapped and the capped estimator side by side: the largest collected
    tensor and the device's peak memory, vote counts bitwise equal, labels
    equal but for ties (top two vote-averaged probabilities within 1e-5);
    then the capped validate_test, timed, against the uncapped run's."""
    from dynseg_torch.infer import Inferencer, validate_test

    cfg = config("window", "none")
    cap = FOLD_CAP_GB * 1e9
    inf = Inferencer(cfg, tiles, device=DEVICE)
    saved = os.environ.pop("DYNSEG_FOLD_MEM_GB", None)
    out = {}
    try:
        for name, env in (("uncapped", None), ("capped", str(FOLD_CAP_GB))):
            if env is not None:
                os.environ["DYNSEG_FOLD_MEM_GB"] = env
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            res = inf._window_device(weights, 0)
            torch.cuda.synchronize()
            out[name] = (*res, inf.fold_peak_bytes, torch.cuda.max_memory_allocated())
        t0 = time.perf_counter()
        scores = validate_test(cfg, weights, tiles, DEVICE, log=lambda *_: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        os.environ.pop("DYNSEG_FOLD_MEM_GB", None)
        if saved is not None:
            os.environ["DYNSEG_FOLD_MEM_GB"] = saved
    pred_u, sum_u, cnt_u, peak_u, mem_u = out["uncapped"]
    pred_c, sum_c, cnt_c, peak_c, mem_c = out["capped"]
    same_counts = torch.equal(cnt_u, cnt_c)
    top2 = torch.topk(sum_u / cnt_u[..., None], 2, dim=-1).values
    differ = pred_u != pred_c
    ties = bool(((top2[..., 0] - top2[..., 1])[differ] < 1e-5).all())
    px = int(np.prod(tiles.valid_hw, axis=1).sum())
    agree = float(np.mean([np.mean(a == b) for a, b in
                           zip(scores["predictions"], uncapped["predictions"])]))
    log(f"window float, DYNSEG_FOLD_MEM_GB={FOLD_CAP_GB}: fold_peak_bytes {peak_c} "
        f"(cap {cap:.0f}; uncapped {peak_u}), device peak memory {mem_c / 1e6:.1f} MB "
        f"(uncapped {mem_u / 1e6:.1f} MB); tile 0 counts bitwise equal: {same_counts}, "
        f"labels differing {int(differ.sum())} (all ties: {ties})")
    log(f"    validate_test capped: OA={scores['oa']:.4f} (uncapped {uncapped['oa']:.4f}) "
        f"infer_wall_s={scores['infer_wall_s']} ({px / scores['infer_wall_s'] / 1e6:.3f} "
        f"Mpx/s; uncapped {px / uncapped['infer_wall_s'] / 1e6:.3f}) call wall {wall:.3f} s, "
        f"label agreement with the uncapped run {agree:.6f} [{card}]")
    if not (peak_c <= cap < peak_u) or not same_counts or not ties:
        raise SystemExit("capped window fold: over the cap, or counts or labels differ")
    if agree < 0.9999 or abs(scores["oa"] - uncapped["oa"]) > 1e-4:
        raise SystemExit("capped window fold: validate_test differs from the uncapped run")


def check_real_activations(weights, int8_conv) -> None:
    """Phase 4: capture K5's inputs in one real window batch, then hold
    each captured launch against the plain version."""
    from dynseg_torch.data.datasets import load_synthetic
    from dynseg_torch.infer import Inferencer
    from dynseg_torch.ops import quant

    tiles = load_synthetic(seed=0, num_tiles=2, size=256)[1]
    inf = Inferencer(config("window", "int8"), tiles, device=DEVICE)
    qsd = inf.enable_quant(weights)
    captured = []

    def capture(x, pc, variant=None):
        out = int8_conv.int8_block_conv_packed(x, pc, variant)
        captured.append((x, pc, out))
        return out

    quant.int8_block_conv_packed = capture
    try:
        origins = np.stack(np.meshgrid(np.arange(0, 256, 16),
                                       np.arange(0, 256, 16)), -1).reshape(-1, 2)
        inf._probs(qsd, inf.images[0], origins, 65)
    finally:
        quant.int8_block_conv_packed = int8_conv.int8_block_conv_packed
    if len(captured) != 3:
        raise SystemExit(f"expected 3 K5 launches, captured {len(captured)}")
    for i, (x, pc, out) in enumerate(captured):
        want = int8_conv.int8_block_conv_packed_ref(x, pc)
        same = torch.equal(out, want)
        log(f"real activations, block {3 + i} x{tuple(x.shape)} "
            f"-> {out.dtype} ({pc.variant}): "
            f"kernel == plain bitwise: {same}")
        if not same:
            raise SystemExit(f"block {3 + i}: kernel disagrees on real data")


def check_gather_kernel(gather) -> dict:
    """Phase 5a: K2 kernel vs plain, bitwise, at B=100 for every scale; its
    device time (CUDA-graph replay) and eager call time against PR 4's."""
    rng = np.random.default_rng(5)
    dev = torch.device(DEVICE)
    t_n, h, w, c = 4, 600, 600, 3
    images = torch.from_numpy(rng.integers(0, 256, (t_n, h, w, c), dtype=np.uint8)).to(dev)
    masks = torch.from_numpy(rng.integers(0, 2, (t_n, h, w), dtype=np.uint8)).to(dev)
    mean = torch.tensor([120.0, 110.5, 99.25], device=dev)
    std = torch.tensor([40.0, 37.3, 51.7], device=dev)
    total, bounds = collections.Counter(), collections.Counter()
    for s in SCALES:
        half = s // 2
        pos = np.stack([rng.integers(0, t_n, TRAIN_BATCH),
                        rng.integers(half, h - s + half + 1, TRAIN_BATCH),
                        rng.integers(half, w - s + half + 1, TRAIN_BATCH)], 1)
        # Windows flush with each corner of the tile array.
        pos[:4] = [[0, half, half], [1, half, w - s + half],
                   [2, h - s + half, half], [t_n - 1, h - s + half, w - s + half]]
        args = (images, masks, mean, std,
                torch.from_numpy(pos.astype(np.int32)).to(dev),
                torch.from_numpy((np.arange(TRAIN_BATCH) % 8).astype(np.int32)).to(dev))
        gi, gl = gather.gather_batch(*args, s)
        wi, wl = gather.gather_batch_ref(*args, s)
        torch.cuda.synchronize()
        same = torch.equal(gi, wi) and torch.equal(gl, wl)
        ms = graph_ms(lambda: gather.gather_batch(*args, s))
        eager = time_ms(lambda: gather.gather_batch(*args, s), 50)
        plain = time_ms(lambda: gather.gather_batch_ref(*args, s), 10)
        log(f"K2 gather B={TRAIN_BATCH} s={s} u8 tiles, aug 0..7: kernel == plain "
            f"bitwise: {same}; kernel {ms:.4f} ms (device, CUDA graph) plain {plain:.4f} ms")
        if not same:
            raise SystemExit(f"K2 s={s}: kernel disagrees with plain")
        # Read: the windows' u8 pixels and labels, positions and augment
        # ids; written: f32 patches and int64 labels. Two operations a
        # value (subtract the mean, scale by 1/std).
        px = TRAIN_BATCH * s * s
        bound, bound_by = bound_ms(2.0 * px * c, px * c + px + 16 * TRAIN_BATCH
                                   + 4 * px * c + 8 * px, F32_PEAK)
        log(f"    bound {bound:.5f} ms ({bound_by}), {bound / ms:.3f} of it; vs PR 4's "
            f"kernel {PR4_K2_DEVICE_MS[s]:.4f} ms (device): {PR4_K2_DEVICE_MS[s] / ms:.2f}x; "
            f"eager call {eager:.4f} ms vs PR 4's {PR4_K2_EAGER_MS[s]:.4f} ms "
            f"({PR4_K2_EAGER_MS[s] / ms:.2f}x its recorded time)")
        total.update(ms=ms, plain_ms=plain)
        bounds[bound_by] += bound
    return {"max_abs_err": 0.0, "ms": total["ms"], "plain_ms": total["plain_ms"],
            **bound_totals(bounds)}


def aten_first_max_bwd(x, g):
    """ATen's max-pool backward at K4's shape (NHWC x, g; window 3): each
    window's gradient to its first max, by the forward's indices. Not the
    same function as K4, and the port never calls it; timed as a yardstick."""
    xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    _, idx = torch.nn.functional.max_pool2d(xc, 3, 1, 1, return_indices=True)
    return lambda: torch.ops.aten.max_pool2d_with_indices_backward(
        gc, xc, [3, 3], [1, 1], [1, 1], [1, 1], False, idx)


def check_pool_kernel(pool) -> dict:
    """Phase 5b: K4 kernel vs plain, bitwise, at the step's pool shapes,
    both variants timed (device time, CUDA-graph replay) with ATen's
    first-max backward beside them. Values on a 1/16 grid give the
    plateaus of stacked pools (ties). A constant image then checks that
    the fused variant reads NaN outside the image."""
    rng = np.random.default_rng(6)
    dev = torch.device(DEVICE)
    total, bounds = collections.Counter(), collections.Counter()
    for s in (25, 65):
        for c in sorted(set(POOL_CHANNELS)):
            shape = (TRAIN_BATCH, s, s, c)
            x = torch.round(torch.randn(shape, device=dev, generator=torch.Generator(
                dev).manual_seed(s * c)) * 16) / 16
            y = pool.pool_forward(x.permute(0, 3, 1, 2), 3).permute(0, 2, 3, 1).contiguous()
            g = torch.from_numpy(rng.normal(0, 1e-3, shape).astype(np.float32)).to(dev)
            if pool.variant_for(shape, 3, x.data_ptr() % 16 == 0) != "fused":
                raise SystemExit(f"K4 {shape}: the step's pool does not take the fused variant")
            want = pool.pallas_pool_bwd_ref(x, y, g, 3)
            ms = {}
            for variant in pool.VARIANTS:
                got = pool.pallas_pool_bwd(x, y, g, 3, variant)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise SystemExit(f"K4 {shape} {variant}: kernel disagrees with plain")
                del got
                ms[variant] = graph_ms(lambda: pool.pallas_pool_bwd(x, y, g, 3, variant))
            eager = time_ms(lambda: pool.pallas_pool_bwd(x, y, g, 3), 20)
            plain = time_ms(lambda: pool.pallas_pool_bwd_ref(x, y, g, 3), 5)
            aten = graph_ms(aten_first_max_bwd(x, g))
            ties = float((want != 0).float().mean())
            # x, y, g read and dx written once; a compare and an add per
            # tap in each of the two passes.
            nbytes = 4 * 4 * x.numel()
            bound, bound_by = bound_ms(2 * 2 * 9.0 * x.numel(), nbytes, F32_PEAK)
            log(f"K4 pool bwd {shape} window 3: every variant == plain bitwise "
                f"(nonzero dx share {ties:.3f}); bound {bound:.4f} ms ({bound_by}); "
                f"plain {plain:.4f} ms")
            for variant, t in ms.items():
                log(f"    {variant:8s}: {t:.4f} ms (device), {nbytes / t / 1e6:.0f} GB/s "
                    f"of x, y, g, dx, {bound / t:.3f} of the bound")
            log(f"    fused vs twopass {ms['twopass'] / ms['fused']:.2f}x; eager call "
                f"{eager:.4f} ms")
            log(f"    ATen max_pool2d_with_indices_backward (first max, not the same "
                f"function): {aten:.4f} ms (device)")
            total.update(ms=ms["fused"], plain_ms=plain)
            bounds[bound_by] += bound
            del x, y, g, want
    # A constant image: inside it every tap ties, so a corner counts 4 and
    # an edge 6; a fill of 0 outside the image would make them count 9.
    x = torch.zeros((2, 13, 11, 32), device=dev)
    g = torch.ones_like(x)
    got = pool.pallas_pool_bwd(x, x, g, 3, "fused")
    corner = float(got[0, 0, 0, 0])
    ok = torch.equal(got, pool.pallas_pool_bwd_ref(x, x, g, 3))
    log(f"K4 fused on a constant image: == plain bitwise: {ok}; corner dx {corner:.7f} "
        f"(1/4 + 2/6 + 1/9 = {1 / 4 + 2 / 6 + 1 / 9:.7f}): TMA fills NaN outside the image")
    if not ok or abs(corner - (1 / 4 + 2 / 6 + 1 / 9)) > 1e-6:
        raise SystemExit("K4 fused: the tensor map's fill outside the image is not NaN")
    torch.cuda.empty_cache()
    return {"max_abs_err": 0.0, "ms": total["ms"], "plain_ms": total["plain_ms"],
            **bound_totals(bounds)}


def train_config(pool_backward: str, niter: int, ema: bool, width: float = 1.0,
                 scales=SCALES, batch: int = TRAIN_BATCH):
    from dynseg_torch.config import (Config, DataConfig, InferConfig,
                                     ModelConfig, SchedulerConfig, TrainConfig)

    return Config(
        model=ModelConfig(net_type="dilated_icpr_rate6", num_classes=2,
                          num_input_bands=3, width_multiplier=width,
                          pool_backward=pool_backward),
        sched=SchedulerConfig(distribution_type="multinomial", values=scales),
        train=TrainConfig(batch_size=batch, niter=niter, eval_every=EVAL_EVERY,
                          ema_decay=0.9 if ema else 0.0,
                          ema_recalib_batches=RECALIB if ema else 0,
                          output_path=f"{OUT_DIR}/smoke_train_{pool_backward}"),
        infer=InferConfig(scales=scales, save_prediction_maps=False),
        data=DataConfig(dataset="synthetic", dataset_kwargs=json.dumps(
            {"size": TRAIN_TILE, "num_tiles": 4})))


def check_train_step_against_cpu() -> None:
    """Phase 6: one train step on the card and on the CPU."""
    from dynseg_torch.data.datasets import load_synthetic
    from dynseg_torch.train import Trainer

    cfg = train_config("pallas", 1, False, width=0.25, scales=(25,), batch=8)
    tiles = load_synthetic(seed=0, num_tiles=2, size=64)[0]
    out = {}
    for dev in (DEVICE, "cpu"):
        tr = Trainer(cfg, tiles, device=dev)
        st = tr.init_state(seed=3)
        pos, aug = tr.make_batch_inputs(25)
        loss = float(tr._step_impl(st, pos[0], aug[0], 25)["loss"])
        out[dev] = (loss, {k: v.cpu() for k, v in st.model.state_dict().items()})
    (lg, sg), (lc, sc) = out[DEVICE], out["cpu"]
    dp = max(float((sg[k].double() - sc[k].double()).abs().max()) for k in sc)
    rel = abs(lg - lc) / abs(lc)
    log(f"train step width 0.25, 8 x 25^2, pool_backward pallas: card vs CPU "
        f"loss {lg:.7f} vs {lc:.7f} (rel {rel:.2e}), max|dparam| {dp:.2e}")
    # Both float32 (TF32 off); sums in another order: 1e-5 / 1e-6.
    if not (math.isfinite(lg) and rel <= 1e-5 and dp <= 1e-6):
        raise SystemExit("train step: card and CPU disagree")


def run_training_slice(gather, pool, card: str) -> dict:
    """Phase 7: run_training with pool_backward pallas, then xla."""
    from dynseg_torch import cli, train

    losses = []
    step = train.Trainer.train_step

    def recording_step(self, state, size):
        state, m = step(self, state, size)
        losses.append(m["loss"])
        return state, m

    train.Trainer.train_step = recording_step
    out = {}
    try:
        for pb, niter, ema in (("pallas", TRAIN_STEPS, True), ("xla", XLA_STEPS, False)):
            cfg = train_config(pb, niter, ema)
            losses.clear()
            gather.launches = 0
            pool.reset_launches()
            t0 = time.perf_counter()
            scores = cli.run_training(cfg, log=lambda *_: None, device=DEVICE)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            k2, k4 = gather.launches, pool.launches
            vals = [float(x) for x in losses]
            n_scales = len(cfg.sched.values)
            gathers = n_scales + niter + niter // EVAL_EVERY + (RECALIB if ema else 0)
            backwards = 6 * (n_scales + niter) if pb == "pallas" else 0
            third = max(1, len(vals) // 3)
            head, tail = np.mean(vals[:third]), np.mean(vals[-third:])
            log(f"run_training pool_backward={pb}: {niter} steps + {n_scales} warm-up, "
                f"wall {wall:.1f} s, mean loss of the first {third} steps {head:.4f}, "
                f"of the last {third} {tail:.4f}, "
                f"OA={scores['oa']:.4f} kappa={scores['kappa']:.4f} "
                f"infer_wall_s={scores['infer_wall_s']} [{card}]")
            for size, st in scores["train_steps"].items():
                log(f"  scale {size}: {st['steps']} steps, {st['ms_per_step']:.3f} "
                    f"ms/step, {st['patches_per_s']:.1f} patches/s")
            log(f"  K2 launches {k2} (expected {gathers} gathers: {n_scales} warm-up + "
                f"{niter} steps + {niter // EVAL_EVERY} evals + "
                f"{RECALIB if ema else 0} recalibration); K4 launches {k4} "
                f"(expected {backwards} = 6 pools x {n_scales + niter} steps), by variant "
                f"{pool.variant_launches}")
            if not all(map(math.isfinite, vals)) or len(vals) != niter:
                raise SystemExit(f"{pb}: non-finite or missing losses {vals}")
            if not tail < head:
                raise SystemExit(f"{pb}: loss did not fall ({head} -> {tail})")
            if k2 != gathers or k4 != backwards or (pb == "pallas" and k4 == 0):
                raise SystemExit(f"{pb}: launch counts do not match the run")
            if pool.variant_launches["fused"] != k4:
                raise SystemExit(f"{pb}: a pool backward of the step did not take "
                                 f"the fused variant")
            if not 0.0 <= scores["oa"] <= 1.0 or len(scores["predictions"]) != 2:
                raise SystemExit(f"{pb}: malformed scores")
            out[pb] = {"k2": k2, "k4": k4, "steps": scores["train_steps"]}
    finally:
        train.Trainer.train_step = step
    log("ms/step by scale, pool_backward pallas (K4) vs xla (ATen's first-max "
        "backward), the same net, batch and tiles:")
    for size in sorted(out["pallas"]["steps"]):
        pal, xla = out["pallas"]["steps"][size], out["xla"]["steps"].get(size)
        xla_ms = f"{xla['ms_per_step']:.3f}" if xla else "not run"
        diff = f", pallas - xla {pal['ms_per_step'] - xla['ms_per_step']:+.3f} ms" if xla else ""
        log(f"  scale {size}: pallas {pal['ms_per_step']:.3f} ({pal['steps']} steps) "
            f"xla {xla_ms} ({xla['steps'] if xla else 0} steps){diff}")
    return out


def check_train_real_activations(gather, pool) -> None:
    """Phase 8: capture K2's and K4's inputs in one real full-width train
    step at 65 px, then hold each captured launch against plain."""
    from dynseg_torch import train
    from dynseg_torch.data.datasets import load_synthetic
    from dynseg_torch.ops import pool as pool_mod

    cfg = train_config("pallas", 1, False)
    tiles = load_synthetic(seed=0, num_tiles=4, size=TRAIN_TILE)[0]
    tr = train.Trainer(cfg, tiles, device=DEVICE)
    st = tr.init_state(seed=0)
    captured = []

    def capture_gather(*args):
        out = gather.gather_batch(*args)
        captured.append(("K2", args, out))
        return out

    launched = []

    def capture_pool(*args):
        before = dict(pool.variant_launches)
        out = pool_bwd(*args)
        launched.extend(v for v in pool.VARIANTS if pool.variant_launches[v] != before[v])
        captured.append(("K4", tuple(a.clone() for a in args[:3]) + args[3:], out.clone()))
        return out

    views = []

    def watch_nhwc(t):
        out = nhwc(t)
        views.append(out.data_ptr() == t.data_ptr())
        return out

    pool_bwd, nhwc = pool_mod.pallas_pool_bwd, pool_mod._nhwc
    train.gather_batch, pool_mod.pallas_pool_bwd = capture_gather, capture_pool
    pool_mod._nhwc = watch_nhwc
    try:
        pos, aug = tr.make_batch_inputs(65)
        tr._step_impl(st, pos[0], aug[0], 65)
    finally:
        train.gather_batch, pool_mod.pallas_pool_bwd = gather.gather_batch, pool_bwd
        pool_mod._nhwc = nhwc
    log(f"real train step: the pool backward's x, y, g arrived channels_last (NHWC "
        f"views, no copy) {sum(views)} of {len(views)} times")
    if [c[0] for c in captured] != ["K2"] + ["K4"] * 6:
        raise SystemExit(f"expected 1 K2 and 6 K4 launches, got {[c[0] for c in captured]}")
    if launched != ["fused"] * 6:
        raise SystemExit(f"the step's pool backwards took {launched}, not the fused variant")
    for name, args, out in captured:
        ref = gather.gather_batch_ref if name == "K2" else pool.pallas_pool_bwd_ref
        want = ref(*args)
        same = (all(map(torch.equal, out, want)) if name == "K2"
                else torch.equal(out, want))
        shape = tuple(args[0].shape) if name == "K4" else tuple(out[0].shape)
        variant = f" ({launched.pop(0)})" if name == "K4" else ""
        log(f"real train step, {name} x{shape}{variant}: kernel == plain bitwise: {same}")
        if not same:
            raise SystemExit(f"{name}: kernel disagrees on real data")


def check_p1_kernel(p1) -> dict:
    """Phase 9: both P1 variants vs plain, bitwise, at every shape; at the
    probe's shape, each timed with its share of the bound. The scale
    spreads the codes over the whole int8 range, a few percent clipped at
    each bound."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(dev).manual_seed(9)
    runs = (("wgmma", {}), ("mma_sync", {"variant": "mma_sync"}))
    for b, h, w, c, dil in P1_SHAPES:
        x = torch.randint(-128, 128, (b, h, w, c), generator=gen, device=dev,
                          dtype=torch.int8)
        wt = torch.randint(-128, 128, (3, 3, c, c), generator=gen, device=dev,
                           dtype=torch.int8)
        scale = 64.0 / (math.sqrt(9 * c) * 73.9 ** 2)
        if p1.variant_for(dil, x.data_ptr() % 16 == 0) != "wgmma":
            raise SystemExit(f"P1 {(b, h, w, c, dil)}: the probe's input does not take wgmma")
        want = p1.int8_conv3x3_requant_ref(x, wt, scale, dil)
        for name, kw in runs:
            got = p1.int8_conv3x3_requant(x, wt, scale, dil, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                diff = (got.int() - want.int()).abs().max().item()
                raise SystemExit(f"P1 {(b, h, w, c, dil)} {name}: kernel disagrees "
                                 f"with plain ({diff})")
            del got
        lo, hi = float((want == -128).float().mean()), float((want == 127).float().mean())
        log(f"P1 x({b},{h},{w},{c}) d{dil}: every variant == plain bitwise: True "
            f"(codes at -128 {lo:.4f}, at 127 {hi:.4f})")
    ops = 2.0 * b * h * w * 9 * c * c
    bound, bound_by = bound_ms(ops, 2 * x.numel() + wt.numel(), INT8_PEAK)
    times = {name: time_ms(lambda: p1.int8_conv3x3_requant(x, wt, scale, dil, **kw), 10)
             for name, kw in runs}
    plain = time_ms(lambda: p1.int8_conv3x3_requant_ref(x, wt, scale, dil), 2)
    log(f"P1 at the probe's shape x({b},{h},{w},{c}) d{dil}: bound {bound:.4f} ms "
        f"({bound_by}: {ops:.3e} ops); plain {plain:.3f} ms")
    for name, ms in times.items():
        tag = {"wgmma": "the default", "mma_sync": "the first kernel"}[name]
        log(f"    {name:8s} ({tag}): {ms:.4f} ms, {ops / ms / 1e9:.1f} TOPS, "
            f"{bound / ms:.3f} of the bound")
    del x, wt, want
    torch.cuda.empty_cache()
    return {"max_abs_err": 0.0, "ms": times["wgmma"], "plain_ms": plain, "bound_ms": bound,
            "bound_by": bound_by}


def run_probe(p1) -> int:
    """Phase 10: the probe's main; returns P1's launches in it."""
    from dynseg_torch.probes import int8_kernel_probe

    p1.reset_launches()
    out = f"{OUT_DIR}/int8_kernel_probe.json"
    if int8_kernel_probe.main(["--reps", str(PROBE_REPS), "--out", out]) != 0:
        raise SystemExit("int8 kernel probe failed")
    launches = p1.launches
    # 2 check shapes + 3 warm-up + the timed reps of leg C.
    expected = len(int8_kernel_probe.CHECK_SHAPES) + 3 + PROBE_REPS
    log(f"P1 launches in the probe: {launches} (expected {expected}), by variant "
        f"{p1.variant_launches}")
    if launches != expected:
        raise SystemExit("P1 launch count does not match the probe")
    if p1.variant_launches["wgmma"] != launches:
        raise SystemExit("P1: a launch of the probe did not take the wgmma variant")
    torch.cuda.empty_cache()
    return launches


def _launch_line(lines, name: str) -> dict:
    found = [m for m in lines if m.startswith("kernel launches:")]
    if len(found) != 1:
        raise SystemExit(f"CLI {name}: no kernel launches line")
    return {k: int(v) for k, v in (kv.split("=") for kv in found[0].split()[2:])}


def run_cli(card: str) -> dict:
    """Phase 11: python -m dynseg_torch through training, testing, resume,
    int8 testing, predict and info."""
    from PIL import Image

    from dynseg_torch import cli
    from dynseg_torch.data.datasets import load_dataset

    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(root, OUT_DIR, "cli")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    kwargs = {"size": TRAIN_TILE, "num_tiles": 4}
    common = ["--device", DEVICE, "--dataset", "synthetic", "--dataset_kwargs",
              json.dumps(kwargs), "--values", ",".join(map(str, SCALES)),
              "--batch_size", str(TRAIN_BATCH), "--output_path", out]
    train_flags = ["--checkpoint_every", str(CLI_EVERY), "--eval_every", str(CLI_EVERY),
                   "--ema_decay", "0.9", "--ema_recalib_batches", str(RECALIB),
                   "--pool_backward", "pallas"]
    walls = {}

    def start(name, argv):
        """A `python -m dynseg_torch` process, its output to a log file."""
        log_path = os.path.join(root, OUT_DIR, f"cli_{name}.log")
        with open(log_path, "w") as f:
            proc = subprocess.Popen([sys.executable, "-m", "dynseg_torch", *argv, *common],
                                    stdout=f, stderr=subprocess.STDOUT, text=True, cwd=root)
        return name, time.perf_counter(), proc, log_path

    def finish(job, note="", end=None):
        name, t0, proc, log_path = job
        rc = proc.wait(timeout=600)
        walls[name] = (time.perf_counter() if end is None else end) - t0
        with open(log_path) as f:
            text = f.read()
        log(f"CLI {name}: exit {rc}, wall {walls[name]:.1f} s{note} [{card}]")
        if rc != 0:
            print(text[-3000:], file=sys.stderr)
            raise SystemExit(f"CLI {name} exited {rc}")
        return text.splitlines()

    def run(name, argv):
        return finish(start(name, argv))

    def total(lines, name):
        found = [m for m in lines if m.startswith("TOTAL:")]
        if len(found) != 1:
            raise SystemExit(f"CLI {name}: no TOTAL line")
        log(f"  {found[0]}")
        return found[0]

    def expect(name, lines, **want):
        got = _launch_line(lines, name)
        log(f"  kernel launches {got} (expected {want})")
        if any(got[k] != v for k, v in want.items()):
            raise SystemExit(f"CLI {name}: launch counts do not match the run")

    n = len(SCALES)
    lines = run("training", ["--operation", "training", "--niter", str(CLI_NITER),
                             *train_flags])
    train_total = total(lines, "training")
    expect("training", lines, patch_gather=n + CLI_NITER + CLI_NITER // CLI_EVERY + RECALIB,
           pool_bwd=6 * (n + CLI_NITER), int8_block_conv=0,
           **{"pool_bwd.fused": 6 * (n + CLI_NITER)})
    maps = sorted(f for f in os.listdir(out) if f.startswith("prediction_"))
    for f in maps:
        os.replace(os.path.join(out, f), os.path.join(out, "train_" + f))

    lines = run("testing", ["--operation", "testing"])
    for want in (f"restored checkpoint at iteration {CLI_NITER}",
                 "using recalibrated BatchNorm statistics"):
        if not any(want in m for m in lines):
            raise SystemExit(f"CLI testing: no '{want}' line")
    differ = sum(int(np.any(np.asarray(Image.open(os.path.join(out, f)))
                            != np.asarray(Image.open(os.path.join(out, "train_" + f))),
                            axis=-1).sum()) for f in maps)
    log(f"  label pixels differing from the training process's maps: {differ} "
        f"over {len(maps)} maps")
    if total(lines, "testing") != train_total:
        raise SystemExit("CLI testing: TOTAL differs from the training run's")

    lines = run("resume", ["--operation", "training", "--resume", "--niter",
                           str(CLI_RESUME_NITER), *train_flags])
    if not any(f"resumed from iteration {CLI_NITER}" in m for m in lines):
        raise SystemExit("CLI resume: no 'resumed from iteration' line")
    steps = CLI_RESUME_NITER - CLI_NITER
    total(lines, "resume")
    expect("resume", lines, patch_gather=n + steps + steps // CLI_EVERY + RECALIB,
           pool_bwd=6 * (n + steps), **{"pool_bwd.fused": 6 * (n + steps)})

    # int8 testing, predict and info only read the checkpoint: they run
    # side by side, and their walls overlap.
    rasters = os.path.join(out, "rasters")
    os.makedirs(rasters)
    rng = np.random.default_rng(11)
    shapes = {"scene_a": (600, 700), "scene_b": (384, 512)}
    for stem, (h, w) in shapes.items():
        np.save(os.path.join(rasters, f"{stem}.npy"),
                rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    int8_argv = ["--operation", "testing", "--quant", "int8", "--quant_exit"]
    jobs = [start("testing_int8", int8_argv),
            start("predict", ["--operation", "predict", "--predict_path", rasters,
                              "--predict_chunk", "1"]),
            start("info", ["--operation", "info"])]
    try:
        ends = {}
        deadline = time.perf_counter() + 600
        while len(ends) < len(jobs) and time.perf_counter() < deadline:
            for name, _, proc, _ in jobs:
                if name not in ends and proc.poll() is not None:
                    ends[name] = time.perf_counter()
            time.sleep(0.1)
        lines = finish(jobs[0], " (beside predict and info)", ends.get("testing_int8"))
        total(lines, "testing_int8")
        cfg = cli.config_from_args(cli.build_argparser().parse_args(int8_argv + common))
        test_tiles = load_dataset("synthetic", "", 0, seed=0, **kwargs)[1]
        k5 = 3 * expected_forwards(cfg, test_tiles)
        expect("testing_int8", lines, int8_block_conv=k5, patch_gather=0)

        finish(jobs[1], " (beside int8 testing and info)", ends.get("predict"))
        for stem, (h, w) in shapes.items():
            path = os.path.join(out, f"prediction_{stem}.png")
            if not os.path.exists(path) or Image.open(path).size != (w, h):
                raise SystemExit(f"CLI predict: no {w}x{h} map {path}")
        log(f"  wrote {len(shapes)} maps: {', '.join(sorted(shapes))}")

        lines = finish(jobs[2], " (beside int8 testing and predict)", ends.get("info"))
        if f"iteration: {CLI_RESUME_NITER}" not in lines:
            raise SystemExit("CLI info: wrong iteration")
        log("  " + next(m for m in lines if m.startswith("checkpoints:")))
    finally:
        for _, _, proc, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {"walls": walls, "k5": k5, "differ": differ}


def kernel_class(event: dict) -> str:
    """A device event's class in the serving summaries."""
    if event["cat"] != "kernel":
        return "copies"
    n = event["name"].lower()
    for cls, keys in (("K5", ("k5_",)), ("max-pool", ("max_pool",)), ("BN", ("bn_fw",)),
                      ("transposes", ("nchwtonhwc", "nhwctonchw")),
                      ("cuDNN conv", ("xmma", "implicit_gemm", "conv", "cudnn")),
                      ("softmax", ("softmax",)), ("fold", ("col2im", "im2col")),
                      ("sort (calibration)", ("radixsort", "sort")),
                      ("casts", ("copy_kernel",)), ("reductions", ("reduce",)),
                      ("elementwise", ("elementwise",))):
        if any(k in n for k in keys):
            return cls
    return "other"


def profile_serving(out_dir: str, weights, runs) -> None:
    """--profile: torch.profiler over one warm validate_test call of each
    serving run (the span includes int8 calibration); chrome traces, the
    device's busy time and idle share, and device time by kernel class."""
    from torch.profiler import ProfilerActivity, profile

    from dynseg_torch.infer import validate_test

    os.makedirs(out_dir, exist_ok=True)
    for name, cfg, tiles in runs:
        validate_test(cfg, weights, tiles, DEVICE, log=lambda *_: None)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            validate_test(cfg, weights, tiles, DEVICE, log=lambda *_: None)
            torch.cuda.synchronize()
            span = time.perf_counter() - t0
        trace = os.path.join(out_dir, f"serving_{name.replace(' ', '_')}.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        busy = sum(e["dur"] for e in events) / 1e6
        by_class = collections.Counter()
        for e in events:
            by_class[kernel_class(e)] += e["dur"] / 1e6
        log(f"profile serving {name}: span {span:.4f} s, device busy {busy:.4f} s, "
            f"idle share {1 - busy / span:.3f}; " + ", ".join(
                f"{cls} {s:.4f} s ({s / busy:.3f})" for cls, s in by_class.most_common()))


def profile_train_steps(out_dir: str) -> None:
    """--profile: torch.profiler over one warm full-width train step per
    pool backward at 25 and 65 px; chrome traces and kernel sums."""
    from torch.profiler import ProfilerActivity, profile

    from dynseg_torch import train
    from dynseg_torch.data.datasets import load_synthetic

    os.makedirs(out_dir, exist_ok=True)
    tiles = load_synthetic(seed=0, num_tiles=4, size=TRAIN_TILE)[0]
    for pb in ("pallas", "xla"):
        tr = train.Trainer(train_config(pb, 1, False), tiles, device=DEVICE)
        st = tr.init_state(seed=0)
        for s in (25, 65):
            for _ in range(3):  # warm
                tr.train_step(st, s)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                tr.train_step(st, s)
                torch.cuda.synchronize()
                span = time.perf_counter() - t0
            trace = os.path.join(out_dir, f"train_step_{pb}_{s}.json")
            prof.export_chrome_trace(trace)
            with open(trace) as f:
                events = json.load(f)["traceEvents"]
            kernels = [e for e in events if e.get("cat") == "kernel"]
            busy = sum(e["dur"] for e in kernels) / 1e6
            by_name = collections.Counter()
            for e in kernels:
                by_name[e["name"][:90]] += e["dur"] / 1e3
            copies = [e for e in kernels if any(
                k in e["name"].lower() for k in ("copy", "transpose", "nchwtonhwc",
                                                 "nhwctonchw"))]
            log(f"profile pool_backward={pb} s={s}: span {span * 1e3:.3f} ms, "
                f"kernels busy {busy * 1e3:.3f} ms, idle share {1 - busy / span:.3f}; "
                f"copy/transpose kernels {len(copies)}, "
                f"{sum(e['dur'] for e in copies) / 1e3:.3f} ms")
            for name, ms in by_name.most_common(8):
                log(f"    {ms:8.3f} ms  {name}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="also trace the serving runs and warm train steps into DIR")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from dynseg_torch.ops import _build, gather, int8_conv, int8_probe_conv, pool

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.load_library()
    log(f"kernels built from dynseg_torch/csrc/*.cu in {time.perf_counter() - t0:.2f} s "
        f"-> {_build.build_info['path']}")
    for line in _build.build_info["log"].splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # The serving path (K5).
    k5 = check_kernel_geometries(int8_conv)
    weights = {k: v.to(DEVICE) for k, v in
               seeded_weights(config("window", "none").model, 3).items()}
    check_against_cpu(weights)
    k5.update(run_slice(weights, int8_conv, card))
    check_capped_fold(weights, k5["runs"][0][2], k5.pop("scores")["window float"], card)
    check_real_activations(weights, int8_conv)
    if args.profile:
        profile_serving(args.profile, weights, k5.pop("runs"))
    k5.pop("runs", None)
    del weights
    torch.cuda.empty_cache()

    # The training path (K2, K4).
    k2 = check_gather_kernel(gather)
    k4 = check_pool_kernel(pool)
    check_train_step_against_cpu()
    runs = run_training_slice(gather, pool, card)
    k2["launches"], k4["launches"] = runs["pallas"]["k2"], runs["pallas"]["k4"]
    check_train_real_activations(gather, pool)
    if args.profile:
        profile_train_steps(args.profile)

    # The probe (P1) and the command line.
    p1 = check_p1_kernel(int8_probe_conv)
    p1["launches"] = run_probe(int8_probe_conv)
    run_cli(card)

    def entry(name, source, replaces, k):
        # library_ms: no single PyTorch call computes any of the four
        # functions (no CUDA int8 conv; ATen's max-pool backward routes a
        # tie to the first max; the gather fuses crop, normalise and labels).
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": k["launches"],
                "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"], "library_ms": None}

    print(json.dumps({"kernels": [
        entry("int8_block_conv", KERNEL_SOURCE, KERNEL_REPLACES, k5),
        entry("patch_gather", GATHER_SOURCE, GATHER_REPLACES, k2),
        entry("pool_bwd", POOL_SOURCE, POOL_REPLACES, k4),
        entry("int8_conv3x3.wgmma", P1_SOURCE, P1_REPLACES, p1)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
