#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dynseg_torch) on one NVIDIA card.

    python3 chip_smoke.py [--profile DIR]

Builds the port's CUDA kernels from dynseg_torch/csrc/, holds each against
its plain PyTorch version on the card, then drives the port's two paths at
the full width of dilated_icpr_rate6 with seeded random weights on
synthetic tiles:

  1. the card's name and power limit, and the kernel build;
  2. K5 (int8_block_conv) kernel vs plain at the three quantized-block
     geometries of a dense batch (8 x 336^2, i.e. block 256 + halo 40):
     int8 output bitwise equal, float32 output within 1e-5 * max|y|,
     and the CUDA-event time of each;
  3. the serving path: a small tile through `validate_test` on the card
     and on the CPU (plain versions): the same answer; then the three
     timed runs (window float and window int8 on a 1024^2 tile, 5 scales
     25..65; dense int8 on a 2048^2 tile), with K5's launch count held to
     3 per int8 forward;
  4. K5 kernel vs plain, bitwise, on the int8 activations of one real
     window batch;
  5. K2 (gather_batch) kernel vs plain, bitwise, at B=100 for s in
     25..65 on uint8 tiles, every augment id and edge positions, and K4
     (pallas_pool_bwd) kernel vs plain, bitwise, at the pools of a
     100 x s^2 step (C 64, 128, 256; s 25 and 65), with CUDA-event times;
  6. one train step of a width-0.25 net on the card and on the CPU
     (plain versions): loss within 1e-5 relative, params within 1e-6;
  7. the training path: `dynseg_torch.cli.run_training` on full-width
     dilated_icpr_rate6 (batch 100, multinomial over 25..65, balanced
     sampling, dihedral augment, EMA + BN recalibration), warm-up then
     TRAIN_STEPS timed steps with pool_backward="pallas", then a shorter
     run with "xla": ms/step and patches/s per scale, loss finite and
     falling, final OA, and K2/K4 launches equal to the gathers and
     pool backwards the run made;
  8. K2 and K4 kernel vs plain, bitwise, on the tiles, positions and
     activations of one real train step at 65 px.

With --profile DIR, it also traces one warm train step per pool backward
with torch.profiler and writes the chrome traces and a kernel summary
to DIR.

The last two lines are a JSON object describing the kernels and
{"ok": true, "device": {...}}. Exits non-zero, before printing a result,
when there is no CUDA device or any check fails. Imports no JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

KERNEL_SOURCE = "dynseg_torch/csrc/int8_block_conv.cu"
KERNEL_REPLACES = "dynseg/ops/pallas_conv.py:59"
GATHER_SOURCE = "dynseg_torch/csrc/patch_gather.cu"
GATHER_REPLACES = "dynseg/ops/pallas_gather.py:92"
POOL_SOURCE = "dynseg_torch/csrc/pool_bwd.cu"
POOL_REPLACES = "dynseg/ops/pool.py:76"
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


def check_gather_kernel(gather) -> dict:
    """Phase 5a: K2 kernel vs plain, bitwise, at B=100 for every scale."""
    rng = np.random.default_rng(5)
    dev = torch.device(DEVICE)
    t_n, h, w, c = 4, 600, 600, 3
    images = torch.from_numpy(rng.integers(0, 256, (t_n, h, w, c), dtype=np.uint8)).to(dev)
    masks = torch.from_numpy(rng.integers(0, 2, (t_n, h, w), dtype=np.uint8)).to(dev)
    mean = torch.tensor([120.0, 110.5, 99.25], device=dev)
    std = torch.tensor([40.0, 37.3, 51.7], device=dev)
    total_ms = total_plain = 0.0
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
        ms = time_ms(lambda: gather.gather_batch(*args, s), 50)
        plain = time_ms(lambda: gather.gather_batch_ref(*args, s), 10)
        log(f"K2 gather B={TRAIN_BATCH} s={s} u8 tiles, aug 0..7: kernel == plain "
            f"bitwise: {same}; kernel {ms:.4f} ms plain {plain:.4f} ms")
        if not same:
            raise SystemExit(f"K2 s={s}: kernel disagrees with plain")
        total_ms += ms
        total_plain += plain
    return {"max_abs_err": 0.0, "ms": total_ms, "plain_ms": total_plain}


def check_pool_kernel(pool) -> dict:
    """Phase 5b: K4 kernel vs plain, bitwise, at the step's pool shapes.
    Values on a 1/16 grid give the plateaus of stacked pools (ties)."""
    rng = np.random.default_rng(6)
    dev = torch.device(DEVICE)
    total_ms = total_plain = 0.0
    for s in (25, 65):
        for c in (64, 128, 256):
            shape = (TRAIN_BATCH, s, s, c)
            x = torch.round(torch.randn(shape, device=dev, generator=torch.Generator(
                dev).manual_seed(s * c)) * 16) / 16
            y = pool.pool_forward(x.permute(0, 3, 1, 2), 3).permute(0, 2, 3, 1).contiguous()
            g = torch.from_numpy(rng.normal(0, 1e-3, shape).astype(np.float32)).to(dev)
            got = pool.pallas_pool_bwd(x, y, g, 3)
            want = pool.pallas_pool_bwd_ref(x, y, g, 3)
            torch.cuda.synchronize()
            same = torch.equal(got, want)
            ties = float((got != 0).float().mean())
            ms = time_ms(lambda: pool.pallas_pool_bwd(x, y, g, 3), 20)
            plain = time_ms(lambda: pool.pallas_pool_bwd_ref(x, y, g, 3), 5)
            gb = 8 * x.numel() * 4 / 1e9  # x, y, g, gdc; x, y, gdc, dx
            log(f"K4 pool bwd {shape} window 3: kernel == plain bitwise: {same} "
                f"(nonzero dx share {ties:.3f}); kernel {ms:.4f} ms "
                f"({gb / ms * 1e3:.0f} GB/s at 8 tensor passes) plain {plain:.4f} ms")
            if not same:
                raise SystemExit(f"K4 {shape}: kernel disagrees with plain")
            total_ms += ms
            total_plain += plain
            del x, y, g, got, want
    torch.cuda.empty_cache()
    return {"max_abs_err": 0.0, "ms": total_ms, "plain_ms": total_plain}


def train_config(pool_backward: str, niter: int, ema: bool, width: float = 1.0,
                 scales=SCALES, batch: int = TRAIN_BATCH):
    from dynseg.config import (Config, DataConfig, InferConfig, ModelConfig,
                               SchedulerConfig, TrainConfig)

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
    from dynseg.data.datasets import load_synthetic
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
            gather.launches = pool.launches = 0
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
                f"(expected {backwards} = 6 pools x {n_scales + niter} steps)")
            if not all(map(math.isfinite, vals)) or len(vals) != niter:
                raise SystemExit(f"{pb}: non-finite or missing losses {vals}")
            if not tail < head:
                raise SystemExit(f"{pb}: loss did not fall ({head} -> {tail})")
            if k2 != gathers or k4 != backwards or (pb == "pallas" and k4 == 0):
                raise SystemExit(f"{pb}: launch counts do not match the run")
            if not 0.0 <= scores["oa"] <= 1.0 or len(scores["predictions"]) != 2:
                raise SystemExit(f"{pb}: malformed scores")
            out[pb] = {"k2": k2, "k4": k4, "steps": scores["train_steps"]}
    finally:
        train.Trainer.train_step = step
    return out


def check_train_real_activations(gather, pool) -> None:
    """Phase 8: capture K2's and K4's inputs in one real full-width train
    step at 65 px, then hold each captured launch against plain."""
    from dynseg.data.datasets import load_synthetic
    from dynseg_torch import train
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

    def capture_pool(*args):
        out = pool_bwd(*args)
        captured.append(("K4", tuple(a.clone() for a in args[:3]) + args[3:], out.clone()))
        return out

    pool_bwd = pool_mod.pallas_pool_bwd
    train.gather_batch, pool_mod.pallas_pool_bwd = capture_gather, capture_pool
    try:
        pos, aug = tr.make_batch_inputs(65)
        tr._step_impl(st, pos[0], aug[0], 65)
    finally:
        train.gather_batch, pool_mod.pallas_pool_bwd = gather.gather_batch, pool_bwd
    if [c[0] for c in captured] != ["K2"] + ["K4"] * 6:
        raise SystemExit(f"expected 1 K2 and 6 K4 launches, got {[c[0] for c in captured]}")
    for name, args, out in captured:
        ref = gather.gather_batch_ref if name == "K2" else pool.pallas_pool_bwd_ref
        want = ref(*args)
        same = (all(map(torch.equal, out, want)) if name == "K2"
                else torch.equal(out, want))
        log(f"real train step, {name} x{tuple(args[0].shape) if name == 'K4' else tuple(out[0].shape)}: "
            f"kernel == plain bitwise: {same}")
        if not same:
            raise SystemExit(f"{name}: kernel disagrees on real data")


def profile_train_steps(out_dir: str) -> None:
    """--profile: torch.profiler over one warm full-width train step per
    pool backward at 25 and 65 px; chrome traces and kernel sums."""
    from torch.profiler import ProfilerActivity, profile

    from dynseg.data.datasets import load_synthetic
    from dynseg_torch import train

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
            log(f"profile pool_backward={pb} s={s}: span {span * 1e3:.3f} ms, "
                f"kernels busy {busy * 1e3:.3f} ms, idle share {1 - busy / span:.3f}")
            for name, ms in by_name.most_common(8):
                log(f"    {ms:8.3f} ms  {name}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="also trace warm train steps into DIR")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from dynseg_torch.ops import _build, gather, int8_conv, pool

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
    check_real_activations(weights, int8_conv)
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

    def entry(name, source, replaces, k):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": k["launches"],
                "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                "plain_ms": k["plain_ms"]}

    print(json.dumps({"kernels": [
        entry("int8_block_conv", KERNEL_SOURCE, KERNEL_REPLACES, k5),
        entry("patch_gather", GATHER_SOURCE, GATHER_REPLACES, k2),
        entry("pool_bwd", POOL_SOURCE, POOL_REPLACES, k4)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
