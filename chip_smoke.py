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
  2b. K6 (max_pool_s1 forward) kernel vs plain, bitwise, at the six
     pools of a dense batch of dilated_grsl_rate8 (8 x 336^2: C 64 and 64
     f32, 128 f32 -> int8 with the quantize fused, 128 and 192 int8, 192
     f32), each with its device time, share of the byte bound, the plain
     composition's time and ATen's float32 max_pool2d at the same shape;
  2c. K7 (quantize_s8) kernel vs plain, bitwise, on the four channel
     prefixes (144 / 272 / 400 / 656) of a dense batch's feature buffer of
     dilated_icpr_rate6_densely (8 x 336^2 x 912, float32 and bfloat16),
     read in place, each with its device time, share of the byte bound and
     the plain composition's time; then one int8 forward of that net at
     full width on the batch: K7 launched 4 times, all on the 16-byte
     path, and the logits equal to the plain composition's;
  3. the serving path: a small tile through `validate_test` on the card
     and on the CPU (plain versions): the same answer; then the three
     timed runs (window float and window int8 on a 1024^2 tile, 5 scales
     25..65; dense int8 on a 2048^2 tile), with K5's launch count held to
     3 per int8 forward, all of them the wgmma variant, and K6's to 2 i8
     and 1 f32_i8 per int8 forward; then window float
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
     to the run; each run's output is in smoke_out/cli_<name>.log. Beside
     int8 testing, testing --tta --compute_dtype bfloat16 in dense mode
     prints its TOTAL line.

 12. K5's bfloat16 store (the int8 forward under compute_dtype bfloat16)
     vs plain, bitwise, at the three geometries of phase 2 in both
     variants, each timed with its share of the bound and its ratio to
     the float32 store's time in the same run; then dp4a at a ragged
     shape (the dense-wired net's 131-channel concat);
 13. the serving runs of phase 3 in float32 and under compute_dtype
     bfloat16, with the head bias centred on the 2048^2 tile's median
     log-odds (the random net otherwise paints one class everywhere, and
     every label agreement would be 1): Mpx/s side by side and label
     agreement; K5 launches = 3 per int8 forward, one of them (block 5)
     storing bf16;
 14. test-time augmentation, with phase 13's weights: validate_test with
     tta on in dense int8 (the 2048^2 tile) and window float on a 512^2
     tile (a smaller tile keeps 8x the window work inside the time
     limit): forwards = 8 x the plain run's, label agreement with the
     plain run;
 15. host streaming, with phase 13's weights: window float on phase 3's
     tile with hbm_budget_gb=0
     (the tile set stays on the host, one tile uploaded a prediction):
     label maps bitwise equal to the resident run, device peak memory and
     Mpx/s of both;
 16. training under compute_dtype bfloat16: one width-0.25 step on the
     card and on the CPU (a bfloat16 bound), then `run_training` at
     phase 7's configuration with pool_backward="xla" (TRAIN_STEPS steps,
     EMA + recalibration) and a short run with "pallas", which must warn
     that the bfloat16 pools take ATen's backward: ms/step and patches/s
     per scale beside phase 7's, loss finite and falling, K2 launches =
     gathers, no K4 launch.

 17. export and serve, on phase 11's trained checkpoint: first K5 (wgmma)
     vs plain, bitwise, at the shapes the serve path gives it: a dense
     call at the server's defaults (8 blocks of 1024 + 2 * 40 halo, over
     2^31 output elements at Cout 256) and window batches of 64 and 128
     at 65^2, for the three blocks with the int8 exit's requant and block
     5's float32 store too; then `python -m
     dynseg_torch --operation export` in two subprocesses side by side,
     bfloat16 (the default) and --quant int8 --quant_exit, each loaded
     and checked on cuda and cpu; each artifact loaded onto the card and
     held to the live net restored in this process on a 2048^2 raster in
     dense blocks (bf16 within 1e-2, labels equal but near a tie; int8
     within 1e-5, K5 launched 3 times per forward, all wgmma); then
     `--operation serve` over each at its defaults on a port the OS
     picks (read from its "listening:" line): ready on /healthz
     after its warm-up, a dense labels POST on the 2048^2 raster and a
     window probs POST on a 512^2 one (latency, Mpx/s), /metrics, and a
     SIGTERM drain to exit 0; the answers equal an in-process
     ServingEngine on the same artifact at the server's settings (labels
     bitwise, probabilities within 1e-6); the serve path's K5 launches
     are the server's own over the two requests (its "server stopped"
     line; it counts from 0 after its warm-up), and equal the engine's.

 18. data parallelism (dynseg_torch.parallel), after phase 17: first K2
     and K4 (fused) vs plain, bitwise, at a rank's half batch (50) and
     K5 (wgmma) at a rank's window batches (half the window batch of c's
     window config, at each of its scales; a rank's dense batch is
     phase 2's 8 x 336^2); then
     `python -m dynseg_torch --operation training --num_devices N`, N
     one more than the visible cards, must exit non-zero with the
     over-commit message; at the full width of phase 7 (batch 100, its
     tiles), a. one rank in an NCCL group on cuda:0 takes three steps at
     25 and 65 px and predicts a small tile, held to one device on the
     same batches (every loss within 1e-5 relative; after the first
     step params within 1e-6 and BN statistics within 1e-5; after the
     third within the larger of those and twice that run's own float32
     noise: the largest distance between one device's run and four
     reruns on its batches with the rows in other orders; probabilities
     1e-5); b. two ranks sharing cuda:0 over gloo take the same three
     steps (50 patches a rank), then three --shard_tiles steps on their
     own sampling, each held to one device on the same global batches at
     the same limits (the shard run to the noise of its own batches),
     with each rank's K2/K4 launches equal to its gathers and pool
     backwards, all fused, and ms/step per scale beside one device's (the
     ranks share one card: not a speed-up), and the all-reduces' share
     of a step timed alone; c. the same two ranks, and a's one rank,
     predict window int8 on phase 3's 1024^2 tile and dense int8 on its
     2048^2 tile (weights centred as in phase 13), held to one device
     outside a group at the default batch and, in window mode, to one
     whose forwards take a rank's windows (half the window batch): labels
     equal but at counted ties, probabilities within 1e-5, the int8
     state_dict bitwise, each rank's K5 launches = 3 x its int8 forwards,
     all wgmma; Mpx/s beside one device's at the default batch; then two
     readings: one device at the default window batch against half of
     it, and the same windows forwarded in a full, a half and a short
     batch, with cuDNN on and off (what makes a forward depend on its
     batch).

 19. reproducibility, after phase 18, at phase 7's full width (batch 100,
     multinomial over 25..65, its tiles, seed 0): a. train_loop twice
     from the same seed, REPRO_STEPS steps (at least one at 25 and one at
     65 px), EMA 0.9 with RECALIB recalibration batches, in float32 with
     pool_backward pallas (K4) and in bfloat16 with xla (ATen's pool
     backward): params, BN statistics, momentum, EMA weights, the
     recalibrated statistics, per-step losses, the scales drawn and the
     scheduler's scores bitwise equal, cuDNN's deterministic flag on; b.
     readings: the float32 run with cuDNN's free choice of algorithms (a
     cudnn.flags context here, not a package switch) against a's, and
     ms/step at 25 and 65 px both ways in float32 and bfloat16 (with
     --profile DIR, the kernels whose time the deterministic step grew);
     c. a's float32 checkpoint restored twice, REPRO_RESUME_STEPS more
     steps each: bitwise; d. phase 18's two gloo ranks sharing cuda:0
     through its three steps twice: each rank bitwise to its rerun, with
     cuDNN's deterministic flag on in the spawned ranks; e. a reading:
     validate_test twice in one process in a serving process's cuDNN
     mode (window float on a 512^2 crop of phase 3's tile, dense int8 on
     its 2048^2 tile): max|dprob| and labels between the runs; f. a's
     runs once more under torch.use_deterministic_algorithms(True), which
     must not raise; g. `python -m dynseg_torch.run_folds --folds 2`
     twice side by side (phase 11's data flags, FOLDS_NITER iterations,
     pool_backward pallas): the two folds_summary.json files
     byte-identical, each fold's K2/K4 launches held to its run.
 20. a reading, after phase 13: quant_min_ch 64 (blocks 1-2 also int8)
     against the default 128 on phase 13's window int8 1024^2 and dense
     int8 2048^2 runs: first K5 at blocks 1-2's geometries (64->64 k5 d2,
     64->128 k4 d3) vs plain, bitwise, at a dense batch and window
     batches; then Mpx/s, label agreement with the float32 run of the
     mode, and K5 launches by geometry and variant, the first launch of
     each geometry bitwise to plain.

 21. the production-scale rehearsals, after phase 19, each `python -m
     dynseg_torch.probes.<name>` in a process of its own (cuDNN's
     process-wide flags and the host RSS stay the probe's own) at its
     defaults, the scripts' own, but for one cut the time limit forces:
     a. stress_scale (20 x 3000^2 uint8 training tiles, 180 Mpx,
     position tables capped at 2,000,000 a class, 6 classes, dynamic
     5-scale training with area-rescaled batches, steps_per_call 8,
     metric_fetch_depth 4, then validate_test dense and window on two
     3000^2 test tiles): tile storage uint8, every logged loss finite,
     the mean chunk loss of the last quarter below the first's, OA and
     mean F1 printed for both modes, K2's launches equal to the gathers
     the run made, and K2 bitwise to plain on one real batch of each of
     the five buckets (B = 100, 51, 31, 21, 15) on the 20-tile stack; b.
     profile_multitile (four odd-shaped uint8 tiles, 12 Mpx), voting
     over scales 25 and 65 (--scales, the cut): pass 2's label maps
     equal pass 1's; c. sweep_dense (a 2048^2 tile, blocks 256 to 1024,
     float32 and bfloat16): every agreement with the float32 block-512
     labels printed. Each probe's lines are repeated here with its exit
     code and wall time; its whole output is in
     smoke_out/rehearsal_<name>.log.

 22. the accuracy studies, after phase 21, each `python -m
     dynseg_torch.probes.<name>` in a process of its own, cut through its
     own flags only: sched_ablation (--values 25,65, multinomial, one
     seed, 300 iterations, area-rescaled batches), mode_gap and bf16_eval
     (one seed, 300 iterations), parity_bracket (the texture set, the
     first 2 combinations, one seed, 100 iterations), diagnose_collapse
     (multinomial:0, 300 iterations, eval every 100, EMA 0.999, the cell
     kept), then ema_recalib_probe on that cell (N = 25, 50); the five
     lanes run side by side on the card, so their wall times and ms/step
     are contended. Each must exit 0 and write a JSON with the script's
     top-level keys and every OA in (0, 1];
     K2's launches in each training run equal its gathers, and K2 is
     bitwise to plain on one batch of each bucket of each run, among them
     the batch of 64 rescaled by area (B = 64 / 33 / 20 / 13 / 9 at s =
     25..65). Logs in smoke_out/study_<name>.log, JSONs beside them.

 23. the reference's initial weights, after phase 22: on this host, the
     full-width dilated_icpr_rate6 init (3 bands, 2 and 6 classes, seeds
     0-4) that `Trainer.init_state(seed)` draws in numpy
     (`bridge.init_variables_like_reference`), each tree's SHA-256 equal
     to the digest pinned in `bridge.REFERENCE_INIT_SHA256` (the JAX
     package's `init_state(jax.random.key(seed))`, which the CPU tests
     hold the draw to); the same digest read back from a Trainer's model
     on the card; then one cut paired run through the command line,
     `python -m dynseg_torch.probes.sched_ablation` at single_fixed@35,
     seed 0, 300 iterations, batch 64: its OA (no JAX run exists at this
     cut, so nothing is compared), K2's launches equal to its gathers and
     K2 bitwise to plain on its batch. Log in smoke_out/paired_sched_ablation.log.

Phases 12-15 and 20 run after phase 4, phase 16 after phase 8 and phases
17-19 and 21-23 after phase 11, each beside the phase it is compared with.

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
import concurrent.futures
import dataclasses
import importlib.abc
import io
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import torch

# cuBLAS's deterministic workspace, set before CUDA initialises: phase 19
# runs a training run under torch.use_deterministic_algorithms(True).
os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"


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
K6_SOURCE = "dynseg_torch/csrc/max_pool_fwd.cu"
K6_REPLACES = "none in Pallas: lax.reduce_window on int8, dynseg/ops/quant.py:192-220"
K7_SOURCE = "dynseg_torch/csrc/act_quantize.cu"
K7_REPLACES = "none in Pallas: jnp.round(jnp.clip(x / sx, -127, 127)), dynseg/ops/quant.py:103"
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
# K6's six pools in a dense int8 forward of dilated_grsl_rate8 (quant_min_ch
# 128, no int8 exit): (channels, mode) of blocks 0-5.
K6_POOLS = ((64, "f32"), (64, "f32"), (128, "f32_i8"), (128, "i8"), (192, "i8"), (192, "f32"))
# K7's shapes: the int8 blocks' concat prefixes of dilated_icpr_rate6_densely's
# feature buffer (13 zero lead channels, 3 bands, six slots: 912 channels).
K7_PREFIXES, K7_BUFFER = (144, 272, 400, 656), 912
# The command line: iterations of the first training run and of the resume.
CLI_NITER, CLI_RESUME_NITER, CLI_EVERY = 40, 60, 20
# Phase 14's window-mode tile, and phase 16's short pallas run.
TTA_TILE, BF16_PALLAS_STEPS = 512, 5
# Phase 17's K5 shapes, (batch, side): a dense call at the server's
# defaults (8 blocks of 1024 + 2 * 40 halo pixels a side) and window
# batches of the largest scale; samples per plain-version call.
SERVE_K5_SHAPES = ((8, 1104), (64, 65), (128, 65))
SERVE_K5_PLAIN_CHUNK = 2
# Phase 18: the steps' scales, a rank's batch, and the row orders of one
# device's reruns that measure its float32 noise.
DP_SIZES = (25, 65, 25)
DP_HALF_BATCH = TRAIN_BATCH // 2
DP_REORDER_SEEDS = (9, 10, 11, 12)
# A short window batch, as a scale's last batch was before it was padded.
DP_SHORT_BATCH = 37
# Where the ranks run: one card, NCCL for the world of one rank.
DP_DEVICE, DP_ONE_BACKEND = "cuda:0", "nccl"
# Phase 19: the same-seed training runs (steps, and steps after a
# restore), the steps timed per scale and cuDNN mode, the crop of phase
# 3's tile for serving, and the fold runs' iterations per fold.
REPRO_STEPS, REPRO_RESUME_STEPS, REPRO_TIMED, REPRO_CROP = 12, 4, 5, 512
FOLDS_NITER = 10
# Phase 20: blocks 1-2 of dilated_icpr_rate6 at width 1.0, which
# quant_min_ch 64 also quantizes (the default 128 leaves them float).
LOW_GEOMETRIES = (("block1", 64, 64, 5, 2, True), ("block2", 64, 128, 4, 3, True))
# Phase 21: the rehearsals in order, each with the arguments it runs with,
# and the batches of stress_scale's buckets, 100 x (25 / s)^2 for s =
# 25..65. Every probe runs at its defaults (the scripts' own) but for one
# cut through its own flags, which the script's time limit forces:
# profile_multitile votes over scales 25 and 65, not all five (its window
# passes take ~38 s each at five scales on the H100, PERF.md §4).
REHEARSALS = (("stress_scale", ()), ("profile_multitile", ("--scales", "25,65")),
              ("sweep_dense", ()))
STRESS_BATCHES = (100, 51, 31, 21, 15)
# Phase 22: the accuracy studies in order, each cut through its own flags
# only (fewer seeds, configs and iterations); ema_recalib_probe reads the
# EMA cell that diagnose_collapse keeps, so the two share a lane; the
# other studies run side by side. The top-level keys of each script's
# JSON (of each row, for parity_bracket's list; the CPU tests hold every
# level of each JSON byte for byte to the script's). K2's buckets that the studies' batch of 64
# rescaled by area gives at s = 25..65 (mode_gap's multinomial regime).
STUDIES = (
    ("sched_ablation", ("--values", "25,65", "--distributions", "multinomial",
                        "--seeds", "1", "--niter", "300", "--rescale_batch_by_area")),
    ("mode_gap", ("--seeds", "1", "--niter", "300")),
    ("bf16_eval", ("--seeds", "1", "--niter", "300")),
    ("parity_bracket", ("--dataset", "synthetic_texture", "--combos", "2", "--seeds", "1",
                        "--niter", "100")),
    ("diagnose_collapse", ("--runs", "multinomial:0", "--niter", "300", "--eval_every",
                           "100", "--ema_decay", "0.999", "--keep_checkpoints",
                           "--workdir", os.path.join(OUT_DIR, "collapse"))),
    ("ema_recalib_probe", ("--ckpt", os.path.join(OUT_DIR, "collapse", "multinomial_s0"),
                           "--seed", "0", "--recalib_batches", "25,50")),
)
STUDY_KEYS = {
    "sched_ablation": {"dataset", "values", "niter", "batch_size", "seeds", "seed_start",
                       "net_type", "update_type", "sched_temperature", "distributions",
                       "tag", "rescale_batch_by_area", "dataset_kwargs", "results"},
    "mode_gap": {"dataset", "niter", "seeds", "rows", "summary"},
    "bf16_eval": {"window_oa_f32", "window_oa_bf16", "dense_oa_f32", "dense_oa_bf16",
                  "per_seed", "protocol"},
    "parity_bracket": {"favor_high_score", "update_type", "leaky_slope", "use_batch_norm",
                       "mean_f1", "per_seed"},
    "diagnose_collapse": {"tag", "dataset", "dataset_kwargs", "niter", "batch_size",
                          "learning_rate", "lr_decay_rate", "lr_decay_steps",
                          "no_batch_norm", "bn_momentum", "compute_dtype", "ema_decay",
                          "width_multiplier", "eval_every", "results", "partial"},
    "ema_recalib_probe": {"ckpt", "step", "seed", "ema_decay", "raw_final", "ema_live_bn",
                          "ema_recalibrated"},
}
STUDY_BUCKETS = {(64, 25), (33, 35), (20, 45), (13, 55), (9, 65)}
# Phase 23: one run of the paired scheduler ablation, cut as phase 22's.
PAIRED_RUN = ("--values", "35", "--distributions", "", "--seeds", "1", "--niter", "300",
              "--batch_size", "64", "--rescale_batch_by_area")
_LOG_LOCK = threading.Lock()


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


def config(mode: str, quant: str, scales=SCALES, dtype: str = "float32", **infer_kw):
    from dynseg_torch.config import Config, InferConfig, ModelConfig

    return Config(
        model=ModelConfig(net_type="dilated_icpr_rate6", num_classes=2,
                          num_input_bands=3, width_multiplier=1.0,
                          compute_dtype=dtype),
        infer=InferConfig(scales=scales, mode=mode, quant=quant,
                          dense_block=256, dense_halo=40,
                          save_prediction_maps=False, **infer_kw))


def with_dtype(cfg, dtype: str = "bfloat16"):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype=dtype))


def mpx_s(tiles, scores) -> float:
    return float(np.prod(tiles.valid_hw, axis=1).sum()) / scores["infer_wall_s"] / 1e6


def agreement(a: dict, b: dict) -> float:
    """Share of equal labels over the tiles of two validate_test runs."""
    return float(np.mean([np.mean(x == y) for x, y in
                          zip(a["predictions"], b["predictions"], strict=True)]))


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
    from dynseg_torch.ops import pool

    t0 = time.perf_counter()
    tiles1k = load_synthetic(seed=0, num_tiles=2, size=WINDOW_TILE)[1]
    tiles2k = load_synthetic(seed=1, num_tiles=2, size=DENSE_TILE)[1]
    log(f"synthetic tiles made in {time.perf_counter() - t0:.1f} s")
    runs = (("window float", config("window", "none"), tiles1k),
            ("window int8", config("window", "int8"), tiles1k),
            ("dense int8", config("dense", "int8"), tiles2k))
    int8_forwards = 0
    int8_conv.reset_launches()
    pool.reset_launches()
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
    fwd = dict(pool.fwd_launches)
    log(f"K6 launches: {fwd} (2 i8 and 1 f32_i8 x {int8_forwards} int8 forwards; "
        f"f32 besides in the calibrations)")
    if fwd["i8"] != 2 * int8_forwards or fwd["f32_i8"] != int8_forwards:
        raise SystemExit("K6 launch count does not match the int8 forwards")
    launches = int8_conv.launches
    log(f"K5 launches on the main path: {launches} "
        f"(3 quantized blocks x {int8_forwards} int8 forwards), by variant "
        f"{int8_conv.variant_launches}")
    if launches == 0 or launches != 3 * int8_forwards:
        raise SystemExit("K5 launch count does not match the int8 forwards")
    if int8_conv.variant_launches["wgmma"] != launches:
        raise SystemExit("K5: a serving block did not take the wgmma variant")
    return {"launches": launches, "runs": runs, "scores": all_scores,
            "k6_launches": fwd}


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


def check_max_pool_fwd_kernel(pool) -> dict:
    """Phase 2b: K6 kernel vs plain, bitwise, at the six pools of a dense
    int8 forward of dilated_grsl_rate8 (8 x 336^2), each timed (device
    time, CUDA-graph replay) beside its byte bound, the plain composition
    (what the int8 forward ran before K6) and ATen's float32 max_pool2d at
    the same shape (library_ms; ATen pools no int8 on the card). Values
    on a 1/16 grid give ties."""
    dev = torch.device(DEVICE)
    total, bounds = collections.Counter(), collections.Counter()
    for c, mode in K6_POOLS:
        shape = (DENSE_BATCH, DENSE_EXT, DENSE_EXT, c)
        gen = torch.Generator(dev).manual_seed(c + len(mode))
        xf = torch.round(torch.randn(shape, device=dev, generator=gen) * 64) / 16
        sx = torch.tensor(0.0371, device=dev) if mode == "f32_i8" else None
        x = pool.quantize_act(xf, torch.tensor(0.25, device=dev)) if mode == "i8" else xf
        xc = x.permute(0, 3, 1, 2)
        before = pool.fwd_launches[mode]
        got = pool.max_pool_fwd(xc, 3, sx).permute(0, 2, 3, 1)
        want = pool.max_pool_fwd_ref(x, 3, sx)
        torch.cuda.synchronize()
        if not torch.equal(got, want) or pool.fwd_launches[mode] != before + 1:
            raise SystemExit(f"K6 {shape} {mode}: kernel disagrees with plain")
        ms = graph_ms(lambda: pool.max_pool_fwd(xc, 3, sx))
        plain = graph_ms(lambda: pool.max_pool_fwd_ref(x, 3, sx))
        xl = xf.permute(0, 3, 1, 2)
        aten = graph_ms(lambda: torch.nn.functional.max_pool2d(xl, 3, 1, 1))
        # Each input value read once and each output value written once.
        nbytes = x.numel() * (x.element_size() + got.element_size())
        bound, bound_by = bound_ms(9.0 * x.numel(), nbytes, F32_PEAK)
        log(f"K6 max_pool_s1 fwd {shape} {mode}: == plain bitwise; {ms:.4f} ms (device), "
            f"{nbytes / ms / 1e6:.0f} GB/s, bound {bound:.4f} ms ({bound_by}), "
            f"{bound / ms:.3f} of the bound; plain {plain:.4f} ms; ATen f32 max_pool2d "
            f"{aten:.4f} ms")
        total.update(ms=ms, plain_ms=plain, library_ms=aten)
        bounds[bound_by] += bound
        del x, xf, got, want
    log(f"K6 over the six pools: {total['ms']:.4f} ms against a bound of "
        f"{sum(bounds.values()):.4f} ms ({sum(bounds.values()) / total['ms']:.3f}); plain "
        f"{total['plain_ms']:.4f} ms, ATen f32 {total['library_ms']:.4f} ms")
    torch.cuda.empty_cache()
    return {"max_abs_err": 0.0, "ms": total["ms"], "plain_ms": total["plain_ms"],
            "library_ms": total["library_ms"], **bound_totals(bounds)}


def check_quantize_kernel(pool) -> dict:
    """Phase 2c: K7 kernel vs plain, bitwise, on the densely net's four
    concat prefixes of a dense batch's feature buffer (read in place), in
    float32 (the cell's) and bfloat16, each timed (device time, CUDA-graph
    replay) beside its byte bound and the plain composition (what the
    dense forward ran before K7); then K7's launches in one int8 forward
    of the net, against the same forward on the plain composition."""
    from dynseg_torch.ops import quant

    dev = torch.device(DEVICE)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        shape = (DENSE_BATCH, DENSE_EXT, DENSE_EXT, K7_BUFFER)
        gen = torch.Generator(dev).manual_seed(len(name))
        sx = torch.tensor(0.0371, device=dev)
        buf = (torch.round(torch.randn(shape, device=dev, generator=gen) * 1024) / 128
               * sx).to(dtype)
        buf[..., :13] = 0
        fm = buf.permute(0, 3, 1, 2)
        total, bounds = collections.Counter(), collections.Counter()
        for c in K7_PREFIXES:
            before = dict(pool.quantize_launches)
            got = pool.quantize_s8(fm[:, :c], sx).permute(0, 2, 3, 1)
            want = pool.quantize_act(buf[..., :c], sx)
            torch.cuda.synchronize()
            if (not torch.equal(got, want)
                    or pool.quantize_launches["vec16"] != before["vec16"] + 1):
                raise SystemExit(f"K7 {shape[:3]} C {c} {name}: kernel disagrees with "
                                 f"plain, or left the 16-byte path")
            ms = graph_ms(lambda: pool.quantize_s8(fm[:, :c], sx))
            plain = graph_ms(lambda: pool.quantize_act(buf[..., :c], sx))
            # Each input value read once and each code written once.
            nbytes = got.numel() * (buf.element_size() + 1)
            bound, bound_by = bound_ms(got.numel(), nbytes, F32_PEAK)
            log(f"K7 quantize_s8 {shape[:3]} C {c} of {K7_BUFFER} {name}: == plain bitwise; "
                f"{ms:.4f} ms (device), {nbytes / ms / 1e6:.0f} GB/s, bound {bound:.4f} ms "
                f"({bound_by}), {bound / ms:.3f} of the bound; plain {plain:.4f} ms")
            total.update(ms=ms, plain_ms=plain)
            bounds[bound_by] += bound
            del got, want
        log(f"K7 over the four prefixes ({name}): {total['ms']:.4f} ms against a bound of "
            f"{sum(bounds.values()):.4f} ms ({sum(bounds.values()) / total['ms']:.3f}); "
            f"plain {total['plain_ms']:.4f} ms")
        if dtype == torch.float32:
            out = {"max_abs_err": 0.0, "ms": total["ms"], "plain_ms": total["plain_ms"],
                   **bound_totals(bounds)}
        else:
            out.update(bf16_ms=total["ms"], bf16_plain_ms=total["plain_ms"])
        del buf, fm
    torch.cuda.empty_cache()

    from dynseg_torch.config import ModelConfig

    mcfg = ModelConfig(net_type="dilated_icpr_rate6_densely", num_classes=6)
    weights = {k: v.to(dev) for k, v in seeded_weights(mcfg, 3).items()}
    x = torch.randn((DENSE_BATCH, DENSE_EXT, DENSE_EXT, 3), device=dev,
                    generator=torch.Generator(dev).manual_seed(7))
    qsd = quant.quantize_variables(mcfg, weights, quant.calibrate(mcfg, weights, [x[:1]]))
    apply_fn = quant.make_apply(mcfg)
    with torch.inference_mode():
        apply_fn(qsd, x)
        pool.reset_launches()
        got = apply_fn(qsd, x)
        out["launches"] = dict(pool.quantize_launches)
        kernel = quant.quantize_s8
        quant.quantize_s8 = pool.quantize_act
        try:
            want = apply_fn(qsd, x)
        finally:
            quant.quantize_s8 = kernel
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    log(f"K7 launches in one densely int8 forward of {tuple(x.shape)}: "
        f"{out['launches']}; logits == plain composition's bitwise: {same}")
    if out["launches"] != {"vec16": 4, "scalar": 0} or not same:
        raise SystemExit("K7: the densely int8 forward left the kernel's 16-byte path "
                         "or disagrees with the plain composition")
    del weights, qsd, x, got, want
    torch.cuda.empty_cache()
    return out


def train_config(pool_backward: str, niter: int, ema: bool, width: float = 1.0,
                 scales=SCALES, batch: int = TRAIN_BATCH, dtype: str = "float32"):
    from dynseg_torch.config import (Config, DataConfig, InferConfig,
                                     ModelConfig, SchedulerConfig, TrainConfig)

    return Config(
        model=ModelConfig(net_type="dilated_icpr_rate6", num_classes=2,
                          num_input_bands=3, width_multiplier=width,
                          pool_backward=pool_backward, compute_dtype=dtype),
        sched=SchedulerConfig(distribution_type="multinomial", values=scales),
        train=TrainConfig(batch_size=batch, niter=niter, eval_every=EVAL_EVERY,
                          ema_decay=0.9 if ema else 0.0,
                          ema_recalib_batches=RECALIB if ema else 0,
                          output_path=f"{OUT_DIR}/smoke_train_{pool_backward}_{dtype}"),
        infer=InferConfig(scales=scales, save_prediction_maps=False),
        data=DataConfig(dataset="synthetic", dataset_kwargs=json.dumps(
            {"size": TRAIN_TILE, "num_tiles": 4})))


def check_train_step_against_cpu(dtype: str = "float32") -> None:
    """Phase 6 (float32) and 16 (bfloat16): one train step on the card and
    on the CPU."""
    from dynseg_torch.data.datasets import load_synthetic
    from dynseg_torch.train import Trainer

    pb = "pallas" if dtype == "float32" else "xla"
    cfg = train_config(pb, 1, False, width=0.25, scales=(25,), batch=8, dtype=dtype)
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
    log(f"train step width 0.25, 8 x 25^2, {dtype}, pool_backward {pb}: card vs CPU "
        f"loss {lg:.7f} vs {lc:.7f} (rel {rel:.2e}), max|dparam| {dp:.2e}")
    # float32 (TF32 off): sums in another order, 1e-5 / 1e-6. bfloat16:
    # cuDNN's and the CPU's bf16 convs round their sums apart, the bounds
    # of tests/test_torch_train.py's bfloat16 step: 1e-2 / 5e-3.
    loss_tol, param_tol = (1e-5, 1e-6) if dtype == "float32" else (1e-2, 5e-3)
    if not (math.isfinite(lg) and rel <= loss_tol and dp <= param_tol):
        raise SystemExit(f"train step {dtype}: card and CPU disagree")


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
            start("info", ["--operation", "info"]),
            start("testing_tta_bf16", ["--operation", "testing", "--tta", "--compute_dtype",
                                       "bfloat16", "--inference_mode", "dense",
                                       "--no_prediction_maps"])]
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

        lines = finish(jobs[3], " (beside int8 testing, predict and info)",
                       ends.get("testing_tta_bf16"))
        total(lines, "testing_tta_bf16")
        expect("testing_tta_bf16", lines, int8_block_conv=0, patch_gather=0, pool_bwd=0)
    finally:
        for _, _, proc, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {"walls": walls, "k5": k5, "differ": differ}


class _LivePredictor:
    """The live net behind the artifact interface the serving engine
    calls (`probs_device`), so that the artifact and the net in this
    process go through the same dense blocks."""

    def __init__(self, manifest: dict, forward):
        self.manifest, self.forward = manifest, forward

    def has(self, name: str) -> bool:
        return name != "dense_labels"

    @torch.inference_mode()
    def probs_device(self, x):
        return self.forward(torch.from_numpy(np.ascontiguousarray(x)).to(DEVICE))


def check_k5_serve_shapes(int8_conv, shapes=SERVE_K5_SHAPES, what="serve",
                          geometries=GEOMETRIES) -> float:
    """Phase 17, first: K5's serving variant (wgmma) vs plain, bitwise, at
    the shapes the serve path gives it (SERVE_K5_SHAPES), for each block
    with the requant of the int8 exit's route and block 5 with its
    float32 store too; phase 18 at a rank's shapes, phase 20 at blocks
    1-2's `geometries`. The data is made on the card from a seed; the
    plain version runs SERVE_K5_PLAIN_CHUNK samples a call. Returns the
    largest difference."""
    gen = torch.Generator(device=DEVICE).manual_seed(17)

    def codes(shape, mean, std):
        return (torch.randn(shape, generator=gen, device=DEVICE) * std + mean
                ).round_().clamp_(-127, 127).to(torch.int8)

    worst = 0.0
    for name, cin, cout, k, dil, requant in geometries:
        w = codes((k, k, cin, cout), 0, 35)
        a = (torch.rand(cout, generator=gen, device=DEVICE) + 0.5) / (
            math.sqrt(k * k * cin) * 38 * 35)
        b = torch.randn(cout, generator=gen, device=DEVICE) * 0.1
        for out_scale in ((3.0 / 127,) if requant else (3.0 / 127, None)):
            pc = int8_conv.pack_conv(w, a, b, dilation=dil, leaky_slope=0.1,
                                     out_scale=out_scale)
            if pc.variant != "wgmma":
                raise SystemExit(f"K5 {name}: the serving block does not take wgmma")
            for bsz, side in shapes:
                x = torch.empty((bsz, side, side, cin), dtype=torch.int8, device=DEVICE)
                for i in range(bsz):
                    x[i] = codes((side, side, cin), 10, 38)
                got = int8_conv.int8_block_conv_packed(x, pc)
                ms = time_ms(lambda: int8_conv.int8_block_conv_packed(x, pc), 3)
                diff = 0.0
                for i in range(0, bsz, SERVE_K5_PLAIN_CHUNK):
                    want = int8_conv.int8_block_conv_packed_ref(
                        x[i:i + SERVE_K5_PLAIN_CHUNK], pc)
                    part = got[i:i + SERVE_K5_PLAIN_CHUNK]
                    if not torch.equal(part, want):
                        diff = max(diff, (part.float() - want.float()).abs().max().item())
                    del want, part
                macs = bsz * side * side * k * k * cin * cout
                bound, bound_by = bound_ms(2.0 * macs, x.numel() + pc.w.numel()
                                           + got.numel() * got.element_size() + 8 * cout,
                                           INT8_PEAK)
                store = str(pc.store_dtype).removeprefix("torch.")
                log(f"K5 {name} at {what} shape x({bsz},{side},{side},{cin}) -> {store} "
                    f"({got.numel()} elements): kernel == plain bitwise: "
                    f"{diff == 0}; {ms:.4f} ms, {bound / ms:.3f} of the bound "
                    f"{bound:.4f} ms ({bound_by})")
                if diff != 0:
                    raise SystemExit(f"K5 {name} at x({bsz},{side},{side},{cin}): kernel "
                                     f"disagrees with plain ({diff})")
                worst = max(worst, diff)
                del x, got
                torch.cuda.empty_cache()
    return worst


def _live_forward(out: str, argv: list):
    """The checkpoint under `out` restored in this process by the code the
    export ran (`cli.restore_for_serving` on the export's flags `argv`):
    the served variables and, for int8, the calibration on the test
    tiles. Returns raw pixels -> softmax on the card."""
    from dynseg_torch import cli
    from dynseg_torch.models.dilated import build_model
    from dynseg_torch.ops import quant as quant_ops

    args = cli.build_argparser().parse_args(["--output_path", out, *argv])
    r = cli.restore_for_serving(cli.config_from_args(args), lambda *_: None,
                                device=DEVICE)
    mean = torch.tensor(r.stats["mean"], dtype=torch.float32, device=DEVICE)
    std = torch.tensor(r.stats["std"], dtype=torch.float32, device=DEVICE)
    if r.quant_variables is not None:
        apply = quant_ops.make_apply(r.cfg.model)
        net = lambda x: apply(r.quant_variables, x)  # noqa: E731
    else:
        model = build_model(r.cfg.model, r.cfg.model.num_input_bands).to(DEVICE)
        model.load_state_dict(r.variables)
        net = model
    return lambda x: torch.softmax(net((x.float() - mean) / std).float(), dim=-1)


def run_export_serve(int8_conv, card: str) -> dict:
    """Phase 17: K5 at the serve path's shapes, then --operation export
    (bfloat16, and int8 with the int8 exit) from phase 11's checkpoint,
    each artifact against the live net on the card, then --operation
    serve over each, answered requests held to an in-process
    ServingEngine on the same artifact, and a SIGTERM drain."""
    import urllib.request

    from dynseg_torch import cli
    from dynseg_torch.export import ExportedPredictor
    from dynseg_torch.serve import ServingEngine

    max_err = check_k5_serve_shapes(int8_conv)
    cli_window_batch = cli.build_argparser().get_default("window_batch")
    root = os.path.dirname(os.path.abspath(__file__))
    base = os.path.join(root, OUT_DIR, "cli")
    dirs = {"bf16": os.path.join(root, OUT_DIR, "export_bf16"),
            "int8": os.path.join(root, OUT_DIR, "export_int8")}
    for d in dirs.values():  # both write <output_path>/export: two copies
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(base, d, ignore=shutil.ignore_patterns("export", "*.png", "rasters"))
    common = ["--device", DEVICE, "--dataset", "synthetic", "--dataset_kwargs",
              json.dumps({"size": TRAIN_TILE, "num_tiles": 4}),
              "--values", ",".join(map(str, SCALES))]
    flags = {name: ["--operation", "export", "--export_platforms", "cuda,cpu",
                    *extra, *common]
             for name, extra in (("bf16", []), ("int8", ["--quant", "int8", "--quant_exit"]))}
    t0 = time.perf_counter()
    procs = {}
    for name, d in dirs.items():
        with open(os.path.join(root, OUT_DIR, f"export_{name}.log"), "w") as f:
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "dynseg_torch", "--output_path", d, *flags[name]],
                stdout=f, stderr=subprocess.STDOUT, cwd=root)
    try:
        for name, proc in procs.items():
            rc = proc.wait(timeout=600)
            with open(os.path.join(root, OUT_DIR, f"export_{name}.log")) as f:
                text = f.read()
            if rc != 0:
                print(text[-3000:], file=sys.stderr)
                raise SystemExit(f"export {name} exited {rc}")
            log(f"CLI export {name}: exit 0, wall {time.perf_counter() - t0:.1f} s "
                f"(both exports side by side) [{card}]")
            log("  " + next(m for m in text.splitlines()
                            if "exported serving artifact" in m))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    m_entries = ("probs", "probs_u8", "dense_labels")
    rng = np.random.default_rng(17)
    raster = rng.integers(0, 256, (2048, 2048, 3), dtype=np.uint8)
    small = rng.integers(0, 256, (512, 512, 3), dtype=np.uint8)
    out = {}
    for name, d in dirs.items():
        exp = os.path.join(d, "export")
        t1 = time.perf_counter()
        pred = ExportedPredictor.load(exp, device=DEVICE)
        for entry in m_entries:
            pred._fn(entry)  # deserialize onto the card now, to time it
        t_load = time.perf_counter() - t1
        m = pred.manifest
        sizes = {a["file"]: os.path.getsize(os.path.join(exp, a["file"]))
                 for a in m["artifacts"].values()}
        log(f"artifact {name}: compute_dtype {m['compute_dtype']}, quant_blocks "
            f"{m['quant_blocks']}, quant_exit {m['quant_exit']}, platforms "
            f"{m['platforms']}, custom_ops {m.get('custom_ops', [])}, bytes {sizes}; "
            f"checksums and the three programs loaded onto the card in {t_load:.2f} s")
        if m["platforms"] != ["cuda", "cpu"]:
            raise SystemExit(f"artifact {name}: not checked on cuda and cpu")
        live = _LivePredictor(m, _live_forward(d, flags[name]))
        calls = []
        probs_device = pred.probs_device
        pred.probs_device = lambda x, f=probs_device: calls.append(len(x)) or f(x)
        int8_conv.reset_launches()
        got = ServingEngine(pred).dense(raster)
        launches, variants = int8_conv.launches, dict(int8_conv.variant_launches)
        pred.probs_device = probs_device
        want = ServingEngine(live).dense(raster)
        dp = float(np.abs(got - want).max())
        differ = got.argmax(-1) != want.argmax(-1)
        top2 = np.sort(want, axis=-1)[..., -2:]
        near = bool((top2[differ, 1] - top2[differ, 0] < 1e-2).all())
        log(f"artifact {name} vs live net, 2048^2 in dense blocks (calls {calls}): "
            f"max|dprob| {dp:.3e}, labels differing {int(differ.sum())} (all near a "
            f"tie: {near}); K5 launches {launches} {variants}")
        if name == "bf16" and (dp > 1e-2 or not near):
            raise SystemExit("bf16 artifact disagrees with the live net")
        if name == "int8" and (dp > 1e-5 or launches != 3 * len(calls)
                               or variants["wgmma"] != launches):
            raise SystemExit("int8 artifact: disagrees with the live forward, or K5 "
                             "was not launched 3 times (wgmma) per forward")
        out[name] = {"pred": pred, "dir": d}
        del live
        torch.cuda.empty_cache()

    for name, rec in out.items():
        log_path = os.path.join(root, OUT_DIR, f"serve_{name}.log")
        with open(log_path, "w") as f:
            proc = subprocess.Popen(
                [sys.executable, "-m", "dynseg_torch", "--operation", "serve",
                 "--output_path", rec["dir"], "--serve_port", "0", *common],
                stdout=f, stderr=subprocess.STDOUT, cwd=root)
        try:
            t0 = time.perf_counter()
            url = None
            while True:
                if proc.poll() is not None:
                    with open(log_path) as f:
                        print(f.read()[-3000:], file=sys.stderr)
                    raise SystemExit(f"serve {name} exited {proc.returncode} before ready")
                if time.perf_counter() - t0 > 300:
                    raise SystemExit(f"serve {name}: not ready in 300 s")
                if url is None:  # the port the OS gave the server
                    with open(log_path) as f:
                        listening = re.search(r"^listening: .* on (http://\S+:\d+) ",
                                              f.read(), re.M)
                    url = listening and listening.group(1)
                    time.sleep(0.2)
                    continue
                try:
                    urllib.request.urlopen(f"{url}/healthz", timeout=2).read()
                    break
                except OSError:
                    time.sleep(0.2)
            ready = time.perf_counter() - t0
            with open(log_path) as f:
                warm = next(m for m in f.read().splitlines() if m.startswith("warm-up done"))
            answers, lat = {}, {}
            for key, query, img in (("dense labels", "mode=dense&output=labels", raster),
                                    ("window probs", "mode=window&output=probs", small)):
                buf = io.BytesIO()
                np.save(buf, img)
                t1 = time.perf_counter()
                body = urllib.request.urlopen(urllib.request.Request(
                    f"{url}/predict?{query}", data=buf.getvalue(),
                    headers={"Content-Type": "application/x-npy"}), timeout=600).read()
                lat[key] = time.perf_counter() - t1
                answers[key] = np.load(io.BytesIO(body))
            metrics = json.loads(urllib.request.urlopen(f"{url}/metrics", timeout=10).read())
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        with open(log_path) as f:
            text = f.read()
        stopped = [m for m in text.splitlines() if m.startswith("server stopped")]
        if rc != 0 or not stopped:
            print(text[-3000:], file=sys.stderr)
            raise SystemExit(f"serve {name}: SIGTERM drain exit {rc}")
        # The server's K5 launches over the two requests: it reset its
        # count after the warm-up and prints it at stop.
        served = re.search(r"K5 launches (\d+)", stopped[0])
        rec["launches"] = int(served.group(1)) if served else 0
        # The same requests through an in-process engine on the artifact,
        # at the server's settings: the CLI's --window_batch, the rest
        # serve's defaults.
        eng = ServingEngine(rec["pred"], window_batch=cli_window_batch)
        int8_conv.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        want_l, _ = eng.predict(raster, mode="dense", want_probs=False)
        t_dense = time.perf_counter() - t1
        t1 = time.perf_counter()
        _, want_p = eng.predict(small, mode="window")
        t_window = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated()
        engine_launches = int8_conv.launches
        same_l = np.array_equal(answers["dense labels"], want_l)
        dp = float(np.abs(answers["window probs"] - want_p).max())
        log(f"serve {name}: ready in {ready:.1f} s ({warm}), exit 0 after SIGTERM "
            f"({stopped[0]}) [{card}]")
        for key, img in (("dense labels", raster), ("window probs", small)):
            px = img.shape[0] * img.shape[1]
            log(f"  POST {key} {img.shape[0]}^2: {lat[key]:.4f} s, "
                f"{px / lat[key] / 1e6:.3f} Mpx/s")
        log(f"  in-process engine (first calls of the dense labels shapes): dense labels "
            f"{t_dense:.4f} s, window probs {t_window:.4f} s; device peak {peak} "
            f"bytes; K5 launches {engine_launches} (the server's: {rec['launches']})")
        log(f"  /metrics {json.dumps(metrics)}")
        log(f"  answers == in-process engine: labels bitwise {same_l}, "
            f"probs max|d| {dp:.2e}")
        if not same_l or dp > 1e-6:
            raise SystemExit(f"serve {name}: answers differ from the in-process engine")
        if rec["launches"] != engine_launches or (name == "int8") != (rec["launches"] > 0):
            raise SystemExit(f"serve {name}: the server launched K5 {rec['launches']} "
                             f"times, the in-process engine {engine_launches}")
    return {"serve_launches": out["int8"]["launches"], "max_abs_err": max_err}


def check_k5_bf16_out(int8_conv) -> dict:
    """Phase 12: K5 with the bfloat16 store vs plain, bitwise, at phase 2's
    geometries in both variants, each timed beside the float32 store of
    the same launch shape; then dp4a at a ragged shape."""
    rng = np.random.default_rng(12)
    dev = torch.device(DEVICE)
    bsz, ext = DENSE_BATCH, DENSE_EXT
    total, bounds = collections.Counter(), collections.Counter()
    for name, cin, cout, k, dil, _ in GEOMETRIES:
        x = np.clip(np.rint(rng.normal(10, 38, (bsz, ext, ext, cin))), -127, 127)
        w = np.clip(np.rint(rng.normal(0, 35, (k, k, cin, cout))), -127, 127)
        a = rng.uniform(0.5, 1.5, cout) / (math.sqrt(k * k * cin) * 38 * 35)
        b = rng.normal(0, 0.1, cout)
        xq = torch.from_numpy(x.astype(np.int8)).to(dev)
        operands = (torch.from_numpy(w.astype(np.int8)).to(dev),
                    torch.from_numpy(a.astype(np.float32)).to(dev),
                    torch.from_numpy(b.astype(np.float32)).to(dev))
        pcs = {dt: int8_conv.pack_conv(*operands, dilation=dil, leaky_slope=0.1,
                                       out_dtype=dt) for dt in (torch.float32, torch.bfloat16)}
        want = int8_conv.int8_block_conv_packed_ref(xq, pcs[torch.bfloat16])
        if not torch.equal(want, int8_conv.int8_block_conv_packed_ref(
                xq, pcs[torch.float32]).to(torch.bfloat16)):
            raise SystemExit(f"K5 {name}: plain bf16 store is not the f32 value rounded once")
        macs = bsz * ext * ext * k * k * cin * cout
        bound, bound_by = bound_ms(2.0 * macs, xq.numel() + operands[0].numel()
                                   + 2 * want.numel() + 8 * cout, INT8_PEAK)
        times = {}
        for variant, reps in (("wgmma", 20), ("dp4a", 5)):
            got = int8_conv.int8_block_conv_packed(xq, pcs[torch.bfloat16], variant)
            torch.cuda.synchronize()
            if got.dtype != torch.bfloat16 or not torch.equal(got, want):
                raise SystemExit(f"K5 {name} {variant} bf16 out: kernel disagrees with plain")
            del got
            for dt in (torch.bfloat16, torch.float32):
                times[variant, dt] = time_ms(
                    lambda: int8_conv.int8_block_conv_packed(xq, pcs[dt], variant), reps)
        log(f"K5 bf16 out {name} {cin}->{cout} k{k} d{dil} x({bsz},{ext},{ext},{cin}): "
            f"every variant == plain bitwise (max|y| {want.abs().max().item():.3g}); "
            f"bound {bound:.4f} ms ({bound_by})")
        for variant in ("wgmma", "dp4a"):
            bf, f32 = times[variant, torch.bfloat16], times[variant, torch.float32]
            log(f"    {variant:8s}: bf16 out {bf:.4f} ms, {bound / bf:.3f} of the bound; "
                f"f32 out {f32:.4f} ms; bf16 / f32 time {bf / f32:.3f}")
        total.update(ms=times["wgmma", torch.bfloat16])
        bounds[bound_by] += bound
        del xq, operands, pcs, want
    # The dense-wired net's block 3 input: 131 channels, dp4a only.
    x = torch.randint(-127, 128, (2, 48, 40, 131), dtype=torch.int8, device=dev)
    w = torch.randint(-127, 128, (4, 4, 131, 128), dtype=torch.int8, device=dev)
    a = torch.full((128,), 2e-6, device=dev)
    pc = int8_conv.pack_conv(w, a, torch.zeros_like(a), dilation=3, leaky_slope=0.1,
                             out_dtype=torch.bfloat16)
    got = int8_conv.int8_block_conv_packed(x, pc)
    same = pc.variant == "dp4a" and torch.equal(got, int8_conv.int8_block_conv_packed_ref(x, pc))
    log(f"K5 bf16 out ragged x(2,48,40,131) 131->128 k4 d3 ({pc.variant}): "
        f"kernel == plain bitwise: {same}")
    if not same:
        raise SystemExit("K5 bf16 out: dp4a disagrees with plain at the ragged shape")
    torch.cuda.empty_cache()
    return {"bf16_out_ms": total["ms"], "bf16_out_bound_ms": sum(bounds.values())}


def centred_weights(weights, mode: str, tiles) -> dict:
    """`weights` with the head's class-1 bias moved by the median log-odds
    of a float32 prediction of tile 0 in `mode`, so that the random net
    splits the tile between the two classes."""
    from dynseg_torch.infer import Inferencer

    inf = Inferencer(config(mode, "none"), tiles, device=DEVICE)
    _, prob = (inf.predict_tile_dense(weights, 0, 256, 40) if mode == "dense"
               else inf.predict_tile(weights, 0))
    odds = np.log(np.maximum(prob[..., 1], 1e-30)) - np.log(np.maximum(prob[..., 0], 1e-30))
    bias = weights["head.conv.bias"].clone()
    bias[1] -= float(np.median(odds))
    return {**weights, "head.conv.bias": bias}


def run_bf16_serving(weights, int8_conv, f32_runs, card):
    """Phase 13: phase 3's three validate_test runs with weights centred
    per mode, in float32, then under compute_dtype bfloat16 (K5 launches
    counted); returns the weights by mode, the float32 scores and K5's
    bf16-out launches."""
    from dynseg_torch.infer import validate_test

    centred = {mode: centred_weights(weights, mode, tiles)
               for mode, tiles in (("window", f32_runs[0][2]), ("dense", f32_runs[2][2]))}
    f32 = {}
    for name, cfg, tiles in f32_runs:
        f32[name] = validate_test(cfg, centred[cfg.infer.mode], tiles, DEVICE,
                                  log=lambda *_: None)
        share = float(np.mean(f32[name]["predictions"][0]))
        if not 0.05 < share < 0.95:
            raise SystemExit(f"{name}: the centred net still paints one class ({share})")
    int8_conv.reset_launches()
    int8_forwards = 0
    for name, cfg, tiles in f32_runs:
        cfg = with_dtype(cfg)
        t0 = time.perf_counter()
        scores = validate_test(cfg, centred[cfg.infer.mode], tiles, DEVICE,
                               log=lambda *_: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ref = f32[name]
        agree = agreement(scores, ref)
        pred = scores["predictions"][0]
        if cfg.infer.quant == "int8":
            int8_forwards += expected_forwards(cfg, tiles)
        log(f"{name} bf16: OA={scores['oa']:.4f} (f32 {ref['oa']:.4f}) "
            f"{mpx_s(tiles, scores):.3f} Mpx/s (f32 {mpx_s(tiles, ref):.3f}), call wall "
            f"{wall:.3f} s, class-1 share {pred.mean():.3f} (f32 "
            f"{ref['predictions'][0].mean():.3f}), label agreement with f32 {agree:.6f} [{card}]")
        if pred.shape != tuple(tiles.valid_hw[0]) or not 0 <= pred.min() <= pred.max() < 2:
            raise SystemExit(f"{name} bf16: malformed prediction map")
        # bfloat16 moves a label only near a tie (tests/test_torch_infer.py
        # bounds it at the reference); far fewer agreeing means a fault.
        if agree < 0.9:
            raise SystemExit(f"{name} bf16: labels far from the float32 run's")
    launches, out = int8_conv.launches, dict(int8_conv.out_launches)
    log(f"K5 launches on the bf16 serving runs: {launches} (3 x {int8_forwards} int8 "
        f"forwards), by output {out}, by variant {int8_conv.variant_launches}")
    if launches != 3 * int8_forwards or out != {"float32": 0, "int8": 2 * int8_forwards,
                                                "bfloat16": int8_forwards}:
        raise SystemExit("bf16 serving: K5 launches do not match the int8 forwards")
    if int8_conv.variant_launches["wgmma"] != launches:
        raise SystemExit("bf16 serving: a K5 launch did not take the wgmma variant")
    return centred, f32, out["bfloat16"]


def run_tta(centred, int8_conv, dense_run, dense_scores, card) -> None:
    """Phase 14: validate_test with tta on, in dense int8 on phase 3's
    2048^2 tile and in window float on a 512^2 tile, each beside the
    plain run: forwards counted at the net's apply."""
    from dynseg_torch import infer
    from dynseg_torch.data.datasets import load_synthetic

    small = load_synthetic(seed=3, num_tiles=2, size=TTA_TILE)[1]
    forwards = [0]
    probs = infer.Inferencer._probs

    def counted(self, *args, **kwargs):
        forwards[0] += 1
        return probs(self, *args, **kwargs)

    name, dcfg, dense_tiles = dense_run
    cases = (("window float", config("window", "none"), small, None,
              " (512^2 keeps 8x the window work inside the time limit)"),
             (name, dcfg, dense_tiles, dense_scores, ""))
    infer.Inferencer._probs = counted
    try:
        for name, cfg, tiles, plain, note in cases:
            weights = centred[cfg.infer.mode]
            if plain is None:
                forwards[0] = 0
                plain = infer.validate_test(cfg, weights, tiles, DEVICE, log=lambda *_: None)
                n_plain = forwards[0]
            else:
                n_plain = expected_forwards(cfg, tiles)
            int8_conv.reset_launches()
            forwards[0] = 0
            tcfg = dataclasses.replace(cfg, infer=dataclasses.replace(cfg.infer, tta=True))
            t0 = time.perf_counter()
            scores = infer.validate_test(tcfg, weights, tiles, DEVICE, log=lambda *_: None)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n_tta, k5 = forwards[0], int8_conv.launches
            side = tiles.valid_hw[0]
            log(f"TTA {name} on a {side[0]}x{side[1]} tile{note}: {n_tta} forwards (plain {n_plain}, 8x = {8 * n_plain}), OA={scores['oa']:.4f} "
                f"(plain {plain['oa']:.4f}), label agreement with plain {agreement(scores, plain):.6f}, "
                f"{mpx_s(tiles, scores):.3f} Mpx/s (plain {mpx_s(tiles, plain):.3f}), call wall "
                f"{wall:.3f} s, K5 launches {k5} [{card}]")
            pred = scores["predictions"][0]
            if pred.shape != tuple(side) or not 0 <= pred.min() <= pred.max() < 2:
                raise SystemExit(f"TTA {name}: malformed prediction map")
            if n_tta != 8 * n_plain or k5 != (3 * n_tta if cfg.infer.quant == "int8" else 0):
                raise SystemExit(f"TTA {name}: forwards or K5 launches do not match 8 x plain")
    finally:
        infer.Inferencer._probs = probs


def check_streaming(weights, window_run, card) -> None:
    """Phase 15: window float with hbm_budget_gb=0 (tiles on the host, one
    uploaded a prediction) beside the resident run: label maps bitwise,
    device peak memory and Mpx/s of each."""
    from dynseg_torch.infer import Inferencer, validate_test

    _, cfg, tiles = window_run
    out = {}
    for label, budget in (("resident", cfg.infer.hbm_budget_gb), ("streamed", 0.0)):
        c = dataclasses.replace(cfg, infer=dataclasses.replace(cfg.infer, hbm_budget_gb=budget))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        scores = validate_test(c, weights, tiles, DEVICE, log=lambda *_: None)
        torch.cuda.synchronize()
        out[label] = (scores, torch.cuda.max_memory_allocated() - base)
        held = Inferencer(c, tiles, device=DEVICE).images
        log(f"window float {label} (hbm_budget_gb={budget}, tiles held as "
            f"{type(held).__module__}.{type(held).__name__}): {mpx_s(tiles, scores):.3f} Mpx/s, "
            f"device peak memory over the weights {out[label][1]} bytes [{card}]")
        if (budget == 0.0) != isinstance(held, np.ndarray):
            raise SystemExit(f"streaming: the {label} run held its tiles in the wrong place")
        del held
    same = all(np.array_equal(a, b) for a, b in zip(
        out["resident"][0]["predictions"], out["streamed"][0]["predictions"], strict=True))
    log(f"    streamed label maps == resident bitwise: {same}")
    if not same:
        raise SystemExit("streaming: label maps differ from the resident run's")


def run_bf16_training(gather, pool, f32_runs, card) -> None:
    """Phase 16: run_training under compute_dtype bfloat16 with
    pool_backward xla (TRAIN_STEPS steps, EMA + recalibration), then a
    short pallas run, which must warn; beside phase 7's float32 steps."""
    from dynseg_torch import cli, train

    losses = []
    step = train.Trainer.train_step

    def recording_step(self, state, size):
        state, m = step(self, state, size)
        losses.append(m["loss"])
        return state, m

    train.Trainer.train_step = recording_step
    steps = {}
    try:
        for pb, niter, ema in (("xla", TRAIN_STEPS, True), ("pallas", BF16_PALLAS_STEPS, False)):
            cfg = train_config(pb, niter, ema, dtype="bfloat16")
            losses.clear()
            gather.launches = 0
            pool.reset_launches()
            pool._warned.clear()
            t0 = time.perf_counter()
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                scores = cli.run_training(cfg, log=lambda *_: None, device=DEVICE)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            warned = sorted({str(r.message) for r in rec if "falling back to ATen" in str(r.message)})
            vals = [float(x) for x in losses]
            n_scales = len(cfg.sched.values)
            gathers = n_scales + niter + niter // EVAL_EVERY + (RECALIB if ema else 0)
            third = max(1, len(vals) // 3)
            head, tail = np.mean(vals[:third]), np.mean(vals[-third:])
            log(f"run_training bf16 pool_backward={pb}: {niter} steps + {n_scales} warm-up, "
                f"wall {wall:.1f} s, mean loss of the first {third} steps {head:.4f}, of the "
                f"last {third} {tail:.4f}, OA={scores['oa']:.4f}; K2 launches "
                f"{gather.launches} (expected {gathers}), K4 launches {pool.launches}, "
                f"{len(warned)} pool fallback warnings [{card}]")
            for msg in warned[:1]:
                log(f"    warned: {msg}")
            if not all(map(math.isfinite, vals)) or len(vals) != niter:
                raise SystemExit(f"bf16 {pb}: non-finite or missing losses {vals}")
            if niter == TRAIN_STEPS and not tail < head:
                raise SystemExit(f"bf16 {pb}: loss did not fall ({head} -> {tail})")
            if gather.launches != gathers or pool.launches != 0:
                raise SystemExit(f"bf16 {pb}: launch counts do not match the run")
            if (pb == "pallas") != bool(warned):
                raise SystemExit(f"bf16 {pb}: the pool fallback warning is wrong ({warned})")
            if not 0.0 <= scores["oa"] <= 1.0 or len(scores["predictions"]) != 2:
                raise SystemExit(f"bf16 {pb}: malformed scores")
            steps[pb] = scores["train_steps"]
    finally:
        train.Trainer.train_step = step
    log("ms/step and patches/s by scale, bf16 (xla) beside phase 7's float32 (pallas, xla):")
    for size, st in sorted(steps["xla"].items()):
        f32 = {pb: f32_runs[pb]["steps"].get(size) for pb in ("pallas", "xla")}
        cols = ", ".join(f"f32 {pb} {v['ms_per_step']:.3f} ms {v['patches_per_s']:.1f}/s"
                         if v else f"f32 {pb} not run" for pb, v in f32.items())
        log(f"  scale {size}: bf16 {st['ms_per_step']:.3f} ms ({st['steps']} steps) "
            f"{st['patches_per_s']:.1f}/s; {cols}")


def check_dp_kernel_shapes(gather, pool, int8_conv) -> None:
    """Phase 18, first: K2 and K4 vs plain, bitwise, at a rank's half
    batch: K2 gathering from a rank's block of two tiles with local ids,
    K4 (the fused variant the step takes) at 50 x s^2 x C; then K5 at a
    rank's window batches: half the window batch of phase 18's window
    int8 config, at each of its scales."""
    rng = np.random.default_rng(18)
    dev = torch.device(DEVICE)
    b = DP_HALF_BATCH
    images = torch.from_numpy(rng.integers(0, 256, (2, 600, 600, 3), dtype=np.uint8)).to(dev)
    masks = torch.from_numpy(rng.integers(0, 2, (2, 600, 600), dtype=np.uint8)).to(dev)
    mean = torch.tensor([120.0, 110.5, 99.25], device=dev)
    std = torch.tensor([40.0, 37.3, 51.7], device=dev)
    for s in (25, 65):
        half = s // 2
        pos = np.stack([rng.integers(0, 2, b), rng.integers(half, 600 - s + half + 1, b),
                        rng.integers(half, 600 - s + half + 1, b)], 1).astype(np.int32)
        args = (images, masks, mean, std, torch.from_numpy(pos).to(dev),
                torch.from_numpy((np.arange(b) % 8).astype(np.int32)).to(dev))
        gi, gl = gather.gather_batch(*args, s)
        wi, wl = gather.gather_batch_ref(*args, s)
        same = torch.equal(gi, wi) and torch.equal(gl, wl)
        log(f"K2 gather at a rank's batch B={b} s={s}, local ids into 2 tiles: "
            f"kernel == plain bitwise: {same}")
        if not same:
            raise SystemExit(f"K2 B={b} s={s}: kernel disagrees with plain")
        for c in sorted(set(POOL_CHANNELS)):
            shape = (b, s, s, c)
            x = torch.round(torch.randn(shape, device=dev, generator=torch.Generator(
                dev).manual_seed(s * c + 1)) * 16) / 16
            y = pool.pool_forward(x.permute(0, 3, 1, 2), 3).permute(0, 2, 3, 1).contiguous()
            g = torch.from_numpy(rng.normal(0, 1e-3, shape).astype(np.float32)).to(dev)
            variant = pool.variant_for(shape, 3, x.data_ptr() % 16 == 0)
            same = torch.equal(pool.pallas_pool_bwd(x, y, g, 3),
                               pool.pallas_pool_bwd_ref(x, y, g, 3))
            log(f"K4 pool bwd at a rank's batch {shape} ({variant}): kernel == plain "
                f"bitwise: {same}")
            if not same or variant != "fused":
                raise SystemExit(f"K4 {shape}: {variant} kernel disagrees with plain "
                                 f"or is not the fused variant")
            del x, y, g
    c_win = config("window", "int8")
    check_k5_serve_shapes(int8_conv, [(c_win.infer.window_batch // 2, s)
                                      for s in c_win.infer.scales], "a rank's window")
    torch.cuda.empty_cache()


def _dp_distance(a: dict, b: dict):
    """(max|dparam|, max|dBN statistics|) between two state_dicts."""
    dp = max(float(np.abs(a[k] - v).max()) for k, v in b.items()
             if v.dtype == np.float32 and "running" not in k)
    dbn = max(float(np.abs(a[k] - v).max()) for k, v in b.items() if "running" in k)
    return dp, dbn


def _dp_compare(what: str, got: dict, want: dict, floor) -> None:
    """A rank's train_steps against one device's on the same batches: every
    loss within 1e-5 relative; after the first step params within 1e-6 and
    BN statistics within 1e-5; after the last, within the larger of those
    and twice `floor`, `want`'s own float32 noise (`_dp_reordered`: the
    same arithmetic summed in another order, which compounds over steps).
    The distances are printed."""
    rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    dp1, dbn1 = _dp_distance(got["states"][0], want["states"][0])
    dp, dbn = _dp_distance(got["state"], want["state"])
    lim_p, lim_bn = max(1e-6, 2 * floor[0]), max(1e-5, 2 * floor[1])
    log(f"  {what}: losses {[round(x, 6) for x in got['losses']]} vs one device's "
        f"{[round(x, 6) for x in want['losses']]}: max rel {rel:.2e}; after step 1 "
        f"max|dparam| {dp1:.2e}, max|dBN stats| {dbn1:.2e}; after step "
        f"{len(got['losses'])} {dp:.2e} (limit {lim_p:.2e}), {dbn:.2e} (limit "
        f"{lim_bn:.2e}; one device with its rows reordered: {floor[0]:.2e}, "
        f"{floor[1]:.2e})")
    if not (all(map(math.isfinite, got["losses"])) and rel <= 1e-5 and dp1 <= 1e-6
            and dbn1 <= 1e-5 and dp <= lim_p and dbn <= lim_bn):
        raise SystemExit(f"{what}: the ranks' step disagrees with one device's")


def _dp_reordered(cfg, tiles, variables, base: dict) -> tuple:
    """The float32 noise floor of one device's train_steps run `base`
    (with its "batches"): the largest distance between it and its reruns
    on the same batches with each batch's rows in another order, one for
    each of DP_REORDER_SEEDS."""
    from dynseg_torch.probes import dp_parity

    worst = (0.0, 0.0)
    for seed in DP_REORDER_SEEDS:
        perm = np.random.default_rng(seed).permutation(len(base["batches"][0][0]))
        again = dp_parity.train_steps(
            cfg, tiles, variables, DP_SIZES,
            [(p[perm], a[perm]) for p, a in base["batches"]], warm_up=True,
            device=DEVICE)
        worst = tuple(map(max, worst, _dp_distance(again["state"], base["state"])))
    return worst


def _dp_ms(res: dict) -> dict:
    """Mean ms per step by scale over a train_steps run."""
    by = collections.defaultdict(list)
    for size, ms in zip(DP_SIZES, res["ms"]):
        by[size].append(ms)
    return {size: float(np.mean(v)) for size, v in sorted(by.items())}


def _dp_check_launches(what: str, got: dict) -> None:
    """A rank's K2/K4 launches against the gathers and pool backwards of
    its steps, every K4 launch the fused variant."""
    log(f"    K2 launches {got['k2']} (gathers {got['gathers']}), K4 launches "
        f"{got['k4']} (pool backwards {got['pool_bwds']}, fused {got['k4_fused']})")
    if (got["k2"], got["k4"], got["k4_fused"]) != (got["gathers"], got["pool_bwds"],
                                                   got["pool_bwds"]):
        raise SystemExit(f"{what}: K2/K4 launches do not match its steps")


def _dp_check_k5(what: str, res: dict, int8: bool) -> None:
    """A rank's K5 launches: 3 per int8 forward (none in float), all wgmma."""
    if res["forwards"] == 0 or res["k5_wgmma"] != res["k5"] \
            or res["k5"] != (3 * res["forwards"] if int8 else 0):
        raise SystemExit(f"{what}: K5 launches do not match its forwards")


def _dp_maps(got: dict, ref: dict) -> tuple:
    """Two predict results' maps: (labels that differ, those of them not
    at a tie of `ref`'s, `ref`'s ties, max|dprob|)."""
    differ = away = ties = 0
    dprob = 0.0
    for lab, prob, lab1, prob1 in zip(got["labels"], got["probs"], ref["labels"],
                                      ref["probs"], strict=True):
        dprob = max(dprob, float(np.abs(prob - prob1).max()))
        top2 = np.sort(prob1, axis=-1)[..., -2:]
        tie = top2[..., 1] - top2[..., 0] < 1e-5
        moved = lab != lab1
        differ += int(moved.sum())
        away += int((moved & ~tie).sum())
        ties += int(tie.sum())
    return differ, away, ties, dprob


def _dp_predictions(what: str, ranks: list, refs: list, tiles, card: str,
                    sharing: str = "2 ranks sharing one card") -> None:
    """Phase 18: the ranks' maps against each of `refs`, (name, one device
    outside a group): labels equal but at counted ties, probabilities
    within 1e-5, the int8 state_dict bitwise; each rank's K5 launches = 3
    x its forwards, all wgmma; its Mpx/s beside the last reference's."""
    px = float(np.prod(tiles.valid_hw, axis=1).sum())
    for r, res in enumerate(ranks):
        for name, ref in refs:
            differ, away, ties, dprob = _dp_maps(res, ref)
            qsame = all(np.array_equal(res["qvars"][k], v)
                        for k, v in (ref["qvars"] or {}).items())
            log(f"  {what} rank {r} vs one device {name}: {differ} labels differ, "
                f"{away} of them not at a tie ({ties} ties); max|dprob| {dprob:.2e}; "
                f"int8 state_dict bitwise: {qsame}")
            if away or dprob > 1e-5 or not qsame:
                raise SystemExit(f"{what} rank {r}: labels, probabilities or int8 "
                                 f"weights differ from one device {name}")
        name, ref = refs[-1]
        log(f"    {res['forwards']} forwards, K5 launches {res['k5']} (wgmma "
            f"{res['k5_wgmma']}); {px / res['wall_s'] / 1e6:.3f} Mpx/s with {sharing} "
            f"vs one device's {px / ref['wall_s'] / 1e6:.3f} {name} [{card}]")
        _dp_check_k5(f"{what} rank {r}", res, ref["qvars"] is not None)


def _dp_batch_reading(full: dict, half: dict, batch: int, card: str) -> None:
    """Phase 18, a reading: one device's window int8 maps at window_batch
    `batch` (`full`) against half of it (`half`)."""
    differ, away, ties, dprob = _dp_maps(full, half)
    log(f"  window int8, one device at window_batch {batch} vs {batch // 2}: max|dprob| "
        f"{dprob:.2e}, {differ} labels differ, {away} of them not at a tie [{card}]")


@torch.inference_mode()
def _dp_cudnn_witness(cfg, tiles, weights, card: str) -> None:
    """Phase 18, a reading: how one device's window probabilities depend on
    the batch they are forwarded in. The same windows of the smallest
    scale forwarded in a full window batch, in half of one, and the first
    DP_SHORT_BATCH of them alone (a short batch, as an unpadded last batch
    of a scale was): the largest difference from the full batch's. Float
    with cuDNN on (every run's path) and off (torch's own convolution, one
    sample at a time), int8 with cuDNN on (with it off the convolutions
    return NCHW tensors, which K5 does not take)."""
    from dynseg_torch.infer import Inferencer

    b, s, m = cfg.infer.window_batch, min(cfg.infer.scales), DP_SHORT_BATCH
    for quant, flags in (("none", (True, False)), ("int8", (True,))):
        c = dataclasses.replace(cfg, infer=dataclasses.replace(cfg.infer, quant=quant))
        inf = Inferencer(c, tiles, device=DEVICE)
        v = inf.enable_quant({k: w.to(DEVICE) for k, w in weights.items()})
        origins = np.array([(inf.pad + 8 * (i // 16), inf.pad + 8 * (i % 16))
                            for i in range(b)], np.int64)
        tile = inf._tile(0)
        for on in flags:
            with torch.backends.cudnn.flags(enabled=on, benchmark=False,
                                            deterministic=False, allow_tf32=False):
                full = inf._probs(v, tile, origins, s)
                d_half = (full[:b // 2] - inf._probs(v, tile, origins[:b // 2], s)
                          ).abs().max().item()
                d_short = (full[:m] - inf._probs(v, tile, origins[:m], s)
                           ).abs().max().item()
            log(f"  {'int8' if quant == 'int8' else 'float'}, cuDNN {'on' if on else 'off'}:"
                f" {s}^2 windows in a batch of {b // 2} vs of {b}: max|dprob| "
                f"{d_half:.2e}; in a batch of {m} vs of {b}: {d_short:.2e} [{card}]")


def dp_train_config(n: int, shard: bool = False):
    """Phase 18's steps at n ranks: phase 7's configuration over the
    scales of DP_SIZES, no EMA."""
    cfg = train_config("pallas", len(DP_SIZES), False,
                       scales=tuple(sorted(set(DP_SIZES))))
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, num_devices=n, shard_tiles=shard))


def dp_inputs() -> tuple:
    """Phase 18's tiles (phase 7's), variables and global batches, the
    batches drawn by a CPU trainer as the ranks draw them."""
    from dynseg_torch.bridge import init_variables_np
    from dynseg_torch.data.datasets import load_synthetic
    from dynseg_torch.train import Trainer

    tiles = load_synthetic(seed=0, num_tiles=4, size=TRAIN_TILE)[0]
    variables = init_variables_np(dp_train_config(1).model, num_input_bands=3, seed=0)
    sampler = Trainer(dp_train_config(1), tiles, device="cpu")
    batches = [tuple(a[0] for a in sampler.global_batch_inputs(s)) for s in DP_SIZES]
    return tiles, variables, batches


def run_data_parallel(gather, pool, int8_conv, card: str) -> dict:
    """Phase 18: data parallelism over torch.distributed (see the module
    docstring). Returns each rank's K2, K4 and K5 launches."""
    from dynseg_torch import parallel
    from dynseg_torch.data.datasets import load_synthetic
    from dynseg_torch.probes import dp_parity

    root = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.perf_counter()
    n_over = torch.cuda.device_count() + 1
    refused = subprocess.Popen(
        [sys.executable, "-m", "dynseg_torch", "--operation", "training",
         "--num_devices", str(n_over), "--output_path", os.path.join(OUT_DIR, "dp_refused")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=root)
    check_dp_kernel_shapes(gather, pool, int8_conv)
    train_cfg = dp_train_config
    tiles, variables, batches = dp_inputs()
    wt = {k: v.cpu() for k, v in seeded_weights(config("window", "none").model, 3).items()}
    tiles1k = load_synthetic(seed=0, num_tiles=2, size=WINDOW_TILE)[1]
    tiles2k = load_synthetic(seed=1, num_tiles=2, size=DENSE_TILE)[1]
    small = load_synthetic(seed=2, num_tiles=2, size=96)[1]
    w_win = {k: v.cpu() for k, v in centred_weights(
        {k: v.to(DEVICE) for k, v in wt.items()}, "window", tiles1k).items()}
    w_dense = {k: v.cpu() for k, v in centred_weights(
        {k: v.to(DEVICE) for k, v in wt.items()}, "dense", tiles2k).items()}
    preds = [("window float, 96^2", config("window", "none"), small, wt),
             ("window int8, 1024^2", config("window", "int8"), tiles1k, w_win),
             ("dense int8, 2048^2", config("dense", "int8"), tiles2k, w_dense)]
    # c's references, one device outside a group: at the default batch, and
    # with forwards that take a rank's windows (a window batch of half the
    # ranks', its last batch padded to full size as theirs is); a rank's
    # dense blocks are the default's (the ranks' groups of 2 x 8 are its
    # groups of 8).
    (_, c_win, t_win, w_win), (_, c_dense, t_dense, w_dense) = preds[1:]
    half = dataclasses.replace(c_win, infer=dataclasses.replace(
        c_win.infer, window_batch=c_win.infer.window_batch // 2))
    torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    one = dp_parity.train_steps(train_cfg(1), tiles, variables, DP_SIZES, batches,
                                warm_up=True, device=DEVICE)
    one_pred = [dp_parity.predict(c, t, w, DEVICE) for _, c, t, w in preds]
    one_half = dp_parity.predict(half, t_win, w_win, DEVICE)
    t_ref = time.perf_counter() - t_ref
    torch.cuda.empty_cache()

    # a. One rank in an NCCL group; its int8 runs take c's rank shapes.
    t0 = time.perf_counter()
    nccl = parallel.spawn(dp_parity.run_many, 1, [DP_DEVICE], DP_ONE_BACKEND, args=([
        (dp_parity.train_steps, (train_cfg(1), tiles, variables, DP_SIZES, batches),
         {"warm_up": True}),
        (dp_parity.predict, preds[0][1:]),
        (dp_parity.predict, (half, t_win, w_win)),
        (dp_parity.predict, (c_dense, t_dense, w_dense))],))[0]
    log(f"data parallel a: one rank in an NCCL group on cuda:0, {len(DP_SIZES)} "
        f"steps at {DP_SIZES} px, batch {TRAIN_BATCH}, full width, and "
        f"{preds[0][0]}, window int8 at half the window batch and dense int8 "
        f"(launch and run {time.perf_counter() - t0:.1f} s) [{card}]")
    floor = _dp_reordered(train_cfg(1), tiles, variables, one)
    _dp_compare("NCCL world size 1", nccl[0], one, floor)
    _dp_check_launches("NCCL world size 1", nccl[0])
    _dp_predictions(f"NCCL world size 1, {preds[0][0]}", [nccl[1]],
                    [("at the default batch", one_pred[0])], small, card, "one rank")

    # b, c. Two ranks sharing cuda:0 over gloo.
    t0 = time.perf_counter()
    ranks = parallel.spawn(dp_parity.run_many, 2, [DP_DEVICE] * 2, "gloo", args=([
        (dp_parity.train_steps, (train_cfg(2), tiles, variables, DP_SIZES, batches),
         {"warm_up": True}),
        (dp_parity.train_steps, (train_cfg(2, True), tiles, variables, DP_SIZES),
         {"warm_up": True}),
        (dp_parity.train_steps, (train_cfg(2), tiles, variables, DP_SIZES, batches),
         {"collective_stats": True}),
        *[(dp_parity.predict, p[1:]) for p in preds[1:]]],))
    log(f"data parallel b: two ranks sharing cuda:0 over gloo, {DP_HALF_BATCH} "
        f"patches a rank, replicated tiles then --shard_tiles (launch and run "
        f"{time.perf_counter() - t0:.1f} s; one device's runs {t_ref:.1f} s) [{card}]")
    one_shard = dp_parity.train_steps(train_cfg(1), tiles, variables, DP_SIZES,
                                      ranks[0][1]["batches"], warm_up=True, device=DEVICE)
    shard_floor = _dp_reordered(train_cfg(1), tiles, variables, one_shard)
    for r, res in enumerate(ranks):
        for what, got, want, noise in (("replicated", res[0], one, floor),
                                       ("--shard_tiles", res[1], one_shard, shard_floor)):
            _dp_compare(f"rank {r} {what}", got, want, noise)
            _dp_check_launches(f"rank {r} {what}", got)
    if not all(np.array_equal(ranks[0][0]["state"][k], v)
               for k, v in ranks[1][0]["state"].items()):
        raise SystemExit("the two ranks' states differ")
    timed = ranks[0][2]
    log(f"  ms/step by scale, 2 ranks sharing one card (not a speed-up measurement) "
        f"vs one device, the same global batch; the ranks' "
        f"{timed['collective_calls'] // len(timed['ms'])} all-reduces a step timed "
        f"alone (the card synchronised and the ranks met before each):")
    two_ms, one_ms = _dp_ms(ranks[0][0]), _dp_ms(one)
    coll = _dp_ms({"ms": timed["collective_ms"]})
    for size in two_ms:
        log(f"    scale {size}: 2 ranks {two_ms[size]:.3f} ms, 1 device {one_ms[size]:.3f} "
            f"ms; all-reduces {coll[size]:.3f} ms, {coll[size] / two_ms[size]:.3f} of "
            f"the ranks' step")
    refs = ([("at a rank's batch (window_batch "
              f"{half.infer.window_batch})", one_half),
             ("at the default batch (window_batch "
              f"{c_win.infer.window_batch})", one_pred[1])],
            [("at the default batch (a rank's groups of 8 blocks)", one_pred[2])])
    for (what, _, t, _), ref, i, in_nccl in zip(preds[1:], refs, (3, 4), nccl[2:]):
        _dp_predictions(f"NCCL world size 1, {what}", [in_nccl], ref, t, card, "one rank")
        _dp_predictions(what, [r[i] for r in ranks], ref, t, card)
    _dp_batch_reading(one_pred[1], one_half, c_win.infer.window_batch, card)
    _dp_cudnn_witness(c_win, t_win, w_win, card)

    # d. More ranks than cards.
    out, err = refused.communicate(timeout=120)
    msg = f"--num_devices {n_over} requested but only {n_over - 1} CUDA device(s) are visible"
    log(f"data parallel d: --num_devices {n_over} on {n_over - 1} card(s): exit "
        f"{refused.returncode}, {err.strip().splitlines()[-1] if err.strip() else ''!r}")
    if refused.returncode == 0 or msg not in err or "TOTAL" in out:
        raise SystemExit("--num_devices past the visible cards was not refused")
    log(f"phase 18 took {time.perf_counter() - t_phase:.1f} s")
    return {"k2": [r[0]["k2"] for r in ranks], "k4": [r[0]["k4"] for r in ranks],
            "k5": [r[3]["k5"] + r[4]["k5"] for r in ranks]}


def repro_config(pool_backward: str, dtype: str):
    """Phase 19's training run: phase 7's configuration (full width, batch
    100, multinomial over 25..65, its tiles) with EMA 0.9 and RECALIB
    recalibration batches, REPRO_STEPS steps from seed 0 (whose first
    draws take 25 and 65 px)."""
    cfg = train_config(pool_backward, REPRO_STEPS, True, dtype=dtype)
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, seed=0))


def _cudnn_free():
    """cuDNN's free choice of algorithms (the flag's default), for a
    reading against the deterministic step the port takes."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=False, allow_tf32=False)


def _repro_line(what: str, d: dict) -> str:
    return (f"{what}: max|dparam| {d['params']:.2e}, BN stats {d['bn']:.2e}, momentum "
            f"{d['momentum']:.2e}, EMA {d['ema']:.2e}, recalibrated {d['recal']:.2e}, "
            f"losses {d['losses']:.2e}, scheduler scores {d['scores']:.2e}, scales "
            f"{'equal' if d['scales'] == 0 else 'differ'}")


def _repro_require(what: str, d: dict) -> None:
    if any(v != 0 for v in d.values()):
        raise SystemExit(f"{what}: two same-seed runs differ {d}")


def time_deterministic_steps(tiles, card: str, profile_dir=None) -> None:
    """Phase 19 b, the cost: ms/step at 25 and 65 px (the mean of
    REPRO_TIMED steps after a warm one) with the deterministic algorithms
    the port asks for against cuDNN's free choice, in float32 (K4) and
    bfloat16 (ATen's pool backward), on one Trainer per dtype. With a
    profile directory, each mode's step is traced and the kernels whose
    time grew are named."""
    from dynseg_torch.train import Trainer

    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
    for pb, dtype in (("pallas", "float32"), ("xla", "bfloat16")):
        tr = Trainer(train_config(pb, 1, False, dtype=dtype), tiles, device=DEVICE)
        st = tr.init_state(seed=0)
        for size in (25, 65):
            ms, top = {}, {}
            for det in (True, False):
                with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                                deterministic=det, allow_tf32=False):
                    ms[det] = time_ms(lambda: tr.train_step(st, size), REPRO_TIMED)
                    if profile_dir:
                        top[det] = kernel_ms(profile_step(tr, st, size, os.path.join(
                            profile_dir, f"repro_{dtype}_{size}_{'det' if det else 'free'}.json"))[1])
            log(f"  b. {dtype} (pool_backward {pb}) scale {size}: deterministic "
                f"{ms[True]:.3f} ms/step, cuDNN's free choice {ms[False]:.3f} ms/step, "
                f"cost {ms[True] / ms[False] - 1:+.3f} [{card}]")
            if top:
                grew = sorted(((top[True].get(k, 0.0) - top[False].get(k, 0.0), k)
                               for k in set(top[True]) | set(top[False])), reverse=True)
                for delta, name in grew[:6]:
                    log(f"      {delta:+8.3f} ms  det {top[True].get(name, 0.0):8.3f}  "
                        f"free {top[False].get(name, 0.0):8.3f}  {name}")
        del tr, st
        torch.cuda.empty_cache()


def _crop(tiles, side: int):
    """The top-left side x side pixels of every tile of a TileSet."""
    return dataclasses.replace(
        tiles, images=np.ascontiguousarray(tiles.images[:, :side, :side]),
        masks=np.ascontiguousarray(tiles.masks[:, :side, :side]),
        valid_hw=np.minimum(tiles.valid_hw, side))


def _serving_reruns(card: str) -> None:
    """Phase 19 e: validate_test twice in one process, in a serving
    process's cuDNN mode (the flag's default: no Trainer built there):
    window float on a REPRO_CROP^2 crop of phase 3's window tile and dense
    int8 on its 2048^2 tile, weights centred as in phase 13. The two runs'
    scores and maps, and the probabilities of the same Inferencer path
    (dp_parity.predict) twice."""
    from dynseg_torch.data.datasets import load_synthetic
    from dynseg_torch.infer import validate_test
    from dynseg_torch.probes import dp_parity

    wt = seeded_weights(config("window", "none").model, 3)
    crop = _crop(load_synthetic(seed=0, num_tiles=2, size=WINDOW_TILE)[1], REPRO_CROP)
    tiles2k = load_synthetic(seed=1, num_tiles=2, size=DENSE_TILE)[1]
    wt = {k: v.to(DEVICE) for k, v in wt.items()}
    runs = ((f"window float {REPRO_CROP}^2", config("window", "none"), crop,
             centred_weights(wt, "window", crop)),
            (f"dense int8 {DENSE_TILE}^2", config("dense", "int8"), tiles2k,
             centred_weights(wt, "dense", tiles2k)))
    with _cudnn_free():
        for name, cfg, tiles, w in runs:
            s = [validate_test(cfg, w, tiles, DEVICE, log=lambda *_: None) for _ in range(2)]
            p = [dp_parity.predict(cfg, tiles, w, DEVICE) for _ in range(2)]
            dprob = max(float(np.abs(a - b).max()) for a, b in zip(p[0]["probs"], p[1]["probs"]))
            moved = sum(int((a != b).sum()) for a, b in
                        zip(s[0]["predictions"], s[1]["predictions"]))
            same = all(s[0][k] == s[1][k] for k in ("oa", "kappa", "mean_f1"))
            log(f"  e. {name}, cuDNN's free choice, run twice in one process: "
                f"max|dprob| {dprob:.2e}, {moved} labels differ, OA/kappa/meanF1 "
                f"equal: {same} (OA {s[0]['oa']:.6f}) [{card}]")


def _start_fold_runs() -> list:
    """Phase 19 g, started: `python -m dynseg_torch.run_folds --folds 2`
    twice, side by side on the card, at phase 11's data flags with
    FOLDS_NITER iterations a fold and pool_backward pallas. Returns the
    jobs for `_check_fold_runs`."""
    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(root, OUT_DIR), exist_ok=True)
    jobs = []
    for run in ("a", "b"):
        out = os.path.join(root, OUT_DIR, f"folds_{run}")
        shutil.rmtree(out, ignore_errors=True)
        log_path = os.path.join(root, OUT_DIR, f"folds_{run}.log")
        with open(log_path, "w") as f:
            proc = subprocess.Popen(
                [sys.executable, "-m", "dynseg_torch.run_folds", "--folds", "2",
                 "--output_path", out, "--device", DEVICE, "--dataset", "synthetic",
                 "--dataset_kwargs", json.dumps({"size": TRAIN_TILE, "num_tiles": 4}),
                 "--values", ",".join(map(str, SCALES)), "--batch_size", str(TRAIN_BATCH),
                 "--niter", str(FOLDS_NITER), "--eval_every", str(FOLDS_NITER),
                 "--checkpoint_every", str(FOLDS_NITER), "--pool_backward", "pallas"],
                stdout=f, stderr=subprocess.STDOUT, text=True, cwd=root)
        jobs.append((run, time.perf_counter(), proc, out, log_path))
    return jobs


def _check_fold_runs(jobs: list, card: str) -> None:
    """Phase 19 g: the two fold runs' folds_summary.json files
    byte-identical; each fold's K2/K4 launches held to its run."""
    n = len(SCALES)
    summaries = []
    for run, t0, proc, out, log_path in jobs:
        rc = proc.wait(timeout=600)
        with open(log_path) as f:
            lines = f.read().splitlines()
        log(f"  g. run_folds --folds 2 ({run}): exit {rc}, wall "
            f"{time.perf_counter() - t0:.1f} s [{card}]")
        if rc != 0:
            print("\n".join(lines[-40:]), file=sys.stderr)
            raise SystemExit(f"run_folds ({run}) exited {rc}")
        for fold in range(2):
            got = _launch_line([m.removeprefix(f"fold {fold} ") for m in lines
                                if m.startswith(f"fold {fold} kernel launches:")],
                               f"run_folds fold {fold}")
            want = {"patch_gather": n + FOLDS_NITER + 1,
                    "pool_bwd": 6 * (n + FOLDS_NITER), "pool_bwd.fused": 6 * (n + FOLDS_NITER)}
            log(f"    fold {fold}: K2 launches {got['patch_gather']}, K4 launches "
                f"{got['pool_bwd']} (fused {got['pool_bwd.fused']}); expected {want}")
            if any(got[k] != v for k, v in want.items()):
                raise SystemExit(f"run_folds ({run}) fold {fold}: launches do not match")
        with open(os.path.join(out, "folds_summary.json"), "rb") as f:
            summaries.append(f.read())
    summary = json.loads(summaries[0])
    log(f"    folds_summary.json byte-identical: {summaries[0] == summaries[1]}; "
        f"OA {summary['oa_mean']:.6f} +- {summary['oa_std']:.6f}, kappa "
        f"{summary['kappa_mean']:.6f}, mean F1 {summary['mean_f1_mean']:.6f}")
    if summaries[0] != summaries[1] or not summary["complete"]:
        raise SystemExit("run_folds: two same-seed runs wrote different summaries")


def run_reproducibility(gather, pool, card: str, profile_dir=None) -> None:
    """Phase 19: two same-seed training runs at full width are bitwise
    equal (see the module docstring for a-g)."""
    from dynseg_torch.probes import repro

    t_phase = time.perf_counter()
    tiles, variables, batches = dp_inputs()
    ckpt = os.path.join(OUT_DIR, "repro_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    first = {}
    for pb, dtype in (("pallas", "float32"), ("xla", "bfloat16")):
        cfg = repro_config(pb, dtype)
        gather.launches = 0
        pool.reset_launches()
        t0 = time.perf_counter()
        a = repro.train_run(cfg, tiles, DEVICE, recalib=RECALIB,
                            save_to=ckpt if dtype == "float32" else None)
        k2, k4 = gather.launches, pool.launches
        b = repro.train_run(cfg, tiles, DEVICE, recalib=RECALIB)
        d = repro.distances(a, b)
        log(f"  a. {dtype}, pool_backward {pb}: two runs of {REPRO_STEPS} steps at "
            f"scales {a['scales']}, EMA + {RECALIB} recalibration batches "
            f"({time.perf_counter() - t0:.1f} s); losses {[round(x, 5) for x in a['losses']]}; "
            f"K2 {k2}, K4 {k4} launches a run; cuDNN deterministic/benchmark {a['cudnn']} [{card}]")
        log("     " + _repro_line("run against its rerun", d))
        want_k4 = 6 * REPRO_STEPS if pb == "pallas" else 0
        if not (25 in a["scales"] and 65 in a["scales"]):
            raise SystemExit(f"{dtype}: the run took no step at 25 or at 65 px")
        if not all(map(math.isfinite, a["losses"])) or a["cudnn"] != (True, False):
            raise SystemExit(f"{dtype}: non-finite losses or cuDNN not deterministic")
        if k2 != REPRO_STEPS + RECALIB or k4 != want_k4:
            raise SystemExit(f"{dtype}: launches K2 {k2}, K4 {k4} do not match the run")
        _repro_require(f"{dtype} same-seed runs", d)
        first[dtype] = a

    free = repro.train_run(repro_config("pallas", "float32"), tiles, DEVICE,
                           recalib=RECALIB, context=_cudnn_free)
    log("  b. " + _repro_line("float32 with cuDNN's free choice vs a's run (a reading)",
                              repro.distances(free, first["float32"])))
    time_deterministic_steps(tiles, card, profile_dir)
    # g's two processes run beside c-f (nothing after b is timed).
    jobs = _start_fold_runs()
    try:
        _repro_reruns(tiles, variables, batches, ckpt, first, card)
        _check_fold_runs(jobs, card)
    finally:
        for job in jobs:
            if job[2].poll() is None:
                job[2].kill()
                job[2].wait()
    log(f"phase 19 took {time.perf_counter() - t_phase:.1f} s")


def _repro_reruns(tiles, variables, batches, ckpt: str, first: dict, card: str) -> None:
    """Phase 19 c-f (see the module docstring)."""
    from dynseg_torch import parallel
    from dynseg_torch.probes import dp_parity, repro

    again = [repro.train_run(repro_config("pallas", "float32"), tiles, DEVICE,
                             niter=REPRO_RESUME_STEPS, restore_from=ckpt) for _ in range(2)]
    d = repro.distances(*again)
    log(f"  c. a's float32 checkpoint (step {REPRO_STEPS}) restored twice, "
        f"{REPRO_RESUME_STEPS} more steps each at {again[0]['scales']}: "
        + _repro_line("one against the other", d))
    if again[0]["step"] != REPRO_STEPS + REPRO_RESUME_STEPS:
        raise SystemExit("the restored runs did not continue from the checkpoint")
    _repro_require("restored runs", d)

    t0 = time.perf_counter()
    step_case = (dp_parity.train_steps, (dp_train_config(2), tiles, variables, DP_SIZES,
                                         batches), {"warm_up": True})
    ranks = parallel.spawn(dp_parity.run_many, 2, [DP_DEVICE] * 2, "gloo",
                           args=([step_case, step_case],))
    for r, (x, y) in enumerate(ranks):
        dstate = max(float(np.abs(x["state"][k].astype(np.float64) - v).max())
                     for k, v in y["state"].items())
        dmom = max(float(np.abs(x["momentum"][k] - v).max()) for k, v in y["momentum"].items())
        log(f"  d. rank {r} of two gloo ranks sharing cuda:0, phase 18's {len(DP_SIZES)} "
            f"steps twice: losses equal {x['losses'] == y['losses']}, max|dstate| "
            f"{dstate:.2e}, max|dmomentum| {dmom:.2e}; cuDNN deterministic/benchmark "
            f"{x['cudnn']} ({time.perf_counter() - t0:.1f} s for both ranks) [{card}]")
        if x["losses"] != y["losses"] or dstate or dmom or x["cudnn"] != (True, False):
            raise SystemExit(f"rank {r}: its rerun of the same steps differs")

    _serving_reruns(card)

    torch.use_deterministic_algorithms(True)
    try:
        for pb, dtype in (("pallas", "float32"), ("xla", "bfloat16")):
            got = repro.train_run(repro_config(pb, dtype), tiles, DEVICE, recalib=RECALIB)
            log(f"  f. {dtype} under torch.use_deterministic_algorithms(True): ran "
                f"without raising; " + _repro_line("against a's run", repro.distances(
                    got, first[dtype])))
            if not all(map(math.isfinite, got["losses"])):
                raise SystemExit(f"{dtype}: non-finite losses under deterministic algorithms")
    finally:
        torch.use_deterministic_algorithms(False)


def _rehearsal(name: str, argv, card: str, kind: str = "rehearsal") -> str:
    """One probe, `python -m dynseg_torch.probes.<name>`, in a process of
    its own; its output goes to smoke_out/<kind>_<name>.log and is
    repeated here, in one piece when probes run side by side. Exits on a
    non-zero exit code."""
    root = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(root, OUT_DIR, f"{kind}_{name}.log")
    t0 = time.perf_counter()
    with open(path, "w") as f:
        rc = subprocess.run([sys.executable, "-m", f"dynseg_torch.probes.{name}", *argv],
                            stdout=f, stderr=subprocess.STDOUT, cwd=root,
                            timeout=900).returncode
    with open(path) as f:
        text = f.read()
    lines = [f"{kind} {name} {' '.join(argv) or '(defaults)'}: exit {rc}, wall "
             f"{time.perf_counter() - t0:.1f} s [{card}]"]
    lines += [f"  {line}" for line in text.splitlines()
              if "Warning" not in line and not line.startswith("  return F.")]
    with _LOG_LOCK:
        log("\n".join(lines))
    if rc != 0:
        raise SystemExit(f"{kind} {name} exited {rc}")
    return text


def _check_stress(text: str) -> int:
    """Phase 21a's checks on stress_scale's output; returns K2's launches."""
    if "tile storage uint8" not in text:
        raise SystemExit("stress_scale: the training tiles are not stored as uint8")
    logged = [float(v) for v in re.findall(r"^  iter \d+/\d+ scale=\d+ loss=(\S+)", text, re.M)]
    chunks = re.search(r"^loss by chunk: (\d+) chunks of \d+ steps, all finite: (\w+); "
                       r"mean of the first \d+ (\S+), of the last \d+ (\S+)$", text, re.M)
    if not logged or not all(map(math.isfinite, logged)) or not chunks:
        raise SystemExit(f"stress_scale: logged losses {logged}, or no chunk summary")
    first, last = float(chunks.group(3)), float(chunks.group(4))
    if chunks.group(2) != "True" or not last < first:
        raise SystemExit(f"stress_scale: chunk losses not finite or not falling "
                         f"({first} -> {last})")
    for mode in ("dense", "window"):
        if not re.search(rf"^validate_test\[{mode}\] .* OA=[0-9.]+ meanF1=[0-9.]+ ",
                         text, re.M):
            raise SystemExit(f"stress_scale: no OA / meanF1 for {mode} mode")
    k2 = re.search(r"^K2 launches: (\d+) \(gathers (\d+):", text, re.M)
    if not k2 or int(k2.group(1)) != int(k2.group(2)) or int(k2.group(1)) == 0:
        raise SystemExit(f"stress_scale: K2 launches do not equal the gathers "
                         f"({k2 and k2.groups()})")
    checks = re.findall(r"^K2 real batch B=(\d+) s=(\d+) .*: bitwise: (\w+)$", text, re.M)
    if ([int(b) for b, _, _ in checks] != list(STRESS_BATCHES)
            or any(ok != "True" for _, _, ok in checks)):
        raise SystemExit(f"stress_scale: K2 vs plain on the real batches: {checks}")
    return int(k2.group(1))


def run_rehearsals(card: str) -> int:
    """Phase 21: the three production-scale rehearsals (see the module
    docstring); returns K2's launches in stress_scale."""
    t_phase = time.perf_counter()
    texts = {name: _rehearsal(name, argv, card) for name, argv in REHEARSALS}
    k2 = _check_stress(texts["stress_scale"])
    if "pass2 labels == pass1 labels: True" not in texts["profile_multitile"]:
        raise SystemExit("profile_multitile: pass 2's label maps differ from pass 1's")
    agree = re.findall(r"^(float32|bfloat16) block=(\d+) .* agree\(ref\)=([0-9.]+) ",
                       texts["sweep_dense"], re.M)
    if len(agree) != 10:
        raise SystemExit(f"sweep_dense: {len(agree)} agreements printed, not 10")
    log(f"  K2 launches in stress_scale {k2} = its gathers; agreements "
        f"{[(d, int(b), float(a)) for d, b, a in agree]}")
    log(f"phase 21 took {time.perf_counter() - t_phase:.1f} s")
    return k2


def _study_checks(name: str, payload) -> list:
    """Phase 22's checks on one study's JSON: its top-level keys are the
    script's (STUDY_KEYS), and every OA (and, in parity_bracket, every
    mean F1; not mode_gap's gap) lies in (0, 1]. Returns the scores
    checked."""
    for row in payload if isinstance(payload, list) else [payload]:
        if set(row) != STUDY_KEYS[name]:
            raise SystemExit(f"study {name}: top-level keys {sorted(row)}, not the "
                             f"script's {sorted(STUDY_KEYS[name])}")
    scores = []

    def collect(obj):
        if isinstance(obj, dict):
            for k, v in obj.items():
                oa = k == "oa" or k.startswith("oa_") or ("_oa" in k and k != "gap_oa")
                f1 = name == "parity_bracket" and k == "mean_f1"
                if (oa or f1) and isinstance(v, (int, float)):
                    scores.append(float(v))
                else:
                    collect(v)
        elif isinstance(obj, list):
            for v in obj:
                collect(v)

    collect(payload)
    if not scores or not all(0.0 < v <= 1.0 for v in scores):
        raise SystemExit(f"study {name}: scores outside (0, 1]: {scores}")
    return scores


def run_studies(card: str) -> int:
    """Phase 22: the accuracy studies (see the module docstring); returns
    K2's launches over them."""
    t_phase = time.perf_counter()
    shutil.rmtree(os.path.join(OUT_DIR, "collapse"), ignore_errors=True)
    outs = {name: os.path.join(OUT_DIR, f"study_{name}.json") for name, _ in STUDIES}
    lanes = []
    for name, argv in STUDIES:
        if name == "ema_recalib_probe":  # reads the cell diagnose_collapse keeps
            lanes[-1].append((name, argv))
        else:
            lanes.append([(name, argv)])

    def lane(studies):
        return [(name, _rehearsal(name, [*argv, "--out", outs[name]], card, kind="study"))
                for name, argv in studies]

    with concurrent.futures.ThreadPoolExecutor(len(lanes)) as pool:
        futures = [pool.submit(lane, studies) for studies in lanes]
        texts = dict(pair for fut in futures for pair in fut.result())
    launches, buckets = 0, set()
    for name, _ in STUDIES:
        text, out = texts[name], outs[name]
        with open(out) as f:
            scores = _study_checks(name, json.load(f))
        k2 = re.findall(r"^    K2 launches: (\d+) \(gathers (\d+):", text, re.M)
        if not k2 or any(int(n) != int(g) or int(n) == 0 for n, g in k2):
            raise SystemExit(f"study {name}: K2 launches against gathers {k2}")
        checks = re.findall(r"^    K2 real batch B=(\d+) s=(\d+) \(kernel vs plain\): "
                            r"bitwise: (\w+)$", text, re.M)
        if not checks or any(ok != "True" for _, _, ok in checks):
            raise SystemExit(f"study {name}: K2 vs plain on the real batches: {checks}")
        launches += sum(int(n) for n, _ in k2)
        buckets |= {(int(b), int(s)) for b, s, _ in checks}
        log(f"  study {name}: top-level JSON keys are the script's, {len(scores)} scores in "
            f"(0, 1] ({min(scores):.4f}..{max(scores):.4f}); K2 launches "
            f"{[int(n) for n, _ in k2]} = the gathers; K2 bitwise at (B, s) "
            f"{sorted({(int(b), int(s)) for b, s, _ in checks})}")
    if not STUDY_BUCKETS <= buckets:
        raise SystemExit(f"phase 22: K2 not checked at {sorted(STUDY_BUCKETS - buckets)}")
    log(f"  K2 in the studies: {launches} launches, bitwise at the area-rescaled "
        f"buckets {sorted(STUDY_BUCKETS)} and at {sorted(buckets - STUDY_BUCKETS)}")
    log(f"phase 22 took {time.perf_counter() - t_phase:.1f} s")
    return launches


def run_reference_init(card: str) -> None:
    """Phase 23: the reference's init drawn on this host against the
    pinned digests, read back from a Trainer on the card, then one cut
    paired run through the command line."""
    from dynseg_torch import bridge
    from dynseg_torch.config import ModelConfig
    from dynseg_torch.data.datasets import load_synthetic
    from dynseg_torch.train import Trainer

    t_phase = time.perf_counter()
    for (classes, seed), pin in sorted(bridge.REFERENCE_INIT_SHA256.items()):
        cfg = ModelConfig(net_type="dilated_icpr_rate6", num_classes=classes,
                          num_input_bands=3, width_multiplier=1.0)
        t0 = time.perf_counter()
        digest = bridge.variables_sha256(bridge.init_variables_like_reference(cfg, 3, seed))
        log(f"  reference init, dilated_icpr_rate6 x1.0, 3 bands, {classes} classes, seed "
            f"{seed}: sha256 {digest} ({time.perf_counter() - t0:.2f} s), pinned: "
            f"{digest == pin}")
        if digest != pin:
            raise SystemExit(f"phase 23: the init of ({classes} classes, seed {seed}) is "
                             f"not the pinned one ({pin})")
    tr = Trainer(train_config("xla", 1, False), load_synthetic(seed=0, num_tiles=2, size=64)[0],
                 device=DEVICE)
    sd = {k: v.cpu() for k, v in tr.init_state(0).model.state_dict().items()}
    on_card = bridge.variables_sha256(bridge.torch_to_flax(sd))
    log(f"  Trainer.init_state(0) on {DEVICE}, read back: sha256 {on_card}, pinned: "
        f"{on_card == bridge.REFERENCE_INIT_SHA256[2, 0]}")
    if on_card != bridge.REFERENCE_INIT_SHA256[2, 0]:
        raise SystemExit("phase 23: the Trainer's init on the card is not the pinned one")
    del tr, sd
    torch.cuda.empty_cache()
    out = os.path.join(OUT_DIR, "paired_sched_ablation.json")
    text = _rehearsal("sched_ablation", [*PAIRED_RUN, "--out", out], card, kind="paired")
    with open(out) as f:
        payload = json.load(f)
    runs = [(r["config"], run) for r in payload["results"] for run in r["runs"]]
    if [(name, run["seed"]) for name, run in runs] != [("single_fixed@35", 0)]:
        raise SystemExit(f"phase 23: the paired run is not single_fixed@35 seed 0: {runs}")
    run = runs[0][1]
    k2 = re.findall(r"^    K2 launches: (\d+) \(gathers (\d+):", text, re.M)
    checks = re.findall(r"^    K2 real batch B=(\d+) s=(\d+) \(kernel vs plain\): "
                        r"bitwise: (\w+)$", text, re.M)
    if (not 0 < run["oa"] <= 1 or len(k2) != 1 or int(k2[0][0]) != int(k2[0][1])
            or int(k2[0][0]) == 0 or not checks or any(ok != "True" for _, _, ok in checks)):
        raise SystemExit(f"phase 23: OA {run['oa']}, K2 launches against gathers {k2}, "
                         f"K2 vs plain {checks}")
    log(f"  paired run single_fixed@35 seed 0, 300 iterations, batch 64: OA "
        f"{run['oa']:.4f} meanF1 {run['mean_f1']:.4f} (no JAX run at this cut: nothing "
        f"compared); K2 launches {k2[0][0]} = the gathers, bitwise at (B, s) "
        f"{sorted({(int(b), int(s)) for b, s, _ in checks})}")
    log(f"phase 23 took {time.perf_counter() - t_phase:.1f} s")


def read_quant_min_ch(centred, int8_conv, f32_runs, f32_scores, card) -> None:
    """Phase 20, a reading: quant_min_ch 64 against the default 128 on
    phase 13's window int8 (1024^2) and dense int8 (2048^2) runs. At 64,
    blocks 1-2 also run int8 through K5: first K5 at their geometries vs
    plain, bitwise, at a dense batch and window batches; then each run's
    Mpx/s, label agreement with the float32 run of its mode, and K5
    launches by geometry and variant, the first launch of each geometry
    held to plain bitwise."""
    from dynseg_torch.infer import validate_test
    from dynseg_torch.ops import quant

    check_k5_serve_shapes(int8_conv, ((DENSE_BATCH, DENSE_EXT), (256, 25), (256, 65)),
                          "quant_min_ch 64", LOW_GEOMETRIES)
    dense_float = validate_test(config("dense", "none"), centred["dense"], f32_runs[2][2],
                                DEVICE, log=lambda *_: None)
    floats = {"window": f32_scores["window float"], "dense": dense_float}
    packed = quant.int8_block_conv_packed
    for name, base, tiles in f32_runs[1:]:
        for min_ch in (128, 64):
            cfg = dataclasses.replace(base, infer=dataclasses.replace(
                base.infer, quant_min_ch=min_ch))
            by_geometry, first = collections.Counter(), {}

            def recorded(x, pc):
                out = packed(x, pc)
                key = (pc.cin, pc.cout, pc.k, pc.dilation, pc.variant)
                by_geometry[key] += 1
                if key not in first:
                    first[key] = (x.clone(), pc, out.clone())
                return out

            int8_conv.reset_launches()
            quant.int8_block_conv_packed = recorded
            try:
                t0 = time.perf_counter()
                scores = validate_test(cfg, centred[cfg.infer.mode], tiles, DEVICE,
                                       log=lambda *_: None)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                quant.int8_block_conv_packed = packed
            same = {key: torch.equal(out, int8_conv.int8_block_conv_packed_ref(x, pc))
                    for key, (x, pc, out) in first.items()}
            log(f"  {name}, quant_min_ch {min_ch}: {mpx_s(tiles, scores):.3f} Mpx/s, call "
                f"wall {wall:.3f} s, OA {scores['oa']:.4f}, label agreement with the "
                f"float32 run {agreement(scores, floats[cfg.infer.mode]):.6f}; K5 "
                f"launches {int8_conv.launches} [{card}]")
            for key, count in sorted(by_geometry.items()):
                log(f"    K5 {key[0]}->{key[1]} k{key[2]} d{key[3]} ({key[4]}): {count} "
                    f"launches, first launch == plain bitwise: {same[key]}")
            blocks = 5 if min_ch == 64 else 3
            if (not all(same.values()) or len(by_geometry) != blocks
                    or int8_conv.launches != sum(by_geometry.values())):
                raise SystemExit(f"{name} quant_min_ch {min_ch}: K5 launches or results "
                                 f"do not match")
            del first
            torch.cuda.empty_cache()


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


def profile_step(tr, st, size: int, path: str) -> tuple:
    """torch.profiler over one train step at `size` (the caller warms it
    up): its span in seconds and its kernel events, from a chrome trace
    written to `path`."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.train_step(st, size)
        torch.cuda.synchronize()
        span = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    with open(path) as f:
        return span, [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]


def kernel_ms(kernels: list) -> collections.Counter:
    """Device ms of kernel events by name (its first 90 characters)."""
    by_name = collections.Counter()
    for e in kernels:
        by_name[e["name"][:90]] += e["dur"] / 1e3
    return by_name


def profile_train_steps(out_dir: str) -> None:
    """--profile: torch.profiler over one warm full-width train step per
    pool backward in float32, and with ATen's in bfloat16, at 25 and 65
    px; chrome traces and kernel sums."""
    from dynseg_torch import train
    from dynseg_torch.data.datasets import load_synthetic

    os.makedirs(out_dir, exist_ok=True)
    tiles = load_synthetic(seed=0, num_tiles=4, size=TRAIN_TILE)[0]
    for pb, dtype in (("pallas", "float32"), ("xla", "float32"), ("xla", "bfloat16")):
        tr = train.Trainer(train_config(pb, 1, False, dtype=dtype), tiles, device=DEVICE)
        st = tr.init_state(seed=0)
        for s in (25, 65):
            for _ in range(3):  # warm
                tr.train_step(st, s)
            span, kernels = profile_step(tr, st, s, os.path.join(
                out_dir, f"train_step_{pb}_{dtype}_{s}.json"))
            busy = sum(e["dur"] for e in kernels) / 1e6
            by_name = kernel_ms(kernels)
            copies = [e for e in kernels if any(
                k in e["name"].lower() for k in ("copy", "transpose", "nchwtonhwc",
                                                 "nhwctonchw"))]
            log(f"profile {dtype} pool_backward={pb} s={s}: span {span * 1e3:.3f} ms, "
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

    # The serving path (K5, K6).
    k5 = check_kernel_geometries(int8_conv)
    k6 = check_max_pool_fwd_kernel(pool)
    k7 = check_quantize_kernel(pool)
    weights = {k: v.to(DEVICE) for k, v in
               seeded_weights(config("window", "none").model, 3).items()}
    check_against_cpu(weights)
    k5.update(run_slice(weights, int8_conv, card))
    k6["launches"] = k5.pop("k6_launches")
    f32_runs, f32_scores = k5.pop("runs"), k5.pop("scores")
    check_capped_fold(weights, f32_runs[0][2], f32_scores["window float"], card)
    check_real_activations(weights, int8_conv)
    if args.profile:
        profile_serving(args.profile, weights, f32_runs)
    torch.cuda.empty_cache()

    # This slice: bfloat16 serving with K5's bf16 store, TTA, streaming.
    k5.update(check_k5_bf16_out(int8_conv))
    centred, centred_scores, k5["bf16_out_launches"] = run_bf16_serving(
        weights, int8_conv, f32_runs, card)
    read_quant_min_ch(centred, int8_conv, f32_runs, centred_scores, card)
    run_tta(centred, int8_conv, f32_runs[2], centred_scores["dense int8"], card)
    check_streaming(centred["window"], f32_runs[0], card)
    del weights, centred, f32_runs, f32_scores, centred_scores
    torch.cuda.empty_cache()

    # The training path (K2, K4), float32 then bfloat16.
    k2 = check_gather_kernel(gather)
    k4 = check_pool_kernel(pool)
    check_train_step_against_cpu()
    runs = run_training_slice(gather, pool, card)
    k2["launches"], k4["launches"] = runs["pallas"]["k2"], runs["pallas"]["k4"]
    check_train_real_activations(gather, pool)
    check_train_step_against_cpu("bfloat16")
    run_bf16_training(gather, pool, runs, card)
    if args.profile:
        profile_train_steps(args.profile)

    # The probe (P1) and the command line.
    p1 = check_p1_kernel(int8_probe_conv)
    p1["launches"] = run_probe(int8_probe_conv)
    run_cli(card)
    served = run_export_serve(int8_conv, card)
    k5["serve_launches"] = served["serve_launches"]
    k5["max_abs_err"] = max(k5["max_abs_err"], served["max_abs_err"])
    dp = run_data_parallel(gather, pool, int8_conv, card)
    k5["dp_rank_launches"], k2["dp_rank_launches"], k4["dp_rank_launches"] = (
        dp["k5"], dp["k2"], dp["k4"])
    run_reproducibility(gather, pool, card, args.profile)
    torch.cuda.empty_cache()
    k2["stress_launches"] = run_rehearsals(card)
    k2["study_launches"] = run_studies(card)
    run_reference_init(card)

    def entry(name, source, replaces, k):
        # library_ms: no single PyTorch call computes K5, K2, K4 or P1 (no
        # CUDA int8 conv; ATen's max-pool backward routes a tie to the first
        # max; the gather fuses crop, normalise and labels); K6's is ATen's
        # float32 max_pool2d at its shapes. K7 adds its bfloat16 times.
        # K5 adds its bf16 store's time, bound and launches (phases 12-13)
        # and its launches in the HTTP server over phase 17's requests; K5,
        # K2 and K4 each rank's launches in phase 18; K2 its launches in
        # phase 21's production rehearsal and over phase 22's studies.
        extra = {key: k[key] for key in ("bf16_out_ms", "bf16_out_bound_ms",
                                         "bf16_out_launches", "serve_launches",
                                         "dp_rank_launches", "stress_launches",
                                         "study_launches", "bf16_ms", "bf16_plain_ms")
                 if key in k}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": k["launches"],
                "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"], "library_ms": k.get("library_ms"), **extra}

    print(json.dumps({"kernels": [
        entry("int8_block_conv", KERNEL_SOURCE, KERNEL_REPLACES, k5),
        entry("patch_gather", GATHER_SOURCE, GATHER_REPLACES, k2),
        entry("pool_bwd", POOL_SOURCE, POOL_REPLACES, k4),
        entry("max_pool_s1_fwd", K6_SOURCE, K6_REPLACES, k6),
        entry("quantize_s8_fwd", K7_SOURCE, K7_REPLACES, k7),
        entry("int8_conv3x3.wgmma", P1_SOURCE, P1_REPLACES, p1)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
