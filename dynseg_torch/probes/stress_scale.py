"""Production-scale rehearsal of the port (counterpart of
scripts/stress_scale.py): a Potsdam-sized synthetic set (default 20 x
3000^2 uint8 training tiles, 180 Mpx, and 2 test tiles) through the whole
training path on one device: the position tables under the per-class
cap, the upload, one warm-up call per bucket, dynamic 5-scale training
with area-rescaled batches (steps_per_call 8, metric_fetch_depth 4), then
validate_test in dense and in window mode.

    python -m dynseg_torch.probes.stress_scale [--tiles 20] [--size 3000]
        [--iters 200] [--device cuda]

Prints the script's lines, and beside each host RSS the device's peak
memory and the card's name and power limit; then the set-up's parts
(padding, tables, upload), ms/step and patches/s per bucket, the chunk
losses' summary, `fold_peak_bytes` of the window run, K2's launches
against the gathers the run made, and K2 against its plain version,
bitwise, on one real batch of every bucket. Training starts from the
JAX package's init for seed 0, as the script's (`Trainer.init_state(0)`).
`Trainer.__init__` asks cuDNN for its deterministic algorithms for the
whole process, so the two validate_test runs here take them too, unlike
a testing process.
--device cpu runs the plain versions (the tests); with the default cuda
and no card it exits non-zero before any work.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import resource
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from dynseg_torch.config import (Config, DataConfig, InferConfig, ModelConfig,
                                 SchedulerConfig, TrainConfig)
from dynseg_torch.data.tiles import compute_stats, pack_tiles
from dynseg_torch.infer import validate_test
from dynseg_torch.ops import gather
from dynseg_torch.probes.int8_kernel_probe import card
from dynseg_torch.sched.scheduler import ScaleScheduler
from dynseg_torch.train import Trainer, resolve_device, train_loop


def synth_tiles(rng, n, size, num_classes=6, bands=3):
    """Potsdam-like uint8 rasters with learnable blob structure (float32
    arrays, as the script makes them, byte for byte)."""
    ims, mks = [], []
    sig = np.random.default_rng(7).uniform(40, 215, (num_classes, bands))
    for _ in range(n):
        low = rng.normal(size=(num_classes, size // 64 + 1, size // 64 + 1))
        fields = np.stack([np.kron(low[c], np.ones((64, 64)))[:size, :size]
                           for c in range(num_classes)])
        mask = np.argmax(fields, axis=0).astype(np.int32)
        im = sig[mask] + rng.normal(scale=14.0, size=(size, size, bands))
        ims.append(np.clip(np.round(im), 0, 255).astype(np.float32))
        mks.append(mask)
    return ims, mks


def rss_gb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def where(device: torch.device, name: str) -> str:
    """What a number was taken on: the device's peak memory so far and the
    card's name and power limit, or the CPU."""
    if device.type != "cuda":
        return "cpu"
    return (f"device peak {torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB; "
            f"{name}")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_config(iters: int) -> Config:
    """The script's configuration."""
    return Config(
        model=ModelConfig(net_type="dilated_icpr_rate6", num_classes=6),
        sched=SchedulerConfig(distribution_type="multinomial",
                              values=(25, 35, 45, 55, 65)),
        train=TrainConfig(batch_size=100, seed=0, steps_per_call=8,
                          metric_fetch_depth=4, rescale_batch_by_area=True,
                          niter=iters),
        infer=InferConfig(scales=(25, 35, 45, 55, 65), window_batch=128,
                          dense_block=512, dense_halo=40),
        data=DataConfig(dataset="synthetic",
                        max_positions_per_class=2_000_000),
    )


def check_gather(trainer: Trainer) -> List[tuple]:
    """K2 against its plain version on one real batch of every bucket
    (positions and augment ids drawn by the run's sampler, the resident
    tile stack): (batch, size, bitwise equal) per bucket."""
    out = []
    for s in trainer.scales:
        pos, aug = trainer.make_batch_inputs(s)
        args = (trainer.images, trainer.masks, trainer.mean, trainer.std,
                pos[0], aug[0], s)
        got, want = gather.gather_batch(*args), gather.gather_batch_ref(*args)
        out.append((int(pos.shape[1]), s,
                    all(map(torch.equal, got, want))))
    return out


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m dynseg_torch.probes.stress_scale",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--tiles", type=int, default=20)
    ap.add_argument("--size", type=int, default=3000)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits non-zero without a card) or cpu")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, variables: Optional[dict] = None) -> dict:
    """The rehearsal on args.device from `variables` (a Flax-shaped tree
    with numpy leaves; default the reference's init for seed 0). Returns the chunk
    losses, the log lines, both modes' scores, K2's launches and the
    gathers of the run, and the K2 check."""
    dev = resolve_device(args.device)
    name = card() if dev.type == "cuda" else "cpu"
    print(f"platform: {dev.type} ({name})", flush=True)
    rng = np.random.default_rng(0)

    t0 = time.perf_counter()
    ims, mks = synth_tiles(rng, args.tiles, args.size)
    train_tiles = pack_tiles(ims, mks)
    compute_stats(train_tiles)
    ims_t, mks_t = synth_tiles(rng, 2, args.size)
    test_tiles = pack_tiles(ims_t, mks_t)
    test_tiles.mean, test_tiles.std = train_tiles.mean, train_tiles.std
    mpx = args.tiles * args.size ** 2 / 1e6
    print(f"built {args.tiles}x{args.size}^2 = {mpx:.0f} Mpx train set "
          f"in {time.perf_counter() - t0:.1f}s (host RSS {rss_gb():.1f} GB) "
          f"[{where(dev, name)}]", flush=True)

    cfg = build_config(args.iters)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, train_tiles, dev)
    print(f"Trainer init (tables + upload): {time.perf_counter() - t0:.1f}s "
          f"(host RSS {rss_gb():.1f} GB; tile storage "
          f"{str(trainer.images.dtype).replace('torch.', '')}) "
          f"[{where(dev, name)}]", flush=True)
    print("  of it: " + ", ".join(f"{k} {v:.2f}s" for k, v in trainer.setup_s.items())
          + f"; tile stack {tuple(trainer.images.shape)}, position tables "
          + "/".join(str(len(t)) for t in trainer.sampler.tables) + f" [{name}]",
          flush=True)

    state = trainer.init_state(0, variables)
    gather.launches = 0
    times = trainer.compile_buckets(state)
    print("bucket compiles: " + " ".join(f"{s}:{dt:.2f}s" for s, dt in times.items())
          + f" (one warm-up call of {cfg.train.steps_per_call} steps a bucket) [{name}]",
          flush=True)

    sched = ScaleScheduler(cfg.sched, seed=0)
    logs, losses = [], []
    step = trainer.train_step

    def recording(st, size):
        st, m = step(st, size)
        losses.append(m["loss"])
        return st, m

    trainer.train_step = recording
    t0 = time.perf_counter()
    state = train_loop(cfg, trainer, state, sched, niter=args.iters,
                       log_every=max(50, args.iters // 4), log=logs.append)
    sync(dev)
    dt = time.perf_counter() - t0
    trainer.train_step = step
    launches = gather.launches
    for line in logs:
        print("  " + line, flush=True)
    print(f"train {args.iters} iters (5-scale dynamic): {dt:.1f}s [{name}]", flush=True)
    k = cfg.train.steps_per_call
    for size, st in trainer.step_stats().items():
        print(f"  scale {size}: batch {trainer.batch_size_for(size)}, {st['steps']} "
              f"steps, {st['ms_per_step']:.3f} ms/step, "
              f"{st['patches_per_s']:.1f} patches/s [{name}]", flush=True)
    vals = [float(x) for x in losses]
    q = max(1, len(vals) // 4)
    print(f"loss by chunk: {len(vals)} chunks of {k} steps, all finite: "
          f"{all(map(math.isfinite, vals))}; mean of the first {q} "
          f"{np.mean(vals[:q]):.4f}, of the last {q} {np.mean(vals[-q:]):.4f}",
          flush=True)
    gathers = len(trainer.scales) * k + state.step
    print(f"K2 launches: {launches} (gathers {gathers}: {len(trainer.scales)} x {k} "
          f"warm-up + {state.step} steps; 0 on the CPU, where the plain "
          f"version runs)", flush=True)

    variables_t = state.model.state_dict()
    scores = {}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    for mode in ("dense", "window"):
        c = dataclasses.replace(cfg, infer=dataclasses.replace(cfg.infer, mode=mode))
        if dev.type == "cuda":
            # Each mode's own peak; `peak` keeps the run's.
            peak = max(peak, torch.cuda.max_memory_allocated(dev))
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        scores[mode] = validate_test(c, variables_t, test_tiles, dev,
                                     log=lambda *_: None)
        dt = time.perf_counter() - t0
        fold = (f", fold_peak_bytes {scores[mode]['fold_peak_bytes']}"
                if mode == "window" else "")
        print(f"validate_test[{mode}] 2x{args.size}^2: {dt:.1f}s "
              f"({2 * args.size ** 2 / dt / 1e6:.2f} Mpx/s) "
              f"OA={scores[mode]['oa']:.4f} meanF1={scores[mode]['mean_f1']:.4f} "
              f"[{where(dev, name)}{fold}; cuDNN deterministic]", flush=True)

    checks = check_gather(trainer)
    for b, s, same in checks:
        print(f"K2 real batch B={b} s={s} on the {trainer.images.shape[0]}-tile "
              f"stack ({'kernel' if dev.type == 'cuda' else 'plain'} vs plain): "
              f"bitwise: {same}", flush=True)
    if dev.type == "cuda":
        peak = max(peak, torch.cuda.max_memory_allocated(dev))
    print(f"final host RSS {rss_gb():.1f} GB "
          f"[{f'device peak over the run {peak / 1e9:.2f} GB; {name}' if peak else name}]",
          flush=True)
    return {"losses": vals, "logs": logs, "scores": scores, "launches": launches,
            "gathers": gathers, "gather_check": checks}


def main(argv: Optional[List[str]] = None, variables: Optional[dict] = None) -> int:
    args = parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"stress_scale: {e}", file=sys.stderr)
        return 1
    run(args, variables)
    return 0


if __name__ == "__main__":
    sys.exit(main())
