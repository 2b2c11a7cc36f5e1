"""Dense-mode block-size and compute-dtype sweep of the port (counterpart
of scripts/sweep_dense.py): one --size^2 uint8 tile predicted in dense
blocks of each --blocks size, in float32 and then in bfloat16, each
block size once to warm up and once timed.

    python -m dynseg_torch.probes.sweep_dense [--size 2048]
        [--blocks 256,384,512,768,1024] [--halo 40] [--device cuda]

Each line gives Mpx/s, the label agreement with the float32 block-512
labels (the script's reference), and the device's peak memory over the
timed call beside the card's name and power limit. Blocks are grouped as
the package groups them (8 a forward, or all of a tile that has fewer).
The weights are random (`profile_multitile.random_weights`: the
script's, the reference's init for seed 0, or a Flax-shaped tree the
caller passes); both dtypes use the same float32 params. --device cpu runs on the CPU (the tests); with
the default cuda and no card it exits non-zero before any work.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from dynseg_torch.config import Config, InferConfig, ModelConfig
from dynseg_torch.data.tiles import compute_stats, pack_tiles
from dynseg_torch.infer import Inferencer
from dynseg_torch.probes.int8_kernel_probe import card
from dynseg_torch.probes.profile_multitile import random_weights
from dynseg_torch.probes.stress_scale import sync, where
from dynseg_torch.train import resolve_device


def make_tile(size: int):
    """The script's tile from default_rng(0): a uint8 image and an int32
    mask of size x size."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (size, size, 3)).astype(np.uint8)
    mask = rng.integers(0, 6, (size, size)).astype(np.int32)
    return img, mask


def build_config(dtype: str, halo: int) -> Config:
    """The script's configuration for one compute dtype."""
    mc = ModelConfig(net_type="dilated_icpr_rate6", num_classes=6,
                     compute_dtype=dtype)
    return Config(model=mc, infer=InferConfig(scales=(25,), dense_halo=halo))


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m dynseg_torch.probes.sweep_dense",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=2048)
    ap.add_argument("--blocks", type=str, default="256,384,512,768,1024")
    ap.add_argument("--halo", type=int, default=40)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits non-zero without a card) or cpu")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, variables: Optional[dict] = None) -> dict:
    """The sweep on args.device. Returns {(dtype, block): agreement with
    the float32 block-512 labels}."""
    dev = resolve_device(args.device)
    name = card() if dev.type == "cuda" else "cpu"
    blocks = [int(b) for b in args.blocks.split(",")]
    print(f"platform: {dev.type} ({name})", flush=True)
    img, mask = make_tile(args.size)
    ts = pack_tiles([img], [mask])
    compute_stats(ts)
    px = args.size * args.size

    ref = None
    agree = {}
    for dtype in ("float32", "bfloat16"):
        cfg = build_config(dtype, args.halo)
        weights = random_weights(cfg.model, dev, variables)
        inf = Inferencer(cfg, ts, dev)
        if ref is None:  # f32 block=512 reference predictions
            ref, _ = inf.predict_tile_dense(
                weights, 0, block=512, halo=args.halo, return_probs=False)
        for b in blocks:
            kw = dict(block=b, halo=args.halo, return_probs=False)
            inf.predict_tile_dense(weights, 0, **kw)  # warm
            sync(dev)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            pred, _ = inf.predict_tile_dense(weights, 0, **kw)
            dt = time.perf_counter() - t0
            ext = b + 2 * args.halo
            agree[(dtype, b)] = float(np.mean(pred == ref))
            print(f"{dtype} block={b} (ext={ext}, halo-ovh x{ext * ext / b / b:.2f}): "
                  f"{dt:.3f}s = {px / dt / 1e6:.2f} Mpx/s"
                  f"  agree(ref)={agree[(dtype, b)]:.4f} [{where(dev, name)}]",
                  flush=True)
    return agree


def main(argv: Optional[List[str]] = None, variables: Optional[dict] = None) -> int:
    args = parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"sweep_dense: {e}", file=sys.stderr)
        return 1
    run(args, variables)
    return 0


if __name__ == "__main__":
    sys.exit(main())
