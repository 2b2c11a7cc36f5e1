"""Multi-tile inference rehearsal of the port (counterpart of
scripts/profile_multitile.py): four odd-sized uint8 tiles (~12 Mpx in
all, Vaihingen-scale) through two full validate_test passes in window
mode, then a warm per-tile decomposition on one Inferencer: window, and
dense at block 512 with halo 40.

    python -m dynseg_torch.probes.profile_multitile
        [--scales 25,35,45,55,65] [--window_batch 128] [--device cuda]

Prints the script's lines, each time with the device's peak memory and
the card's name and power limit, and whether pass 2's label maps equal
pass 1's. The weights are random (`random_weights`: the port's seeded
init, or a Flax-shaped tree the caller passes). PyTorch compiles
nothing, so "pass1(+compile)" keeps the script's label for cuDNN's first
calls at each shape. The script synchronises by reading one scalar (a
TPU relayout); here every timed region ends in torch.cuda.synchronize().
--device cpu runs the plain versions (the tests); with the default cuda
and no card it exits non-zero before any work.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from dynseg_torch.bridge import flax_to_torch, init_variables_like_reference
from dynseg_torch.config import Config, InferConfig, ModelConfig
from dynseg_torch.data.tiles import compute_stats, pack_tiles
from dynseg_torch.infer import Inferencer, validate_test
from dynseg_torch.probes.int8_kernel_probe import card
from dynseg_torch.probes.stress_scale import sync, where
from dynseg_torch.train import resolve_device

SIZES = [(2048, 1536), (1792, 1664), (1920, 1440), (1856, 1600)]


def random_weights(model_cfg: ModelConfig, device: torch.device,
                   variables: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """The probe's weights on `device`: `variables` (a Flax-shaped tree with
    numpy leaves) or else the script's, the reference's init for seed 0
    (`init_variables_like_reference`), as a state_dict."""
    if variables is None:
        variables = init_variables_like_reference(model_cfg, model_cfg.num_input_bands,
                                                  seed=0)
    return {k: v.to(device) for k, v in flax_to_torch(variables).items()}


def make_tiles():
    """The script's four tiles from default_rng(0): uint8 images and int32
    masks of SIZES."""
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (h, w, 3)).astype(np.uint8) for h, w in SIZES]
    masks = [rng.integers(0, 6, (h, w)).astype(np.int32) for h, w in SIZES]
    return imgs, masks


def build_config(scales, window_batch: int) -> Config:
    """The script's configuration."""
    return Config(
        model=ModelConfig(net_type="dilated_icpr_rate6", num_classes=6),
        infer=InferConfig(
            scales=scales, window_batch=window_batch,
            dense_block=512, dense_halo=40,
        ),
    )


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m dynseg_torch.probes.profile_multitile",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--scales", type=str, default="25,35,45,55,65")
    ap.add_argument("--window_batch", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits non-zero without a card) or cpu")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, variables: Optional[dict] = None) -> dict:
    """The rehearsal on args.device. Returns the label maps of both passes
    ("pass1", "pass2") and of the warm decomposition ("window", "dense"),
    per tile, int32."""
    dev = resolve_device(args.device)
    name = card() if dev.type == "cuda" else "cpu"
    scales = tuple(int(s) for s in args.scales.split(","))
    print(f"platform: {dev.type} ({name})", flush=True)
    imgs, masks = make_tiles()
    ts = pack_tiles(imgs, masks)
    compute_stats(ts)
    mpx = sum(h * w for h, w in SIZES) / 1e6
    print(f"{len(SIZES)} tiles, {mpx:.1f} Mpx total, uint8 storage", flush=True)

    cfg = build_config(scales, args.window_batch)
    weights = random_weights(cfg.model, dev, variables)
    out = {}
    for key, label in (("pass1", "pass1(+compile)"), ("pass2", "pass2(warm, incl upload)")):
        t0 = time.perf_counter()
        scores = validate_test(cfg, weights, ts, dev, log=lambda *_: None)
        sync(dev)
        dt = time.perf_counter() - t0
        out[key] = scores["predictions"]
        print(f"window e2e {label}: {dt:.2f}s = {mpx / dt:.2f} Mpx/s "
              f"[{where(dev, name)}]", flush=True)
    same = all(np.array_equal(a, b) for a, b in zip(out["pass1"], out["pass2"]))
    print(f"pass2 labels == pass1 labels: {same}", flush=True)

    # Decomposition: one Inferencer (upload once), warm per-tile predicts.
    t0 = time.perf_counter()
    inf = Inferencer(cfg, ts, dev)
    sync(dev)
    print(f"Inferencer init + tile upload: {time.perf_counter() - t0:.2f}s [{name}]",
          flush=True)

    for t in range(ts.num_tiles):  # warm both paths on every tile shape
        inf.predict_tile(weights, t, return_probs=False)
        inf.predict_tile_dense(weights, t, block=512, halo=40, return_probs=False)
    for key, fn in (
        ("window", lambda t: inf.predict_tile(weights, t, return_probs=False)),
        ("dense", lambda t: inf.predict_tile_dense(
            weights, t, block=512, halo=40, return_probs=False)),
    ):
        t0 = time.perf_counter()
        out[key] = [fn(t)[0] for t in range(ts.num_tiles)]
        sync(dev)
        dt = time.perf_counter() - t0
        print(f"{key} warm device-resident: {dt:.2f}s = {mpx / dt:.2f} Mpx/s "
              f"[{where(dev, name)}]", flush=True)
    return out


def main(argv: Optional[List[str]] = None, variables: Optional[dict] = None) -> int:
    args = parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"profile_multitile: {e}", file=sys.stderr)
        return 1
    run(args, variables)
    return 0


if __name__ == "__main__":
    sys.exit(main())
