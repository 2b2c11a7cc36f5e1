"""How much device memory does the window estimator's fold hold at one
large scale, and what does it cost in Mpx/s? Runs
`Inferencer._window_device` once, window mode, float, at full width
(dilated_icpr_rate6, the reference's initial weights for seed 0), on one
synthetic tile of --size^2 pixels at one scale, and prints the windows,
the reference's estimate of the scale's collected buffer (`nb·B·s²·nc·4`
bytes), `fold_peak_bytes` (the largest tensor collected for a fold, where
the package reports it), the device's peak memory, the wall time and
Mpx/s, and a hash of the vote counts and of the labels (--out also saves
the labels beside the JSON, as PATH.labels.npy).

    python -m dynseg_torch.probes.fold_memory [--root DIR] [--size 2048]
        [--scale 25] [--stride_fraction 0.125] [--classes 6]
        [--window_batch 256] [--out PATH]

DYNSEG_FOLD_MEM_GB (default 2.0) is read by the package, as in any run.
--root runs the `dynseg_torch` package found in DIR (for example a
`git archive` of an earlier commit), so that two versions are held side
by side in one call on one card; the default is this checkout. Needs a
CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from dynseg_torch.probes import import_from


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="directory whose dynseg_torch package is run")
    ap.add_argument("--size", type=int, default=2048)
    ap.add_argument("--scale", type=int, default=25)
    ap.add_argument("--stride_fraction", type=float, default=0.125)
    ap.add_argument("--classes", type=int, default=6)
    ap.add_argument("--window_batch", type=int, default=256)
    ap.add_argument("--out", default=None, help="also write the result as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fold_memory: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    pkg = import_from(args.root or here)
    from dynseg_torch import infer
    from dynseg_torch.bridge import flax_to_torch, init_variables_like_reference
    from dynseg_torch.config import Config, InferConfig, ModelConfig
    from dynseg_torch.data.datasets import load_synthetic

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    s, nc, B = args.scale, args.classes, args.window_batch
    cfg = Config(
        model=ModelConfig(net_type="dilated_icpr_rate6", num_classes=nc,
                          num_input_bands=3, width_multiplier=1.0),
        infer=InferConfig(scales=(s,), mode="window", quant="none",
                          stride_fraction=args.stride_fraction, window_batch=B,
                          save_prediction_maps=False))
    weights = flax_to_torch(init_variables_like_reference(cfg.model, 3, seed=0))
    dev = torch.device("cuda")
    weights = {k: v.to(dev) for k, v in weights.items()}
    # Warm-up on a small tile: cuDNN's first calls at the window batch.
    small = load_synthetic(seed=0, num_tiles=1, size=128, num_classes=nc)[1]
    infer.Inferencer(cfg, small, device=dev)._window_device(weights, 0)
    tiles = load_synthetic(seed=0, num_tiles=1, size=args.size, num_classes=nc)[1]
    inf = infer.Inferencer(cfg, tiles, device=dev)
    h, w = (int(v) for v in inf.valid_hw[0])
    hp, wp = inf.padded_hw
    stride = min(s, max(1, int(round(s * args.stride_fraction))))
    windows = (len(infer.window_origins(inf.pad, inf.pad + h, s, stride, hp - s))
               * len(infer.window_origins(inf.pad, inf.pad + w, s, stride, wp - s)))
    estimate = -(-windows // B) * B * s * s * nc * 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pred, _, cnt = inf._window_device(weights, 0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = {
        "package": pkg, "card": card, "tile": [h, w], "scale": s, "stride": stride,
        "classes": nc, "window_batch": B, "windows": windows,
        "estimate_bytes": estimate,
        "cap_gb": float(os.environ.get("DYNSEG_FOLD_MEM_GB", "2.0")),
        "fold_peak_bytes": getattr(inf, "fold_peak_bytes", None),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "wall_s": wall, "mpx_s": h * w / wall / 1e6,
        "counts_sha256": hashlib.sha256(cnt.cpu().numpy().tobytes()).hexdigest()[:16],
        "labels_sha256": hashlib.sha256(pred.cpu().numpy().tobytes()).hexdigest()[:16],
    }
    print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f)
        np.save(args.out + ".labels.npy", pred.cpu().numpy())
    return 0


if __name__ == "__main__":
    sys.exit(main())
