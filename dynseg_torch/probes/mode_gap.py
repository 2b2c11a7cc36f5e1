"""The dense-vs-window estimator accuracy gap of the port (counterpart of
scripts/mode_gap.py).

`dense` inference is one full-receptive-field forward per pixel, where
window voting feeds the net patch-sized contexts as training did: a
different estimator. This measures the accuracy cost on the
context-sensitive texture benchmark for two training regimes:

  * single_fixed@25: trained on small contexts only, so dense inference
    hands the net far more context than it ever saw (the worst case for
    the estimator mismatch);
  * multinomial 25..65: dynamic training covered contexts up to 65 px
    (about the nets' receptive field), so dense input looks in
    distribution.

For each: OA/meanF1 under window (trained scales) and dense, and each
mode's inference time (`infer_wall_s` of a second run_testing call, the
first one warms the mode).

    python -m dynseg_torch.probes.mode_gap [--niter 1500] [--seeds 2]
        [--out docs/torch_mode_gap.json] [--device cuda]

The script's flags, defaults, printed lines and JSON schema, plus
--device (default cuda; with no card it exits 1 before any work; cpu for
the tests), and --out's default, which keeps the JAX package's committed
docs/mode_gap.json as it is. Under each training run it prints the lines
of `dynseg_torch.probes.study`. A preempted training run stops the sweep
with exit 1 and writes nothing.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
from typing import List, Optional

from dynseg_torch import cli
from dynseg_torch.probes import study

REGIMES = [
    ("single_fixed@25", "single_fixed", "25"),
    ("multinomial25-65", "multinomial", "25,35,45,55,65"),
]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m dynseg_torch.probes.mode_gap",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="synthetic_texture")
    ap.add_argument("--niter", type=int, default=1500)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--net_type", default="dilated_icpr_rate6")
    ap.add_argument("--out", default="docs/torch_mode_gap.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits non-zero without a card) or cpu")
    args = ap.parse_args(argv)
    if args.seeds < 1:
        # 0 would crash the summary with ZeroDivisionError after the
        # (empty) sweep.
        ap.error("--seeds must be >= 1")
    return args


def run(args: argparse.Namespace, device) -> Optional[dict]:
    """Both regimes x args.seeds on `device`; writes args.out and returns
    its payload, or None when a training run was preempted."""
    rows = []
    for name, dist, values in REGIMES:
        for seed in range(args.seeds):
            with tempfile.TemporaryDirectory() as tmp:
                cli_args = cli.build_argparser().parse_args([
                    "--operation", "training",
                    "--dataset", args.dataset,
                    "--output_path", tmp,
                    "--net_type", args.net_type,
                    "--distribution_type", dist,
                    "--values", values,
                    "--niter", str(args.niter),
                    "--batch_size", str(args.batch_size),
                    "--rescale_batch_by_area",
                    "--seed", str(seed),
                    "--eval_every", str(10 * args.niter),
                    "--checkpoint_every", str(10 * args.niter),
                    "--window_batch", "256",
                    "--no_prediction_maps",
                ])
                cfg = cli.config_from_args(cli_args)
                scores = study.train(cfg, device, lambda *_: None)
                if scores.get("preempted"):
                    # SIGINT/SIGTERM lands in train_loop's handler and
                    # run_training returns: a half-trained checkpoint must
                    # not be scored and recorded as a row.
                    print("preempted — aborting sweep", file=sys.stderr)
                    return None
                row = {"train": name, "seed": seed}
                for mode in ("window", "dense"):
                    # The first call warms the mode; the second's
                    # inference-only timer is the row's.
                    cfg_m = dataclasses.replace(
                        cfg, infer=dataclasses.replace(cfg.infer, mode=mode))
                    cli.run_testing(cfg_m, log=lambda *_: None, device=device)
                    s = cli.run_testing(cfg_m, log=lambda *_: None, device=device)
                    row[mode] = {
                        "oa": round(float(s["oa"]), 4),
                        "mean_f1": round(float(s["mean_f1"]), 4),
                        "wall_s": float(s["infer_wall_s"]),
                    }
                row["gap_oa"] = round(row["window"]["oa"] - row["dense"]["oa"], 4)
                print(json.dumps(row), flush=True)
                rows.append(row)

    summary = []
    for name, _, _ in REGIMES:
        rs = [r for r in rows if r["train"] == name]
        summary.append({
            "train": name,
            "window_oa": round(sum(r["window"]["oa"] for r in rs) / len(rs), 4),
            "dense_oa": round(sum(r["dense"]["oa"] for r in rs) / len(rs), 4),
            "gap_oa": round(sum(r["gap_oa"] for r in rs) / len(rs), 4),
        })
    payload = {"dataset": args.dataset, "niter": args.niter,
               "seeds": args.seeds, "rows": rows, "summary": summary}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2)
    print(json.dumps(summary))
    return payload


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    device = study.open_device(args.device, "mode_gap")
    if device is None:
        return 1
    return 1 if run(args, device) is None else 0


if __name__ == "__main__":
    sys.exit(main())
