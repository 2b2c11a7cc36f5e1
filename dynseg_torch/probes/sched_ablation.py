"""Scheduler ablation of the port on the context-sensitive texture
benchmark (counterpart of scripts/sched_ablation.py).

Runs every distribution_type (plus single_fixed at EACH scale) on
`synthetic_texture`, where per-pixel accuracy on the coarse texture pair
depends on spatial context, and reports test OA/meanF1 per configuration
over N seeds: the paper's core claim (score-driven context selection
beats every fixed context), measured on the port.

Each run evaluates with the full method's protocol: window voting over
the scales that config trained on (single_fixed@v votes at v alone; the
dynamic configs fuse all --values).

    python -m dynseg_torch.probes.sched_ablation [--niter 1500] [--seeds 3]
        [--values 25,35,45,55,65] [--out docs/torch_sched_ablation.json]
        [--device cuda]

The script's flags, defaults, printed lines and JSON schema, but for
--device (default cuda; with no card it exits 1 before any work; cpu for
the tests) in place of --platform, and --out's default, which keeps the
JAX package's committed docs/sched_ablation.json as it is. Under each
run it prints the lines of `dynseg_torch.probes.study`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from typing import List, Optional

from dynseg_torch import cli
from dynseg_torch.config import DISTRIBUTION_TYPES
from dynseg_torch.probes import study


def run_one(args, distribution, values, seed, update_type="acc", *, device):
    with tempfile.TemporaryDirectory() as tmp:
        cli_args = cli.build_argparser().parse_args([
            "--operation", "training",
            "--dataset", args.dataset,
            "--dataset_path", args.dataset_path,
            "--dataset_kwargs", args.dataset_kwargs,
            "--output_path", tmp,
            "--net_type", args.net_type,
            "--distribution_type", distribution,
            "--values", ",".join(str(v) for v in values),
            "--update_type", update_type,
            "--sched_temperature", str(args.sched_temperature),
            "--niter", str(args.niter),
            "--batch_size", str(args.batch_size),
            "--learning_rate", str(args.learning_rate),
            "--seed", str(seed),
            "--eval_every", str(10 * args.niter),
            "--checkpoint_every", str(10 * args.niter),
            "--window_batch", str(args.window_batch),
            "--no_prediction_maps",
        ] + (["--rescale_batch_by_area"] if args.rescale_batch_by_area else []))
        cfg = cli.config_from_args(cli_args)
        if args.width_multiplier != 1.0:
            cfg = dataclasses.replace(
                cfg, model=dataclasses.replace(
                    cfg.model, width_multiplier=args.width_multiplier))
        logs = []

        def log(*msg):
            line = " ".join(str(m) for m in msg)
            logs.append(line)
            if "final scale distribution" in line:
                print(f"    {line}")

        t0 = time.time()
        scores = study.train(cfg, device, log)
        if scores.get("preempted"):
            raise KeyboardInterrupt
        return {
            "seed": seed,
            "oa": float(scores["oa"]),
            "kappa": float(scores["kappa"]),
            "mean_f1": float(scores["mean_f1"]),
            "wall_s": round(time.time() - t0, 1),
            "final_distribution": next(
                (ln for ln in logs if "final scale distribution" in ln), ""),
        }


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m dynseg_torch.probes.sched_ablation",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="synthetic_texture")
    ap.add_argument("--dataset_path", default="")
    ap.add_argument("--dataset_kwargs", default="",
                    help="JSON loader kwargs (e.g. the harsh-imbalance "
                         "run: '{\"class_probs\": [0.02,0.08,0.55,0.35]}')")
    ap.add_argument("--values", default="25,35,45,55,65")
    ap.add_argument("--niter", type=int, default=1500)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--learning_rate", type=float, default=0.01)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--seed_start", type=int, default=0,
                    help="first seed (extend an earlier sweep without "
                         "re-running its seeds; merge the JSONs offline)")
    ap.add_argument("--net_type", default="dilated_icpr_rate6")
    ap.add_argument("--width_multiplier", type=float, default=1.0)
    ap.add_argument("--window_batch", type=int, default=256)
    ap.add_argument("--rescale_batch_by_area", action="store_true")
    ap.add_argument("--update_type", default="acc")
    ap.add_argument("--sched_temperature", type=float, default=1.0)
    ap.add_argument("--distributions", default="multi_fixed,uniform,multinomial",
                    help="comma list of dynamic distribution types to run")
    ap.add_argument("--tag", default="",
                    help="suffix appended to config names in the output")
    ap.add_argument("--skip_single_fixed", action="store_true",
                    help="only run the dynamic distribution types over the "
                         "full --values list (skip per-scale baselines)")
    ap.add_argument("--out", default="docs/torch_sched_ablation.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits non-zero without a card) or cpu")
    args = ap.parse_args(argv)
    if args.seeds < 1:
        # 0 would reach summarize() and die on sum([])/0 after the (empty)
        # sweep.
        ap.error("--seeds must be >= 1")
    # A typo'd distribution must fail now, not after hours of completed
    # baseline runs.
    dists = [d.strip() for d in args.distributions.split(",") if d.strip()]
    bad = [d for d in dists if d not in DISTRIBUTION_TYPES]
    if bad:
        ap.error(f"unknown --distributions {bad}; accepted: "
                 f"{sorted(DISTRIBUTION_TYPES)}")
    return args


def summarize(name, dist, vals, runs):
    oas = [r["oa"] for r in runs]
    f1s = [r["mean_f1"] for r in runs]
    return {
        "config": name, "distribution": dist, "values": vals,
        "oa_mean": round(sum(oas) / len(oas), 4),
        "oa_min": round(min(oas), 4), "oa_max": round(max(oas), 4),
        "f1_mean": round(sum(f1s) / len(f1s), 4),
        "runs": runs,
    }


def run(args: argparse.Namespace, device) -> dict:
    """The sweep on `device`; writes args.out and returns its payload.
    An interrupt writes the completed configs (and the in-flight one's
    completed seeds, as "<name>(partial)") as the payload; any other
    exception writes {"partial": true, "results": ...} and re-raises."""
    values = [int(v) for v in args.values.split(",")]
    dists = [d.strip() for d in args.distributions.split(",") if d.strip()]
    configs = []
    if not args.skip_single_fixed:
        configs += [(f"single_fixed@{v}{args.tag}", "single_fixed", [v])
                    for v in values]
    configs += [(d + args.tag, d, values) for d in dists]

    results = []
    try:
        for name, dist, vals in configs:
            runs = []
            for seed in range(args.seed_start, args.seed_start + args.seeds):
                print(f"[{name} seed={seed}] ...", flush=True)
                try:
                    r = run_one(args, dist, vals, seed,
                                update_type=args.update_type, device=device)
                except BaseException:
                    # Keep the in-flight config's completed seeds too: each
                    # is a full training run.
                    if runs:
                        results.append(summarize(
                            name + "(partial)", dist, vals, runs))
                    raise
                print(f"[{name} seed={seed}] OA={r['oa']:.4f} "
                      f"meanF1={r['mean_f1']:.4f} ({r['wall_s']}s)",
                      flush=True)
                runs.append(r)
            results.append(summarize(name, dist, vals, runs))
    except KeyboardInterrupt:
        print("interrupted — writing partial results")
    except BaseException:
        # A device fault mid-sweep must not lose the completed runs: write
        # the partials, then re-raise for the caller.
        print("run failed — writing partial results", file=sys.stderr)
        if results:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump({"partial": True, "results": results}, f, indent=2)
        raise

    results.sort(key=lambda r: -r["oa_mean"])
    payload = {
        "dataset": args.dataset, "values": values, "niter": args.niter,
        "batch_size": args.batch_size, "seeds": args.seeds,
        "seed_start": args.seed_start, "net_type": args.net_type,
        "update_type": args.update_type,
        "sched_temperature": args.sched_temperature,
        "distributions": dists, "tag": args.tag,
        "rescale_batch_by_area": args.rescale_batch_by_area,
        # The generator knobs are part of the protocol: without them a
        # JSON can be neither reproduced nor paired.
        "dataset_kwargs": args.dataset_kwargs,
        "results": results,
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2)
    print(f"\n{'config':<18} {'OA':>8} {'min':>8} {'max':>8} {'meanF1':>8}")
    for r in results:
        print(f"{r['config']:<18} {r['oa_mean']:>8.4f} {r['oa_min']:>8.4f} "
              f"{r['oa_max']:>8.4f} {r['f1_mean']:>8.4f}")
    print(f"-> {args.out}")
    return payload


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    device = study.open_device(args.device, "sched_ablation")
    if device is None:
        return 1
    run(args, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
