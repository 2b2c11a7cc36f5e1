"""Accuracy-parity bracket of the port (counterpart of
scripts/parity_bracket.py).

A handful of semantic choices of the reference are reconstructions that
can each move F1 by more than half a point:

  * the scheduler's sign convention (favor_high_score: exploit good
    contexts, or train the struggling ones)
  * the scheduler's score source (update_type: acc or loss)
  * the leaky-ReLU slope (0.1, or TF's default 0.2)
  * batch norm in the conv blocks (present or absent)

This trains every combination of the bracket on the same dataset and
seeds and ranks the combinations by mean F1, so that the semantics can
be picked by validation score.

    python -m dynseg_torch.probes.parity_bracket [--dataset synthetic_multi]
        [--niter 300] [--seeds 2] [--values 9,15] [--out torch_bracket.json]
        [--combos N] [--device cuda]

The script's flags, defaults, printed lines and JSON schema, but for
--device (default cuda; with no card it exits 1 before any work; cpu for
the tests) in place of --platform, and --out's default
(torch_bracket.json, not the script's bracket.json). Under each run it
prints the lines of `dynseg_torch.probes.study`. An interrupt outside
train_loop (or a preempted run) writes the partial ranking and exits 130.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import sys
import tempfile
from typing import List, Optional

from dynseg_torch import cli
from dynseg_torch.probes import study


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m dynseg_torch.probes.parity_bracket",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="synthetic_multi")
    ap.add_argument("--dataset_path", default="")
    ap.add_argument("--fold", type=int, default=0)
    ap.add_argument("--niter", type=int, default=300)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--values", default="9,15")
    ap.add_argument("--seeds", type=int, default=2,
                    help="repeat each combination with this many seeds")
    ap.add_argument("--width_multiplier", type=float, default=0.25)
    ap.add_argument("--net_type", default="dilated_icpr_rate6")
    ap.add_argument("--out", default="torch_bracket.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits non-zero without a card) or cpu")
    ap.add_argument("--combos", type=int, default=0,
                    help="only run the first N bracket combinations (smoke)")
    return ap.parse_args(argv)


def bracket(combos: int = 0) -> list:
    """(favor_high_score, update_type, leaky_slope, use_batch_norm) of every
    combination, in the script's order; the first `combos` if given."""
    out = list(itertools.product(
        (True, False),        # favor_high_score
        ("acc", "loss"),      # update_type
        (0.1, 0.2),           # leaky_slope
        (True, False),        # use_batch_norm
    ))
    return out[:combos] if combos else out


def run(args: argparse.Namespace, device, results: list) -> None:
    """Train every combination x seed on `device`, appending one ranked
    entry per finished combination to `results`; a preempted run raises
    KeyboardInterrupt."""
    for favor, upd, slope, bn in bracket(args.combos):
        f1s = []
        for seed in range(args.seeds):
            with tempfile.TemporaryDirectory() as tmp:
                cli_args = cli.build_argparser().parse_args([
                    "--operation", "training",
                    "--dataset", args.dataset,
                    "--dataset_path", args.dataset_path,
                    "--fold", str(args.fold),
                    "--output_path", tmp,
                    "--net_type", args.net_type,
                    "--distribution_type", "multinomial",
                    "--values", args.values,
                    "--update_type", upd,
                    "--niter", str(args.niter),
                    "--batch_size", str(args.batch_size),
                    "--seed", str(seed),
                    "--eval_every", str(10 * args.niter),
                    "--checkpoint_every", str(10 * args.niter),
                    "--no_prediction_maps",
                ])
                cfg = cli.config_from_args(cli_args)
                cfg = dataclasses.replace(
                    cfg,
                    model=dataclasses.replace(
                        cfg.model, leaky_slope=slope, use_batch_norm=bn,
                        width_multiplier=args.width_multiplier),
                    sched=dataclasses.replace(
                        cfg.sched, favor_high_score=favor),
                )
                scores = study.train(cfg, device, lambda *_: None)
                if scores.get("preempted"):
                    # A stop inside train_loop: main's handler writes the
                    # partial ranking once and exits 130.
                    raise KeyboardInterrupt
                f1s.append(float(scores["mean_f1"]))
        mean = sum(f1s) / len(f1s)
        combo = {"favor_high_score": favor, "update_type": upd,
                 "leaky_slope": slope, "use_batch_norm": bn,
                 "mean_f1": round(mean, 4), "per_seed": f1s}
        results.append(combo)
        print(json.dumps(combo))


def write(results: list, out_path: str) -> None:
    if not results:
        return
    results.sort(key=lambda r: -r["mean_f1"])
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    best = results[0]
    print(f"\nBEST bracket: favor_high_score={best['favor_high_score']} "
          f"update_type={best['update_type']} "
          f"leaky_slope={best['leaky_slope']} "
          f"use_batch_norm={best['use_batch_norm']} "
          f"meanF1={best['mean_f1']}")
    print(f"full ranking -> {out_path}")


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    device = study.open_device(args.device, "parity_bracket")
    if device is None:
        return 1
    results = []
    try:
        run(args, device, results)
    except KeyboardInterrupt:
        # Ctrl-C during dataset load or between combos must not lose the
        # completed combos' ranking.
        print("interrupted outside train_loop — writing partial ranking")
        write(results, args.out)
        return 130
    write(results, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
