"""Coffee 5-fold cross-county protocol runner (counterpart of
scripts/run_folds.py).

The reference reports fold-averaged metrics for the Brazilian Coffee
dataset; its CLI runs one fold per invocation. This module runs all
folds (training + validate_test each, `dynseg_torch.cli.run_training`)
and aggregates mean +- std of OA / kappa / mean-F1 into
folds_summary.json, with the keys and arithmetic of the reference's.

Usage: python -m dynseg_torch.run_folds --dataset coffee --dataset_path ... \\
           --output_path /out [--folds 5] [any dynseg_torch CLI flag...]

It runs on the card (`--device cuda`, the default) unless the caller asks
for the CPU (`--device cpu`), and exits non-zero where no card is
visible. `--num_devices N` trains each fold on N ranks
(`dynseg_torch.parallel.spawn`), as the command line does. A training run
is reproducible bitwise for a seed, so a rerun writes the same summary.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _write_summary(output_path: str, results: list, folds: int) -> None:
    summary = {
        "folds": results,
        "folds_requested": folds,
        "complete": len(results) == folds,
    }
    if results:
        summary.update({
            "oa_mean": float(np.mean([r["oa"] for r in results])),
            "oa_std": float(np.std([r["oa"] for r in results])),
            "kappa_mean": float(np.mean([r["kappa"] for r in results])),
            "kappa_std": float(np.std([r["kappa"] for r in results])),
            "mean_f1_mean": float(np.mean([r["mean_f1"] for r in results])),
            "mean_f1_std": float(np.std([r["mean_f1"] for r in results])),
        })
    path = os.path.join(output_path, "folds_summary.json")
    with open(path, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    print(f"wrote {path}")


def main(argv=None) -> int:
    # allow_abbrev=False: --fold is a real CLI flag; with abbreviation on,
    # argparse would take it for --folds and the pass-through would break.
    ap = argparse.ArgumentParser(
        prog="run_folds",
        description=__doc__.splitlines()[0],
        epilog="All other flags pass through to the dynseg_torch CLI.",
        allow_abbrev=False,
    )
    ap.add_argument("--folds", type=int, default=5)
    ap.add_argument("--output_path", required=True)
    args, passthrough = ap.parse_known_args(argv)
    if args.folds < 1:
        ap.error("--folds must be >= 1")
    if any(p == "--fold" or p.startswith("--fold=") for p in passthrough):
        # argparse takes the last value: a leftover --fold would override
        # the one set per fold, train the same fold N times and aggregate fake
        # cross-fold statistics.
        ap.error("--fold conflicts with the fold driver (it sets --fold "
                 "per iteration); drop it from the pass-through flags")

    results = []
    try:
        rc = _run_folds(args, passthrough, results)
    except BaseException:
        # A fault raising out of a late fold must not lose the completed
        # folds' aggregation: write the partial summary, then re-raise.
        if results:
            print("run failed — writing partial summary", file=sys.stderr)
            _write_summary(args.output_path, results, args.folds)
        raise
    if rc is not None:  # preempted inside a fold (summary already written)
        return rc
    _write_summary(args.output_path, results, args.folds)
    return 0


def _train_fold(cfg, out: str, fold: int, folds: int, device) -> dict:
    """One fold's run_training, logged into `out` with the fold's kernel
    launches; in a data-parallel group every rank calls it and rank 0's
    logger writes. Returns the scores the summary reads, or the
    preemption record."""
    from dynseg_torch import parallel
    from dynseg_torch.cli import _launch_counts, run_training
    from dynseg_torch.models.blocks import reset_conv_layouts
    from dynseg_torch.models.dilated import reset_assembly
    from dynseg_torch.ops import gather, int8_conv, pool
    from dynseg_torch.utils.logging import MetricLogger

    gather.launches = 0
    pool.reset_launches()
    int8_conv.reset_launches()
    reset_assembly()
    reset_conv_layouts()
    logger = MetricLogger(out)
    logger.log(f"=== fold {fold}/{folds} ===")
    scores = run_training(cfg, log=logger,
                          device=parallel.world().device if parallel.grouped() else device)
    logger.log(f"fold {fold} {_launch_counts()}")
    logger.close()
    keys = ("preempted", "iteration") if scores.get("preempted") else (
        "oa", "kappa", "mean_f1", "f1")
    return {k: scores[k] for k in keys}


def _run_folds(args, passthrough, results):
    from dynseg_torch import parallel
    from dynseg_torch.cli import build_argparser, config_from_args
    from dynseg_torch.train import resolve_device

    for fold in range(args.folds):
        out = os.path.join(args.output_path, f"fold{fold}")
        cli_args = build_argparser().parse_args(
            ["--operation", "training", "--output_path", out,
             "--fold", str(fold)] + passthrough
        )
        cfg = config_from_args(cli_args)
        n = cli_args.num_devices
        if n > 1:
            try:
                devices = parallel.check_devices(n, cli_args.device)
            except ValueError as e:
                raise SystemExit(f"run_folds: {e}") from None
            threads = max(1, (os.cpu_count() or 1) // n) if devices[0] == "cpu" else None
            # By its module's name: under `python -m` this module is
            # __main__, which the ranks do not import by that name.
            from dynseg_torch.run_folds import _train_fold as fold_fn

            scores = parallel.spawn(fold_fn, n, devices, threads=threads,
                                    args=(cfg, out, fold, args.folds, None))[0]
        else:
            try:
                device = resolve_device(cli_args.device)
            except (RuntimeError, ValueError) as e:
                raise SystemExit(f"run_folds: {e}") from None
            scores = _train_fold(cfg, out, fold, args.folds, device)
        if scores.get("preempted"):
            # SIGTERM/SIGINT inside train_loop returns (a checkpoint at the
            # exact iteration is written): write what finished, then stop.
            print(f"fold {fold} preempted at iteration "
                  f"{scores.get('iteration')} — writing partial summary",
                  file=sys.stderr)
            _write_summary(args.output_path, results, args.folds)
            return 1
        results.append(
            {"fold": fold, "oa": scores["oa"], "kappa": scores["kappa"],
             "mean_f1": scores["mean_f1"],
             "f1": list(map(float, scores["f1"]))}
        )
    return None


if __name__ == "__main__":
    sys.exit(main())
