"""Post-hoc BatchNorm recalibration for the EMA weights, on the port
(counterpart of scripts/ema_recalib_probe.py).

The EMA params are scored against the LIVE BatchNorm running statistics,
which track the raw oscillating iterate the EMA never follows. From a
kept checkpoint (a `dynseg_torch.probes.diagnose_collapse
--keep_checkpoints` cell), this

  1. restores the trained state and takes the EMA params
     (`train.ema_variables`),
  2. recalibrates BatchNorm statistics FOR the EMA params with N
     train-mode forwards (params frozen) over freshly sampled balanced
     training batches, the scales cycling through the trained list, each
     batch from `Trainer.make_batch_inputs` through K2, and
  3. scores three weight sets on the test tiles: raw final iterate, EMA +
     live statistics, EMA + recalibrated statistics at each N.

The recalibration is the script's `recal_step`: progressive over the
sorted N (the statistics after N=25 are the start for N=50, through
`Trainer.recalibrate_batch_stats` of the N - 25 further forwards), and
the scale of forward i is scales[i % len(scales)] counted over the whole
probe. The script draws every dropout mask from one fixed key, the port
from a stream seeded once a call: dropout sits after the last BatchNorm,
so no mask moves a statistic.

    python -m dynseg_torch.probes.ema_recalib_probe \\
        --ckpt "${TMPDIR:-/tmp}/torch_collapse_diag/multinomial_s4" --seed 4 \\
        [--out docs/torch_ema_recalib_probe.json] [--device cuda]

The script's flags, defaults, printed lines and JSON schema, but for
--device (default cuda; with no card it exits 1 before any work; cpu for
the tests) in place of --platform, and --out's default, which keeps the
JAX package's committed docs/ema_recalib_probe.json as it is. After the
recalibration it prints K2's launches against its gathers, K2 against its
plain version on one batch of each bucket, and the device's peak memory
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional

import torch

from dynseg_torch import cli
from dynseg_torch.checkpoint import CheckpointManager
from dynseg_torch.data.datasets import load_dataset
from dynseg_torch.infer import validate_test
from dynseg_torch.ops import gather
from dynseg_torch.probes import study
from dynseg_torch.probes.stress_scale import where
from dynseg_torch.sched.scheduler import ScaleScheduler
from dynseg_torch.train import Trainer, ema_variables


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m dynseg_torch.probes.ema_recalib_probe",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True,
                    help="output dir of a kept diagnose_collapse cell")
    ap.add_argument("--seed", type=int, required=True,
                    help="the cell's training seed (drives the synthetic "
                         "generator too)")
    ap.add_argument("--dataset", default="synthetic_texture")
    ap.add_argument("--dataset_kwargs", default='{"label_noise": 0.0}')
    ap.add_argument("--values", default="25,35,45,55,65")
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--recalib_batches", default="25,50,100,200",
                    help="comma list of N to evaluate at")
    ap.add_argument("--window_batch", type=int, default=256)
    ap.add_argument("--out", default="docs/torch_ema_recalib_probe.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits non-zero without a card) or cpu")
    return ap.parse_args(argv)


def recalibrated(trainer: Trainer, ema: Dict[str, torch.Tensor], targets: List[int]):
    """Yield (N, state_dict) for each N of the sorted `targets`: the EMA
    params with BatchNorm statistics refreshed by N train-mode forwards
    in all, progressively (see the module docstring)."""
    variables, n_done = ema, 0
    for n in targets:
        variables = trainer.recalibrate_batch_stats(variables, n - n_done, start=n_done)
        n_done = n
        yield n, variables


def run(args: argparse.Namespace, device) -> dict:
    """The probe on `device`; writes args.out and returns its results."""
    cli_args = cli.build_argparser().parse_args([
        "--operation", "testing", "--dataset", args.dataset,
        "--dataset_kwargs", args.dataset_kwargs, "--output_path", args.ckpt,
        "--values", args.values, "--batch_size", str(args.batch_size),
        "--seed", str(args.seed), "--window_batch", str(args.window_batch),
        "--no_prediction_maps",
    ])
    cfg = cli.config_from_args(cli_args)

    ckpt = CheckpointManager(args.ckpt)
    stats = ckpt.load_stats()
    if stats is None or float(stats.get("ema_decay", 0.0)) <= 0.0:
        raise SystemExit(f"{args.ckpt} is not an EMA checkpoint with sidecar")
    # The checkpoint's full model config (width, BN, slope, ... and
    # ema_decay): the restore template must match it.
    cfg = cli._adopt_checkpoint_model(cfg, stats)

    train_tiles, test_tiles = load_dataset(
        cfg.data.dataset, cfg.data.dataset_path, cfg.data.fold,
        seed=cfg.train.seed,
        **{k: tuple(v) if isinstance(v, list) else v
           for k, v in json.loads(cfg.data.dataset_kwargs or "{}").items()})

    trainer = Trainer(cfg, train_tiles, device)
    sched = ScaleScheduler(cfg.sched, seed=cfg.train.seed)
    state, step = ckpt.restore(trainer, sched)
    ema = ema_variables(cfg, state)
    print(f"restored step {step}; ema_decay={cfg.train.ema_decay}")

    def evaluate(tag, variables):
        s = validate_test(cfg, variables, test_tiles, device, log=lambda *_: None)
        row = {"oa": round(float(s["oa"]), 4),
               "mean_f1": round(float(s["mean_f1"]), 4)}
        print(f"{tag}: {row}")
        return row

    results = {
        "ckpt": args.ckpt, "step": int(step), "seed": args.seed,
        "ema_decay": cfg.train.ema_decay,
        "raw_final": evaluate("raw final", state.model.state_dict()),
        "ema_live_bn": evaluate("EMA + live BN", ema),
        "ema_recalibrated": {},
    }

    targets = sorted(int(n) for n in args.recalib_batches.split(","))
    gather.launches = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for n, variables in recalibrated(trainer, ema, targets):
        results["ema_recalibrated"][str(n)] = evaluate(
            f"EMA + recalibrated BN (N={n})", variables)
    name = study.card_of(device)
    print(f"    K2 launches: {gather.launches} (gathers {max(targets)}: "
          f"{max(targets)} recalibration forwards; 0 on the CPU, where the "
          f"plain version runs)", flush=True)
    study.print_gather_check(trainer)
    print(f"    [{where(device, name)}]", flush=True)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {args.out}")
    return results


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    device = study.open_device(args.device, "ema_recalib_probe")
    if device is None:
        return 1
    run(args, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
