"""The clean-horizon collapse study of the port (counterpart of
scripts/diagnose_collapse.py).

On 3000-iteration clean-label texture runs, stochastic schedules lost to
cycling in the JAX package's runs, with the same low-OA "collapse" seeds
for the iid multinomial and the stratified control. For named
(distribution, seed) cells this:

1. trains with per-iteration TRAIN trajectories (loss/acc/scale and the
   scheduler's per-scale scores every log_every) and periodic VALIDATION
   trajectories (crop loss/acc/kappa/meanF1 every --eval_every), parsed
   from the training log;
2. trains with keep_best and scores the same run twice: the final
   checkpoint, and the best-validation one;
3. takes hypothesis knobs (--learning_rate, --lr_decay_rate/steps,
   --no_batch_norm, --bn_momentum, --batch_size, --compute_dtype), one
   mechanism hypothesis per invocation;
4. with --ema_decay > 0 trains with the params EMA and reports three
   scores of the same run: raw final iterate, EMA iterate (recalibrated
   BatchNorm statistics) and the best-validation checkpoint.

    python -m dynseg_torch.probes.diagnose_collapse \\
        --runs multinomial:0,multinomial:4,multinomial_stratified:4 \\
        [--out docs/torch_collapse_diag.json] [--device cuda]

The script's flags, defaults, printed lines and JSON schema, but for
--device (default cuda; with no card it exits 1 before any work; cpu for
the tests) in place of --platform, and two defaults: --out, which keeps
the JAX package's committed docs/collapse_diag.json as it is, and
--workdir (torch_collapse_diag under the temporary directory that
$TMPDIR names, so two checkouts' runs keep their own cells, and apart
from the script's /tmp/collapse_diag). Under each run it prints the lines
of `dynseg_torch.probes.study`. --keep_checkpoints leaves each cell's
output directory (port checkpoints, for ema_recalib_probe).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import shutil
import sys
import tempfile
import time
from typing import List, Optional

from dynseg_torch import cli
from dynseg_torch.probes import study

# The port's log lines: train.train_loop's "iter" line, run_training's
# "[val @ iter]" line, the scheduler summary at the end of each "iter"
# line ("25:p=0.19,s=0.915 ...") and run_testing's restore line.
VAL_RE = re.compile(
    r"\[val @ iter (\d+)\] loss=([\d.]+) acc=([\d.]+) "
    r"kappa=([-\d.]+) meanF1=([\d.]+)")
ITER_RE = re.compile(
    r"iter (\d+)/\d+ scale=(\d+) loss=([\d.]+) acc=([\d.]+)")
SCORE_RE = re.compile(r"(\d+):p=([\d.]+),s=([-\d.]+|-)")
BEST_RE = re.compile(r"restored best checkpoint at iteration (\d+)")


def build_cli(args, distribution, seed, outdir, operation):
    argv = [
        "--operation", operation,
        "--dataset", args.dataset,
        "--dataset_path", args.dataset_path,
        "--dataset_kwargs", args.dataset_kwargs,
        "--output_path", outdir,
        "--net_type", args.net_type,
        "--distribution_type", distribution,
        "--values", args.values,
        "--update_type", args.update_type,
        "--niter", str(args.niter),
        "--batch_size", str(args.batch_size),
        "--learning_rate", str(args.learning_rate),
        "--lr_decay_rate", str(args.lr_decay_rate),
        "--lr_decay_steps", str(args.lr_decay_steps),
        "--seed", str(seed),
        "--eval_every", str(args.eval_every),
        "--checkpoint_every", str(10 * args.niter),
        "--window_batch", str(args.window_batch),
        "--no_prediction_maps",
    ]
    if args.no_batch_norm:
        argv += ["--use_batch_norm", "false"]
    if args.bn_momentum != 0.9:
        argv += ["--bn_momentum", str(args.bn_momentum)]
    if args.compute_dtype:
        argv += ["--compute_dtype", args.compute_dtype]
    if args.ema_decay > 0:
        argv += ["--ema_decay", str(args.ema_decay)]
    if operation == "training":
        argv += ["--keep_best"]
    return cli.build_argparser().parse_args(argv)


def run_cell(args, distribution, seed, *, device):
    outdir = os.path.join(args.workdir, f"{distribution}_s{seed}")
    shutil.rmtree(outdir, ignore_errors=True)
    os.makedirs(outdir, exist_ok=True)

    logs = []

    def log(*msg):
        logs.append(" ".join(str(m) for m in msg))

    cfg = cli.config_from_args(build_cli(args, distribution, seed, outdir,
                                         "training"))
    if args.width_multiplier != 1.0:  # CPU pilots and smoke runs
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, width_multiplier=args.width_multiplier))
    t0 = time.time()
    final = study.train(cfg, device, log, keep_best=True)
    if final.get("preempted"):
        raise KeyboardInterrupt
    wall = time.time() - t0

    val_traj = [
        {"iter": int(m[0]), "loss": float(m[1]), "acc": float(m[2]),
         "kappa": float(m[3]), "mean_f1": float(m[4])}
        for ln in logs for m in VAL_RE.findall(ln)
    ]
    train_traj = []
    for ln in logs:
        for m in ITER_RE.findall(ln):
            row = {"iter": int(m[0]), "scale": int(m[1]),
                   "loss": float(m[2]), "acc": float(m[3])}
            scores = {int(v): (None if s == "-" else float(s))
                      for v, _p, s in SCORE_RE.findall(ln)}
            if scores:  # per-scale score table at this iteration
                row["scores"] = scores
            train_traj.append(row)

    # A second full-tile score of the same run at the best-validation
    # checkpoint (run_training's final validate_test used the last one).
    best_logs = []
    cfg_t = cli.config_from_args(build_cli(args, distribution, seed, outdir,
                                           "testing"))
    # With EMA on, best is the raw iterate at the best-validation step
    # (keep_best scores raw); the EMA arm serves the recalibrated sidecar
    # statistics.
    best_use_ema = False if args.ema_decay > 0 else None
    if args.width_multiplier != 1.0:
        cfg_t = dataclasses.replace(cfg_t, model=dataclasses.replace(
            cfg_t.model, width_multiplier=args.width_multiplier))
    best = cli.run_testing(cfg_t, log=lambda *m: best_logs.append(
        " ".join(str(x) for x in m)), use_best=True, use_ema=best_use_ema,
        device=device)
    best_iter = next(
        (int(m.group(1)) for ln in best_logs for m in [BEST_RE.search(ln)]
         if m), None)

    ema = None
    if args.ema_decay > 0:
        # With EMA on, run_training's final score (and the best one above)
        # already used the EMA weights: the raw final iterate needs its own
        # pass for the three-way comparison.
        ema = final
        final = cli.run_testing(cfg_t, log=lambda *m: None, use_ema=False,
                                device=device)

    if not args.keep_checkpoints:
        shutil.rmtree(outdir, ignore_errors=True)
    return {
        "distribution": distribution,
        "seed": seed,
        "final_oa": float(final["oa"]),
        "final_mean_f1": float(final["mean_f1"]),
        "best_oa": float(best["oa"]),
        "best_mean_f1": float(best["mean_f1"]),
        "best_iter": best_iter,
        **({"ema_oa": float(ema["oa"]),
            "ema_mean_f1": float(ema["mean_f1"])} if ema else {}),
        "wall_s": round(wall, 1),
        "val_trajectory": val_traj,
        "train_trajectory": train_traj,
        "final_distribution": next(
            (ln for ln in logs if "final scale distribution" in ln), ""),
    }


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """The flags; a --runs cell that is not distribution:seed is refused
    (exit 2)."""
    ap = argparse.ArgumentParser(prog="python -m dynseg_torch.probes.diagnose_collapse",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--runs", required=True,
                    help="comma list of distribution:seed cells, e.g. "
                         "multinomial:0,multi_fixed:0")
    ap.add_argument("--dataset", default="synthetic_texture")
    ap.add_argument("--dataset_path", default="")
    ap.add_argument("--dataset_kwargs", default='{"label_noise": 0.0}')
    ap.add_argument("--values", default="25,35,45,55,65")
    ap.add_argument("--niter", type=int, default=3000)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--learning_rate", type=float, default=0.01)
    ap.add_argument("--lr_decay_rate", type=float, default=1.0)
    ap.add_argument("--lr_decay_steps", type=int, default=50000)
    ap.add_argument("--no_batch_norm", action="store_true")
    ap.add_argument("--compute_dtype", default="",
                    help="train in this activation dtype (bfloat16 = the "
                         "mixed-precision-training evaluation; empty = the "
                         "CLI default f32)")
    ap.add_argument("--bn_momentum", type=float, default=0.9,
                    help="hypothesis knob: the oscillation is BN-coupled: "
                         "does a slower statistics track (0.99) damp it at "
                         "the source?")
    ap.add_argument("--ema_decay", type=float, default=0.0,
                    help=">0 trains with the params-EMA tracker and adds "
                         "a third eval (EMA iterate) per cell")
    ap.add_argument("--update_type", default="acc")
    ap.add_argument("--net_type", default="dilated_icpr_rate6")
    ap.add_argument("--width_multiplier", type=float, default=1.0,
                    help="narrow the model for CPU pilots/smoke runs "
                         "(sidecar records it, so the eval passes match)")
    ap.add_argument("--eval_every", type=int, default=100)
    ap.add_argument("--window_batch", type=int, default=256)
    ap.add_argument("--workdir",
                    default=os.path.join(tempfile.gettempdir(), "torch_collapse_diag"))
    ap.add_argument("--keep_checkpoints", action="store_true")
    ap.add_argument("--tag", default="",
                    help="free-form label recorded in the payload (name "
                         "the hypothesis this invocation tests)")
    ap.add_argument("--out", default="docs/torch_collapse_diag.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits non-zero without a card) or cpu")
    args = ap.parse_args(argv)
    args.cells = []
    for tok in args.runs.split(","):
        dist, _, seed = tok.strip().partition(":")
        if not seed.lstrip("-").isdigit():
            ap.error(f"bad --runs cell {tok!r} (want distribution:seed)")
        args.cells.append((dist, int(seed)))
    return args


def run(args: argparse.Namespace, device) -> dict:
    """Every cell of args.cells on `device`; args.out is rewritten after
    each cell (partial: true) and at the end (partial: false). Returns the
    payload; a failing cell writes the completed ones and re-raises."""
    results = []
    payload = {
        "tag": args.tag,
        "dataset": args.dataset,
        "dataset_kwargs": args.dataset_kwargs,
        "niter": args.niter,
        "batch_size": args.batch_size,
        "learning_rate": args.learning_rate,
        "lr_decay_rate": args.lr_decay_rate,
        "lr_decay_steps": args.lr_decay_steps,
        "no_batch_norm": args.no_batch_norm,
        "bn_momentum": args.bn_momentum,
        "compute_dtype": args.compute_dtype or "float32",
        "ema_decay": args.ema_decay,
        "width_multiplier": args.width_multiplier,
        "eval_every": args.eval_every,
        "results": results,
    }

    def write(partial):
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        payload["partial"] = partial
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=2)

    try:
        for dist, seed in args.cells:
            print(f"[{dist} seed={seed}] ...", flush=True)
            r = run_cell(args, dist, seed, device=device)
            extra = (f" ema OA={r['ema_oa']:.4f}" if "ema_oa" in r else "")
            print(f"[{dist} seed={seed}] final OA={r['final_oa']:.4f}"
                  f"{extra} best OA={r['best_oa']:.4f} "
                  f"(best_iter={r['best_iter']}, {r['wall_s']}s)", flush=True)
            results.append(r)
            write(partial=True)
    except BaseException:
        # A device fault mid-sweep: keep the completed cells (each a full
        # training run).
        print("run failed — writing partial results", file=sys.stderr)
        if results:
            write(partial=True)
        raise
    write(partial=False)
    print(f"wrote {args.out} ({len(results)} cells)")
    return payload


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    device = study.open_device(args.device, "diagnose_collapse")
    if device is None:
        return 1
    run(args, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
