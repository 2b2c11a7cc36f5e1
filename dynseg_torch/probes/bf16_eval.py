"""bfloat16 inference accuracy of the port, end to end (counterpart of
scripts/bf16_eval.py).

What does bf16 compute (params stay f32, `ModelConfig.compute_dtype`)
cost in accuracy on the context-sensitive texture benchmark, per seed,
in window voting and in dense mode, and how long does each evaluation
take? Each seed trains once in f32 (the training dtype is not under
test), then the same checkpoint is restored and scored with f32 and with
bf16 compute.

    python -m dynseg_torch.probes.bf16_eval [--seeds 3] [--niter 1000]
        [--out docs/torch_bf16_eval.json] [--device cuda]

The script's flags, defaults, printed lines and JSON schema, but for
--device (default cuda; with no card it exits 1 before any work; cpu for
the tests) in place of --platform, and --out's default, which keeps the
JAX package's committed docs/bf16_eval.json as it is. Under each
training run it prints the lines of `dynseg_torch.probes.study`. Each
evaluation's wall_s is the whole run_testing call (restore included), as
the script's is.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from typing import List, Optional

from dynseg_torch import cli
from dynseg_torch.probes import study


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m dynseg_torch.probes.bf16_eval",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--niter", type=int, default=1000)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--values", default="25,35,45,55,65")
    ap.add_argument("--dense_block", type=int, default=512)
    ap.add_argument("--out", default="docs/torch_bf16_eval.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits non-zero without a card) or cpu")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, device) -> dict:
    """args.seeds f32 trainings on `device`, each scored four ways; writes
    args.out and returns its payload."""
    results = []
    for seed in range(args.seeds):
        with tempfile.TemporaryDirectory() as tmp:
            base = [
                "--operation", "training",
                "--dataset", "synthetic_texture",
                "--output_path", tmp,
                "--net_type", "dilated_icpr_rate6",
                "--distribution_type", "multinomial",
                "--values", args.values,
                "--niter", str(args.niter),
                "--batch_size", str(args.batch_size),
                "--seed", str(seed),
                "--eval_every", str(10 * args.niter),
                "--checkpoint_every", str(10 * args.niter),
                "--window_batch", "256",
                "--no_prediction_maps",
            ]
            cli_args = cli.build_argparser().parse_args(base)
            study.train(cli.config_from_args(cli_args), device, lambda *a: None)

            row = {"seed": seed}
            for mode in ("window", "dense"):
                for dtype in ("float32", "bfloat16"):
                    cli_args = cli.build_argparser().parse_args(base + [
                        "--compute_dtype", dtype,
                        "--inference_mode", mode,
                        "--dense_block", str(args.dense_block),
                    ])
                    cfg = cli.config_from_args(cli_args)
                    t0 = time.time()
                    scores = cli.run_testing(cfg, log=lambda *a: None, device=device)
                    key = f"{mode}_" + (
                        "f32" if dtype == "float32" else "bf16")
                    row[key] = {
                        "oa": round(float(scores["oa"]), 4),
                        "mean_f1": round(float(scores["mean_f1"]), 4),
                        "wall_s": round(time.time() - t0, 1),
                    }
                    print(f"[seed {seed}] {mode}/{dtype}: "
                          f"OA={row[key]['oa']:.4f} "
                          f"({row[key]['wall_s']}s)", flush=True)
            results.append(row)

    def agg(key, field):
        vals = [r[key][field] for r in results]
        return round(sum(vals) / len(vals), 4)

    summary = {
        "window_oa_f32": agg("window_f32", "oa"),
        "window_oa_bf16": agg("window_bf16", "oa"),
        "dense_oa_f32": agg("dense_f32", "oa"),
        "dense_oa_bf16": agg("dense_bf16", "oa"),
        "per_seed": results,
        "protocol": {
            "train": "f32 multinomial, texture benchmark",
            "niter": args.niter, "batch_size": args.batch_size,
            "values": args.values, "dense_block": args.dense_block,
        },
    }
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items()
                      if k not in ("per_seed", "protocol")}))
    print(f"wrote {args.out}")
    return summary


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    device = study.open_device(args.device, "bf16_eval")
    if device is None:
        return 1
    run(args, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
