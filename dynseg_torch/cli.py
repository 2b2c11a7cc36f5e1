"""Entry points of the port (counterpart of dynseg/cli.py).

    python -m dynseg_torch --operation training|testing|validate_test|
        predict|export|serve|info|check_data --device cuda|cpu
        [the flags of dynseg]

The flags are the reference's (`build_argparser`, held equal to
`dynseg.cli.build_argparser` by tests/test_torch_cli.py) plus `--device`,
the port's form of JAX's backend choice: default `cuda`, and where no card
is visible the run stops with a message instead of falling back to the CPU.

  * training: train, checkpoint every --checkpoint_every iterations and on
    SIGTERM/SIGINT, keep the best-validation checkpoint (--keep_best),
    resume (--resume) with the reference's guards, recalibrate the EMA
    weights' BatchNorm statistics, then score the test tiles;
  * testing / validate_test: restore (--use_best, --use_ema) and score
    the test tiles (--scales_from_scheduler fuses the top-K scales);
  * predict: label maps of unlabeled rasters (--predict_path,
    --predict_chunk) from the checkpoint and its stats sidecar alone;
  * export: the checkpoint as a `torch.export` serving artifact under
    <output_path>/export (dynseg_torch/export.py), float in bfloat16 by
    default or int8 (--quant int8, calibrated on the test tiles);
  * serve: the HTTP server over that artifact (dynseg_torch/serve.py);
  * info: the checkpoint's model card; check_data: the dataset pre-flight.

--tta fuses the 8 dihedral transforms of each tile in either mode;
--compute_dtype bfloat16 runs the nets' activations in bfloat16 for
training, testing and predict, float or int8; --hbm_budget_gb (GiB) keeps
a larger test set on the host and uploads one tile a prediction.

--num_devices N (N > 1) runs training (its final scoring included) and
testing/validate_test data-parallel, as the reference runs them on its
mesh: the command spawns N ranks (`dynseg_torch.parallel`), rank r on
cuda:r over NCCL, or N CPU ranks over gloo under --device cpu; more ranks
than visible cards exit non-zero before any rank starts. --shard_tiles
splits the training tiles across the ranks. The other operations run on
one device, as the reference's do. Rank 0 alone logs and writes.

Knobs of the reference's XLA programs
that change no result have no effect here: --scan_chunk,
--dense_scan_chunk, --quant_conv (the int8 blocks always run K5).
--window_fold off is accepted: the port's one window accumulator gives
the legacy counts.

`dynseg/cli.py` imports jax at the top, so its jax-free helpers are
copies here, each held equal to its original by the tests.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import List, NamedTuple, Optional

import numpy as np

from dynseg_torch import config as cfgmod
from dynseg_torch.config import (Config, DataConfig, InferConfig,
                                 ModelConfig, SchedulerConfig, TrainConfig)
from dynseg_torch.data.datasets import NUM_CLASSES, load_dataset


def parse_values(s) -> List[int]:
    if isinstance(s, (list, tuple)):
        return [int(v) for v in s]
    try:
        return [int(v) for v in str(s).replace(" ", "").split(",") if v]
    except ValueError:
        raise ValueError(
            f"--values must be comma-separated patch sizes (e.g. "
            f"'25,35,45,55,65'), got {s!r}"
        ) from None


def build_argparser() -> argparse.ArgumentParser:
    """The reference's parser (same dests, defaults, choices and types),
    with prog "dynseg_torch" and --device."""
    from dynseg_torch import __version__

    p = argparse.ArgumentParser(
        prog="dynseg_torch",
        description="dynamic multi-context remote-sensing segmentation, "
                    "the PyTorch/CUDA port")
    p.add_argument("--version", action="version",
                   version=f"dynseg_torch {__version__}")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on: cuda (default; stops with "
                        "a message where no card is visible) or cpu")
    p.add_argument("--operation", required=True,
                   choices=["training", "testing", "validate_test", "predict",
                            "export", "serve", "info", "check_data"],
                   help="training; testing/validate_test (synonyms): "
                        "full-tile prediction with metrics; predict: "
                        "unlabeled rasters (--predict_path); info: the "
                        "checkpoint's model card; export: a torch.export "
                        "serving artifact under <output_path>/export "
                        "(dynseg_torch/export.py); serve: the HTTP server "
                        "over it (dynseg_torch/serve.py); check_data: "
                        "validate a dataset dump")
    p.add_argument("--predict_path", default="",
                   help="file or directory of rasters for --operation predict")
    p.add_argument("--predict_chunk", type=int, default=0,
                   help="rasters loaded/predicted at a time (0 = all); "
                        "chunk shapes bucket to 512-px multiples")
    p.add_argument("--dataset", default="synthetic", choices=cfgmod.DATASETS)
    p.add_argument("--dataset_path", default="")
    p.add_argument("--output_path", default="/tmp/dynseg_out")
    p.add_argument("--net_type", default="dilated_icpr_rate6", choices=cfgmod.NET_TYPES)
    p.add_argument("--learning_rate", type=float, default=0.01)
    p.add_argument("--weight_decay", type=float, default=5e-4)
    p.add_argument("--batch_size", type=int, default=100)
    p.add_argument("--niter", type=int, default=200000)
    p.add_argument("--distribution_type", default="multinomial",
                   choices=cfgmod.DISTRIBUTION_TYPES)
    p.add_argument("--values", default="25,35,45,55,65",
                   help="comma-separated patch sizes (dynamic scales)")
    p.add_argument("--update_type", default="acc", choices=cfgmod.UPDATE_TYPES,
                   help="scheduler score source: batch acc or loss")
    p.add_argument("--sched_temperature", type=float, default=1.0,
                   help="multinomial sharpening: fitness**(1/T)")
    p.add_argument("--sched_ema", type=float, default=0.9,
                   help="EMA factor for per-scale score updates")
    p.add_argument("--sched_favor", default="high", choices=["high", "low"],
                   help="multinomial sign convention: 'high' exploits "
                        "well-performing contexts, 'low' trains struggling "
                        "ones harder")
    p.add_argument("--fold", type=int, default=0)
    p.add_argument("--val_tiles", default="",
                   help="ISPRS named validation split: comma-separated "
                        "tile ids. Empty = published default split")
    p.add_argument("--bands", default="", choices=["", "rgb", "irrg", "rgbir"],
                   help="Potsdam image source directory (default rgb)")
    p.add_argument("--extra_bands", default="",
                   help="extra channels appended to the imagery: 'dsm', "
                        "'ndsm' or 'dsm,ndsm'")
    p.add_argument("--dataset_kwargs", default="",
                   help="JSON dict of extra loader kwargs")
    p.add_argument("--leaky_slope", type=float, default=0.1,
                   help="negative slope of the leaky-ReLU inside conv blocks")
    p.add_argument("--bn_momentum", type=float, default=0.9,
                   help="BatchNorm running-statistics momentum")
    p.add_argument("--use_batch_norm", default="true",
                   choices=["true", "false"],
                   help="batch-norm inside each conv block")
    p.add_argument("--compute_dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="activation compute dtype (params stay float32); "
                        "default float32, bfloat16 for export")
    p.add_argument("--pool_backward", default="xla", choices=["xla", "pallas"],
                   help="stride-1 max-pool backward: autograd's (xla) or "
                        "the tie-split kernel K4 (pallas)")
    p.add_argument("--quant_conv", default="xla",
                   choices=["xla", "auto", "pallas"],
                   help="no effect in the port: --quant int8 blocks always "
                        "run the K5 kernel")
    p.add_argument("--eval_every", type=int, default=500,
                   help="validation interval in iterations (0 disables)")
    p.add_argument("--checkpoint_every", type=int, default=1000,
                   help="periodic-checkpoint interval (0 disables; the "
                        "final and preemption checkpoints still write)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_devices", type=int, default=1,
                   help="data-parallel ranks for training and testing: rank r "
                        "on cuda:r (NCCL), or CPU ranks (gloo) under --device "
                        "cpu")
    p.add_argument("--shard_tiles", action="store_true",
                   help="shard training tiles across the ranks instead of "
                        "replicating them")
    p.add_argument("--steps_per_call", type=int, default=1,
                   help="optimizer steps per train_step call")
    p.add_argument("--metric_fetch_depth", type=int, default=1,
                   help="scheduler-metric fetches trail this many steps")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--keep_best", dest="keep_best", action="store_true",
                   default=True,
                   help="also keep the checkpoint with the best validation "
                        "mean-F1 under checkpoints/best/ (default on)")
    p.add_argument("--no_keep_best", dest="keep_best", action="store_false",
                   help="disable best-validation checkpoint tracking")
    p.add_argument("--use_best", action="store_true",
                   help="at testing/predict/export/info, restore the "
                        "best-validation checkpoint instead of the latest")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="per-step exponential moving average of the params "
                        "(0 = off). At testing/predict the checkpoint's "
                        "recorded value is authoritative")
    p.add_argument("--ema_recalib_batches", type=int, default=50,
                   help="BatchNorm-recalibration batches for the EMA "
                        "weights at the end of training (0 disables)")
    p.add_argument("--use_ema", dest="use_ema", action="store_true",
                   default=None,
                   help="evaluate the EMA weights instead of the raw "
                        "iterate. Default: auto, EMA whenever the "
                        "checkpoint has them, except under --use_best")
    p.add_argument("--no_use_ema", dest="use_ema", action="store_false",
                   help="force the raw iterate even when the checkpoint "
                        "carries EMA weights")
    p.add_argument("--no_augment", action="store_true")
    p.add_argument("--no_balanced_sampling", action="store_true")
    p.add_argument("--max_positions_per_class", type=int, default=0,
                   help="cap per-class patch-center tables (0 = all pixels)")
    p.add_argument("--rescale_batch_by_area", action="store_true")
    p.add_argument("--stride_fraction", type=float, default=0.5)
    p.add_argument("--window_batch", type=int, default=128)
    p.add_argument("--test_scales", default="",
                   help="scales fused at inference (default: training values)")
    p.add_argument("--scales_from_scheduler", type=int, default=0,
                   help="at testing/predict, fuse only the top-K scales of "
                        "the restored scheduler distribution")
    p.add_argument("--no_prediction_maps", action="store_true")
    p.add_argument("--error_maps", action="store_true",
                   help="also write per-tile green/red correctness PNGs")
    p.add_argument("--inference_mode", default="window",
                   choices=["window", "dense"],
                   help="window = multi-scale voting; dense = blockwise "
                        "whole-tile forward")
    p.add_argument("--dense_block", type=int, default=None,
                   help="dense-mode block size (default 256; --operation "
                        "serve defaults to its own 1024 unless this is set)")
    p.add_argument("--dense_halo", type=int, default=40)
    p.add_argument("--dense_block_batch", type=int, default=0,
                   help="dense blocks per forward; 0 = auto (8)")
    p.add_argument("--scan_chunk", type=int, default=8,
                   help="no effect in the port (a knob of the reference's "
                        "scanned window programs)")
    p.add_argument("--window_fold", default="auto",
                   choices=["auto", "on", "off"],
                   help="the port's window accumulator is the fold; off is "
                        "accepted and gives the same counts")
    p.add_argument("--dense_scan_chunk", type=int, default=4,
                   help="no effect in the port")
    p.add_argument("--hbm_budget_gb", type=float, default=10.0,
                   help="device budget (GiB) for the packed test tiles; "
                        "past it they stay on the host and each prediction "
                        "uploads one tile")
    p.add_argument("--eval_eroded_boundaries", type=int, default=0,
                   help="also report metrics with class boundaries eroded "
                        "by this radius")
    p.add_argument("--tta", action="store_true",
                   help="test-time augmentation: average the softmax maps "
                        "of the 8 dihedral transforms (8x the compute)")
    p.add_argument("--quant", default="none", choices=["none", "int8"],
                   help="post-training int8 serving path at "
                        "testing/predict/export")
    p.add_argument("--quant_min_ch", type=int, default=128,
                   help="minimum channel count (both operands) for a "
                        "block to be quantized")
    p.add_argument("--quant_calib_pct", type=float, default=99.9,
                   help="activation-scale calibration percentile of |input|")
    p.add_argument("--quant_calib_crops", type=int, default=8,
                   help="number of 128px sample crops used to calibrate")
    p.add_argument("--quant_exit", action="store_true",
                   help="with --quant int8: also run the final block's "
                        "pool and the head input in int8")
    p.add_argument("--export_platforms", default="tpu,cpu",
                   help="--operation export writes one program that loads on "
                        "any torch device; it is loaded and checked against "
                        "the live net on each torch device of this list "
                        "(other names, such as tpu, are skipped), and the "
                        "manifest's platforms lists those checked")
    p.add_argument("--serve_host", default="127.0.0.1")
    p.add_argument("--serve_port", type=int, default=8400)
    p.add_argument("--max_request_mb", type=int, default=512,
                   help="serve: reject request bodies above this (413)")
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--profile_dir", default="",
                   help="write a torch.profiler chrome trace of the run here")
    p.add_argument("--lr_decay_rate", type=float, default=1.0)
    p.add_argument("--lr_decay_steps", type=int, default=50000)
    return p


def _default_compute_dtype(args: argparse.Namespace) -> str:
    """bf16 is the reference's default for exported artifacts only; every
    other operation computes in float32."""
    if args.compute_dtype is not None:
        return args.compute_dtype
    if args.operation == "export" and args.quant == "none":
        return "bfloat16"
    return "float32"


def config_from_args(args: argparse.Namespace) -> Config:
    values = parse_values(args.values)
    test_scales = parse_values(args.test_scales) if args.test_scales else values
    cfg = Config(
        model=ModelConfig(
            net_type=args.net_type,
            num_classes=NUM_CLASSES[args.dataset],
            leaky_slope=args.leaky_slope,
            use_batch_norm=(args.use_batch_norm == "true"),
            bn_momentum=args.bn_momentum,
            compute_dtype=_default_compute_dtype(args),
            pool_backward=args.pool_backward,
            quant_conv=args.quant_conv,
        ),
        sched=SchedulerConfig(
            distribution_type=args.distribution_type,
            values=tuple(values),
            update_type=args.update_type,
            temperature=args.sched_temperature,
            ema=args.sched_ema,
            favor_high_score=(args.sched_favor == "high"),
        ),
        train=TrainConfig(
            learning_rate=args.learning_rate,
            lr_decay_rate=args.lr_decay_rate,
            lr_decay_steps=args.lr_decay_steps,
            momentum=args.momentum,
            weight_decay=args.weight_decay,
            batch_size=args.batch_size,
            niter=args.niter,
            rescale_batch_by_area=args.rescale_batch_by_area,
            eval_every=args.eval_every,
            checkpoint_every=args.checkpoint_every,
            steps_per_call=args.steps_per_call,
            shard_tiles=args.shard_tiles,
            metric_fetch_depth=args.metric_fetch_depth,
            seed=args.seed,
            num_devices=args.num_devices,
            output_path=args.output_path,
            resume=args.resume,
            ema_decay=args.ema_decay,
            ema_recalib_batches=args.ema_recalib_batches,
        ),
        infer=InferConfig(
            stride_fraction=args.stride_fraction,
            window_batch=args.window_batch,
            scales=tuple(test_scales),
            scales_explicit=bool(args.test_scales),
            save_prediction_maps=not args.no_prediction_maps,
            save_error_maps=args.error_maps,
            mode=args.inference_mode,
            dense_block=(256 if args.dense_block is None
                         else args.dense_block),
            dense_halo=args.dense_halo,
            dense_block_batch=args.dense_block_batch,
            scan_chunk=args.scan_chunk,
            window_fold=args.window_fold,
            dense_scan_chunk=args.dense_scan_chunk,
            hbm_budget_gb=args.hbm_budget_gb,
            eroded_boundary_radius=args.eval_eroded_boundaries,
            tta=args.tta,
            quant=args.quant,
            quant_min_ch=args.quant_min_ch,
            quant_calib_pct=args.quant_calib_pct,
            quant_calib_crops=args.quant_calib_crops,
            quant_exit=args.quant_exit,
        ),
        data=DataConfig(
            dataset=args.dataset,
            dataset_path=args.dataset_path,
            fold=args.fold,
            balanced_sampling=not args.no_balanced_sampling,
            max_positions_per_class=args.max_positions_per_class,
            augment=not args.no_augment,
            val_tiles=args.val_tiles,
            bands=args.bands,
            extra_bands=args.extra_bands,
            dataset_kwargs=args.dataset_kwargs,
        ),
    )
    return cfg.validate()


def _loader_kwargs(cfg: Config) -> dict:
    """Dataset-specific loader arguments from the config; --dataset_kwargs
    (a JSON object) merges on top, JSON lists become tuples."""
    if cfg.data.dataset.startswith("synthetic"):
        kw = {"seed": cfg.train.seed}
    else:
        kw = {}
        if cfg.data.dataset in ("vaihingen", "potsdam"):
            if cfg.data.val_tiles:
                kw["val_tiles"] = tuple(
                    t.strip() for t in cfg.data.val_tiles.split(",")
                    if t.strip())
            if cfg.data.bands:
                kw["bands"] = cfg.data.bands
            if cfg.data.extra_bands:
                kw["extra_bands"] = tuple(
                    b.strip() for b in cfg.data.extra_bands.split(",")
                    if b.strip())
    if cfg.data.dataset_kwargs:
        try:
            extra = json.loads(cfg.data.dataset_kwargs)
        except json.JSONDecodeError as e:
            raise ValueError(
                f"--dataset_kwargs is not valid JSON: {e}") from e
        if not isinstance(extra, dict):
            raise ValueError("--dataset_kwargs must be a JSON object")
        kw.update({k: tuple(v) if isinstance(v, list) else v
                   for k, v in extra.items()})
    return kw


def _adopt_checkpoint_model(cfg: Config, stats: dict,
                            adopt_net_type: bool = False) -> Config:
    """The exact model config a checkpoint was trained with, from its
    stats sidecar; old sidecars lack the architecture keys, which then
    keep the CLI values. Unless adopt_net_type, a sidecar net_type that
    contradicts the CLI is an error."""
    import dataclasses as dc

    if not adopt_net_type and stats.get("net_type") not in (
            None, cfg.model.net_type):
        raise ValueError(
            f"checkpoint was trained with net_type={stats['net_type']!r}; "
            f"pass --net_type {stats['net_type']}"
        )
    kw = {
        "num_input_bands": int(stats["num_input_bands"]),
        "num_classes": int(stats["num_classes"]),
    }
    if adopt_net_type and stats.get("net_type"):
        kw["net_type"] = stats["net_type"]
    for k in ("width_multiplier", "leaky_slope", "dropout_rate",
              "bn_momentum"):
        if k in stats:
            kw[k] = float(stats[k])
    if "pool_window" in stats:
        kw["pool_window"] = int(stats["pool_window"])
    if "use_batch_norm" in stats:
        kw["use_batch_norm"] = bool(stats["use_batch_norm"])
    cfg = dc.replace(cfg, model=dc.replace(cfg.model, **kw))
    if "ema_decay" in stats:
        # The checkpoint holds EMA weights iff it was trained with
        # ema_decay > 0: the restore template must match.
        cfg = dc.replace(cfg, train=dc.replace(
            cfg.train, ema_decay=float(stats["ema_decay"])))
    if "lr_decay_rate" in stats:
        cfg = dc.replace(cfg, train=dc.replace(
            cfg.train,
            lr_decay_rate=float(stats["lr_decay_rate"]),
            lr_decay_steps=int(stats.get(
                "lr_decay_steps", cfg.train.lr_decay_steps))))
    return cfg


def _reconcile_scales(cfg: Config, scheduler, log) -> Config:
    """A restored scheduler carries the checkpoint's own trained scales;
    default to them unless --test_scales was explicit."""
    if scheduler.semantics_adopted:
        detail = ", ".join(
            f"{k}={c!r} (CLI had {u!r})"
            for k, (c, u) in scheduler.semantics_adopted.items()
        )
        log(f"WARNING: adopting the checkpoint's scheduler semantics — "
            f"{detail}; top-K scale ranking follows the trained convention")
    ckpt_scales = sorted(int(v) for v in scheduler.values)
    if set(ckpt_scales) == set(int(s) for s in cfg.infer.scales):
        return cfg
    if cfg.infer.scales_explicit:
        log(f"WARNING: explicit --test_scales {sorted(cfg.infer.scales)} "
            f"differ from the checkpoint's trained scales {ckpt_scales}; "
            f"honoring --test_scales — windows at untrained scales vote "
            f"with untrained statistics")
        return cfg
    log(f"WARNING: CLI-derived inference scales {sorted(cfg.infer.scales)} "
        f"differ from the checkpoint's trained scales {ckpt_scales}; using "
        f"the checkpoint's scales (pass --test_scales to override)")
    return dataclasses.replace(
        cfg, infer=dataclasses.replace(cfg.infer, scales=tuple(ckpt_scales))
    )


def _warn_protocol_mismatch(cfg: Config, stats: dict, log) -> None:
    """Warn where the split/band choices recorded in the sidecar differ
    from this run's; the CLI flags stay authoritative."""
    for key in ("dataset", "fold", "val_tiles", "bands", "extra_bands"):
        if key not in stats:
            continue  # pre-r2 sidecar: nothing recorded to compare
        have = str(getattr(cfg.data, key) or "")
        want = str(stats.get(key) or "")
        if key == "fold":  # ints, and 0 is a real fold — compare directly
            have, want = str(cfg.data.fold), str(stats["fold"])
        if want != have:
            log(f"WARNING: checkpoint was trained with --{key}="
                f"{want or '<default>'} but this run uses "
                f"{have or '<default>'} — scores are NOT comparable to "
                f"the training protocol"
                + (f" (pass --{key} {want} to match)" if want else ""))


def _serving_variables(cfg: Config, state, stats: Optional[dict],
                       use_ema: Optional[bool], log=print,
                       from_best: bool = False) -> dict:
    """The state_dict an eval/predict entry point serves: the raw params
    with the live BatchNorm statistics, or the EMA params with their
    recalibrated statistics from the stats sidecar. use_ema None = auto:
    EMA whenever the checkpoint carries one and this is a latest-
    checkpoint restore (a --use_best restore serves the raw best iterate,
    which is what best selection scored). True = require, False = raw.
    Without recalibrated statistics the EMA weights run on the live ones,
    with a warning."""
    from dynseg_torch.bridge import batch_stats_to_torch
    from dynseg_torch.train import ema_variables

    ema = ema_variables(cfg, state)
    if use_ema is None:
        resolved = ema is not None and not from_best
    else:
        resolved = use_ema
    if resolved and ema is None:
        raise ValueError(
            "--use_ema: this checkpoint has no EMA weights (it was "
            "trained without --ema_decay)")
    if not resolved:
        if use_ema is None and from_best and ema is not None:
            log("--use_best: serving the RAW best-validation iterate "
                "(best-step selection was scored on raw weights; the "
                "sidecar's recalibrated BN stats belong to the end-of-"
                "training EMA). Pass --use_ema to opt into the "
                "approximate EMA-at-best-step combination")
        return {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    if use_ema is None:
        log("using EMA weights (checkpoint trained with --ema_decay "
            f"{cfg.train.ema_decay}; pass --no_use_ema for the raw "
            f"final iterate)")
    rec = (stats or {}).get("ema_batch_stats")
    if rec is not None:
        device = next(iter(ema.values())).device
        ema.update({k: v.to(device) for k, v in batch_stats_to_torch(rec).items()})
        log("using recalibrated BatchNorm statistics for the EMA weights "
            "(stats sidecar)")
        if from_best:
            log("note: the sidecar's recalibrated statistics belong to "
                "the END-of-training EMA; for this best-step checkpoint "
                "they are an approximation (the raw best iterate, "
                "--no_use_ema, needs no recalibration)")
    elif any(k.endswith("running_mean") for k in ema):
        log("WARNING: no recalibrated BN statistics in the sidecar "
            "(preempted run, --ema_recalib_batches 0, or a pre-"
            "recalibration checkpoint) — serving EMA weights with LIVE "
            "statistics; prefer --no_use_ema for such checkpoints")
    return ema


def _fix_num_input_bands(cfg: Config, train_tiles) -> Config:
    bands = train_tiles.num_bands
    if bands != cfg.model.num_input_bands:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, num_input_bands=bands))
    return cfg


def _fix_num_classes(cfg: Config, train_tiles, log=print) -> Config:
    """Widen the head when the loaded labels exceed the dataset's default
    class count."""
    from dynseg_torch.data.tiles import IGNORE_LABEL

    masks = np.asarray(train_tiles.masks)
    labeled = masks[masks != IGNORE_LABEL]
    observed = int(labeled.max()) + 1 if labeled.size else 0
    if observed > cfg.model.num_classes:
        log(f"note: labels contain {observed} classes; widening the model "
            f"head from the {cfg.data.dataset!r} default "
            f"{cfg.model.num_classes}")
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, num_classes=observed))
    return cfg


def _sidecar(cfg: Config, train_tiles) -> dict:
    """The stats sidecar of a training run, in the reference's schema."""
    return {
        "mean": train_tiles.mean, "std": train_tiles.std,
        "num_input_bands": cfg.model.num_input_bands,
        "num_classes": cfg.model.num_classes,
        "net_type": cfg.model.net_type,
        "dataset": cfg.data.dataset,
        "width_multiplier": cfg.model.width_multiplier,
        "use_batch_norm": cfg.model.use_batch_norm,
        "bn_momentum": cfg.model.bn_momentum,
        "leaky_slope": cfg.model.leaky_slope,
        "pool_window": cfg.model.pool_window,
        "dropout_rate": cfg.model.dropout_rate,
        "ema_decay": cfg.train.ema_decay,
        "lr_decay_rate": cfg.train.lr_decay_rate,
        "lr_decay_steps": cfg.train.lr_decay_steps,
        "val_tiles": cfg.data.val_tiles,
        "bands": cfg.data.bands,
        "extra_bands": cfg.data.extra_bands,
        "fold": cfg.data.fold,
    }


def _check_resume(cfg: Config, prev_stats: dict, log) -> None:
    """The reference's --resume guards that read the previous sidecar,
    in its order: net_type, the protocol warning, EMA and LR-schedule
    toggles."""
    if prev_stats.get("net_type") not in (None, cfg.model.net_type):
        raise ValueError(
            f"--resume: checkpoint was trained with net_type="
            f"{prev_stats['net_type']!r} but the CLI requests "
            f"{cfg.model.net_type!r}; resume with the original "
            f"--net_type or train fresh in a new --output_path"
        )
    _warn_protocol_mismatch(cfg, prev_stats, log)
    prev_ema = float(prev_stats.get("ema_decay", 0.0))
    if (prev_ema > 0.0) != (cfg.train.ema_decay > 0.0):
        raise ValueError(
            f"--resume: checkpoint was trained with ema_decay="
            f"{prev_ema} but the CLI requests "
            f"{cfg.train.ema_decay}; EMA cannot be toggled "
            f"on/off mid-run — resume with the original "
            f"--ema_decay or train fresh in a new --output_path"
        )
    prev_lr_decay = float(prev_stats.get("lr_decay_rate", 1.0))
    if (prev_lr_decay < 1.0) != (cfg.train.lr_decay_rate < 1.0):
        raise ValueError(
            f"--resume: checkpoint was trained with "
            f"lr_decay_rate={prev_lr_decay} but the CLI "
            f"requests {cfg.train.lr_decay_rate}; the LR "
            f"schedule cannot be toggled on/off mid-run — "
            f"resume with a compatible --lr_decay_rate or "
            f"train fresh in a new --output_path"
        )


def _check_resumed_scheduler(cfg: Config, scheduler) -> None:
    if set(scheduler.values) != set(int(v) for v in cfg.sched.values):
        raise ValueError(
            f"--resume: checkpoint was trained with --values "
            f"{sorted(scheduler.values)} but the CLI requests "
            f"{sorted(cfg.sched.values)}; resume with the original "
            f"--values or train fresh in a new --output_path"
        )
    if scheduler.semantics_adopted:
        detail = ", ".join(
            f"{k}: checkpoint={c!r} vs CLI={u!r}"
            for k, (c, u) in scheduler.semantics_adopted.items()
        )
        raise ValueError(
            f"--resume: scheduler semantics differ from the checkpoint "
            f"({detail}); resume with the original --update_type/"
            f"--sched_favor or train fresh in a new --output_path"
        )


def _save_maps(cfg: Config, scores: dict, test_tiles) -> None:
    if cfg.infer.save_prediction_maps:
        from dynseg_torch.viz import save_prediction_maps

        save_prediction_maps(scores["predictions"], cfg.data.dataset,
                             cfg.train.output_path)
    if cfg.infer.save_error_maps:
        from dynseg_torch.viz import save_error_maps

        save_error_maps(scores["predictions"], list(test_tiles.masks),
                        cfg.train.output_path)


def _write_scores(cfg: Config, scores: dict, scales=None) -> None:
    out = {
        "oa": scores["oa"],
        "kappa": scores["kappa"],
        "mean_f1": scores["mean_f1"],
        "f1": list(map(float, scores["f1"])),
        "inference": {
            "mode": cfg.infer.mode,
            "scales": ([] if cfg.infer.mode == "dense"
                       else [int(s) for s in (scales or cfg.infer.scales)]),
            "tta": cfg.infer.tta,
            "quant": cfg.infer.quant,
            "quant_exit": (cfg.infer.quant_exit
                           if cfg.infer.quant != "none" else False),
            "wall_s": scores.get("infer_wall_s"),
        },
    }
    if "eroded" in scores:
        es = scores["eroded"]
        out["eroded"] = {
            "oa": es["oa"], "kappa": es["kappa"], "mean_f1": es["mean_f1"],
            "f1": list(map(float, es["f1"])),
        }
    path = os.path.join(cfg.train.output_path, "scores.json")
    os.makedirs(cfg.train.output_path, exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=2)


def run_training(cfg: Config, log=print, keep_best: bool = False, *,
                 device, on_trainer=None) -> dict:
    """Train per `cfg` on `device` with checkpoints in
    cfg.train.output_path, then score the test tiles with the weights that
    would be served. Returns validate_test's scores plus "train_steps",
    the per-scale step times of the loop (Trainer.step_stats); a run
    stopped by SIGTERM/SIGINT returns {"preempted": True, "iteration"}.
    `on_trainer`, if given, is called with the run's Trainer once it is
    built (a probe keeps it to check the kernels on the run's own tiles
    after the run). In a data-parallel group every rank calls it; rank 0
    alone writes."""
    from dynseg_torch import parallel
    from dynseg_torch.bridge import torch_to_flax
    from dynseg_torch.checkpoint import CheckpointManager
    from dynseg_torch.data.sampler import BalancedPatchSampler
    from dynseg_torch.infer import validate_test
    from dynseg_torch.metrics import scores_from_confusion
    from dynseg_torch.sched.scheduler import ScaleScheduler
    from dynseg_torch.train import Trainer, ema_variables, train_loop

    train_tiles, test_tiles = load_dataset(
        cfg.data.dataset, cfg.data.dataset_path, cfg.data.fold,
        **_loader_kwargs(cfg))
    cfg = _fix_num_input_bands(cfg, train_tiles)
    cfg = _fix_num_classes(cfg, train_tiles, log)
    os.makedirs(cfg.train.output_path, exist_ok=True)

    trainer = Trainer(cfg, train_tiles, device)
    if on_trainer is not None:
        on_trainer(trainer)
    scheduler = ScaleScheduler(cfg.sched, seed=cfg.train.seed)
    ckpt = CheckpointManager(cfg.train.output_path)
    if not cfg.train.resume and ckpt.reset_for_fresh_run():
        log("WARNING: cleared checkpoints from a previous run in this "
            "--output_path (a fresh run cannot extend them; pass --resume "
            "to continue the previous run instead)")
    new_stats = _sidecar(cfg, train_tiles)
    parallel.barrier()  # rank 0's reset is done before any rank reads

    start_iter = 0
    if cfg.train.resume and ckpt.latest_step() is not None:
        # Every guard runs before save_stats: a refused resume leaves the
        # previous run's sidecar as it was.
        prev_stats = ckpt.load_stats()
        if prev_stats is not None:
            _check_resume(cfg, prev_stats, log)
        state, start_iter = ckpt.restore(trainer, scheduler)
        _check_resumed_scheduler(cfg, scheduler)
        trainer.reseed_samplers(start_iter)
        log(f"resumed from iteration {start_iter}")
    else:
        state = trainer.init_state(cfg.train.seed)
    parallel.barrier()  # every rank has read the previous run's files
    ckpt.save_stats(new_stats)

    log(f"training on {trainer.device}; warming up one step per scale...")
    times = trainer.compile_buckets(state)
    log(" ".join(f"scale {s}: {t:.1f}s" for s, t in times.items()))

    # Periodic crop validation on the held-out tiles.
    val_dev, val_padded = trainer.put_tiles(test_tiles)
    val_sampler = BalancedPatchSampler(
        val_padded, cfg.model.num_classes, pad=trainer.pad,
        seed=cfg.train.seed + 17, balanced=False)
    val_scale = max(cfg.sched.values)
    val_pos = val_sampler.sample(min(64, cfg.train.batch_size))

    def on_eval(it, st):
        m = trainer.eval_crops(st, val_dev, val_pos, val_scale)
        s = scores_from_confusion(m["confusion"].cpu().numpy())
        log(f"[val @ iter {it}] loss={float(m['loss']):.4f} "
            f"acc={float(m['acc']):.4f} kappa={s['kappa']:.4f} "
            f"meanF1={s['mean_f1']:.4f}")
        if keep_best and ckpt.save_best(s["mean_f1"], it, st, scheduler):
            log(f"[val @ iter {it}] new best meanF1={s['mean_f1']:.4f} saved")

    state = train_loop(cfg, trainer, state, scheduler, start_iter=start_iter,
                       log=log, on_eval=on_eval,
                       checkpointer=lambda it, st, sch: ckpt.save(it, st, sch))
    final_it = int(state.step)
    if final_it < cfg.train.niter:
        # Preempted: train_loop checkpointed the exact iteration.
        log(f"preempted at iteration {final_it}/{cfg.train.niter}; "
            f"exiting (resume with --resume)")
        return {"preempted": True, "iteration": final_it}
    ckpt.save(cfg.train.niter, state, scheduler)
    log(f"training done; final scale distribution: {scheduler.summary()}")

    # The served EMA weights get BatchNorm statistics recalibrated for
    # them, kept in the sidecar for testing and predict.
    ema = ema_variables(cfg, state)
    if (ema is not None and cfg.train.ema_recalib_batches > 0
            and cfg.model.use_batch_norm):
        log(f"recalibrating BatchNorm statistics for the EMA weights "
            f"({cfg.train.ema_recalib_batches} batches)")
        recal = trainer.recalibrate_batch_stats(ema, cfg.train.ema_recalib_batches)
        new_stats["ema_batch_stats"] = torch_to_flax(recal)["batch_stats"]
        ckpt.save_stats(new_stats)
    variables = _serving_variables(cfg, state, new_stats, None, log)
    scores = validate_test(cfg, variables, test_tiles, trainer.device, log=log)
    if parallel.is_main():
        _save_maps(cfg, scores, test_tiles)
        _write_scores(cfg, scores)
    scores["train_steps"] = trainer.step_stats()
    return scores


def _top_k_scales(scheduler, k: int, log) -> Optional[List[int]]:
    if k <= 0:
        return None
    scales = scheduler.best_scales(k)
    log(f"scheduler-selected inference scales: {scales}")
    return scales


def run_testing(cfg: Config, log=print, scales_from_scheduler: int = 0,
                use_best: bool = False, use_ema: Optional[bool] = None, *,
                device) -> dict:
    """Restore the checkpoint in cfg.train.output_path onto `device` and
    score the test tiles, normalised with the training statistics of the
    stats sidecar. In a data-parallel group every rank calls it; rank 0
    alone writes."""
    from dynseg_torch import parallel
    from dynseg_torch.checkpoint import CheckpointManager
    from dynseg_torch.infer import validate_test
    from dynseg_torch.sched.scheduler import ScaleScheduler
    from dynseg_torch.train import Trainer, init_state_template

    if cfg.train.num_devices != parallel.world().size:
        raise ValueError(
            f"num_devices {cfg.train.num_devices} but this process is one of "
            f"{parallel.world().size} rank(s): launch the ranks with "
            f"python -m dynseg_torch --num_devices N")
    scheduler = ScaleScheduler(cfg.sched, seed=cfg.train.seed)
    ckpt = CheckpointManager(cfg.train.output_path)
    stats = ckpt.load_stats()
    # With a sidecar the training split is needed for nothing.
    train_tiles, test_tiles = load_dataset(
        cfg.data.dataset, cfg.data.dataset_path, cfg.data.fold,
        test_only=(stats is not None), **_loader_kwargs(cfg))
    if stats is not None:
        _warn_protocol_mismatch(cfg, stats, log)
        cfg = _adopt_checkpoint_model(cfg, stats)
        if test_tiles.num_bands != cfg.model.num_input_bands:
            raise ValueError(
                f"test tiles have {test_tiles.num_bands} bands but the "
                f"checkpoint was trained on {cfg.model.num_input_bands} "
                f"(match the training --bands/--extra_bands)")
        test_tiles.mean = np.asarray(stats["mean"], np.float32)
        test_tiles.std = np.asarray(stats["std"], np.float32)
        state, step = ckpt.restore_state(init_state_template(cfg, device),
                                         scheduler, best=use_best)
    else:  # no sidecar: the template via a full Trainer
        cfg = _fix_num_input_bands(cfg, train_tiles)
        trainer = Trainer(cfg, train_tiles, device)
        state, step = ckpt.restore(trainer, scheduler, best=use_best)
    log(f"restored {'best ' if use_best else ''}checkpoint at iteration {step}")
    cfg = _reconcile_scales(cfg, scheduler, log)
    scales = None
    if scales_from_scheduler > 0 and cfg.infer.mode == "dense":
        log("WARNING: --scales_from_scheduler has no effect in dense "
            "mode (whole-tile forward, no window-scale fusion) — ignored")
    else:
        scales = _top_k_scales(scheduler, scales_from_scheduler, log)
    variables = _serving_variables(cfg, state, stats, use_ema, log,
                                   from_best=use_best)
    scores = validate_test(cfg, variables, test_tiles, device, scales=scales,
                           log=log)
    if parallel.is_main():
        _save_maps(cfg, scores, test_tiles)
        _write_scores(cfg, scores, scales=scales)
    return scores


def run_predict(cfg: Config, predict_path: str, log=print,
                scales_from_scheduler: int = 0, use_best: bool = False,
                predict_chunk: int = 0, use_ema: Optional[bool] = None, *,
                device) -> List[str]:
    """Label maps of unlabeled rasters from the checkpoint and its stats
    sidecar alone (no training dataset on disk), named after the input
    files. predict_chunk > 0 loads that many rasters at a time, padded to
    512-px multiples; the Inferencer (and its int8 calibration, made on
    the first chunk) is reused across chunks."""
    from dynseg_torch.checkpoint import CheckpointManager
    from dynseg_torch.data.datasets import list_rasters, load_rasters, raster_names
    from dynseg_torch.infer import Inferencer
    from dynseg_torch.sched.scheduler import ScaleScheduler
    from dynseg_torch.train import init_state_template
    from dynseg_torch.viz import save_prediction_maps

    ckpt = CheckpointManager(cfg.train.output_path)
    stats = ckpt.load_stats()
    if stats is None:
        raise FileNotFoundError(
            f"no stats.json under {ckpt.dir}: predict needs the sidecar a "
            f"training run writes; use --operation testing with the "
            f"original dataset")
    cfg = _adopt_checkpoint_model(cfg, stats)

    files = list_rasters(predict_path)
    # Output stems deduped over the full list before chunking.
    all_names = raster_names(files)
    chunk = predict_chunk if predict_chunk > 0 else len(files)
    pad_mult = 512 if predict_chunk > 0 else 1

    scheduler = ScaleScheduler(cfg.sched, seed=cfg.train.seed)
    state, step = ckpt.restore_state(init_state_template(cfg, device),
                                     scheduler, best=use_best)
    log(f"restored {'best ' if use_best else ''}checkpoint at iteration {step}")
    cfg = _reconcile_scales(cfg, scheduler, log)
    scales = _top_k_scales(scheduler, scales_from_scheduler, log)
    variables = _serving_variables(cfg, state, stats, use_ema, log,
                                   from_best=use_best)

    # Colour with the training dataset's palette, recorded in the sidecar.
    palette_ds = stats.get("dataset") or cfg.data.dataset
    if palette_ds != cfg.data.dataset and cfg.data.dataset != "synthetic":
        log(f"note: using training palette {palette_ds!r} "
            f"(CLI --dataset was {cfg.data.dataset!r})")

    paths: List[str] = []
    inf = None
    for lo in range(0, len(files), chunk):
        tiles, names = load_rasters(files[lo:lo + chunk],
                                    pad_to_multiple=pad_mult,
                                    names=all_names[lo:lo + chunk])
        if tiles.num_bands != cfg.model.num_input_bands:
            raise ValueError(
                f"rasters have {tiles.num_bands} bands but the checkpoint "
                f"was trained on {cfg.model.num_input_bands}")
        tiles.mean = np.asarray(stats["mean"], np.float32)
        tiles.std = np.asarray(stats["std"], np.float32)
        if inf is None:
            inf = Inferencer(cfg, tiles, device)
            if cfg.infer.quant != "none":
                variables = inf.enable_quant(variables)
                blocks = sorted(f"DilatedConvBlock_{k.split('.')[1]}"
                                for k in variables if k.endswith(".w_scale"))
                log(f"int8 serving path: quantized blocks {blocks}"
                    f"{' + int8 exit' if 'exit.act_scale' in variables else ''}")
        else:
            inf.set_tiles(tiles)
        # Tile t's map comes back to the host while tile t+1 is queued.
        pending = inf.predict_tile_device(variables, 0, scales)
        for t in range(tiles.num_tiles):
            nxt = (inf.predict_tile_device(variables, t + 1, scales)
                   if t + 1 < tiles.num_tiles else None)
            pred = pending.cpu().numpy().astype(np.int32)
            pending = nxt
            h, w = (int(x) for x in tiles.valid_hw[t])
            paths += save_prediction_maps([pred], palette_ds,
                                          cfg.train.output_path,
                                          names=[names[t]])
            log(f"tile {names[t]}: {w}x{h} -> {paths[-1]}")
        del tiles
    return paths


class ServingRestore(NamedTuple):
    """What an export bakes: the checkpoint's config, served variables
    and, under --quant int8, the calibrated quantized variables."""

    cfg: Config
    variables: dict
    quant_variables: Optional[dict]
    stats: dict
    scheduler: object
    step: int


def restore_for_serving(cfg: Config, log=print, use_best: bool = False,
                        use_ema: Optional[bool] = None, *,
                        device) -> ServingRestore:
    """The checkpoint and its stats sidecar restored for serving: the
    checkpoint's model, its trained scales, the served variables and,
    under --quant int8, the net calibrated on the test tiles on `device`,
    as testing calibrates it."""
    from dynseg_torch.checkpoint import CheckpointManager
    from dynseg_torch.sched.scheduler import ScaleScheduler
    from dynseg_torch.train import init_state_template

    ckpt = CheckpointManager(cfg.train.output_path)
    stats = ckpt.load_stats()
    if stats is None:
        raise FileNotFoundError(
            f"no stats.json under {ckpt.dir} — export needs the stats "
            f"sidecar a training run writes")
    cfg = _adopt_checkpoint_model(cfg, stats)
    scheduler = ScaleScheduler(cfg.sched, seed=cfg.train.seed)
    state, step = ckpt.restore_state(init_state_template(cfg, device),
                                     scheduler, best=use_best)
    log(f"restored {'best ' if use_best else ''}checkpoint at iteration {step}")
    # The manifest's train_scales and window_scales describe the
    # checkpoint's trained scales, not a CLI --values default.
    cfg = _reconcile_scales(cfg, scheduler, log)
    cfg = dataclasses.replace(
        cfg, sched=dataclasses.replace(
            cfg.sched, values=tuple(int(v) for v in scheduler.values)))
    variables = _serving_variables(cfg, state, stats, use_ema, log,
                                   from_best=use_best)
    quant_variables = None
    if cfg.infer.quant != "none":
        from dynseg_torch.infer import Inferencer

        _, calib_tiles = load_dataset(
            cfg.data.dataset, cfg.data.dataset_path, cfg.data.fold,
            test_only=True, **_loader_kwargs(cfg))
        if calib_tiles.num_bands != cfg.model.num_input_bands:
            raise ValueError(
                f"calibration tiles have {calib_tiles.num_bands} bands but "
                f"the checkpoint was trained on {cfg.model.num_input_bands} "
                f"(match --bands/--extra_bands, or export without --quant)")
        calib_tiles.mean = np.asarray(stats["mean"], np.float32)
        calib_tiles.std = np.asarray(stats["std"], np.float32)
        quant_variables = Inferencer(cfg, calib_tiles, device).enable_quant(variables)
        blocks = sorted(f"DilatedConvBlock_{k.split('.')[1]}"
                        for k in quant_variables if k.endswith(".w_scale"))
        log(f"int8 export: quantized blocks {blocks}"
            f"{' + int8 exit' if 'exit.act_scale' in quant_variables else ''}")
    return ServingRestore(cfg, variables, quant_variables, stats, scheduler, int(step))


def run_export(cfg: Config, platforms=("tpu", "cpu"), log=print,
               use_best: bool = False, use_ema: Optional[bool] = None, *,
               device) -> str:
    """Export the checkpoint as a standalone serving artifact (three
    `torch.export` programs with symbolic shapes, params and normalization
    baked in: dynseg_torch/export.py) from the checkpoint and its stats
    sidecar alone (`restore_for_serving`)."""
    from dynseg_torch.export import export_predictor

    r = restore_for_serving(cfg, log, use_best, use_ema, device=device)
    out_dir = export_predictor(
        r.cfg, r.variables, r.stats["mean"], r.stats["std"],
        os.path.join(r.cfg.train.output_path, "export"),
        platforms=platforms,
        extra_meta={
            "scheduler_best_scales": [int(s) for s in r.scheduler.best_scales(
                len(r.scheduler.values))],
            "checkpoint_step": r.step,
            "dataset": r.stats.get("dataset"),
        },
        quant_variables=r.quant_variables)
    with open(os.path.join(out_dir, "manifest.json")) as f:
        checked = json.load(f)["platforms"]
    log(f"exported serving artifact ({r.cfg.model.compute_dtype}) -> {out_dir} "
        f"(loaded and checked on: {', '.join(checked) or 'none'})")
    return out_dir


def run_info(cfg: Config, log=print, use_best: bool = False) -> dict:
    """The checkpoint's model card: architecture, parameter count,
    provenance, scheduler state and best-validation record. Reads the
    checkpoint on the CPU: it computes nothing."""
    from dynseg_torch.checkpoint import CheckpointManager
    from dynseg_torch.sched.scheduler import ScaleScheduler
    from dynseg_torch.train import init_state_template

    ckpt = CheckpointManager(cfg.train.output_path)
    stats = ckpt.load_stats()
    if stats is None:
        raise FileNotFoundError(
            f"no stats.json under {ckpt.dir} — not a dynseg output dir "
            f"(or a pre-sidecar checkpoint)")
    cfg = _adopt_checkpoint_model(cfg, stats, adopt_net_type=True)
    scheduler = ScaleScheduler(cfg.sched, seed=cfg.train.seed)
    state, step = ckpt.restore_state(init_state_template(cfg, "cpu"),
                                     scheduler, best=use_best)
    info = {
        "net_type": cfg.model.net_type,
        "num_classes": cfg.model.num_classes,
        "num_input_bands": cfg.model.num_input_bands,
        "parameters": sum(p.numel() for p in state.model.parameters()),
        "iteration": int(step),
        "dataset": stats.get("dataset"),
        "normalization_mean": [round(float(x), 4)
                               for x in np.ravel(stats["mean"])],
        "normalization_std": [round(float(x), 4)
                              for x in np.ravel(stats["std"])],
        "ema_decay": float(stats.get("ema_decay", 0.0)),
        "scheduler": scheduler.summary(),
        "protocol": {k: stats.get(k, "") for k in
                     ("val_tiles", "bands", "extra_bands")
                     if stats.get(k)},
        "best": ckpt.best_record(),
        "checkpoints": ckpt.all_steps(),
        "export": os.path.isdir(
            os.path.join(cfg.train.output_path, "export")),
    }
    for k, v in info.items():
        log(f"{k}: {v}")
    return info


# The operations that --num_devices N runs on N ranks, as the reference
# runs them on its mesh; the others run on one device.
DATA_PARALLEL_OPERATIONS = ("training", "testing", "validate_test")


def _launch_ranks(args: argparse.Namespace, argv: List[str]) -> int:
    """Run this command on --num_devices ranks (`parallel.spawn`): rank r
    on cuda:r over NCCL, or CPU ranks over gloo. Exits non-zero before
    any rank starts when the cards are fewer than the ranks, and when a
    rank fails (the others are stopped)."""
    from dynseg_torch import parallel

    n = args.num_devices
    try:
        devices = parallel.check_devices(n, args.device)
    except ValueError as e:
        raise SystemExit(f"dynseg_torch: {e}") from None
    threads = None
    if devices[0] == "cpu":
        threads = max(1, (os.cpu_count() or 1) // n)
    try:
        # Each rank runs this command's `main`, which sees the group.
        parallel.spawn(main, n, devices, args=(argv,), threads=threads)
    except Exception as e:  # a rank failed: its error, and a non-zero exit
        raise SystemExit(f"dynseg_torch: a rank of --num_devices {n} "
                         f"failed: {e}") from None
    return 0


def _launch_counts() -> str:
    """The run's CUDA kernel launches (0 on the CPU, where the plain
    versions run)."""
    from dynseg_torch.ops import gather, int8_conv, pool

    variants = " ".join(f"int8_block_conv.{v}={n}" for v, n in [
        *int8_conv.variant_launches.items(),
        *((f"out_{d}", n) for d, n in int8_conv.out_launches.items())])
    pools = " ".join(f"pool_bwd.{v}={n}" for v, n in pool.variant_launches.items())
    fwd = " ".join(f"{op}.{m}={n}" for op, counts in (
        ("max_pool_s1", pool.fwd_launches), ("max_pool_s1_into", pool.fwd_slot_launches))
        for m, n in counts.items())
    return (f"kernel launches: int8_block_conv={int8_conv.launches} {variants} "
            f"patch_gather={gather.launches} pool_bwd={pool.launches} {pools} {fwd}")


def main(argv: Optional[List[str]] = None) -> int:
    from dynseg_torch import parallel
    from dynseg_torch.utils.profiling import trace

    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_argparser().parse_args(argv)
    cfg = config_from_args(args)
    if (args.num_devices > 1 and args.operation in DATA_PARALLEL_OPERATIONS
            and not parallel.grouped()):
        return _launch_ranks(args, argv)
    if args.operation == "check_data":
        # Host-only pre-flight: no device; non-zero exit on a bad dump.
        from dynseg_torch.data.check import check_data

        report = check_data(
            cfg.data.dataset, cfg.data.dataset_path, fold=cfg.data.fold,
            loader_kwargs=_loader_kwargs(cfg),
            expected_bands=cfg.model.num_input_bands,
            max_scale=max(cfg.sched.values))
        return 0 if report["ok"] else 1
    device = None
    if parallel.grouped():
        device = parallel.world().device
    elif args.operation != "info":
        from dynseg_torch.train import resolve_device

        try:
            device = resolve_device(args.device)
        except (RuntimeError, ValueError) as e:
            raise SystemExit(f"dynseg_torch: {e}") from None
    from dynseg_torch.utils.logging import MetricLogger

    logger = MetricLogger(cfg.train.output_path)
    if cfg.infer.window_fold == "off":
        logger.log("--window_fold off: the port's window voting has one "
                   "accumulator (F.fold), whose counts equal the legacy "
                   "accumulator's bitwise")
    t0 = time.time()
    with trace(args.profile_dir):
        if args.operation == "training":
            run_training(cfg, log=logger, keep_best=args.keep_best,
                         device=device)
        elif args.operation == "predict":
            if not args.predict_path:
                raise SystemExit("--operation predict requires --predict_path")
            run_predict(cfg, args.predict_path, log=logger,
                        scales_from_scheduler=args.scales_from_scheduler,
                        use_best=args.use_best,
                        predict_chunk=args.predict_chunk,
                        use_ema=args.use_ema, device=device)
        elif args.operation == "export":
            platforms = tuple(
                s for s in args.export_platforms.replace(" ", "").split(",") if s)
            run_export(cfg, platforms=platforms, log=logger,
                       use_best=args.use_best, use_ema=args.use_ema,
                       device=device)
        elif args.operation == "info":
            run_info(cfg, log=logger, use_best=args.use_best)
        elif args.operation == "serve":
            from dynseg_torch.serve import main as serve_main

            export_dir = os.path.join(cfg.train.output_path, "export")
            if not os.path.isdir(export_dir):
                raise SystemExit(f"no export under {export_dir} — run "
                                 f"--operation export first")
            logger.close()
            return serve_main([
                "--export_dir", export_dir,
                "--host", args.serve_host,
                "--port", str(args.serve_port),
                "--window_batch", str(args.window_batch),
                "--max_request_mb", str(args.max_request_mb),
                "--device", args.device,
            ] + (  # only when explicit: serve's own default is 1024
                ["--dense_block", str(args.dense_block)]
                if args.dense_block is not None else []
            ) + (  # 0 = auto: serve's own default (8) stands
                ["--dense_block_batch", str(args.dense_block_batch)]
                if args.dense_block_batch > 0 else []))
        else:  # testing / validate_test
            run_testing(cfg, log=logger,
                        scales_from_scheduler=args.scales_from_scheduler,
                        use_best=args.use_best, use_ema=args.use_ema,
                        device=device)
    logger.log(_launch_counts())
    logger.log(f"total time: {time.time() - t0:.1f}s")
    logger.close()
    return 0



if __name__ == "__main__":
    sys.exit(main())
