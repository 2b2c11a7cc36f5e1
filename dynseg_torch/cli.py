"""Entry points of the port (counterpart of dynseg/cli.py).

`run_training(cfg)` trains a `dynseg.config.Config` end to end: load the
dataset, build the trainer, warm each scale up, run the scheduled loop
with periodic crop validation, then (with ema_decay > 0) recalibrate the
BatchNorm statistics for the EMA weights, score the test tiles with
`dynseg_torch.infer.validate_test` and write scores.json (and the
prediction maps) to cfg.train.output_path.

Not ported yet: checkpoints and --resume, the argument parser and the
other operations. `dynseg/cli.py` imports jax at the top, so the
jax-free helpers below are copies, held equal to the originals by
tests/test_torch_train.py.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from dynseg.config import Config
from dynseg.data.datasets import load_dataset


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


def _fix_num_input_bands(cfg: Config, train_tiles) -> Config:
    bands = train_tiles.num_bands
    if bands != cfg.model.num_input_bands:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, num_input_bands=bands))
    return cfg


def _fix_num_classes(cfg: Config, train_tiles, log=print) -> Config:
    """Widen the head when the loaded labels exceed the dataset's default
    class count."""
    from dynseg.data.tiles import IGNORE_LABEL

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


def _save_maps(cfg: Config, scores: dict, test_tiles) -> None:
    if cfg.infer.save_prediction_maps:
        from dynseg.viz import save_prediction_maps

        save_prediction_maps(scores["predictions"], cfg.data.dataset,
                             cfg.train.output_path)
    if cfg.infer.save_error_maps:
        from dynseg.viz import save_error_maps

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


def run_training(cfg: Config, log=print, device=None) -> dict:
    """Train per `cfg` on `device` (default: the card when there is one)
    and score the test tiles. Returns validate_test's scores plus
    "train_steps", the per-scale step times of the loop (Trainer.step_stats)."""
    from dynseg.data.sampler import BalancedPatchSampler
    from dynseg.sched.scheduler import ScaleScheduler
    from dynseg_torch.infer import validate_test
    from dynseg_torch.metrics import scores_from_confusion
    from dynseg_torch.train import Trainer, ema_variables, train_loop

    if cfg.train.resume:
        raise NotImplementedError("--resume: checkpoints are not ported")
    train_tiles, test_tiles = load_dataset(
        cfg.data.dataset, cfg.data.dataset_path, cfg.data.fold,
        **_loader_kwargs(cfg))
    cfg = _fix_num_input_bands(cfg, train_tiles)
    cfg = _fix_num_classes(cfg, train_tiles, log)
    os.makedirs(cfg.train.output_path, exist_ok=True)

    trainer = Trainer(cfg, train_tiles, device=device)
    scheduler = ScaleScheduler(cfg.sched, seed=cfg.train.seed)
    state = trainer.init_state(cfg.train.seed)
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

    state = train_loop(cfg, trainer, state, scheduler, log=log, on_eval=on_eval)
    log(f"training done; final scale distribution: {scheduler.summary()}")

    # The weights that would be served: the EMA iterate with BatchNorm
    # statistics recalibrated for it, or the raw final iterate.
    variables = ema_variables(cfg, state)
    if variables is None:
        variables = state.model.state_dict()
    elif cfg.model.use_batch_norm and cfg.train.ema_recalib_batches > 0:
        log(f"recalibrating BatchNorm statistics for the EMA weights "
            f"({cfg.train.ema_recalib_batches} batches)")
        variables = trainer.recalibrate_batch_stats(
            variables, cfg.train.ema_recalib_batches)
    scores = validate_test(cfg, variables, test_tiles, log=log)
    _save_maps(cfg, scores, test_tiles)
    _write_scores(cfg, scores)
    scores["train_steps"] = trainer.step_stats()
    return scores
