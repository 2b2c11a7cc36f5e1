"""Reproducibility of a training run: the same seed gives the same run,
as the reference guarantees (tests/test_determinism.py).

  * `train_run`: one `train_loop` from a seed (or resumed from a
    checkpoint, as the command line resumes), with the per-step losses
    and scales recorded, the EMA weights' BatchNorm statistics
    recalibrated, and the final state on the CPU;
  * `distances`: the largest difference between two such runs, part by
    part; 0 everywhere is a bitwise rerun.

Used by tests/test_torch_determinism.py and tests/test_torch_cuda.py.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import numpy as np
import torch

from dynseg_torch.config import Config
from dynseg_torch.data.tiles import TileSet


def _cpu(sd: Optional[Dict[str, torch.Tensor]]) -> Optional[Dict[str, np.ndarray]]:
    if sd is None:
        return None
    return {k: v.detach().cpu().numpy().copy() for k, v in sd.items()}


def train_run(cfg: Config, tiles: TileSet, device, niter: Optional[int] = None,
              recalib: int = 0, save_to: Optional[str] = None,
              restore_from: Optional[str] = None,
              context: Optional[Callable] = None) -> dict:
    """`train_loop` on a fresh Trainer for `niter` steps (default
    cfg.train.niter) from cfg.train.seed, or, with `restore_from`, from the
    latest checkpoint there (samplers reseeded at its iteration, as
    `--resume` does) for `niter` more. Then, with `recalib` > 0 and EMA
    on, `recalibrate_batch_stats` of the EMA weights; with `save_to`, the
    state checkpointed there. `context` (a context-manager factory) is
    entered after the Trainer is built, around the loop and the
    recalibration. Returns the per-step losses and scales, the
    scheduler's scores, the state_dict, momentum, EMA and recalibrated
    statistics on the CPU, the step, and cuDNN's deterministic and
    benchmark flags as the run left them."""
    from dynseg_torch.checkpoint import CheckpointManager
    from dynseg_torch.sched.scheduler import ScaleScheduler
    from dynseg_torch.train import (Trainer, checkpoint_dict, ema_variables,
                                    train_loop)

    tr = Trainer(cfg, tiles, device)
    sched = ScaleScheduler(cfg.sched, seed=cfg.train.seed)
    start = 0
    if restore_from is not None:
        st, start = CheckpointManager(restore_from).restore(tr, sched)
        tr.reseed_samplers(start)
    else:
        st = tr.init_state(cfg.train.seed)
    losses, scales = [], []
    step = tr.train_step

    def recording(state, size):
        state, m = step(state, size)
        losses.append(m["loss"])
        scales.append(size)
        return state, m

    tr.train_step = recording
    n = cfg.train.niter if niter is None else niter
    recal = None
    with (context or contextlib.nullcontext)():
        st = train_loop(cfg, tr, st, sched, niter=start + n, log_every=0,
                        log=lambda *_: None, start_iter=start)
        ema = ema_variables(cfg, st)
        if recalib > 0 and ema is not None:
            recal = tr.recalibrate_batch_stats(ema, recalib)
    if save_to is not None:
        CheckpointManager(save_to).save(st.step, st, sched)
    ckpt = checkpoint_dict(st)
    return {"losses": [float(x) for x in losses], "scales": scales,
            "scores": sched.state_dict()["scores"], "state": _cpu(ckpt["model"]),
            "momentum": _cpu(ckpt["momentum"]), "ema": _cpu(ckpt["ema"]),
            "recal": _cpu(recal), "step": ckpt["step"],
            "cudnn": (torch.backends.cudnn.deterministic,
                      torch.backends.cudnn.benchmark)}


def _max_abs(a: Optional[dict], b: Optional[dict], keep=lambda k: True) -> float:
    if a is None or b is None:
        return 0.0 if a is b else float("inf")
    if a.keys() != b.keys():
        return float("inf")
    return max([float(np.abs(a[k].astype(np.float64) - b[k].astype(np.float64)).max())
                for k in a if keep(k)] or [0.0])


def distances(a: dict, b: dict) -> Dict[str, float]:
    """The largest |a - b| of two `train_run` results, by part: params,
    BN statistics, momentum, EMA, recalibrated statistics, losses and
    scheduler scores; scales 0 where the two drew the same, else inf."""
    def scores(x, y):
        if x.keys() != y.keys() or any((x[v] is None) != (y[v] is None) for v in x):
            return float("inf")
        return max([abs(x[v] - y[v]) for v in x if x[v] is not None] or [0.0])

    return {
        "params": _max_abs(a["state"], b["state"], lambda k: "running" not in k),
        "bn": _max_abs(a["state"], b["state"], lambda k: "running" in k),
        "momentum": _max_abs(a["momentum"], b["momentum"]),
        "ema": _max_abs(a["ema"], b["ema"]),
        "recal": _max_abs(a["recal"], b["recal"]),
        "losses": (max([abs(x - y) for x, y in zip(a["losses"], b["losses"])] or [0.0])
                   if len(a["losses"]) == len(b["losses"]) else float("inf")),
        "scores": scores(a["scores"], b["scores"]),
        "scales": 0.0 if a["scales"] == b["scales"] else float("inf"),
    }
