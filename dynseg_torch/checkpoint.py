"""Checkpoint save/restore of the port (counterpart of dynseg/checkpoint.py).

The reference keeps its checkpoints with orbax, which needs JAX; the port
keeps the same layout under `<output_path>/checkpoints/` in a format of
its own:

    <step>/state.pt         the TrainState as `train.checkpoint_dict` gives
                            it: the model's state_dict (params and BatchNorm
                            running statistics), the momentum buffers by
                            parameter name, the EMA dict or None, the step
    <step>/scheduler.json   the scheduler's state_dict, JSON
    best/<step>/...         the best-validation checkpoint (max 1)
    best.json               {"metric", "step"} of best/
    stats.json              the sidecar, in the reference's schema

Each step is written to a temporary directory and renamed into place, so
a run stopped mid-save leaves the last good step. Loading uses
torch.load(weights_only=True). A step directory that holds no state.pt is
the reference's orbax checkpoint: the port refuses it and names
`import_reference_state`, which converts one.

Under data parallelism (`dynseg_torch.parallel`) every rank holds the
same state: rank 0 alone writes, and every rank restores. The files
carry no trace of the ranks, so a checkpoint written at N ranks restores
at 1 and the other way round.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import List, Optional, Tuple

import numpy as np
import torch

from dynseg_torch import parallel
from dynseg_torch.sched.scheduler import ScaleScheduler
from dynseg_torch.train import (TrainState, Trainer, checkpoint_dict,
                                init_state_template, load_checkpoint_dict)

_STATE = "state.pt"
_SCHED = "scheduler.json"


class _Steps:
    """The step directories under one root, newest kept, at most
    `max_to_keep` of them."""

    def __init__(self, root: str, max_to_keep: int):
        self.root = root
        self.max_to_keep = max_to_keep

    def all_steps(self) -> List[int]:
        if not os.path.isdir(self.root):
            return []
        steps = []
        for name in os.listdir(self.root):
            path = os.path.join(self.root, name)
            if not (name.isdigit() and os.path.isdir(path)):
                continue
            if not os.path.exists(os.path.join(path, _STATE)):
                raise ValueError(
                    f"{path} is not a dynseg_torch checkpoint (no {_STATE}; "
                    f"an orbax step of the JAX package?). The port does not "
                    f"read orbax checkpoints: convert it with "
                    f"dynseg_torch.checkpoint.import_reference_state (see "
                    f"README.md), or train in another --output_path")
            steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, ckpt: dict, sched_state: dict) -> bool:
        """Write `step`; refused (False) at a step <= the latest, as
        orbax refuses it."""
        latest = self.latest_step()
        if latest is not None and step <= latest:
            return False
        os.makedirs(self.root, exist_ok=True)
        tmp = os.path.join(self.root, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(ckpt, os.path.join(tmp, _STATE))
        with open(os.path.join(tmp, _SCHED), "w") as f:
            json.dump(_jsonable(sched_state), f)
        os.replace(tmp, os.path.join(self.root, str(step)))
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.root, str(old)))
        return True

    def load(self, step: int, device) -> Tuple[dict, dict]:
        path = os.path.join(self.root, str(step))
        ckpt = torch.load(os.path.join(path, _STATE), map_location=device,
                          weights_only=True)
        with open(os.path.join(path, _SCHED)) as f:
            sched = json.load(f)
        return ckpt, sched


class CheckpointManager:
    """Saves (on rank 0; the other ranks' saves write nothing and return
    False) and restores (on every rank)."""

    def __init__(self, output_path: str, max_to_keep: int = 3):
        self.dir = os.path.abspath(os.path.join(output_path, "checkpoints"))
        self.max_to_keep = max_to_keep
        self.writer = parallel.is_main()
        if self.writer:
            os.makedirs(self.dir, exist_ok=True)
        self._main = _Steps(self.dir, max_to_keep)
        self._best = _Steps(os.path.join(self.dir, "best"), 1)

    def reset_for_fresh_run(self) -> bool:
        """Delete checkpoints left by a PREVIOUS run in this output_path,
        as the reference does: a fresh run's saves would be refused at
        steps <= the old run's latest, and a stale best.json/best/ would
        gate --keep_best against a metric the new run never produced.
        Returns True if state was removed; the caller logs it."""
        if not self.writer:
            return False
        had_best = (self.best_record() is not None
                    or os.path.isdir(self._best.root))
        if self.latest_step() is None and not had_best:
            return False
        shutil.rmtree(self.dir, ignore_errors=True)
        os.makedirs(self.dir, exist_ok=True)
        return True

    def save(self, it: int, state: TrainState, scheduler: ScaleScheduler) -> bool:
        if not self.writer:
            return False
        return self._main.save(it, checkpoint_dict(state), scheduler.state_dict())

    def save_stats(self, stats: dict) -> None:
        """The sidecar predict and testing read instead of the training
        dataset: normalisation statistics, input/output dims and the
        architecture knobs (the reference's schema)."""
        if not self.writer:
            return
        with open(os.path.join(self.dir, "stats.json"), "w") as f:
            json.dump(_jsonable(stats), f, indent=2)

    def load_stats(self) -> Optional[dict]:
        path = os.path.join(self.dir, "stats.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return _unjsonable(json.load(f))

    def latest_step(self) -> Optional[int]:
        return self._main.latest_step()

    def all_steps(self) -> List[int]:
        return self._main.all_steps()

    def best_record(self) -> Optional[dict]:
        path = os.path.join(self.dir, "best.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def save_best(self, metric: float, it: int, state: TrainState,
                  scheduler: ScaleScheduler) -> bool:
        """Keep the single checkpoint with the highest validation metric
        under checkpoints/best/. Returns True if this one became the best."""
        if not self.writer:
            return False
        rec = self.best_record()
        if rec is not None and float(metric) <= float(rec["metric"]):
            return False
        if not self._best.save(it, checkpoint_dict(state), scheduler.state_dict()):
            # A stale best/ at a later step (a previous run's): never let
            # best.json claim weights that were not written.
            return False
        with open(os.path.join(self.dir, "best.json"), "w") as f:
            json.dump({"metric": float(metric), "step": int(it)}, f)
        return True

    def restore(self, trainer: Trainer, scheduler: ScaleScheduler,
                step: Optional[int] = None, best: bool = False
                ) -> Tuple[TrainState, int]:
        """Restore into a template of the trainer's config on its device."""
        template = init_state_template(trainer.cfg, trainer.device)
        return self.restore_state(template, scheduler, step, best=best)

    def restore_state(self, template: TrainState,
                      scheduler: Optional[ScaleScheduler] = None,
                      step: Optional[int] = None, best: bool = False
                      ) -> Tuple[TrainState, int]:
        """Trainer-free restore into `template` (train.init_state_template),
        on the template's device. best=True restores the best-validation
        checkpoint (save_best)."""
        steps = self._best if best else self._main
        step = steps.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(
                f"no {'best ' if best else ''}checkpoint under {self.dir}")
        device = next(template.model.parameters()).device
        ckpt, sched = steps.load(step, device)
        load_checkpoint_dict(template, ckpt)
        if scheduler is not None:
            scheduler.load_state_dict(_unjsonable(sched))
        return template, step


def import_reference_state(dst_output_path: str, variables: dict,
                           momentum: dict, ema: Optional[dict], step: int,
                           scheduler_state: dict, stats: Optional[dict]) -> str:
    """Write a port checkpoint at `step` from the numpy trees of a dynseg
    checkpoint: `variables` {"params", "batch_stats"}, the optimizer's
    momentum trace and the params' EMA (params-shaped trees, `ema` None
    when the run had none), the scheduler's JSON state and the stats
    sidecar. Reading the orbax checkpoint needs JAX, so it is the
    caller's half (README.md has the snippet). Returns the checkpoint dir."""
    from dynseg_torch.bridge import flax_to_torch

    def params_of(tree):
        return flax_to_torch({"params": tree})

    ckpt = {"model": flax_to_torch(variables), "momentum": params_of(momentum),
            "ema": None if ema is None else params_of(ema), "step": int(step)}
    mgr = CheckpointManager(dst_output_path)
    if not mgr._main.save(int(step), ckpt, scheduler_state):
        raise ValueError(f"{mgr.dir} already holds a step >= {step}")
    if stats is not None:
        mgr.save_stats(stats)
    return mgr.dir


def _jsonable(obj):
    """numpy-state dicts -> pure JSON (the reference's encoding)."""
    return json.loads(json.dumps(obj, default=_np_default))


def _np_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return {"__ndarray__": o.tolist(), "dtype": str(o.dtype)}
    raise TypeError(f"not jsonable: {type(o)}")


def _unjsonable(obj):
    if isinstance(obj, dict):
        if "__ndarray__" in obj:
            return np.array(obj["__ndarray__"], dtype=obj["dtype"])
        return {k: _unjsonable(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unjsonable(v) for v in obj]
    return obj
