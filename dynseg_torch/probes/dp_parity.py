"""Work for the ranks of a data-parallel parity check: the same function
runs in one process (the single-device reference, no group) and on each
rank of `parallel.spawn`, and returns what the two are compared with.

  * `train_steps`: a Trainer on the given config and tiles, the given
    variables, one step per entry of `sizes` on the global batches given
    (or sampled by the trainer, as `Trainer.global_batch_inputs` draws
    them); returns the losses, the state after each step and the final
    state with its momentum on the CPU, the global
    batches with tile ids into the unsharded set (so that one device can
    replay them), each step's time, and this rank's K2/K4 launches beside
    the gathers and pool backwards it ran;
  * `recalibrate`, `loop_scales`, `restore`: Trainer.recalibrate_batch_stats,
    the scales a train_loop chose, a restored checkpoint;
  * `predict`: an Inferencer on the given tiles (int8-calibrated under
    quant int8), labels and probabilities of every tile in the config's
    mode; returns them with the quantized state_dict, this rank's forwards,
    its wall time and its K5 launches (the count set to 0 after the
    calibration).

With `collective_stats`, each all-reduce is timed alone (the device
synchronised and the ranks met at a host barrier before it, the device
synchronised after) and counted: the share of a step the collectives
take. Used by tests/test_torch_parallel_train.py,
tests/test_torch_parallel_infer.py and chip_smoke.py phase 18.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dynseg_torch import parallel
from dynseg_torch.config import Config
from dynseg_torch.data.tiles import TileSet
from dynseg_torch.models.dilated import arch
from dynseg_torch.ops import gather, int8_conv, pool


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _CollectiveClock:
    """Wraps dist.all_reduce: each call timed alone and counted."""

    def __init__(self, device: torch.device):
        self.device, self.calls, self.seconds = device, 0, 0.0
        self._orig = dist.all_reduce

    def __enter__(self):
        def timed(*args, **kw):
            # The card idle and every rank arrived: the time is the
            # collective's own, not a wait for a slower rank.
            _sync(self.device)
            dist.all_reduce = self._orig
            try:
                parallel.barrier()
            finally:
                dist.all_reduce = timed
            t0 = time.perf_counter()
            out = self._orig(*args, **kw)
            _sync(self.device)
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out

        dist.all_reduce = timed
        return self

    def __exit__(self, *exc):
        dist.all_reduce = self._orig


def _cpu(sd: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Copies: a CPU tensor's numpy view would follow later changes."""
    return {k: v.detach().cpu().numpy().copy() for k, v in sd.items()}


def run_many(calls: Sequence[Tuple]) -> list:
    """Several of these functions in one launch of the ranks, in order:
    each call (fn, args) or (fn, args, kwargs)."""
    return [c[0](*c[1], **(c[2] if len(c) > 2 else {})) for c in calls]


def train_steps(cfg: Config, tiles: TileSet, variables: dict,
                sizes: Sequence[int], batches: Optional[List] = None,
                collective_stats: bool = False,
                save_to: Optional[str] = None, warm_up: bool = False,
                device: Optional[str] = None) -> dict:
    """One step per size; `batches` (global (positions, aug_ids) per step,
    tile ids into the unsharded set) default to the trainer's own
    sampling (always under shard_tiles). With `warm_up`, the trainer's
    compile_buckets runs first (its launches are not counted); with
    `save_to`, the state is then checkpointed there (rank 0 writes). Runs
    on `device` (default: this process's World's); the K2/K4 counts are
    set to 0 before the steps and read after them."""
    from dynseg_torch.train import Trainer, _index_tensor

    t = Trainer(cfg, tiles, device=device or parallel.world().device)
    st = t.init_state(variables=variables)
    pools = sum(1 for *_, p in arch(cfg.model) if p)
    out = {"losses": [], "accs": [], "ms": [], "batches": [], "states": [],
           "k2": 0, "k4": 0, "gathers": 0, "pool_bwds": 0,
           "collective_calls": 0, "collective_ms": []}
    if warm_up:
        t.compile_buckets(st)
    gather.launches = 0
    pool.reset_launches()
    for i, size in enumerate(sizes):
        if batches is None:
            pos, aug = (a[0] for a in t.global_batch_inputs(size))
        elif t.shard_tiles:
            raise ValueError("under shard_tiles the ranks sample their batches")
        else:
            pos, aug = batches[i]
        mine = t.local_rows(len(pos))
        clock = _CollectiveClock(t.device) if collective_stats else None
        _sync(t.device)
        t0 = time.perf_counter()
        if clock is not None:
            with clock:
                m = t._step_impl(st, _index_tensor(pos[mine], t.device),
                                 _index_tensor(aug[mine], t.device), size)
        else:
            m = t._step_impl(st, _index_tensor(pos[mine], t.device),
                             _index_tensor(aug[mine], t.device), size)
        _sync(t.device)
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        if clock is not None:
            out["collective_calls"] += clock.calls
            out["collective_ms"].append(clock.seconds * 1e3)
        out["gathers"] += 1
        out["pool_bwds"] += pools
        out["losses"].append(float(m["loss"]))
        out["accs"].append(float(m["acc"]))
        out["batches"].append((t.unsharded_positions(pos), aug))
        out["states"].append(_cpu(st.model.state_dict()))
    out["k2"], out["k4"] = gather.launches, pool.launches
    out["k4_fused"] = pool.variant_launches["fused"]
    if save_to:
        from dynseg_torch.checkpoint import CheckpointManager
        from dynseg_torch.sched.scheduler import ScaleScheduler

        CheckpointManager(save_to).save(
            st.step, st, ScaleScheduler(cfg.sched, seed=cfg.train.seed))
    return dict(out, **_state(st))


def _state(st) -> dict:
    from dynseg_torch.train import checkpoint_dict

    ckpt = checkpoint_dict(st)
    return {"state": _cpu(ckpt["model"]), "momentum": _cpu(ckpt["momentum"]),
            "step": ckpt["step"]}


def restore(cfg: Config, output_path: str) -> dict:
    """The latest checkpoint under output_path, restored on this rank."""
    from dynseg_torch.checkpoint import CheckpointManager
    from dynseg_torch.train import init_state_template

    st, _ = CheckpointManager(output_path).restore_state(
        init_state_template(cfg, parallel.world().device))
    return _state(st)


def recalibrate(cfg: Config, tiles: TileSet, variables: dict,
                n_batches: int) -> Dict[str, np.ndarray]:
    """Trainer.recalibrate_batch_stats of the Flax-shaped `variables` over
    n_batches sampled batches; the new state_dict on the CPU."""
    from dynseg_torch.bridge import flax_to_torch
    from dynseg_torch.train import Trainer

    t = Trainer(cfg, tiles, device=parallel.world().device)
    sd = {k: v.to(t.device) for k, v in flax_to_torch(variables).items()}
    return _cpu(t.recalibrate_batch_stats(sd, n_batches))


def loop_scales(cfg: Config, tiles: TileSet, variables: dict) -> dict:
    """train_loop for cfg.train.niter steps: the scales it trained, in
    order, and the final state."""
    from dynseg_torch.sched.scheduler import ScaleScheduler
    from dynseg_torch.train import Trainer, train_loop

    t = Trainer(cfg, tiles, device=parallel.world().device)
    st = t.init_state(variables=variables)
    sched = ScaleScheduler(cfg.sched, seed=cfg.train.seed)
    scales = []
    select = sched.select

    def recorded():
        scales.append(select())
        return scales[-1]

    sched.select = recorded
    st = train_loop(cfg, t, st, sched, log=lambda *_: None)
    return dict(_state(st), scales=scales)


def predict(cfg: Config, tiles: TileSet, variables: Dict[str, torch.Tensor],
            device: Optional[str] = None) -> dict:
    """Labels and probabilities of every tile (cfg.infer.mode, block and
    halo), int8-calibrated under quant int8, on `device` (default: this
    process's World's)."""
    from dynseg_torch.infer import Inferencer

    inf = Inferencer(cfg, tiles, device=device or parallel.world().device)
    variables = {k: v.to(inf.device) for k, v in variables.items()}
    variables = inf.enable_quant(variables)
    forwards = [0]
    probs_fn = inf._probs

    def counted(*args, **kw):
        forwards[0] += 1
        return probs_fn(*args, **kw)

    inf._probs = counted
    int8_conv.reset_launches()
    icfg = cfg.infer
    _sync(inf.device)
    t0 = time.perf_counter()
    labels, probs = [], []
    for i in range(tiles.num_tiles):
        if icfg.mode == "dense":
            lab, p = inf.predict_tile_dense(variables, i, icfg.dense_block,
                                            icfg.dense_halo)
        else:
            lab, p = inf.predict_tile(variables, i)
        labels.append(lab)
        probs.append(p)
    _sync(inf.device)
    return {"labels": labels, "probs": probs, "forwards": forwards[0],
            "wall_s": time.perf_counter() - t0,
            "k5": int8_conv.launches,
            "k5_wgmma": int8_conv.variant_launches["wgmma"],
            "qvars": _cpu(variables) if icfg.quant != "none" else None}
