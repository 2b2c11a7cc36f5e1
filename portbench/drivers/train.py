"""Driver of the training mixes: `train.train_loop` -> `scheduler.select`
-> `Trainer.train_step`, closed loop, as users run training.

Set-up makes the training tiles and the weights from the seed on the
device, builds one Trainer and one TrainState, warms every patch size
(`compile_buckets`), and drives that state through its first steps by the
window's own call (`train_loop`), recording what they were fed and
produced. The window goes on from there with the same objects for
--seconds; it is ended by the signal the loop honours (checkpoint at the
step boundary), and closes on `torch.cuda.synchronize()`.

The comparison: the plain reference takes the same weights, the raw
tiles and the positions and augment ids the sampler drew for the first
steps, and follows those steps; compared are each step's loss, the
first step's update direction (the optimizer's momentum after one step)
and the params' change after the last checked step, by the worst leaf.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Dict

import numpy as np
import torch

from portbench import synth
from portbench.reference import train as ref_train


def config(r):
    from dynseg_torch.config import (Config, DataConfig, ModelConfig,
                                     SchedulerConfig, TrainConfig)

    m, x = r.config["model"], r.mix
    return Config(
        model=ModelConfig(net_type=m["net_type"], num_classes=m["num_classes"],
                          num_input_bands=m["num_input_bands"],
                          width_multiplier=m.get("width_multiplier", 1.0),
                          compute_dtype=m["compute_dtype"],
                          pool_backward=x["pool_backward"]),
        sched=SchedulerConfig(distribution_type=x["distribution_type"],
                              values=tuple(x["values"]), update_type=x["update_type"]),
        train=TrainConfig(learning_rate=x["learning_rate"], momentum=x["momentum"],
                          weight_decay=x["weight_decay"], batch_size=x["batch_size"],
                          seed=r.seed, eval_every=0, checkpoint_every=0,
                          output_path=os.path.join(r.tmpdir, "portbench_out")),
        data=DataConfig(balanced_sampling=x["balanced_sampling"], augment=x["augment"],
                        max_positions_per_class=x["max_positions_per_class"]),
    ).validate()


def _timed_loop(cfg, trainer, state, sched, seconds: float) -> float:
    """train_loop until `seconds` have passed; the loop stops at the next
    step boundary on SIGINT, drains its metrics and calls the
    checkpointer. Returns the wall seconds, synchronised."""
    from dynseg_torch.train import train_loop

    stop: Dict[str, int] = {}
    timer = threading.Timer(seconds, os.kill, (os.getpid(), signal.SIGINT))
    t0 = time.perf_counter()
    timer.start()
    try:
        train_loop(cfg, trainer, state, sched, niter=2 ** 62, log_every=0,
                   log=lambda *a: None,
                   checkpointer=lambda it, st, sc: stop.setdefault("it", it))
        if trainer.device.type == "cuda":
            torch.cuda.synchronize()
    finally:
        timer.cancel()
    return time.perf_counter() - t0


def _steps(trainer) -> Dict[int, int]:
    return {s: v["steps"] for s, v in trainer.step_stats().items()}


def _diff(after: Dict[int, int], before: Dict[int, int]) -> Dict[int, int]:
    return {s: n - before.get(s, 0) for s, n in after.items() if n - before.get(s, 0)}


def px_of(trainer, steps: Dict[int, int]) -> int:
    return sum(n * trainer.batch_size_for(s) * s * s for s, n in steps.items())


def first_steps(cfg, trainer, state, sched, n: int) -> dict:
    """n steps through train_loop, recording each step's batch inputs and
    loss, the momentum after the first and the params after the last."""
    from dynseg_torch.train import train_loop

    fed, losses, snap = [], [], {}
    draw, step = trainer.global_batch_inputs, trainer.train_step

    def spy_draw(size, augment=None, k=1):
        pos, aug = draw(size, augment, k)
        fed.append((size, pos[0].copy(), aug[0].copy()))
        return pos, aug

    def spy_step(st, size):
        st, metrics = step(st, size)
        losses.append(metrics["loss"].detach().clone())
        if len(losses) == 1:
            # A parameter the step left without momentum moved by nothing.
            snap["m1"] = {name: st.optimizer.state.get(p, {}).get(
                "momentum_buffer", torch.zeros_like(p)).detach().clone()
                for name, p in st.model.named_parameters()}
        return st, metrics

    trainer.global_batch_inputs, trainer.train_step = spy_draw, spy_step
    try:
        train_loop(cfg, trainer, state, sched, niter=n, log_every=0, log=lambda *a: None)
    finally:
        del trainer.global_batch_inputs, trainer.train_step
    return {"fed": fed, "losses": [float(v) for v in losses],
            "m1": {k: v.cpu() for k, v in snap["m1"].items()},
            "params": {k: v.detach().cpu().clone() for k, v in state.model.named_parameters()}}


def left_out(ref: dict):
    """Leaves whose reference gradient is under a thousandth of the median
    leaf's: they move by round-off alone."""
    g = {k: float(v.double().norm()) for k, v in ref["m1"].items()}
    med = float(np.median(list(g.values())))
    return sorted(k for k, v in g.items() if v < 1e-3 * med)


def gaps(prog: dict, ref: dict, p0: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The numbers compared: the worst step's relative loss gap; by the
    worst leaf, the gap between the norms of the first update direction,
    and of the params' change, each against the larger of the leaf's
    reference norm and the median leaf's. Leaves whose reference gradient
    is under a thousandth of the median leaf's move by round-off alone and
    are left out of the change."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    names = sorted(ref["m1"])
    g_ref = {k: float(ref["m1"][k].double().norm()) for k in names}
    g_med = float(np.median(list(g_ref.values())))
    grad = max(abs(float(prog["m1"][k].double().norm()) - g_ref[k]) / max(g_ref[k], g_med)
               for k in names)
    moved = [k for k in names if k not in left_out(ref)]
    d_ref = {k: float((ref["params"][k].double() - p0[k].double()).norm()) for k in moved}
    d_med = float(np.median(list(d_ref.values())))
    change = max(abs(float((prog["params"][k].double() - p0[k].double()).norm()) - d_ref[k])
                 / max(d_ref[k], d_med) for k in moved)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def reference_steps(r, cpu_weights, fed, images, masks, hw, mean, std, pad, tf32=False,
                    half=False):
    """The plain reference over the batches the program was fed."""
    dev = r.device
    x = r.mix
    params0 = {k: v.to(dev) for k, v in cpu_weights.items()}
    m = torch.as_tensor(mean, device=dev)
    s = torch.as_tensor(std, device=dev)
    batches = []
    for size, pos, aug in fed:
        if half:
            pos, aug = pos[:len(pos) // 2], aug[:len(aug) // 2]
        batches.append(ref_train.cut_batch(images, masks, hw, m, s, pos, aug, size, pad))
    out = ref_train.train_steps(params0, batches, r.net,
                                x["learning_rate"], x["momentum"], x["weight_decay"],
                                tf32=tf32)
    return {"losses": out["losses"], "m1": {k: v.cpu() for k, v in out["m1"].items()},
            "params": {k: v.cpu() for k, v in out["params"].items()}}


def run(r) -> None:
    from dynseg_torch.data.tiles import pack_tiles
    from dynseg_torch.ops import gather as k2
    from dynseg_torch.ops import pool as k4
    from dynseg_torch.sched.scheduler import ScaleScheduler
    from dynseg_torch.train import Trainer

    data = r.config["data"]
    cfg = config(r)
    dev = torch.device(r.device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    images, masks = synth.make_tiles(data, "train", r.seed, dev)
    mean, std = synth.stats(images)
    tiles = pack_tiles([im.cpu().numpy().astype(np.float32) for im in images],
                       [mk.cpu().numpy().astype(np.int32) for mk in masks])
    tiles.mean, tiles.std = mean, std
    weights = synth.make_weights(r.net, r.seed, dev)
    trainables = {k: v.cpu().clone() for k, v in weights.items() if ".running_" not in k}
    trainer = Trainer(cfg, tiles, dev)
    state = trainer.init_state(variables=synth.flax_tree(weights, r.net))
    del weights, tiles
    r.program["setup_host_s"] = dict(trainer.setup_s)
    trainer.compile_buckets(state)
    # The scheduler draws from one fixed stream, so that the window's mix
    # of patch sizes (and with it its work) does not move with the seed.
    sched = ScaleScheduler(cfg.sched, seed=r.mix["scheduler_seed"])
    prog = first_steps(cfg, trainer, state, sched, r.mix["checked_steps"])
    r.setup_done()

    before = _steps(trainer)
    wall = _timed_loop(cfg, trainer, state, sched, r.seconds)
    window = _diff(_steps(trainer), before)
    r.window = {"seconds": wall, "steps": window, "px": px_of(trainer, window),
                "batch": {s: trainer.batch_size_for(s) for s in window}}
    r.e2e["train_Mpx_s"] = r.window["px"] / wall / 1e6
    r.attempted = sum(window.values())
    r.read_memory_peak()
    stats = trainer.step_stats()
    print("step_stats " + " ".join(
        f"{s}px:{v['steps']}steps,{v['ms_per_step']:.4f}ms/step,{v['patches_per_s']:.1f}patches/s"
        for s, v in stats.items()), flush=True)
    print(f"setup_host_s {r.program['setup_host_s']}", flush=True)

    if r.trace:
        k2.launches = 0
        k4.reset_launches()
        before = _steps(trainer)
        with r.profiled():
            wall_t = _timed_loop(cfg, trainer, state, sched, r.mix["trace_seconds"])
        steps = _diff(_steps(trainer), before)
        r.stretch = {"seconds": wall_t, "steps": steps,
                     "batch": {s: trainer.batch_size_for(s) for s in steps}}
        r.program["k2_launches"] = k2.launches
        r.program["k4_launches"] = k4.launches
        print(f"stretch steps {steps} K2 launches {k2.launches} K4 launches "
              f"{k4.launches} {dict(k4.variant_launches)}", flush=True)

    # The window is closed: free the program's state, then the reference.
    del trainer, state, sched
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    hw = [tuple(im.shape[:2]) for im in images]
    ref = reference_steps(r, trainables, prog["fed"], images, masks, hw, mean, std,
                          max(r.mix["values"]) // 2 + 1)
    r.numbers = gaps(prog, ref, trainables)
    print(f"numbers {r.numbers} left_out {left_out(ref)}", flush=True)
