"""What the port's accuracy studies share (sched_ablation, mode_gap,
bf16_eval, parity_bracket, diagnose_collapse, ema_recalib_probe): the
device they run on, and the lines each prints under a training run
before the script's own result line:

    K2 launches: N (gathers G: ...)       the run's K2 launches against the
                                          gathers it made (0 on the CPU)
    scale s: batch B, n steps, x ms/step  per bucket (Trainer.step_stats)
    K2 real batch B=.. s=.. ...: bitwise  K2 against its plain version on
                                          one batch of each bucket
    [device peak X GB; card]              the device's peak memory and the
                                          card's nvidia-smi name and power
                                          limit

The bucket check runs after the run on the run's own Trainer (its
resident tiles, its sampler) and gathers one sampled batch of each bucket
with the kernel and with the plain version."""

from __future__ import annotations

import sys
from typing import List, Optional

import torch

from dynseg_torch import cli
from dynseg_torch.ops import gather
from dynseg_torch.probes.int8_kernel_probe import card
from dynseg_torch.probes.stress_scale import check_gather, where
from dynseg_torch.train import Trainer, resolve_device


def open_device(name: str, prog: str) -> Optional[torch.device]:
    """`name` as a torch.device, or None after a message on stderr when it
    is cuda and no card is visible (the caller exits 1)."""
    try:
        dev = resolve_device(name)
    except RuntimeError as e:
        print(f"{prog}: {e}", file=sys.stderr)
        return None
    print(f"platform: {dev.type} ({card_of(dev)})", flush=True)
    return dev


def card_of(device: torch.device) -> str:
    return card() if device.type == "cuda" else "cpu"


def train(cfg, device: torch.device, log, **kw) -> dict:
    """cli.run_training on `device`, with K2's launches counted over the
    run and `report`'s lines printed after it (not after a preemption)."""
    evals = []

    def counting(*msg):
        line = " ".join(str(m) for m in msg)
        if line.startswith("[val @ iter") and " loss=" in line:
            evals.append(line)
        log(*msg)

    trainers = []
    gather.launches = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    scores = cli.run_training(cfg, log=counting, device=device,
                              on_trainer=trainers.append, **kw)
    if not scores.get("preempted"):
        report(cfg, scores, gather.launches, len(evals), trainers[0])
    return scores


def report(cfg, scores: dict, launches: int, evals: int, trainer: Trainer) -> None:
    """The lines of the module docstring for one finished run_training
    and its Trainer."""
    device = trainer.device
    name = card_of(device)
    k = cfg.train.steps_per_call
    steps = scores["train_steps"]
    trained = sum(st["steps"] for st in steps.values())
    recal = (cfg.train.ema_recalib_batches
             if cfg.train.ema_decay > 0 and cfg.model.use_batch_norm else 0)
    nscales = len(cfg.sched.values)
    gathers = nscales * k + trained + evals + recal
    print(f"    K2 launches: {launches} (gathers {gathers}: {nscales} x {k} warm-up + "
          f"{trained} steps + {evals} evals + {recal} recalibration; 0 on "
          f"the CPU, where the plain version runs)", flush=True)
    for size, st in steps.items():
        print(f"    scale {size}: batch {trainer.batch_size_for(size)}, {st['steps']} "
              f"steps, {st['ms_per_step']:.3f} ms/step, "
              f"{st['patches_per_s']:.1f} patches/s [{name}]", flush=True)
    print_gather_check(trainer)
    print(f"    [{where(device, name)}]", flush=True)


def print_gather_check(trainer: Trainer) -> List[tuple]:
    """K2 against its plain version on one batch of each of the trainer's
    buckets, a line each; returns (batch, size, bitwise equal) per bucket."""
    checks = check_gather(trainer)
    kind = "kernel" if trainer.device.type == "cuda" else "plain"
    for b, s, same in checks:
        print(f"    K2 real batch B={b} s={s} ({kind} vs plain): bitwise: {same}",
              flush=True)
    return checks
