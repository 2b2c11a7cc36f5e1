"""Data parallelism over torch.distributed (counterpart of the reference's
1-D device mesh over axis "data": dynseg/train.py Trainer.__init__,
dynseg/cli.py run_testing).

The reference jits the single-device step with a sharded batch, so its
N-device step IS the one-device step on the global batch. The port keeps
that meaning with N processes, one rank each:

  * `spawn(fn, n, devices, backend)` starts n ranks with the `spawn` start
    method, joined by a TCP rendezvous on 127.0.0.1 at a port the OS picks
    (a TCPStore held by the launcher), each with a process group created
    with a timeout. A rank that fails ends the group: the others are
    stopped and `spawn` raises. SIGTERM and SIGINT sent to the launcher are
    passed on to every rank, which drain at the same step boundary.
  * `world()` is this process's rank, size, device and backend; size 1
    with no backend is the plain single-process path, with no collective.
  * Collectives are `all_reduce` (sum) and `broadcast` only: NCCL and gloo
    both support them on CUDA tensors, and gloo has no CUDA all_gather.
    `all_reduce_sum` is differentiable (its backward all-reduces the
    gradient: BatchNorm's global statistics), `all_reduce_grads` sums the
    parameters' gradients in one flat buffer, and `gather_rows` gives every
    rank the concatenation of the ranks' equal slices of a batch by an
    all-reduce over a zero buffer, which adding zeros keeps exact.
  * Decisions that steer control flow (the next scale, a stop) are taken
    once on the host (`agree`) and are the same on every rank; under NCCL
    they travel over a gloo group of their own, so that no decision waits
    for the card's stream.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import signal
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# How long a rendezvous or a collective may wait for a peer before the
# group fails (a rank that died or hangs ends the run instead of holding
# the others).
TIMEOUT = datetime.timedelta(seconds=300)


@dataclasses.dataclass(frozen=True)
class World:
    """One rank of a data-parallel group: rank, size, its device and the
    process group's backend (None: no group, the single-process path)."""

    rank: int = 0
    size: int = 1
    device: str = "cpu"
    backend: Optional[str] = None

    @property
    def grouped(self) -> bool:
        return self.backend is not None

    @property
    def is_main(self) -> bool:
        return self.rank == 0


_WORLD = World()
_CONTROL = None  # the host group of `agree` under NCCL (None: the default group)


def world() -> World:
    """This process's World (the single-process one outside `spawn`)."""
    return _WORLD


def grouped() -> bool:
    return _WORLD.grouped


def is_main() -> bool:
    return _WORLD.is_main


def check_devices(n: int, device: str) -> List[str]:
    """The devices of n ranks of the command line: rank r on cuda:r, or n
    CPU ranks. More ranks than visible cards raise before any process
    starts, as the reference refuses a mesh larger than its devices."""
    if torch.device(device).type == "cuda":
        avail = torch.cuda.device_count()
        if n > avail:
            raise ValueError(
                f"--num_devices {n} requested but only {avail} CUDA "
                f"device(s) are visible")
        return [f"cuda:{r}" for r in range(n)]
    return ["cpu"] * n


def backend_for(devices: Sequence[str]) -> str:
    """NCCL for one rank per card, gloo otherwise (CPU ranks, or ranks
    that share a card, which NCCL refuses)."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len(set(devices)) == len(devs):
        return "nccl"
    return "gloo"


# --------------------------------------------------------------------- #
# the launcher
# --------------------------------------------------------------------- #
def spawn(fn: Callable[..., Any], n: int, devices: Sequence[str],
          backend: Optional[str] = None, args: Tuple = (),
          threads: Optional[int] = None) -> List[Any]:
    """Run fn(*args) on n ranks (rank r on devices[r]) in a process group
    of `backend` (default `backend_for(devices)`); returns the ranks'
    return values by rank, which must pickle (numpy, CPU tensors). `fn`
    must be importable by name (a module-level function). `threads` sets
    each rank's torch intra-op threads. A rank that raises or dies stops
    the others, and `spawn` raises torch's ProcessRaisedException or
    ProcessExitedException naming it."""
    import torch.multiprocessing as mp

    devices = [str(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"{n} ranks but {len(devices)} devices: {devices}")
    backend = backend or backend_for(devices)
    store = dist.TCPStore("127.0.0.1", 0, n + 1, is_master=True,
                          wait_for_workers=False, timeout=TIMEOUT)
    results = mp.get_context("spawn").SimpleQueue()
    # The work goes by value: torch's pickler would move the caller's CPU
    # tensors into shared memory in place.
    work = pickle.dumps((fn, args))
    ctx = mp.start_processes(
        _rank_main, args=(n, devices, backend, store.port, threads, results, work),
        nprocs=n, join=False, start_method="spawn")

    def forward(signum, frame):
        for p in ctx.processes:
            if p.is_alive():
                os.kill(p.pid, signum)

    prev = {}
    for s in (signal.SIGTERM, signal.SIGINT):
        try:
            prev[s] = signal.signal(s, forward)
        except ValueError:  # not the main thread
            pass
    out = {}

    def drain():
        while not results.empty():
            rank, value = results.get()
            out[rank] = pickle.loads(value)

    try:
        while not ctx.join(timeout=0.2, grace_period=2.0):
            drain()
        drain()
    finally:
        for s, h in prev.items():
            signal.signal(s, h)
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        del store
    missing = [r for r in range(n) if r not in out]
    if missing:
        raise RuntimeError(f"ranks {missing} exited without a result")
    return [out[r] for r in range(n)]


def _rank_main(rank: int, n: int, devices: List[str], backend: str, port: int,
               threads: Optional[int], results, work: bytes) -> None:
    """A spawned rank: join the group, set the World, run fn, put its
    result, leave the group."""
    global _WORLD, _CONTROL
    if threads:
        torch.set_num_threads(threads)
    # Every rank lives on this host: gloo's sockets stay on the loopback.
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    store = dist.TCPStore("127.0.0.1", port, n + 1, is_master=False,
                          timeout=TIMEOUT)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n,
                            timeout=TIMEOUT)
    try:
        _CONTROL = dist.new_group(backend="gloo") if backend == "nccl" else None
        _WORLD = World(rank, n, str(device), backend)
        fn, args = pickle.loads(work)
        # By value: torch's queue would pass tensors by shared file
        # descriptors, which die with this process.
        results.put((rank, pickle.dumps(fn(*args))))
    finally:
        _WORLD, _CONTROL = World(), None
        dist.destroy_process_group()


# --------------------------------------------------------------------- #
# collectives
# --------------------------------------------------------------------- #
class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the gradient of every rank's input is the sum
    of the ranks' output gradients."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The ranks' sum of x, differentiable; x itself outside a group."""
    return _AllReduceSum.apply(x) if grouped() else x


def all_reduce_(x: torch.Tensor) -> torch.Tensor:
    """Sum x over the ranks in place (no autograd); returns x."""
    if grouped():
        dist.all_reduce(x)
    return x


def all_reduce_grads(params) -> None:
    """Sum the parameters' gradients over the ranks, in one flat
    all-reduce (the parameters' order is the model's, the same on every
    rank)."""
    if not grouped():
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    o = 0
    for g in grads:
        g.copy_(flat[o:o + g.numel()].view(g.shape))
        o += g.numel()


def gather_rows(local: torch.Tensor) -> torch.Tensor:
    """The ranks' equal slices of a batch, concatenated in rank order on
    every rank: each rank writes its rows into a zero buffer and the
    buffers are summed, so every rank gets the rows bitwise."""
    if not grouped():
        return local
    w = _WORLD
    b = local.shape[0]
    buf = local.new_zeros((w.size * b,) + tuple(local.shape[1:]))
    buf[w.rank * b:(w.rank + 1) * b] = local
    dist.all_reduce(buf)
    return buf


def agree(stop: bool, choice: int = 0) -> Tuple[bool, int]:
    """One decision for all ranks, on the host: whether any rank stops,
    and rank 0's `choice`. Outside a group: (stop, choice)."""
    if not grouped():
        return stop, choice
    t = torch.tensor([int(bool(stop)), int(choice) if is_main() else 0],
                     dtype=torch.int64)
    dist.all_reduce(t, group=_CONTROL)
    return bool(t[0]), int(t[1])


def broadcast_choice(choice: int) -> int:
    """Rank 0's `choice` on every rank (a host broadcast)."""
    if not grouped():
        return choice
    t = torch.tensor([int(choice)], dtype=torch.int64)
    dist.broadcast(t, src=0, group=_CONTROL)
    return int(t[0])


def barrier() -> None:
    """Wait for every rank (an all-reduce on the host group)."""
    agree(False)
