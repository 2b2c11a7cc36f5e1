"""Profiling: the port's spans and its torch.profiler traces (counterpart
of dynseg/utils/profiling.py).

  * `span(name)`: a context manager around one stretch of the program at
    a layer boundary (`train.*`, `infer.*`, `serve.*`). Every span adds
    to in-memory totals per name: calls, total seconds, and self seconds
    (the total less what child spans on the same thread covered). Each
    thread keeps its own stack of open spans, so spans of concurrent
    threads never nest into each other. With no profiler running a span
    reads the host clock twice and updates one dict entry: no CUDA call,
    no event, no sync. While a torch.profiler runs (`trace`, or the
    benchmark's traced stretch) a span also opens a `record_function`
    range of its name, so it lands in the same trace as the card's
    kernels and copies, on their clock;
  * `totals()` (a copy) and `reset()`;
  * `trace(dir)`: a torch.profiler context (host, and the card's kernels
    where one is visible) that writes a chrome trace into `dir`; a no-op
    for None or "". Under data parallelism each rank writes its own file,
    with the rank in its name.
"""

from __future__ import annotations

import contextlib
import os
import threading
from time import perf_counter_ns
from typing import Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

from dynseg_torch import parallel

_lock = threading.Lock()
# name -> [calls, total ns, self ns]
_totals: Dict[str, List[int]] = {}
_local = threading.local()


class span:
    """`with span("infer.index"): ...` adds the body's time to the totals
    of "infer.index". After the body, `.seconds` is its wall time."""

    __slots__ = ("name", "seconds", "_t0", "_child_ns", "_range", "_stack")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0

    def __enter__(self) -> "span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self._stack = stack
        self._child_ns = 0
        # A plain bool the profiler sets while it runs: record_function
        # costs microseconds even with no profiler, so it is opened only
        # when a trace will hold it.
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        else:
            self._range = None
        stack.append(self)
        self._t0 = perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        dt = perf_counter_ns() - self._t0
        stack = self._stack
        stack.pop()
        if stack:
            stack[-1]._child_ns += dt
        own = dt - self._child_ns
        with _lock:
            t = _totals.get(self.name)
            if t is None:
                _totals[self.name] = [1, dt, own]
            else:
                t[0] += 1
                t[1] += dt
                t[2] += own
        self.seconds = dt / 1e9
        if self._range is not None:
            self._range.__exit__(None, None, None)


def totals() -> Dict[str, Dict[str, float]]:
    """A copy of the totals: {name: {"calls", "seconds", "self_seconds"}}."""
    with _lock:
        items = [(k, list(v)) for k, v in _totals.items()]
    return {k: {"calls": c, "seconds": t / 1e9, "self_seconds": s / 1e9}
            for k, (c, t, s) in items}


def reset() -> None:
    """Forget every total (spans open now still add theirs when they end)."""
    with _lock:
        _totals.clear()


def trace_file(trace_dir: str) -> str:
    """The chrome trace `trace` writes: trace.json, or trace.rank<r>.json
    in a data-parallel group."""
    w = parallel.world()
    name = f"trace.rank{w.rank}.json" if w.grouped else "trace.json"
    return os.path.join(trace_dir, name)


@contextlib.contextmanager
def trace(trace_dir: Optional[str]) -> Iterator[None]:
    """torch.profiler trace into `trace_dir` if one is given, else no-op.
    The trace holds the spans the program opened meanwhile."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(trace_file(trace_dir))
