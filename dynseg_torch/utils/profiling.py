"""Profiling and throughput metering (counterpart of dynseg/utils/profiling.py).

  * `trace(dir)`: a torch.profiler context (host, and the card's kernels
    where one is visible) that writes a chrome trace into `dir`; a no-op
    for None or "". Under data parallelism each rank writes its own file,
    with the rank in its name;
  * `Meter`: the reference's rolling patches/s or Mpx/s meter. Its first
    `add()` only starts the clock.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

from dynseg_torch import parallel


def trace_file(trace_dir: str) -> str:
    """The chrome trace `trace` writes: trace.json, or trace.rank<r>.json
    in a data-parallel group."""
    w = parallel.world()
    name = f"trace.rank{w.rank}.json" if w.grouped else "trace.json"
    return os.path.join(trace_dir, name)


@contextlib.contextmanager
def trace(trace_dir: Optional[str]) -> Iterator[None]:
    """torch.profiler trace into `trace_dir` if one is given, else no-op."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(trace_file(trace_dir))


class Meter:
    """Rolling throughput meter: count units (patches, pixels) between
    reads. The FIRST add() only starts the clock: its units were produced
    before timing began, and counting them against zero elapsed would
    inflate the early rate."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._units = 0
        self._t0: Optional[float] = None

    def add(self, units: int) -> None:
        if self._t0 is None:
            self._t0 = time.perf_counter()
            return
        self._units += units

    @property
    def rate(self) -> float:
        if self._t0 is None:
            return 0.0
        dt = time.perf_counter() - self._t0
        return self._units / dt if dt > 0 else 0.0
