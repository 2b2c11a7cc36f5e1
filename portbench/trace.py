"""Reading a torch.profiler trace of a short stretch on the card: device
busy time (the union of kernel, copy and set intervals), kernel time by
class, the longest idle gaps by what the host was doing, and the device
time of the port's own kernels.

`kernel_class` is chip_smoke.py's classifier, with the port's K2 and K4
named as well.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import time
from contextlib import contextmanager
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# Classes of the port's hand-written kernels (dynseg_torch/csrc).
KERNELS = ("K2", "K4", "K5")


def kernel_class(event: dict) -> str:
    """A device event's class in the summaries."""
    if event["cat"] != "kernel":
        return "copies"
    n = event["name"].lower()
    for cls, keys in (("K5", ("k5_",)), ("K2", ("patch_gather",)), ("K4", ("pool_bwd",)),
                      ("max-pool", ("max_pool",)), ("BN", ("bn_fw",)),
                      ("transposes", ("nchwtonhwc", "nhwctonchw")),
                      ("cuDNN conv", ("xmma", "implicit_gemm", "conv", "cudnn", "sm90_")),
                      ("softmax", ("softmax",)), ("fold", ("col2im", "im2col")),
                      ("sort (calibration)", ("radixsort", "sort")),
                      ("casts", ("copy_kernel",)), ("reductions", ("reduce",)),
                      ("elementwise", ("elementwise",))):
        if any(k in n for k in keys):
            return cls
    return "other"


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize(events: List[dict], t0_us: float, t1_us: float) -> dict:
    """The summary of a trace's events (chrome-trace dicts, times in us)
    over the host-clock stretch [t0_us, t1_us]."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    busy = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev])
    busy_s = sum(b - a for a, b in busy) / 1e6
    by_class: Dict[str, float] = collections.Counter()
    by_kernel: Dict[str, float] = collections.Counter()
    launches: Dict[str, int] = collections.Counter()
    for e in dev:
        cls = kernel_class(e)
        by_class[cls] += e["dur"] / 1e6
        if cls in KERNELS:
            by_kernel[cls] += e["dur"] / 1e6
            launches[cls] += 1
    # Idle gaps between device intervals, named by the innermost host
    # operation running at the gap's start.
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                  for e in events if e.get("cat") in ("cpu_op", "user_annotation",
                                                      "python_function")
                  and "dur" in e)
    starts = [h[0] for h in host]
    edges = [t0_us] + [x for iv in busy for x in iv] + [t1_us]
    gaps: Dict[str, float] = collections.Counter()
    for a, b in zip(edges[0::2], edges[1::2]):
        if b - a <= 0:
            continue
        # Nested host operations: the innermost one running at `a` is the
        # latest-started that has not ended.
        name = "(no host op)"
        i = bisect.bisect_right(starts, a) - 1
        for j in range(i, max(-1, i - 4000), -1):
            if host[j][1] >= a:
                name = host[j][2]
                break
        gaps[name[:80]] += (b - a) / 1e6
    window_s = (t1_us - t0_us) / 1e6
    return {"busy_s": busy_s, "window_s": window_s,
            "device_ops": [[k, v] for k, v in by_class.most_common(10)],
            "idle_gaps": [[k, v] for k, v in gaps.most_common(10)],
            "kernel_s": dict(by_kernel), "kernel_launches": dict(launches)}


@contextmanager
def profiled(tmpdir: str, out: dict):
    """torch.profiler (CPU and CUDA) over the body; on exit `out` holds the
    summary of the stretch. The chrome trace is written to `tmpdir` and
    removed once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("portbench.stretch"):
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            span = time.perf_counter() - t0
    path = os.path.join(tmpdir, "portbench_trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    marks = [e for e in events if e.get("name") == "portbench.stretch" and "dur" in e]
    if marks:
        t0_us, t1_us = float(marks[0]["ts"]), float(marks[0]["ts"]) + float(marks[0]["dur"])
    else:
        t0_us = min(float(e["ts"]) for e in events if "ts" in e)
        t1_us = t0_us + span * 1e6
    out.update(summarize([e for e in events if e.get("name") != "portbench.stretch"],
                         t0_us, t1_us))
