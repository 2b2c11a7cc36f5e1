"""How long does K2, the patch gather, take on the card, and how much of an
eager call is the host's? Times `gather_batch` four ways at B patches of
s^2 from uint8 tiles, for each s:

  eager     CUDA events around `reps` calls: the call rate, which the
            host's cost per call (wrapper and launch) bounds when the
            kernel is short;
  graph     20 calls captured in a CUDA graph and replayed between CUDA
            events: the device time, without the host;
  profiler  the kernel's own duration in a torch.profiler trace;
  host      the host's wall time per call, without synchronising.

    python dynseg_torch/probes/gather_timing.py [--root DIR] [--batch 100]
        [--sizes 25,35,45,55,65] [--reps 50]

--root times the `dynseg_torch` package found in DIR (for example a
`git archive` of an earlier commit), so that two versions of the kernel
are timed in one call on one card; the default is this checkout. Each
line names the package's directory, and the first the card. Needs a CUDA
card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from typing import List, Optional

import numpy as np
import torch


def _events_ms(fn, reps: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(fn, calls: int = 20, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return _events_ms(graph.replay, reps) / calls


def _profiler_ms(fn, reps: int = 20) -> float:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type.name == "CUDA" and "gather" in e.name]
    # The trace can drop an event of a long run; average over those it kept.
    if not kernels:
        raise RuntimeError("no gather kernel in the trace")
    return sum(e.device_time for e in kernels) / 1e3 / len(kernels)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="directory whose dynseg_torch package is timed")
    ap.add_argument("--batch", type=int, default=100)
    ap.add_argument("--sizes", default="25,35,45,55,65")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gather_timing: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    root = os.path.abspath(args.root or here)
    sys.path.insert(0, root)
    from dynseg_torch.ops import _build, gather

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(gather.__file__)))
    if not pkg.startswith(root):
        raise SystemExit(f"--root {root}: dynseg_torch was imported from {pkg} "
                         f"(run this file by its path, not with -m)")
    _build.load_library()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    t_n, h, w, c = 4, 600, 600, 3
    images = torch.from_numpy(rng.integers(0, 256, (t_n, h, w, c), dtype=np.uint8)).to(dev)
    masks = torch.from_numpy(rng.integers(0, 2, (t_n, h, w), dtype=np.uint8)).to(dev)
    mean = torch.tensor([120.0, 110.5, 99.25], device=dev)
    std = torch.tensor([40.0, 37.3, 51.7], device=dev)
    b = args.batch
    for s in map(int, args.sizes.split(",")):
        pos = np.stack([rng.integers(0, t_n, b), rng.integers(s, h - s, b),
                        rng.integers(s, w - s, b)], 1)
        call = (images, masks, mean, std, torch.from_numpy(pos.astype(np.int32)).to(dev),
                torch.from_numpy((np.arange(b) % 8).astype(np.int32)).to(dev))

        def fn():
            return gather.gather_batch(*call, s)

        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            fn()
        host = (time.perf_counter() - t0) / args.reps * 1e3
        torch.cuda.synchronize()
        print(f"{pkg} K2 B={b} s={s}: eager {_events_ms(fn, args.reps):.4f} ms, "
              f"graph {_graph_ms(fn):.4f} ms, profiler {_profiler_ms(fn):.4f} ms, "
              f"host {host:.4f} ms per call", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
