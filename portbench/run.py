"""Run one cell of BENCHMARK.json and print its result line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (configs/<config>.json), whose `model`
states the net (its blocks, wiring and multiply-adds a pixel, which must
agree), and a traffic mix (mixes/<traffic>.json); the mix names its
driver (drivers/<driver>.py), which sets the port up from the seed, warms
every shape it will use, measures for --seconds and hands back what the
timed path produced. With --trace 1 the driver also runs a short profiled
stretch after the window, and the per-layer metrics are read by their
readers (metrics/<metric>.py). Then the driver's comparison with the plain
reference is judged against limits/<cell>.json.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device, with --trace 1 breakdown, and last the numbers
compared with their limits (also the last lines of standard error).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

from portbench import counts  # noqa: E402

HERE = Path(__file__).resolve().parent
# Top-level module names that may not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "dynseg")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module of its own file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


class Run:
    """One run of one cell: what the driver is given, and what it and the
    readers leave for the result line."""

    def __init__(self, root: Path, workload: str, seed: int, seconds: float,
                 trace: bool, device: str, t_start: float = T_START):
        self.root = root
        self.bench = load_json(root / "BENCHMARK.json")
        cells = {c["name"]: c for c in self.bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.cell = cells[workload]
        conf = {c["name"]: c for c in self.bench["configs"]}[self.cell["config"]]
        self.config = load_json(root / conf["file"])
        # The net as the configuration states it, checked against its own
        # macs_per_px: every count, weight and reference forward follows it.
        self.net = counts.checked_net(self.config["model"])
        self.pkg = root / "portbench"
        self.mix = load_json(self.pkg / "mixes" / f"{self.cell['traffic']}.json")
        self.limits = load_json(self.pkg / "limits" / f"{workload}.json")
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = device
        self.t_start = t_start
        self.tmpdir = tempfile.gettempdir()
        self.setup_s: Optional[float] = None
        self.e2e: Dict[str, float] = {}
        self.attempted = 0
        self.failed = 0
        self.window: dict = {}   # what the window did (driver's keys)
        self.stretch: dict = {}  # what the traced stretch did
        self.profile: dict = {}  # trace summary of the stretch
        self.program: dict = {}  # the program's own spans and counters
        self.numbers: Dict[str, float] = {}
        self.memory_peak = 0

    def setup_done(self) -> None:
        """Mark the end of set-up: the first timed unit of work starts."""
        self.setup_s = time.perf_counter() - self.t_start

    def read_memory_peak(self) -> None:
        import torch

        if self.device == "cuda":
            self.memory_peak = int(torch.cuda.max_memory_allocated())

    def profiled(self):
        """The traced stretch's context: torch.profiler on the card."""
        from contextlib import nullcontext

        from portbench.trace import profiled

        if self.device != "cuda":
            return nullcontext()
        return profiled(self.tmpdir, self.profile)


def card_line() -> str:
    """The card's name, power limit, clock and temperature."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def per_layer(r: Run) -> Dict[str, dict]:
    """The cell's per-layer metrics, each from its reader; a reader that
    finds nothing returns None and the metric is left out."""
    out = {}
    for m in r.bench["per_layer"]:
        if "workloads" in m and r.cell["name"] not in m["workloads"]:
            continue
        reader = load_module(r.pkg / "metrics" / f"{m['name']}.py",
                             f"portbench_metric_{m['name'].replace('.', '_')}")
        v = reader.read(r)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def end_to_end(r: Run) -> Dict[str, dict]:
    out = {}
    for m in r.bench["end_to_end"]:
        if "workloads" in m and r.cell["name"] not in m["workloads"]:
            continue
        v = r.setup_s if m["name"] == "setup_s" else r.e2e.get(m["name"])
        if v is None:
            raise RuntimeError(f"the driver measured no {m['name']}")
        out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def judge(r: Run) -> Dict[str, dict]:
    """Each number the comparison produced beside its limit."""
    if set(r.numbers) != set(r.limits):
        raise RuntimeError(f"numbers {sorted(r.numbers)} do not match the limits "
                           f"{sorted(r.limits)}")
    return {k: {"value": r.numbers[k], "limit": r.limits[k]} for k in sorted(r.limits)}


def device_kind(device: str) -> str:
    import torch

    return torch.cuda.get_device_name(0) if device == "cuda" else device


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device: str, t_start: float = T_START) -> dict:
    """Everything of a run but the look for a card: the result as a dict."""
    r = Run(root, workload, seed, seconds, trace, device, t_start)
    driver = load_module(r.pkg / "drivers" / f"{r.mix['driver']}.py",
                         f"portbench_driver_{r.mix['driver']}")
    driver.run(r)
    checks = judge(r)
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    result = {"correct": bool(correct), "attempted": int(r.attempted),
              "failed": int(r.failed),
              "metrics": per_layer(r) if trace else end_to_end(r),
              "device": {"platform": "gpu" if device == "cuda" else device,
                         "kind": device_kind(device),
                         "count": 1, "memory_peak_bytes": int(r.memory_peak)}}
    if trace and r.profile:
        result["device"]["busy_s"] = r.profile["busy_s"]
        result["device"]["window_s"] = r.profile["window_s"]
        result["breakdown"] = {"device_ops": r.profile["device_ops"],
                               "idle_gaps": r.profile["idle_gaps"]}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    bench = load_json(HERE.parent / "BENCHMARK.json")
    chips = {c["name"]: c["chips"] for c in bench["workloads"]}.get(args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"portbench: needs {chips} CUDA card(s); torch.cuda.is_available() "
            f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}")
        return 2
    print(f"card: {card_line()}", flush=True)
    res = run_cell(HERE.parent, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        log(f"portbench: modules of JAX or the JAX package were loaded: {bad}")
        return 3
    for name, c in res["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
