"""The port's spans (`dynseg_torch.utils.profiling.span`): totals and self
time, no CUDA call and no profiler range while no profiler runs, ranges in
a torch.profiler trace while one does, one stack per thread; the spans at
the layer boundaries of training, segmentation and serving, counted on
tiny CPU runs; and the benchmark's four per-layer metrics that read them,
on tiny cells."""

import io
import json
import os
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

from dynseg_torch import serve
from dynseg_torch.bridge import flax_to_torch, init_variables_np
from dynseg_torch.config import (Config, DataConfig, InferConfig, ModelConfig,
                                 SchedulerConfig, TrainConfig)
from dynseg_torch.data.datasets import load_synthetic
from dynseg_torch.infer import Inferencer
from dynseg_torch.sched.scheduler import ScaleScheduler
from dynseg_torch.train import Trainer, train_loop
from dynseg_torch.utils import profiling
from dynseg_torch.utils.profiling import span


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one machine: torch's default of
    one intra-op thread per core oversubscribes it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_totals():
    profiling.reset()
    yield
    profiling.reset()


def _fake_clock(monkeypatch, ticks):
    it = iter(ticks)
    monkeypatch.setattr(profiling, "perf_counter_ns", lambda: next(it))


def test_nested_spans_add_calls_totals_and_self_time(monkeypatch):
    # outer [0, 100] holds inner [10, 40] and inner [50, 55]; then inner
    # alone [200, 207].
    _fake_clock(monkeypatch, [0, 10, 40, 50, 55, 100, 200, 207])
    with span("outer") as outer:
        with span("inner"):
            pass
        with span("inner"):
            pass
    with span("inner") as last:
        pass
    assert outer.seconds == 100e-9 and last.seconds == 7e-9
    assert profiling.totals() == {
        "outer": {"calls": 1, "seconds": 100e-9, "self_seconds": 65e-9},
        "inner": {"calls": 3, "seconds": 42e-9, "self_seconds": 42e-9}}


def test_totals_is_a_copy_and_reset_forgets(monkeypatch):
    _fake_clock(monkeypatch, [0, 5, 10, 12])
    with span("a"):
        pass
    got = profiling.totals()
    got["a"]["calls"] = 99
    assert profiling.totals()["a"]["calls"] == 1
    profiling.reset()
    assert profiling.totals() == {}
    with span("a"):
        pass
    assert profiling.totals() == {"a": {"calls": 1, "seconds": 2e-9, "self_seconds": 2e-9}}


def test_no_profiler_range_and_no_cuda_call_with_the_profiler_off(monkeypatch):
    """With no profiler running a span touches neither record_function nor
    torch.cuda: every entry point is replaced by one that raises."""

    def refuse(*a, **k):
        raise AssertionError("called with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", refuse,
                        raising=False)
    for name in ("synchronize", "Event", "current_stream", "is_available",
                 "current_device", "Stream", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    with span("off.outer"):
        with span("off.inner"):
            torch.ones(4).sum()
    assert profiling.totals()["off.inner"]["calls"] == 1


def test_spans_are_nested_user_annotations_in_a_profiler_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        with span("trace.outer"):
            torch.ones(64).cumsum(0)
            with span("trace.inner"):
                torch.ones(64).add(1)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    marks = {e["name"]: e for e in events
             if e.get("cat") == "user_annotation" and e["name"].startswith("trace.")}
    assert set(marks) == {"trace.outer", "trace.inner"}
    o, i = marks["trace.outer"], marks["trace.inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    adds = [e for e in events if e.get("cat") == "cpu_op" and e["name"] == "aten::add"]
    assert adds and all(i["ts"] <= e["ts"] and e["ts"] + e["dur"] <= i["ts"] + i["dur"]
                        for e in adds)
    # The profiler is off again: spans only add to the totals.
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiling.totals()["trace.inner"]["calls"] == 1


def test_spans_of_two_threads_never_nest():
    """Two threads hold their spans open at once; each span's self time is
    its whole time, as neither has a child on its own thread."""
    both_open = threading.Barrier(2)

    def work(name):
        with span(name):
            both_open.wait(timeout=10)
            with span(name + ".inner"):
                both_open.wait(timeout=10)

    threads = [threading.Thread(target=work, args=(n,)) for n in ("thread.a", "thread.b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    got = profiling.totals()
    for n in ("thread.a", "thread.b"):
        inner = got[n + ".inner"]
        assert inner["calls"] == 1 and inner["self_seconds"] == inner["seconds"]
        assert got[n]["self_seconds"] == pytest.approx(
            got[n]["seconds"] - inner["seconds"], abs=1e-9)


def test_totals_lose_no_update_under_many_threads():
    """More threads than cores, each opening spans of one shared name, with
    the interpreter switching threads as often as it can: no call is lost
    and no thread's span counts another's as its child."""
    n, per = (os.cpu_count() or 2) + 2, 500
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                with span("stress"):
                    with span("stress.inner"):
                        pass

        threads = [threading.Thread(target=work) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    got = profiling.totals()
    assert got["stress"]["calls"] == got["stress.inner"]["calls"] == n * per
    assert got["stress"]["self_seconds"] == pytest.approx(
        got["stress"]["seconds"] - got["stress.inner"]["seconds"], abs=1e-6)


# --------------------------------------------------------------------- #
# spans at the port's layer boundaries, on tiny CPU runs
# --------------------------------------------------------------------- #
def _model(net="dilated_icpr_rate6"):
    return ModelConfig(net_type=net, num_classes=2, num_input_bands=3,
                       width_multiplier=0.125)


@pytest.fixture(scope="module")
def tiles():
    return load_synthetic(seed=0, num_tiles=2, size=40)


def _train_cfg():
    return Config(model=_model(),
                  sched=SchedulerConfig(distribution_type="multinomial", values=(9, 13)),
                  train=TrainConfig(batch_size=8, niter=5, eval_every=0,
                                    checkpoint_every=0, seed=0),
                  data=DataConfig(dataset="synthetic"))


def test_trainer_setup_s_is_its_spans(tiles):
    trainer = Trainer(_train_cfg(), tiles[0], "cpu")
    got = profiling.totals()
    assert trainer.setup_s == {k: got[f"train.setup.{k}"]["seconds"]
                               for k in ("pad", "tables", "upload")}
    assert all(got[f"train.setup.{k}"]["calls"] == 1 for k in ("pad", "tables", "upload"))


def _counting(monkeypatch, cls, name):
    calls = []
    real = getattr(cls, name)

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(cls, name, counted)
    return calls


def test_train_spans_count_the_steps(tiles):
    cfg = _train_cfg()
    trainer = Trainer(cfg, tiles[0], "cpu")
    state = trainer.init_state(0)
    profiling.reset()
    train_loop(cfg, trainer, state, ScaleScheduler(cfg.sched, seed=0), niter=5,
               log_every=0, log=lambda *a: None)
    steps = sum(v["steps"] for v in trainer.step_stats().values())
    got = {k: v["calls"] for k, v in profiling.totals().items()}
    assert steps == 5
    # On the CPU no copy event is recorded, so there is no metric wait.
    assert got == {"train.loop": 1, "train.select": 5, "train.sample": 5,
                   "train.step": 5, "train.update": 5}


@pytest.mark.parametrize("mode", ["window", "dense"])
def test_infer_spans_count_the_tiles_and_batches(tiles, monkeypatch, mode):
    cfg = Config(model=_model(),
                 infer=InferConfig(scales=(9, 13), mode=mode, window_batch=16,
                                   dense_block=16, dense_halo=13,
                                   save_prediction_maps=False))
    variables = flax_to_torch(init_variables_np(_model(), num_input_bands=3, seed=0))
    inf = Inferencer(cfg, tiles[1], "cpu")
    got = profiling.totals()
    assert got["infer.setup.pad"]["calls"] == got["infer.setup.upload"]["calls"] == 1
    batches = _counting(monkeypatch, Inferencer, "_probs")
    folds = _counting(monkeypatch, Inferencer, "_fold")
    profiling.reset()
    for t in range(tiles[1].num_tiles):
        if mode == "dense":
            inf.predict_tile_dense(variables, t, block=16, halo=13, return_probs=False)
        else:
            inf.predict_tile(variables, t)
    got = {k: v["calls"] for k, v in profiling.totals().items()}
    n = tiles[1].num_tiles
    assert len(batches) > n
    want = {"infer.tile": n, "infer.forward": len(batches), "infer.to_host": n}
    if mode == "dense":
        want.update({"infer.index": len(batches), "infer.place": len(batches)})
        assert not folds
    else:
        want.update({"infer.index": len(batches) + len(folds), "infer.fold": len(folds)})
    assert got == want


def test_metrics_endpoint_shows_the_serve_spans():
    """One dense request through a ServingEngine on a numpy predictor: the
    engine's queue, device call and copy are spans, listed in /metrics."""

    class Predictor:
        manifest = {"num_input_bands": 3, "num_classes": 2, "net_type": "stub",
                    "dataset": "synthetic", "inference": {"dense_halo": 2}}

        def has(self, name):
            return True

        def probs_device(self, x):
            return torch.softmax(torch.as_tensor(x, dtype=torch.float32)[..., :2], -1)

    engine = serve.ServingEngine(Predictor(), dense_block=8, dense_block_batch=2)
    srv = serve.make_server("unused", port=0, engine=engine)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_port}"
    try:
        body = io.BytesIO()
        np.save(body, np.random.default_rng(0).uniform(0, 1, (12, 20, 3)).astype(np.float32))
        req = urllib.request.Request(f"{base}/predict?mode=dense&output=labels",
                                     data=body.getvalue(),
                                     headers={"Content-Type": "application/x-npy"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
        with urllib.request.urlopen(f"{base}/metrics", timeout=60) as r:
            spans = json.loads(r.read())["spans"]
    finally:
        srv.shutdown()
        srv.server_close()
    # 12 x 20 in blocks of 8: 2 x 3 blocks, in groups of 2.
    assert {k: v["calls"] for k, v in spans.items()} == {
        "serve.queue": 3, "serve.device": 3, "serve.to_host": 3}
    assert all(v["seconds"] >= 0 for v in spans.values())


# --------------------------------------------------------------------- #
# the benchmark's per-layer metrics that read the spans
# --------------------------------------------------------------------- #
SEED = 2 ** 31 + 23
SPAN_METRICS = {
    "tiny_rate6.tiny_train": {"train.host_ms": (0.0, 5000.0)},
    "tiny_rate8.tiny_dense": {"segment.setup_host_s": (0.0, 60.0),
                              "segment.index_wait": (0.0, 100.0),
                              "segment.to_host": (0.0, 100.0)},
    "tiny_rate6.tiny_window": {"segment.setup_host_s": (0.0, 60.0),
                               "segment.index_wait": (0.0, 100.0),
                               "segment.to_host": (0.0, 100.0)},
}


@pytest.fixture(scope="module")
def bench_root(tmp_path_factory):
    """A copy of the benchmark with portbench's tiny CPU cells added."""
    from pathlib import Path

    from portbench.run import load_module

    tiny = load_module(Path(__file__).resolve().parents[1] / "portbench" / "tests" / "tiny.py",
                       "portbench_tests_tiny")
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_tiny_cell_reports_the_span_metrics(bench_root, cell):
    """A traced run of a tiny cell on the CPU, where no profiler runs: the
    spans still fill the totals, and each new metric reads them."""
    from portbench.run import run_cell

    res = run_cell(bench_root, cell, SEED, 0.5, True, "cpu")
    assert res["correct"], res["checks"]
    for name, (lo, hi) in SPAN_METRICS[cell].items():
        assert lo < res["metrics"][name]["value"] < hi, (name, res["metrics"])
    if "train" in cell:
        assert res["metrics"]["train.setup_host_s"]["value"] > 0
