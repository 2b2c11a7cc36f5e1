"""Training the dense-wired net (`dilated_icpr_rate6_densely`) on the CPU:
three steps of the port's Trainer against portbench's plain reference
(`portbench.reference.train.train_steps`) over the batches the port's
sampler drew; a tiny dense-wired training cell of the benchmark, correct
as the port is and not correct under a planted fault; and the net's
assembly span and counter, with the benchmark metric that reads them."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from dynseg_torch.config import ModelConfig
from dynseg_torch.data.tiles import pack_tiles
from dynseg_torch.models import dilated
from dynseg_torch.models.dilated import DilatedDenseNet, build_model, to_nchw
from dynseg_torch.sched.scheduler import ScaleScheduler
from dynseg_torch.train import Trainer
from dynseg_torch.utils import profiling
from portbench import synth
from portbench.run import Run, load_module, run_cell

REPO = Path(__file__).resolve().parents[1]
CELL = "tiny_densely.tiny_train"
SEEDS = [2 ** 31 + 11, 2 ** 32 + 5]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one machine: torch's default of
    one intra-op thread per core oversubscribes it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A copy of the benchmark with portbench's tiny cells and a tiny
    dense-wired training cell, which reports what icpr_rate6's training
    cell reports, train.assemble_bytes_px too, under the densely training
    cell's limits."""
    tiny = load_module(REPO / "portbench" / "tests" / "tiny.py", "portbench_tests_tiny")
    r = tiny.make_root(tmp_path_factory.mktemp("bench"))
    bench = json.loads((r / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": CELL, "config": "tiny_densely", "traffic": "tiny_train",
                               "chips": 1, "why": "CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "icpr_rate6_densely-potsdam.train" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (r / "BENCHMARK.json").write_text(json.dumps(bench))
    limits = r / "portbench" / "limits"
    (limits / f"{CELL}.json").write_text(
        (limits / "icpr_rate6_densely-potsdam.train.json").read_text())
    return r


def _concat_forward(fault):
    """DilatedDenseNet.forward with a fault planted: "fan_in" detaches
    block 0's output where block 3 reads it (one consumer's gradient is
    cut), "head" zeroes block 1's slot in the head's input (the head
    drops a block)."""

    def forward(self, x, generator=None):
        feats = [to_nchw(x).to(self.blocks[0].compute_dtype)]
        for i, block in enumerate(self.blocks):
            parts = list(feats)
            if fault == "fan_in" and i == 3:
                parts[1] = parts[1].detach()
            feats.append(block(torch.cat(parts, dim=1)))
        head = feats[1:]
        if fault == "head":
            head[1] = torch.zeros_like(head[1])
        return self.head(self.dropout(torch.cat(head, dim=1), generator)).permute(0, 2, 3, 1)

    return forward


def _port_and_reference(root, seed):
    """Three steps of the port's Trainer through train_loop (width 0.125,
    the tiny train mix, seeded weights), recording what its sampler drew,
    and the plain reference over the same batches from the same weights."""
    driver = load_module(REPO / "portbench" / "drivers" / "train.py", "portbench_driver_train")
    r = Run(root, CELL, seed, 0.0, False, "cpu")
    cfg = driver.config(r)
    images, masks = synth.make_tiles(r.config["data"], "train", seed, "cpu")
    mean, std = synth.stats(images)
    tiles = pack_tiles([im.numpy().astype(np.float32) for im in images],
                       [mk.numpy().astype(np.int32) for mk in masks])
    tiles.mean, tiles.std = mean, std
    weights = synth.make_weights(r.net, seed, "cpu")
    p0 = {k: v.clone() for k, v in weights.items() if ".running_" not in k}
    trainer = Trainer(cfg, tiles, torch.device("cpu"))
    state = trainer.init_state(variables=synth.flax_tree(weights, r.net))
    sched = ScaleScheduler(cfg.sched, seed=r.mix["scheduler_seed"])
    prog = driver.first_steps(cfg, trainer, state, sched, 3)
    hw = [tuple(im.shape[:2]) for im in images]
    ref = driver.reference_steps(r, p0, prog["fed"], images, masks, hw, mean, std,
                                 max(r.mix["values"]) // 2 + 1)
    return prog, ref, p0


def _worst(got, want):
    """By leaf, the largest elementwise gap over the leaf's largest
    magnitude; the worst leaf's."""
    return max(float((got[k] - want[k]).abs().max() / want[k].abs().max().clamp(min=1e-30))
               for k in want)


@pytest.mark.parametrize("fault", [None, "fan_in", "head"])
@pytest.mark.parametrize("seed", SEEDS)
def test_three_dense_steps_match_the_plain_reference(root, monkeypatch, seed, fault):
    """Each step's loss, the momentum after step 1 (every leaf's update
    direction, g + wd p) and the params' change after step 3 agree with
    the plain reference leaf by leaf, element by element. Read on an x86
    CPU (torch 2.13, two threads) over both seeds: loss 1.1e-7, momentum
    1.4e-6, change 1.8e-5 at most. The limits allow float32 rounding in
    other summation orders (the port's channels_last convs and batch
    statistics against the reference's NCHW ones, grown over three
    momentum steps) and nothing more: a planted fault that cuts one
    consumer's gradient or drops a block from the head's input fails
    them."""
    if fault:
        monkeypatch.setattr(DilatedDenseNet, "forward", _concat_forward(fault))
    prog, ref, p0 = _port_and_reference(root, seed)
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    m1 = _worst(prog["m1"], ref["m1"])
    change = _worst({k: prog["params"][k] - p0[k] for k in p0},
                    {k: ref["params"][k] - p0[k] for k in p0})
    ok = loss <= 1e-5 and m1 <= 2e-5 and change <= 2e-4
    assert ok == (fault is None), (loss, m1, change)
    assert set(prog["m1"]) == set(ref["m1"]) == set(p0)


@pytest.mark.parametrize("fault", [None, "fan_in", "head"])
def test_tiny_dense_training_cell(root, monkeypatch, fault):
    """The tiny dense-wired training cell through the benchmark's own run:
    correct as the port is, not correct with a fault planted in its net.
    Its traced run reads train.assemble_bytes_px: 4 bytes a channel of
    the concats at width 0.125, 3 + 11 + 19 + 35 + 51 + 83 + 112."""
    if fault:
        monkeypatch.setattr(DilatedDenseNet, "forward", _concat_forward(fault))
    dilated.reset_assembly()  # as in the benchmark's own process, fresh
    res = run_cell(root, CELL, SEEDS[0], 0.3, fault is None, "cpu")
    assert res["correct"] == (fault is None), res["checks"]
    if fault is None:
        assert res["attempted"] > 0 and res["failed"] == 0
        assert res["metrics"]["train.assemble_bytes_px"] == {"value": 4.0 * 314, "unit": "B/px"}


# --------------------------------------------------------------------- #
# the assembly span and counter
# --------------------------------------------------------------------- #
def _forward(net_type, width, dtype="float32", train=False, shape=(2, 7, 9, 3)):
    cfg = ModelConfig(net_type=net_type, num_classes=6, num_input_bands=3,
                      width_multiplier=width, compute_dtype=dtype)
    model = build_model(cfg, 3).train(train)
    profiling.reset()
    dilated.reset_assembly()
    x = torch.from_numpy(np.random.default_rng(0).normal(size=shape).astype(np.float32))
    model(x).sum().backward() if train else model(x)
    return profiling.totals(), dict(dilated.assembly)


@pytest.mark.parametrize("width,dtype,per_px", [
    (1.0, "float32", 4 * 2386),    # 3 + 67 + 131 + 259 + 387 + 643 + 896 channels
    (0.125, "float32", 4 * 314),   # 3 + 11 + 19 + 35 + 51 + 83 + 112
    (1.0, "bfloat16", 2 * 2386),
])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_dense_forward_assembles_seven_concats(width, dtype, per_px, train):
    """One forward of the dense net: 7 `model.assemble` spans (six block
    inputs and the head's) and the concats' bytes, exactly the element
    size times the sum of the concat widths a pixel, over B x H x W; at
    full width in float32, 9,544 B/px."""
    with torch.no_grad() if not train else torch.enable_grad():
        spans, counted = _forward("dilated_icpr_rate6_densely", width, dtype, train)
    assert spans["model.assemble"]["calls"] == 7
    assert counted == {"bytes": per_px * 2 * 7 * 9, "px": 2 * 7 * 9}


def test_sequential_net_assembles_nothing():
    spans, counted = _forward("dilated_icpr_rate6", 0.125)
    assert "model.assemble" not in spans and counted == {"bytes": 0, "px": 0}


def test_export_adds_nothing_to_the_counter():
    """torch.export traces the forward with symbolic sizes: the counter
    stays as it was."""
    from torch.export import Dim

    cfg = ModelConfig(net_type="dilated_icpr_rate6_densely", num_classes=6,
                      num_input_bands=3, width_multiplier=0.125)
    model = build_model(cfg, 3)
    dilated.reset_assembly()
    dims = {0: Dim("b", min=1), 1: Dim("h", min=1), 2: Dim("w", min=1)}
    torch.export.export(model, (torch.zeros(2, 18, 20, 3),), dynamic_shapes=(dims,))
    assert dilated.assembly == {"bytes": 0, "px": 0}


def test_assemble_metric_reads_the_counter_or_nothing(monkeypatch):
    """train.assemble_bytes_px: bytes over pixels; nothing where the
    counter counted no pixel or the program has none (as before it)."""
    reader = load_module(REPO / "portbench" / "metrics" / "train.assemble_bytes_px.py",
                         "portbench_metric_train_assemble_bytes_px")
    monkeypatch.setattr(dilated, "assembly", {"bytes": 19088, "px": 2})
    assert reader.read(None) == 9544.0
    monkeypatch.setattr(dilated, "assembly", {"bytes": 0, "px": 0})
    assert reader.read(None) is None
    monkeypatch.delattr(dilated, "assembly")
    assert reader.read(None) is None
