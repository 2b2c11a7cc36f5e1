"""Reproducibility of the port (counterpart of tests/test_determinism.py):
the same seed gives the same sampling, scheduling and training
trajectory, as the reference guarantees. Every comparison here is
bitwise (tolerance 0): two runs of the port against each other, and the
port's sampler against the JAX package's. On the card the same holds
(tests/test_torch_cuda.py::test_training_is_bitwise_reproducible_on_the_card)."""

import dataclasses

import numpy as np
import pytest
import torch

from dynseg.data.datasets import load_synthetic
from dynseg.data.sampler import BalancedPatchSampler as JaxSampler
from dynseg.data.tiles import mirror_pad as jax_mirror_pad
from dynseg_torch import config as port_config
from dynseg_torch.data import tiles as port_tiles
from dynseg_torch.data.sampler import BalancedPatchSampler
from dynseg_torch.probes import repro
from dynseg_torch.train import Trainer

ZERO = {"params": 0.0, "bn": 0.0, "momentum": 0.0, "ema": 0.0, "recal": 0.0,
        "losses": 0.0, "scores": 0.0, "scales": 0.0}


def _tiles(tiles):
    """The port's TileSet with the reference TileSet's field values."""
    return port_tiles.TileSet(**{f.name: getattr(tiles, f.name)
                                 for f in dataclasses.fields(tiles)})


def _cfg(net_type="dilated_grsl", pool_backward="xla", **train_kw):
    """tests/test_determinism.py's configuration (width 0.125, multinomial
    over (9, 15), lr 0.05, batch 8, 6 steps, seed 3) in the port's
    classes, with EMA 0.9 so that the EMA weights are compared too."""
    c = port_config
    return c.Config(
        model=c.ModelConfig(net_type=net_type, num_classes=2,
                            width_multiplier=0.125, pool_backward=pool_backward),
        sched=c.SchedulerConfig(distribution_type="multinomial", values=(9, 15)),
        train=c.TrainConfig(learning_rate=0.05, batch_size=8, niter=6, seed=3,
                            ema_decay=0.9, **train_kw),
        data=c.DataConfig(dataset="synthetic"))


@pytest.fixture(scope="module")
def tiles():
    return _tiles(load_synthetic(seed=0, num_tiles=2, size=96)[0])


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_sampler_deterministic_and_equal_to_reference(synthetic_data):
    """Two port samplers from one seed draw equal positions and augment
    ids, and both equal the JAX sampler's on the same tiles."""
    train_tiles, _ = synthetic_data
    padded = jax_mirror_pad(train_tiles, 8)
    port_padded = _tiles(padded)
    a = BalancedPatchSampler(port_padded, 2, pad=8, seed=5)
    b = BalancedPatchSampler(port_padded, 2, pad=8, seed=5)
    j = JaxSampler(padded, 2, pad=8, seed=5)
    pos = a.sample(32)
    np.testing.assert_array_equal(pos, b.sample(32))
    np.testing.assert_array_equal(pos, j.sample(32))
    ids = a.sample_augment_ids(32, True)
    np.testing.assert_array_equal(ids, b.sample_augment_ids(32, True))
    np.testing.assert_array_equal(ids, j.sample_augment_ids(32, True))


@pytest.mark.parametrize("net_type,pool_backward", [
    ("dilated_grsl", "xla"),
    ("dilated_icpr_rate6", "xla"),
    ("dilated_icpr_rate6", "pallas"),
])
def test_training_trajectory_deterministic(tiles, net_type, pool_backward):
    """train_loop twice from one seed: the state_dict (params and BN
    statistics), momentum, EMA, per-step losses, the scales drawn and the
    scheduler's scores bitwise equal."""
    cfg = _cfg(net_type, pool_backward)
    a = repro.train_run(cfg, tiles, "cpu")
    b = repro.train_run(cfg, tiles, "cpu")
    assert len(a["losses"]) == 6 and all(np.isfinite(a["losses"]))
    assert set(a["scales"]) == {9, 15}
    assert repro.distances(a, b) == ZERO
    assert a["scores"] == b["scores"]
    for k, v in a["state"].items():
        np.testing.assert_array_equal(b["state"][k], v, err_msg=k)
    for k, v in a["ema"].items():
        np.testing.assert_array_equal(b["ema"][k], v, err_msg=k)


def test_recalibrate_batch_stats_deterministic(tiles):
    """recalibrate_batch_stats of the same weights on two Trainers built
    from one seed: bitwise equal running statistics."""
    cfg = _cfg("dilated_icpr_rate6")
    out = []
    for _ in range(2):
        tr = Trainer(cfg, tiles, device="cpu")
        sd = tr.init_state(seed=4).model.state_dict()
        out.append(tr.recalibrate_batch_stats(sd, 4))
    assert out[0].keys() == out[1].keys()
    moved = 0
    for k, v in out[0].items():
        assert torch.equal(v, out[1][k]), k
        moved += "running_mean" in k and bool(v.abs().max() > 0)
    assert moved  # the statistics were recomputed, not left at zero


def test_checkpoint_restored_twice_continues_bitwise(tiles, tmp_path):
    """One checkpoint after 6 steps, restored twice (samplers reseeded at
    its iteration, as --resume does) for 3 more steps each: bitwise."""
    cfg = _cfg("dilated_icpr_rate6", "pallas")
    first = repro.train_run(cfg, tiles, "cpu", save_to=str(tmp_path))
    again = [repro.train_run(cfg, tiles, "cpu", niter=3, restore_from=str(tmp_path))
             for _ in range(2)]
    assert first["step"] == 6 and again[0]["step"] == 9
    assert len(again[0]["losses"]) == 3
    assert repro.distances(*again) == ZERO
    assert repro.distances(first, again[0])["params"] > 0  # it did train on


def test_trainer_asks_cudnn_for_deterministic_algorithms(tiles):
    """Building a Trainer leaves cuDNN's deterministic flag on and its
    benchmark (autotuning) off, whatever they were before."""
    flags = torch.backends.cudnn
    before = (flags.deterministic, flags.benchmark)
    try:
        flags.deterministic, flags.benchmark = False, True
        Trainer(_cfg(), tiles, device="cpu")
        assert (flags.deterministic, flags.benchmark) == (True, False)
    finally:
        flags.deterministic, flags.benchmark = before
