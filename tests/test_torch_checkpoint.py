"""The port's checkpoints (dynseg_torch.checkpoint): a bitwise save/restore
round trip of everything a resumed run needs, max_to_keep, best tracking
and a stale best/, the refusal of the reference's orbax steps, and the
sidecar's encoding against the reference's."""

import copy
import json
import os

import numpy as np
import pytest
import torch

import dynseg.checkpoint as jax_checkpoint
from dynseg_torch import checkpoint, train
from dynseg_torch.bridge import torch_to_flax
from dynseg_torch.config import (Config, DataConfig, ModelConfig,
                                 SchedulerConfig, TrainConfig)
from dynseg_torch.data.datasets import load_synthetic
from dynseg_torch.sched.scheduler import ScaleScheduler


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(**train_kw) -> Config:
    t = dict(batch_size=8, niter=4, ema_decay=0.9, lr_decay_rate=0.5,
             lr_decay_steps=2)
    t.update(train_kw)
    return Config(model=ModelConfig(num_classes=2, width_multiplier=0.125),
                  sched=SchedulerConfig(values=(9, 13)),
                  train=TrainConfig(**t), data=DataConfig(dataset="synthetic"))


@pytest.fixture(scope="module")
def trained():
    """A TrainState after three steps (momentum, EMA, BN statistics all
    moved) and its scheduler."""
    cfg = _cfg()
    tr = train.Trainer(cfg, load_synthetic(seed=0, num_tiles=2, size=40)[0], "cpu")
    st = tr.init_state(seed=1)
    sched = ScaleScheduler(cfg.sched, seed=0)
    for i in range(3):
        size = sched.select()
        _, m = tr.train_step(st, size)
        sched.update(size, float(m["loss"]), float(m["acc"]))
    return cfg, st, sched


def _assert_states_equal(a: train.TrainState, b: train.TrainState):
    da, db = train.checkpoint_dict(a), train.checkpoint_dict(b)
    assert da["step"] == db["step"]
    for part in ("model", "momentum", "ema"):
        assert da[part].keys() == db[part].keys(), part
        for k in da[part]:
            assert torch.equal(da[part][k], db[part][k]), (part, k)


def test_round_trip_is_bitwise(tmp_path, trained):
    cfg, st, sched = trained
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    assert mgr.save(3, st, sched)
    assert sorted(os.listdir(mgr.dir)) == ["3"]
    assert sorted(os.listdir(os.path.join(mgr.dir, "3"))) == ["scheduler.json", "state.pt"]
    fresh = ScaleScheduler(cfg.sched, seed=5)
    got, step = mgr.restore_state(train.init_state_template(cfg, "cpu"), fresh)
    assert step == 3 and got.step == 3
    _assert_states_equal(got, st)
    assert len(train.checkpoint_dict(st)["momentum"]) == len(list(st.model.parameters()))
    assert json.dumps(fresh.state_dict()) == json.dumps(sched.state_dict())
    ahead = copy.deepcopy(sched)
    assert [fresh.select() for _ in range(5)] == [ahead.select() for _ in range(5)]


def test_restore_refuses_a_template_without_ema(tmp_path, trained):
    cfg, st, sched = trained
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    mgr.save(3, st, sched)
    with pytest.raises(ValueError, match="EMA"):
        mgr.restore_state(train.init_state_template(_cfg(ema_decay=0.0), "cpu"))


def test_max_to_keep_and_refused_steps(tmp_path, trained):
    _, st, sched = trained
    mgr = checkpoint.CheckpointManager(str(tmp_path), max_to_keep=3)
    for it in (2, 4, 6, 8, 10):
        assert mgr.save(it, st, sched)
    assert mgr.all_steps() == [6, 8, 10] and mgr.latest_step() == 10
    # Like orbax: a step <= the latest is refused and writes nothing.
    assert not mgr.save(10, st, sched) and not mgr.save(7, st, sched)
    assert mgr.all_steps() == [6, 8, 10]


def test_interrupted_save_leaves_the_last_good_step(tmp_path, trained, monkeypatch):
    cfg, st, sched = trained
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    mgr.save(2, st, sched)

    def killed(*args, **kw):
        raise KeyboardInterrupt

    monkeypatch.setattr(checkpoint.torch, "save", killed)
    with pytest.raises(KeyboardInterrupt):
        mgr.save(4, st, sched)
    assert mgr.all_steps() == [2]
    _, step = mgr.restore_state(train.init_state_template(cfg, "cpu"))
    assert step == 2


def test_best_tracking_and_stale_best(tmp_path, trained):
    cfg, st, sched = trained
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    assert mgr.best_record() is None
    assert mgr.save_best(0.5, 2, st, sched)
    assert not mgr.save_best(0.4, 4, st, sched)  # not better
    assert mgr.save_best(0.6, 6, st, sched)
    assert mgr.best_record() == {"metric": 0.6, "step": 6}
    assert os.listdir(os.path.join(mgr.dir, "best")) == ["6"]
    _, step = mgr.restore_state(train.init_state_template(cfg, "cpu"), best=True)
    assert step == 6

    # A previous run's best/ at a later step, its best.json lost: the
    # new best is refused and best.json does not claim it.
    os.remove(os.path.join(mgr.dir, "best.json"))
    assert not mgr.save_best(0.9, 3, st, sched)
    assert mgr.best_record() is None
    # A fresh run clears the stale best/ (and the steps and sidecar).
    mgr.save(3, st, sched)
    mgr.save_stats({"num_classes": 2})
    assert mgr.reset_for_fresh_run()
    assert os.listdir(mgr.dir) == []
    assert not mgr.reset_for_fresh_run()
    assert mgr.save_best(0.1, 1, st, sched)


def test_orbax_step_is_refused_with_the_importer_named(tmp_path, trained):
    cfg, _, _ = trained
    step_dir = tmp_path / "checkpoints" / "40"
    (step_dir / "state").mkdir(parents=True)
    (step_dir / "_CHECKPOINT_METADATA").write_text("{}")
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    for call in (mgr.latest_step, mgr.reset_for_fresh_run,
                 lambda: mgr.restore_state(train.init_state_template(cfg, "cpu"))):
        with pytest.raises(ValueError, match="import_reference_state"):
            call()
    assert (step_dir / "_CHECKPOINT_METADATA").exists()


def test_sidecar_encoding_matches_reference(tmp_path, trained):
    """The sidecar goes through the reference's numpy <-> JSON encoding,
    ema_batch_stats in the Flax-shaped nested layout."""
    _, st, _ = trained
    stats = {"mean": np.array([1.5, 2.25], np.float32), "std": np.float32(3.0),
             "num_classes": np.int64(2), "fold": 0, "val_tiles": "",
             "ema_batch_stats": torch_to_flax(st.model.state_dict())["batch_stats"]}
    assert checkpoint._jsonable(stats) == jax_checkpoint._jsonable(stats)
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    mgr.save_stats(stats)
    back = mgr.load_stats()
    raw = json.loads((tmp_path / "checkpoints" / "stats.json").read_text())
    assert jax_checkpoint._unjsonable(raw).keys() == back.keys()
    assert back["mean"].dtype == np.float32 and np.array_equal(back["mean"], stats["mean"])
    bs = back["ema_batch_stats"]["DilatedConvBlock_0"]["BatchNorm_0"]
    assert np.array_equal(bs["mean"], st.model.state_dict()["blocks.0.bn.running_mean"].numpy())


def test_import_reference_state_writes_a_port_checkpoint(tmp_path, trained):
    """numpy trees shaped like a dynseg checkpoint's become a port
    checkpoint that restores the same numbers."""
    cfg, st, sched = trained
    flax = torch_to_flax(st.model.state_dict())
    mom = torch_to_flax({k: torch.full_like(v, 0.25) for k, v in
                         st.model.named_parameters()})["params"]
    ema = torch_to_flax({k: v.clone() for k, v in st.ema.items()})["params"]
    out = checkpoint.import_reference_state(
        str(tmp_path), flax, mom, ema, 7, sched.state_dict(), {"num_classes": 2})
    assert out == str(tmp_path / "checkpoints")
    got, step = checkpoint.CheckpointManager(str(tmp_path)).restore_state(
        train.init_state_template(cfg, "cpu"))
    assert step == 7
    for k, v in st.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got.model.state_dict()[k], v), k
    for k, p in got.model.named_parameters():
        assert torch.equal(got.optimizer.state[p]["momentum_buffer"], torch.full_like(p, 0.25))
        assert torch.equal(got.ema[k], st.ema[k])
    with pytest.raises(ValueError, match="already holds"):
        checkpoint.import_reference_state(str(tmp_path), flax, mom, ema, 7,
                                          sched.state_dict(), None)
