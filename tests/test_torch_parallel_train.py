"""Data-parallel training of the port (dynseg_torch.parallel, the Trainer
under a group of ranks) against the JAX package's mesh trainer and the
port's own single-device trainer.

Two CPU ranks over gloo (`parallel.spawn`) run width-0.125 nets on small
synthetic tiles. The reference runs its Trainer on 2 of the 8 virtual CPU
devices that tests/conftest.py provides. One launch of the ranks carries
every check of this file (`dp_parity.run_many`), since a launch costs
seconds of process start-up. Tolerances are those of
tests/test_torch_train.py: loss 1e-5 relative, params 1e-6, momentum
1e-3 / 1e-5, BN statistics 1e-5."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynseg.train as jax_train
from dynseg.config import Config, DataConfig, ModelConfig, SchedulerConfig, TrainConfig
from dynseg.data.datasets import load_synthetic
from dynseg_torch import config as port_config
from dynseg_torch import parallel, train
from dynseg_torch.bridge import init_variables_np, torch_to_flax
from dynseg_torch.data import tiles as port_tiles
from dynseg_torch.ops.gather import gather_batch
from dynseg_torch.probes import dp_parity

SIZE = 13


def _port(obj):
    """The port's dataclass of the same name (a config, or a TileSet) with
    the reference object's field values."""
    mod = port_tiles if type(obj).__name__ == "TileSet" else port_config
    vals = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    return getattr(mod, type(obj).__name__)(**{
        k: _port(v) if dataclasses.is_dataclass(v) else v for k, v in vals.items()})


def tiny_config(num_devices=2, distribution="single_fixed", **train_kw) -> Config:
    t = dict(learning_rate=0.05, weight_decay=5e-4, batch_size=8, niter=6,
             eval_every=1000, checkpoint_every=1000, seed=0,
             num_devices=num_devices)
    t.update(train_kw)
    return Config(
        model=ModelConfig(net_type="dilated_icpr_rate6", num_classes=2,
                          num_input_bands=3, width_multiplier=0.125),
        sched=SchedulerConfig(distribution_type=distribution, values=(9, 13)),
        train=TrainConfig(**t),
        data=DataConfig(dataset="synthetic"))


def _seeded(cfg: ModelConfig, seed: int) -> dict:
    """Flax-shaped variables with non-trivial BN params and statistics."""
    v = init_variables_np(_port(cfg), num_input_bands=3, seed=seed)
    rng = np.random.default_rng(seed + 1)
    for name, st in v["batch_stats"].items():
        bn, s = v["params"][name]["BatchNorm_0"], st["BatchNorm_0"]
        n = bn["scale"].shape[0]
        bn["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
        bn["bias"] = rng.normal(0, 0.1, n).astype(np.float32)
        s["mean"] = rng.normal(0, 0.3, n).astype(np.float32)
        s["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return v


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _close(got, want, rtol, atol, what):
    got, want = _flat(got), _flat(dict(want))
    assert got.keys() == want.keys(), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {k}")


def _as_flax(state: dict) -> dict:
    return torch_to_flax({k: torch.from_numpy(v) for k, v in state.items()})


def _momentum_flax(momentum: dict) -> dict:
    return torch_to_flax({k: torch.from_numpy(v) for k, v in momentum.items()})["params"]


def _edge_heavy_batches(tiles, pad: int, b: int, steps: int):
    """Global batches whose first half (rank 0's rows) sits on the tiles'
    corners, where a patch covers the IGNORE pad, and whose second half
    (rank 1's) sits inside: the ranks hold different valid-pixel counts."""
    rng = np.random.default_rng(4)
    h, w = tiles.images.shape[1:3]
    out = []
    for _ in range(steps):
        pos = np.empty((b, 3), np.int32)
        pos[:, 0] = rng.integers(0, tiles.num_tiles, b)
        half = b // 2
        pos[:half, 1] = pad + rng.choice([0, 1, h - 2, h - 1], half)
        pos[:half, 2] = pad + rng.choice([0, 1, w - 2, w - 1], half)
        pos[half:, 1] = pad + rng.integers(h // 3, 2 * h // 3, b - half)
        pos[half:, 2] = pad + rng.integers(w // 3, 2 * w // 3, b - half)
        out.append((pos, rng.integers(0, 8, b).astype(np.int32)))
    return out


@pytest.fixture(scope="module")
def tiles():
    return load_synthetic(seed=0, num_tiles=2, size=40)[0]


@pytest.fixture(scope="module")
def shard_tiles():
    """Three tiles: two ranks get blocks {0, 2} and {1, a dummy}."""
    return load_synthetic(seed=3, num_tiles=3, size=40)[0]


@pytest.fixture(scope="module")
def run(tiles, shard_tiles, tmp_path_factory):
    """One launch of two gloo ranks, every check's work in it; beside it
    the single-device runs in this process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    out = tmp_path_factory.mktemp("dp_train")
    variables = _seeded(tiny_config().model, 2)
    pad = SIZE // 2 + 1
    batches = _edge_heavy_batches(tiles, pad, 8, 2)
    cfg2, cfg1 = _port(tiny_config(2)), _port(tiny_config(1))
    shard2 = _port(tiny_config(2, shard_tiles=True))
    loop2 = _port(tiny_config(2, "multinomial"))
    pt, st = _port(tiles), _port(shard_tiles)
    one = dp_parity.train_steps(cfg1, pt, variables, [SIZE, SIZE], batches,
                                save_to=str(out / "one"))
    ranks = parallel.spawn(dp_parity.run_many, 2, ["cpu", "cpu"], threads=2, args=([
        (dp_parity.train_steps, (cfg2, pt, variables, [SIZE, SIZE], batches,
                                 True, str(out / "two"))),
        (dp_parity.train_steps, (shard2, st, variables, [SIZE, SIZE])),
        (dp_parity.recalibrate, (cfg2, pt, variables, 3)),
        (dp_parity.loop_scales, (loop2, pt, variables)),
        (dp_parity.restore, (cfg2, str(out / "one"))),
    ],))
    names = ("steps", "shard", "recalibrate", "loop", "restored")
    yield {"variables": variables, "batches": batches, "one": one, "out": out,
           "ranks": [dict(zip(names, r)) for r in ranks]}
    torch.set_num_threads(threads)


def _jax_mesh_steps(cfg, tiles, variables, batches):
    """The reference's mesh step on the given global batches (positions
    and augment ids sharded over axis "data", as make_batch_inputs puts
    them): its losses and state."""
    jt = jax_train.Trainer(cfg, tiles)
    params = jax.tree.map(jnp.asarray, variables["params"])
    js = jax.device_put(jax_train.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=jt.tx.init(params)), jt.repl)
    sh = jax.sharding.NamedSharding(jt.mesh, jax.sharding.PartitionSpec(None, "data"))
    losses = []
    for i, (pos, aug) in enumerate(batches):
        js, m = jt._train_step(js, jt.images, jt.masks, jt.mean, jt.std,
                               jax.device_put(pos[None], sh),
                               jax.device_put(aug[None], sh),
                               jax.random.split(jax.random.key(i), 1), size=SIZE)
        losses.append(float(m["loss"]))
    return jt, js, losses


def _assert_state(got: dict, js, what):
    flax = _as_flax(got["state"])
    _close(flax["params"], js.params, 0, 1e-6, f"{what} params")
    _close(flax["batch_stats"], js.batch_stats, 1e-5, 1e-5, f"{what} batch_stats")
    _close(_momentum_flax(got["momentum"]), js.opt_state[1][0].trace, 1e-3, 1e-5,
           f"{what} momentum")
    assert got["step"] == int(js.step)


# --------------------------------------------------------------------- #
# the step
# --------------------------------------------------------------------- #
def test_ranks_hold_unequal_valid_pixel_counts(tiles, run):
    """The batches give rank 0 fewer valid pixels than rank 1, so that a
    per-rank mean loss or per-rank BatchNorm would show."""
    t = train.Trainer(_port(tiny_config(1)), _port(tiles), device="cpu")
    for pos, aug in run["batches"]:
        _, labs = gather_batch(t.images, t.masks, t.mean, t.std,
                               torch.from_numpy(pos), torch.from_numpy(aug), SIZE)
        valid = (labs != 255).reshape(2, -1).sum(1).tolist()
        assert valid[0] < 0.9 * valid[1], valid


@pytest.mark.parametrize("rank", [0, 1])
def test_two_rank_steps_match_the_reference_mesh_step(tiles, run, rank):
    """Two steps at 2 ranks against dynseg's Trainer on a 2-device mesh,
    the same global batches: every rank holds the reference's state."""
    jt, js, jl = _jax_mesh_steps(tiny_config(2), tiles, run["variables"], run["batches"])
    assert jt.mesh.devices.size == 2
    got = run["ranks"][rank]["steps"]
    np.testing.assert_allclose(got["losses"], jl, rtol=1e-5)
    _assert_state(got, js, f"rank {rank}")


def test_two_rank_steps_match_the_single_device_step(run):
    """The same two steps on one device: loss, params, momentum, BN."""
    one, two = run["one"], run["ranks"][0]["steps"]
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5)
    np.testing.assert_allclose(two["accs"], one["accs"], rtol=1e-6)
    for k, v in one["state"].items():
        tol = 1e-5 if "running" in k else 1e-6
        np.testing.assert_allclose(two["state"][k], v, rtol=0, atol=tol, err_msg=k)
    for k, v in one["momentum"].items():
        np.testing.assert_allclose(two["momentum"][k], v, rtol=1e-3, atol=1e-5, err_msg=k)


def test_spawned_ranks_ask_cudnn_for_deterministic_algorithms(run):
    """Each rank is a fresh process (the spawn start method): its Trainer
    sets cuDNN's deterministic flag and clears benchmark there too."""
    for r in run["ranks"]:
        assert r["steps"]["cudnn"] == (True, False)
        assert r["shard"]["cudnn"] == (True, False)


def test_ranks_end_bitwise_equal(run):
    """Every rank applies the same summed gradient and the same global
    statistics: the states are equal bit for bit."""
    a, b = (r["steps"] for r in run["ranks"])
    assert a["losses"] == b["losses"]
    for k in a["state"]:
        np.testing.assert_array_equal(a["state"][k], b["state"][k], err_msg=k)


def test_each_rank_counts_its_collectives_and_its_gathers(run):
    """Per step: the valid count, an all-reduce forward and backward for
    each of the six BatchNorms, the gradients and the metrics (15); one
    gather and six pool backwards (the K2/K4 counts stay 0 on the CPU)."""
    for r in run["ranks"]:
        s = r["steps"]
        assert s["collective_calls"] == 2 * 15
        assert (s["gathers"], s["pool_bwds"], s["k2"], s["k4"]) == (2, 12, 0, 0)


# --------------------------------------------------------------------- #
# --shard_tiles
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("rank", [0, 1])
def test_shard_layout_and_sampling_match_reference(shard_tiles, rank):
    """The port's shard layout (dummy tiles, interleaved) and each rank's
    block, local positions and augment ids equal the reference's
    make_batch_inputs on its 2-device mesh."""
    cfg = tiny_config(2, shard_tiles=True)
    jt = jax_train.Trainer(cfg, shard_tiles)
    tt = train.Trainer(_port(cfg), _port(shard_tiles), device="cpu",
                       world=parallel.World(rank=rank, size=2))
    tpd = jt.tiles_per_device
    assert tt.shard_tiles and tt.tiles_per_device == tpd == 2
    np.testing.assert_array_equal(
        tt.images.numpy(), np.asarray(jt.images)[rank * tpd:(rank + 1) * tpd])
    np.testing.assert_array_equal(
        tt.masks.numpy(), np.asarray(jt.masks)[rank * tpd:(rank + 1) * tpd])
    for _ in range(2):
        jpos, jaug = (np.asarray(a) for a in jt.make_batch_inputs(SIZE, k=2))
        tpos, taug = tt.make_batch_inputs(SIZE, k=2)
        mine = slice(rank * 4, (rank + 1) * 4)
        np.testing.assert_array_equal(tpos.numpy(), jpos[:, mine])
        np.testing.assert_array_equal(taug.numpy(), jaug[:, mine])


@pytest.mark.parametrize("rank", [0, 1])
def test_two_rank_shard_steps_match_reference(shard_tiles, run, rank):
    """Two --shard_tiles steps on the ranks' own sampling against the
    reference's mesh trainer on its own sampling (the same draws): loss
    and state; and against one device replaying the same batches with
    unsharded tile ids."""
    cfg = tiny_config(2, shard_tiles=True)
    jt = jax_train.Trainer(cfg, shard_tiles)
    params = jax.tree.map(jnp.asarray, run["variables"]["params"])
    js = jax.device_put(jax_train.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, run["variables"]["batch_stats"]),
        opt_state=jt.tx.init(params)), jt.repl)
    jl = []
    for i in range(2):
        pos, aug = jt.make_batch_inputs(SIZE)
        js, m = jt._train_step(js, jt.images, jt.masks, jt.mean, jt.std, pos, aug,
                               jax.random.split(jax.random.key(i), 1), size=SIZE)
        jl.append(float(m["loss"]))
    got = run["ranks"][rank]["shard"]
    np.testing.assert_allclose(got["losses"], jl, rtol=1e-5)
    _assert_state(got, js, f"shard rank {rank}")
    one = dp_parity.train_steps(_port(tiny_config(1)), _port(shard_tiles),
                                run["variables"], [SIZE, SIZE], got["batches"])
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-5)


@pytest.mark.parametrize("b,n", [(8, 2), (9, 2), (1, 2), (7, 4), (100, 8), (3, 8)])
def test_batch_size_for_matches_reference(tiles, b, n):
    """Rounded to a multiple of the ranks, at least one row a rank."""
    cfg = tiny_config(n, batch_size=b)
    want = jax_train.Trainer(cfg, tiles).batch_size_for(SIZE)
    tt = train.Trainer(_port(cfg), _port(tiles), device="cpu",
                       world=parallel.World(rank=n - 1, size=n))
    assert tt.batch_size_for(SIZE) == want
    pos, aug = tt.make_batch_inputs(SIZE)
    assert pos.shape == (1, want // n, 3) and aug.shape == (1, want // n)


def test_replicated_rows_are_the_reference_global_batch(tiles):
    """Without --shard_tiles each rank samples the reference's global batch
    and keeps its rows."""
    cfg = tiny_config(2)
    jpos, jaug = (np.asarray(a) for a in jax_train.Trainer(cfg, tiles).make_batch_inputs(SIZE, k=3))
    for rank in (0, 1):
        tt = train.Trainer(_port(cfg), _port(tiles), device="cpu",
                           world=parallel.World(rank=rank, size=2))
        pos, aug = tt.make_batch_inputs(SIZE, k=3)
        np.testing.assert_array_equal(pos.numpy(), jpos[:, rank * 4:(rank + 1) * 4])
        np.testing.assert_array_equal(aug.numpy(), jaug[:, rank * 4:(rank + 1) * 4])


def test_trainer_refuses_a_rank_count_it_was_not_launched_with(tiles):
    """num_devices 2 in one process: no silent single-device run."""
    with pytest.raises(ValueError, match="launch the ranks"):
        train.Trainer(_port(tiny_config(2)), _port(tiles), device="cpu")


# --------------------------------------------------------------------- #
# recalibration, the loop, checkpoints
# --------------------------------------------------------------------- #
def test_recalibration_at_two_ranks_matches_reference(tiles, run):
    """Three train-mode forwards over the sampled global batches: the
    reference's running statistics on its mesh; params untouched."""
    v = run["variables"]
    jt = jax_train.Trainer(tiny_config(2), tiles)
    want = jt.recalibrate_batch_stats(jax.tree.map(jnp.asarray, v["params"]),
                                      jax.tree.map(jnp.asarray, v["batch_stats"]), 3)
    for r in run["ranks"]:
        got = _as_flax(r["recalibrate"])
        _close(got["batch_stats"], want, 1e-5, 1e-5, "batch_stats")
        _close(got["params"], v["params"], 0, 0, "params")


def test_loop_takes_the_same_scales_on_every_rank(run):
    """A multinomial train_loop: every rank trains the same scale at every
    step, and ends in the same state."""
    a, b = (r["loop"] for r in run["ranks"])
    assert len(a["scales"]) == 6 and set(a["scales"]) <= {9, 13}
    assert a["scales"] == b["scales"]
    assert a["step"] == b["step"] == 6
    for k in a["state"]:
        np.testing.assert_array_equal(a["state"][k], b["state"][k], err_msg=k)


def test_checkpoint_from_two_ranks_restores_bitwise_at_one(run):
    """Rank 0 wrote the 2-rank state; one process restores it bit for
    bit, momentum included."""
    got = dp_parity.restore(_port(tiny_config(1)), str(run["out"] / "two"))
    want = run["ranks"][0]["steps"]
    assert got["step"] == want["step"] == 2
    for part in ("state", "momentum"):
        for k, v in want[part].items():
            np.testing.assert_array_equal(got[part][k], v, err_msg=k)


def test_checkpoint_from_one_device_restores_bitwise_at_two_ranks(run):
    """A single-device checkpoint restores bit for bit on both ranks."""
    want = run["one"]
    for r in run["ranks"]:
        got = r["restored"]
        assert got["step"] == want["step"]
        for part in ("state", "momentum"):
            for k, v in want[part].items():
                np.testing.assert_array_equal(got[part][k], v, err_msg=k)


def test_only_rank_zero_writes_a_checkpoint(run):
    """One step directory and a scheduler state, written once."""
    ck = run["out"] / "two" / "checkpoints"
    assert sorted(os.listdir(ck)) == ["2"]
    assert sorted(os.listdir(ck / "2")) == ["scheduler.json", "state.pt"]
