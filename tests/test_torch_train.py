"""The port's training slice (dynseg_torch.train, .cli, the train-mode nets
and the batch metrics) against the JAX package: the same numpy-seeded
weights, positions and augment ids go through both. The JAX side runs
its CPU routes: the XLA gather, and for pool_backward="pallas" the Pallas
pool backward in interpret mode (the reference's own CPU fallback would
take the first-max XLA VJP instead of the tie-split kernel)."""

import dataclasses
import functools
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynseg.cli as jax_cli
import dynseg.ops.pool as jax_pool
import dynseg.train as jax_train
from dynseg.config import (NET_TYPES, Config, DataConfig, InferConfig,
                           ModelConfig, SchedulerConfig, TrainConfig)
from dynseg.data.datasets import load_synthetic
from dynseg.metrics import balanced_batch_accuracy as jax_bacc
from dynseg.metrics import batch_accuracy as jax_acc
from dynseg.models import dilated as jax_dilated
from dynseg.sched.scheduler import ScaleScheduler
from dynseg_torch import cli, metrics, train
from dynseg_torch import config as port_config
from dynseg_torch.bridge import (flax_to_torch, init_variables_np,
                                 load_momentum, momentum_to_flax,
                                 torch_to_flax)
from dynseg_torch.data import tiles as port_tiles
from dynseg_torch.models import dilated as torch_dilated
from dynseg_torch.ops import pool as torch_pool
from dynseg_torch.sched import scheduler as port_scheduler


def _port(obj):
    """The port's dataclass of the same name (a config, or a TileSet) with
    the reference object's field values."""
    mod = port_tiles if type(obj).__name__ == "TileSet" else port_config
    vals = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    return getattr(mod, type(obj).__name__)(**{
        k: _port(v) if dataclasses.is_dataclass(v) else v for k, v in vals.items()})


def _plain(cfg):
    """A config of either package as its class name and field values."""
    return type(cfg).__name__, dataclasses.asdict(cfg)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one machine: torch's default of
    one intra-op thread per core oversubscribes it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_trees_close(got, want, rtol, atol, what):
    got, want = _flat(got), _flat(dict(want))
    assert got.keys() == want.keys(), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {k}")


def _seeded(cfg: ModelConfig, bands: int, seed: int) -> dict:
    """Flax-shaped variables with non-trivial BN params and statistics."""
    v = init_variables_np(_port(cfg), num_input_bands=bands, seed=seed)
    rng = np.random.default_rng(seed + 1)
    for name, st in v.get("batch_stats", {}).items():
        bn, s = v["params"][name]["BatchNorm_0"], st["BatchNorm_0"]
        n = bn["scale"].shape[0]
        bn["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
        bn["bias"] = rng.normal(0, 0.1, n).astype(np.float32)
        s["mean"] = rng.normal(0, 0.3, n).astype(np.float32)
        s["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return v


def tiny_config(pool_backward="xla", **train_kw) -> Config:
    t = dict(learning_rate=0.05, weight_decay=5e-4, batch_size=8, niter=4,
             eval_every=1000, checkpoint_every=1000, seed=0)
    t.update(train_kw)
    return Config(
        model=ModelConfig(net_type="dilated_icpr_rate6", num_classes=2,
                          num_input_bands=3, width_multiplier=0.125,
                          pool_backward=pool_backward),
        sched=SchedulerConfig(distribution_type="single_fixed", values=(9, 13)),
        train=TrainConfig(**t),
        data=DataConfig(dataset="synthetic"))


@pytest.fixture(scope="module")
def tiles():
    return load_synthetic(seed=0, num_tiles=2, size=40)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Route the reference's max_pool_s1 backward through the Pallas kernel
    in interpret mode (for odd windows), as tests/test_pallas.py runs it."""
    monkeypatch.setattr(jax_pool, "pallas_pool_bwd_supported",
                        lambda shape, dtype, window=3: window % 2 == 1)
    monkeypatch.setattr(jax_pool, "pallas_pool_bwd", functools.partial(
        jax_pool.pallas_pool_bwd, interpret=True))


def _jax_state(jt, variables):
    params = jax.tree.map(jnp.asarray, variables["params"])
    return jax_train.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=jt.tx.init(params))


# --------------------------------------------------------------------- #
# train-mode forward, loss and metrics
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("momentum", [0.9, 0.99])
@pytest.mark.parametrize("net_type", NET_TYPES)
def test_train_forward_matches_flax(net_type, momentum):
    """Logits within the eval forward's bound (test_torch_models.py);
    running statistics within 1e-5: batch mean/var are float32 sums of
    the same values in another order."""
    cfg = ModelConfig(net_type=net_type, num_classes=3, num_input_bands=3,
                      width_multiplier=0.125, bn_momentum=momentum)
    x = np.random.default_rng(5).normal(size=(2, 17, 15, 3)).astype(np.float32)
    variables = _seeded(cfg, 3, 1)
    want, mutated = jax_dilated.build_model(cfg).apply(
        variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    net = torch_dilated.build_model(_port(cfg))
    net.load_state_dict(flax_to_torch(variables))
    net.train()
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=5e-5, rtol=1e-4)
    stats = torch_to_flax(net.state_dict())["batch_stats"]
    _assert_trees_close(stats, mutated["batch_stats"], 1e-5, 1e-5, "batch_stats")


def test_masked_cross_entropy_and_batch_metrics():
    """Float32 log-softmax in both: 1e-6. All pixels ignored: 0, not NaN."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 5, 4, 4)).astype(np.float32)
    labels = rng.integers(0, 4, (3, 5, 4)).astype(np.int64)
    labels[0, :2] = 255
    labels[1, :, 1] = 3  # class 2 absent from some rows, 3 over-present
    lt, yt = torch.from_numpy(logits), torch.from_numpy(labels)
    lj, yj = jnp.asarray(logits), jnp.asarray(labels.astype(np.int32))
    np.testing.assert_allclose(float(train.masked_cross_entropy(lt, yt)),
                               float(jax_train.masked_cross_entropy(lj, yj)),
                               rtol=1e-6)
    ignored = torch.full_like(yt, 255)
    assert float(train.masked_cross_entropy(lt, ignored)) == 0.0
    np.testing.assert_allclose(float(metrics.batch_accuracy(lt, yt)),
                               float(jax_acc(lj, yj)), rtol=1e-6)
    np.testing.assert_allclose(float(metrics.balanced_batch_accuracy(lt, yt, 4)),
                               float(jax_bacc(lj, yj, 4)), rtol=1e-6)
    assert float(metrics.batch_accuracy(lt, ignored)) == 0.0
    assert float(metrics.balanced_batch_accuracy(lt, ignored, 4)) == 0.0


def test_dropout_keeps_and_scales_in_train_mode_only():
    cfg = ModelConfig(net_type="dilated_grsl", num_classes=2, width_multiplier=0.125,
                      dropout_rate=0.5)
    net = torch_dilated.build_model(_port(cfg), 3)
    x = torch.ones((4, 8, 8, 32)).permute(0, 3, 1, 2)
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(net.dropout(x, gen), x)  # eval: identity
    net.train()
    y = net.dropout(x, gen)
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}
    assert abs(float((y > 0).float().mean()) - 0.5) < 0.05


# --------------------------------------------------------------------- #
# the train step
# --------------------------------------------------------------------- #
def _run_both(cfg, tiles, steps, size, momentum=False):
    """`steps` steps from the same TrainState in both packages (with
    `momentum`, random momentum buffers carried across by the bridge);
    returns (JAX state, JAX losses, port state, port losses)."""
    variables = _seeded(cfg.model, 3, 2)
    jt = jax_train.Trainer(cfg, tiles[0])
    tt = train.Trainer(_port(cfg), _port(tiles[0]), device="cpu")
    js = _jax_state(jt, variables)
    ts = tt.init_state(variables=variables)
    if momentum:
        mrng = np.random.default_rng(9)
        trace = jax.tree.map(lambda p: mrng.normal(0, 0.01, p.shape).astype(np.float32),
                             variables["params"])
        load_momentum(ts.model, ts.optimizer, trace)
        _assert_trees_close(momentum_to_flax(ts.model, ts.optimizer), trace, 0, 0,
                            "momentum round trip")
        o = js.opt_state
        js = js.replace(opt_state=(o[0], (o[1][0]._replace(
            trace=jax.tree.map(jnp.asarray, trace)), o[1][1])) + tuple(o[2:]))
    rng = np.random.default_rng(3)
    jl, tl = [], []
    for i in range(steps):
        b = jt.batch_size_for(size)
        pos = jt.sampler.sample(b).astype(np.int32)
        aug = rng.integers(0, 8, b).astype(np.int32)
        js, mj = jt._train_step(js, jt.images, jt.masks, jt.mean, jt.std,
                                jnp.asarray(pos[None]), jnp.asarray(aug[None]),
                                jax.random.split(jax.random.key(i), 1), size=size)
        mt = tt._step_impl(ts, torch.from_numpy(pos), torch.from_numpy(aug), size)
        jl.append(float(mj["loss"]))
        tl.append(float(mt["loss"]))
        np.testing.assert_allclose(float(mt["acc"]), float(mj["acc"]), atol=2e-3)
    return js, jl, ts, tl


def _compare_states(js, ts, rtol, atol, momentum=True):
    got = torch_to_flax(ts.model.state_dict())
    _assert_trees_close(got["params"], js.params, rtol, atol, "params")
    _assert_trees_close(got["batch_stats"], js.batch_stats, 1e-5, 1e-5, "batch_stats")
    if momentum:
        _assert_trees_close(momentum_to_flax(ts.model, ts.optimizer),
                            js.opt_state[1][0].trace, 1e-3, 1e-5, "momentum")
    assert ts.step == int(js.step)


@pytest.mark.parametrize("pool_backward", ["xla", "pallas"])
def test_one_step_matches_reference(tiles, pool_backward, pallas_interpret):
    """One step from the same TrainState, momentum buffers included: loss
    to 1e-5 relative; params to 1e-6 absolute (an lr-scaled gradient
    whose float32 sums run in another order); the new momentum buffer,
    the gradient plus decay plus 0.9 x the old buffer, to 1e-3 relative /
    1e-5 absolute; BN statistics to 1e-5."""
    cfg = tiny_config(pool_backward)
    js, jl, ts, tl = _run_both(cfg, tiles, 1, 13, momentum=True)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _compare_states(js, ts, 0, 1e-6)


@pytest.mark.parametrize("pool_backward", ["xla", "pallas"])
def test_one_bfloat16_step_matches_reference(tiles, pool_backward):
    """compute_dtype bfloat16: float32 params, logits, loss, gradients,
    momentum and BN statistics around bfloat16 activations. Both sides'
    bfloat16 convs (forward and backward) accumulate in other orders, so
    the gradient carries bfloat16 noise: the reference's own bfloat16
    step lands 3.4e-3 (max) from its float32 step, the update's L2
    distance 7% of the update. Held to: loss within 1e-2 relative,
    params within 5e-3 absolute and the update's distance within 15% of
    its norm, momentum within 5e-3 / lr, BN statistics within 1e-3 of
    each vector's largest magnitude. The pools take ATen's backward
    (pool_backward="pallas" warns), as the reference's take the XLA VJP."""
    cfg = tiny_config(pool_backward)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                             compute_dtype="bfloat16"))
    start = _flat(_seeded(cfg.model, 3, 2)["params"])
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch_pool._warned.clear()
        js, jl, ts, tl = _run_both(cfg, tiles, 1, 13, momentum=True)
    warned = [r for r in rec if "falling back to ATen" in str(r.message)]
    # Once per pool shape: the six pools have 8, 8, 16, 16, 32, 32 channels.
    assert len(warned) == (3 if pool_backward == "pallas" else 0)
    np.testing.assert_allclose(tl, jl, rtol=1e-2)
    got = torch_to_flax(ts.model.state_dict())
    gp, wp = _flat(got["params"]), _flat(dict(js.params))
    assert gp.keys() == wp.keys() and all(v.dtype == np.float32 for v in gp.values())
    for k in wp:
        np.testing.assert_allclose(gp[k], wp[k], rtol=0, atol=5e-3, err_msg=k)
    dist = np.sqrt(sum(((gp[k] - wp[k]) ** 2).sum() for k in wp))
    norm = np.sqrt(sum(((wp[k] - start[k]) ** 2).sum() for k in wp))
    assert dist <= 0.15 * norm, dist / norm
    _assert_trees_close(momentum_to_flax(ts.model, ts.optimizer),
                        js.opt_state[1][0].trace, 0, 5e-3 / 0.05, "momentum")
    gb, wb = _flat(got["batch_stats"]), _flat(dict(js.batch_stats))
    for k in wb:
        assert gb[k].dtype == np.float32
        np.testing.assert_allclose(gb[k], wb[k], rtol=0,
                                   atol=1e-3 * np.abs(wb[k]).max(), err_msg=k)


def test_steps_with_lr_decay_and_ema_match_reference(tiles):
    """Three steps with a staircase LR (0.05, 0.05, then halved) and the
    params EMA. After the first steps the two float32 trajectories part
    a little faster: a near-tie in a pool or a leaky-ReLU input near 0
    resolves differently and moves a few gradient entries (measured 4e-6
    after three steps), so params and EMA are held to 1e-5 absolute and
    1e-4 relative."""
    cfg = tiny_config("xla", lr_decay_rate=0.5, lr_decay_steps=2, ema_decay=0.9)
    js, jl, ts, tl = _run_both(cfg, tiles, 3, 9)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    _compare_states(js, ts, 1e-4, 1e-5, momentum=False)
    ema = torch_to_flax(train.ema_variables(_port(cfg), ts))["params"]
    _assert_trees_close(ema, js.opt_state[-1].ema, 1e-4, 1e-5, "ema")
    assert [train.learning_rate(_port(cfg), i) for i in range(5)] == [0.05, 0.05, 0.025, 0.025, 0.0125]


# --------------------------------------------------------------------- #
# loop, batches, recalibration
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dist", ["single_fixed", "multi_fixed"])
def test_train_loop_matches_reference_schedule(tiles, dist):
    """The same scale sequence, and scheduler scores (EMA of the batch
    accuracies) within 2e-3."""
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, sched=dataclasses.replace(
        cfg.sched, distribution_type=dist))
    variables = _seeded(cfg.model, 3, 4)
    seqs, scheds = {}, {}
    for name in ("jax", "torch"):
        sched = (ScaleScheduler(cfg.sched, seed=0) if name == "jax"
                 else port_scheduler.ScaleScheduler(_port(cfg.sched), seed=0))
        seqs[name] = []
        select = sched.select
        sched.select = lambda select=select, seq=seqs[name]: seq.append(select()) or seq[-1]
        if name == "jax":
            jt = jax_train.Trainer(cfg, tiles[0])
            st = jax_train.train_loop(cfg, jt, _jax_state(jt, variables), sched,
                                      log=lambda *_: None)
            assert int(st.step) == cfg.train.niter
        else:
            tt = train.Trainer(_port(cfg), _port(tiles[0]), device="cpu")
            st = train.train_loop(_port(cfg), tt, tt.init_state(variables=variables),
                                  sched, log=lambda *_: None)
            assert st.step == cfg.train.niter
            assert sorted(tt.step_stats()) == sorted(set(seqs[name]))
        scheds[name] = sched.state_dict()["scores"]
    assert seqs["torch"] == seqs["jax"] and len(seqs["jax"]) == 4
    for k, v in scheds["jax"].items():
        assert (v is None) == (scheds["torch"][k] is None)
        if v is not None:
            np.testing.assert_allclose(scheds["torch"][k], v, atol=2e-3)


def test_sigterm_drains_checkpoints_and_stops(tiles):
    """SIGTERM mid-loop (raised here from on_eval at iteration 2): the loop
    drains the pending scores, calls the checkpointer at the exact
    iteration, returns, and restores the previous handler."""
    import signal

    cfg = _port(tiny_config(niter=1000, eval_every=2, metric_fetch_depth=4))
    tt = train.Trainer(cfg, _port(tiles[0]), device="cpu")
    sched = port_scheduler.ScaleScheduler(cfg.sched, seed=0)
    saved, logs = [], []
    prev = signal.getsignal(signal.SIGTERM)
    state = train.train_loop(
        cfg, tt, tt.init_state(seed=0), sched, log=logs.append,
        on_eval=lambda it, st: signal.raise_signal(signal.SIGTERM),
        checkpointer=lambda it, st, sc: saved.append(
            (it, st.step, sum(sc.state_dict()["counts"].values()))))
    assert saved == [(2, 2, 2)] and state.step == 2
    assert any("signal" in m for m in logs)
    assert signal.getsignal(signal.SIGTERM) == prev


def test_batch_size_for_and_batch_inputs_match_reference(tiles):
    cfg = tiny_config(batch_size=64, rescale_batch_by_area=True)
    jt = jax_train.Trainer(cfg, tiles[0])
    tt = train.Trainer(_port(cfg), _port(tiles[0]), device="cpu")
    for s in (9, 13, 25, 65):
        assert tt.batch_size_for(s) == jt.batch_size_for(s)
    pj, aj = jt.make_batch_inputs(13, k=2)
    pt, at = tt.make_batch_inputs(13, k=2)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    assert pt.dtype == torch.int32 and pt.shape == (2, round(64 * 81 / 169), 3)


def test_recalibrate_batch_stats_matches_reference(tiles):
    """Three train-mode forwards over the same sampled batches: the
    running statistics within 1e-5; the params are left as they were."""
    cfg = tiny_config()
    variables = _seeded(cfg.model, 3, 6)
    jt = jax_train.Trainer(cfg, tiles[0])
    tt = train.Trainer(_port(cfg), _port(tiles[0]), device="cpu")
    want = jt.recalibrate_batch_stats(
        jax.tree.map(jnp.asarray, variables["params"]),
        jax.tree.map(jnp.asarray, variables["batch_stats"]), 3)
    sd = flax_to_torch(variables)
    got = torch_to_flax(tt.recalibrate_batch_stats(sd, 3))
    _assert_trees_close(got["batch_stats"], want, 1e-5, 1e-5, "batch_stats")
    _assert_trees_close(got["params"], variables["params"], 0, 0, "params")
    assert tt.recalibrate_batch_stats(sd, 0) is sd


def test_eval_crops_matches_reference(tiles):
    """Crop validation on held-out tiles put on the device by put_tiles:
    the same confusion matrix; loss and acc within 1e-5."""
    cfg = tiny_config()
    variables = _seeded(cfg.model, 3, 8)
    jt = jax_train.Trainer(cfg, tiles[0])
    tt = train.Trainer(_port(cfg), _port(tiles[0]), device="cpu")
    (jdev, jpad), (tdev, tpad) = jt.put_tiles(tiles[1]), tt.put_tiles(_port(tiles[1]))
    np.testing.assert_array_equal(tdev[0].numpy(), np.asarray(jdev[0]))
    pos = jax_train.BalancedPatchSampler(jpad, 2, pad=jt.pad, seed=17,
                                         balanced=False).sample(12)
    want = jt.eval_crops(_jax_state(jt, variables), jdev, pos, 13)
    got = tt.eval_crops(tt.init_state(variables=variables), tdev, pos, 13)
    np.testing.assert_array_equal(got["confusion"].numpy(), np.asarray(want["confusion"]))
    for k in ("loss", "acc"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)


def test_compile_buckets_leaves_state_untouched(tiles):
    cfg = _port(tiny_config(ema_decay=0.9))
    tt = train.Trainer(cfg, _port(tiles[0]), device="cpu")
    st = tt.init_state(seed=1)
    before = {k: v.clone() for k, v in st.model.state_dict().items()}
    times = tt.compile_buckets(st)
    assert sorted(times) == [9, 13] and all(t > 0 for t in times.values())
    assert st.step == 0 and not st.optimizer.state and not tt.step_marks
    for k, v in st.model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_data_parallel_options_raise(tiles):
    for kw in (dict(num_devices=2), dict(num_devices=2, shard_tiles=True)):
        with pytest.raises(NotImplementedError, match="data parallelism"):
            train.Trainer(_port(tiny_config(**kw)), _port(tiles[0]), device="cpu")


# --------------------------------------------------------------------- #
# entry point
# --------------------------------------------------------------------- #
def test_cli_helpers_match_reference(tmp_path):
    base = tiny_config()
    for data in (DataConfig(dataset="synthetic", dataset_kwargs='{"size": 48, "class_probs": [0.5, 0.5]}'),
                 DataConfig(dataset="vaihingen", val_tiles="11, 15", bands="irrg",
                            extra_bands="dsm,ndsm"),
                 DataConfig(dataset="coffee")):
        cfg = dataclasses.replace(base, data=data)
        assert cli._loader_kwargs(_port(cfg)) == jax_cli._loader_kwargs(cfg)
    tr = load_synthetic(seed=0, num_tiles=1, size=32, num_classes=3, num_bands=4)[0]
    assert (_plain(cli._fix_num_input_bands(_port(base), _port(tr)))
            == _plain(jax_cli._fix_num_input_bands(base, tr)))
    assert (_plain(cli._fix_num_classes(_port(base), _port(tr), log=lambda *_: None))
            == _plain(jax_cli._fix_num_classes(base, tr, log=lambda *_: None)))
    scores = {"oa": 0.9, "kappa": 0.8, "mean_f1": 0.85, "f1": np.array([0.8, 0.9]),
              "infer_wall_s": 1.5,
              "eroded": {"oa": 0.95, "kappa": 0.9, "mean_f1": 0.9, "f1": np.array([1, 0.8])}}
    out = {}
    for name, fn, conv in (("jax", jax_cli._write_scores, lambda c: c),
                           ("torch", cli._write_scores, _port)):
        cfg = dataclasses.replace(base, train=dataclasses.replace(
            base.train, output_path=str(tmp_path / name)))
        fn(conv(cfg), scores, scales=(9, 13))
        out[name] = json.loads((tmp_path / name / "scores.json").read_text())
    assert out["torch"] == out["jax"]


def test_run_training_end_to_end(tmp_path):
    """A tiny run on the CPU: synthetic tiles, scales 9 and 13, 40
    iterations at batch 16, EMA with recalibration, window voting on the
    test tiles. The synthetic classes differ by band signature, so a
    trained net scores well above the 0.5 of chance: bound 0.9."""
    cfg = Config(
        model=ModelConfig(width_multiplier=0.25, pool_backward="pallas"),
        sched=SchedulerConfig(values=(9, 13)),
        train=TrainConfig(niter=40, batch_size=16, eval_every=20,
                          ema_decay=0.9, ema_recalib_batches=4,
                          output_path=str(tmp_path)),
        infer=InferConfig(scales=(9, 13), window_batch=64,
                          save_prediction_maps=False),
        data=DataConfig(dataset="synthetic", dataset_kwargs='{"size": 64}'))
    lines = []
    scores = cli.run_training(_port(cfg), log=lines.append, device="cpu")
    assert scores["oa"] > 0.9, lines
    assert any(line.startswith("[val @ iter 40]") for line in lines)
    assert any("recalibrating BatchNorm" in line for line in lines)
    steps = scores["train_steps"]
    assert sum(s["steps"] for s in steps.values()) == 40
    saved = json.loads((tmp_path / "scores.json").read_text())
    assert saved["oa"] == scores["oa"] and saved["inference"]["scales"] == [9, 13]
