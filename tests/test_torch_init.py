"""The port's initial weights (dynseg_torch.jax_random,
bridge.init_variables_like_reference, Trainer.init_state) against JAX's
own draw on XLA-CPU.

* The threefry words (`key`, `split`, `fold_in`, `random_bits`) equal
  `jax.random`'s bitwise, at odd shapes and past 2^16 values.
* `uniform`, `truncated_normal`, `lecun_normal` and the float32 `erf`,
  `log1p` and `erf_inv` under them are held within 2 ulp of JAX's, and
  the share that is bitwise is printed (1.0 on an x86-64 host with FMA,
  whose XLA program the port mirrors).
* Flax's key derivation (`_fold_in_static` of a scope path) bitwise.
* The whole variables tree of every net_type, at widths 0.125 and 1.0,
  3 and 4 bands, 2 and 6 classes, against
  `dynseg.train.init_state_template(cfg, jax.random.key(seed))`: the same
  paths, shapes and dtypes, values within 2 ulp; and the port's
  `Trainer.init_state(seed)` against it leaf by leaf.
* The digests that tests/test_torch_cuda.py checks a card's host
  against equal this host's draw.
"""

import dataclasses
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core.scope import _fold_in_static

from dynseg.config import NET_TYPES, Config, ModelConfig
from dynseg.data.datasets import load_synthetic
from dynseg.train import init_state_template
from dynseg_torch import bridge, jax_random, train
from dynseg_torch import config as port_config
from dynseg_torch.data import tiles as port_tiles

SEEDS = (0, 1, 4, 2 ** 31 - 1)


def _raw(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k))


def _bitwise_share(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.mean(got.view(np.uint32) == np.asarray(want).view(np.uint32)))


def _assert_within_2ulp(got, want, what: str) -> None:
    want = np.asarray(want)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape, what
    print(f"{what}: bitwise share {_bitwise_share(got, want):.6f} of {want.size}")
    np.testing.assert_array_max_ulp(got, want, maxulp=2)


# --------------------------------------------------------------------- #
# the threefry words, bitwise
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", SEEDS)
def test_key_is_jax_key(seed):
    np.testing.assert_array_equal(jax_random.key(seed), _raw(jax.random.key(seed)))


@pytest.mark.parametrize("num", [2, 3, 8])
def test_split_is_jax_split(num):
    for seed in SEEDS:
        np.testing.assert_array_equal(jax_random.split(jax_random.key(seed), num),
                                      _raw(jax.random.split(jax.random.key(seed), num)))


@pytest.mark.parametrize("data", [0, 1, 0xDEADBEEF, 2 ** 32 - 1])
def test_fold_in_is_jax_fold_in(data):
    for seed in SEEDS:
        np.testing.assert_array_equal(
            jax_random.fold_in(jax_random.key(seed), data),
            _raw(jax.random.fold_in(jax.random.key(seed), jnp.uint32(data))))


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5, 7), (257, 263), (70001,)])
def test_random_bits_is_jax_bits(shape):
    k = jax.random.fold_in(jax.random.key(4), 17)
    got = jax_random.random_bits(jax_random.fold_in(jax_random.key(4), 17), shape)
    assert got.dtype == np.uint32 and got.shape == shape
    np.testing.assert_array_equal(got, np.asarray(jax.random.bits(k, shape, jnp.uint32)))


def test_fold_in_static_is_flax():
    k = jax.random.key(3)
    for path in [("DilatedConvBlock_0", "Conv_0", 1), ("ScoreHead_0", "Conv_0", 2),
                 ("a", 300), ()]:
        np.testing.assert_array_equal(
            jax_random.fold_in_static(jax_random.key(3), path),
            _raw(_fold_in_static(k, path)), err_msg=str(path))


# --------------------------------------------------------------------- #
# float32
# --------------------------------------------------------------------- #
def _exact_fma(a, b, c) -> np.float32:
    """a * b + c rounded once to float32 (nearest, ties to even)."""
    v = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(v))
    near = [f, np.nextafter(f, np.float32(np.inf)), np.nextafter(f, np.float32(-np.inf))]
    return min(near, key=lambda x: (abs(Fraction(float(x)) - v), int(x.view(np.uint32)) & 1))


def test_fma_rounds_once():
    """The float64 route rounds twice only at a float32 halfway point;
    there the error of the float64 sum decides (a * b below is 1 + 2^-11
    + 2^-24, halfway between two float32 values)."""
    a = np.float32(1 + 2 ** -12)
    for c in (0.0, 2.0 ** -60, -2.0 ** -60, -2.0 ** -11, 2.0 ** -140):
        c = np.float32(c)
        assert jax_random._fma(a, a, c) == _exact_fma(a, a, c), c
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 2000)).astype(np.float32)
    x[2] *= np.float32(1e-3)
    got = jax_random._fma(x[0], x[1], x[2])
    want = [_exact_fma(*x[:, i]) for i in range(x.shape[1])]
    np.testing.assert_array_equal(got, np.array(want, np.float32))


@pytest.mark.parametrize("bounds", [(0.0, 1.0), (-0.9544997, 0.9544997), (-3.0, 2.5)])
def test_uniform_within_2ulp_of_jax(bounds):
    lo, hi = bounds
    k = jax.random.key(7)
    want = jax.random.uniform(k, (300001,), jnp.float32, lo, hi)
    _assert_within_2ulp(jax_random.uniform(jax_random.key(7), (300001,), lo, hi), want,
                        f"uniform{bounds}")


@pytest.mark.parametrize("bounds", [(-2, 2), (-1.5, 3.0), (0.0, 1.0)])
def test_truncated_normal_within_2ulp_of_jax(bounds):
    lo, hi = bounds
    k = jax.random.key(1)
    want = jax.random.truncated_normal(k, lo, hi, (5, 5, 64, 64), jnp.float32)
    _assert_within_2ulp(jax_random.truncated_normal(jax_random.key(1), lo, hi, (5, 5, 64, 64)),
                        want, f"truncated_normal{bounds}")


@pytest.mark.parametrize("name", ["erf", "log1p", "erf_inv"])
def test_special_functions_within_2ulp_of_xla(name):
    rng = np.random.default_rng(2)
    x = {"erf": rng.uniform(-5, 5, 200000),
         "log1p": np.concatenate([rng.uniform(-0.999, 4, 100000),
                                  -rng.uniform(0, 1, 100000) ** 2]),
         "erf_inv": np.concatenate([rng.uniform(-1, 1, 199998), [-1.0, 1.0]])}[name]
    x = x.astype(np.float32)
    want = getattr(jax.lax, name)(x)
    _assert_within_2ulp(getattr(jax_random, name)(x), want, name)


@pytest.mark.parametrize("shape", [(5, 5, 3, 64), (3, 3, 256, 256), (1, 1, 16, 6)])
def test_lecun_normal_within_2ulp_of_flax(shape):
    want = jax.nn.initializers.lecun_normal()(jax.random.key(5), shape, jnp.float32)
    _assert_within_2ulp(jax_random.lecun_normal(jax_random.key(5), shape), want,
                        f"lecun_normal{shape}")


# --------------------------------------------------------------------- #
# the variables tree
# --------------------------------------------------------------------- #
def _jax_tree(cfg: Config, seed: int) -> dict:
    state = init_state_template(cfg, jax.random.key(seed))
    tree = {"params": jax.tree.map(np.asarray, dict(state.params))}
    if state.batch_stats:
        tree["batch_stats"] = jax.tree.map(np.asarray, dict(state.batch_stats))
    return tree


def _assert_trees_within_2ulp(got: dict, want: dict, what: str) -> None:
    got_leaves = jax.tree_util.tree_flatten_with_path(got)[0]
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves], what
    shares = []
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        g = np.asarray(g)
        assert g.dtype == w.dtype and g.shape == w.shape, jax.tree_util.keystr(path)
        np.testing.assert_array_max_ulp(g, w, maxulp=2)
        shares.append((_bitwise_share(g, w), g.size))
    total = sum(n for _, n in shares)
    print(f"{what}: bitwise share {sum(s * n for s, n in shares) / total:.6f} of {total}")


def _model(net_type: str, width: float, bands: int, classes: int,
           use_batch_norm: bool = True) -> ModelConfig:
    return ModelConfig(net_type=net_type, width_multiplier=width, num_input_bands=bands,
                       num_classes=classes, use_batch_norm=use_batch_norm)


def _port(obj):
    """The port's dataclass of the same name (a config, or a TileSet) with
    the reference object's field values."""
    mod = port_tiles if type(obj).__name__ == "TileSet" else port_config
    vals = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    return getattr(mod, type(obj).__name__)(**{
        k: _port(v) if dataclasses.is_dataclass(v) else v for k, v in vals.items()})


@pytest.mark.parametrize("bands,classes,seed", [(3, 2, 0), (4, 6, 2 ** 31 - 1)])
@pytest.mark.parametrize("width", [0.125, 1.0])
@pytest.mark.parametrize("net_type", NET_TYPES)
def test_init_tree_is_init_state_template(net_type, width, bands, classes, seed):
    m = _model(net_type, width, bands, classes)
    want = _jax_tree(Config(model=m), seed)
    got = bridge.init_variables_like_reference(_port(m), bands, seed)
    _assert_trees_within_2ulp(got, want, f"{net_type} x{width} {bands}b {classes}c s{seed}")


def test_init_tree_without_batch_norm():
    """Conv biases in place of BatchNorm: the kernel still draws with its
    scope's first make_rng, the bias (zeros) with the second."""
    m = _model("dilated_icpr_rate6", 0.25, 3, 6, use_batch_norm=False)
    want = _jax_tree(Config(model=m), 4)
    assert "batch_stats" not in want
    _assert_trees_within_2ulp(bridge.init_variables_like_reference(_port(m), 3, 4),
                              want, "no BatchNorm")


@pytest.fixture(scope="module")
def tiles():
    return load_synthetic(seed=0, num_tiles=2, size=40)


@pytest.mark.parametrize("net_type", NET_TYPES)
def test_trainer_init_state_is_jax_init(net_type, tiles):
    """The training path's draw: Trainer.init_state(seed), read back from
    the port's model as a Flax tree, against JAX's init for the seed."""
    cfg = Config(model=_model(net_type, 0.125, 3, 2))
    tr = train.Trainer(_port(cfg), _port(tiles[0]), device="cpu")
    state = tr.init_state(1)
    got = bridge.torch_to_flax(state.model.state_dict())
    want = _jax_tree(cfg, 1)
    assert int(state.model.blocks[0].bn.num_batches_tracked) == 0
    _assert_trees_within_2ulp(got, want, f"Trainer.init_state {net_type}")
    assert torch.equal(state.model.blocks[0].conv.weight,
                       torch.from_numpy(np.transpose(
                           want["params"]["DilatedConvBlock_0"]["Conv_0"]["kernel"],
                           (3, 2, 0, 1)).copy()))


@pytest.mark.parametrize("classes,seed", sorted(bridge.REFERENCE_INIT_SHA256))
def test_pinned_digests_are_the_draw(classes, seed):
    """tests/test_torch_cuda.py checks a card's host against these pins
    (`test_reference_init_on_the_cards_host_is_pinned`): they are
    this host's draw of the full-width dilated_icpr_rate6 (3 bands), so a
    pin cannot go stale (the draw is held to JAX's above)."""
    m = _model("dilated_icpr_rate6", 1.0, 3, classes)
    got = bridge.init_variables_like_reference(_port(m), 3, seed)
    assert bridge.variables_sha256(got) == bridge.REFERENCE_INIT_SHA256[classes, seed]
