"""dynseg_torch's weight bridge and nets against the Flax reference: the
same numpy-seeded weights and inputs go through both packages, and the
eval forward must agree to float32 tolerance (the bounds of
test_golden_torch.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynseg.config import NET_TYPES, ModelConfig
from dynseg.models import dilated as jax_dilated
from dynseg_torch.bridge import flax_to_torch, init_variables_np, torch_to_flax
from dynseg_torch.models import dilated as torch_dilated


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _seeded_stats(variables, seed):
    """Non-trivial BN running statistics, so the eval BN is exercised."""
    rng = np.random.default_rng(seed)
    for block in variables.get("batch_stats", {}).values():
        bn = block["BatchNorm_0"]
        bn["mean"] = rng.normal(scale=0.3, size=bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    for name, block in variables["params"].items():
        if "BatchNorm_0" in block:
            bn = block["BatchNorm_0"]
            bn["scale"] = rng.uniform(0.5, 1.5, bn["scale"].shape).astype(np.float32)
            bn["bias"] = rng.normal(scale=0.1, size=bn["bias"].shape).astype(np.float32)
    return variables


def test_arch_and_receptive_radius_match_reference():
    assert torch_dilated._ARCH == jax_dilated._ARCH
    for net in NET_TYPES:
        for window in (3, 5):
            cfg = ModelConfig(net_type=net, pool_window=window)
            assert (torch_dilated.receptive_radius(cfg)
                    == jax_dilated.receptive_radius(cfg))


@pytest.mark.parametrize("net_type", NET_TYPES)
@pytest.mark.parametrize("use_bn", [True, False])
def test_init_variables_np_has_flax_structure(net_type, use_bn):
    cfg = ModelConfig(net_type=net_type, num_classes=3, width_multiplier=0.125,
                      use_batch_norm=use_bn)
    x = jax.ShapeDtypeStruct((1, 9, 9, 4), jnp.float32)
    ref = jax.eval_shape(
        lambda x: jax_dilated.build_model(cfg).init(jax.random.key(0), x), x)
    got = init_variables_np(cfg, num_input_bands=4, seed=0)
    want = {k: (tuple(v.shape), np.dtype(v.dtype))
            for k, v in _flat(dict(ref)).items()}
    assert {k: (v.shape, v.dtype) for k, v in _flat(got).items()} == want


@pytest.mark.parametrize("use_bn", [True, False])
def test_bridge_round_trip_is_bitwise(use_bn):
    cfg = ModelConfig(net_type="dilated_icpr_rate6", num_classes=4,
                      width_multiplier=0.25, use_batch_norm=use_bn)
    tree = _seeded_stats(init_variables_np(cfg, num_input_bands=3, seed=1), 2)
    rng = np.random.default_rng(3)
    # A quant collection as quantize_variables writes it: int8 kernels,
    # scalar act_scale, per-channel w_scale, and the int8 exit.
    tree["quant"] = {"__exit__": {"act_scale": np.float32(0.02)}}
    for i in (3, 4, 5):
        conv = tree["params"][f"DilatedConvBlock_{i}"]["Conv_0"]
        conv["kernel"] = rng.integers(-127, 128, conv["kernel"].shape).astype(np.int8)
        tree["quant"][f"DilatedConvBlock_{i}"] = {
            "act_scale": np.asarray(0.05 * i, np.float32),
            "w_scale": rng.uniform(1e-3, 1e-2, conv["kernel"].shape[-1]).astype(np.float32)}
    sd = flax_to_torch(tree)
    assert sd["blocks.3.conv.weight"].dtype == torch.int8
    assert sd["blocks.0.conv.weight"].shape == (16, 3, 5, 5)  # OIHW
    back = _flat(torch_to_flax(sd))
    want = _flat(tree)
    assert back.keys() == want.keys()
    for k, v in want.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        assert back[k].tobytes() == v.tobytes(), k


@pytest.mark.parametrize("net_type", NET_TYPES)
def test_net_matches_flax_apply(net_type):
    width = 0.125 if net_type == "dilated_icpr_rate6_densely" else 0.25
    cfg = ModelConfig(net_type=net_type, num_classes=4, num_input_bands=3,
                      width_multiplier=width, use_batch_norm=True)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 17, 15, 3)).astype(np.float32)
    variables = _seeded_stats(init_variables_np(cfg, num_input_bands=3, seed=1), 6)
    want = np.asarray(jax_dilated.build_model(cfg).apply(
        variables, jnp.asarray(x), train=False))

    net = torch_dilated.build_model(cfg)
    net.load_state_dict(flax_to_torch(variables))
    with torch.inference_mode():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)


def test_net_without_batch_norm_matches_flax_apply():
    """use_batch_norm=False: the conv carries a bias; k=4 blocks pin the
    even-kernel SAME padding."""
    cfg = ModelConfig(net_type="dilated_grsl", num_classes=3, num_input_bands=4,
                      width_multiplier=0.25, use_batch_norm=False)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(1, 20, 23, 4)).astype(np.float32)
    variables = init_variables_np(cfg, num_input_bands=4, seed=8)
    for block in variables["params"].values():
        conv = block["Conv_0"]
        conv["bias"] = rng.normal(scale=0.1, size=conv["bias"].shape).astype(np.float32)
    want = np.asarray(jax_dilated.build_model(cfg).apply(
        variables, jnp.asarray(x), train=False))
    net = torch_dilated.build_model(cfg)
    net.load_state_dict(flax_to_torch(variables))
    with torch.inference_mode():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)
