"""int8 post-training quantization (dynseg_torch.ops.quant) against
dynseg.ops.quant at full width (the int8 plan and K5 need >= 128-channel
blocks) on a 24 x 24 input, as tests/test_pallas_conv.py runs it.

The JAX side runs the K5 route (quant_conv="pallas", interpret mode on
the CPU), the formulation the port ships: same folded affine, same
epilogue. The logits bound and the argmax equality are those of
test_pallas_conv.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynseg.config import ModelConfig
from dynseg.ops import quant as jax_quant
from dynseg_torch.bridge import flax_to_torch, init_variables_np, torch_to_flax
from dynseg_torch.models.dilated import build_model
from dynseg_torch.ops import quant


def _seeded(cfg, seed):
    variables = init_variables_np(cfg, num_input_bands=3, seed=seed)
    rng = np.random.default_rng(seed + 100)
    for block in variables.get("batch_stats", {}).values():
        bn = block["BatchNorm_0"]
        bn["mean"] = rng.normal(scale=0.2, size=bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    return variables


@pytest.fixture(scope="module")
def setup():
    cfg = ModelConfig(net_type="dilated_icpr_rate6", num_classes=4,
                      num_input_bands=3, quant_conv="pallas")
    variables = _seeded(cfg, seed=0)
    x = np.random.default_rng(1).normal(size=(1, 21, 24, 3)).astype(np.float32)
    jax_ranges = jax_quant.calibrate(cfg, variables, [jnp.asarray(x)])
    return cfg, variables, x, jax_ranges


def test_calibrate_matches_reference(setup):
    cfg, variables, x, jax_ranges = setup
    got = quant.calibrate(cfg, flax_to_torch(variables), [torch.from_numpy(x)])
    assert got.keys() == jax_ranges.keys()
    for name, want in jax_ranges.items():
        np.testing.assert_allclose(got[name], want, rtol=1e-5, err_msg=name)


def test_quantize_variables_is_bitwise(setup):
    cfg, variables, _, ranges = setup
    want = jax_quant.quantize_variables(cfg, variables, ranges, exit_int8=True)
    got = torch_to_flax(quant.quantize_variables(
        cfg, flax_to_torch(variables), ranges, exit_int8=True))
    assert got["quant"].keys() == want["quant"].keys()
    for name, q in want["quant"].items():
        for key, value in q.items():
            assert got["quant"][name][key].tobytes() == np.asarray(value).tobytes()
        if name.startswith("Dilated"):
            kernel = np.asarray(want["params"][name]["Conv_0"]["kernel"])
            assert kernel.dtype == np.int8
            np.testing.assert_array_equal(
                got["params"][name]["Conv_0"]["kernel"], kernel)


@pytest.mark.parametrize("exit_int8", [False, True], ids=["float_exit", "int8_exit"])
def test_mixed_forward_matches_reference_k5_route(setup, exit_int8):
    cfg, variables, x, ranges = setup
    qvars = jax_quant.quantize_variables(cfg, variables, ranges, exit_int8=exit_int8)
    want = np.asarray(jax_quant.make_apply(cfg)(qvars, jnp.asarray(x)))
    qsd = quant.quantize_variables(cfg, flax_to_torch(variables), ranges,
                                   exit_int8=exit_int8)
    assert sorted(k for k in qsd if k.endswith("w_scale")) == [
        "blocks.3.w_scale", "blocks.4.w_scale", "blocks.5.w_scale"]
    with torch.inference_mode():
        got = quant.make_apply(cfg)(qsd, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("net_type", ["dilated_icpr_rate6",
                                      "dilated_icpr_rate6_densely"])
@pytest.mark.parametrize("use_bn", [True, False])
def test_float_mirror_matches_model(net_type, use_bn):
    """With no quantized block the functional forward is the nets'."""
    cfg = dataclasses.replace(
        ModelConfig(num_classes=3, width_multiplier=0.125, use_batch_norm=use_bn),
        net_type=net_type)
    sd = flax_to_torch(_seeded(cfg, seed=2))
    x = torch.from_numpy(
        np.random.default_rng(3).normal(size=(2, 13, 11, 3)).astype(np.float32))
    net = build_model(cfg)
    net.load_state_dict(sd)
    with torch.inference_mode():
        np.testing.assert_allclose(quant.make_apply(cfg)(sd, x).numpy(),
                                   net(x).numpy(), rtol=1e-5, atol=1e-5)
