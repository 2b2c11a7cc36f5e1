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
from dynseg_torch import config as port_config
from dynseg_torch.bridge import flax_to_torch, init_variables_np, torch_to_flax
from dynseg_torch.models.dilated import build_model
from dynseg_torch.ops import int8_conv, quant


def _port(cfg):
    """The port's ModelConfig with the reference config's field values."""
    return port_config.ModelConfig(**dataclasses.asdict(cfg))


def _seeded(cfg, seed):
    variables = init_variables_np(_port(cfg), num_input_bands=3, seed=seed)
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
    got = quant.calibrate(_port(cfg), flax_to_torch(variables), [torch.from_numpy(x)])
    assert got.keys() == jax_ranges.keys()
    for name, want in jax_ranges.items():
        np.testing.assert_allclose(got[name], want, rtol=1e-5, err_msg=name)


def test_quantize_variables_is_bitwise(setup):
    cfg, variables, _, ranges = setup
    want = jax_quant.quantize_variables(cfg, variables, ranges, exit_int8=True)
    got = torch_to_flax(quant.quantize_variables(
        _port(cfg), flax_to_torch(variables), ranges, exit_int8=True))
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
    qsd = quant.quantize_variables(_port(cfg), flax_to_torch(variables), ranges,
                                   exit_int8=exit_int8)
    assert sorted(k for k in qsd if k.endswith("w_scale")) == [
        "blocks.3.w_scale", "blocks.4.w_scale", "blocks.5.w_scale"]
    with torch.inference_mode():
        got = quant.make_apply(_port(cfg))(qsd, torch.from_numpy(x)).numpy()
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
    net = build_model(_port(cfg))
    net.load_state_dict(sd)
    with torch.inference_mode():
        np.testing.assert_allclose(quant.make_apply(_port(cfg))(sd, x).numpy(),
                                   net(x).numpy(), rtol=1e-5, atol=1e-5)


def _unprepared_forward(mcfg, qsd, x):
    """The int8 forward as it ran before K5's operands were prepared once:
    each block folds A and B and packs its weights at every call, through
    int8_block_conv's public signature."""
    specs = quant.block_specs(mcfg, x.shape[-1])
    h, carried = quant.to_nchw(x), None
    for i, spec in enumerate(specs):
        p = quant._block_params(qsd, spec)
        nxt = (qsd.get("exit.act_scale") if i + 1 == len(specs)
               else qsd.get(quant._prefix(specs[i + 1]) + ".act_scale"))
        if "w_scale" not in p:
            h, carried = quant._block_forward(mcfg, spec, p, h, None, 99.9,
                                              in_scale=carried, out_scale=nxt)
            continue
        sx = carried if carried is not None else p["act_scale"]
        xq = h if carried is not None else quant._quantize_act(h, sx)
        a = (sx * p["w_scale"]).float()
        g = torch.rsqrt(p["bn.running_var"].float() + 1e-5) * p["bn.weight"]
        b = p["bn.bias"] - p["bn.running_mean"] * g
        y = int8_conv.int8_block_conv(
            xq.permute(0, 2, 3, 1), p["conv.weight"].permute(2, 3, 1, 0), a * g, b,
            dilation=spec["dilation"], leaky_slope=mcfg.leaky_slope,
            out_scale=nxt).permute(0, 3, 1, 2)
        window = mcfg.pool_window if spec["pool"] else 0
        if nxt is not None:
            h, carried = (quant._pool_int8(y, window) if window else y), nxt
        else:
            h, carried = (quant.pool_forward(y, window) if window else y), None
    if carried is not None:
        h = h.float() * carried
    logits = torch.nn.functional.conv2d(h, qsd["head.conv.weight"])
    return (logits + qsd["head.conv.bias"][:, None, None]).permute(0, 2, 3, 1)


@pytest.mark.parametrize("exit_int8", [False, True], ids=["float_exit", "int8_exit"])
def test_prepared_operands_give_the_same_int8_forward(setup, exit_int8):
    """K5's operands prepared once per model (`pack_blocks`) give bitwise
    the forward of folding and packing at every call, and the prepared
    operands are made once for repeated calls with the same state_dict."""
    cfg, variables, x, ranges = setup
    mcfg = _port(cfg)
    qsd = quant.quantize_variables(mcfg, flax_to_torch(variables), ranges,
                                   exit_int8=exit_int8)
    packed = quant.pack_blocks(mcfg, qsd)
    assert sorted(packed) == [f"DilatedConvBlock_{i}" for i in (3, 4, 5)]
    for name, pc in packed.items():
        assert pc.w.is_contiguous() and pc.w.shape[0] in (9, 16)
        requant = name != "DilatedConvBlock_5" or exit_int8
        assert (pc.inv_scale is not None) == requant
    xt = torch.from_numpy(x)
    apply_fn = quant.make_apply(mcfg)
    calls = []
    pack = quant.pack_blocks
    quant.pack_blocks = lambda *a, **k: calls.append(1) or pack(*a, **k)
    try:
        with torch.inference_mode():
            got = [apply_fn(qsd, xt) for _ in range(2)]
            want = _unprepared_forward(mcfg, qsd, xt)
    finally:
        quant.pack_blocks = pack
    assert len(calls) == 1
    for g in got:
        assert torch.equal(g, want)
