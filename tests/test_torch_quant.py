"""int8 post-training quantization (dynseg_torch.ops.quant) against
dynseg.ops.quant at full width (the int8 plan and K5 need >= 128-channel
blocks) on a 24 x 24 input, as tests/test_pallas_conv.py runs it.

The JAX side runs the K5 route (quant_conv="pallas", interpret mode on
the CPU), the formulation the port ships: same folded affine, same
epilogue. The logits bound and the argmax equality are those of
test_pallas_conv.py."""

import collections
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dynseg.config import ModelConfig
from dynseg.ops import quant as jax_quant
from dynseg_torch import config as port_config
from dynseg_torch.bridge import flax_to_torch, init_variables_np, torch_to_flax
from dynseg_torch.models.dilated import build_model
from dynseg_torch.ops import int8_conv, pool, quant


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
        xq = h if carried is not None else pool.quantize_act(h, sx)
        a = (sx * p["w_scale"]).float()
        g = torch.rsqrt(p["bn.running_var"].float() + 1e-5) * p["bn.weight"]
        b = p["bn.bias"] - p["bn.running_mean"] * g
        y = int8_conv.int8_block_conv(
            xq.permute(0, 2, 3, 1), p["conv.weight"].permute(2, 3, 1, 0), a * g, b,
            dilation=spec["dilation"], leaky_slope=mcfg.leaky_slope,
            out_scale=nxt).permute(0, 3, 1, 2)
        window = mcfg.pool_window if spec["pool"] else 0
        if nxt is not None:
            h, carried = (pool.max_pool_fwd(y, window) if window else y), nxt
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


def _pre_k6_forward(mcfg, qsd, x):
    """The sequential int8 forward as it ran before K6: each int8 map
    pooled in float32 by ATen and cast back, and the float block whose
    output streams int8 quantized (divide, clamp, round, cast) before its
    pool."""
    dtype = quant.compute_dtype(mcfg)
    packed = quant.pack_blocks(mcfg, qsd)
    specs = quant.block_specs(mcfg, x.shape[-1])

    def quantize(y, sx):
        return torch.round(torch.clamp(y.float() / sx, -127.0, 127.0)).to(torch.int8)

    def pooled(y, window):
        if not window:
            return y
        if y.dtype == torch.int8:
            return quant.pool_forward(y.float(), window).to(torch.int8)
        return quant.pool_forward(y, window)

    h, carried = quant.to_nchw(x.float()), None
    for i, spec in enumerate(specs):
        p = quant._block_params(qsd, spec)
        pc = packed.get(spec["name"])
        out_scale = quant._out_scale(qsd, specs, i)
        window = mcfg.pool_window if spec["pool"] else 0
        if carried is None:
            h = h.to(dtype)
        if pc is not None:
            xq = h if carried is not None else quantize(h, p["act_scale"])
            y = int8_conv.int8_block_conv_packed(xq.permute(0, 2, 3, 1), pc)
            h, carried = pooled(y.permute(0, 3, 1, 2), window), out_scale
            continue
        if carried is not None:
            h = (h.float() * carried).to(dtype)
        y = torch.nn.functional.conv2d(h, p["conv.weight"].to(dtype), padding="same",
                                       dilation=spec["dilation"])
        eps = float(torch.tensor(1e-5, dtype=dtype))
        y = ((y - p["bn.running_mean"].to(dtype)[:, None, None])
             * torch.rsqrt(p["bn.running_var"].to(dtype)[:, None, None] + eps)
             * p["bn.weight"].to(dtype)[:, None, None] + p["bn.bias"].to(dtype)[:, None, None])
        y = torch.nn.functional.leaky_relu(y, mcfg.leaky_slope)
        if out_scale is not None:
            y = quantize(y, out_scale)
        h, carried = pooled(y, window), out_scale
    if carried is not None:
        h = (h.float() * carried).to(dtype)
    logits = torch.nn.functional.conv2d(h.to(dtype), qsd["head.conv.weight"].to(dtype))
    logits = logits + qsd["head.conv.bias"].to(dtype)[:, None, None]
    return logits.float().permute(0, 2, 3, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("exit_int8", [False, True], ids=["float_exit", "int8_exit"])
def test_rate8_int8_forward_equals_the_pre_k6_composition(exit_int8, dtype):
    """dilated_grsl_rate8 at full width (blocks 3-5 int8; block 2 float,
    its output streaming int8): `quant._forward` through K6's op, with
    block 2's quantize fused into its pool, gives bitwise the logits of
    the forward that quantized first and pooled int8 codes in float32."""
    mcfg = port_config.ModelConfig(net_type="dilated_grsl_rate8", num_classes=6,
                                   compute_dtype=dtype)
    sd = flax_to_torch(init_variables_np(mcfg, num_input_bands=3, seed=7))
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(2, 19, 23, 3)).astype(np.float32))
    with torch.inference_mode():
        ranges = quant.calibrate(mcfg, sd, [x[:1]])
        qsd = quant.quantize_variables(mcfg, sd, ranges, exit_int8=exit_int8)
        assert sorted(k for k in qsd if k.endswith("w_scale")) == [
            "blocks.3.w_scale", "blocks.4.w_scale", "blocks.5.w_scale"]
        got = quant._forward(mcfg, qsd, x)
        want = _pre_k6_forward(mcfg, qsd, x)
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("exit_int8", [False, True], ids=["float_exit", "int8_exit"])
def test_bfloat16_mixed_forward_matches_reference_k5_route(exit_int8):
    """compute_dtype bfloat16: calibration over bfloat16 activations (the
    ranges within 1e-5, as in float32), then the mixed forward against
    the reference's K5 route. The float blocks' BatchNorm runs in
    bfloat16 with bfloat16 statistics, and with the float exit block 5's
    K5 launch stores bfloat16. The two sides' bfloat16 convs accumulate
    in other orders and a requantized code may flip with them: logits
    within 3e-2 of their largest magnitude, and the argmax equal except
    where the reference's top two logits are within twice that."""
    cfg = ModelConfig(net_type="dilated_icpr_rate6", num_classes=4, num_input_bands=3,
                      quant_conv="pallas", compute_dtype="bfloat16")
    variables = _seeded(cfg, seed=0)
    x = np.random.default_rng(1).normal(size=(1, 21, 24, 3)).astype(np.float32)
    ranges = jax_quant.calibrate(cfg, variables, [jnp.asarray(x)])
    got_ranges = quant.calibrate(_port(cfg), flax_to_torch(variables), [torch.from_numpy(x)])
    assert got_ranges.keys() == ranges.keys()
    for name, want in ranges.items():
        np.testing.assert_allclose(got_ranges[name], want, rtol=1e-5, err_msg=name)
    qvars = jax_quant.quantize_variables(cfg, variables, ranges, exit_int8=exit_int8)
    want = np.asarray(jax_quant.make_apply(cfg)(qvars, jnp.asarray(x)))
    qsd = quant.quantize_variables(_port(cfg), flax_to_torch(variables), ranges,
                                   exit_int8=exit_int8)
    packed = quant.pack_blocks(_port(cfg), qsd)
    assert [pc.store_dtype for pc in packed.values()] == [
        torch.int8, torch.int8, torch.int8 if exit_int8 else torch.bfloat16]
    with torch.inference_mode():
        got = quant.make_apply(_port(cfg))(qsd, torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    tol = 3e-2 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    differ = got.argmax(-1) != want.argmax(-1)
    top2 = np.sort(want, axis=-1)[..., -2:]
    assert np.all(top2[differ, 1] - top2[differ, 0] < 2 * tol)
    assert differ.mean() <= 0.01


def test_dense_wired_mixed_forward_matches_reference():
    """dilated_icpr_rate6_densely at full width: each quantized block
    (2-5, concat inputs of 131-643 channels) quantizes its own concat
    input, behind the zero lead channels that make its Cin a multiple of
    16 (K5's tensor-core variant), and outputs float32 from K5. The JAX side takes its K5 route
    where the geometry allows and its XLA int8 route elsewhere (the
    ragged concat inputs), so a requantized code may round the other way:
    the bound is the int8 slice test's (labels on >= 99.5% of pixels)
    with the logits within 2e-2 of their largest magnitude."""
    cfg = ModelConfig(net_type="dilated_icpr_rate6_densely", num_classes=4,
                      num_input_bands=3, quant_conv="pallas")
    variables = _seeded(cfg, seed=5)
    x = np.random.default_rng(6).normal(size=(1, 21, 24, 3)).astype(np.float32)
    ranges = jax_quant.calibrate(cfg, variables, [jnp.asarray(x)])
    qvars = jax_quant.quantize_variables(cfg, variables, ranges)
    want = np.asarray(jax_quant.make_apply(cfg)(qvars, jnp.asarray(x)))
    qsd = quant.quantize_variables(_port(cfg), flax_to_torch(variables), ranges)
    assert sorted(k for k in qsd if k.endswith("w_scale")) == [
        f"blocks.{i}.w_scale" for i in (2, 3, 4, 5)]
    packed = quant.pack_blocks(_port(cfg), qsd)
    assert [pc.store_dtype for pc in packed.values()] == [torch.float32] * 4
    assert [pc.variant for pc in packed.values()] == ["wgmma"] * 4
    with torch.inference_mode():
        got = quant.make_apply(_port(cfg))(qsd, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * np.abs(want).max())
    assert np.mean(got.argmax(-1) == want.argmax(-1)) >= 0.995


def test_dense_forward_through_the_quantize_op_equals_the_composition(monkeypatch):
    """A small dense-wired net with blocks 2-5 int8 (width 0.125, min_ch
    16): the forward that quantizes each concat prefix through K7's op, on
    the feature buffer's channel prefix in place, gives the logits of the
    forward that quantizes with the plain composition, bit for bit, and
    calls the op once per int8 block."""
    cfg = ModelConfig(net_type="dilated_icpr_rate6_densely", num_classes=4,
                      num_input_bands=3, width_multiplier=0.125)
    mcfg = _port(cfg)
    sd = flax_to_torch(_seeded(cfg, seed=7))
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(2, 13, 11, 3)).astype(np.float32))
    ranges = quant.calibrate(mcfg, sd, [x[:1]])
    qsd = quant.quantize_variables(mcfg, sd, ranges, min_ch=16)
    assert sorted(k for k in qsd if k.endswith("w_scale")) == [
        f"blocks.{i}.w_scale" for i in (2, 3, 4, 5)]
    calls = []
    op = quant.quantize_s8
    monkeypatch.setattr(quant, "quantize_s8",
                        lambda h, sx: calls.append(h.shape[1]) or op(h, sx))
    with torch.inference_mode():
        got = quant.make_apply(mcfg)(qsd, x)
        monkeypatch.setattr(quant, "quantize_s8", pool.quantize_act)
        want = quant.make_apply(mcfg)(qsd, x)
    lead = quant.dense_lead(3)
    assert calls == [lead + s["cin"] for s in quant.block_specs(mcfg, 3)[2:]]
    assert torch.equal(got, want)


class _OpCalls(TorchDispatchMode):
    """Within it, `calls` counts the operators called, by name."""

    def __init__(self):
        super().__init__()
        self.calls = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls[func.name()] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("net_type, slot_stores", [("dilated_icpr_rate6_densely", 6),
                                                   ("dilated_grsl_rate8", 0),
                                                   ("dilated_icpr_rate6", 0)])
def test_k6_stores_into_slots_in_the_dense_forward_alone(net_type, slot_stores):
    """An int8 forward at full width calls K6's slot-store op once a block
    under the dense wiring, where every block pools into its slot of the
    feature buffer (K6's op that returns a map, never), and never in the
    sequential nets. On the CPU the slot counter stays at 0: it counts
    the card's launches."""
    mcfg = port_config.ModelConfig(net_type=net_type, num_classes=6)
    sd = flax_to_torch(init_variables_np(mcfg, num_input_bands=3, seed=9))
    x = torch.from_numpy(np.random.default_rng(10).normal(
        size=(1, 17, 15, 3)).astype(np.float32))
    qsd = quant.quantize_variables(mcfg, sd, quant.calibrate(mcfg, sd, [x]))
    apply_fn = quant.make_apply(mcfg)
    before = dict(pool.fwd_slot_launches)
    with torch.inference_mode(), _OpCalls() as mode:
        apply_fn(qsd, x)
    assert mode.calls["dynseg_torch::max_pool_s1_into"] == slot_stores
    assert mode.calls["dynseg_torch::max_pool_s1"] == 6 - slot_stores
    assert pool.fwd_slot_launches == before
