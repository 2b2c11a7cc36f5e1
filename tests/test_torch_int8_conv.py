"""K5's plain PyTorch version (dynseg_torch.ops.int8_conv) against the
Pallas kernel it ports, dynseg.ops.pallas_conv.int8_block_conv, run in
interpret mode on the CPU as the reference's own tests run it.

The int8 (requantized) output must be bitwise equal: both accumulate
exactly and round once per epilogue operation. The float32 output may
differ by float32 rounding only (XLA on the CPU fuses the epilogue's
multiply-add into an FMA), hence atol 1e-5 on values of order 1."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynseg.ops import pallas_conv
from dynseg_torch.ops import int8_conv

# The cases of tests/test_pallas_conv.py: k3 d5 (block 4's geometry),
# the even k4 d4 (block 3's asymmetric SAME pad), and an odd H/W with
# 128 -> 256 channels.
CASES = {
    "k3d5": dict(k=3, dil=5, cin=128, cout=128, shape=(2, 24, 22), xr=127, wr=8,
                 out_scale=0.05),
    "k4d4_even": dict(k=4, dil=4, cin=128, cout=128, shape=(1, 16, 19), xr=64, wr=4,
                      out_scale=0.005),
    "k3d6_odd_hw": dict(k=3, dil=6, cin=128, cout=256, shape=(1, 21, 17), xr=127, wr=8,
                        out_scale=0.05),
}


def _inputs(case, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-case["xr"], case["xr"], (*case["shape"], case["cin"]),
                     dtype=np.int8)
    w = rng.integers(-case["wr"], case["wr"],
                     (case["k"], case["k"], case["cin"], case["cout"]),
                     dtype=np.int8)
    a = rng.uniform(1e-4, 3e-4, case["cout"]).astype(np.float32)
    b = rng.normal(scale=0.1, size=case["cout"]).astype(np.float32)
    return x, w, a, b


@pytest.mark.parametrize("requant", [True, False], ids=["int8_out", "f32_out"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_ref_matches_pallas_interpret(name, requant):
    case = CASES[name]
    x, w, a, b = _inputs(case, seed=len(name))
    out_scale = case["out_scale"] if requant else None
    want = np.asarray(pallas_conv.int8_block_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(a), jnp.asarray(b),
        dilation=case["dil"], leaky_slope=0.1, out_scale=out_scale,
        out_dtype=jnp.float32, interpret=True))
    got = int8_conv.int8_block_conv_ref(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(a),
        torch.from_numpy(b), dilation=case["dil"], leaky_slope=0.1,
        out_scale=out_scale).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if requant:
        np.testing.assert_array_equal(got, want)
        # The case must exercise the clip and the sign of the leak.
        assert (got == 127).any() and (got < 0).any()
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_wrapper_on_cpu_takes_plain_version():
    x, w, a, b = _inputs(CASES["k3d5"], seed=1)
    args = [torch.from_numpy(v) for v in (x, w, a, b)]
    before = int8_conv.launches
    got = int8_conv.int8_block_conv(*args, dilation=5, leaky_slope=0.1,
                                    out_scale=0.05)
    want = int8_conv.int8_block_conv_ref(*args, dilation=5, leaky_slope=0.1,
                                         out_scale=0.05)
    assert torch.equal(got, want)
    assert int8_conv.launches == before  # no kernel launched on the CPU


def test_bfloat16_output_is_not_ported():
    x, w, a, b = _inputs(CASES["k3d5"], seed=2)
    with pytest.raises(NotImplementedError):
        int8_conv.int8_block_conv(
            *(torch.from_numpy(v) for v in (x, w, a, b)), dilation=5,
            leaky_slope=0.1, out_dtype=torch.bfloat16)


@pytest.mark.parametrize("shape,want", [
    ((128, 128, 4, 4), "wgmma"), ((128, 256, 3, 5), "wgmma"), ((256, 256, 3, 6), "wgmma"),
    ((16, 16, 3, 2), "wgmma"), ((144, 64, 4, 4), "wgmma"), ((131, 128, 4, 3), "dp4a"),
    ((128, 68, 4, 4), "dp4a"), ((3, 5, 5, 1), "dp4a"), ((128, 128, 3, 128), "dp4a"),
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_variant_by_shape(shape, want):
    """The tensor cores take 16-byte channel pieces and a SAME pad under
    128 pixels (TMA's im2col window); every other shape takes dp4a."""
    cin, cout, k, dil = shape
    assert int8_conv.variant_for(cin, cout, k, dil) == want
    w = torch.zeros((k, k, cin, cout), dtype=torch.int8)
    pc = int8_conv.pack_conv(w, torch.zeros(cout), torch.zeros(cout), dilation=dil,
                             leaky_slope=0.1, out_scale=0.05)
    assert pc.variant == want and pc.w.shape == (k * k, cout, cin)
    assert pc.inv_scale == np.float32(1.0 / 0.05)
