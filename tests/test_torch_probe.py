"""P1's plain PyTorch version (dynseg_torch.ops.int8_probe_conv) against
the probe it ports, scripts/int8_kernel_probe.py: its Pallas kernel
`pallas_conv` in interpret mode and its XLA `reference_conv`. All three
accumulate exactly and round once per epilogue operation, so the int8
outputs are bitwise equal."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynseg_torch.ops import int8_probe_conv
from dynseg_torch.probes import int8_kernel_probe

_PATH = os.path.join(os.path.dirname(__file__), os.pardir, "scripts",
                     "int8_kernel_probe.py")


@pytest.fixture(scope="module")
def jax_probe():
    spec = importlib.util.spec_from_file_location("jax_int8_kernel_probe", _PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# The TPU probe's two check shapes (x in [-127, 127), w in [-8, 8), scale
# 1/512, tile_h 8), then one whose scale drives the output to both clip
# bounds, -128 and +127.
CASES = {
    "b2_h16_c128_d2": dict(shape=(2, 16, 16, 128), dil=2, w=8, scale=1 / 512, tile_h=8),
    "b1_h32_c128_d6": dict(shape=(1, 32, 32, 128), dil=6, w=8, scale=1 / 512, tile_h=8),
    "clip_b1_h8_c64_d1": dict(shape=(1, 8, 24, 64), dil=1, w=128, scale=1 / 8, tile_h=4),
}


def _inputs(case, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 127, case["shape"], dtype=np.int8)
    c = case["shape"][-1]
    w = rng.integers(-case["w"], case["w"], (3, 3, c, c), dtype=np.int8)
    return x, w


@pytest.mark.parametrize("name", sorted(CASES))
def test_ref_matches_jax_probe_bitwise(jax_probe, name):
    case = CASES[name]
    x, w = _inputs(case, seed=len(name))
    got = int8_probe_conv.int8_conv3x3_requant_ref(
        torch.from_numpy(x), torch.from_numpy(w), case["scale"], case["dil"]).numpy()
    want = np.asarray(jax_probe.reference_conv(
        jnp.asarray(x), jnp.asarray(w), case["scale"], case["dil"]))
    kernel = np.asarray(jax_probe.pallas_conv(
        jnp.asarray(x), jnp.asarray(w), case["scale"], case["dil"],
        case["tile_h"], interpret=True))
    assert got.dtype == np.int8 and got.shape == x.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, kernel)
    if name.startswith("clip"):
        assert (got == -128).any() and (got == 127).any()


@pytest.mark.parametrize("offset", [0, 1, 7, 15])
def test_wrapper_on_cpu_takes_plain_version(offset):
    """CPU tensors, at and off 16-byte alignment, take the plain version
    and count no launch of either variant."""
    x, w = _inputs(CASES["b2_h16_c128_d2"], seed=3)
    buf = torch.zeros(x.size + 16, dtype=torch.int8)
    shift = (offset - buf.data_ptr()) % 16
    xt = buf[shift:shift + x.size].view(x.shape)
    xt.copy_(torch.from_numpy(x))
    assert xt.data_ptr() % 16 == offset
    wt = torch.from_numpy(w)
    before = int8_probe_conv.launches, dict(int8_probe_conv.variant_launches)
    got = int8_probe_conv.int8_conv3x3_requant(xt, wt, 1 / 512, 2)
    assert torch.equal(got, int8_probe_conv.int8_conv3x3_requant_ref(
        torch.from_numpy(x), wt, 1 / 512, 2))
    assert (int8_probe_conv.launches, int8_probe_conv.variant_launches) == before


@pytest.mark.parametrize("offset", range(16))
def test_variant_for_alignment(offset):
    """The wgmma variant for a 16-byte-aligned input, the mma.sync
    kernel for a view 1-15 bytes past alignment."""
    want = "wgmma" if offset == 0 else "mma_sync"
    assert int8_probe_conv.variant_for(6, aligned=offset % 16 == 0) == want


@pytest.mark.parametrize("dilation,want", [(1, "wgmma"), (6, "wgmma"), (127, "wgmma"),
                                           (128, "mma_sync"), (300, "mma_sync")])
def test_variant_for_dilation(dilation, want):
    """TMA's im2col corners reach a SAME pad (the dilation) under 128."""
    assert int8_probe_conv.variant_for(dilation) == want
    assert int8_probe_conv.variant_for(dilation, aligned=False) == "mma_sync"


def test_reset_launches():
    int8_probe_conv.launches = 3
    int8_probe_conv.variant_launches["wgmma"] = 2
    int8_probe_conv.reset_launches()
    assert int8_probe_conv.launches == 0
    assert int8_probe_conv.variant_launches == {"mma_sync": 0, "wgmma": 0}


@pytest.mark.parametrize("c", [16, 48, 100])
def test_wrapper_refuses_channels_not_multiple_of_32(c):
    x = torch.zeros((1, 4, 4, c), dtype=torch.int8)
    w = torch.zeros((3, 3, c, c), dtype=torch.int8)
    with pytest.raises(ValueError, match="multiple of 32"):
        int8_probe_conv.int8_conv3x3_requant(x, w, 0.5, 1)


@pytest.mark.parametrize("variant", [None, "wgmma", "mma_sync"])
def test_wrapper_raises_off_cpu_and_cuda(variant):
    x = torch.zeros((1, 4, 4, 32), dtype=torch.int8, device="meta")
    w = torch.zeros((3, 3, 32, 32), dtype=torch.int8, device="meta")
    before = int8_probe_conv.launches, dict(int8_probe_conv.variant_launches)
    with pytest.raises(RuntimeError, match="no kernel"):
        int8_probe_conv.int8_conv3x3_requant(x, w, 0.5, 1, variant)
    assert (int8_probe_conv.launches, int8_probe_conv.variant_launches) == before


def test_probe_refuses_to_run_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert int8_kernel_probe.main(["--check_only"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_probe_peak_table():
    assert int8_kernel_probe.card_peak_tops("NVIDIA H100 80GB HBM3") == 1979.0
    assert int8_kernel_probe.card_peak_tops("NVIDIA H100 PCIe") == 1513.0
    assert int8_kernel_probe.card_peak_tops("NVIDIA A100-SXM4-80GB") is None
