"""K2's plain PyTorch version (dynseg_torch.ops.gather) against the JAX
package's gather: the XLA fallback and the Pallas kernel in interpret
mode, on the cases of tests/test_pallas.py. Labels must be bitwise equal.
Images: bitwise against the XLA fallback (both compute (x - mean) / std
with one float32 rounding per op); within 1e-5 against the Pallas kernel,
which multiplies by 1/std where the plain version divides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dynseg.ops.gather import dihedral_batch as jax_dihedral
from dynseg.ops.gather import gather_batch as jax_gather
from dynseg_torch.ops import gather


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one machine: torch's default of
    one intra-op thread per core oversubscribes it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _case(rng, T, H, W, C, size, B, u8):
    if u8:
        images = rng.integers(0, 256, (T, H, W, C)).astype(np.uint8)
        masks = rng.integers(0, 4, (T, H, W)).astype(np.uint8)
    else:
        images = rng.normal(size=(T, H, W, C)).astype(np.float32)
        masks = rng.integers(0, 4, (T, H, W)).astype(np.int32)
    f = images.astype(np.float32)
    mean = f.mean((0, 1, 2)).astype(np.float32)
    std = f.std((0, 1, 2)).astype(np.float32)
    half = size // 2
    pos = np.stack([rng.integers(0, T, B),
                    rng.integers(half, H - size + half, B),
                    rng.integers(half, W - size + half, B)], 1).astype(np.int32)
    aug = (np.arange(B) % 8).astype(np.int32)  # every dihedral id
    return images, masks, mean, std, pos, aug


def _port(images, masks, mean, std, pos, aug, size):
    imgs, labs = gather.gather_batch(
        *(torch.from_numpy(a) for a in (images, masks, mean, std, pos, aug)),
        size)
    assert imgs.dtype == torch.float32 and labs.dtype == torch.int64
    return imgs.numpy(), labs.numpy()


@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("size", [9, 16, 25])
def test_plain_gather_matches_jax(size, u8):
    rng = np.random.default_rng(size + 100 * u8)
    args = _case(rng, 3, 80, 70, 3, size, 16, u8)
    got_i, got_l = _port(*args, size)
    ij, lj = jax_gather(*args, size, use_pallas=False)
    assert got_i.shape == (16, size, size, 3) and got_l.shape == (16, size, size)
    np.testing.assert_array_equal(got_i, np.asarray(ij))
    np.testing.assert_array_equal(got_l, np.asarray(lj))
    with pltpu.force_tpu_interpret_mode():
        ip, lp = jax_gather(*args, size, use_pallas=True)
    np.testing.assert_allclose(got_i, np.asarray(ip), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got_l, np.asarray(lp))


def test_plain_gather_edge_positions():
    """Centres at the extreme valid corners, as tests/test_pallas.py, plus
    centres whose windows leave the array: starts clamp as
    lax.dynamic_slice clamps them."""
    rng = np.random.default_rng(1)
    size, T, H, W, C = 8, 2, 40, 40, 3
    images = rng.normal(size=(T, H, W, C)).astype(np.float32)
    masks = rng.integers(0, 2, (T, H, W)).astype(np.int32)
    mean = np.zeros(C, np.float32)
    std = np.ones(C, np.float32)
    half = size // 2
    corners = [(0, half, half), (1, H - size + half, W - size + half),
               (0, half, W - size + half), (1, H - size + half, half),
               (0, 8 + half, 8 + half)]
    outside = [(1, 0, 0), (0, H + 5, 3), (0, 2, W - 1), (1, -3, -9)]
    pos = np.array(corners + outside, np.int32)
    aug = (np.arange(len(pos)) % 8).astype(np.int32)
    got_i, got_l = _port(images, masks, mean, std, pos, aug, size)
    ij, lj = jax_gather(images, masks, mean, std, pos, aug, size,
                        use_pallas=False)
    np.testing.assert_array_equal(got_i, np.asarray(ij))
    np.testing.assert_array_equal(got_l, np.asarray(lj))
    n = len(corners)
    with pltpu.force_tpu_interpret_mode():
        ip, lp = jax_gather(images, masks, mean, std, pos[:n], aug[:n], size,
                            use_pallas=True)
    np.testing.assert_allclose(got_i[:n], np.asarray(ip), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got_l[:n], np.asarray(lp))


@pytest.mark.parametrize("channels", [0, 3])
def test_dihedral_batch_matches_jax(channels):
    rng = np.random.default_rng(channels)
    shape = (16, 7, 7) + ((channels,) if channels else ())
    x = rng.normal(size=shape).astype(np.float32)
    k = (np.arange(16) % 8).astype(np.int32)
    got = gather.dihedral_batch(torch.from_numpy(x), torch.from_numpy(k))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_dihedral(
        jnp.asarray(x), jnp.asarray(k))))


def test_gather_rejects_bad_inputs():
    images = torch.zeros((1, 10, 10, 3), dtype=torch.uint8)
    masks = torch.zeros((1, 10, 10), dtype=torch.uint8)
    m = torch.zeros(3)
    pos = torch.zeros((2, 3), dtype=torch.int32)
    aug = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="does not fit"):
        gather.gather_batch(images, masks, m, m, pos, aug, 11)
    with pytest.raises(TypeError, match="uint8 or float32"):
        gather.gather_batch(images.double(), masks, m, m, pos, aug, 5)
    with pytest.raises(ValueError, match="positions"):
        gather.gather_batch(images, masks, m, m, pos[:, :2], aug, 5)
