"""K4's plain PyTorch version (dynseg_torch.ops.pool) against the JAX
package's Pallas pool backward in interpret mode, on the cases of
tests/test_pallas.py; MaxPoolS1's gradient through torch.autograd; and
the port's default pool backward (ATen, first max in window order)
against XLA's select_and_scatter on tie-rich inputs."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynseg.ops.pool as jax_pool
from dynseg_torch.ops import pool


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one machine: torch's default of
    one intra-op thread per core oversubscribes it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ref(x, g, window=3):
    """The port's plain K4 on NHWC numpy arrays: (y, dx)."""
    xt = torch.from_numpy(x)
    y = pool.pool_forward(xt.permute(0, 3, 1, 2), window).permute(0, 2, 3, 1)
    dx = pool.pallas_pool_bwd(xt, y.contiguous(), torch.from_numpy(g), window)
    return y.numpy(), dx.numpy()


def _jax_pallas(x, g, window=3):
    xj = jnp.asarray(x)
    y = jax_pool.pool_forward(xj, window)
    return np.asarray(y), np.asarray(jax_pool.pallas_pool_bwd(
        xj, y, jnp.asarray(g), window, interpret=True))


def _xla_grad(x, g, window):
    _, vjp = jax.vjp(lambda v: jax_pool.pool_forward(v, window), jnp.asarray(x))
    return np.asarray(vjp(jnp.asarray(g))[0])


# (B, H, W, C, window, ties): the cases of tests/test_pallas.py: distinct
# values, plateaus of integer values, window 5; plus a ragged C.
CASES = [(2, 7, 5, 8, 3, False), (1, 6, 6, 8, 3, True), (1, 8, 8, 8, 5, False),
         (2, 9, 7, 16, 5, True), (1, 5, 11, 3, 3, True)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_plain_pool_bwd_matches_pallas_interpret(case):
    """Bitwise: both count the ties exactly, divide once and add the
    included terms in the same offset order with one rounding each."""
    b, h, w, c, window, ties = case
    rng = np.random.default_rng(sum(case[:5]))
    if ties:
        x = rng.integers(0, 3, (b, h, w, c)).astype(np.float32)
    else:
        x = rng.permutation(b * h * w * c).reshape(b, h, w, c).astype(np.float32)
    g = rng.normal(size=(b, h, w, c)).astype(np.float32)
    y, dx = _ref(x, g, window)
    yj, dxj = _jax_pallas(x, g, window)
    np.testing.assert_array_equal(y, yj)
    np.testing.assert_array_equal(dx, dxj)
    if not ties:  # tie-free: the split equals the first-max routing
        np.testing.assert_allclose(dx, _xla_grad(x, g, window), rtol=0, atol=1e-6)


def test_tie_split_conserves_mass():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 3, (1, 6, 6, 8)).astype(np.float32)
    g = rng.uniform(1, 2, (1, 6, 6, 8)).astype(np.float32)
    _, dx = _ref(x, g)
    np.testing.assert_allclose(dx.sum(), g.sum(), rtol=1e-5)
    # an all-equal window splits its gradient 1/9 per tap
    _, dx0 = _ref(np.zeros((1, 9, 9, 8), np.float32), np.ones((1, 9, 9, 8), np.float32))
    np.testing.assert_allclose(dx0[0, 4, 4, 0], 1.0, rtol=1e-6)


def test_even_window_refused_and_max_pool_s1_warns():
    """An even window: the kernel and its plain version refuse it, and
    max_pool_s1 warns and takes ATen's backward, as the reference warns
    and takes the XLA VJP."""
    x = torch.zeros((1, 8, 8, 8))
    with pytest.raises(ValueError, match="even window"):
        pool.pallas_pool_bwd(x, x, x, window=2)
    xn = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 12, 7, 7)).astype(np.float32)).requires_grad_()
    pool._warned.clear()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        pool.max_pool_s1(xn, 2).sum().backward()
    assert any(issubclass(r.category, RuntimeWarning)
               and "falling back" in str(r.message) for r in rec)
    want = _xla_grad(xn.detach().permute(0, 2, 3, 1).numpy(),
                     np.ones((2, 7, 7, 12), np.float32), 2)
    np.testing.assert_array_equal(xn.grad.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("ties", [False, True])
def test_max_pool_s1_autograd(ties):
    """MaxPoolS1 through torch.autograd on a channels_last NCHW tensor:
    the gradient is the plain tie-split backward of the upstream
    gradient; tie-free, it is also ATen's gradient."""
    rng = np.random.default_rng(7 + ties)
    if ties:
        x_np = rng.integers(0, 3, (2, 8, 9, 6)).astype(np.float32)
    else:
        x_np = rng.permutation(2 * 8 * 9 * 6).reshape(2, 8, 9, 6).astype(np.float32)
    w_np = rng.normal(size=(2, 8, 9, 6)).astype(np.float32)
    x = torch.from_numpy(x_np).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    w = torch.from_numpy(w_np).permute(0, 3, 1, 2)
    y = pool.max_pool_s1(x, 3)
    (y * w).sum().backward()
    _, want = _ref(x_np, w_np)
    np.testing.assert_array_equal(x.grad.permute(0, 2, 3, 1).numpy(), want)
    np.testing.assert_array_equal(y.detach().permute(0, 2, 3, 1).numpy(),
                                  _ref(x_np, w_np)[0])
    if not ties:
        xa = x.detach().clone().requires_grad_()
        (pool.pool_forward(xa, 3) * w).sum().backward()
        np.testing.assert_array_equal(x.grad.numpy(), xa.grad.numpy())


@pytest.mark.parametrize("window", [3, 5, 2])
def test_aten_backward_matches_xla_first_max(window):
    """The port's default pool backward (pool_backward="xla"): ATen routes
    each window's gradient to its first max in window order, as XLA's
    select_and_scatter does; held on integer inputs full of plateaus,
    the kind stacked stride-1 pools produce."""
    rng = np.random.default_rng(window)
    x_np = rng.integers(0, 3, (2, 9, 10, 4)).astype(np.float32)
    g_np = rng.normal(size=(2, 9, 10, 4)).astype(np.float32)
    x = torch.from_numpy(x_np).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    pool.pool_forward(x, window).backward(torch.from_numpy(g_np).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(x.grad.permute(0, 2, 3, 1).numpy(),
                                  _xla_grad(x_np, g_np, window))
