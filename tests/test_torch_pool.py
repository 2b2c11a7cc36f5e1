"""K4's plain PyTorch version (dynseg_torch.ops.pool) against the JAX
package's Pallas pool backward in interpret mode, on the cases of
tests/test_pallas.py; MaxPoolS1's gradient through torch.autograd; the
port's default pool backward (ATen, first max in window order) against
XLA's select_and_scatter on tie-rich inputs; and K6's operators
(`dynseg_torch::max_pool_s1`, `dynseg_torch::max_pool_s1_into`) on the
CPU, their plain routes, against the compositions the int8 forward ran
before it and the reference's int8 pool (`lax.reduce_window` with an
int8 -128 pad), and the path K6 takes."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynseg.ops.pool as jax_pool
from dynseg_torch.ops import pool
from dynseg_torch.ops.pool import pool_forward


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


@pytest.mark.parametrize("window", [3, 5, 7])
@pytest.mark.parametrize("channels", [64, 128, 256])
def test_variant_for_takes_fused_on_the_nets_pools(channels, window):
    """Every pool of dilated_icpr_rate6 at width 1.0 (C 64, 128, 256) takes
    the one-pass kernel at 25 and 65 px, for windows 3, 5 and 7."""
    for size in (25, 65):
        assert pool.variant_for((100, size, size, channels), window) == "fused"
        assert pool.fused_smem(channels, window, pool.fused_tile(size),
                               pool.fused_tile(size)) <= 227 * 1024


@pytest.mark.parametrize("channels", [3, 5, 19])
def test_variant_for_keeps_twopass_for_ragged_channels(channels):
    """C not a multiple of 4: the rows are not 16-byte strides, which TMA
    needs."""
    assert pool.variant_for((2, 25, 25, channels), 3) == "twopass"


def test_variant_for_keeps_twopass_for_a_misaligned_base():
    assert pool.variant_for((2, 25, 25, 64), 3, aligned=False) == "twopass"
    assert pool.variant_for((2, 25, 25, 64), 3, aligned=True) == "fused"


def test_variant_for_keeps_twopass_past_the_shared_memory():
    """A window so wide that a tile's halos overflow a block's 227 KB."""
    assert pool.fused_smem(64, 21, 16, 16) > 227 * 1024
    assert pool.variant_for((1, 64, 64, 64), 21) == "twopass"


@pytest.mark.parametrize("n, tile", [(1, 1), (9, 9), (16, 16), (17, 9), (25, 13),
                                     (35, 12), (45, 15), (55, 14), (65, 13)])
def test_fused_tile_cuts_an_extent_evenly(n, tile):
    """At most 16 pixels a side, as few tiles as that allows, as even as
    they can be: 65 and 25 cut into 13s, with no tile of 1 pixel."""
    assert pool.fused_tile(n) == tile
    tiles = -(-n // tile)
    assert tiles == -(-n // 16) and (tiles - 1) * tile < n <= tiles * tile


def test_fused_smem_counts_three_boxes():
    """x on 17^2, y and g on 15^2 pixels of 16 channels (13^2 tile, r 1),
    each rounded to 128 bytes, the barrier and 128 bytes of alignment."""
    x, yg = 17 * 17 * 16 * 4, 15 * 15 * 16 * 4
    assert pool.fused_smem(256, 3, 13, 13) == (
        -(-x // 128) * 128 + 2 * (-(-yg // 128) * 128) + 8 + 128)
    # C 8: a slice of 8 channels
    assert pool.fused_smem(8, 3, 13, 13) < pool.fused_smem(16, 3, 13, 13)


def test_nhwc_of_a_channels_last_tensor_is_a_view():
    """The net's activations and gradients are channels_last: the backward
    hands the kernel NHWC views, and copies only other layouts."""
    x = torch.randn(2, 8, 5, 7).contiguous(memory_format=torch.channels_last)
    v = pool._nhwc(x)
    assert v.data_ptr() == x.data_ptr() and v.is_contiguous()
    assert v.shape == (2, 5, 7, 8)
    y = torch.randn(2, 8, 5, 7)
    assert pool._nhwc(y).data_ptr() != y.data_ptr()
    assert torch.equal(pool._nhwc(y), y.permute(0, 2, 3, 1))


def test_bfloat16_max_pool_s1_warns_once_and_takes_aten_backward():
    """A bfloat16 input (compute_dtype bfloat16) is not K4's type: as the
    reference's gate, max_pool_s1 warns once per (shape, dtype, window),
    in the reference's words up to its list of needs, and the gradient is
    ATen's first-max backward in bfloat16; no kernel is launched."""
    x_np = np.random.default_rng(11).integers(0, 4, (2, 7, 9, 12)).astype(np.float32)
    x = torch.from_numpy(x_np).bfloat16().permute(0, 3, 1, 2).requires_grad_()
    g = torch.from_numpy(np.random.default_rng(12).normal(
        size=(2, 12, 7, 9)).astype(np.float32)).bfloat16()
    pool._warned.clear()
    jax_pool._warned_fallbacks.clear()
    before = pool.launches
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        y = pool.max_pool_s1(x, 3)
        pool.max_pool_s1(x.detach(), 3)
        jax_pool._warn_fallback((2, 7, 9, 12), jnp.bfloat16, 3)
    y.backward(g)
    assert pool.launches == before
    got, want = [str(r.message) for r in rec if issubclass(r.category, RuntimeWarning)]
    head = want[:want.index("(needs")]
    assert head == ("--pool_backward pallas requested but unsupported for shape "
                    "(2, 7, 9, 12) dtype bfloat16 window 3 ")
    assert got.startswith(head) and "falling back" in got
    xa = x.detach().clone().requires_grad_()
    torch.nn.functional.max_pool2d(xa, 3, stride=1, padding=1).backward(g)
    assert y.dtype == torch.bfloat16 and x.grad.dtype == torch.bfloat16
    assert torch.equal(x.grad, xa.grad)


# (H, W, C, window): every H and W from 1 to 7, C in {1, 3, 16, 40, 72},
# windows 2 to 5 (even windows split SAME as XLA does, extra after).
FWD = [(1 + i % 7, 1 + (3 * i + 2) % 7, (1, 3, 16, 40, 72)[i % 5], 2 + i % 4)
       for i in range(20)]


def _fwd_input(case, mode):
    """Codes over the whole int8 range, a third of them tied at a few
    values; floats on a grid of half-steps of sx, so that x / sx lands on
    exact .5 boundaries, ties and values past +-127 sx. (x, sx)."""
    h, w, c, window = case
    rng = np.random.default_rng(h * 1000 + w * 100 + c + window)
    shape = (2, h, w, c)
    if mode == "i8":
        codes = rng.integers(-128, 128, shape)
        codes = np.where(rng.random(shape) < 0.33, codes // 64 * 64, codes)
        return torch.from_numpy(codes.astype(np.int8)), None
    sx = torch.tensor(0.0371, dtype=torch.float32)
    half = rng.integers(-300, 301, shape).astype(np.float32)
    x = torch.from_numpy(half) * 0.5 * sx
    return x, (sx if mode == "f32_i8" else None)


def _composition(x, window, sx):
    """What the int8 forward ran before K6, on an NHWC tensor: the
    quantize (divide, clamp, round, cast), then an int8 map pooled in
    float32 by ATen and cast back; a float map pooled by ATen."""
    xc = x.permute(0, 3, 1, 2)
    if sx is not None:
        xc = torch.round(torch.clamp(xc.float() / sx, -127.0, 127.0)).to(torch.int8)
    if xc.dtype == torch.int8:
        y = pool_forward(xc.float(), window).to(torch.int8)
    else:
        y = pool_forward(xc, window)
    return y.permute(0, 2, 3, 1)


@pytest.mark.parametrize("mode", pool.FWD_MODES)
@pytest.mark.parametrize("case", FWD, ids=lambda c: "x".join(map(str, c)))
def test_max_pool_fwd_plain_route_equals_composition(case, mode):
    """The op on the CPU (through `max_pool_fwd`, NCHW in and out) equals
    the composition it replaces, bitwise and in its dtype, and launches
    no kernel."""
    x, sx = _fwd_input(case, mode)
    before = dict(pool.fwd_launches)
    xc = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    got = pool.max_pool_fwd(xc, case[3], sx)
    want = _composition(x, case[3], sx).permute(0, 3, 1, 2)
    assert got.dtype == (torch.float32 if mode == "f32" else torch.int8)
    assert got.shape == xc.shape and torch.equal(got, want)
    assert pool.fwd_launches == before


@pytest.mark.parametrize("window", [2, 3, 4, 5])
def test_pool_then_quantize_equals_quantize_then_pool(window):
    """The kernel's f32_i8 order, the window's float32 max quantized
    once with an IEEE divide, equals quantize-then-pool, bitwise: ties,
    values past +-127 sx, exact .5 boundaries of x / sx (half to even)."""
    x, sx = _fwd_input((7, 6, 40, window), "f32_i8")
    assert bool(((x / sx) % 1 == 0.5).any()) and bool((x / sx).abs().max() > 127)
    pooled = pool_forward(x.permute(0, 3, 1, 2), window)
    got = torch.round(torch.clamp(pooled / sx, -127.0, 127.0)).to(torch.int8)
    want = pool.max_pool_fwd_ref(x, window, sx).permute(0, 3, 1, 2)
    assert torch.equal(got, want)
    assert torch.equal(pool.quantize_act(torch.tensor([0.5, 1.5, -2.5, 1e9]) * sx, sx),
                       torch.tensor([0, 2, -2, 127], dtype=torch.int8))


@pytest.mark.parametrize("window", [2, 3, 4, 5])
def test_int8_route_matches_reference_reduce_window(window):
    """The i8 route against the reference's int8 pool, lax.reduce_window
    with an int8 -128 pad and XLA's SAME split."""
    x, _ = _fwd_input((5, 7, 16, window), "i8")
    want = jax.lax.reduce_window(jnp.asarray(x.numpy()), jnp.int8(-128), jax.lax.max,
                                 (1, window, window, 1), (1, 1, 1, 1), "SAME")
    got = pool.max_pool_fwd_ref(x, window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", pool.FWD_MODES)
def test_max_pool_s1_op_schema_and_fake(mode):
    """The registered op's schema, fake (meta) and CPU implementations
    agree (torch.library.opcheck)."""
    x, sx = _fwd_input((5, 6, 16, 3), mode)
    torch.library.opcheck(torch.ops.dynseg_torch.max_pool_s1.default, (x, 3, sx),
                          test_utils=("test_schema", "test_faketensor"))


# K6 storing into a channel slot: (buffer C, slot offset, C). The densely
# net's six slots in its 912-channel feature buffer, a slot off 4 floats,
# ragged C 3 and 40, and a slot that is the whole buffer.
SLOTS = [(912, 16, 64), (912, 80, 64), (912, 144, 128), (912, 272, 128), (912, 400, 256),
         (912, 656, 256), (912, 18, 64), (48, 5, 3), (48, 8, 40), (16, 0, 16)]


def _slot_buffer(buf_c, mode):
    """A (2, 5, 7, buf_c) NHWC buffer of the mode's output dtype filled
    with a canary that no pool of `_fwd_input` gives: 1234.5 in float32,
    -100 in int8 (the tests keep their codes above it)."""
    if mode == "f32":
        return torch.full((2, 5, 7, buf_c), 1234.5)
    return torch.full((2, 5, 7, buf_c), -100, dtype=torch.int8)


@pytest.mark.parametrize("mode", pool.FWD_MODES)
@pytest.mark.parametrize("case", SLOTS, ids=lambda c: "x".join(map(str, c)))
def test_max_pool_fwd_into_plain_route_writes_its_slot_alone(case, mode):
    """The slot-store op on the CPU, through `max_pool_fwd_into` on the
    NCHW view of a channel slot, writes `max_pool_fwd_ref` there bit for
    bit, leaves every other channel as it was, returns the view itself,
    and launches no kernel."""
    buf_c, at, c = case
    x, sx = _fwd_input((5, 7, c, 3), mode)
    if mode == "i8":
        x = torch.clamp(x, min=-99)
    buf = _slot_buffer(buf_c, mode)
    before = dict(pool.fwd_slot_launches), dict(pool.fwd_launches)
    xc = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    slot = buf.permute(0, 3, 1, 2)[:, at:at + c]
    assert pool.max_pool_fwd_into(xc, 3, sx, slot) is slot
    assert torch.equal(buf[..., at:at + c], pool.max_pool_fwd_ref(x, 3, sx))
    assert torch.equal(buf[..., :at], _slot_buffer(at, mode))
    assert torch.equal(buf[..., at + c:], _slot_buffer(buf_c - at - c, mode))
    assert (dict(pool.fwd_slot_launches), dict(pool.fwd_launches)) == before


@pytest.mark.parametrize("mode", pool.FWD_MODES)
def test_max_pool_s1_into_op_schema_and_fake(mode):
    """The slot-store op's schema (it mutates `out` alone), fake (meta)
    and CPU implementations agree (torch.library.opcheck), into a channel
    slot of a wider buffer."""
    x, sx = _fwd_input((5, 7, 16, 3), mode)
    out = _slot_buffer(48, mode)[..., 16:32]
    torch.library.opcheck(torch.ops.dynseg_torch.max_pool_s1_into.default, (x, 3, sx, out),
                          test_utils=("test_schema", "test_faketensor"))


@pytest.mark.parametrize("shape, dtype", [((2, 5, 7, 20), torch.float32),
                                          ((2, 5, 7, 16), torch.int8)],
                         ids=["shape", "dtype"])
def test_max_pool_fwd_into_refuses_another_shape_or_dtype(shape, dtype):
    x, _ = _fwd_input((5, 7, 16, 3), "f32")
    out = torch.zeros(shape, dtype=dtype)
    with pytest.raises(ValueError, match="out must be"):
        pool.max_pool_fwd_into(x.permute(0, 3, 1, 2), 3, None, out.permute(0, 3, 1, 2))


# K6's path: (mode, C, output pixel stride, x offset, y offset in bytes,
# path). The densely slots at offsets of 4 floats, a slot off 4 floats, a
# stride off 4, ragged C, a base off 16 bytes, i8's 16-code pieces and
# f32_i8's 4-byte stores.
FWD_PATH_CASES = [
    ("f32", 64, 912, 0, 16 * 4, "vec16"), ("f32", 256, 912, 0, 656 * 4, "vec16"),
    ("f32", 64, 64, 0, 0, "vec16"), ("f32", 64, 912, 0, 18 * 4, "scalar"),
    ("f32", 64, 914, 0, 0, "scalar"), ("f32", 3, 48, 0, 0, "scalar"),
    ("f32", 40, 40, 4, 0, "scalar"), ("i8", 128, 128, 0, 0, "vec16"),
    ("i8", 128, 136, 0, 0, "scalar"), ("i8", 40, 40, 0, 0, "scalar"),
    ("f32_i8", 128, 128, 0, 4, "vec16"), ("f32_i8", 128, 128, 0, 2, "scalar"),
]


@pytest.mark.parametrize("case", FWD_PATH_CASES, ids=lambda c: "x".join(map(str, c)))
def test_fwd_path_takes_vec16_on_whole_aligned_pieces(case):
    mode, c, ldy, x_off, y_off, path = case
    assert pool.fwd_path(mode, c, ldy, 1024 + x_off, 2048 + y_off) == path


def test_dense_slots_take_the_vec16_path():
    """Every block of dilated_icpr_rate6_densely at full width pools (f32,
    from K5's or the float block's own map) into its slot of the
    912-channel feature buffer (channels 16, 80, 144, 272, 400, 656) on
    K6's 16-byte path."""
    from dynseg_torch.config import ModelConfig
    from dynseg_torch.ops import quant

    mcfg = ModelConfig(net_type="dilated_icpr_rate6_densely", num_classes=6)
    specs = quant.block_specs(mcfg, 3)
    lead = quant.dense_lead(3)
    width = lead + specs[-1]["cin"] + specs[-1]["cout"]
    slots = [(lead + s["cin"], s["cout"]) for s in specs]
    assert all(s["pool"] for s in specs)
    assert slots == [(16, 64), (80, 64), (144, 128), (272, 128), (400, 256), (656, 256)]
    assert {pool.fwd_path("f32", c, width, 0, at * 4) for at, c in slots} == {"vec16"}


@pytest.mark.parametrize("dtype, scaled", [(torch.bfloat16, False), (torch.int8, True),
                                           (torch.float64, False)])
def test_max_pool_fwd_refuses_other_types(dtype, scaled):
    x = torch.zeros((1, 4, 5, 6), dtype=dtype)
    with pytest.raises(TypeError, match="int8 codes, or float32"):
        pool.max_pool_fwd(x, 3, torch.tensor(0.1) if scaled else None)


# K7, the quantize of a float map: (buffer channels, channels quantized,
# zero lead channels). A 144-channel prefix of a 160-channel buffer behind
# the dense forward's 13 zero lead channels, ragged C 3 and 40 (the whole
# buffer and a prefix), and a 16-channel map.
QUANT = [(160, 144, 13), (3, 3, 0), (40, 40, 0), (48, 40, 5), (16, 16, 0)]


def _quant_buffer(buf_c, lead, dtype, seed):
    """An NHWC buffer of half-steps of sx (ties, values past +-127 sx)
    behind `lead` zero channels, in `dtype`, and sx. A power-of-two sx
    keeps bfloat16's half-steps exact near 0."""
    rng = np.random.default_rng(seed)
    sx = torch.tensor(0.25 if dtype == torch.bfloat16 else 0.0371)
    half = rng.integers(-300, 301, (2, 5, 7, buf_c)).astype(np.float32)
    buf = (torch.from_numpy(half) * 0.5 * sx).to(dtype)
    buf[..., :lead] = 0
    return buf, sx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", QUANT, ids=lambda c: "x".join(map(str, c)))
def test_quantize_s8_plain_route_equals_quantize_act(case, dtype):
    """The op on the CPU, through `quantize_s8` on the NCHW view of a
    channel prefix, equals `quantize_act` of the same prefix bit for bit:
    ties to even, values past +-127 sx clamped, the zero lead codes 0. It
    returns NCHW views of NHWC-contiguous int8 codes and launches no
    kernel."""
    buf_c, c, lead = case
    buf, sx = _quant_buffer(buf_c, lead, dtype, seed=sum(case))
    ratio = buf[..., :c].float() / sx
    assert bool((ratio % 1 == 0.5).any()) and bool(ratio.abs().max() > 127)
    before = dict(pool.quantize_launches)
    got = pool.quantize_s8(buf.permute(0, 3, 1, 2)[:, :c], sx)
    want = pool.quantize_act(buf[..., :c], sx)
    assert got.dtype == torch.int8 and got.shape == (2, c, 5, 7)
    assert got.permute(0, 2, 3, 1).is_contiguous()
    assert torch.equal(got.permute(0, 2, 3, 1), want)
    assert not got[:, :lead].any()
    assert pool.quantize_launches == before
    steps = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, 127.5, -127.5, 1e9, -1e9, 0.0])
    codes = pool.quantize_s8((steps * 0.25).to(dtype).view(1, 10, 1, 1), torch.tensor(0.25))
    assert codes.flatten().tolist() == [0, 2, 2, 0, -2, 127, -127, 127, -127, 0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("prefix", [False, True], ids=["whole", "prefix"])
def test_quantize_s8_op_schema_and_fake(dtype, prefix):
    """The registered op's schema, fake (meta) and CPU implementations
    agree (torch.library.opcheck), on a whole map and on a channel prefix
    of a wider buffer; the fake gives the input's shape in int8."""
    buf, sx = _quant_buffer(160, 13, dtype, seed=3)
    x = buf[..., :144] if prefix else buf
    op = torch.ops.dynseg_torch.quantize_s8.default
    torch.library.opcheck(op, (x, sx), test_utils=("test_schema", "test_faketensor"))
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        y = op(mode.from_tensor(x), mode.from_tensor(sx))
    assert y.shape == x.shape and y.dtype == torch.int8 and y.is_contiguous()


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int8], ids=str)
def test_quantize_s8_refuses_other_types(dtype):
    with pytest.raises(TypeError, match="float32 or bfloat16 map"):
        pool.quantize_s8(torch.zeros((1, 4, 5, 6), dtype=dtype), torch.tensor(0.1))


# (C, element bytes, base offset in bytes, pixel stride in elements, path).
PATHS = [(144, 4, 0, 912, "vec16"), (656, 4, 0, 912, "vec16"), (144, 2, 0, 912, "vec16"),
         (16, 4, 0, 16, "vec16"), (3, 4, 0, 3, "scalar"), (40, 4, 0, 48, "scalar"),
         (144, 4, 4, 912, "scalar"), (144, 4, 0, 913, "scalar"), (16, 2, 0, 20, "scalar")]


@pytest.mark.parametrize("case", PATHS, ids=lambda c: "x".join(map(str, c)))
def test_quantize_path_takes_vec16_on_whole_aligned_pieces(case):
    c, elem, offset, stride, path = case
    assert pool.quantize_path(c, elem, 1024 + offset, stride) == path


@pytest.mark.parametrize("elem", [4, 2], ids=["float32", "bfloat16"])
def test_dense_prefixes_take_the_vec16_path(elem):
    """Every int8 block of dilated_icpr_rate6_densely at full width reads
    a prefix of the feature buffer (the zero lead, the bands, the earlier
    slots: 144 / 272 / 400 / 656 channels of 912) that K7 takes on its
    16-byte path."""
    from dynseg_torch.config import ModelConfig
    from dynseg_torch.ops import quant

    mcfg = ModelConfig(net_type="dilated_icpr_rate6_densely", num_classes=6)
    specs = quant.block_specs(mcfg, 3)
    lead = quant.dense_lead(3)
    width = lead + specs[-1]["cin"] + specs[-1]["cout"]
    slots = [lead + s["cin"] for s, q in zip(specs, quant.quant_plan(mcfg, 3)) if q]
    assert (slots, width) == ([144, 272, 400, 656], 912)
    assert {pool.quantize_path(c, elem, 0, width) for c in slots} == {"vec16"}
