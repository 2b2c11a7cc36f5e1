"""dynseg_torch's CUDA kernels on the card: K5 (csrc/int8_block_conv.cu),
K2 (csrc/patch_gather.cu), K4 (csrc/pool_bwd.cu) and P1
(csrc/int8_conv3x3.cu) against their plain PyTorch versions, and the int8 serving path and a train step on the card
against the same on the CPU. Marked `gpu`; every test skips where
torch.cuda.is_available() is false. On a machine with a card and without
JAX (these tests import none), run

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from dynseg_torch.ops import gather, int8_conv, int8_probe_conv, pool

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


# (B, H, W, Cin, Cout, k, dilation, requant, variant): the slice's three
# block geometries at batch 1 and as a window batch of 256 x 25^2, then
# ragged tiles: M not a multiple of 128 (with Cout 256 and 192), Cin 144 (a
# partial K chunk), a 1 x 1 image, Cin 48 with k 5; then the dp4a variant:
# Cout 68 and 4, Cin 131 (the dense-wired net's block 2), 24, 3, Cout 30, 5.
SHAPES = [
    (1, 96, 96, 128, 128, 4, 4, True, "wgmma"),
    (1, 96, 96, 128, 256, 3, 5, True, "wgmma"),
    (1, 96, 96, 256, 256, 3, 6, False, "wgmma"),
    (256, 25, 25, 128, 128, 4, 4, True, "wgmma"),
    (256, 25, 25, 128, 256, 3, 5, True, "wgmma"),
    (256, 25, 25, 256, 256, 3, 6, False, "wgmma"),
    (3, 25, 25, 128, 192, 3, 5, True, "wgmma"),
    (2, 7, 130, 256, 256, 3, 6, True, "wgmma"),
    (1, 21, 17, 144, 64, 4, 4, False, "wgmma"),
    (1, 1, 1, 16, 16, 3, 2, False, "wgmma"),
    (2, 13, 11, 48, 32, 5, 1, True, "wgmma"),
    (1, 21, 17, 144, 68, 4, 4, False, "dp4a"),
    (1, 1, 1, 16, 4, 3, 2, False, "dp4a"),
    (2, 13, 10, 131, 128, 4, 3, True, "dp4a"),
    (1, 9, 11, 24, 30, 3, 2, True, "dp4a"),
    (1, 5, 7, 3, 5, 5, 1, False, "dp4a"),
]


def _k5_case(cuda, shape):
    b, h, w, cin, cout, k, dil, requant = shape[:8]
    rng = np.random.default_rng(sum(shape[:8]))
    x = torch.from_numpy(rng.integers(-127, 128, (b, h, w, cin), dtype=np.int8)).to(cuda)
    wt = torch.from_numpy(rng.integers(-127, 128, (k, k, cin, cout), dtype=np.int8)).to(cuda)
    a = torch.from_numpy(rng.uniform(1e-6, 3e-6, cout).astype(np.float32)).to(cuda)
    bias = torch.from_numpy(rng.normal(0, 0.1, cout).astype(np.float32)).to(cuda)
    kw = dict(dilation=dil, leaky_slope=0.1, out_scale=0.05 if requant else None)
    return (x, wt, a, bias), kw


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain_bitwise(cuda, shape):
    args, kw = _k5_case(cuda, shape)
    variant = shape[-1]
    k, dil = args[1].shape[0], kw["dilation"]
    assert int8_conv.variant_for(args[0].shape[3], args[1].shape[3], k, dil) == variant
    before, before_v = int8_conv.launches, int8_conv.variant_launches[variant]
    got = int8_conv.int8_block_conv(*args, **kw)
    assert int8_conv.launches == before + 1
    assert int8_conv.variant_launches[variant] == before_v + 1
    want = int8_conv.int8_block_conv_ref(*args, **kw)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [s for s in SHAPES if s[-1] == "wgmma"],
                         ids=lambda s: "x".join(map(str, s[:8])))
def test_dp4a_variant_matches_plain_bitwise_on_aligned_shapes(cuda, shape):
    """dp4a, PR 1's kernel, named on the shapes the tensor cores take."""
    args, kw = _k5_case(cuda, shape)
    pc = int8_conv.pack_conv(*args[1:], **kw)
    before = int8_conv.variant_launches["dp4a"]
    got = int8_conv.int8_block_conv_packed(args[0], pc, "dp4a")
    assert int8_conv.variant_launches["dp4a"] == before + 1
    want = int8_conv.int8_block_conv_packed_ref(args[0], pc)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bfloat16_output_matches_plain_bitwise(cuda, shape):
    """The bfloat16 store (the int8 forward under compute_dtype bfloat16)
    at every case, in the shape's variant and in dp4a: one launch each,
    counted as a bfloat16 output, bitwise equal to plain."""
    args, kw = _k5_case(cuda, shape)
    kw.update(out_scale=None, out_dtype=torch.bfloat16)
    pc = int8_conv.pack_conv(*args[1:], **kw)
    want = int8_conv.int8_block_conv_packed_ref(args[0], pc)
    assert want.dtype == torch.bfloat16
    for variant in sorted({shape[-1], "dp4a"}):
        before, before_bf = int8_conv.variant_launches[variant], int8_conv.out_launches["bfloat16"]
        got = int8_conv.int8_block_conv_packed(args[0], pc, variant)
        assert int8_conv.variant_launches[variant] == before + 1
        assert int8_conv.out_launches["bfloat16"] == before_bf + 1
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16 and torch.equal(got, want), variant
    assert torch.equal(int8_conv.int8_block_conv(*args, **kw), want)


def test_tensor_core_variant_refuses_ragged_channels(cuda):
    args, kw = _k5_case(cuda, SHAPES[-3])
    pc = int8_conv.pack_conv(*args[1:], **kw)
    with pytest.raises(ValueError, match="multiples of 16"):
        int8_conv.int8_block_conv_packed(args[0], pc, "wgmma")


def test_kernel_refuses_strided_input(cuda):
    x = torch.zeros((1, 8, 8, 32), dtype=torch.int8, device=cuda)[..., ::2]
    w = torch.zeros((3, 3, 16, 32), dtype=torch.int8, device=cuda)
    a = torch.zeros(32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        int8_conv.int8_block_conv(x, w, a, a, dilation=2, leaky_slope=0.1)


def test_int8_window_path_on_card_matches_cpu(cuda):
    """Full-width int8 window voting on a small tile: the card (K5,
    cuDNN) and the CPU (plain versions) give the same labels."""
    from dynseg_torch.config import Config, InferConfig, ModelConfig
    from dynseg_torch.data.datasets import load_synthetic
    from dynseg_torch.bridge import flax_to_torch, init_variables_np
    from dynseg_torch.infer import Inferencer

    cfg = Config(model=ModelConfig(num_classes=2),
                 infer=InferConfig(scales=(25,), quant="int8"))
    tiles = load_synthetic(seed=0, num_tiles=2, size=40)[1]
    sd = flax_to_torch(init_variables_np(cfg.model, num_input_bands=3, seed=0))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        inf = Inferencer(cfg, tiles, device=dev)
        qsd = inf.enable_quant({k: v.to(dev) for k, v in sd.items()})
        out[dev.type] = inf.predict_tile(qsd, 0)
    (pg, prob_g), (pc, prob_c) = out["cuda"], out["cpu"]
    assert np.isfinite(prob_g).all()
    np.testing.assert_allclose(prob_g, prob_c, rtol=0, atol=2e-2)
    assert np.mean(pg == pc) >= 0.995


# (T, H, W, C, size, B, uint8 tiles, uint8 masks): the slice's shapes
# (uint8, C 3, s 25..65, B 100; s 25 at B 1 and 1000), then float32 tiles,
# int32 masks, even and tiny sizes, C 1 and 5, a window as large as the
# tile, and a float32 window of 65^2 x 5.
GATHER = [
    (3, 200, 190, 3, 65, 100, True, True),
    (3, 200, 190, 3, 25, 100, True, True),
    (3, 200, 190, 3, 25, 1, True, True),
    (3, 200, 190, 3, 25, 1000, True, True),
    (2, 80, 70, 3, 16, 37, False, False),
    (2, 40, 41, 1, 9, 13, True, False),
    (1, 30, 30, 5, 30, 8, False, True),
    (2, 90, 80, 5, 65, 7, False, False),
    (1, 5, 6, 3, 1, 3, True, True),
]


@pytest.mark.parametrize("case", GATHER, ids=lambda c: "x".join(map(str, c)))
def test_gather_kernel_matches_plain_bitwise(cuda, case):
    t, h, w, c, size, b, img_u8, mask_u8 = case
    rng = np.random.default_rng(sum(case[:6]))
    if img_u8:
        images = rng.integers(0, 256, (t, h, w, c), dtype=np.uint8)
    else:
        images = rng.normal(100, 40, (t, h, w, c)).astype(np.float32)
    masks = rng.integers(0, 6, (t, h, w)).astype(np.uint8 if mask_u8 else np.int32)
    masks[0, :3] = 255
    f = images.astype(np.float32)
    mean, std = f.mean((0, 1, 2)), f.std((0, 1, 2)) + 0.5
    pos = np.stack([rng.integers(0, t, b), rng.integers(size // 2, h - size + size // 2 + 1, b),
                    rng.integers(size // 2, w - size + size // 2 + 1, b)], 1)
    pos[:4] = [[0, 0, 0], [t - 1, h + 3, w - 1], [0, -2, 5], [t, 1, -w]][:len(pos[:4])]
    aug = np.arange(b) % 8
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in
            (images, masks, mean.astype(np.float32), std.astype(np.float32),
             pos.astype(np.int32), aug.astype(np.int32))]
    before = gather.launches
    gi, gl = gather.gather_batch(*args, size)
    assert gather.launches == before + 1
    wi, wl = gather.gather_batch_ref(*args, size)
    torch.cuda.synchronize()
    assert gi.shape == (b, size, size, c) and gl.dtype == torch.int64
    assert torch.equal(gi, wi) and torch.equal(gl, wl)


# (B, H, W, C, window, ties): the slice's pool shapes at batch 2 and the
# largest at its full batch, then ragged ones: C 3 and 5, H or W of 1, H
# and W not a multiple of the fused tile, window 5 and 7.
POOL = [
    (2, 25, 25, 64, 3, False), (2, 65, 65, 256, 3, True), (3, 13, 11, 3, 3, True),
    (1, 1, 9, 5, 3, False), (2, 10, 7, 8, 5, True), (1, 6, 9, 16, 7, True),
    (100, 65, 65, 256, 3, True), (2, 29, 31, 68, 3, True), (1, 17, 35, 4, 5, True),
]


def _pool_case(cuda, case, offset=0):
    """x, y, g of a POOL case; with `offset`, each tensor's storage starts
    that many float32 past the allocation (4 bytes per unit)."""
    b, h, w, c, window, ties = case
    rng = np.random.default_rng(sum(case[:5]))
    if ties:
        x = rng.integers(0, 3, (b, h, w, c)).astype(np.float32)
    else:
        x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    g = rng.normal(size=(b, h, w, c)).astype(np.float32)

    def place(a):
        buf = torch.empty(a.size + offset, device=cuda)
        t = buf[offset:].view(a.shape)
        t.copy_(torch.from_numpy(a))
        return t

    xt = place(x)
    y = place(np.zeros_like(x))
    y.copy_(pool.pool_forward(xt.permute(0, 3, 1, 2), window).permute(0, 2, 3, 1))
    return xt, y, place(g)


@pytest.mark.parametrize("variant", pool.VARIANTS)
@pytest.mark.parametrize("case", POOL, ids=lambda c: "x".join(map(str, c)))
def test_pool_bwd_kernel_matches_plain_bitwise(cuda, case, variant):
    """Each variant on every case it takes, bitwise; the fused variant
    refuses the others. Gradient mass is conserved."""
    window = case[4]
    xt, y, g = _pool_case(cuda, case)
    if variant == "fused" and pool.variant_for(xt.shape, window) != "fused":
        with pytest.raises(ValueError, match="multiple of 4"):
            pool.pallas_pool_bwd(xt, y, g, window, variant)
        return
    before, before_v = pool.launches, pool.variant_launches[variant]
    got = pool.pallas_pool_bwd(xt, y, g, window, variant)
    assert pool.launches == before + 1
    assert pool.variant_launches[variant] == before_v + 1
    want = pool.pallas_pool_bwd_ref(xt, y, g, window)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    np.testing.assert_allclose(float(got.double().sum()), float(g.double().sum()),
                               rtol=1e-4)


@pytest.mark.parametrize("case", POOL[:2], ids=lambda c: "x".join(map(str, c)))
def test_pool_bwd_misaligned_storage_takes_twopass(cuda, case):
    """Storage 4 bytes past 16-byte alignment: TMA cannot take it, so the
    default is twopass, which reads it right; naming fused raises."""
    xt, y, g = _pool_case(cuda, case, offset=1)
    assert xt.data_ptr() % 16 == 4
    assert pool.variant_for(xt.shape, case[4], aligned=False) == "twopass"
    before = dict(pool.variant_launches)
    got = pool.pallas_pool_bwd(xt, y, g, case[4])
    assert pool.variant_launches["twopass"] == before["twopass"] + 1
    assert pool.variant_launches["fused"] == before["fused"]
    torch.cuda.synchronize()
    assert torch.equal(got, pool.pallas_pool_bwd_ref(xt, y, g, case[4]))
    with pytest.raises(ValueError, match="aligned"):
        pool.pallas_pool_bwd(xt, y, g, case[4], "fused")


def test_pool_bwd_fused_reads_nan_outside_the_image(cuda):
    """A constant image: every tap inside the image ties, so a corner's
    window counts 4 and an edge's 6. Had the TMA fill outside the image
    been 0 (or anything equal to the image), they would count 9."""
    x = torch.zeros((2, 13, 11, 32), device=cuda)
    g = torch.ones_like(x)
    got = pool.pallas_pool_bwd(x, x, g, 3, "fused")
    torch.cuda.synchronize()
    assert torch.equal(got, pool.pallas_pool_bwd_ref(x, x, g, 3))
    assert abs(float(got[0, 0, 0, 0]) - (1 / 4 + 2 / 6 + 1 / 9)) < 1e-6


def test_max_pool_s1_on_card_matches_cpu(cuda):
    """The autograd path on the card (K4) and on the CPU (plain): the same
    forward and the same gradient, bitwise."""
    rng = np.random.default_rng(0)
    x_np = rng.integers(0, 4, (2, 32, 19, 23)).astype(np.float32)
    w_np = rng.normal(size=(2, 32, 19, 23)).astype(np.float32)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        x = torch.from_numpy(x_np).to(dev).contiguous(
            memory_format=torch.channels_last).requires_grad_()
        (pool.max_pool_s1(x, 3) * torch.from_numpy(w_np).to(dev)).sum().backward()
        grads.append(x.grad.cpu())
    assert torch.equal(grads[0], grads[1])


def test_train_step_on_card_matches_cpu(cuda):
    """One step of a width-0.25 net at batch 8, 25 px, pool_backward
    pallas, lr 0.01, from the same weights on the card (K2, K4, cuDNN
    without TF32) and on the CPU (plain versions): loss within 1e-5
    relative and params within 1e-6 absolute (an lr-scaled gradient whose
    float32 sums run in another order; measured 3.4e-7)."""
    from dynseg_torch.config import Config, ModelConfig, SchedulerConfig, TrainConfig
    from dynseg_torch.data.datasets import load_synthetic
    from dynseg_torch.train import Trainer

    cfg = Config(model=ModelConfig(width_multiplier=0.25, pool_backward="pallas"),
                 sched=SchedulerConfig(values=(25,)),
                 train=TrainConfig(batch_size=8, learning_rate=0.01))
    tiles = load_synthetic(seed=0, num_tiles=2, size=64)[0]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        tr = Trainer(cfg, tiles, device=dev)
        st = tr.init_state(seed=3)
        pos, aug = tr.make_batch_inputs(25)
        m = tr._step_impl(st, pos[0], aug[0], 25)
        out[dev.type] = (float(m["loss"]),
                         {k: v.cpu() for k, v in st.model.state_dict().items()})
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for k, v in out["cpu"][1].items():
        np.testing.assert_allclose(out["cuda"][1][k].numpy(), v.numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)


# P1's (B, H, W, C, dilation): the TPU probe's check shapes, then ragged
# ones: odd H and W, B 3, C 32 and 160 (a half K chunk), dilations 1, 2,
# 5, 6, a dilation wider than the image, and a 1 x 1 image; then C 512 (two
# N tiles), dilation 20, and the probe's shape (chip_smoke.P1_SHAPES).
P1 = [
    (2, 16, 16, 128, 2), (1, 32, 32, 128, 6), (3, 17, 23, 32, 1),
    (3, 21, 15, 160, 2), (3, 19, 13, 32, 5), (3, 25, 11, 160, 6),
    (1, 5, 7, 64, 6), (1, 1, 1, 32, 1), (2, 37, 41, 512, 3),
    (1, 60, 50, 256, 20), (8, 592, 592, 256, 6),
]
# Each launch of a case: the default (wgmma) and the mma.sync kernel.
P1_RUNS = {"wgmma": {}, "mma_sync": {"variant": "mma_sync"}}


def _p1_case(cuda, case):
    b, h, w, c, dil = case
    rng = np.random.default_rng(sum(case))
    x = torch.from_numpy(rng.integers(-128, 128, (b, h, w, c), dtype=np.int8)).to(cuda)
    wt = torch.from_numpy(rng.integers(-128, 128, (3, 3, c, c), dtype=np.int8)).to(cuda)
    return x, wt


@pytest.mark.parametrize("run", sorted(P1_RUNS))
@pytest.mark.parametrize("case", P1, ids=lambda c: "x".join(map(str, c)))
def test_p1_kernel_matches_plain_bitwise(cuda, case, run):
    b, h, w, c, dil = case
    x, wt = _p1_case(cuda, case)
    kw = P1_RUNS[run]
    variant = kw.get("variant", "wgmma")
    assert int8_probe_conv.variant_for(dil, x.data_ptr() % 16 == 0) == "wgmma"
    for scale in (1 / 512, 64.0 / (np.sqrt(9 * c) * 73.9 ** 2)):
        before, by_variant = int8_probe_conv.launches, dict(int8_probe_conv.variant_launches)
        got = int8_probe_conv.int8_conv3x3_requant(x, wt, scale, dil, **kw)
        assert int8_probe_conv.launches == before + 1
        assert int8_probe_conv.variant_launches == {
            v: n + (v == variant) for v, n in by_variant.items()}
        want = int8_probe_conv.int8_conv3x3_requant_ref(x, wt, scale, dil)
        torch.cuda.synchronize()
        assert got.dtype == torch.int8 and got.shape == x.shape
        assert torch.equal(got, want)
    if h * w > 1:  # 1/512 saturates: both bounds are exercised
        got = int8_probe_conv.int8_conv3x3_requant(x, wt, 1 / 512, dil, **kw)
        assert (got == -128).any() and (got == 127).any()


@pytest.mark.parametrize("offset", [1, 4, 8, 15])
def test_p1_misaligned_input_takes_mma_sync(cuda, offset):
    """x 1-15 bytes past 16-byte alignment: TMA cannot copy it, so the
    default is the mma.sync kernel, which reads it a byte at a time; naming
    wgmma raises."""
    case = (2, 13, 11, 64, 2)
    x0, wt = _p1_case(cuda, case)
    buf = torch.empty(x0.numel() + 16, dtype=torch.int8, device=cuda)
    x = buf[offset:offset + x0.numel()].view(x0.shape)
    x.copy_(x0)
    assert x.data_ptr() % 16 == offset and x.is_contiguous()
    assert int8_probe_conv.variant_for(2, aligned=False) == "mma_sync"
    before = dict(int8_probe_conv.variant_launches)
    got = int8_probe_conv.int8_conv3x3_requant(x, wt, 1 / 512, 2)
    assert int8_probe_conv.variant_launches["mma_sync"] == before["mma_sync"] + 1
    assert int8_probe_conv.variant_launches["wgmma"] == before["wgmma"]
    torch.cuda.synchronize()
    assert torch.equal(got, int8_probe_conv.int8_conv3x3_requant_ref(x0, wt, 1 / 512, 2))
    with pytest.raises(ValueError, match="aligned"):
        int8_probe_conv.int8_conv3x3_requant(x, wt, 1 / 512, 2, "wgmma")


def test_p1_wide_dilation_takes_mma_sync(cuda):
    """A dilation of 128 or more is past TMA's im2col corners: the default
    is the mma.sync kernel, bitwise equal to plain; naming wgmma raises."""
    case = (1, 3, 3, 32, 130)
    x, wt = _p1_case(cuda, case)
    assert int8_probe_conv.variant_for(130, x.data_ptr() % 16 == 0) == "mma_sync"
    before = dict(int8_probe_conv.variant_launches)
    got = int8_probe_conv.int8_conv3x3_requant(x, wt, 1 / 512, 130)
    assert int8_probe_conv.variant_launches == {
        v: n + (v == "mma_sync") for v, n in before.items()}
    torch.cuda.synchronize()
    assert torch.equal(got, int8_probe_conv.int8_conv3x3_requant_ref(x, wt, 1 / 512, 130))
    with pytest.raises(ValueError, match="dilation"):
        int8_probe_conv.int8_conv3x3_requant(x, wt, 1 / 512, 130, "wgmma")


def test_p1_kernel_refuses_strided_input(cuda):
    x = torch.zeros((1, 8, 8, 64), dtype=torch.int8, device=cuda)[..., ::2]
    w = torch.zeros((3, 3, 32, 32), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        int8_probe_conv.int8_conv3x3_requant(x, w, 0.5, 1)


# --------------------------------------------------------------------- #
# data parallelism on the card (chip_smoke.py phase 18, at small width)
# --------------------------------------------------------------------- #
def _dp_train_cfg(n, shard=False):
    from dynseg_torch.config import Config, ModelConfig, SchedulerConfig, TrainConfig

    return Config(model=ModelConfig(width_multiplier=0.25, pool_backward="pallas"),
                  sched=SchedulerConfig(values=(25, 65)),
                  train=TrainConfig(batch_size=16, learning_rate=0.01, num_devices=n,
                                    shard_tiles=shard))


def _dp_distance(a, b):
    """(max relative loss difference, max|dparam|, max|dBN statistics|)
    between two train_steps runs."""
    sa, sb = a["state"], b["state"]
    dp = max(float(np.abs(sa[k] - v).max()) for k, v in sb.items()
             if v.dtype == np.float32 and "running" not in k)
    dbn = max(float(np.abs(sa[k] - v).max()) for k, v in sb.items() if "running" in k)
    rel = max(abs(x - y) / abs(y) for x, y in zip(a["losses"], b["losses"]))
    return rel, dp, dbn


def _dp_assert_steps(got, want, floor):
    """Every loss within 1e-5 relative; after the first step params within
    1e-6 and BN statistics within 1e-5; after the last, each within the
    larger of those and twice `floor`, `want`'s own float32 noise (its
    reruns on the same batches with the rows in other orders, as
    chip_smoke.py phase 18); K2/K4 launches equal the gathers and pool
    backwards, every K4 launch fused."""
    first = {"losses": got["losses"][:1], "state": got["states"][0]}
    _, dp1, dbn1 = _dp_distance(first, {"losses": want["losses"][:1],
                                        "state": want["states"][0]})
    assert dp1 <= 1e-6 and dbn1 <= 1e-5, (dp1, dbn1)
    rel, dp, dbn = _dp_distance(got, want)
    assert (rel <= 1e-5 and dp <= max(1e-6, 2 * floor[1])
            and dbn <= max(1e-5, 2 * floor[2])), (rel, dp, dbn, floor)
    assert (got["k2"], got["k4"], got["k4_fused"]) == (
        got["gathers"], got["pool_bwds"], got["pool_bwds"])


def _dp_one_device(cfg, tiles, variables, sizes, batches):
    """One device on `batches`, and the largest distance to four reruns
    with each batch's rows in another order."""
    from dynseg_torch.probes import dp_parity

    one = dp_parity.train_steps(cfg, tiles, variables, sizes, batches, device="cuda")
    floor = (0.0, 0.0, 0.0)
    for seed in (9, 10, 11, 12):
        perm = np.random.default_rng(seed).permutation(len(batches[0][0]))
        again = dp_parity.train_steps(cfg, tiles, variables, sizes,
                                      [(p[perm], a[perm]) for p, a in batches],
                                      device="cuda")
        floor = tuple(map(max, floor, _dp_distance(again, one)))
    return one, floor


@pytest.mark.parametrize("ranks", [1, 2])
def test_data_parallel_steps_on_the_card_match_one_device(cuda, ranks):
    """Two steps (25, 65 px) of a width-0.25 net at batch 16: one rank in
    an NCCL group, or two ranks sharing the card over gloo (replicated
    tiles, then --shard_tiles on the ranks' own sampling), against one
    device on the same global batches (`_dp_assert_steps`)."""
    from dynseg_torch import parallel
    from dynseg_torch.bridge import init_variables_np
    from dynseg_torch.data.datasets import load_synthetic
    from dynseg_torch.probes import dp_parity
    from dynseg_torch.train import Trainer

    tiles = load_synthetic(seed=0, num_tiles=3, size=96)[0]
    variables = init_variables_np(_dp_train_cfg(1).model, 3, seed=1)
    sizes = [25, 65]
    sampler = Trainer(_dp_train_cfg(1), tiles, device="cpu")
    batches = [tuple(a[0] for a in sampler.global_batch_inputs(s)) for s in sizes]
    one, floor = _dp_one_device(_dp_train_cfg(1), tiles, variables, sizes, batches)
    backend = "nccl" if ranks == 1 else "gloo"
    calls = [(dp_parity.train_steps, (_dp_train_cfg(ranks), tiles, variables, sizes,
                                      batches))]
    if ranks == 2:
        calls.append((dp_parity.train_steps, (_dp_train_cfg(2, True), tiles, variables,
                                              sizes)))
    got = parallel.spawn(dp_parity.run_many, ranks, ["cuda:0"] * ranks, backend,
                         args=(calls,))
    if ranks == 2:
        one_shard, shard_floor = _dp_one_device(_dp_train_cfg(1), tiles, variables,
                                                sizes, got[0][1]["batches"])
    for res in got:
        _dp_assert_steps(res[0], one, floor)
        if ranks == 2:
            _dp_assert_steps(res[1], one_shard, shard_floor)


def test_split_int8_inference_on_the_card_matches_one_device(cuda):
    """Dense int8 at full width on a 256^2 tile, blocks of 64: two ranks
    sharing the card over gloo hold one device's quantized state_dict
    bitwise and its probabilities within 1e-5; each rank's K5 launches
    are 3 per int8 forward, all wgmma."""
    from dynseg_torch import parallel
    from dynseg_torch.bridge import flax_to_torch, init_variables_np
    from dynseg_torch.config import Config, InferConfig, ModelConfig
    from dynseg_torch.data.datasets import load_synthetic
    from dynseg_torch.probes import dp_parity

    cfg = Config(model=ModelConfig(num_classes=2),
                 infer=InferConfig(scales=(25,), mode="dense", quant="int8",
                                   dense_block=64, dense_halo=40,
                                   save_prediction_maps=False))
    tiles = load_synthetic(seed=0, num_tiles=2, size=256)[1]
    sd = flax_to_torch(init_variables_np(cfg.model, 3, seed=2))
    one = dp_parity.predict(cfg, tiles, sd, "cuda")
    for res in parallel.spawn(dp_parity.predict, 2, ["cuda:0"] * 2, "gloo",
                              args=(cfg, tiles, sd)):
        for k, v in one["qvars"].items():
            np.testing.assert_array_equal(res["qvars"][k], v, err_msg=k)
        for p, q in zip(res["probs"], one["probs"]):
            np.testing.assert_allclose(p, q, rtol=0, atol=1e-5)
        assert res["forwards"] > 0
        assert res["k5"] == res["k5_wgmma"] == 3 * res["forwards"]
