"""dynseg_torch on the card: K5 (csrc/int8_block_conv.cu), K2
(csrc/patch_gather.cu), K4 (csrc/pool_bwd.cu), K6 (csrc/max_pool_fwd.cu,
into a tensor of its own and into a channel slot of a wider buffer), K7
(csrc/act_quantize.cu) and P1 (csrc/int8_conv3x3.cu) against their plain
PyTorch versions; the serving path and train steps on the card
against the same on the CPU; data parallelism and reproducibility; the
window fold under its memory cap, host streaming, the command line's
kernel launches, an int8 artifact against the live forward, and the
reference's initial weights against their pins. Marked `gpu`; every test
skips where torch.cuda.is_available() is false. On a machine with a card
and without JAX (these tests import none), run

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
# block geometries at batch 1, as a window batch of 256 x 25^2 and as the
# dense batch of the main path (8 blocks of 256 + 2 * 40 halo pixels a
# side, 8 x 336^2), then ragged tiles: M not a multiple of 128 (with Cout 256 and 192), Cin 144 (a
# partial K chunk), a 1 x 1 image, Cin 48 with k 5; then the dp4a variant:
# Cout 68 and 4, Cin 131 (the dense-wired net's block 2), 24, 3, Cout 30, 5.
SHAPES = [
    (1, 96, 96, 128, 128, 4, 4, True, "wgmma"),
    (1, 96, 96, 128, 256, 3, 5, True, "wgmma"),
    (1, 96, 96, 256, 256, 3, 6, False, "wgmma"),
    (256, 25, 25, 128, 128, 4, 4, True, "wgmma"),
    (256, 25, 25, 128, 256, 3, 5, True, "wgmma"),
    (256, 25, 25, 256, 256, 3, 6, False, "wgmma"),
    (8, 336, 336, 128, 128, 4, 4, True, "wgmma"),
    (8, 336, 336, 128, 256, 3, 5, True, "wgmma"),
    (8, 336, 336, 256, 256, 3, 6, False, "wgmma"),
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


# The serve path's K5 calls at its defaults: a dense call of 8 blocks of
# 1024 + 2 * 40 halo pixels a side, whose output passes 2^31 elements at
# Cout 256, and window batches of 64 and 128 at the largest scale, 65.
SERVE_K5 = [(8, 1104), (64, 65), (128, 65)]
# (block, Cin, Cout, k, dilation, store): the three int8 blocks with the
# int8 store of the int8 exit's route, blocks 4 and 5 with float32 too.
SERVE_BLOCKS = [("block3", 128, 128, 4, 4, torch.int8),
                ("block4", 128, 256, 3, 5, torch.int8),
                ("block4", 128, 256, 3, 5, torch.float32),
                ("block5", 256, 256, 3, 6, torch.int8),
                ("block5", 256, 256, 3, 6, torch.float32)]


@pytest.mark.parametrize("block", SERVE_BLOCKS,
                         ids=lambda g: f"{g[0]}-{str(g[-1]).removeprefix('torch.')}")
@pytest.mark.parametrize("batch", SERVE_K5, ids=lambda s: "{}x{}".format(*s))
def test_kernel_at_the_serve_paths_shapes_matches_plain_bitwise(cuda, batch, block):
    """Each int8 block at the serve path's shapes, storing int8 (requant)
    or float32: the wgmma variant bitwise equal to plain, which runs two
    of the dense call's samples a call."""
    (b, side), (_, cin, cout, k, dil, store) = batch, block
    gen = torch.Generator(device=cuda).manual_seed(17)
    x = torch.randint(-127, 128, (b, side, side, cin), generator=gen, device=cuda,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (k, k, cin, cout), generator=gen, device=cuda,
                      dtype=torch.int8)
    a = torch.full((cout,), 2e-6, device=cuda)
    pc = int8_conv.pack_conv(w, a, torch.rand(cout, generator=gen, device=cuda) - 0.5,
                             dilation=dil, leaky_slope=0.1,
                             out_scale=3.0 / 127 if store == torch.int8 else None)
    assert pc.variant == "wgmma"
    got = int8_conv.int8_block_conv_packed(x, pc)
    assert got.dtype == store
    if side == 1104 and cout == 256:
        assert got.numel() > 2 ** 31
    step = 2 if side == 1104 else b
    for i in range(0, b, step):
        assert torch.equal(got[i:i + step],
                           int8_conv.int8_block_conv_packed_ref(x[i:i + step], pc)), i


# The dense-wired net's int8 blocks 2-5 at the serving batch of 8 x 336^2:
# (concat Cin, Cout, k, dilation).
DENSE_K5 = [(131, 128, 4, 3), (259, 128, 4, 4), (387, 256, 3, 5), (643, 256, 3, 6)]


@pytest.mark.parametrize("geom", DENSE_K5, ids=lambda g: "x".join(map(str, g)))
def test_wgmma_on_the_padded_prefix_equals_dp4a_on_the_concat(cuda, geom):
    """K5 as the dense forward calls it: the tensor cores on the concat's
    codes behind the zero lead codes, with zero weight rows there, against
    dp4a on the concat alone, bit for bit (float32 out), one launch each."""
    from dynseg_torch.ops.quant import dense_lead

    cin, cout, k, dil = geom
    lead = dense_lead(3)
    (x, w, a, b), kw = _k5_case(cuda, (8, 336, 336, cin, cout, k, dil, False))
    plain = int8_conv.pack_conv(w, a, b, **kw)
    padded = int8_conv.pack_conv(torch.nn.functional.pad(w, (0, 0, lead, 0)), a, b, **kw)
    assert (plain.variant, padded.variant) == ("dp4a", "wgmma")
    xp = torch.nn.functional.pad(x, (lead, 0))
    before = dict(int8_conv.variant_launches)
    got = int8_conv.int8_block_conv_packed(xp, padded)
    want = int8_conv.int8_block_conv_packed(x, plain)
    torch.cuda.synchronize()
    assert {v: int8_conv.variant_launches[v] - before[v] for v in before} == \
        {"dp4a": 1, "wgmma": 1}
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_dense_int8_tile_equals_the_dp4a_path(cuda, monkeypatch):
    """A dense int8 tile of the densely connected net at full width
    (blocks 2-5 int8 at min_ch 128, blocks of 256 + halo 40, 8 a batch):
    every K5 launch of the feature buffer's forward takes the tensor
    cores, and its probabilities and labels equal those of the same
    forward without the lead channels, where every int8 block runs dp4a
    at its concat Cin."""
    from dynseg_torch.bridge import flax_to_torch, init_variables_np
    from dynseg_torch.config import Config, InferConfig, ModelConfig
    from dynseg_torch.data.datasets import load_synthetic
    from dynseg_torch.infer import Inferencer
    from dynseg_torch.ops import quant

    cfg = Config(model=ModelConfig(net_type="dilated_icpr_rate6_densely", num_classes=6),
                 infer=InferConfig(mode="dense", quant="int8", dense_block=256,
                                   dense_halo=40, save_prediction_maps=False))
    tiles = load_synthetic(seed=0, num_tiles=1, size=600, num_classes=6)[1]
    sd = flax_to_torch(init_variables_np(cfg.model, num_input_bands=3, seed=1))
    inf = Inferencer(cfg, tiles, device=cuda)
    qsd = inf.enable_quant({k: v.to(cuda) for k, v in sd.items()})
    out = {}
    for path in ("wgmma", "dp4a"):
        if path == "dp4a":
            monkeypatch.setattr(quant, "dense_lead", lambda bands: 0)
        int8_conv.reset_launches()
        # A new dict: the forward packs K5's operands anew.
        out[path] = inf.predict_tile_dense(dict(qsd), 0, block=256, halo=40)
        torch.cuda.synchronize()
        assert int8_conv.launches > 0
        assert int8_conv.variant_launches == {"dp4a": 0, "wgmma": 0, path: int8_conv.launches}
    (lw, pw), (ld, pd) = out["wgmma"], out["dp4a"]
    assert np.array_equal(pw, pd) and np.array_equal(lw, ld)


def _window_tile_on_card_and_cpu(cuda, cfg, size=40):
    """Tile 0's window labels and probabilities on the card (K5, cuDNN)
    and on the CPU (plain versions), from the same weights."""
    from dynseg_torch.bridge import flax_to_torch, init_variables_np
    from dynseg_torch.data.datasets import load_synthetic
    from dynseg_torch.infer import Inferencer

    tiles = load_synthetic(seed=0, num_tiles=2, size=size)[1]
    sd = flax_to_torch(init_variables_np(cfg.model, num_input_bands=3, seed=0))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        inf = Inferencer(cfg, tiles, device=dev)
        qsd = inf.enable_quant({k: v.to(dev) for k, v in sd.items()})
        out[dev.type] = inf.predict_tile(qsd, 0)
    assert np.isfinite(out["cuda"][1]).all()
    return out["cuda"], out["cpu"]


def test_int8_window_path_on_card_matches_cpu(cuda):
    """Full-width int8 window voting on a small tile: the card (K5,
    cuDNN) and the CPU (plain versions) give the same labels."""
    from dynseg_torch.config import Config, InferConfig, ModelConfig

    cfg = Config(model=ModelConfig(num_classes=2),
                 infer=InferConfig(scales=(25,), quant="int8"))
    (pg, prob_g), (pc, prob_c) = _window_tile_on_card_and_cpu(cuda, cfg)
    np.testing.assert_allclose(prob_g, prob_c, rtol=0, atol=2e-2)
    assert np.mean(pg == pc) >= 0.995


def test_float_window_path_on_card_matches_cpu(cuda):
    """Float32 window voting of a width-0.25 net over scales 25 and 35 on
    a 48^2 tile: the card and the CPU agree to float32 summation order
    (probabilities within 1e-4, labels but for near-ties)."""
    from dynseg_torch.config import Config, InferConfig, ModelConfig

    cfg = Config(model=ModelConfig(num_classes=2, width_multiplier=0.25),
                 infer=InferConfig(scales=(25, 35)))
    (pg, prob_g), (pc, prob_c) = _window_tile_on_card_and_cpu(cuda, cfg, size=48)
    assert prob_g.shape == (48, 48, 2)
    np.testing.assert_allclose(prob_g, prob_c, rtol=0, atol=1e-4)
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


@pytest.mark.parametrize("b, size", [(15, 65), (51, 35)])
def test_gather_kernel_on_the_rehearsal_stack_matches_plain_bitwise(cuda, b, size):
    """K2 at two of the production rehearsal's area-rescaled batches
    (probes.stress_scale: B = 100 (25 / s)^2) on a stack of its size, 20
    uint8 tiles of 3066^2 x 3 (3000^2 mirror-padded by 33), with a patch
    on every tile and at both corners of the last."""
    t, hw, c = 20, 3066, 3
    gen = torch.Generator(device=cuda)
    gen.manual_seed(b)
    images = torch.randint(0, 256, (t, hw, hw, c), generator=gen, device=cuda,
                           dtype=torch.uint8)
    masks = torch.randint(0, 6, (t, hw, hw), generator=gen, device=cuda, dtype=torch.uint8)
    mean = torch.tensor([120.0, 110.5, 99.25], device=cuda)
    std = torch.tensor([40.0, 37.3, 51.7], device=cuda)
    rng = np.random.default_rng(b)
    half = size // 2
    pos = np.stack([np.arange(b) % t, rng.integers(half, hw - size + half + 1, b),
                    rng.integers(half, hw - size + half + 1, b)], 1)
    pos[:2] = [[t - 1, half, half], [t - 1, hw - size + half, hw - size + half]]
    args = (images, masks, mean, std, torch.from_numpy(pos.astype(np.int32)).to(cuda),
            torch.from_numpy((np.arange(b) % 8).astype(np.int32)).to(cuda))
    before = gather.launches
    gi, gl = gather.gather_batch(*args, size)
    assert gather.launches == before + 1
    wi, wl = gather.gather_batch_ref(*args, size)
    torch.cuda.synchronize()
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


# (B, H, W, C, window): K6 at the dense int8 cell's pools (8 x 336^2 at C
# 64, 128, 192), the window int8 batch, the serve path's dense call, then
# ragged C (3, 40, 200), tiny images and windows 2, 4, 5 and 7.
K6 = [
    (8, 336, 336, 64, 3), (8, 336, 336, 128, 3), (8, 336, 336, 192, 3),
    (256, 65, 65, 128, 3), (8, 1104, 1104, 128, 3),
    (2, 17, 19, 3, 3), (2, 23, 9, 40, 3), (1, 31, 33, 200, 3),
    (1, 1, 1, 16, 3), (2, 7, 5, 32, 2), (1, 6, 9, 16, 4), (2, 10, 7, 8, 5), (1, 9, 6, 64, 7),
]


def _k6_case(cuda, case, mode, offset=0):
    """x (and the scale) of a K6 case in `mode`: codes over the whole int8
    range with ties; floats on a grid of half-steps of sx, so that x / sx
    lands on exact .5 boundaries and past +-127. With `offset`, x starts
    that many elements past the allocation."""
    b, h, w, c, _ = case
    gen = torch.Generator(cuda).manual_seed(sum(case) * 3 + pool.FWD_MODES.index(mode))
    shape = (b, h, w, c)
    n = b * h * w * c
    if mode == "i8":
        flat = torch.randint(-128, 128, (n + offset,), generator=gen, device=cuda,
                             dtype=torch.int16).to(torch.int8)
        flat[offset:] = torch.where(flat[offset:] % 5 == 0, -flat[offset:] // 3, flat[offset:])
        return flat[offset:].view(shape), None
    sx = torch.tensor(0.0371, device=cuda)
    half = torch.randint(-300, 301, (n + offset,), generator=gen, device=cuda).float()
    flat = half * 0.5 * sx
    return flat[offset:].view(shape), (sx if mode == "f32_i8" else None)


@pytest.mark.parametrize("mode", pool.FWD_MODES)
@pytest.mark.parametrize("case", K6, ids=lambda c: "x".join(map(str, c)))
def test_max_pool_fwd_kernel_matches_plain_bitwise(cuda, case, mode):
    """K6 in each mode equals the plain composition bitwise, and counts
    one launch of that mode."""
    x, sx = _k6_case(cuda, case, mode)
    before = dict(pool.fwd_launches)
    got = pool.max_pool_fwd(x.permute(0, 3, 1, 2), case[4], sx).permute(0, 2, 3, 1)
    assert pool.fwd_launches[mode] == before[mode] + 1
    assert sum(pool.fwd_launches.values()) == sum(before.values()) + 1
    want = pool.max_pool_fwd_ref(x, case[4], sx)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("mode", pool.FWD_MODES)
@pytest.mark.parametrize("case", [K6[0], K6[6], K6[7]], ids=lambda c: "x".join(map(str, c)))
def test_max_pool_fwd_misaligned_base_matches_plain(cuda, case, mode):
    """x one element past a 16-byte boundary: the kernel takes one
    element a thread and still equals the plain composition."""
    x, sx = _k6_case(cuda, case, mode, offset=1)
    assert x.data_ptr() % 16
    got = pool.max_pool_fwd(x.permute(0, 3, 1, 2), case[4], sx).permute(0, 2, 3, 1)
    want = pool.max_pool_fwd_ref(x, case[4], sx)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_max_pool_fwd_propagates_nan_and_infinities_like_aten(cuda):
    """float32: a NaN wins its windows and -inf/+inf pool as values, as in
    ATen's max_pool2d."""
    x = torch.randn((2, 9, 11, 8), device=cuda)
    x[0, 4, 5, 3] = float("nan")
    x[1, 0, 0, :] = float("inf")
    x[1, 8, 10, :] = float("-inf")
    got = pool.max_pool_fwd(x.permute(0, 3, 1, 2), 3).permute(0, 2, 3, 1)
    want = pool.max_pool_fwd_ref(x, 3)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert int(torch.isnan(got).sum()) == 9
    keep = ~torch.isnan(want)
    assert torch.equal(got[keep], want[keep])


def _rate8_int8_state(cuda, dtype="float32"):
    """A full-width dilated_grsl_rate8 int8 state_dict on the card (blocks
    3-5 quantized, calibrated on one crop) and an input."""
    from dynseg_torch.bridge import flax_to_torch, init_variables_np
    from dynseg_torch.config import ModelConfig
    from dynseg_torch.ops import quant

    mcfg = ModelConfig(net_type="dilated_grsl_rate8", num_classes=6, compute_dtype=dtype)
    sd = {k: v.to(cuda) for k, v in
          flax_to_torch(init_variables_np(mcfg, num_input_bands=3, seed=3)).items()}
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 48, 40, 3)).astype(np.float32)).to(cuda)
    ranges = quant.calibrate(mcfg, sd, [x[:1]])
    return mcfg, quant.quantize_variables(mcfg, sd, ranges), x


def test_max_pool_fwd_launches_per_int8_forward(cuda):
    """One grsl_rate8 int8 forward launches K6 six times: 3 f32 (blocks 0,
    1, 5), 1 f32_i8 (block 2, its quantize fused) and 2 i8 (blocks 3, 4),
    and its logits equal those of the same forward with the plain pools.
    Under bfloat16 no float pool goes through K6: blocks 0, 1 and 5 pool
    on ATen, and the three int8 maps (blocks 2-4, block 2 quantized
    first) on K6."""
    from dynseg_torch.ops import quant

    mcfg, qsd, x = _rate8_int8_state(cuda)
    apply_fn = quant.make_apply(mcfg)
    with torch.inference_mode():
        apply_fn(qsd, x)
        pool.reset_launches()
        got = apply_fn(qsd, x)
        counts = dict(pool.fwd_launches)
        plain = quant.max_pool_fwd
        quant.max_pool_fwd = lambda y, w, s=None: pool.max_pool_fwd_ref(
            y.permute(0, 2, 3, 1), w, s).permute(0, 3, 1, 2)
        try:
            want = apply_fn(qsd, x)
        finally:
            quant.max_pool_fwd = plain
    torch.cuda.synchronize()
    assert counts == {"i8": 2, "f32_i8": 1, "f32": 3}
    assert torch.equal(got, want)
    mcfg, qsd, x = _rate8_int8_state(cuda, "bfloat16")
    with torch.inference_mode():
        pool.reset_launches()
        quant.make_apply(mcfg)(qsd, x)
    assert pool.fwd_launches == {"i8": 3, "f32_i8": 0, "f32": 0}


# K6 storing into a channel slot of the densely net's 912-channel feature
# buffer: (slot offset, C) of its six blocks.
DENSE_SLOTS = ((16, 64), (80, 64), (144, 128), (272, 128), (400, 256), (656, 256))
CANARY = 1234.5  # above every value of `_k6_case` (|x| <= 150 sx)


def _k6_slot(cuda, buf_shape, at, c, mode, window=3):
    """Pool a K6 case of C `c` into channels at..at+c of a canary-filled
    NHWC buffer of `buf_shape` through the slot-store op: (the buffer, the
    case's contiguous K6 output, the path the store took)."""
    x, sx = _k6_case(cuda, (*buf_shape[:3], c, window), mode)
    buf = torch.full(buf_shape, CANARY if mode == "f32" else -128, device=cuda,
                     dtype=torch.float32 if mode == "f32" else torch.int8)
    if mode == "i8":
        x = torch.clamp(x, min=-127)  # the canary stays below every code
    before = dict(pool.fwd_slot_launches)
    slot = buf.permute(0, 3, 1, 2)[:, at:at + c]
    assert pool.max_pool_fwd_into(x.permute(0, 3, 1, 2), window, sx, slot) is slot
    (path,) = [p for p in pool.FWD_PATHS if pool.fwd_slot_launches[p] == before[p] + 1]
    assert sum(pool.fwd_slot_launches.values()) == sum(before.values()) + 1
    want = pool.max_pool_fwd(x.permute(0, 3, 1, 2), window, sx).permute(0, 2, 3, 1)
    torch.cuda.synchronize()
    return buf, want, path


def _canary_outside(buf, at, c, mode):
    canary = CANARY if mode == "f32" else -128
    return bool((buf[..., :at] == canary).all()) and bool((buf[..., at + c:] == canary).all())


@pytest.mark.parametrize("slot", DENSE_SLOTS, ids=lambda s: "{}+{}".format(*s))
@pytest.mark.parametrize("side", [96, 336])
def test_max_pool_fwd_into_the_dense_slots_equals_k6_bitwise(cuda, side, slot):
    """K6 storing f32 into each densely slot of the 912-channel buffer at
    8 x 96^2 and at the main path's 8 x 336^2: the slot equals K6's
    contiguous output bit for bit, every other channel still holds the
    canary, and the store takes the 16-byte path."""
    at, c = slot
    buf, want, path = _k6_slot(cuda, (8, side, side, 912), at, c, "f32")
    assert path == "vec16"
    assert torch.equal(buf[..., at:at + c], want)
    assert _canary_outside(buf, at, c, "f32")


# (buffer C, slot offset, C, the path in i8 / f32_i8 / f32): a slot off 4
# floats, ragged C 3, C 40 (ragged in 16-code pieces), and a slot all
# three modes store in 16-byte pieces.
SLOT_PATHS = [(912, 18, 64, ("scalar", "scalar", "scalar")),
              (48, 5, 3, ("scalar", "scalar", "scalar")),
              (56, 8, 40, ("scalar", "vec16", "vec16")),
              (96, 16, 32, ("vec16", "vec16", "vec16"))]


@pytest.mark.parametrize("mode", pool.FWD_MODES)
@pytest.mark.parametrize("case", SLOT_PATHS, ids=lambda c: "x".join(map(str, c[:3])))
def test_max_pool_fwd_into_a_slot_takes_its_path_and_equals_k6(cuda, case, mode):
    """K6 storing into a slot in each mode takes the one-element path
    where a pixel's store is not whole 16-byte pieces on their
    boundaries, else the 16-byte path, and in both equals K6's contiguous
    output bit for bit and leaves every other channel as it was."""
    buf_c, at, c, paths = case
    buf, want, path = _k6_slot(cuda, (2, 23, 19, buf_c), at, c, mode)
    assert path == paths[pool.FWD_MODES.index(mode)]
    assert torch.equal(buf[..., at:at + c], want)
    assert _canary_outside(buf, at, c, mode)


def test_max_pool_fwd_slot_stores_per_int8_forward(cuda, monkeypatch):
    """One int8 forward of dilated_icpr_rate6_densely at full width stores
    into a slot six times (every block pools into its slot, on the
    16-byte path) and launches K6 into a map of its own no time; its
    logits equal those of the same forward that pools into maps of their
    own and copies them into the slots. A grsl_rate8 forward stores into
    no slot."""
    from dynseg_torch.bridge import flax_to_torch, init_variables_np
    from dynseg_torch.config import ModelConfig
    from dynseg_torch.ops import quant

    mcfg = ModelConfig(net_type="dilated_icpr_rate6_densely", num_classes=6)
    sd = {k: v.to(cuda) for k, v in
          flax_to_torch(init_variables_np(mcfg, num_input_bands=3, seed=5)).items()}
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 48, 40, 3)).astype(np.float32)).to(cuda)
    qsd = quant.quantize_variables(mcfg, sd, quant.calibrate(mcfg, sd, [x[:1]]))
    apply_fn = quant.make_apply(mcfg)
    with torch.inference_mode():
        apply_fn(qsd, x)
        pool.reset_launches()
        got = apply_fn(qsd, x)
        counts = dict(pool.fwd_slot_launches), dict(pool.fwd_launches)
        monkeypatch.setattr(quant, "max_pool_fwd_into",
                            lambda y, window, scale, out: quant.max_pool_fwd(y, window, scale))
        want = apply_fn(qsd, x)
    torch.cuda.synchronize()
    assert counts == ({"vec16": 6, "scalar": 0}, {"i8": 0, "f32_i8": 0, "f32": 0})
    assert torch.equal(got, want)
    mcfg, qsd, x = _rate8_int8_state(cuda)
    with torch.inference_mode():
        pool.reset_launches()
        quant.make_apply(mcfg)(qsd, x)
    torch.cuda.synchronize()
    assert pool.fwd_slot_launches == {"vec16": 0, "scalar": 0}
    assert sum(pool.fwd_launches.values()) == 6


# K7 on the dense-wired net's feature buffer: 13 zero lead channels, the
# bands and the block slots, 912 channels; each int8 block's prefix.
DENSE_PREFIXES = (144, 272, 400, 656)


def _k7_buffer(cuda, shape, dtype, lead=13, offset=0):
    """An NHWC buffer of half-steps of sx (ties, values past +-127 sx)
    behind `lead` zero channels, in `dtype`, starting `offset` elements
    past its allocation, and sx on the card."""
    gen = torch.Generator(cuda).manual_seed(sum(shape) + offset)
    sx = torch.tensor(0.25 if dtype == torch.bfloat16 else 0.0371, device=cuda)
    n = int(np.prod(shape))
    half = torch.randint(-300, 301, (n + offset,), generator=gen, device=cuda).float()
    buf = (half * 0.5 * sx).to(dtype)[offset:].view(shape)
    buf[..., :lead] = 0
    return buf, sx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("c", DENSE_PREFIXES)
@pytest.mark.parametrize("side", [96, 336])
def test_quantize_s8_kernel_matches_plain_bitwise_on_the_dense_prefixes(cuda, side, c, dtype):
    """K7 on a channel prefix of the 912-channel feature buffer at 8 x
    96^2 and at the main path's dense batch, 8 x 336^2, read in place:
    the codes equal the plain composition's bit for bit, in one launch of
    the 16-byte path."""
    buf, sx = _k7_buffer(cuda, (8, side, side, 912), dtype)
    before = dict(pool.quantize_launches)
    got = pool.quantize_s8(buf.permute(0, 3, 1, 2)[:, :c], sx).permute(0, 2, 3, 1)
    assert pool.quantize_launches == {**before, "vec16": before["vec16"] + 1}
    want = pool.quantize_act(buf[..., :c], sx)
    torch.cuda.synchronize()
    assert got.is_contiguous() and got.dtype == torch.int8 and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", [(48, 3, 0, 0), (48, 40, 5, 0), (160, 144, 13, 1),
                                  (16, 16, 0, 1)], ids=lambda c: "x".join(map(str, c)))
def test_quantize_s8_scalar_path_matches_plain_bitwise(cuda, case, dtype):
    """(buffer C, C, lead, offset): ragged C and a base one element off
    16 bytes take one value a thread and still equal the plain
    composition bit for bit."""
    buf_c, c, lead, offset = case
    buf, sx = _k7_buffer(cuda, (3, 17, 29, buf_c), dtype, lead, offset)
    before = dict(pool.quantize_launches)
    got = pool.quantize_s8(buf.permute(0, 3, 1, 2)[:, :c], sx).permute(0, 2, 3, 1)
    assert pool.quantize_launches == {**before, "scalar": before["scalar"] + 1}
    want = pool.quantize_act(buf[..., :c], sx)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_quantize_s8_launches_per_densely_int8_forward(cuda, monkeypatch):
    """One int8 forward of dilated_icpr_rate6_densely at full width
    launches K7 four times (blocks 2-5), all on the 16-byte path, and its
    logits equal those of the same forward with the plain composition."""
    from dynseg_torch.bridge import flax_to_torch, init_variables_np
    from dynseg_torch.config import ModelConfig
    from dynseg_torch.ops import quant

    mcfg = ModelConfig(net_type="dilated_icpr_rate6_densely", num_classes=6)
    sd = {k: v.to(cuda) for k, v in
          flax_to_torch(init_variables_np(mcfg, num_input_bands=3, seed=5)).items()}
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 48, 40, 3)).astype(np.float32)).to(cuda)
    qsd = quant.quantize_variables(mcfg, sd, quant.calibrate(mcfg, sd, [x[:1]]))
    apply_fn = quant.make_apply(mcfg)
    with torch.inference_mode():
        apply_fn(qsd, x)
        pool.reset_launches()
        got = apply_fn(qsd, x)
        counts = dict(pool.quantize_launches)
        monkeypatch.setattr(quant, "quantize_s8", pool.quantize_act)
        want = apply_fn(qsd, x)
    torch.cuda.synchronize()
    assert counts == {"vec16": 4, "scalar": 0}
    assert torch.equal(got, want)


def test_quantize_s8_launches_in_a_rate8_int8_forward(cuda):
    """A grsl_rate8 int8 forward launches K7 no time: its one float-to-int8
    step is fused into K6 (f32_i8). Under bfloat16 block 2 quantizes its
    map before the ATen pool: one launch, on the 16-byte path."""
    from dynseg_torch.ops import quant

    for dtype, want in (("float32", 0), ("bfloat16", 1)):
        mcfg, qsd, x = _rate8_int8_state(cuda, dtype)
        with torch.inference_mode():
            pool.reset_launches()
            quant.make_apply(mcfg)(qsd, x)
        assert pool.quantize_launches == {"vec16": want, "scalar": 0}


def _step_on_card_and_cpu(cuda, **model_kw):
    """One step of a width-0.25 net at batch 8, 25 px, lr 0.01, from the
    same weights on the card and on the CPU: {device type: (loss,
    state_dict on the CPU)}."""
    from dynseg_torch.config import Config, ModelConfig, SchedulerConfig, TrainConfig
    from dynseg_torch.data.datasets import load_synthetic
    from dynseg_torch.train import Trainer

    cfg = Config(model=ModelConfig(width_multiplier=0.25, **model_kw),
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
    return out


def test_train_step_on_card_matches_cpu(cuda):
    """One step with pool_backward pallas on the card (K2, K4, cuDNN
    without TF32) and on the CPU (plain versions): loss within 1e-5
    relative and params within 1e-6 absolute (an lr-scaled gradient whose
    float32 sums run in another order; measured 3.4e-7)."""
    out = _step_on_card_and_cpu(cuda, pool_backward="pallas")
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for k, v in out["cpu"][1].items():
        np.testing.assert_allclose(out["cuda"][1][k].numpy(), v.numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_bfloat16_train_step_on_card_matches_cpu(cuda):
    """The same step under compute_dtype bfloat16 with pool_backward xla
    (K4 takes float32 only): cuDNN's and the CPU's bfloat16 convs round
    their sums apart, so loss within 1e-2 relative and params within 5e-3
    (tests/test_torch_train.py's bfloat16 bounds)."""
    out = _step_on_card_and_cpu(cuda, pool_backward="xla", compute_dtype="bfloat16")
    assert np.isfinite(out["cuda"][0])
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-2)
    for k, v in out["cpu"][1].items():
        np.testing.assert_allclose(out["cuda"][1][k].double().numpy(), v.double().numpy(),
                                   rtol=0, atol=5e-3, err_msg=k)


def test_training_is_bitwise_reproducible_on_the_card(cuda):
    """Six steps of a width-0.25 net (multinomial over 25 and 45 px, batch
    16, pool_backward pallas, EMA 0.9 with two recalibration batches) on
    the card, twice from one seed: params, BN statistics, momentum, EMA,
    recalibrated statistics, losses, scales and scheduler scores bitwise
    equal (tolerance 0), with cuDNN's deterministic flag on."""
    from dynseg_torch.config import Config, ModelConfig, SchedulerConfig, TrainConfig
    from dynseg_torch.data.datasets import load_synthetic
    from dynseg_torch.probes import repro

    cfg = Config(model=ModelConfig(width_multiplier=0.25, pool_backward="pallas"),
                 sched=SchedulerConfig(distribution_type="multinomial", values=(25, 45)),
                 train=TrainConfig(batch_size=16, niter=6, ema_decay=0.9))
    tiles = load_synthetic(seed=0, num_tiles=2, size=96)[0]
    a, b = (repro.train_run(cfg, tiles, cuda, recalib=2) for _ in range(2))
    assert a["cudnn"] == (True, False) and len(a["losses"]) == 6
    assert all(np.isfinite(a["losses"]))
    assert all(d == 0.0 for d in repro.distances(a, b).values()), repro.distances(a, b)


def test_densely_training_is_bitwise_reproducible_on_the_card(cuda):
    """Three steps of the full-width densely net (multinomial over 25 and
    45 px, batch 8), whose block 5 (Cin 643, k3, d6) reaches cuDNN in
    NCHW, twice from one seed: bitwise equal, and every forward took the
    route (1 `nchw` conv to 6 `channels_last` ones)."""
    from dynseg_torch.config import Config, ModelConfig, SchedulerConfig, TrainConfig
    from dynseg_torch.data.datasets import load_synthetic
    from dynseg_torch.models import blocks
    from dynseg_torch.probes import repro

    cfg = Config(model=ModelConfig(net_type="dilated_icpr_rate6_densely"),
                 sched=SchedulerConfig(distribution_type="multinomial", values=(25, 45)),
                 train=TrainConfig(batch_size=8, niter=3))
    tiles = load_synthetic(seed=0, num_tiles=2, size=96)[0]
    blocks.reset_conv_layouts()
    a, b = (repro.train_run(cfg, tiles, cuda) for _ in range(2))
    counted = dict(blocks.conv_layouts)
    assert a["cudnn"] == (True, False) and len(a["losses"]) == 3
    assert all(np.isfinite(a["losses"]))
    assert all(d == 0.0 for d in repro.distances(a, b).values()), repro.distances(a, b)
    assert counted["nchw"] >= 6 and counted["channels_last"] == 6 * counted["nchw"], counted


# P1's (B, H, W, C, dilation): the TPU probe's check shapes, then ragged
# ones: odd H and W, B 3, C 32 and 160 (a half K chunk), dilations 1, 2,
# 5, 6, a dilation wider than the image, and a 1 x 1 image; then C 512 (two
# N tiles), dilation 20, and the probe's shape.
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
# data parallelism on the card, at small width
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
    reruns on the same batches with the rows in other orders); K2/K4
    launches equal the gathers and pool backwards, every K4 launch
    fused."""
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


# --------------------------------------------------------------------- #
# the estimator, the command line, the int8 artifact and the initial
# weights on the card
# --------------------------------------------------------------------- #
def _window_setup(cuda, size, **infer_kw):
    """A width-0.25 window float config over scales 25 and 35, two test
    tiles of size^2 and weights on the card."""
    from dynseg_torch.bridge import flax_to_torch, init_variables_np
    from dynseg_torch.config import Config, InferConfig, ModelConfig
    from dynseg_torch.data.datasets import load_synthetic

    cfg = Config(model=ModelConfig(num_classes=2, width_multiplier=0.25),
                 infer=InferConfig(scales=(25, 35), save_prediction_maps=False, **infer_kw))
    tiles = load_synthetic(seed=0, num_tiles=2, size=size)[1]
    sd = flax_to_torch(init_variables_np(cfg.model, num_input_bands=3, seed=0))
    return cfg, tiles, {k: v.to(cuda) for k, v in sd.items()}


def _window_grid(cfg, tiles, h: int, w: int):
    """{scale: windows} of the window grid over an h x w tile."""
    from dynseg_torch.infer import window_origins

    pad = max(max(cfg.infer.scales), cfg.infer.dense_halo)
    hp, wp = tiles.images.shape[1] + 2 * pad, tiles.images.shape[2] + 2 * pad
    out = {}
    for s in cfg.infer.scales:
        stride = min(s, max(1, int(round(s * cfg.infer.stride_fraction))))
        out[s] = (len(window_origins(pad, pad + h, s, stride, hp - s))
                  * len(window_origins(pad, pad + w, s, stride, wp - s)))
    return out


def test_capped_window_fold_on_the_card_equals_the_uncapped_run(cuda, monkeypatch):
    """DYNSEG_FOLD_MEM_GB under every scale's collected probabilities and
    over one window batch's: each scale folds in bands, the largest
    collected tensor stays within the cap, the vote counts equal the
    uncapped run's bitwise and the labels differ only at ties."""
    from dynseg_torch.infer import Inferencer

    cfg, tiles, sd = _window_setup(cuda, 192, window_batch=32)
    grid = _window_grid(cfg, tiles, *(int(v) for v in tiles.valid_hw[0]))
    px = {s: s * s * cfg.model.num_classes * 4 for s in grid}
    batch = max(cfg.infer.window_batch * b for b in px.values())
    whole = min(n * px[s] for s, n in grid.items())
    cap = (batch + whole) / 2
    assert batch < cap < whole
    inf = Inferencer(cfg, tiles, device=cuda)
    out = {}
    for name, gb in (("uncapped", None), ("capped", cap / 1e9)):
        if gb is None:
            monkeypatch.delenv("DYNSEG_FOLD_MEM_GB", raising=False)
        else:
            monkeypatch.setenv("DYNSEG_FOLD_MEM_GB", str(gb))
        out[name] = (*inf._window_device(sd, 0), inf.fold_peak_bytes)
    (pred_u, sum_u, cnt_u, peak_u), (pred_c, _, cnt_c, peak_c) = out["uncapped"], out["capped"]
    assert peak_c <= cap < peak_u
    assert torch.equal(cnt_u, cnt_c)
    top2 = torch.topk(sum_u / cnt_u[..., None], 2, dim=-1).values
    differ = pred_u != pred_c
    assert bool(((top2[..., 0] - top2[..., 1])[differ] < 1e-5).all())


def test_streamed_tiles_on_the_card_equal_the_resident_run(cuda):
    """hbm_budget_gb 0 keeps the test tiles on the host and uploads one a
    prediction: validate_test's label maps equal those of the run whose
    tiles stay on the card, bitwise."""
    import dataclasses

    from dynseg_torch.infer import Inferencer, validate_test

    cfg, tiles, sd = _window_setup(cuda, 96)
    maps = {}
    for budget in (cfg.infer.hbm_budget_gb, 0.0):
        c = dataclasses.replace(cfg, infer=dataclasses.replace(cfg.infer, hbm_budget_gb=budget))
        held = Inferencer(c, tiles, device=cuda).images
        assert isinstance(held, np.ndarray) == (budget == 0.0)
        maps[budget] = validate_test(c, sd, tiles, cuda, log=lambda *_: None)["predictions"]
    (resident, streamed) = maps.values()
    assert resident and all(np.array_equal(a, b) for a, b in zip(resident, streamed, strict=True))


def _launch_line(text: str) -> dict:
    """The counts of a run's one `kernel launches:` line."""
    lines = [m for m in text.splitlines() if m.startswith("kernel launches:")]
    assert len(lines) == 1, text[-3000:]
    return {k: int(v) for k, v in (kv.split("=") for kv in lines[0].split()[2:])}


def test_command_line_on_the_card_launches_each_kernel_per_unit_of_work(cuda, tmp_path):
    """`python -m dynseg_torch` in processes of their own: training a
    width-0.25 net (which the command line, having no width flag, takes
    from a wrapped config_from_args), then int8 testing at quant_min_ch 32,
    which quantizes blocks 3-5 at that width. K2 launches equal the
    gathers (a warm-up step per scale, the steps, one per evaluation), K4
    six a step, all fused; testing restores the run and launches K5 three
    times an int8 forward."""
    import json
    import math
    import os
    import subprocess
    import sys

    from dynseg_torch import cli
    from dynseg_torch.data.datasets import load_dataset

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    data = {"size": 128, "num_tiles": 4}
    scales, niter, every = (25, 35), 6, 3
    common = ["--dataset", "synthetic", "--dataset_kwargs", json.dumps(data), "--values",
              ",".join(map(str, scales)), "--output_path", str(tmp_path),
              "--no_prediction_maps"]
    narrow = ("import dataclasses, sys; from dynseg_torch import cli; f = cli.config_from_args; "
              "cli.config_from_args = lambda a: (lambda c: dataclasses.replace(c, model="
              "dataclasses.replace(c.model, width_multiplier=0.25)))(f(a)); "
              "sys.exit(cli.main(sys.argv[1:]))")
    runs = {"training": ["-c", narrow, "--operation", "training", "--niter", str(niter),
                         "--batch_size", "16", "--eval_every", str(every),
                         "--checkpoint_every", str(niter), "--pool_backward", "pallas"],
            "testing": ["-m", "dynseg_torch", "--operation", "testing", "--quant", "int8",
                        "--quant_exit", "--quant_min_ch", "32"]}
    got = {}
    for name, argv in runs.items():
        res = subprocess.run([sys.executable, *argv, *common], capture_output=True, text=True,
                             cwd=root, timeout=600)
        assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
        assert "TOTAL:" in res.stdout
        got[name] = _launch_line(res.stdout)
    steps = len(scales) + niter
    assert got["training"]["patch_gather"] == steps + niter // every
    assert got["training"]["pool_bwd"] == got["training"]["pool_bwd.fused"] == 6 * steps
    assert got["training"]["int8_block_conv"] == 0

    cfg = cli.config_from_args(cli.build_argparser().parse_args(runs["testing"][2:] + common))
    tiles = load_dataset("synthetic", "", 0, seed=0, **data)[1]
    forwards = sum(math.ceil(n / cfg.infer.window_batch) for h, w in tiles.valid_hw
                   for n in _window_grid(cfg, tiles, int(h), int(w)).values())
    assert got["testing"]["int8_block_conv"] == got["testing"]["int8_block_conv.wgmma"] \
        == 3 * forwards
    assert got["testing"]["patch_gather"] == got["testing"]["pool_bwd"] == 0


def test_int8_artifact_on_the_card_matches_the_live_forward(cuda, tmp_path):
    """A width-0.25 dilated_icpr_rate6 int8 artifact (blocks 3-5 at
    quant_min_ch 32, the int8 exit) exported, loaded onto the card and
    run on a 2 x 96 x 80 raster: probabilities within 1e-5 of the live
    int8 forward on the card, and the same K5, K6 and K7 launches through
    the registered ops: K5 three times, all wgmma, K6 once a pool."""
    from dynseg_torch.bridge import flax_to_torch, init_variables_np
    from dynseg_torch.config import Config, ModelConfig
    from dynseg_torch.export import ExportedPredictor, export_predictor
    from dynseg_torch.ops import quant

    cfg = Config(model=ModelConfig(num_classes=2, width_multiplier=0.25))
    mcfg = cfg.model
    mean, std = np.array([120.0, 110.5, 99.25]), np.array([40.0, 37.3, 51.7])
    raw = np.random.default_rng(5).uniform(0, 255, (2, 96, 80, 3)).astype(np.float32)
    xn = torch.from_numpy((raw - mean) / std).float().to(cuda)
    sd = {k: v.to(cuda) for k, v in flax_to_torch(
        init_variables_np(mcfg, num_input_bands=3, seed=4)).items()}
    qsd = quant.quantize_variables(mcfg, sd, quant.calibrate(mcfg, sd, [xn[:1]]), min_ch=32,
                                   exit_int8=True)
    export_predictor(cfg, {k: v.cpu() for k, v in sd.items()}, mean, std, str(tmp_path),
                     platforms=("cuda",), quant_variables={k: v.cpu() for k, v in qsd.items()})
    pred = ExportedPredictor.load(str(tmp_path), device=cuda)
    assert pred.manifest["quant_blocks"] == [
        "DilatedConvBlock_3", "DilatedConvBlock_4", "DilatedConvBlock_5"]

    def launches(fn):
        int8_conv.reset_launches()
        pool.reset_launches()
        with torch.inference_mode():
            out = fn()
        torch.cuda.synchronize()
        return out.float().cpu().numpy(), (
            int8_conv.launches, dict(int8_conv.variant_launches), dict(pool.fwd_launches),
            dict(pool.quantize_launches))

    got, counts = launches(lambda: pred.probs_device(raw))
    want, live_counts = launches(lambda: torch.softmax(
        quant.make_apply(mcfg)(qsd, xn).float(), dim=-1))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert counts == live_counts
    assert counts[0] == counts[1]["wgmma"] == 3
    assert sum(counts[2].values()) == 6


def test_reference_init_on_the_cards_host_is_pinned(cuda):
    """The reference's initial weights drawn on the card's host
    (`bridge.init_variables_like_reference`, full-width dilated_icpr_rate6,
    3 bands, 2 and 6 classes, seeds 0-4) have the pinned digests, and a
    Trainer's model on the card reads back the seed-0 one."""
    from dynseg_torch import bridge
    from dynseg_torch.config import Config, ModelConfig
    from dynseg_torch.data.datasets import load_synthetic
    from dynseg_torch.train import Trainer

    for (classes, seed), pin in sorted(bridge.REFERENCE_INIT_SHA256.items()):
        mcfg = ModelConfig(num_classes=classes, num_input_bands=3)
        digest = bridge.variables_sha256(bridge.init_variables_like_reference(mcfg, 3, seed))
        assert digest == pin, (classes, seed)
    tr = Trainer(Config(model=ModelConfig(num_classes=2, num_input_bands=3,
                                          pool_backward="xla")),
                 load_synthetic(seed=0, num_tiles=2, size=64)[0], device=cuda)
    sd = {k: v.cpu() for k, v in tr.init_state(0).model.state_dict().items()}
    assert bridge.variables_sha256(bridge.torch_to_flax(sd)) == bridge.REFERENCE_INIT_SHA256[2, 0]
