"""dynseg_torch's CUDA kernels on the card: K5 (csrc/int8_block_conv.cu),
K2 (csrc/patch_gather.cu) and K4 (csrc/pool_bwd.cu) against their plain
PyTorch versions, and the int8 serving path and a train step on the card
against the same on the CPU. Marked `gpu`; every test skips where
torch.cuda.is_available() is false. On a machine with a card and without
JAX (these tests import none), run

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from dynseg_torch.ops import gather, int8_conv, pool

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


# (B, H, W, Cin, Cout, k, dilation, requant): the slice's three block
# geometries at batch 1, then ragged tiles: M not a multiple of 128,
# Cout 192 and 68, Cin 144 (a partial K chunk), a 1 x 1 image; then the
# byte-load variant: Cin 131 (the dense-wired net's block 2), 24, 3 and
# Cout 30, 5.
SHAPES = [
    (1, 96, 96, 128, 128, 4, 4, True),
    (1, 96, 96, 128, 256, 3, 5, True),
    (1, 96, 96, 256, 256, 3, 6, False),
    (3, 25, 25, 128, 192, 3, 5, True),
    (1, 21, 17, 144, 68, 4, 4, False),
    (2, 7, 130, 256, 256, 3, 6, True),
    (1, 1, 1, 16, 4, 3, 2, False),
    (2, 13, 10, 131, 128, 4, 3, True),
    (1, 9, 11, 24, 30, 3, 2, True),
    (1, 5, 7, 3, 5, 5, 1, False),
]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain_bitwise(cuda, shape):
    b, h, w, cin, cout, k, dil, requant = shape
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.integers(-127, 128, (b, h, w, cin), dtype=np.int8)).to(cuda)
    wt = torch.from_numpy(rng.integers(-127, 128, (k, k, cin, cout), dtype=np.int8)).to(cuda)
    a = torch.from_numpy(rng.uniform(1e-6, 3e-6, cout).astype(np.float32)).to(cuda)
    bias = torch.from_numpy(rng.normal(0, 0.1, cout).astype(np.float32)).to(cuda)
    kw = dict(dilation=dil, leaky_slope=0.1, out_scale=0.05 if requant else None)
    before = int8_conv.launches
    got = int8_conv.int8_block_conv(x, wt, a, bias, **kw)
    assert int8_conv.launches == before + 1
    want = int8_conv.int8_block_conv_ref(x, wt, a, bias, **kw)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


def test_kernel_refuses_strided_input(cuda):
    x = torch.zeros((1, 8, 8, 32), dtype=torch.int8, device=cuda)[..., ::2]
    w = torch.zeros((3, 3, 16, 32), dtype=torch.int8, device=cuda)
    a = torch.zeros(32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        int8_conv.int8_block_conv(x, w, a, a, dilation=2, leaky_slope=0.1)


def test_int8_window_path_on_card_matches_cpu(cuda):
    """Full-width int8 window voting on a small tile: the card (K5,
    cuDNN) and the CPU (plain versions) give the same labels."""
    from dynseg.config import Config, InferConfig, ModelConfig
    from dynseg.data.datasets import load_synthetic
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
# (uint8, C 3, s 25..65, B 100), then float32 tiles, int32 masks, even and
# tiny sizes, C 1 and 5, a window as large as the tile, and a float32
# window of 65^2 x 5 that needs more than 48 KB of shared memory.
GATHER = [
    (3, 200, 190, 3, 65, 100, True, True),
    (3, 200, 190, 3, 25, 100, True, True),
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


# (B, H, W, C, window, ties): the slice's pool shapes at batch 2, then
# ragged ones: C 3 and 5, H or W of 1, window 5 and 7.
POOL = [
    (2, 25, 25, 64, 3, False), (2, 65, 65, 256, 3, True), (3, 13, 11, 3, 3, True),
    (1, 1, 9, 5, 3, False), (2, 10, 7, 8, 5, True), (1, 6, 9, 16, 7, True),
]


@pytest.mark.parametrize("case", POOL, ids=lambda c: "x".join(map(str, c)))
def test_pool_bwd_kernel_matches_plain_bitwise(cuda, case):
    b, h, w, c, window, ties = case
    rng = np.random.default_rng(sum(case[:5]))
    if ties:
        x = rng.integers(0, 3, (b, h, w, c)).astype(np.float32)
    else:
        x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    xt = torch.from_numpy(x).to(cuda)
    y = pool.pool_forward(xt.permute(0, 3, 1, 2), window).permute(0, 2, 3, 1).contiguous()
    g = torch.from_numpy(rng.normal(size=(b, h, w, c)).astype(np.float32)).to(cuda)
    before = pool.launches
    got = pool.pallas_pool_bwd(xt, y, g, window)
    assert pool.launches == before + 1
    want = pool.pallas_pool_bwd_ref(xt, y, g, window)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    np.testing.assert_allclose(float(got.sum()), float(g.sum()), rtol=1e-4)


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
    from dynseg.config import Config, ModelConfig, SchedulerConfig, TrainConfig
    from dynseg.data.datasets import load_synthetic
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
