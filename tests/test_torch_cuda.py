"""dynseg_torch's CUDA kernel on the card: K5 (csrc/int8_block_conv.cu)
against its plain PyTorch version, and the int8 serving path on the card
against the same path on the CPU. Marked `gpu`; every test skips where
torch.cuda.is_available() is false. On a machine with a card and without
JAX (these tests import none), run

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from dynseg_torch.ops import int8_conv

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
