"""The yardstick's arithmetic: multiply-adds of the nets and the bound
times of K5, K2 and K4 at the shapes PERF.md's kernel table gives."""

import numpy as np
import pytest
import torch

from portbench import counts, peaks


@pytest.mark.parametrize("net,classes,macs", [
    ("dilated_icpr_rate6", 6, 1_386_688),
    ("dilated_icpr_rate6", 2, 1_385_664),
    ("dilated_grsl_rate8", 6, 1_054_528),
])
def test_macs_per_pixel(net, classes, macs):
    assert counts.macs_per_px(net, 3, classes) == macs


@pytest.mark.parametrize("net", ["dilated_icpr_rate6", "dilated_grsl_rate8"])
def test_float_blocks_of_the_int8_plan(net):
    f32, i8 = counts.split_macs(net, 3, 6, 128)
    assert counts.quantized(net, 3, 128) == [False] * 3 + [True] * 3
    assert f32 - counts.blocks(net, 3)[-1].cout * 6 == 238_272
    assert f32 + i8 == counts.macs_per_px(net, 3, 6)


def test_k5_bounds_at_the_dense_shape():
    # 8 x 336^2 (block 256 + halo 40): 0.2393 / 0.2692 / 0.5384 ms, by ops.
    got = [peaks.bound_s(o, b, peaks.INT8_OPS) * 1e3
           for o, b in counts.k5_launches("dilated_icpr_rate6", 3, 128, 8, 336)]
    assert np.round(got, 4).tolist() == [0.2393, 0.2692, 0.5384]


def test_k2_bounds():
    got = [counts.k2_bytes(100, s, 3) / peaks.HBM_BYTES_S * 1e3
           for s in (25, 35, 45, 55, 65)]
    assert np.round(got, 5).tolist() == [0.00045, 0.00088, 0.00145, 0.00217, 0.00303]


def test_k4_bounds():
    got = [counts.k4_bytes(100, s, s, c) / peaks.HBM_BYTES_S * 1e3
           for s in (25, 65) for c in (64, 128, 256)]
    assert np.round(got, 4).tolist() == [0.0191, 0.0382, 0.0764, 0.1291, 0.2583, 0.5166]
    assert len(counts.k4_launches("dilated_grsl_rate8", 3, 100, 25)) == 6


def test_train_step_flops():
    m = 1_386_688
    assert counts.train_step_flops("dilated_icpr_rate6", 3, 6, 100, 25) == \
        (6 * m - 2 * 4800) * 100 * 625


@pytest.mark.parametrize("h,w", [(2494, 2064), (72, 80), (6000, 6000), (65, 130)])
@pytest.mark.parametrize("s", [25, 35, 45, 55, 65])
def test_window_grid_is_the_estimators(h, w, s):
    from dynseg_torch.infer import window_origins

    pad, st = 65, counts.window_stride(s, 0.5)
    for n in (h, w):
        # The estimator's limit is the packed extent; any limit at or past
        # the tile's own padded extent gives the same grid.
        assert counts.window_origins(pad, pad + n, s, st, n + 2 * pad - s) == \
            window_origins(pad, pad + n, s, st, n + 2 * pad + 300 - s)


@pytest.mark.parametrize("hw", [(72, 80), (64, 64), (300, 130)])
def test_dense_groups_are_the_estimators(monkeypatch, hw):
    from dynseg_torch.config import Config, InferConfig, ModelConfig
    from dynseg_torch.data.tiles import pack_tiles
    from dynseg_torch.infer import Inferencer

    cfg = Config(model=ModelConfig(num_classes=6, width_multiplier=0.125),
                 infer=InferConfig(mode="dense", dense_block=32, scales=(9, 13)))
    tiles = pack_tiles([np.zeros(hw + (3,), np.float32)], [np.zeros(hw, np.int32)])
    tiles.mean, tiles.std = np.zeros(3, np.float32), np.ones(3, np.float32)
    inf = Inferencer(cfg, tiles, "cpu")
    calls = []
    real = inf._split_probs
    monkeypatch.setattr(inf, "_split_probs",
                        lambda v, t, o, s, full: calls.append(full) or real(v, t, o, s, full))
    sd = {k: v for k, v in inf.model.state_dict().items()}
    inf.predict_tile_dense(sd, 0, block=32, halo=40, return_probs=False)
    groups, bb = counts.dense_groups(*hw, inf.pad, 32, 0)
    assert len(calls) == groups and set(calls) == {bb}


def test_tf32_rounding():
    from portbench.reference.net import round_tf32

    x = torch.tensor([1.0 + 2 ** -12, 1.0 + 3 * 2 ** -12, -1.0 - 3 * 2 ** -12, float("inf")])
    assert round_tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, -1.0 - 2 ** -10, float("inf")]
