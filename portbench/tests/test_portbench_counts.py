"""The yardstick's arithmetic: multiply-adds of the nets as their
configurations state them, sequential and dense-wired, and the bound times
of K5, K2 and K4 at the shapes PERF.md's kernel table gives."""

import json

import numpy as np
import pytest
import torch

from portbench import counts, peaks
from tiny import REPO

CONFIGS = ["icpr_rate6-vaihingen", "grsl_rate8-potsdam"]


def model_of(config: str, **over) -> dict:
    """The `model` of a configuration file of the repo, with keys replaced."""
    path = REPO / "portbench" / "configs" / f"{config}.json"
    return dict(json.loads(path.read_text())["model"], **over)


def densely(**over) -> dict:
    """dilated_icpr_rate6_densely: icpr_rate6's published blocks, dense-wired."""
    return model_of("icpr_rate6-vaihingen", net_type="dilated_icpr_rate6_densely",
                    wiring="dense", **over)


@pytest.mark.parametrize("config,classes,macs", [
    ("icpr_rate6-vaihingen", 6, 1_386_688),
    ("icpr_rate6-vaihingen", 2, 1_385_664),
    ("grsl_rate8-potsdam", 6, 1_054_528),
])
def test_macs_per_pixel(config, classes, macs):
    assert counts.macs_per_px(counts.net(model_of(config, num_classes=classes))) == macs


@pytest.mark.parametrize("config", CONFIGS)
def test_float_blocks_of_the_int8_plan(config):
    net = counts.net(model_of(config))
    f32, i8 = counts.split_macs(net, 128)
    assert counts.quantized(net, 128) == [False] * 3 + [True] * 3
    assert f32 - net.blocks[-1].cout * 6 == 238_272
    assert f32 + i8 == counts.macs_per_px(net)


def test_k5_bounds_at_the_dense_shape():
    # 8 x 336^2 (block 256 + halo 40): 0.2393 / 0.2692 / 0.5384 ms, by ops.
    got = [peaks.bound_s(o, b, peaks.INT8_OPS) * 1e3
           for o, b in counts.k5_launches(counts.net(model_of("icpr_rate6-vaihingen")),
                                          128, 8, 336)]
    assert np.round(got, 4).tolist() == [0.2393, 0.2692, 0.5384]


def test_k2_bounds():
    got = [counts.k2_bytes(100, s, 3) / peaks.HBM_BYTES_S * 1e3
           for s in (25, 35, 45, 55, 65)]
    assert np.round(got, 5).tolist() == [0.00045, 0.00088, 0.00145, 0.00217, 0.00303]


def test_k4_bounds():
    got = [counts.k4_bytes(100, s, s, c) / peaks.HBM_BYTES_S * 1e3
           for s in (25, 65) for c in (64, 128, 256)]
    assert np.round(got, 4).tolist() == [0.0191, 0.0382, 0.0764, 0.1291, 0.2583, 0.5166]
    assert len(counts.k4_launches(counts.net(model_of("grsl_rate8-potsdam")), 100, 25)) == 6


def test_train_step_flops():
    m = 1_386_688
    assert counts.train_step_flops(counts.net(model_of("icpr_rate6-vaihingen")), 100, 25) == \
        (6 * m - 2 * 4800) * 100 * 625


def test_dense_wiring():
    """Worked by hand from the published blocks: the concat's channels,
    3,289,216 multiply-adds, 3,171,840 of them in blocks 2-5 under the int8
    plan at min_ch 128, every int8 block storing float32 (no int8 stream),
    and no input gradient for the raw bands of any concat."""
    net = counts.net(densely())
    assert [b.cin for b in net.blocks] == [3, 67, 131, 259, 387, 643]
    assert net.head_cin == 896
    m = counts.macs_per_px(net)
    assert m == 3_289_216
    assert counts.quantized(net, 128) == [False, False, True, True, True, True]
    assert counts.split_macs(net, 128) == (m - 3_171_840, 3_171_840)
    launches = counts.k5_launches(net, 128, 8, 336)
    assert [b for _, b in launches] == [
        counts.k5_bytes(8, 336, 336, b.cin, b.cout, b.k, 4) for b in net.blocks[2:]]
    raw = 3 * sum(b.k * b.k * b.cout for b in net.blocks)  # 35,712
    assert counts.train_step_flops(net, 100, 25) == (4 * m + 2 * (m - raw)) * 100 * 625


@pytest.mark.parametrize("config", CONFIGS)
def test_configuration_states_its_work(config):
    """A configuration whose macs_per_px is not what its blocks and wiring
    give is refused."""
    model = model_of(config)
    assert counts.macs_per_px(counts.checked_net(model)) == model["macs_per_px"]
    for wrong in (dict(model, macs_per_px=model["macs_per_px"] + 1),
                  dict(model, wiring="dense"), {k: v for k, v in model.items()
                                                if k != "macs_per_px"}):
        with pytest.raises(ValueError):
            counts.checked_net(wrong)
    with pytest.raises(ValueError):
        counts.net(dict(model, wiring="residual"))


@pytest.mark.parametrize("config", CONFIGS)
def test_configuration_is_the_ports_net(config):
    """Each configuration's blocks and wiring are what the port builds for
    its net_type."""
    from dynseg_torch.config import ModelConfig
    from dynseg_torch.models.dilated import DilatedDenseNet, arch, build_model

    model = model_of(config)
    mcfg = ModelConfig(net_type=model["net_type"], num_classes=model["num_classes"])
    assert model["blocks"] == [list(b) for b in arch(mcfg)]
    dense = isinstance(build_model(mcfg, model["num_input_bands"]), DilatedDenseNet)
    assert model["wiring"] == ("dense" if dense else "sequential")


@pytest.mark.parametrize("net_type", ["dilated_icpr_rate6", "dilated_icpr_original",
                                      "dilated_grsl", "dilated_grsl_rate8",
                                      "dilated_icpr_rate6_densely"])
@pytest.mark.parametrize("width", [1.0, 0.125])
def test_blocks_are_the_ports_operand_shapes(net_type, width):
    """The counts' channels follow the wiring as the port's int8 planner
    sees its operands, for every net the port builds."""
    from dynseg_torch.config import ModelConfig
    from dynseg_torch.models.dilated import DilatedDenseNet, arch, build_model
    from dynseg_torch.ops.quant import block_specs

    mcfg = ModelConfig(net_type=net_type, num_classes=6, width_multiplier=width)
    dense = isinstance(build_model(mcfg, 3), DilatedDenseNet)
    net = counts.net({"blocks": [list(b) for b in arch(mcfg)], "num_input_bands": 3,
                      "num_classes": 6, "width_multiplier": width,
                      "wiring": "dense" if dense else "sequential"})
    assert [(b.k, b.cin, b.cout, b.dilation, b.pool) for b in net.blocks] == [
        (s["kernel"], s["cin"], s["cout"], s["dilation"], s["pool"])
        for s in block_specs(mcfg, 3)]


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
