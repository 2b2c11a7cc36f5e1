"""The serving path (dynseg_torch.infer) against dynseg.infer on the same
synthetic tiles and the same numpy-seeded weights.

Float runs: window-vote counts are integers and must be equal; the
vote-averaged probabilities may differ by float32 summation order only
(atol 1e-5); labels may differ only where the top two probabilities are
within 1e-5 (ties); OA and kappa within 1e-4.

The int8 run compares the port (K5 formulation: folded affine, multiply
by 1/scale) with the reference's default int8 route (XLA emitter: float
epilogue, divide by the scale), so a few requantized codes may round
the other way: labels must agree on >= 99.5% of pixels."""

import dataclasses

import numpy as np
import pytest
import torch

from dynseg import infer as jax_infer
from dynseg.config import Config, InferConfig, ModelConfig
from dynseg.data.datasets import load_synthetic
from dynseg_torch import infer
from dynseg_torch.bridge import flax_to_torch, init_variables_np


@pytest.mark.parametrize("lo,hi,size,stride,lim", [
    (40, 136, 9, 4, 167), (40, 136, 13, 6, 163), (65, 1089, 25, 12, 1129),
    (65, 1089, 65, 32, 1089), (3, 5, 9, 4, 0), (0, 7, 3, 3, 4), (10, 11, 1, 1, 20),
])
def test_window_origins_and_split_match_reference(lo, hi, size, stride, lim):
    got = infer.window_origins(lo, hi, size, stride, lim)
    assert got == jax_infer.window_origins(lo, hi, size, stride, lim)
    assert infer._split_uniform(got, stride) == jax_infer._split_uniform(got, stride)


def _cfg(mode="window", quant="none", width=0.125, **infer_kw):
    return Config(
        model=ModelConfig(net_type="dilated_icpr_rate6", num_classes=2,
                          num_input_bands=3, width_multiplier=width),
        infer=InferConfig(scales=(9, 13), mode=mode, quant=quant,
                          save_prediction_maps=False, **infer_kw))


def _variables(cfg, tiles, seed=0):
    """Random weights with seeded BN statistics, and a head bias that
    centres the port's prediction of `tiles` in cfg's mode, so that both
    classes are predicted and the label maps compared are not constant.
    The head bias feeds neither calibration nor quantization."""
    variables = init_variables_np(cfg.model, num_input_bands=3, seed=seed)
    rng = np.random.default_rng(seed + 1)
    for block in variables["batch_stats"].values():
        bn = block["BatchNorm_0"]
        bn["mean"] = rng.normal(scale=0.2, size=bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    inf = infer.Inferencer(cfg, tiles, "cpu")
    sd = inf.enable_quant(flax_to_torch(variables))
    if cfg.infer.mode == "dense":
        _, prob = inf.predict_tile_dense(sd, 0, cfg.infer.dense_block,
                                         cfg.infer.dense_halo)
    else:
        _, prob = inf.predict_tile(sd, 0)
    head = variables["params"]["ScoreHead_0"]["Conv_0"]
    head["bias"][1] -= np.median(np.log(prob[..., 1] / prob[..., 0]))
    return variables


@pytest.fixture(scope="module")
def tiles96():
    return load_synthetic(seed=0, num_tiles=2, size=96)[1]


def _assert_probs_and_labels(pred_t, prob_t, pred_j, prob_j):
    np.testing.assert_allclose(prob_t, prob_j, rtol=0, atol=1e-5)
    differ = pred_t != pred_j
    top2 = np.sort(prob_j, axis=-1)[..., -2:]
    assert np.all(top2[differ, 1] - top2[differ, 0] < 1e-5)


@pytest.mark.parametrize("mode", ["window", "dense"])
def test_float_validate_test_matches_reference(tiles96, mode):
    cfg = _cfg(mode=mode, dense_block=32)
    variables = _variables(cfg, tiles96)
    sd = flax_to_torch(variables)

    jinf = jax_infer.Inferencer(cfg, tiles96)
    tinf = infer.Inferencer(cfg, tiles96, device="cpu")
    if mode == "window":
        pj, sum_j, cnt_j = (np.asarray(a) for a in jinf._window_device(variables, 0))
        pt, sum_t, cnt_t = (a.numpy() for a in tinf._window_device(sd, 0))
        np.testing.assert_array_equal(cnt_t, cnt_j)
        _assert_probs_and_labels(pt, sum_t / cnt_t[..., None],
                                 pj, sum_j / cnt_j[..., None])
    else:
        pj, prob_j = jinf.predict_tile_dense(variables, 0, block=32, halo=40)
        pt, prob_t = tinf.predict_tile_dense(sd, 0, block=32, halo=40)
        _assert_probs_and_labels(pt, prob_t, pj, prob_j)

    lines = []
    got = infer.validate_test(cfg, sd, tiles96, log=lines.append)
    want = jax_infer.validate_test(cfg, variables, tiles96, log=lambda *_: None)
    assert abs(got["oa"] - want["oa"]) <= 1e-4
    assert abs(got["kappa"] - want["kappa"]) <= 1e-4
    assert got["predictions"][0].shape == want["predictions"][0].shape == (96, 96)
    assert got["predictions"][0].dtype == np.int32
    assert lines[-1].startswith("TOTAL: OA=")
    assert any(line.startswith("tile 0: OA=") for line in lines)
    # Not a constant map: the label comparison above means something.
    assert 0.1 < got["predictions"][0].mean() < 0.9


def test_eroded_scores_and_confusion(tiles96):
    cfg = _cfg(eroded_boundary_radius=2)
    got = infer.validate_test(cfg, flax_to_torch(_variables(cfg, tiles96)), tiles96,
                              log=lambda *_: None)
    gt = tiles96.masks[0, :96, :96]
    pred = got["predictions"][0]
    from dynseg.metrics import erode_boundaries, scores_from_confusion

    def cm(mask):
        valid = mask != 255
        return np.bincount(mask[valid] * 2 + pred[valid], minlength=4).reshape(2, 2)

    np.testing.assert_array_equal(got["confusion"], cm(gt))
    want = scores_from_confusion(cm(erode_boundaries(gt, 2)))
    np.testing.assert_array_equal(got["eroded"]["confusion"], want["confusion"])
    assert got["eroded"]["oa"] == want["oa"]


def test_int8_validate_test_matches_reference():
    tiles = load_synthetic(seed=0, num_tiles=2, size=48)[1]
    cfg = _cfg(quant="int8", width=1.0)
    variables = _variables(cfg, tiles, seed=3)
    lines = []
    got = infer.validate_test(cfg, flax_to_torch(variables), tiles,
                              log=lines.append)
    want = jax_infer.validate_test(cfg, variables, tiles, log=lambda *_: None)
    assert lines[0].startswith(
        "int8 serving path: quantized blocks ['DilatedConvBlock_3', "
        "'DilatedConvBlock_4', 'DilatedConvBlock_5']")
    agree = np.mean(got["predictions"][0] == want["predictions"][0])
    assert agree >= 0.995, agree
    assert 0.1 < got["predictions"][0].mean() < 0.9
    assert abs(got["oa"] - want["oa"]) <= 0.005


def test_tta_is_refused(tiles96):
    cfg = dataclasses.replace(_cfg(), infer=InferConfig(tta=True))
    with pytest.raises(NotImplementedError):
        infer.Inferencer(cfg, tiles96, device="cpu")
