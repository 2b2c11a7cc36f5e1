"""The serving path (dynseg_torch.infer) against dynseg.infer on the same
synthetic tiles and the same numpy-seeded weights.

Float runs: window-vote counts are integers and must be equal; the
vote-averaged probabilities may differ by float32 summation order only
(atol 1e-5); labels may differ only where the top two probabilities are
within 1e-5 (ties); OA and kappa within 1e-4.

The int8 run compares the port (K5 formulation: folded affine, multiply
by 1/scale) with the reference's default int8 route (XLA emitter: float
epilogue, divide by the scale), so a few requantized codes may round
the other way: labels must agree on >= 99.5% of pixels.

Test-time augmentation and host streaming are held to the float bounds
above. Under compute_dtype bfloat16 the two frameworks round the
activations at the same points, but their bfloat16 convs accumulate in
other orders, so an activation may land one bfloat16 ulp (2^-8 relative)
away and the next layers carry it: probabilities within 1e-2 (the
reference's own bfloat16 run is 3e-3 from its float32 run on the dense
tile, 6.5e-3 in int8), and labels equal except where the reference's top
two probabilities are within 1e-2. Window voting averages that noise
away: there labels must agree on >= 99.5% of pixels. The weights are
random and the head bias centres the classes, so ~1% of dense pixels
sit within bfloat16 noise of a tie (the reference's bfloat16 and float32
dense labels agree on 99.0%, its int8 ones on 97.5%)."""

import dataclasses

import numpy as np
import pytest
import torch

from dynseg import infer as jax_infer
from dynseg.config import Config, InferConfig, ModelConfig
from dynseg.data.datasets import load_synthetic
from dynseg_torch import config as port_config
from dynseg_torch import infer
from dynseg_torch.bridge import flax_to_torch, init_variables_np
from dynseg_torch.data import tiles as port_tiles
from dynseg_torch.ops import dihedral as port_dihedral
from dynseg_torch.ops.gather import dihedral_batch


def _port(obj):
    """The port's dataclass of the same name (a config, or a TileSet) with
    the reference object's field values."""
    mod = port_tiles if type(obj).__name__ == "TileSet" else port_config
    vals = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    return getattr(mod, type(obj).__name__)(**{
        k: _port(v) if dataclasses.is_dataclass(v) else v for k, v in vals.items()})


@pytest.mark.parametrize("lo,hi,size,stride,lim", [
    (40, 136, 9, 4, 167), (40, 136, 13, 6, 163), (65, 1089, 25, 12, 1129),
    (65, 1089, 65, 32, 1089), (3, 5, 9, 4, 0), (0, 7, 3, 3, 4), (10, 11, 1, 1, 20),
])
def test_window_origins_and_split_match_reference(lo, hi, size, stride, lim):
    got = infer.window_origins(lo, hi, size, stride, lim)
    assert got == jax_infer.window_origins(lo, hi, size, stride, lim)
    assert infer._split_uniform(got, stride) == jax_infer._split_uniform(got, stride)


def _cfg(mode="window", quant="none", width=0.125, dtype="float32",
         quant_conv="xla", **infer_kw):
    return Config(
        model=ModelConfig(net_type="dilated_icpr_rate6", num_classes=2,
                          num_input_bands=3, width_multiplier=width,
                          compute_dtype=dtype, quant_conv=quant_conv),
        infer=InferConfig(scales=(9, 13), mode=mode, quant=quant,
                          save_prediction_maps=False, **infer_kw))


def _variables(cfg, tiles, seed=0):
    """Random weights with seeded BN statistics, and a head bias that
    centres the port's prediction of `tiles` in cfg's mode, so that both
    classes are predicted and the label maps compared are not constant.
    The head bias feeds neither calibration nor quantization."""
    variables = init_variables_np(_port(cfg.model), num_input_bands=3, seed=seed)
    rng = np.random.default_rng(seed + 1)
    for block in variables["batch_stats"].values():
        bn = block["BatchNorm_0"]
        bn["mean"] = rng.normal(scale=0.2, size=bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    inf = infer.Inferencer(_port(cfg), _port(tiles), "cpu")
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
    tinf = infer.Inferencer(_port(cfg), _port(tiles96), device="cpu")
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
    got = infer.validate_test(_port(cfg), sd, _port(tiles96), "cpu", log=lines.append)
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
    got = infer.validate_test(_port(cfg), flax_to_torch(_variables(cfg, tiles96)),
                              _port(tiles96), "cpu", log=lambda *_: None)
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
    got = infer.validate_test(_port(cfg), flax_to_torch(variables), _port(tiles), "cpu",
                              log=lines.append)
    want = jax_infer.validate_test(cfg, variables, tiles, log=lambda *_: None)
    assert lines[0].startswith(
        "int8 serving path: quantized blocks ['DilatedConvBlock_3', "
        "'DilatedConvBlock_4', 'DilatedConvBlock_5']")
    agree = np.mean(got["predictions"][0] == want["predictions"][0])
    assert agree >= 0.995, agree
    assert 0.1 < got["predictions"][0].mean() < 0.9
    assert abs(got["oa"] - want["oa"]) <= 0.005


@pytest.fixture(scope="module")
def tiles_ragged():
    """Two 96 x 96 synthetic test tiles with valid extents 96 x 72 and
    60 x 96 inside the pack: a non-square tile, and one smaller than the
    pack."""
    tiles = load_synthetic(seed=0, num_tiles=4, size=96)[1]
    masks = tiles.masks.copy()
    masks[0, :, 72:] = 255
    masks[1, 60:] = 255
    return dataclasses.replace(tiles, masks=masks,
                               valid_hw=np.array([[96, 72], [60, 96]]))


@pytest.mark.parametrize("k", range(8))
def test_dihedral_matches_reference(k):
    """dihedral / dihedral_inv against dynseg.ops.dihedral on a
    non-square image, bitwise; the inverse undoes the transform, and
    training's per-sample dihedral_batch follows the same convention."""
    from dynseg.ops.dihedral import dihedral, dihedral_inv

    x = np.random.default_rng(k).normal(size=(5, 7, 3)).astype(np.float32)
    got = port_dihedral.dihedral(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got.numpy(), dihedral(x, k, np))
    back = port_dihedral.dihedral_inv(got, k)
    np.testing.assert_array_equal(back.numpy(), dihedral_inv(dihedral(x, k, np), k, np))
    np.testing.assert_array_equal(back.numpy(), x)
    sq = torch.from_numpy(x[:5, :5])
    batch = dihedral_batch(sq[None], torch.tensor([k]))[0]
    assert torch.equal(batch, port_dihedral.dihedral(sq, k))


@pytest.mark.parametrize("mode", ["window", "dense"])
def test_tta_matches_reference(tiles_ragged, mode):
    """The 8-way dihedral fusion of a non-square tile (96 x 72) against
    the reference's _tta_device: fused probabilities within 1e-5 and
    labels equal except ties. predict_tile(_dense)(tta=True), cfg tta and
    validate_test give the same labels."""
    cfg = _cfg(mode=mode, dense_block=32)
    variables = _variables(cfg, tiles_ragged)
    sd = flax_to_torch(variables)
    jinf = jax_infer.Inferencer(cfg, tiles_ragged)
    tinf = infer.Inferencer(_port(cfg), _port(tiles_ragged), device="cpu")
    pj, prob_j = (np.asarray(a) for a in jinf._tta_device(variables, 0, mode=mode,
                                                          block=32, halo=40))
    pt, prob_t = (a.numpy() for a in tinf._tta_device(sd, 0, mode=mode,
                                                      block=32, halo=40))
    assert pt.shape == (96, 72) and prob_t.shape == (96, 72, 2)
    _assert_probs_and_labels(pt, prob_t, pj, prob_j)

    if mode == "dense":
        lab, prob = tinf.predict_tile_dense(sd, 0, block=32, halo=40, tta=True)
    else:
        lab, prob = tinf.predict_tile(sd, 0, tta=True)
    np.testing.assert_array_equal(prob, prob_t)
    np.testing.assert_array_equal(lab, pt)
    tcfg = dataclasses.replace(cfg, infer=dataclasses.replace(cfg.infer, tta=True))
    tta_inf = infer.Inferencer(_port(tcfg), _port(tiles_ragged), device="cpu")
    np.testing.assert_array_equal(tta_inf.predict_tile_device(sd, 0).numpy(), pt)
    got = infer.validate_test(_port(tcfg), sd, _port(tiles_ragged), "cpu",
                              log=lambda *_: None)
    np.testing.assert_array_equal(got["predictions"][0], pt)
    assert got["predictions"][1].shape == (60, 96)
    # The fusion is not the plain prediction: 8 transforms were averaged.
    plain = tinf.predict_tile_device(sd, 0).numpy()
    assert not np.array_equal(plain, pt) or not np.array_equal(
        prob_t, (tinf.predict_tile_dense(sd, 0, 32, 40) if mode == "dense"
                 else tinf.predict_tile(sd, 0))[1])


@pytest.mark.parametrize("mode", ["window", "dense"])
def test_host_streaming_matches_resident_and_reference(tiles_ragged, mode):
    """hbm_budget_gb=0: the packed set stays on the host as numpy and each
    predict uploads one tile; counts and maps are bitwise those of the
    resident run, and match the reference's streamed run."""
    cfg = _cfg(mode=mode, dense_block=32)
    variables = _variables(cfg, tiles_ragged)
    sd = flax_to_torch(variables)
    scfg = dataclasses.replace(cfg, infer=dataclasses.replace(cfg.infer, hbm_budget_gb=0.0))
    resident = infer.Inferencer(_port(cfg), _port(tiles_ragged), device="cpu")
    streamed = infer.Inferencer(_port(scfg), _port(tiles_ragged), device="cpu")
    assert isinstance(resident.images, torch.Tensor)
    assert isinstance(streamed.images, np.ndarray)
    np.testing.assert_array_equal(streamed.images, resident.images.numpy())
    jinf = jax_infer.Inferencer(scfg, tiles_ragged)
    assert isinstance(jinf.images, np.ndarray)
    for t in range(2):
        if mode == "dense":
            outs = [inf._dense_device(sd, t, 32, 40)[:2] for inf in (resident, streamed)]
            pj, prob_j = (np.asarray(a) for a in jinf._dense_device(variables, t, 32, 40)[:2])
        else:
            outs = [inf._window_device(sd, t) for inf in (resident, streamed)]
            pj, sum_j, cnt_j = (np.asarray(a) for a in jinf._window_device(variables, t))
            cnt_r, cnt_s = outs[0][2], outs[1][2]
            assert torch.equal(cnt_r, cnt_s)
            np.testing.assert_array_equal(cnt_s.numpy(), cnt_j)
            prob_j = sum_j / cnt_j[..., None]
        for a, b in zip(outs[0], outs[1]):
            assert torch.equal(a, b)
        pt, prob_t = outs[1][0].numpy(), outs[1][1].numpy()
        if mode == "window":
            prob_t = prob_t / outs[1][2].numpy()[..., None]
        assert pt.shape == tuple(tiles_ragged.valid_hw[t])
        _assert_probs_and_labels(pt, prob_t, pj, prob_j)


def test_host_streaming_calibrates_int8_from_the_host_tiles():
    """int8 calibration crops are cut from the streamed tiles through the
    same upload: the quantized state_dict is bitwise the resident one's."""
    tiles = load_synthetic(seed=0, num_tiles=2, size=48)[1]
    cfg = _cfg(quant="int8", width=1.0)
    scfg = dataclasses.replace(cfg, infer=dataclasses.replace(cfg.infer, hbm_budget_gb=0.0))
    sd = flax_to_torch(init_variables_np(_port(cfg.model), num_input_bands=3, seed=4))
    out = []
    for c in (cfg, scfg):
        inf = infer.Inferencer(_port(c), _port(tiles), device="cpu")
        out.append(inf.enable_quant(sd))
    assert isinstance(inf.images, np.ndarray)
    assert out[0].keys() == out[1].keys() and any(k.endswith("act_scale") for k in out[0])
    for k in out[0]:
        assert torch.equal(out[0][k], out[1][k]), k


def _assert_bf16_probs_and_labels(pred_t, prob_t, pred_j, prob_j):
    np.testing.assert_allclose(prob_t, prob_j, rtol=0, atol=1e-2)
    differ = pred_t != pred_j
    top2 = np.sort(prob_j, axis=-1)[..., -2:]
    assert np.all(top2[differ, 1] - top2[differ, 0] < 1e-2)
    assert differ.mean() <= 0.03, differ.mean()


@pytest.mark.parametrize("mode", ["window", "dense"])
def test_bfloat16_validate_test_matches_reference(tiles96, mode):
    cfg = _cfg(mode=mode, dtype="bfloat16", dense_block=32)
    variables = _variables(dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, compute_dtype="float32")), tiles96)
    sd = flax_to_torch(variables)
    jinf = jax_infer.Inferencer(cfg, tiles96)
    tinf = infer.Inferencer(_port(cfg), _port(tiles96), device="cpu")
    assert all(b.compute_dtype == torch.bfloat16 for b in tinf.model.blocks)
    if mode == "window":
        pj, sum_j, cnt_j = (np.asarray(a) for a in jinf._window_device(variables, 0))
        pt, sum_t, cnt_t = (a.numpy() for a in tinf._window_device(sd, 0))
        np.testing.assert_array_equal(cnt_t, cnt_j)
        _assert_bf16_probs_and_labels(pt, sum_t / cnt_t[..., None],
                                      pj, sum_j / cnt_j[..., None])
    else:
        pj, prob_j = jinf.predict_tile_dense(variables, 0, block=32, halo=40)
        pt, prob_t = tinf.predict_tile_dense(sd, 0, block=32, halo=40)
        _assert_bf16_probs_and_labels(pt, prob_t, pj, prob_j)
    got = infer.validate_test(_port(cfg), sd, _port(tiles96), "cpu", log=lambda *_: None)
    want = jax_infer.validate_test(cfg, variables, tiles96, log=lambda *_: None)
    agree = np.mean(got["predictions"][0] == want["predictions"][0])
    assert agree >= (0.995 if mode == "window" else 0.97), agree
    assert 0.1 < got["predictions"][0].mean() < 0.9
    assert abs(got["oa"] - want["oa"]) <= 0.01


def test_int8_bfloat16_matches_reference_k5_route():
    """int8 serving under compute_dtype bfloat16, dense mode, against the
    reference's K5 route (quant_conv="pallas", interpret mode): the same
    calibrated scales, blocks 3 and 4 requantize and block 5's K5 launch
    stores bfloat16; probabilities and labels as above."""
    tiles = load_synthetic(seed=0, num_tiles=1, size=48)[1]
    cfg = _cfg(mode="dense", quant="int8", width=1.0, dtype="bfloat16",
               quant_conv="pallas", dense_block=32)
    fcfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                              compute_dtype="float32"))
    variables = _variables(fcfg, tiles, seed=3)
    jinf = jax_infer.Inferencer(cfg, tiles)
    jq = jinf.enable_quant(variables)
    tinf = infer.Inferencer(_port(cfg), _port(tiles), device="cpu")
    tq = tinf.enable_quant(flax_to_torch(variables))
    for i in (3, 4, 5):
        np.testing.assert_allclose(
            float(tq[f"blocks.{i}.act_scale"]),
            float(jq["quant"][f"DilatedConvBlock_{i}"]["act_scale"]), rtol=1e-6)
    stores = []
    conv = infer.quant_ops.int8_block_conv_packed

    def watched(x, pc, variant=None):
        out = conv(x, pc, variant)
        stores.append(out.dtype)
        return out

    infer.quant_ops.int8_block_conv_packed = watched
    try:
        pt, prob_t = tinf.predict_tile_dense(tq, 0, block=32, halo=40)
    finally:
        infer.quant_ops.int8_block_conv_packed = conv
    assert stores == [torch.int8, torch.int8, torch.bfloat16]
    pj, prob_j = jinf.predict_tile_dense(jq, 0, block=32, halo=40)
    _assert_bf16_probs_and_labels(pt, prob_t, pj, prob_j)
    assert 0.1 < pt.mean() < 0.9


def _window_run(cfg, tiles, variables, monkeypatch, cap_gb):
    """The port's window estimator on tile 0 with DYNSEG_FOLD_MEM_GB at
    `cap_gb` (None: unset), recording the bytes of every tensor it gets
    from torch.cat or hands to F.fold."""
    if cap_gb is None:
        monkeypatch.delenv("DYNSEG_FOLD_MEM_GB", raising=False)
    else:
        monkeypatch.setenv("DYNSEG_FOLD_MEM_GB", str(cap_gb))
    seen = []
    cat, fold = torch.cat, torch.nn.functional.fold

    def watched_cat(*args, **kwargs):
        out = cat(*args, **kwargs)
        seen.append(out.numel() * out.element_size())
        return out

    def watched_fold(x, *args, **kwargs):
        seen.append(x.numel() * x.element_size())
        return fold(x, *args, **kwargs)

    tinf = infer.Inferencer(_port(cfg), _port(tiles), device="cpu")
    with monkeypatch.context() as m:
        m.setattr(torch, "cat", watched_cat)
        m.setattr(torch.nn.functional, "fold", watched_fold)
        out = [a.numpy() for a in tinf._window_device(flax_to_torch(variables), 0)]
    return out, seen, tinf.fold_peak_bytes


def _scale_buffers(cfg, tiles):
    """Bytes of each scale's whole collected buffer: every window's
    probabilities, as the port collects them below the cap."""
    pad = max(max(cfg.infer.scales), cfg.infer.dense_halo)
    h, w = (int(v) for v in tiles.valid_hw[0])
    hp, wp = h + 2 * pad, w + 2 * pad
    out = {}
    for s in cfg.infer.scales:
        stride = min(s, max(1, int(round(s * cfg.infer.stride_fraction))))
        n = (len(infer.window_origins(pad, pad + h, s, stride, hp - s))
             * len(infer.window_origins(pad, pad + w, s, stride, wp - s)))
        out[s] = n * s * s * cfg.model.num_classes * 4
    return out


# Caps in GB between one window batch of 32 (21 / 43 KB at s = 9 / 13)
# and a scale's buffer (~440 KB): every scale is folded in bands.
@pytest.mark.parametrize("cap_gb", [6e-5, 1.5e-4])
def test_capped_window_fold_stays_under_cap_and_matches_reference(
        tiles96, monkeypatch, cap_gb):
    cfg = _cfg(window_batch=32)
    variables = _variables(cfg, tiles96)
    buffers = _scale_buffers(cfg, tiles96)
    cap = cap_gb * 1e9
    assert min(buffers.values()) > cap
    (pt, sum_t, cnt_t), seen, peak = _window_run(cfg, tiles96, variables,
                                                 monkeypatch, cap_gb)
    assert seen and max(seen) <= cap
    assert 0 < peak <= cap and peak == max(seen)

    jcfg = dataclasses.replace(cfg, infer=dataclasses.replace(cfg.infer,
                                                              window_fold="off"))
    pj, sum_j, cnt_j = (np.asarray(a) for a in
                        jax_infer.Inferencer(jcfg, tiles96)._window_device(variables, 0))
    np.testing.assert_array_equal(cnt_t, cnt_j)
    _assert_probs_and_labels(pt, sum_t / cnt_t[..., None], pj, sum_j / cnt_j[..., None])


def test_uncapped_window_fold_collects_each_scale_whole(tiles96, monkeypatch):
    cfg = _cfg(window_batch=32)
    variables = _variables(cfg, tiles96)
    (pt, sum_t, cnt_t), seen, peak = _window_run(cfg, tiles96, variables,
                                                 monkeypatch, None)
    assert peak == max(_scale_buffers(cfg, tiles96).values()) == max(seen)
    (pb, sum_b, cnt_b), _, peak_b = _window_run(cfg, tiles96, variables,
                                                monkeypatch, 6e-5)
    assert peak_b < peak
    np.testing.assert_array_equal(cnt_b, cnt_t)
    _assert_probs_and_labels(pb, sum_b / cnt_b[..., None], pt, sum_t / cnt_t[..., None])
