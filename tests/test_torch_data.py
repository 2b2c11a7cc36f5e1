"""The port's own copies of the JAX package's host-side modules
(dynseg_torch.config, .data.*, .sched.scheduler, .viz, .utils.logging and
the native position tables) against their originals: the same inputs,
made from numpy seeds, give equal configs, messages, arrays, positions,
scale sequences, reports and files."""

import dataclasses
import json
import os

import numpy as np
import pytest

import dynseg.config as ref_config
import dynseg.data.check as ref_check
import dynseg.data.datasets as ref_datasets
import dynseg.data.native as ref_native
import dynseg.data.sampler as ref_sampler
import dynseg.data.tiles as ref_tiles
import dynseg.sched.scheduler as ref_scheduler
import dynseg.utils.logging as ref_logging
import dynseg.viz as ref_viz
from dynseg_torch import config as port_config
from dynseg_torch import viz as port_viz
from dynseg_torch.data import check as port_check
from dynseg_torch.data import datasets as port_datasets
from dynseg_torch.data import native as port_native
from dynseg_torch.data import sampler as port_sampler
from dynseg_torch.data import tiles as port_tiles
from dynseg_torch.sched import scheduler as port_scheduler
from dynseg_torch.utils import logging as port_logging


def _as(mod, obj):
    """`obj` rebuilt as the dataclass of the same name in `mod`, from the
    same field values."""
    vals = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    return getattr(mod, type(obj).__name__)(**{
        k: _as(mod, v) if dataclasses.is_dataclass(v) else v for k, v in vals.items()})


def _assert_tiles_equal(got, want):
    assert type(got) is port_tiles.TileSet
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if b is None:
            assert a is None, f.name
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name


# --------------------------------------------------------------------- #
# config
# --------------------------------------------------------------------- #
CONFIG_CLASSES = ["ModelConfig", "SchedulerConfig", "TrainConfig", "InferConfig",
                  "DataConfig", "Config"]


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_fields_and_defaults_match(name):
    ref, port = getattr(ref_config, name), getattr(port_config, name)
    fields = [(f.name, f.type) for f in dataclasses.fields(ref)]
    assert [(f.name, f.type) for f in dataclasses.fields(port)] == fields
    assert ref.__dataclass_params__.frozen and port.__dataclass_params__.frozen
    assert dataclasses.asdict(port()) == dataclasses.asdict(ref())


def test_config_constants_match():
    for name in ("DEFAULT_SCALES", "DISTRIBUTION_TYPES", "UPDATE_TYPES", "NET_TYPES",
                 "DATASETS"):
        assert getattr(port_config, name) == getattr(ref_config, name), name


# (section, field, value) set on the default Config; None: a valid one.
BAD_CONFIGS = [
    None, ("model", "net_type", "resnet"), ("sched", "distribution_type", "zipf"),
    ("sched", "update_type", "f1"), ("data", "dataset", "mnist"), ("sched", "values", ()),
    ("sched", "values", (25, 0)), ("sched", "values", (25, 25)),
    ("train", "batch_size", 0), ("train", "niter", -1), ("train", "num_devices", 0),
    ("train", "steps_per_call", 0), ("train", "ema_decay", 1.0),
    ("infer", "stride_fraction", 0.0), ("infer", "window_batch", 0),
    ("infer", "mode", "tiled"), ("infer", "window_fold", "maybe"),
    ("infer", "eroded_boundary_radius", -1), ("infer", "dense_block", 0),
    ("infer", "dense_block_batch", -1), ("infer", "dense_halo", -2),
    ("train", "shard_tiles", True), ("sched", "ema", 1.0), ("sched", "temperature", 0.0),
    ("infer", "quant", "fp8"), ("infer", "quant_min_ch", 0),
    ("infer", "quant_calib_pct", 0.0), ("infer", "quant_calib_crops", 0),
    ("model", "pool_backward", "cuda"), ("model", "quant_conv", "triton"),
    ("data", "extra_bands", "dsm,lidar"),
]
# --quant int8 ones: feasible, no block selected, the dense-wired exit,
# and a narrow net.
INT8_CONFIGS = [
    {}, {"quant_min_ch": 1000}, {"quant_exit": True, "net": "dilated_icpr_rate6_densely"},
    {"width": 0.25}, {"net": "dilated_icpr_rate6_densely"}, {"quant_exit": True},
]


def _validate_message(cfg):
    try:
        cfg.validate()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("change", BAD_CONFIGS, ids=lambda c: "valid" if c is None
                         else f"{c[0]}.{c[1]}={c[2]}")
def test_validate_messages_match(change):
    cfg = ref_config.Config()
    if change is not None:
        section, field, value = change
        cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(
            getattr(cfg, section), **{field: value})})
    want = _validate_message(cfg)
    assert (want is None) == (change is None)
    assert _validate_message(_as(port_config, cfg)) == want


@pytest.mark.parametrize("case", INT8_CONFIGS, ids=lambda c: "_".join(
    f"{k}={v}" for k, v in c.items()) or "default")
def test_validate_int8_messages_match(case):
    """The feasibility check under --quant int8 runs each package's own
    quant_plan (the port's imports no JAX)."""
    cfg = ref_config.Config(
        model=ref_config.ModelConfig(net_type=case.get("net", "dilated_icpr_rate6"),
                                     width_multiplier=case.get("width", 1.0)),
        infer=ref_config.InferConfig(quant="int8", quant_min_ch=case.get("quant_min_ch", 128),
                                     quant_exit=case.get("quant_exit", False)))
    assert _validate_message(_as(port_config, cfg)) == _validate_message(cfg)


# --------------------------------------------------------------------- #
# tiles
# --------------------------------------------------------------------- #
def _raw_tiles(seed, bands=3, shapes=((37, 41), (29, 52), (8, 6))):
    rng = np.random.default_rng(seed)
    ims = [rng.integers(0, 256, (h, w, bands)).astype(np.float32) for h, w in shapes]
    mks = [rng.integers(0, 3, (h, w)).astype(np.int32) for h, w in shapes]
    for m in mks:
        m[: max(1, m.shape[0] // 5)] = 255
    return ims, mks


@pytest.mark.parametrize("multiple", [1, 16])
def test_pack_tiles_and_compute_stats_match(multiple):
    ims, mks = _raw_tiles(multiple)
    want = ref_tiles.pack_tiles(ims, mks, pad_to_multiple=multiple)
    got = port_tiles.pack_tiles(ims, mks, pad_to_multiple=multiple)
    _assert_tiles_equal(got, want)
    for a, b in zip(port_tiles.compute_stats(got), ref_tiles.compute_stats(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert port_tiles.storage_dtype(got.images) == ref_tiles.storage_dtype(want.images)
    assert port_tiles.IGNORE_LABEL == ref_tiles.IGNORE_LABEL


@pytest.mark.parametrize("pad", [0, 5, 9, 30])
@pytest.mark.parametrize("pad_masks", [True, False])
def test_mirror_pad_and_fill_padded_context_match(pad, pad_masks):
    ims, mks = _raw_tiles(pad + 1)
    ref_ts = ref_tiles.pack_tiles(ims, mks)
    ref_tiles.compute_stats(ref_ts)
    want = ref_tiles.mirror_pad(ref_ts, pad, pad_masks=pad_masks)
    got = port_tiles.mirror_pad(_as(port_tiles, ref_ts), pad, pad_masks=pad_masks)
    _assert_tiles_equal(got, want)
    if pad:
        _assert_tiles_equal(port_tiles.fill_padded_context(got, pad),
                            ref_tiles.fill_padded_context(want, pad))


# --------------------------------------------------------------------- #
# datasets and check_data
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kw", [
    dict(seed=0, num_tiles=2, size=40), dict(seed=3, num_tiles=3, size=33),
    dict(seed=1, num_tiles=2, size=32, num_classes=4, num_bands=5),
], ids=["default", "odd_size", "classes4_bands5"])
def test_load_synthetic_matches(kw):
    for got, want in zip(port_datasets.load_synthetic(**kw),
                         ref_datasets.load_synthetic(**kw)):
        _assert_tiles_equal(got, want)


@pytest.mark.parametrize("name", ["synthetic", "synthetic_multi", "synthetic_texture"])
@pytest.mark.parametrize("test_only", [False, True])
def test_load_dataset_synthetic_matches(name, test_only):
    kw = dict(seed=2, size=48, num_tiles=2, test_only=test_only)
    got = port_datasets.load_dataset(name, **kw)
    want = ref_datasets.load_dataset(name, **kw)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            _assert_tiles_equal(a, b)


def test_dataset_tables_match():
    assert port_datasets.NUM_CLASSES == ref_datasets.NUM_CLASSES
    assert port_datasets.PALETTES.keys() == ref_datasets.PALETTES.keys()
    for k, v in ref_datasets.PALETTES.items():
        assert np.array_equal(port_datasets.PALETTES[k], v), k


def test_unlabeled_rasters_match(tmp_path):
    rng = np.random.default_rng(4)
    for stem, (h, w) in (("b_scene", (30, 44)), ("a_scene", (21, 17))):
        np.save(tmp_path / f"{stem}.npy", rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    files = port_datasets.list_rasters(str(tmp_path))
    assert files == ref_datasets.list_rasters(str(tmp_path))
    assert port_datasets.raster_names(files) == ref_datasets.raster_names(files)
    (got, got_names), (want, want_names) = (
        mod.load_rasters(files, pad_to_multiple=16) for mod in (port_datasets, ref_datasets))
    assert got_names == want_names
    _assert_tiles_equal(got, want)


@pytest.mark.parametrize("case", [
    ("synthetic", {"size": 40}, 3, 25), ("synthetic_multi", {"size": 32}, 3, 0),
    ("synthetic", {"size": 24}, 0, 65), ("vaihingen", None, 0, 0), ("coffee", None, 0, 0),
    ("potsdam", None, 0, 0), ("grss_dfc_2014", None, 0, 0),
], ids=lambda c: c[0] + ("" if c[1] is None else f"_{c[1]['size']}_{c[2]}_{c[3]}"))
def test_check_data_report_matches(case, tmp_path):
    """The same report and the same log lines; the real datasets' dumps
    are absent here, so those report their FAIL the same way."""
    dataset, kwargs, bands, max_scale = case
    path = "" if kwargs is not None else str(tmp_path / "missing")
    out = []
    for mod in (ref_check, port_check):
        lines = []
        report = mod.check_data(dataset, path, loader_kwargs=kwargs, expected_bands=bands,
                                max_scale=max_scale, log=lines.append)
        out.append((json.dumps(report, sort_keys=True, default=str), lines))
    assert out[1] == out[0]


# --------------------------------------------------------------------- #
# sampler and native tables
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def padded_pair():
    train, _ = ref_datasets.load_synthetic(seed=5, num_tiles=3, size=48, num_classes=3)
    want = ref_tiles.mirror_pad(train, 13)
    got = port_tiles.mirror_pad(_as(port_tiles, train), 13)
    return got, want


def test_native_library_matches(padded_pair):
    got, want = padded_pair
    assert port_native.available() == ref_native.available()
    if not ref_native.available():
        pytest.skip("no C++ compiler: both packages take the numpy path")
    a = port_native.build_position_tables(got.masks, 3)
    b = ref_native.build_position_tables(want.masks, 3)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    port_native.shuffle_table(a[0], 7)
    ref_native.shuffle_table(b[0], 7)
    assert np.array_equal(a[0], b[0])


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("balanced,cap", [(True, 0), (False, 0), (True, 50)],
                         ids=["balanced", "uniform", "capped"])
def test_sampler_positions_match(padded_pair, use_native, balanced, cap):
    got_t, want_t = padded_pair
    kw = dict(num_classes=3, pad=13, seed=11, balanced=balanced, use_native=use_native,
              max_positions_per_class=cap)
    got = port_sampler.BalancedPatchSampler(got_t, **kw)
    want = ref_sampler.BalancedPatchSampler(want_t, **kw)
    for step in range(6):
        if step == 3:
            got.reseed(40)
            want.reseed(40)
        assert np.array_equal(got.sample(37), want.sample(37))
        assert np.array_equal(got.sample_augment_ids(9, True),
                              want.sample_augment_ids(9, True))


# --------------------------------------------------------------------- #
# scheduler
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dist", ["single_fixed", "multi_fixed", "multinomial",
                                  "uniform", "multinomial_stratified"])
@pytest.mark.parametrize("update", ["acc", "loss"])
def test_scale_scheduler_matches(dist, update):
    cfg = ref_config.SchedulerConfig(distribution_type=dist, update_type=update,
                                     values=(25, 35, 45, 55, 65), temperature=0.7)
    want = ref_scheduler.ScaleScheduler(cfg, seed=3)
    got = port_scheduler.ScaleScheduler(_as(port_config, cfg), seed=3)
    rng = np.random.default_rng(8)
    for i in range(40):
        s = got.select()
        assert s == want.select(), i
        loss, acc = float(rng.uniform(0.1, 2.0)), float(rng.uniform(0.3, 1.0))
        got.update(s, loss, acc)
        want.update(s, loss, acc)
    assert json.dumps(got.state_dict()) == json.dumps(want.state_dict())
    assert np.array_equal(got.probabilities(), want.probabilities())
    assert got.summary() == want.summary() and got.best_scales(2) == want.best_scales(2)
    # A scheduler restored from the reference's state continues the same.
    resumed = port_scheduler.ScaleScheduler(_as(port_config, cfg), seed=9)
    resumed.load_state_dict(json.loads(json.dumps(want.state_dict())))
    assert [resumed.select() for _ in range(10)] == [want.select() for _ in range(10)]


# --------------------------------------------------------------------- #
# viz and logging
# --------------------------------------------------------------------- #
def test_prediction_and_error_maps_match(tmp_path):
    rng = np.random.default_rng(6)
    preds = [rng.integers(0, 7, (20, 30)), rng.integers(0, 2, (9, 5))]
    masks = [rng.integers(0, 7, (22, 31)), np.full((9, 5), 255)]
    for mod, name in ((ref_viz, "ref"), (port_viz, "port")):
        out = str(tmp_path / name)
        mod.save_prediction_maps(preds, "vaihingen", out, names=("a", "b"))
        mod.save_error_maps(preds, masks, out)
    files = sorted(os.listdir(tmp_path / "ref"))
    assert files == sorted(os.listdir(tmp_path / "port")) and len(files) == 4
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "ref" / f).read_bytes(), f


def test_metric_logger_matches(tmp_path):
    records = []
    for mod, name in ((ref_logging, "ref"), (port_logging, "port")):
        echoed = []
        logger = mod.MetricLogger(str(tmp_path / name), echo=echoed.append)
        logger.log("step 1", loss=np.float32(0.5), it=np.int64(3), ts=1.0, tag=object)
        logger("plain line")
        logger.close()
        lines = (tmp_path / name / "metrics.jsonl").read_text().splitlines()
        records.append((echoed, [json.loads(m) | {"ts": 0} for m in lines]))
    assert records[1] == records[0]
