"""The port's serving export (dynseg_torch.export) against dynseg.export:
the same seeded numpy weights (through bridge.flax_to_torch) exported by
both packages on the CPU, and the two artifacts fed the same raw pixels.
Float32 at three shapes, bfloat16 and int8 within their bounds, the
labels entry point at halo 40 and 0, the manifest's keys, the checksum,
and --operation export from a checkpoint."""

import dataclasses
import json
import os
import pickle
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynseg.config import (Config, DataConfig, InferConfig, ModelConfig,
                           SchedulerConfig, TrainConfig)
from dynseg.export import ExportedPredictor as JaxPredictor
from dynseg.export import export_predictor as jax_export
from dynseg.ops import quant as jax_quant
from dynseg_torch import config as port_config
from dynseg_torch.bridge import flax_to_torch, init_variables_np
from dynseg_torch.export import ARTIFACT, ExportedPredictor, export_predictor
from dynseg_torch.ops import pool, quant

# Statistics that bring uniform raw pixels to about unit variance, as a
# training set's do.
MEAN = np.array([120.0, 125.0, 130.0], np.float32)
STD = np.array([70.0, 72.0, 74.0], np.float32)
# tests/test_export.py's statistics: raw pixels at up to ~50 standard
# deviations, where bfloat16 rounding shows most.
REF_MEAN = np.array([10.0, 20.0, 30.0], np.float32)
REF_STD = np.array([5.0, 5.0, 5.0], np.float32)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _as(mod, cfg):
    """`cfg` rebuilt as the config dataclass of the same name in `mod`."""
    vals = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return getattr(mod, type(cfg).__name__)(**{
        k: _as(mod, v) if dataclasses.is_dataclass(v) else v for k, v in vals.items()})


def _cfg(net_type="dilated_grsl", width=0.125, classes=3, halo=40, **model_kw):
    """tests/test_export.py's tiny config (or a full-width one)."""
    return Config(
        model=ModelConfig(net_type=net_type, num_classes=classes, num_input_bands=3,
                          width_multiplier=width, **model_kw),
        sched=SchedulerConfig(distribution_type="multi_fixed", values=(9, 13)),
        train=TrainConfig(batch_size=4, seed=0),
        infer=InferConfig(dense_halo=halo),
        data=DataConfig(dataset="synthetic"),
    )


def _seeded(cfg, seed):
    """Numpy Flax variables with non-trivial BatchNorm statistics."""
    variables = init_variables_np(_as(port_config, cfg.model), num_input_bands=3,
                                  seed=seed)
    rng = np.random.default_rng(seed + 100)
    for block in variables.get("batch_stats", {}).values():
        bn = block["BatchNorm_0"]
        bn["mean"] = rng.normal(scale=0.2, size=bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    return variables


def _both(cfg, variables, tmp, quant_pair=(None, None), platforms=(), mean=MEAN,
          std=STD):
    """The JAX artifact and the port's, exported on the CPU from the same
    weights (the port's loaded and checked on `platforms`); returns the
    two loaded predictors."""
    jax_export(cfg, variables, mean, std, str(tmp / "jax"), platforms=("cpu",),
               quant_variables=quant_pair[0])
    export_predictor(_as(port_config, cfg), flax_to_torch(variables), mean, std,
                     str(tmp / "port"), platforms=platforms, quant_variables=quant_pair[1])
    return (JaxPredictor.load(str(tmp / "jax")),
            ExportedPredictor.load(str(tmp / "port"), device="cpu"))


@pytest.fixture(scope="module")
def float32(tmp_path_factory):
    """(the port's export directory, (reference, port) predictors)."""
    tmp = tmp_path_factory.mktemp("export_f32")
    cfg = _cfg()
    return str(tmp / "port"), _both(cfg, _seeded(cfg, 3), tmp, platforms=("cpu",))


@pytest.mark.parametrize("shape", [(2, 9, 9, 3), (1, 25, 25, 3), (3, 17, 13, 3)],
                         ids=["2x9x9", "1x25x25", "3x17x13"])
def test_float32_artifact_matches_reference_artifact(float32, shape):
    """One program for every (b, h, w), none of them the export example's
    (2, 18, 20): probabilities within 1e-5 of the JAX artifact's, for
    float32 and uint8 raw pixels."""
    _, (ref, port) = float32
    rng = np.random.default_rng(sum(shape))
    raw = rng.uniform(0, 255, size=shape).astype(np.float32)
    got = port.probs(raw)
    assert got.shape == shape[:3] + (3,) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref.probs(raw), rtol=1e-5, atol=1e-5)
    raw8 = raw.astype(np.uint8)
    np.testing.assert_allclose(port.probs(raw8), ref.probs(raw8), rtol=1e-5, atol=1e-5)
    labels, probs = port.predict(raw)
    assert labels.dtype == np.int32
    np.testing.assert_array_equal(labels, probs.argmax(-1))


def _jax_probs_rounding_every_op(cfg, variables, mean, std, raws, tmp):
    """The JAX bf16 artifact's probabilities on `raws` with XLA rounding
    to bfloat16 after every op, as PyTorch's ops do
    (--xla_allow_excess_precision=false; by default XLA keeps float32
    between the bf16 ops it fuses). In a fresh process, since XLA reads
    its flags once."""
    with open(tmp / "per_op.pkl", "wb") as f:
        pickle.dump((cfg, variables, mean, std, raws), f)
    code = "\n".join([
        "import pickle, sys",
        "import numpy as np",
        "from dynseg.export import ExportedPredictor, export_predictor",
        "d = sys.argv[1]",
        "with open(d + '/per_op.pkl', 'rb') as f:",
        "    cfg, v, mean, std, raws = pickle.load(f)",
        "export_predictor(cfg, v, mean, std, d + '/jax_per_op', platforms=('cpu',))",
        "p = ExportedPredictor.load(d + '/jax_per_op')",
        "np.savez(d + '/per_op.npz', *[p.probs(r) for r in raws])",
    ])
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=" ".join([os.environ.get("XLA_FLAGS", ""),
                                   "--xla_allow_excess_precision=false"]).strip(),
               PYTHONPATH=os.pathsep.join(filter(None, [REPO, os.environ.get("PYTHONPATH")])))
    subprocess.run([sys.executable, "-c", code, str(tmp)], check=True, env=env,
                   timeout=300, cwd=REPO)
    with np.load(tmp / "per_op.npz") as z:
        return [z[f"arr_{i}"] for i in range(len(raws))]


@pytest.mark.parametrize("stats", ["unit_variance", "reference"])
def test_bfloat16_artifact_matches_reference_artifact(tmp_path, stats):
    """compute_dtype bfloat16, the export's default.

    unit_variance (MEAN, STD: inputs at about unit variance, as a
    training set's statistics give): probabilities within 1e-2 of the JAX
    bf16 artifact's, labels equal except where the reference's top two
    are within that bound (the two frameworks' bf16 convs sum in other
    orders).

    reference (tests/test_export.py's statistics): here JAX's own bf16
    artifact is up to 0.034 from its float32 one, and the two
    frameworks round in different places (XLA keeps float32 between the
    bf16 ops it fuses; PyTorch rounds after each op), so no fixed bound
    on port vs JAX holds. Held instead: the port's float32 artifact
    within 1e-5 of JAX's (the same net), the port's bf16 artifact no
    further from JAX's float32 artifact than 1.25x JAX's bf16 artifact
    is when XLA rounds after every op, and labels equal to the JAX bf16
    artifact's except where the float32 artifact's top two are within
    twice that gap (a flip that either rounding can make: the JAX
    artifact rounding after every op flips the same pixel)."""
    mean, std = (MEAN, STD) if stats == "unit_variance" else (REF_MEAN, REF_STD)
    cfg = _cfg(compute_dtype="bfloat16")
    variables = _seeded(cfg, 4)
    ref, port = _both(cfg, variables, tmp_path, mean=mean, std=std)
    assert port.manifest["compute_dtype"] == "bfloat16"
    rng = np.random.default_rng(5)
    raws = [rng.uniform(0, 255, size=shape).astype(np.float32)
            for shape in [(2, 9, 9, 3), (1, 25, 31, 3)]]
    if stats == "unit_variance":
        for raw in raws:
            got, want = port.probs(raw), ref.probs(raw)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)
            differ = got.argmax(-1) != want.argmax(-1)
            top2 = np.sort(want, axis=-1)[..., -2:]
            assert np.all(top2[differ, 1] - top2[differ, 0] < 1e-2)
        return
    cfg32 = _cfg()
    ref32, port32 = _both(cfg32, variables, tmp_path / "f32", mean=mean, std=std)
    per_op = _jax_probs_rounding_every_op(cfg, variables, mean, std, raws, tmp_path)
    for raw, want_per_op in zip(raws, per_op):
        f32 = ref32.probs(raw)
        np.testing.assert_allclose(port32.probs(raw), f32, rtol=0, atol=1e-5)
        gap = float(np.abs(want_per_op - f32).max())
        got, want = port.probs(raw), ref.probs(raw)
        assert np.abs(got - f32).max() <= 1.25 * gap
        differ = got.argmax(-1) != want.argmax(-1)
        top2 = np.sort(f32, axis=-1)[..., -2:]
        assert np.all(top2[differ, 1] - top2[differ, 0] < 2 * gap)


@pytest.mark.parametrize("exit_int8", [False, True], ids=["float_exit", "int8_exit"])
def test_int8_artifact_matches_reference_artifact(tmp_path, exit_int8):
    """A full-width dilated_icpr_rate6 int8 artifact (blocks 3-5 through
    K5's op; the JAX side through its K5 route, interpret mode) on a
    21 x 24 raster, within the bound of
    tests/test_torch_quant.py::test_mixed_forward_matches_reference_k5_route
    (2e-2) and with equal labels; the program calls K5's op once per
    quantized block and K6's once per pool, and no ATen pool."""
    cfg = _cfg("dilated_icpr_rate6", width=1.0, classes=4, quant_conv="pallas")
    variables = _seeded(cfg, 0)
    x = np.random.default_rng(1).uniform(0, 255, size=(1, 21, 24, 3)).astype(np.float32)
    ranges = jax_quant.calibrate(cfg.model, variables, [jnp.asarray((x - MEAN) / STD)])
    qj = jax_quant.quantize_variables(cfg.model, variables, ranges, exit_int8=exit_int8)
    qp = quant.quantize_variables(_as(port_config, cfg.model), flax_to_torch(variables),
                                  ranges, exit_int8=exit_int8)
    ref, port = _both(cfg, variables, tmp_path, (qj, qp))
    m = port.manifest
    assert m["quant"] == "int8" and m["quant_exit"] == exit_int8
    assert m["quant_blocks"] == ref.manifest["quant_blocks"] == [
        "DilatedConvBlock_3", "DilatedConvBlock_4", "DilatedConvBlock_5"]
    assert m["custom_ops"] == ["dynseg_torch::int8_block_conv", "dynseg_torch::max_pool_s1"]
    got, want = port.probs(x), ref.probs(x)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    program = torch.export.load(str(tmp_path / "port" / ARTIFACT))
    targets = [str(getattr(n, "target", "")) for n in program.graph.nodes]
    assert sum("int8_block_conv" in t for t in targets) == 3
    assert sum("max_pool_s1" in t for t in targets) == 6
    assert not any("max_pool2d" in t for t in targets)


def _aten_pool(y, window, scale=None):
    """The int8 forward's pools before K6, on NCHW maps: quantize first,
    then int8 codes pooled in float32 by ATen and cast back."""
    if scale is not None:
        y = pool.quantize_act(y, scale)
    if y.dtype == torch.int8:
        return quant.pool_forward(y.float(), window).to(torch.int8)
    return quant.pool_forward(y, window)


def test_int8_artifacts_load_in_a_fresh_process(tmp_path, monkeypatch):
    """An int8 artifact exported now (K5 and K6 ops) and one as exported
    before K6 (ATen pools, a manifest listing K5 alone) each load in a
    fresh process, which registers the ops the manifest names, and give
    the probabilities they give here."""
    cfg = _cfg("dilated_icpr_rate6", width=1.0, classes=4)
    variables = _seeded(cfg, 2)
    sd = flax_to_torch(variables)
    x = np.random.default_rng(3).uniform(0, 255, size=(1, 13, 11, 3)).astype(np.float32)
    mcfg = _as(port_config, cfg.model)
    ranges = quant.calibrate(mcfg, sd, [torch.from_numpy((x - MEAN) / STD)])
    qsd = quant.quantize_variables(mcfg, sd, ranges)
    new, old = str(tmp_path / "new"), str(tmp_path / "old")
    export_predictor(_as(port_config, cfg), sd, MEAN, STD, new, quant_variables=qsd)
    monkeypatch.setattr(quant, "max_pool_fwd", _aten_pool)
    export_predictor(_as(port_config, cfg), sd, MEAN, STD, old, quant_variables=qsd)
    monkeypatch.undo()
    manifest = os.path.join(old, "manifest.json")
    with open(manifest) as f:
        meta = json.load(f)
    meta["custom_ops"] = ["dynseg_torch::int8_block_conv"]
    with open(manifest, "w") as f:
        json.dump(meta, f)
    programs = {d: torch.export.load(os.path.join(d, ARTIFACT)) for d in (new, old)}
    assert any("max_pool_s1" in str(n.target) for n in programs[new].graph.nodes)
    assert not any("max_pool_s1" in str(n.target) for n in programs[old].graph.nodes)
    np.save(tmp_path / "x.npy", x)
    code = "\n".join([
        "import sys, numpy as np",
        "from dynseg_torch.export import ExportedPredictor",
        "x = np.load(sys.argv[1])",
        "for d in sys.argv[2:]:",
        "    np.save(d + '.npy', ExportedPredictor.load(d, device='cpu').probs(x))",
    ])
    env = {**os.environ, "PYTHONPATH": REPO}
    subprocess.run([sys.executable, "-c", code, str(tmp_path / "x.npy"), new, old],
                   check=True, timeout=300, env=env, cwd=str(tmp_path))
    here = ExportedPredictor.load(new, device="cpu").probs(x)
    np.testing.assert_array_equal(np.load(new + ".npy"), here)
    np.testing.assert_array_equal(np.load(old + ".npy"), here)


@pytest.mark.parametrize("halo", [40, 0])
def test_dense_labels_is_argmax_of_probs(tmp_path, halo):
    """The labels entry point: the argmax of probs with the halo cropped,
    the full map at halo 0 (no [0:-0] empty slice), and a crop of one
    pixel on a side too; the JAX artifact's labels where it has them."""
    cfg = _cfg(halo=halo)
    ref, port = _both(cfg, _seeded(cfg, 7), tmp_path)
    assert port.manifest["dense_labels_halo"] == halo
    rng = np.random.default_rng(8)
    for shape in [(2, 2 * halo + 12, 2 * halo + 14, 3), (1, 2 * halo + 1, 2 * halo + 9, 3)]:
        x = rng.integers(0, 256, size=shape, dtype=np.uint8)
        labels = port.dense_labels_device(x).numpy()
        probs = port.probs(x)[:, halo:shape[1] - halo, halo:shape[2] - halo]
        assert labels.dtype == np.uint8
        assert labels.shape == (shape[0], shape[1] - 2 * halo, shape[2] - 2 * halo)
        np.testing.assert_array_equal(labels, probs.argmax(-1))
        np.testing.assert_array_equal(labels, np.asarray(ref.dense_labels_device(x)))


def test_manifest_keys_match_reference(float32):
    """The reference's keys and values, but for the listed differences:
    the format, torch_version for jax_version and .pt2 file names."""
    _, (ref, port) = float32
    want, got = dict(ref.manifest), dict(port.manifest)
    assert set(got) - {"torch_version"} == set(want) - {"jax_version"}
    assert got["format"] == "torch.export/pt2" and got["torch_version"] == torch.__version__
    assert got["artifact"] == ARTIFACT
    assert sorted(got["artifacts"]) == sorted(want["artifacts"])
    for art in got["artifacts"].values():
        assert art["file"].endswith(".pt2") and len(art["sha256"]) == 64
    assert got["sha256"] == got["artifacts"]["probs"]["sha256"]
    for key in ("format", "jax_version", "torch_version", "artifact", "artifacts",
                "sha256"):
        want.pop(key, None)
        got.pop(key, None)
    assert got == want


def test_tampered_file_is_refused(float32, tmp_path):
    """A flipped byte in any program file fails its checksum at load."""
    src, _ = float32
    for name in ("predictor.pt2", "dense_labels_u8.pt2"):
        bad = tmp_path / name.split(".")[0]
        shutil.copytree(src, bad)
        blob = bytearray((bad / name).read_bytes())
        blob[len(blob) // 2] ^= 0xFF
        (bad / name).write_bytes(bytes(blob))
        with pytest.raises(ValueError, match="checksum"):
            ExportedPredictor.load(str(bad), device="cpu")


def test_input_validation(float32):
    _, (_, port) = float32
    with pytest.raises(ValueError, match="expected"):
        port.probs(np.zeros((1, 9, 9, 5), np.float32))
    with pytest.raises(ValueError, match="expected"):
        port.probs(np.zeros((9, 9, 3), np.float32))


def test_load_refuses_a_missing_card(float32, monkeypatch):
    """device='cuda' (the default) where no card is visible is an error,
    not a quiet run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ExportedPredictor.load(float32[0])


def test_float_artifact_loads_with_torch_alone(float32):
    """The float programs run in a process that imports torch and nothing
    of dynseg_torch."""
    code = "\n".join([
        "import sys, torch",
        f"p = torch.export.load({os.path.join(float32[0], ARTIFACT)!r}).module()",
        "y = p(torch.full((2, 11, 13, 3), 50.0))",
        "assert y.shape == (2, 11, 13, 3)",
        "assert torch.allclose(y.sum(-1), torch.ones(()))",
        "assert not [m for m in sys.modules if m.startswith('dynseg')]",
    ])
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd="/")


def test_cli_export_from_checkpoint(tmp_path):
    """--operation export --device cpu from a small port training run: the
    artifact reproduces the restored net's probabilities, names the
    checkpoint's step, dataset and trained scales (not a stale CLI
    --values), and --quant int8 exports an int8 artifact."""
    from dynseg_torch import cli
    from dynseg_torch.checkpoint import CheckpointManager
    from dynseg_torch.models.dilated import build_model
    from dynseg_torch.sched.scheduler import ScaleScheduler
    from dynseg_torch.train import init_state_template

    data = ["--dataset", "synthetic", "--dataset_kwargs", '{"size": 48}',
            "--window_batch", "32", "--device", "cpu", "--output_path", str(tmp_path)]
    args = cli.build_argparser().parse_args(
        ["--operation", "training", "--niter", "6", "--batch_size", "8", "--values", "9",
         "--distribution_type", "single_fixed", "--eval_every", "0",
         "--no_prediction_maps"] + data)
    cfg = cli.config_from_args(args)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, width_multiplier=0.125))
    cli.run_training(cfg, log=lambda *_: None, device="cpu")
    # A stale --values (the defaults, 25..65) must not reach the manifest.
    assert cli.main(["--operation", "export", "--export_platforms", "cpu"] + data) == 0
    out = str(tmp_path / "export")
    pred = ExportedPredictor.load(out, device="cpu")
    m = pred.manifest
    assert m["checkpoint_step"] == 6 and m["dataset"] == "synthetic"
    assert m["compute_dtype"] == "bfloat16" and m["platforms"] == ["cpu"]
    assert m["train_scales"] == [9] and m["inference"]["window_scales"] == [9]
    assert m["scheduler_best_scales"] == [9]

    ckpt = CheckpointManager(str(tmp_path))
    stats = ckpt.load_stats()
    tcfg = cli._adopt_checkpoint_model(cfg, stats)
    tcfg = dataclasses.replace(tcfg, model=dataclasses.replace(
        tcfg.model, compute_dtype="bfloat16"))
    state, _ = ckpt.restore_state(init_state_template(tcfg, "cpu"),
                                  ScaleScheduler(tcfg.sched, seed=0))
    net = build_model(tcfg.model)
    net.load_state_dict(cli._serving_variables(tcfg, state, stats, None, lambda *_: None))
    raw = np.random.default_rng(1).uniform(0, 255, (2, 15, 15, 3)).astype(np.float32)
    x = (torch.from_numpy(raw) - torch.tensor(stats["mean"])) / torch.tensor(stats["std"])
    with torch.inference_mode():
        want = torch.softmax(net(x.float()).float(), -1).numpy()
    np.testing.assert_allclose(pred.probs(raw), want, rtol=0, atol=1e-5)

    assert cli.main(["--operation", "export", "--quant", "int8", "--quant_min_ch", "16",
                     "--export_platforms", "tpu,cpu"] + data) == 0
    m8 = ExportedPredictor.load(out, device="cpu").manifest
    assert m8["quant"] == "int8" and m8["compute_dtype"] == "float32"
    assert m8["quant_blocks"] and m8["platforms"] == ["cpu"]


def test_dense_int8_artifact_calls_the_quantize_op(tmp_path):
    """A dense-wired int8 artifact (width 0.125, blocks 2-5 int8 at
    min_ch 16): its program calls K7's op once per int8 block and K6's
    slot store once per block (every block pools into its slot of the
    feature buffer, none through the op that returns a map), the
    manifest lists both beside K5's, and the artifact gives the live int8
    forward's probabilities."""
    cfg = _cfg("dilated_icpr_rate6_densely", classes=4)
    mcfg = _as(port_config, cfg.model)
    sd = flax_to_torch(_seeded(cfg, 4))
    x = np.random.default_rng(5).uniform(0, 255, size=(1, 13, 11, 3)).astype(np.float32)
    xn = torch.from_numpy((x - MEAN) / STD)
    qsd = quant.quantize_variables(mcfg, sd, quant.calibrate(mcfg, sd, [xn]), min_ch=16)
    export_predictor(_as(port_config, cfg), sd, MEAN, STD, str(tmp_path), platforms=(),
                     quant_variables=qsd)
    port = ExportedPredictor.load(str(tmp_path), device="cpu")
    assert port.manifest["custom_ops"] == ["dynseg_torch::int8_block_conv",
                                           "dynseg_torch::max_pool_s1_into",
                                           "dynseg_torch::quantize_s8"]
    program = torch.export.load(str(tmp_path / ARTIFACT))
    targets = [str(getattr(n, "target", "")) for n in program.graph.nodes]
    assert sum("quantize_s8" in t for t in targets) == 4
    assert sum("max_pool_s1_into" in t for t in targets) == 6
    assert not any("max_pool_s1." in t for t in targets)
    with torch.inference_mode():
        want = torch.softmax(quant.make_apply(mcfg)(qsd, xn), -1).numpy()
    np.testing.assert_allclose(port.probs(x), want, rtol=0, atol=1e-6)
