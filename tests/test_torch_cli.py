"""The port's command line (dynseg_torch.cli) against dynseg.cli: the
parser, the config and the helpers copied from the reference held equal
to their originals; the --resume guards; train -> testing, resume after a
SIGTERM, predict and info on small nets on the CPU; the refusal of a
missing card and of parts not ported; and a dynseg checkpoint imported
with import_reference_state, scored by both packages."""

import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import dynseg.cli as jax_cli
import dynseg.config as jax_config
from dynseg.config import SchedulerConfig
from dynseg.sched.scheduler import ScaleScheduler
from dynseg_torch import checkpoint, cli, train
from dynseg_torch import config as port_config
from dynseg_torch.data.datasets import load_synthetic
from dynseg_torch.infer import Inferencer
from dynseg_torch.sched import scheduler as port_scheduler

DATA = ["--dataset", "synthetic", "--dataset_kwargs", '{"size": 48}',
        "--values", "9,13", "--window_batch", "64"]
TRAIN = ["--operation", "training", "--niter", "20", "--batch_size", "16",
         "--eval_every", "10", "--checkpoint_every", "10", "--ema_decay", "0.9",
         "--ema_recalib_batches", "4", "--pool_backward", "pallas",
         "--no_prediction_maps"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _train_cfg(out, extra=(), width=0.25):
    """config_from_args of a training argv, at a small width (the CLI
    has no width flag; testing adopts it from the sidecar)."""
    args = cli.build_argparser().parse_args(
        TRAIN + DATA + ["--output_path", str(out), "--device", "cpu", *extra])
    cfg = cli.config_from_args(args)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, width_multiplier=width))


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A tiny port training run: EMA with recalibration, keep_best,
    checkpoints at 10 and 20."""
    out = tmp_path_factory.mktemp("port_run")
    lines = []
    scores = cli.run_training(_train_cfg(out), log=lines.append, keep_best=True,
                              device="cpu")
    return out, scores, lines


def _copy(run_dir, tmp_path):
    dst = tmp_path / "run"
    shutil.copytree(run_dir, dst)
    return dst


# --------------------------------------------------------------------- #
# pieces copied from dynseg.cli
# --------------------------------------------------------------------- #
def _as(mod, cfg):
    """`cfg` rebuilt as the config dataclass of the same name in `mod`
    (dynseg.config or dynseg_torch.config), from the same field values."""
    vals = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return getattr(mod, type(cfg).__name__)(**{
        k: _as(mod, v) if dataclasses.is_dataclass(v) else v for k, v in vals.items()})


def _plain(obj):
    """A config of either package as its class name and field values, so
    that the two packages' configs compare."""
    if dataclasses.is_dataclass(obj):
        return type(obj).__name__, dataclasses.asdict(obj)
    return obj


def _actions(parser):
    return {tuple(a.option_strings): (a.dest, a.default, a.choices, a.type,
                                      a.required, a.nargs, a.const, type(a).__name__)
            for a in parser._actions if a.option_strings not in (["-h", "--help"], ["--version"])}


def test_parser_matches_reference():
    ref, port = jax_cli.build_argparser(), cli.build_argparser()
    want, got = _actions(ref), _actions(port)
    assert len(ref._actions) == 78  # 77 add_argument calls + --help
    assert got.pop(("--device",))[:2] == ("device", "cuda")
    assert got == want
    assert port.prog == "dynseg_torch"


# The argvs of tests/test_cli.py, and the int8 ones.
ARGVS = [
    ["--dataset", "vaihingen", "--dataset_path", "/data/v", "--net_type",
     "dilated_grsl_rate8", "--learning_rate", "0.02", "--weight_decay", "1e-3",
     "--batch_size", "64", "--niter", "1234", "--distribution_type", "uniform",
     "--values", "25,45,65", "--update_type", "loss", "--fold", "3"],
    ["--steps_per_call", "8", "--num_devices", "4", "--compute_dtype", "bfloat16",
     "--rescale_batch_by_area", "--inference_mode", "dense", "--dense_block", "512",
     "--dense_halo", "48", "--test_scales", "35,55", "--no_augment",
     "--no_balanced_sampling"],
    ["--scan_chunk", "16", "--dense_scan_chunk", "2", "--metric_fetch_depth", "4",
     "--shard_tiles", "--num_devices", "2", "--hbm_budget_gb", "2.5"],
    ["--sched_temperature", "0.25", "--sched_ema", "0.8", "--pool_backward", "pallas"],
    ["--sched_favor", "low", "--leaky_slope", "0.2", "--use_batch_norm", "false"],
    ["--dataset", "synthetic_texture", "--dataset_kwargs",
     '{"class_probs": [0.02, 0.08, 0.55, 0.35], "size": 128}'],
    ["--ema_decay", "0.999", "--ema_recalib_batches", "0", "--use_ema"],
    ["--test_scales", "35,55", "--lr_decay_rate", "0.5", "--lr_decay_steps", "7"],
    ["--quant", "int8", "--quant_exit", "--quant_min_ch", "64"],
    ["--quant", "int8", "--net_type", "dilated_icpr_rate6_densely"],
    [],
]
BAD = [
    ["--batch_size", "0"], ["--values", "25,-3"], ["--steps_per_call", "0"],
    ["--stride_fraction", "0"], ["--window_batch", "0"], ["--num_devices", "0"],
    ["--eval_eroded_boundaries", "-1"], ["--sched_ema", "1.5"],
    ["--sched_temperature", "0"], ["--extra_bands", "dsm,nsdm"], ["--shard_tiles"],
    ["--values", "25,35,35"], ["--ema_decay", "1.0"],
    ["--quant", "int8", "--quant_min_ch", "1000"],
    ["--quant", "int8", "--quant_exit", "--net_type", "dilated_icpr_rate6_densely"],
]


@pytest.mark.parametrize("op", ["training", "export", "testing"])
def test_config_from_args_matches_reference(op):
    for argv in ARGVS:
        args = jax_cli.build_argparser().parse_args(["--operation", op] + argv)
        assert cli._default_compute_dtype(args) == jax_cli._default_compute_dtype(args)
        assert _plain(cli.config_from_args(args)) == _plain(jax_cli.config_from_args(args)), argv


@pytest.mark.parametrize("argv", BAD, ids=lambda a: "_".join(a).strip("-"))
def test_config_errors_match_reference(argv):
    args = jax_cli.build_argparser().parse_args(["--operation", "training"] + argv)
    with pytest.raises(ValueError) as want:
        jax_cli.config_from_args(args)
    with pytest.raises(ValueError) as got:
        cli.config_from_args(args)
    assert str(got.value) == str(want.value)


def _scheduler(values, ckpt_values, sched=(SchedulerConfig, ScaleScheduler), **ckpt_kw):
    config_cls, scheduler_cls = sched
    donor = scheduler_cls(config_cls(values=tuple(ckpt_values), **ckpt_kw), seed=0)
    for v in ckpt_values:
        donor.update(v, loss=1.0, acc=0.5)
    sch = scheduler_cls(config_cls(values=tuple(values)), seed=0)
    sch.load_state_dict(donor.state_dict())
    return sch


def test_helpers_match_reference():
    def both(fn_name, jax_args, port_args):
        """The reference's helper on dynseg's configs and schedulers, the
        port's on its own, built from the same values."""
        outs = []
        for mod, args in ((jax_cli, jax_args), (cli, port_args)):
            msgs = []
            try:
                res = _plain(getattr(mod, fn_name)(*args, log=msgs.append))
            except ValueError as e:
                res = f"ValueError: {e}"
            outs.append((res, msgs))
        assert outs[0] == outs[1], fn_name
        return outs[1]

    assert cli.parse_values("25,35, 45") == jax_cli.parse_values("25,35, 45") == [25, 35, 45]
    assert cli.parse_values([9, 13]) == [9, 13]
    with pytest.raises(ValueError, match="comma-separated"):
        cli.parse_values("abc")
    cfg = cli.config_from_args(cli.build_argparser().parse_args(["--operation", "testing"]))
    stats = {"num_input_bands": 4, "num_classes": 6, "net_type": "dilated_grsl",
             "width_multiplier": 0.5, "leaky_slope": 0.2, "dropout_rate": 0.1,
             "bn_momentum": 0.99, "pool_window": 5, "use_batch_norm": False,
             "ema_decay": 0.9, "lr_decay_rate": 0.5, "lr_decay_steps": 3}
    for adopt in (False, True):
        for st in (stats, {"num_input_bands": 3, "num_classes": 2}):
            try:
                want = jax_cli._adopt_checkpoint_model(_as(jax_config, cfg), st,
                                                       adopt_net_type=adopt)
            except ValueError as e:
                with pytest.raises(ValueError, match="net_type") as got:
                    cli._adopt_checkpoint_model(cfg, st, adopt_net_type=adopt)
                assert str(got.value) == str(e)
                continue
            got = cli._adopt_checkpoint_model(cfg, st, adopt_net_type=adopt)
            assert type(got) is port_config.Config and _plain(got) == _plain(want)
    explicit = dataclasses.replace(cfg, infer=dataclasses.replace(
        cfg.infer, scales=(25, 45), scales_explicit=True))
    port_sched = (port_config.SchedulerConfig, port_scheduler.ScaleScheduler)
    for c, ckpt, kw in ((cfg, [9, 13], {}), (explicit, [9, 13], {}),
                        (cfg, cfg.sched.values, {"update_type": "loss"})):
        both("_reconcile_scales",
             (_as(jax_config, c), _scheduler(c.sched.values, ckpt, **kw)),
             (c, _scheduler(c.sched.values, ckpt, port_sched, **kw)))
    for st in ({"val_tiles": "11,15", "bands": "rgbir", "extra_bands": ""},
               {"dataset": "potsdam", "fold": 1}, {}):
        both("_warn_protocol_mismatch", (_as(jax_config, cfg), st), (cfg, st))


# --------------------------------------------------------------------- #
# training, testing, resume, predict, info on the CPU
# --------------------------------------------------------------------- #
def test_train_then_testing_is_bitwise(port_run, capsys):
    """testing restores iteration 20 with the EMA weights and their
    recalibrated statistics, and gives the training run's own scores and
    label maps, bitwise; --window_fold off is accepted and changes
    nothing."""
    out, trained, lines = port_run
    assert any(line.startswith("[val @ iter 20]") for line in lines)
    assert any("new best meanF1" in line for line in lines)
    args = cli.build_argparser().parse_args(
        ["--operation", "testing", "--no_prediction_maps", "--output_path", str(out),
         *DATA])
    tlines = []
    got = cli.run_testing(cli.config_from_args(args), log=tlines.append, device="cpu")
    assert "restored checkpoint at iteration 20" in tlines
    assert any("using recalibrated BatchNorm statistics" in m for m in tlines)
    for k in ("oa", "kappa", "mean_f1"):
        assert got[k] == trained[k]
    assert np.array_equal(got["f1"], trained["f1"])
    for a, b in zip(got["predictions"], trained["predictions"]):
        assert np.array_equal(a, b)
    assert trained["oa"] > 0.9
    total = [m for m in lines if m.startswith("TOTAL:")]

    capsys.readouterr()
    assert cli.main(["--operation", "testing", "--device", "cpu", "--window_fold", "off",
                     "--no_prediction_maps", "--output_path", str(out), *DATA]) == 0
    printed = capsys.readouterr().out.splitlines()
    assert any(m.startswith("--window_fold off") for m in printed)
    assert [m for m in printed if m.startswith("TOTAL:")] == total
    saved = json.loads((out / "scores.json").read_text())
    assert saved["oa"] == trained["oa"] and saved["inference"]["scales"] == [9, 13]


def test_testing_use_best_and_top_k(port_run):
    out, _, _ = port_run
    args = cli.build_argparser().parse_args(
        ["--operation", "testing", "--no_prediction_maps", "--output_path", str(out),
         *DATA])
    lines = []
    cli.run_testing(cli.config_from_args(args), log=lines.append, device="cpu",
                    use_best=True, scales_from_scheduler=1)
    best = checkpoint.CheckpointManager(str(out)).best_record()
    assert f"restored best checkpoint at iteration {best['step']}" in lines
    assert any(m.startswith("--use_best: serving the RAW") for m in lines)
    assert any(m.startswith("scheduler-selected inference scales: [") for m in lines)
    lines = []
    raw = cli.run_testing(cli.config_from_args(args), log=lines.append, device="cpu",
                          use_ema=False)
    assert not any("EMA" in m for m in lines) and 0.0 <= raw["oa"] <= 1.0
    with pytest.raises(ValueError, match="no EMA"):
        cli._serving_variables(cli.config_from_args(args), train.TrainState(None, None),
                               None, True)


# (extra flags on --resume, the reference's error)
GUARDS = [
    (["--net_type", "dilated_grsl"], "net_type="),
    (["--ema_decay", "0"], "ema_decay="),
    (["--lr_decay_rate", "0.5"], "lr_decay_rate="),
    (["--values", "9,17"], "--values"),
    (["--update_type", "loss"], "scheduler semantics"),
]


@pytest.mark.parametrize("extra,match", GUARDS, ids=[g[1].strip("-=") for g in GUARDS])
def test_resume_guards_refuse_before_the_sidecar_changes(port_run, tmp_path, extra, match):
    run = _copy(port_run[0], tmp_path)
    stats = (run / "checkpoints" / "stats.json").read_bytes()
    cfg = _train_cfg(run, ["--resume", "--niter", "30", *extra])
    with pytest.raises(ValueError, match=match):
        cli.run_training(cfg, log=lambda *_: None, device="cpu")
    assert (run / "checkpoints" / "stats.json").read_bytes() == stats
    assert checkpoint.CheckpointManager(str(run)).all_steps() == [10, 20]


def test_resume_after_sigterm(tmp_path, monkeypatch):
    """SIGTERM during the run (raised at the first validation, iteration
    4): the run checkpoints iteration 4 and returns; --resume continues
    from it to the end."""
    cfg = _train_cfg(tmp_path, ["--niter", "10", "--eval_every", "4",
                                "--checkpoint_every", "1000", "--ema_decay", "0"])
    evals = train.Trainer.eval_crops

    def stop(self, *args, **kw):
        signal.raise_signal(signal.SIGTERM)
        return evals(self, *args, **kw)

    monkeypatch.setattr(train.Trainer, "eval_crops", stop)
    lines = []
    assert cli.run_training(cfg, log=lines.append, device="cpu") == {
        "preempted": True, "iteration": 4}
    assert any(m.startswith("signal 15 received: checkpointed at iteration 4") for m in lines)
    assert checkpoint.CheckpointManager(str(tmp_path)).all_steps() == [4]
    monkeypatch.undo()
    lines = []
    rcfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, resume=True))
    scores = cli.run_training(rcfg, log=lines.append, device="cpu")
    assert "resumed from iteration 4" in lines
    assert not any("cleared checkpoints" in m for m in lines)
    assert checkpoint.CheckpointManager(str(tmp_path)).all_steps() == [4, 10]
    assert sum(s["steps"] for s in scores["train_steps"].values()) == 6
    assert 0.0 <= scores["oa"] <= 1.0


def test_predict_and_info(port_run, tmp_path, capsys):
    run = _copy(port_run[0], tmp_path)
    rasters = tmp_path / "rasters"
    rasters.mkdir()
    rng = np.random.default_rng(0)
    for name, (h, w) in (("a", (40, 52)), ("b", (33, 47))):
        np.save(rasters / f"{name}.npy", rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    assert cli.main(["--operation", "predict", "--device", "cpu", "--predict_path",
                     str(rasters), "--predict_chunk", "1", "--output_path", str(run),
                     *DATA]) == 0
    printed = capsys.readouterr().out
    assert "restored checkpoint at iteration 20" in printed
    for name, (h, w) in (("a", (40, 52)), ("b", (33, 47))):
        maps = [f for f in os.listdir(run) if f.endswith(".png") and name in f]
        assert len(maps) == 1, os.listdir(run)
        assert Image.open(run / maps[0]).size == (w, h)
    paths = cli.run_predict(cli.config_from_args(cli.build_argparser().parse_args(
        ["--operation", "predict", "--output_path", str(run), *DATA])),
        str(rasters), log=lambda *_: None, device="cpu")
    assert len(paths) == 2

    # info reads the checkpoint on the host: no --device needed.
    assert cli.main(["--operation", "info", "--output_path", str(run),
                     "--profile_dir", str(tmp_path / "prof"), *DATA]) == 0
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    info = cli.run_info(cli.config_from_args(cli.build_argparser().parse_args(
        ["--operation", "info", "--output_path", str(run)])), log=lambda *_: None)
    assert info["iteration"] == 20 and info["checkpoints"] == [10, 20]
    assert info["ema_decay"] == 0.9 and info["best"]["step"] in (10, 20)
    assert info["parameters"] == sum(
        p.numel() for p in train.init_state_template(
            cli._adopt_checkpoint_model(cli.config_from_args(
                cli.build_argparser().parse_args(["--operation", "info"])),
                checkpoint.CheckpointManager(str(run)).load_stats()),
            "cpu").model.parameters())


# --------------------------------------------------------------------- #
# no silent CPU fallback; parts not ported
# --------------------------------------------------------------------- #
def test_no_silent_cpu_fallback(tmp_path, monkeypatch):
    """The device is an explicit argument: Trainer without one raises
    (it used to train on the CPU where no card was visible), and "cuda"
    without a card raises instead of falling back."""
    cfg = _train_cfg(tmp_path)
    tiles = load_synthetic(seed=0, num_tiles=2, size=32)
    with pytest.raises(TypeError):
        train.Trainer(cfg, tiles[0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        train.Trainer(cfg, tiles[0], "cuda")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Inferencer(cfg, tiles[1], "cuda")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.run_training(cfg, log=lambda *_: None, device="cuda")
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(["--operation", "training", "--output_path", str(tmp_path), *DATA])
    assert not (tmp_path / "checkpoints").exists()


def test_command_line_without_a_card_exits_non_zero(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-m", "dynseg_torch", "--operation", "testing",
                          "--output_path", str(tmp_path)],
                         capture_output=True, text=True, env=env, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert res.returncode != 0
    assert "no CUDA card is visible" in res.stderr and "--device cpu" in res.stderr
    assert "TOTAL" not in res.stdout


@pytest.mark.parametrize("extra", [
    ["--operation", "training", "--num_devices", "2"],
    ["--operation", "training", "--num_devices", "2", "--shard_tiles"],
], ids=["num_devices", "shard_tiles"])
def test_parts_not_ported_are_refused(extra, tmp_path):
    with pytest.raises(SystemExit, match="not ported"):
        cli.main([*extra, "--device", "cpu", "--output_path", str(tmp_path)])


@pytest.mark.parametrize("extra", [
    ["--tta"], ["--compute_dtype", "bfloat16"],
    ["--tta", "--compute_dtype", "bfloat16", "--inference_mode", "dense",
     "--dense_block", "32", "--hbm_budget_gb", "0"],
], ids=["tta", "bfloat16", "dense_tta_bfloat16_streamed"])
def test_tta_and_bfloat16_testing_run_to_a_total_line(port_run, tmp_path, capsys, extra):
    """--operation testing with --tta and --compute_dtype bfloat16 (once
    together, in dense mode with the tiles streamed from the host):
    restored, scored, one TOTAL line; the trained net still scores."""
    out = _copy(port_run[0], tmp_path)
    capsys.readouterr()
    assert cli.main(["--operation", "testing", "--device", "cpu", "--no_prediction_maps",
                     "--output_path", str(out), *DATA, *extra]) == 0
    printed = capsys.readouterr().out.splitlines()
    assert "restored checkpoint at iteration 20" in printed
    totals = [m for m in printed if m.startswith("TOTAL: OA=")]
    assert len(totals) == 1
    saved = json.loads((out / "scores.json").read_text())
    assert saved["inference"]["tta"] == ("--tta" in extra)
    assert saved["oa"] > 0.9
    assert totals[0].startswith(f"TOTAL: OA={saved['oa']:.4f}")


# --------------------------------------------------------------------- #
# a dynseg checkpoint, imported
# --------------------------------------------------------------------- #
def import_from_dynseg(src: str, dst: str) -> str:
    """The JAX half of the import (README.md has it too): restore the
    orbax checkpoint with dynseg, hand its numpy trees to the port."""
    from dynseg.checkpoint import CheckpointManager
    from dynseg.config import Config
    from dynseg.train import ema_params, init_state_template

    mgr = CheckpointManager(src)
    stats = mgr.load_stats()
    cfg = jax_cli._adopt_checkpoint_model(Config(), stats, adopt_net_type=True)
    sched = ScaleScheduler(cfg.sched)
    state, step = mgr.restore_state(init_state_template(cfg), sched)
    ema = ema_params(cfg, state)

    def np_tree(t):
        return jax.tree.map(np.asarray, t)

    return checkpoint.import_reference_state(
        dst, {"params": np_tree(state.params), "batch_stats": np_tree(state.batch_stats)},
        np_tree(state.opt_state[1][0].trace), None if ema is None else np_tree(ema),
        int(step), sched.state_dict(), stats)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """dynseg trains a tiny model on the CPU: width 0.125, 8 iterations,
    EMA with recalibration."""
    out = tmp_path_factory.mktemp("jax_run")
    args = jax_cli.build_argparser().parse_args(
        ["--operation", "training", "--niter", "8", "--batch_size", "8",
         "--eval_every", "1000", "--checkpoint_every", "1000", "--ema_decay", "0.9",
         "--ema_recalib_batches", "2", "--no_prediction_maps", "--output_path", str(out),
         *DATA])
    cfg = jax_cli.config_from_args(args)
    jax_cli.run_training(dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, width_multiplier=0.125)),
        log=lambda *_: None)
    return out


def _schema(obj):
    if isinstance(obj, dict):
        return {k: _schema(v) for k, v in obj.items()}
    return type(obj).__name__


def test_sidecar_schema_matches_reference(jax_run, port_run):
    want = json.loads((jax_run / "checkpoints" / "stats.json").read_text())
    got = json.loads((port_run[0] / "checkpoints" / "stats.json").read_text())
    assert _schema(got) == _schema(want)
    assert got["ema_batch_stats"].keys() == want["ema_batch_stats"].keys()


def test_imported_reference_checkpoint_scores_like_reference(jax_run, tmp_path):
    """dynseg and dynseg_torch testing of the same trained weights (the
    port's imported with import_reference_state): the same OA, kappa and
    F1 and the same prediction maps. Bound: labels equal except at exact
    float ties of the two classes' summed probabilities, at most 1e-4 of
    the pixels (float32 sums in another order)."""
    port_dir = tmp_path / "port"
    with pytest.raises(ValueError, match="import_reference_state"):
        cli.main(["--operation", "testing", "--device", "cpu", "--output_path",
                  str(jax_run), *DATA])
    assert import_from_dynseg(str(jax_run), str(port_dir)) == str(port_dir / "checkpoints")
    assert cli.main(["--operation", "testing", "--device", "cpu", "--output_path",
                     str(port_dir), *DATA]) == 0
    jax_cli.run_testing(jax_cli.config_from_args(jax_cli.build_argparser().parse_args(
        ["--operation", "testing", "--output_path", str(jax_run), *DATA])), log=lambda *_: None)
    want = json.loads((jax_run / "scores.json").read_text())
    got = json.loads((port_dir / "scores.json").read_text())
    n_px = 0
    n_diff = 0
    maps = sorted(f for f in os.listdir(jax_run) if f.startswith("prediction_"))
    assert len(maps) == 2 and sorted(
        f for f in os.listdir(port_dir) if f.startswith("prediction_")) == maps
    for name in maps:
        a = np.asarray(Image.open(port_dir / name))
        b = np.asarray(Image.open(jax_run / name))
        assert a.shape == b.shape
        n_px += a.shape[0] * a.shape[1]
        n_diff += int(np.any(a != b, axis=-1).sum())
    assert n_diff <= 1e-4 * n_px
    for k in ("oa", "kappa", "mean_f1"):
        assert abs(got[k] - want[k]) <= 1e-4, k
    np.testing.assert_allclose(got["f1"], want["f1"], rtol=0, atol=1e-4)
    assert got["inference"] == {**want["inference"], "wall_s": got["inference"]["wall_s"]}
