"""The port's fold-protocol runner (dynseg_torch/run_folds.py) against the
reference's (scripts/run_folds.py, loaded by path): the same summary file
from the same per-fold results, the same refusals, the same partial-run
behaviour; then a tiny real run on the CPU twice, byte-identical."""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import dynseg.cli as jax_cli
from dynseg_torch import cli, run_folds

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location(
        "reference_run_folds", os.path.join(ROOT, "scripts", "run_folds.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _results(n):
    rng = np.random.default_rng(n)
    return [{"fold": i, "oa": float(rng.uniform(0.8, 1)),
             "kappa": float(rng.uniform(0.6, 1)), "mean_f1": float(rng.uniform(0.7, 1)),
             "f1": [float(x) for x in rng.uniform(0.5, 1, 3)]} for i in range(n)]


@pytest.mark.parametrize("done,folds", [(5, 5), (2, 5), (0, 3), (1, 1)])
def test_summary_equals_reference(ref, tmp_path, capsys, done, folds):
    """_write_summary of both runners on the same results, complete and
    partial (no fold done included): the same bytes, the same output."""
    out = {}
    for name, fn in (("ref", ref._write_summary), ("port", run_folds._write_summary)):
        d = tmp_path / name
        d.mkdir()
        fn(str(d), _results(done), folds)
        printed = capsys.readouterr().out.replace(str(d), "<dir>")
        out[name] = ((d / "folds_summary.json").read_bytes(), printed)
    assert out["port"] == out["ref"]
    summary = json.loads(out["port"][0])
    assert summary["complete"] == (done == folds) and ("oa_mean" in summary) == (done > 0)


@pytest.mark.parametrize("argv", [
    ["--output_path", "OUT", "--fold", "1"],
    ["--output_path", "OUT", "--fold=2"],
    ["--output_path", "OUT", "--folds", "0"],
    ["--out", "OUT"],
    ["--output_path", "OUT", "--folds", "-1", "--fold", "1"],
], ids=["fold", "fold_eq", "folds_0", "no_abbrev", "folds_neg"])
def test_refusals_equal_reference(ref, tmp_path, capsys, argv):
    """A pass-through --fold is refused, --folds below 1 is refused, and
    no flag is abbreviated (--out is not --output_path): both runners
    exit 2 with the same message, before any fold runs."""
    argv = [str(tmp_path) if a == "OUT" else a for a in argv]
    errs = []
    for main in (ref.main, run_folds.main):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 2
        errs.append(capsys.readouterr().err)
    assert errs[0] == errs[1] and "error:" in errs[0]
    assert not os.listdir(tmp_path)


def _fake_training(raise_at=None, preempt_at=None):
    """A stand-in for run_training: scores made from the fold number, an
    error or a preemption at the given fold."""
    def run_training(cfg, log=print, **kw):
        fold = cfg.data.fold
        log(f"fake training of fold {fold}")
        if fold == raise_at:
            raise RuntimeError(f"fold {fold} failed")
        if fold == preempt_at:
            return {"preempted": True, "iteration": 7}
        r = _results(fold + 1)[fold]
        return {**r, "f1": np.array(r["f1"]), "infer_wall_s": 1.0}
    return run_training


def _run_both(ref, tmp_path, monkeypatch, capsys, folds, **fake):
    """Both runners over `folds` folds with the fake training: their
    return codes (or the error raised), summaries and standard error."""
    monkeypatch.setattr(jax_cli, "enable_compilation_cache", lambda *a, **k: None)
    monkeypatch.setattr(jax_cli, "run_training", _fake_training(**fake))
    monkeypatch.setattr(cli, "run_training", _fake_training(**fake))
    out = {}
    for name, main, extra in (("ref", ref.main, []),
                              ("port", run_folds.main, ["--device", "cpu"])):
        d = tmp_path / name
        try:
            rc = main(["--folds", str(folds), "--output_path", str(d),
                       "--dataset", "synthetic"] + extra)
        except RuntimeError as e:
            rc = str(e)
        path = d / "folds_summary.json"
        err = capsys.readouterr().err
        out[name] = (rc, path.read_bytes() if path.exists() else None, err,
                     sorted(os.listdir(d)) if d.exists() else [])
    return out


def test_complete_run_equals_reference(ref, tmp_path, monkeypatch, capsys):
    out = _run_both(ref, tmp_path, monkeypatch, capsys, 3)
    assert out["port"][:2] == out["ref"][:2] and out["port"][0] == 0
    assert out["port"][3] == ["fold0", "fold1", "fold2", "folds_summary.json"]
    assert json.loads(out["port"][1])["complete"] is True


def test_failing_fold_leaves_partial_summary(ref, tmp_path, monkeypatch, capsys):
    """A fold that raises: the completed folds' summary is written and the
    error re-raised, in both runners."""
    out = _run_both(ref, tmp_path, monkeypatch, capsys, 4, raise_at=2)
    assert out["port"][:3] == out["ref"][:3]
    assert out["port"][0] == "fold 2 failed"
    summary = json.loads(out["port"][1])
    assert [r["fold"] for r in summary["folds"]] == [0, 1] and not summary["complete"]
    assert "writing partial summary" in out["port"][2]


def test_preempted_fold_returns_1_with_partial_summary(ref, tmp_path, monkeypatch, capsys):
    """A fold preempted by SIGTERM/SIGINT (run_training returns the
    preemption record): the partial summary, return code 1."""
    out = _run_both(ref, tmp_path, monkeypatch, capsys, 3, preempt_at=1)
    assert out["port"][:3] == out["ref"][:3] and out["port"][0] == 1
    assert [r["fold"] for r in json.loads(out["port"][1])["folds"]] == [0]
    assert "fold 1 preempted at iteration 7" in out["port"][2]


def test_no_card_exits_non_zero(tmp_path, monkeypatch):
    """The default device is the card: without one the runner exits
    non-zero with a message, and runs no fold on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(cli, "run_training", _fake_training())
    with pytest.raises(SystemExit) as e:
        run_folds.main(["--folds", "2", "--output_path", str(tmp_path),
                        "--dataset", "synthetic"])
    assert "no CUDA card is visible" in str(e.value.code)
    assert not (tmp_path / "folds_summary.json").exists()


@pytest.fixture
def narrow_net(monkeypatch):
    """The command line has no width flag: its configs get a width-0.125
    net, so that a real fold runs in seconds on the CPU."""
    config_from_args = cli.config_from_args

    def narrow(args):
        c = config_from_args(args)
        return dataclasses.replace(c, model=dataclasses.replace(
            c.model, width_multiplier=0.125))

    monkeypatch.setattr(cli, "config_from_args", narrow)


def test_two_real_folds_twice_write_identical_summaries(tmp_path, narrow_net, capsys):
    """Two folds of a tiny run (width 0.125, 6 iterations, scales 9 and
    13, pool_backward pallas) on the CPU, run twice: byte-identical
    folds_summary.json files, with every fold scored."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        summaries = []
        for run in ("a", "b"):
            rc = run_folds.main([
                "--folds", "2", "--output_path", str(tmp_path / run),
                "--device", "cpu", "--dataset", "synthetic",
                "--dataset_kwargs", '{"size": 48}', "--values", "9,13",
                "--niter", "6", "--batch_size", "8", "--eval_every", "3",
                "--checkpoint_every", "3", "--window_batch", "64",
                "--pool_backward", "pallas"])
            assert rc == 0
            summaries.append((tmp_path / run / "folds_summary.json").read_bytes())
    finally:
        torch.set_num_threads(threads)
    assert summaries[0] == summaries[1]
    summary = json.loads(summaries[0])
    assert summary["complete"] and [r["fold"] for r in summary["folds"]] == [0, 1]
    assert 0.5 < summary["oa_mean"] <= 1.0
    assert "fold 1 kernel launches:" in capsys.readouterr().out


def test_folds_on_two_cpu_ranks(tmp_path, narrow_net):
    """--num_devices 2 trains each fold on two spawned ranks (gloo on the
    CPU), as the command line does: the summary of rank 0's scores is
    written, and rank 0 alone logs the fold."""
    rc = run_folds.main([
        "--folds", "1", "--output_path", str(tmp_path), "--device", "cpu",
        "--num_devices", "2", "--dataset", "synthetic",
        "--dataset_kwargs", '{"size": 48}', "--values", "9,13", "--niter", "4",
        "--batch_size", "8", "--eval_every", "4", "--checkpoint_every", "4",
        "--window_batch", "64"])
    assert rc == 0
    summary = json.loads((tmp_path / "folds_summary.json").read_text())
    assert summary["complete"] and 0.0 < summary["oa_mean"] <= 1.0
    log = (tmp_path / "fold0" / "metrics.jsonl").read_text()
    assert log.count("=== fold 0/1 ===") == 1
