"""The port's collapse and EMA studies (dynseg_torch.probes.diagnose_collapse
and ema_recalib_probe) against the scripts they port
(scripts/diagnose_collapse.py and ema_recalib_probe.py, loaded by path),
in this process on the CPU.

* Each parser is the script's, flag by flag, but for --device (in place
  of --platform) and the --out defaults (and diagnose_collapse's
  --workdir, torch_collapse_diag under the temporary directory).
* diagnose_collapse on a stand-in for run_training / run_testing that
  logs the port's lines: the script's argv for every training and
  testing call (keep_best, use_best, use_ema as the script passes them),
  trajectories parsed by the same regexes, the same JSON and printed
  lines, with EMA on and off, a cell that raises and a preempted cell.
* A tiny real diagnose_collapse on the CPU (width 0.125, 100 iterations,
  eval every 50, EMA) gives train and val trajectories, per-scale scores
  and a best_iter: the regexes match the port's log. ema_recalib_probe
  then runs on its kept cell.
* ema_recalib_probe against the script from one tiny EMA checkpoint that
  the JAX CLI makes here and `checkpoint.import_reference_state` imports:
  the raw and EMA weights scored are the same, and the BatchNorm
  statistics recalibrated at N = 1 and 2 are within 1e-5 of the script's
  (measured 1.3e-6 on statistics up to 1.6; the same weights, the same
  sampled batches); from the
  same scores the JSON is byte for byte the script's.
* The refusals exit with the script's code and message; without a card
  the default --device exits 1 before any work.
"""

import dataclasses
import json
import os
import tempfile

import jax
import numpy as np
import pytest
import torch

import dynseg.cli as jax_cli
import dynseg.infer as jax_infer
from dynseg_torch import cli
from dynseg_torch.bridge import flax_to_torch
from dynseg_torch.probes import diagnose_collapse, ema_recalib_probe
from test_torch_cli import import_from_dynseg
from test_torch_studies import (StandIn, assert_parser_is_the_scripts, assert_same_runs,
                                run_both, run_script, script)

DATA = ["--dataset", "synthetic", "--dataset_kwargs", '{"size": 48}', "--values", "9,13"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name, module, differences", [
    ("diagnose_collapse", diagnose_collapse,
     {"out": ("docs/collapse_diag.json", "docs/torch_collapse_diag.json"),
      "workdir": ("/tmp/collapse_diag",
                  os.path.join(tempfile.gettempdir(), "torch_collapse_diag"))}),
    ("ema_recalib_probe", ema_recalib_probe,
     {"out": ("docs/ema_recalib_probe.json", "docs/torch_ema_recalib_probe.json")}),
])
def test_parser_is_the_scripts(name, module, differences, monkeypatch):
    assert_parser_is_the_scripts(name, module.main, monkeypatch, differences)


# --------------------------------------------------------------------- #
# diagnose_collapse on a stand-in
# --------------------------------------------------------------------- #
class Logging(StandIn):
    """The stand-in, logging what run_training and run_testing log and the
    trajectories parse: an "iter" line with the scheduler's summary (one
    scale not yet scored), "[val @ iter]" lines with a new-best line, and
    the best checkpoint's restore line."""

    def run_training(self, cfg, log=print, keep_best=False, **kw):
        n = cfg.train.niter
        log(f"iter {n // 2}/{n} scale=9 loss=0.6931 acc=0.5123 patches/s=812.5 | "
            f"9:p=0.55,s=0.512 13:p=0.45,s=-")
        for it, f1 in ((n // 2, 0.7012), (n, 0.6543)):
            log(f"[val @ iter {it}] loss=0.5000 acc=0.8000 kappa=-0.0123 meanF1={f1:.4f}")
            if it == n // 2:
                log(f"[val @ iter {it}] new best meanF1={f1:.4f} saved")
        return super().run_training(cfg, log, keep_best, **kw)

    def run_testing(self, cfg, log=print, scales_from_scheduler=0, use_best=False,
                    use_ema=None, **kw):
        log(f"restored {'best ' if use_best else ''}checkpoint at iteration "
            f"{cfg.train.niter // 2 if use_best else cfg.train.niter}")
        return super().run_testing(cfg, log, scales_from_scheduler, use_best, use_ema, **kw)


@pytest.mark.parametrize("extra, fault, cells", [
    ([], {}, 3),
    (["--ema_decay", "0.999", "--no_batch_norm", "--bn_momentum", "0.99",
      "--compute_dtype", "bfloat16", "--width_multiplier", "0.5", "--tag", "h1"], {}, 3),
    (["--ema_decay", "0.9"], {"raise_at": (2, RuntimeError("device lost"))}, 2),
    ([], {"preempt_at": 3}, 3),
], ids=["plain", "ema_and_knobs", "raises", "preempted"])
def test_diagnose_collapse_matches_the_script(extra, fault, cells, tmp_path, monkeypatch,
                                              capsys):
    """Three cells: the same argvs (training with --keep_best; testing at
    the best checkpoint with use_ema False under EMA, then the raw final
    iterate), the same JSON (rewritten after each cell) and lines; a cell
    that raises or is preempted leaves the completed cells with partial
    true and re-raises."""
    argv = ["--runs", "multinomial:0,uniform:4,multi_fixed:-1", "--niter", "40",
            "--eval_every", "20", "--learning_rate", "0.02", "--lr_decay_rate", "0.5",
            "--lr_decay_steps", "10", "--workdir", str(tmp_path / "work")] + extra
    out = run_both("diagnose_collapse", diagnose_collapse.main, argv, tmp_path,
                   monkeypatch, capsys, stand_in=Logging, **fault)
    rc, js, text, err, fake = assert_same_runs(out)
    payload = json.loads(js)
    ema = "--ema_decay" in extra
    kinds = [(c[0], c[2]) for c in fake.calls]
    per_cell = [("train", {"keep_best": True}),
                ("test", {"use_best": True, "use_ema": False if ema else None})]
    per_cell += [("test", {"use_best": False, "use_ema": False})] if ema else []
    if not fault:
        assert rc == 0 and payload["partial"] is False and len(payload["results"]) == cells
        assert kinds == per_cell * cells
        r = payload["results"][2]
        assert r["seed"] == -1 and r["best_iter"] == 20
        assert r["train_trajectory"] == [{"iter": 20, "scale": 9, "loss": 0.6931,
                                          "acc": 0.5123, "scores": {"9": 0.512, "13": None}}]
        assert [v["iter"] for v in r["val_trajectory"]] == [20, 40]
        assert ("ema_oa" in r) == ema
        assert not os.listdir(tmp_path / "work")  # no --keep_checkpoints
    else:
        assert payload["partial"] is True and len(payload["results"]) == cells - 1
        assert "run failed — writing partial results" in err
        assert rc == ("RuntimeError('device lost')" if "raise_at" in fault
                      else "KeyboardInterrupt()")


@pytest.mark.parametrize("runs", ["multinomial", "multinomial:x", "multinomial:0,:"])
def test_bad_runs_cell_is_refused_as_by_the_script(runs, monkeypatch, capsys):
    monkeypatch.setattr(jax_cli, "enable_compilation_cache", lambda *a, **k: None)
    errors = []
    for main in (lambda: run_script(script("diagnose_collapse"), ["--runs", runs]),
                 lambda: diagnose_collapse.main(["--runs", runs])):
        with pytest.raises(SystemExit) as e:
            main()
        assert e.value.code == 2
        errors.append(capsys.readouterr().err.splitlines()[-1].split("error: ", 1)[1])
    assert errors[0] == errors[1] and "want distribution:seed" in errors[0]


# --------------------------------------------------------------------- #
# real runs
# --------------------------------------------------------------------- #
def test_tiny_diagnose_collapse_parses_the_ports_log_then_ema_probe(tmp_path, capsys):
    """A real cell on the CPU: the regexes find the port's iter and val
    lines (with the scheduler's per-scale scores) and its best-checkpoint
    restore line; the kept cell then feeds ema_recalib_probe."""
    out = tmp_path / "diag.json"
    rc = diagnose_collapse.main(
        ["--runs", "multinomial:0", *DATA, "--niter", "100", "--batch_size", "8",
         "--eval_every", "50", "--width_multiplier", "0.125", "--window_batch", "64",
         "--ema_decay", "0.9", "--keep_checkpoints", "--workdir", str(tmp_path / "work"),
         "--device", "cpu", "--out", str(out)])
    assert rc == 0
    r = json.loads(out.read_text())["results"][0]
    assert [t["iter"] for t in r["train_trajectory"]] == [50, 100]
    assert all(set(t["scores"]) == {"9", "13"} for t in r["train_trajectory"])
    assert [v["iter"] for v in r["val_trajectory"]] == [50, 100]
    assert r["best_iter"] in (50, 100) and "final scale distribution" in r["final_distribution"]
    assert 0 < r["ema_oa"] <= 1 and 0 < r["final_oa"] <= 1 and 0 < r["best_oa"] <= 1
    text = capsys.readouterr().out
    assert "    K2 launches: 0 (gathers 154: 2 x 1 warm-up + 100 steps + 2 evals + " \
           "50 recalibration;" in text
    assert "    K2 real batch B=8 s=13 (plain vs plain): bitwise: True" in text

    cell = tmp_path / "work" / "multinomial_s0"
    assert ema_recalib_probe.main(
        ["--ckpt", str(cell), "--seed", "0", *DATA, "--batch_size", "8",
         "--recalib_batches", "3,1", "--window_batch", "64", "--device", "cpu",
         "--out", str(tmp_path / "ema.json")]) == 0
    got = json.loads((tmp_path / "ema.json").read_text())
    assert got["step"] == 100 and got["ema_decay"] == 0.9
    assert list(got["ema_recalibrated"]) == ["1", "3"]
    assert "K2 launches: 0 (gathers 3: 3 recalibration forwards;" in capsys.readouterr().out


@pytest.fixture(scope="module")
def jax_ema_run(tmp_path_factory):
    """The JAX CLI trains a tiny EMA model on the CPU (width 0.125, 8
    iterations, decay 0.9) and the port imports its checkpoint."""
    root = tmp_path_factory.mktemp("ema")
    args = jax_cli.build_argparser().parse_args(
        ["--operation", "training", "--niter", "8", "--batch_size", "8",
         "--eval_every", "1000", "--checkpoint_every", "1000", "--ema_decay", "0.9",
         "--ema_recalib_batches", "2", "--no_prediction_maps",
         "--output_path", str(root / "jax"), *DATA])
    cfg = jax_cli.config_from_args(args)
    jax_cli.run_training(dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, width_multiplier=0.125)), log=lambda *_: None)
    import_from_dynseg(str(root / "jax"), str(root / "port"))
    return root


def _evaluations(monkeypatch, target, convert):
    """validate_test replaced in `target`: records the variables it gets
    (through `convert`) and answers with scores made from the call's
    index, the same on both sides."""
    seen = []

    def fake(cfg, variables, tiles, *args, **kw):
        seen.append(convert(variables))
        rng = np.random.default_rng(len(seen))
        return {"oa": float(rng.uniform(0.5, 1)), "mean_f1": float(rng.uniform(0.5, 1))}

    monkeypatch.setattr(target, "validate_test", fake)
    return seen


def test_ema_recalib_probe_matches_the_script(jax_ema_run, monkeypatch, capsys):
    """The same checkpoint through both: the raw and EMA weights scored are
    the script's; the statistics recalibrated at N = 1 and 2 within 1e-5;
    from the same scores the same JSON and lines."""
    monkeypatch.setattr(jax_cli, "enable_compilation_cache", lambda *a, **k: None)
    argv = ["--seed", "0", *DATA, "--batch_size", "8", "--recalib_batches", "2,1",
            "--window_batch", "64"]
    want = _evaluations(monkeypatch, jax_infer,
                        lambda v: {k: t.numpy() for k, t in flax_to_torch(
                            jax.tree.map(np.array, dict(v))).items()})
    jax_dir, port_dir = str(jax_ema_run / "jax"), str(jax_ema_run / "port")
    assert run_script(script("ema_recalib_probe"), argv + [
        "--ckpt", jax_dir, "--platform", "cpu",
        "--out", str(jax_ema_run / "jax.json")]) == 0
    want_text = capsys.readouterr().out

    got = _evaluations(monkeypatch, ema_recalib_probe,
                       lambda v: {k: t.numpy() for k, t in v.items()})
    assert ema_recalib_probe.main(argv + ["--ckpt", port_dir, "--device", "cpu",
                                          "--out", str(jax_ema_run / "port.json")]) == 0
    text = capsys.readouterr().out

    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys()
        for k in w:
            if i < 2 or "running" not in k and "num_batches" not in k:
                # raw and EMA as restored; the params stay frozen
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"{i} {k}")
            elif "running" in k:  # (flax counts no batches)
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-5, err_msg=f"{i} {k}")
    moved = [k for k in want[0] if "running_var" in k and not np.array_equal(want[0][k], want[3][k])]
    assert moved  # the recalibration did move the statistics

    jax_bytes = (jax_ema_run / "jax.json").read_bytes().replace(jax_dir.encode(), b"CKPT")
    port_bytes = (jax_ema_run / "port.json").read_bytes().replace(port_dir.encode(), b"CKPT")
    assert port_bytes == jax_bytes
    lines = [ln.replace(str(jax_ema_run / "jax.json"), "OUT") for ln in want_text.splitlines()]
    port_lines = [ln.replace(str(jax_ema_run / "port.json"), "OUT")
                  for ln in text.splitlines() if not ln.startswith(("platform:", "    "))]
    assert port_lines == lines


def test_non_ema_checkpoint_is_refused_as_by_the_script(tmp_path, monkeypatch):
    (tmp_path / "checkpoints").mkdir()
    (tmp_path / "checkpoints" / "stats.json").write_text(json.dumps({"ema_decay": 0.0}))
    monkeypatch.setattr(jax_cli, "enable_compilation_cache", lambda *a, **k: None)
    argv = ["--ckpt", str(tmp_path), "--seed", "0", "--out", str(tmp_path / "x.json")]
    messages = []
    for main in (lambda: run_script(script("ema_recalib_probe"), argv + ["--platform", "cpu"]),
                 lambda: ema_recalib_probe.main(argv + ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            main()
        messages.append(e.value.code)
    assert messages[0] == messages[1] == f"{tmp_path} is not an EMA checkpoint with sidecar"


@pytest.mark.parametrize("module, argv", [
    (diagnose_collapse, ["--runs", "multinomial:0"]),
    (ema_recalib_probe, ["--ckpt", "CKPT", "--seed", "0"]),
])
def test_without_a_card_the_default_exits_1(module, argv, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fake = StandIn()
    monkeypatch.setattr(cli, "run_training", fake.run_training)
    assert module.parse_args(argv).device == "cuda"
    assert module.main(argv + ["--out", "/nonexistent/out.json"]) == 1
    printed = capsys.readouterr()
    assert "no CUDA card is visible" in printed.err and "platform" not in printed.out
    assert fake.calls == []
