"""The port's accuracy studies (dynseg_torch.probes.sched_ablation,
mode_gap, bf16_eval and parity_bracket) against the scripts they port
(scripts/<name>.py, loaded by path), in this process on the CPU.

* Each parser is the script's, flag by flag (default, type, choices),
  but for three deliberate differences: --device (default cuda) in place
  of --platform (mode_gap gains it), and the --out defaults, none of
  which names an existing file under docs/.
* With run_training / run_testing replaced by a stand-in that records
  its config and returns scores made from it, each study issues the
  script's command-line argv and dataclasses.replace overrides for every
  (config, seed), in the script's order, and writes the script's JSON and
  prints the script's lines byte for byte: complete runs, a run that
  raises, a preempted run, an interrupt.
* The refusals exit with the script's code and message.
* A tiny real sched_ablation through both (two configs, the width-0.125
  net, 4 iterations of batch 8, a 64^2 texture set), each drawing its own
  init, the port's equal to JAX's: every run's OA and mean F1 within 1e-3 of the script's (measured
  1.2e-4 in OA and 1.4e-4 in mean F1; the maps are not one class, OA ~0.3).
* Without a card the default --device exits 1 before any work.
"""

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
import tempfile
import time
import zlib

import jax
import numpy as np
import pytest
import torch

import dynseg.cli as jax_cli
import dynseg.train as jax_train
import dynseg_torch.train as port_train
from dynseg_torch import bridge, cli
from dynseg_torch.probes import (bf16_eval, diagnose_collapse, ema_recalib_probe,
                                 mode_gap, parity_bracket, sched_ablation, study)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = {"sched_ablation": sched_ablation, "mode_gap": mode_gap,
        "bf16_eval": bf16_eval, "parity_bracket": parity_bracket}
# Each study's --out default: the script's, and the port's.
OUT = {"sched_ablation": ("docs/sched_ablation.json", "docs/torch_sched_ablation.json"),
       "mode_gap": ("docs/mode_gap.json", "docs/torch_mode_gap.json"),
       "bf16_eval": ("docs/bf16_eval.json", "docs/torch_bf16_eval.json"),
       "parity_bracket": ("bracket.json", "torch_bracket.json")}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _Stop(Exception):
    """Raised by a stand-in once it has captured what a test needs."""


def script(name: str):
    """A fresh module of scripts/<name>.py."""
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_script(mod, argv):
    """The script's main with argv in sys.argv; returns its return code."""
    saved = sys.argv
    sys.argv = [f"{mod.__name__}.py"] + list(argv)
    try:
        return mod.main()
    finally:
        sys.argv = saved


def parser_of(main, monkeypatch) -> argparse.ArgumentParser:
    """The parser a main() builds, caught at its parse_args."""
    seen = []

    def capture(self, args=None, namespace=None):
        seen.append(self)
        raise _Stop

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Stop):
            main()
    return seen[0]


def flags(parser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices,
                     a.nargs, a.required, a.const)
            for a in parser._actions if a.dest != "help"}


def assert_parser_is_the_scripts(name, port_main, monkeypatch, differences):
    """The port's flags equal the script's, but for --platform -> --device
    and the defaults in `differences` {dest: (script's, port's)}."""
    mod = script(name)
    want = flags(parser_of(lambda: run_script(mod, []), monkeypatch))
    got = flags(parser_of(lambda: port_main([]), monkeypatch))
    want.pop("platform", None)
    assert got.pop("device") == (("--device",), "cuda", None, None, None, False, None)
    for dest, (old, new) in differences.items():
        assert want[dest][1] == old and got[dest][1] == new, dest
        want[dest] = got[dest]
    assert got == want


@pytest.mark.parametrize("name", sorted(PORT))
def test_parser_is_the_scripts(name, monkeypatch):
    assert_parser_is_the_scripts(name, PORT[name].main, monkeypatch,
                                 {"out": OUT[name]})


def test_no_port_default_writes_into_the_docs():
    """No study's default --out (nor diagnose_collapse's --workdir) names
    one of the JAX package's JSONs under docs/: a port run from the repo
    root leaves the committed evidence as it is, and writes torch_*.json."""
    defaults = [m.parse_args(argv) for m, argv in (
        (sched_ablation, []), (mode_gap, []), (bf16_eval, []), (parity_bracket, []),
        (diagnose_collapse, ["--runs", "multinomial:0"]),
        (ema_recalib_probe, ["--ckpt", "CKPT", "--seed", "0"]))]
    outs = [a.out for a in defaults]
    assert len(set(outs)) == 6
    evidence = {f for f in os.listdir(os.path.join(ROOT, "docs"))
                if f.endswith(".json") and not f.startswith("torch_")}
    # The scripts' defaults are among them.
    assert {"sched_ablation.json", "mode_gap.json", "bf16_eval.json", "collapse_diag.json",
            "ema_recalib_probe.json"} <= evidence
    for out in outs:
        assert os.path.basename(out).startswith("torch_"), out
        assert os.path.basename(out) not in evidence, out
    assert [o for o in outs if o.startswith("docs/")] == outs[:3] + outs[4:]
    assert defaults[4].workdir == os.path.join(tempfile.gettempdir(), "torch_collapse_diag")


# --------------------------------------------------------------------- #
# the studies, on a stand-in for training and testing
# --------------------------------------------------------------------- #
def scores_for(cfg, kind: str) -> dict:
    """Scores made from the config (and the call's kind), the same on both
    sides when the configs are."""
    key = json.dumps([kind, dataclasses.asdict(cfg.sched), dataclasses.asdict(cfg.model),
                      cfg.train.seed, cfg.infer.mode], sort_keys=True, default=str)
    rng = np.random.default_rng(zlib.crc32(key.encode()))
    oa, kappa, f1 = (float(x) for x in rng.uniform(0.5, 1.0, 3))
    return {"oa": oa, "kappa": kappa, "mean_f1": f1, "f1": np.array([f1, f1]),
            "infer_wall_s": float(rng.uniform(0.1, 9.9))}


def normalised(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d["train"]["output_path"] = "OUT"
    return d


class StandIn:
    """run_training and run_testing of one side: records (kind, the
    config, the keyword arguments) of every call and answers with
    `scores_for`; the n-th training call (from 1) raises `raise_at`'s
    exception or returns a preemption record."""

    def __init__(self, raise_at=None, preempt_at=None):
        self.calls, self.argvs = [], []
        self.raise_at, self.preempt_at = raise_at or (None, None), preempt_at
        self.trainings = 0

    def run_training(self, cfg, log=print, keep_best=False, on_trainer=None, **kw):
        self.trainings += 1
        self.calls.append(("train", normalised(cfg), {"keep_best": keep_best}))
        if on_trainer is not None:  # the port's hook; study.report is stood in for
            on_trainer(None)
        if self.trainings == self.raise_at[0]:
            raise self.raise_at[1]
        if self.trainings == self.preempt_at:
            return {"preempted": True, "iteration": 3}
        d = cfg.sched.distribution_type
        log(f"training done; final scale distribution: {d}:p=1.00,s=0.500")
        return scores_for(cfg, "train")

    def run_testing(self, cfg, log=print, scales_from_scheduler=0, use_best=False,
                    use_ema=None, **kw):
        self.calls.append(("test", normalised(cfg),
                           {"use_best": use_best, "use_ema": use_ema}))
        return scores_for(cfg, f"test best={use_best} ema={use_ema}")

    def recording(self, build):
        """build_argparser, whose parsers record the argv they parse."""
        def build_recording():
            parser = build()
            parse = parser.parse_args

            def parse_args(args=None, namespace=None):
                argv = list(args)
                if "--output_path" in argv:
                    argv[argv.index("--output_path") + 1] = "OUT"
                self.argvs.append(argv)
                return parse(args, namespace)

            parser.parse_args = parse_args
            return parser
        return build_recording


def run_both(name, port_main, argv, tmp_path, monkeypatch, capsys, stand_in=StandIn,
             **fault):
    """The script and the port over argv on stand-ins: per side the return
    code (or the exception raised), the JSON's bytes (None if none was
    written), standard output and error, and the stand-in."""
    monkeypatch.setattr(jax_cli, "enable_compilation_cache", lambda *a, **k: None)
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    monkeypatch.setattr(study, "report", lambda *a, **k: None)
    out = {}
    for side in ("script", "port"):
        d = tmp_path / side
        d.mkdir()
        path = d / "out.json"
        fake = stand_in(**fault)
        pkg = jax_cli if side == "script" else cli
        monkeypatch.setattr(pkg, "run_training", fake.run_training)
        monkeypatch.setattr(pkg, "run_testing", fake.run_testing)
        monkeypatch.setattr(pkg, "build_argparser", fake.recording(pkg.build_argparser))
        full = list(argv) + ["--out", str(path)]
        try:
            if side == "script":
                rc = run_script(script(name), full)
            else:
                rc = port_main(full + ["--device", "cpu"])
        except (RuntimeError, KeyboardInterrupt) as e:
            rc = repr(e)
        printed = capsys.readouterr()
        text = printed.out.replace(str(path), "OUT")
        if side == "port":
            first, text = text.split("\n", 1)
            assert first == "platform: cpu (cpu)"
        out[side] = (rc, path.read_bytes() if path.exists() else None, text,
                     printed.err, fake)
    return out


def assert_same_runs(out):
    """Return codes, JSON bytes, standard output and error, argvs and
    configs of both sides equal; returns the port's part."""
    (rc, js, text, err, fake), (wrc, wjs, wtext, werr, wfake) = out["port"], out["script"]
    assert (rc, text, err) == (wrc, wtext, werr)
    assert js == wjs
    assert fake.argvs == wfake.argvs
    assert fake.calls == wfake.calls
    return out["port"]


SCHED_ARGV = ["--values", "25,35", "--seeds", "2", "--seed_start", "3", "--niter", "50",
              "--batch_size", "64", "--rescale_batch_by_area", "--tag", "@t",
              "--width_multiplier", "0.5", "--dataset_kwargs", '{"label_noise": 0.0}',
              "--update_type", "loss", "--sched_temperature", "0.25"]


@pytest.mark.parametrize("fault, calls", [
    ({}, 10), ({"raise_at": (4, RuntimeError("device lost"))}, 4), ({"preempt_at": 6}, 6),
    ({"raise_at": (4, KeyboardInterrupt())}, 4), ({"raise_at": (1, RuntimeError("first"))}, 1),
], ids=["complete", "raises", "preempted", "interrupt", "raises_first"])
def test_sched_ablation_matches_the_script(fault, calls, tmp_path, monkeypatch, capsys):
    """Five configs x two seeds: the same argvs, overrides, JSON and lines.
    A run that raises leaves {"partial": true, ...} and re-raises; a
    preempted or interrupted one writes the completed configs with the
    in-flight one's seeds as "<name>(partial)" and returns 0; a fault on
    the first run writes nothing."""
    out = run_both("sched_ablation", sched_ablation.main, SCHED_ARGV, tmp_path,
                   monkeypatch, capsys, **fault)
    rc, js, text, err, fake = assert_same_runs(out)
    assert len(fake.calls) == calls
    error = fault.get("raise_at", (None, None))[1]
    if not fault:
        payload = json.loads(js)
        assert rc == 0 and len(payload["results"]) == 5
        assert payload["results"][0]["runs"][0]["seed"] == 3
        assert "single_fixed@25@t" in text and "final scale distribution" in text
        assert [c[1]["model"]["width_multiplier"] for c in fake.calls] == [0.5] * 10
    elif error is None or isinstance(error, KeyboardInterrupt):
        assert rc == 0 and "interrupted — writing partial results" in text
        names = [r["config"] for r in json.loads(js)["results"]]
        assert len(names) == calls // 2 and sum(n.endswith("(partial)") for n in names) == 1
    elif calls == 1:
        assert rc == "RuntimeError('first')" and js is None
    else:
        assert rc == "RuntimeError('device lost')" and json.loads(js)["partial"] is True
        assert "run failed — writing partial results" in err


@pytest.mark.parametrize("fault", [{}, {"preempt_at": 3}], ids=["complete", "preempted"])
def test_mode_gap_matches_the_script(fault, tmp_path, monkeypatch, capsys):
    """Two regimes x two seeds, run_testing twice per mode: the same argvs,
    configs, JSON and lines; a preempted training returns 1 and writes
    nothing."""
    out = run_both("mode_gap", mode_gap.main,
                   ["--seeds", "2", "--niter", "40", "--batch_size", "16"],
                   tmp_path, monkeypatch, capsys, **fault)
    rc, js, text, err, fake = assert_same_runs(out)
    if fault:
        assert rc == 1 and js is None and "preempted — aborting sweep" in err
        assert [c[0] for c in fake.calls] == (["train"] + ["test"] * 4) * 2 + ["train"]
    else:
        assert rc == 0 and len(fake.calls) == 4 * 5
        assert [c[1]["infer"]["mode"] for c in fake.calls[1:5]] == ["window"] * 2 + ["dense"] * 2
        assert json.loads(js)["rows"][0]["window"]["wall_s"] > 0


def test_bf16_eval_matches_the_script(tmp_path, monkeypatch, capsys):
    """Two seeds, each trained once and scored window/dense x f32/bf16: the
    same argvs, configs, JSON and lines."""
    out = run_both("bf16_eval", bf16_eval.main,
                   ["--seeds", "2", "--niter", "30", "--values", "25,45",
                    "--dense_block", "128"], tmp_path, monkeypatch, capsys)
    rc, js, text, err, fake = assert_same_runs(out)
    assert rc == 0 and len(fake.calls) == 2 * 5
    assert [(c[1]["infer"]["mode"], c[1]["model"]["compute_dtype"]) for c in fake.calls[1:5]] == [
        ("window", "float32"), ("window", "bfloat16"), ("dense", "float32"),
        ("dense", "bfloat16")]
    assert set(json.loads(js)["per_seed"][1]) == {
        "seed", "window_f32", "window_bf16", "dense_f32", "dense_bf16"}


@pytest.mark.parametrize("argv, fault", [
    (["--seeds", "1"], {}),
    (["--seeds", "2", "--combos", "3"], {"preempt_at": 4}),
    (["--seeds", "1", "--combos", "5"], {"raise_at": (3, KeyboardInterrupt())}),
    (["--seeds", "1", "--combos", "5"], {"raise_at": (2, RuntimeError("lost"))}),
], ids=["all_16", "preempted", "interrupt", "raises"])
def test_parity_bracket_matches_the_script(argv, fault, tmp_path, monkeypatch, capsys):
    """The 16 combinations (or the first --combos) with their overrides of
    leaky_slope, use_batch_norm, width_multiplier and favor_high_score:
    the same argvs, configs, ranking and lines; a preempted or
    interrupted run writes the partial ranking and exits 130."""
    out = run_both("parity_bracket", parity_bracket.main,
                   ["--dataset", "synthetic_texture", "--niter", "20"] + argv,
                   tmp_path, monkeypatch, capsys, **fault)
    rc, js, text, err, fake = assert_same_runs(out)
    models = [(c[1]["sched"]["favor_high_score"], c[1]["sched"]["update_type"],
               c[1]["model"]["leaky_slope"], c[1]["model"]["use_batch_norm"],
               c[1]["model"]["width_multiplier"]) for c in fake.calls]
    if not fault:
        assert rc == 0 and len(json.loads(js)) == 16
        assert models == [(*b, 0.25) for b in parity_bracket.bracket()]
    elif "raise_at" in fault and isinstance(fault["raise_at"][1], RuntimeError):
        assert rc == "RuntimeError('lost')" and js is None
    else:
        assert rc == 130 and "writing partial ranking" in text
        assert len(json.loads(js)) == (1 if "preempt_at" in fault else 2)


@pytest.mark.parametrize("name, argv", [
    ("sched_ablation", ["--seeds", "0"]),
    ("sched_ablation", ["--distributions", "multinomial,multinomal"]),
    ("mode_gap", ["--seeds", "0"]),
    ("parity_bracket", ["--seeds", "x"]),
])
def test_refusals_match_the_script(name, argv, monkeypatch, capsys):
    """The same exit code and the same error message, before any run."""
    monkeypatch.setattr(jax_cli, "enable_compilation_cache", lambda *a, **k: None)
    errors = []
    for main in (lambda: run_script(script(name), argv), lambda: PORT[name].main(argv)):
        with pytest.raises(SystemExit) as e:
            main()
        assert e.value.code == 2
        errors.append(capsys.readouterr().err.splitlines()[-1].split("error: ", 1)[1])
    assert errors[0] == errors[1]


@pytest.mark.parametrize("name", sorted(PORT))
def test_without_a_card_the_default_exits_1(name, monkeypatch, capsys):
    """--device defaults to the card; where none is visible each study
    exits 1 with a message, before any run and without writing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fake = StandIn()
    monkeypatch.setattr(cli, "run_training", fake.run_training)
    monkeypatch.setattr(cli, "run_testing", fake.run_testing)
    assert PORT[name].parse_args([]).device == "cuda"
    assert PORT[name].main(["--out", "/nonexistent/out.json"]) == 1
    printed = capsys.readouterr()
    assert "no CUDA card is visible" in printed.err and "platform" not in printed.out
    assert fake.calls == []


# --------------------------------------------------------------------- #
# a real run against the script's
# --------------------------------------------------------------------- #
def test_tiny_sched_ablation_matches_the_script(tmp_path, monkeypatch, capsys):
    """Two configs (multi_fixed and uniform over 25 and 35 px: the scales
    they draw do not depend on the scores) through the script on
    XLA-CPU and the port on the CPU, each side drawing its own init for
    --seed: the port's draw equals JAX's init of each run, and every
    run's OA and mean F1 is within 1e-3."""
    monkeypatch.setattr(jax_cli, "enable_compilation_cache", lambda *a, **k: None)
    argv = ["--values", "25,35", "--skip_single_fixed", "--distributions",
            "multi_fixed,uniform", "--seeds", "1", "--niter", "4", "--batch_size", "8",
            "--width_multiplier", "0.125", "--dataset_kwargs", '{"size": 64}',
            "--window_batch", "64"]
    inits = []
    jax_init = jax_train.Trainer.init_state

    def recording(self, rng):
        state = jax_init(self, rng)
        inits.append(jax.tree.map(np.array, {"params": state.params,
                                             "batch_stats": state.batch_stats}))
        return state

    monkeypatch.setattr(jax_train.Trainer, "init_state", recording)
    run_script(script("sched_ablation"), argv + ["--platform", "cpu",
                                                  "--out", str(tmp_path / "jax.json")])
    want = json.loads((tmp_path / "jax.json").read_text())
    assert len(inits) == 2

    port_init = port_train.Trainer.init_state
    drawn = []

    def own_draw(self, seed=0, variables=None):
        assert variables is None
        state = port_init(self, seed)
        drawn.append(bridge.torch_to_flax(
            {k: v.clone() for k, v in state.model.state_dict().items()}))
        return state

    monkeypatch.setattr(port_train.Trainer, "init_state", own_draw)
    capsys.readouterr()
    got = sched_ablation.run(sched_ablation.parse_args(
        argv + ["--device", "cpu", "--out", str(tmp_path / "port.json")]), torch.device("cpu"))
    text = capsys.readouterr().out
    assert len(drawn) == len(inits)
    for want_tree, got_tree in zip(inits, drawn):
        want_leaves = jax.tree_util.tree_flatten_with_path(want_tree)[0]
        got_leaves = jax.tree_util.tree_flatten_with_path(got_tree)[0]
        assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
        for (path, w), (_, g) in zip(want_leaves, got_leaves):
            np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))
    assert sorted(r["config"] for r in got["results"]) == ["multi_fixed", "uniform"]
    by_config = {r["config"]: r["runs"][0] for r in want["results"]}
    for r in got["results"]:
        w = by_config[r["config"]]
        run = r["runs"][0]
        assert abs(run["oa"] - w["oa"]) <= 1e-3, (r["config"], run["oa"], w["oa"])
        assert abs(run["mean_f1"] - w["mean_f1"]) <= 1e-3, r["config"]
        assert run["final_distribution"] == w["final_distribution"]
    assert text.count("K2 launches: 0 (gathers 6: 2 x 1 warm-up + 4 steps + 0 evals") == 2
    assert text.count("K2 real batch B=8 s=35 (plain vs plain): bitwise: True") == 2

