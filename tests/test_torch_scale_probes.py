"""The port's production-scale rehearsals (dynseg_torch.probes.stress_scale,
profile_multitile and sweep_dense) against the scripts they port
(scripts/stress_scale.py, profile_multitile.py and sweep_dense.py), run
in this process on the CPU.

The data each probe makes is the script's, byte for byte, and so is the
Config it builds, field by field (both at the scripts' defaults). For
the runs, both sides are cut the same way: the net at width 0.125 and,
for stress_scale, batch 8 over scales 9 and 13, by wrapping the config
classes each module names (`_narrow`); the rest of each configuration
(steps_per_call 8, metric_fetch_depth 4, area-rescaled batches, the
per-class cap, window batch, dense block and halo) stays the script's.
The port's runs start from JAX's own init, carried by the bridge.

Tolerances, each measured here at these sizes:
  * stress_scale: one chunk of 8 steps from the same init on the same
    batches, its loss within 1e-4 relative of the script's (measured
    1.2e-6); the buckets drawn equal; OA of both modes within 2e-3. A
    longer run is not compared by its losses: the script's own run, with
    its initial weights moved 1e-7 relative, lands 2.2e-4 away after two
    chunks and 9.9e-3 after seven, and the port lands as far from it;
  * profile_multitile: every label map (both passes, and the warm
    window and dense decomposition) equal to the script's except where
    the port's top two probabilities are within 1e-5 (ties);
  * sweep_dense: every agreement with the float32 block-512 labels
    within 1e-3 of the script's printed one (4 decimals).
"""

import dataclasses
import importlib.util
import io
import os
import re
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynseg.config as jax_config
import dynseg.infer as jax_infer
from dynseg.models.dilated import build_model
from dynseg_torch import config as port_config
from dynseg_torch.bridge import flax_to_torch
from dynseg_torch.infer import Inferencer
from dynseg_torch.probes import profile_multitile, stress_scale, sweep_dense

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Four odd-shaped tiles in place of profile_multitile's SIZES.
TINY_SIZES = [(40, 32), (36, 44), (48, 30), (33, 41)]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one machine: torch's default of
    one intra-op thread per core oversubscribes it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _Stop(Exception):
    """Raised by a stand-in once it has captured what a test needs."""


def _script(name: str):
    """A fresh module of scripts/<name>.py, its compilation cache off."""
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.enable_compilation_cache = lambda *a, **k: None
    return mod


def _run_script(mod, argv):
    """The script's main with argv; returns what it printed."""
    out = io.StringIO()
    saved = sys.argv
    sys.argv = [mod.__name__] + list(argv)
    try:
        with redirect_stdout(out):
            mod.main()
    finally:
        sys.argv = saved
    return out.getvalue()


def _over(cls, **fixed):
    """`cls` with some fields fixed, whatever its caller passes."""
    return lambda *args, **kw: cls(*args, **{**kw, **fixed})


def _narrow(monkeypatch, mod, cfg_mod, small_run: bool = False):
    """Cut a script's or a probe's configuration as the module docstring
    says, through the config classes it names."""
    monkeypatch.setattr(mod, "ModelConfig",
                        _over(cfg_mod.ModelConfig, width_multiplier=0.125))
    if small_run:
        monkeypatch.setattr(mod, "TrainConfig", _over(cfg_mod.TrainConfig, batch_size=8))
        monkeypatch.setattr(mod, "SchedulerConfig",
                            _over(cfg_mod.SchedulerConfig, values=(9, 13)))
        monkeypatch.setattr(mod, "InferConfig", _over(cfg_mod.InferConfig, scales=(9, 13)))


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if hasattr(v, "items") else np.array(v)
            for k, v in tree.items()}


def _labels(text: str):
    """Each printed line's label: its text up to the first digit."""
    return [re.match(r"\D*", line).group(0) for line in text.splitlines() if line.strip()]


def _assert_prints_the_scripts_labels(port_text: str, script_text: str):
    port_lines = port_text.splitlines()
    for label in _labels(script_text):
        assert any(line.startswith(label) for line in port_lines), label


# --------------------------------------------------------------------- #
# the data and the configurations
# --------------------------------------------------------------------- #
def _assert_same_arrays(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def test_stress_scale_tiles_are_the_scripts():
    script = _script("stress_scale")
    want = script.synth_tiles(np.random.default_rng(0), 2, 130)
    got = stress_scale.synth_tiles(np.random.default_rng(0), 2, 130)
    for g, w in zip(got, want):
        _assert_same_arrays(g, w)
    assert got[0][0].dtype == np.float32 and got[1][0].dtype == np.int32


def _captured_tiles(name: str, argv):
    """The rasters the script passes to pack_tiles."""
    script = _script(name)
    seen = {}

    def capture(images, masks, *args, **kw):
        seen["images"], seen["masks"] = list(images), list(masks)
        raise _Stop

    script.pack_tiles = capture
    with pytest.raises(_Stop):
        _run_script(script, argv)
    return seen["images"], seen["masks"]


def test_profile_multitile_tiles_are_the_scripts():
    images, masks = _captured_tiles("profile_multitile", [])
    got_images, got_masks = profile_multitile.make_tiles()
    _assert_same_arrays(got_images, images)
    _assert_same_arrays(got_masks, masks)
    assert [im.shape[:2] for im in got_images] == profile_multitile.SIZES


def test_sweep_dense_tile_is_the_scripts():
    images, masks = _captured_tiles("sweep_dense", ["--size", "96"])
    img, mask = sweep_dense.make_tile(96)
    _assert_same_arrays([img], images)
    _assert_same_arrays([mask], masks)


def _assert_same_config(got, want):
    """Field by field, the port's Config against the script's."""
    assert type(got).__name__ == type(want).__name__ == "Config"
    for f in dataclasses.fields(want):
        assert (dataclasses.asdict(getattr(got, f.name))
                == dataclasses.asdict(getattr(want, f.name))), f.name


def test_stress_scale_config_is_the_scripts():
    script = _script("stress_scale")
    seen = []

    def capture(cfg, *args, **kw):
        seen.append(cfg)
        raise _Stop

    script.Trainer = capture
    with pytest.raises(_Stop):
        _run_script(script, ["--tiles", "1", "--size", "64", "--iters", "120"])
    _assert_same_config(stress_scale.build_config(120), seen[0])
    assert seen[0].train.niter == 120


def test_profile_multitile_config_is_the_scripts():
    script = _script("profile_multitile")
    script.SIZES = TINY_SIZES
    seen = []

    def capture(cfg, *args, **kw):
        seen.append(cfg)
        raise _Stop

    script.validate_test = capture
    script.build_model = lambda cfg: type("Net", (), {"init": lambda *a: {}})()
    with pytest.raises(_Stop):
        _run_script(script, [])
    args = profile_multitile.parse_args([])
    _assert_same_config(profile_multitile.build_config(
        tuple(int(s) for s in args.scales.split(",")), args.window_batch), seen[0])


def test_sweep_dense_configs_are_the_scripts():
    script = _script("sweep_dense")
    seen = []

    class Capture:
        def __init__(self, cfg, tiles):
            seen.append(cfg)

        def predict_tile_dense(self, variables, t, block, halo, return_probs):
            return np.zeros((32, 32), np.int32), None

    script.Inferencer = Capture
    script.build_model = lambda cfg: type("Net", (), {"init": lambda *a: {}})()
    _run_script(script, ["--size", "32", "--blocks", "16"])
    assert [c.model.compute_dtype for c in seen] == ["float32", "bfloat16"]
    for cfg in seen:
        _assert_same_config(sweep_dense.build_config(cfg.model.compute_dtype, 40), cfg)


# --------------------------------------------------------------------- #
# the runs against the scripts'
# --------------------------------------------------------------------- #
def test_stress_scale_run_matches_the_script(monkeypatch):
    """One chunk of 8 steps from JAX's init (tolerances in the module
    docstring), then both modes of validate_test."""
    argv = ["--tiles", "2", "--size", "130", "--iters", "8"]
    script = _script("stress_scale")
    _narrow(monkeypatch, script, jax_config, small_run=True)
    rec = {"losses": [], "scales": []}

    class Recording(script.Trainer):
        def init_state(self, rng):
            state = super().init_state(rng)
            rec["variables"] = _numpy_tree({"params": state.params,
                                            "batch_stats": state.batch_stats})
            return state

        def train_step(self, state, size, *args):
            state, metrics = super().train_step(state, size, *args)
            rec["losses"].append(float(metrics["loss"]))
            rec["scales"].append(size)
            return state, metrics

    script.Trainer = Recording
    scores = {}
    validate = script.validate_test

    def recording_validate(cfg, *args, **kw):
        scores[cfg.infer.mode] = validate(cfg, *args, **kw)
        return scores[cfg.infer.mode]

    script.validate_test = recording_validate
    want_text = _run_script(script, argv)

    _narrow(monkeypatch, stress_scale, port_config, small_run=True)
    out = io.StringIO()
    with redirect_stdout(out):
        got = stress_scale.run(stress_scale.parse_args(argv + ["--device", "cpu"]),
                               variables=rec["variables"])

    assert len(got["losses"]) == len(rec["losses"]) == 1
    np.testing.assert_allclose(got["losses"], rec["losses"], rtol=1e-4)
    for mode in ("dense", "window"):
        assert abs(got["scores"][mode]["oa"] - scores[mode]["oa"]) <= 2e-3, mode
    assert got["gathers"] == 2 * 8 + 8 and got["launches"] == 0
    assert [c[2] for c in got["gather_check"]] == [True, True]
    assert "tile storage uint8" in out.getvalue()
    _assert_prints_the_scripts_labels(out.getvalue(), want_text)
    assert f"scale={rec['scales'][0]}" not in want_text  # no log line at 8 steps


def _tie_free_differences(got, want, probs):
    """Pixels where got and want differ must be ties of `probs`."""
    differ = got != want
    top2 = np.sort(probs, axis=-1)[..., -2:]
    return bool(np.all(top2[differ, 1] - top2[differ, 0] < 1e-5)), int(differ.sum())


def test_profile_multitile_labels_match_the_script(monkeypatch):
    argv = ["--scales", "9", "--window_batch", "64"]
    script = _script("profile_multitile")
    script.SIZES = TINY_SIZES
    _narrow(monkeypatch, script, jax_config)
    build = script.build_model

    class Centred:
        """The script's net with its head bias centred between the mean
        logits of 9^2 windows and of a 128^2 block of normalised noise,
        like the tiles': JAX's init at this width paints one class
        everywhere, and a constant map would make the comparison empty."""

        def __init__(self, cfg):
            self.net = build(cfg)

        def init(self, *args):
            v = _numpy_tree(self.net.init(*args))
            rng = np.random.default_rng(3)
            means = [np.asarray(self.net.apply(v, jnp.asarray(
                rng.uniform(-1.7, 1.7, shape), jnp.float32), train=False)).mean((0, 1, 2))
                for shape in ((64, 9, 9, 3), (1, 128, 128, 3))]
            v["params"]["ScoreHead_0"]["Conv_0"]["bias"] -= (means[0] + means[1]) / 2
            return v

    script.build_model = Centred
    want = {"pass": [], "window": [], "dense": []}
    validate = script.validate_test

    def recording_validate(cfg, variables, tiles, **kw):
        want["variables"] = _numpy_tree(variables)
        scores = validate(cfg, variables, tiles, **kw)
        want["pass"].append(scores["predictions"])
        return scores

    script.validate_test = recording_validate
    calls = {"window": 0, "dense": 0}
    n = len(TINY_SIZES)
    for key, method in (("window", "predict_tile"), ("dense", "predict_tile_dense")):
        orig = getattr(jax_infer.Inferencer, method)

        def recorded(self, *args, _orig=orig, _key=key, **kw):
            pred, prob = _orig(self, *args, **kw)
            calls[_key] += 1
            if calls[_key] > n:  # past the warm-up pass over the tiles
                want[_key].append(np.asarray(pred))
            return pred, prob

        monkeypatch.setattr(jax_infer.Inferencer, method, recorded)
    want_text = _run_script(script, argv)

    monkeypatch.setattr(profile_multitile, "SIZES", TINY_SIZES)
    _narrow(monkeypatch, profile_multitile, port_config)
    out = io.StringIO()
    with redirect_stdout(out):
        got = profile_multitile.run(profile_multitile.parse_args(argv + ["--device", "cpu"]),
                                    variables=want["variables"])
    _assert_prints_the_scripts_labels(out.getvalue(), want_text)
    assert "pass2 labels == pass1 labels: True" in out.getvalue()

    cfg = profile_multitile.build_config((9,), 64)
    tiles = profile_multitile.pack_tiles(*profile_multitile.make_tiles())
    profile_multitile.compute_stats(tiles)
    inf = Inferencer(cfg, tiles, "cpu")
    sd = flax_to_torch(want["variables"])
    for t in range(n):
        window_probs = inf.predict_tile(sd, t)[1]
        dense_probs = inf.predict_tile_dense(sd, t, block=512, halo=40)[1]
        pairs = [(got["pass1"][t], want["pass"][0][t], window_probs),
                 (got["pass2"][t], want["pass"][1][t], window_probs),
                 (got["window"][t], want["window"][t], window_probs),
                 (got["dense"][t], want["dense"][t], dense_probs)]
        for a, b, probs in pairs:
            assert a.shape == b.shape == TINY_SIZES[t]
            ok, differ = _tie_free_differences(a, b, probs)
            assert ok, (t, differ)
    # The maps compared are not constant.
    for key in ("pass1", "dense"):
        assert len(np.unique(np.concatenate([p.ravel() for p in got[key]]))) > 1, key


def test_sweep_dense_agreements_match_the_script(monkeypatch):
    argv = ["--size", "64", "--blocks", "16,32"]
    script = _script("sweep_dense")
    _narrow(monkeypatch, script, jax_config)
    want_text = _run_script(script, argv)
    want = {(m.group(1), int(m.group(2))): float(m.group(3)) for m in re.finditer(
        r"^(float32|bfloat16) block=(\d+) .* agree\(ref\)=([0-9.]+)", want_text, re.M)}
    assert len(want) == 4

    # The script initialises each dtype's net from key 0: the same params.
    inits = [_numpy_tree(build_model(script.ModelConfig(
        net_type="dilated_icpr_rate6", num_classes=6, compute_dtype=d)).init(
        jax.random.key(0), jnp.zeros((1, 25, 25, 3)))) for d in ("float32", "bfloat16")]
    jax.tree.map(np.testing.assert_array_equal, inits[0], inits[1])

    _narrow(monkeypatch, sweep_dense, port_config)
    out = io.StringIO()
    with redirect_stdout(out):
        got = sweep_dense.run(sweep_dense.parse_args(argv + ["--device", "cpu"]),
                              variables=inits[0])
    assert got.keys() == want.keys()
    for key in want:
        assert abs(got[key] - want[key]) <= 1e-3, (key, got[key], want[key])
    _assert_prints_the_scripts_labels(out.getvalue(), want_text)


# --------------------------------------------------------------------- #
# the entry points
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name, argv, printed", [
    ("stress_scale", ["--tiles", "2", "--size", "130", "--iters", "56"],
     ["  iter 56/56 scale=", "loss by chunk: 7 chunks of 8 steps, all finite: True",
      "K2 launches: 0 (gathers 72", "validate_test[window] 2x130^2:",
      "K2 real batch B=8 s=13 on the 2-tile stack", "final host RSS"]),
    ("profile_multitile", ["--scales", "9,13", "--window_batch", "64"],
     ["window e2e pass2(warm, incl upload):", "pass2 labels == pass1 labels: True",
      "dense warm device-resident:"]),
    ("sweep_dense", ["--size", "48", "--blocks", "16,24"],
     ["float32 block=16 (ext=96, halo-ovh x36.00):", "bfloat16 block=24 (ext=104"]),
])
def test_main_runs_on_the_cpu(monkeypatch, name, argv, printed):
    """Each probe's main, --device cpu, at a tiny size on the width-0.125
    net, exits 0 and prints its lines."""
    probe = {"stress_scale": stress_scale, "profile_multitile": profile_multitile,
             "sweep_dense": sweep_dense}[name]
    _narrow(monkeypatch, probe, port_config, small_run=name == "stress_scale")
    monkeypatch.setattr(profile_multitile, "SIZES", TINY_SIZES)
    out = io.StringIO()
    with redirect_stdout(out):
        assert probe.main(argv + ["--device", "cpu"]) == 0
    text = out.getvalue()
    for line in printed:
        assert line in text, line


def test_without_a_card_the_default_exits_non_zero():
    """python -m dynseg_torch.probes.<name> with the default --device cuda
    exits non-zero at once where no card is visible, and never falls back
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    procs = [subprocess.Popen([sys.executable, "-m", f"dynseg_torch.probes.{name}"],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for name in ("stress_scale", "profile_multitile", "sweep_dense")]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode != 0
        assert "no CUDA card is visible" in err and "platform" not in out
