"""Inference split across data-parallel ranks, the command line under
--num_devices, and the profiling utilities of the port.

Two CPU ranks over gloo (`parallel.spawn`) predict with width-0.125 nets
on small synthetic tiles, held to the JAX package's Inferencer on a
2-device mesh (of the 8 virtual CPU devices of tests/conftest.py) and to
the port's single-device Inferencer at the tolerances of
tests/test_infer.py: labels equal but at ties, probabilities within 1e-5.
The command-line runs train the full-width net on 48^2 tiles for a few
iterations."""

import dataclasses
import os
import signal
import subprocess
import sys
import time

import jax
import jax.sharding as shd
import numpy as np
import pytest
import torch
from PIL import Image

import dynseg.infer as jax_infer
import dynseg.utils.profiling as ref_profiling
from dynseg.config import Config, InferConfig, ModelConfig
from dynseg.data.datasets import load_synthetic
from dynseg_torch import cli
from dynseg_torch import config as port_config
from dynseg_torch import parallel
from dynseg_torch.bridge import flax_to_torch, init_variables_np
from dynseg_torch.data import tiles as port_tiles
from dynseg_torch.probes import dp_parity
from dynseg_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port(obj):
    mod = port_tiles if type(obj).__name__ == "TileSet" else port_config
    vals = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    return getattr(mod, type(obj).__name__)(**{
        k: _port(v) if dataclasses.is_dataclass(v) else v for k, v in vals.items()})


def _cfg(mode, quant="none", **infer_kw) -> Config:
    return Config(
        model=ModelConfig(net_type="dilated_icpr_rate6", num_classes=2,
                          num_input_bands=3, width_multiplier=0.125),
        infer=InferConfig(scales=(9, 13), mode=mode, quant=quant, quant_min_ch=16,
                          window_batch=17, dense_block=16, dense_halo=40,
                          window_fold="off", save_prediction_maps=False, **infer_kw))


# Window float (17 windows a batch: 16 under 2 ranks), dense float and
# dense int8 (3 x 3 blocks of 16: one group of 2 x 5, the last a copy).
CASES = {"window": _cfg("window"), "dense": _cfg("dense"),
         "dense_int8": _cfg("dense", "int8")}


@pytest.fixture(scope="module")
def tiles():
    return load_synthetic(seed=0, num_tiles=2, size=48)[1]


def _centred(cfg, tiles) -> dict:
    """Seeded weights with non-trivial BN statistics, and a head bias that
    centres the single-device prediction of `tiles` in cfg's mode, so that
    both classes are predicted and the label maps compared mean something
    (the head bias feeds neither calibration nor quantization)."""
    v = init_variables_np(_port(cfg.model), num_input_bands=3, seed=5)
    rng = np.random.default_rng(6)
    for block in v["batch_stats"].values():
        bn = block["BatchNorm_0"]
        bn["mean"] = rng.normal(scale=0.2, size=bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    prob = dp_parity.predict(_port(cfg), _port(tiles), flax_to_torch(v))["probs"][0]
    head = v["params"]["ScoreHead_0"]["Conv_0"]
    head["bias"][1] -= np.median(np.log(prob[..., 1] / prob[..., 0]))
    return v


@pytest.fixture(scope="module")
def variables(tiles):
    return {name: _centred(c, tiles) for name, c in CASES.items()}


@pytest.fixture(scope="module")
def split(tiles, variables):
    """Each case predicted by two gloo ranks in one launch, and by one
    device in this process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    pt = _port(tiles)
    calls = [(_port(c), pt, flax_to_torch(variables[n])) for n, c in CASES.items()]
    ranks = parallel.spawn(dp_parity.run_many, 2, ["cpu", "cpu"], threads=2, args=(
        [(dp_parity.predict, args) for args in calls],))
    one = [dp_parity.predict(*args) for args in calls]
    yield {name: {"ranks": [r[i] for r in ranks], "one": one[i]}
           for i, name in enumerate(CASES)}
    torch.set_num_threads(threads)


def _assert_labels_and_probs(pred, prob, pred_ref, prob_ref, atol=1e-5):
    """Labels equal except at ties of the reference; probabilities within
    atol. Returns the number of labels that differ."""
    np.testing.assert_allclose(prob, prob_ref, rtol=0, atol=atol)
    differ = pred != pred_ref
    top2 = np.sort(prob_ref, axis=-1)[..., -2:]
    assert np.all(top2[differ, 1] - top2[differ, 0] < 1e-5)
    return int(differ.sum())


def _jax_mesh(cfg, tiles, variables):
    """The reference's Inferencer on a 2-device mesh: labels and probs of
    every tile."""
    mesh = shd.Mesh(np.array(jax.devices()[:2]), ("data",))
    inf = jax_infer.Inferencer(cfg, tiles, mesh=mesh)
    v = inf.enable_quant(variables)
    out = []
    for t in range(tiles.num_tiles):
        if cfg.infer.mode == "dense":
            out.append(inf.predict_tile_dense(v, t, block=cfg.infer.dense_block,
                                              halo=cfg.infer.dense_halo))
        else:
            out.append(inf.predict_tile(v, t))
    return out


# --------------------------------------------------------------------- #
# split inference
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("case", ["window", "dense"])
def test_split_float_inference_matches_one_device_and_reference_mesh(
        tiles, variables, split, case):
    """Both ranks hold the single-device maps and the reference mesh's."""
    res = split[case]
    want = _jax_mesh(CASES[case], tiles, variables[case])
    for r in res["ranks"]:
        for t in range(tiles.num_tiles):
            _assert_labels_and_probs(r["labels"][t], r["probs"][t],
                                     res["one"]["labels"][t], res["one"]["probs"][t])
            _assert_labels_and_probs(r["labels"][t], r["probs"][t], *want[t])
    assert 0.1 < res["one"]["labels"][0].mean() < 0.9  # both classes predicted


def test_split_int8_inference_matches_one_device_and_reference_mesh(
        tiles, variables, split):
    """Dense int8: the calibration runs replicated, so each rank's
    quantized state_dict is bitwise the single-device one; the maps are
    the single device's, and agree with the reference mesh's int8 labels
    as closely as the single-device port does (tests/test_torch_infer.py)."""
    res = split["dense_int8"]
    one = res["one"]
    assert any(k.endswith(".w_scale") for k in one["qvars"])
    want = _jax_mesh(CASES["dense_int8"], tiles, variables["dense_int8"])
    for r in res["ranks"]:
        assert r["qvars"].keys() == one["qvars"].keys()
        for k, v in one["qvars"].items():
            np.testing.assert_array_equal(r["qvars"][k], v, err_msg=k)
        for t in range(tiles.num_tiles):
            _assert_labels_and_probs(r["labels"][t], r["probs"][t],
                                     one["labels"][t], one["probs"][t])
            assert np.mean(r["labels"][t] == want[t][0]) >= 0.995
    assert 0.1 < one["labels"][0].mean() < 0.9


def test_each_rank_runs_its_share_of_the_forwards(tiles, split):
    """Window mode: every window batch is one forward on each rank, so
    each rank runs as many forwards as one device, of half the windows
    (17 -> 16 a batch); dense mode: groups of 2 x 5 blocks (9 blocks a
    tile: one group)."""
    for case in CASES:
        one, ranks = split[case]["one"], split[case]["ranks"]
        assert ranks[0]["forwards"] == ranks[1]["forwards"]
        if case.startswith("dense"):
            assert one["forwards"] == 2 * tiles.num_tiles  # groups of 8 and 1
            assert ranks[0]["forwards"] == tiles.num_tiles
        else:
            assert ranks[0]["forwards"] >= one["forwards"]
        assert ranks[0]["k5"] == 0  # the plain versions run on the CPU


def test_window_batch_rounds_to_the_ranks(tiles):
    """B rounds down to a multiple of n, at least one window a rank."""
    from dynseg_torch.infer import Inferencer

    for b, n, want in ((17, 2, 16), (1, 2, 2), (128, 3, 126), (5, 1, 5)):
        cfg = _port(dataclasses.replace(CASES["window"], infer=dataclasses.replace(
            CASES["window"].infer, window_batch=b)))
        inf = Inferencer(cfg, _port(tiles), "cpu", world=parallel.World(0, n))
        assert inf._window_batch() == want


# --------------------------------------------------------------------- #
# the command line
# --------------------------------------------------------------------- #
DATA = ["--dataset", "synthetic", "--dataset_kwargs", '{"size": 48}',
        "--values", "9,13", "--window_batch", "64", "--device", "cpu"]

# Makes the JAX package absent in every process of a command, the ranks
# the launcher spawns included (they inherit PYTHONPATH).
ABSENT = """import importlib.abc, sys
class Absent(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('dynseg', 'jax', 'flax', 'optax'):
            raise ModuleNotFoundError(f'No module named {name!r}', name=name)
        return None
sys.meta_path.insert(0, Absent())
"""


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """`python -m dynseg_torch --operation training --num_devices 2
    --device cpu` in a subprocess whose processes cannot import the JAX
    package."""
    base = tmp_path_factory.mktemp("dp_cli")
    site = base / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(ABSENT)
    out = base / "run"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(site), ROOT]))
    res = subprocess.run(
        [sys.executable, "-m", "dynseg_torch", "--operation", "training",
         "--num_devices", "2", "--niter", "6", "--batch_size", "8",
         "--eval_every", "3", "--checkpoint_every", "3", "--output_path", str(out),
         *DATA], capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    return out, res


def test_cli_training_on_two_ranks_reaches_total_with_rank_zero_the_only_writer(trained):
    out, res = trained
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    assert sum(line.startswith("TOTAL: OA=") for line in lines) == 1
    assert sum(line.startswith("training on cpu") for line in lines) == 1
    assert "No module named" not in res.stderr
    assert sorted(os.listdir(out / "checkpoints")) == [
        "3", "6", "best", "best.json", "stats.json"]
    with open(out / "metrics.jsonl") as f:
        msgs = [line for line in f if '"TOTAL: OA=' in line]
    assert len(msgs) == 1  # one writer of the log
    assert sorted(f for f in os.listdir(out) if f.endswith(".png")) == [
        "prediction_0.png", "prediction_1.png"]
    assert not [f for f in os.listdir(out / "checkpoints") if f.startswith(".tmp")]


def _maps(out):
    return [np.asarray(Image.open(out / f"prediction_{t}.png")) for t in (0, 1)]


def _served_probs(out, argv):
    """The single-device probabilities of the test tiles from the run's
    checkpoint, as testing serves it."""
    from dynseg_torch.checkpoint import CheckpointManager
    from dynseg_torch.data.datasets import load_dataset
    from dynseg_torch.infer import Inferencer
    from dynseg_torch.train import init_state_template

    cfg = cli.config_from_args(cli.build_argparser().parse_args(argv))
    mgr = CheckpointManager(str(out))
    stats = mgr.load_stats()
    cfg = cli._adopt_checkpoint_model(cfg, stats)
    st, _ = mgr.restore_state(init_state_template(cfg, "cpu"))
    sd = cli._serving_variables(cfg, st, stats, None, lambda *_: None)
    _, test = load_dataset("synthetic", "", 0, test_only=True, **cli._loader_kwargs(cfg))
    test.mean = np.asarray(stats["mean"], np.float32)
    test.std = np.asarray(stats["std"], np.float32)
    inf = Inferencer(cfg, test, "cpu")
    return [inf.predict_tile(sd, t)[1] for t in range(test.num_tiles)]


def test_cli_testing_on_two_ranks_matches_one(trained, tmp_path):
    """testing at 2 ranks and at 1 on the trained checkpoint: the same
    maps but at counted ties (pixels whose two best probabilities of the
    single-device run are within 1e-5), and the same scores when none
    differs; --profile_dir gets one trace per rank."""
    import json
    import shutil

    out, res = trained
    assert res.returncode == 0, res.stderr[-3000:]
    one, two = tmp_path / "one", tmp_path / "two"
    shutil.copytree(out, one)
    shutil.copytree(out, two)
    argv = ["--operation", "testing", "--output_path", str(one), *DATA]
    assert cli.main(argv) == 0
    assert cli.main(["--operation", "testing", "--num_devices", "2",
                     "--profile_dir", str(tmp_path / "prof"),
                     "--output_path", str(two), *DATA]) == 0
    assert sorted(os.listdir(tmp_path / "prof")) == ["trace.rank0.json",
                                                     "trace.rank1.json"]
    probs = _served_probs(one, argv)
    differ = ties = 0
    for a, b, p in zip(_maps(one), _maps(two), probs):
        moved = np.any(a != b, axis=-1)
        top2 = np.sort(p, axis=-1)[..., -2:]
        tie = top2[..., 1] - top2[..., 0] < 1e-5
        assert not np.any(moved & ~tie)
        differ += int(moved.sum())
        ties += int(tie.sum())
    print(f"labels differing: {differ} of {ties} ties")
    if differ == 0:
        s1, s2 = (json.load(open(d / "scores.json")) for d in (one, two))
        for k in ("oa", "kappa", "mean_f1", "f1"):
            assert s1[k] == s2[k], k


def test_cli_stops_when_a_rank_raises(tmp_path, monkeypatch):
    """Rank 1 is handed a device it cannot train on and raises; rank 0,
    waiting in a collective, is stopped, and the command exits non-zero
    long before the group's timeout."""
    monkeypatch.setattr(parallel, "check_devices", lambda n, device: ["cpu", "meta"])
    t0 = time.perf_counter()
    with pytest.raises(SystemExit) as e:
        cli.main(["--operation", "training", "--num_devices", "2", "--niter", "4",
                  "--batch_size", "8", "--output_path", str(tmp_path), *DATA])
    assert e.value.code not in (0, None)
    assert "a rank of --num_devices 2 failed" in str(e.value.code)
    # Rank 1's error, or rank 0's from the collective rank 1 left, whichever
    # the launcher saw first.
    assert "terminated with the following error" in str(e.value.code)
    assert time.perf_counter() - t0 < 120


def test_sigterm_to_the_launcher_stops_every_rank_at_one_step(tmp_path):
    """SIGTERM to the command once training runs: the launcher passes it
    to both ranks, they agree to stop at the same step boundary, rank 0
    checkpoints that iteration, and the command exits 0 (ranks stopping
    at different steps would leave one waiting in a collective)."""
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynseg_torch", "--operation", "training",
         "--num_devices", "2", "--niter", "100000", "--batch_size", "8",
         "--eval_every", "2", "--checkpoint_every", "0", "--output_path",
         str(tmp_path), *DATA], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True, env=env, cwd=ROOT)
    lines = []
    for line in proc.stdout:
        lines.append(line)
        if line.startswith("[val @ iter 4]"):
            proc.send_signal(signal.SIGTERM)
            break
    out, _ = proc.communicate(timeout=120)
    lines += out.splitlines()
    assert proc.returncode == 0, lines[-20:]
    stops = [line for line in lines if "received: checkpointed at iteration" in line]
    assert len(stops) == 1, lines[-20:]
    it = int(stops[0].split("iteration ")[1].split(",")[0])
    assert it >= 4 and any(f"preempted at iteration {it}/" in line for line in lines)
    from dynseg_torch.checkpoint import CheckpointManager

    assert CheckpointManager(str(tmp_path)).all_steps() == [it]
    assert not any(line.startswith("TOTAL") for line in lines)


def test_cli_refuses_more_ranks_than_cards(tmp_path):
    """--num_devices beyond the visible cards exits non-zero with the
    over-commit message before any rank starts."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-m", "dynseg_torch", "--operation",
                          "training", "--num_devices", "2", "--output_path",
                          str(tmp_path)], capture_output=True, text=True, env=env,
                         timeout=120, cwd=ROOT)
    assert res.returncode != 0
    assert "--num_devices 2 requested but only 0 CUDA device(s) are visible" in res.stderr
    assert not os.path.exists(tmp_path / "checkpoints")


def test_other_operations_run_on_one_device(trained, monkeypatch, capsys):
    """As in the reference, --num_devices leaves info (and predict, export,
    serve) on one device: no rank is launched."""
    out, _ = trained
    called = []
    monkeypatch.setattr(parallel, "spawn", lambda *a, **k: called.append(a))
    assert cli.main(["--operation", "info", "--num_devices", "2",
                     "--output_path", str(out)]) == 0
    assert not called and "iteration: 6" in capsys.readouterr().out


# --------------------------------------------------------------------- #
# profiling
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("where", [None, ""])
def test_trace_is_a_no_op_without_a_directory(where, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for mod in (ref_profiling, profiling):
        with mod.trace(where):
            torch.ones(3).sum()
    assert os.listdir(tmp_path) == []


def test_trace_writes_a_chrome_trace_named_by_rank(tmp_path, monkeypatch):
    """One process: trace.json; rank 1 of a group: trace.rank1.json."""
    with profiling.trace(str(tmp_path / "a")):
        torch.ones(64).cumsum(0)
    monkeypatch.setattr(parallel, "_WORLD", parallel.World(1, 2, "cpu", "gloo"))
    with profiling.trace(str(tmp_path / "b")):
        torch.ones(64).cumsum(0)
    for path in (tmp_path / "a" / "trace.json", tmp_path / "b" / "trace.rank1.json"):
        with open(path) as f:
            assert '"traceEvents"' in f.read()
    assert os.listdir(tmp_path / "b") == ["trace.rank1.json"]
