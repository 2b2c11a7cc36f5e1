"""Whole runs of tiny cells on the CPU, everything but the look for a
card: a cell added as new files and BENCHMARK.json entries only is found
and run; the comparison passes on the port as it is and fails when a
layer of the timed path is broken underneath; the control fails it."""

import json
import subprocess
import sys

import pytest
import torch

import tiny
from portbench import control
from portbench.run import Run, run_cell

SEED = 2 ** 31 + 11


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tiny.make_root(tmp_path_factory.mktemp("bench"))
    # A per-layer metric added as a file of its own and an entry.
    (r / "portbench" / "metrics" / "tiny.tiles.py").write_text(
        "def read(r):\n    return float(len(r.window.get('tiles', []))) or None\n")
    bench = json.loads((r / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "tiny.tiles", "unit": "tiles", "better": "higher",
                               "source": "program_counter", "layer": "estimator",
                               "moves": "segment_Mpx_s",
                               "workloads": ["tiny_rate6.tiny_window"]})
    (r / "BENCHMARK.json").write_text(json.dumps(bench))
    return r


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_added_cell_runs_and_compares(root, cell):
    res = run_cell(root, cell, SEED, 1.0, False, "cpu")
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    e2e = "train_Mpx_s" if "train" in cell else "segment_Mpx_s"
    assert set(res["metrics"]) == {e2e, "setup_s"}
    assert list(res)[-1] == "checks"


def test_added_metric_is_read(root):
    res = run_cell(root, "tiny_rate6.tiny_window", SEED, 1.0, True, "cpu")
    assert res["metrics"]["tiny.tiles"]["value"] >= 1


def _half_gather(real):
    def gather(images, masks, mean, std, pos, aug, size):
        n = max(1, pos.shape[0] // 2)
        return real(images, masks, mean, std, pos[:n], aug[:n], size)
    return gather


def _altered_gather(real):
    def gather(*args):
        imgs, labs = real(*args)
        labs = labs.clone()
        labs[0] = torch.where(labs[0] == 255, labs[0], (labs[0] + 1) % 6)
        return imgs, labs
    return gather


def _half_probs(real):
    def split(self, variables, tile, origins, size, full):
        p = real(self, variables, tile, origins, size, full).clone()
        p[len(p) // 2:] = 0.0
        return p
    return split


def _altered_labels(real):
    def finish(pred, prob, cnt, return_probs):
        out, probs = real(pred, prob, cnt, return_probs)
        out[:8, :8] = (out[:8, :8] + 1) % 6
        return out, probs
    return finish


def _faults(monkeypatch, cell, fault):
    import dynseg_torch.infer as infer
    import dynseg_torch.train as train

    if fault == "unchanged":
        monkeypatch.setattr(torch.optim.SGD, "step", lambda self, closure=None: None)
    elif fault == "half_batch" and "train" in cell:
        monkeypatch.setattr(train, "gather_batch", _half_gather(train.gather_batch))
    elif fault == "altered" and "train" in cell:
        monkeypatch.setattr(train, "gather_batch", _altered_gather(train.gather_batch))
    elif fault == "half_batch":
        monkeypatch.setattr(infer.Inferencer, "_split_probs",
                            _half_probs(infer.Inferencer._split_probs))
    elif fault == "altered":
        monkeypatch.setattr(infer.Inferencer, "_finish",
                            staticmethod(_altered_labels(infer.Inferencer._finish)))


FAULTS = [(c, f) for c in sorted(tiny.CELLS) for f in ("half_batch", "altered")] + \
    [("tiny_rate6.tiny_train", "unchanged")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_broken_path_is_not_correct(root, monkeypatch, cell, fault):
    _faults(monkeypatch, cell, fault)
    res = run_cell(root, cell, SEED, 0.5, False, "cpu")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_control_is_not_correct(root, cell):
    r = Run(root, cell, SEED, 0.0, False, "cpu")
    for variant, numbers in control.readings(r).items():
        assert any(numbers[k] > lim for k, lim in r.limits.items()), (variant, numbers)


def test_no_card_no_result(tmp_path):
    """Where torch sees no card, the benchmark exits non-zero and prints no
    result."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible here")
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                           "icpr_rate6-vaihingen.train", "--seed", "1", "--seconds", "1"],
                          capture_output=True, text=True, cwd=tiny.REPO)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
