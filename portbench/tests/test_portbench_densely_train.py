"""The densely net's training cell (icpr_rate6_densely-potsdam.train) and
the fixed 25 px training cell (icpr_rate6-vaihingen.train_fixed25): the
configuration and the mix as `Run` loads them. Marked `gpu`: a short run
of each cell on the card, which must come out correct, and its control,
which must not."""

import json

import pytest

from portbench import control, counts
from portbench.run import Run, run_cell
from tiny import REPO

DENSELY = "icpr_rate6_densely-potsdam.train"
FIXED25 = "icpr_rate6-vaihingen.train_fixed25"
SEED = 2 ** 31 + 13


def _config(name):
    return json.loads((REPO / "portbench" / "configs" / f"{name}.json").read_text())


def test_densely_potsdam_is_the_dense_net_on_potsdams_data():
    """The model block is the Vaihingen densely configuration's, the data
    block rate-8 Potsdam's, and only the training tiles are cut."""
    r = Run(REPO, DENSELY, SEED, 0.0, False, "cpu")
    assert r.cell["traffic"] == "train" and r.cell["chips"] == 1
    assert r.config["model"] == _config("icpr_rate6_densely-vaihingen")["model"]
    assert r.config["data"] == _config("grsl_rate8-potsdam")["data"]
    assert r.config["reduced"] == ["train_tiles"]
    assert [b.cin for b in r.net.blocks] == [3, 67, 131, 259, 387, 643]
    assert r.net.head_cin == 896 and counts.macs_per_px(r.net) == 3_289_216
    assert set(r.limits) == {"loss_gap", "grad_gap", "change_gap"}


def test_fixed25_mix_is_the_train_mix_at_one_size():
    r = Run(REPO, FIXED25, SEED, 0.0, False, "cpu")
    train = json.loads((REPO / "portbench" / "mixes" / "train.json").read_text())
    assert r.mix["distribution_type"] == "single_fixed" and r.mix["values"] == [25]
    drop = ("why", "distribution_type", "values")
    assert {k: v for k, v in r.mix.items() if k not in drop} == \
        {k: v for k, v in train.items() if k not in drop}
    assert r.config["name"] == "icpr_rate6-vaihingen"
    assert set(r.limits) == {"loss_gap", "grad_gap", "change_gap"}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [DENSELY, FIXED25])
def test_training_cell_is_correct_on_the_card(card, cell):
    res = run_cell(REPO, cell, SEED, 3.0, False, card)
    assert res["correct"], res["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [DENSELY, FIXED25])
def test_training_control_fails_on_the_card(card, cell):
    r = Run(REPO, cell, SEED + 1, 0.0, False, card)
    for variant, numbers in control.readings(r).items():
        assert any(numbers[k] > lim for k, lim in r.limits.items()), (variant, numbers)
