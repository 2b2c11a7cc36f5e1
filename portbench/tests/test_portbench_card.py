"""On the card: a short run of each cell as committed, which must come out
correct, and the control at the cell's own size, which must not. Run there
with `python -m pytest portbench/tests -q -m gpu`."""

import pytest

from portbench import control
from portbench.run import Run, run_cell
from tiny import REPO

CELLS = ["icpr_rate6-vaihingen.train", "grsl_rate8-potsdam.segment_dense_int8",
         "icpr_rate6-vaihingen.segment_window_f32", "grsl_rate8-potsdam.train"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(card, cell):
    res = run_cell(REPO, cell, 2 ** 31 + 3, 3.0, False, card)
    assert res["correct"], res["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(card, cell):
    r = Run(REPO, cell, 2 ** 31 + 4, 0.0, False, card)
    for variant, numbers in control.readings(r).items():
        assert any(numbers[k] > lim for k, lim in r.limits.items()), (variant, numbers)
