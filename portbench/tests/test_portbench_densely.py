"""The densely connected net's configuration and cell
(icpr_rate6_densely-vaihingen.segment_dense_int8) and its per-layer metric
segment.k5_wgmma: the configuration as `Run` loads it, and the metric on
the tiny dense-wired CPU cell, where K5's plain CPU op is counted as the
card counts its launches. Marked `gpu`: a short run of the cell on the
card, which must come out correct, read every K5 launch as wgmma, and
whose control must not."""

import json

import pytest

import tiny
from portbench import control, counts
from portbench.run import Run, run_cell

CELL = "icpr_rate6_densely-vaihingen.segment_dense_int8"
TINY = "tiny_densely.tiny_dense"
SEED = 2 ** 31 + 11


def test_configuration_is_the_dense_wired_net_at_full_width():
    r = Run(tiny.REPO, CELL, SEED, 0.0, False, "cpu")
    n = r.net
    assert r.cell["traffic"] == "segment_dense_int8" and r.cell["chips"] == 1
    assert r.config["model"]["net_type"] == "dilated_icpr_rate6_densely"
    assert n == counts.checked_net(r.config["model"])
    assert [b.cin for b in n.blocks] == [3, 67, 131, 259, 387, 643]
    assert [b.cout for b in n.blocks] == [64, 64, 128, 128, 256, 256]
    assert n.head_cin == 896 and counts.macs_per_px(n) == 3_289_216
    assert counts.quantized(n, r.mix["quant_min_ch"]) == [False, False] + [True] * 4
    assert r.config["reduced"] == [] and set(r.limits) == {"label_gap_mean"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny roots, with the tiny dense-wired cell among the cells that
    report segment.k5_wgmma."""
    r = tiny.make_root(tmp_path_factory.mktemp("bench"))
    bench = json.loads((r / "BENCHMARK.json").read_text())
    metric = next(m for m in bench["per_layer"] if m["name"] == "segment.k5_wgmma")
    metric["workloads"].append(TINY)
    (r / "BENCHMARK.json").write_text(json.dumps(bench))
    return r


@pytest.fixture
def counted(monkeypatch):
    """K5's op on the CPU, counted as its launch on the card counts it."""
    from dynseg_torch.ops import int8_conv

    real = int8_conv._op

    def op(x, w, a, b, k, dilation, pad, leaky_slope, store, inv_scale, variant):
        int8_conv.launches += 1
        int8_conv.variant_launches[int8_conv.VARIANTS[variant]] += 1
        return real(x, w, a, b, k, dilation, pad, leaky_slope, store, inv_scale, variant)

    monkeypatch.setattr(int8_conv, "_op", op)
    yield int8_conv
    int8_conv.reset_launches()


@pytest.mark.parametrize("fault", [False, True], ids=["aligned", "no_lead"])
def test_tiny_dense_cell_reads_k5_wgmma(root, counted, monkeypatch, fault):
    """At width 0.125 the int8 blocks' inputs (19, 35, 51, 83 channels)
    become 16-aligned prefixes behind the 13 lead channels: every launch
    wgmma. A fault that drops the lead sends every block to dp4a: the
    metric reads 0 and the answer is the same, so still correct."""
    if fault:
        from dynseg_torch.ops import quant

        monkeypatch.setattr(quant, "dense_lead", lambda bands: 0)
    res = run_cell(root, TINY, SEED, 0.5, True, "cpu")
    assert res["correct"], res["checks"]
    assert counted.launches > 0
    assert res["metrics"]["segment.k5_wgmma"]["value"] == (0.0 if fault else 100.0)


def test_k5_wgmma_reads_nothing_where_the_counts_disagree(root, counted, monkeypatch):
    from portbench.run import load_module

    reader = load_module(root / "portbench" / "metrics" / "segment.k5_wgmma.py",
                         "portbench_metric_segment_k5_wgmma")
    r = Run(root, TINY, SEED, 0.0, True, "cpu")
    assert reader.read(r) is None  # no traced tile
    counted.variant_launches["wgmma"] = 4
    r.program["k5_launches"] = 4
    assert reader.read(r) == 100.0
    r.program["k5_launches"] = 5
    assert reader.read(r) is None


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return "cuda"


@pytest.mark.gpu
def test_cell_is_correct_on_the_card_with_every_k5_launch_wgmma(card):
    res = run_cell(tiny.REPO, CELL, 2 ** 31 + 3, 3.0, True, card)
    assert res["correct"], res["checks"]
    assert res["metrics"]["segment.k5_wgmma"]["value"] == 100.0


@pytest.mark.gpu
def test_control_fails_on_the_card(card):
    r = Run(tiny.REPO, CELL, 2 ** 31 + 4, 0.0, False, card)
    for variant, numbers in control.readings(r).items():
        assert any(numbers[k] > lim for k, lim in r.limits.items()), (variant, numbers)
