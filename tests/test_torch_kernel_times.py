"""The kernel timing probe (`python -m dynseg_torch.probes.kernel_times`)
on the CPU: each row's bound is the bound PERF.md §6's kernel table
gives its shape, and the probe refuses to run without a card; the
probes' `--root` import takes the package found in the directory given."""

import os
import subprocess
import sys

import pytest
import torch

from dynseg_torch.probes import kernel_times

# Each row's bound in ms, as PERF.md §6 prints it.
BOUNDS = {
    "K5 block3 128->128 k4 d4 int8 out x(8,336,336,128)": "0.2393",
    "K5 block4 128->256 k3 d5 int8 out x(8,336,336,128)": "0.2692",
    "K5 block5 256->256 k3 d6 float32 out x(8,336,336,256)": "0.5384",
    "K5 block3 128->128 k4 d4 bfloat16 out x(8,336,336,128)": "0.2393",
    "K5 block4 128->256 k3 d5 bfloat16 out x(8,336,336,128)": "0.2692",
    "K5 block5 256->256 k3 d6 bfloat16 out x(8,336,336,256)": "0.5384",
    "K6 block0 f32 x(8,336,336,64)": "0.1380",
    "K6 block1 f32 x(8,336,336,64)": "0.1380",
    "K6 block2 f32_i8 x(8,336,336,128)": "0.1725",
    "K6 block3 i8 x(8,336,336,128)": "0.0690",
    "K6 block4 i8 x(8,336,336,192)": "0.1035",
    "K6 block5 f32 x(8,336,336,192)": "0.4141",
    "K7 float32 C 144 of 912 x(8,336,336)": "0.1941",
    "K7 float32 C 272 of 912 x(8,336,336)": "0.3667",
    "K7 float32 C 400 of 912 x(8,336,336)": "0.5392",
    "K7 float32 C 656 of 912 x(8,336,336)": "0.8843",
    "K7 bfloat16 C 144 of 912 x(8,336,336)": "0.1165",
    "K7 bfloat16 C 272 of 912 x(8,336,336)": "0.2200",
    "K7 bfloat16 C 400 of 912 x(8,336,336)": "0.3235",
    "K7 bfloat16 C 656 of 912 x(8,336,336)": "0.5306",
    "K2 B=100 s=25 uint8": "0.00045",
    "K2 B=100 s=35 uint8": "0.00088",
    "K2 B=100 s=45 uint8": "0.00145",
    "K2 B=100 s=55 uint8": "0.00217",
    "K2 B=100 s=65 uint8": "0.00303",
    "K4 x(100,25,25,64) window 3": "0.0191",
    "K4 x(100,25,25,128) window 3": "0.0382",
    "K4 x(100,25,25,256) window 3": "0.0764",
    "K4 x(100,65,65,64) window 3": "0.1291",
    "K4 x(100,65,65,128) window 3": "0.2583",
    "K4 x(100,65,65,256) window 3": "0.5166",
    "P1 x(8,592,592,256) d6": "1.6712",
}
# The sums the table gives: K6 over the six pools, K7 over the prefixes.
SUMS = {"K6 ": "1.0353", "K7 float32": "1.9843", "K7 bfloat16": "1.1906"}


def _printed(value: float, like: str) -> str:
    return f"{value:.{len(like.split('.')[1])}f}"


@pytest.mark.parametrize("row", kernel_times.ROWS, ids=lambda r: r.name)
def test_row_bound_is_the_kernel_tables(row):
    bound, by = row.bound()
    want = BOUNDS[row.name]
    assert _printed(bound, want) == want
    assert by == ("operations" if row.name[:2] in ("K5", "P1") else "bytes")


@pytest.mark.parametrize("prefix", sorted(SUMS))
def test_summed_bounds_are_the_kernel_tables(prefix):
    rows = [r for r in kernel_times.ROWS if r.name.startswith(prefix)]
    assert len(rows) in (4, 6)
    assert _printed(sum(r.bound()[0] for r in rows), SUMS[prefix]) == SUMS[prefix]


def test_every_row_of_the_table_is_timed():
    assert [r.name for r in kernel_times.ROWS] == list(BOUNDS)


def test_exits_non_zero_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kernel_times.main(["--reps", "1"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("has_package", [True, False], ids=["package", "empty"])
def test_import_from_takes_roots_package_in_place_of_the_imported_one(tmp_path, has_package):
    """With dynseg_torch already imported from this checkout, import_from
    re-imports it from `root`; a root without the package exits, naming
    where it came from instead."""
    if has_package:
        (tmp_path / "dynseg_torch").mkdir()
        (tmp_path / "dynseg_torch" / "__init__.py").write_text("MARK = 'other'\n")
    code = ("import sys, dynseg_torch\n"
            "from dynseg_torch.probes import import_from\n"
            "print(import_from(sys.argv[1]))\n"
            "import dynseg_torch\n"
            "print(dynseg_torch.MARK)\n")
    run = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    if has_package:
        assert run.returncode == 0, run.stderr
        assert run.stdout.split() == [str(tmp_path), "other"]
    else:
        assert run.returncode == 1
        assert f"dynseg_torch was imported from {REPO}" in run.stderr
