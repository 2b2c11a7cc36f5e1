"""A benchmark root of tiny cells for the CPU tests: a copy of portbench/
with configurations, mixes and limits of its own, added as new files and
BENCHMARK.json entries only, as a later cell would be. Each tiny
configuration takes its blocks from a configuration file of the repo;
tiny_densely wires icpr_rate6's dense, as dilated_icpr_rate6_densely."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_MODEL = {"num_input_bands": 3, "num_classes": 6, "width_multiplier": 0.125,
              "compute_dtype": "float32", "tf32": False}
TINY_DATA = {"bands": 3, "num_classes": 6, "region_px": 16,
             "rare_classes": {"4": [0.02, 4], "5": [0.02, 8]},
             "band_signatures": [[150, 140, 135], [170, 125, 120], [195, 125, 120],
                                 [180, 95, 100], [110, 105, 110], [90, 80, 70]],
             "noise": 18.0,
             "train_tiles_hw": [[64, 72], [80, 64]], "val_tiles_hw": [[72, 80], [64, 64]]}
MIXES = {
    "tiny_train": ("train", {"values": [9, 13], "batch_size": 8, "trace_seconds": 1}),
    "tiny_dense": ("segment_dense_int8", {"scales": [9, 13], "dense_block": 32,
                                          "quant_min_ch": 16}),
    "tiny_window": ("segment_window_f32", {"scales": [9, 13], "window_batch": 16}),
}
# config -> (net_type, the repo's configuration whose published blocks it
# takes, wiring, multiply-adds of a pixel-forward at TINY_MODEL's width)
NETS = {
    "tiny_rate6": ("dilated_icpr_rate6", "icpr_rate6-vaihingen", "sequential", 22_360),
    "tiny_rate8": ("dilated_grsl_rate8", "grsl_rate8-potsdam", "sequential", 17_128),
    "tiny_densely": ("dilated_icpr_rate6_densely", "icpr_rate6-vaihingen", "dense", 55_888),
}
# cell -> (traffic, the real cell whose metrics it reports, and whose limits
# it keeps where it names none of its own)
CELLS = {
    "tiny_rate6.tiny_train": ("tiny_train", "icpr_rate6-vaihingen.train", None),
    "tiny_rate8.tiny_dense": ("tiny_dense", "grsl_rate8-potsdam.segment_dense_int8", None),
    "tiny_rate6.tiny_window": ("tiny_window", "icpr_rate6-vaihingen.segment_window_f32", None),
    # Read on the CPU over six seeds: the port 0 to 1.0e-8, the TF32
    # control 7.7e-6 to 2.1e-5 (int8 blocks 2-5 leave the control two float
    # blocks and the head to show in): the limit lies between.
    "tiny_densely.tiny_dense": ("tiny_dense", "grsl_rate8-potsdam.segment_dense_int8",
                                {"label_gap_mean": 1e-6}),
}


def make_root(tmp: Path) -> Path:
    """tmp/ holding BENCHMARK.json and portbench/, with the tiny cells."""
    pkg = tmp / "portbench"
    shutil.copytree(REPO / "portbench", pkg, ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, (net, base, wiring, macs) in NETS.items():
        blocks = json.loads((pkg / "configs" / f"{base}.json").read_text())["model"]["blocks"]
        model = dict(TINY_MODEL, net_type=net, blocks=blocks, wiring=wiring, macs_per_px=macs)
        cfg = {"name": name, "model": model, "data": TINY_DATA, "reduced": [], "assumed": []}
        (pkg / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "https://arxiv.org/abs/1804.04020",
                                 "file": f"portbench/configs/{name}.json", "reduced": [],
                                 "why": "a tiny net for the CPU tests"})
    for mix, (base, over) in MIXES.items():
        spec = json.loads((pkg / "mixes" / f"{base}.json").read_text())
        spec.update(over)
        (pkg / "mixes" / f"{mix}.json").write_text(json.dumps(spec))
    for cell, (traffic, real, limits) in CELLS.items():
        bench["workloads"].append({"name": cell, "config": cell.split(".")[0],
                                   "traffic": traffic, "chips": 1, "why": "CPU test"})
        if limits is None:
            shutil.copy(pkg / "limits" / f"{real}.json", pkg / "limits" / f"{cell}.json")
        else:
            (pkg / "limits" / f"{cell}.json").write_text(json.dumps(limits))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real in m.get("workloads", []):
                m["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
