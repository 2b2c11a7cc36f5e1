"""Pre-flight dataset-dump validation — `--operation check_data`.

The port's own copy of dynseg/data/check.py (dynseg_torch imports nothing of the
JAX package); tests/test_torch_data.py holds it to the original.

The Coffee/GRSS on-disk layouts in this framework are RECONSTRUCTIONS
(the reference repo and its datasets have never been readable on this
machine — SURVEY.md §0), and even the published ISPRS layouts have many
circulating variants. check_data validates a dump in seconds, without a
device or any training: layout, image/GT pairing, band counts, GT
palette coverage, split membership, and the per-class pixel histogram —
so day-one contact with real data is a one-minute sanity check instead
of a mid-training crash (verdict r2, item #7).

Pure host numpy — no JAX import, runs anywhere.
"""

from __future__ import annotations

import glob
import os
from typing import Callable, Dict, List, Optional

import numpy as np

from dynseg_torch.data.datasets import NUM_CLASSES, load_dataset
from dynseg_torch.data.tiles import IGNORE_LABEL, TileSet

# What each loader expects on disk, for the failure path. Coffee/GRSS
# are flagged speculative (datasets.py _warn_speculative).
EXPECTED_LAYOUTS: Dict[str, str] = {
    "coffee": (
        "{path}/{county}/<img>.{tif|tiff|png|jpg|npy} paired with "
        "<img>_mask.<ext> (binary coffee mask: green channel >127, "
        "grayscale >127, or 0/1 .npy); >=2 county subdirectories; "
        "--fold N holds out the Nth county in sorted order "
        "(5-fold cross-county protocol). LAYOUT IS RECONSTRUCTED — "
        "not verified against the reference distribution."
    ),
    "grss_dfc_2014": (
        "{path}/train_image.* + train_labels.* and test_image.* + "
        "test_labels.* (labels as class-id rasters: 0 = unlabeled, "
        "1..5 = classes; .npy allowed for >3-band imagery). LAYOUT IS "
        "RECONSTRUCTED — not verified against the reference "
        "distribution."
    ),
    "vaihingen": (
        "{path}/top/top_mosaic_09cm_areaNN.tif (IRRG) + "
        "{path}/gts_for_participants/<same filename> (color-coded GT); "
        "published validation areas 11,15,28,30,34 (--val_tiles "
        "overrides); optional {path}/dsm + {path}/ndsm for "
        "--extra_bands dsm,ndsm."
    ),
    "potsdam": (
        "{path}/2_Ortho_RGB/top_potsdam_R_C_RGB.tif (or 3_Ortho_IRRG / "
        "4_Ortho_RGBIR per --bands) + {path}/5_Labels_for_participants/"
        "top_potsdam_R_C_label.tif; optional 1_DSM / "
        "1_DSM_normalisation for --extra_bands. Default validation "
        "split (column 12) is LOW confidence — pass --val_tiles when "
        "the reference split is known."
    ),
}


def _class_histogram(tiles: TileSet, num_classes: int) -> dict:
    """Per-class pixel counts over the VALID region of every tile."""
    counts = np.zeros(num_classes, np.int64)
    ignore = 0
    invalid: dict = {}
    for t in range(tiles.num_tiles):
        h, w = (int(x) for x in tiles.valid_hw[t])
        m = tiles.masks[t, :h, :w]
        ids, n = np.unique(m, return_counts=True)
        for cid, cnt in zip(ids.tolist(), n.tolist()):
            if cid == IGNORE_LABEL:
                ignore += cnt
            elif 0 <= cid < num_classes:
                counts[cid] += cnt
            else:
                invalid[cid] = invalid.get(cid, 0) + cnt
    total = int(counts.sum()) + ignore + sum(invalid.values())
    return {
        "per_class": counts.tolist(),
        "ignore": ignore,
        "ignore_frac": (ignore / total) if total else 0.0,
        "invalid_ids": invalid,
        "total_valid_px": total,
    }


def _isprs_split_membership(dataset: str, path: str, bands: str,
                            val_tiles) -> Optional[dict]:
    """Best-effort: which tile ids the loader will put in train vs
    validation, derived from filenames alone (no decode)."""
    from dynseg_torch.data import datasets as ds

    if dataset == "vaihingen":
        image_dir, tid = "top", ds._vaihingen_area
        default_val = ds.VAIHINGEN_VAL_TILES
    elif dataset == "potsdam":
        image_dir, _ = ds._POTSDAM_BAND_DIRS[bands or "rgb"]
        tid, default_val = ds._potsdam_grid, ds.POTSDAM_VAL_TILES
    else:
        return None
    files = sorted(glob.glob(os.path.join(path, image_dir, "*.tif")))
    ids = [tid(f) for f in files]
    if not ids or all(i is None for i in ids):
        return None
    val = tuple(val_tiles) or default_val
    return {
        "train": sorted(i for i in ids if i and i not in val),
        "validation": sorted(i for i in ids if i in val),
        "unrecognized": sum(1 for i in ids if i is None),
    }


def check_data(dataset: str, path: str, fold: int = 0,
               loader_kwargs: Optional[dict] = None,
               expected_bands: int = 0, max_scale: int = 0,
               log: Callable[[str], None] = print) -> dict:
    """Validate a dataset dump. Returns a report dict with
    ok / errors / warnings / info; logs a human-readable account and a
    final PASS/FAIL line."""
    errors: List[str] = []
    warnings: List[str] = []
    info: dict = {"dataset": dataset, "path": path, "fold": fold}
    kwargs = dict(loader_kwargs or {})
    num_classes = NUM_CLASSES[dataset]

    log(f"check_data: dataset={dataset} path={path or '<generated>'} "
        f"fold={fold}")
    if dataset in EXPECTED_LAYOUTS:
        log(f"expected layout: {EXPECTED_LAYOUTS[dataset]}")

    try:
        train, test = load_dataset(dataset, path=path, fold=fold, **kwargs)
    except Exception as e:  # noqa: BLE001 — the whole point is a clean FAIL
        errors.append(f"{type(e).__name__}: {e}")
        log(f"LOAD FAILED — {errors[-1]}")
        if dataset in EXPECTED_LAYOUTS:
            log("fix the dump to match the expected layout above (or, for "
                "the RECONSTRUCTED coffee/grss layouts, adapt "
                "dynseg/data/datasets.py to the real one and update "
                "EXPECTED_LAYOUTS)")
        log("CHECK FAILED")
        return {"ok": False, "errors": errors, "warnings": warnings,
                "info": info}

    for split, tiles in (("train", train), ("test", test)):
        if tiles is None:
            continue
        sizes = [tuple(int(x) for x in hw) for hw in tiles.valid_hw]
        info[f"{split}_tiles"] = tiles.num_tiles
        info[f"{split}_bands"] = tiles.num_bands
        info[f"{split}_sizes"] = sizes[:16]
        hist = _class_histogram(tiles, num_classes)
        info[f"{split}_hist"] = hist
        log(f"{split}: {tiles.num_tiles} tiles, {tiles.num_bands} bands, "
            f"sizes {sorted(set(sizes))[:8]}")
        log(f"{split}: per-class px {hist['per_class']}, "
            f"ignore {hist['ignore']} ({hist['ignore_frac']:.1%})")
        if hist["invalid_ids"]:
            errors.append(
                f"{split}: mask values outside [0,{num_classes}) and not "
                f"IGNORE({IGNORE_LABEL}): {hist['invalid_ids']} — wrong GT "
                f"encoding for {dataset} ({num_classes} classes)")
        missing = [c for c, n in enumerate(hist["per_class"]) if n == 0]
        if missing:
            lvl = errors if split == "train" else warnings
            lvl.append(
                f"{split}: classes {missing} have ZERO labeled pixels"
                + (" — balanced sampling cannot draw them; training would "
                   "never see these classes" if split == "train" else ""))
        if hist["ignore_frac"] > 0.5:
            warnings.append(
                f"{split}: {hist['ignore_frac']:.0%} of valid-region pixels "
                f"are IGNORE — for color-coded GT (ISPRS) this usually "
                f"means palette mismatch (anti-aliased / re-encoded GT "
                f"rasters); for GRSS it means mostly-unlabeled scenes")
        if max_scale:
            small = [s for s in sizes if min(s) < max_scale]
            if small:
                warnings.append(
                    f"{split}: {len(small)} tile(s) smaller than the "
                    f"largest patch scale ({max_scale}px): {small[:4]} — "
                    f"handled via mirrored context, but patches will be "
                    f"mostly reflection")

    if train is not None and test is not None and \
            train.num_bands != test.num_bands:
        errors.append(f"band mismatch: train {train.num_bands} vs test "
                      f"{test.num_bands}")
    if expected_bands and test is not None and \
            test.num_bands != expected_bands:
        warnings.append(
            f"dump has {test.num_bands} bands; config expects "
            f"{expected_bands} — the trainer auto-adopts the dump's band "
            f"count (a restored checkpoint must match it)")
    if train is not None and train.mean is not None:
        info["mean"] = np.asarray(train.mean).round(3).tolist()
        info["std"] = np.asarray(train.std).round(3).tolist()
        log(f"train stats: mean {info['mean']} std {info['std']}")
        if np.any(np.asarray(train.std) < 1e-6):
            errors.append("a channel has ~zero std over the training "
                          "split — constant band (wrong file paired?)")

    membership = _isprs_split_membership(
        dataset, path, kwargs.get("bands", ""), kwargs.get("val_tiles", ()))
    if membership:
        info["split"] = membership
        log(f"split membership: train {membership['train']} | "
            f"validation {membership['validation']}"
            + (f" | {membership['unrecognized']} file(s) with "
               f"unrecognized ids" if membership["unrecognized"] else ""))

    for w in warnings:
        log(f"WARNING: {w}")
    for e in errors:
        log(f"ERROR: {e}")
    ok = not errors
    log(f"CHECK {'PASSED' if ok else 'FAILED'} "
        f"({len(warnings)} warning(s), {len(errors)} error(s))")
    return {"ok": ok, "errors": errors, "warnings": warnings, "info": info}
