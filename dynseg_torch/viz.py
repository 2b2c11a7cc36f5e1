"""Prediction-map export — SURVEY.md C18.

The port's own copy of dynseg/viz.py (dynseg_torch imports nothing of the
JAX package); tests/test_torch_data.py holds it to the original.

Writes colorized per-tile prediction PNGs using the per-dataset class
palette (ISPRS submission format / visual inspection), like the
reference's create_prediction_map ([R] dynamic.py:≈prediction export)."""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from dynseg_torch.data.datasets import PALETTES


def save_prediction_maps(
    preds: Sequence[np.ndarray],
    dataset: str,
    output_path: str,
    prefix: str = "prediction",
    names: Sequence[str] = (),
) -> list:
    from PIL import Image

    palette = PALETTES[dataset]
    os.makedirs(output_path, exist_ok=True)
    paths = []
    for i, pred in enumerate(preds):
        n = int(np.max(pred)) + 1 if pred.size else 1
        if n > len(palette):  # distinct colors instead of a silent clip
            extra = (np.arange(len(palette), n)[:, None]
                     * np.array([97, 57, 17]) + np.array([13, 101, 197])) % 255
            palette = np.concatenate([palette, extra.astype(np.uint8)])
        safe = np.clip(pred, 0, len(palette) - 1)
        rgb = palette[safe]
        tag = names[i] if i < len(names) else str(i)
        p = os.path.join(output_path, f"{prefix}_{tag}.png")
        Image.fromarray(rgb).save(p)
        paths.append(p)
    return paths


def save_error_maps(
    preds: Sequence[np.ndarray],
    masks: Sequence[np.ndarray],
    output_path: str,
    prefix: str = "errors",
) -> list:
    """Per-tile error maps for analysis (beyond reference): green =
    correct, red = wrong, dark gray = unlabeled/ignored ground truth."""
    from PIL import Image

    from dynseg_torch.data.tiles import IGNORE_LABEL

    os.makedirs(output_path, exist_ok=True)
    paths = []
    for i, (pred, gt) in enumerate(zip(preds, masks)):
        h, w = pred.shape[:2]
        gt = np.asarray(gt)[:h, :w]
        rgb = np.zeros((h, w, 3), np.uint8)
        correct = pred == gt
        rgb[correct] = (60, 170, 60)
        rgb[~correct] = (200, 50, 50)
        rgb[gt == IGNORE_LABEL] = (70, 70, 70)
        p = os.path.join(output_path, f"{prefix}_{i}.png")
        Image.fromarray(rgb).save(p)
        paths.append(p)
    return paths
