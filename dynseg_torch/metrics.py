"""Metrics: overall accuracy, Cohen's kappa, per-class and mean F1, the
confusion matrix and the train step's batch accuracies (counterpart of
dynseg/metrics.py).

`scores_from_confusion` and `erode_boundaries` are host numpy, equal to
the reference's (held so by tests); `confusion_matrix`, `batch_accuracy`
and `balanced_batch_accuracy` compute on the tensors' device. Pixels
labeled IGNORE_LABEL are excluded everywhere.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from dynseg.data.tiles import IGNORE_LABEL


def confusion_matrix(preds: torch.Tensor, labels: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """(num_classes, num_classes) int64 counts, rows = true, cols = pred."""
    preds = preds.reshape(-1).long()
    labels = labels.reshape(-1).long()
    valid = labels != IGNORE_LABEL
    idx = labels[valid] * num_classes + preds[valid]
    return torch.bincount(idx, minlength=num_classes * num_classes).reshape(
        num_classes, num_classes)


def batch_accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-pixel accuracy over the valid pixels of a batch (the scheduler's
    'acc' signal), a float32 scalar tensor; 0 when no pixel is valid."""
    valid = labels != IGNORE_LABEL
    correct = ((logits.argmax(-1) == labels) & valid).sum()
    return (correct / valid.sum().clamp(min=1)).float()


def balanced_batch_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                            num_classes: int) -> torch.Tensor:
    """Mean per-class recall over the classes present in the batch (the
    scheduler's 'balanced_acc' signal), a float32 scalar tensor in [0, 1]."""
    valid = (labels != IGNORE_LABEL).reshape(-1)
    labs = labels.reshape(-1)[valid].long()
    hit = (logits.argmax(-1).reshape(-1)[valid] == labs)
    total = torch.bincount(labs, minlength=num_classes)[:num_classes]
    hits = torch.bincount(labs[hit], minlength=num_classes)[:num_classes]
    present = total > 0
    recall = torch.where(present, hits / total.clamp(min=1), 0.0)
    return (recall.sum() / present.sum().clamp(min=1)).float()


def scores_from_confusion(cm: np.ndarray) -> Dict[str, object]:
    """Overall accuracy, Cohen's kappa, per-class F1 and mean F1 from an
    accumulated confusion matrix. Classes absent from both ground truth
    and prediction get F1 0 and are left out of the mean."""
    cm = np.asarray(cm, dtype=np.float64)
    total = cm.sum()
    if total == 0:
        return {"oa": 0.0, "kappa": 0.0, "f1": np.zeros(cm.shape[0]),
                "mean_f1": 0.0, "confusion": cm.astype(np.int64)}
    diag = np.diag(cm)
    oa = diag.sum() / total
    rows = cm.sum(axis=1)
    cols = cm.sum(axis=0)
    pe = (rows * cols).sum() / (total * total)
    kappa = (oa - pe) / (1.0 - pe) if pe < 1.0 else 0.0
    denom = rows + cols
    with np.errstate(divide="ignore", invalid="ignore"):
        f1 = np.where(denom > 0, 2.0 * diag / np.maximum(denom, 1e-12), 0.0)
    present = denom > 0
    mean_f1 = float(f1[present].mean()) if present.any() else 0.0
    return {
        "oa": float(oa),
        "kappa": float(kappa),
        "f1": f1,
        "mean_f1": mean_f1,
        "confusion": cm.astype(np.int64),
    }


def _dilate8(b: np.ndarray) -> np.ndarray:
    """One 8-neighbourhood dilation of a boolean map, edge-clipped."""
    out = b.copy()
    out[1:, :] |= b[:-1, :]
    out[:-1, :] |= b[1:, :]
    out[:, 1:] |= b[:, :-1]
    out[:, :-1] |= b[:, 1:]
    out[1:, 1:] |= b[:-1, :-1]
    out[1:, :-1] |= b[:-1, 1:]
    out[:-1, 1:] |= b[1:, :-1]
    out[:-1, :-1] |= b[1:, 1:]
    return out


def erode_boundaries(mask: np.ndarray, radius: int,
                     ignore: int = IGNORE_LABEL) -> np.ndarray:
    """ISPRS protocol: a copy of `mask` with every pixel within Chebyshev
    distance `radius` of a class boundary set to `ignore`. A boundary
    pixel has a differently labeled 8-neighbour (IGNORE_LABEL counts as
    different)."""
    if radius <= 0:
        return mask
    m = np.asarray(mask)
    b = np.zeros(m.shape, bool)
    b[1:, :] |= m[1:, :] != m[:-1, :]
    b[:-1, :] |= m[:-1, :] != m[1:, :]
    b[:, 1:] |= m[:, 1:] != m[:, :-1]
    b[:, :-1] |= m[:, :-1] != m[:, 1:]
    b[1:, 1:] |= m[1:, 1:] != m[:-1, :-1]
    b[:-1, :-1] |= m[:-1, :-1] != m[1:, 1:]
    b[1:, :-1] |= m[1:, :-1] != m[:-1, 1:]
    b[:-1, 1:] |= m[:-1, 1:] != m[1:, :-1]
    for _ in range(radius - 1):
        b = _dilate8(b)
    out = m.copy()
    out[b] = ignore
    return out
