"""The plain reference of a training step: the batch cut from the raw
tiles, the train-mode forward, the masked softmax cross-entropy, the
backward and momentum SGD with L2 on the conv kernels.

The batch: a patch of side s centred on (tile, row, col), given in the
coordinates of each tile mirror-padded by `pad` (numpy's "reflect"),
normalised as (x - mean) / std, then the dihedral transform k: k >= 4
flips the columns first, then rot90 (k % 4) times over the two spatial
axes. Labels are the tile's mask, IGNORE outside the tile.

SGD (optax's add_decayed_weights -> sgd(momentum)): d = g + wd * p for
4-D kernels, d = g otherwise; m = d at the first step, m = mu * m + d
after; p = p - lr * m.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from portbench.counts import Net
from portbench.reference.net import IGNORE, forward, no_tf32


def reflect(idx: np.ndarray, n: int) -> np.ndarray:
    """numpy's "reflect" padding index: -1 -> 1, n -> n - 2."""
    idx = np.abs(idx)
    return np.where(idx >= n, 2 * (n - 1) - idx, idx)


def dihedral(x: torch.Tensor, k: int) -> torch.Tensor:
    """(s, s, ...) -> its dihedral transform k."""
    if k >= 4:
        x = x.flip(1)
    return torch.rot90(x, k % 4, dims=(0, 1))


def cut_batch(images: Sequence[torch.Tensor], masks: Sequence[torch.Tensor],
              hw: Sequence, mean: torch.Tensor, std: torch.Tensor,
              positions: np.ndarray, aug: np.ndarray, size: int, pad: int):
    """(B, s, s, C) float32 images and (B, s, s) int64 labels. images[t]
    (h, w, C) and masks[t] (h, w) are tile t's raw pixels on the device."""
    imgs, labs = [], []
    for (t, r, c), k in zip(positions.tolist(), aug.tolist()):
        h, w = (int(v) for v in hw[t])
        if not (pad <= r < pad + h and pad <= c < pad + w):
            raise ValueError(f"position {(t, r, c)} outside tile {t}'s valid area")
        rows = np.arange(r - size // 2, r - size // 2 + size) - pad
        cols = np.arange(c - size // 2, c - size // 2 + size) - pad
        dev = images[t].device
        ri = torch.from_numpy(reflect(rows, h)).to(dev)
        ci = torch.from_numpy(reflect(cols, w)).to(dev)
        im = (images[t][ri][:, ci].float() - mean) / std
        inside = (torch.from_numpy((rows >= 0) & (rows < h)).to(dev)[:, None]
                  & torch.from_numpy((cols >= 0) & (cols < w)).to(dev)[None, :])
        lab = torch.where(inside, masks[t][ri][:, ci].long(), IGNORE)
        if int(lab[size // 2, size // 2]) == IGNORE:
            raise ValueError(f"position {(t, r, c)} is not a labelled pixel")
        if not 0 <= k < 8:
            raise ValueError(f"augment id {k} not in [0, 8)")
        imgs.append(dihedral(im, k))
        labs.append(dihedral(lab, k))
    return torch.stack(imgs), torch.stack(labs)


def masked_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    valid = labels != IGNORE
    ce = F.cross_entropy(logits[valid], labels[valid], reduction="sum")
    return ce / valid.sum().clamp(min=1)


def train_steps(params0: Dict[str, torch.Tensor], batches: List, net: Net,
                lr: float, momentum: float, weight_decay: float,
                tf32: bool = False) -> dict:
    """Momentum SGD over `batches` [(images, labels)] from params0.
    Returns each step's loss, the first step's update direction m1 (the
    gradient as the optimizer takes it) and the params after the last
    step, by leaf name."""
    no_tf32()
    names = [k for k in params0 if not k.startswith("blocks.") or ".bn.running" not in k]
    p = {k: params0[k].detach().clone().requires_grad_(True) for k in names}
    m: Dict[str, torch.Tensor] = {}
    losses, m1 = [], None
    for step, (imgs, labs) in enumerate(batches):
        loss = masked_ce(forward(p, imgs, net, train=True, tf32=tf32, tie_split=True), labs)
        grads = torch.autograd.grad(loss, [p[k] for k in names])
        with torch.no_grad():
            for k, g in zip(names, grads):
                d = g + weight_decay * p[k] if p[k].dim() == 4 else g
                m[k] = d.clone() if step == 0 else momentum * m[k] + d
                p[k] -= lr * m[k]
        losses.append(float(loss.detach()))
        if step == 0:
            m1 = {k: v.clone() for k, v in m.items()}
    return {"losses": losses, "m1": m1,
            "params": {k: v.detach() for k, v in p.items()}}
