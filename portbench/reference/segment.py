"""The plain reference of full-tile segmentation: int8 calibration and
quantization, dense blocks with a halo, and multi-scale window voting.

Each works on the raw tile (h, w, C) and mirror-pads by indexing (numpy's
"reflect"), so that a rectangle of the tile is computed from its own
context alone:

  * dense: one forward of the rectangle plus a halo of at least the
    receptive radius on every side; the centre is the whole-tile
    forward's value there. Probabilities are the softmax.
  * window voting: for every scale s, the windows of side s at stride
    round(s * fraction) (clamped to s) whose grid covers the tile, from
    s // 2 before its first pixel, the last snapped to the padded edge;
    each window's softmax probabilities are summed where it lands, with
    a vote count; probabilities are the sums over the counts, labels the
    argmax of the sums.
  * int8 (the reference's post-training scheme): activation ranges are
    the 99.9th percentile of |block input| over 8 crops of side
    min(128, h, w), drawn with numpy's default_rng(0) (tile i % T, row
    and column uniform in the valid area), the max over crops; a block
    is int8 where both of its channel counts reach min_ch (under dense
    wiring, its concat input's); weights are per-output-channel symmetric
    (absmax / 127), activations per-tensor (range / 127).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench.counts import Net, quantized, window_origins, window_stride
from portbench.reference.net import EPS, forward, no_tf32, percentile


def crop(image: torch.Tensor, y0: int, y1: int, x0: int, x1: int) -> torch.Tensor:
    """Rows [y0, y1) x cols [x0, x1) of the tile mirror-padded without
    bound: indices outside [0, h) reflect."""
    h, w = image.shape[:2]
    dev = image.device
    return image[_reflect(torch.arange(y0, y1, device=dev), h)][
        :, _reflect(torch.arange(x0, x1, device=dev), w)]


def calib_crops(images: Sequence[torch.Tensor], mean, std, n: int = 8) -> List[torch.Tensor]:
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        img = images[i % len(images)]
        h, w = img.shape[:2]
        s = min(128, h, w)
        y0 = int(rng.integers(0, max(1, h - s + 1)))
        x0 = int(rng.integers(0, max(1, w - s + 1)))
        out.append((img[y0:y0 + s, x0:x0 + s].float() - mean) / std)
    return out


@torch.no_grad()
def quantize(params: Dict[str, torch.Tensor], net: Net, crops: Sequence[torch.Tensor],
             pct: float, min_ch: int, tf32: bool = False) -> dict:
    """The int8 plan: per block None (float) or its codes' scale, int8
    weights and folded affine; the scale is that of the block's own input
    (under dense wiring, its concat)."""
    no_tf32()
    ranges = None
    for c in crops:
        rec: list = []
        forward(params, c[None], net, record=rec, tf32=tf32)
        vals = [percentile(t.abs(), pct) for t in rec]
        ranges = vals if ranges is None else [max(a, b) for a, b in zip(ranges, vals)]
    plan = []
    for i, on in enumerate(quantized(net, min_ch)):
        if not on:
            plan.append(None)
            continue
        w = params[f"blocks.{i}.conv.weight"].detach().cpu().numpy().astype(np.float32)
        absmax = np.abs(w).reshape(w.shape[0], -1).max(axis=1)
        w_scale = np.maximum(absmax, 1e-12) / np.float32(127.0)
        wq = np.round(np.clip(w / w_scale[:, None, None, None], -127, 127))
        dev = params[f"blocks.{i}.conv.weight"].device
        act = float(np.float32(ranges[i] / 127.0))
        g = torch.rsqrt(params[f"blocks.{i}.bn.running_var"] + EPS) * params[f"blocks.{i}.bn.weight"]
        a = (torch.tensor(act, dtype=torch.float32, device=dev)
             * torch.from_numpy(w_scale.astype(np.float32)).to(dev)) * g
        plan.append({"act_scale": act, "inv_scale": float(np.float32(1.0 / act)),
                     "wq": torch.from_numpy(wq.astype(np.float32)).to(dev), "a": a,
                     "b": params[f"blocks.{i}.bn.bias"] - params[f"blocks.{i}.bn.running_mean"] * g})
    return {"blocks": plan}


@torch.no_grad()
def dense_probs(params, image: torch.Tensor, mean, std, rect, net: Net, halo: int,
                quant=None, tf32: bool = False) -> torch.Tensor:
    """(y1-y0, x1-x0, classes) softmax probabilities of rect (y0, y1, x0,
    x1) of the raw tile, from one forward with a halo."""
    no_tf32()
    y0, y1, x0, x1 = rect
    x = (crop(image, y0 - halo, y1 + halo, x0 - halo, x1 + halo).float() - mean) / std
    logits = forward(params, x[None], net, quant=quant, tf32=tf32)[0]
    return torch.softmax(logits[halo:halo + y1 - y0, halo:halo + x1 - x0], -1)


@torch.no_grad()
def window_probs(params, image: torch.Tensor, mean, std, rect, net: Net,
                 scales: Sequence[int], fraction: float, pad: int,
                 batch: int = 256, tf32: bool = False):
    """Vote sums (h', w', classes) and counts (h', w') over rect of the raw
    tile, from every window of every scale that lands on it."""
    no_tf32()
    y0, y1, x0, x1 = rect
    h, w = image.shape[:2]
    nc = params["head.conv.bias"].shape[0]
    dev = image.device
    acc = torch.zeros((y1 - y0, x1 - x0, nc), dtype=torch.float32, device=dev)
    cnt = torch.zeros((y1 - y0, x1 - x0), dtype=torch.float32, device=dev)
    for s in scales:
        st = window_stride(s, fraction)
        # Origins in padded coordinates, then in the tile's own.
        rows = [r - pad for r in window_origins(pad, pad + h, s, st, h + 2 * pad - s)
                if r - pad < y1 and r - pad + s > y0]
        cols = [c - pad for c in window_origins(pad, pad + w, s, st, w + 2 * pad - s)
                if c - pad < x1 and c - pad + s > x0]
        origins = torch.tensor([(r, c) for r in rows for c in cols], device=dev)
        ar = torch.arange(s, device=dev)
        for i in range(0, len(origins), batch):
            o = origins[i:i + batch]
            rr, cc = o[:, 0, None] + ar, o[:, 1, None] + ar  # (N, s) tile coords
            x = image[_reflect(rr, h)[:, :, None], _reflect(cc, w)[:, None, :]]
            probs = torch.softmax(forward(params, (x.float() - mean) / std, net,
                                          tf32=tf32), -1)
            yy = (rr - y0)[:, :, None].expand(-1, s, s)
            xx = (cc - x0)[:, None, :].expand(-1, s, s)
            on = (yy >= 0) & (yy < y1 - y0) & (xx >= 0) & (xx < x1 - x0)
            acc.index_put_((yy[on], xx[on]), probs[on], accumulate=True)
            cnt.index_put_((yy[on], xx[on]), torch.ones_like(yy[on], dtype=torch.float32),
                           accumulate=True)
    return acc, cnt


def _reflect(idx: torch.Tensor, n: int) -> torch.Tensor:
    idx = idx.abs()
    return torch.where(idx >= n, 2 * (n - 1) - idx, idx)
