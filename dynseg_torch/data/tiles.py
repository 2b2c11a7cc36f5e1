"""Tile storage and normalization statistics.

The port's own copy of dynseg/data/tiles.py (dynseg_torch imports nothing of the
JAX package); tests/test_torch_data.py holds it to the original.

The reference loads full georeferenced tiles + masks into host RAM and
extracts numpy patches per step — a CPU bottleneck (SURVEY.md §3.1 hot
loops). TPU-first redesign: tiles live as ONE padded, device-resident
array (HBM); per-step batches are produced by an on-device gather
(dynseg_torch.ops.gather) indexed by host-sampled balanced positions. Mean/std
normalization is folded into the gather (SURVEY.md C3/C4 TPU equivalents).

Reference anchors: [R] dynamic.py:≈loader section (load_images,
compute_image_mean, normalize_images); SURVEY.md C2, C3, C14.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

IGNORE_LABEL = 255  # pixels excluded from loss/metrics (ISPRS clutter/void)


@dataclasses.dataclass
class TileSet:
    """A set of full tiles (images + masks) padded to a common shape.

    images: (T, H, W, C) float32, raw (unnormalized) values
    masks:  (T, H, W) int32 class ids, IGNORE_LABEL outside valid area
    valid_hw: (T, 2) original (h, w) per tile before padding
    mean/std: per-channel stats computed from TRAINING tiles only
              (SURVEY.md C3) over valid pixels.
    """

    images: np.ndarray
    masks: np.ndarray
    valid_hw: np.ndarray
    mean: Optional[np.ndarray] = None
    std: Optional[np.ndarray] = None

    @property
    def num_tiles(self) -> int:
        return self.images.shape[0]

    @property
    def num_bands(self) -> int:
        return self.images.shape[-1]


def _reflect_fill(a: np.ndarray, h: int, w: int) -> np.ndarray:
    """Fill a (H, W, C) buffer whose valid region is [:h, :w] by
    reflecting the valid data rightward/downward (one-sided numpy
    'reflect' applied in steps; 1-px dims fall back to edge
    replication). The filled slack only ever provides CONTEXT beyond a
    tile's own mirror margin — the exactness-critical band
    [0, valid+2*pad) is rebuilt with a single native np.pad by
    fill_padded_context, so stepped-vs-native reflection differences in
    the far slack are immaterial (and pinned by the unequal-tile parity
    tests)."""
    H, W = a.shape[:2]
    filled = a[:h, :w]
    for axis, target in ((1, W), (0, H)):
        while filled.shape[axis] < target:
            step = min(filled.shape[axis] - 1, target - filled.shape[axis])
            pad = [(0, 0)] * filled.ndim
            if step == 0:  # cannot reflect a 1-px dim
                pad[axis] = (0, target - filled.shape[axis])
                filled = np.pad(filled, pad, mode="edge")
                break
            pad[axis] = (0, step)
            filled = np.pad(filled, pad, mode="reflect")
    return filled


def pack_tiles(
    images: Sequence[np.ndarray], masks: Sequence[np.ndarray],
    pad_to_multiple: int = 1,
) -> TileSet:
    """Pad a list of variably-sized (H,W,C) tiles into one dense array.

    Padding area gets IGNORE_LABEL in the mask so it never contributes to
    sampling, loss, or metrics. pad_to_multiple > 1 rounds the packed
    shape up — chunked prediction uses it to BUCKET shapes so different
    chunks reuse the same compiled programs. (Trainer and Inferencer both
    reflect-fill each tile's image padding — fill_padded_context below.)
    """
    assert len(images) == len(masks) and len(images) > 0
    hs = [im.shape[0] for im in images]
    ws = [im.shape[1] for im in images]
    c = images[0].shape[2]
    m = max(1, int(pad_to_multiple))
    H = (max(hs) + m - 1) // m * m
    W = (max(ws) + m - 1) // m * m
    T = len(images)
    out_im = np.zeros((T, H, W, c), dtype=np.float32)
    out_mk = np.full((T, H, W), IGNORE_LABEL, dtype=np.int32)
    valid = np.zeros((T, 2), dtype=np.int32)
    for t, (im, mk) in enumerate(zip(images, masks)):
        h, w = im.shape[:2]
        assert mk.shape[:2] == (h, w), (im.shape, mk.shape)
        if im.shape[2] != c:
            # review r2: without this, a mixed-channel batch either dies
            # in an opaque numpy broadcast error or (C=1 vs c>1) silently
            # channel-broadcasts a grayscale tile into RGB normalization.
            raise ValueError(
                f"tile {t} has {im.shape[2]} channels but tile 0 has {c}; "
                f"all rasters in one run must share a band count")
        out_im[t, :h, :w] = im.astype(np.float32)
        out_mk[t, :h, :w] = mk.astype(np.int32)
        valid[t] = (h, w)
    return TileSet(images=out_im, masks=out_mk, valid_hw=valid)


def compute_stats(ts: TileSet) -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel mean/std over valid (non-ignored) pixels of all tiles
    ([R] dynamic.py:≈compute_image_mean; SURVEY.md C3)."""
    valid = ts.masks != IGNORE_LABEL  # (T,H,W)
    # Accumulate per tile: boolean advanced indexing over the whole pack
    # would materialize a dataset-sized copy (review r2 — full-res
    # Potsdam would transiently double host RAM).
    c = ts.images.shape[-1]
    n = 0
    s = np.zeros(c, dtype=np.float64)
    sq = np.zeros(c, dtype=np.float64)
    for t in range(ts.images.shape[0]):
        px = ts.images[t][valid[t]].astype(np.float64)  # (n_t, C)
        n += px.shape[0]
        s += px.sum(axis=0)
        sq += (px * px).sum(axis=0)
    mean = s / max(n, 1)
    var = np.maximum(sq / max(n, 1) - mean * mean, 0.0)
    std = np.sqrt(var)
    std = np.where(std < 1e-6, 1.0, std)
    ts.mean, ts.std = mean.astype(np.float32), std.astype(np.float32)
    return ts.mean, ts.std


def storage_dtype(images: np.ndarray) -> np.dtype:
    """uint8 when lossless (integer-valued imagery in [0,255] — typical
    RS products), else float32. uint8 device storage quarters HBM
    residency and gather-DMA traffic (full Potsdam fits on one chip)."""
    if (
        images.min() >= 0
        and images.max() <= 255
        and np.all(images == np.round(images))
    ):
        return np.dtype(np.uint8)
    return np.dtype(np.float32)


def mirror_pad(ts: TileSet, pad: int, pad_masks: bool = True) -> TileSet:
    """Reflect-pad every tile by `pad` on each spatial side so patch centers
    anywhere in the valid area always have full context, and sliding windows
    cover tile edges ([R] dynamic.py:≈manipulate_border_array; SURVEY.md C14).

    Mask padding uses IGNORE_LABEL (padded pixels never scored/sampled).
    pad_masks=False shares the caller's UNPADDED masks instead of
    allocating a padded int32 copy — inference never reads padded masks,
    and the copy is ~13 GB at production scale (review r2).
    """
    if pad <= 0:
        return ts
    im = np.pad(
        ts.images,
        ((0, 0), (pad, pad), (pad, pad), (0, 0)),
        mode="reflect",
    )
    if pad_masks:
        mk = np.pad(
            ts.masks,
            ((0, 0), (pad, pad), (pad, pad)),
            mode="constant",
            constant_values=IGNORE_LABEL,
        )
    else:
        mk = ts.masks  # shared reference, NOT in padded coordinates
    return TileSet(images=im, masks=mk, valid_hw=ts.valid_hw.copy(), mean=ts.mean, std=ts.std)


def fill_padded_context(padded: TileSet, pad: int) -> TileSet:
    """For every tile smaller than the packed shape, extend the tile's
    OWN mirrored context across the pack slack AND the mirror margin
    (in place on the freshly-padded array — no extra copy).

    Why after mirror_pad: filling only up to the packed shape and then
    mirror-padding reflects around the PACK boundary; when the slack is
    smaller than the window/halo overhang, edge windows would see that
    wrapped context instead of the tile's own reflection — diverging
    between pack shapes (caught by review; regression-tested)."""
    T, Hp, Wp = padded.images.shape[:3]
    H, W = Hp - 2 * pad, Wp - 2 * pad
    for t in range(T):
        h, w = (int(x) for x in padded.valid_hw[t])
        if (h <= pad or w <= pad) and (h < H or w < W):
            # <= not <: at h == pad exactly, np.pad reflect sets
            # out[0] = in[pad], and row `pad` of the mirror_pad source
            # was the first PACK-SLACK row (zeros), not tile data — the
            # outermost mirror row/col was corrupt (review r2, round 2).
            # Tiles SHORTER than the pad margin in a pack with slack
            # (review r2): mirror_pad's top/left bands reflected packed
            # rows/cols that included zero slack, and _reflect_fill's
            # source region would then PROPAGATE that corruption right
            # and down. Rebuild the tile's whole mirrored crop from the
            # valid block alone (np.pad reflect handles pad >= dim by
            # repeated reflection — exactly the solo-tile semantics),
            # then extend across the remaining pack slack.
            block = padded.images[t, pad:pad + h, pad:pad + w]
            crop = np.pad(block, ((pad, pad), (pad, pad), (0, 0)),
                          mode="reflect")
            padded.images[t][:2 * pad + h, :2 * pad + w] = crop
            padded.images[t] = _reflect_fill(
                padded.images[t], 2 * pad + h, 2 * pad + w)
        elif h < H or w < W:
            # Source region includes the top/left mirror rows, so the
            # fill reproduces a per-tile mirror at the valid edge.
            padded.images[t] = _reflect_fill(
                padded.images[t], pad + h, pad + w)
    return padded
