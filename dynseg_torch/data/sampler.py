"""Per-class-balanced patch position sampling (SURVEY.md C4).

The port's own copy of dynseg/data/sampler.py (dynseg_torch imports nothing of the
JAX package); tests/test_torch_data.py holds it to the original.

TPU-first split of responsibilities (SURVEY.md §7 hard part 4):
  * HOST (here, cheap): build per-class center-position tables ONCE from the
    label rasters, then per step draw `batch` (tile,row,col) triples by
    cycling classes — no rejection sampling, no dynamic shapes.
  * DEVICE (dynseg_torch.ops.gather): gather the actual pixel windows from the
    HBM-resident padded tiles, normalize, and apply dihedral augmentation —
    all fused under jit.

Positions are in PADDED-tile coordinates: tiles are mirror-padded by
max_scale//2 up front, so a patch of ANY scheduled size centered at a valid
pixel always lies fully inside the padded array (static-shape gathers).

Reference anchor: [R] dynamic.py:≈dynamically_create_patches +
class-distribution helpers.
"""

from __future__ import annotations

from typing import List

import numpy as np

from dynseg_torch.data.tiles import TileSet

try:  # optional native (C++) fast path — see dynseg_torch/native/position_tables.cc
    from dynseg_torch.data import native as _native
except Exception:  # pragma: no cover
    _native = None


class BalancedPatchSampler:
    """Draws class-balanced patch center positions from a (padded) TileSet."""

    def __init__(
        self,
        tiles: TileSet,
        num_classes: int,
        pad: int,
        seed: int = 0,
        balanced: bool = True,
        use_native: bool = True,
        max_positions_per_class: int = 0,
    ):
        """max_positions_per_class: if > 0, cap each class table to a
        random subsample of that many centers (12 bytes/position — the
        full table for a Potsdam-size set is ~8.6 GB of host RAM; a few
        million positions per class are statistically equivalent for
        training). The subsample is drawn once per sampler; epoch
        reshuffles permute within it."""
        # NOTE: deliberately no self.tiles — storing the TileSet would
        # pin the full host pixel arrays (GBs at Potsdam scale) for the
        # sampler's lifetime, and only the position tables are needed
        # after __init__ (review r2).
        self.num_classes = num_classes
        self.pad = pad  # padded-coordinate convention marker (unused)
        self.balanced = balanced
        self._seed = seed
        self.rng = np.random.default_rng(seed)

        # Per-class tables of (tile, row, col) centers, row/col in padded
        # coordinates. Built once (host); device only ever sees indices.
        masks = tiles.masks  # padded: (T, H, W) with IGNORE_LABEL border
        tables: List[np.ndarray] = []
        built = None
        if use_native and _native is not None and _native.available():
            built = _native.build_position_tables(masks, num_classes)
        if built is not None:
            tables = built
        else:
            for c in range(num_classes):
                t, r, cc = np.nonzero(masks == c)
                tables.append(
                    np.stack([t, r, cc], axis=1).astype(np.int32)
                )
        # True per-class pixel counts BEFORE any cap: unbalanced mode's
        # "uniform over all labeled pixels" weights must reflect the real
        # distribution — weighting by capped table LENGTHS silently
        # reshaped it toward class-uniform (review r2, round 2).
        self._true_counts = np.array([len(t) for t in tables], np.float64)
        if max_positions_per_class > 0:
            for c in range(num_classes):
                if len(tables[c]) > max_positions_per_class:
                    idx = self.rng.choice(
                        len(tables[c]), max_positions_per_class, replace=False
                    )
                    tables[c] = np.ascontiguousarray(tables[c][idx])
        self.tables = tables
        counts = np.array([len(t) for t in tables])
        self.present = np.nonzero(counts > 0)[0]
        if len(self.present) == 0:
            raise ValueError("no labeled pixels found in tile set")
        self._cursor = np.zeros(num_classes, dtype=np.int64)
        for c in self.present:
            self.rng.shuffle(self.tables[c])

    def _draw_from_class(self, c: int, n: int) -> np.ndarray:
        tab = self.tables[c]
        out = np.empty((n, 3), dtype=np.int32)
        got = 0
        while got < n:
            cur = self._cursor[c]
            take = min(n - got, len(tab) - cur)
            out[got : got + take] = tab[cur : cur + take]
            got += take
            self._cursor[c] = cur + take
            if self._cursor[c] >= len(tab):
                # epoch over for this class: reshuffle (host-cheap)
                self.rng.shuffle(tab)
                self._cursor[c] = 0
        return out

    def reseed(self, salt: int) -> None:
        """Fold salt (e.g. the resume iteration) into the position
        stream: a resumed run must not REPLAY the identical sample
        sequence from iteration 0 (review r2). Exact continuation of an
        uninterrupted stream is not reconstructable from checkpoints;
        a (seed, salt)-derived distinct stream is the correct fix."""
        if salt:
            self.rng = np.random.default_rng((self._seed, salt))
            # Also reshuffle the in-flight epoch: the table order drawn
            # from the cursor was produced by the ORIGINAL stream and
            # would replay regardless of the new rng.
            for c in self.present:
                self.rng.shuffle(self.tables[c])
                self._cursor[c] = 0

    def sample(self, batch: int) -> np.ndarray:
        """Return (batch, 3) int32 (tile, row, col) centers.

        Balanced mode cycles present classes round-robin with a random class
        offset per batch so remainders don't always favor class 0
        ([R] dynamic.py:≈class balancing; SURVEY.md C4).
        """
        if not self.balanced:
            # uniform over all labeled pixels (pre-cap counts — see init)
            weights = self._true_counts[self.present].copy()
            weights /= weights.sum()
            counts = self.rng.multinomial(batch, weights)
            parts = [
                self._draw_from_class(c, int(n))
                for c, n in zip(self.present, counts)
                if n > 0
            ]
            pos = np.concatenate(parts, axis=0)
            self.rng.shuffle(pos)
            return pos
        k = len(self.present)
        base, rem = divmod(batch, k)
        order = self.rng.permutation(self.present)
        parts = []
        for i, c in enumerate(order):
            n = base + (1 if i < rem else 0)
            if n > 0:
                parts.append(self._draw_from_class(int(c), n))
        pos = np.concatenate(parts, axis=0)
        self.rng.shuffle(pos)
        return pos

    def sample_augment_ids(self, batch: int, augment: bool) -> np.ndarray:
        """Per-sample dihedral transform ids in [0,8): rot90 k + optional
        flip (SURVEY.md C5). 0 = identity when augmentation is off."""
        if not augment:
            return np.zeros(batch, dtype=np.int32)
        return self.rng.integers(0, 8, size=batch, dtype=np.int32)
