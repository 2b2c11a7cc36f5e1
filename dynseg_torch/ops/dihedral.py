"""The dihedral-transform convention (counterpart of dynseg/ops/dihedral.py).

k in [0, 8): k >= 4 flips the column axis first, then rot90^(k % 4) over
the two leading spatial axes. Test-time augmentation (`infer._tta_device`)
transforms one padded tile with `dihedral` and maps each probability map
back with `dihedral_inv`; training's per-sample `gather.dihedral_batch`
follows the same convention (held equal by tests/test_torch_infer.py).
The serving engine's host-side TTA (`serve.ServingEngine`) applies the
same functions to numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch


def _flip(x, axis: int):
    if isinstance(x, np.ndarray):
        return np.flip(x, axis=axis)
    return torch.flip(x, dims=(axis,))


def _rot90(x, k: int):
    if isinstance(x, np.ndarray):
        return np.rot90(x, k, axes=(0, 1))
    return torch.rot90(x, k, dims=(0, 1))


def dihedral(x, k: int):
    """Transform k of one (H, W, ...) image, a tensor or a numpy array."""
    if k >= 4:
        x = _flip(x, 1)
    return _rot90(x, k % 4)


def dihedral_inv(x, k: int):
    """Inverse of `dihedral(., k)`."""
    x = _rot90(x, -(k % 4))
    if k >= 4:
        x = _flip(x, 1)
    return x
