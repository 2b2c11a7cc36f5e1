"""The dihedral-transform convention (counterpart of dynseg/ops/dihedral.py).

k in [0, 8): k >= 4 flips the column axis first, then rot90^(k % 4) over
the two leading spatial axes. Test-time augmentation (`infer._tta_device`)
transforms one padded tile with `dihedral` and maps each probability map
back with `dihedral_inv`; training's per-sample `gather.dihedral_batch`
follows the same convention (held equal by tests/test_torch_infer.py).
"""

from __future__ import annotations

import torch


def dihedral(x: torch.Tensor, k: int) -> torch.Tensor:
    """Transform k of one (H, W, ...) image."""
    if k >= 4:
        x = torch.flip(x, dims=(1,))
    return torch.rot90(x, k % 4, dims=(0, 1))


def dihedral_inv(x: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of `dihedral(., k)`."""
    x = torch.rot90(x, -(k % 4), dims=(0, 1))
    if k >= 4:
        x = torch.flip(x, dims=(1,))
    return x
