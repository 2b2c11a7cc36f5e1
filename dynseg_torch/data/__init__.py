"""The port's copy of dynseg/data (host-side numpy)."""
from dynseg_torch.data.datasets import NUM_CLASSES, PALETTES, load_dataset  # noqa: F401
from dynseg_torch.data.sampler import BalancedPatchSampler  # noqa: F401
from dynseg_torch.data.tiles import (  # noqa: F401
    IGNORE_LABEL,
    TileSet,
    compute_stats,
    mirror_pad,
    pack_tiles,
)
