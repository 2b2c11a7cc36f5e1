"""Building blocks of the dilated nets (counterpart of dynseg/models/blocks.py).

Eval semantics only: BatchNorm reads its running statistics, and the
forward runs in float32. Tensors inside the nets are NCHW in the
channels_last memory format, i.e. NHWC in memory like the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def max_pool_same(x: torch.Tensor, window: int) -> torch.Tensor:
    """Stride-1 SAME max-pool of an NCHW tensor, padded like XLA's SAME:
    (window-1)//2 before and the rest after, with -inf. It also pools
    int8 codes held in a float tensor: the window always holds its own
    centre, so a -inf pad acts as the reference's int8 pad value -128."""
    lo = (window - 1) // 2
    hi = window - 1 - lo
    if lo == hi:
        return F.max_pool2d(x, window, stride=1, padding=lo)
    x = F.pad(x, (lo, hi, lo, hi), value=float("-inf"))
    return F.max_pool2d(x, window, stride=1)


class DilatedConvBlock(nn.Module):
    """conv (dilated, SAME, stride 1) -> [BN] -> leaky-ReLU -> [stride-1
    SAME max-pool], in the order of dynseg's DilatedConvBlock. An even
    kernel pads like XLA's SAME: torch's padding="same" puts the extra
    pixel after, as XLA does."""

    def __init__(self, in_channels: int, features: int, kernel: int,
                 dilation: int = 1, leaky_slope: float = 0.1,
                 use_batch_norm: bool = True, pool: bool = True,
                 pool_window: int = 3):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, kernel, padding="same",
                              dilation=dilation, bias=not use_batch_norm)
        self.bn = nn.BatchNorm2d(features, eps=1e-5) if use_batch_norm else None
        self.leaky_slope = leaky_slope
        self.pool_window = pool_window if pool else 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        x = F.leaky_relu(x, self.leaky_slope)
        if self.pool_window:
            x = max_pool_same(x, self.pool_window)
        return x


class ScoreHead(nn.Module):
    """1x1 conv producing per-pixel class logits."""

    def __init__(self, in_channels: int, num_classes: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)
