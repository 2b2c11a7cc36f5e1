"""Building blocks of the dilated nets (counterpart of dynseg/models/blocks.py).

Float32 throughout. In eval mode BatchNorm reads its running statistics;
in train mode it normalises with the batch statistics and updates the
running ones, exactly as Flax's BatchNorm does (see `BatchNorm`). Tensors
inside the nets are NCHW in the channels_last memory format, i.e. NHWC in
memory like the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dynseg_torch.ops.pool import max_pool_s1, pool_forward


class BatchNorm(nn.Module):
    """Flax's BatchNorm over (N, H, W) of an NCHW tensor, with the state
    names of torch's BatchNorm2d (weight, bias, running_mean, running_var,
    num_batches_tracked) so that state_dicts carry over.

    Train mode (flax 0.12.3, use_fast_variance=True): batch mean and
    var = max(0, E[x^2] - E[x]^2), both float32, gradients through both;
    y = (x - mean) * (rsqrt(var + eps) * weight) + bias; then
    running = momentum * running + (1 - momentum) * batch, with the BIASED
    batch variance (torch's own BatchNorm2d updates with the unbiased one
    and counts its momentum the other way round)."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.tensor(0))
        self.momentum = momentum
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        dims = (0, 2, 3)
        xf = x.float()
        mean = xf.mean(dims)
        var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]


class DilatedConvBlock(nn.Module):
    """conv (dilated, SAME, stride 1) -> [BN] -> leaky-ReLU -> [stride-1
    SAME max-pool], in the order of dynseg's DilatedConvBlock. An even
    kernel pads like XLA's SAME: torch's padding="same" puts the extra
    pixel after, as XLA does. pool_backward="pallas" routes the pool
    through K4 (`ops.pool.max_pool_s1`); "xla" keeps ATen's backward."""

    def __init__(self, in_channels: int, features: int, kernel: int,
                 dilation: int = 1, leaky_slope: float = 0.1,
                 use_batch_norm: bool = True, bn_momentum: float = 0.9,
                 pool: bool = True, pool_window: int = 3,
                 pool_backward: str = "xla"):
        super().__init__()
        if pool_backward not in ("xla", "pallas"):
            raise ValueError(f"pool_backward {pool_backward!r} not in "
                             f"('xla', 'pallas')")
        self.conv = nn.Conv2d(in_channels, features, kernel, padding="same",
                              dilation=dilation, bias=not use_batch_norm)
        self.bn = BatchNorm(features, bn_momentum) if use_batch_norm else None
        self.leaky_slope = leaky_slope
        self.pool_window = pool_window if pool else 0
        self.pool_backward = pool_backward

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        x = F.leaky_relu(x, self.leaky_slope)
        if self.pool_window:
            if self.pool_backward == "pallas":
                x = max_pool_s1(x, self.pool_window)
            else:
                x = pool_forward(x, self.pool_window)
        return x


class ScoreHead(nn.Module):
    """1x1 conv producing per-pixel class logits."""

    def __init__(self, in_channels: int, num_classes: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)
