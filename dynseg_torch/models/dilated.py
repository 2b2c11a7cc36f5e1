"""The five dilated network variants (counterpart of dynseg/models/dilated.py).

Every variant is a stack of DilatedConvBlocks with ramping dilation, an
optional dropout (train mode, dropout_rate > 0) and a 1x1 score head,
stride 1 throughout, so logits have the input's spatial shape for any
patch size. The nets take and return NHWC tensors, the
reference's layout; inside they run NCHW in the channels_last format.
ModelConfig.compute_dtype ("float32" or "bfloat16") is the activations'
dtype; params stay float32 and the logits are float32.

The dense-wired net's concats (each block's input and the head's) each
run in a `model.assemble` span, 7 a forward, and `assembly` counts the
bytes they write and the pixels (B*H*W) of the forwards that wrote them,
since the last `reset_assembly()`; a sequential net adds to neither.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from dynseg_torch import parallel
from dynseg_torch.config import ModelConfig
from dynseg_torch.models.blocks import DilatedConvBlock, ScoreHead
from dynseg_torch.utils.profiling import span

# (kernel, features, dilation, pool) per block; held equal to
# dynseg.models.dilated._ARCH by tests/test_torch_models.py.
_ARCH: dict[str, Tuple[Tuple[int, int, int, bool], ...]] = {
    "dilated_icpr_rate6": (
        (5, 64, 1, True),
        (5, 64, 2, True),
        (4, 128, 3, True),
        (4, 128, 4, True),
        (3, 256, 5, True),
        (3, 256, 6, True),
    ),
    "dilated_icpr_original": (
        (5, 64, 1, True),
        (5, 64, 1, True),
        (4, 128, 1, True),
        (4, 128, 1, True),
        (3, 256, 1, True),
        (3, 256, 1, True),
    ),
    "dilated_grsl": (
        (5, 64, 1, True),
        (5, 64, 2, True),
        (4, 128, 3, True),
        (4, 128, 4, True),
        (3, 256, 5, True),
    ),
    "dilated_grsl_rate8": (
        (5, 64, 1, True),
        (5, 64, 2, True),
        (4, 128, 3, True),
        (4, 128, 4, True),
        (3, 192, 6, True),
        (3, 192, 8, True),
    ),
}


# Bytes the dense-wired net's concats wrote, and the pixels of the forwards
# that wrote them, since the last reset.
assembly = {"bytes": 0, "px": 0}


def reset_assembly() -> None:
    assembly["bytes"] = assembly["px"] = 0


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC tensor -> NCHW view in the channels_last format (a copy only
    when `x` is not NHWC-contiguous)."""
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    """The torch dtype of cfg.compute_dtype."""
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r} not in "
                         f"{tuple(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[cfg.compute_dtype]


def _block(cfg: ModelConfig, cin: int, k: int, feats: int, dil: int,
           pool: bool) -> DilatedConvBlock:
    return DilatedConvBlock(
        cin, max(1, int(feats * cfg.width_multiplier)), k, dilation=dil,
        leaky_slope=cfg.leaky_slope, use_batch_norm=cfg.use_batch_norm,
        bn_momentum=cfg.bn_momentum, pool=pool, pool_window=cfg.pool_window,
        pool_backward=cfg.pool_backward, compute_dtype=compute_dtype(cfg))


class _Dropout(nn.Module):
    """Flax's Dropout before the head, active in train mode only: keep
    each value with probability 1 - rate and scale it by 1 / (1 - rate).
    The mask is drawn from `generator` (a torch.Generator on the
    activations' device, passed by the trainer), so a run is reproducible
    from its seed; its bits differ from JAX's."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate <= 0:
            return x
        keep = 1.0 - self.rate
        # The global batch's mask from a generator seeded alike on every
        # rank; this rank keeps its rows.
        w, b = parallel.world(), x.shape[0]
        u = torch.rand((w.size * b,) + tuple(x.shape[1:]), generator=generator,
                       device=x.device)[w.rank * b:(w.rank + 1) * b]
        return torch.where(u < keep, x / keep, torch.zeros_like(x))


class DilatedNet(nn.Module):
    """Sequential dilated ConvNet (icpr_rate6 / grsl / grsl_rate8 / original)."""

    def __init__(self, cfg: ModelConfig, num_input_bands: int):
        super().__init__()
        blocks = []
        cin = num_input_bands
        for k, feats, dil, pool in _ARCH[cfg.net_type]:
            blocks.append(_block(cfg, cin, k, feats, dil, pool))
            cin = blocks[-1].conv.out_channels
        self.blocks = nn.ModuleList(blocks)
        self.dropout = _Dropout(cfg.dropout_rate)
        self.head = ScoreHead(cin, cfg.num_classes)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, H, W, C) float32 -> (B, H, W, num_classes) float32 logits;
        `generator` draws the train-mode dropout mask. Each block casts
        its input to the compute dtype."""
        h = to_nchw(x)
        for block in self.blocks:
            h = block(h)
        return self.head(self.dropout(h, generator)).permute(0, 2, 3, 1)


class DilatedDenseNet(nn.Module):
    """dilated_icpr_rate6_densely: block i consumes the channel concat of
    the input and every earlier block's output; the head consumes the
    concat of all block outputs, input excluded (dilated.py:99-115). The
    concats hold compute-dtype features, the input cast first."""

    def __init__(self, cfg: ModelConfig, num_input_bands: int):
        super().__init__()
        blocks = []
        total = num_input_bands
        for k, feats, dil, pool in _ARCH["dilated_icpr_rate6"]:
            blocks.append(_block(cfg, total, k, feats, dil, pool))
            total += blocks[-1].conv.out_channels
        self.blocks = nn.ModuleList(blocks)
        self.dropout = _Dropout(cfg.dropout_rate)
        self.head = ScoreHead(total - num_input_bands, cfg.num_classes)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feats = [to_nchw(x).to(self.blocks[0].compute_dtype)]
        counted = not torch.compiler.is_compiling()  # no symbolic sizes
        if counted:
            assembly["px"] += x.shape[0] * x.shape[1] * x.shape[2]
        for block in self.blocks:
            feats.append(block(self._assemble(feats, counted)))
        h = self.dropout(self._assemble(feats[1:], counted), generator)
        return self.head(h).permute(0, 2, 3, 1)

    @staticmethod
    def _assemble(parts, counted: bool) -> torch.Tensor:
        """The channel concat of `parts`, a `model.assemble` span, its
        bytes added to `assembly`."""
        with span("model.assemble"):
            out = torch.cat(parts, dim=1)
        if counted:
            assembly["bytes"] += out.numel() * out.element_size()
        return out


def arch(cfg: ModelConfig) -> Tuple[Tuple[int, int, int, bool], ...]:
    """(kernel, features, dilation, pool) per block of cfg.net_type; the
    dense-wired variant uses the dilated_icpr_rate6 stack."""
    if cfg.net_type == "dilated_icpr_rate6_densely":
        return _ARCH["dilated_icpr_rate6"]
    return _ARCH[cfg.net_type]


def receptive_radius(cfg: ModelConfig) -> int:
    """Receptive-field radius of a variant (half the diameter, rounded
    up). Dense-mode blockwise inference is exact iff its halo >= this."""
    diameter = 1
    for k, _, dil, pool in arch(cfg):
        diameter += (k - 1) * dil
        if pool:
            diameter += cfg.pool_window - 1
    return diameter // 2


def build_model(cfg: ModelConfig,
                num_input_bands: Optional[int] = None) -> nn.Module:
    """Model factory over cfg.net_type, in eval mode and channels_last
    (training calls .train()), computing in cfg.compute_dtype."""
    compute_dtype(cfg)
    bands = cfg.num_input_bands if num_input_bands is None else num_input_bands
    if cfg.net_type == "dilated_icpr_rate6_densely":
        model = DilatedDenseNet(cfg, bands)
    elif cfg.net_type in _ARCH:
        model = DilatedNet(cfg, bands)
    else:
        raise ValueError(f"unknown net_type: {cfg.net_type!r}")
    return model.eval().to(memory_format=torch.channels_last)
