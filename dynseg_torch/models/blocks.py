"""Building blocks of the dilated nets (counterpart of dynseg/models/blocks.py).

Params are float32. The activations run in the block's compute dtype,
float32 or bfloat16, rounded where Flax's modules round them (`conv`,
`BatchNorm`). In eval mode BatchNorm reads its running statistics; in
train mode it normalises with the batch statistics and updates the
running ones, exactly as Flax's BatchNorm does. Tensors inside the nets
are NCHW in the channels_last memory format, i.e. NHWC in memory like the
reference, except where a block's shape routes its float conv to cuDNN
in NCHW (`routes_nchw`); `conv_layouts` counts the float conv forwards by
route since the last `reset_conv_layouts()`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dynseg_torch import parallel
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
    and counts its momentum the other way round).

    A bfloat16 input is normalised as flax's `_normalize` does it with
    dtype=bfloat16: float32 statistics (and float32 running statistics in
    eval mode) promote the arithmetic to float32, and the result is cast
    to bfloat16 once.

    Under a data-parallel group (`dynseg_torch.parallel`) the train-mode
    statistics are the global batch's, as the reference's are under its
    mesh: one differentiable all-reduce of [sum x, sum x^2, count] per
    layer, then the same recipe. torch's SyncBatchNorm would merge the
    ranks' variances by Welford and update with the unbiased variance."""

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
            # One pass; a bfloat16 input meets the float32 statistics and
            # affine in float32 arithmetic, rounded once to bfloat16.
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        dims = (0, 2, 3)
        xf = x.float()
        if parallel.grouped():
            n = float(xf.numel() // xf.shape[1])
            sums = parallel.all_reduce_sum(torch.cat([
                xf.sum(dims), (xf * xf).sum(dims), xf.new_full((1,), n)]))
            c = xf.shape[1]
            mean = sums[:c] / sums[-1]
            var = torch.clamp(sums[c:2 * c] / sums[-1] - mean * mean, min=0.0)
        else:
            mean = xf.mean(dims)
            var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


# Float conv forwards through `conv` since the last `reset_conv_layouts()`,
# by the memory layout in which they reached cuDNN.
conv_layouts = {"channels_last": 0, "nchw": 0}


def reset_conv_layouts() -> None:
    conv_layouts["channels_last"] = conv_layouts["nchw"] = 0


def routes_nchw(in_channels: int, kernel: int, dilation: int,
                compute_dtype: torch.dtype) -> bool:
    """Whether a conv of this shape runs its forward in NCHW rather than
    in channels_last. In channels_last, float32, TF32 off and with the
    deterministic algorithms, cuDNN runs a 3x3 forward with more than 512
    input channels (576, 643, 704 measured) and a dilation of 3 or more
    on a direct kernel at 0.2-1.3 TFLOP/s, 20-45x slower than NCHW's
    implicit GEMM; at dilation 1 or 2, at Cin 512, in bfloat16 and in the
    backward the two layouts are within ~20 % (PERF.md section 5, the
    layout table; `python -m dynseg_torch.probes.conv_layouts` times it).
    Of the nets that is dilated_icpr_rate6_densely's block 5 alone."""
    return (compute_dtype == torch.float32 and kernel == 3
            and in_channels > 512 and dilation >= 3)


class _NCHWForward(torch.autograd.Function):
    """A stride-1 conv with an odd kernel, SAME padding and no bias whose
    forward runs on NCHW-contiguous copies of x and w (cuDNN takes
    channels_last if either operand is) and hands its output back in
    channels_last, and whose backward runs in channels_last on the
    saved inputs, where cuDNN's weight gradient is the faster."""

    @staticmethod
    def forward(ctx, x, w, dilation):
        ctx.save_for_backward(x, w)
        ctx.conf = ([d * (k - 1) // 2 for k, d in zip(w.shape[2:], dilation)], dilation)
        y = F.conv2d(x.contiguous(), w.contiguous(), None, 1, ctx.conf[0], dilation)
        return y.contiguous(memory_format=torch.channels_last)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        padding, dilation = ctx.conf
        gx, gw, _ = torch.ops.aten.convolution_backward(
            gy, x, w, None, [1, 1], padding, dilation, False, [0, 0], 1,
            [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None


def conv(layer: nn.Conv2d, x: torch.Tensor, nchw: bool = False) -> torch.Tensor:
    """`layer` on x in x's dtype, as flax's nn.Conv(dtype=...) computes it:
    the kernel cast to that dtype, the conv's output rounded to it, then
    the bias cast to it added (one more rounding in bfloat16). With `nchw`
    (a block of `routes_nchw`'s shapes) the forward runs in NCHW and the
    output comes back in channels_last; the parameter keeps its layout."""
    if not torch.compiler.is_compiling():  # nothing counted under export
        conv_layouts["nchw" if nchw else "channels_last"] += 1
    if x.dtype == torch.float32 and not nchw:
        return layer(x)
    w = layer.weight.to(x.dtype)
    if nchw:
        y = _NCHWForward.apply(x, w, layer.dilation)
    else:
        y = F.conv2d(x, w, None, layer.stride, layer.padding, layer.dilation)
    if layer.bias is not None:
        y = y + layer.bias.to(x.dtype)[:, None, None]
    return y


class DilatedConvBlock(nn.Module):
    """conv (dilated, SAME, stride 1) -> [BN] -> leaky-ReLU -> [stride-1
    SAME max-pool], in the order of dynseg's DilatedConvBlock. An even
    kernel pads like XLA's SAME: torch's padding="same" puts the extra
    pixel after, as XLA does. pool_backward="pallas" routes the pool
    through K4 (`ops.pool.max_pool_s1`); "xla" keeps ATen's backward. The
    input is cast to `compute_dtype` first, and every op after runs in
    it. `nchw` (from the shape, `routes_nchw`) fixes the conv's layout."""

    def __init__(self, in_channels: int, features: int, kernel: int,
                 dilation: int = 1, leaky_slope: float = 0.1,
                 use_batch_norm: bool = True, bn_momentum: float = 0.9,
                 pool: bool = True, pool_window: int = 3,
                 pool_backward: str = "xla",
                 compute_dtype: torch.dtype = torch.float32):
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
        self.compute_dtype = compute_dtype
        self.nchw = routes_nchw(in_channels, kernel, dilation, compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv(self.conv, x.to(self.compute_dtype), self.nchw)
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
    """1x1 conv producing per-pixel class logits, computed in the input's
    dtype and returned as float32."""

    def __init__(self, in_channels: int, num_classes: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(self.conv, x).float()
