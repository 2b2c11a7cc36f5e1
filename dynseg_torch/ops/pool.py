"""K4, the stride-1 SAME max-pool and its backward (counterpart of
dynseg/ops/pool.py).

`max_pool_s1` is the pool of a block built with pool_backward="pallas":
its forward is ATen's max-pool and its backward is the tie-split
subgradient of the reference's Pallas kernel,

    cnt[s] = #{taps == y[s]},  dx[r] = sum_d valid * [x[r] == y[r+d]] * g[r+d] / cnt[r+d]

over the window's offsets in row-major order. `pallas_pool_bwd` launches
the hand-written Hopper kernel (csrc/pool_bwd.cu) for CUDA tensors and
takes the plain PyTorch version, `pallas_pool_bwd_ref`, only for tensors
on the CPU. `launches` counts the wrapper's kernel launches (one per
backward; the kernel runs in two passes).

An even window has an asymmetric SAME footprint that the symmetric tap set
cannot express: as in the reference, `max_pool_s1` then warns and takes
ATen's own backward. That is a shape gate; a kernel that fails to build or
launch raises.
"""

from __future__ import annotations

import warnings

import torch
import torch.nn.functional as F

# Kernel launches since the last reset (callers set it to 0).
launches = 0


def pool_forward(x: torch.Tensor, window: int) -> torch.Tensor:
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


def _offsets(window: int):
    r = window // 2
    return [(di, dj) for di in range(-r, r + 1) for dj in range(-r, r + 1)]


def _check(x, y, g, window):
    if window % 2 != 1:
        raise ValueError(f"pallas_pool_bwd: even window {window} has an "
                         f"asymmetric SAME footprint the symmetric tap set "
                         f"cannot express")
    if x.dim() != 4 or y.shape != x.shape or g.shape != x.shape:
        raise ValueError(f"x, y, g must share one (B,H,W,C) shape, got "
                         f"{tuple(x.shape)}, {tuple(y.shape)}, {tuple(g.shape)}")
    for t in (x, y, g):
        if t.dtype != torch.float32:
            raise TypeError(f"pallas_pool_bwd: float32 required, got {t.dtype}")


def pallas_pool_bwd_ref(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
                        window: int = 3) -> torch.Tensor:
    """Plain PyTorch version of K4 on any device, NHWC (B, H, W, C). Taps
    outside the image read a NaN pad, which equals nothing, so they drop
    out of both passes as the reference's valid mask drops them."""
    _check(x, y, g, window)
    r = window // 2
    h, w = x.shape[1:3]
    nan = float("nan")

    def shifted(a, di, dj):
        return a[:, r + di:r + di + h, r + dj:r + dj + w]

    xp = F.pad(x, (0, 0, r, r, r, r), value=nan)
    cnt = torch.zeros_like(x)
    for di, dj in _offsets(window):
        cnt = cnt + (shifted(xp, di, dj) == y).float()
    gdc = g / torch.clamp(cnt, min=1.0)
    yp = F.pad(y, (0, 0, r, r, r, r), value=nan)
    gp = F.pad(gdc, (0, 0, r, r, r, r))
    dx = torch.zeros_like(x)
    for di, dj in _offsets(window):
        dx = dx + torch.where(x == shifted(yp, di, dj), shifted(gp, di, dj), 0.0)
    return dx


def pallas_pool_bwd(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
                    window: int = 3) -> torch.Tensor:
    """K4: dx for y = maxpool_{window, SAME, stride 1}(x) given the
    cotangent g; x, y, g (B, H, W, C) float32, NHWC-contiguous on the card.
    CPU tensors take `pallas_pool_bwd_ref`; CUDA tensors launch the
    kernel; anything else raises."""
    global launches
    if x.device.type == "cpu":
        return pallas_pool_bwd_ref(x, y, g, window)
    if x.device.type != "cuda":
        raise RuntimeError(f"pallas_pool_bwd: no kernel for device {x.device}")
    _check(x, y, g, window)
    for t in (y, g):
        if t.device != x.device:
            raise ValueError(f"operands on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError("pallas_pool_bwd: y and g must be NHWC-contiguous")
    if not x.is_contiguous():
        raise ValueError("pallas_pool_bwd: x must be NHWC-contiguous")
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    gdc = torch.empty_like(x)
    from dynseg_torch.ops._build import load_library

    lib = load_library()
    b, h, w, c = x.shape
    err = lib.dynseg_pool_bwd(
        x.data_ptr(), y.data_ptr(), g.data_ptr(), gdc.data_ptr(),
        dx.data_ptr(), b, h, w, c, window,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"pallas_pool_bwd launch failed: CUDA error {err}")
    launches += 1
    return dx


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    """NCHW tensor -> NHWC-contiguous (a view for channels_last input)."""
    return t.permute(0, 2, 3, 1).contiguous()


class MaxPoolS1(torch.autograd.Function):
    """Stride-1 SAME odd-window max-pool of an NCHW tensor whose backward
    is K4. The forward saves x and y for the backward."""

    @staticmethod
    def forward(ctx, x, window):
        y = pool_forward(x, window)
        ctx.save_for_backward(x, y)
        ctx.window = window
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        dx = pallas_pool_bwd(_nhwc(x), _nhwc(y), _nhwc(g), ctx.window)
        return dx.permute(0, 3, 1, 2), None


_warned: set = set()


def max_pool_s1(x: torch.Tensor, window: int = 3) -> torch.Tensor:
    """The pool of pool_backward="pallas": K4's tie-split backward for an
    odd window; an even window warns once per shape and takes ATen's
    backward, like the reference's fallback to the XLA VJP."""
    if window % 2 == 1:
        return MaxPoolS1.apply(x, window)
    key = (tuple(x.shape), window)
    if key not in _warned:
        _warned.add(key)
        warnings.warn(
            f"--pool_backward pallas requested but unsupported for shape "
            f"{tuple(x.shape)} dtype {x.dtype} window {window} (needs an odd "
            f"window) — falling back to ATen's max-pool backward",
            RuntimeWarning, stacklevel=2)
    return pool_forward(x, window)
