"""P1, the int8 conv probe's kernel (counterpart of `pallas_conv` in
scripts/int8_kernel_probe.py).

A 3x3 dilated SAME conv of int8 NHWC activations with int8 HWIO weights,
C channels in and out, accumulated exactly in int32, then the probe's
requant epilogue:

    out = int8(clip(round(float32(acc) * scale), -128, 127))

It rounds before it clips, and to -128: not K5's epilogue.

`int8_conv3x3_requant` launches the hand-written Hopper kernel
(csrc/int8_conv3x3.cu) for CUDA tensors and takes the plain PyTorch
version, `int8_conv3x3_requant_ref`, only for tensors on the CPU.

The kernel has two variants, chosen by `variant_for` from the shape and
the pointers alone: "wgmma", warp-specialised on the tensor cores and fed
by TMA, where the input is 16-byte aligned and the dilation under 128 (the
range of TMA's im2col corners), and "mma_sync", the first kernel, for any
other input, such as a view that starts off 16-byte alignment. `launches`
counts the wrapper's kernel launches, `variant_launches` those of each
variant.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# Kernel launches since the last reset (callers set them to 0).
launches = 0
VARIANTS = ("mma_sync", "wgmma")  # the C entry's variant codes
variant_launches = dict.fromkeys(VARIANTS, 0)


def reset_launches() -> None:
    global launches
    launches = 0
    for v in VARIANTS:
        variant_launches[v] = 0


def variant_for(dilation: int, aligned: bool = True) -> str:
    """The kernel variant a launch takes: "wgmma" where TMA can copy the
    input (`aligned`: a 16-byte-aligned base) and its im2col corners
    reach the SAME pad (dilation < 128), else "mma_sync"."""
    return "wgmma" if aligned and dilation < 128 else "mma_sync"


def _check(x: torch.Tensor, w: torch.Tensor, dilation: int) -> None:
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8 operands required, got {x.dtype}, {w.dtype}")
    c = x.shape[-1] if x.dim() == 4 else -1
    if x.dim() != 4 or tuple(w.shape) != (3, 3, c, c):
        raise ValueError(f"x (B,H,W,C) and w (3,3,C,C) required, got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if c % 32:
        raise ValueError(f"C must be a multiple of 32 (the tensor cores' "
                         f"int8 K step), got {c}")
    if dilation < 1:
        raise ValueError(f"dilation must be >= 1, got {dilation}")


def int8_conv3x3_requant_ref(x: torch.Tensor, w: torch.Tensor, scale: float,
                             dilation: int) -> torch.Tensor:
    """Plain PyTorch version of P1 on any device. The accumulator is a
    float64 conv of the int8 values, which is exact: |acc| <= 9 * C *
    128^2 < 2^53. The epilogue runs in float32, as the kernel's does."""
    _check(x, w, dilation)
    xd = x.permute(0, 3, 1, 2).double()
    acc = F.conv2d(xd, w.permute(3, 2, 0, 1).double(), padding=dilation,
                   dilation=dilation)
    y = acc.permute(0, 2, 3, 1).float() * torch.tensor(
        np.float32(scale), device=x.device)
    return torch.clamp(torch.round(y), -128, 127).to(torch.int8).contiguous()


def int8_conv3x3_requant(x: torch.Tensor, w: torch.Tensor, scale: float,
                         dilation: int, variant: Optional[str] = None) -> torch.Tensor:
    """P1: the conv and its requant epilogue as one launch.

    x: (B, H, W, C) int8, NHWC-contiguous on the card, C % 32 == 0
    w: (3, 3, C, C) int8 HWIO
    scale: float32 scalar, passed to the kernel by value
    variant: default `variant_for` the dilation and x's alignment
    Returns (B, H, W, C) int8.

    CPU tensors take `int8_conv3x3_requant_ref`; CUDA tensors launch the
    kernel; anything else raises.
    """
    global launches
    if x.device.type == "cpu":
        return int8_conv3x3_requant_ref(x, w, scale, dilation)
    if x.device.type != "cuda":
        raise RuntimeError(f"int8_conv3x3_requant: no kernel for device {x.device}")
    _check(x, w, dilation)
    if not x.is_contiguous():
        raise ValueError("int8_conv3x3_requant: x must be NHWC-contiguous")
    if w.device != x.device:
        raise ValueError(f"operands on {w.device} and {x.device}")
    chosen = variant_for(dilation, x.data_ptr() % 16 == 0)
    variant = variant or chosen
    if variant not in VARIANTS:
        raise ValueError(f"int8_conv3x3_requant: unknown variant {variant!r}")
    if variant == "wgmma" and chosen != "wgmma":
        raise ValueError(f"variant wgmma needs a 16-byte-aligned x and a dilation "
                         f"under 128, got dilation {dilation}, x at "
                         f"{x.data_ptr() % 16} bytes past alignment")
    bsz, h, wd, c = x.shape
    # (9, C out, C in): both GEMM operands contiguous along K.
    wp = w.permute(0, 1, 3, 2).reshape(9, c, c).contiguous()
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    from dynseg_torch.ops._build import load_library

    err = load_library().dynseg_int8_conv3x3(
        x.data_ptr(), wp.data_ptr(), out.data_ptr(), bsz, h, wd, c, dilation,
        float(np.float32(scale)), VARIANTS.index(variant),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"int8_conv3x3_requant launch failed: CUDA error {err}")
    launches += 1
    variant_launches[variant] += 1
    return out
