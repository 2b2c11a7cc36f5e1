"""K5, the int8 block conv (counterpart of dynseg/ops/pallas_conv.py).

One quantized conv block in a single launch: a k x k dilated SAME conv of
int8 NHWC activations with int8 HWIO weights, accumulated exactly in
int32, then the block's whole epilogue before the one store:

    y = A * acc + B          (dequant sx*sw_c folded with BN or the bias)
    y = leaky_relu(y)
    out = int8(round(clip(y * (1/out_scale), -127, 127)))   if out_scale
    out = y                                                 otherwise

`int8_block_conv` launches the hand-written Hopper kernel
(csrc/int8_block_conv.cu) for CUDA tensors and takes the plain PyTorch
version, `int8_block_conv_ref`, only for tensors on the CPU. `launches`
counts the kernel's launches.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# Kernel launches since the last reset (callers set it to 0).
launches = 0


def same_pads(k: int, dilation: int):
    """XLA SAME padding of a dilated kernel: (low, high), extra on high."""
    ext = (k - 1) * dilation
    return ext // 2, ext - ext // 2


def _inv_scale(out_scale) -> np.float32:
    # 1/out_scale rounded once to float32, as K5's wrapper computes it.
    return np.float32(1.0 / float(out_scale))


def _check(x, w, affine_a, affine_b, out_dtype):
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8 operands required, got {x.dtype}, {w.dtype}")
    if x.dim() != 4 or w.dim() != 4 or w.shape[0] != w.shape[1] \
            or w.shape[2] != x.shape[3]:
        raise ValueError(f"x (B,H,W,Cin) and w (k,k,Cin,Cout) required, "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}")
    cout = w.shape[3]
    if affine_a.shape != (cout,) or affine_b.shape != (cout,):
        raise ValueError(f"affine_a/affine_b must be ({cout},)")
    if out_dtype == torch.bfloat16:
        raise NotImplementedError("out_dtype bfloat16 is not ported")
    if out_dtype != torch.float32:
        raise TypeError(f"out_dtype must be float32, got {out_dtype}")


def int8_block_conv_ref(x: torch.Tensor, w: torch.Tensor,
                        affine_a: torch.Tensor, affine_b: torch.Tensor, *,
                        dilation: int, leaky_slope: float,
                        out_scale: Optional[float] = None,
                        out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of K5 on any device. The accumulator is a
    float64 conv of the int8 values, which is exact here: |acc| <=
    k^2 * Cin * 127^2 < 2^53. The epilogue runs in float32 with one
    rounding per operation, as the kernel's does."""
    _check(x, w, affine_a, affine_b, out_dtype)
    k = w.shape[0]
    lo, hi = same_pads(k, dilation)
    xd = F.pad(x.permute(0, 3, 1, 2).double(), (lo, hi, lo, hi))
    acc = F.conv2d(xd, w.permute(3, 2, 0, 1).double(), dilation=dilation)
    y = acc.permute(0, 2, 3, 1).float() * affine_a.float()
    y = y + affine_b.float()
    y = torch.where(y >= 0, y, y * leaky_slope)
    if out_scale is None:
        return y.contiguous()
    y = y * torch.tensor(_inv_scale(out_scale), device=y.device)
    return torch.round(torch.clamp(y, -127.0, 127.0)).to(torch.int8).contiguous()


def int8_block_conv(x: torch.Tensor, w: torch.Tensor, affine_a: torch.Tensor,
                    affine_b: torch.Tensor, *, dilation: int,
                    leaky_slope: float, out_scale: Optional[float] = None,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K5: the quantized block's conv and epilogue as one launch.

    x: (B, H, W, Cin) int8, NHWC-contiguous on the card
    w: (k, k, Cin, Cout) int8 HWIO, per-output-channel quantized
    affine_a, affine_b: (Cout,) float32, y = A*acc + B
    out_scale: requantize to int8 at this activation scale when set
    Returns (B, H, W, Cout) int8 (requant) or float32.

    CPU tensors take `int8_block_conv_ref`; CUDA tensors launch the
    kernel; anything else raises.
    """
    global launches
    if x.device.type == "cpu":
        return int8_block_conv_ref(
            x, w, affine_a, affine_b, dilation=dilation,
            leaky_slope=leaky_slope, out_scale=out_scale, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise RuntimeError(f"int8_block_conv: no kernel for device {x.device}")
    _check(x, w, affine_a, affine_b, out_dtype)
    bsz, h, wd, cin = x.shape
    k, cout = w.shape[0], w.shape[3]
    if not x.is_contiguous():
        raise ValueError("int8_block_conv: x must be NHWC-contiguous")
    for t in (w, affine_a, affine_b):
        if t.device != x.device:
            raise ValueError(f"operands on {t.device} and {x.device}")
    # (k*k, Cout, Cin): both GEMM operands contiguous along Cin.
    wp = w.permute(0, 1, 3, 2).contiguous()
    a = affine_a.float().contiguous()
    b = affine_b.float().contiguous()
    requant = out_scale is not None
    out = torch.empty((bsz, h, wd, cout), device=x.device,
                      dtype=torch.int8 if requant else torch.float32)
    if out.numel() == 0:
        return out
    from dynseg_torch.ops._build import load_library

    lib = load_library()
    err = lib.dynseg_int8_block_conv(
        x.data_ptr(), wp.data_ptr(), a.data_ptr(), b.data_ptr(),
        out.data_ptr(), bsz, h, wd, cin, cout, k, dilation,
        same_pads(k, dilation)[0], float(np.float32(leaky_slope)),
        int(requant), float(_inv_scale(out_scale)) if requant else 1.0,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"int8_block_conv launch failed: CUDA error {err}")
    launches += 1
    return out
