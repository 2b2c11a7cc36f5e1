"""K5, the int8 block conv (counterpart of dynseg/ops/pallas_conv.py).

One quantized conv block in a single launch: a k x k dilated SAME conv of
int8 NHWC activations with int8 HWIO weights, accumulated exactly in
int32, then the block's whole epilogue before the one store:

    y = A * acc + B          (dequant sx*sw_c folded with BN or the bias)
    y = leaky_relu(y)
    out = int8(round(clip(y * (1/out_scale), -127, 127)))   if out_scale
    out = y, stored as out_dtype (float32, or bfloat16
          rounded once to nearest even)                    otherwise

`pack_conv` prepares a block's operands once: the weights packed to
(k*k, Cout, Cin), A and B as contiguous float32, and 1/out_scale as a host
float32. `int8_block_conv_packed` launches the hand-written Hopper kernel
(csrc/int8_block_conv.cu) on them for CUDA tensors and reads nothing back
from the device; it takes the plain PyTorch version only for tensors on
the CPU. `int8_block_conv` packs and launches in one call.

The kernel has variants, chosen by `variant_for` from the shape alone:
"wgmma" (the tensor cores, fed by TMA) where Cin and Cout are multiples of
16 and the SAME pad is under 128, as in every serving block, and "dp4a"
(the integer pipes) for any other shape, such as the dense-wired net's
concat inputs of 131 channels; dp4a can be named for an aligned shape, to
measure the tensor cores against it. `launches` counts the kernel's
launches, `variant_launches` those of each variant and `out_launches`
those of each output type (int8, float32, bfloat16).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# Kernel launches since the last reset (callers set them to 0).
launches = 0
VARIANTS = ("dp4a", "wgmma")  # the C entry's variant codes
variant_launches = dict.fromkeys(VARIANTS, 0)
# The C entry's store codes, by output dtype.
STORES = {torch.float32: 0, torch.int8: 1, torch.bfloat16: 2}
out_launches = {str(d).removeprefix("torch."): 0 for d in STORES}


def reset_launches() -> None:
    global launches
    launches = 0
    for counts in (variant_launches, out_launches):
        for v in counts:
            counts[v] = 0


def same_pads(k: int, dilation: int):
    """XLA SAME padding of a dilated kernel: (low, high), extra on high."""
    ext = (k - 1) * dilation
    return ext // 2, ext - ext // 2


def _inv_scale(out_scale) -> np.float32:
    # 1/out_scale rounded once to float32, as K5's wrapper computes it.
    return np.float32(1.0 / float(out_scale))


def variant_for(cin: int, cout: int, k: int = 1, dilation: int = 1) -> str:
    """The kernel variant a block of this shape launches: the tensor cores
    where the channels come in 16-byte pieces and TMA's im2col window
    (pads under 128 pixels) covers the SAME border, else dp4a."""
    aligned = cin % 16 == 0 and cout % 16 == 0
    return "wgmma" if aligned and same_pads(k, dilation)[0] < 128 else "dp4a"


@dataclasses.dataclass(frozen=True)
class PackedConv:
    """A quantized block's K5 operands, prepared once per model."""

    w: torch.Tensor          # (k*k, Cout, Cin) int8, contiguous
    a: torch.Tensor          # (Cout,) float32, contiguous
    b: torch.Tensor          # (Cout,) float32, contiguous
    k: int
    dilation: int
    leaky_slope: float       # the float32 value, as the kernel takes it
    inv_scale: Optional[np.float32]  # 1/out_scale; None: out_dtype output
    out_dtype: torch.dtype = torch.float32  # without requant

    @property
    def cin(self) -> int:
        return int(self.w.shape[2])

    @property
    def cout(self) -> int:
        return int(self.w.shape[1])

    @property
    def variant(self) -> str:
        return variant_for(self.cin, self.cout, self.k, self.dilation)

    @property
    def store_dtype(self) -> torch.dtype:
        """The output's dtype: int8 with requant, else out_dtype."""
        return torch.int8 if self.inv_scale is not None else self.out_dtype


def _check(x, w, affine_a, affine_b):
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8 operands required, got {x.dtype}, {w.dtype}")
    if x.dim() != 4 or w.dim() != 4 or w.shape[0] != w.shape[1] \
            or w.shape[2] != x.shape[3]:
        raise ValueError(f"x (B,H,W,Cin) and w (k,k,Cin,Cout) required, "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}")
    cout = w.shape[3]
    if affine_a.shape != (cout,) or affine_b.shape != (cout,):
        raise ValueError(f"affine_a/affine_b must be ({cout},)")


def pack_conv(w: torch.Tensor, affine_a: torch.Tensor, affine_b: torch.Tensor,
              *, dilation: int, leaky_slope: float, out_scale=None,
              out_dtype: torch.dtype = torch.float32) -> PackedConv:
    """K5's operands from HWIO weights, on the weights' device. `out_scale`
    (a number or a one-element tensor) is read to the host here, once;
    `out_dtype` is the output's dtype where out_scale is None."""
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if w.dtype != torch.int8 or w.dim() != 4 or w.shape[0] != w.shape[1]:
        raise ValueError(f"w (k,k,Cin,Cout) int8 required, got "
                         f"{tuple(w.shape)} {w.dtype}")
    k, cin, cout = int(w.shape[0]), int(w.shape[2]), int(w.shape[3])
    if affine_a.shape != (cout,) or affine_b.shape != (cout,):
        raise ValueError(f"affine_a/affine_b must be ({cout},)")
    return PackedConv(
        w=w.permute(0, 1, 3, 2).reshape(k * k, cout, cin).contiguous(),
        a=affine_a.float().contiguous(), b=affine_b.float().contiguous(),
        k=k, dilation=int(dilation),
        leaky_slope=float(np.float32(leaky_slope)),
        inv_scale=None if out_scale is None else _inv_scale(out_scale),
        out_dtype=out_dtype)


def int8_block_conv_ref(x: torch.Tensor, w: torch.Tensor,
                        affine_a: torch.Tensor, affine_b: torch.Tensor, *,
                        dilation: int, leaky_slope: float,
                        out_scale: Optional[float] = None,
                        out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of K5 on any device. The accumulator is a
    float64 conv of the int8 values, which is exact here: |acc| <=
    k^2 * Cin * 127^2 < 2^53. The epilogue runs in float32 with one
    rounding per operation, as the kernel's does; a bfloat16 output is
    that float32 value rounded once to nearest even."""
    _check(x, w, affine_a, affine_b)
    return int8_block_conv_packed_ref(x, pack_conv(
        w, affine_a, affine_b, dilation=dilation, leaky_slope=leaky_slope,
        out_scale=out_scale, out_dtype=out_dtype))


def int8_block_conv_packed_ref(x: torch.Tensor, pc: PackedConv) -> torch.Tensor:
    """`int8_block_conv_ref` on prepared operands."""
    lo, hi = same_pads(pc.k, pc.dilation)
    xd = F.pad(x.permute(0, 3, 1, 2).double(), (lo, hi, lo, hi))
    w = pc.w.reshape(pc.k, pc.k, pc.cout, pc.cin).permute(2, 3, 0, 1)
    acc = F.conv2d(xd, w.double(), dilation=pc.dilation)
    y = acc.permute(0, 2, 3, 1).float() * pc.a
    y = y + pc.b
    y = torch.where(y >= 0, y, y * pc.leaky_slope)
    if pc.inv_scale is None:
        return y.to(pc.out_dtype).contiguous()
    y = y * torch.tensor(pc.inv_scale, device=y.device)
    return torch.round(torch.clamp(y, -127.0, 127.0)).to(torch.int8).contiguous()


def int8_block_conv_packed(x: torch.Tensor, pc: PackedConv,
                           variant: Optional[str] = None) -> torch.Tensor:
    """K5 on prepared operands: (B, H, W, Cin) int8 -> (B, H, W, Cout)
    `pc.store_dtype`. CPU tensors take the plain version; CUDA
    tensors launch `variant` (default: `variant_for` the shape); anything
    else raises."""
    global launches
    if x.dtype != torch.int8 or x.dim() != 4 or x.shape[3] != pc.cin:
        raise ValueError(f"x (B,H,W,{pc.cin}) int8 required, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        return int8_block_conv_packed_ref(x, pc)
    if x.device.type != "cuda":
        raise RuntimeError(f"int8_block_conv: no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("int8_block_conv: x must be NHWC-contiguous")
    for t in (pc.w, pc.a, pc.b):
        if t.device != x.device:
            raise ValueError(f"operands on {t.device} and {x.device}")
    variant = variant or pc.variant
    if variant != "dp4a" and pc.variant == "dp4a":
        raise ValueError(f"variant {variant} needs Cin and Cout multiples of "
                         f"16 and a pad under 128, got {pc.cin}, {pc.cout}, "
                         f"{same_pads(pc.k, pc.dilation)[0]}")
    if variant == "wgmma" and x.data_ptr() % 16:
        raise ValueError("int8_block_conv: x must be 16-byte aligned for TMA")
    bsz, h, wd, _ = x.shape
    requant = pc.inv_scale is not None
    out = torch.empty((bsz, h, wd, pc.cout), device=x.device, dtype=pc.store_dtype)
    if out.numel() == 0:
        return out
    from dynseg_torch.ops._build import load_library

    err = load_library().dynseg_int8_block_conv(
        x.data_ptr(), pc.w.data_ptr(), pc.a.data_ptr(), pc.b.data_ptr(),
        out.data_ptr(), bsz, h, wd, pc.cin, pc.cout, pc.k, pc.dilation,
        same_pads(pc.k, pc.dilation)[0], pc.leaky_slope, STORES[out.dtype],
        float(pc.inv_scale) if requant else 1.0, VARIANTS.index(variant),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"int8_block_conv launch failed: CUDA error {err}")
    launches += 1
    variant_launches[variant] += 1
    out_launches[str(out.dtype).removeprefix("torch.")] += 1
    return out


def int8_block_conv(x: torch.Tensor, w: torch.Tensor, affine_a: torch.Tensor,
                    affine_b: torch.Tensor, *, dilation: int,
                    leaky_slope: float, out_scale: Optional[float] = None,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K5: the quantized block's conv and epilogue as one launch.

    x: (B, H, W, Cin) int8, NHWC-contiguous on the card
    w: (k, k, Cin, Cout) int8 HWIO, per-output-channel quantized
    affine_a, affine_b: (Cout,) float32, y = A*acc + B
    out_scale: requantize to int8 at this activation scale when set
    out_dtype: float32 or bfloat16, the output's dtype without requant
    Returns (B, H, W, Cout) int8 (requant) or out_dtype.

    CPU tensors take `int8_block_conv_ref`; CUDA tensors launch the
    kernel; anything else raises.
    """
    if x.device.type == "cpu":
        return int8_block_conv_ref(
            x, w, affine_a, affine_b, dilation=dilation,
            leaky_slope=leaky_slope, out_scale=out_scale, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise RuntimeError(f"int8_block_conv: no kernel for device {x.device}")
    _check(x, w, affine_a, affine_b)
    return int8_block_conv_packed(x, pack_conv(
        w, affine_a, affine_b, dilation=dilation, leaky_slope=leaky_slope,
        out_scale=out_scale, out_dtype=out_dtype))
