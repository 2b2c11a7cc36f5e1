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
float32. `int8_block_conv_packed` calls the registered operator
`dynseg_torch::int8_block_conv` on them, with every operand explicit, so
that an exported program (`dynseg_torch.export`) holds one call of it per
quantized block: for CUDA tensors the op launches the hand-written Hopper
kernel (csrc/int8_block_conv.cu) and reads nothing back from the device;
for CPU tensors it runs the plain PyTorch version. `int8_block_conv` packs
and launches in one call.

The kernel has variants, chosen by `variant_for` from the shape alone:
"wgmma" (the tensor cores, fed by TMA) where Cin and Cout are multiples of
16 and the SAME pad is under 128, as in every serving block (the dense-wired
net's concat inputs of 131-643 channels among them, which `ops.quant` pads
with zero channels to a multiple of 16), and "dp4a" (the integer pipes) for
any other shape; dp4a can be named for an aligned shape, to measure the
tensor cores against it. `launches` counts the kernel's
launches, `variant_launches` those of each variant and `out_launches`
those of each output type (int8, float32, bfloat16), whether the eager
forward or a loaded artifact called the op.
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
STORE_DTYPES = {v: k for k, v in STORES.items()}
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
    return _plain(x, pc.w, pc.a, pc.b, pc.k, pc.dilation,
                  same_pads(pc.k, pc.dilation)[0], pc.leaky_slope,
                  STORES[pc.store_dtype], _inv_arg(pc))


def _inv_arg(pc: PackedConv) -> float:
    # The op's inv_scale argument: 1/out_scale, or 1.0 without requant.
    return 1.0 if pc.inv_scale is None else float(pc.inv_scale)


def _plain(x, w, a, b, k: int, dilation: int, pad: int, leaky_slope: float,
           store: int, inv_scale: float) -> torch.Tensor:
    """The plain version on the C entry's operands, on any device. The
    accumulator is a float64 conv of the int8 values, exact since |acc| <=
    k^2 * Cin * 127^2 < 2^53; the epilogue runs in float32 with one
    rounding per operation."""
    cout, cin = int(w.shape[1]), int(w.shape[2])
    hi = (k - 1) * dilation - pad
    xd = F.pad(x.permute(0, 3, 1, 2).double(), (pad, hi, pad, hi))
    wd = w.reshape(k, k, cout, cin).permute(2, 3, 0, 1).double()
    acc = F.conv2d(xd, wd, dilation=dilation)
    y = acc.permute(0, 2, 3, 1).float() * a
    y = y + b
    y = torch.where(y >= 0, y, y * leaky_slope)
    if store != STORES[torch.int8]:
        return y.to(STORE_DTYPES[store]).contiguous()
    y = y * torch.tensor(inv_scale, dtype=torch.float32, device=y.device)
    return torch.round(torch.clamp(y, -127.0, 127.0)).to(torch.int8).contiguous()


# K5 as a registered operator, so that a `torch.export` program (the
# int8 serving artifact, `dynseg_torch.export`) calls it as one node and
# launches the kernel when it runs on the card. Every operand is explicit:
# x, the packed weights, A and B, and the numbers the C entry takes;
# `variant` indexes VARIANTS and `store` is a value of STORES. On the CPU
# the op runs the plain version.
@torch.library.custom_op("dynseg_torch::int8_block_conv", mutates_args=(),
                         device_types="cpu")
def _op(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
        k: int, dilation: int, pad: int, leaky_slope: float, store: int,
        inv_scale: float, variant: int) -> torch.Tensor:
    return _plain(x, w, a, b, k, dilation, pad, leaky_slope, store, inv_scale)


@_op.register_fake
def _(x, w, a, b, k, dilation, pad, leaky_slope, store, inv_scale, variant):
    return x.new_empty((*x.shape[:3], w.shape[1]), dtype=STORE_DTYPES[store])


@_op.register_kernel("cuda")
def _launch(x, w, a, b, k, dilation, pad, leaky_slope, store, inv_scale, variant):
    """The op on the card: one launch of csrc/int8_block_conv.cu, counted.
    A launch that fails raises; nothing falls back to the plain version."""
    global launches
    if not x.is_contiguous():
        raise ValueError("int8_block_conv: x must be NHWC-contiguous")
    for t in (w, a, b):
        if t.device != x.device:
            raise ValueError(f"operands on {t.device} and {x.device}")
    if VARIANTS[variant] == "wgmma" and x.data_ptr() % 16:
        raise ValueError("int8_block_conv: x must be 16-byte aligned for TMA")
    bsz, h, wd, cin = x.shape
    cout = int(w.shape[1])
    out = torch.empty((bsz, h, wd, cout), device=x.device, dtype=STORE_DTYPES[store])
    if out.numel() == 0:
        return out
    from dynseg_torch.ops._build import load_library

    err = load_library().dynseg_int8_block_conv(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(),
        bsz, h, wd, cin, cout, k, dilation, pad, leaky_slope, store, inv_scale,
        variant, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"int8_block_conv launch failed: CUDA error {err}")
    launches += 1
    variant_launches[VARIANTS[variant]] += 1
    out_launches[str(out.dtype).removeprefix("torch.")] += 1
    return out


def int8_block_conv_packed(x: torch.Tensor, pc: PackedConv,
                           variant: Optional[str] = None) -> torch.Tensor:
    """K5 on prepared operands: (B, H, W, Cin) int8 -> (B, H, W, Cout)
    `pc.store_dtype`, through the registered op. CPU tensors take the
    plain version; CUDA tensors launch `variant` (default: `variant_for`
    the shape); anything else raises."""
    if x.dtype != torch.int8 or x.dim() != 4 or x.shape[3] != pc.cin:
        raise ValueError(f"x (B,H,W,{pc.cin}) int8 required, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"int8_block_conv: no kernel for device {x.device}")
    variant = variant or pc.variant
    if variant != "dp4a" and pc.variant == "dp4a":
        raise ValueError(f"variant {variant} needs Cin and Cout multiples of "
                         f"16 and a pad under 128, got {pc.cin}, {pc.cout}, "
                         f"{same_pads(pc.k, pc.dilation)[0]}")
    return _op(x, pc.w, pc.a, pc.b, pc.k, pc.dilation,
               same_pads(pc.k, pc.dilation)[0], pc.leaky_slope,
               STORES[pc.store_dtype], _inv_arg(pc), VARIANTS.index(variant))


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
