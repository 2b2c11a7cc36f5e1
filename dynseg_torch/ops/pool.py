"""K4, the stride-1 SAME max-pool and its backward (counterpart of
dynseg/ops/pool.py), and K6, the int8 forward's one-pass max-pool.

`max_pool_s1` is the pool of a block built with pool_backward="pallas":
its forward is ATen's max-pool and its backward is the tie-split
subgradient of the reference's Pallas kernel,

    cnt[s] = #{taps == y[s]},  dx[r] = sum_d valid * [x[r] == y[r+d]] * g[r+d] / cnt[r+d]

over the window's offsets in row-major order. `pallas_pool_bwd` launches
the hand-written Hopper kernel (csrc/pool_bwd.cu) for CUDA tensors and
takes the plain PyTorch version, `pallas_pool_bwd_ref`, only for tensors
on the CPU.

The kernel has two variants, chosen by `variant_for` from the shape and
the pointers alone: "fused", one pass whose tiles TMA copies into shared
memory, where C is a multiple of 4, x, y and g are 16-byte aligned and a
tile fits the shared memory (every pool of dilated_icpr_rate6), and
"twopass", PR 2's kernel, for any other shape. `launches` counts the
wrapper's kernel launches (one per backward), `variant_launches` those of
each variant.

K4 takes float32 and an odd window, as the reference's kernel does. An
even window has an asymmetric SAME footprint that the symmetric tap set
cannot express, and a bfloat16 input (compute_dtype="bfloat16") is not
K4's type: as in the reference, `max_pool_s1` then warns once per shape,
dtype and window and takes ATen's own backward (the first max). That is
a shape and type gate; a kernel that fails to build or launch raises.

K6 (csrc/max_pool_fwd.cu) is the forward pool of the int8 forward
(`ops.quant`): one pass over an NHWC tensor that writes only the max, in
the output's own type, through the registered operator
`dynseg_torch::max_pool_s1`. Its mode follows from the input's dtype and
whether an out-scale is given (`fwd_mode`): "i8" pools int8 codes as
int8, "f32_i8" pools float32 and quantizes the max once to int8 at the
scale (equal to quantize-then-pool, since the quantize is monotone), "f32"
pools float32. On the CPU the op runs `max_pool_fwd_ref`, the plain
composition; on the card it launches the kernel. `fwd_launches` counts
its launches by mode. A second operator, `dynseg_torch::max_pool_s1_into`
(`max_pool_fwd_into`), stores the max into a given view instead, such as
a channel slot of the dense forward's feature buffer, whose pixels lie
further apart than its channels: the kernel takes that output pixel
stride. Either op takes the kernel's 16-byte path where `fwd_path` finds
the pixels in whole 16-byte pieces on their boundaries, else one element
a thread. `fwd_slot_launches` counts the stores into a view by path,
apart from `fwd_launches`. `pool_forward` and `max_pool_s1`, the pools of the
train-capable nets, use neither.

K7 (csrc/act_quantize.cu) is the int8 forward's quantize of a float map,
`quantize_act` in one pass, through the registered operator
`dynseg_torch::quantize_s8`: float32 or bfloat16 in, by the input's
dtype, int8 codes out. It reads a channel prefix of a wider NHWC buffer in
place. On the CPU the op runs `quantize_act`; on the card it launches the
kernel on the path `quantize_path` picks, and `quantize_launches` counts
its launches by path.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch
import torch.nn.functional as F

# Kernel launches since the last reset (callers set them to 0).
launches = 0
VARIANTS = ("twopass", "fused")  # the C entry's variant codes
variant_launches = dict.fromkeys(VARIANTS, 0)

# The fused variant's largest tile side, and the shared memory a block may
# use on the H100 (227 KB).
_TILE = 16
_SMEM_LIMIT = 232448


# K6's load/store modes (the C entry's mode codes) and its launches by mode.
FWD_MODES = ("i8", "f32_i8", "f32")
fwd_launches = dict.fromkeys(FWD_MODES, 0)
# K6's paths (the C entry's path codes), and its stores into a view by path.
FWD_PATHS = ("vec16", "scalar")
fwd_slot_launches = dict.fromkeys(FWD_PATHS, 0)
# K6's strip: output rows a thread walks down H. Over the dense int8
# forward's six pools on an H100, strips of 4 and 16 rows were the fastest
# of 2 to 64, within 1 % of each other (a whole 336-row column took twice
# as long).
_FWD_ROWS = 16


# K7's paths (the C entry's path codes) and its launches by path.
QUANT_PATHS = ("vec16", "scalar")
quantize_launches = dict.fromkeys(QUANT_PATHS, 0)


def reset_launches() -> None:
    global launches
    launches = 0
    for counts in (variant_launches, fwd_launches, fwd_slot_launches, quantize_launches):
        for v in counts:
            counts[v] = 0


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


def fused_tile(n: int) -> int:
    """The fused variant's tile side along an extent of n pixels: at most
    16, cutting n into as few tiles of as equal a size as it can (13 at 65
    and at 25)."""
    tiles = -(-n // _TILE)
    return -(-n // tiles)


def fused_smem(c: int, window: int, th: int, tw: int) -> int:
    """Dynamic shared memory of a fused block (csrc/pool_bwd.cu
    `smem_bytes`): x on the tile plus a halo of 2r, y and g on the tile
    plus r, 4 * min(4, C // 4) channels, each box rounded to 128 bytes,
    the barrier and 128 bytes of alignment."""
    r, cb = window // 2, 4 * min(4, c // 4)

    def box(h, w):
        return -(-h * w * cb * 4 // 128) * 128

    return box(th + 4 * r, tw + 4 * r) + 2 * box(th + 2 * r, tw + 2 * r) + 8 + 128


def variant_for(shape, window: int = 3, aligned: bool = True) -> str:
    """The kernel variant a (B, H, W, C) backward launches: "fused" where
    TMA can copy the tensors (C a multiple of 4, so 16-byte rows, and
    16-byte aligned pointers: `aligned`) and a tile fits the shared
    memory, else "twopass"."""
    _, h, w, c = shape
    if c % 4 or c == 0 or not aligned or window % 2 != 1:
        return "twopass"
    smem = fused_smem(c, window, fused_tile(h), fused_tile(w))
    return "fused" if smem <= _SMEM_LIMIT else "twopass"


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
                    window: int = 3, variant: Optional[str] = None) -> torch.Tensor:
    """K4: dx for y = maxpool_{window, SAME, stride 1}(x) given the
    cotangent g; x, y, g (B, H, W, C) float32, NHWC-contiguous on the card.
    CPU tensors take `pallas_pool_bwd_ref`; CUDA tensors launch `variant`
    (default: `variant_for` the shape and pointers); anything else
    raises."""
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
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, y, g))
    chosen = variant_for(x.shape, window, aligned)
    variant = variant or chosen
    if variant not in VARIANTS:
        raise ValueError(f"pallas_pool_bwd: unknown variant {variant!r}")
    if variant == "fused" and chosen != "fused":
        raise ValueError(f"variant fused needs C a multiple of 4, 16-byte aligned "
                         f"x, y, g and a tile within the shared memory, got "
                         f"{tuple(x.shape)}, window {window}, aligned {aligned}")
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    from dynseg_torch.ops._build import load_library

    b, h, w, c = x.shape
    gdc = torch.empty_like(x) if variant == "twopass" else None
    err = load_library().dynseg_pool_bwd(
        x.data_ptr(), y.data_ptr(), g.data_ptr(),
        None if gdc is None else gdc.data_ptr(), dx.data_ptr(), b, h, w, c,
        window, VARIANTS.index(variant), fused_tile(h), fused_tile(w),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"pallas_pool_bwd launch failed: CUDA error {err}")
    launches += 1
    variant_launches[variant] += 1
    return dx


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    """NCHW tensor -> NHWC-contiguous: a view for channels_last input (the
    net's layout), a copy otherwise."""
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
    """The pool of pool_backward="pallas" on an NCHW tensor: K4's
    tie-split backward for a float32 input and an odd window; any other
    warns once per (shape, dtype, window), in the reference's words with
    the NHWC shape, and takes ATen's backward, like the reference's
    fallback to the XLA VJP."""
    if window % 2 == 1 and x.dtype == torch.float32:
        return MaxPoolS1.apply(x, window)
    shape = (x.shape[0], x.shape[2], x.shape[3], x.shape[1])
    dtype = str(x.dtype).removeprefix("torch.")
    key = (shape, dtype, window)
    if key not in _warned:
        _warned.add(key)
        warnings.warn(
            f"--pool_backward pallas requested but unsupported for shape "
            f"{shape} dtype {dtype} window {window} (needs float32 and an odd "
            f"window) — falling back to ATen's max-pool backward",
            RuntimeWarning, stacklevel=2)
    return pool_forward(x, window)


def quantize_act(x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """Per-tensor symmetric int8 codes of x at scale sx (a float32 tensor):
    round(clamp(x / sx, -127, 127)), rounding half to even."""
    return torch.round(torch.clamp(x.float() / sx, -127.0, 127.0)).to(torch.int8)


def fwd_mode(dtype: torch.dtype, scaled: bool) -> str:
    """K6's mode for an input of `dtype`, with or without an out-scale."""
    if dtype == torch.int8 and not scaled:
        return "i8"
    if dtype == torch.float32:
        return "f32_i8" if scaled else "f32"
    raise TypeError(f"max_pool_s1 forward: int8 codes, or float32 with or without "
                    f"an out-scale, required; got {dtype}"
                    f"{' with an out-scale' if scaled else ''}")


def max_pool_fwd_ref(x: torch.Tensor, window: int,
                     scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K6 on any device, NHWC (B, H, W, C) in and
    out: "f32" is `pool_forward`; "i8" pools the codes in float32, which
    is exact, and casts back; "f32_i8" quantizes to `scale` first."""
    mode = fwd_mode(x.dtype, scale is not None)
    xc = x.permute(0, 3, 1, 2)
    if mode == "f32":
        y = pool_forward(xc, window)
    else:
        if mode == "f32_i8":
            xc = quantize_act(xc, scale)
        y = pool_forward(xc.float(), window).to(torch.int8)
    return y.permute(0, 2, 3, 1).contiguous()


# K6 as a registered operator, so that the int8 serving artifact
# (`dynseg_torch.export`) calls it as one node and launches the kernel
# when it runs on the card. On the CPU the op runs the plain version.
@torch.library.custom_op("dynseg_torch::max_pool_s1", mutates_args=(),
                         device_types="cpu")
def _fwd_op(x: torch.Tensor, window: int,
            scale: Optional[torch.Tensor]) -> torch.Tensor:
    return max_pool_fwd_ref(x, window, scale)


def _fwd_dtype(mode: str) -> torch.dtype:
    return torch.float32 if mode == "f32" else torch.int8


@_fwd_op.register_fake
def _(x, window, scale):
    return x.new_empty(x.shape, dtype=_fwd_dtype(fwd_mode(x.dtype, scale is not None)))


def _fwd_checked(x, window, scale) -> str:
    """K6's mode for x, after the checks of a launch on the card."""
    mode = fwd_mode(x.dtype, scale is not None)
    if not x.is_contiguous():
        raise ValueError("max_pool_s1 forward: x must be NHWC-contiguous")
    if not 1 <= window <= 7:
        raise ValueError(f"max_pool_s1 forward: window {window} not in 1..7")
    if scale is not None and (scale.device != x.device or scale.dtype != torch.float32
                              or scale.numel() != 1):
        raise ValueError(f"max_pool_s1 forward: the scale must be one float32 on "
                         f"{x.device}, got {tuple(scale.shape)} {scale.dtype} on "
                         f"{scale.device}")
    return mode


def fwd_path(mode: str, c: int, ldy: int, x_ptr: int, y_ptr: int) -> str:
    """K6's path in `mode` for pixels of `c` channels at x_ptr, stored
    `ldy` elements apart from y_ptr: "vec16" where every input and output
    pixel is whole 16-byte loads (16 codes or 4 floats) on their
    boundaries, x on 16 bytes and y on its store's size (4 codes in
    f32_i8), else "scalar"."""
    n = 16 if mode == "i8" else 4
    out_bytes = 4 if mode == "f32_i8" else 16
    aligned = x_ptr % 16 == 0 and y_ptr % out_bytes == 0
    return "vec16" if c % n == 0 and ldy % n == 0 and aligned else "scalar"


def _fwd_kernel(x, window, scale, mode, y) -> str:
    """One launch of csrc/max_pool_fwd.cu from x into y, whose pixels lie
    y.stride(2) elements apart; returns the path it took. A launch that
    fails raises; nothing falls back to the plain version."""
    from dynseg_torch.ops._build import load_library

    b, h, w, c = x.shape
    ldy = y.stride(2)
    path = fwd_path(mode, c, ldy, x.data_ptr(), y.data_ptr())
    err = load_library().dynseg_max_pool_s1(
        x.data_ptr(), y.data_ptr(), None if scale is None else scale.data_ptr(),
        b, h, w, c, ldy, window, FWD_MODES.index(mode), FWD_PATHS.index(path), _FWD_ROWS,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"max_pool_s1 forward launch failed: CUDA error {err}")
    return path


@_fwd_op.register_kernel("cuda")
def _fwd_launch(x, window, scale):
    """The op on the card: one launch of csrc/max_pool_fwd.cu, counted."""
    mode = _fwd_checked(x, window, scale)
    y = torch.empty(x.shape, device=x.device, dtype=_fwd_dtype(mode))
    if y.numel() == 0:
        return y
    _fwd_kernel(x, window, scale, mode, y)
    fwd_launches[mode] += 1
    return y


def _check_into(x, scale, out) -> None:
    mode = fwd_mode(x.dtype, scale is not None)
    if out.shape != x.shape or out.dtype != _fwd_dtype(mode) or out.device != x.device:
        raise ValueError(f"max_pool_s1_into: out must be {tuple(x.shape)} "
                         f"{_fwd_dtype(mode)} on {x.device}, got {tuple(out.shape)} "
                         f"{out.dtype} on {out.device}")


# K6 storing into a given view, as a registered operator that mutates it,
# so that the int8 serving artifact writes each pooled map into its slot
# too. On the CPU the op copies the plain version's result into the view.
@torch.library.custom_op("dynseg_torch::max_pool_s1_into", mutates_args=("out",),
                         device_types="cpu")
def _fwd_into_op(x: torch.Tensor, window: int, scale: Optional[torch.Tensor],
                 out: torch.Tensor) -> None:
    _check_into(x, scale, out)
    out.copy_(max_pool_fwd_ref(x, window, scale))


@_fwd_into_op.register_fake
def _(x, window, scale, out):
    _check_into(x, scale, out)


@_fwd_into_op.register_kernel("cuda")
def _fwd_into_launch(x, window, scale, out):
    """The op on the card: one launch of csrc/max_pool_fwd.cu that stores
    into `out`, (B, H, W, C) NHWC with its pixels out.stride(2) >= C
    elements apart, counted in `fwd_slot_launches` by its path."""
    mode = _fwd_checked(x, window, scale)
    _check_into(x, scale, out)
    _, h, w, c = out.shape
    ld = out.stride(2)
    strides = (h * w * ld, w * ld, ld, 1)
    if ld < c or any(n > 1 and s != t for n, s, t in zip(out.shape, out.stride(), strides)):
        raise ValueError(f"max_pool_s1_into: out's pixels must lie ld >= C elements apart "
                         f"in NHWC order, got shape {tuple(out.shape)} strides "
                         f"{tuple(out.stride())}")
    if out.numel() == 0:
        return
    fwd_slot_launches[_fwd_kernel(x, window, scale, mode, out)] += 1


def max_pool_fwd(x: torch.Tensor, window: int,
                 scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K6: the stride-1 SAME max-pool of an NCHW tensor (int8 codes, or
    float32 quantized to int8 at `scale` when given, or float32), padded
    like XLA's SAME, through the registered op. Returns NCHW in the
    channels_last format: int8 for "i8" and "f32_i8", else float32. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    return _fwd_op(_nhwc(x), window, scale).permute(0, 3, 1, 2)


def max_pool_fwd_into(x: torch.Tensor, window: int, scale: Optional[torch.Tensor],
                      out: torch.Tensor) -> torch.Tensor:
    """`max_pool_fwd` stored into `out`, an NCHW view of its result's shape
    and dtype in the channels_last format, such as a channel slot of a
    channels_last buffer, through the registered op. Returns `out`. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    _fwd_into_op(_nhwc(x), window, scale, out.permute(0, 2, 3, 1))
    return out


def _check_quantize(x: torch.Tensor) -> None:
    if x.dim() != 4 or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quantize_s8: a (B, H, W, C) float32 or bfloat16 map "
                        f"required, got {tuple(x.shape)} {x.dtype}")


def quantize_path(c: int, elem_size: int, x_ptr: int, pixel_stride: int) -> str:
    """K7's path for pixels of `c` channels of `elem_size` bytes at x_ptr,
    `pixel_stride` elements apart: "vec16" where every pixel is whole
    16-channel pieces on 16-byte boundaries, else "scalar"."""
    aligned = x_ptr % 16 == 0 and pixel_stride * elem_size % 16 == 0
    return "vec16" if c % 16 == 0 and aligned else "scalar"


# K7 as a registered operator, like K6: the int8 serving artifact calls it
# as one node. On the CPU the op runs the plain version.
@torch.library.custom_op("dynseg_torch::quantize_s8", mutates_args=(),
                         device_types="cpu")
def _quantize_op(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    _check_quantize(x)
    return quantize_act(x, scale).contiguous()


@_quantize_op.register_fake
def _(x, scale):
    _check_quantize(x)
    return x.new_empty(x.shape, dtype=torch.int8)


@_quantize_op.register_kernel("cuda")
def _quantize_launch(x, scale):
    """The op on the card: one launch of csrc/act_quantize.cu, counted. A
    launch that fails raises; nothing falls back to the plain version."""
    _check_quantize(x)
    if scale.device != x.device or scale.dtype != torch.float32 or scale.numel() != 1:
        raise ValueError(f"quantize_s8: the scale must be one float32 on {x.device}, "
                         f"got {tuple(scale.shape)} {scale.dtype} on {scale.device}")
    c = x.shape[3]
    y = torch.empty(x.shape, device=x.device, dtype=torch.int8)
    if y.numel() == 0:
        return y
    # The pixels at one stride, each pixel's channels contiguous: a view of
    # a channel prefix of an NHWC buffer, a copy of any other layout.
    px = x.reshape(-1, c)
    if c > 1 and px.stride(1) != 1:
        px = px.contiguous()
    path = quantize_path(c, px.element_size(), px.data_ptr(), px.stride(0))
    from dynseg_torch.ops._build import load_library

    err = load_library().dynseg_quantize_s8(
        px.data_ptr(), y.data_ptr(), scale.data_ptr(), px.shape[0], c, px.stride(0),
        int(px.dtype == torch.bfloat16), QUANT_PATHS.index(path),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"quantize_s8 launch failed: CUDA error {err}")
    quantize_launches[path] += 1
    return y


def quantize_s8(x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """K7: `quantize_act` of an NCHW float32 or bfloat16 map at the scale
    sx (one float32), through the registered op. A channels_last map, or a
    channel prefix of one, is read in place. Returns NCHW int8 codes in the
    channels_last format. CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    return _quantize_op(x.permute(0, 2, 3, 1), sx).permute(0, 3, 1, 2)
