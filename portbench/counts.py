"""Operations and bytes of the nets and kernels, as functions of shapes.

The yardstick of the mfu and roofline metrics. Each input byte is counted
once and each output byte once, whatever a kernel reads again; a
convolution's operations are 2 per multiply-add.
"""

from __future__ import annotations

from typing import List, NamedTuple

# (kernel, features, dilation, pool) per block, as published
# (dynseg_torch.models.dilated._ARCH; Nogueira et al., TGRS 2019).
ARCH = {
    "dilated_icpr_rate6": ((5, 64, 1, True), (5, 64, 2, True), (4, 128, 3, True),
                           (4, 128, 4, True), (3, 256, 5, True), (3, 256, 6, True)),
    "dilated_grsl_rate8": ((5, 64, 1, True), (5, 64, 2, True), (4, 128, 3, True),
                           (4, 128, 4, True), (3, 192, 6, True), (3, 192, 8, True)),
}


class Block(NamedTuple):
    k: int
    cin: int
    cout: int
    dilation: int
    pool: bool


def blocks(net: str, bands: int, width: float = 1.0) -> List[Block]:
    """The conv blocks of `net` on `bands` input channels."""
    out, cin = [], bands
    for k, feats, dil, pool in ARCH[net]:
        cout = max(1, int(feats * width))
        out.append(Block(k, cin, cout, dil, pool))
        cin = cout
    return out


def block_macs(b: Block) -> int:
    """Multiply-adds of one block per output pixel."""
    return b.k * b.k * b.cin * b.cout


def macs_per_px(net: str, bands: int, classes: int, width: float = 1.0) -> int:
    """Multiply-adds of one pixel-forward: every block and the 1x1 head."""
    bs = blocks(net, bands, width)
    return sum(block_macs(b) for b in bs) + bs[-1].cout * classes


def quantized(net: str, bands: int, min_ch: int, width: float = 1.0) -> List[bool]:
    """Per block: True where both channel counts reach `min_ch` (the
    port's int8 plan)."""
    return [min(b.cin, b.cout) >= min_ch for b in blocks(net, bands, width)]


def split_macs(net: str, bands: int, classes: int, min_ch: int,
               width: float = 1.0):
    """(float multiply-adds, int8 multiply-adds) of one pixel-forward under
    the int8 plan at `min_ch`; the head is float."""
    bs = blocks(net, bands, width)
    q = quantized(net, bands, min_ch, width)
    i8 = sum(block_macs(b) for b, on in zip(bs, q) if on)
    return macs_per_px(net, bands, classes, width) - i8, i8


def train_step_flops(net: str, bands: int, classes: int, batch: int, size: int,
                     width: float = 1.0) -> float:
    """Forward, input-gradient (none for the input image) and weight-
    gradient operations of one train step on batch x size^2 pixels."""
    bs = blocks(net, bands, width)
    m = macs_per_px(net, bands, classes, width)
    per_px = 2 * m + 2 * (m - block_macs(bs[0])) + 2 * m
    return float(per_px) * batch * size * size


def k2_bytes(batch: int, size: int, channels: int, image_bytes: int = 1,
             mask_bytes: int = 1) -> int:
    """K2 (patch gather): the tile pixels and labels it reads, the float32
    images and int64 labels it writes, and the positions and augment ids."""
    px = batch * size * size
    return px * (channels * image_bytes + mask_bytes + 4 * channels + 8) + batch * 16


def k4_bytes(batch: int, h: int, w: int, c: int) -> int:
    """K4 (max-pool backward): x, y, g read and dx written, float32."""
    return 16 * batch * h * w * c


def k5_ops(batch: int, h: int, w: int, cin: int, cout: int, k: int) -> float:
    """K5 (int8 block conv): 2 operations per multiply-add."""
    return 2.0 * batch * h * w * cin * cout * k * k


def k5_bytes(batch: int, h: int, w: int, cin: int, cout: int, k: int,
             out_bytes: int) -> int:
    """K5: int8 input and weights read, the folded affine read, the output
    written (1 byte requantized, 4 float32)."""
    return batch * h * w * (cin + cout * out_bytes) + k * k * cin * cout + 8 * cout


def k5_launches(net: str, bands: int, min_ch: int, batch: int, ext: int,
                width: float = 1.0):
    """The K5 launches of one forward of `batch` x ext^2 under the int8 plan:
    (ops, bytes) each. A block whose successor is quantized stores int8,
    the last quantized block float32."""
    bs = blocks(net, bands, width)
    q = quantized(net, bands, min_ch, width)
    out = []
    for i, (b, on) in enumerate(zip(bs, q)):
        if not on:
            continue
        nxt = i + 1 < len(bs) and q[i + 1]
        out.append((k5_ops(batch, ext, ext, b.cin, b.cout, b.k),
                    k5_bytes(batch, ext, ext, b.cin, b.cout, b.k, 1 if nxt else 4)))
    return out


def k4_launches(net: str, bands: int, batch: int, size: int, width: float = 1.0):
    """The K4 launches of one train step: bytes of each pooled block."""
    return [k4_bytes(batch, size, size, b.cout) for b in blocks(net, bands, width)
            if b.pool]


def window_origins(lo: int, hi: int, size: int, stride: int, lim: int) -> List[int]:
    """1-D origins of the windows that cover [lo, hi) (the estimator's
    grid, dynseg_torch.infer.window_origins): from size//2 before lo at
    `stride`, and a last window snapped to `lim` covering the right edge."""
    first = min(max(0, lo - size // 2), lim)
    origins = list(range(first, min(hi, lim + 1), stride))
    while origins[-1] + size < hi and origins[-1] < lim:
        origins.append(min(lim, origins[-1] + stride))
    out = [r for r in origins if r < hi]
    return out or [min(lim, max(0, lo))]


def window_stride(size: int, fraction: float) -> int:
    """The stride of a scale's windows, clamped to the window."""
    return min(size, max(1, int(round(size * fraction))))


def windows_per_tile(h: int, w: int, pad: int, size: int, fraction: float) -> int:
    """Windows the grid defines on an h x w tile mirror-padded by `pad`."""
    st = window_stride(size, fraction)
    return (len(window_origins(pad, pad + h, size, st, h + 2 * pad - size))
            * len(window_origins(pad, pad + w, size, st, w + 2 * pad - size)))


def dense_groups(h: int, w: int, pad: int, block: int, block_batch: int):
    """(forwards, blocks a forward) of a tile in dense mode: the estimator's
    block grid (dynseg_torch.infer), the last block of a row or column
    snapped to the tile's edge, and its auto batch (8 where the tile has 8
    blocks, else all of them)."""
    b = max(1, min(block, h, w))

    def n(extent):
        ss = list(range(pad, pad + max(1, extent - b + 1), b))
        return len(ss) + (1 if ss[-1] + b < pad + extent else 0)

    nb = n(h) * n(w)
    bb = block_batch if block_batch > 0 else (8 if nb >= 8 else nb)
    return -(-nb // bb), bb
