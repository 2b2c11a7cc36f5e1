"""Operations and bytes of the nets and kernels, as functions of shapes.

The yardstick of the mfu and roofline metrics. Each input byte is counted
once and each output byte once, whatever a kernel reads again; a
convolution's operations are 2 per multiply-add.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

WIRINGS = ("sequential", "dense")


class Block(NamedTuple):
    k: int
    cin: int
    cout: int
    dilation: int
    pool: bool


class Net(NamedTuple):
    """A net as its configuration states it: the blocks with the width
    multiplier and the wiring applied, and the 1x1 head."""
    blocks: Tuple[Block, ...]
    wiring: str
    bands: int
    classes: int
    head_cin: int


def net(model: dict) -> Net:
    """The net of a configuration's `model`: `blocks` holds the published
    [kernel, features, dilation, pool] per block, `wiring` is "sequential"
    (block i reads block i-1's output) or "dense" (block i reads the
    channel concat of the input bands and of every earlier block's output;
    the head reads the concat of all block outputs, input excluded)."""
    wiring = model["wiring"]
    if wiring not in WIRINGS:
        raise ValueError(f"wiring {wiring!r} not in {WIRINGS}")
    bands, width = model["num_input_bands"], model.get("width_multiplier", 1.0)
    out, cin = [], bands
    for k, feats, dil, pool in model["blocks"]:
        cout = max(1, int(feats * width))
        out.append(Block(k, cin, cout, dil, bool(pool)))
        cin = cin + cout if wiring == "dense" else cout
    head = cin - bands if wiring == "dense" else cin
    return Net(tuple(out), wiring, bands, model["num_classes"], head)


def checked_net(model: dict) -> Net:
    """net(model), refused where the configuration's own `macs_per_px`
    is not what its blocks and wiring give."""
    n = net(model)
    if model.get("macs_per_px") != macs_per_px(n):
        raise ValueError(f"the configuration states macs_per_px {model.get('macs_per_px')}; "
                         f"its blocks and wiring give {macs_per_px(n)}")
    return n


def block_macs(b: Block) -> int:
    """Multiply-adds of one block per output pixel."""
    return b.k * b.k * b.cin * b.cout


def macs_per_px(n: Net) -> int:
    """Multiply-adds of one pixel-forward: every block and the 1x1 head."""
    return sum(block_macs(b) for b in n.blocks) + n.head_cin * n.classes


def quantized(n: Net, min_ch: int) -> List[bool]:
    """Per block: True where both channel counts reach `min_ch` (the
    port's int8 plan)."""
    return [min(b.cin, b.cout) >= min_ch for b in n.blocks]


def split_macs(n: Net, min_ch: int):
    """(float multiply-adds, int8 multiply-adds) of one pixel-forward under
    the int8 plan at `min_ch`; the head is float."""
    i8 = sum(block_macs(b) for b, on in zip(n.blocks, quantized(n, min_ch)) if on)
    return macs_per_px(n) - i8, i8


def train_step_flops(n: Net, batch: int, size: int) -> float:
    """Forward, input-gradient and weight-gradient operations of one train
    step on batch x size^2 pixels. An input gradient is counted only where
    there is one to take: for every input channel of a block or the head
    but the raw bands (sequential wiring: every block but block 0; dense:
    every channel of every concat but the input's)."""
    m = macs_per_px(n)
    raw = [n.bands if i == 0 or n.wiring == "dense" else 0 for i in range(len(n.blocks))]
    dgrad = sum(b.k * b.k * (b.cin - r) * b.cout for b, r in zip(n.blocks, raw)) \
        + n.head_cin * n.classes
    per_px = 2 * m + 2 * dgrad + 2 * m
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


def k5_launches(n: Net, min_ch: int, batch: int, ext: int):
    """The K5 launches of one forward of `batch` x ext^2 under the int8 plan:
    (ops, bytes) each. Under sequential wiring a block whose successor is
    quantized stores int8, the last quantized block float32; under dense
    wiring there is no int8 stream and every int8 block stores float32."""
    q = quantized(n, min_ch)
    out = []
    for i, (b, on) in enumerate(zip(n.blocks, q)):
        if not on:
            continue
        nxt = n.wiring == "sequential" and i + 1 < len(n.blocks) and q[i + 1]
        out.append((k5_ops(batch, ext, ext, b.cin, b.cout, b.k),
                    k5_bytes(batch, ext, ext, b.cin, b.cout, b.k, 1 if nxt else 4)))
    return out


def k4_launches(n: Net, batch: int, size: int):
    """The K4 launches of one train step: bytes of each pooled block."""
    return [k4_bytes(batch, size, size, b.cout) for b in n.blocks if b.pool]


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
