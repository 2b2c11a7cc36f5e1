"""The plain reference of the dilated nets: forward (train or eval
BatchNorm, float32 or the int8 serving blocks) in plain PyTorch, NCHW.

Written from the published description (Nogueira et al., TGRS 2019) and
the reference package's stated semantics, not from dynseg_torch:

  * a block is conv (dilated, SAME as XLA pads it: the odd pixel after,
    stride 1, no bias under BatchNorm) -> BatchNorm -> leaky-ReLU (0.1)
    -> 3x3 stride-1 SAME max-pool where the block pools; the head is a 1x1
    conv with bias;
  * the wiring is the configuration's: sequential, each block reading the
    one before it; or dense (SURVEY.md C7), each block reading the channel
    concat of the input bands and of every earlier block's output, in that
    order, and the head the concat of all block outputs, input excluded;
  * train-mode BatchNorm is Flax's: mean and max(0, E[x^2] - E[x]^2) over
    (N, H, W), y = (x - mean) * (rsqrt(var + 1e-5) * scale) + bias;
  * the max-pool's gradient splits a tie evenly among the maxima of a
    window (the reference's pool-backward kernel), not to the first;
  * int8 blocks: int8 codes x int8 per-output-channel weights summed
    exactly, y = A * acc + B with the dequantization and BatchNorm folded
    into A and B, leaky-ReLU, then requantized to the next block's scale
    where that block is int8; pools run on the codes. Under dense wiring
    there is no int8 stream: each int8 block quantizes its own float32
    concat input at its act_scale, outputs float32 and pools in float.

`tf32=True` rounds every float convolution's operands to TF32 (10
mantissa bits, to nearest even) and accumulates in float32: the tensor
cores' TF32 mode, the control of the float32 cells. TF32 is otherwise
off, so cuDNN computes in full float32.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from portbench.counts import Net

EPS = 1e-5
LEAKY = 0.1
IGNORE = 255


def no_tf32() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties to even), kept in float32;
    the gradient passes through unchanged."""
    bits = x.detach().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    out = ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)
    out = torch.where(torch.isfinite(x.detach()), out, x.detach())
    return x + (out - x).detach() if x.requires_grad else out


def same_pads(k: int, dilation: int):
    ext = (k - 1) * dilation
    return ext // 2, ext - ext // 2


def conv(x: torch.Tensor, w: torch.Tensor, dilation: int, tf32: bool = False,
         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SAME dilated conv of NCHW x with OIHW w, padded as XLA pads."""
    lo, hi = same_pads(w.shape[-1], dilation)
    if tf32:
        x, w = round_tf32(x), round_tf32(w)
    return F.conv2d(F.pad(x, (lo, hi, lo, hi)), w, bias, dilation=dilation)


def pool(x: torch.Tensor, window: int = 3) -> torch.Tensor:
    lo = (window - 1) // 2
    hi = window - 1 - lo
    return F.max_pool2d(F.pad(x, (lo, hi, lo, hi), value=float("-inf")),
                        window, stride=1)


class TieSplitPool(torch.autograd.Function):
    """3x3 stride-1 SAME max-pool whose gradient splits among tied maxima:
    cnt[s] = #{taps of s equal to y[s]}, dx[r] = sum over the windows s
    holding r of [x[r] == y[s]] * g[s] / cnt[s]."""

    @staticmethod
    def forward(ctx, x):
        y = pool(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        h, w = x.shape[2:]
        nan = float("nan")
        offs = [(a, b) for a in (-1, 0, 1) for b in (-1, 0, 1)]

        def sh(t, a, b):
            return t[:, :, 1 + a:1 + a + h, 1 + b:1 + b + w]

        xp = F.pad(x, (1, 1, 1, 1), value=nan)
        cnt = sum((sh(xp, a, b) == y).float() for a, b in offs)
        gp = F.pad(g / cnt.clamp(min=1.0), (1, 1, 1, 1))
        yp = F.pad(y, (1, 1, 1, 1), value=nan)
        return sum(torch.where(x == sh(yp, a, b), sh(gp, a, b), 0.0)
                   for a, b in offs)


def bn_train(x: torch.Tensor, scale, bias):
    mean = x.mean((0, 2, 3))
    var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + EPS) * scale
    return (x - mean[:, None, None]) * mul[:, None, None] + bias[:, None, None], mean, var


def bn_eval(x, p: Dict[str, torch.Tensor], i: int):
    inv = torch.rsqrt(p[f"blocks.{i}.bn.running_var"] + EPS)
    return ((x - p[f"blocks.{i}.bn.running_mean"][:, None, None]) * inv[:, None, None]
            * p[f"blocks.{i}.bn.weight"][:, None, None]
            + p[f"blocks.{i}.bn.bias"][:, None, None])


def percentile(x: torch.Tensor, pct: float) -> float:
    """numpy's linear-interpolation percentile of x, in float32."""
    v = torch.sort(x.reshape(-1).float()).values
    n = v.numel()
    pos = torch.tensor(pct, dtype=torch.float32) / 100.0 * (n - 1)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    wh = (pos - lo).to(v.device)
    return float(v[int(lo)] * (1.0 - wh) + v[int(hi)] * wh)


def quantize_codes(x: torch.Tensor, scale: float) -> torch.Tensor:
    return torch.round(torch.clamp(x / scale, -127.0, 127.0))


def int8_conv(codes: torch.Tensor, wq: torch.Tensor, dilation: int) -> torch.Tensor:
    """Exact integer sum of int8 codes x int8 weights (float64 carries it:
    every partial sum is an integer far below 2^53)."""
    return torch.round(conv(codes.double(), wq.double(), dilation)).float()


def concat(maps: List[torch.Tensor]) -> torch.Tensor:
    """Dense wiring's channel concat, in the order given."""
    return torch.cat(maps, 1)


def forward(params: Dict[str, torch.Tensor], x: torch.Tensor, net: Net,
            train: bool = False, tf32: bool = False, tie_split: bool = False,
            quant: Optional[dict] = None, record: Optional[List[torch.Tensor]] = None,
            stats: Optional[list] = None) -> torch.Tensor:
    """(B, H, W, C) float32 -> (B, H, W, classes) float32 logits of `net`
    (`counts.net` of the configuration).

    train: Flax's train-mode BatchNorm (batch statistics, appended to
    `stats` as (mean, var) per block); else the running statistics.
    tie_split: the pools' gradient splits ties. quant: the int8 plan
    (`segment.quantize`). record: each block's float input appended, then
    the head's (calibration)."""
    dense = net.wiring == "dense"
    h = x.permute(0, 3, 1, 2).contiguous()
    feats = [h]
    q = quant["blocks"] if quant else [None] * len(net.blocks)
    codes = None  # h holds int8 codes at this scale when set
    for i, b in enumerate(net.blocks):
        if dense:
            h = concat(feats)
        if record is not None:
            record.append(h)
        nxt = q[i + 1] if not dense and i + 1 < len(q) else None
        if q[i] is not None:
            qi = q[i]
            c = h if codes is not None else quantize_codes(h, qi["act_scale"])
            y = qi["a"][:, None, None] * int8_conv(c, qi["wq"], b.dilation) \
                + qi["b"][:, None, None]
        else:
            y = conv(h, params[f"blocks.{i}.conv.weight"], b.dilation, tf32)
            if train:
                y, mean, var = bn_train(y, params[f"blocks.{i}.bn.weight"],
                                        params[f"blocks.{i}.bn.bias"])
                if stats is not None:
                    stats.append((mean.detach(), var.detach()))
            else:
                y = bn_eval(y, params, i)
        y = F.leaky_relu(y, LEAKY)
        if nxt is not None:
            if q[i] is not None:
                y = torch.round(torch.clamp(y * nxt["inv_scale"], -127.0, 127.0))
            else:
                y = quantize_codes(y, nxt["act_scale"])
            codes = nxt["act_scale"]
        else:
            codes = None
        if b.pool:
            y = TieSplitPool.apply(y) if tie_split else pool(y)
        h = y
        if dense:
            feats.append(h)
    if dense:
        h = concat(feats[1:])
    if record is not None:
        record.append(h)
    logits = conv(h, params["head.conv.weight"], 1, tf32, params["head.conv.bias"])
    return logits.permute(0, 2, 3, 1)
