"""Post-training int8 quantization for the serving path (counterpart of
dynseg/ops/quant.py).

The scheme is the reference's: per-output-channel symmetric int8 weights
(scale absmax_c/127), per-tensor symmetric int8 activations calibrated at
a high percentile of |input| over sample crops, and a MIXED forward that
quantizes only blocks whose channel dims are both >= min_ch. Between two
quantized blocks the activations stay int8: the earlier block requantizes
in its epilogue and its max-pool runs on the int8 codes.

Every pool of the forward goes through K6 (`ops.pool.max_pool_fwd`), one
pass that writes only the max in the output's own type: int8 codes pool
as int8, and the float block whose output streams int8 pools in float32
and quantizes the max once (equal to quantizing first, since the quantize
is monotone). Under compute_dtype bfloat16 the float pools stay on ATen
(`pool_forward`), and such a block quantizes first. Every other quantize
of a float map goes through K7 (`ops.pool.quantize_s8`), one pass that
reads the map, in place where it is a channel prefix of the dense
forward's feature buffer, and writes the int8 codes.

Every quantized block's conv goes through K5 (`ops.int8_conv`) with the
dequant and BN folded into y = A*acc + B. That is the port's only int8
route, whatever ModelConfig.quant_conv says: the reference's other route
is XLA's int8 conv emitter, which has no counterpart here. `pack_blocks`
prepares K5's operands once per model (packed weights, A, B and the
requant's 1/out_scale on the host), and `make_apply`'s forward reuses them,
so no launch folds, packs or reads a scale back from the device.

Under the dense wiring there is no int8 stream: every block reads the
channel concat of the input and of all earlier outputs. The forward keeps
them in one feature buffer, each output written once into its slot after
zero lead channels that round the input's slot up to 16 channels, and a
quantized block quantizes the buffer's channels up to its slot: its
concat input behind the zero lead, which meets zero rows of its packed
weights. K5 then sees a Cin that is a multiple of 16 wherever the slots'
widths are (the tensor cores), and sums the same int32s as on the concat.
A block that pools on K6 has it store the pooled map straight into its
slot (`max_pool_fwd_into`), and the head reads the block slots in place,
as a product over each pixel's channels whose rows lie the buffer's
width apart: no copy moves a block's output.

The activations run in ModelConfig.compute_dtype with the reference's
rounding points: each block casts its float input to it, K5 stores the
last int8 block's output in it, and the float blocks' BatchNorm runs in it
with the statistics cast to it (not float32 as in the train-capable nets
of `models`, whose BatchNorm is flax's). Logits are float32.

`variables` is the port's state_dict (see `bridge`); the forward takes and
returns NHWC tensors and runs NCHW channels_last inside.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from dynseg_torch.config import ModelConfig
from dynseg_torch.models.dilated import arch, compute_dtype, to_nchw
from dynseg_torch.ops.int8_conv import (PackedConv, int8_block_conv_packed,
                                       pack_conv)
from dynseg_torch.ops.pool import (max_pool_fwd, max_pool_fwd_into, pool_forward,
                                   quantize_s8)
from dynseg_torch.utils.profiling import span

# K5's tensor-core variant takes int8 channels in 16-byte pieces (TMA's
# stride rule); the dense forward's lead channels round the input up to it.
_CIN_ALIGN = 16


def _dense_wired(mcfg: ModelConfig) -> bool:
    return mcfg.net_type == "dilated_icpr_rate6_densely"


def block_specs(mcfg: ModelConfig, num_input_bands: int) -> List[dict]:
    """Per conv block: name, kernel, cin, cout, dilation, pool, with the
    width multiplier and the dense-concat wiring applied."""
    specs = []
    cin = num_input_bands
    total = num_input_bands
    for i, (k, feats, dil, pool) in enumerate(arch(mcfg)):
        cout = max(1, int(feats * mcfg.width_multiplier))
        specs.append({
            "name": f"DilatedConvBlock_{i}", "kernel": k, "cin": cin,
            "cout": cout, "dilation": dil, "pool": pool,
        })
        if _dense_wired(mcfg):
            total += cout
            cin = total
        else:
            cin = cout
    return specs


def dense_lead(bands: int) -> int:
    """The zero channels before the input bands in the dense forward's
    feature buffer: as many as round the bands' slot up to 16 channels."""
    return -bands % _CIN_ALIGN


def quant_plan(mcfg: ModelConfig, num_input_bands: int,
               min_ch: int = 128) -> List[bool]:
    """True per block iff both of its channel dims are >= min_ch."""
    return [min(s["cin"], s["cout"]) >= min_ch
            for s in block_specs(mcfg, num_input_bands)]


def _prefix(spec: dict) -> str:
    return f"blocks.{spec['name'].rsplit('_', 1)[1]}"


def _percentile(x: torch.Tensor, pct: float) -> torch.Tensor:
    """jnp.percentile(x, pct) with linear interpolation, in the same
    float32 arithmetic. Sorts instead of calling torch.quantile, which
    refuses inputs of more than 2**24 elements."""
    v = torch.sort(x.reshape(-1).float()).values
    n = v.numel()
    pos = torch.tensor(pct, dtype=torch.float32) / 100.0 * (n - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    w_high = pos - low
    w_low = 1.0 - w_high
    lo_i = int(low.clamp(0, n - 1))
    hi_i = int(high.clamp(0, n - 1))
    return v[lo_i] * w_low.to(v.device) + v[hi_i] * w_high.to(v.device)


def _pool(y: torch.Tensor, window: int, out_scale=None,
          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A block's pool: K6 on int8 codes and on float32, with the quantize
    to `out_scale` fused where given, stored into `out` where given (a
    slot of the dense forward's buffer) and then returned as it. A
    bfloat16 map pools on ATen, after the quantize where it streams int8
    (then its codes pool on K6), into a map of its own."""
    if y.dtype == torch.bfloat16:
        if out_scale is None:
            return pool_forward(y, window)
        y, out_scale = quantize_s8(y, out_scale), None
    if out is not None:
        return max_pool_fwd_into(y, window, out_scale, out)
    return max_pool_fwd(y, window, out_scale)


def _fold(mcfg: ModelConfig, p: Dict[str, torch.Tensor]):
    """A and B of a quantized block: the dequant sx*sw_c folded with BN or
    the conv bias. sx is the block's act_scale, which is also the scale of
    a streamed int8 input (the previous block's out_scale)."""
    a = (p["act_scale"] * p["w_scale"]).float()
    if mcfg.use_batch_norm:
        g = torch.rsqrt(p["bn.running_var"].float() + 1e-5) * p["bn.weight"]
        b = p["bn.bias"] - p["bn.running_mean"] * g
        a = a * g
    else:
        b = p["conv.bias"]
    return a, b


def _out_scale(variables, specs: List[dict], i: int):
    """The scale block i's output streams at in the sequential wiring: the
    next block's act_scale (the exit's after the last block), None where
    the next block runs in float."""
    if i + 1 == len(specs):
        return variables.get("exit.act_scale")
    return variables.get(_prefix(specs[i + 1]) + ".act_scale")


def pack_blocks(mcfg: ModelConfig, variables: Dict[str, torch.Tensor],
                stream: bool = True) -> Dict[str, PackedConv]:
    """K5's prepared operands of every quantized block, by block name.
    With `stream` (the serving forward) a block of the sequential wiring
    requantizes to its out_scale; without it (calibration), and where the
    next block runs in float, a block outputs the compute dtype. Under the
    dense wiring a block's weights gain zero rows for the feature buffer's
    lead channels (`dense_lead`), before its concat input's."""
    specs = block_specs(mcfg, int(variables["blocks.0.conv.weight"].shape[1]))
    dense = _dense_wired(mcfg)
    lead = dense_lead(specs[0]["cin"]) if dense else 0
    packed = {}
    for i, spec in enumerate(specs):
        p = _block_params(variables, spec)
        if "w_scale" not in p:
            continue
        out_scale = (_out_scale(variables, specs, i)
                     if stream and not dense else None)
        a, b = _fold(mcfg, p)
        packed[spec["name"]] = pack_conv(
            F.pad(p["conv.weight"].permute(2, 3, 1, 0), (0, 0, lead, 0)), a, b,
            dilation=spec["dilation"], leaky_slope=mcfg.leaky_slope,
            out_scale=out_scale, out_dtype=compute_dtype(mcfg))
    return packed


def _block_forward(mcfg: ModelConfig, spec: dict, p: Dict[str, torch.Tensor],
                   x: torch.Tensor, record: Optional[dict], calib_pct: float,
                   pc: Optional[PackedConv] = None, in_scale=None,
                   out_scale=None, out: Optional[torch.Tensor] = None):
    """One conv block on an NCHW (channels_last) tensor. `p` holds the
    block's entries with the "blocks.{i}." prefix stripped; `pc`, its K5
    operands, marks it quantized. When `in_scale` is set, `x` is already
    int8 at that scale; when `out_scale` is set, the epilogue requantizes
    (`pc` was packed with it) and the pool runs on int8, or a float
    block's pool quantizes its max. A pool on K6 stores into `out` where
    given, and y is then `out`. Returns (y, carried_scale), where
    carried_scale is out_scale iff y is int8."""
    dtype = compute_dtype(mcfg)
    if in_scale is None:
        x = x.to(dtype)
    if record is not None:
        # Calibration probe: this block's input range (float path only).
        record[spec["name"]] = _percentile(x.abs(), calib_pct)
    window = mcfg.pool_window if spec["pool"] else 0
    if pc is not None:
        xq = x if in_scale is not None else quantize_s8(x, p["act_scale"])
        y = int8_block_conv_packed(xq.permute(0, 2, 3, 1), pc).permute(0, 3, 1, 2)
        return (_pool(y, window, out=out) if window else y), out_scale
    if in_scale is not None:
        x = (x.float() * in_scale).to(dtype)
    y = F.conv2d(x, p["conv.weight"].to(dtype), padding="same",
                 dilation=spec["dilation"])

    def cast(name):
        return p[name].to(dtype)[:, None, None]

    if mcfg.use_batch_norm:
        # eps rounded to the compute dtype (the reference adds a bf16
        # 1e-5), as a host number: a device tensor made here would copy
        # from the host and hold the host up at every block.
        eps = float(torch.tensor(1e-5, dtype=dtype))
        inv = torch.rsqrt(cast("bn.running_var") + eps)
        y = ((y - cast("bn.running_mean")) * inv * cast("bn.weight")
             + cast("bn.bias"))
    else:
        y = y + cast("conv.bias")
    y = F.leaky_relu(y, mcfg.leaky_slope)
    if window:
        return _pool(y, window, out_scale, out), out_scale
    return (y if out_scale is None else quantize_s8(y, out_scale)), out_scale


def _block_params(variables: Dict[str, torch.Tensor], spec: dict) -> dict:
    prefix = _prefix(spec) + "."
    return {k[len(prefix):]: v for k, v in variables.items()
            if k.startswith(prefix)}


def _dense_forward(mcfg: ModelConfig, variables: Dict[str, torch.Tensor],
                   x: torch.Tensor, specs: List[dict], record: Optional[dict],
                   calib_pct: float, packed: Dict[str, PackedConv]) -> torch.Tensor:
    """The blocks of the dense wiring on one NHWC feature buffer in the
    compute dtype: `dense_lead` zero channels, the input bands, then each
    block's output in its slot, written once: by K6 where the block pools
    there, else by a copy. A float block reads its concat input from the
    bands to its slot; a quantized block quantizes from channel 0, the
    zero lead included (codes 0). Returns the head's input, the block
    slots, as an NHWC view of the buffer (no copy). The bands' copy, every
    assembled block input and every slot copy is a `quant.assemble`
    span."""
    lead = dense_lead(x.shape[-1])
    first = lead + x.shape[-1]  # the first block's slot
    buf = x.new_empty((*x.shape[:3], lead + specs[-1]["cin"] + specs[-1]["cout"]),
                      dtype=compute_dtype(mcfg))
    fm = buf.permute(0, 3, 1, 2)  # the NCHW view, channels_last strides
    with span("quant.assemble"):
        buf[..., :lead].zero_()
        buf[..., lead:first].copy_(x)
    for spec in specs:
        slot = lead + spec["cin"]
        p = _block_params(variables, spec)
        pc = packed.get(spec["name"])
        with span("quant.assemble"):
            if pc is None:
                h = fm[:, lead:slot].contiguous(memory_format=torch.channels_last)
            else:
                h = quantize_s8(fm[:, :slot], p["act_scale"])
        if record is not None:
            # Calibration probe: the concat input, without the lead.
            record[spec["name"]] = _percentile(fm[:, lead:slot].abs(), calib_pct)
        dest = fm[:, slot:slot + spec["cout"]]
        out, _ = _block_forward(mcfg, spec, p, h, None, calib_pct, pc,
                                in_scale=None if pc is None else p["act_scale"],
                                out=dest)
        if out is not dest:
            with span("quant.assemble"):
                dest.copy_(out)
    slots = buf[..., first:]
    if record is not None:
        record["__head__"] = _percentile(slots.abs(), calib_pct)
    return slots


def _forward(mcfg: ModelConfig, variables: Dict[str, torch.Tensor],
             x: torch.Tensor, record: Optional[dict] = None,
             calib_pct: float = 99.9,
             packed: Optional[Dict[str, PackedConv]] = None) -> torch.Tensor:
    """(B, H, W, C) float32 -> (B, H, W, num_classes) float32 logits.
    `packed` is `pack_blocks(mcfg, variables)`, made here when not given."""
    if packed is None:
        packed = pack_blocks(mcfg, variables, stream=record is None)
    dtype = compute_dtype(mcfg)
    head = variables["head.conv.weight"].to(dtype)
    specs = block_specs(mcfg, x.shape[-1])
    if _dense_wired(mcfg):
        slots = _dense_forward(mcfg, variables, x.float(), specs, record,
                               calib_pct, packed)
        # The 1x1 head as one matrix product whose rows, the pixels, lie
        # the buffer's width apart: read in place. (cuDNN's convolution
        # reads the slots only through a copy, and the whole buffer with
        # zero weights for the lead and bands at a slower engine.)
        logits = F.linear(slots.reshape(-1, slots.shape[-1]), head[:, :, 0, 0])
        logits = logits.view(*slots.shape[:3], -1)
    else:
        h = to_nchw(x.float())
        carried = None  # h is int8 at this scale when set
        for i, spec in enumerate(specs):
            # Stream int8 only outside calibration (the probe must see
            # every block's float input).
            out_scale = _out_scale(variables, specs, i) if record is None else None
            h, carried = _block_forward(
                mcfg, spec, _block_params(variables, spec), h, record,
                calib_pct, packed.get(spec["name"]), in_scale=carried,
                out_scale=out_scale)
        if record is not None:
            record["__head__"] = _percentile(h.abs(), calib_pct)
        if carried is not None:
            # int8 exit: dequantize the last block's int8 map for the head.
            h = (h.float() * carried).to(dtype)
        logits = F.conv2d(h.to(dtype), head).permute(0, 2, 3, 1)
    logits = logits + variables["head.conv.bias"].to(dtype)
    return logits.float()


def make_apply(mcfg: ModelConfig):
    """An `apply_fn(variables, x)` over the port's state_dict: the int8
    path for blocks that carry a "w_scale", the float mirror otherwise.
    K5's operands are prepared at the first call with a state_dict and
    kept while the same dict object is passed; a new dict (not one edited
    in place) is prepared anew."""
    cache: dict = {}

    def apply_fn(variables, x):
        if cache.get("variables") is not variables:
            cache.update(variables=variables, packed=pack_blocks(mcfg, variables))
        return _forward(mcfg, variables, x, packed=cache["packed"])

    return apply_fn


@torch.inference_mode()
def calibrate(mcfg: ModelConfig, variables, crops: Sequence[torch.Tensor],
              calib_pct: float = 99.9) -> Dict[str, float]:
    """Per-block input ranges over normalized crops: for each block the
    max over crops of the calib_pct percentile of |input|."""
    ranges: Dict[str, float] = {}
    for crop in crops:
        if crop.dim() == 3:
            crop = crop[None]
        rec: dict = {}
        _forward(mcfg, variables, crop, record=rec, calib_pct=calib_pct)
        for name, val in rec.items():
            ranges[name] = max(ranges.get(name, 0.0), float(val))
    return ranges


def quantize_variables(mcfg: ModelConfig, variables: Dict[str, torch.Tensor],
                       act_ranges: Dict[str, float],
                       num_input_bands: Optional[int] = None,
                       min_ch: int = 128, exit_int8: bool = False):
    """The float state_dict -> the mixed-precision serving state_dict:
    selected blocks' kernels become int8 and gain act_scale / w_scale.
    The weight arithmetic is the reference's numpy, on the HWIO kernel,
    so the int8 kernels and scales are bitwise those of dynseg."""
    bands = (num_input_bands if num_input_bands is not None
             else mcfg.num_input_bands)
    out = dict(variables)
    chosen = 0
    for spec, q in zip(block_specs(mcfg, bands),
                       quant_plan(mcfg, bands, min_ch=min_ch)):
        if not q:
            continue
        name, prefix = spec["name"], _prefix(spec)
        rng = act_ranges.get(name, 0.0)
        if rng <= 0.0:
            raise ValueError(
                f"no calibration range for quantized block {name}; run "
                f"calibrate() on sample crops first")
        weight = variables[prefix + ".conv.weight"]
        w = np.transpose(weight.detach().cpu().numpy().astype(np.float32),
                         (2, 3, 1, 0))
        absmax = np.abs(w).reshape(-1, w.shape[-1]).max(axis=0)
        w_scale = np.maximum(absmax, 1e-12) / 127.0  # (cout,)
        wq = np.round(np.clip(w / w_scale, -127, 127)).astype(np.int8)
        dev = weight.device
        out[prefix + ".conv.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.transpose(wq, (3, 2, 0, 1)))).to(dev)
        out[prefix + ".act_scale"] = torch.tensor(
            rng / 127.0, dtype=torch.float32, device=dev)
        out[prefix + ".w_scale"] = torch.from_numpy(
            w_scale.astype(np.float32)).to(dev)
        chosen += 1
    if not chosen:
        raise ValueError(
            f"int8 quantization selected no blocks (min_ch={min_ch}, "
            f"net={mcfg.net_type}, width={mcfg.width_multiplier}): every "
            f"layer is below the threshold; run without --quant or lower "
            f"--quant_min_ch")
    if exit_int8:
        if _dense_wired(mcfg):
            raise ValueError(
                "exit_int8 requires sequential wiring (the dense-concat "
                "variant has no single exit stream)")
        rng = act_ranges.get("__head__", 0.0)
        if rng <= 0.0:
            raise ValueError(
                "no '__head__' calibration range for exit_int8; run "
                "calibrate() (it records the head input range)")
        out["exit.act_scale"] = torch.tensor(
            rng / 127.0, dtype=torch.float32,
            device=variables["head.conv.weight"].device)
    return out
