"""Post-training int8 quantization for the serving path (counterpart of
dynseg/ops/quant.py).

The scheme is the reference's: per-output-channel symmetric int8 weights
(scale absmax_c/127), per-tensor symmetric int8 activations calibrated at
a high percentile of |input| over sample crops, and a MIXED forward that
quantizes only blocks whose channel dims are both >= min_ch. Between two
quantized blocks the activations stay int8: the earlier block requantizes
in its epilogue and its max-pool runs on the int8 codes.

Every quantized block's conv goes through K5 (`ops.int8_conv`) with the
dequant and BN folded into y = A*acc + B. That is the port's only int8
route, whatever ModelConfig.quant_conv says: the reference's other route
is XLA's int8 conv emitter, which has no counterpart here.

`variables` is the port's state_dict (see `bridge`); the forward takes and
returns NHWC tensors and runs NCHW channels_last inside.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from dynseg.config import ModelConfig
from dynseg_torch.models.dilated import arch, to_nchw
from dynseg_torch.ops.int8_conv import int8_block_conv
from dynseg_torch.ops.pool import pool_forward


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


def _quantize_act(x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.clamp(x.float() / sx, -127.0, 127.0)).to(torch.int8)


def _pool_int8(y: torch.Tensor, window: int) -> torch.Tensor:
    # No int8 max-pool on every device: pool the codes in float32, which
    # is exact, and cast back.
    return pool_forward(y.float(), window).to(torch.int8)


def _block_forward(mcfg: ModelConfig, spec: dict, p: Dict[str, torch.Tensor],
                   x: torch.Tensor, record: Optional[dict], calib_pct: float,
                   in_scale=None, out_scale=None):
    """One conv block on an NCHW (channels_last) tensor. `p` holds the
    block's entries with the "blocks.{i}." prefix stripped; a "w_scale"
    entry marks it quantized. When `in_scale` is set, `x` is already int8
    at that scale; when `out_scale` is set, the epilogue requantizes and
    the pool runs on int8. Returns (y, carried_scale), where
    carried_scale is out_scale iff y is int8."""
    if record is not None:
        # Calibration probe: this block's input range (float path only).
        record[spec["name"]] = _percentile(x.abs(), calib_pct)
    window = mcfg.pool_window if spec["pool"] else 0
    if "w_scale" in p:
        sx = in_scale if in_scale is not None else p["act_scale"]
        xq = x if in_scale is not None else _quantize_act(x, sx)
        a = (sx * p["w_scale"]).float()
        if mcfg.use_batch_norm:
            g = torch.rsqrt(p["bn.running_var"].float() + 1e-5) * p["bn.weight"]
            b = p["bn.bias"] - p["bn.running_mean"] * g
            a = a * g
        else:
            b = p["conv.bias"]
        y = int8_block_conv(
            xq.permute(0, 2, 3, 1), p["conv.weight"].permute(2, 3, 1, 0), a, b,
            dilation=spec["dilation"], leaky_slope=mcfg.leaky_slope,
            out_scale=out_scale).permute(0, 3, 1, 2)
        if out_scale is not None:
            return (_pool_int8(y, window) if window else y), out_scale
        return (pool_forward(y, window) if window else y), None
    if in_scale is not None:
        x = x.float() * in_scale
    y = F.conv2d(x, p["conv.weight"], padding="same", dilation=spec["dilation"])
    if mcfg.use_batch_norm:
        inv = torch.rsqrt(p["bn.running_var"] + 1e-5)
        y = ((y - p["bn.running_mean"][:, None, None]) * inv[:, None, None]
             * p["bn.weight"][:, None, None] + p["bn.bias"][:, None, None])
    else:
        y = y + p["conv.bias"][:, None, None]
    y = F.leaky_relu(y, mcfg.leaky_slope)
    if out_scale is not None:
        y = _quantize_act(y, out_scale)
        return (_pool_int8(y, window) if window else y), out_scale
    return (pool_forward(y, window) if window else y), None


def _block_params(variables: Dict[str, torch.Tensor], spec: dict) -> dict:
    prefix = _prefix(spec) + "."
    return {k[len(prefix):]: v for k, v in variables.items()
            if k.startswith(prefix)}


def _forward(mcfg: ModelConfig, variables: Dict[str, torch.Tensor],
             x: torch.Tensor, record: Optional[dict] = None,
             calib_pct: float = 99.9) -> torch.Tensor:
    """(B, H, W, C) float32 -> (B, H, W, num_classes) float32 logits."""
    specs = block_specs(mcfg, x.shape[-1])
    h = to_nchw(x.float())
    carried = None  # h is int8 at this scale when set
    if _dense_wired(mcfg):
        # Dense wiring mixes every earlier map into each input, so there
        # is no single int8 stream: each quantized block quantizes its
        # own concat input.
        feats = [h]
        for spec in specs:
            out, _ = _block_forward(
                mcfg, spec, _block_params(variables, spec),
                torch.cat(feats, dim=1), record, calib_pct)
            feats.append(out)
        h = torch.cat(feats[1:], dim=1)
    else:
        for i, spec in enumerate(specs):
            nxt = (variables.get("exit.act_scale") if i + 1 == len(specs)
                   else variables.get(_prefix(specs[i + 1]) + ".act_scale"))
            # Stream int8 only outside calibration (the probe must see
            # every block's float input).
            out_scale = nxt if record is None else None
            h, carried = _block_forward(
                mcfg, spec, _block_params(variables, spec), h, record,
                calib_pct, in_scale=carried, out_scale=out_scale)
    if record is not None:
        record["__head__"] = _percentile(h.abs(), calib_pct)
    if carried is not None:
        # int8 exit: dequantize the last block's int8 map for the head.
        h = h.float() * carried
    logits = F.conv2d(h, variables["head.conv.weight"])
    logits = logits + variables["head.conv.bias"][:, None, None]
    return logits.permute(0, 2, 3, 1)


def make_apply(mcfg: ModelConfig):
    """An `apply_fn(variables, x)` over the port's state_dict: the int8
    path for blocks that carry a "w_scale", the float mirror otherwise."""

    def apply_fn(variables, x):
        return _forward(mcfg, variables, x)

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
