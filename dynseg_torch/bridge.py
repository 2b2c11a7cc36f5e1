"""Weights carried between dynseg's Flax variables tree and this package.

A Flax tree here is the reference's variables dict held as numpy arrays:

    params/DilatedConvBlock_{i}/Conv_0/{kernel HWIO, bias}
    params/DilatedConvBlock_{i}/BatchNorm_0/{scale, bias}
    batch_stats/DilatedConvBlock_{i}/BatchNorm_0/{mean, var}
    params/ScoreHead_0/Conv_0/{kernel, bias}
    quant/DilatedConvBlock_{i}/{act_scale, w_scale}, quant/__exit__/act_scale

and the port's state_dict names the same numbers

    blocks.{i}.conv.{weight OIHW, bias}
    blocks.{i}.bn.{weight, bias, running_mean, running_var}
    head.conv.{weight, bias}
    blocks.{i}.{act_scale, w_scale}, exit.act_scale

Kernels keep their dtype (an int8 kernel of a quantized block stays int8).
The SGD momentum buffers of the port's optimizer carry across as optax's
`trace` state, a tree shaped like params (`momentum_to_flax`,
`load_momentum`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from dynseg.config import ModelConfig

# Flax BatchNorm_0 leaf -> torch bn leaf, for params and for batch_stats.
_BN = {"scale": "weight", "bias": "bias"}
_STATS = {"mean": "running_mean", "var": "running_var"}
_BN_BACK = {v: k for k, v in _BN.items()}
_STATS_BACK = {v: k for k, v in _STATS.items()}


def _block_index(name: str) -> int:
    return int(name.rsplit("_", 1)[1])


def flax_to_torch(variables) -> Dict[str, torch.Tensor]:
    """Flax variables tree (numpy leaves) -> the port's state_dict. A tree
    without batch_stats (a params-shaped tree such as an optimizer trace)
    gives the parameter entries only."""
    sd: Dict[str, torch.Tensor] = {}

    def put(key, value):
        sd[key] = torch.from_numpy(np.array(value, order="C"))

    params = variables["params"]
    stats = variables.get("batch_stats", {})
    for name, block in params.items():
        if name == "ScoreHead_0":
            prefix = "head"
        else:
            prefix = f"blocks.{_block_index(name)}"
        conv = block["Conv_0"]
        put(f"{prefix}.conv.weight", np.transpose(conv["kernel"], (3, 2, 0, 1)))
        if "bias" in conv:
            put(f"{prefix}.conv.bias", conv["bias"])
        if "BatchNorm_0" in block:
            for src, dst in _BN.items():
                put(f"{prefix}.bn.{dst}", block["BatchNorm_0"][src])
            if name in stats:
                for src, dst in _STATS.items():
                    put(f"{prefix}.bn.{dst}", stats[name]["BatchNorm_0"][src])
                sd[f"{prefix}.bn.num_batches_tracked"] = torch.tensor(0)
    for name, q in variables.get("quant", {}).items():
        prefix = "exit" if name == "__exit__" else f"blocks.{_block_index(name)}"
        for key, value in q.items():
            put(f"{prefix}.{key}", value)
    return sd


def torch_to_flax(state_dict: Dict[str, torch.Tensor]) -> dict:
    """The port's state_dict -> Flax variables tree with numpy leaves."""
    params: dict = {}
    stats: dict = {}
    quant: dict = {}
    for key, tensor in state_dict.items():
        value = tensor.detach().cpu().numpy()
        parts = key.split(".")
        if parts[0] == "exit":
            quant.setdefault("__exit__", {})[parts[1]] = value
            continue
        name = ("ScoreHead_0" if parts[0] == "head"
                else f"DilatedConvBlock_{parts[1]}")
        leaf = parts[-1]
        if leaf in ("act_scale", "w_scale"):
            quant.setdefault(name, {})[leaf] = value
        elif parts[-2] == "conv":
            conv = params.setdefault(name, {}).setdefault("Conv_0", {})
            if leaf == "weight":
                conv["kernel"] = np.ascontiguousarray(
                    np.transpose(value, (2, 3, 1, 0)))
            else:
                conv["bias"] = value
        elif leaf in _BN_BACK:
            bn = params.setdefault(name, {}).setdefault("BatchNorm_0", {})
            bn[_BN_BACK[leaf]] = value
        elif leaf in _STATS_BACK:
            bn = stats.setdefault(name, {}).setdefault("BatchNorm_0", {})
            bn[_STATS_BACK[leaf]] = value
        # num_batches_tracked has no Flax counterpart.
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    if quant:
        out["quant"] = quant
    return out


def momentum_to_flax(model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer) -> dict:
    """The optimizer's momentum buffers as optax's trace tree (numpy,
    params-shaped). A parameter without a buffer yet (no step taken)
    carries zeros, as optax's trace starts."""
    sd = {}
    for name, p in model.named_parameters():
        buf = optimizer.state.get(p, {}).get("momentum_buffer")
        sd[name] = torch.zeros_like(p) if buf is None else buf
    return torch_to_flax(sd)["params"]


def load_momentum(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                  trace) -> None:
    """Set the optimizer's momentum buffers from optax's trace tree."""
    sd = flax_to_torch({"params": trace})
    for name, p in model.named_parameters():
        optimizer.state[p]["momentum_buffer"] = (
            sd[name].to(device=p.device, dtype=p.dtype).clone())


def _lecun_normal(rng: np.random.Generator, shape) -> np.ndarray:
    """Flax's lecun_normal for an HWIO kernel: a normal truncated at two
    standard deviations, scaled to variance 1/fan_in."""
    fan_in = int(np.prod(shape[:-1]))
    std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
    z = rng.standard_normal(shape)
    bad = np.abs(z) > 2.0
    while bad.any():
        z[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(z) > 2.0
    return (z * std).astype(np.float32)


def init_variables_np(cfg: ModelConfig, num_input_bands: int,
                      seed: int = 0) -> dict:
    """A Flax-shaped variables tree built with numpy alone: lecun-normal
    kernels, zero biases, BatchNorm scale 1 / bias 0, running mean 0 /
    var 1. Feeds both packages the same numbers, and lets the port build
    full-width weights where JAX is not installed."""
    from dynseg_torch.ops.quant import block_specs

    rng = np.random.default_rng(seed)
    specs = block_specs(cfg, num_input_bands)
    params: dict = {}
    stats: dict = {}
    for spec in specs:
        k, cin, cout = spec["kernel"], spec["cin"], spec["cout"]
        conv = {"kernel": _lecun_normal(rng, (k, k, cin, cout))}
        block = {"Conv_0": conv}
        if cfg.use_batch_norm:
            block["BatchNorm_0"] = {"scale": np.ones(cout, np.float32),
                                    "bias": np.zeros(cout, np.float32)}
            stats[spec["name"]] = {"BatchNorm_0": {
                "mean": np.zeros(cout, np.float32),
                "var": np.ones(cout, np.float32)}}
        else:
            conv["bias"] = np.zeros(cout, np.float32)
        params[spec["name"]] = block
    if cfg.net_type == "dilated_icpr_rate6_densely":
        head_in = sum(s["cout"] for s in specs)
    else:
        head_in = specs[-1]["cout"]
    params["ScoreHead_0"] = {"Conv_0": {
        "kernel": _lecun_normal(rng, (1, 1, head_in, cfg.num_classes)),
        "bias": np.zeros(cfg.num_classes, np.float32)}}
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out
