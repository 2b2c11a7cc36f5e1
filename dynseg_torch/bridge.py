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

import hashlib
from typing import Dict

import numpy as np
import torch

from dynseg_torch import jax_random
from dynseg_torch.config import ModelConfig

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


def batch_stats_to_torch(batch_stats) -> Dict[str, torch.Tensor]:
    """A Flax batch_stats tree (numpy leaves; the stats sidecar's
    ema_batch_stats) -> the port's BatchNorm running-statistics entries."""
    return {f"blocks.{_block_index(name)}.bn.{dst}":
            torch.from_numpy(np.array(block["BatchNorm_0"][src], order="C"))
            for name, block in batch_stats.items() for src, dst in _STATS.items()}


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


def _variables_tree(cfg: ModelConfig, num_input_bands: int, kernel) -> dict:
    """The Flax-shaped variables tree of `cfg`: `kernel(name, shape)` draws
    each HWIO kernel, biases are zero, BatchNorm scale 1 / bias 0, running
    mean 0 / var 1."""
    from dynseg_torch.ops.quant import block_specs

    specs = block_specs(cfg, num_input_bands)
    params: dict = {}
    stats: dict = {}
    for spec in specs:
        k, cin, cout = spec["kernel"], spec["cin"], spec["cout"]
        conv = {"kernel": kernel(spec["name"], (k, k, cin, cout))}
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
        "kernel": kernel("ScoreHead_0", (1, 1, head_in, cfg.num_classes)),
        "bias": np.zeros(cfg.num_classes, np.float32)}}
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out


def init_variables_np(cfg: ModelConfig, num_input_bands: int,
                      seed: int = 0) -> dict:
    """The tests' fixture draw, not the training path's: a Flax-shaped
    variables tree with lecun-normal kernels from
    `np.random.default_rng(seed)` (the same law as Flax's, other numbers),
    which the CPU tests and probes hand both packages as `variables=`.
    `init_variables_like_reference` is the draw `Trainer.init_state` makes."""
    rng = np.random.default_rng(seed)
    return _variables_tree(cfg, num_input_bands,
                           lambda name, shape: _lecun_normal(rng, shape))


def init_variables_like_reference(cfg: ModelConfig, num_input_bands: int,
                                  seed: int = 0) -> dict:
    """The variables tree that `dynseg.train.init_state_template(cfg,
    jax.random.key(seed))` builds (`model.init` of the Flax net), drawn in
    numpy by `jax_random`: each Conv kernel is Flax's lecun_normal under
    the key `Scope.make_rng("params")` gives it. Each scope counts its own
    calls from 1 and the kernel's is the first in its `Conv_0` scope, so
    its key folds the path (block, "Conv_0", 1) into `key(seed)`. Biases and BatchNorm parameters take no random
    numbers (their `make_rng` calls come after the kernel's and change
    nothing it draws)."""
    root = jax_random.key(seed)
    return _variables_tree(
        cfg, num_input_bands,
        lambda name, shape: jax_random.lecun_normal(
            jax_random.fold_in_static(root, (name, "Conv_0", 1)), shape))


def variables_sha256(variables) -> str:
    """SHA-256 of a variables tree with numpy leaves: each leaf's path,
    dtype, shape and C-order bytes, in sorted path order."""
    h = hashlib.sha256()

    def walk(tree, prefix):
        for name in sorted(tree):
            value = tree[name]
            if isinstance(value, dict):
                walk(value, f"{prefix}{name}/")
            else:
                a = np.ascontiguousarray(value)
                h.update(f"{prefix}{name}:{a.dtype.str}:{a.shape}".encode())
                h.update(a.tobytes())

    walk(variables, "")
    return h.hexdigest()


# `variables_sha256` of `init_variables_like_reference` for the full-width
# dilated_icpr_rate6 with 3 bands, by (num_classes, seed), which a host
# checks its own draw against. tests/test_torch_init.py holds the pins to
# the draw, and the draw to the reference's init.
REFERENCE_INIT_SHA256 = {
    (2, 0): "79f19ed6ec87017118dd66184ab02ae823d123be11762cc58cb79e7e1efa1192",
    (2, 1): "3fe4791f045fbc039800d8d03b27824d6f26a6bea595de0588ad3c429f8ec735",
    (2, 2): "49a6e5266bc6307f8ddfad5c0096115f321857015e0360cabccdf36692210cce",
    (2, 3): "adae93b0b56591f7b9b78eec5d65ce14ba09107c4c765fb089b56ceab81cf7b3",
    (2, 4): "49cec1e12c82451cce4222511e8bcda81fb77e8b0070eb3e8cbc4750c735c390",
    (6, 0): "328ddec5684e03b7e0c5bf99fe5ea23ce9112d7afbb9ab768f3016eade8ba69e",
    (6, 1): "ba9820736fef38719dbb470080364da6cad4b693be1fa52d7a2d8084712ae08c",
    (6, 2): "e086f6a25acf79a7e1a32b4e57ad45fdd4ad679f8e426f4cd4ce473537ece2b4",
    (6, 3): "579975395fe18bea720fb6252fb735343dcd88a5babb50262414d6eb164b3943",
    (6, 4): "18d4f42472950f16f5cb8bb76783d32b1a19d15a399a34099617376250d07243",
}
