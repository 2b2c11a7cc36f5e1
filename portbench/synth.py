"""Tiles and weights made on the device from the seed.

Tiles (as `dynseg_torch.data.load_synthetic` makes them, at a
configuration's tile sizes): smooth class fields whose argmax gives the
four common classes, two rare classes laid over them as small blobs at
their stated shares (car, clutter), a band signature per class and
Gaussian noise, rounded to 8-bit values as the orthophotos are.

Weights: He-normal conv kernels (std sqrt(2 / fan_in)), the head's
LeCun-normal (std sqrt(1 / fan_in)) with a zero bias, BatchNorm scale 1
and bias 0, drawn in one call on the device. `bn_from_crops` gives the
BatchNorm running statistics of a plain train-mode forward over crops of
the tiles, so that an eval-mode net's probabilities are not degenerate.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.counts import Net

# Salts that keep the seed's streams apart.
_TILES, _WEIGHTS, _SAMPLE = 0x7115, 0x3E16, 0x5A3B


def generator(seed: int, salt: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 0x9E3779B1 + salt) % (2 ** 63))
    return g


def _smooth(g, n: int, h: int, w: int, cell: int, device) -> torch.Tensor:
    low = torch.randn((1, n, h // cell + 2, w // cell + 2), generator=g, device=device)
    return F.interpolate(low, size=(h + 2 * cell, w + 2 * cell), mode="bilinear",
                         align_corners=False)[0, :, cell:cell + h, cell:cell + w]


def _top_share(field: torch.Tensor, share: float) -> torch.Tensor:
    """Mask of the `share` largest values of field (threshold from a
    strided sample)."""
    sample = field.reshape(-1)[::61].float()
    k = max(1, int(round((1.0 - share) * sample.numel())))
    return field > torch.kthvalue(sample.cpu(), k).values.to(field.device)


def make_tiles(data: dict, split: str, seed: int, device) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Images (h, w, bands) uint8 and masks (h, w) uint8 on `device`, one
    per tile of data[split + "_tiles_hw"]."""
    g = generator(seed, _TILES + (0 if split == "train" else 1), device)
    nc, bands = data["num_classes"], data["bands"]
    sig = torch.tensor(data["band_signatures"], dtype=torch.float32, device=device)
    rare = data["rare_classes"]  # {class id: [share, blob px]}
    common = [c for c in range(nc) if str(c) not in rare]
    images, masks = [], []
    for h, w in data[f"{split}_tiles_hw"]:
        fields = _smooth(g, len(common), h, w, data["region_px"], device)
        mask = torch.tensor(common, device=device)[fields.argmax(0)]
        for c, (share, blob) in sorted(rare.items()):
            mask[_top_share(_smooth(g, 1, h, w, blob, device)[0], share)] = int(c)
        noise = torch.randn((h, w, bands), generator=g, device=device)
        img = torch.round(sig[mask] + data["noise"] * noise).clamp(0, 255)
        images.append(img.to(torch.uint8))
        masks.append(mask.to(torch.uint8))
    return images, masks


def stats(images: Sequence[torch.Tensor]) -> Tuple[np.ndarray, np.ndarray]:
    """Per-band mean and std (float32) over every pixel of the tiles, in
    float64, as the loaders compute them over the training tiles."""
    n, s, sq = 0, 0.0, 0.0
    for img in images:
        x = img.reshape(-1, img.shape[-1]).double()
        n += x.shape[0]
        s = s + x.sum(0)
        sq = sq + (x * x).sum(0)
    mean = s / n
    std = torch.sqrt(torch.clamp(sq / n - mean * mean, min=0.0))
    std = torch.where(std < 1e-6, torch.ones_like(std), std)
    return mean.float().cpu().numpy(), std.float().cpu().numpy()


def make_weights(net: Net, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 weights of `net` (`counts.net` of the configuration) by the
    port's state_dict names, on `device`: the blocks' kernels in order,
    then the head's, from one draw."""
    bs = net.blocks
    shapes = [(b.cout, b.cin, b.k, b.k) for b in bs] + [(net.classes, net.head_cin, 1, 1)]
    sizes = [int(np.prod(s)) for s in shapes]
    flat = torch.randn(sum(sizes), generator=generator(seed, _WEIGHTS, device),
                       device=device)
    out, at = {}, 0
    for i, (shape, n) in enumerate(zip(shapes, sizes)):
        fan_in = shape[1] * shape[2] * shape[3]
        gain = 2.0 if i < len(bs) else 1.0
        w = flat[at:at + n].reshape(shape) * float(np.sqrt(gain / fan_in))
        at += n
        if i < len(bs):
            out[f"blocks.{i}.conv.weight"] = w
            out[f"blocks.{i}.bn.weight"] = torch.ones(shape[0], device=device)
            out[f"blocks.{i}.bn.bias"] = torch.zeros(shape[0], device=device)
            out[f"blocks.{i}.bn.running_mean"] = torch.zeros(shape[0], device=device)
            out[f"blocks.{i}.bn.running_var"] = torch.ones(shape[0], device=device)
        else:
            out["head.conv.weight"] = w
            out["head.conv.bias"] = torch.zeros(shape[0], device=device)
    return out


@torch.no_grad()
def bn_from_crops(weights: Dict[str, torch.Tensor], net: Net, images, mean, std,
                  seed: int, n: int = 8, side: int = 128) -> None:
    """Set the running statistics to the batch statistics of one plain
    train-mode forward over n crops drawn from the seed."""
    from portbench.reference.net import forward

    g = np.random.default_rng([int(seed) % 2 ** 63, _SAMPLE])
    dev = images[0].device
    m = torch.as_tensor(mean, device=dev)
    s = torch.as_tensor(std, device=dev)
    side = min(side, *(min(im.shape[:2]) for im in images))
    crops = []
    for i in range(n):
        img = images[i % len(images)]
        y = int(g.integers(0, img.shape[0] - side + 1))
        x = int(g.integers(0, img.shape[1] - side + 1))
        crops.append((img[y:y + side, x:x + side].float() - m) / s)
    st: list = []
    forward(weights, torch.stack(crops), net, train=True, stats=st)
    for i, (mu, var) in enumerate(st):
        weights[f"blocks.{i}.bn.running_mean"] = mu
        weights[f"blocks.{i}.bn.running_var"] = var


def flax_tree(weights: Dict[str, torch.Tensor], net: Net) -> dict:
    """The Flax-shaped numpy tree `Trainer.init_state(variables=...)` takes."""
    def np_(t):
        return t.detach().cpu().numpy()

    params, stats_ = {}, {}
    for i in range(len(net.blocks)):
        name = f"DilatedConvBlock_{i}"
        params[name] = {
            "Conv_0": {"kernel": np.ascontiguousarray(
                np_(weights[f"blocks.{i}.conv.weight"]).transpose(2, 3, 1, 0))},
            "BatchNorm_0": {"scale": np_(weights[f"blocks.{i}.bn.weight"]),
                            "bias": np_(weights[f"blocks.{i}.bn.bias"])}}
        stats_[name] = {"BatchNorm_0": {"mean": np_(weights[f"blocks.{i}.bn.running_mean"]),
                                        "var": np_(weights[f"blocks.{i}.bn.running_var"])}}
    params["ScoreHead_0"] = {"Conv_0": {
        "kernel": np.ascontiguousarray(np_(weights["head.conv.weight"]).transpose(2, 3, 1, 0)),
        "bias": np_(weights["head.conv.bias"])}}
    return {"params": params, "batch_stats": stats_}
