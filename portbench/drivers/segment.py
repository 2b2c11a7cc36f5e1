"""Driver of the segmentation mixes: `infer.Inferencer` over whole tiles,
back to back, labels to the host, closed loop.

Set-up makes the tiles and the weights from the seed on the device (the
BatchNorm statistics from a plain forward over crops of the tiles),
builds the Inferencer, calibrates int8 where the mix asks for it, and
warms every shape the window uses. The window predicts tile after tile
(`predict_tile_dense` or `predict_tile`, labels only) until --seconds
have passed and the tile in progress is done.

The comparison: rectangles of the completed tiles, drawn from the seed
before the window (one at a corner of its tile, so the mirrored border
is in the sample), are recomputed by the plain reference from the raw
tiles and the weights; the reference's probabilities judge the labels
the program produced there.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import synth
from portbench.reference import segment as ref_seg

_RECTS = 0x2EC7


def config(r):
    from dynseg_torch.config import Config, InferConfig, ModelConfig

    m, x = r.config["model"], r.mix
    return Config(
        model=ModelConfig(net_type=m["net_type"], num_classes=m["num_classes"],
                          num_input_bands=m["num_input_bands"],
                          width_multiplier=m.get("width_multiplier", 1.0),
                          compute_dtype=m["compute_dtype"]),
        infer=InferConfig(mode=x["mode"], scales=tuple(x["scales"]),
                          stride_fraction=x["stride_fraction"],
                          window_batch=x["window_batch"], dense_block=x["dense_block"],
                          dense_halo=x["dense_halo"],
                          dense_block_batch=x["dense_block_batch"], quant=x["quant"],
                          quant_min_ch=x["quant_min_ch"],
                          quant_calib_pct=x["quant_calib_pct"],
                          quant_calib_crops=x["quant_calib_crops"],
                          save_prediction_maps=False),
    ).validate()


def rects_for(rng, h: int, w: int, side: int, n: int):
    """n rectangles (y0, y1, x0, x1) of a tile, the first at a corner."""
    sh, sw = min(side, h), min(side, w)
    out = []
    for i in range(n):
        if i == 0:
            y0 = 0 if rng.integers(2) else h - sh
            x0 = 0 if rng.integers(2) else w - sw
        else:
            y0 = int(rng.integers(0, h - sh + 1))
            x0 = int(rng.integers(0, w - sw + 1))
        out.append((y0, y0 + sh, x0, x0 + sw))
    return out


def predict(inf, variables, t: int, x: dict):
    """One tile's labels, and its probabilities where the mix takes them,
    on the host, by the mix's mode."""
    if x["mode"] == "dense":
        return inf.predict_tile_dense(variables, t, block=x["dense_block"],
                                      halo=x["dense_halo"], return_probs=x["probs"])
    return inf.predict_tile(variables, t, return_probs=x["probs"])


def warm(inf, variables, x: dict) -> None:
    """Every shape the window uses: a whole tile in dense mode (all its
    groups have one shape); in window mode every scale's window batch,
    on a small crop of tile 0 (a scale's batches are padded to one size)."""
    if x["mode"] == "dense":
        predict(inf, variables, 0, x)
        return
    p = inf.pad
    side = min(96, *(int(v) for v in inf.valid_hw[0]))
    tile = inf._tile(0)[:side + 2 * p, :side + 2 * p].contiguous()
    inf._window_device(variables, 0, override=(tile, side, side))


def numbers(answers, ref) -> dict:
    """Over the sampled pixels, the candidates a cell's limits choose from:
    label_gap, the widest gap by which the reference's probability of the
    program's label lies below its best; label_gap_mean, its mean;
    label_mismatch, the share of pixels where that gap is above 0; where the program's probabilities
    came to the host, prob_gap, their widest distance from the
    reference's, and answer_gap, the larger of prob_gap and label_gap."""
    label_gap = prob_gap = gap_sum = 0.0
    wrong = n = 0
    for (lab, probs), p in zip(answers, ref):
        lab = torch.as_tensor(lab, device=p.device).long()
        gap = p.max(-1).values - p.gather(-1, lab[..., None])[..., 0]
        label_gap = max(label_gap, float(gap.max()))
        wrong += int((gap > 0).sum())
        gap_sum += float(gap.double().sum())
        n += gap.numel()
        if probs is not None:
            prob_gap = max(prob_gap, float((torch.as_tensor(probs, device=p.device)
                                            - p).abs().max()))
    out = {"label_gap": label_gap, "label_mismatch": wrong / max(n, 1),
           "label_gap_mean": gap_sum / max(n, 1)}
    if all(a[1] is not None for a in answers):
        out.update(prob_gap=prob_gap, answer_gap=max(prob_gap, label_gap))
    return out


def reference_probs(r, weights, images, mean, std, kept, tf32: bool = False):
    """The reference's probabilities over each kept rectangle."""
    x = r.mix
    m = torch.as_tensor(mean, device=r.device)
    s = torch.as_tensor(std, device=r.device)
    quant = None
    if x["quant"] == "int8":
        crops = ref_seg.calib_crops(images, m, s, x["quant_calib_crops"])
        quant = ref_seg.quantize(weights, r.net, crops, x["quant_calib_pct"],
                                 x["quant_min_ch"], tf32=tf32)
    out = []
    for t, rect, _ in kept:
        if x["mode"] == "dense":
            out.append(ref_seg.dense_probs(weights, images[t], m, s, rect, r.net,
                                           x["dense_halo"], quant=quant, tf32=tf32))
        else:
            acc, cnt = ref_seg.window_probs(
                weights, images[t], m, s, rect, r.net, x["scales"], x["stride_fraction"],
                max(max(x["scales"]), x["dense_halo"]), x["window_batch"], tf32=tf32)
            out.append(acc / cnt.clamp(min=1e-9)[..., None])
    return out


def run(r) -> None:
    from dynseg_torch.data.tiles import pack_tiles
    from dynseg_torch.infer import Inferencer
    from dynseg_torch.ops import int8_conv as k5

    x, data = r.mix, r.config["data"]
    cfg = config(r)
    dev = torch.device(r.device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    images, masks = synth.make_tiles(data, "val", r.seed, dev)
    mean, std = synth.stats(images)
    weights = synth.make_weights(r.net, r.seed, dev)
    synth.bn_from_crops(weights, r.net, images, mean, std, r.seed)
    tiles = pack_tiles([im.cpu().numpy().astype(np.float32) for im in images],
                       [mk.cpu().numpy().astype(np.int32) for mk in masks])
    tiles.mean, tiles.std = mean, std
    del masks
    inf = Inferencer(cfg, tiles, dev)
    del tiles
    variables = inf.enable_quant({k: v.clone() for k, v in weights.items()})
    warm(inf, variables, x)
    rng = np.random.default_rng([r.seed % 2 ** 63, _RECTS])
    hw = [tuple(int(v) for v in im.shape[:2]) for im in images]
    r.setup_done()

    n_tiles = len(images)
    kept, done, px = [], [], 0
    t0 = time.perf_counter()
    while True:
        t = len(done) % n_tiles
        pred, probs = predict(inf, variables, t, x)
        done.append(t)
        px += hw[t][0] * hw[t][1]
        for y0, y1, x0, x1 in rects_for(rng, *hw[t], x["check_side"],
                                        x["check_rects_per_tile"]):
            kept.append((t, (y0, y1, x0, x1), (
                pred[y0:y1, x0:x1].copy(),
                None if probs is None else probs[y0:y1, x0:x1].copy())))
        if time.perf_counter() - t0 >= r.seconds:
            break
    wall = time.perf_counter() - t0
    r.window = {"seconds": wall, "tiles": done, "hw": hw, "px": px}
    r.e2e["segment_Mpx_s"] = px / wall / 1e6
    r.attempted = len(done)
    r.read_memory_peak()
    print(f"window tiles {len(done)} px {px} fold_peak_bytes {inf.fold_peak_bytes}",
          flush=True)

    if r.trace:
        k5.reset_launches()
        t = len(done) % n_tiles
        t1 = time.perf_counter()
        with r.profiled():
            predict(inf, variables, t, x)
        r.stretch = {"seconds": time.perf_counter() - t1, "tiles": [t], "hw": hw}
        r.program["k5_launches"] = k5.launches
        print(f"stretch tile {t} K5 launches {k5.launches} {dict(k5.variant_launches)}",
              flush=True)

    del inf, variables
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    kept = kept[:x["check_rects_max"]]
    found = numbers([k[2] for k in kept], reference_probs(r, weights, images, mean, std, kept))
    print(f"numbers {found}", flush=True)
    r.numbers = {k: found[k] for k in r.limits if k in found}

