"""segment.mfu: the share (%) of the card's peaks that the window's
segmentation reached: the useful operations of the completed tiles, from
shapes, each part at its precision's peak (float32 blocks and head at 67
TFLOP/s, int8 blocks at 1,979 TOPS), over the window's wall time. Dense
mode counts every output pixel once (not the halo's recompute); window
mode every window the grid defines (not the padding of a short batch)."""

from portbench import counts, peaks


def read(r):
    if r.device != "cuda":
        return None  # a share of the card's peak exists only on the card
    w, x = r.window, r.mix
    if not w.get("tiles") or w["seconds"] <= 0:
        return None
    if x["mode"] == "dense":
        min_ch = x["quant_min_ch"] if x["quant"] == "int8" else 10 ** 9
        f32, i8 = counts.split_macs(r.net, min_ch)
        px = sum(w["hw"][t][0] * w["hw"][t][1] for t in w["tiles"])
        least = px * (2 * f32 / peaks.FP32_FLOPS + 2 * i8 / peaks.INT8_OPS)
    else:
        pad = max(max(x["scales"]), x["dense_halo"])
        px = sum(counts.windows_per_tile(*w["hw"][t], pad, s, x["stride_fraction"]) * s * s
                 for t in w["tiles"] for s in x["scales"])
        least = px * 2 * counts.macs_per_px(r.net) / peaks.FP32_FLOPS
    return 100.0 * least / w["seconds"]
