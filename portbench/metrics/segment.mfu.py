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
    w, x, m = r.window, r.mix, r.config["model"]
    if not w.get("tiles") or w["seconds"] <= 0:
        return None
    net, bands, nc = m["net_type"], m["num_input_bands"], m["num_classes"]
    width = m.get("width_multiplier", 1.0)
    if x["mode"] == "dense":
        min_ch = x["quant_min_ch"] if x["quant"] == "int8" else 10 ** 9
        f32, i8 = counts.split_macs(net, bands, nc, min_ch, width)
        px = sum(w["hw"][t][0] * w["hw"][t][1] for t in w["tiles"])
        least = px * (2 * f32 / peaks.FP32_FLOPS + 2 * i8 / peaks.INT8_OPS)
    else:
        pad = max(max(x["scales"]), x["dense_halo"])
        px = sum(counts.windows_per_tile(*w["hw"][t], pad, s, x["stride_fraction"]) * s * s
                 for t in w["tiles"] for s in x["scales"])
        least = px * 2 * counts.macs_per_px(net, bands, nc, width) / peaks.FP32_FLOPS
    return 100.0 * least / w["seconds"]
