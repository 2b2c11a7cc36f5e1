"""segment.k5_roofline: K5's (int8 block conv) share (%) of its roofline in
the traced tile: the sum over its launches of max(operations / 1,979
TOPS, bytes / 3.35 TB/s), the launches being the tile's dense forwards
times the net's int8 blocks, over the sum of its device time. A trace or
counter that disagrees gives nothing."""

from portbench import counts, peaks


def read(r):
    st, p, x = r.stretch, r.profile, r.mix
    if not st.get("tiles") or not p or not p["kernel_s"].get("K5") or x["mode"] != "dense":
        return None
    pad = max(max(x["scales"]), x["dense_halo"])
    bound, launches = 0.0, 0
    for t in st["tiles"]:
        h, w = st["hw"][t]
        groups, bb = counts.dense_groups(h, w, pad, x["dense_block"], x["dense_block_batch"])
        ext = min(x["dense_block"], h, w) + 2 * x["dense_halo"]
        per = counts.k5_launches(r.net, x["quant_min_ch"], bb, ext)
        bound += groups * sum(peaks.bound_s(o, b, peaks.INT8_OPS) for o, b in per)
        launches += groups * len(per)
    if p["kernel_launches"].get("K5") != launches or r.program.get("k5_launches") != launches:
        return None
    return 100.0 * bound / p["kernel_s"]["K5"]
