"""train.k2_roofline: K2's (patch gather) share (%) of its roofline in the
traced stretch: the sum over its launches of the least time (the tile
pixels and labels read, the float32 images and int64 labels written, at
3.35 TB/s) over the sum of its device time. One launch a step; a trace or
counter that disagrees gives nothing."""

from portbench import counts, peaks


def read(r):
    st, p = r.stretch, r.profile
    if not st.get("steps") or not p or not p["kernel_s"].get("K2"):
        return None
    bands = r.config["model"]["num_input_bands"]
    bound = sum(n * counts.k2_bytes(st["batch"][s], s, bands) / peaks.HBM_BYTES_S
                for s, n in st["steps"].items())
    launches = sum(st["steps"].values())
    if p["kernel_launches"].get("K2") != launches or r.program.get("k2_launches") != launches:
        return None
    return 100.0 * bound / p["kernel_s"]["K2"]
