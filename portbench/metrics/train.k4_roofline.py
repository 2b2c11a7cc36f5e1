"""train.k4_roofline: K4's (max-pool backward) share (%) of its roofline
in the traced stretch: the sum over its launches of the least time (x, y,
g read and dx written once each, at 3.35 TB/s) over the sum of its device
time. The launches are the stretch's steps times the net's pools; a
trace or counter that disagrees gives nothing."""

from portbench import counts, peaks


def read(r):
    st, p = r.stretch, r.profile
    if not st.get("steps") or not p or not p["kernel_s"].get("K4"):
        return None
    bound, launches = 0.0, 0
    for s, n in st["steps"].items():
        per = counts.k4_launches(r.net, st["batch"][s], s)
        bound += n * sum(b / peaks.HBM_BYTES_S for b in per)
        launches += n * len(per)
    if p["kernel_launches"].get("K4") != launches or r.program.get("k4_launches") != launches:
        return None
    return 100.0 * bound / p["kernel_s"]["K4"]
