"""train.host_ms: the host's own milliseconds a launch of the train step
(one step in these cells): the self time of the spans `train.select`,
`train.sample`, `train.step` and `train.update`, over the calls of
`train.step`, through the whole run (the checked steps, the window and
the traced stretch). None where the program has no spans."""


def read(r):
    try:
        from dynseg_torch.utils.profiling import totals
    except ImportError:
        return None
    t = totals()
    steps = t.get("train.step", {}).get("calls", 0)
    if not steps:
        return None
    host = sum(t[k]["self_seconds"] for k in
               ("train.select", "train.sample", "train.step", "train.update") if k in t)
    return 1e3 * host / steps
