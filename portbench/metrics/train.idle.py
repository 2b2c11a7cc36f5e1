"""train.idle: the share (%) of the traced stretch of training in which the
card runs no kernel, copy or set."""


def read(r):
    p = r.profile
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
