"""segment.to_host: the share (%) of the tiles' time spent bringing each
tile's answer to the host once its work is done: the copies and the host's
division and cast (span `infer.to_host` over span `infer.tile`, through the
whole run). None where the program has no spans."""


def read(r):
    try:
        from dynseg_torch.utils.profiling import totals
    except ImportError:
        return None
    t = totals()
    tile = t.get("infer.tile", {}).get("seconds", 0.0)
    if tile <= 0 or "infer.to_host" not in t:
        return None
    return 100.0 * t["infer.to_host"]["seconds"] / tile
