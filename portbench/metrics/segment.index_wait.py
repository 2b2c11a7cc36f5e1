"""segment.index_wait: the share (%) of the tiles' time that the host spends
building each batch's window or block index and putting it on the card
(span `infer.index` over span `infer.tile`, through the whole run). None
where the program has no spans."""


def read(r):
    try:
        from dynseg_torch.utils.profiling import totals
    except ImportError:
        return None
    t = totals()
    tile = t.get("infer.tile", {}).get("seconds", 0.0)
    if tile <= 0 or "infer.index" not in t:
        return None
    return 100.0 * t["infer.index"]["seconds"] / tile
