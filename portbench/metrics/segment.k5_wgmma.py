"""segment.k5_wgmma: the share (%) of the traced tile's K5 (int8 block conv)
launches that ran the tensor-core variant, "wgmma", by the port's own
counters (`dynseg_torch.ops.int8_conv.variant_launches`, which `drivers/segment.py`
resets before the traced tile). Nothing where the tile launched no K5, or
where the variants' counts disagree with the tile's launch count."""


def read(r):
    n = r.program.get("k5_launches")
    if not n:
        return None
    try:
        from dynseg_torch.ops.int8_conv import variant_launches
    except ImportError:
        return None
    if sum(variant_launches.values()) != n:
        return None
    return 100.0 * variant_launches.get("wgmma", 0) / n
