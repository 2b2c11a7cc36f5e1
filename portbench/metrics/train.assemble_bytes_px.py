"""train.assemble_bytes_px: the bytes the dense-wired net's concats (each
block's input and the head's) write for each pixel of a forward, in B/px:
the program's counter `models.dilated.assembly`, its bytes over its
pixels (B x H x W a forward), through the whole run. Nothing where the
program has no such counter or it counted no pixel."""


def read(r):
    try:
        from dynseg_torch.models.dilated import assembly
    except ImportError:
        return None
    if not assembly.get("px"):
        return None
    return assembly["bytes"] / assembly["px"]
