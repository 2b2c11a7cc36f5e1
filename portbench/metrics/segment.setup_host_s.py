"""segment.setup_host_s: the Inferencer's host set-up, in seconds: the
spans `infer.setup.pad` (mirror padding and packing), `infer.setup.upload`
(the tiles to the card) and `infer.calibrate` (int8 calibration and
quantization, where the mix asks for it). None where the program has no
spans."""


def read(r):
    try:
        from dynseg_torch.utils.profiling import totals
    except ImportError:
        return None
    t = totals()
    if "infer.setup.pad" not in t:
        return None
    return sum(t[k]["seconds"] for k in
               ("infer.setup.pad", "infer.setup.upload", "infer.calibrate") if k in t)
