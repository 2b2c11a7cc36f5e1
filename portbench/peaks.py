"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at the 700 W
limit). Shares are stated against these, with the card's power limit
printed beside them."""

FP32_FLOPS = 67e12        # float32 outside the tensor cores (TF32 off)
INT8_OPS = 1979e12
HBM_BYTES_S = 3.35e12


def bound_s(ops: float, nbytes: float, peak_ops: float) -> float:
    """The least time the card could take: operations over `peak_ops` or
    bytes over the memory rate, whichever is larger."""
    return max(ops / peak_ops, nbytes / HBM_BYTES_S)
