"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit): HBM3 bandwidth and the float32 rate outside the
tensor cores. A share of a peak is stated with the card's power limit
beside it (the result line's ``device.card``)."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def bound_s(nbytes: float, flops: float = 0.0) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)
