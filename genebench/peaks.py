"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense,
at the full 700 W power limit): the yardstick of every roofline share."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12               # float32 outside the tensor cores


def bound_seconds(nbytes, ops):
    """The least time the card could take for `nbytes` moved (each input
    read once, each output written once) and `ops` float32 operations."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS)
