"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense, at its
700 W limit: bf16 tensor-core operations and HBM bandwidth."""

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    """The roofline's least time: the larger of the operations at the
    bf16 peak and the bytes at the HBM peak."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
