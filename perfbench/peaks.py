"""The peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit): the yardstick of every roofline share and
``mfu`` metric.  The configurations here compute in IEEE float32 with TF32
off, outside the tensor cores."""

FLOPS_F32 = 67e12          # float32, CUDA cores
HBM_BYTES_PER_S = 3.35e12  # HBM3


def min_time(flops: float, nbytes: float) -> float:
    """The least time the card could take for work of ``flops`` float32
    operations and ``nbytes`` moved to or from its memory."""
    return max(flops / FLOPS_F32, nbytes / HBM_BYTES_PER_S)
