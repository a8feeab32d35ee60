"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its
700 W limit), the yardstick of every roofline share."""

HBM_BYTES_PER_S = 3.35e12      # HBM3
FP32_OPS_PER_S = 67e12         # float32 outside the tensor cores


def least_seconds(nbytes: float, ops: float) -> float:
    """The least time of a launch: the larger of its bytes over the HBM
    bandwidth and its operations over the float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)
