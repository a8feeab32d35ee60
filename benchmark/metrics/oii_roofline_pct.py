"""oii_roofline_pct (%): the least time of the traced frames' cross
aggregation over the device time of K7 (`oii_h_kernel` and
`oii_v_kernel` in csrc/cross_oii.cu), one horizontal and one vertical
pass a frame.

A pass reads the (D, H, W) float32 volume once and writes it once, and
reads the two int32 arm planes of its axis of both views; its least time
is those bytes at the HBM rate (benchmark/peaks.py).  Its operations
(one add per tap of each window and a divide, at most 2 L + 2 per
output) stay under the bytes' time while 2 L + 2 < 8 * FP32 / HBM, that
is for arms up to L = 78; past that the bound would need the arms, and
the metric is left out."""

from benchmark.peaks import FP32_OPS_PER_S, HBM_BYTES_PER_S
from benchmark.tracing import device_us

KERNELS = ("oii_h_kernel", "oii_v_kernel")


def pass_bytes(H, W, D):
    """Volume in and out, both views' arms along the pass's axis."""
    return 2 * 4 * D * H * W + 2 * 2 * 4 * H * W


def read(run):
    tr = run.trace
    p = run.params
    if tr is None or not tr.frames:
        return None
    if (2 * p.arm_len + 2) * HBM_BYTES_PER_S >= 8 * FP32_OPS_PER_S:
        return None
    spent = device_us(tr, KERNELS) / 1e6
    if spent <= 0:
        return None
    least = sum(2 * pass_bytes(H, W, p.d_max + 1) / HBM_BYTES_PER_S
                for H, W in tr.frames)
    return 100.0 * least / spent
