"""aggr_roofline_pct (%): the least time of the traced frames' ASW cost
aggregation over the device time of its kernels (K1 asw_den and K2
asw_pass, both compiled as `asw_tile_kernel` in csrc/asw_aggregation.cu).

The least time of a launch is the larger of its bytes at the HBM rate and
its operations at the float32 rate (benchmark/peaks.py): each input read
once and each output written once.  A frame runs, per disparity chunk of
n planes (ceil(D / aggr_d_chunks), or all D), 2 K1 launches (one
denominator per axis) and 2 r K2 launches (r rounds of a vertical and a
horizontal pass)."""

from benchmark.peaks import least_seconds
from benchmark.tracing import device_us

KERNELS = ("asw_tile_kernel",)


def den_work(T, H, W, n):
    """(bytes, ops) of one K1 launch: both (T, H, W) strips read, the
    (n, H, W) denominator written; a multiply and an add per tap."""
    return 2 * T * H * W * 4 + n * H * W * 4, 2 * T * n * H * W


def pass_work(T, H, W, n):
    """(bytes, ops) of one K2 launch: both strips, the cost and the
    denominator read, the output written; per tap two multiplies and an
    add, and one divide per output."""
    return 2 * T * H * W * 4 + 3 * n * H * W * 4, (3 * T + 1) * n * H * W


def frame_least_seconds(H, W, D, T, r, chunks):
    planes = -(-D // chunks) if chunks else D
    total = 0.0
    for d0 in range(0, D, planes):
        n = min(planes, D - d0)
        total += 2 * least_seconds(*den_work(T, H, W, n))
        total += 2 * r * least_seconds(*pass_work(T, H, W, n))
    return total


def read(run):
    tr = run.trace
    if tr is None or not tr.frames:
        return None
    spent = device_us(tr, KERNELS) / 1e6
    if spent <= 0:
        return None
    p = run.params
    least = sum(frame_least_seconds(H, W, p.d_max + 1, 2 * p.radius + 1,
                                    p.r_iters, p.aggr_d_chunks)
                for H, W in tr.frames)
    return 100.0 * least / spent
