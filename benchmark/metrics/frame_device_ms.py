"""frame_device_ms (ms): device time (kernels, copies, sets) in the traced
stretch, over the frames completed in it."""

from benchmark.tracing import device_us


def read(run):
    tr = run.trace
    if tr is None or not tr.frames or not tr.device:
        return None
    return device_us(tr) / len(tr.frames) / 1e3
