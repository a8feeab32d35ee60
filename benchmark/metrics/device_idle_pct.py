"""device_idle_pct (%): the share of the traced stretch in which no
kernel, copy or set runs on the device, from the union of their
intervals.  The stretch runs from a map copy's end to the last traced
frame's, so it holds the idle time before each of its frames."""

from benchmark.tracing import busy_us, window_us


def read(run):
    tr = run.trace
    if tr is None or not tr.device or window_us(tr) <= 0:
        return None
    return 100.0 * (1.0 - busy_us(tr) / window_us(tr))
