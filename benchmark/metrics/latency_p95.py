"""latency_p95 (ms): the 95th percentile (nearest rank) over all frames of
the window, each timed on the host from its entry call to its kept map on
the host."""

import math


def read(run):
    if not run.frames:
        return None
    ms = sorted((f.t_host - f.t_call) * 1e3 for f in run.frames)
    return ms[max(0, math.ceil(0.95 * len(ms)) - 1)]
