"""submit_ms (ms): the median host time of the entry call until it returns,
before the map's copy back: the frame entry and its capture cache
(signature lookup, copies into the static inputs, the graph's launch, the
results' clones), a span the harness takes around the call.  In a traced
run only the frames after the traced stretch count: the profiler slows
each graph's launch."""

import statistics


def read(run):
    frames = run.frames
    if run.trace is not None:
        frames = frames[run.trace.first + len(run.trace.frames):]
    if not frames:
        return None
    return statistics.median((f.t_return - f.t_call) * 1e3 for f in frames)
