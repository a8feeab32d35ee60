"""first_call_s (s): the frame cache's first calls over the run, summed
over the cell's signatures: each one's warm-up, making room and capture,
from the program's counters of the frame family
(`utils/profiling.py COUNTERS["frames"]`).  Part of `setup_s`'s
`first_calls_s`, which also holds a replay of each signature.  None where
the program keeps no such counter or made no first call (a CPU run)."""

from benchmark.program_spans import frame_counter


def read(run):
    if not frame_counter("first_calls"):
        return None
    parts = [frame_counter(k) for k in ("warmup_s", "make_room_s",
                                        "capture_s")]
    return None if None in parts else sum(parts)
