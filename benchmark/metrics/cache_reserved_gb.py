"""cache_reserved_gb (GB): the high-water mark of the frame cache's bytes
over the run, its frame pool's reserved bytes and its static inputs, read
by the program after each capture and before each drop
(`utils/profiling.py COUNTERS["frames"].peak_bytes`).  Part of
`peak_reserved_gb`.  None where the program keeps no such counter or
captured nothing (a CPU run)."""

from benchmark.program_spans import frame_counter


def read(run):
    peak = frame_counter("peak_bytes")
    return peak / 1e9 if peak else None
