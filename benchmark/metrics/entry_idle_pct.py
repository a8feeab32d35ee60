"""entry_idle_pct (%): the share of the traced stretch in which nothing
runs on the device while the host is inside the frame entry: the
program's `entry` spans (one a call of `utils/graphs.py replay`, from the
signature's lookup to the clones enqueued), mapped onto the trace's clock
by the graph launches (benchmark/program_spans.py).  It is part of
`device_idle_pct`; the rest is the caller's.  None where the program
records no spans or they do not map."""

from benchmark.program_spans import idle_share


def read(run):
    return idle_share(run, "entry")
