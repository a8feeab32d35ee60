"""launch_idle_pct (%): the part of `entry_idle_pct` inside the entry's
`entry.launch` spans, the graph's replay (one `cudaGraphLaunch`): the
device idle while the host launches the frame
(benchmark/program_spans.py).  None where the program records no spans
or they do not map."""

from benchmark.program_spans import idle_share


def read(run):
    return idle_share(run, "launch")
