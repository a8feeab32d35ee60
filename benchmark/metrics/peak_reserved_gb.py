"""peak_reserved_gb (GB): torch.cuda.max_memory_reserved() over the whole
run, set-up and every first call included (each first call resets the
statistic, so the harness reads it before each one and after the
window), read before the reference runs."""


def read(run):
    return run.peak_reserved_bytes / 1e9 if run.peak_reserved_bytes else None
