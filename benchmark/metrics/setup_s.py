"""setup_s (s): process start to the first timed frame: imports, CUDA
init, the kernel library (built by nvcc in the checkout's first run),
the pairs, and a first call (warm-up and capture) and one replay of each
of the cell's signatures."""


def read(run):
    return run.setup_s
