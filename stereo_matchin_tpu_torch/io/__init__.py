"""Image and ground-truth I/O, the named stereo pairs of the port's CLI and
the prefetching pair loader of its `run` command."""

from . import groundtruth, png
from .datasets import (BENCH_PAIRS, REGISTRY, StereoPair, get_pair, load_pair,
                       parse_pics_txt, reference_root, safe_pair_name)
from .loader import PairLoader

__all__ = ["BENCH_PAIRS", "PairLoader", "REGISTRY", "StereoPair", "get_pair",
           "groundtruth", "load_pair", "parse_pics_txt", "png",
           "reference_root", "safe_pair_name"]
