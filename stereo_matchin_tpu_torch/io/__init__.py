"""Image and ground-truth I/O and the named stereo pairs of the port's CLI."""

from . import groundtruth, png
from .datasets import (REGISTRY, StereoPair, get_pair, load_pair,
                       parse_pics_txt, reference_root, safe_pair_name)

__all__ = ["REGISTRY", "StereoPair", "get_pair", "groundtruth", "load_pair",
           "parse_pics_txt", "png", "reference_root", "safe_pair_name"]
