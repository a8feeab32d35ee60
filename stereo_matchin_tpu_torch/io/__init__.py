"""Image I/O and the named stereo pairs of the port's CLI."""

from . import png
from .datasets import (REGISTRY, StereoPair, parse_pics_txt, reference_root,
                       safe_pair_name)

__all__ = ["REGISTRY", "StereoPair", "parse_pics_txt", "png", "reference_root",
           "safe_pair_name"]
