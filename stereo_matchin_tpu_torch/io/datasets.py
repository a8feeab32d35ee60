"""The stereo pairs the CLI knows by name, and the reference's pics.txt.

`REGISTRY` names the five pairs the reference benchmarks and its `sukub`
debug pair.  Their files lie in the reference checkout, whose directory
only the environment variable STEREO_REFERENCE_ROOT gives: the port has
no default for it, and looking a pair up without it raises LookupError.
"""

from __future__ import annotations

import os
from collections.abc import Mapping
from dataclasses import dataclass
from typing import Iterator, Optional

ROOT_VARIABLE = "STEREO_REFERENCE_ROOT"


@dataclass(frozen=True)
class StereoPair:
    name: str
    left: str
    right: str
    golden_dir: Optional[str] = None  # the reference's stored artifacts

    def exists(self) -> bool:
        return os.path.exists(self.left) and os.path.exists(self.right)


def reference_root() -> str:
    """The reference checkout's directory, from STEREO_REFERENCE_ROOT."""
    root = os.environ.get(ROOT_VARIABLE)
    if not root:
        raise LookupError(f"the stereo pairs by name lie in the reference "
                          f"checkout: set {ROOT_VARIABLE} to its directory, "
                          f"or name the pair files in a pics.txt")
    return root


class _Registry(Mapping):
    """Pair name -> StereoPair, resolved under reference_root() at lookup."""

    # The five pairs of the reference's pics.txt, same left/right roles.
    _FILES = {"tsukuba": ("im1.png", "im5.png"),
              "art": ("view1.png", "view5.png"),
              "teddy": ("im2.png", "im6.png"),
              "cones": ("im2.png", "im6.png"),
              "laundry": ("view1.png", "view5.png"),
              "sukub": ("imL.png", "imP.png")}

    def __getitem__(self, name: str) -> StereoPair:
        left, right = self._FILES[name]
        d = os.path.join(reference_root(), name)
        return StereoPair(name, os.path.join(d, left), os.path.join(d, right), d)

    def __contains__(self, name) -> bool:
        return name in self._FILES

    def __iter__(self) -> Iterator[str]:
        return iter(self._FILES)

    def __len__(self) -> int:
        return len(self._FILES)


REGISTRY = _Registry()

# The pairs the reference benchmarks (its pics.txt), without `sukub`.
BENCH_PAIRS = ["tsukuba", "art", "teddy", "cones", "laundry"]


def safe_pair_name(name: str) -> str:
    """Reduce a pair name to one safe path component ('', '.' and '..'
    become "pair"), so that a name never escapes the CLI's --out."""
    safe = os.path.basename(name.rstrip(os.sep))
    if safe in ("", ".", ".."):
        return "pair"
    return safe


def get_pair(name: str) -> StereoPair:
    """The registered pair `name` under reference_root() (KeyError for an
    unknown name, LookupError without STEREO_REFERENCE_ROOT)."""
    return REGISTRY[name]


def load_pair(pair: "str | StereoPair"):
    """Load a pair, registered by name or given as a StereoPair, as two
    (H, W, 3) float32 [0, 1] arrays."""
    from . import png

    if isinstance(pair, str):
        pair = get_pair(pair)
    return png.read_rgb(pair.left), png.read_rgb(pair.right)


def parse_pics_txt(path: str) -> list[StereoPair]:
    """Parse the reference's pics.txt format (left, right alternating lines;
    up to 20 pairs, main.cpp:136-148)."""
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    pairs = []
    for i in range(0, min(len(lines), 40) - 1, 2):
        left, right = lines[i], lines[i + 1]
        name = safe_pair_name(os.path.dirname(left))
        if name == "pair":
            name = f"pair{i // 2}"
        pairs.append(StereoPair(name=name, left=left, right=right))
    return pairs
