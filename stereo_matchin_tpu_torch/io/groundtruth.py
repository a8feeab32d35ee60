"""Ground-truth disparity I/O: Middlebury PFM / PGM / scaled-PNG readers;
the port's own copy of `stereo_matchin_tpu/io/groundtruth.py` (numpy
only), held equal to it by tests/test_torch_standalone.py.

The reference computed its bad-pixel rates offline against Middlebury
ground truth (thesis PDF p.34; numbers in BASELINE.md) — no loader exists
in its codebase.  This module supplies the three formats Middlebury has
shipped GT in, so `eval --gt` can score against real data when present:

- **PFM** (Middlebury 2014, e.g. `disp0GT.pfm`): float32 scanlines,
  bottom-up, with a scale/endianness header.  `inf` marks unknown pixels.
- **PGM** (Middlebury 2001 tsukuba `truedisp.row3.col3.pgm`): 8-bit gray,
  disparity * 16 by convention (caller passes `scale`).
- **PNG** (Middlebury 2003 teddy/cones `disp2.png`/`disp6.png`): 8-bit
  gray, disparity * 4 by convention; 0 marks unknown.

All readers return float32 disparity in PIXEL units after dividing by
`scale`; `unknown` masks are returned separately.
"""

from __future__ import annotations

import re

import numpy as np


def read_pfm(path) -> tuple[np.ndarray, np.ndarray]:
    """Read a PFM file -> (disparity float32 (H, W), valid mask (H, W)).

    Handles grayscale ('Pf') and color ('PF', first channel taken),
    both endiannesses, and the bottom-up scanline order of the format.
    Non-finite values (Middlebury 2014 'inf' = unknown) are masked out
    and zeroed in the returned array.
    """
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header not in (b"PF", b"Pf"):
            raise ValueError(f"{path}: not a PFM file (header {header!r})")
        channels = 3 if header == b"PF" else 1
        dims = f.readline()
        while dims.strip().startswith(b"#"):
            dims = f.readline()
        m = re.match(rb"^\s*(\d+)\s+(\d+)\s*$", dims)
        if m is None:
            raise ValueError(f"{path}: bad PFM dimension line {dims!r}")
        width, height = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().strip())
        endian = "<" if scale < 0 else ">"
        data = np.frombuffer(f.read(width * height * channels * 4),
                             dtype=endian + "f4")
        if data.size != width * height * channels:
            raise ValueError(f"{path}: truncated PFM payload")
    img = data.reshape(height, width, channels)[::-1, :, 0]  # bottom-up
    img = np.ascontiguousarray(img, dtype=np.float32)
    if abs(scale) not in (0.0, 1.0):
        img = img * np.float32(abs(scale))
    valid = np.isfinite(img)
    return np.where(valid, img, np.float32(0)), valid


def write_pfm(path, disp, invalid_mask=None) -> None:
    """Write an (H, W) float32 disparity map as a little-endian 'Pf' PFM.

    Pixels under `invalid_mask` are stored as +inf (the Middlebury 2014
    unknown marker), so `read_pfm` round-trips the (values, mask) pair.
    """
    arr = np.asarray(disp, dtype=np.float32)
    if arr.ndim != 2:
        raise ValueError("write_pfm expects an (H, W) map")
    if invalid_mask is not None:
        arr = np.where(np.asarray(invalid_mask, bool), np.float32(np.inf), arr)
    with open(path, "wb") as f:
        f.write(b"Pf\n")
        f.write(f"{arr.shape[1]} {arr.shape[0]}\n".encode())
        f.write(b"-1.0\n")
        f.write(arr[::-1].astype("<f4").tobytes())


def read_pgm(path, scale: float = 16.0) -> tuple[np.ndarray, np.ndarray]:
    """Read an 8/16-bit PGM (P2 ascii or P5 raw) ground-truth map.

    Returns (disparity / scale as float32, valid mask).  Middlebury 2001
    (tsukuba truedisp) stores disparity*16 with 0 = unknown — the default.
    """
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic not in (b"P2", b"P5"):
            raise ValueError(f"{path}: not a PGM file (magic {magic!r})")
        fields: list[int] = []
        while len(fields) < 3:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: truncated PGM header")
            line = line.split(b"#")[0]
            fields.extend(int(t) for t in line.split())
        width, height, maxval = fields[:3]
        if magic == b"P5":
            dtype = np.dtype(">u2") if maxval > 255 else np.dtype("u1")
            raw = np.frombuffer(f.read(width * height * dtype.itemsize),
                                dtype=dtype)
        else:
            raw = np.array(f.read().split(), dtype=np.uint16)
        if raw.size != width * height:
            raise ValueError(f"{path}: truncated PGM payload")
    img = raw.reshape(height, width).astype(np.float32)
    valid = img > 0
    return img / np.float32(scale), valid


def read_gt_png(path, scale: float = 4.0) -> tuple[np.ndarray, np.ndarray]:
    """Read an 8-bit grayscale PNG ground-truth map (Middlebury 2003
    convention: disparity*4, 0 = unknown).  Returns (disp, valid)."""
    from . import png

    img = png.read_gray(path) * np.float32(255.0)
    valid = img > 0
    return img / np.float32(scale), valid


def read_groundtruth(path, scale: float | None = None
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Dispatch on extension: .pfm, .pgm, or .png ground truth.

    `scale` overrides the per-format default (pfm 1, pgm 16, png 4).
    Returns (disparity float32 in pixels, valid mask).
    """
    p = str(path).lower()
    if p.endswith(".pfm"):
        disp, valid = read_pfm(path)
        if scale not in (None, 1.0):
            disp = disp / np.float32(scale)
        return disp, valid
    if p.endswith(".pgm"):
        return read_pgm(path, scale=16.0 if scale is None else scale)
    if p.endswith(".png"):
        return read_gt_png(path, scale=4.0 if scale is None else scale)
    raise ValueError(f"unrecognized ground-truth format: {path}")
