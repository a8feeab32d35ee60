"""PNG image I/O through PIL.

Decoding yields float32 RGB in [0, 1] on the UNORM8 grid, the values the
reference's CL_UNORM_INT8 images present to its kernels; disparity maps
are written as 8-bit grayscale RGB (R = G = B), as the reference dumps
them (main.cpp:357-367).
"""

from __future__ import annotations

import numpy as np


def read_rgb(path) -> np.ndarray:
    """Decode a PNG to (H, W, 3) float32 in [0,1] (UNORM8 grid)."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), dtype=np.uint8)
    return (arr / np.float32(255.0)).astype(np.float32)


def read_gray(path) -> np.ndarray:
    """Decode a PNG to (H, W) float32 in [0,1] from its R channel (the
    reference's disparity maps have R = G = B)."""
    return read_rgb(path)[..., 0]


def write_gray(path, img01) -> None:
    """Encode an (H, W) [0,1] image as 8-bit grayscale RGB PNG (R=G=B)."""
    u8 = np.clip(np.round(np.asarray(img01) * 255.0), 0, 255).astype(np.uint8)
    write_rgb(path, np.stack([u8, u8, u8], axis=-1))


def write_rgb(path, arr_u8) -> None:
    """Encode an (H, W, 3) uint8 (or [0,1] float) array as PNG."""
    from PIL import Image

    arr = np.asarray(arr_u8)
    if arr.dtype != np.uint8:
        arr = np.clip(np.round(arr * 255.0), 0, 255).astype(np.uint8)
    Image.fromarray(arr, mode="RGB").save(path)
