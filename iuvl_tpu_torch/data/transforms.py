"""Longest-side resize, the port's copy of what AMG's crop layers need
from ``iuvl_tpu/data/transforms.py``.

JAX's ``resize_longest_side`` takes its native core on uint8 images
(``iuvl_tpu/native/preprocess.cpp`` ``resize_bilinear_u8``): bilinear with
half-pixel centres, edges clamped, in float64, rounded half up. This is
the same arithmetic in numpy, equal to it to the uint8 value.
"""

from __future__ import annotations

import numpy as np


def get_preprocess_shape(h: int, w: int, long_side: int) -> tuple[int, int]:
    """Output (new_h, new_w) with the longest side == long_side."""
    scale = long_side / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


def _taps(size: int, out: int):
    """Source rows (or columns) and weights of each output row: the lower
    tap clamped into the image, the upper one past it, and a weight of 0
    on the upper tap left of the first centre."""
    f = (np.arange(out) + 0.5) * (size / out) - 0.5
    lo = np.floor(f).astype(np.int64)
    weight = np.where(lo < 0, 0.0, f - lo)
    lo = np.clip(lo, 0, size - 1)
    return lo, np.minimum(lo + 1, size - 1), weight


def resize_bilinear_u8(image: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(H, W, C) uint8 -> (out_h, out_w, C) uint8."""
    h, w = image.shape[:2]
    y0, y1, wy = _taps(h, out_h)
    x0, x1, wx = _taps(w, out_w)
    img = image.astype(np.float64)
    wx, wy = wx[None, :, None], wy[:, None, None]
    top = img[y0][:, x0] * (1.0 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1.0 - wx) + img[y1][:, x1] * wx
    return (top * (1.0 - wy) + bot * wy + 0.5).astype(np.uint8)


def resize_longest_side(image: np.ndarray, long_side: int = 1024) -> np.ndarray:
    """(H, W, 3) uint8 -> resized (h', w', 3) uint8, the longest side
    ``long_side``, bilinear."""
    new_h, new_w = get_preprocess_shape(*image.shape[:2], long_side)
    return resize_bilinear_u8(np.asarray(image, np.uint8), new_h, new_w)
