"""The prompt helpers of the interactive eval: the port's own copies of
``box_points``, ``distance_transform_conv`` and ``conv_dt_argmax`` from
``iuvl_tpu/data/visual_sampler.py`` (host numpy and scipy). They give the
Box mode its prompts and the Point mode its first click (the deepest pixel
of the mask under the reference sampler's kornia distance transform).
"""

from __future__ import annotations

import numpy as np


def box_points(mask: np.ndarray) -> np.ndarray:
    """xyxy box of a mask (for SAM box prompts)."""
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return np.zeros(4, np.float32)
    return np.array([xs.min(), ys.min(), xs.max(), ys.max()], np.float32)


def distance_transform_conv(mask: np.ndarray, h: float = 0.35,
                            max_iters: int | None = None) -> np.ndarray:
    """Kornia-semantics cascaded-conv distance transform (numpy oracle).

    Mirrors ``kornia.contrib.distance_transform`` as the reference uses it
    (its simpleclick_sampler.py:65 and xdecoder_model.py:874): input is a
    binary image whose NON-ZERO pixels are the seeds; the output at each pixel
    approximates the Euclidean distance to the nearest seed, built ring by
    ring with a 3x3 exp(-d/h) kernel and ``-h * log(conv)`` readout; seed
    pixels read 0. O(diameter) 3x3 convs — the test oracle; the production
    Point sampler reproduces this transform's argmax exactly without the
    cascade (``conv_dt_argmax``).
    """
    seeds = mask.astype(bool)
    hgt, wid = seeds.shape
    if max_iters is None:
        max_iters = int(np.ceil(max(hgt, wid)))
    # 3x3 kernel of exp(-euclidean_dist / h), center weight exp(0) = 1.
    yy, xx = np.meshgrid(np.arange(3) - 1, np.arange(3) - 1, indexing="ij")
    kern = np.exp(-np.hypot(yy, xx) / h)

    out = np.zeros((hgt, wid), np.float64)
    boundary = seeds.astype(np.float64)
    for i in range(max_iters):
        padded = np.pad(boundary, 1, mode="edge")  # kornia border 'replicate'
        conv = np.zeros_like(boundary)
        for dy in range(3):
            for dx in range(3):
                conv += kern[dy, dx] * padded[dy:dy + hgt, dx:dx + wid]
        with np.errstate(divide="ignore"):
            cdt = -h * np.log(conv)
        cdt = np.where(np.isfinite(cdt), cdt, 0.0)
        grow = cdt > 0  # newly-reached ring (seeds and assigned read <= 0)
        if not grow.any():
            break
        out = np.where(grow, i * 1.0 + cdt, out)
        boundary = np.where(grow, 1.0, boundary)
    return out


# exp(-d / h) 3x3 kernel weights at kornia's defaults (h=0.35), float32 like
# torch's conv: edge-adjacent and diagonal neighbor contributions.
_CDT_H = 0.35
_CDT_EDGE = np.float32(np.exp(-1.0 / _CDT_H))
_CDT_DIAG = np.float32(np.exp(-np.sqrt(2.0) / _CDT_H))


def conv_dt_argmax(mask: np.ndarray) -> tuple[int, int]:
    """(y, x) of the argmax of kornia's cascaded-conv distance transform of
    ``mask`` — the reference's first-click pixel (simpleclick_sampler.py:64-66
    runs ``distance_transform((~pad(fp)).float())`` and takes
    ``.max(dim=-1)[1]``, first-in-raster on ties) — computed exactly WITHOUT
    running the O(interior-depth) conv cascade.

    Why this is exact: growth through a 3x3 kernel advances one Chebyshev
    ring per iteration, so a pixel at chessboard distance r from the seed
    set reads ``(r - 1) + (-h * log(conv))`` where ``conv`` sums the kernel
    weights of its already-reached 3x3 neighbors. With h = 0.35 the readout
    band of ring r is ((r-1) + 0.4214, (r-1) + 1.4142], and ring r's lower
    edge sits 0.0071 ABOVE ring r-1's upper edge — bands are disjoint, so
    the global argmax always lies in the deepest ring and, within it, at
    the pixel minimizing ``conv`` (fewest / most-diagonal reached
    neighbors), ties first-in-raster like ``torch.max``.

    Matches the reference's border handling (fp is zero-padded by one, so
    the image border counts as seed). Returns (0, 0) for an empty mask.
    Equivalence to the cascade is pinned against the
    :func:`distance_transform_conv` oracle (tests/test_torch_interactive.py).
    """
    from scipy import ndimage

    fg = np.asarray(mask, bool)
    if not fg.any():
        return (0, 0)
    padded = np.pad(fg, 1)
    # Chessboard distance of fg pixels to the seed set (~fg, incl. border).
    cheb = ndimage.distance_transform_cdt(padded, metric="chessboard")
    rmax = int(cheb.max())
    ring = cheb == rmax
    reached = (cheb <= rmax - 1).astype(np.float32)
    hgt, wid = padded.shape
    conv = np.zeros((hgt, wid), np.float32)
    # Fixed neighbor order (kernel raster order, like torch's conv2d sum).
    pad2 = np.pad(reached, 1, mode="edge")
    for dy in range(3):
        for dx in range(3):
            if dy == 1 and dx == 1:
                continue
            w = _CDT_EDGE if (dy == 1 or dx == 1) else _CDT_DIAG
            conv += w * pad2[dy:dy + hgt, dx:dx + wid]
    # Deepest ring, min conv, first-in-raster: argmin over masked conv.
    conv = np.where(ring, conv, np.float32(np.inf))[1:-1, 1:-1]
    flat = int(np.argmin(conv))
    return (flat // fg.shape[1], flat % fg.shape[1])
