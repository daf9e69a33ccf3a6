"""Visual prompt helpers (host numpy and scipy), the port's own copies
from ``iuvl_tpu/data/visual_sampler.py``:

- the interactive eval's ``box_points``, ``distance_transform_conv`` and
  ``conv_dt_argmax``: the Box mode's prompts and the Point mode's first
  click (the deepest pixel of the mask under the reference sampler's
  kornia distance transform);
- the training streams' ``ShapeSampler``: up to ``max_candidate``
  instances, each with one pseudo-prompt of a random mode (Point, Polygon,
  Scribble, Circle, Box) rasterised from its gt mask.
"""

from __future__ import annotations

import numpy as np

MODES = ("Point", "Polygon", "Scribble", "Circle", "Box")


def _dilate(mask: np.ndarray, iterations: int = 1) -> np.ndarray:
    """3x3 binary dilation."""
    out = mask.astype(bool)
    for _ in range(iterations):
        padded = np.pad(out, 1)
        acc = np.zeros_like(out)
        for dy in (0, 1, 2):
            for dx in (0, 1, 2):
                acc |= padded[dy : dy + out.shape[0], dx : dx + out.shape[1]]
        out = acc
    return out


def sample_point(mask: np.ndarray, rng: np.random.RandomState,
                 max_points: int = 20, dilation: int = 3) -> np.ndarray:
    """Up to ``max_points`` random foreground pixels, dilated
    (reference point.py:14-33)."""
    ys, xs = np.nonzero(mask)
    out = np.zeros_like(mask, dtype=bool)
    if len(ys) == 0:
        return out
    n = rng.randint(1, max_points + 1)
    idx = rng.choice(len(ys), size=min(n, len(ys)), replace=False)
    out[ys[idx], xs[idx]] = True
    return _dilate(out, dilation)


def sample_box(mask: np.ndarray, rng: np.random.RandomState,
               noise: float = 0.1) -> np.ndarray:
    """Rasterized (jittered) bounding-box outline region."""
    ys, xs = np.nonzero(mask)
    out = np.zeros_like(mask, dtype=bool)
    if len(ys) == 0:
        return out
    y0, y1 = ys.min(), ys.max()
    x0, x1 = xs.min(), xs.max()
    h, w = mask.shape
    jitter = lambda v, span: int(np.clip(v + rng.uniform(-noise, noise) * span, 0, None))
    y0 = max(0, jitter(y0, y1 - y0))
    x0 = max(0, jitter(x0, x1 - x0))
    y1 = min(h - 1, jitter(y1, y1 - y0))
    x1 = min(w - 1, jitter(x1, x1 - x0))
    out[y0 : y1 + 1, x0 : x1 + 1] = True
    return out


def _draw_line(out: np.ndarray, p0, p1, thickness: int = 2):
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1)) * 2
    ys = np.linspace(p0[0], p1[0], n).astype(int)
    xs = np.linspace(p0[1], p1[1], n).astype(int)
    valid = (ys >= 0) & (ys < out.shape[0]) & (xs >= 0) & (xs < out.shape[1])
    out[ys[valid], xs[valid]] = True
    if thickness > 1:
        out |= _dilate(out, thickness - 1)
    return out


def _bezier(points: np.ndarray, n: int = 100) -> np.ndarray:
    """Quadratic bezier chain through control points."""
    pts = []
    for i in range(len(points) - 2):
        p0, p1, p2 = points[i], points[i + 1], points[i + 2]
        t = np.linspace(0, 1, n // max(len(points) - 2, 1))[:, None]
        pts.append(((1 - t) ** 2) * p0 + 2 * (1 - t) * t * p1 + t ** 2 * p2)
    return np.concatenate(pts, 0) if pts else points.astype(float)


def sample_scribble(mask: np.ndarray, rng: np.random.RandomState,
                    num_ctrl: int = 5, thickness: int = 2) -> np.ndarray:
    """Random bezier stroke through foreground control points
    (reference scribble.py:16-95 behavioral envelope)."""
    ys, xs = np.nonzero(mask)
    out = np.zeros_like(mask, dtype=bool)
    if len(ys) < 2:
        return sample_point(mask, rng)
    idx = rng.choice(len(ys), size=min(num_ctrl, len(ys)), replace=False)
    ctrl = np.stack([ys[idx], xs[idx]], -1).astype(float)
    ctrl = ctrl[np.argsort(ctrl[:, 0])]
    curve = _bezier(ctrl)
    for i in range(len(curve) - 1):
        _draw_line(out, curve[i], curve[i + 1], thickness=1)
    out &= mask.astype(bool)  # keep the stroke on the object
    return _dilate(out, thickness - 1) if thickness > 1 else out


def sample_circle(mask: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """Random circle (ring) centered inside the mask
    (reference circle.py:15-105 behavioral envelope)."""
    ys, xs = np.nonzero(mask)
    out = np.zeros_like(mask, dtype=bool)
    if len(ys) == 0:
        return out
    i = rng.randint(len(ys))
    cy, cx = ys[i], xs[i]
    extent = max(ys.max() - ys.min(), xs.max() - xs.min())
    r = max(2, int(rng.uniform(0.1, 0.4) * extent))
    theta = np.linspace(0, 2 * np.pi, 8 * r)
    py = (cy + r * np.sin(theta)).astype(int)
    px = (cx + r * np.cos(theta)).astype(int)
    valid = (py >= 0) & (py < mask.shape[0]) & (px >= 0) & (px < mask.shape[1])
    out[py[valid], px[valid]] = True
    return _dilate(out, 1)


def sample_polygon(mask: np.ndarray, rng: np.random.RandomState,
                   num_vertices: int = 8) -> np.ndarray:
    """Random polygon outline following the mask boundary
    (reference polygon.py:53-136 behavioral envelope)."""
    ys, xs = np.nonzero(mask)
    out = np.zeros_like(mask, dtype=bool)
    if len(ys) < 3:
        return sample_point(mask, rng)
    cy, cx = ys.mean(), xs.mean()
    angles = np.arctan2(ys - cy, xs - cx)
    order = np.argsort(angles)
    step = max(len(order) // num_vertices, 1)
    verts = np.stack([ys[order[::step]], xs[order[::step]]], -1).astype(float)
    verts += rng.uniform(-2, 2, verts.shape)
    for i in range(len(verts)):
        _draw_line(out, verts[i], verts[(i + 1) % len(verts)], thickness=1)
    return _dilate(out, 1)


SAMPLERS = {
    "Point": sample_point,
    "Polygon": sample_polygon,
    "Scribble": sample_scribble,
    "Circle": sample_circle,
    "Box": sample_box,
}



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


class ShapeSampler:
    """Reference visual_sampler/sampler.py:15-74: select up to
    ``max_candidate`` instances and draw one random-mode prompt per mask."""

    def __init__(self, max_candidate: int = 1, modes=MODES, seed: int | None = None):
        self.max_candidate = max_candidate
        self.modes = modes
        self.rng = np.random.RandomState(seed)

    def __call__(self, gt_masks: np.ndarray) -> dict:
        """gt_masks: (N, H, W) -> dict(rand_shape (M, H, W) bool, types,
        sampled instance indices)."""
        n = len(gt_masks)
        if n == 0:
            return {"rand_shape": np.zeros((0, *gt_masks.shape[1:]), bool),
                    "types": [], "indices": []}
        k = min(self.max_candidate, n)
        idx = self.rng.choice(n, size=k, replace=False)
        shapes, types = [], []
        for i in idx:
            mode = self.modes[self.rng.randint(len(self.modes))]
            shapes.append(SAMPLERS[mode](np.asarray(gt_masks[i], bool), self.rng))
            types.append(mode)
        return {"rand_shape": np.stack(shapes), "types": types, "indices": list(idx)}
