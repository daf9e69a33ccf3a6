"""Point sampling ops (PointRend-style), PyTorch port of
``iuvl_tpu/ops/point_sample.py``.

Bilinear sampling with ``grid_sample(align_corners=False)`` semantics
(pixel = coord * size - 0.5, zero padding), summed over the four taps in
the JAX package's order, so fp32 results agree to rounding.
:func:`point_sample_trainable`'s backward is the tap scatter (B12,
``ops/cuda/tap_scatter.py``) in the JAX package's wide-table address
space, folded back to the map with four shifted slices.

Random draws: the JAX functions take a ``jax.random`` key. The port takes
a :data:`Draw`, ``draw(name, shape) -> Tensor`` of uniform [0, 1) values:
:func:`generator_draws` takes them from a ``torch.Generator``,
:func:`given_draws` from a mapping, so that a test can hand the port the
very numbers JAX drew.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch

from .cuda.tap_scatter import tap_scatter, tap_scatter_plain

Draw = Callable[[str, tuple], torch.Tensor]


def generator_draws(generator: torch.Generator, device=None) -> Draw:
    """Draws from ``generator`` (on its own device), moved to ``device``."""
    def draw(name: str, shape: tuple) -> torch.Tensor:
        return torch.rand(shape, generator=generator, device=generator.device).to(device)
    return draw


def given_draws(values: Mapping[str, torch.Tensor]) -> Draw:
    """Draws looked up by name; a missing name or a wrong shape raises."""
    def draw(name: str, shape: tuple) -> torch.Tensor:
        t = values[name]
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"draw {name!r}: shape {tuple(t.shape)}, expected {tuple(shape)}")
        return t
    return draw


_TAPS = ((0, 0), (0, 1), (1, 0), (1, 1))


def _bilinear_taps(h: int, w: int, coords: torch.Tensor):
    """[(flat index clipped into the map, weight * validity)] for the four
    taps of points at (..., 2) xy coords in [0, 1]."""
    x = coords[..., 0] * w - 0.5
    y = coords[..., 1] * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    out = []
    for (dy, dx), wgt in zip(_TAPS, ((1 - fy) * (1 - fx), (1 - fy) * fx, fy * (1 - fx),
                                     fy * fx)):
        xi, yi = x0 + dx, y0 + dy
        valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
        out.append((idx, wgt * valid.to(wgt.dtype)))
    return out


def point_sample(masks: torch.Tensor, coords: torch.Tensor, store_dtype=None) -> torch.Tensor:
    """Bilinear sample of (N, H, W) maps at (N, P, 2) xy coords in [0, 1];
    returns (N, P) in masks' dtype. ``store_dtype`` narrows the gathered
    table only (exact for binary masks in bf16)."""
    n, h, w = masks.shape
    table = masks.reshape(n, h * w)
    if store_dtype is not None:
        table = table.to(store_dtype)
    out = torch.zeros(coords.shape[:-1], dtype=masks.dtype, device=masks.device)
    for idx, wgt in _bilinear_taps(h, w, coords):
        out = out + torch.gather(table, 1, idx).to(masks.dtype) * wgt.to(masks.dtype)
    return out


def point_sample_shared(masks: torch.Tensor, coords: torch.Tensor,
                        store_dtype=None) -> torch.Tensor:
    """Bilinear sample of (B, C, H, W) maps at (B, P, 2) coords shared by
    the C maps (rows of C channels gathered at once). Returns (B, C, P)."""
    b, c, h, w = masks.shape
    table = masks.permute(0, 2, 3, 1).reshape(b, h * w, c)
    if store_dtype is not None:
        table = table.to(store_dtype)
    out = torch.zeros((b, coords.shape[1], c), dtype=masks.dtype, device=masks.device)
    for idx, wgt in _bilinear_taps(h, w, coords):
        g = torch.gather(table, 1, idx[..., None].expand(-1, -1, c))
        out = out + g.to(masks.dtype) * wgt.to(masks.dtype)[..., None]
    return out.transpose(1, 2)


def _tap_weights(h: int, w: int, coords: torch.Tensor, dtype):
    """Wide-table base row, per-tap weights (..., 4), pad and span: the
    gather side's math in the address space of ``iuvl_tpu``'s wide table
    (row ``base`` holds the taps at flat offsets base - pad + {0, 1, w,
    w + 1})."""
    x = coords[..., 0] * w - 0.5
    y = coords[..., 1] * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    pad, span = w + 1, h * w + w + 1
    base = (y0.long() * w + x0.long() + pad).clamp(0, span - 1)
    wgts = torch.stack([wgt.to(dtype) for _, wgt in _bilinear_taps(h, w, coords)], dim=-1)
    return base, wgts, pad, span


class _PointSampleTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, masks, coords, impl):
        ctx.impl = impl
        ctx.save_for_backward(masks, coords)
        return point_sample(masks, coords)

    @staticmethod
    def backward(ctx, g):
        scatter = tap_scatter if ctx.impl == "auto" else tap_scatter_plain
        masks, coords = ctx.saved_tensors
        n, h, w = masks.shape
        base, wgts, pad, span = _tap_weights(h, w, coords, masks.dtype)
        rows = (g[..., None].float() * wgts.float()).contiguous()
        acc = scatter(base.to(torch.int32).contiguous(), rows, span)
        # Tap k of wide row i lands on flat cell i + off_k - pad.
        d_flat = None
        for k, off in enumerate((0, 1, w, w + 1)):
            s = pad - off
            piece = acc[:, s:s + h * w, k]
            d_flat = piece if d_flat is None else d_flat + piece
        return d_flat.reshape(n, h, w).to(masks.dtype), None, None


def point_sample_trainable(masks: torch.Tensor, coords: torch.Tensor,
                           impl: str = "auto") -> torch.Tensor:
    """:func:`point_sample` whose backward for the masks is the tap scatter
    (B12; its plain version under ``impl='plain'``, or on the CPU); the coords
    get no gradient (every caller samples at detached or random coords, as
    the reference does)."""
    return _PointSampleTrainable.apply(masks, coords, impl)


def uncertain_point_coords(logits: torch.Tensor, num_points: int, draw: Draw, name: str,
                           oversample_ratio: float = 3.0,
                           importance_sample_ratio: float = 0.75) -> torch.Tensor:
    """Importance sampling of uncertain points (uncertainty = -|logit|) of
    (N, H, W) logits: ``draw(name + '/over')`` gives the oversampled
    candidates, the most uncertain are kept, ``draw(name + '/rand')`` adds
    uniform ones. Returns (N, num_points, 2) coords in [0, 1]."""
    n = logits.shape[0]
    num_sampled = int(num_points * oversample_ratio)
    coords = draw(f"{name}/over", (n, num_sampled, 2))
    uncertainty = -point_sample(logits, coords).abs()
    num_uncertain = int(importance_sample_ratio * num_points)
    num_random = num_points - num_uncertain
    top = torch.topk(uncertainty, num_uncertain, dim=1).indices
    picked = torch.gather(coords, 1, top[..., None].expand(-1, -1, 2))
    if num_random > 0:
        picked = torch.cat([picked, draw(f"{name}/rand", (n, num_random, 2))], dim=1)
    return picked
