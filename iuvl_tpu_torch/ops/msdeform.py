"""Multi-scale deformable attention core, counterpart of
``iuvl_tpu/ops/msdeform.py:ms_deform_attn_core``.

Three routes, chosen by ``impl`` as in JAX (``auto``: ``flat`` at batch > 1,
``wide`` at batch 1):
- ``flat`` (:func:`ms_deform_attn_flat`): per level the autograd function
  :class:`FlatLevel`, JAX's ``_flat_level`` with its hand-written VJP. Its
  forward is the B7 forward kernel; its backward runs, per image, the B7
  gather, the B8 glue and the B7 scatter (``ops/cuda/msdeform.py``,
  ``ops/cuda/deform_bwd_glue.py``), and saves only the level's values,
  locations and weights. ``attn_impl='plain'`` runs the same function on
  the kernels' plain versions.
- ``wide`` and ``xla``: plain PyTorch with the math of
  ``_bilinear_gather_wide`` (four bilinear taps with zero-padding validity,
  the tap weights in the value's dtype), autograd's backward.
- ``hybrid``: ``wide``, but a level of at most :data:`ONEHOT_MAX_CELLS`
  cells (res5 at 1024^2) goes through :class:`OnehotLevel`, JAX's
  ``_level_contribution_onehot``: the B15 kernel
  (``ops/cuda/onehot_gather.py``) on the level's wide map, its output in
  the value's dtype; the backward is autograd of the plain ``wide`` level,
  as JAX's ``_level_onehot_bwd``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .cuda.deform_bwd_glue import deform_bwd_glue_plain, deform_bwd_glue_q
from .cuda.msdeform import (deform_gather_rows, deform_gather_rows_plain, deform_scatter_dv,
                            deform_scatter_dv_plain, ms_deform_level_fwd,
                            ms_deform_level_fwd_plain)
from .cuda.onehot_gather import (onehot_deform_level_forward,
                                 onehot_deform_level_forward_plain)

IMPLS = ("auto", "flat", "hybrid", "wide", "xla")
ONEHOT_MAX_CELLS = 1536  # the 'hybrid' core's one-hot levels (JAX's onehot_max_cells)


def _bilinear_gather(v_flat, h: int, w: int, x, y):
    """4-tap bilinear sample with zero padding (grid_sample
    align_corners=False). v_flat (B, heads, h*w, d); x, y (B, heads, Lq, P)
    pixel coordinates. Returns (B, heads, Lq, P, d) in v_flat's dtype.
    One flat row gather per tap, so that autograd keeps a 1-D index."""
    b, nh, hw, d = v_flat.shape
    lq, p = x.shape[2], x.shape[3]
    dt = v_flat.dtype
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0).to(dt), (y - y0).to(dt)
    table = v_flat.reshape(b * nh * hw, d)
    base = (torch.arange(b * nh, device=x.device) * hw).reshape(b, nh, 1, 1)
    out = None
    for dy, dx, wgt in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                        (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
        xi, yi = x0 + dx, y0 + dy
        valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
        g = table[(base + idx).reshape(-1)].reshape(b, nh, lq, p, d)
        contrib = g * (wgt * valid.to(dt))[..., None]
        out = contrib if out is None else out + contrib
    return out


def _level_contribution_wide(v_l, h: int, w: int, x, y, aw):
    """One level's ``(sampled * aw).sum(points)`` through the wide math:
    (B, nh, Lq, d), fp32 for fp32 weights."""
    return (_bilinear_gather(v_l, h, w, x, y) * aw[..., None]).sum(dim=3)


def wide_map(v: torch.Tensor, w: int) -> torch.Tensor:
    """``_wide_map``: (B, nh, hw, d) -> (B, nh, hw, 4d), the values beside
    their rolls by -1, -w and -(w + 1) along hw."""
    return torch.cat([v, *(torch.roll(v, -off, dims=2) for off in (1, w, w + 1))], dim=-1)


class OnehotLevel(torch.autograd.Function):
    """One small level's contribution, ``_level_contribution_onehot``:
    v (B, nh, h*w, d); x, y, aw (B, nh, Lq, P) fp32 -> (B, nh, Lq, d) in v's
    dtype. The forward folds the attention weight into the slot weights in
    fp32 and runs B15 on the level's wide map (``attn_impl='plain'``: its
    plain version); the backward is autograd of the plain wide level, its
    cotangent cast to that level's dtype and the gradients to the inputs'
    dtypes (JAX's ``_level_onehot_bwd``)."""

    @staticmethod
    def forward(ctx, v, x, y, aw, h: int, w: int, attn_impl: str):
        ctx.h, ctx.w = h, w
        ctx.save_for_backward(v, x, y, aw)
        b, nh, hw, d = v.shape
        lq, p = x.shape[2], x.shape[3]
        idx, wslot = wide_idx_wslot(h, w, x, y)
        wslot = wslot * aw.float()[..., None]  # (B, nh, Lq, P, 4)
        fwd = onehot_deform_level_forward if attn_impl == "auto" else \
            onehot_deform_level_forward_plain
        out = fwd(wide_map(v, w).reshape(b * nh, hw, 4 * d),
                  idx.reshape(b * nh, lq, p).contiguous(),
                  wslot.transpose(-1, -2).reshape(b * nh, lq, 4, p).contiguous(), p)
        return out.view(b, nh, lq, d)

    @staticmethod
    def backward(ctx, gout):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in saved]
            out = _level_contribution_wide(ins[0], ctx.h, ctx.w, *ins[1:])
            grads = torch.autograd.grad(out, ins, gout.to(out.dtype))
        return (*(g.to(t.dtype) for g, t in zip(grads, saved)), None, None, None)


def _ms_deform_attn_wide(value, spatial_shapes, sampling_locations, attention_weights,
                         onehot_max_cells: int = 0, attn_impl: str = "auto"):
    """The ``wide`` core; with ``onehot_max_cells`` the ``hybrid`` one. The
    levels add up in level order (res5 first), from the first level's
    contribution in its own dtype, as JAX adds them to zeros of the
    value's dtype."""
    b, s, nh, d = value.shape
    lq = sampling_locations.shape[1]
    v = value.permute(0, 2, 1, 3)
    out, start = None, 0
    for lvl, (hl, wl) in enumerate(spatial_shapes):
        v_l = v[:, :, start:start + hl * wl]
        start += hl * wl
        loc = sampling_locations[:, :, :, lvl].permute(0, 2, 1, 3, 4)  # (B, nh, Lq, P, 2)
        x, y = loc[..., 0] * wl - 0.5, loc[..., 1] * hl - 0.5
        w_l = attention_weights[:, :, :, lvl].permute(0, 2, 1, 3)
        if 0 < hl * wl <= onehot_max_cells:
            contrib = OnehotLevel.apply(v_l, x, y, w_l, hl, wl, attn_impl)
        else:
            contrib = _level_contribution_wide(v_l, hl, wl, x, y, w_l)
        out = contrib if out is None else out + contrib
    return out.permute(0, 2, 1, 3).reshape(b, lq, nh * d)


def wide_idx_wslot(h: int, w: int, x: torch.Tensor, y: torch.Tensor):
    """``_wide_idx_wslot``: pixel coordinates x, y (...) -> (the clipped
    top-left flat index (...) int32, the four slot weights (..., 4) fp32
    with zero-padding validity). Differentiable in x and y."""
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0).float(), (y - y0).float()
    x0c, y0c = x0.clamp(0, w - 1), y0.clamp(0, h - 1)
    px, py = (x0c - x0).float(), (y0c - y0).float()
    idx = (y0c * w + x0c).to(torch.int32)

    def inside(hi, t):
        return ((t >= 0) & (t <= hi)).float()

    wx0 = (1.0 - fx) * inside(w - 1, x0)
    wx1 = fx * inside(w - 1, x0 + 1)
    wy0 = (1.0 - fy) * inside(h - 1, y0)
    wy1 = fy * inside(h - 1, y0 + 1)
    zero = torch.zeros_like(wx1)
    sx0 = torch.where(px > 0, wx1, wx0)
    sx1 = torch.where(px > 0, zero, wx1)
    sy0 = torch.where(py > 0, wy1, wy0)
    sy1 = torch.where(py > 0, zero, wy1)
    return idx, torch.stack([sy0 * sx0, sy0 * sx1, sy1 * sx0, sy1 * sx1], dim=-1)


class FlatLevel(torch.autograd.Function):
    """One level's contribution, ``_flat_level``: v (B, nh, h*w, d) bf16 or
    fp32; x, y, aw (B, nh, Lq, P) fp32 -> (B, nh, Lq, d) fp32. Saves only
    (v, x, y, aw), as JAX does; the backward recomputes the indices and slot
    weights, and per image gathers the tap rows, runs the glue for the
    scatter rows and the per-slot dots, and scatters d_value in fp32. The
    locations' and weights' gradients come from the dots through autograd of
    :func:`wide_idx_wslot`, as JAX's ``jax.vjp`` of ``_wide_idx_wslot``.
    ``attn_impl``: ``'auto'`` runs the wrappers (kernels on CUDA tensors),
    ``'plain'`` the plain versions."""

    @staticmethod
    def forward(ctx, v, x, y, aw, h: int, w: int, attn_impl: str):
        ctx.h, ctx.w, ctx.kernels = h, w, attn_impl == "auto"
        ctx.save_for_backward(v, x, y, aw)
        fwd = ms_deform_level_fwd if ctx.kernels else ms_deform_level_fwd_plain
        return fwd(v, x, y, aw, h, w)

    @staticmethod
    def backward(ctx, gout):
        v, x, y, aw = ctx.saved_tensors
        h, w = ctx.h, ctx.w
        gather, glue, scatter = ((deform_gather_rows, deform_bwd_glue_q, deform_scatter_dv)
                                 if ctx.kernels else (deform_gather_rows_plain,
                                                      deform_bwd_glue_plain,
                                                      deform_scatter_dv_plain))
        b, nh, hw, d = v.shape
        lq, p = x.shape[2], x.shape[3]
        with torch.enable_grad():
            xg, yg = x.detach().requires_grad_(), y.detach().requires_grad_()
            idx, wslot = wide_idx_wslot(h, w, xg, yg)
        aw32 = aw.float()
        wa = wslot.detach() * aw32[..., None]
        gout = gout.float().contiguous()
        dots, dv = [], []
        for i in range(b):
            g4 = gather(v[i], idx[i], w)
            contrib, dots_i = glue(g4, gout[i].view(nh * lq, d), wa[i].reshape(-1, 4), p)
            del g4
            dv.append(scatter(contrib, idx[i], hw, w))
            dots.append(dots_i)
        dwa = torch.stack(dots).view(b, nh, lq, p, 4)
        d_aw = (dwa * wslot.detach()).sum(-1).to(aw.dtype)
        d_x, d_y = torch.autograd.grad(wslot, (xg, yg), dwa * aw32[..., None])
        return (torch.stack(dv).to(v.dtype), d_x.to(x.dtype), d_y.to(y.dtype), d_aw,
                None, None, None)


def ms_deform_attn_flat(value, spatial_shapes: Sequence[tuple[int, int]], sampling_locations,
                        attention_weights, attn_impl: str = "auto"):
    """``_ms_deform_attn_flat``: the ``wide`` math with the attention weight
    folded into the slot weights, a :class:`FlatLevel` per level. Returns
    (B, Lq, heads * d) fp32."""
    b, s, nh, d = value.shape
    lq = sampling_locations.shape[1]
    assert sum(h * w for h, w in spatial_shapes) == s, (spatial_shapes, s)
    v = value.permute(0, 2, 1, 3)
    out, start = None, 0
    for lvl, (hl, wl) in enumerate(spatial_shapes):
        v_l = v[:, :, start:start + hl * wl].contiguous()
        start += hl * wl
        loc = sampling_locations[:, :, :, lvl]
        x = (loc[..., 0].permute(0, 2, 1, 3) * wl - 0.5).contiguous()
        y = (loc[..., 1].permute(0, 2, 1, 3) * hl - 0.5).contiguous()
        aw = attention_weights[:, :, :, lvl].permute(0, 2, 1, 3).float().contiguous()
        c = FlatLevel.apply(v_l, x, y, aw, hl, wl, attn_impl)
        out = c if out is None else out + c
    return out.permute(0, 2, 1, 3).reshape(b, lq, nh * d)


def ms_deform_attn_core(value, spatial_shapes: Sequence[tuple[int, int]], sampling_locations,
                        attention_weights, impl: str = "xla", attn_impl: str = "auto"):
    """value (B, S, heads, d), levels concatenated along S;
    sampling_locations (B, Lq, heads, L, P, 2) in [0, 1] (x, y);
    attention_weights (B, Lq, heads, L, P), softmaxed. Returns
    (B, Lq, heads * d), fp32 as in JAX (in the value's dtype where every
    level is a ``hybrid`` one-hot level). ``impl`` as JAX's (``auto``:
    ``flat`` at batch > 1, else ``wide``); ``attn_impl`` picks the kernels
    (``'auto'``) or their plain versions (``'plain'``) on the flat and
    hybrid routes."""
    if impl not in IMPLS:
        raise ValueError(f"msdeform impl {impl!r} not in {IMPLS}")
    if impl == "auto":
        impl = "flat" if value.shape[0] > 1 else "wide"
    if impl == "flat":
        return ms_deform_attn_flat(value, spatial_shapes, sampling_locations,
                                   attention_weights, attn_impl)
    assert sum(h * w for h, w in spatial_shapes) == value.shape[1], (spatial_shapes,
                                                                      value.shape)
    return _ms_deform_attn_wide(value, spatial_shapes, sampling_locations, attention_weights,
                                ONEHOT_MAX_CELLS if impl == "hybrid" else 0, attn_impl)
