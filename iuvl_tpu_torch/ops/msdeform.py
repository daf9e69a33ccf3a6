"""Multi-scale deformable attention core, plain PyTorch.

Counterpart of ``iuvl_tpu/ops/msdeform.py:ms_deform_attn_core`` with the
math of its batch-1 ``auto`` choice, ``wide`` (``_bilinear_gather_wide``:
four bilinear taps with zero-padding validity, the tap weights in the
value's dtype), which is also the ``xla`` oracle's up to where the weights
are rounded. Autograd takes its backward. The hand-written msdeform
forward and backward kernel (B7) and the batch > 1 backward glue (B8) are
not ported yet (ROADMAP.md Queue B), so every ``msdeform_impl`` of the
port runs this.
"""

from __future__ import annotations

from typing import Sequence

import torch


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


def ms_deform_attn_core(value, spatial_shapes: Sequence[tuple[int, int]],
                        sampling_locations, attention_weights):
    """value (B, S, heads, d), levels concatenated along S;
    sampling_locations (B, Lq, heads, L, P, 2) in [0, 1] (x, y);
    attention_weights (B, Lq, heads, L, P), softmaxed. Returns
    (B, Lq, heads * d), in the weights' dtype (fp32) as in JAX."""
    b, s, nh, d = value.shape
    lq = sampling_locations.shape[1]
    assert sum(h * w for h, w in spatial_shapes) == s, (spatial_shapes, s)
    v = value.permute(0, 2, 1, 3)
    out, start = None, 0
    for lvl, (hl, wl) in enumerate(spatial_shapes):
        v_l = v[:, :, start:start + hl * wl]
        start += hl * wl
        loc = sampling_locations[:, :, :, lvl].permute(0, 2, 1, 3, 4)  # (B, nh, Lq, P, 2)
        sampled = _bilinear_gather(v_l, hl, wl, loc[..., 0] * wl - 0.5, loc[..., 1] * hl - 0.5)
        w_l = attention_weights[:, :, :, lvl].permute(0, 2, 1, 3)
        contrib = (sampled * w_l[..., None]).sum(dim=3)
        out = contrib if out is None else out + contrib
    return out.permute(0, 2, 1, 3).reshape(b, lq, nh * d)
