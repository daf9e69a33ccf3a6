"""Deformable-attention pixel decoder, PyTorch port of
``iuvl_tpu/models/xdecoder/pixel_decoder.py``.

A deformable-DETR encoder over the {res3, res4, res5} FPN levels (d_model
= conv_dim, 8 heads, 4 points, FFN 1024) flattened into one (B, S, C)
token stream, then top-down fusion into res2 and a 1x1 mask-features
projection. NHWC throughout. Rounding points follow the flax modules'
``dtype=`` casts: 1x1 convs and Dense layers in the working dtype, the
sampling offsets and attention weights, GroupNorm and LayerNorm in fp32.
The deformable core is ``ops/msdeform.py``: ``msdeform_impl`` picks its route
as JAX's ``impl`` does (``auto``: the flat core with the B7 and B8 kernels at
batch > 1, the plain ``wide`` core at batch 1; ``hybrid``: B15 on the levels
of at most 1536 cells), ``attn_impl='plain'`` the kernels' plain versions.

Parameter names mirror the flax tree (``models/xdecoder/convert.py``);
1x1 convs are ``nn.Linear`` (out, in).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.common import conv_nhwc, group_norm_f32, layer_norm_f32, linear
from ...ops.msdeform import ms_deform_attn_core
from ...ops.position_embedding import position_embedding_sine
from ...ops.resize import resize_axis


def sampling_offset_grid(n_heads: int, n_levels: int, n_points: int) -> torch.Tensor:
    """The reference's initial ``sampling_offsets`` bias: per head a unit
    compass direction, scaled by the point index (flat, (heads * levels *
    points * 2,))."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    grid = grid * (np.arange(n_points, dtype=np.float32) + 1)[None, None, :, None]
    return torch.from_numpy(grid.reshape(-1).astype(np.float32))


class MSDeformAttn(nn.Module):
    def __init__(self, d_model: int = 512, n_levels: int = 3, n_heads: int = 8,
                 n_points: int = 4, dtype: torch.dtype = torch.float32,
                 msdeform_impl: str = "xla", attn_impl: str = "auto"):
        super().__init__()
        self.n_heads, self.n_levels, self.n_points = n_heads, n_levels, n_points
        self.dtype, self.msdeform_impl, self.attn_impl = dtype, msdeform_impl, attn_impl
        self.value_proj = nn.Linear(d_model, d_model)
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.output_proj = nn.Linear(d_model, d_model)

    def forward(self, query, reference_points, value_src, spatial_shapes):
        """query (B, Lq, C) content + position; reference_points
        (B, Lq, levels, 2) in [0, 1]; value_src (B, S, C)."""
        b, lq, _ = query.shape
        nh, nl, npt = self.n_heads, self.n_levels, self.n_points
        value = linear(value_src, self.value_proj.weight, self.value_proj.bias, self.dtype)
        value = value.reshape(b, value_src.shape[1], nh, -1)
        f32 = torch.float32
        so, aw = self.sampling_offsets, self.attention_weights
        offsets = linear(query, so.weight, so.bias, f32).reshape(b, lq, nh, nl, npt, 2)
        attn = linear(query, aw.weight, aw.bias, f32).reshape(b, lq, nh, nl * npt)
        attn = torch.softmax(attn, dim=-1).reshape(b, lq, nh, nl, npt)
        normalizer = torch.tensor([[w, h] for h, w in spatial_shapes], dtype=f32,
                                  device=query.device)
        locations = (reference_points[:, :, None, :, None, :]
                     + offsets / normalizer[None, None, None, :, None, :])
        out = ms_deform_attn_core(value, spatial_shapes, locations, attn,
                                  impl=self.msdeform_impl, attn_impl=self.attn_impl)
        return linear(out, self.output_proj.weight, self.output_proj.bias, self.dtype)


class DeformableEncoderLayer(nn.Module):
    def __init__(self, d_model: int = 512, d_ffn: int = 1024, n_levels: int = 3,
                 n_heads: int = 8, n_points: int = 4, dtype: torch.dtype = torch.float32,
                 msdeform_impl: str = "xla", attn_impl: str = "auto"):
        super().__init__()
        self.dtype = dtype
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points, dtype,
                                      msdeform_impl, attn_impl)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, src, pos, reference_points, spatial_shapes):
        attn_out = self.self_attn(src + pos, reference_points, src, spatial_shapes)
        src = layer_norm_f32(src + attn_out, self.norm1.weight, self.norm1.bias, 1e-5)
        y = F.relu(linear(src, self.linear1.weight, self.linear1.bias, self.dtype))
        y = linear(y, self.linear2.weight, self.linear2.bias, self.dtype)
        return layer_norm_f32(src + y, self.norm2.weight, self.norm2.bias, 1e-5)


def encoder_reference_points(spatial_shapes, device=None) -> torch.Tensor:
    """Per-token normalised centres, broadcast over levels (valid ratios 1):
    (S, L, 2) in (x, y)."""
    pts = []
    for h, w in spatial_shapes:
        ys = (np.arange(h, dtype=np.float32) + 0.5) / h
        xs = (np.arange(w, dtype=np.float32) + 0.5) / w
        gx, gy = np.meshgrid(xs, ys)
        pts.append(np.stack([gx.reshape(-1), gy.reshape(-1)], -1))
    ref = np.concatenate(pts, axis=0)
    ref = np.tile(ref[:, None, :], (1, len(spatial_shapes), 1))
    return torch.from_numpy(ref).to(device)


class DeformablePixelDecoder(nn.Module):
    """Input: FPN dict {res2..res5} NHWC (SimpleFPN widths). Output:
    (mask_features (B, H/4, W/4, mask_dim), [res5', res4', res3'] fp32)."""

    NAMES = ("res5", "res4", "res3")

    def __init__(self, in_dims: Sequence[int] = (128, 256, 512, 1024), conv_dim: int = 512,
                 mask_dim: int = 512, num_layers: int = 6, n_heads: int = 8,
                 n_points: int = 4, dtype: torch.dtype = torch.float32,
                 msdeform_impl: str = "xla", attn_impl: str = "auto"):
        super().__init__()
        self.dtype, self.conv_dim = dtype, conv_dim
        res2, res3, res4, res5 = in_dims
        self.input_proj = nn.ModuleList(nn.Linear(c, conv_dim) for c in (res5, res4, res3))
        self.input_gn = nn.ModuleList(nn.GroupNorm(32, conv_dim, eps=1e-5) for _ in range(3))
        self.level_embed = nn.Parameter(torch.zeros(3, conv_dim))
        self.layers = nn.ModuleList(
            DeformableEncoderLayer(conv_dim, 1024, 3, n_heads, n_points, dtype, msdeform_impl,
                                   attn_impl)
            for _ in range(num_layers))
        self.fpn_lateral = nn.Linear(res2, conv_dim, bias=False)
        self.fpn_lateral_gn = nn.GroupNorm(32, conv_dim, eps=1e-5)
        self.fpn_output = nn.Conv2d(conv_dim, conv_dim, 3, padding=1, bias=False)
        self.fpn_output_gn = nn.GroupNorm(32, conv_dim, eps=1e-5)
        self.mask_features = nn.Linear(conv_dim, mask_dim)

    @staticmethod
    def _gn(x, gn: nn.GroupNorm):
        return group_norm_f32(x, gn.num_groups, gn.weight, gn.bias, gn.eps)

    def forward(self, features: dict):
        dt, c = self.dtype, self.conv_dim
        srcs, poss, shapes = [], [], []
        for i, name in enumerate(self.NAMES):
            proj = self.input_proj[i]
            y = self._gn(linear(features[name], proj.weight, proj.bias, dt), self.input_gn[i])
            srcs.append(y)
            h, w = y.shape[1], y.shape[2]
            shapes.append((h, w))
            poss.append(position_embedding_sine(h, w, c // 2, device=y.device))
        b = srcs[0].shape[0]
        src = torch.cat([s.reshape(b, -1, c) for s in srcs], dim=1)
        pos = torch.cat([p.reshape(1, -1, c) + self.level_embed[i][None, None]
                         for i, p in enumerate(poss)], dim=1).to(src.dtype)
        ref = encoder_reference_points(shapes, src.device)[None].expand(b, -1, -1, -1)
        y = src
        for layer in self.layers:
            y = layer(y, pos, ref, shapes)
        outs, start = [], 0
        for h, w in shapes:
            outs.append(y[:, start:start + h * w].reshape(b, h, w, c))
            start += h * w
        lateral = self._gn(linear(features["res2"], self.fpn_lateral.weight, None, dt),
                           self.fpn_lateral_gn)
        top = resize_axis(resize_axis(outs[-1], 1, lateral.shape[1], "linear"), 2,
                          lateral.shape[2], "linear").to(lateral.dtype)
        fused = conv_nhwc(lateral + top, self.fpn_output, dt, padding=1)
        fused = F.relu(self._gn(fused, self.fpn_output_gn))
        mf = self.mask_features
        return linear(fused, mf.weight, mf.bias, dt), outs
