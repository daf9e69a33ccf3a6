"""Sine positional embeddings (DETR-style, ``normalize=True``), PyTorch port
of ``iuvl_tpu/ops/position_embedding.py``: with no padding mask the
cumulative sum of ones is ``i + 1``, computed in closed form. NHWC."""

from __future__ import annotations

import math

import torch


def position_embedding_sine(h: int, w: int, num_pos_feats: int = 128,
                            temperature: float = 10000.0, normalize: bool = True,
                            scale: float | None = None, dtype=torch.float32,
                            device=None) -> torch.Tensor:
    """(h, w, 2 * num_pos_feats): concat(pos_y, pos_x), sin on even and cos
    on odd feature pairs, as the reference orders them."""
    scale = 2 * math.pi if scale is None else scale
    eps = 1e-6
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None]
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :]
    if normalize:
        y = y / (h + eps) * scale
        x = x / (w + eps) * scale
    y, x = y.expand(h, w), x.expand(h, w)
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / num_pos_feats)

    def interleave(t):
        t = t[..., None] / dim_t
        return torch.stack([t[..., 0::2].sin(), t[..., 1::2].cos()], dim=-1).reshape(h, w, -1)

    return torch.cat([interleave(y), interleave(x)], dim=-1).to(dtype)
