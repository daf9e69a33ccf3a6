"""Global-block rel-pos flash attention with the output projection folded in.

Replaces ``iuvl_tpu/ops/pallas/flash_attention.py:flash_attention_rowbias_proj``
(B2). Kernel: ``csrc/flash_attention.cu``, whose header says what bounds
it on the card and how the TPU's sequential grid became loops in a block.
"""

from __future__ import annotations

import torch

from ..rel_pos_attention import rowbias_attention
from .build import launch, require

HEAD_DIM, W, N = 64, 64, 4096


def rowbias_proj_plain(q, k, v, relh, relw, wo, bo, w: int):
    """Plain version: rel-pos attention on pre-scaled q (B, H, N, d) with
    the per-query features relh (B, H, N, N/w) and relw (B, H, N, w), then
    the head-major -> token-major relayout and ``@ wo^T + bo`` (wo in
    ``nn.Linear`` layout and q's dtype, bo fp32). The math of ``iuvl_tpu``
    ``_attn_then_proj(..., 'xla_naive')``. Returns (B, N, C)."""
    out = rowbias_attention(q, k, v, relh, relw, w)
    b, heads, n, d = out.shape
    out = out.transpose(1, 2).reshape(b, n, heads * d)
    return out @ wo.t() + bo.to(q.dtype)


def flash_attention_rowbias_proj(q, k, v, relh, relw, wo, bo, w: int):
    """Row-bias flash attention + output projection: the CUDA kernel for
    CUDA tensors (bf16, head_dim 64, w 64, N 4096: the ViT-B/L/H global
    blocks at 1024^2), the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return rowbias_proj_plain(q, k, v, relh, relw, wo, bo, w)
    b, heads, n, d = q.shape
    c_out = wo.shape[0]
    if d != HEAD_DIM or w != W or n != N or c_out % 16:
        raise ValueError(
            f"flash_attention_rowbias_proj kernel: unsupported d={d}, w={w}, "
            f"N={n}, C={c_out} (needs d 64, w 64, N 4096)")
    bf, f32, dev = torch.bfloat16, torch.float32, q.device
    args = dict(q=q, k=k, v=v, relh=relh, relw=relw, wo=wo, bo=bo)
    shapes = dict(q=(b, heads, n, d), k=(b, heads, n, d), v=(b, heads, n, d),
                  relh=(b, heads, n, n // w), relw=(b, heads, n, w),
                  wo=(c_out, heads * d), bo=(c_out,))
    for name, tensor in args.items():
        require("flash_attention_rowbias_proj", name, tensor,
                f32 if name == "bo" else bf, shapes[name], dev)
    out = torch.empty((b, n, c_out), dtype=bf, device=dev)
    launch("iuvl_rowbias_proj", dev, *(t_.data_ptr() for t_ in args.values()),
           out.data_ptr(), b, heads, n, c_out, w)
    flash_attention_rowbias_proj.launches += 1
    return out


flash_attention_rowbias_proj.launches = 0
