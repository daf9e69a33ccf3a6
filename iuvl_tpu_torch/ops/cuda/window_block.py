"""Whole windowed-attention module body (qkv projection + rel-pos attention
+ output projection) for SAM's windowed ViT blocks.

Replaces ``iuvl_tpu/ops/pallas/window_block.py:window_attention_block``
(B1). Kernel: ``csrc/window_block.cu``, whose header says what bounds it
on the card and how one block per window runs the three phases.
"""

from __future__ import annotations

import torch

from ..rel_pos_attention import rel_pos_features, rowbias_attention
from .build import launch, require

WIN, HEAD_DIM = 14, 64


def window_attention_block_plain(xw, wqkv, bqkv, wo, bo, rh, rw, heads: int):
    """Plain version with the math of ``iuvl_tpu`` ``_block_xla``: xw
    (nW, win*win, C) pre-normalised window tokens; wqkv (3C, C) and wo
    (C, C) in ``nn.Linear`` layout and xw's dtype; bqkv, bo fp32 (rounded
    to xw's dtype where added); rh, rw the (win, win, d) fp32 rel-pos
    tables from ``rel_pos_table``. Returns (nW, win*win, C)."""
    nw, n, c = xw.shape
    dt, win = xw.dtype, rh.shape[0]
    qkv = (xw @ wqkv.t() + bqkv.to(dt)).reshape(nw, n, 3, heads, c // heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    relh, relw = rel_pos_features(q, rh, rw)
    out = rowbias_attention(q * (q.shape[-1] ** -0.5), k, v, relh, relw, win)
    return out.transpose(1, 2).reshape(nw, n, c) @ wo.t() + bo.to(dt)


def window_attention_block(xw, wqkv, bqkv, wo, bo, rh, rw, heads: int):
    """Fused windowed attention body: the CUDA kernel for CUDA tensors
    (bf16, win 14, head_dim 64, C % 128 == 0), the plain version for CPU
    tensors. Arguments as :func:`window_attention_block_plain`."""
    if xw.device.type == "cpu":
        return window_attention_block_plain(xw, wqkv, bqkv, wo, bo, rh, rw, heads)
    nw, n, c = xw.shape
    win = rh.shape[0]
    if win != WIN or c != heads * HEAD_DIM or c % 128 or n != win * win:
        raise ValueError(
            f"window_attention_block kernel: unsupported win={win}, C={c}, "
            f"heads={heads}, N={n} (needs win 14, head_dim 64, C % 128 == 0)")
    bf, f32, dev = torch.bfloat16, torch.float32, xw.device
    args = dict(xw=xw, wqkv=wqkv, bqkv=bqkv, wo=wo, bo=bo, rh=rh, rw=rw)
    shapes = dict(xw=(nw, n, c), wqkv=(3 * c, c), bqkv=(3 * c,), wo=(c, c),
                  bo=(c,), rh=(win, win, HEAD_DIM), rw=(win, win, HEAD_DIM))
    for name, tensor in args.items():
        dtype = bf if name in ("xw", "wqkv", "wo") else f32
        require("window_attention_block", name, tensor, dtype, shapes[name], dev)
    n_pad = -(-n // 16) * 16
    qkv_scratch = torch.empty((nw, n_pad, 3 * c), dtype=bf, device=dev)
    o_scratch = torch.empty((nw, n_pad, c), dtype=bf, device=dev)
    out = torch.empty_like(xw)
    launch("iuvl_window_block", dev, *(t_.data_ptr() for t_ in args.values()),
           qkv_scratch.data_ptr(), o_scratch.data_ptr(), out.data_ptr(),
           nw, c, win, HEAD_DIM)
    window_attention_block.launches += 1
    return out


window_attention_block.launches = 0
