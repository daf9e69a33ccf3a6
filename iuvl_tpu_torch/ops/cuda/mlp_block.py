"""ViT block tail: residual + LayerNorm + MLP + residual in one kernel.

Replaces ``iuvl_tpu/ops/pallas/mlp_block.py:block_tail`` (B3). Kernel:
``csrc/mlp_block.cu``, whose header says what bounds it on the card and
how it streams the 4C hidden through shared memory instead of device
memory.
"""

from __future__ import annotations

import torch

from ..common import gelu, layer_norm_f32
from .build import launch, require

EPS = 1e-6


def block_tail_plain(x, a, scale, bias, w1, b1, w2t, b2, eps=EPS):
    """``x1 = x + a; x1 + gelu(LN(x1) @ w1^T + b1) @ w2t + b2`` with the
    rounding points of ``iuvl_tpu`` ``_tail_xla``. x, a: (T, C); w1: (H, C)
    in ``nn.Linear`` layout and w2t: (H, C), the second weight transposed;
    weights and biases in x's dtype, LN scale and bias fp32."""
    x1 = x + a
    y = layer_norm_f32(x1, scale, bias, eps).to(x.dtype)
    h = gelu(y @ w1.t() + b1)
    return x1 + (h @ w2t + b2)


def block_tail(x, a, scale, bias, w1, b1, w2t, b2):
    """Fused block tail for flattened token rows (T, C): the CUDA kernel for
    CUDA tensors (bf16, T % 32 == 0, C in {768, 1024, 1280}, H % 128 == 0),
    the plain version for CPU tensors. Arguments as
    :func:`block_tail_plain`."""
    if x.device.type == "cpu":
        return block_tail_plain(x, a, scale, bias, w1, b1, w2t, b2)
    t, c = x.shape
    hidden = w1.shape[0]
    if t % 32 or c not in (768, 1024, 1280) or hidden % 128:
        raise ValueError(f"block_tail kernel: unsupported T={t}, C={c}, H={hidden}")
    bf, f32, dev = torch.bfloat16, torch.float32, x.device
    args = dict(x=x, a=a, scale=scale, bias=bias, w1=w1, b1=b1, w2t=w2t, b2=b2)
    shapes = dict(x=(t, c), a=(t, c), scale=(c,), bias=(c,), w1=(hidden, c),
                  b1=(hidden,), w2t=(hidden, c), b2=(c,))
    for name, tensor in args.items():
        dtype = f32 if name in ("scale", "bias") else bf
        require("block_tail", name, tensor, dtype, shapes[name], dev)
    out = torch.empty_like(x)
    launch("iuvl_block_tail", dev, *(t_.data_ptr() for t_ in args.values()),
           out.data_ptr(), t, c, hidden, EPS)
    block_tail.launches += 1
    return out


block_tail.launches = 0
