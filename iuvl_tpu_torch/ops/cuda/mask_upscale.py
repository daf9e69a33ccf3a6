"""SAM mask upscale stack + hypernetwork contraction in one kernel.

Replaces ``iuvl_tpu/ops/pallas/mask_upscale.py:masks_upscale`` (B6).
Kernel: ``csrc/mask_upscale.cu``, whose header says what bounds it on the
card, how it keeps the weights resident and every intermediate in
registers, and why the TPU's block-diagonal matrices are not carried over.

A 2x2 / stride-2 transposed conv is a per-site matmul: with the PyTorch
``ConvTranspose2d`` weight k (cin, co, 2, 2),
``out[2i+di, 2j+dj, :] = x[i, j] @ k[:, :, di, dj]``, so the stack runs on
flat (B, H*W, C) keys and yields logits with columns ordered
``(t, di, ei, dj, ej)``; :func:`unflatten_masks` turns them into
(B, M, 4H, 4W).

:func:`masks_upscale` is differentiable: its backward is the plain
version's vjp, recomputed under autograd (JAX's ``_bwd`` rule takes
``jax.vjp`` of ``masks_upscale_xla``).
"""

from __future__ import annotations

import torch

from ..common import gelu, plain_vjp
from .build import launch, require

C, M = 256, 4
EPS = 1e-6


def flat_deconv(k: torch.Tensor) -> torch.Tensor:
    """ConvTranspose2d weight (cin, co, 2, 2) -> contiguous (cin, 4*co),
    cols (di, dj, co)."""
    return k.permute(0, 2, 3, 1).reshape(k.shape[0], 4 * k.shape[1]).contiguous()


def masks_upscale_plain(keys, w1, b1, lnw, lnb, w2, b2, hyper):
    """Plain version with the rounding points of ``iuvl_tpu``
    ``masks_upscale_xla``, contracting with ``hyper`` directly. keys
    (B, HW, C); w1 (C, 4*C/4) and w2 (C/4, 4*C/8) the ConvTranspose2d
    weights through :func:`flat_deconv`; biases and hyper (B, M, C/8) in
    keys' dtype; lnw, lnb fp32. Returns (B, HW, M*16) logits in keys'
    dtype."""
    b, n, _ = keys.shape
    c4, c8 = b1.shape[0], b2.shape[0]
    y1 = keys @ w1 + b1.repeat(4)
    yf = y1.float().reshape(b, n, 4, c4)
    mean = yf.mean(-1, keepdim=True)
    var = (yf * yf).mean(-1, keepdim=True) - mean * mean
    y1 = (yf - mean) * torch.rsqrt(var + EPS) * lnw.float() + lnb.float()
    y1 = gelu(y1.to(keys.dtype))
    y2 = gelu(y1 @ w2 + b2.repeat(4))
    y2 = y2.reshape(b, n, 2, 2, 2, 2, c8)  # (di, dj, ei, ej, c)
    out = torch.einsum("bnijklc,btc->bntikjl", y2.float(), hyper.float())
    return out.reshape(b, n, hyper.shape[1] * 16).to(keys.dtype)


def _upscale_forward(keys, w1, b1, lnw, lnb, w2, b2, hyper):
    """B6's forward: the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if keys.device.type == "cpu":
        return masks_upscale_plain(keys, w1, b1, lnw, lnb, w2, b2, hyper)
    b, n, c = keys.shape
    if c != C or hyper.shape[1] != M or n < 1:
        raise ValueError(
            f"masks_upscale kernel: unsupported C={c}, M={hyper.shape[1]}, HW={n}")
    bf, f32, dev = torch.bfloat16, torch.float32, keys.device
    c4, c8 = C // 4, C // 8
    args = dict(keys=keys, w1=w1, b1=b1, lnw=lnw, lnb=lnb, w2=w2, b2=b2, hyper=hyper)
    shapes = dict(keys=(b, n, C), w1=(C, 4 * c4), b1=(c4,), lnw=(c4,), lnb=(c4,),
                  w2=(c4, 4 * c8), b2=(c8,), hyper=(b, M, c8))
    for name, tensor in args.items():
        require("masks_upscale", name, tensor,
                f32 if name in ("lnw", "lnb") else bf, shapes[name], dev)
    out = torch.empty((b, n, M * 16), dtype=bf, device=dev)
    launch("iuvl_masks_upscale", dev, *(t_.data_ptr() for t_ in args.values()),
           out.data_ptr(), b, n)
    masks_upscale.launches += 1
    return out


class _MasksUpscale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        return _upscale_forward(*args)

    @staticmethod
    def backward(ctx, g):
        return tuple(plain_vjp(masks_upscale_plain, ctx.saved_tensors, ctx.needs_input_grad, g))


def masks_upscale(keys, w1, b1, lnw, lnb, w2, b2, hyper):
    """Fused upscale + hypernetwork mask logits: the CUDA kernel for CUDA
    tensors (bf16, C 256, 4 mask tokens, any HW >= 1), the plain version
    for CPU tensors; differentiable, its backward the plain version's
    vjp. Arguments as :func:`masks_upscale_plain`."""
    return _MasksUpscale.apply(keys, w1, b1, lnw, lnb, w2, b2, hyper)


masks_upscale.launches = 0


def unflatten_masks(flat: torch.Tensor, h: int, w: int, m: int) -> torch.Tensor:
    """(B, H*W, M*16) with cols (t, di, ei, dj, ej) -> (B, M, 4H, 4W)."""
    b = flat.shape[0]
    x = flat.reshape(b, h, w, m, 2, 2, 2, 2).permute(0, 3, 1, 4, 5, 2, 6, 7)
    return x.reshape(b, m, 4 * h, 4 * w)
