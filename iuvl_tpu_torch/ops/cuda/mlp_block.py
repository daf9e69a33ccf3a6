"""ViT block tail: residual + LayerNorm + MLP + residual, and its backward.

Replaces ``iuvl_tpu/ops/pallas/mlp_block.py``: the forward ``block_tail``
(B3, ``csrc/mlp_block.cu``) and the backward ``_tail_backward`` (B10,
``csrc/mlp_block_bwd.cu``). Each kernel's header says what bounds it on
the card and how its design answers that. :func:`block_tail_train` ties
the two together as an autograd function, as ``jax.custom_vjp`` does in
the JAX package.
"""

from __future__ import annotations

import math

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
    CUDA tensors (bf16, any T, C in {768, 1024, 1280}, H % 128 == 0), the
    plain version for CPU tensors. Arguments as :func:`block_tail_plain`."""
    if x.device.type == "cpu":
        return block_tail_plain(x, a, scale, bias, w1, b1, w2t, b2)
    t, c = x.shape
    hidden = w1.shape[0]
    if c not in (768, 1024, 1280) or hidden % 128:
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


def gelu_grad(h: torch.Tensor, approximate: bool) -> torch.Tensor:
    """d gelu / dx in fp32 at fp32 ``h``: the tanh approximation's
    (``iuvl_tpu`` ``_gelu_grad_f32``, the bf16 forward) or the exact erf
    formula's (``_gelu_grad_exact_f32``, the fp32 forward)."""
    if approximate:
        c, a = math.sqrt(2.0 / math.pi), 0.044715
        t = torch.tanh(c * (h + a * h * h * h))
        return 0.5 * (1.0 + t) + 0.5 * h * (1.0 - t * t) * (c * (1.0 + 3.0 * a * h * h))
    cdf = 0.5 * (1.0 + torch.erf(h / math.sqrt(2.0)))
    return cdf + h * torch.exp(-0.5 * h * h) / math.sqrt(2.0 * math.pi)


def block_tail_backward_plain(x, a, g, scale, bias, w1, b1, w2t, eps=EPS):
    """Plain version of the backward, the arithmetic of ``iuvl_tpu``
    ``_tail_bwd_kernel``: recompute LN(x1) and the hidden, then the
    cotangents. Arguments as :func:`block_tail_plain` (b2 is not needed)
    plus g, the output cotangent in x's dtype. Returns (dxa, dscale, dbias,
    dw1, db1, dw2, db2): dxa (the cotangent of both x and a) in x's dtype,
    the rest fp32; dw1 (H, C) and dw2 (C, H) in ``nn.Linear`` layout."""
    dt = x.dtype
    xf = (x + a).float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    rstd = torch.rsqrt(var + eps)
    xhat = (xf - mu) * rstd
    y = (xhat * scale + bias).to(dt)
    hpre = y @ w1.t() + b1
    h = gelu(hpre)
    gg = gelu_grad(hpre.float(), approximate=dt == torch.bfloat16)
    gf = g.float()
    db2 = gf.sum(0)
    dw2 = gf.t() @ h.float()
    dh = gf @ w2t.float().t()
    dhpre = (dh * gg).to(dt).float()
    db1 = dhpre.sum(0)
    dw1 = dhpre.t() @ y.float()
    dy = dhpre @ w1.float()
    dscale = (dy * xhat).sum(0)
    dbias = dy.sum(0)
    dys = dy * scale
    dxf = rstd * (dys - dys.mean(-1, keepdim=True) - xhat * (dys * xhat).mean(-1, keepdim=True))
    dxa = g + dxf.to(dt)
    return dxa, dscale, dbias, dw1, db1, dw2, db2


def block_tail_backward(x, a, g, scale, bias, w1, b1, w2t):
    """Backward of :func:`block_tail`: the CUDA kernel for CUDA tensors
    (bf16, any T, C % 128 == 0, H % 128 == 0), the plain version for CPU
    tensors.
    Arguments and results as :func:`block_tail_backward_plain`."""
    if x.device.type == "cpu":
        return block_tail_backward_plain(x, a, g, scale, bias, w1, b1, w2t)
    t, c = x.shape
    hidden = w1.shape[0]
    if c % 128 or hidden % 128:
        raise ValueError(f"block_tail_backward kernel: unsupported C={c}, H={hidden}")
    bf, f32, dev = torch.bfloat16, torch.float32, x.device
    args = dict(x=x, a=a, g=g, scale=scale, bias=bias, w1=w1, b1=b1, w2t=w2t)
    shapes = dict(x=(t, c), a=(t, c), g=(t, c), scale=(c,), bias=(c,), w1=(hidden, c),
                  b1=(hidden,), w2t=(hidden, c))
    for name, tensor in args.items():
        dtype = f32 if name in ("scale", "bias") else bf
        require("block_tail_backward", name, tensor, dtype, shapes[name], dev)
    empty = lambda *s, dtype=f32: torch.empty(s, dtype=dtype, device=dev)  # noqa: E731
    scratch = (empty(t, c, dtype=bf), empty(t, 2), empty(t, hidden), empty(t, hidden),
               empty(t, hidden, dtype=bf), empty(t, hidden, dtype=bf))
    dxa = torch.empty_like(x)
    grads = (empty(c), empty(c), empty(hidden, c), empty(hidden), empty(c, hidden), empty(c))
    launch("iuvl_block_tail_bwd", dev, *(t_.data_ptr() for t_ in args.values()),
           *(t_.data_ptr() for t_ in scratch), dxa.data_ptr(),
           *(t_.data_ptr() for t_ in grads), t, c, hidden, EPS)
    block_tail_backward.launches += 1
    return (dxa, *grads)


block_tail_backward.launches = 0


class _BlockTail(torch.autograd.Function):
    """B3 forward, B10 backward (or both plain versions). Takes the fp32
    parameters (lin2's weight in its (C, H) layout) and casts them as the
    kernels take them, so that the gradients come back in fp32."""

    @staticmethod
    def forward(ctx, x, a, scale, bias, w1, b1, w2, b2, impl):
        ctx.impl = impl
        ctx.save_for_backward(x, a, scale, bias, w1, b1, w2)
        dt = x.dtype
        fwd = block_tail if impl == "auto" else block_tail_plain
        return fwd(x, a, scale.float(), bias.float(), w1.to(dt), b1.to(dt),
                   w2.to(dt).t().contiguous(), b2.to(dt))

    @staticmethod
    def backward(ctx, g):
        x, a, scale, bias, w1, b1, w2 = ctx.saved_tensors
        dt = x.dtype
        bwd = block_tail_backward if ctx.impl == "auto" else block_tail_backward_plain
        dxa, dscale, dbias, dw1, db1, dw2, db2 = bwd(
            x, a, g.to(dt).contiguous(), scale.float(), bias.float(), w1.to(dt), b1.to(dt),
            w2.to(dt).t().contiguous())
        return dxa, dxa, dscale, dbias, dw1, db1, dw2, db2, None


def block_tail_train(x, a, scale, bias, w1, b1, w2, b2, impl: str = "auto"):
    """Differentiable block tail for training: the kernels B3 and B10
    (their plain versions under ``impl='plain'``, or on the CPU). x, a (T, C)
    in the working dtype; the fp32 LayerNorm and ``nn.Linear`` parameters
    as the module holds them (w1 (H, C), w2 (C, H))."""
    return _BlockTail.apply(x, a, scale, bias, w1, b1, w2, b2, impl)
