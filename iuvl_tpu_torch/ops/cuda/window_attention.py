"""Attention with the decomposed rel-pos bias built in the kernel, over a
square grid: every block's attention under ``attn_impl='window'``.

Replaces ``iuvl_tpu/ops/pallas/window_attention.py:window_rel_attention``
(B13). Kernel: ``csrc/window_attention.cu``, whose header says what bounds
it on the card and why the TPU's (N, N) selector matrices are not carried
over (the kernel takes the windowed grid, N 196, and the global one, N
4096).

B13's rounding points differ from the port's other rel-pos routes, and the
plain version here copies them: the tables are expanded in fp32 and then
rounded to the working dtype; relh and relw are fp32 products of q and the
rounded tables and stay fp32; the scale multiplies the fp32 scores (the
other routes scale q in bf16); softmax in fp32, the probabilities rounded
to v's dtype before ``p @ v``.

The backward is JAX's ``_wra_bwd``: not a kernel, but autograd of the
plain augmented route (``augment_qk_rel_pos`` and plain softmax attention)
recomputed from the saved inputs.
"""

from __future__ import annotations

import torch

from ..rel_pos_attention import augment_qk_rel_pos, rel_pos_tables
from .build import launch, require

HEAD_DIMS = (64, 80)  # the SAM heads: ViT-B/L 64, ViT-H 80


def window_rel_bias(q, rh, rw):
    """B13's bias terms, each (B, H, N, N) fp32: ``relh[., key // w]`` and
    ``relw[., key % w]``, relh and relw the fp32 products of q (B, H, N, d)
    with the expanded tables rh, rw (w, w, d) already rounded to q's
    dtype."""
    b, heads, n, d = q.shape
    w = rh.shape[0]
    qf = q.float().reshape(b, heads, w, w, d)
    relh = torch.einsum("bnhwc,hkc->bnhwk", qf, rh.float()).reshape(b, heads, n, w)
    relw = torch.einsum("bnhwc,wkc->bnhwk", qf, rw.float()).reshape(b, heads, n, w)
    return relh.repeat_interleave(w, dim=-1), relw.repeat(1, 1, 1, w)


def window_rel_scores(q, k, rh, rw):
    """B13's fp32 scores ``((q k^T) d^-1/2 + relh[., key // w]) + relw[.,
    key % w]``, summed in the TPU kernel's order (arguments as
    :func:`window_rel_bias`; k like q)."""
    bias_h, bias_w = window_rel_bias(q, rh, rw)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    return (s + bias_h) + bias_w


def window_rel_attention_fwd_plain(q, k, v, rh, rw):
    """B13's function: ``softmax(window_rel_scores) v`` with the softmax in
    fp32, the probabilities rounded to v's dtype and the product summed in
    fp32 (arguments as :func:`window_rel_scores`). Returns (B, H, N, d) in
    q's dtype."""
    p = torch.softmax(window_rel_scores(q, k, rh, rw), dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def window_rel_attention_fwd(q, k, v, rh, rw):
    """B13 forward: the CUDA kernel for CUDA tensors (bf16, head dim 64 or
    80, any square grid whose tile fits shared memory: w up to ~300), the
    plain version for CPU tensors. Arguments and result as
    :func:`window_rel_attention_fwd_plain`."""
    if q.device.type == "cpu":
        return window_rel_attention_fwd_plain(q, k, v, rh, rw)
    b, heads, n, d = q.shape
    w = rh.shape[0]
    if d not in HEAD_DIMS or w * w != n:
        raise ValueError(f"window_rel_attention kernel: unsupported d={d}, N={n}, table side "
                         f"{w} (needs d in {HEAD_DIMS} and N == w * w)")
    shapes = dict(q=(b, heads, n, d), k=(b, heads, n, d), v=(b, heads, n, d), rh=(w, w, d),
                  rw=(w, w, d))
    for name, t in zip(shapes, (q, k, v, rh, rw)):
        require("window_rel_attention", name, t, torch.bfloat16, shapes[name], q.device)
    o = torch.empty_like(q)
    rel = torch.empty((b * heads, n, 2, w), dtype=torch.float32, device=q.device)  # relh, relw
    launch("iuvl_window_attention", q.device,
           *(t.data_ptr() for t in (q, k, v, rh, rw, rel, o)), b * heads, n, d, w, d ** -0.5)
    window_rel_attention_fwd.launches += 1
    return o


window_rel_attention_fwd.launches = 0


def augmented_attention(q, k, v, rh, rw):
    """JAX's ``impl='xla'`` route (``rel_pos_attention`` on augmented q, k):
    ``softmax(q_aug k_aug^T)`` in fp32, rounded to v's dtype, times v.
    rh, rw the expanded fp32 tables. What B13's backward differentiates."""
    q_aug, k_aug = augment_qk_rel_pos(q, k, rh, rw)
    s = torch.matmul(q_aug.float(), k_aug.float().transpose(-1, -2))
    return torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v)


class _WindowRelAttention(torch.autograd.Function):
    """B13 forward (its plain version with ``plain``); the backward
    recomputes :func:`augmented_attention` under autograd (JAX's
    ``_wra_bwd``). rh, rw are the expanded fp32 tables and get their
    cotangents, which autograd carries on to the stored tables."""

    @staticmethod
    def forward(ctx, q, k, v, rh, rw, plain):
        ctx.save_for_backward(q, k, v, rh, rw)
        fn = window_rel_attention_fwd_plain if plain else window_rel_attention_fwd
        return fn(q, k, v, rh.to(q.dtype).contiguous(), rw.to(q.dtype).contiguous())

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = augmented_attention(*inputs)
            grads = torch.autograd.grad(out, inputs, g.to(out.dtype))
        return (*grads, None)


def window_attention(q, k, v, rh, rw, impl: str = "window"):
    """Differentiable B13 attention on the expanded fp32 tables rh (w, w,
    d) and rw: the kernel under ``impl='window'`` on CUDA tensors, the
    plain version under ``'window_plain'`` and on the CPU. q, k, v (B, H,
    N, d). Returns (B, H, N, d)."""
    if rh.shape[0] != rw.shape[0]:
        raise ValueError("B13 (window_rel_attention) takes square grids, not "
                         f"{(rh.shape[0], rw.shape[0])}")
    return _WindowRelAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), rh, rw,
                                     impl == "window_plain")


def window_rel_attention(q, k, v, rel_pos_h, rel_pos_w, hw, impl: str = "window"):
    """``iuvl_tpu`` ``window_rel_attention`` with its signature: q, k, v
    (B, H, N, d) with N = win^2, hw = (win, win), the stored (2 win - 1, d)
    tables. Differentiable (to the stored tables too)."""
    return window_attention(q, k, v, *rel_pos_tables(rel_pos_h, rel_pos_w, hw), impl)


def window_rel_attention_plain(q, k, v, rel_pos_h, rel_pos_w, hw):
    """:func:`window_rel_attention` through the plain version."""
    return window_rel_attention(q, k, v, rel_pos_h, rel_pos_w, hw, "window_plain")
