"""Whole windowed-attention module body (qkv projection + rel-pos attention
+ output projection) for SAM's windowed ViT blocks, and its backward.

Replaces ``iuvl_tpu/ops/pallas/window_block.py``: the forward
``window_attention_block`` (B1, ``csrc/window_block.cu``) and the backward
``_block_backward`` (B9, ``csrc/window_block_bwd.cu``). Each kernel's
header says what bounds it on the card and how its design answers that.
:func:`window_attention_block_train` ties the two together as an autograd
function, as ``jax.custom_vjp`` does in the JAX package.
"""

from __future__ import annotations

import torch

from ..rel_pos_attention import rel_pos_features, rowbias_attention
from .build import colsum_scratch, launch, require, split_k

WIN, HEAD_DIMS = 14, (64, 80)  # ViT-B/L heads of 64, ViT-H of 80
TABLE_SPLITS = 16  # csrc/window_block_bwd.cu kTableSplits


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
    (bf16, win 14, head_dim 64 or 80, C % 128 == 0), the plain version for
    CPU tensors. Arguments as :func:`window_attention_block_plain`."""
    if xw.device.type == "cpu":
        return window_attention_block_plain(xw, wqkv, bqkv, wo, bo, rh, rw, heads)
    nw, n, c = xw.shape
    win, d = rh.shape[0], c // heads
    if win != WIN or c != heads * d or d not in HEAD_DIMS or c % 128 or n != win * win:
        raise ValueError(
            f"window_attention_block kernel: unsupported win={win}, C={c}, "
            f"heads={heads}, N={n} (needs win 14, head_dim 64 or 80, C % 128 == 0)")
    bf, f32, dev = torch.bfloat16, torch.float32, xw.device
    args = dict(xw=xw, wqkv=wqkv, bqkv=bqkv, wo=wo, bo=bo, rh=rh, rw=rw)
    shapes = dict(xw=(nw, n, c), wqkv=(3 * c, c), bqkv=(3 * c,), wo=(c, c),
                  bo=(c,), rh=(win, win, d), rw=(win, win, d))
    for name, tensor in args.items():
        dtype = bf if name in ("xw", "wqkv", "wo") else f32
        require("window_attention_block", name, tensor, dtype, shapes[name], dev)
    # q, k, v of each (window, head) contiguous; the head outputs token-major.
    qkv_scratch = torch.empty((nw, 3, heads, n, d), dtype=bf, device=dev)
    o_scratch = torch.empty((nw, n, c), dtype=bf, device=dev)
    out = torch.empty_like(xw)
    launch("iuvl_window_block", dev, *(t_.data_ptr() for t_ in args.values()),
           qkv_scratch.data_ptr(), o_scratch.data_ptr(), out.data_ptr(),
           nw, c, win, d)
    window_attention_block.launches += 1
    return out


window_attention_block.launches = 0


def window_block_backward_plain(xw, g, wqkv, bqkv, wo, rh, rw, heads: int):
    """Plain version of the backward, the arithmetic of ``iuvl_tpu``
    ``_block_bwd_kernel`` on the forward's rounding points: recompute qkv,
    the probabilities and the head outputs, then the cotangents. Arguments
    as :func:`window_attention_block_plain` plus g, the output cotangent
    in xw's dtype. Returns (dx, dwqkv, dbqkv, dwo, dbo, drh, drw): dx in
    xw's dtype (through bf16 dqkv), every other gradient fp32, weights in
    ``nn.Linear`` layout."""
    nw, n, c = xw.shape
    dt, win, d = xw.dtype, rh.shape[0], c // heads
    scale = d ** -0.5
    qkv = (xw @ wqkv.t() + bqkv.to(dt)).reshape(nw, n, 3, heads, d)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)  # (nW, heads, n, d)
    relh, relw = rel_pos_features(q, rh, rw)
    s = (q * scale).float() @ k.float().transpose(-1, -2)
    s = s + relh.float().repeat_interleave(win, dim=-1) + relw.float().repeat(1, 1, 1, win)
    p = torch.softmax(s, dim=-1)
    pb = p.to(dt).float()
    o = (pb @ v.float()).to(dt).transpose(1, 2).reshape(nw * n, c)
    g2 = g.reshape(nw * n, c).float()
    dbo = g2.sum(0)
    dwo = g2.t() @ o.float()
    do = (g @ wo).reshape(nw, n, heads, d).transpose(1, 2).float()
    dp = do @ v.float().transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dsb = ds.to(dt).float()
    dv = pb.transpose(-1, -2) @ do
    dk = (dsb.transpose(-1, -2) @ q.float()) * scale
    grid = (nw, heads, win, win, win)  # (..., query row, query column, key row/column)
    ds5 = ds.reshape(nw, heads, n, win, win)
    drelh = ds5.sum(-1).to(dt).float().reshape(grid)  # summed over a key row
    drelw = ds5.sum(-2).to(dt).float().reshape(grid)  # summed over a key column
    dq_rel = (torch.einsum("bnhwk,hkc->bnhwc", drelh, rh)
              + torch.einsum("bnhwk,wkc->bnhwc", drelw, rw)).reshape(nw, heads, n, d)
    dq = (dsb @ k.float()) * scale + dq_rel
    q5 = q.float().reshape(nw, heads, win, win, d)
    drh = torch.einsum("bnhwk,bnhwc->hkc", drelh, q5)
    drw = torch.einsum("bnhwk,bnhwc->wkc", drelw, q5)
    dqkv = torch.stack([dq, dk, dv]).to(dt)  # (3, nW, heads, n, d)
    dqkv = dqkv.permute(1, 3, 0, 2, 4).reshape(nw * n, 3 * c)
    dbqkv = dqkv.float().sum(0)
    dwqkv = dqkv.float().t() @ xw.reshape(nw * n, c).float()
    dx = (dqkv @ wqkv).reshape(nw, n, c)
    return dx, dwqkv, dbqkv, dwo, dbo, drh, drw


def window_block_backward(xw, g, wqkv, bqkv, wo, rh, rw, heads: int):
    """Backward of :func:`window_attention_block`: the CUDA kernel for CUDA
    tensors (the forward kernel's shapes), the plain version for CPU
    tensors. Arguments and results as :func:`window_block_backward_plain`."""
    if xw.device.type == "cpu":
        return window_block_backward_plain(xw, g, wqkv, bqkv, wo, rh, rw, heads)
    nw, n, c = xw.shape
    win, d = rh.shape[0], c // heads
    if win != WIN or c != heads * d or d not in HEAD_DIMS or c % 128 or n != win * win:
        raise ValueError(
            f"window_block_backward kernel: unsupported win={win}, C={c}, "
            f"heads={heads}, N={n} (needs win 14, head_dim 64 or 80, C % 128 == 0)")
    bf, f32, dev = torch.bfloat16, torch.float32, xw.device
    args = dict(xw=xw, g=g, wqkv=wqkv, bqkv=bqkv, wo=wo, rh=rh, rw=rw)
    shapes = dict(xw=(nw, n, c), g=(nw, n, c), wqkv=(3 * c, c), bqkv=(3 * c,), wo=(c, c),
                  rh=(win, win, d), rw=(win, win, d))
    for name, tensor in args.items():
        dtype = bf if name in ("xw", "g", "wqkv", "wo") else f32
        require("window_block_backward", name, tensor, dtype, shapes[name], dev)
    t = nw * n
    empty = lambda *s, dtype=bf: torch.empty(s, dtype=dtype, device=dev)  # noqa: E731
    # Scratch: qkv and do head-major, the head outputs and dqkv token-major,
    # the compact drelh | drelw rows, the table gradients' 16 split partials
    # and the column sums' chunks.
    scratch = (empty(nw, 3, heads, n, d), empty(nw, heads, n, d), empty(t, c), empty(t, 3 * c),
               empty(nw * heads, n, 2 * win),
               empty(TABLE_SPLITS * 2 * n * d + colsum_scratch(t, 3 * c, 2), dtype=f32))
    dx = torch.empty_like(xw)
    grads = (empty(3 * c, c, dtype=f32), empty(3 * c, dtype=f32), empty(c, c, dtype=f32),
             empty(c, dtype=f32), empty(2, win, win, d, dtype=f32))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    launch("iuvl_window_block_bwd", dev, *(t_.data_ptr() for t_ in args.values()),
           *(t_.data_ptr() for t_ in scratch), dx.data_ptr(),
           *(t_.data_ptr() for t_ in grads), nw, c, win, d, split_k(3 * c, c, t, sms),
           split_k(c, c, t, sms))
    window_block_backward.launches += 1
    dwqkv, dbqkv, dwo, dbo, drhw = grads
    return dx, dwqkv, dbqkv, dwo, dbo, drhw[0], drhw[1]


window_block_backward.launches = 0


class _WindowBlock(torch.autograd.Function):
    """B1 forward, B9 backward (or both plain versions). Takes the fp32
    parameters and casts them as the kernels take them, so that the weight
    gradients come back in fp32, as the JAX custom VJP returns them."""

    @staticmethod
    def forward(ctx, xw, wqkv, bqkv, wo, bo, rh, rw, heads, impl):
        ctx.heads, ctx.impl = heads, impl
        ctx.save_for_backward(xw, wqkv, bqkv, wo, rh, rw)
        dt = xw.dtype
        fwd = window_attention_block if impl == "auto" else window_attention_block_plain
        return fwd(xw, wqkv.to(dt), bqkv.float(), wo.to(dt), bo.float(), rh, rw, heads)

    @staticmethod
    def backward(ctx, g):
        xw, wqkv, bqkv, wo, rh, rw = ctx.saved_tensors
        dt = xw.dtype
        bwd = window_block_backward if ctx.impl == "auto" else window_block_backward_plain
        dx, dwqkv, dbqkv, dwo, dbo, drh, drw = bwd(
            xw, g.to(dt).contiguous(), wqkv.to(dt), bqkv.float(), wo.to(dt), rh, rw, ctx.heads)
        return dx, dwqkv, dbqkv, dwo, dbo, drh, drw, None, None


def window_attention_block_train(xw, wqkv, bqkv, wo, bo, rh, rw, heads: int,
                                 impl: str = "auto"):
    """Differentiable windowed attention body for training: the kernels B1
    and B9 (their plain versions under ``impl='plain'``, or on the CPU).
    Parameters are the fp32 ``nn.Linear`` weights and biases; rh, rw the
    expanded tables, made inside the graph so that their gradient reaches
    ``rel_pos_h/w`` through PyTorch's own backward of the expansion."""
    return _WindowBlock.apply(xw, wqkv, bqkv, wo, bo, rh, rw, heads, impl)
