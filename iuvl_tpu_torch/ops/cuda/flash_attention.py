"""Flash attention for the SAM global blocks.

Replaces two functions of ``iuvl_tpu/ops/pallas/flash_attention.py``:

- ``flash_attention_rowbias_proj`` (B2, ``csrc/flash_attention.cu``):
  rel-pos attention with the output projection folded in, the serving
  route;
- ``flash_attention`` (B11, ``csrc/flash_attention_train.cu``): plain
  softmax attention on the rel-pos-augmented q, k with the per-row
  logsumexp, and its backward, the training route (see
  ``ops/rel_pos_attention.py``).

Each kernel's header says what bounds it on the card and how the TPU's
sequential grid became loops in a block.
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


D_QK, D_V = 192, 64


def flash_attention_fwd_plain(q, k, v):
    """softmax(q k^T) v and the per-row logsumexp, with the arithmetic of
    ``iuvl_tpu`` ``_flash_kernel_lse``: fp32 scores, the unnormalised
    probabilities rounded to v's dtype for the product, divided by the row
    sum in fp32. q, k (B, H, N, d_qk) with any softmax scale folded in; v
    (B, H, N, d_v). Returns (o in v's dtype, lse fp32 (B, H, N))."""
    s = q.float() @ k.float().transpose(-1, -2)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    l_ = e.sum(-1, keepdim=True)
    o = (e.to(v.dtype).float() @ v.float()) / l_
    return o.to(v.dtype), (m + torch.log(l_)).squeeze(-1)


def flash_attention_bwd_plain(q, k, v, o, lse, do):
    """The backward of :func:`flash_attention_fwd_plain` from the stored
    lse, with the arithmetic of ``iuvl_tpu`` ``_flash_backward``: p =
    exp(s - lse) fp32, delta = rowsum(do o), ds = p (do v^T - delta)
    rounded to q's dtype, dq = ds k, dk = ds^T q, dv = bf16(p)^T do.
    Returns (dq, dk, dv) in the inputs' dtypes."""
    dt = q.dtype
    p = torch.exp(q.float() @ k.float().transpose(-1, -2) - lse.unsqueeze(-1))
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    ds = (p * (do.float() @ v.float().transpose(-1, -2) - delta)).to(dt).float()
    dq = ds @ k.float()
    dk = ds.transpose(-1, -2) @ q.float()
    dv = p.to(v.dtype).float().transpose(-1, -2) @ do.float()
    return dq.to(dt), dk.to(dt), dv.to(v.dtype)


def _require_flash(kernel, q, k, v, extra=()):
    b, heads, n, d_qk = q.shape
    if d_qk != D_QK or v.shape[-1] != D_V or n % 64:
        raise ValueError(f"{kernel} kernel: unsupported d_qk={d_qk}, d_v={v.shape[-1]}, "
                         f"N={n} (needs d_qk 192, d_v 64, N % 64 == 0)")
    bf, dev = torch.bfloat16, q.device
    shapes = dict(q=(b, heads, n, D_QK), k=(b, heads, n, D_QK), v=(b, heads, n, D_V),
                  o=(b, heads, n, D_V), do=(b, heads, n, D_V), lse=(b, heads, n))
    for name, tensor in (("q", q), ("k", k), ("v", v), *extra):
        require(kernel, name, tensor, torch.float32 if name == "lse" else bf, shapes[name],
                dev)
    return b * heads, n


def flash_attention_fwd(q, k, v):
    """Flash attention forward with lse: the CUDA kernel for CUDA tensors
    (bf16, d_qk 192, d_v 64, N % 64 == 0), the plain version for CPU
    tensors. Arguments and results as :func:`flash_attention_fwd_plain`."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v)
    bh, n = _require_flash("flash_attention_fwd", q, k, v)
    o = torch.empty_like(v)
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    launch("iuvl_flash_fwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
           lse.data_ptr(), bh, n, D_QK, D_V)
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do):
    """Flash attention backward (delta, the dq pass and the dk/dv pass):
    the CUDA kernels for CUDA tensors, the plain version for CPU tensors.
    Arguments and results as :func:`flash_attention_bwd_plain`."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do)
    bh, n = _require_flash("flash_attention_bwd", q, k, v,
                           (("o", o), ("lse", lse), ("do", do)))
    delta = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    launch("iuvl_flash_bwd", q.device, *(t_.data_ptr() for t_ in (q, k, v, o, lse, do, delta,
                                                                  dq, dk, dv)),
           bh, n, D_QK, D_V)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, impl):
        ctx.impl = impl
        o, lse = (flash_attention_fwd if impl == "auto" else flash_attention_fwd_plain)(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = flash_attention_bwd if ctx.impl == "auto" else flash_attention_bwd_plain
        return (*bwd(q, k, v, o, lse, do.to(v.dtype).contiguous()), None)


def flash_attention(q, k, v, impl: str = "auto"):
    """Differentiable flash attention (softmax scale 1: fold it into q):
    the kernels B11 forward and backward (their plain versions under
    ``impl='plain'``, or on the CPU). q, k (B, H, N, d_qk), v (B, H, N, d_v),
    contiguous. Returns o (B, H, N, d_v)."""
    return _FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), impl)
