"""Flash attention for the SAM ViT blocks.

Replaces four functions of ``iuvl_tpu/ops/pallas/flash_attention.py``:

- ``flash_attention_rowbias_proj`` (B2, ``csrc/flash_attention.cu``):
  rel-pos attention with the output projection folded in, the serving
  route of the global blocks where ``rowbias_supported`` holds;
- ``flash_attention`` (B11, ``csrc/flash_attention_train.cu``): plain
  softmax attention on the rel-pos-augmented q, k with the per-row
  logsumexp, and its backward, the training route and the serving route
  where B2 does not take the shape (see ``ops/rel_pos_attention.py``);
- ``flash_attention_rowbias`` (B2b) and ``flash_attention_relpos`` (B14),
  ``csrc/flash_attention_rowbias.cu``: rel-pos attention with the bias
  inside the kernel (indexed, or through expander matrices), forward with
  lse and a two-pass backward (dk/dv, then dq with the bias cotangents;
  no atomics); every block's attention under ``attn_impl='rowbias'`` /
  ``'pallas_rp'``.

Each kernel's header says what bounds it on the card and how the TPU's
sequential grid became loops in a block.
"""

from __future__ import annotations

import torch

from ..rel_pos_attention import rowbias_attention, rowbias_scores
from .build import launch, require

HEAD_DIMS = (64, 80)  # the SAM heads: ViT-B/L 64, ViT-H 80


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
    """Row-bias flash attention + output projection: the CUDA kernels for
    CUDA tensors (bf16, head dim 64 or 80, w a power of two dividing N: any
    grid that ``rowbias_supported`` admits; C % 8 == 0), the plain version
    for CPU tensors."""
    if q.device.type == "cpu":
        return rowbias_proj_plain(q, k, v, relh, relw, wo, bo, w)
    b, heads, n, d = q.shape
    c_out = wo.shape[0]
    if d not in HEAD_DIMS or n % w or w & (w - 1) or c_out % 8:
        raise ValueError(
            f"flash_attention_rowbias_proj kernel: unsupported d={d}, w={w}, N={n}, "
            f"C={c_out} (needs d 64 or 80, w a power of two dividing N, C % 8 == 0)")
    bf, f32, dev = torch.bfloat16, torch.float32, q.device
    args = dict(q=q, k=k, v=v, relh=relh, relw=relw, wo=wo, bo=bo)
    shapes = dict(q=(b, heads, n, d), k=(b, heads, n, d), v=(b, heads, n, d),
                  relh=(b, heads, n, n // w), relw=(b, heads, n, w),
                  wo=(c_out, heads * d), bo=(c_out,))
    for name, tensor in args.items():
        require("flash_attention_rowbias_proj", name, tensor,
                f32 if name == "bo" else bf, shapes[name], dev)
    out = torch.empty((b, n, c_out), dtype=bf, device=dev)
    # The head outputs (and their lse, unused) from the attention kernel,
    # which the projection kernel reads.
    o_scratch = torch.empty((b, heads, n, d), dtype=bf, device=dev)
    lse_scratch = torch.empty((b, heads, n), dtype=f32, device=dev)
    launch("iuvl_rowbias_proj", dev, *(t_.data_ptr() for t_ in args.values()),
           out.data_ptr(), o_scratch.data_ptr(), lse_scratch.data_ptr(), b, heads, n, c_out, d,
           w)
    flash_attention_rowbias_proj.launches += 1
    return out


flash_attention_rowbias_proj.launches = 0


# B11's instantiated widths: d_qk is zero-padded to the next of DQK_PAD
# (the padded columns add nothing to q k^T), d_v is the head dim.
DQK_PAD, D_VS = (128, 160, 192, 224, 256), (64, 80)


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
    """Check B11's operands; returns (B*H, N, d_qk padded)."""
    b, heads, n, d_qk = q.shape
    d_v = v.shape[-1]
    pad = next((p for p in DQK_PAD if p >= d_qk), None)
    if pad is None or d_v not in D_VS:
        raise ValueError(f"{kernel} kernel: unsupported d_qk={d_qk}, d_v={d_v} (needs d_qk "
                         f"<= {DQK_PAD[-1]}, d_v in {D_VS})")
    bf, dev = torch.bfloat16, q.device
    shapes = dict(q=(b, heads, n, d_qk), k=(b, heads, n, d_qk), v=(b, heads, n, d_v),
                  o=(b, heads, n, d_v), do=(b, heads, n, d_v), lse=(b, heads, n))
    for name, tensor in (("q", q), ("k", k), ("v", v), *extra):
        require(kernel, name, tensor, torch.float32 if name == "lse" else bf, shapes[name],
                dev)
    return b * heads, n, pad


def _pad_last(x, width):
    return x if x.shape[-1] == width else torch.nn.functional.pad(
        x, (0, width - x.shape[-1])).contiguous()


def flash_attention_fwd(q, k, v):
    """Flash attention forward with lse: the CUDA kernel for CUDA tensors
    (bf16, d_qk <= 256, d_v 64 or 80, any N: the last tile is masked), the
    plain version for CPU tensors. Arguments and results as
    :func:`flash_attention_fwd_plain`."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v)
    bh, n, pad = _require_flash("flash_attention_fwd", q, k, v)
    q, k = _pad_last(q, pad), _pad_last(k, pad)
    o = torch.empty_like(v)
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    launch("iuvl_flash_fwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
           lse.data_ptr(), bh, n, pad, v.shape[-1])
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do):
    """Flash attention backward (delta, the dq pass and the dk/dv pass):
    the CUDA kernels for CUDA tensors, the plain version for CPU tensors.
    Arguments and results as :func:`flash_attention_bwd_plain`."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do)
    bh, n, pad = _require_flash("flash_attention_bwd", q, k, v,
                                (("o", o), ("lse", lse), ("do", do)))
    d_qk = q.shape[-1]
    q, k = _pad_last(q, pad), _pad_last(k, pad)
    delta = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    launch("iuvl_flash_bwd", q.device, *(t_.data_ptr() for t_ in (q, k, v, o, lse, do, delta,
                                                                  dq, dk, dv)),
           bh, n, pad, v.shape[-1])
    flash_attention_bwd.launches += 1
    return dq[..., :d_qk], dk[..., :d_qk], dv


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


def flash_rowbias_fwd_plain(q, k, v, relh, relw, w: int, eh=None, ew=None):
    """Plain version of B2b's forward (and, given the expanders eh (h, N)
    and ew (w, N), of B14's): :func:`rowbias_attention` with its lse,
    the scores and softmax in fp32 and the probabilities rounded to v's
    dtype. q pre-scaled, (B, H, N, d); relh (B, H, N, h), relw (B, H, N,
    w). Returns (o in v's dtype, lse fp32 (B, H, N))."""
    return rowbias_attention(q, k, v, relh, relw, w, eh, ew, return_lse=True)


def flash_rowbias_bwd_plain(q, k, v, relh, relw, o, lse, do, w: int, eh=None, ew=None):
    """Plain version of B2b's backward (B14's with eh, ew), the arithmetic
    of ``iuvl_tpu`` ``_flash_rb_backward`` / ``_flash_rp_backward``: p =
    exp(s - lse) in fp32, ds = p (do v^T - rowsum(do o)) rounded to q's
    dtype, dq = ds k, dk = ds^T q, dv = bf16(p)^T do; the bias cotangents
    ds [eh | ew]^T (without expanders: ds summed over each key row, and
    over each key column) accumulated in fp32 and cast to relh's dtype.
    Returns (dq, dk, dv, drelh, drelw)."""
    dt = q.dtype
    p = torch.exp(rowbias_scores(q, k, relh, relw, w, eh, ew) - lse.unsqueeze(-1))
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    ds = (p * (do.float() @ v.float().transpose(-1, -2) - delta)).to(dt).float()
    dq = ds @ k.float()
    dk = ds.transpose(-1, -2) @ q.float()
    dv = p.to(v.dtype).float().transpose(-1, -2) @ do.float()
    if eh is None:
        grid = ds.reshape(*ds.shape[:-1], -1, w)  # (..., key row, key column)
        drelh, drelw = grid.sum(-1), grid.sum(-2)
    else:
        drelh, drelw = ds @ eh.float().t(), ds @ ew.float().t()
    return dq.to(dt), dk.to(dt), dv.to(v.dtype), drelh.to(relh.dtype), drelw.to(relw.dtype)


def _require_rowbias(kernel, q, k, v, relh, relw, eh=None, ew=None, extra=()):
    b, heads, n, d = q.shape
    h, w = relh.shape[-1], relw.shape[-1]
    if d not in HEAD_DIMS or (eh is None and h * w != n) or h + w > 496:
        raise ValueError(f"{kernel} kernel: unsupported d={d}, h={h}, w={w}, N={n} (needs "
                         f"d in {HEAD_DIMS}, h + w <= 496 and, without expanders, N == h w)")
    shapes = dict(q=(b, heads, n, d), k=(b, heads, n, d), v=(b, heads, n, d),
                  relh=(b, heads, n, h), relw=(b, heads, n, w), eh=(h, n), ew=(w, n),
                  o=(b, heads, n, d), do=(b, heads, n, d), lse=(b, heads, n))
    named = (("q", q), ("k", k), ("v", v), ("relh", relh), ("relw", relw), *extra)
    if eh is not None:
        named += (("eh", eh), ("ew", ew))
    for name, tensor in named:
        require(kernel, name, tensor, torch.float32 if name == "lse" else torch.bfloat16,
                shapes[name], q.device)
    return b * heads, n, d, h, w


def flash_rowbias_fwd(q, k, v, relh, relw, w: int):
    """B2b's forward: the CUDA kernel for CUDA tensors (bf16, head dim 64
    or 80, any N = h w), the plain version for CPU tensors. Arguments and
    results as :func:`flash_rowbias_fwd_plain`."""
    if q.device.type == "cpu":
        return flash_rowbias_fwd_plain(q, k, v, relh, relw, w)
    bh, n, d, h, w_ = _require_rowbias("flash_rowbias_fwd", q, k, v, relh, relw)
    o, lse = torch.empty_like(v), torch.empty(q.shape[:-1], dtype=torch.float32,
                                              device=q.device)
    launch("iuvl_rowbias_fwd", q.device, *(t_.data_ptr() for t_ in (q, k, v, relh, relw, o, lse)),
           bh, n, d, h, w_)
    flash_rowbias_fwd.launches += 1
    return o, lse


flash_rowbias_fwd.launches = 0


def expander_groups_plain(eh, ew):
    """Plain version of :func:`expander_groups`: int32 (ceil(N / 64),), bit
    g of word t set where rows 16 g .. 16 g + 15 of [eh ; ew] hold a
    non-zero value among keys 64 t .. 64 t + 63."""
    e = torch.cat([eh, ew]) != 0
    n, rows = e.shape[-1], -(-e.shape[0] // 16) * 16
    e = torch.nn.functional.pad(e, (0, -n % 64, 0, rows - e.shape[0]))
    used = e.reshape(rows // 16, 16, -1, 64).any(-1).any(1)  # (groups, tiles)
    weights = 2 ** torch.arange(rows // 16, dtype=torch.int64, device=e.device)
    return (used.long() * weights[:, None]).sum(0).to(torch.int32)


def expander_groups(eh, ew):
    """B14's expander groups in use, as its forward and backward kernels
    read them: ``iuvl_relpos_groups`` for CUDA tensors (eh (h, N), ew (w,
    N) bf16, h + w <= 496), :func:`expander_groups_plain` for CPU tensors."""
    if eh.device.type == "cpu":
        return expander_groups_plain(eh, ew)
    (h, n), w = eh.shape, ew.shape[0]
    if h + w > 496:
        raise ValueError(f"expander_groups: h + w = {h + w} over 496")
    for name, e, rows in (("eh", eh, h), ("ew", ew, w)):
        require("expander_groups", name, e, torch.bfloat16, (rows, n), eh.device)
    nz = torch.empty(((n + 63) // 64,), dtype=torch.int32, device=eh.device)
    launch("iuvl_relpos_groups", eh.device, eh.data_ptr(), ew.data_ptr(), nz.data_ptr(), n, h, w)
    return nz


def flash_relpos_fwd(q, k, v, relh, relw, eh, ew, nz=None):
    """B14's forward: the CUDA kernel for CUDA tensors (bf16, head dim 64
    or 80, any N, eh (h, N) and ew (w, N) bf16 with h + w <= 496), the
    plain version for CPU tensors. ``nz``: :func:`expander_groups` of eh,
    ew (computed here when not given). Results as
    :func:`flash_rowbias_fwd_plain`."""
    if q.device.type == "cpu":
        return flash_rowbias_fwd_plain(q, k, v, relh, relw, relw.shape[-1], eh, ew)
    bh, n, d, h, w = _require_rowbias("flash_relpos_fwd", q, k, v, relh, relw, eh, ew)
    o, lse = torch.empty_like(v), torch.empty(q.shape[:-1], dtype=torch.float32,
                                              device=q.device)
    nz = expander_groups(eh, ew) if nz is None else nz
    require("flash_relpos_fwd", "nz", nz, torch.int32, ((n + 63) // 64,), q.device)
    launch("iuvl_relpos_fwd", q.device,
           *(t_.data_ptr() for t_ in (q, k, v, relh, relw, eh, ew, nz, o, lse)), bh, n, d, h, w)
    flash_relpos_fwd.launches += 1
    return o, lse


flash_relpos_fwd.launches = 0


def _rowbias_bwd(name, q, k, v, relh, relw, o, lse, do, eh=None, ew=None, nz=None):
    bh, n, d, h, w = _require_rowbias(name, q, k, v, relh, relw, eh, ew,
                                      (("o", o), ("lse", lse), ("do", do)))
    dev = q.device
    # Scratch: delta; for B2b the one-hot expanders its dq pass multiplies
    # by (where w != 64) and their groups in use, a word a 64-key tile
    # (B14: its expanders' groups, nz).
    scratch = (torch.empty(lse.shape, dtype=torch.float32, device=dev),)
    if eh is None:
        scratch += (torch.empty((h + w, n), dtype=torch.bfloat16, device=dev),
                    torch.empty(((n + 63) // 64,), dtype=torch.int32, device=dev))
    else:
        nz = expander_groups(eh, ew) if nz is None else nz
        require(name, "nz", nz, torch.int32, ((n + 63) // 64,), dev)
        scratch += (nz,)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    drelh, drelw = torch.empty_like(relh), torch.empty_like(relw)
    ins = (q, k, v, relh, relw) + ((eh, ew) if eh is not None else ()) + (o, lse, do)
    launch("iuvl_relpos_bwd" if eh is not None else "iuvl_rowbias_bwd", dev,
           *(t_.data_ptr() for t_ in ins + scratch + (dq, drelh, drelw, dk, dv)),
           bh, n, d, h, w)
    return dq, dk, dv, drelh, drelw


def flash_rowbias_bwd(q, k, v, relh, relw, o, lse, do, w: int):
    """B2b's backward (a dk/dv pass and a dq pass, no atomics; dq and the
    bias cotangents summed in fp32 and rounded once): the CUDA kernels for
    CUDA tensors, the plain version for CPU tensors. Arguments and results
    as :func:`flash_rowbias_bwd_plain`."""
    if q.device.type == "cpu":
        return flash_rowbias_bwd_plain(q, k, v, relh, relw, o, lse, do, w)
    out = _rowbias_bwd("flash_rowbias_bwd", q, k, v, relh, relw, o, lse, do)
    flash_rowbias_bwd.launches += 1
    return out


flash_rowbias_bwd.launches = 0


def flash_relpos_bwd(q, k, v, relh, relw, eh, ew, o, lse, do, nz=None):
    """B14's backward: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. ``nz`` as for :func:`flash_relpos_fwd`. Results as
    :func:`flash_rowbias_bwd_plain`."""
    if q.device.type == "cpu":
        return flash_rowbias_bwd_plain(q, k, v, relh, relw, o, lse, do, relw.shape[-1], eh, ew)
    out = _rowbias_bwd("flash_relpos_bwd", q, k, v, relh, relw, o, lse, do, eh, ew, nz)
    flash_relpos_bwd.launches += 1
    return out


flash_relpos_bwd.launches = 0


class _RowbiasAttention(torch.autograd.Function):
    """B2b (``eh is None``) or B14 forward with lse, and its backward; the
    expanders get no cotangent, as JAX gives them zeros."""

    @staticmethod
    def forward(ctx, q, k, v, relh, relw, eh, ew, w):
        nz = None
        if eh is None:
            o, lse = flash_rowbias_fwd(q, k, v, relh, relw, w)
        else:  # the expander groups once, for the forward and the backward
            nz = expander_groups(eh, ew)
            o, lse = flash_relpos_fwd(q, k, v, relh, relw, eh, ew, nz)
        ctx.w = w
        ctx.save_for_backward(q, k, v, relh, relw, eh, ew, o, lse, nz)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, relh, relw, eh, ew, o, lse, nz = ctx.saved_tensors
        do = do.to(v.dtype).contiguous()
        if eh is None:
            grads = flash_rowbias_bwd(q, k, v, relh, relw, o, lse, do, ctx.w)
        else:
            grads = flash_relpos_bwd(q, k, v, relh, relw, eh, ew, o, lse, do, nz)
        return (*grads, None, None, None)


def flash_attention_rowbias(q_scaled, k, v, relh, relw, w: int):
    """Differentiable row-bias flash attention (B2b, its plain versions on
    the CPU): softmax(q_scaled k^T + relh[., key // w] + relw[., key % w]) v.
    q_scaled (B, H, N, d) pre-scaled; relh (B, H, N, N / w), relw (B, H,
    N, w) from ``rel_pos_features``. Returns (B, H, N, d)."""
    return _RowbiasAttention.apply(q_scaled.contiguous(), k.contiguous(), v.contiguous(),
                                   relh.contiguous(), relw.contiguous(), None, None, w)


def flash_attention_relpos(q_scaled, k, v, relh, relw, eh, ew):
    """Differentiable flash attention with the bias relh eh + relw ew (B14,
    its plain versions on the CPU); eh (h, N) and ew (w, N) in q's dtype,
    no gradient. Returns (B, H, N, d)."""
    return _RowbiasAttention.apply(q_scaled.contiguous(), k.contiguous(), v.contiguous(),
                                   relh.contiguous(), relw.contiguous(), eh.contiguous(),
                                   ew.contiguous(), relw.shape[-1])
