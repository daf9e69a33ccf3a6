"""Attention with decomposed relative-position bias (SAM ViT), plain math.

Counterpart of ``iuvl_tpu/ops/rel_pos_attention.py``. Scores are
``(q * d**-0.5) @ k^T`` plus a bias built from per-axis relative-position
tables indexed by the *unscaled* q, softmaxed in fp32.

Weights here are in PyTorch's ``nn.Linear`` layout, ``(out, in)``.
"""

from __future__ import annotations

import torch

from .common import linear, needs_grad
from .resize import resize_axis


def rel_pos_table(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """(q_size, k_size, head_dim) relative-position embeddings for a grid
    pair, linearly resizing the stored table when its length is not
    ``2 * max(q, k) - 1``. Mirrors ``iuvl_tpu`` ``rel_pos_table``."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    rel_pos = resize_axis(rel_pos, 0, max_rel_dist, "linear")
    # Indices built on the table's device: a host-to-device copy here would
    # synchronise the stream in every attention call.
    coords = lambda n: torch.arange(n, device=rel_pos.device, dtype=torch.float64)  # noqa: E731
    q_coords = coords(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = coords(k_size)[None, :] * max(q_size / k_size, 1.0)
    rel_coords = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel_coords.long()]


def rel_pos_tables(rel_pos_h, rel_pos_w, hw):
    """The stored tables expanded to ``(h, h, d)`` and ``(w, w, d)`` fp32."""
    h, w = hw
    return rel_pos_table(h, h, rel_pos_h.float()), rel_pos_table(w, w, rel_pos_w.float())


def rel_pos_features(q, rh, rw):
    """Per-query bias features from *unscaled* q (B, heads, h*w, d) and the
    expanded tables of :func:`rel_pos_tables`: ``relh (B, heads, N, h)`` and
    ``relw (B, heads, N, w)``, computed in fp32 and cast to q's dtype
    (``iuvl_tpu`` ``_rowbias_proj_route``)."""
    h, w = rh.shape[0], rw.shape[0]
    b, heads, n, d = q.shape
    r_q = q.float().reshape(b, heads, h, w, d)
    relh = torch.einsum("bnhwc,hkc->bnhwk", r_q, rh).reshape(b, heads, n, h)
    relw = torch.einsum("bnhwc,wkc->bnhwk", r_q, rw).reshape(b, heads, n, w)
    return relh.to(q.dtype).contiguous(), relw.to(q.dtype).contiguous()


def decomposed_rel_pos_bias(q, rh, rw):
    """(B, heads, N, N) decomposed bias from unscaled q (B, heads, N, d) and
    the expanded tables of :func:`rel_pos_tables`."""
    h, w = rh.shape[0], rw.shape[0]
    b, heads, n, d = q.shape
    r_q = q.reshape(b, heads, h, w, d)
    rel_h = torch.einsum("bnhwc,hkc->bnhwk", r_q, rh)
    rel_w = torch.einsum("bnhwc,wkc->bnhwk", r_q, rw)
    bias = rel_h[..., :, None] + rel_w[..., None, :]
    return bias.reshape(b, heads, n, n)


def rowbias_scores(q_scaled, k, relh, relw, w: int, eh=None, ew=None):
    """fp32 scores ``q_scaled @ k^T + bias``. Without expanders the bias is
    ``relh[., key // w] + relw[., key % w]`` (B2b's indexed bias); with
    expanders eh (h, N) and ew (w, N) it is ``relh @ eh + relw @ ew``
    (B14's), each product in fp32."""
    s = torch.matmul(q_scaled.float(), k.float().transpose(-1, -2))
    n_k = k.shape[-2]
    if eh is None:
        s = s + relh.float().repeat_interleave(w, dim=-1)[..., :n_k]
        return s + relw.float().repeat(1, 1, 1, n_k // w)
    return s + relh.float() @ eh.float() + relw.float() @ ew.float()


def rowbias_attention(q_scaled, k, v, relh, relw, w: int, eh=None, ew=None,
                      return_lse: bool = False):
    """softmax(:func:`rowbias_scores`) @ v with the scores and softmax in
    fp32 and the probabilities cast to v's dtype. q_scaled is pre-scaled;
    relh/relw come from :func:`rel_pos_features`. With ``return_lse`` also
    the per-row logsumexp of the scores (fp32), as the flash kernels keep
    it for their backward."""
    s = rowbias_scores(q_scaled, k, relh, relw, w, eh, ew)
    out = torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v)
    return (out, torch.logsumexp(s, dim=-1)) if return_lse else out


def rowbias_supported(n: int, d: int, hw, block_k: int = 1024) -> bool:
    """Whether the row-bias kernels take a global block of n tokens on the
    grid hw with head dim d: the port's copy of ``iuvl_tpu``
    ``rowbias_supported`` (``ops/pallas/flash_attention.py``), which picks
    the serving route of ``impl='auto'`` (B2 where it holds, the augmented
    route through B11 otherwise)."""
    h, w = hw
    block_k = min(block_k, max(128, 1 << (n - 1).bit_length()))
    return (n == h * w and d + w <= 128 and block_k % w == 0
            and n % block_k == 0 and n % min(2048, n) == 0)


def onehot_expanders(hw, dtype, device):
    """B14's expanders for the (h, w) grid: eh (h, N) with eh[a, j] =
    1[j // w == a] and ew (w, N) with ew[a, j] = 1[j % w == a], made on
    ``device`` in ``dtype`` (JAX's ``impl='pallas_rp'`` route)."""
    h, w = hw
    col = torch.arange(h * w, device=device)
    eh = (torch.arange(h, device=device)[:, None] == col[None] // w).to(dtype)
    ew = (torch.arange(w, device=device)[:, None] == col[None] % w).to(dtype)
    return eh, ew


KERNEL_IMPLS = ("rowbias", "pallas_rp")  # impls whose attention is one kernel, B2b or B14
# B13 and its plain version (the card's reference for 'window': B13 rounds
# where no other route does, see ops/cuda/window_attention.py).
WINDOW_IMPLS = ("window", "window_plain")


def _attention(q, k, v, rh, rw, impl: str):
    """Rel-pos attention on the expanded tables rh (h, h, d), rw (w, w, d).
    ``'rowbias'``: B2b (JAX's ``_rowbias_route``); ``'pallas_rp'``: B14 on
    the one-hot expanders (JAX's ``impl='pallas_rp'``); ``'window'``: B13
    (JAX's ``window_rel_attention``, square grids), ``'window_plain'`` its
    plain version; ``'pallas'``: the augmented q, k through B11 (JAX's
    ``impl='pallas'``); each differentiable, its kernels on CUDA tensors and
    its plain versions on CPU ones. ``'xla_naive'``: the materialised-bias
    oracle. ``'auto'`` and ``'plain'``: the plain math, bias features
    rounded to the working dtype (JAX's augmented route, ``impl='xla'``)."""
    from .cuda import flash_attention as fa  # it imports this module

    if impl == "xla_naive":
        return naive_attention(q, k, v, rh, rw)
    if impl in WINDOW_IMPLS:
        from .cuda.window_attention import window_attention

        return window_attention(q, k, v, rh, rw, impl)
    if impl == "pallas":
        return fa.flash_attention(*augment_qk_rel_pos(q, k, rh, rw), v)
    relh, relw = rel_pos_features(q, rh, rw)
    hw = (rh.shape[0], rw.shape[0])
    qs = q * (q.shape[-1] ** -0.5)
    if impl not in KERNEL_IMPLS:
        return rowbias_attention(qs, k, v, relh, relw, hw[1])

    if impl == "rowbias":
        return fa.flash_attention_rowbias(qs, k, v, relh, relw, hw[1])
    return fa.flash_attention_relpos(qs, k, v, relh, relw,
                                     *onehot_expanders(hw, q.dtype, q.device))


def rel_pos_attention(q, k, v, rel_pos_h, rel_pos_w, hw, impl: str = "plain"):
    """Rel-pos attention over an (h, w) grid, (B, heads, N, d) -> same,
    through ``impl`` (see :func:`_attention`). The bias features are
    rounded to the working dtype before they join the fp32 scores, as in
    every JAX route."""
    return _attention(q, k, v, *rel_pos_tables(rel_pos_h, rel_pos_w, hw), impl)


def naive_attention(q, k, v, rh, rw):
    """Materialised-bias oracle (``iuvl_tpu`` ``_rel_pos_attention_naive``,
    JAX's ``impl='xla_naive'``) on the expanded fp32 tables: the bias in
    fp32, unrounded, added to the fp32 scores of the pre-scaled q."""
    scale = q.shape[-1] ** -0.5
    attn = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    attn = attn + decomposed_rel_pos_bias(q.float(), rh, rw)
    attn = torch.softmax(attn, dim=-1).to(v.dtype)
    return torch.matmul(attn, v)


def rel_pos_attention_naive(q, k, v, rel_pos_h, rel_pos_w, hw):
    """:func:`naive_attention` from the stored tables."""
    return naive_attention(q, k, v, *rel_pos_tables(rel_pos_h, rel_pos_w, hw))


def augment_qk_rel_pos(q, k, rh, rw):
    """Fold the decomposed rel-pos bias into the q.k contraction
    (``iuvl_tpu`` ``augment_qk_rel_pos``): ``q_aug = [q * d**-0.5, relh,
    relw]`` and ``k_aug = [k, onehot(key row), onehot(key column)]``, so
    that ``q_aug . k_aug`` is the scaled score plus the bias and plain
    softmax attention on them is rel-pos attention. q, k (B, heads, N, d)
    with N = h * w; rh, rw from :func:`rel_pos_tables`. Returns
    (q_aug, k_aug), (B, heads, N, d + h + w) in q's dtype."""
    h, w = rh.shape[0], rw.shape[0]
    b, heads, n, d = q.shape
    relh, relw = rel_pos_features(q, rh, rw)
    eye = lambda size: torch.eye(size, dtype=q.dtype, device=q.device)  # noqa: E731
    onehot = torch.cat([eye(h).repeat_interleave(w, dim=0), eye(w).repeat(h, 1)], dim=-1)
    k_aug = torch.cat([k, onehot.expand(b, heads, n, h + w)], dim=-1)
    q_aug = torch.cat([q * d ** -0.5, relh, relw], dim=-1)
    return q_aug, k_aug


def rel_pos_attention_proj(q, k, v, rh, rw, wo, bo, impl: str = "auto"):
    """Rel-pos attention with the output projection: ``(B, N, heads*d) @
    wo^T + bo`` in token-major (B, N, C) layout; rh, rw from
    :func:`rel_pos_tables`; wo, bo rounded to q's dtype where used.

    Under ``impl`` 'rowbias', 'pallas_rp', 'window' (and 'window_plain'),
    'pallas' or 'xla_naive' every block takes JAX's ``_attn_then_proj``:
    :func:`_attention`, the relayout and the projection, autograd taking
    the backward.

    Under 'auto' (the kernels) and 'plain' (their plain versions) the route
    depends on differentiation, as the JAX grad switch does
    (``_global_attention_proj_gradswitch``), and on the shape, as JAX's
    ``rowbias_supported`` decides:

    - not recorded by autograd (serving), where :func:`rowbias_supported`
      holds: the relh/relw features come from the unscaled q, and attention
      runs on the pre-scaled q through ``flash_attention_rowbias_proj``
      (B2); wo in q's dtype, bo fp32;
    - recorded (training, :func:`~iuvl_tpu_torch.ops.common.needs_grad`),
      or serving where B2 does not take the shape (ViT-H's head dim 80, a
      grid that is no multiple of 1024 tokens): :func:`augment_qk_rel_pos`,
      then ``flash_attention`` (B11 forward and backward), the relayout and
      the projection as plain PyTorch, whose backward autograd takes."""
    from .cuda import flash_attention as fa  # it imports this module

    if impl not in ("auto", "plain"):
        out = _attention(q, k, v, rh, rw, impl)
        b, heads, n, d = out.shape
        return linear(out.transpose(1, 2).reshape(b, n, heads * d), wo, bo, q.dtype)
    hw = (rh.shape[0], rw.shape[0])
    if needs_grad(q, k, v, rh, rw, wo, bo) or not rowbias_supported(q.shape[2], q.shape[3], hw):
        q_aug, k_aug = augment_qk_rel_pos(q, k, rh, rw)
        out = fa.flash_attention(q_aug, k_aug, v, impl=impl)
        b, heads, n, d = out.shape
        return linear(out.transpose(1, 2).reshape(b, n, heads * d), wo, bo, q.dtype)
    relh, relw = rel_pos_features(q, rh, rw)
    fn = fa.flash_attention_rowbias_proj if impl == "auto" else fa.rowbias_proj_plain
    return fn(q * (q.shape[-1] ** -0.5), k, v, relh, relw, wo, bo, rw.shape[0])
