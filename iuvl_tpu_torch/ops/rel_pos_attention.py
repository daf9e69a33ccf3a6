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


def decomposed_rel_pos_bias(q, rel_pos_h, rel_pos_w, hw):
    """(B, heads, N, N) decomposed bias from unscaled q (B, heads, N, d)."""
    h, w = hw
    b, heads, n, d = q.shape
    rh = rel_pos_table(h, h, rel_pos_h)
    rw = rel_pos_table(w, w, rel_pos_w)
    r_q = q.reshape(b, heads, h, w, d)
    rel_h = torch.einsum("bnhwc,hkc->bnhwk", r_q, rh)
    rel_w = torch.einsum("bnhwc,wkc->bnhwk", r_q, rw)
    bias = rel_h[..., :, None] + rel_w[..., None, :]
    return bias.reshape(b, heads, n, n)


def rowbias_attention(q_scaled, k, v, relh, relw, w: int):
    """softmax(q_scaled @ k^T + relh[., k // w] + relw[., k % w]) @ v with the
    scores and softmax in fp32 and the probabilities cast to v's dtype.
    q_scaled is pre-scaled; relh/relw come from :func:`rel_pos_features`."""
    s = torch.matmul(q_scaled.float(), k.float().transpose(-1, -2))
    n_k = k.shape[-2]
    s = s + relh.float().repeat_interleave(w, dim=-1)[..., :n_k]
    s = s + relw.float().repeat(1, 1, 1, n_k // w)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p, v)


def rel_pos_attention(q, k, v, rel_pos_h, rel_pos_w, hw):
    """Rel-pos attention over an (h, w) grid, (B, heads, N, d) -> same.
    The bias features are rounded to the working dtype before they join
    the fp32 scores, as in the JAX augmented route (``impl='xla'``)."""
    relh, relw = rel_pos_features(q, *rel_pos_tables(rel_pos_h, rel_pos_w, hw))
    return rowbias_attention(q * (q.shape[-1] ** -0.5), k, v, relh, relw, hw[1])


def rel_pos_attention_naive(q, k, v, rel_pos_h, rel_pos_w, hw):
    """Materialised-bias oracle (``iuvl_tpu`` ``_rel_pos_attention_naive``)."""
    scale = q.shape[-1] ** -0.5
    attn = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    attn = attn + decomposed_rel_pos_bias(
        q.float(), rel_pos_h.float(), rel_pos_w.float(), hw)
    attn = torch.softmax(attn, dim=-1).to(v.dtype)
    return torch.matmul(attn, v)


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
    """Global-block attention with the output projection folded in:
    ``(B, N, heads*d) @ wo^T + bo`` in token-major (B, N, C) layout; rh, rw
    from :func:`rel_pos_tables`; wo, bo rounded to q's dtype where used.

    The route depends on differentiation, as the JAX grad switch does
    (``_global_attention_proj_gradswitch``):

    - not recorded by autograd (serving): the relh/relw features come from
      the unscaled q, and attention runs on the pre-scaled q through
      ``flash_attention_rowbias_proj`` (B2: the CUDA kernel for CUDA tensors
      under ``impl='auto'``, its plain version on the CPU or under
      ``impl='plain'``); wo in q's dtype, bo fp32;
    - recorded (training, :func:`~iuvl_tpu_torch.ops.common.needs_grad`):
      :func:`augment_qk_rel_pos`, then ``flash_attention`` (B11 forward and
      backward, or their plain versions), the relayout and the projection
      as plain PyTorch, whose backward autograd takes."""
    from .cuda import flash_attention as fa  # it imports this module

    if needs_grad(q, k, v, rh, rw, wo, bo):
        q_aug, k_aug = augment_qk_rel_pos(q, k, rh, rw)
        out = fa.flash_attention(q_aug, k_aug, v, impl=impl)
        b, heads, n, d = out.shape
        return linear(out.transpose(1, 2).reshape(b, n, heads * d), wo, bo, q.dtype)
    relh, relw = rel_pos_features(q, rh, rw)
    fn = fa.flash_attention_rowbias_proj if impl == "auto" else fa.rowbias_proj_plain
    return fn(q * (q.shape[-1] ** -0.5), k, v, relh, relw, wo, bo, rw.shape[0])
