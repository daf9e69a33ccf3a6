"""Unified latent/text-query transformer decoder, PyTorch port of
``iuvl_tpu/models/xdecoder/unified_decoder.py`` (its ``task='seg'`` and
``task='interactive'`` paths).

9 layers (3 feature levels x 3 rounds) of masked cross-attention over the
pixel decoder's maps, block-masked self-attention over [100 object queries
+ 1 class query] and an FFN; after the initial queries and after every
layer the prediction heads give class logits (similarity to the text
embeddings), mask logits (``mask_embed . mask_features``) and the caption
embeddings. The next layer's cross-attention bias comes from the mask
logits: bicubic-resized with ``jax.image.resize``'s kernel
(``ops/resize.py``), ``sigmoid < 0.5`` disallowed, fully masked rows
unmasked. Rounding points follow the flax modules' ``dtype=`` casts:
Dense in the working dtype, scores, softmax, norms and heads in fp32.

``task='interactive'`` takes SAM's prompt decode: ``sam_queries`` (the
mask-token hypernetwork vectors) through ``sam_query_proj`` join as prompt
slots after the latent queries (which cannot see them; they see everything),
and ``sam_features`` (SAM's upscaled embedding) through ``sam_feat_proj``
are added to the mask features; the prompt slots' mask logits are
``pred_interactive_masks``.

Captioning, grounding and the LLM tasks are not ported yet (ROADMAP.md);
their parameters (``caping_embed``, ``pos_embed_caping``) are kept so the
weight bridge covers the flax tree.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.common import layer_norm_f32, linear
from ...ops.position_embedding import position_embedding_sine
from ...ops.resize import resize_axis

NEG_INF = -1e9


def build_base_self_mask(num_queries: int, contxt_len: int) -> np.ndarray:
    """Static block mask, True = disallowed (reference xdecoder.py:148-154)."""
    n = num_queries + contxt_len
    m = np.zeros((n, n), dtype=bool)
    m[:num_queries, num_queries:] = True
    m[num_queries:, num_queries:] = np.triu(np.ones((contxt_len, contxt_len), dtype=bool), k=1)
    m[: num_queries - 1, num_queries - 1: num_queries] = True
    m[num_queries - 1: num_queries, : num_queries - 1] = True
    return m


def _ln(x, norm: nn.LayerNorm):
    return layer_norm_f32(x, norm.weight, norm.bias, norm.eps)


def _dense(x, layer: nn.Linear, dtype):
    return linear(x, layer.weight, layer.bias, dtype)


class MHA(nn.Module):
    """Multi-head attention with an additive fp32 bias (torch
    MultiheadAttention's math): q, k, v projections in the working dtype,
    scores and softmax in fp32."""

    def __init__(self, d_model: int, nhead: int, dtype: torch.dtype):
        super().__init__()
        self.nhead, self.dtype = nhead, dtype
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, q, k, v, bias=None):
        dt, b, nq, c = self.dtype, q.shape[0], q.shape[1], q.shape[2]
        hd = c // self.nhead

        def split(t):
            return t.reshape(b, t.shape[1], self.nhead, hd).transpose(1, 2)

        qs = split(_dense(q, self.q_proj, dt))
        ks = split(_dense(k, self.k_proj, dt))
        vs = split(_dense(v, self.v_proj, dt))
        attn = (qs.float() @ ks.float().transpose(-1, -2)) / (hd ** 0.5)
        if bias is not None:
            attn = attn + bias
        out = torch.softmax(attn, dim=-1).to(vs.dtype) @ vs
        return _dense(out.transpose(1, 2).reshape(b, nq, c), self.out_proj, dt)


class DecoderLayer(nn.Module):
    """Masked cross-attention -> self-attention -> FFN, post-norm."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.cross_attn = MHA(d_model, nhead, dtype)
        self.self_attn = MHA(d_model, nhead, dtype)
        self.cross_norm = nn.LayerNorm(d_model, eps=1e-5)
        self.self_norm = nn.LayerNorm(d_model, eps=1e-5)
        self.ffn_norm = nn.LayerNorm(d_model, eps=1e-5)
        self.ffn_lin1 = nn.Linear(d_model, dim_feedforward)
        self.ffn_lin2 = nn.Linear(dim_feedforward, d_model)

    def forward(self, tgt, memory, query_pos, mem_pos, cross_bias, self_bias):
        y = self.cross_attn(tgt + query_pos, memory + mem_pos, memory, cross_bias)
        tgt = _ln(tgt + y, self.cross_norm)
        q = tgt + query_pos
        tgt = _ln(tgt + self.self_attn(q, q, tgt, self_bias), self.self_norm)
        y = _dense(F.relu(_dense(tgt, self.ffn_lin1, self.dtype)), self.ffn_lin2, self.dtype)
        return _ln(tgt + y, self.ffn_norm)


class MLP3(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.lin0 = nn.Linear(dim, hidden)
        self.lin1 = nn.Linear(hidden, hidden)
        self.lin2 = nn.Linear(hidden, out)

    def forward(self, x):
        x = F.relu(_dense(x, self.lin0, self.dtype))
        x = F.relu(_dense(x, self.lin1, self.dtype))
        return _dense(x, self.lin2, self.dtype)


class UnifiedDecoder(nn.Module):
    def __init__(self, hidden_dim: int = 512, dim_proj: int = 512, num_queries: int = 101,
                 contxt_len: int = 77, nheads: int = 8, dim_feedforward: int = 2048,
                 mask_dim: int = 512, num_feature_levels: int = 3, num_rounds: int = 3,
                 sam_dim: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_dim, self.num_queries, self.contxt_len = hidden_dim, num_queries, contxt_len
        self.num_feature_levels, self.dtype = num_feature_levels, dtype
        self.query_feat = nn.Parameter(torch.zeros(num_queries, hidden_dim))
        self.query_embed = nn.Parameter(torch.zeros(num_queries, hidden_dim))
        self.level_embed = nn.Parameter(torch.zeros(num_feature_levels, hidden_dim))
        self.layers = nn.ModuleList(
            DecoderLayer(hidden_dim, nheads, dim_feedforward, dtype)
            for _ in range(num_feature_levels * num_rounds))
        self.decoder_norm = nn.LayerNorm(hidden_dim, eps=1e-5)
        self.mask_embed = MLP3(hidden_dim, hidden_dim, mask_dim, dtype)
        self.class_embed = nn.Parameter(torch.zeros(hidden_dim, dim_proj))
        self.caping_embed = nn.Parameter(torch.zeros(hidden_dim, dim_proj))
        self.pos_embed_caping = nn.Parameter(torch.zeros(contxt_len, hidden_dim))
        self.sam_query_proj = nn.Linear(sam_dim, hidden_dim)
        self.sam_feat_proj = nn.Linear(sam_dim, mask_dim)

    def _prepare_memory(self, multi_scale):
        """Level maps (NHWC) -> tokens + level embedding, sine PE, sizes."""
        srcs, poss, sizes = [], [], []
        for i, x in enumerate(multi_scale):
            b, h, w, c = x.shape
            sizes.append((h, w))
            pos = position_embedding_sine(h, w, self.hidden_dim // 2, device=x.device)
            poss.append(pos.reshape(1, h * w, c).expand(b, -1, -1))
            srcs.append(x.reshape(b, h * w, c) + self.level_embed[i][None, None])
        return srcs, poss, sizes

    def _attn_bias_from_mask(self, outputs_mask, size):
        """(B, 1, Q, h*w) fp32 additive cross-attention bias from the mask
        logits (B, Q, H, W): bicubic resize, ``sigmoid < 0.5`` disallowed,
        fully disallowed rows allowed again."""
        h, w = size
        b, q = outputs_mask.shape[:2]
        mask = outputs_mask.detach().float()  # the bias is a step function: no gradient
        resized = resize_axis(resize_axis(mask, 2, h, "cubic"), 3, w, "cubic")
        disallow = (torch.sigmoid(resized) < 0.5).reshape(b, q, h * w)
        disallow = disallow & ~disallow.all(dim=-1, keepdim=True)
        bias = torch.zeros(disallow.shape, dtype=torch.float32, device=disallow.device)
        return bias.masked_fill(disallow, NEG_INF)[:, None]

    def _prediction_heads(self, output, mask_features, text_embeddings, logit_scale):
        """The heads over [obj; cls] and, under the interactive task, the
        prompt slots after them (kept as they are)."""
        dec = _ln(output, self.decoder_norm)
        nq = self.num_queries
        norm_dec = dec / (torch.linalg.vector_norm(dec, dim=-1, keepdim=True) + 1e-7)
        obj, cls = norm_dec[:, : nq - 1], norm_dec[:, nq - 1: nq]
        sim = torch.softmax(torch.einsum("bic,bqc->bqi", obj, cls), dim=-1)[:, 0, :, None]
        cls_token = (sim * dec[:, : nq - 1]).sum(dim=1, keepdim=True)
        dec = torch.cat([dec[:, : nq - 1], cls_token, dec[:, nq:]], dim=1)
        class_embed = dec @ self.class_embed
        outputs_class = None
        if text_embeddings is not None:
            v = class_embed / (torch.linalg.vector_norm(class_embed, dim=-1, keepdim=True) + 1e-7)
            outputs_class = torch.einsum("bqd,kd->bqk", v, text_embeddings)
            if logit_scale is not None:
                outputs_class = torch.exp(logit_scale) * outputs_class
        # bf16 operands, fp32 sums (preferred_element_type=float32 in JAX):
        # mask_features comes upcast once per forward.
        outputs_mask = torch.einsum("bqc,bhwc->bqhw", self.mask_embed(dec).float(),
                                    mask_features)
        return {"class_embed": class_embed, "outputs_class": outputs_class,
                "outputs_mask": outputs_mask}

    def forward(self, multi_scale: Sequence[torch.Tensor], mask_features: torch.Tensor,
                text_embeddings=None, task: str = "seg", logit_scale=None, sam_queries=None,
                sam_features=None, **unported):
        if task not in ("seg", "interactive") or unported:
            raise NotImplementedError(
                f"UnifiedDecoder task={task!r} ({sorted(unported)}) is not ported yet; the "
                "port runs task='seg' and 'interactive' (ROADMAP.md lists the other tasks)")
        assert len(multi_scale) == self.num_feature_levels
        srcs, poss, sizes = self._prepare_memory(multi_scale)
        b, nq, dt = srcs[0].shape[0], self.num_queries, self.dtype
        if sam_features is not None:  # the prompt-conditioned mask-feature modulation
            mask_features = mask_features + _dense(sam_features.to(dt), self.sam_feat_proj, dt)
        mask_features = mask_features.float()
        output = self.query_feat[None].expand(b, -1, -1).to(dt)
        query_pos = self.query_embed[None].expand(b, -1, -1).to(dt)
        base = build_base_self_mask(nq, self.contxt_len)[:nq, :nq]
        if task == "interactive":
            sq = _dense(sam_queries.to(dt), self.sam_query_proj, dt)
            total = nq + sq.shape[1]
            m = np.ones((total, total), dtype=bool)
            m[:nq, :nq] = base
            m[nq:, :] = False  # prompt slots attend obj, cls and each other
            m[:nq, nq:] = True  # the latent queries are blind to them
            base = m
            output = torch.cat([output, sq], dim=1)
            query_pos = torch.cat([query_pos, sq], dim=1)
        base = torch.from_numpy(base)
        self_bias = torch.zeros(base.shape).masked_fill(base, NEG_INF)[None, None].to(
            output.device)
        results = self._prediction_heads(output, mask_features, text_embeddings, logit_scale)
        predictions = [results]
        for i, layer in enumerate(self.layers):
            lvl = i % self.num_feature_levels
            cross_bias = self._attn_bias_from_mask(results["outputs_mask"], sizes[lvl])
            output = layer(output, srcs[lvl], query_pos, poss[lvl].to(dt), cross_bias,
                           self_bias)
            results = self._prediction_heads(output, mask_features, text_embeddings,
                                             logit_scale)
            predictions.append(results)
        out = {
            "pred_logits": predictions[-1]["outputs_class"],
            "pred_masks": predictions[-1]["outputs_mask"],
            "pred_captions": predictions[-1]["class_embed"],
            "aux_outputs": [{"pred_logits": p["outputs_class"], "pred_masks": p["outputs_mask"],
                             "pred_captions": p["class_embed"]} for p in predictions[:-1]],
        }
        if task == "interactive":  # the prompt slots' masks
            out["pred_interactive_masks"] = predictions[-1]["outputs_mask"][:, nq:]
        return out
