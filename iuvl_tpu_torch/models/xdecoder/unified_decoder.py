"""Unified latent/text-query transformer decoder, PyTorch port of
``iuvl_tpu/models/xdecoder/unified_decoder.py``.

9 layers (3 feature levels x 3 rounds) of masked cross-attention over the
pixel decoder's maps, block-masked self-attention over [100 object queries
+ 1 class query] and an FFN; after the initial queries and after every
layer the prediction heads give class logits (similarity to the text
embeddings), mask logits (``mask_embed . mask_features``) and the caption
embeddings. The next layer's cross-attention bias comes from the mask
logits: bicubic-resized with ``jax.image.resize``'s kernel
(``ops/resize.py``), ``sigmoid < 0.5`` disallowed, fully masked rows
unmasked. Rounding points follow the flax modules' ``dtype=`` casts:
Dense in the working dtype, scores, softmax, norms and heads in fp32;
where JAX adds a working-dtype tensor to an fp32 one, the sum is fp32 here
too (PyTorch promotes as JAX does).

Tasks:

- ``'seg'``: the latent queries alone.
- ``'interactive'``: SAM's prompt decode: ``sam_queries`` (the mask-token
  hypernetwork vectors) through ``sam_query_proj`` join as prompt slots
  after the latent queries (which cannot see them; they see everything),
  and ``sam_features`` (SAM's upscaled embedding) through ``sam_feat_proj``
  are added to the mask features; the prompt slots' mask logits are
  ``pred_interactive_masks``.
- ``'seg_grounding'`` / ``'grounding_eval'``: the 100 object queries are
  duplicated after the class query, and ``grounding_tokens`` (B, G, C)
  join the self-attention of every layer (split off again after its FFN),
  their content cut from the gradient, their positions not (as in JAX);
  padded tokens (``grounding_valid`` False) are masked as keys. The heads
  read [obj; cls; dup]; row ``num_queries`` (the first duplicate) attends
  to the whole memory (the reference's quirk).
- ``'vlp'``: ``caption_tokens`` (B, contxt_len, C) are appended as a causal
  block that the queries cannot see, their positions plus
  ``pos_embed_caping``; ``pred_captionings`` is their rows through the
  decoder norm and ``caping_embed``.
- ``'llm'`` / ``'vqa'``: ``caption_tokens`` (B, contxt_len, C), the
  question's token embeddings, are appended as a block whose rows attend
  to each other freely (the queries keep the base mask and cannot see
  them; they cannot see the queries), their content cut from the
  gradient, their positions the tokens themselves; ``image_feature`` is
  the object queries' rows through the decoder norm, the LLM projector's
  input.

The cached captioning decode (``captioning_prefill``,
``init_caption_cache``, ``caption_decode_step``) uses that the query rows
never read the caption rows: they run once, each layer's projected
self-attention keys and values (and the projected memory of its
cross-attention) are kept, and each caption token is one row through the
9 layers against them.
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
GROUNDING_TASKS = ("seg_grounding", "grounding_eval")
LLM_TASKS = ("llm", "vqa")
TASKS = ("seg", "interactive", "vlp") + GROUNDING_TASKS + LLM_TASKS


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
    scores and softmax in fp32. ``project_kv`` and ``attend`` are its two
    halves, for keys and values projected once and attended many times."""

    def __init__(self, d_model: int, nhead: int, dtype: torch.dtype):
        super().__init__()
        self.nhead, self.dtype = nhead, dtype
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def project_kv(self, k, v):
        """The projected (B, N, C) keys and values."""
        return _dense(k, self.k_proj, self.dtype), _dense(v, self.v_proj, self.dtype)

    def attend(self, q, kp, vp, bias=None):
        """Attention of ``q`` over already projected keys and values."""
        dt, b, nq, c = self.dtype, q.shape[0], q.shape[1], q.shape[2]
        hd = c // self.nhead

        def split(t):
            return t.reshape(b, t.shape[1], self.nhead, hd).transpose(1, 2)

        qs, ks, vs = split(_dense(q, self.q_proj, dt)), split(kp), split(vp)
        attn = (qs.float() @ ks.float().transpose(-1, -2)) / (hd ** 0.5)
        if bias is not None:
            attn = attn + bias
        out = torch.softmax(attn, dim=-1).to(vs.dtype) @ vs
        return _dense(out.transpose(1, 2).reshape(b, nq, c), self.out_proj, dt)

    def forward(self, q, k, v, bias=None):
        return self.attend(q, *self.project_kv(k, v), bias)


class DecoderLayer(nn.Module):
    """Masked cross-attention -> (grounding tokens appended) ->
    self-attention -> FFN, post-norm."""

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

    def _ffn(self, tgt):
        y = _dense(F.relu(_dense(tgt, self.ffn_lin1, self.dtype)), self.ffn_lin2, self.dtype)
        return _ln(tgt + y, self.ffn_norm)

    def forward(self, tgt, memory, query_pos, mem_pos, cross_bias, self_bias, grounding=None,
                grounding_pos=None, collect_kv: bool = False):
        """-> (tgt, the grounding rows after this layer, or with
        ``collect_kv`` the (self k, self v, memory k, memory v) projections
        that :meth:`caption_step` reads, else None)."""
        mem_kv = self.cross_attn.project_kv(memory + mem_pos, memory)
        tgt = _ln(tgt + self.cross_attn.attend(tgt + query_pos, *mem_kv, cross_bias),
                  self.cross_norm)
        n_ground = 0
        if grounding is not None:
            n_ground = grounding.shape[1]
            tgt = torch.cat([tgt, grounding], dim=1)
            query_pos = torch.cat([query_pos, grounding_pos], dim=1)
        q = tgt + query_pos
        kv = self.self_attn.project_kv(q, tgt)
        tgt = self._ffn(_ln(tgt + self.self_attn.attend(q, *kv, self_bias), self.self_norm))
        if n_ground:
            return tgt[:, :-n_ground], tgt[:, -n_ground:]
        return tgt, (*kv, *mem_kv) if collect_kv else None

    def caption_step(self, e, e_pos, q_kv, cap_k, cap_v, step_idx: int):
        """One caption row (B, 1, C) through this layer: its cross-attention
        unmasked over the memory projections and its self-attention over
        the query block's projections and the caption rows up to
        ``step_idx`` (``q_kv``: what ``forward(..., collect_kv=True)``
        returned). Its k and v are written into row ``step_idx`` of the
        (B, contxt_len, C) caches ``cap_k`` / ``cap_v``, later rows masked."""
        q_k, q_v, mem_k, mem_v = q_kv
        e = _ln(e + self.cross_attn.attend(e + e_pos, mem_k, mem_v), self.cross_norm)
        q_row = e + e_pos
        nk, nv = self.self_attn.project_kv(q_row, e)
        cap_k[:, step_idx] = nk[:, 0]
        cap_v[:, step_idx] = nv[:, 0]
        bias = torch.zeros(q_k.shape[1] + cap_k.shape[1], device=e.device)
        bias[q_k.shape[1] + step_idx + 1:] = NEG_INF
        y = self.self_attn.attend(q_row, torch.cat([q_k, cap_k], 1), torch.cat([q_v, cap_v], 1),
                                  bias)
        return self._ffn(_ln(e + y, self.self_norm))


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

    def _attn_bias_from_mask(self, outputs_mask, size, extra_rows: int = 0,
                             force_unmask_first_extra: bool = True):
        """(B, 1, Q + extra_rows, h*w) fp32 additive cross-attention bias
        from the mask logits (B, Q, H, W): bicubic resize, ``sigmoid < 0.5``
        disallowed, fully disallowed rows allowed again, ``extra_rows``
        allowed rows appended, and with ``force_unmask_first_extra`` row
        ``num_queries`` allowed where there is one."""
        h, w = size
        b, q = outputs_mask.shape[:2]
        mask = outputs_mask.detach().float()  # the bias is a step function: no gradient
        resized = resize_axis(resize_axis(mask, 2, h, "cubic"), 3, w, "cubic")
        disallow = (torch.sigmoid(resized) < 0.5).reshape(b, q, h * w)
        disallow = disallow & ~disallow.all(dim=-1, keepdim=True)
        if extra_rows:
            disallow = torch.cat([disallow, disallow.new_zeros(b, extra_rows, h * w)], dim=1)
        if disallow.shape[1] > self.num_queries and force_unmask_first_extra:
            disallow[:, self.num_queries] = False
        bias = torch.zeros(disallow.shape, dtype=torch.float32, device=disallow.device)
        return bias.masked_fill(disallow, NEG_INF)[:, None]

    def _prediction_heads(self, output, mask_features, text_embeddings, logit_scale,
                          task: str = "seg"):
        """The heads over [obj; cls] (the class query recomputed as the
        similarity-weighted mixture of the object queries), then the prompt
        slots (``'interactive'``) or the duplicated queries (grounding)
        after them as they are; the caption rows (``'vlp'``) go to
        ``outputs_captioning`` alone."""
        dec = _ln(output, self.decoder_norm)
        nq = self.num_queries
        outputs_captioning = dec[:, nq:] @ self.caping_embed if task == "vlp" else None
        norm_dec = dec / (torch.linalg.vector_norm(dec, dim=-1, keepdim=True) + 1e-7)
        obj, cls = norm_dec[:, : nq - 1], norm_dec[:, nq - 1: nq]
        sim = torch.softmax(torch.einsum("bic,bqc->bqi", obj, cls), dim=-1)[:, 0, :, None]
        cls_token = (sim * dec[:, : nq - 1]).sum(dim=1, keepdim=True)
        rest = dec[:, nq: 2 * nq - 1] if task in GROUNDING_TASKS else (
            dec[:, nq:] if task == "interactive" else dec[:, :0])
        dec = torch.cat([dec[:, : nq - 1], cls_token, rest], dim=1)
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
                "outputs_mask": outputs_mask, "outputs_captioning": outputs_captioning}

    def _queries(self, b: int):
        """The (B, num_queries, C) initial queries and their positions."""
        return (self.query_feat[None].expand(b, -1, -1).to(self.dtype),
                self.query_embed[None].expand(b, -1, -1).to(self.dtype))

    @staticmethod
    def _bias(disallowed: np.ndarray, device) -> torch.Tensor:
        """A (1, 1, N, N) fp32 additive bias, NEG_INF where disallowed."""
        m = torch.from_numpy(disallowed)
        return torch.zeros(m.shape).masked_fill(m, NEG_INF)[None, None].to(device)

    def forward(self, multi_scale: Sequence[torch.Tensor], mask_features: torch.Tensor,
                text_embeddings=None, task: str = "seg", logit_scale=None, sam_queries=None,
                sam_features=None, grounding_tokens=None, grounding_valid=None,
                caption_tokens=None, **unported):
        if task not in TASKS or unported:
            raise NotImplementedError(
                f"UnifiedDecoder task={task!r} ({sorted(unported)}) is not ported yet; the "
                f"port runs the tasks {TASKS} (ROADMAP.md lists the others)")
        assert len(multi_scale) == self.num_feature_levels
        srcs, poss, sizes = self._prepare_memory(multi_scale)
        b, nq, dt = srcs[0].shape[0], self.num_queries, self.dtype
        if sam_features is not None:  # the prompt-conditioned mask-feature modulation
            mask_features = mask_features + _dense(sam_features.to(dt), self.sam_feat_proj, dt)
        mask_features = mask_features.float()
        output, query_pos = self._queries(b)
        base = build_base_self_mask(nq, self.contxt_len)
        grounding = grounding_pos = None
        extra_rows = 0
        if task == "interactive":
            sq = _dense(sam_queries.to(dt), self.sam_query_proj, dt)
            total = nq + sq.shape[1]
            m = np.ones((total, total), dtype=bool)
            m[:nq, :nq] = base[:nq, :nq]
            m[nq:, :] = False  # prompt slots attend obj, cls and each other
            m[:nq, nq:] = True  # the latent queries are blind to them
            self_bias = self._bias(m, output.device)
            output = torch.cat([output, sq], dim=1)
            query_pos = torch.cat([query_pos, sq], dim=1)
        elif task in GROUNDING_TASKS:
            total = 2 * nq - 1 + grounding_tokens.shape[1]
            m = np.ones((total, total), dtype=bool)
            m[:nq, :nq] = base[:nq, :nq]
            m[nq:, nq:] = False  # the duplicates and the grounding tokens see each other
            self_bias = self._bias(m, output.device)
            if grounding_valid is not None:  # padded grounding tokens are no keys
                pad = torch.cat([torch.ones(b, 2 * nq - 1, dtype=torch.bool,
                                            device=grounding_valid.device),
                                 grounding_valid.bool()], dim=1)
                self_bias = self_bias + torch.zeros(pad.shape, device=pad.device).masked_fill(
                    ~pad, NEG_INF)[:, None, None]
            output = torch.cat([output, output[:, : nq - 1]], dim=1)
            query_pos = torch.cat([query_pos, query_pos[:, : nq - 1]], dim=1)
            # The content is cut from the gradient, the positions are not.
            grounding = grounding_tokens.detach().to(dt)
            grounding_pos = grounding_tokens.to(dt)
        elif task == "vlp":
            self_bias = self._bias(base, output.device)
            output = torch.cat([output, caption_tokens.detach().to(dt)], dim=1)
            ctx_pos = caption_tokens.to(dt) + self.pos_embed_caping[None]
            query_pos = torch.cat([query_pos.to(ctx_pos.dtype), ctx_pos], dim=1)
            extra_rows = self.contxt_len
        elif task in LLM_TASKS:
            total = nq + self.contxt_len
            m = np.ones((total, total), dtype=bool)
            m[:nq, :nq] = base[:nq, :nq]
            m[nq:, nq:] = False  # the context rows attend each other freely
            self_bias = self._bias(m, output.device)
            # The content is cut from the gradient, the positions are not.
            output = torch.cat([output, caption_tokens.detach().to(dt)], dim=1)
            query_pos = torch.cat([query_pos, caption_tokens.to(dt)], dim=1)
            extra_rows = self.contxt_len
        else:
            self_bias = self._bias(base[:nq, :nq], output.device)
        results = self._prediction_heads(output, mask_features, text_embeddings, logit_scale,
                                         task)
        predictions = [results]
        for i, layer in enumerate(self.layers):
            lvl = i % self.num_feature_levels
            # The prompt slots keep their own mask attention; row num_queries
            # is always allowed only for the grounding and caption blocks.
            cross_bias = self._attn_bias_from_mask(
                results["outputs_mask"], sizes[lvl], extra_rows=extra_rows,
                force_unmask_first_extra=task != "interactive")
            output, new_grounding = layer(output, srcs[lvl], query_pos, poss[lvl].to(dt),
                                          cross_bias, self_bias, grounding=grounding,
                                          grounding_pos=grounding_pos)
            if grounding is not None:
                grounding = new_grounding
            results = self._prediction_heads(output, mask_features, text_embeddings,
                                             logit_scale, task)
            predictions.append(results)
        out = {
            "pred_logits": predictions[-1]["outputs_class"],
            "pred_masks": predictions[-1]["outputs_mask"],
            "pred_captions": predictions[-1]["class_embed"],
            "aux_outputs": [{"pred_logits": p["outputs_class"], "pred_masks": p["outputs_mask"],
                             "pred_captions": p["class_embed"]} for p in predictions[:-1]],
        }
        if task == "vlp":
            out["pred_captionings"] = predictions[-1]["outputs_captioning"]
            out["aux_captionings"] = [p["outputs_captioning"] for p in predictions[:-1]]
        if task == "interactive":  # the prompt slots' masks
            out["pred_interactive_masks"] = predictions[-1]["outputs_mask"][:, nq:]
        if task in LLM_TASKS:  # the object queries' features for the LLM projector
            out["image_feature"] = _ln(output, self.decoder_norm)[:, : nq - 1]
        return out

    # -- the cached captioning decode ----------------------------------------
    def captioning_prefill(self, multi_scale, mask_features) -> list:
        """The query block through the 9 layers once (the seg task: the
        caption rows cannot change it, nor its mask-attention biases):
        each layer's projections that :meth:`caption_decode_step` reads."""
        srcs, poss, sizes = self._prepare_memory(multi_scale)
        mask_features = mask_features.float()
        output, query_pos = self._queries(srcs[0].shape[0])
        nq = self.num_queries
        self_bias = self._bias(build_base_self_mask(nq, self.contxt_len)[:nq, :nq],
                               output.device)
        results = self._prediction_heads(output, mask_features, None, None)
        q_kv = []
        for i, layer in enumerate(self.layers):
            lvl = i % self.num_feature_levels
            cross_bias = self._attn_bias_from_mask(results["outputs_mask"], sizes[lvl])
            output, kv = layer(output, srcs[lvl], query_pos, poss[lvl].to(self.dtype),
                               cross_bias, self_bias, collect_kv=True)
            q_kv.append(kv)
            if i + 1 < len(self.layers):  # the last heads feed no layer
                results = self._prediction_heads(output, mask_features, None, None)
        return q_kv

    def init_caption_cache(self, batch: int) -> list:
        """Zeroed (k, v) caption caches of every layer, each (B,
        contxt_len, C): the rows past the current step are masked, so the
        zeros are never read."""
        shape = (batch, self.contxt_len, self.hidden_dim)
        dev = self.query_feat.device
        return [(torch.zeros(shape, dtype=self.dtype, device=dev),
                 torch.zeros(shape, dtype=self.dtype, device=dev)) for _ in self.layers]

    def caption_decode_step(self, prefill: list, cap_caches: list, tok_emb_t: torch.Tensor,
                            step_idx: int):
        """The caption token at ``step_idx`` (its (B, 1, C) text-tower
        embedding) through the 9 layers against the prefill's projections
        and the caption caches (updated in place): (its captioning
        embedding (B, dim_proj) fp32, the caches), the row ``step_idx`` of
        the ``'vlp'`` task's ``pred_captionings``."""
        dt = self.dtype
        e = tok_emb_t.detach().to(dt)
        e_pos = tok_emb_t.to(dt) + self.pos_embed_caping[step_idx].to(dt)
        for layer, q_kv, (cap_k, cap_v) in zip(self.layers, prefill, cap_caches):
            e = layer.caption_step(e, e_pos, q_kv, cap_k, cap_v, step_idx)
        return (_ln(e, self.decoder_norm) @ self.caping_embed)[:, 0], cap_caches
