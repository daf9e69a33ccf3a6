"""CLIP-style text tower and language head, PyTorch port of
``iuvl_tpu/models/xdecoder/lang_encoder.py``.

A causal text transformer (token embedding + learned positional
embedding, residual blocks with a packed in-projection and a QuickGELU
MLP, TF-style fp32 LayerNorm with eps 1e-12 inside the sqrt), eot pooling
at the argmax of the ids, ``lang_proj`` to the syslearner width, and the
learnable ``logit_scale``. Rounding points follow the flax modules: Dense
layers in the working dtype, the attention scores and softmax in fp32
(the probabilities cast to v's dtype), the norms in fp32 cast back, the
projection in fp32 (flax promotes the bf16 hidden state against the fp32
``lang_proj``). Parameter names mirror the flax tree
(``models/xdecoder/convert.py``).

Besides the pooled embedding (``forward_language``), the tower gives every
token's projected embedding (``forward_language_token``: grounding and
captioning) and a KV-cached decode of one position at a time
(``init_text_cache`` / ``forward_token_step``: the cached captioning
loop), which gives row ``pos`` of the full forward: the tower is causal.
The caches are written in place. The JAX tower is autoregressive, so an
``attention_mask`` is taken where JAX takes one and never read.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ...ops.common import linear, take_rows


class TFLayerNorm(nn.Module):
    """fp32 LayerNorm, eps inside the sqrt; the result in x's dtype."""

    def __init__(self, dim: int, eps: float = 1e-12):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf - mean) ** 2).mean(-1, keepdim=True)
        y = (xf - mean) / torch.sqrt(var + self.eps)
        return (self.weight * y + self.bias).to(x.dtype)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, d_model: int, n_head: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_head, self.dtype = n_head, dtype
        self.ln_1 = TFLayerNorm(d_model)
        self.in_proj = nn.Linear(d_model, 3 * d_model)
        self.out_proj = nn.Linear(d_model, d_model)
        self.ln_2 = TFLayerNorm(d_model)
        self.c_fc = nn.Linear(d_model, 4 * d_model)
        self.c_proj = nn.Linear(4 * d_model, d_model)

    def _linear(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return linear(x, layer.weight, layer.bias, self.dtype)

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        b, n, c = t.shape
        return t.reshape(b, n, self.n_head, c // self.n_head).transpose(1, 2)

    def _attend(self, q, k, v, bias: torch.Tensor) -> torch.Tensor:
        """Heads of (B, N, C) q and (B, T, C) k, v; fp32 scores plus ``bias``
        and softmax, the probabilities in v's dtype; the out projection."""
        b, n, c = q.shape
        q, k, v = self._heads(q), self._heads(k), self._heads(v)
        scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(c // self.n_head) + bias
        attn = torch.softmax(scores, dim=-1).to(v.dtype)
        return self._linear(self.out_proj, (attn @ v).transpose(1, 2).reshape(b, n, c))

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        y = self._linear(self.c_fc, self.ln_2(x))
        y = y * torch.sigmoid(1.702 * y)  # QuickGELU
        return x + self._linear(self.c_proj, y)

    def forward(self, x: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
        q, k, v = self._linear(self.in_proj, self.ln_1(x)).chunk(3, dim=-1)
        return self._mlp(x + self._attend(q, k, v, causal))

    def step(self, x_row: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
             pos: int) -> torch.Tensor:
        """Row ``pos`` of :meth:`forward` from the (B, 1, C) block input at
        ``pos``: its k and v are written into row ``pos`` of the (B, T, C)
        caches, whose rows before ``pos`` hold the earlier positions', and
        the rows after it are masked to -inf, as the causal mask does."""
        q, k, v = self._linear(self.in_proj, self.ln_1(x_row)).chunk(3, dim=-1)
        k_cache[:, pos] = k[:, 0]
        v_cache[:, pos] = v[:, 0]
        t = k_cache.shape[1]
        future = torch.zeros(t, device=x_row.device)
        future[pos + 1:] = float("-inf")
        return self._mlp(x_row + self._attend(q, k_cache, v_cache, future))


class TextTransformer(nn.Module):
    def __init__(self, context_length: int = 77, vocab_size: int = 49408, width: int = 512,
                 layers: int = 12, heads: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.token_embedding = nn.Parameter(torch.zeros(vocab_size, width))
        self.positional_embedding = nn.Parameter(torch.zeros(context_length, width))
        self.blocks = nn.ModuleList(ResidualAttentionBlock(width, heads, dtype)
                                    for _ in range(layers))
        self.ln_final = TFLayerNorm(width)

    def token_table(self) -> torch.Tensor:
        """The raw token-embedding matrix (V, width)."""
        return self.token_embedding

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """(B, T) ids -> (B, T, width) in the working dtype. The tower is
        causal (the reference's autoregressive text encoder), so no padding
        mask is read. An id outside the vocabulary gives a row of NaN, as
        ``jnp.take`` does."""
        n = input_ids.shape[1]
        x = take_rows(self.token_embedding, input_ids) + self.positional_embedding[None, :n]
        x = x.to(self.dtype)
        causal = torch.full((n, n), float("-inf"), device=x.device).triu(1)
        for blk in self.blocks:
            x = blk(x, causal)
        return self.ln_final(x)

    def init_cache(self, batch: int) -> list:
        """Zeroed (k, v) caches of every block for :meth:`decode_step`,
        each (B, context_length, width) in the working dtype."""
        shape = (batch, *self.positional_embedding.shape)
        dev = self.positional_embedding.device
        return [(torch.zeros(shape, dtype=self.dtype, device=dev),
                 torch.zeros(shape, dtype=self.dtype, device=dev)) for _ in self.blocks]

    def decode_step(self, token_ids: torch.Tensor, pos: int, caches: list):
        """(B,) ids at position ``pos`` -> ((B, 1, width) row ``pos`` of
        :meth:`forward`, caches), the positions before ``pos`` read from
        the caches, which are updated in place."""
        x = take_rows(self.token_embedding, token_ids)[:, None] + self.positional_embedding[pos]
        x = x.to(self.dtype)
        for blk, (k_c, v_c) in zip(self.blocks, caches):
            x = blk.step(x, k_c, v_c, pos)
        return self.ln_final(x), caches


class LanguageEncoder(nn.Module):
    def __init__(self, width: int = 512, proj_dim: int = 512, layers: int = 12, heads: int = 8,
                 context_length: int = 77, vocab_size: int = 49408,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.lang_encoder = TextTransformer(context_length, vocab_size, width, layers, heads,
                                            dtype)
        self.lang_proj = nn.Parameter(torch.zeros(width, proj_dim))
        self.logit_scale = nn.Parameter(torch.ones(()))  # flax init: ones

    @staticmethod
    def _pool_eot(hidden: torch.Tensor, input_ids: torch.Tensor) -> torch.Tensor:
        """The hidden state at the eot token: the argmax of the ids (eot is
        the largest id of both tokenizers)."""
        eot = input_ids.argmax(dim=-1)
        return hidden[torch.arange(hidden.shape[0], device=hidden.device), eot]

    def forward_language(self, input_ids: torch.Tensor, attention_mask=None,
                         norm: bool = True) -> torch.Tensor:
        """(B, T) ids -> (B, proj_dim) fp32: the eot hidden state, projected,
        with ``norm`` scaled to unit length."""
        x = self._pool_eot(self.lang_encoder(input_ids), input_ids).float() @ self.lang_proj
        return _unit(x) if norm else x

    def forward_language_token(self, input_ids: torch.Tensor, attention_mask=None,
                               norm: bool = False):
        """(B, T) ids -> (token embeddings (B, T, proj_dim), class embedding
        (B, proj_dim)), fp32: every hidden state projected, and the eot one;
        with ``norm`` each scaled to unit length."""
        hidden = self.lang_encoder(input_ids)
        class_x = self._pool_eot(hidden, input_ids).float() @ self.lang_proj
        token_x = hidden.float() @ self.lang_proj
        return (_unit(token_x), _unit(class_x)) if norm else (token_x, class_x)

    def init_text_cache(self, batch: int) -> list:
        return self.lang_encoder.init_cache(batch)

    def forward_token_step(self, token_ids: torch.Tensor, pos: int, caches: list):
        """(B,) ids at ``pos`` -> ((B, 1, proj_dim) row ``pos`` of
        :meth:`forward_language_token`'s token embeddings, caches)."""
        hidden, caches = self.lang_encoder.decode_step(token_ids, pos, caches)
        return hidden.float() @ self.lang_proj, caches

    def compute_similarity(self, v_emb: torch.Tensor, text_emb: torch.Tensor) -> torch.Tensor:
        """exp(logit_scale) x the cosine similarity of (B, Q, D) visual
        embeddings to (K, D) unit text embeddings: (B, Q, K)."""
        return torch.exp(self.logit_scale) * torch.einsum("bqd,kd->bqk", _unit(v_emb), text_emb)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-7)
