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

Not ported yet: the KV-cached ``step`` / ``decode_step`` and
``forward_language_token`` (captioning and grounding).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ...ops.common import linear


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

    def _attention(self, x: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        hd = c // self.n_head
        q, k, v = (t.reshape(b, n, self.n_head, hd).transpose(1, 2)
                   for t in self._linear(self.in_proj, x).chunk(3, dim=-1))
        scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(hd) + causal
        attn = torch.softmax(scores, dim=-1).to(v.dtype)
        return self._linear(self.out_proj, (attn @ v).transpose(1, 2).reshape(b, n, c))

    def forward(self, x: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
        x = x + self._attention(self.ln_1(x), causal)
        y = self._linear(self.c_fc, self.ln_2(x))
        y = y * torch.sigmoid(1.702 * y)  # QuickGELU
        return x + self._linear(self.c_proj, y)


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
        mask is read."""
        n = input_ids.shape[1]
        x = (self.token_embedding[input_ids.long()] + self.positional_embedding[None, :n])
        x = x.to(self.dtype)
        causal = torch.full((n, n), float("-inf"), device=x.device).triu(1)
        for blk in self.blocks:
            x = blk(x, causal)
        return self.ln_final(x)


class LanguageEncoder(nn.Module):
    def __init__(self, width: int = 512, proj_dim: int = 512, layers: int = 12, heads: int = 8,
                 context_length: int = 77, vocab_size: int = 49408,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.lang_encoder = TextTransformer(context_length, vocab_size, width, layers, heads,
                                            dtype)
        self.lang_proj = nn.Parameter(torch.zeros(width, proj_dim))
        self.logit_scale = nn.Parameter(torch.ones(()))  # flax init: ones

    def forward_language(self, input_ids: torch.Tensor) -> torch.Tensor:
        """(B, T) ids -> (B, proj_dim) fp32 unit vectors: the hidden state at
        the eot token (the argmax of the ids: eot is the largest id of both
        tokenizers), projected, scaled to unit length."""
        hidden = self.lang_encoder(input_ids)
        eot = input_ids.argmax(dim=-1)
        x = hidden[torch.arange(hidden.shape[0], device=hidden.device), eot]
        x = x.float() @ self.lang_proj
        return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-7)
