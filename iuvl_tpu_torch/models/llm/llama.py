"""LLaMA / Vicuna decoder, PyTorch port of ``iuvl_tpu/models/llm/llama.py``.

The frozen language model of the LLaVA-style stage: RMSNorm, rotary
position embeddings, a SwiGLU MLP, grouped-query causal attention and a
fixed-size KV cache for decoding. Parameter names are the HF / reference
state-dict names (``model.layers.{i}.self_attn.q_proj.weight``, ...), the
ones ``iuvl_tpu/models/llm/convert.py`` reads, so a real checkpoint loads
with ``load_state_dict``. Linear weights keep PyTorch's (out, in) layout.

Rounding points are JAX's:

- RoPE in fp32 (frequencies from an fp32 ``arange(0, d, 2) / d``; the two
  halves of each head rotated, not interleaved pairs), cast back;
- RMSNorm in fp32 with an fp32 weight, whatever ``param_dtype`` is;
- the projections in ``dtype`` (flax ``nn.Dense(dtype=...)``); the int8
  projections dequantise ``weight.to(dtype) * scale.to(dtype)``, rounded in
  ``dtype``, before the product;
- attention scores in fp32 (exact products of the ``dtype`` operands),
  divided by sqrt(head_dim), the additive -1e9 masks, softmax in fp32,
  cast to the value dtype before p v;
- the LM head on ``dtype`` operands with fp32 logits.

Grouped-query attention repeats each kv head ``heads // kv_heads`` times
in a row (``jnp.repeat``: ``repeat_interleave``). The cache holds each
layer's rotated keys and values, (B, max_seq_len, kv_heads, head_dim) in
``dtype``, as JAX's does; a step attends over the slots up to its offset
only, since JAX's mask gives every later slot a weight of exactly zero.

Default config: Vicuna-7B v1.5 (LLaMA-2 7B shapes). ``llama_param_shardings``
(tensor parallelism over a mesh) is not ported.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.common import linear, prepared, take_rows
from ..sam.build import target_device

NEG_INF = -1e9
PROJECTIONS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    layers: int = 32
    heads: int = 32
    kv_heads: int = 32
    ffn_dim: int = 11008
    max_seq_len: int = 1024
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: str = "bfloat16"
    param_dtype: str = "float32"  # the weights' storage dtype (norms stay fp32)
    quant: str = "none"  # "int8": weight-only per-output-channel int8 projections

    def __post_init__(self):
        if self.quant not in ("none", "int8"):
            raise ValueError(f"LlamaConfig.quant={self.quant!r}: 'none' or 'int8'")
        if self.heads % self.kv_heads or self.dim % self.heads:
            raise ValueError("LlamaConfig: heads must divide dim, kv_heads must divide heads")

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads


def rope_tables(positions: torch.Tensor, d: int, theta: float):
    """(B, T) positions -> fp32 (cos, sin), each (B, T, 1, d / 2)."""
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=positions.device) / d))
    angles = positions[..., None].float() * freqs  # (B, T, D/2)
    return torch.cos(angles)[:, :, None], torch.sin(angles)[:, :, None]


def apply_rope(x: torch.Tensor, tables) -> torch.Tensor:
    """x (B, T, H, D) rotated by :func:`rope_tables`' (cos, sin): the two
    halves of D, in fp32, cast back to x's dtype."""
    cos, sin = tables
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def rotary_embed(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, T, H, D), positions (B, T) -> RoPE (JAX's ``rotary_embed``)."""
    return apply_rope(x, rope_tables(positions, x.shape[-1], theta))


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        norm = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + self.eps)
        return (norm * self.weight).to(x.dtype)


class Linear(nn.Module):
    """Bias-free projection: ``weight`` (out, in) in ``param_dtype``, the
    product in ``dtype`` (flax ``nn.Dense(use_bias=False, dtype=...)``)."""

    def __init__(self, in_f: int, out_f: int, dtype: torch.dtype, param_dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_f, in_f, dtype=param_dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, None, self.dtype)


class QuantLinear(nn.Module):
    """Weight-only int8 projection (JAX's ``QuantDense``): ``weight`` (out,
    in) int8 and ``weight_scale`` (out,) fp32, the absmax / 127 of each
    output channel. The weight is dequantised in ``dtype`` (its rounding
    point), then multiplied; plain PyTorch."""

    def __init__(self, in_f: int, out_f: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("weight", torch.zeros(out_f, in_f, dtype=torch.int8, device=device))
        self.register_buffer("weight_scale", torch.ones(out_f, dtype=torch.float32,
                                                        device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(self.dtype) * self.weight_scale.to(self.dtype)[:, None]
        return F.linear(x.to(self.dtype), w)


def _proj(cfg: LlamaConfig, in_f: int, out_f: int, device) -> nn.Module:
    dtype = getattr(torch, cfg.dtype)
    if cfg.quant == "int8":
        return QuantLinear(in_f, out_f, dtype, device)
    return Linear(in_f, out_f, dtype, getattr(torch, cfg.param_dtype), device)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
              rep: int) -> torch.Tensor:
    """q (B, T, H, hd), k / v (B, S, KVH, hd), an additive fp32 mask
    broadcastable to (B, H, T, S) -> (B, T, H * hd) in v's dtype."""
    b, t, _, hd = q.shape
    if rep > 1:
        k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
    scores = (q.transpose(1, 2).float() @ k.permute(0, 2, 3, 1).float()) / (hd ** 0.5)
    p = torch.softmax(scores + mask, dim=-1).to(v.dtype)
    return (p @ v.transpose(1, 2)).transpose(1, 2).reshape(b, t, -1)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        self.q_proj = _proj(cfg, cfg.dim, cfg.heads * hd, device)
        self.k_proj = _proj(cfg, cfg.dim, cfg.kv_heads * hd, device)
        self.v_proj = _proj(cfg, cfg.dim, cfg.kv_heads * hd, device)
        self.o_proj = _proj(cfg, cfg.heads * hd, cfg.dim, device)

    def forward(self, x, rope, mask, cache=None, offset: int = 0):
        """``rope``: :func:`rope_tables` of the positions. ``cache`` (k, v),
        each (B, max_seq_len, kv_heads, hd): this call's keys and values
        are written at ``offset`` (clamped so that they fit, as
        ``dynamic_update_slice`` clamps), and the attention reads the first
        ``mask.shape[-1]`` slots."""
        c = self.cfg
        b, t, _ = x.shape
        q = apply_rope(self.q_proj(x).view(b, t, c.heads, c.head_dim), rope)
        k = apply_rope(self.k_proj(x).view(b, t, c.kv_heads, c.head_dim), rope)
        v = self.v_proj(x).view(b, t, c.kv_heads, c.head_dim)
        if cache is not None:
            k_cache, v_cache = cache
            start = min(max(offset, 0), k_cache.shape[1] - t)
            k_cache[:, start: start + t] = k
            v_cache[:, start: start + t] = v
            n = mask.shape[-1]
            k, v = k_cache[:, :n], v_cache[:, :n]
        return self.o_proj(attention(q, k, v, mask, c.heads // c.kv_heads))


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.gate_proj = _proj(cfg, cfg.dim, cfg.ffn_dim, device)
        self.up_proj = _proj(cfg, cfg.dim, cfg.ffn_dim, device)
        self.down_proj = _proj(cfg, cfg.ffn_dim, cfg.dim, device)

    def forward(self, h):
        return self.down_proj(F.silu(self.gate_proj(h)) * self.up_proj(h))


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.dim, cfg.rms_eps, device)
        self.self_attn = LlamaAttention(cfg, device)
        self.post_attention_layernorm = RMSNorm(cfg.dim, cfg.rms_eps, device)
        self.mlp = LlamaMLP(cfg, device)

    def forward(self, x, rope, mask, cache=None, offset: int = 0):
        x = x + self.self_attn(self.input_layernorm(x), rope, mask, cache, offset)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.dim, device=device,
                                         dtype=getattr(torch, cfg.param_dtype))
        self.layers = nn.ModuleList(LlamaBlock(cfg, device) for _ in range(cfg.layers))
        self.norm = RMSNorm(cfg.dim, cfg.rms_eps, device)


class LlamaForCausalLM(nn.Module):
    """``embed``, the full-sequence ``forward``, and the cached decode:
    ``init_cache``, ``prefill`` and ``decode_step``."""

    def __init__(self, cfg: LlamaConfig = LlamaConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        self.model = LlamaModel(cfg, device)
        self.lm_head = nn.Linear(cfg.dim, cfg.vocab_size, bias=False, device=device,
                                 dtype=getattr(torch, cfg.param_dtype))

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        """(B, T) ids -> (B, T, dim) in ``dtype``, ``jnp.take``'s semantics:
        a negative id counts from the end of the table, and an id outside
        it gives a row of NaN (no device assert)."""
        return take_rows(self.model.embed_tokens.weight, input_ids).to(self.dtype)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """The final norm's output (..., dim) -> fp32 logits: the head on
        ``dtype`` operands, summed in fp32 (the products of two bf16
        values are exact in fp32; the fp32 copy of the head is made once
        per weight state)."""
        head = self.lm_head.weight
        w = prepared(self, f"lm_head_{x.dtype}", lambda: head.to(x.dtype).float(), head)
        return x.float() @ w.t()

    def _run(self, x, positions, mask, caches=None, offset: int = 0):
        rope = rope_tables(positions, self.cfg.head_dim, self.cfg.rope_theta)
        for i, blk in enumerate(self.model.layers):
            x = blk(x, rope, mask, None if caches is None else caches[i], offset)
        return self.model.norm(x)

    def forward(self, inputs_embeds: torch.Tensor, attention_mask=None,
                positions=None) -> torch.Tensor:
        """Full-sequence forward: (B, T, dim) embeddings, (B, T) 1 = valid ->
        (B, T, V) fp32 logits; causal, padded keys masked."""
        b, t, _ = inputs_embeds.shape
        dev = inputs_embeds.device
        if positions is None:
            positions = torch.arange(t, device=dev)[None].expand(b, t)
        mask = torch.triu(torch.full((t, t), NEG_INF, device=dev), diagonal=1)[None, None]
        if attention_mask is not None:
            mask = mask + torch.where(attention_mask[:, None, None, :] == 0, NEG_INF, 0.0)
        return self.logits(self._run(inputs_embeds, positions, mask))

    def init_cache(self, batch: int) -> list:
        """Zeroed (k, v) of every layer, each (B, max_seq_len, kv_heads,
        head_dim) in ``dtype``."""
        c = self.cfg
        dev = self.lm_head.weight.device
        shape = (batch, c.max_seq_len, c.kv_heads, c.head_dim)
        return [(torch.zeros(shape, dtype=self.dtype, device=dev),
                 torch.zeros(shape, dtype=self.dtype, device=dev)) for _ in range(c.layers)]

    def prefill(self, inputs_embeds: torch.Tensor, attention_mask: torch.Tensor):
        """The prompt through every layer, filling fresh caches: ((B, V)
        fp32 logits of the last position, whatever its row's length, the
        caches). Keys: causal, padded ones masked, each query always
        allowed its own key."""
        b, t, _ = inputs_embeds.shape
        dev = inputs_embeds.device
        caches = self.init_cache(b)
        positions = torch.arange(t, device=dev)[None].expand(b, t)
        key_pos = torch.arange(t, device=dev)[None, None, None, :]
        q_pos = torch.arange(t, device=dev)[None, None, :, None]
        mask = torch.where(key_pos <= q_pos, 0.0, NEG_INF)
        mask = mask + torch.where(attention_mask[:, None, None, :] == 0, NEG_INF, 0.0)
        mask = torch.where(key_pos == q_pos, 0.0, mask)
        x = self._run(inputs_embeds, positions, mask, caches, 0)
        return self.logits(x[:, -1]), caches

    def decode_step(self, x_embed: torch.Tensor, caches: list, offset: int, pad_mask=None):
        """One token a row at position ``offset``: x_embed (B, 1, dim),
        ``pad_mask`` (B, max_seq_len) True = never attend (prompt padding).
        Writes the caches in place; returns ((B, V) fp32 logits, caches)."""
        b = x_embed.shape[0]
        dev = x_embed.device
        n = min(offset + 1, self.cfg.max_seq_len)
        positions = torch.full((b, 1), offset, device=dev)
        mask = torch.zeros(1, 1, 1, n, device=dev)
        if pad_mask is not None:
            mask = mask + torch.where(pad_mask[:, None, None, :n], NEG_INF, 0.0)
        x = self._run(x_embed, positions, mask, caches, offset)
        return self.logits(x[:, 0]), caches


@torch.no_grad()
def init_llama_(model: LlamaForCausalLM, generator: torch.Generator) -> LlamaForCausalLM:
    """Seeded random weights, drawn on the model's device from
    ``generator`` (a generator of that device) one tensor at a time, in
    fp32: the token table and the head normal(0.02) (flax's initialisers),
    each projection normal with std 1 / sqrt(fan_in) (``lecun_normal``'s
    scale), the norms at one. An int8 model gets the int8 quantisation of
    the fp32 draws of the same generator, one projection at a time."""
    from .quant import quantize_weight

    dev = model.lm_head.weight.device

    def draw(shape, std):
        return torch.empty(shape, dtype=torch.float32, device=dev).normal_(
            0.0, std, generator=generator)

    emb = model.model.embed_tokens.weight
    emb.copy_(draw(emb.shape, 0.02))
    for blk in model.model.layers:
        for norm in (blk.input_layernorm, blk.post_attention_layernorm):
            norm.weight.fill_(1.0)
        for name in PROJECTIONS:
            lin = getattr(blk.self_attn if name in PROJECTIONS[:4] else blk.mlp, name)
            w = draw(lin.weight.shape, lin.weight.shape[1] ** -0.5)
            if isinstance(lin, QuantLinear):
                q, scale = quantize_weight(w)
                lin.weight.copy_(q)
                lin.weight_scale.copy_(scale)
            else:
                lin.weight.copy_(w)
            del w
    model.model.norm.weight.fill_(1.0)
    model.lm_head.weight.copy_(draw(model.lm_head.weight.shape, 0.02))
    return model


def build_llama(cfg: LlamaConfig = LlamaConfig(), device="cuda",
                generator: torch.Generator | None = None) -> LlamaForCausalLM:
    """``cfg``'s model on ``device`` (the card by default; ``device='cpu'``
    for the CPU), its tensors made there. With ``generator`` (a generator
    of that device) the weights are drawn from it (:func:`init_llama_`);
    without, the norms are one and every other weight zero, for a
    ``load_state_dict`` to fill."""
    device = target_device(device, "build_llama")
    with torch.no_grad():
        model = LlamaForCausalLM(cfg, device=device)
        if generator is not None:
            return init_llama_(model, generator)
        for p in model.parameters():
            if p.dim() > 1:
                p.zero_()
    return model
