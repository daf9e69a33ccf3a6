"""SAM two-way-transformer mask decoder, PyTorch port of
``iuvl_tpu/models/sam/mask_decoder.py``.

The two-way transformer is the structure of the JAX package's fused TPU
path (``TwoWayAttentionBlock(fused=True)``): token self-attention in plain
PyTorch; every token -> image attention through ``t2i_stream`` (B4) and
every image -> token step (attention, out-projection, residual, norm4)
through ``i2t_block_step`` (B5); positional terms folded through the
projections (``proj(x + pe) == proj(x) + pe @ W``). A batch-1 image
embedding stays batch-1 until block 0's image -> token step writes the
per-prompt keys, which is algebraically the reference's per-prompt tiling.
The mask output goes through the fused upscale + hypernetwork kernel (B6).
The three kernels are differentiable (their backward the plain version's
vjp); under training (``needs_grad``) the weight layouts they take are
made inside the graph, otherwise once per weight state (``prepared``).

``twoway_impl='auto'`` runs the kernels on CUDA tensors (their plain
versions on CPU tensors); ``'plain'`` runs the plain versions everywhere.
``'chunk'`` is JAX's whole-chunk decode: block 0's token side in plain
PyTorch, everything after it in one ``decode_tail`` call (B16), which
needs a batch-1 image embedding; ``'chunk_plain'`` runs B16's plain
version everywhere (JAX's ``'chunk_xla'``).
Returns both output conventions: ``masks`` (B, M, 4H, 4W) and
``iou_pred`` (B, M), and the unified-head inputs ``upscaled_embedding``
(B, 4H, 4W, C/8) and ``hyper_in`` (B, M, C/8).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.common import (conv_transpose_nhwc, gelu, layer_norm_f32, linear, needs_grad,
                          prepared)
from ...ops.cuda.decode_chunk import decode_tail, decode_tail_plain, unflatten_masks_ge
from ...ops.cuda.mask_upscale import (flat_deconv, masks_upscale, masks_upscale_plain,
                                      unflatten_masks)
from ...ops.cuda.twoway_attention import (i2t_block_step, i2t_block_step_plain,
                                          t2i_stream, t2i_stream_plain)
from .image_encoder import LayerNorm2d


def _ln(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """flax ``nn.LayerNorm(epsilon=1e-5, dtype=float32)``: fp32 out."""
    return layer_norm_f32(x, norm.weight, norm.bias, norm.eps)


class Attention(nn.Module):
    """Attention with internal-dim downsampling (reference transformer.py
    ``Attention``; JAX ``DownsampledAttention``)."""

    def __init__(self, embedding_dim: int, num_heads: int, downsample_rate: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        internal = embedding_dim // downsample_rate
        self.q_proj = nn.Linear(embedding_dim, internal)
        self.k_proj = nn.Linear(embedding_dim, internal)
        self.v_proj = nn.Linear(embedding_dim, internal)
        self.out_proj = nn.Linear(internal, embedding_dim)

    def forward(self, q, k, v, q_pe=None, k_pe=None):
        dt = self.dtype
        qp = q.to(dt) @ self.q_proj.weight.to(dt).t()
        if q_pe is not None:
            qp = qp + q_pe.to(dt) @ self.q_proj.weight.to(dt).t()
        qp = qp + self.q_proj.bias.to(dt)
        kp = linear(k, self.k_proj.weight, self.k_proj.bias, dt)
        vp = linear(v, self.v_proj.weight, self.v_proj.bias, dt)
        if k_pe is not None:
            kp = kp + k_pe.to(dt) @ self.k_proj.weight.to(dt).t()

        h = self.num_heads
        split = lambda t: t.reshape(t.shape[0], t.shape[1], h, -1).transpose(1, 2)  # noqa: E731
        qh, kh, vh = split(qp), split(kp), split(vp)  # (b, h, n, d), b may be 1
        bq, _, nq, d = qh.shape
        shared = kh.shape[0] == 1 < bq  # one image's keys: the prompts' queries as rows of one product
        if shared:
            qh = qh.transpose(0, 1).reshape(1, h, bq * nq, d)
        attn = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
        attn = torch.softmax(attn / (d ** 0.5), dim=-1).to(vh.dtype)
        out = torch.matmul(attn, vh)
        if shared:
            out = out.reshape(h, bq, nq, d).transpose(0, 1)
        out = out.transpose(1, 2).reshape(bq, nq, -1)
        return linear(out, self.out_proj.weight, self.out_proj.bias, dt)

    def weights(self) -> dict[str, torch.Tensor]:
        """The projections in the working dtype, ``nn.Linear`` layout:
        inside the graph when they train, else made once per weight state."""
        names = ("q_proj", "k_proj", "v_proj", "out_proj")
        def make():
            w = {}
            for name in names:
                lin = getattr(self, name)
                w[name[0] + "w"], w[name[0] + "b"] = lin.weight.to(self.dtype), lin.bias.to(self.dtype)
            return w
        if needs_grad(*self.parameters()):
            return make()
        return prepared(self, "weights", make, *self.parameters())

    def token_to_image(self, queries, query_pe, keys, key_pe, impl: str):
        """Token -> image cross attention (JAX ``_fused_t2i``): the q side
        and the out-projection on the (B, T, .) tokens, the keys side in
        ``t2i_stream``. keys (1 or B, N, C); key_pe (1, N, C)."""
        dt, w = self.dtype, self.weights()
        qp = queries.to(dt) @ w["qw"].t() + query_pe.to(dt) @ w["qw"].t() + w["qb"]
        d = qp.shape[-1] // self.num_heads
        fn = t2i_stream if impl == "auto" else t2i_stream_plain
        out = fn(qp * d ** -0.5, keys, key_pe[0] @ w["kw"].t(), w["kw"], w["kb"],
                 w["vw"], w["vb"], self.num_heads)
        return out @ w["ow"].t() + w["ob"]

    def image_to_token(self, keys, key_pe, queries, query_pe, norm: nn.LayerNorm,
                       impl: str):
        """``norm(keys + attn(keys, queries))`` (JAX ``_fused_i2t``): the
        token-side k/v projections here, the pass over the keys in
        ``i2t_block_step``. Returns (B, N, C) in the working dtype."""
        dt, w = self.dtype, self.weights()
        q = queries.to(dt)
        kp = q @ w["kw"].t() + w["kb"] + query_pe.to(dt) @ w["kw"].t()
        vp = q @ w["vw"].t() + w["vb"]
        fn = i2t_block_step if impl == "auto" else i2t_block_step_plain
        return fn(keys, key_pe[0] @ w["qw"].t(), kp, vp, w["qw"], w["qb"], w["ow"],
                  w["ob"], norm.weight.float(), norm.bias.float(), self.num_heads)


class MLPBlock(nn.Module):
    def __init__(self, embedding_dim: int, mlp_dim: int):
        super().__init__()
        self.lin1 = nn.Linear(embedding_dim, mlp_dim)
        self.lin2 = nn.Linear(mlp_dim, embedding_dim)


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, embedding_dim: int, num_heads: int, mlp_dim: int = 2048,
                 attention_downsample_rate: int = 2, skip_first_layer_pe: bool = False,
                 dtype: torch.dtype = torch.float32, impl: str = "auto"):
        super().__init__()
        self.dtype = dtype
        self.impl = impl
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = Attention(embedding_dim, num_heads, dtype=dtype)
        self.norm1 = nn.LayerNorm(embedding_dim, eps=1e-5)
        self.cross_attn_token_to_image = Attention(
            embedding_dim, num_heads, attention_downsample_rate, dtype)
        self.norm2 = nn.LayerNorm(embedding_dim, eps=1e-5)
        self.mlp = MLPBlock(embedding_dim, mlp_dim)
        self.norm3 = nn.LayerNorm(embedding_dim, eps=1e-5)
        self.norm4 = nn.LayerNorm(embedding_dim, eps=1e-5)
        self.cross_attn_image_to_token = Attention(
            embedding_dim, num_heads, attention_downsample_rate, dtype)

    def front(self, queries, keys, query_pe, key_pe, fused: bool = True):
        """The token side of the block: self-attention, token -> image
        attention (through B4 when ``fused``, else the plain ``Attention``,
        as JAX's ``fused=False`` block) and the MLP, each with its norm."""
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            queries = queries + self.self_attn(queries, queries, queries,
                                               q_pe=query_pe, k_pe=query_pe)
        queries = _ln(queries, self.norm1)
        t2i = self.cross_attn_token_to_image
        if fused:
            queries = queries + t2i.token_to_image(queries, query_pe, keys, key_pe, self.impl)
        else:
            queries = queries + t2i(queries, keys, keys, q_pe=query_pe, k_pe=key_pe)
        queries = _ln(queries, self.norm2)
        y = torch.relu(linear(queries, self.mlp.lin1.weight, self.mlp.lin1.bias, self.dtype))
        y = linear(y, self.mlp.lin2.weight, self.mlp.lin2.bias, self.dtype)
        return _ln(queries + y, self.norm3)

    def forward(self, queries, keys, query_pe, key_pe):
        queries = self.front(queries, keys, query_pe, key_pe)
        keys = self.cross_attn_image_to_token.image_to_token(
            keys, key_pe, queries, query_pe, self.norm4, self.impl)
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, depth: int = 2, embedding_dim: int = 256, num_heads: int = 8,
                 mlp_dim: int = 2048, attention_downsample_rate: int = 2,
                 dtype: torch.dtype = torch.float32, impl: str = "auto"):
        super().__init__()
        self.impl = impl
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(embedding_dim, num_heads, mlp_dim,
                                 attention_downsample_rate, i == 0, dtype, impl)
            for i in range(depth))
        self.final_attn_token_to_image = Attention(
            embedding_dim, num_heads, attention_downsample_rate, dtype)
        self.norm_final_attn = nn.LayerNorm(embedding_dim, eps=1e-5)

    def chunk_front(self, image_embedding, image_pe, point_embedding):
        """JAX's ``chunk_front``: only block 0's token side (plain PyTorch,
        no B4), which never writes into the shared keys; ``decode_tail``
        takes over from block 0's image -> token step. image_embedding and
        image_pe (1, H, W, C). Returns (queries (B, T, C) fp32, keys and
        key_pe (1, HW, C) in the embedding's dtype)."""
        _, h, w, c = image_embedding.shape
        keys = image_embedding.reshape(1, h * w, c)
        key_pe = image_pe[:1].reshape(1, h * w, c).to(keys.dtype)
        queries = self.layers[0].front(point_embedding, keys, point_embedding, key_pe,
                                       fused=False)
        return queries, keys, key_pe

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding (1 or B, H, W, C); image_pe (1 or B, H, W, C);
        point_embedding (B, N, C). The image PE is the same for every
        prompt: only its first row is read, as in JAX's fused path.
        Returns (queries (B, N, C) fp32, keys (B, HW, C))."""
        b, h, w, c = image_embedding.shape
        keys = image_embedding.reshape(b, h * w, c)
        key_pe = image_pe[:1].reshape(1, h * w, c).to(keys.dtype)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        queries = queries + self.final_attn_token_to_image.token_to_image(
            queries, point_embedding, keys, key_pe, self.impl)
        return _ln(queries, self.norm_final_attn), keys


class MLP(nn.Module):
    """ReLU MLP (reference mask_decoder.py ``MLP``; JAX ``HyperMLP``)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        dims = [input_dim] + [hidden_dim] * (num_layers - 1)
        outs = [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(n, k) for n, k in zip(dims, outs))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = linear(x, layer.weight, layer.bias, self.dtype)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


# JAX's twoway_impl names and the port's routes: 'pallas' forces JAX's fused
# per-op decode kernels (the port's 'auto'), 'off' its XLA math (the plain
# versions), 'chunk_xla' the whole-chunk decode's XLA oracle ('chunk_plain').
TWOWAY_ALIASES = {"pallas": "auto", "off": "plain", "chunk_xla": "chunk_plain"}


class MaskDecoder(nn.Module):
    def __init__(self, transformer_dim: int = 256, num_multimask_outputs: int = 3,
                 iou_head_depth: int = 3, iou_head_hidden_dim: int = 256,
                 transformer_mlp_dim: int = 2048, transformer_num_heads: int = 8,
                 dtype: torch.dtype = torch.float32, twoway_impl: str = "auto"):
        super().__init__()
        self.dtype = dtype
        twoway_impl = TWOWAY_ALIASES.get(twoway_impl, twoway_impl)
        self.twoway_impl = twoway_impl
        self.num_mask_tokens = num_multimask_outputs + 1
        c = transformer_dim
        self.transformer = TwoWayTransformer(
            2, c, transformer_num_heads, transformer_mlp_dim, dtype=dtype, impl=twoway_impl)
        self.iou_token = nn.Embedding(1, c)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, c)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(c, c // 4, 2, 2), LayerNorm2d(c // 4), nn.GELU(),
            nn.ConvTranspose2d(c // 4, c // 8, 2, 2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(c, c, c // 8, 3, dtype) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = MLP(c, iou_head_hidden_dim, self.num_mask_tokens,
                                       iou_head_depth, dtype)

    def upscale_weights(self):
        """The upscale stack in the layout ``masks_upscale`` takes: flat
        deconv weights and biases in the working dtype, LN2d params fp32;
        inside the graph when they train, else made once per weight state."""
        up, dt = self.output_upscaling, self.dtype

        def make():
            return (flat_deconv(up[0].weight).to(dt), up[0].bias.to(dt), up[1].weight.float(),
                    up[1].bias.float(), flat_deconv(up[3].weight).to(dt), up[3].bias.to(dt))
        if needs_grad(*up.parameters()):
            return make()
        return prepared(self, "upscale", make, *up.parameters())

    def upscaled_embedding(self, keys: torch.Tensor, hgrid: int, wgrid: int):
        """(B, 4H, 4W, C/8) from flat keys (B, HW, C): the upscale stack."""
        up, dt = self.output_upscaling, self.dtype
        y = keys.reshape(keys.shape[0], hgrid, wgrid, -1)
        y = gelu(up[1](conv_transpose_nhwc(y, up[0], dt)))
        return gelu(conv_transpose_nhwc(y, up[3], dt))

    def forward(self, image_embeddings, image_pe, sparse_prompt_embeddings,
                dense_prompt_embeddings, return_upscaled: bool = True,
                return_masks: bool = True):
        """image_embeddings (1 or B, H, W, C) — batch-1 is the
        one-encode/many-decode path; image_pe (H, W, C) or (1|B, H, W, C);
        sparse (B, T, C); dense (1 or B, H, W, C). ``return_upscaled=False``
        skips the (B, 4H, 4W, C/8) upscaled embedding, which the JAX
        serving program never materialises when only masks are read;
        ``return_masks=False`` skips the masks (B6), which the spatial
        train stream never reads (per-op routes only)."""
        dt = self.dtype
        b = sparse_prompt_embeddings.shape[0]
        output_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight])
        tokens = torch.cat([output_tokens[None].expand(b, -1, -1).to(dt),
                            sparse_prompt_embeddings.to(dt)], dim=1)
        src = image_embeddings + dense_prompt_embeddings
        if image_pe.dim() == 3:
            image_pe = image_pe[None]
        _, hgrid, wgrid, _ = src.shape
        if self.twoway_impl in ("chunk", "chunk_plain"):
            return self._chunk_decode(src.to(dt), image_pe, tokens, return_upscaled)
        hs, keys = self.transformer(src.to(dt), image_pe, tokens)
        m = self.num_mask_tokens
        hyper_in = torch.stack(
            [mlp(hs[:, 1 + i]) for i, mlp in enumerate(self.output_hypernetworks_mlps)],
            dim=1)
        out = {}
        if return_masks:
            fn = masks_upscale if self.twoway_impl == "auto" else masks_upscale_plain
            flat = fn(keys, *self.upscale_weights(), hyper_in.to(dt))
            out["masks"] = unflatten_masks(flat, hgrid, wgrid, m)
        out.update(iou_pred=self.iou_prediction_head(hs[:, 0]), hyper_in=hyper_in)
        if return_upscaled:
            out["upscaled_embedding"] = self.upscaled_embedding(keys, hgrid, wgrid)
        return out

    def tail_weights(self) -> dict:
        """The weights ``decode_tail`` reads, in its layout (made once per
        weight state): block 0's image -> token attention (its k and v
        projections also in fp32, as JAX's chunk branch reads them) and
        norm4, all of block 1, the final attention and its norm, the
        hypernetwork MLPs stacked, the upscale stack."""
        tr, dt = self.transformer, self.dtype
        l0, l1 = tr.layers

        def make():
            attn = {"i2t0": l0.cross_attn_image_to_token.weights(),
                    "self1": l1.self_attn.weights(),
                    "t2i1": l1.cross_attn_token_to_image.weights(),
                    "i2t1": l1.cross_attn_image_to_token.weights(),
                    "final": tr.final_attn_token_to_image.weights()}
            i2t0 = l0.cross_attn_image_to_token
            i2t0_kv = tuple(x.float() for x in (i2t0.k_proj.weight, i2t0.k_proj.bias,
                                                 i2t0.v_proj.weight, i2t0.v_proj.bias))
            mlp1 = (l1.mlp.lin1.weight.to(dt), l1.mlp.lin1.bias.to(dt),
                    l1.mlp.lin2.weight.to(dt), l1.mlp.lin2.bias.to(dt))
            norms = {name: (norm.weight.float(), norm.bias.float()) for name, norm in (
                ("ln40", l0.norm4), ("ln11", l1.norm1), ("ln21", l1.norm2), ("ln31", l1.norm3),
                ("ln41", l1.norm4), ("lnf", tr.norm_final_attn))}
            mlps = self.output_hypernetworks_mlps
            hyper = [(torch.stack([mlp.layers[j].weight for mlp in mlps]).to(dt),
                      torch.stack([mlp.layers[j].bias for mlp in mlps]).to(dt))
                     for j in range(len(mlps[0].layers))]
            return {**attn, "i2t0_kv": i2t0_kv, "mlp1": mlp1, **norms, "hyper": tuple(hyper),
                    "up": self.upscale_weights()}
        return prepared(self, "tail", make, *self.parameters())

    def _chunk_decode(self, src, image_pe, tokens, return_upscaled: bool):
        """JAX's chunk branch: block 0's token side here, the rest of the
        two-way transformer, the hypernetwork and the upscale in
        ``decode_tail`` (B16 for ``'chunk'`` on CUDA tensors, its plain
        version on the CPU and for ``'chunk_plain'``); the tokens padded to
        a multiple of 16 slots (B16 takes any). ``hyper_in`` and
        ``iou_pred`` come from the output tokens as in the per-op path."""
        if src.shape[0] != 1:
            raise ValueError(
                "chunk decode is the one-encode/many-decode serving path and needs a shared "
                f"batch-1 image embedding; got {tuple(src.shape)}")
        _, hgrid, wgrid, _ = src.shape
        q0, keys0, key_pe = self.transformer.chunk_front(src, image_pe, tokens)
        t_valid = q0.shape[1]
        pad = (0, 0, 0, -(-t_valid // 16) * 16 - t_valid)
        q0p = F.pad(q0.to(self.dtype), pad)
        tpep = F.pad(tokens, pad)
        heads = self.transformer.final_attn_token_to_image.num_heads
        W = self.tail_weights()
        if self.twoway_impl == "chunk":
            res = decode_tail(q0p, tpep, keys0, key_pe, W, heads, t_valid,
                              return_keys2=return_upscaled)
        else:
            res = decode_tail_plain(q0p, tpep, keys0, key_pe, W, heads, t_valid)
        tout, flat = res[:2]
        out = {
            "masks": unflatten_masks_ge(flat, hgrid, wgrid, self.num_mask_tokens),
            "iou_pred": self.iou_prediction_head(tout[:, 0]),
            "hyper_in": torch.stack([mlp(tout[:, 1 + i]) for i, mlp in
                                     enumerate(self.output_hypernetworks_mlps)], dim=1),
        }
        if return_upscaled:
            out["upscaled_embedding"] = self.upscaled_embedding(res[2], hgrid, wgrid)
        return out
