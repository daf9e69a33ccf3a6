"""The SAM two-way transformer's cross attentions over the image keys.

Replaces ``iuvl_tpu/ops/pallas/twoway_attention.py``: ``t2i_stream`` (B4,
token -> image) and ``i2t_block_step`` (B5, image -> token with the
block's residual and LayerNorm). Kernels: ``csrc/twoway_attention.cu``,
whose header says what bounds them on the card, why the TPU's
block-diagonal head packing is not carried over, how B4 splits the key
axis over work items and merges them, and how B5 keeps its step in
registers.

Both take the prompt-side tensors unpacked, (B, T, I) with the heads as
16-wide column slices, and the image keys (Bk, N, C) with Bk 1 (one image
embedding shared by every prompt) or B. Weights are in ``nn.Linear``
layout, (out, in).

Both are differentiable: each is a ``torch.autograd.Function`` whose
forward is the kernel (its plain version on CPU tensors) and whose
backward is the plain version's vjp on the saved inputs, recomputed under
autograd, as JAX's custom VJPs take ``jax.vjp`` of the XLA oracle
(``_t2i_bwd_rule``, ``_i2t_bwd_rule``). No backward kernel exists.
"""

from __future__ import annotations

import functools

import torch

from ..common import plain_vjp
from .build import launch, require


C, I, HEADS = 256, 128, 8
LN_EPS = 1e-5
T2I_KEY_TILE = 64  # keys a tile of B4's kernel
T2I_TOKEN_PASS = 64  # tokens a pass of B4's kernel (four 16-row tiles)


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def t2i_plan(b: int, n: int, t: int, keys_batch: int, sms: int) -> tuple[int, int]:
    """B4's work split: (prompts an item, key ranges). With batch-1 keys an
    item serves 4, 2 or 1 prompts (T <= 16, <= 32, above: the kernel's
    ``t2i_group``); the ranges are as many as give 2 * ``sms`` items, at most
    one a 64-key tile, each of ceil(tiles / ranges) tiles, none empty."""
    tiles = -(-n // T2I_KEY_TILE)
    ntt = -(-min(t, T2I_TOKEN_PASS) // 16)
    group = {1: 4, 2: 2}.get(ntt, 1) if keys_batch == 1 and b > 1 else 1
    units = -(-b // group) * -(-t // T2I_TOKEN_PASS)
    length = -(-tiles // min(tiles, max(1, -(-2 * sms // units))))
    return group, -(-tiles // length)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, L, heads*d) -> (B, heads, L, d)."""
    b, n, _ = x.shape
    return x.reshape(b, n, heads, -1).transpose(1, 2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    """(B, heads, L, d) -> (B, L, heads*d)."""
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def t2i_stream_plain(q, keys, pe_wk, wk, bk, wv, bv, heads: int):
    """Plain version with the math of ``iuvl_tpu`` ``t2i_stream_xla``:
    ``kp = keys @ wk^T + pe_wk + bk``, ``vp = keys @ wv^T + bv``, then
    softmax(q @ kp^T) @ vp per head, scores in fp32. q (B, T, I) is
    pre-scaled by ``d**-0.5``; pe_wk (N, I). Returns (B, T, I)."""
    dt = keys.dtype
    kp = keys @ wk.t() + pe_wk + bk
    vp = keys @ wv.t() + bv
    s = torch.matmul(_heads(q, heads).float(), _heads(kp, heads).float().transpose(-1, -2))
    p = torch.softmax(s, dim=-1).to(dt)
    return _merge(torch.matmul(p, _heads(vp, heads)))


def _t2i_forward(q, keys, pe_wk, wk, bk, wv, bv, heads: int):
    """B4's forward: the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if keys.device.type == "cpu":
        return t2i_stream_plain(q, keys, pe_wk, wk, bk, wv, bv, heads)
    b, t, i = q.shape
    bk_keys, n, c = keys.shape
    if (c, i, heads) != (C, I, HEADS) or t < 1 or n < 1 or bk_keys not in (1, b):
        raise ValueError(
            f"t2i_stream kernel: unsupported C={c}, I={i}, heads={heads}, T={t}, N={n}, "
            f"keys batch {bk_keys} for {b} prompts (needs C 256, I 128, 8 heads, "
            "T >= 1, N >= 1)")
    bf, dev = torch.bfloat16, keys.device
    args = dict(q=q, keys=keys, pe_wk=pe_wk, wk=wk, bk=bk, wv=wv, bv=bv)
    shapes = dict(q=(b, t, I), keys=(bk_keys, n, C), pe_wk=(n, I), wk=(I, C), bk=(I,),
                  wv=(I, C), bv=(I,))
    for name, tensor in args.items():
        require("t2i_stream", name, tensor, bf, shapes[name], dev)
    out = torch.empty((b, t, I), dtype=bf, device=dev)
    _, splits = t2i_plan(b, n, t, bk_keys, _sm_count(dev))
    # Scratch, one allocation: the key ranges' partial o (B, splits, T, I)
    # and (m, l) (B, splits, T, heads, 2) in fp32, then [kp | vp] of the
    # image rows (N, 2 I) in bf16 with batch-1 keys.
    rows = b * splits * t
    kpv_floats = n * I if bk_keys == 1 and b > 1 else 0
    scratch = torch.empty(rows * (I + 2 * HEADS) + kpv_floats, dtype=torch.float32, device=dev)
    part_o = scratch.data_ptr()
    part_ml = part_o + rows * I * 4
    kpv = part_ml + rows * 2 * HEADS * 4
    launch("iuvl_t2i_stream", dev, *(t_.data_ptr() for t_ in args.values()),
           out.data_ptr(), kpv, part_o, part_ml, b, bk_keys, n, t, splits)
    t2i_stream.launches += 1
    return out


class _T2IStream(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, keys, pe_wk, wk, bk, wv, bv, heads):
        ctx.heads = heads
        ctx.save_for_backward(q, keys, pe_wk, wk, bk, wv, bv)
        return _t2i_forward(q, keys, pe_wk, wk, bk, wv, bv, heads)

    @staticmethod
    def backward(ctx, g):
        return (*plain_vjp(t2i_stream_plain, ctx.saved_tensors, ctx.needs_input_grad[:7], g,
                           ctx.heads), None)


def t2i_stream(q, keys, pe_wk, wk, bk, wv, bv, heads: int):
    """Token -> image attention streamed over the keys: the CUDA kernel for
    CUDA tensors (bf16, C 256, I 128, 8 heads, any T >= 1 and N >= 1), the
    plain version for CPU tensors; differentiable, its backward the plain
    version's vjp."""
    return _T2IStream.apply(q, keys, pe_wk, wk, bk, wv, bv, heads)


t2i_stream.launches = 0


def i2t_block_step_plain(keys, pe_wq, kp, vp, wq, bq, wo, bo, ln_w, ln_b, heads: int):
    """Plain version with the math of ``iuvl_tpu`` ``i2t_block_step_xla``:
    ``qp = keys @ wq^T + pe_wq + bq``; softmax(qp @ kp^T * d**-0.5) @ vp per
    head over the prompt's T tokens; ``@ wo^T + bo``; residual; LayerNorm
    (fp32, two-pass variance, eps 1e-5). keys (Bk, N, C); pe_wq (N, I);
    kp, vp (B, T, I). Returns (B, N, C) in keys' dtype."""
    dt = keys.dtype
    qh = _heads(keys @ wq.t() + pe_wq + bq, heads)
    kh = _heads(kp, heads)
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * kh.shape[-1] ** -0.5
    p = torch.softmax(s, dim=-1).to(dt)
    y = (keys + (_merge(torch.matmul(p, _heads(vp, heads))) @ wo.t() + bo)).float()
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    return ((y - mu) * torch.rsqrt(var + LN_EPS) * ln_w.float() + ln_b.float()).to(dt)


def _i2t_forward(keys, pe_wq, kp, vp, wq, bq, wo, bo, ln_w, ln_b, heads: int):
    """B5's forward: the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if keys.device.type == "cpu":
        return i2t_block_step_plain(keys, pe_wq, kp, vp, wq, bq, wo, bo, ln_w, ln_b, heads)
    b, t, i = kp.shape
    bk_keys, n, c = keys.shape
    if (c, i, heads) != (C, I, HEADS) or t < 1 or n < 1 or bk_keys not in (1, b):
        raise ValueError(
            f"i2t_block_step kernel: unsupported C={c}, I={i}, heads={heads}, T={t}, N={n}, "
            f"keys batch {bk_keys} for {b} prompts (needs C 256, I 128, 8 heads, "
            "T >= 1, N >= 1)")
    bf, f32, dev = torch.bfloat16, torch.float32, keys.device
    args = dict(keys=keys, pe_wq=pe_wq, kp=kp, vp=vp, wq=wq, bq=bq, wo=wo, bo=bo,
                ln_w=ln_w, ln_b=ln_b)
    shapes = dict(keys=(bk_keys, n, C), pe_wq=(n, I), kp=(b, t, I), vp=(b, t, I),
                  wq=(I, C), bq=(I,), wo=(C, I), bo=(C,), ln_w=(C,), ln_b=(C,))
    for name, tensor in args.items():
        require("i2t_block_step", name, tensor, f32 if name.startswith("ln") else bf,
                shapes[name], dev)
    out = torch.empty((b, n, C), dtype=bf, device=dev)
    launch("iuvl_i2t_block_step", dev, *(t_.data_ptr() for t_ in args.values()),
           out.data_ptr(), b, bk_keys, n, t, (I // HEADS) ** -0.5, LN_EPS)
    i2t_block_step.launches += 1
    return out


class _I2TBlockStep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, keys, pe_wq, kp, vp, wq, bq, wo, bo, ln_w, ln_b, heads):
        ctx.heads = heads
        ctx.save_for_backward(keys, pe_wq, kp, vp, wq, bq, wo, bo, ln_w, ln_b)
        return _i2t_forward(keys, pe_wq, kp, vp, wq, bq, wo, bo, ln_w, ln_b, heads)

    @staticmethod
    def backward(ctx, g):
        return (*plain_vjp(i2t_block_step_plain, ctx.saved_tensors, ctx.needs_input_grad[:10],
                           g, ctx.heads), None)


def i2t_block_step(keys, pe_wq, kp, vp, wq, bq, wo, bo, ln_w, ln_b, heads: int):
    """Image -> token block step (attention, out-projection, residual,
    LayerNorm) in one pass over the keys: the CUDA kernel for CUDA tensors
    (bf16, C 256, I 128, 8 heads, any T >= 1 (past 64 the kernel takes the
    tokens in 64-row tiles) and N >= 1; LN params fp32), the plain version
    for CPU tensors; differentiable, its backward the plain version's
    vjp."""
    return _I2TBlockStep.apply(keys, pe_wq, kp, vp, wq, bq, wo, bo, ln_w, ln_b, heads)


i2t_block_step.launches = 0
