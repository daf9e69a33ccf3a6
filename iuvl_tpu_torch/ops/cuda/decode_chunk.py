"""SAM's whole-chunk decode tail: everything of the two-way decode that
reads the per-prompt image keys, for a chunk of prompts over one shared
image embedding.

Replaces ``iuvl_tpu/ops/pallas/decode_chunk.py:decode_tail`` (B16): block
0's image -> token step, all of block 1, the final token -> image
attention and its norm, the hypernetwork MLPs, the two upscaling deconvs
and the mask contraction. Kernel: ``csrc/decode_chunk.cu``, whose header
says how the function is split into passes on the card (three token
passes of its own between B5's, B4's and B6's kernels) and why the TPU's
one-prompt-in-VMEM design and its block-diagonal selector matrices are
not carried over.

Arguments: ``t``, ``tpe`` (B, Tp, C) the prompts' tokens after block 0's
front (self-attention, token -> image attention, MLP) and their PE, padded
to Tp slots (pad rows zero); ``keys0``, ``key_pe`` (1, N, C) the shared
image keys and their PE; ``W`` the weights (``MaskDecoder.tail_weights``:
per attention site ``i2t0``, ``self1``, ``t2i1``, ``i2t1``, ``final`` the
``Attention.weights()`` dict, nn.Linear layout (out, in) in the working
dtype; ``i2t0_kv`` block 0's image -> token k and v projections (kw,
kb, vw, vb) in fp32; ``mlp1`` block 1's (w1, b1, w2, b2); per norm of
NORMS (scale, bias) fp32; ``hyper`` the three layers' (weight (M, out,
in), bias (M, out)) of the M hypernetwork MLPs stacked; ``up`` the
upscale stack of ``MaskDecoder.upscale_weights()``); ``t_valid`` the
number of real token slots. The attention over the prompt's slots (block
0's and block 1's image -> token steps, block 1's self-attention) masks
slots ``>= t_valid``; the token -> image attentions compute every slot's
row, as JAX does, and the pad rows are never read.

Rounding follows the JAX kernel: every product is rounded to the working
dtype before its PE term and bias are added, each add rounded in turn;
block 0's token-side k and v, which JAX computes outside its kernel from
the fp32 parameters, are computed in fp32 and rounded once;
LayerNorms in fp32 with the two-pass variance; softmax in fp32 with the
probabilities rounded to the working dtype; GELU tanh in bf16 and erf in
fp32; the mask contraction accumulated and returned in fp32.
"""

from __future__ import annotations

import ctypes

import torch

from ..common import gelu
from .build import launch, require
from .twoway_attention import _heads, _merge, _sm_count, t2i_plan, t2i_stream_plain

C, I, HEADS, M, MLP = 256, 128, 8, 4, 2048
# The kernel's token slots, Tp: any multiple of SLOT (JAX pads a prompt's
# tokens to one); past 64 the token passes run in 64-row tiles.
SLOT = 16
LN_EPS, LN2D_EPS = 1e-5, 1e-6
ATTN_SITES = ("self1", "t2i1", "i2t1", "final")
NORMS = ("ln40", "ln11", "ln21", "ln31", "ln41", "lnf")


def _proj(x, w, b=None, pe=None):
    """``x @ w^T`` rounded to x's dtype, then ``pe`` and ``b`` added in turn."""
    y = x @ w.t()
    if pe is not None:
        y = y + pe
    return y if b is None else y + b


def _i2t0_token_kv(t, tpe, kv):
    """Block 0's image -> token keys and values of the prompts' tokens as
    JAX computes them outside its kernel: from the fp32 parameters ``kv``
    (kw, kb, vw, vb), in fp32, rounded once to t's dtype."""
    kw, kb, vw, vb = kv
    tf = t.float()
    return (tf @ kw.t() + tpe.float() @ kw.t() + kb).to(t.dtype), (tf @ vw.t() + vb).to(t.dtype)


def _ln(y, norm):
    """LayerNorm over the last axis in fp32 (two-pass variance, eps 1e-5),
    the result in y's dtype."""
    yf = y.float()
    mu = yf.mean(-1, keepdim=True)
    var = ((yf - mu) ** 2).mean(-1, keepdim=True)
    return ((yf - mu) * torch.rsqrt(var + LN_EPS) * norm[0].float() + norm[1].float()).to(y.dtype)


def _slot_attention(q, k, v, heads: int, t_valid: int):
    """softmax(q k^T d^-1/2) v per head over the prompt's token slots, the
    slots ``>= t_valid`` masked. q (1 or B, L, D); k, v (B, Tp, D)."""
    qh, kh = _heads(q, heads), _heads(k, heads)
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * qh.shape[-1] ** -0.5
    mask = torch.zeros(k.shape[1], device=s.device)
    mask[t_valid:] = -1e30
    p = torch.softmax(s + mask, dim=-1).to(q.dtype)
    return _merge(torch.matmul(p, _heads(v, heads)))


def _i2t(x, qp, kp, vp, w, norm, heads: int, t_valid: int):
    """The image -> token step: attention of the rows' queries ``qp`` over
    the slots, out-projection, residual and LayerNorm. x (1 or B, N, C)."""
    att = _slot_attention(qp, kp, vp, heads, t_valid)
    return _ln(x + att @ w["ow"].t() + w["ob"], norm)


def _t2i(q, keys, pe_wk, w, heads: int):
    """Token -> image attention of the pre-scaled queries q (B, Tp, I) over
    the keys (B, N, C): the math of B4's plain version."""
    return t2i_stream_plain(q, keys, pe_wk, w["kw"], w["kb"], w["vw"], w["vb"], heads)


def _upscale_masks(keys, up, hyper):
    """Both deconvs on flat keys (B, N, C), the grouped LayerNorm2d and the
    GELUs, then the contraction with ``hyper`` (B, M, C/8) in fp32: (B, N,
    16 M) with columns (di, dj, ei, ej, t)."""
    w1, b1, lnw, lnb, w2, b2 = up
    b, n, _ = keys.shape
    c4, c8 = b1.shape[0], b2.shape[0]
    y1 = (keys @ w1 + b1.repeat(4)).float().reshape(b, n, 4, c4)
    mean = y1.mean(-1, keepdim=True)
    var = (y1 * y1).mean(-1, keepdim=True) - mean * mean
    y1 = (y1 - mean) * torch.rsqrt(var + LN2D_EPS) * lnw.float() + lnb.float()
    y1 = gelu(y1.to(keys.dtype))                                # (B, N, 4 (di, dj), C/4)
    y2 = gelu(y1 @ w2 + b2.repeat(4)).reshape(b, n, 16, c8)     # 16: (di, dj, ei, ej)
    out = torch.einsum("bngc,btc->bngt", y2.float(), hyper.float())
    return out.reshape(b, n, 16 * hyper.shape[1])


def _hyper_mlps(tout, hyper):
    """The M hypernetwork MLPs (ReLU between layers) on the mask tokens
    ``tout[:, 1:1+M]``: (B, M, C/8)."""
    x = tout[:, 1:1 + hyper[0][0].shape[0]]
    for i, (hw, hb) in enumerate(hyper):
        x = torch.einsum("bmc,mdc->bmd", x, hw) + hb
        if i < len(hyper) - 1:
            x = torch.relu(x)
    return x


def decode_tail_plain(t, tpe, keys0, key_pe, W, n_heads: int, t_valid: int):
    """Plain version with the math of ``iuvl_tpu`` ``decode_tail`` (and
    ``decode_tail_xla``), per-head attention in place of the TPU's
    block-diagonal packing. Returns (tokens_out (B, Tp, C), masks_flat
    (B, N, 16 M) fp32 with columns (di, dj, ei, ej, t), keys2 (B, N, C))."""
    dt = keys0.dtype
    h = n_heads
    d_i = W["i2t0"]["qw"].shape[0] // h
    pe = key_pe[0]

    # block 0's image -> token step over the shared keys
    w0 = W["i2t0"]
    qp0 = _proj(keys0, w0["qw"], w0["qb"], pe @ w0["qw"].t())
    kp0, vp0 = _i2t0_token_kv(t, tpe, W["i2t0_kv"])
    keys1 = _i2t(keys0, qp0, kp0, vp0, w0, W["ln40"], h, t_valid)

    # block 1: self-attention, token -> image, MLP, image -> token
    ws = W["self1"]
    tq = t + tpe
    att = _slot_attention(_proj(tq, ws["qw"], ws["qb"]), _proj(tq, ws["kw"], ws["kb"]),
                          _proj(t, ws["vw"], ws["vb"]), h, t_valid)
    t1 = _ln(t + att @ ws["ow"].t() + ws["ob"], W["ln11"])
    w1 = W["t2i1"]
    q = _proj(t1 + tpe, w1["qw"], w1["qb"]) * d_i ** -0.5
    o = _t2i(q, keys1, pe @ w1["kw"].t(), w1, h)
    t1 = _ln(t1 + o @ w1["ow"].t() + w1["ob"], W["ln21"])
    m1w, m1b, m2w, m2b = W["mlp1"]
    y = torch.relu(_proj(t1, m1w, m1b))
    t1 = _ln(t1 + y @ m2w.t() + m2b, W["ln31"])
    wi = W["i2t1"]
    t1pe = t1 + tpe
    qp1 = _proj(keys1, wi["qw"], wi["qb"], pe @ wi["qw"].t())
    keys2 = _i2t(keys1, qp1, _proj(t1pe, wi["kw"], wi["kb"]), _proj(t1, wi["vw"], wi["vb"]),
                 wi, W["ln41"], h, t_valid)

    # the final token -> image attention and its norm
    wf = W["final"]
    q = _proj(t1pe, wf["qw"], wf["qb"]) * d_i ** -0.5
    o = _t2i(q, keys2, pe @ wf["kw"].t(), wf, h)
    tout = _ln(t1 + o @ wf["ow"].t() + wf["ob"], W["lnf"])

    # the hypernetwork MLPs on the mask tokens, the upscale and the masks
    return tout, _upscale_masks(keys2, W["up"], _hyper_mlps(tout, W["hyper"])), keys2


# The kernel's operands in the order of the C entry's pointer array.
def _operands(t, tpe, keys0, key_pe, W):
    pe = key_pe[0]
    w0, wi, w1, wf = W["i2t0"], W["i2t1"], W["t2i1"], W["final"]
    # The shared (batch-1) and the token-side precomputes that JAX runs in
    # XLA around its kernel: plain products here.
    kbd0, vbd0 = _i2t0_token_kv(t, tpe, W["i2t0_kv"])
    pre = dict(pewq0=pe @ w0["qw"].t(), pewq1=pe @ wi["qw"].t(), pewk1=pe @ w1["kw"].t(),
               pewkf=pe @ wf["kw"].t(), kbd0=kbd0, vbd0=vbd0)
    ops = [("t", t), ("tpe", tpe), ("keys0", keys0), *pre.items()]
    ops += [(f"i2t0.{k}", w0[k]) for k in ("qw", "qb", "ow", "ob")]
    for site in ATTN_SITES:
        ops += [(f"{site}.{k}", W[site][k]) for k in ("qw", "qb", "kw", "kb", "vw", "vb",
                                                      "ow", "ob")]
    ops += [(f"mlp1.{k}", x) for k, x in zip(("w1", "b1", "w2", "b2"), W["mlp1"])]
    ops += [(f"{nm}.{k}", x) for nm in NORMS for k, x in zip(("w", "b"), W[nm])]
    ops += [(f"hyper{i}.{k}", x) for i, layer in enumerate(W["hyper"])
            for k, x in zip(("w", "b"), layer)]
    ops += [(f"up.{k}", x) for k, x in zip(("w1", "b1", "lnw", "lnb", "w2", "b2"), W["up"])]
    return ops


def _shapes(b: int, n: int, tp: int = SLOT) -> dict:
    c4, c8 = C // 4, C // 8
    s = dict(t=(b, tp, C), tpe=(b, tp, C), keys0=(1, n, C), pewq0=(n, I), pewq1=(n, I),
             pewk1=(n, I), pewkf=(n, I), kbd0=(b, tp, I), vbd0=(b, tp, I))
    s.update({"i2t0.qw": (I, C), "i2t0.qb": (I,), "i2t0.ow": (C, I), "i2t0.ob": (C,)})
    for site in ATTN_SITES:
        width = C if site == "self1" else I
        s.update({f"{site}.{k}w": (width, C) for k in "qkv"})
        s.update({f"{site}.{k}b": (width,) for k in "qkv"})
        s.update({f"{site}.ow": (C, width), f"{site}.ob": (C,)})
    s.update({"mlp1.w1": (MLP, C), "mlp1.b1": (MLP,), "mlp1.w2": (C, MLP), "mlp1.b2": (C,)})
    s.update({f"{nm}.{k}": (C,) for nm in NORMS for k in "wb"})
    s.update({"hyper0.w": (M, C, C), "hyper0.b": (M, C), "hyper1.w": (M, C, C),
              "hyper1.b": (M, C), "hyper2.w": (M, c8, C), "hyper2.b": (M, c8)})
    s.update({"up.w1": (C, 4 * c4), "up.b1": (c4,), "up.lnw": (c4,), "up.lnb": (c4,),
              "up.w2": (c4, 4 * c8), "up.b2": (c8,)})
    return s


def decode_tail(t, tpe, keys0, key_pe, W, n_heads: int, t_valid: int,
                return_keys2: bool = False):
    """The whole-chunk decode tail: the CUDA kernel for CUDA tensors (bf16,
    C 256, 8 heads of 16 in the cross attentions, Tp any multiple of 16
    slots, M 4 mask tokens, MLP width 2048, any N >= 1; LayerNorm params
    fp32),
    the plain version for CPU tensors. Returns (tokens_out (B, Tp, C), masks_flat
    (B, N, 16 M) fp32, columns (di, dj, ei, ej, t)), and with
    ``return_keys2`` also keys2 (B, N, C), the keys after block 1 (on the
    card the kernel's workspace, which ends holding them)."""
    if keys0.device.type == "cpu":
        out = decode_tail_plain(t, tpe, keys0, key_pe, W, n_heads, t_valid)
        return out if return_keys2 else out[:2]
    b, tp, c = t.shape
    n = keys0.shape[1]
    internal = W["i2t0"]["qw"].shape[0]
    m = W["hyper"][0][0].shape[0]
    if (c, internal, n_heads, m) != (C, I, HEADS, M) or tp < SLOT or tp % SLOT or n < 1 \
            or not 1 <= t_valid <= tp or keys0.shape[0] != 1:
        raise ValueError(
            f"decode_tail kernel: unsupported C={c}, internal {internal}, heads {n_heads} "
            f"(head width {internal // n_heads}), Tp={tp}, t_valid {t_valid}, M={m}, N={n}, "
            f"keys batch {keys0.shape[0]} (needs C 256, 8 heads of 16 (internal 128), Tp a "
            f"multiple of {SLOT}, 1 <= t_valid <= Tp, M 4, N >= 1, one shared image)")
    bf, f32, dev = torch.bfloat16, torch.float32, keys0.device
    ops = _operands(t, tpe, keys0, key_pe, W)
    shapes = _shapes(b, n, tp)
    for name, x in ops:
        require("decode_tail", name, x, f32 if name.startswith(("ln", "up.ln")) else bf,
                shapes[name], dev)
        if x.data_ptr() % 32:  # tensor-core fragments load 32-byte aligned tiles
            raise ValueError(f"decode_tail: {name} is not 32-byte aligned")
    tok = torch.empty((b, tp, C), dtype=bf, device=dev)
    masks = torch.empty((b, n, 16 * M), dtype=f32, device=dev)
    # B4's key ranges in the two token -> image attentions (per-prompt keys).
    _, splits = t2i_plan(b, n, tp, b, _sm_count(dev))
    work = [torch.empty((b, n, C), dtype=bf, device=dev),             # keys1
            torch.empty((b, n, C), dtype=bf, device=dev),             # keys2
            torch.empty(b * splits * tp * (I + 2 * HEADS), dtype=f32, device=dev),  # B4's partials
            torch.empty((b, tp, I), dtype=bf, device=dev),             # B4's merged output
            torch.empty((b, tp, C), dtype=bf, device=dev),             # token state
            torch.empty((b, tp, I), dtype=bf, device=dev),             # t2i queries
            torch.empty((b, 2, tp, I), dtype=bf, device=dev),          # i2t1 token k, v
            torch.empty((b, M, C // 8), dtype=bf, device=dev),         # hypernetwork out
            # block 1's self-attention k, v (read past 64 slots only)
            torch.empty((b, 2, tp, C) if tp > 64 else (0,), dtype=bf, device=dev)]
    ptrs = [x.data_ptr() for _, x in ops] + [tok.data_ptr(), masks.data_ptr()] \
        + [x.data_ptr() for x in work]
    array = (ctypes.c_void_p * len(ptrs))(*ptrs)
    launch("iuvl_decode_tail", dev, ctypes.addressof(array), len(ptrs), b, n, tp, t_valid,
           splits)
    decode_tail.launches += 1
    return (tok, masks, work[1]) if return_keys2 else (tok, masks)


decode_tail.launches = 0


def unflatten_masks_ge(flat: torch.Tensor, h: int, w: int, m: int) -> torch.Tensor:
    """(B, H*W, 16 M) with columns (di, dj, ei, ej, t) -> (B, M, 4H, 4W)."""
    b = flat.shape[0]
    x = flat.reshape(b, h, w, 2, 2, 2, 2, m).permute(0, 7, 1, 3, 5, 2, 4, 6)
    return x.reshape(b, m, 4 * h, 4 * w)
