"""Drive the port's SAM serving paths, automatic mask generation, its seg
train step and its seg eval on one CUDA card, and check them.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):
1. device: require CUDA; print torch/CUDA versions and the card's name and
   power limit (nvidia-smi).
2. build: compile the hand-written kernels from iuvl_tpu_torch/csrc (one
   nvcc per source, in parallel).
3. kernels: each kernel against its plain PyTorch version at the shapes of
   the path that runs it (ViT-B, 1024^2, bf16; the deformable core B7 and
   its backward glue B8 at the res3 level of the batch-2 train step; the
   one-hot level B15 at the res5 level of the hybrid eval; the whole-chunk
   decode tail B16 at a 256-prompt chunk, its tokens on the 7 valid
   slots; B2b and B14, forward and backward, at the windowed shape (300
   (window, head) pairs of N 196) and the global one (12 heads of N 4096),
   each shape a row of its own). Every output's relative L2 error must stay within its own bound
   (KERNEL_BOUNDS). Planted faults run through the plain version (a bias,
   rel-pos or PE term dropped, heads, tokens or slots swapped, a wrong lse,
   a reduction that misses its last 16 rows, a tap at the wrong row, the
   zero-padding validity dropped, a slot read from the next slot's columns,
   a point dropped, an index one cell off, weights rounded per point
   instead of per cell, the slot mask dropped, the final attention reading
   keys1, a softmax merge missing a split): each must move some output by
   more than its bound, and each output's bound must catch some fault. B8's two entry
   points must agree exactly. Times from CUDA events after a warm-up; for
   B11, B12, B2b, B14 and B7's gather and scatter also the PyTorch call that
   computes the same function (timed only, never a path). Then the global-block grad
   switch: the training route (B11 + projection) against the serving route
   (B2) on the same inputs.
4. serving: SAM ViT-B bf16 with seeded random weights answers REQUESTS
   requests (one 1024^2 image encoded once, 1024 point prompts decoded in
   chunks of 256) through the kernels, with per-request launch counts
   checked; the same requests go through the plain versions in bf16 and in
   fp32. The kernel path's masks must be no further from the fp32 masks
   than SLICE_FACTOR times the plain bf16 path's distance, in relative L2
   of the logits and in 1 - mean per-mask IoU of ``logits > 0``. The same
   requests go through the whole-chunk decode (``twoway_impl='chunk'``:
   B16 once a chunk, B4-B6 never) and its plain version in bf16 and fp32,
   gated the same way; masks/s of both decode designs are printed.
   AMG: ``generate_masks`` on one seeded 1024^2 image (32 x 32 points,
   batches of 64, one crop layer, COCO RLE) with the chunk model, with the
   default IoU and stability cuts and with both cuts off (NMS and the RLE
   codec over all 2048 masks); launches per image checked (5 encodes, B16
   32), the records checked well-formed, host times printed; one batch of
   64 grid prompts also goes through chunk plain bf16 and fp32 (each path
   encoding the image), its masks and upscaled embedding gated the same
   way. One more request of CHUNK prompts of 20 points each (26 tokens)
   goes through the per-op decode (B4, B5 at T 26) and the whole-chunk
   decode (B16 at 32 slots), each gated against its plain paths. Then the
   same REQUESTS requests through attn_impl 'rowbias' and 'pallas_rp'
   (JAX's unfused encoder route: B2b / B14 in all 12 blocks, no B1-B3),
   gated against the plain paths.
   Shapes: the encoder at ViT-H 1024^2, ViT-B 512^2 and ViT-B 800^2 (depth
   cut to one windowed and one global block) through 'auto', the serving
   encode and the training route's backward gated against plain bf16 and
   fp32, launches checked (every block on a kernel).
5. train: the SysLearner seg train step (ViT-B + SimpleFPN, 6-layer
   deformable pixel decoder, 9-layer unified decoder, 101 queries; bf16;
   seeded random weights) for STEPS steps of 1024^2 images, 134 x 512
   text embeddings and 20 gt masks an image, at batch 1 (the plain 'wide'
   deformable core) and then at batch 2 (the flat core: B7 and B8), each
   through the kernels, the plain versions
   in bf16 and the plain versions in fp32, with the same point draws; each
   step's assignments are the fp32 path's. Launch counts per step are
   checked. For each loss term (class CE, mask BCE, dice, each over the 10
   kept layers, pooled over GATE_BATCHES batches at the first step's
   weights, the first step's batch among them) and the gradient of each
   parameter group on the first step,
   the kernel path's relative L2 from fp32 must be at most SLICE_FACTOR
   times the plain bf16 path's. At batch 1 a control pair
   (plain bf16 and fp32 on slightly perturbed weights) takes the first step
   too: its ratios, and every path's ratio per layer's loss scalar, are
   printed, not gated. Step times after one warm-up step, and each path's
   peak device memory. Then the same at batch 1 under attn_impl 'rowbias'
   and 'pallas_rp' and at batch 2 under 'rowbias' (B2b / B14 forward and
   backward in every block, the plain tail; no control pair), each gated
   on its gradient groups and its loss terms pooled over GATE_BATCHES
   batches; their one-batch loss ratios are printed, not gated.
6. eval: ``SysLearner.evaluate_seg`` (the same full-width config, bf16,
   batch 1) on EVAL_IMAGES seeded 1024^2 images with synthetic gt, with the
   134 COCO panoptic class embeddings (80 HashWord-tokenized templates a
   class through the 12-layer text tower), through the kernels with
   ``msdeform_impl='auto'`` (bench's config) and ``'hybrid'`` (B15 on
   res5), the plain versions in bf16 with each impl, and in fp32. Each
   kernel path's mask_cls and upsampled mask_pred, over the images, must be
   no further from fp32 than SLICE_FACTOR times its own impl's plain bf16
   path's. Launches per image checked; evaluate_seg times (host clock,
   synchronised, images after the first), text embedding, encode and
   SimpleFPN times, peak memory. Then each kernel path runs the seg eval
   pipeline (semantic, panoptic and instance heads into the mIoU, PQ and
   AP evaluators) over the images, its launches counted, the host times of
   the post-processing and the metrics printed.
7. prints the kernel table as one JSON line, the nvidia-smi line, and
   ``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

# Relative L2 error of each kernel output against its plain bf16 version
# on the card: about 3-7x its sound reading, and 5x or more below its
# smallest planted fault's (PERF.md, Findings, lists both readings).
KERNEL_BOUNDS = {
    "window_attention_block": {"out": 5e-4},
    "flash_attention_rowbias_proj": {"out": 1e-2},
    "block_tail": {"out": 5e-4},
    "masks_upscale": {"out": 2e-4},
    "t2i_stream": {"out": 5e-3},
    "i2t_block_step": {"out": 2e-4},
    "window_block_backward": {"dx": 1e-3, "dwqkv": 5e-4, "dbqkv": 5e-4, "dwo": 5e-4,
                              "dbo": 1e-5, "drh": 5e-4, "drw": 5e-4},
    "block_tail_backward": {"dxa": 1e-3, "dscale": 5e-4, "dbias": 5e-4, "dw1": 5e-4,
                            "db1": 5e-4, "dw2": 5e-4, "db2": 1e-5},
    # fp32 atomics: colliding rows add in no fixed order.
    "tap_scatter": {"acc": 1e-6},
    # dq, dk inherit the forward's rounding of o through delta = rowsum(do o).
    "flash_attention": {"o": 5e-3, "lse": 1e-5, "dq": 5e-3, "dk": 5e-3, "dv": 1e-3},
    # The deformable core: the forward and B8's dots sum fp32 products in
    # another order; the gather and B8's contrib are exact (a copy, one
    # rounding of one product); the scatter adds with fp32 atomics.
    "ms_deform_level_fwd": {"out": 5e-7},
    "deform_gather_rows": {"g4": 0.0},
    "deform_bwd_glue_q": {"contrib": 0.0, "dots": 5e-7},
    "deform_bwd_glue": {"contrib": 0.0, "dots": 5e-7},
    "deform_scatter_dv": {"dv": 5e-8},
    # B15: the same exact products summed in fp32 in another order, one
    # rounding to bf16: outputs differ by at most one bf16 unit, rarely.
    "onehot_deform_level_forward": {"out": 3e-5},
    # B16: the whole decode tail in bf16, every rounding point of the plain
    # version but the t2i softmax's (unnormalised, per 32-key tile) and the
    # order of the sums; tokens on the valid slots.
    "decode_tail": {"tokens": 3.5e-3, "masks": 1.5e-2},
    # B2b / B14: the online softmax rounds the unnormalised p per 64-key
    # tile (as B11 does); the backward sums dq and the bias cotangents with
    # fp32 atomics in no fixed order.
    "flash_rowbias_fwd": {"o": 1e-2, "lse": 1e-5},
    "flash_relpos_fwd": {"o": 1e-2, "lse": 1e-5},
    "flash_rowbias_bwd": {"dq": 1e-3, "dk": 1e-3, "dv": 1e-3, "drelh": 1e-3, "drelw": 1e-3},
    "flash_relpos_bwd": {"dq": 1e-3, "dk": 1e-3, "dv": 1e-3, "drelh": 1e-3, "drelw": 1e-3},
}
GRAD_SWITCH_BOUND = 1e-2  # B11 + projection vs B2: two bf16 roundings of one function
# A bf16 path's distance from the fp32 path: the kernels may be this many
# times as far off as the plain versions (sound: about 1).
SLICE_FACTOR = 1.25
REQUESTS = 3
N_PROMPTS, CHUNK = 1024, 256
STEPS = 3
GATE_BATCHES = 16  # the loss gate's batches at the first step's weights
N_CLASSES, N_TARGETS, MATCH_POINTS = 133, 20, 12544
SEED = 0
BIAS_STD = 0.3  # biases, PE and rel-pos terms: a fair share of a unit signal
PALLAS = "iuvl_tpu/ops/pallas/"
MSDEFORM = "iuvl_tpu/ops/msdeform.py"
SOURCES = {  # kernel -> (CUDA source, the TPU function it replaces)
    "window_attention_block": ("window_block.cu", PALLAS + "window_block.py:148"),
    "flash_attention_rowbias_proj": ("flash_attention.cu", PALLAS + "flash_attention.py:1271"),
    "block_tail": ("mlp_block.cu", PALLAS + "mlp_block.py:115"),
    "masks_upscale": ("mask_upscale.cu", PALLAS + "mask_upscale.py:181"),
    "t2i_stream": ("twoway_attention.cu", PALLAS + "twoway_attention.py:305"),
    "i2t_block_step": ("twoway_attention.cu", PALLAS + "twoway_attention.py:163"),
    "window_block_backward": ("window_block_bwd.cu", PALLAS + "window_block.py:273"),
    "block_tail_backward": ("mlp_block_bwd.cu", PALLAS + "mlp_block.py:212"),
    "flash_attention": ("flash_attention_train.cu", PALLAS + "flash_attention.py:193"),
    "tap_scatter": ("tap_scatter.cu", PALLAS + "tap_scatter.py:39"),
    # B7: the flat core of the JAX package (XLA, not Pallas), per level.
    "ms_deform_level_fwd": ("msdeform.cu", MSDEFORM + ":489"),  # _flat_level_fwd_impl
    "deform_gather_rows": ("msdeform.cu", MSDEFORM + ":442"),  # _flat_gather_rows(_wide_map)
    "deform_scatter_dv": ("msdeform.cu", MSDEFORM + ":637"),  # dv4 scatter + fold (:669)
    "deform_bwd_glue_q": ("deform_bwd_glue.cu", PALLAS + "deform_bwd_glue.py:71"),
    "deform_bwd_glue": ("deform_bwd_glue.cu", PALLAS + "deform_bwd_glue.py:111"),
    "onehot_deform_level_forward": ("onehot_gather.cu", PALLAS + "onehot_gather.py:57"),
    "decode_tail": ("decode_chunk.cu", PALLAS + "decode_chunk.py:511"),
    # B2b (flash_attention_rowbias, :1171) and B14 (flash_attention_relpos, :677):
    # their forward and backward functions.
    "flash_rowbias_fwd": ("flash_attention_rowbias.cu", PALLAS + "flash_attention.py:1012"),
    "flash_rowbias_bwd": ("flash_attention_rowbias.cu", PALLAS + "flash_attention.py:1074"),
    "flash_relpos_fwd": ("flash_attention_rowbias.cu", PALLAS + "flash_attention.py:601"),
    "flash_relpos_bwd": ("flash_attention_rowbias.cu", PALLAS + "flash_attention.py:694"),
}
# Checked and timed, on no path: JAX's row-layout glue, which its flat
# backward runs only under IUVL_GLUE_Q=0 (the query-row glue is the default).
OFF_PATH = ("deform_bwd_glue",)
# H100 SXM peaks (NVIDIA's data sheet): bf16 tensor cores, fp32 CUDA cores, HBM3.
BF16_FLOPS, F32_FLOPS, HBM_BYTES = 989e12, 67e12, 3.35e12


def log(*a):
    print(*a, flush=True)


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs only on a CUDA card")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi.splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def as_tuple(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def flash_fwd_bwd(q, k, v, do):
    """One call of the B11 wrapper pair, as the global block's training
    route makes it: forward with lse, then backward."""
    from iuvl_tpu_torch.ops.cuda import flash_attention as fa

    o, lse = fa.flash_attention_fwd(q, k, v)
    return (o, lse, *fa.flash_attention_bwd(q, k, v, o, lse, do))


def flash_fwd_bwd_plain(q, k, v, do):
    from iuvl_tpu_torch.ops.cuda import flash_attention as fa

    o, lse = fa.flash_attention_fwd_plain(q, k, v)
    return (o, lse, *fa.flash_attention_bwd_plain(q, k, v, o, lse, do))


def decode_tail_valid(*args):
    """B16's wrapper with the tokens cut to the valid slots (the pad slots'
    rows are computed but never read)."""
    from iuvl_tpu_torch.ops.cuda import decode_chunk as dc

    tok, masks = dc.decode_tail(*args)
    return tok[:, :args[-1]], masks


RB_GRADS = ("dq", "dk", "dv", "drelh", "drelw")


def relpos_fwd_plain(q, k, v, relh, relw, eh, ew):
    """B14's forward plain version with the wrapper's argument order."""
    from iuvl_tpu_torch.ops.cuda import flash_attention as fa

    return fa.flash_rowbias_fwd_plain(q, k, v, relh, relw, relw.shape[-1], eh, ew)


def relpos_bwd_plain(q, k, v, relh, relw, eh, ew, o, lse, do):
    from iuvl_tpu_torch.ops.cuda import flash_attention as fa

    return fa.flash_rowbias_bwd_plain(q, k, v, relh, relw, o, lse, do, relw.shape[-1], eh, ew)


def _rb_tail_unmasked(a):
    """B2b's / B14's forward with the keys past N in the last 64-key tile
    left unmasked (zero rows scoring 0 with no bias, as an unmasked padded
    tile would): (o, lse) of the plain version."""
    from iuvl_tpu_torch.ops.rel_pos_attention import rowbias_scores

    q, k, v, relh, relw = a[:5]
    eh, ew = (a[5], a[6]) if len(a) == 7 else (None, None)
    s = rowbias_scores(q, k, relh, relw, relw.shape[-1], eh, ew)
    pad = -s.shape[-1] % 64
    s = torch.cat([s, s.new_zeros(*s.shape[:-1], pad)], -1)
    p = torch.softmax(s, -1)[..., :k.shape[-2]].to(v.dtype)
    return p @ v, torch.logsumexp(s, -1)


def _rb_last_row_missed(a):
    """The backward with drelh missing the last key row of the grid: every
    output of the plain version, drelh's last column zero."""
    from iuvl_tpu_torch.ops.cuda import flash_attention as fa

    out = list(fa.flash_rowbias_bwd_plain(*a) if len(a) == 9 else relpos_bwd_plain(*a))
    out[3] = out[3].clone()
    out[3][..., -1] = 0
    return tuple(out)


def _rb_wrong_lse(a):
    """The backward given lse + 0.05."""
    from iuvl_tpu_torch.ops.cuda import flash_attention as fa

    i = 6 if len(a) == 9 else 8  # lse's place in B2b's / B14's arguments
    b = a[:i] + (a[i] + 0.05,) + a[i + 1:]
    return fa.flash_rowbias_bwd_plain(*b) if len(a) == 9 else relpos_bwd_plain(*b)


def rowbias_cases(t, rs, dev):
    """B2b's and B14's cases, forward and backward, at the windowed shape
    (25 windows x 12 heads of N 196, h = w = 14, d 64) and the global one
    (12 heads of N 4096, h = w = 64), as the blocks under 'rowbias' /
    'pallas_rp' hand them: q pre-scaled, relh / relw from rel_pos_features,
    the one-hot expanders in bf16; the backward at the plain forward's o
    and lse with a random cotangent."""
    from iuvl_tpu_torch.ops.cuda import flash_attention as fa
    from iuvl_tpu_torch.ops.rel_pos_attention import (onehot_expanders, rel_pos_features,
                                                      rel_pos_tables)

    cases = []
    for tag, bh, side, iters in (("window", 300, 14, 10), ("global", 12, 64, 3)):
        n, d = side * side, 64
        q, k, v, do = (t(1, bh, n, d) for _ in range(4))
        rh, rw = rel_pos_tables(t(2 * side - 1, d, std=BIAS_STD), t(2 * side - 1, d, std=BIAS_STD),
                                (side, side))
        relh, relw = rel_pos_features(q, rh, rw)
        qs = q * d ** -0.5
        eh, ew = onehot_expanders((side, side), torch.bfloat16, dev)
        o, lse = fa.flash_rowbias_fwd_plain(qs, k, v, relh, relw, side)
        fwd_faults = {"relh dropped": _zero(3), "relw dropped": _zero(4),
                      "heads 0/1 swapped in v": _swap(2, 1, 1)}
        if n % 64:
            fwd_faults["the masked tail tile left unmasked"] = _planted(_rb_tail_unmasked)
        bwd_faults = {"wrong lse (+0.05)": _planted(_rb_wrong_lse),
                      "drelh misses the last grid row": _planted(_rb_last_row_missed),
                      "heads 0/1 swapped in do": _swap(7, 1, 1)}
        rel_bwd_faults = {"wrong lse (+0.05)": _planted(_rb_wrong_lse),
                          "drelh misses the last grid row": _planted(_rb_last_row_missed),
                          "heads 0/1 swapped in do": _swap(9, 1, 1)}
        cases += [
            (f"flash_rowbias_fwd@{tag}", (qs, k, v, relh, relw, side), fwd_faults, iters),
            (f"flash_rowbias_bwd@{tag}", (qs, k, v, relh, relw, o, lse, do, side), bwd_faults,
             iters),
            (f"flash_relpos_fwd@{tag}", (qs, k, v, relh, relw, eh, ew),
             {**fwd_faults, "eh dropped": _zero(5)}, iters),
            (f"flash_relpos_bwd@{tag}", (qs, k, v, relh, relw, eh, ew, o, lse, do),
             rel_bwd_faults, iters)]
    return cases


def kernels():
    """kernel name -> (wrappers whose ``launches`` count it, its call, its
    plain version, output names)."""
    from iuvl_tpu_torch.ops.cuda import decode_chunk as dc
    from iuvl_tpu_torch.ops.cuda import deform_bwd_glue as dg
    from iuvl_tpu_torch.ops.cuda import flash_attention as fa
    from iuvl_tpu_torch.ops.cuda import mask_upscale as mu
    from iuvl_tpu_torch.ops.cuda import mlp_block as mb
    from iuvl_tpu_torch.ops.cuda import msdeform as md
    from iuvl_tpu_torch.ops.cuda import onehot_gather as og
    from iuvl_tpu_torch.ops.cuda import tap_scatter as ts
    from iuvl_tpu_torch.ops.cuda import twoway_attention as ta
    from iuvl_tpu_torch.ops.cuda import window_block as wb

    one = lambda fn, plain, out="out": ((fn,), fn, plain, (out,))  # noqa: E731
    return {
        "window_attention_block": one(wb.window_attention_block,
                                      wb.window_attention_block_plain),
        "flash_attention_rowbias_proj": one(fa.flash_attention_rowbias_proj,
                                            fa.rowbias_proj_plain),
        "block_tail": one(mb.block_tail, mb.block_tail_plain),
        "masks_upscale": one(mu.masks_upscale, mu.masks_upscale_plain),
        "t2i_stream": one(ta.t2i_stream, ta.t2i_stream_plain),
        "i2t_block_step": one(ta.i2t_block_step, ta.i2t_block_step_plain),
        "window_block_backward": ((wb.window_block_backward,), wb.window_block_backward,
                                  wb.window_block_backward_plain,
                                  ("dx", "dwqkv", "dbqkv", "dwo", "dbo", "drh", "drw")),
        "block_tail_backward": ((mb.block_tail_backward,), mb.block_tail_backward,
                                mb.block_tail_backward_plain,
                                ("dxa", "dscale", "dbias", "dw1", "db1", "dw2", "db2")),
        "flash_attention": ((fa.flash_attention_fwd, fa.flash_attention_bwd), flash_fwd_bwd,
                            flash_fwd_bwd_plain, ("o", "lse", "dq", "dk", "dv")),
        "tap_scatter": ((ts.tap_scatter,), ts.tap_scatter, ts.tap_scatter_plain, ("acc",)),
        "ms_deform_level_fwd": one(md.ms_deform_level_fwd, md.ms_deform_level_fwd_plain),
        "deform_gather_rows": one(md.deform_gather_rows, md.deform_gather_rows_plain, "g4"),
        "deform_bwd_glue_q": ((dg.deform_bwd_glue_q,), dg.deform_bwd_glue_q,
                              dg.deform_bwd_glue_plain, ("contrib", "dots")),
        "deform_bwd_glue": ((dg.deform_bwd_glue,), dg.deform_bwd_glue, dg.deform_bwd_glue_plain,
                            ("contrib", "dots")),
        "deform_scatter_dv": one(md.deform_scatter_dv, md.deform_scatter_dv_plain, "dv"),
        "onehot_deform_level_forward": one(og.onehot_deform_level_forward,
                                           og.onehot_deform_level_forward_plain),
        "decode_tail": ((dc.decode_tail,), decode_tail_valid, lambda *a: _tail_plain(a),
                        ("tokens", "masks")),
        "flash_rowbias_fwd": ((fa.flash_rowbias_fwd,), fa.flash_rowbias_fwd,
                              fa.flash_rowbias_fwd_plain, ("o", "lse")),
        "flash_rowbias_bwd": ((fa.flash_rowbias_bwd,), fa.flash_rowbias_bwd,
                              fa.flash_rowbias_bwd_plain, RB_GRADS),
        "flash_relpos_fwd": ((fa.flash_relpos_fwd,), fa.flash_relpos_fwd, relpos_fwd_plain,
                             ("o", "lse")),
        "flash_relpos_bwd": ((fa.flash_relpos_bwd,), fa.flash_relpos_bwd, relpos_bwd_plain,
                             RB_GRADS),
    }


def reset_launches() -> None:
    for wrappers, *_ in kernels().values():
        for fn in wrappers:
            fn.launches = 0


def launches() -> dict:
    return {name: sum(fn.launches for fn in wrappers)
            for name, (wrappers, *_) in kernels().items()}


def _zero(i):
    return lambda a: a[:i] + (torch.zeros_like(a[i]),) + a[i + 1:]


def _swap(i, dim, width):
    """Swap the first two ``width``-wide slices of argument i along dim."""
    def fault(a):
        t = a[i].clone()
        first = t.narrow(dim, 0, width).clone()
        t.narrow(dim, 0, width).copy_(t.narrow(dim, width, width))
        t.narrow(dim, width, width).copy_(first)
        return a[:i] + (t,) + a[i + 1:]
    return fault


def _shift(i, by, hi):
    return lambda a: a[:i] + ((a[i] + by).clamp(max=hi),) + a[i + 1:]


def _zero_cols(i, lo, hi):
    """Columns lo:hi of argument i's last dim zeroed."""
    def fault(a):
        t = a[i].clone()
        t[..., lo:hi] = 0
        return a[:i] + (t,) + a[i + 1:]
    return fault


def _tile_missed(j, i, rows):
    """Output j computed by a reduction that misses the last ``rows`` rows
    of argument i (flattened to rows of its last dim): output j of the
    plain version run on argument i with those rows zeroed, every other
    output sound."""
    def fault(a):
        t = a[i].clone()
        t.view(-1, t.shape[-1])[-rows:] = 0
        return a[:i] + (t,) + a[i + 1:]
    return ("out", j, fault)


def _planted(fn):
    """A fault planted inside the plain version: ``fn(args)`` gives all its
    outputs."""
    return ("calc", fn)


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _wrong_wrap(plain):
    """The plain version with slot 2 read at row offset w - 1 instead of w."""
    from iuvl_tpu_torch.ops.cuda import msdeform as md

    def fault(args):
        with _patched(md, "tap_offsets", lambda w: (0, 1, w - 1, w + 1)):
            return as_tuple(plain(*args))
    return _planted(fault)


def _no_validity(plain):
    """The plain version with every tap weighted as if it lay inside the
    map: the clip shift kept, the zero-padding validity dropped."""
    from iuvl_tpu_torch.ops import msdeform as core

    sound = core.wide_idx_wslot

    def without_validity(h, w, x, y):
        idx, _ = sound(h, w, x, y)
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = x - x0, y - y0
        px, py = x0.clamp(0, w - 1) - x0, y0.clamp(0, h - 1) - y0
        sx = (torch.where(px > 0, fx, 1 - fx), torch.where(px > 0, 0 * fx, fx))
        sy = (torch.where(py > 0, fy, 1 - fy), torch.where(py > 0, 0 * fy, fy))
        return idx, torch.stack([sy[0] * sx[0], sy[0] * sx[1], sy[1] * sx[0], sy[1] * sx[1]],
                                dim=-1)

    def fault(args):
        with _patched(core, "wide_idx_wslot", without_validity):
            return as_tuple(plain(*args))
    return _planted(fault)


def _out_cols_swapped(plain, j):
    """Output j with its columns 0 and 1 swapped, every other output sound."""
    def fault(args):
        outs = list(as_tuple(plain(*args)))
        outs[j] = outs[j][:, [1, 0, 2, 3]]
        return tuple(outs)
    return _planted(fault)


def _onehot_per_point(args):
    """B15's plain version with each point's weight rounded to bf16 on its
    own, before the sum over the points that hit the same cell."""
    v4, idx, wslot, _ = args
    bh, _, d4 = v4.shape
    d = d4 // 4
    table, w = v4.float(), wslot.to(v4.dtype).float()
    heads = torch.arange(bh, device=v4.device)[:, None, None]
    out = torch.zeros((bh, idx.shape[1], d), device=v4.device)
    for s in range(4):
        rows = table[:, :, s * d:(s + 1) * d][heads, idx.long()]  # (BH, Lq, P, d)
        out += (w[:, :, s, :, None] * rows).sum(2)
    return (out.to(v4.dtype),)


def _drop_last_point(a):
    t = a[2].clone()
    t[..., -1] = 0
    return a[:2] + (t,) + a[3:]


def _tail_plain(args, t_valid=None):
    """B16's plain version, its slot mask at ``t_valid`` slots."""
    from iuvl_tpu_torch.ops.cuda import decode_chunk as dc

    tok, masks, _ = dc.decode_tail_plain(*args[:-1], t_valid or args[-1])
    return tok[:, :args[-1]], masks


def _t2i_patched(t2i):
    """B16's plain version with its token -> image attention replaced by
    ``t2i(sound, calls, q, keys, pe_wk, w, heads)``."""
    from iuvl_tpu_torch.ops.cuda import decode_chunk as dc

    def fault(args):
        sound, calls = dc._t2i, []
        with _patched(dc, "_t2i", lambda *a: t2i(sound, calls, *a)):
            return _tail_plain(args)
    return _planted(fault)


def _final_reads_keys1(sound, calls, q, keys, *rest):
    calls.append(keys)
    return sound(q, calls[0], *rest)


def _merge_misses_last_split(sound, calls, q, keys, pe_wk, *rest):
    rows = keys.shape[1] // 8  # the kernel merges 8 partials of N / 8 rows
    return sound(q, keys[:, :-rows], pe_wk[:-rows], *rest)


def _i2t1_k_heads_swapped(a):
    w = dict(a[4])
    site = dict(w["i2t1"])
    for k in ("kw", "kb"):
        site[k] = site[k].clone()
        site[k][:16], site[k][16:32] = a[4]["i2t1"][k][16:32], a[4]["i2t1"][k][:16]
    w["i2t1"] = site
    return a[:4] + (w,) + a[5:]


def decode_tail_case(rs: np.random.RandomState, dev):
    """B16's arguments at the chunk serving shape: CHUNK prompts of 7 tokens
    (5 output tokens, the point and the pad point) in 16 slots over the
    ViT-B 64^2 embedding; the decoder's weights as build_sam draws them,
    its LayerNorms' scales and biases perturbed."""
    from iuvl_tpu_torch.models.sam.build import init_random_
    from iuvl_tpu_torch.models.sam.mask_decoder import MaskDecoder

    dec = MaskDecoder(dtype=torch.bfloat16, twoway_impl="chunk")
    init_random_(dec, torch.Generator().manual_seed(SEED + 5))
    with torch.no_grad():
        for mod in dec.modules():
            if isinstance(mod, torch.nn.LayerNorm):
                mod.weight.add_(torch.from_numpy(rs.randn(256).astype(np.float32) * 0.1))
                mod.bias.copy_(torch.from_numpy(rs.randn(256).astype(np.float32) * BIAS_STD))
    dec = dec.to(dev)
    tv = 7
    tok = torch.zeros(2, CHUNK, 16, 256)
    tok[:, :, :tv] = torch.from_numpy(rs.randn(2, CHUNK, tv, 256).astype(np.float32))
    tok[1] *= 0.5
    image = torch.from_numpy(rs.randn(2, 1, 64 * 64, 256).astype(np.float32))
    image[1] *= 0.5
    bf = torch.bfloat16
    return (tok[0].to(dev, bf), tok[1].to(dev, bf), image[0].to(dev, bf), image[1].to(dev, bf),
            dec.tail_weights(), 8, tv)


def kernel_cases(rs: np.random.RandomState, dev):
    """(name, args, planted faults {name: args -> args, or ("out", j)},
    timing iters) at the path shapes, with the weight layouts the models
    hand the kernels."""
    from iuvl_tpu_torch.models.xdecoder.pixel_decoder import encoder_reference_points
    from iuvl_tpu_torch.ops.cuda import deform_bwd_glue as dg
    from iuvl_tpu_torch.ops.cuda import msdeform as md
    from iuvl_tpu_torch.ops.cuda.mask_upscale import flat_deconv
    from iuvl_tpu_torch.ops.msdeform import wide_idx_wslot, wide_map
    from iuvl_tpu_torch.ops.point_sample import _tap_weights
    from iuvl_tpu_torch.ops.rel_pos_attention import (augment_qk_rel_pos, rel_pos_features,
                                                      rel_pos_tables)

    bf, f32 = torch.bfloat16, torch.float32

    def t(*shape, std=1.0, dtype=bf):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32) * std).to(dev, dtype)

    c, heads, d, n, s = 768, 12, 64, 4096, BIAS_STD
    rh, rw = rel_pos_tables(t(27, d, std=s), t(27, d, std=s), (14, 14))
    win = (t(25, 196, c), t(3 * c, c, std=c ** -0.5), t(3 * c, std=s, dtype=f32),
           t(c, c, std=c ** -0.5), t(c, std=s, dtype=f32), rh, rw, heads)
    q, k, v = (t(1, heads, n, d) for _ in range(3))
    grh, grw = rel_pos_tables(t(127, d, std=s), t(127, d, std=s), (64, 64))
    relh, relw = rel_pos_features(q, grh, grw)
    flash = (q * d ** -0.5, k, v, relh, relw, t(c, c, std=c ** -0.5), t(c, std=s, dtype=f32),
             64)
    tail = (t(n, c), t(n, c), 1.0 + t(c, std=0.1, dtype=f32), t(c, std=s, dtype=f32),
            t(4 * c, c, std=c ** -0.5), t(4 * c, std=s), t(4 * c, c, std=(4 * c) ** -0.5),
            t(c, std=s))
    up = (t(CHUNK, n, 256), flat_deconv(t(256, 64, 2, 2, std=1 / 16)), t(64, std=s),
          1.0 + t(64, std=0.1, dtype=f32), t(64, std=s, dtype=f32),
          flat_deconv(t(64, 32, 2, 2, std=1 / 8 / 2 ** 0.5)), t(32, std=s),
          t(CHUNK, 4, 32, std=0.3))
    tok, i_dim, cd = 7, 128, 256  # decoder: 7 tokens a prompt, 8 heads of 16
    t2i = (t(CHUNK, tok, i_dim, std=0.25), t(CHUNK, n, cd), t(n, i_dim, std=s),
           t(i_dim, cd, std=cd ** -0.5), t(i_dim, std=s), t(i_dim, cd, std=cd ** -0.5),
           t(i_dim, std=s), 8)
    i2t = (t(CHUNK, n, cd), t(n, i_dim, std=s), t(CHUNK, tok, i_dim), t(CHUNK, tok, i_dim),
           t(i_dim, cd, std=cd ** -0.5), t(i_dim, std=s), t(cd, i_dim, std=i_dim ** -0.5),
           t(cd, std=s), 1.0 + t(cd, std=0.1, dtype=f32), t(cd, std=s, dtype=f32), 8)
    # Training shapes: the windowed blocks' backward (B9) and the tails' (B10);
    # B11 on the rel-pos-augmented q, k of a global block; B12 on the
    # criterion's 20 matched 256^2 masks at 12544 points.
    win_bwd = (win[0], t(25, 196, c), win[1], win[2], win[3], rh, rw, heads)
    tail_bwd = tail[:2] + (t(n, c),) + tail[2:7]
    q_aug, k_aug = augment_qk_rel_pos(q, k, grh, grw)
    flash_train = (q_aug, k_aug, v, t(1, heads, n, d))
    coords = torch.from_numpy(rs.rand(N_TARGETS, MATCH_POINTS, 2).astype(np.float32)).to(dev)
    base, wgts, _, span = _tap_weights(256, 256, coords, f32)
    scatter = (base.to(torch.int32).contiguous(),
               (t(N_TARGETS, MATCH_POINTS, 1, dtype=f32) * wgts).contiguous(), span)
    # B7 and B8 at the res3 level (128^2) of the batch-2 train step: 8 heads
    # of 64, the 21504 queries of all three levels x 4 points, sampling within
    # a few pixels of their reference points (as the compass-grid offsets do);
    # the per-image kernels on image 0.
    nh, side, pts = 8, 128, 4
    ref = encoder_reference_points([(32, 32), (64, 64), (128, 128)], dev)[:, 0]  # (Lq, 2)
    lq = ref.shape[0]
    jitter = torch.from_numpy(rs.randn(2, nh, lq, pts, 2).astype(np.float32) * 2.5).to(dev)
    xy = ref[None, None, :, None, :] * side - 0.5 + jitter  # pixel coordinates
    x, y = xy[..., 0].contiguous(), xy[..., 1].contiguous()
    aw = torch.from_numpy(rs.rand(2, nh, lq, pts).astype(np.float32) / 12).to(dev)
    v = t(2, nh, side * side, d)
    deform_fwd = (v, x, y, aw, side, side)
    idx, wslot = wide_idx_wslot(side, side, x[0], y[0])
    gather = (v[0], idx, side)
    glue = (md.deform_gather_rows_plain(*gather), t(nh * lq, d, dtype=f32),
            (wslot * aw[0][..., None]).reshape(-1, 4).contiguous(), pts)
    scatter_dv = (dg.deform_bwd_glue_plain(*glue)[0], idx, side * side, side)
    glue_faults = {"dots slots 0/1 swapped": _out_cols_swapped(dg.deform_bwd_glue_plain, 1),
                   "contrib to the wrong slot (wa slots 0/1 swapped)": _swap(2, 1, 1)}
    # B15 at the res5 level (32^2) of the hybrid eval: the same heads, queries
    # and points, sampling around the reference points; the kernel's inputs
    # as the hybrid level makes them (the wide map, the clipped top-left
    # cells, the slot weights times the attention weight).
    side5 = 32
    jitter5 = torch.from_numpy(rs.randn(nh, lq, pts, 2).astype(np.float32) * 2.5).to(dev)
    xy5 = ref[None, :, None, :] * side5 - 0.5 + jitter5
    idx5, wslot5 = wide_idx_wslot(side5, side5, xy5[..., 0], xy5[..., 1])
    aw5 = torch.from_numpy(rs.rand(nh, lq, pts).astype(np.float32) / 12).to(dev)
    v5 = t(1, nh, side5 * side5, d)
    onehot = (wide_map(v5, side5).reshape(nh, side5 * side5, 4 * d), idx5.contiguous(),
              (wslot5 * aw5[..., None]).transpose(-1, -2).contiguous(), pts)
    same = idx5[..., :, None] == idx5[..., None, :]
    log(f"kernel onehot_deform_level_forward: {int(torch.tril(same, -1).any(-1).any(-1).sum())} "
        f"of {nh * lq} rows have points that share a cell")
    return [
        ("decode_tail", decode_tail_case(rs, dev),
         {"slot mask dropped": _planted(lambda a: _tail_plain(a, t_valid=16)),
          "heads 0/1 swapped in i2t1's token-side k": _i2t1_k_heads_swapped,
          "the final attention reads keys1": _t2i_patched(_final_reads_keys1),
          "a t2i merge misses its last split (N/8 rows)": _t2i_patched(_merge_misses_last_split)},
         5),
        ("window_attention_block", win,
         {"bqkv dropped": _zero(2), "bo dropped": _zero(4), "rel_pos_h dropped": _zero(5),
          "rel_pos_w dropped": _zero(6), "heads 0/1 swapped in wo": _swap(3, 1, d)}, 10),
        ("flash_attention_rowbias_proj", flash,
         {"bo dropped": _zero(6), "relh dropped": _zero(3), "relw dropped": _zero(4),
          "heads 0/1 swapped in v": _swap(2, 1, 1)}, 10),
        ("block_tail", tail,
         {"b1 dropped": _zero(5), "b2 dropped": _zero(7), "LN bias dropped": _zero(3)}, 10),
        ("masks_upscale", up,
         {"b1 dropped": _zero(2), "b2 dropped": _zero(6), "LN bias dropped": _zero(4),
          "mask tokens 0/1 swapped": _swap(7, 1, 1)}, 5),
        # (bk adds q.bk to every key's score alike: softmax cancels it.)
        ("t2i_stream", t2i,
         {"bv dropped": _zero(6), "pe_wk dropped": _zero(2),
          "heads 0/1 swapped in q": _swap(0, 2, 16)}, 10),
        ("i2t_block_step", i2t,
         {"bq dropped": _zero(5), "bo dropped": _zero(7), "pe_wq dropped": _zero(1),
          "LN bias dropped": _zero(9), "heads 0/1 swapped in kp": _swap(2, 2, 16)}, 10),
        ("window_block_backward", win_bwd,
         {"rel-pos branch dropped": lambda a: a[:5] + (torch.zeros_like(rh),
                                                        torch.zeros_like(rw)) + a[7:],
          "bqkv dropped": _zero(3), "dbo misses the last 16 rows": _tile_missed(4, 1, 16),
          "heads 0/1 swapped in g": _swap(1, 2, d)}, 5),
        ("block_tail_backward", tail_bwd,
         {"db2 misses the last 16 rows": _tile_missed(6, 2, 16), "LN bias dropped": _zero(4),
          "b1 dropped": _zero(6), "dscale misses the last 16 rows": _tile_missed(1, 2, 16)},
         5),
        ("flash_attention", flash_train,
         {"wrong lse (+0.05)": "lse", "heads 0/1 swapped in do": _swap(3, 1, 1),
          "heads 0/1 swapped in v": _swap(2, 1, 1),
          "relh dropped from q_aug": _zero_cols(0, d, 2 * d)}, 3),
        ("tap_scatter", scatter,
         {"rows one cell off": _shift(0, 1, span - 1), "taps 0/1 swapped": _swap(1, 2, 1)},
         10),
        ("ms_deform_level_fwd", deform_fwd,
         {"slot 2 at offset w - 1": _wrong_wrap(md.ms_deform_level_fwd_plain),
          "validity mask dropped": _no_validity(md.ms_deform_level_fwd_plain)}, 10),
        ("deform_gather_rows", gather,
         {"slot 2 at offset w - 1": _wrong_wrap(md.deform_gather_rows_plain),
          "heads 0/1 swapped in v": _swap(0, 0, 1)}, 10),
        ("deform_bwd_glue_q", glue, glue_faults, 10),
        ("deform_bwd_glue", glue, glue_faults, 10),
        ("deform_scatter_dv", scatter_dv,
         {"misses the last 16 rows": _tile_missed(0, 0, 16),
          "slot 2 at offset w - 1": _wrong_wrap(md.deform_scatter_dv_plain)}, 10),
        ("onehot_deform_level_forward", onehot,
         {"slot s read from slot s+1's columns": lambda a: (torch.roll(a[0], -d, dims=-1),)
          + a[1:],
          "the last point dropped": _drop_last_point,
          "idx one cell off": _shift(1, 1, side5 * side5 - 1),
          "weights rounded per point, not per cell": _planted(_onehot_per_point)}, 20),
    ] + rowbias_cases(t, rs, dev)


def _fp32(a):
    """a with each floating-point tensor in it (in dicts and tuples too) in fp32."""
    if torch.is_tensor(a):
        return a.float() if a.is_floating_point() else a
    if isinstance(a, dict):
        return {k: _fp32(v) for k, v in a.items()}
    if isinstance(a, (tuple, list)):
        return type(a)(_fp32(v) for v in a)
    return a


def _tensors(a):
    """Every tensor in a (nested dicts, tuples, lists)."""
    if torch.is_tensor(a):
        yield a
    elif isinstance(a, dict):
        for v in a.values():
            yield from _tensors(v)
    elif isinstance(a, (tuple, list)):
        for v in a:
            yield from _tensors(v)


def work(name: str, args, outs) -> tuple[float, float, str]:
    """(flops, bytes, flops' rate) of one call: the least work of the
    function on these inputs, each product it needs done once, and the
    bytes it must move, each tensor argument read once and each output
    written once. A backward recomputes what its arguments do not hold:
    B9 and B10 are handed no activations, B11 is handed o and lse, so its
    backward needs s once (p from lse), dp, dq, dk and dv."""
    nbytes = sum(a.numel() * a.element_size() for a in _tensors((args, outs)))
    if name == "decode_tail":
        # Per prompt: the seven N x C x I keys-side projections (i2t0's
        # out-projection, t2i1's k and v, i2t1's q and out-projection, the
        # final attention's k and v), the deconvs, the contraction, and the
        # four attentions' two products each at the valid slots; the token
        # side (block 1's self-attention, t2i1's q and out-projection, the
        # MLP, i2t1's k and v, the final q and out-projection, i2t0's k and v)
        # and the hypernetwork. Once a call: the shared q-projection of
        # keys0 and key_pe and the three PE projections.
        t, _, keys0, _, w, _, tv = args
        b, c, n = t.shape[0], t.shape[2], keys0.shape[1]
        i, mlp = w["i2t0"]["qw"].shape[0], w["mlp1"][0].shape[0]
        c4, c8, m = w["up"][1].shape[0], w["up"][5].shape[0], w["hyper"][0][0].shape[0]
        rows = n * (7 * c * i + c * 4 * c4 + 4 * c4 * 4 * c8 + 16 * c8 * m + 8 * tv * i)
        tokens = tv * (4 * c * c + 2 * tv * c + 6 * c * i + 2 * c * mlp + 3 * c * i) \
            + m * (2 * c * c + c * c8)
        flops = 2 * b * (rows + tokens) + 2 * 5 * n * c * i
        nbytes = sum(a.numel() * a.element_size() for a in _tensors((args[:2], outs))) \
            + keys0.numel() * keys0.element_size() * 2 \
            + sum(a.numel() * a.element_size() for a in _tensors(w))
    elif name == "window_attention_block":
        nw, n, c = args[0].shape
        flops = nw * (2 * n * c * 3 * c + 4 * n * n * c + 2 * n * c * c
                      + 4 * n * c * args[5].shape[0])
    elif name == "flash_attention_rowbias_proj":
        b, h, n, d = args[0].shape
        flops = 4 * b * h * n * n * d + 2 * b * n * h * d * args[5].shape[0]
    elif name == "block_tail":
        flops = 4 * args[0].shape[0] * args[0].shape[1] * args[4].shape[0]
    elif name == "masks_upscale":
        p, n, c = args[0].shape
        flops = (2 * p * n * c * args[1].shape[1] + 2 * p * 4 * n * args[5].numel()
                 + 2 * p * 16 * n * args[7].shape[1] * args[7].shape[2])
    elif name == "t2i_stream":
        p, tok, i = args[0].shape
        pk, n, cd = args[1].shape
        flops = 4 * pk * n * cd * i + 4 * p * tok * n * i
    elif name == "i2t_block_step":
        p, n, cd = args[0].shape
        tok, i = args[2].shape[1:]
        flops = 4 * p * n * cd * i + 4 * p * n * tok * i
    elif name == "window_block_backward":
        nw, n, c = args[0].shape
        flops = 22 * nw * n * c * c + 12 * nw * n * n * c
    elif name == "block_tail_backward":
        flops = 10 * args[0].shape[0] * args[0].shape[1] * args[5].shape[0]
    elif name == "flash_attention":
        b, h, n, dqk = args[0].shape
        dv = args[2].shape[-1]
        flops = b * h * 2 * n * n * ((dqk + dv) + (3 * dqk + 2 * dv))
    elif name.startswith(("flash_rowbias", "flash_relpos")):
        # Forward: q k^T and p v, 4 N^2 d a head; backward: s once from the
        # lse, dp, dq, dk, dv, 10 N^2 d. B14's expander products add 2 N^2
        # (h + w) to s (and as much again for the bias cotangents).
        b, h, n, d = args[0].shape
        hw = args[3].shape[-1] + args[4].shape[-1]
        fwd = name.endswith("_fwd")
        flops = b * h * n * n * (4 * d if fwd else 10 * d)
        if name.startswith("flash_relpos"):
            flops += b * h * n * n * hw * (2 if fwd else 4)
    elif name == "tap_scatter":  # 4 fp32 adds a row
        return 4 * args[0].numel(), nbytes, F32_FLOPS
    elif name == "ms_deform_level_fwd":  # a multiply-add per tap and channel (fp32)
        return 2 * args[1].numel() * 4 * args[0].shape[-1], nbytes, F32_FLOPS
    elif name == "deform_gather_rows":  # a copy
        return 0, nbytes, F32_FLOPS
    elif name == "deform_scatter_dv":  # an fp32 add per element of contrib
        return args[0].numel(), nbytes, F32_FLOPS
    elif name == "onehot_deform_level_forward":
        # A multiply-add per channel for each slot and distinct cell of a row
        # whose merged weight is not 0 after rounding (what these inputs need).
        v4, idx, wslot, _ = args
        same = idx[..., :, None] == idx[..., None, :]  # (BH, Lq, P, P)
        first = ~torch.tril(same, -1).any(-1)
        merged = torch.einsum("bqpj,bqsj->bqsp", same.float(), wslot).to(v4.dtype)
        hits = int((first[:, :, None, :] & (merged != 0)).sum())
        return 2 * hits * (v4.shape[-1] // 4), nbytes, F32_FLOPS
    else:  # B8: per element of g4 a multiply-add (dots) and a multiply (contrib)
        return 3 * args[0].numel(), nbytes, F32_FLOPS
    return flops, nbytes, BF16_FLOPS


def library_call(name: str, args):
    """The one PyTorch call that computes the same function, where one
    exists (timed only): SDPA forward + backward for B11, ``index_add_``
    for B12. None for the rest: no single call fuses their projections,
    rel-pos terms, norms or backward."""
    if name == "flash_attention":
        q, k, v, do = (a.detach().requires_grad_(i < 3) for i, a in enumerate(args))

        def call():
            q.grad = k.grad = v.grad = None
            with torch.enable_grad():
                torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=1.0).backward(do)
        return call
    if name.startswith(("flash_rowbias", "flash_relpos")):
        # SDPA on the materialised (BH, N, N) bias: forward, or forward +
        # backward with the wrapper's cotangent.
        relpos = name.startswith("flash_relpos")
        q, k, v, relh, relw = args[:5]
        if relpos:
            bias = relh.float() @ args[5].float() + relw.float() @ args[6].float()
        else:
            w, n = relw.shape[-1], k.shape[-2]
            bias = relh.float().repeat_interleave(w, -1) + relw.float().repeat(1, 1, 1, n // w)
        bias = bias.to(q.dtype)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        if name.endswith("_fwd"):
            return lambda: sdpa(q, k, v, attn_mask=bias, scale=1.0)
        do = args[9 if relpos else 7]
        q, k, v = (a.detach().requires_grad_() for a in (q, k, v))

        def call():
            q.grad = k.grad = v.grad = None
            with torch.enable_grad():
                sdpa(q, k, v, attn_mask=bias, scale=1.0).backward(do)
        return call
    if name == "tap_scatter":
        base, rows, span = args
        n = base.shape[0]
        idx = (base.long() + torch.arange(n, device=base.device)[:, None] * span).reshape(-1)
        flat = rows.reshape(-1, 4)
        return lambda: torch.zeros((n * span, 4), device=rows.device).index_add_(0, idx, flat)
    if name == "onehot_deform_level_forward":
        # embedding_bag over the wide map's (cell, slot) rows, 4P rows a
        # query, each weighted: the same sums, the weights rounded to bf16
        # per point instead of per cell.
        v4, idx, wslot, p = args
        bh, cells, d4 = v4.shape
        table = v4.reshape(bh * cells * 4, d4 // 4)
        heads = torch.arange(bh, device=idx.device).view(bh, 1, 1, 1)
        slots = torch.arange(4, device=idx.device).view(1, 1, 4, 1)
        rows = ((heads * cells + idx.long()[:, :, None]) * 4 + slots).reshape(-1, 4 * p)
        wts = wslot.reshape(-1, 4 * p).to(v4.dtype)
        return lambda: torch.nn.functional.embedding_bag(rows, table, per_sample_weights=wts,
                                                         mode="sum")
    if name in ("deform_gather_rows", "deform_scatter_dv"):
        # The JAX formulation's calls on a prebuilt (nh * hw, 4d) wide map, its
        # build and the fold not timed: index_select for the gather,
        # index_add_ of the fp32 rows for the scatter.
        idx, w = args[1], args[-1]
        nh = idx.shape[0]
        hw = args[0].shape[1] if name == "deform_gather_rows" else args[2]
        rows = (torch.arange(nh, device=idx.device).view(nh, 1, 1) * hw + idx.long()).reshape(-1)
        if name == "deform_gather_rows":
            v = args[0]
            wide = torch.cat([torch.roll(v, -off, dims=1) for off in (0, 1, w, w + 1)],
                             dim=-1).reshape(nh * hw, -1)
            return lambda: wide.index_select(0, rows)
        src = args[0].float()
        return lambda: torch.zeros((nh * hw, src.shape[1]), device=src.device).index_add_(
            0, rows, src)
    return None


def kernel_phase(dev) -> list[dict]:
    """Checks every kernel and prints every reading, then raises if any
    check failed."""
    rows, failed = [], []
    table = kernels()
    glue_outs = {}
    for name, args, faults, iters in kernel_cases(np.random.RandomState(SEED), dev):
        base, _, shape = name.partition("@")  # a kernel checked at two shapes: name@shape
        _, kern, plain, names = table[base]
        bounds = KERNEL_BOUNDS[base]
        out = as_tuple(kern(*args))
        torch.cuda.synchronize()
        if name.startswith("deform_bwd_glue"):
            glue_outs[name] = out
        ref = as_tuple(plain(*args))
        torch.cuda.synchronize()
        for o, r, oname in zip(out, ref, names):
            if o.shape != r.shape or not bool(torch.isfinite(o).all()):
                raise RuntimeError(f"{name} {oname}: shape {tuple(o.shape)} vs "
                                   f"{tuple(r.shape)} or non-finite output")
        errs = {o_n: rel_l2(o, r) for o, r, o_n in zip(out, ref, names)}
        max_abs = max(float((o.float() - r.float()).abs().max()) for o, r in zip(out, ref))
        # Both bf16 results against the plain version in fp32 on the same
        # (bf16-valued) inputs: how far bf16 alone moves the result.
        ref32 = as_tuple(plain(*[_fp32(a) for a in args]))
        log(f"kernel {name}: vs fp32 plain: kernel rel_l2 "
            + ", ".join(f"{o_n} {rel_l2(o, r):.3e}" for o, r, o_n in zip(out, ref32, names))
            + "; bf16 plain rel_l2 "
            + ", ".join(f"{o_n} {rel_l2(o, r):.3e}" for o, r, o_n in zip(ref, ref32, names)))
        del ref32
        fault_errs = {}
        for fault, plant in faults.items():
            if plant == "lse":  # B11: the backward given a wrong lse
                from iuvl_tpu_torch.ops.cuda import flash_attention as fa

                o, lse = fa.flash_attention_fwd_plain(*args[:3])
                planted = (o, lse + 0.05, *fa.flash_attention_bwd_plain(*args[:3], o,
                                                                        lse + 0.05, args[3]))
            elif isinstance(plant, tuple) and plant[0] == "calc":
                planted = plant[1](args)
            elif isinstance(plant, tuple):
                _, j, move = plant
                planted = ref[:j] + (as_tuple(plain(*move(args)))[j],) + ref[j + 1:]
            else:
                planted = as_tuple(plain(*plant(args)))
            fault_errs[fault] = {o_n: rel_l2(p, r) for p, r, o_n in zip(planted, ref, names)}
        log(f"kernel {name}: planted faults (plain version) rel_l2 " + "; ".join(
            f"{f}: " + ", ".join(f"{o_n} {e:.3e}" for o_n, e in es.items())
            for f, es in fault_errs.items()))
        ms = cuda_ms(lambda: kern(*args), iters)
        plain_ms = cuda_ms(lambda: plain(*args), iters)
        lib = library_call(base, args)
        library_ms = cuda_ms(lib, iters) if lib is not None else None
        del lib
        flops, nbytes, rate = work(base, args, out)
        t_ops, t_bytes = flops / rate * 1e3, nbytes / HBM_BYTES * 1e3
        log(f"kernel {name}: rel_l2 " + ", ".join(f"{o_n} {e:.3e} (bound {bounds[o_n]:g})"
                                                  for o_n, e in errs.items())
            + f"; max_abs {max_abs:.3e}; kernel {ms:.4f} ms plain {plain_ms:.4f} ms library "
            f"{library_ms if library_ms is None else round(library_ms, 4)} ms; "
            f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB")
        over = {o_n: e for o_n, e in errs.items() if not e <= bounds[o_n]}
        if over:
            failed.append(f"{name}: rel L2 {over} over its bounds {bounds}")
        weak = [f for f, es in fault_errs.items()
                if not any(e > bounds[o_n] for o_n, e in es.items())]
        if weak:
            failed.append(f"{name}: bounds {bounds} would not catch {weak}")
        untested = [o_n for o_n in names
                    if not any(es[o_n] > bounds[o_n] for es in fault_errs.values())]
        if untested:
            failed.append(f"{name}: no planted fault reads above the bound of {untested}")
        source, replaces = SOURCES[base]
        rows.append(dict(name=base, route="cuda", source="iuvl_tpu_torch/csrc/" + source,
                         replaces=replaces, max_abs_err=max_abs, ms=ms,
                         plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
                         bound_by="operations" if t_ops >= t_bytes else "bytes",
                         library_ms=library_ms, **({"shape": shape} if shape else {})))
    same = all(torch.equal(a, b) for a, b in zip(glue_outs["deform_bwd_glue_q"],
                                                 glue_outs["deform_bwd_glue"]))
    log(f"kernel deform_bwd_glue_q and deform_bwd_glue on the same inputs: identical {same}")
    if not same:
        failed.append("deform_bwd_glue_q and deform_bwd_glue differ")
    if failed:
        raise RuntimeError("kernel checks failed: " + "; ".join(failed))
    return rows


def grad_switch_phase(dev) -> None:
    """The global block's two routes on the same inputs: the training route
    (autograd records it: augmented q, k, B11, projection in PyTorch)
    against the serving route (B2), as one forward."""
    from iuvl_tpu_torch.ops.cuda import flash_attention as fa
    from iuvl_tpu_torch.ops.rel_pos_attention import rel_pos_attention_proj, rel_pos_tables

    rs = np.random.RandomState(SEED + 4)
    t = lambda *s, std=1.0, dtype=torch.bfloat16: torch.from_numpy(  # noqa: E731
        rs.randn(*s).astype(np.float32) * std).to(dev, dtype)
    q, k, v = (t(1, 12, 4096, 64) for _ in range(3))
    rh, rw = rel_pos_tables(t(127, 64, std=BIAS_STD), t(127, 64, std=BIAS_STD), (64, 64))
    wo, bo = t(768, 768, std=768 ** -0.5), t(768, std=BIAS_STD, dtype=torch.float32)
    reset_launches()
    with torch.no_grad():
        serve = rel_pos_attention_proj(q, k, v, rh, rw, wo, bo)
    counts_serve = launches()
    with torch.enable_grad():
        train = rel_pos_attention_proj(q.requires_grad_(), k, v, rh, rw, wo, bo)
    counts = launches()
    torch.cuda.synchronize()
    err = rel_l2(train.detach(), serve)
    log(f"grad switch: training route vs serving route rel_l2 {err:.3e} "
        f"(bound {GRAD_SWITCH_BOUND:g}); B2 launches {counts_serve['flash_attention_rowbias_proj']}"
        f" then {counts['flash_attention_rowbias_proj']}, B11 forward "
        f"{fa.flash_attention_fwd.launches}")
    if not (counts_serve["flash_attention_rowbias_proj"] == 1 and counts["flash_attention"] == 1
            and counts["flash_attention_rowbias_proj"] == 1):
        raise RuntimeError(f"grad switch: routes not taken as expected: {counts}")
    if not err <= GRAD_SWITCH_BOUND:
        raise RuntimeError(f"grad switch: rel L2 {err} over {GRAD_SWITCH_BOUND}")


def serve(model, image, points, labels):
    """One request: encode once, decode the prompts in chunks. Returns the
    masks and (encode_s, [decode_s per chunk]) on the host clock."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb, _ = model.encode_image(model.normalize(image), return_fpn=False)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    masks, decode_s = [], []
    for i in range(0, points.shape[0], CHUNK):
        t0 = time.perf_counter()
        out = model.decode_from_embedding(emb, points[i:i + CHUNK], labels[i:i + CHUNK],
                                          return_upscaled=False)
        torch.cuda.synchronize()
        decode_s.append(time.perf_counter() - t0)
        masks.append(out["masks"])
    return torch.cat(masks), encode_s, decode_s


def mask_iou(a: torch.Tensor, b: torch.Tensor) -> tuple[float, int]:
    pa, pb = (a > 0).flatten(2), (b > 0).flatten(2)
    inter = (pa & pb).sum(-1).float()
    union = (pa | pb).sum(-1).float()
    keep = union > 0
    return float((inter[keep] / union[keep]).mean()), int(keep.sum())


def serving_phase(dev) -> dict:
    from iuvl_tpu_torch.models.sam import build_sam, sam_model_registry

    per_request = {"window_attention_block": 8, "flash_attention_rowbias_proj": 4,
                   "block_tail": 12, "masks_upscale": N_PROMPTS // CHUNK,
                   "t2i_stream": 3 * N_PROMPTS // CHUNK, "i2t_block_step": 2 * N_PROMPTS // CHUNK}
    gen = torch.Generator().manual_seed(SEED)
    model = sam_model_registry["vit_b"](dtype="bfloat16", device=dev, generator=gen).eval()
    plain = {}
    for dtype in ("bfloat16", "float32"):
        plain[dtype] = build_sam("vit_b", dtype=dtype, attn_impl="plain", twoway_impl="plain",
                                 device=dev).eval()
        plain[dtype].load_state_dict(model.state_dict())
    # The whole-chunk decode (B16) on the same weights: kernels, plain bf16, plain fp32.
    chunk = {}
    for path, (attn, twoway, dtype) in CHUNK_PATHS.items():
        chunk[path] = build_sam("vit_b", dtype=dtype, attn_impl=attn, twoway_impl=twoway,
                                device=dev).eval()
        chunk[path].load_state_dict(model.state_dict())
    rs = np.random.RandomState(SEED + 1)
    totals = {k: 0 for k in per_request}
    timing = {"kernels": [], "plain": [], "chunk": [], "chunk_plain": []}
    with torch.inference_mode():
        for r in range(REQUESTS):
            image, points, labels = request(r, model, plain, rs, dev, per_request, totals,
                                            timing)
            chunk_request(r, chunk, image, points, labels, totals, timing)
        many_tokens_request(model, plain, chunk, rs, dev, totals)
    del chunk
    torch.cuda.empty_cache()
    # JAX's unfused encoder route with every block's attention in B2b / B14
    # (the same weights), the per-op decode; gated against the plain paths,
    # whose rounding points are those of this route.
    for impl, fwd in IMPL_FWD.items():
        unfused = build_sam("vit_b", dtype="bfloat16", attn_impl=impl, device=dev).eval()
        unfused.load_state_dict(model.state_dict())
        want = {**DECODE_PER_REQUEST, fwd: 12}
        rs_i = np.random.RandomState(SEED + 1)
        timing[impl], timing[f"plain ({impl} requests)"] = [], []
        with torch.inference_mode():
            for r in range(REQUESTS):
                request(r, unfused, plain, rs_i, dev, want, totals, timing, label=impl)
        del unfused
    for path, runs in timing.items():  # steady state: requests after the first
        enc = float(np.mean([e for e, _ in runs[1:]]))
        dec = float(np.mean([np.mean(d) for _, d in runs[1:]]))
        per_image = enc + dec * (N_PROMPTS // CHUNK)
        log(f"serving {path} (mean of requests 1..{REQUESTS - 1}): encode {enc * 1e3:.2f} ms, "
            f"{dec * 1e3:.2f} ms per {CHUNK}-prompt chunk, {N_PROMPTS / per_image:.1f} masks/s")
    del model, plain
    torch.cuda.empty_cache()
    return totals


# The per-op decode's launches a request (B6 once a chunk, B4 three times,
# B5 twice), and the forward kernel of each unfused impl (one a block).
DECODE_PER_REQUEST = {"masks_upscale": N_PROMPTS // CHUNK, "t2i_stream": 3 * N_PROMPTS // CHUNK,
                      "i2t_block_step": 2 * N_PROMPTS // CHUNK}
IMPL_FWD = {"rowbias": "flash_rowbias_fwd", "pallas_rp": "flash_relpos_fwd"}
IMPL_BWD = {"rowbias": "flash_rowbias_bwd", "pallas_rp": "flash_relpos_bwd"}
ENCODE_PER_REQUEST = {"window_attention_block": 8, "flash_attention_rowbias_proj": 4,
                      "block_tail": 12}
MANY_POINTS = 20  # a click loop's prompt: 20 points + the pad point + 5 output tokens = 26


def many_tokens_request(model, plain, chunk, rs, dev, totals) -> None:
    """One request of CHUNK prompts of MANY_POINTS points each (26 tokens)
    through the per-op decode ('auto': B4 and B5 at T 26) and through the
    whole-chunk decode ('chunk': B16 at Tp 32), each gated against its own
    plain bf16 path's distance from fp32."""
    image = torch.from_numpy(rs.rand(1, 1024, 1024, 3).astype(np.float32) * 255).to(dev)
    points = torch.from_numpy(rs.rand(CHUNK, MANY_POINTS, 2).astype(np.float32) * 1024).to(dev)
    labels = torch.from_numpy(rs.randint(0, 2, (CHUNK, MANY_POINTS)).astype(np.int32)).to(dev)
    for name, kern, ref_bf16, ref_32, want in (
            ("auto", model, plain["bfloat16"], plain["float32"],
             {**ENCODE_PER_REQUEST, "masks_upscale": 1, "t2i_stream": 3, "i2t_block_step": 2}),
            ("chunk", chunk["chunk"], chunk["chunk_plain_bf16"], chunk["chunk_plain_fp32"],
             {**ENCODE_PER_REQUEST, "decode_tail": 1})):
        reset_launches()
        masks_k, enc, dec = serve(kern, image, points, labels)
        counts = launches()
        check_launches(f"{MANY_POINTS}-point request {name}", counts, want)
        for k, got in counts.items():
            totals[k] = totals.get(k, 0) + got
        if tuple(masks_k.shape) != (CHUNK, 4, 256, 256) or not bool(torch.isfinite(masks_k).all()):
            raise RuntimeError(f"{MANY_POINTS}-point request {name}: masks "
                               f"{tuple(masks_k.shape)} or not finite")
        masks_p = serve(ref_bf16, image, points, labels)[0]
        masks_32 = serve(ref_32, image, points, labels)[0]
        chunk_masks_gate(f"{MANY_POINTS}-point request {name} ({3 + MANY_POINTS + 3} tokens)",
                         masks_k, masks_p, masks_32,
                         f"decode {dec[0] * 1e3:.2f} ms for {CHUNK} prompts; ",
                         ref="chunk plain" if name == "chunk" else "plain")


# path -> (attn_impl, twoway_impl, dtype) of the whole-chunk decode's paths
CHUNK_PATHS = {"chunk": ("auto", "chunk", "bfloat16"),
               "chunk_plain_bf16": ("plain", "chunk_plain", "bfloat16"),
               "chunk_plain_fp32": ("plain", "chunk_plain", "float32")}
# Launches per request on the chunk path: the encode, then B16 once a chunk.
PER_REQUEST_CHUNK = {"window_attention_block": 8, "flash_attention_rowbias_proj": 4,
                     "block_tail": 12, "decode_tail": N_PROMPTS // CHUNK}


def chunk_request(r, chunk, image, points, labels, totals, timing):
    """Serve request r through the whole-chunk decode's paths; launches
    checked on the kernel path, whose masks are gated against fp32 as the
    per-op path's are, with chunk plain bf16 as the yardstick."""
    reset_launches()
    masks_k, enc_k, dec_k = serve(chunk["chunk"], image, points, labels)
    counts = launches()
    check_launches(f"request {r} chunk", counts, PER_REQUEST_CHUNK)
    for name, got in counts.items():
        totals[name] = totals.get(name, 0) + got
    masks_p, enc_p, dec_p = serve(chunk["chunk_plain_bf16"], image, points, labels)
    masks_32 = serve(chunk["chunk_plain_fp32"], image, points, labels)[0]
    want_shape = (N_PROMPTS, 4, 256, 256)
    if tuple(masks_k.shape) != want_shape or not bool(torch.isfinite(masks_k).all()):
        raise RuntimeError(f"request {r} chunk: masks {tuple(masks_k.shape)} not "
                           f"{want_shape} or not finite")
    for path, enc, dec in (("chunk", enc_k, dec_k), ("chunk_plain", enc_p, dec_p)):
        timing[path].append((enc, dec))
        log(f"request {r} {path}: encode {enc * 1e3:.2f} ms, decode chunks "
            f"{[round(s_ * 1e3, 2) for s_ in dec]} ms, "
            f"{N_PROMPTS / (enc + sum(dec)):.1f} masks/s")
    chunk_masks_gate(f"request {r} chunk", masks_k, masks_p, masks_32,
                     f"launches {({k: v for k, v in counts.items() if v})}; ")


def chunk_masks_gate(where: str, masks_k, masks_p, masks_32, note: str = "",
                     ref: str = "chunk plain") -> None:
    """A kernel path's mask logits against its ``ref`` fp32 path's (the
    chunk plain path's by default): rel L2 and 1 - mean IoU each within
    SLICE_FACTOR x the ``ref`` bf16 path's."""
    err_k, err_p = rel_l2(masks_k, masks_32), rel_l2(masks_p, masks_32)
    iou_k, n_masks = mask_iou(masks_k, masks_32)
    iou_p = mask_iou(masks_p, masks_32)[0]
    log(f"{where}: {note}vs {ref} fp32: rel_l2 kernels "
        f"{err_k:.3e} plain bf16 {err_p:.3e}, mean IoU kernels {iou_k:.5f} plain bf16 "
        f"{iou_p:.5f} over {n_masks} non-empty masks; kernels vs {ref} bf16 IoU "
        f"{mask_iou(masks_k, masks_p)[0]:.5f}")
    if not err_k <= SLICE_FACTOR * err_p:
        raise RuntimeError(f"{where}: mask rel L2 to fp32 {err_k} over "
                           f"{SLICE_FACTOR} x the {ref} bf16 path's {err_p}")
    if not 1 - iou_k <= SLICE_FACTOR * (1 - iou_p):
        raise RuntimeError(f"{where}: 1 - IoU to fp32 {1 - iou_k} over "
                           f"{SLICE_FACTOR} x the {ref} bf16 path's {1 - iou_p}")


AMG_CROPS = 5  # crop_n_layers=1: the full image and 4 crops, an encode each
# Launches per AMG image: 5 encodes; B16 once a batch of 64 prompts, 16
# batches for the 32 x 32 grid of the full image and 4 for each crop's 16 x 16.
PER_AMG_IMAGE = {"window_attention_block": 8 * AMG_CROPS,
                 "flash_attention_rowbias_proj": 4 * AMG_CROPS, "block_tail": 12 * AMG_CROPS,
                 "decode_tail": 16 + 4 * 4}
RECORD_KEYS = {"segmentation", "area", "bbox", "predicted_iou", "point_coords",
               "stability_score", "crop_box"}


def check_records(where: str, out: dict, side: int) -> None:
    """The records are finite and well-formed: each COCO string decodes to
    a mask of its record's area, boxes inside the mask frame."""
    from iuvl_tpu_torch.inference.amg import area_from_rle, coco_decode_rle, rle_to_mask

    k = len(out["records"])
    if out["masks"].shape != (k, side, side) or len(out["scores"]) != k or len(out["rles"]) != k:
        raise RuntimeError(f"{where}: masks {out['masks'].shape}, {len(out['scores'])} scores, "
                           f"{len(out['rles'])} rles for {k} records")
    for i, rec in enumerate(out["records"]):
        counts = coco_decode_rle(rec["segmentation"])
        nums = [*rec["bbox"], rec["predicted_iou"], rec["stability_score"],
                *rec["point_coords"][0], *rec["crop_box"]]
        if (set(rec) != RECORD_KEYS or not isinstance(rec["segmentation"]["counts"], str)
                or area_from_rle(counts) != rec["area"] or rec["area"] != out["masks"][i].sum()
                or not np.array_equal(rle_to_mask(counts), out["masks"][i])
                or not all(np.isfinite(nums))
                or not all(0 <= v <= side for v in rec["bbox"])):
            raise RuntimeError(f"{where}: record {i} malformed: {rec}")


def amg_batch_gate(model, image: np.ndarray, batch: int, dev) -> None:
    """The AMG's first batch of grid prompts (``batch`` points of the 32 x
    32 grid over the full image) through ``model`` (chunk kernels) and
    chunk plain bf16 and fp32 on its weights, each path encoding the image
    itself, with ``return_upscaled=True``: the masks gated as the serving
    requests' are, and the upscaled embedding (from keys2, B16's
    workspace) by the same rule in rel L2."""
    from iuvl_tpu_torch.inference.amg import build_point_grid
    from iuvl_tpu_torch.models.sam import build_sam

    paths = {"chunk": model}
    for path, (attn, twoway, dtype) in CHUNK_PATHS.items():
        if path != "chunk":
            paths[path] = build_sam("vit_b", dtype=dtype, attn_impl=attn, twoway_impl=twoway,
                                    device=dev).eval()
            paths[path].load_state_dict(model.state_dict())
    img = torch.from_numpy(image).to(dev)
    points = torch.from_numpy(build_point_grid(32)[:batch, None] * 1024).float().to(dev)
    labels = torch.ones(batch, 1, dtype=torch.int32, device=dev)
    outs = {}
    with torch.inference_mode():
        for path, m in paths.items():
            emb, _ = m.encode_image(m.normalize(img), return_fpn=False)
            outs[path] = m.decode_from_embedding(emb, points, labels, return_upscaled=True)
    k, p, f = (outs[path] for path in CHUNK_PATHS)
    up = "upscaled_embedding"
    if k[up].shape != (batch, 256, 256, 32) or not bool(torch.isfinite(k[up]).all()):
        raise RuntimeError(f"amg batch: upscaled embedding {tuple(k[up].shape)} not "
                           f"{(batch, 256, 256, 32)} or not finite")
    chunk_masks_gate(f"amg batch of {batch}", k["masks"], p["masks"], f["masks"])
    err_k, err_p = rel_l2(k[up], f[up]), rel_l2(p[up], f[up])
    log(f"amg batch of {batch}: upscaled embedding vs chunk plain fp32: rel_l2 kernels "
        f"{err_k:.3e} plain bf16 {err_p:.3e}")
    if not err_k <= SLICE_FACTOR * err_p:
        raise RuntimeError(f"amg batch of {batch}: upscaled embedding rel L2 to fp32 {err_k} "
                           f"over {SLICE_FACTOR} x the chunk plain bf16 path's {err_p}")
    del paths, outs
    torch.cuda.empty_cache()


def amg_phase(dev) -> dict:
    """``generate_masks`` on one seeded 1024^2 image with the ViT-B chunk
    model (32 x 32 points, batches of 64, one crop layer, COCO RLE): with
    the default IoU and stability cuts, then with both cuts off, so that
    NMS and the RLE codec see all 2048 masks. Launches checked per image;
    host-clock times. First, one batch of its prompts is held against the
    plain versions (``amg_batch_gate``). Returns the launch totals."""
    from iuvl_tpu_torch.inference import amg
    from iuvl_tpu_torch.models.sam import sam_model_registry

    gen = torch.Generator().manual_seed(SEED + 40)
    model = sam_model_registry["vit_b"](dtype="bfloat16", twoway_impl="chunk", device=dev,
                                        generator=gen).eval()
    image = (np.random.RandomState(SEED + 41).rand(1, 1024, 1024, 3) * 255).astype(np.float32)
    kw = dict(points_per_side=32, batch=64, crop_n_layers=1, output_mode="coco_rle")
    amg_batch_gate(model, image, kw["batch"], dev)
    totals: dict = {}
    nms = {}
    sound_nms = amg.mask_nms

    def timed_nms(masks, scores, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kept = sound_nms(masks, scores, *a, **k)
        torch.cuda.synchronize()
        nms.update(n=len(masks), kept=len(kept), s=time.perf_counter() - t0)
        return kept

    runs = (("default cuts", {}, 2),
            ("cuts off", dict(pred_iou_thresh=float("-inf"), stability_thresh=-1.0), 1))
    with _patched(amg, "mask_nms", timed_nms):
        for label, cuts, times in runs:
            secs = []
            for _ in range(times):
                nms.clear()
                reset_launches()
                out, s_ = synced(lambda: amg.generate_masks(model, image, **kw, **cuts))
                secs.append(s_)
                counts = launches()
                check_launches(f"amg {label}", counts, PER_AMG_IMAGE)
                for name, got in counts.items():
                    totals[name] = totals.get(name, 0) + got
            if label == "cuts off" and nms.get("n") != 1024 + 4 * 256:
                raise RuntimeError(f"amg cuts off: NMS saw {nms.get('n')} masks, not 2048")
            check_records(f"amg {label}", out, 256)
            log(f"amg {label}: {len(out['records'])} masks after the IoU, stability and NMS "
                f"filters; host ms per image {[round(x * 1e3, 1) for x in secs]}; NMS "
                + (f"{nms['n']} -> {nms['kept']} masks in {nms['s'] * 1e3:.1f} ms" if nms
                   else "not reached (no mask passed the cuts)")
                + f"; launches {({k: v for k, v in counts.items() if v})}")
    del model
    torch.cuda.empty_cache()
    return totals


def request(r, model, plain, rs, dev, per_request, totals, timing, label="kernels"):
    """Serve request r through the kernels (checking the launch counts) and
    through the plain paths, and hold the masks against the fp32 ones.
    ``label`` names the kernel path in the log and in ``timing`` (its plain
    bf16 run goes under "plain", or under "plain (<label> requests)").
    Returns the request (image, points, labels)."""
    image = torch.from_numpy(rs.rand(1, 1024, 1024, 3).astype(np.float32) * 255).to(dev)
    points = torch.from_numpy(rs.rand(N_PROMPTS, 1, 2).astype(np.float32) * 1024).to(dev)
    labels = torch.ones(N_PROMPTS, 1, dtype=torch.int32, device=dev)
    reset_launches()
    masks_k, enc_k, dec_k = serve(model, image, points, labels)
    counts = launches()
    for name, got in counts.items():
        want = per_request.get(name, 0)
        if got != want:
            raise RuntimeError(f"request {r}: {name} launched {got} times, expected {want}")
        totals[name] = totals.get(name, 0) + got
    masks_p, enc_p, dec_p = serve(plain["bfloat16"], image, points, labels)
    masks_32 = serve(plain["float32"], image, points, labels)[0]
    want_shape = (N_PROMPTS, 4, 256, 256)
    if tuple(masks_k.shape) != want_shape or not bool(torch.isfinite(masks_k).all()):
        raise RuntimeError(f"request {r}: masks {tuple(masks_k.shape)} not "
                           f"{want_shape} or not finite")
    err_k, err_p = rel_l2(masks_k, masks_32), rel_l2(masks_p, masks_32)
    iou_k, n_masks = mask_iou(masks_k, masks_32)
    iou_p = mask_iou(masks_p, masks_32)[0]
    iou_kp = mask_iou(masks_k, masks_p)[0]
    pos = [float((m > 0).float().mean()) for m in (masks_k, masks_p, masks_32)]
    log(f"request {r} {label}: launches {({k: v for k, v in counts.items() if v})}; "
        f"vs fp32 plain: rel_l2 kernels {err_k:.3e} "
        f"plain bf16 {err_p:.3e}, mean IoU kernels {iou_k:.5f} plain bf16 {iou_p:.5f} "
        f"over {n_masks} non-empty masks; kernels vs plain bf16 IoU {iou_kp:.5f}; "
        f"positive share kernels {pos[0]:.4f} plain {pos[1]:.4f} fp32 {pos[2]:.4f}")
    plain_label = "plain" if label == "kernels" else f"plain ({label} requests)"
    for path, enc, dec in ((label, enc_k, dec_k), (plain_label, enc_p, dec_p)):
        timing[path].append((enc, dec))
        log(f"request {r} {path}: encode {enc * 1e3:.2f} ms, decode chunks "
            f"{[round(s * 1e3, 2) for s in dec]} ms, "
            f"{N_PROMPTS / (enc + sum(dec)):.1f} masks/s")
    if not err_k <= SLICE_FACTOR * err_p:
        raise RuntimeError(f"request {r}: mask rel L2 to fp32 {err_k} over "
                           f"{SLICE_FACTOR} x the plain bf16 path's {err_p}")
    if not 1 - iou_k <= SLICE_FACTOR * (1 - iou_p):
        raise RuntimeError(f"request {r}: 1 - IoU to fp32 {1 - iou_k} over "
                           f"{SLICE_FACTOR} x the plain bf16 path's {1 - iou_p}")
    return image, points, labels


# Launches of each kernel wrapper per train step of the kernel path. At
# batch 1 the deformable core is the plain 'wide' core; at batch 2 it is
# the flat core: the B7 forward once per layer and level (6 x 3), the
# gather, B8 and the scatter once per layer, level and image.
PER_STEP = {1: {"window_attention_block": 8, "block_tail": 12, "window_block_backward": 8,
                "block_tail_backward": 12, "flash_attention": 8, "tap_scatter": 10}}
PER_STEP[2] = {**PER_STEP[1], "ms_deform_level_fwd": 18, "deform_gather_rows": 36,
               "deform_bwd_glue_q": 36, "deform_scatter_dv": 36}
DEFORM_STEP = {k: v for k, v in PER_STEP[2].items() if k not in PER_STEP[1]}


def per_step(impl: str, batch: int) -> dict:
    """Launches per train step: under 'rowbias' / 'pallas_rp' each of the 12
    blocks runs the impl's forward and backward kernel once, and no B1-B3,
    B9-B11 (JAX's unfused route); B12, and at batch 2 B7 and B8, as 'auto'."""
    if impl == "auto":
        return PER_STEP[batch]
    return {IMPL_FWD[impl]: 12, IMPL_BWD[impl]: 12, "tap_scatter": 10,
            **(DEFORM_STEP if batch == 2 else {})}
GROUPS = ("image_encoder.", "pixel_decoder.", "predictor.")


def step_draws(gen: torch.Generator, n_layers: int, batch: int) -> dict:
    """One step's uniform draws of the criterion, by name, from ``gen``."""
    p, n = MATCH_POINTS, batch * N_TARGETS
    out = {}
    for i in range(n_layers):
        out[f"layer{i}/match"] = torch.rand((batch, p, 2), generator=gen, device=gen.device)
        out[f"layer{i}/over"] = torch.rand((n, 3 * p, 2), generator=gen, device=gen.device)
        out[f"layer{i}/rand"] = torch.rand((n, p - int(0.75 * p), 2), generator=gen,
                                           device=gen.device)
    return out


TRAIN_CONFIG = dict(sam_size="base", img_size=1024, dtype="bfloat16", attn_impl="auto",
                    msdeform_impl="auto")
# In the order they run: the fp32 path's assignments serve every path.
TRAIN_PATHS = ("plain_fp32", "plain_bf16", "kernels", "control_fp32", "control_bf16")


def perturbed(state: dict, seed: int, dev) -> dict:
    """The control pair's weights: each floating-point entry scaled by
    1 + 2^-9 u, u uniform in [-1, 1] from ``seed``. That changes the bf16
    rounding of a good share of the weights; the pair's fp32 path takes the
    same weights, so the pair is one more sound bf16 path with its own fp32
    reference."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {k: v * (1 + 2.0 ** -9 * (2 * torch.rand(v.shape, generator=gen, device=dev) - 1))
            if v.is_floating_point() else v for k, v in state.items()}


def capture_grads(state, model, into: dict) -> None:
    """Have the next optimizer update first copy every parameter's gradient
    (before clipping) into ``into``."""
    opt = state.optimizer

    def copy_then_step():
        into.update({n: p.grad.detach().clone() for n, p in model.named_parameters()})
        del opt.step
        return opt.step()

    opt.step = copy_then_step


def make_batch(rs: np.random.RandomState, batch: int, size: int, dev):
    """Seeded images (raw RGB) and targets: 20 binary gt masks an image
    (70% zero), ~30% of them invalid."""
    from iuvl_tpu_torch.losses.criterion import SegTargets

    image = torch.from_numpy(rs.rand(batch, size, size, 3).astype(np.float32) * 255).to(dev)
    targets = SegTargets(
        labels=torch.from_numpy(rs.randint(0, N_CLASSES, (batch, N_TARGETS))).to(dev),
        masks=torch.from_numpy(
            (rs.rand(batch, N_TARGETS, size, size) > 0.7).astype(np.float32)).to(dev),
        valid=torch.from_numpy(rs.rand(batch, N_TARGETS) > 0.3).to(dev))
    return image, targets


def train_phase(dev, batch: int, steps: int, control: bool, impl: str = "auto") -> dict:
    """``steps`` train steps on ``batch`` images a step through the kernels,
    the plain bf16 and the plain fp32 paths, and with ``control`` on the
    first step the control pair too (plain bf16 and fp32 on perturbed
    weights). Before the steps, :func:`loss_gate` gates the loss terms on
    the first step's batch and GATE_BATCHES - 1 more at the same weights;
    at batch 1 they are also gated on the first step's batch alone.
    ``impl`` is the kernel path's attn_impl; the plain paths are 'plain'.
    Returns the kernel path's launch totals."""
    from iuvl_tpu_torch.losses.criterion import CriterionConfig, SegCriterion
    from iuvl_tpu_torch.models.xdecoder import convert
    from iuvl_tpu_torch.models.xdecoder.model import SysLearnerConfig, build_syslearner
    from iuvl_tpu_torch.train.optimizer import Optimizer
    from iuvl_tpu_torch.train.train_step import TrainState, make_train_step

    cfg = SysLearnerConfig(**{**TRAIN_CONFIG, "attn_impl": impl})
    size = cfg.img_size
    plain = {"bf16": dataclasses.replace(cfg, attn_impl="plain"),
             "fp32": dataclasses.replace(cfg, attn_impl="plain", dtype="float32")}
    cfgs = {"kernels": cfg, "plain_bf16": plain["bf16"], "plain_fp32": plain["fp32"]}
    if control:
        cfgs.update(control_bf16=plain["bf16"], control_fp32=plain["fp32"])
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED)
    models = {"kernels": build_syslearner(cfg, device=dev, generator=gen)}
    weights = models["kernels"].state_dict()
    shifted = perturbed(weights, SEED + 5, dev) if control else None
    for path in cfgs:
        if path != "kernels":
            models[path] = build_syslearner(cfgs[path], device=dev)
            models[path].load_state_dict(shifted if path.startswith("control") else weights)
    del weights, shifted
    paths = convert.flax_paths(cfg)
    states = {path: TrainState(Optimizer(m.named_parameters(), paths=paths, base_lr=1e-4,
                                         total_steps=1000))
              for path, m in models.items()}
    n_params = sum(p.numel() for p in models["kernels"].parameters())
    log(f"train batch {batch} ({impl}): {len(models)} x SysLearner ({n_params / 1e6:.1f} M "
        f"parameters each) built in {time.perf_counter() - t0:.1f} s")
    crits = {path: SegCriterion(CriterionConfig(num_classes=N_CLASSES),
                                impl=cfgs[path].kernels_impl) for path in models}
    step_fns = {path: make_train_step(m, crits[path], match_points=MATCH_POINTS)
                for path, m in models.items()}
    rs = np.random.RandomState(SEED + 2 + 10 * (batch - 1))
    text = torch.from_numpy(rs.randn(N_CLASSES + 1, cfg.syslearner_dim).astype(np.float32))
    text = text.to(dev)
    draw_gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    n_layers = 10
    data = [(*make_batch(rs, batch, size, dev), step_draws(draw_gen, n_layers, batch))
            for _ in range(steps)]
    gate_rs = np.random.RandomState(SEED + 20)
    gate_gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    loss_gate(models, crits, text, data[:1] + [
        (*make_batch(gate_rs, batch, size, dev), step_draws(gate_gen, n_layers, batch))
        for _ in range(GATE_BATCHES - 1)])
    want = per_step(impl, batch)
    totals = {k: 0 for k in want}
    times = {"kernels": [], "plain_bf16": []}
    peak = {path: 0 for path in models}
    for step, (image, targets, draws) in enumerate(data):
        metrics, grads = {}, {}
        for path in [p for p in TRAIN_PATHS if p in models]:
            if step == 0:
                grads[path] = {}
                capture_grads(states[path], models[path], grads[path])
            assignments = None if path == "plain_fp32" else metrics["plain_fp32"]["assignments"]
            reset_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t_start = time.perf_counter()
            _, metrics[path] = step_fns[path](states[path], image, text, targets, draws,
                                              assignments=assignments)
            torch.cuda.synchronize()
            if path in times:
                times[path].append(time.perf_counter() - t_start)
            peak[path] = max(peak[path], torch.cuda.max_memory_allocated())
            counts = launches()
            if path == "kernels":
                check_step_launches(step, counts, totals, want, impl)
            elif any(counts.values()):
                raise RuntimeError(f"step {step} {path}: kernels launched {counts}")
        # The one-batch loss gate only on the 'auto' batch-1 phase; every phase
        # gates its gradient groups and (loss_gate) its loss terms pooled over
        # GATE_BATCHES batches.
        check_step(step, metrics, grads, gate_losses=batch == 1 and impl == "auto")
        if step == 0 and control:  # the control pair has served its purpose
            for path in ("control_bf16", "control_fp32"):
                del models[path], states[path], step_fns[path]
            torch.cuda.empty_cache()
        del grads
    del data
    resident = torch.cuda.memory_allocated()
    for path, ts in times.items():
        mean = float(np.mean(ts[1:]))
        label = impl if path == "kernels" else path
        log(f"train batch {batch} {label}: step times {[round(s * 1e3, 1) for s in ts]} ms; mean "
            f"of steps 1..{steps - 1} {mean * 1e3:.1f} ms, {batch / mean:.3f} img/s")
    log(f"train batch {batch} ({impl}): peak memory allocated during a step (GiB) "
        + ", ".join(f"{path} {b / 2**30:.2f}" for path, b in peak.items())
        + f"; after the steps {resident / 2**30:.2f} GiB held by the "
        f"{len(models)} models and their optimizer states")
    del models, states
    torch.cuda.empty_cache()
    return totals


def check_step_launches(step: int, counts: dict, totals: dict, per_step: dict,
                        impl: str = "auto") -> None:
    from iuvl_tpu_torch.ops.cuda import flash_attention as fa

    log(f"train step {step} kernels ({impl}): launches "
        f"{({k: v for k, v in counts.items() if v})} (B11 forward "
        f"{fa.flash_attention_fwd.launches}, backward {fa.flash_attention_bwd.launches})")
    for name, got in counts.items():
        want = per_step.get(name, 0)
        if got != want:
            raise RuntimeError(f"train step {step}: {name} launched {got} times, "
                               f"expected {want}")
        if name in totals:
            totals[name] += got
    if impl == "auto" and (fa.flash_attention_fwd.launches != 4
                           or fa.flash_attention_bwd.launches != 4):
        raise RuntimeError(f"train step {step}: B11 forward/backward calls "
                           f"{fa.flash_attention_fwd.launches}/{fa.flash_attention_bwd.launches}"
                           ", expected 4/4")


LOSS_TERMS = ("loss_mask_ce", "loss_mask_bce", "loss_mask_dice")


def check_step(step: int, metrics: dict, grads: dict, gate_losses: bool) -> None:
    """Print the losses; on the first step gate each parameter group's
    gradient and, with ``gate_losses``, each loss term (class CE, mask BCE,
    dice: the vector of its values over the kept layers; :func:`loss_gate`
    gates them over many batches): the kernel path may be at most
    SLICE_FACTOR times as far from fp32, in relative L2, as the plain bf16
    path. The control pair (a second sound bf16 path, held against its own
    fp32 path) is read the same way, ungated, and so is each layer's loss
    scalar: there the control shows how far the ratio of two sound bf16
    paths spreads, which is why one scalar is no gate."""
    ref = metrics["plain_fp32"]
    keys = sorted(k for k in ref if k.startswith("loss_"))
    for path, m in metrics.items():
        if not all(bool(torch.isfinite(m[k])) for k in keys):
            raise RuntimeError(f"train step {step} {path}: non-finite loss")
    for path, m in metrics.items():
        log(f"train step {step} {path}: loss_total {float(m['loss_total']):.6f}, "
            + ", ".join(f"{term[5:]} " + " ".join(
                f"{float(m[k]):.5f}" for k in keys if k.startswith(term + "_"))
                for term in LOSS_TERMS)
            + f"; grad_norm {float(m['grad_norm']):.4f}")
    if step:
        return
    # Each bf16 path against its own fp32 path.
    pairs = {"kernels": "plain_fp32", "plain_bf16": "plain_fp32",
             "control_bf16": "control_fp32"}
    if "control_bf16" not in metrics:
        del pairs["control_bf16"]

    def rel(path, key):
        r = float(metrics[pairs[path]][key])
        return abs(float(metrics[path][key]) - r) / abs(r)

    def others(e, fmt, label=""):
        return "".join(f" {path}{label} {fmt(e[path])}" for path in pairs
                       if path.startswith("control"))

    ratios = {path: [] for path in pairs if path != "plain_bf16"}
    for key in keys:
        e = {path: rel(path, key) for path in pairs}
        r = {path: e[path] / max(e["plain_bf16"], 1e-30) for path in ratios}
        log(f"train step 0 {key}: fp32 {float(ref[key]):.6f}, rel err kernels "
            f"{e['kernels']:.3e} plain bf16 {e['plain_bf16']:.3e}{others(e, '{:.3e}'.format)}"
            f"; ratio to plain bf16 kernels {r['kernels']:.2f}{others(r, '{:.2f}'.format)}")
        if key != "loss_total":
            for path in ratios:
                ratios[path].append(r[path])
    for path, rs in ratios.items():
        log(f"train step 0 per-layer loss scalars, {path} / plain bf16: "
            f"{sum(x > SLICE_FACTOR for x in rs)} of {len(rs)} above {SLICE_FACTOR}; "
            f"min {min(rs):.3f} median {float(np.median(rs)):.3f} max {max(rs):.3f} (not gated)")

    def dist(vec, path):
        return rel_l2(vec[path], vec[pairs[path]])

    failed = []
    for term in LOSS_TERMS:
        vec = {path: torch.stack([m[k].float() for k in keys if k.startswith(term + "_")])
               for path, m in metrics.items()}
        e = {path: dist(vec, path) for path in pairs}
        r = {path: e[path] / e["plain_bf16"] for path in pairs}
        log(f"train step 0 {term} ({len(vec['kernels'])} layers): rel L2 to fp32 kernels "
            f"{e['kernels']:.3e} plain bf16 {e['plain_bf16']:.3e}{others(e, '{:.3e}'.format)}"
            f"; ratio kernels {r['kernels']:.3f}{others(r, '{:.3f}'.format)} (one batch"
            + ("" if gate_losses else ", not gated") + ")")
        if gate_losses and not e["kernels"] <= SLICE_FACTOR * e["plain_bf16"]:
            failed.append(f"{term}: {e['kernels']:.3e} > {SLICE_FACTOR} x {e['plain_bf16']:.3e}")
    for group in GROUPS:
        names = [n for n in grads["plain_fp32"] if n.startswith(group)]
        vec = {path: torch.cat([grads[path][n].float().flatten() for n in names])
               for path in grads}
        e = {path: dist(vec, path) for path in pairs}
        r = {path: e[path] / e["plain_bf16"] for path in pairs}
        log(f"train step 0 grad {group[:-1]}: rel L2 to fp32 kernels {e['kernels']:.3e} plain "
            f"bf16 {e['plain_bf16']:.3e}{others(e, '{:.3e}'.format)}; ratio kernels "
            f"{r['kernels']:.3f}{others(r, '{:.3f}'.format, ' (not gated)')}")
        if not e["kernels"] <= SLICE_FACTOR * e["plain_bf16"]:
            failed.append(f"grad {group}: {e['kernels']:.3e} > {SLICE_FACTOR} x "
                          f"{e['plain_bf16']:.3e}")
    if failed:
        raise RuntimeError("train gate failed: " + "; ".join(failed))


def loss_gate(models: dict, crits: dict, text, batches: list) -> None:
    """Gate each loss term (its 10 layers' values) pooled over ``batches``
    (images, targets, draws), every path at the same weights: forward and
    criterion as in a train step (autograd recording, so the training
    routes run; no backward, no update), the fp32 path's assignments on
    every path. The kernel path's relative L2 from fp32 must be at most
    SLICE_FACTOR times the plain bf16 path's. On one batch the ratio of two
    sound bf16 paths spreads over about 0.4-2.5 (PERF.md, Findings), so one
    batch's ten values per term are no gate."""
    from iuvl_tpu_torch.losses.matcher import batched_hungarian
    from iuvl_tpu_torch.ops.point_sample import given_draws
    from iuvl_tpu_torch.train.train_step import split_seg_outputs

    paths = ("plain_fp32", "plain_bf16", "kernels")
    values = {path: {term: [] for term in LOSS_TERMS} for path in paths}
    per_batch = []
    for images, targets, draws in batches:
        assignments = None
        for path in paths:
            model, crit, draw = models[path], crits[path], given_draws(draws)
            with torch.enable_grad():
                obj = split_seg_outputs(model.forward_seg(images, text), model.cfg.num_queries)
                costs, kept = crit.collect_costs(obj, targets, draw, MATCH_POINTS)
                if assignments is None:
                    assignments = batched_hungarian(costs)
                losses = crit.losses_from_assignments(kept, assignments, targets, draw)
            for term in LOSS_TERMS:
                values[path][term] += [float(v.detach()) for k, v in sorted(losses.items())
                                       if k.startswith(term + "_")]
            del obj, kept, losses
        per_batch.append({term: [
            rel_l2(torch.tensor(values[path][term][-10:]), torch.tensor(
                values["plain_fp32"][term][-10:])) for path in paths[1:]] for term in LOSS_TERMS})
    failed = []
    for term in LOSS_TERMS:
        vec = {path: torch.tensor(values[path][term], dtype=torch.float64) for path in paths}
        e = {path: rel_l2(vec[path], vec["plain_fp32"]) for path in paths[1:]}
        one = [round(b[term][1] / b[term][0], 2) for b in per_batch]
        log(f"train {term} over {len(batches)} batches ({len(vec['kernels'])} values): rel L2 "
            f"to fp32 kernels {e['kernels']:.3e} plain bf16 {e['plain_bf16']:.3e}; ratio "
            f"{e['kernels'] / e['plain_bf16']:.3f} (one batch at a time, not gated: {one})")
        if not e["kernels"] <= SLICE_FACTOR * e["plain_bf16"]:
            failed.append(f"{term}: {e['kernels']:.3e} > {SLICE_FACTOR} x {e['plain_bf16']:.3e}")
    if failed:
        raise RuntimeError("train loss gate failed: " + "; ".join(failed))


# The encoder at other widths and grids through attn_impl='auto' (every block
# on a kernel), depth cut to one windowed and one global block: (label, SAM
# variant, image side, launches of the serving encode, of the training
# route's forward + backward). ViT-H: head dim 80 (B1, B9) and C 1280 (B3,
# B10); its global block fails rowbias_supported (d + w = 144), so serving
# runs B11's forward at d_qk 208. ViT-B at 512^2: B2 at N 1024, w 32; B11 at
# d_qk 128 in training. ViT-B at 800^2: N 2500 (B11 at d_qk 164, masked last
# tiles; B3 and B10 at T 2500), 16 padded windows.
SHAPE_CASES = (
    ("vit_h 1024", "vit_h", 1024, {"window_attention_block": 1, "flash_attention": 1,
                                   "block_tail": 2}),
    ("vit_b 512", "vit_b", 512, {"window_attention_block": 1,
                                 "flash_attention_rowbias_proj": 1, "block_tail": 2}),
    ("vit_b 800", "vit_b", 800, {"window_attention_block": 1, "flash_attention": 1,
                                 "block_tail": 2}),
)
TRAIN_ROUTE = {"window_attention_block": 1, "window_block_backward": 1, "flash_attention": 2,
               "block_tail": 2, "block_tail_backward": 2}
SHAPE_PATHS = {"kernels": ("auto", torch.bfloat16), "plain_bf16": ("plain", torch.bfloat16),
               "plain_fp32": ("plain", torch.float32)}


def gate_paths(where: str, vec: dict) -> None:
    """The kernel path at most SLICE_FACTOR x as far from plain fp32 as
    plain bf16, in relative L2."""
    e_k, e_p = rel_l2(vec["kernels"], vec["plain_fp32"]), rel_l2(vec["plain_bf16"],
                                                                 vec["plain_fp32"])
    log(f"{where}: rel L2 to plain fp32 kernels {e_k:.3e} plain bf16 {e_p:.3e}; ratio "
        f"{e_k / e_p:.3f}")
    if not e_k <= SLICE_FACTOR * e_p:
        raise RuntimeError(f"{where}: rel L2 to fp32 {e_k} over {SLICE_FACTOR} x the plain "
                           f"bf16 path's {e_p}")


def shape_phase(dev) -> dict:
    """SHAPE_CASES: each encoder on one seeded image through the kernels,
    plain bf16 and plain fp32 (the same weights): the serving encode (the
    SAM embedding gated), then the training route, forward and backward of
    a fixed random projection of the embedding (every parameter's gradient,
    gated as one vector). Launches checked on the kernel path."""
    from iuvl_tpu_torch.models.sam.build import SAM_VARIANTS, init_random_
    from iuvl_tpu_torch.models.sam.image_encoder import ImageEncoderViT

    totals = {}
    for label, variant, side, serve_want in SHAPE_CASES:
        cfg = SAM_VARIANTS[variant]
        kw = dict(img_size=side, embed_dim=cfg["embed_dim"], depth=2,
                  num_heads=cfg["num_heads"], global_attn_indexes=(1,))
        base = init_random_(ImageEncoderViT(**kw), torch.Generator().manual_seed(SEED + 30))
        encs = {}
        for path, (impl, dtype) in SHAPE_PATHS.items():
            encs[path] = ImageEncoderViT(**kw, dtype=dtype, attn_impl=impl)
            encs[path].load_state_dict(base.state_dict())
            encs[path].to(dev)
        del base
        rs = np.random.RandomState(SEED + 31)
        x = torch.from_numpy(rs.randn(1, side, side, 3).astype(np.float32)).to(dev)
        emb, grads, names = {}, {}, None
        for path, enc in encs.items():
            reset_launches()
            with torch.no_grad():
                emb[path], t_enc = synced(lambda: enc(x, return_fpn=False)[0])
            counts = launches()
            if path == "kernels":
                check_launches(f"{label} encode", counts, serve_want)
                log(f"{label} encode (kernels): {t_enc * 1e3:.2f} ms (host clock, the first "
                    f"call), launches {({k: v for k, v in counts.items() if v})}")
            elif any(counts.values()):
                raise RuntimeError(f"{label} encode {path}: kernels launched {counts}")
            for k, got in counts.items():
                totals[k] = totals.get(k, 0) + got
        gate_paths(f"{label} encode, SAM embedding {tuple(emb['kernels'].shape)}", emb)
        proj = torch.from_numpy(rs.randn(*emb["kernels"].shape).astype(np.float32)).to(dev)
        for path, enc in encs.items():
            reset_launches()
            with torch.enable_grad():
                (enc(x, return_fpn=False)[0].float() * proj).sum().backward()
            torch.cuda.synchronize()
            counts = launches()
            if path == "kernels":
                check_launches(f"{label} encoder backward", counts, TRAIN_ROUTE)
            elif any(counts.values()):
                raise RuntimeError(f"{label} backward {path}: kernels launched {counts}")
            for k, got in counts.items():
                totals[k] = totals.get(k, 0) + got
            names = names or [n for n, p in enc.named_parameters() if p.grad is not None]
            grads[path] = torch.cat([dict(enc.named_parameters())[n].grad.float().flatten()
                                     for n in names])
        gate_paths(f"{label} encoder backward, gradient of {len(names)} parameters", grads)
        del encs, emb, grads, proj
        torch.cuda.empty_cache()
    return totals


EVAL_IMAGES = 3
EVAL_CONFIG = dict(TRAIN_CONFIG)
# Launches of each kernel wrapper per evaluated image: the ViT's blocks (B2
# for the global blocks: no autograd), and with 'hybrid' B15 on res5 in each
# of the 6 deformable layers.
PER_IMAGE = {"auto": {"window_attention_block": 8, "flash_attention_rowbias_proj": 4,
                      "block_tail": 12}}
PER_IMAGE["hybrid"] = {**PER_IMAGE["auto"], "onehot_deform_level_forward": 6}
# path -> (attn_impl, msdeform_impl, dtype), in the order they run; each
# kernel path is gated against the plain bf16 path of its own impl.
EVAL_PATHS = {"plain_fp32": ("plain", "auto", "float32"),
              "plain_bf16": ("plain", "auto", "bfloat16"),
              "plain_bf16_hybrid": ("plain", "hybrid", "bfloat16"),
              "kernels_auto": ("auto", "auto", "bfloat16"),
              "kernels_hybrid": ("auto", "hybrid", "bfloat16")}
EVAL_GATES = {"kernels_auto": "plain_bf16", "kernels_hybrid": "plain_bf16_hybrid"}


def synced(fn):
    """(fn(), host seconds) around work that ends in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_launches(where: str, counts: dict, want: dict, times: int = 1) -> None:
    for name, got in counts.items():
        if got != times * want.get(name, 0):
            raise RuntimeError(f"{where}: {name} launched {got} times, expected "
                               f"{times * want.get(name, 0)}")


def eval_phase(dev) -> dict:
    """The seg eval at full width on EVAL_IMAGES images through every path
    of EVAL_PATHS (one set of seeded weights), gated as the module's
    docstring says; then the eval pipeline on each kernel path. Returns the
    kernel paths' launch totals from their pipeline runs."""
    from iuvl_tpu_torch.data.class_names import get_class_names
    from iuvl_tpu_torch.models.sam import image_encoder as ie
    from iuvl_tpu_torch.models.xdecoder.model import SysLearnerConfig, build_syslearner
    from iuvl_tpu_torch.pipeline import class_text_embeddings, evaluate_seg_batches

    cfg = SysLearnerConfig(**EVAL_CONFIG)
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 30)
    models, weights = {}, None
    for path, (attn, msdeform, dtype) in EVAL_PATHS.items():
        pcfg = dataclasses.replace(cfg, attn_impl=attn, msdeform_impl=msdeform, dtype=dtype)
        models[path] = build_syslearner(pcfg, device=dev,
                                        generator=gen if weights is None else None).eval()
        if weights is None:
            weights = models[path].state_dict()
        else:
            models[path].load_state_dict(weights)
    del weights
    log(f"eval: {len(models)} x SysLearner built in {time.perf_counter() - t0:.1f} s")
    names = get_class_names("coco_panoptic")
    text, text_s = {}, {}
    with torch.no_grad():
        for path, m in models.items():
            text[path], text_s[path] = synced(lambda: class_text_embeddings(m, names))
    log(f"eval: class embeddings {tuple(text['kernels_auto'].shape)} ({len(names)} classes x 80 "
        f"templates) ms: " + ", ".join(f"{p} {s * 1e3:.1f}" for p, s in text_s.items())
        + f"; bf16 vs fp32 rel_l2 {rel_l2(text['kernels_auto'], text['plain_fp32']):.3e}")
    for path in ("kernels_hybrid", "plain_bf16", "plain_bf16_hybrid"):
        if not torch.equal(text[path], text["kernels_auto"]):
            raise RuntimeError(f"eval: {path}'s class embeddings differ from kernels_auto's")
    rs = np.random.RandomState(SEED + 31)
    batches = []
    for _ in range(EVAL_IMAGES):
        image, targets = make_batch(rs, 1, cfg.img_size, torch.device("cpu"))
        batches.append({"image": image.numpy(), "masks": targets.masks.numpy(),
                        "labels": targets.labels.numpy(), "valid": targets.valid.numpy()})
    sq = {path: {"cls": 0.0, "pred": 0.0} for path in models if path != "plain_fp32"}
    ref_sq = {"cls": 0.0, "pred": 0.0}
    times = {path: [] for path in models}
    peak = {path: 0 for path in models}
    want_shape = (1, cfg.num_queries, len(names))
    with torch.no_grad():
        for i, batch in enumerate(batches):
            image = torch.from_numpy(batch["image"]).to(dev)
            ref = None
            per_image = {}
            for path, m in models.items():
                reset_launches()
                torch.cuda.reset_peak_memory_stats()
                (cls, pred), secs = synced(lambda: m.evaluate_seg(image, text[path]))
                times[path].append(secs)
                peak[path] = max(peak[path], torch.cuda.max_memory_allocated())
                impl = EVAL_PATHS[path][1]
                check_launches(f"eval image {i} {path}", launches(),
                               PER_IMAGE[impl] if path.startswith("kernels") else {})
                if (tuple(cls.shape) != want_shape
                        or tuple(pred.shape) != (1, cfg.num_queries, *image.shape[1:3])
                        or not bool(torch.isfinite(cls).all() & torch.isfinite(pred).all())):
                    raise RuntimeError(f"eval image {i} {path}: mask_cls {tuple(cls.shape)}, "
                                       f"mask_pred {tuple(pred.shape)} or not finite")
                if ref is None:
                    ref = {"cls": cls.float(), "pred": pred.float()}
                    ref_n = {k: float(v.square().sum()) for k, v in ref.items()}
                    for k, v in ref_n.items():
                        ref_sq[k] += v
                    continue
                for key, got in (("cls", cls), ("pred", pred)):
                    d2 = float((got.float() - ref[key]).square().sum())
                    sq[path][key] += d2
                    per_image[f"{path} {key}"] = (d2 / ref_n[key]) ** 0.5
                del cls, pred
            log(f"eval image {i}: rel_l2 to fp32 " + ", ".join(
                f"{k} {v:.3e}" for k, v in per_image.items()))
            del ref
    dist = {path: {k: (v / ref_sq[k]) ** 0.5 for k, v in d.items()} for path, d in sq.items()}
    failed = []
    for path, yard in EVAL_GATES.items():
        for key, label in (("cls", "mask_cls"), ("pred", "mask_pred")):
            e, y = dist[path][key], dist[yard][key]
            other = dist["plain_bf16"][key]
            log(f"eval {label} over {EVAL_IMAGES} images: rel L2 to fp32 {path} {e:.3e}, {yard} "
                f"{y:.3e}; ratio {e / y:.3f} (bound {SLICE_FACTOR}); ratio to plain_bf16 "
                f"{e / other:.3f} (not gated)")
            if not e <= SLICE_FACTOR * y:
                failed.append(f"{path} {label}: {e:.3e} > {SLICE_FACTOR} x {y:.3e}")
    for path, ts in times.items():
        mean = float(np.mean(ts[1:]))
        log(f"eval {path}: evaluate_seg ms {[round(t_ * 1e3, 1) for t_ in ts]}; mean of images "
            f"1..{EVAL_IMAGES - 1} {mean * 1e3:.1f} ms, {1 / mean:.3f} img/s; peak memory "
            f"allocated during a call {peak[path] / 2**30:.2f} GiB")
    if failed:
        raise RuntimeError("eval gate failed: " + "; ".join(failed))

    # The encode and its SimpleFPN on the kernel path (CUDA events), and the
    # SimpleFPN with its GroupNorms skipped: what group_norm_f32 costs.
    enc = models["kernels_auto"].image_encoder
    with torch.no_grad():
        x = models["kernels_auto"].normalize(torch.from_numpy(batches[0]["image"]).to(dev))
        encode_ms = cuda_ms(lambda: enc(x, return_fpn=True, return_embedding=False), 5)
        seen = {}
        hook = enc.neck.register_forward_pre_hook(lambda _, a: seen.setdefault("vit", a[0]))
        enc(x, return_fpn=True, return_embedding=False)
        hook.remove()
        fpn_ms = cuda_ms(lambda: enc.neck(seen["vit"]), 10)
        with _patched(ie, "_group_norm", lambda y, gn: y.float()):
            fpn_no_gn_ms = cuda_ms(lambda: enc.neck(seen["vit"]), 10)
        del seen
    log(f"eval kernels_auto: encode (ViT + SimpleFPN) {encode_ms:.3f} ms, SimpleFPN "
        f"{fpn_ms:.3f} ms, SimpleFPN without its 10 GroupNorms {fpn_no_gn_ms:.3f} ms "
        f"(CUDA events)")

    totals = {}
    for path in EVAL_GATES:
        timings = {}
        reset_launches()
        metrics = evaluate_seg_batches(models[path], text[path], batches, "coco_panoptic",
                                       timings=timings)
        counts = launches()
        check_launches(f"eval pipeline {path}", counts, PER_IMAGE[EVAL_PATHS[path][1]],
                       EVAL_IMAGES)
        for name, got in counts.items():
            totals[name] = totals.get(name, 0) + got
        if not all(np.isfinite(v) for v in metrics.values()):
            raise RuntimeError(f"eval pipeline {path}: non-finite metrics {metrics}")
        log(f"eval pipeline {path}: launches {counts}; host ms per image (images 1.."
            f"{EVAL_IMAGES - 1}) " + ", ".join(
                f"{stage} {float(np.mean(ts[1:])) * 1e3:.1f}" for stage, ts in timings.items()))
        log(f"eval pipeline {path}: " + ", ".join(
            f"{k.split('/')[-1]} {v:.4f}" for k, v in metrics.items()
            if k.split("/")[-1] in ("mIoU", "pACC", "PQ", "PQ_th", "PQ_st", "AP", "AP50",
                                    "processed")))
    del models
    torch.cuda.empty_cache()
    return totals


def main() -> int:
    t_start = time.perf_counter()
    smi = device_phase()
    dev = torch.device("cuda", 0)
    from iuvl_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s ({build.BUILD_DIR})")
    with torch.no_grad():
        rows = kernel_phase(dev)
    grad_switch_phase(dev)
    t0 = time.perf_counter()
    serving = serving_phase(dev)
    log(f"serving phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths = [serving, amg_phase(dev)]
    log(f"amg phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths.append(shape_phase(dev))
    log(f"shape phase: {time.perf_counter() - t0:.1f} s")
    for batch, control, impl in ((1, True, "auto"), (2, False, "auto"), (1, False, "rowbias"),
                                 (1, False, "pallas_rp"), (2, False, "rowbias")):
        t0 = time.perf_counter()
        paths.append(train_phase(dev, batch, STEPS, control, impl))
        log(f"train phase, batch {batch}, {impl}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths.append(eval_phase(dev))
    log(f"eval phase: {time.perf_counter() - t0:.1f} s")
    for row in rows:
        row["launches"] = sum(counts.get(row["name"], 0) for counts in paths)
        if not row["launches"] and row["name"] not in OFF_PATH:
            raise RuntimeError(f"{row['name']}: never launched on the main paths")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
