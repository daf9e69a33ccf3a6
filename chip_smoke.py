"""Drive the port's SAM serving paths, automatic mask generation, its seg
and joint step-1 train steps, its seg and vision-language evals and its
interactive segmentation on one CUDA card, and check them.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):
1. device: require CUDA; print torch/CUDA versions and the card's name and
   power limit (nvidia-smi).
2. build: compile the hand-written kernels from iuvl_tpu_torch/csrc (one
   nvcc per source, in parallel).
3. kernels: each kernel against its plain PyTorch version at the shapes of
   the path that runs it (ViT-B, 1024^2, bf16; the deformable core B7 and
   its backward glue B8 at the res3 level of the batch-2 train step; the
   one-hot level B15 at the res5 level of the hybrid eval; all six
   deformable entries also at head widths 32 and 128, and B15 also on a
   16^2 and a 50^2 table (its L2 instance) and in fp32; the whole-chunk
   decode tail B16 at a 256-prompt chunk, its tokens on the 7 valid
   slots, and again at 48 and 64 slots, at N 2500 and at an interactive
   round (8 prompts, 26 tokens in 32 slots); B3 also at ViT-H, T 2500 and
   batch 2 (T 8192); B2b and B14, forward and backward,
   and B13 at the windowed shape (300 (window, head) pairs of N 196) and
   the global one (12 heads of N 4096), each shape a row of its own; B11's
   forward and backward, each a row, on the augmented q, k of a global
   block at ViT-B 1024^2 and 800^2 (N 2500: masked last tiles), the
   forward also at ViT-H's serving shape; B1 also at ViT-H and at ViT-B
   512^2, B2 also at ViT-B 512^2; B17, which no path runs, at the
   shape of B7's d_value scatter and at a skewed case). Every output's
   relative L2 error must stay within its own bound
   (KERNEL_BOUNDS). Planted faults run through the plain version (a bias,
   rel-pos or PE term dropped, heads, tokens or slots swapped, a wrong lse,
   a reduction that misses its last 16 rows, a tap at the wrong row, the
   zero-padding validity dropped, a slot read from the next slot's columns,
   a point dropped, an index one cell off, weights rounded per point
   instead of per cell, the slot mask dropped, the final attention reading
   keys1, a softmax merge missing its last key range, B16's second 64-row
   mask tile or B3's second 128-row tile missed, B3's last K step of the
   second product dropped or its GELU taken on the fp32 sum, B13's relw
   read from the
   neighbouring column, B1's last 4-row strip unwritten or a window's keys
   from the next window, B2's last head left out of the projection, a
   B2b / B14 / B11 dq pass that skips the last key
   tile, alpha not applied at a key tile, a dk/dv strip left unwritten,
   B17's partial sums of a destination that spans blocks dropped, a B9 /
   B10 weight gradient's split-K sum that misses its last split, an
   MN-major GEMM operand read one 8-row group off):
   each must move some output by more than its bound, and each output's
   bound must catch some fault. B8's two entry points must agree exactly at
   every shape; two launches of B1-B10, B15, B16, the B2b / B14 / B11
   forward and backward and of B17 on
   the same inputs must give the same bits, and B14's expander group words must equal
   their plain version's. Times from CUDA events after a warm-up (20 calls at the
   global shapes of B2b, B14 and B13); for B11 (SDPA forward, and forward
   + backward), B12, B2b, B14 and B7's gather and scatter also the
   PyTorch call that
   computes the same function (timed only, never a path); for B13 SDPA on
   the materialised bias, for B17 ``index_add_``. Then the global-block grad
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
   decode (B16 at 32 slots), each gated against its plain paths, and one of
   64 prompts of 80 points each (86 tokens: B5 past 64 tokens, B16 at 96
   slots) the same way. Then the
   same REQUESTS requests through attn_impl 'rowbias' and 'pallas_rp'
   (JAX's unfused encoder route: B2b / B14 in all 12 blocks, no B1-B3),
   gated against the plain paths, and through attn_impl 'window' (B13 in
   all 12 blocks, 12 launches a request), gated against 'window_plain' (B13's
   plain version: its rounding points are not 'plain''s).
   Shapes: the encoder at ViT-H 1024^2, ViT-B 512^2 and ViT-B 800^2 (depth
   cut to one windowed and one global block) through 'auto', the serving
   encode and the training route's backward gated against plain bf16 and
   fp32, launches checked (every block on a kernel); at 800^2 also one
   chunk of 64 one-point prompts over the 50 x 50 grid through the
   whole-chunk decode and its plain bf16 and fp32 paths (B16 at N 2500),
   its masks gated as the serving requests' are.
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
   on its loss terms and its gradient groups pooled over GATE_BATCHES
   batches at the first step's weights (one batch reads sound paths
   anywhere in 0.41-2.42 over two sets of 16, tools/grad_spread.py --impl
   rowbias; PERF.md §6); their one-batch ratios are printed, not gated.
   Last, at batch 1 under
   'window' (B13's forward in every block, its backward the plain
   augmented recompute; the plain paths 'window_plain'), gated the same
   way but for its gradient groups, which are gated pooled over
   POOLED_GRADS batches (one batch reads sound paths anywhere in
   0.45-1.62; PERF.md §6), with each path's peak memory.
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
   the post-processing and the metrics printed. Then C9_CONFIG (the same
   SysLearner at SYSLEARNER_DIM 256: heads of 32 in the deformable core):
   one image through evaluate_seg on the 'hybrid' kernels, plain bf16
   'hybrid' and plain fp32, the kernel path held to the same gate, and one
   batch-2 'auto' train step through the kernels (B7 and B8), each with
   the launches of head width 64 and finite outputs and gradients.
   Then the vision-language evals (``vl_eval_phase``): the same SysLearner
   with the retrieval ensemble on, through the same five paths, on one
   seeded 1024^2 image: grounding of two phrases, retrieval (plain and
   ensemble), zero-shot classification against the 133 COCO class
   embeddings, and 20-step greedy captioning, KV-cached and by full
   re-run. Each kernel path no further from fp32 than SLICE_FACTOR times
   its impl's plain bf16 path's, where a discrete choice is taken along
   fp32's (the grounding's matched queries, the captions' ids: each step's
   logits teacher-forced); on plain fp32 the two captioning modes' ids
   equal (or part at a near-tie). Launches checked a call; ms a phrase, an
   image and a caption printed with the card.
   Then the LLM stage (``llm_phase``, its memory freed before the next
   phase): the same SysLearner with ``llm_dim`` 4096 through the kernels
   ('auto' and 'hybrid'), plain bf16 and plain fp32, and a LLaMA-2-7B-wide
   LLM (vocab 49408: the offline tokenizer's ids) drawn once in fp32 on the
   card, its bf16 copy the fp32 weights rounded. One seeded 1024^2 image
   and one question: ``answer_questions`` greedy over 32 tokens,
   ``evaluate_vqa_items`` with 5 beams over 8 tokens, and greedy through
   'hybrid' (B15), launches checked a request (B1 8, B2 4, B3 12, B15 6
   with 'hybrid'). Gated: the projected image features along plain fp32's
   mask attention and every step's logits along plain fp32's greedy ids
   (replayed through each path's cache), the kernels at most SLICE_FACTOR
   times as far from fp32 as plain bf16; plain fp32's cached logits within CACHE_BOUND of one
   full-sequence forward; all finite. Then int8 (the fp32 weights
   quantised): one request, finite logits, projection bytes at most
   INT8_BYTES of bf16's. Vision, splice, prefill and per-token ms, tok/s,
   peak memory and one token's device time under torch.profiler printed.
   Then stage 2 (``stage2_phase``, after the LLM stage has freed its
   models): configs/step2_instruction.yaml's SysLearner (ViT-B 1024^2,
   ``llm_dim`` 4096) and the LLaMA-2-7B-wide LLM at vocab 49408, drawn
   once (the LLM in fp32 on the card, its bf16 copy the weights rounded).
   (a) One ``make_llm_train_step`` on one ``instruction_train`` item padded
   to the YAML's 1024 positions through the kernels, plain bf16 and plain
   fp32 (plain fp32's mask attention replayed): loss_llm (its supervised
   tokens' losses, whose mean it is), the projector's gradient and the
   updated projector gated (the kernels at most
   SLICE_FACTOR times as far from fp32 as plain bf16), launches (B1 8, B2
   4, B3 12), the LLM and a FIX_PARAM parameter bit-identical after the
   step, every value finite, each path's peak printed. (b) ``Trainer(cfg,
   'cuda').train()`` on the YAML with STAGE2_OVERRIDES (batch 2 x 1024, 3
   steps): ms a step (the step function's, and the loop's from one step's
   start to the next), the set-up, launches a step (B1, B2, B3 above 0),
   peak memory,
   one more step's device time and idle share under torch.profiler; the
   loss finite, the projector moved, the frozen parameters and the LLM
   not, the final checkpoint restored into a fresh model with equal
   tensors. (c) The same with ``LLM_QUANT: int8`` at batch 1: ms a step
   and peak memory.
7. interactive: the full-width SysLearner (bf16, seeded weights), one
   seeded 1024^2 image and 8 synthetic gt masks (discs, boxes, an L), first
   clicks at their conv-dt argmax; ``encode_interactive`` once, then the
   20-round click loop (20 click slots padded with label -1: 26 tokens a
   prompt) through ``decode_interactive`` under twoway_impl 'auto' (B4, B5)
   and 'chunk' (B16 at 32 slots), launches checked each round. The kernel
   path's prompts are replayed through the plain bf16 and fp32 paths: its
   encode products, SAM's prompt decode at rounds 1, 10 and 20 and the
   unified decoder's logits pooled over the 20 rounds no further from fp32
   than SLICE_FACTOR times plain bf16's (one round's logits are printed,
   not gated: the unified decoder's mask attention thresholds its previous
   logits, and a sound path reads up to 1.60x on one round). Encode ms, ms
   a round, NoC and mIoU@k, and the p50 prompt latency of bench.py's
   protocol are printed.
8. joint (after the train phases): B4-B6 as autograd functions first
   (``c11_cases``, after the kernel phase: the forward under autograd the
   kernel's bits, the backward the plain version's vjp, a dropped keys'
   cotangent caught); then ``make_joint_train_step`` at full width with
   every stream (live class text, phrases, grounding, 3 spatial prompts
   through B4 / B5, 2 VLP images, ``retrieval_ensemble``) through the
   kernels, plain bf16 and plain fp32 at one set of weights, gated over
   GATE_BATCHES batches with fp32's matchings, draws and discrete choices
   (``joint_gate``; the five terms with one value a batch over
   JOINT_POOL_BATCHES more forward-only batches of their two streams), the
   gradients checked to reach SAM's decoder, the
   text tower and ``backbone_proj``; then JOINT_STEPS kernel steps,
   launches checked, ms a step and peak memory printed.
9. prints the kernel table as one JSON line, the nvidia-smi line, and
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
    # The kernel adds each cell's rows in row order; the plain version's
    # index_put_ adds colliding rows in its own order.
    "tap_scatter": {"acc": 1e-6},
    # dq, dk inherit the forward's rounding of o through delta = rowsum(do o).
    "flash_attention": {"o": 5e-3, "lse": 1e-5, "dq": 5e-3, "dk": 5e-3, "dv": 1e-3},
    # The deformable core: the forward and B8's dots sum fp32 products in
    # another order; the gather and B8's contrib are exact (a copy, one
    # rounding of one product); the scatter sums each cell's rows in the
    # plain version's order (each bucket's rows in row order, a long
    # bucket in 256-row pieces), so it reads 0.
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
    # order of the sums; tokens on the valid slots. Masks 1.2e-2, 1.9x the
    # largest sound reading (6.4e-3 at 16 slots): at 64 slots the swapped
    # heads of i2t1's k move the masks by 1.43e-2 only.
    "decode_tail": {"tokens": 3.5e-3, "masks": 1.2e-2},
    # B2b / B14: the online softmax rounds the unnormalised p per 64-key
    # tile (as B11 does); the backward's fp32 sums (s, dp, dq, dk, dv and the
    # bias cotangents) run in the tensor cores' order, not the plain
    # version's (each in one fixed order: two launches give the same bits).
    "flash_rowbias_fwd": {"o": 1e-2, "lse": 1e-5},
    "flash_relpos_fwd": {"o": 1e-2, "lse": 1e-5},
    "flash_rowbias_bwd": {"dq": 1e-3, "dk": 1e-3, "dv": 1e-3, "drelh": 1e-3, "drelw": 1e-3},
    "flash_relpos_bwd": {"dq": 1e-3, "dk": 1e-3, "dv": 1e-3, "drelh": 1e-3, "drelw": 1e-3},
    # B13: its fp32 sums (scores, p v in the tensor cores' order; relh / relw
    # over the head dim in order) in another order than the plain version's,
    # its softmax sum rescaled per 64-key tile and p = exp(s - m) * (1 / l)
    # where the plain version divides; p and o rounded to bf16 where the
    # plain version rounds them.
    "window_rel_attention": {"out": 1e-3},
    # B17: the same fp32 sums of the same rows, in another order.
    "segmented_scatter_add": {"out": 1e-6},
}
# Rows whose bounds are another kernel's (B11's forward and backward: its
# outputs' bounds).
BOUNDS_OF = {"flash_attention_fwd": "flash_attention", "flash_attention_bwd": "flash_attention"}
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
    # B11 (flash_attention, :193): its forward with lse and its backward.
    "flash_attention_fwd": ("flash_attention_train.cu", PALLAS + "flash_attention.py:365"),
    "flash_attention_bwd": ("flash_attention_train.cu", PALLAS + "flash_attention.py:257"),
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
    "window_rel_attention": ("window_attention.cu", PALLAS + "window_attention.py:125"),
    "segmented_scatter_add": ("seg_scatter.cu", PALLAS + "seg_scatter.py:55"),
}
# Checked and timed, on no path: JAX's row-layout glue, which its flat
# backward runs only under IUVL_GLUE_Q=0 (the query-row glue is the default),
# and the segmented scatter-add, which no function of the JAX package calls.
OFF_PATH = ("deform_bwd_glue", "segmented_scatter_add")
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


def decode_tail_valid(*args):
    """B16's wrapper with the tokens cut to the valid slots (the pad slots'
    rows are computed but never read)."""
    from iuvl_tpu_torch.ops.cuda import decode_chunk as dc

    tok, masks = dc.decode_tail(*args)
    return tok[:, :args[-1]], masks


RB_GRADS = ("dq", "dk", "dv", "drelh", "drelw")
# Kernels whose outputs must not change from launch to launch (no atomics).
DETERMINISTIC = ("flash_rowbias_fwd", "flash_relpos_fwd", "flash_rowbias_bwd",
                 "flash_relpos_bwd", "flash_attention_fwd", "flash_attention_bwd",
                 "segmented_scatter_add", "i2t_block_step", "tap_scatter", "t2i_stream",
                 "masks_upscale", "window_attention_block", "flash_attention_rowbias_proj",
                 "block_tail", "decode_tail", "window_block_backward", "block_tail_backward",
                 "ms_deform_level_fwd", "deform_scatter_dv", "deform_gather_rows",
                 "deform_bwd_glue_q", "deform_bwd_glue", "onehot_deform_level_forward")


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


def _rb_fwd_plain(a):
    """(o, lse) of B2b's (6 arguments) or B14's (7) forward plain version."""
    from iuvl_tpu_torch.ops.cuda import flash_attention as fa

    return fa.flash_rowbias_fwd_plain(*a) if len(a) == 6 else relpos_fwd_plain(*a)


def _rb_alpha_skipped(a, tile: int = 1):
    """B2b's / B14's forward whose online softmax skips the rescale by
    alpha at key tile ``tile`` (:func:`_alpha_skipped`)."""
    from iuvl_tpu_torch.ops.rel_pos_attention import rowbias_scores

    q, k, v, relh, relw = a[:5]
    eh, ew = (a[5], a[6]) if len(a) == 7 else (None, None)
    return _alpha_skipped(rowbias_scores(q, k, relh, relw, relw.shape[-1], eh, ew), v, tile)


def _alpha_skipped(s, v, tile: int = 1):
    """(o, lse) of a forward on the fp32 scores s whose online softmax skips
    the rescale by alpha = exp(m_old - m_new) at key tile ``tile``: the
    kernels' one pass (64-key tiles, p = exp(s - m) rounded to bf16 per
    tile, fp32 sums) with the running sum and output of the tiles before it
    left as they were where that tile raises a row's max."""
    m = torch.full_like(s[..., :1], float("-inf"))
    l_ = torch.zeros_like(m)
    acc = torch.zeros(*s.shape[:-1], v.shape[-1], device=s.device)
    for i, k0 in enumerate(range(0, s.shape[-1], 64)):
        st = s[..., k0:k0 + 64]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        p = torch.exp(st - m_new)
        alpha = 1.0 if i == tile else torch.exp(m - m_new)
        l_ = l_ * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(v.dtype).float() @ v[..., k0:k0 + 64, :].float()
        m = m_new
    return (acc / l_).to(v.dtype), (m + torch.log(l_)).squeeze(-1)


def _rb_last_strip_unwritten(a):
    """The resident forward with a window's last 16-row strip (its last N %
    16 rows) never written: (o, lse) of the plain version, those rows 0."""
    o, lse = (x.clone() for x in _rb_fwd_plain(a))
    r0 = (o.shape[-2] - 1) // 16 * 16
    o[..., r0:, :] = 0
    lse[..., r0:] = 0
    return o, lse


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


def _rb_dq_misses_last_key_tile(a):
    """The backward whose dq pass skips the last 64-key tile: dq, drelh and
    drelw of the plain version without that tile's ds; dk, dv sound."""
    from iuvl_tpu_torch.ops.cuda import flash_attention as fa
    from iuvl_tpu_torch.ops.rel_pos_attention import rowbias_scores

    relpos = len(a) == 10
    q, k, v, relh, relw = a[:5]
    eh, ew = (a[5], a[6]) if relpos else (None, None)
    o, lse, do = a[7:10] if relpos else a[5:8]
    w, n = relw.shape[-1], k.shape[-2]
    out = list(relpos_bwd_plain(*a) if relpos else fa.flash_rowbias_bwd_plain(*a))
    p = torch.exp(rowbias_scores(q, k, relh, relw, w, eh, ew) - lse.unsqueeze(-1))
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    ds = (p * (do.float() @ v.float().transpose(-1, -2) - delta)).to(q.dtype).float()
    del p
    ds[..., (n - 1) // 64 * 64:] = 0
    out[0] = (ds @ k.float()).to(q.dtype)
    if eh is None:
        grid = ds.reshape(*ds.shape[:-1], -1, w)
        drelh, drelw = grid.sum(-1), grid.sum(-2)
    else:
        drelh, drelw = ds @ eh.float().t(), ds @ ew.float().t()
    out[3], out[4] = drelh.to(relh.dtype), drelw.to(relw.dtype)
    return tuple(out)


def _rb_fwd_faults(n: int) -> dict:
    """The planted faults of B2b's / B14's forward at N keys."""
    faults = {"relh dropped": _zero(3), "relw dropped": _zero(4),
              "heads 0/1 swapped in v": _swap(2, 1, 1),
              "alpha's rescale skipped at key tile 1": _planted(_rb_alpha_skipped)}
    if n % 64:
        faults["the masked tail tile left unmasked"] = _planted(_rb_tail_unmasked)
    return faults


def _rb_relw_neighbour(w: int, dev) -> dict:
    """At w 64 (relw held in registers a lane): B2b's relw[q, c ^ 1] for
    relw[q, c], the neighbouring column's register."""
    if w != 64:
        return {}
    i = torch.arange(w, device=dev) ^ 1
    return {"relw from the neighbouring column":
            lambda a: a[:4] + (a[4][..., i].contiguous(),) + a[5:]}


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
    for tag, bh, side, iters in (("window", 300, 14, 10), ("global", 12, 64, 20)):
        n, d = side * side, 64
        q, k, v, do = (t(1, bh, n, d) for _ in range(4))
        rh, rw = rel_pos_tables(t(2 * side - 1, d, std=BIAS_STD), t(2 * side - 1, d, std=BIAS_STD),
                                (side, side))
        relh, relw = rel_pos_features(q, rh, rw)
        qs = q * d ** -0.5
        eh, ew = onehot_expanders((side, side), torch.bfloat16, dev)
        o, lse = fa.flash_rowbias_fwd_plain(qs, k, v, relh, relw, side)
        fwd_faults = _rb_fwd_faults(n)
        if n <= 256:  # the resident kernel: a block a (window, head) pair
            fwd_faults["the last strip of a window not written"] = _planted(
                _rb_last_strip_unwritten)
        bwd_faults = {"wrong lse (+0.05)": _planted(_rb_wrong_lse),
                      "drelh misses the last grid row": _planted(_rb_last_row_missed),
                      "heads 0/1 swapped in do": _swap(7, 1, 1),
                      "the dq pass skips the last key tile":
                          _planted(_rb_dq_misses_last_key_tile)}
        rel_bwd_faults = {**bwd_faults, "heads 0/1 swapped in do": _swap(9, 1, 1)}
        rb_fwd_faults = {**fwd_faults, **_rb_relw_neighbour(side, dev)}
        cases += [
            (f"flash_rowbias_fwd@{tag}", (qs, k, v, relh, relw, side), rb_fwd_faults, iters),
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
    from iuvl_tpu_torch.ops.cuda import seg_scatter as ss
    from iuvl_tpu_torch.ops.cuda import tap_scatter as ts
    from iuvl_tpu_torch.ops.cuda import twoway_attention as ta
    from iuvl_tpu_torch.ops.cuda import window_attention as wa
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
        "flash_attention_fwd": ((fa.flash_attention_fwd,), fa.flash_attention_fwd,
                                fa.flash_attention_fwd_plain, ("o", "lse")),
        "flash_attention_bwd": ((fa.flash_attention_bwd,), fa.flash_attention_bwd,
                                fa.flash_attention_bwd_plain, ("dq", "dk", "dv")),
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
        "window_rel_attention": one(wa.window_rel_attention_fwd,
                                    wa.window_rel_attention_fwd_plain),
        "segmented_scatter_add": one(ss.segmented_scatter_add, ss.segmented_scatter_add_plain),
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


def _rows_rolled(j, i, by):
    """Output j of the plain version with argument i's rows (its first dim)
    rolled by ``by``: a GEMM operand read ``by`` rows off (an MN-major
    operand's 8-row group shifted), every other output sound."""
    def fault(a):
        return a[:i] + (torch.roll(a[i], by, dims=0),) + a[i + 1:]
    return ("out", j, fault)


def _split_k_rows(m: int, n: int, k: int, dev) -> int:
    """Depth rows of the last split of the split-K GEMM of an (m, n) output
    over depth k, as the wrappers plan it on this card."""
    from iuvl_tpu_torch.ops.cuda.build import split_k, split_k_last_rows

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return split_k_last_rows(k, split_k(m, n, k, sms))


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


def _merge_misses_last_range(sound, calls, q, keys, pe_wk, *rest):
    """B4's merge inside B16 without its last key range (the wrapper's
    t2i_plan on this card, per-prompt keys at Tp slots)."""
    from iuvl_tpu_torch.ops.cuda import twoway_attention as ta

    b, tp, n = q.shape[0], q.shape[1], keys.shape[1]
    sms = torch.cuda.get_device_properties(keys.device).multi_processor_count
    _, splits = ta.t2i_plan(b, n, tp, b, sms)
    tiles = -(-n // ta.T2I_KEY_TILE)
    cut = (splits - 1) * -(-tiles // splits) * ta.T2I_KEY_TILE
    return sound(q, keys[:, :cut], pe_wk[:cut], *rest)


def _masks_tile_missed(a):
    """B16's masks with the second 64-row tile of every prompt unwritten
    (zero), the tokens sound."""
    tok, masks = _tail_plain(a)
    masks = masks.clone()
    masks[:, 64:128] = 0
    return tok, masks


def _i2t1_k_heads_swapped(a):
    w = dict(a[4])
    site = dict(w["i2t1"])
    for k in ("kw", "kb"):
        site[k] = site[k].clone()
        site[k][:16], site[k][16:32] = a[4]["i2t1"][k][16:32], a[4]["i2t1"][k][:16]
    w["i2t1"] = site
    return a[:4] + (w,) + a[5:]


def decode_tail_case(rs: np.random.RandomState, dev, tp: int = 16, tv: int = 7,
                     n: int = 64 * 64, prompts: int = CHUNK):
    """B16's arguments at the chunk serving shape: ``prompts`` (CHUNK) prompts
    of ``tv`` tokens in ``tp`` slots over an ``n``-row embedding (ViT-B's 64^2
    by default; 7 tokens, 5 output tokens, the point and the pad point, in
    16 slots); the decoder's weights as build_sam draws them, its
    LayerNorms' scales and biases perturbed."""
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
    tok = torch.zeros(2, prompts, tp, 256)
    tok[:, :, :tv] = torch.from_numpy(rs.randn(2, prompts, tv, 256).astype(np.float32))
    tok[1] *= 0.5
    image = torch.from_numpy(rs.randn(2, 1, n, 256).astype(np.float32))
    image[1] *= 0.5
    bf = torch.bfloat16
    return (tok[0].to(dev, bf), tok[1].to(dev, bf), image[0].to(dev, bf), image[1].to(dev, bf),
            dec.tail_weights(), 8, tv)


def rowbias_general_cases(dev):
    """The forward's general path, on its own seeded draws: B2b and B14 at
    d 80 on the 64 x 64 grid (ViT-H's head dim, 2 heads), and B14 with dense
    random expanders (every 16-row group in use) at N 200 (h 8, w 25: the
    resident kernel) and N 300 (h 200, w 296, h + w = 496: the streaming
    kernel, the expander rows by plain loads, N % 8 = 4), N not a
    multiple of 64 (160 pairs at N 200: the resident kernel takes a grid
    of a block an SM or more); relh, relw and the expanders scaled so the
    bias has about unit spread."""
    from iuvl_tpu_torch.ops.rel_pos_attention import (onehot_expanders, rel_pos_features,
                                                      rel_pos_tables)

    rs = np.random.RandomState(SEED + 9)

    def t(*shape, std=1.0):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32) * std).to(
            dev, torch.bfloat16)

    d, side = 80, 64
    q, k, v = (t(1, 2, side * side, d) for _ in range(3))
    rh, rw = rel_pos_tables(t(2 * side - 1, d, std=BIAS_STD), t(2 * side - 1, d, std=BIAS_STD),
                            (side, side))
    relh, relw = rel_pos_features(q, rh, rw)
    qs = q * d ** -0.5
    eh, ew = onehot_expanders((side, side), torch.bfloat16, dev)
    cases = [("flash_rowbias_fwd@global_d80", (qs, k, v, relh, relw, side),
              {**_rb_fwd_faults(side * side), **_rb_relw_neighbour(side, dev)}, 20),
             ("flash_relpos_fwd@global_d80", (qs, k, v, relh, relw, eh, ew),
              {**_rb_fwd_faults(side * side), "eh dropped": _zero(5)}, 20)]
    for bh, n, h, w in ((160, 200, 8, 25), (2, 300, 200, 296)):
        q, k, v = (t(1, bh, n, 64) for _ in range(3))
        faults = {**_rb_fwd_faults(n), "eh dropped": _zero(5)}
        cases.append((f"flash_relpos_fwd@dense{n}",
                      (q * 0.125, k, v, t(1, bh, n, h), t(1, bh, n, w),
                       t(h, n, std=(h + w) ** -0.5), t(w, n, std=(h + w) ** -0.5)),
                      faults, 10))
    return cases


def _flash_alpha_skipped(a):
    """B11's forward whose online softmax skips alpha at key tile 1."""
    q, k, v = a
    return _alpha_skipped(q.float() @ k.float().transpose(-1, -2), v)


def _flash_wrong_lse(a):
    """B11's backward given lse + 0.05."""
    from iuvl_tpu_torch.ops.cuda import flash_attention as fa

    return fa.flash_attention_bwd_plain(*a[:4], a[4] + 0.05, a[5])


def _flash_dq_misses_last_key_tile(a):
    """B11's backward whose dq pass skips the last 64-key tile (the masked
    one where N % 64 != 0): dq of the plain version without that tile's
    ds; dk, dv sound."""
    from iuvl_tpu_torch.ops.cuda import flash_attention as fa

    q, k, v, o, lse, do = a
    _, dk, dv = fa.flash_attention_bwd_plain(*a)
    p = torch.exp(q.float() @ k.float().transpose(-1, -2) - lse.unsqueeze(-1))
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    ds = (p * (do.float() @ v.float().transpose(-1, -2) - delta)).to(q.dtype).float()
    del p
    ds[..., (k.shape[-2] - 1) // 64 * 64:] = 0
    return (ds @ k.float()).to(q.dtype), dk, dv


def _flash_strip_unwritten(a):
    """B11's backward whose dk/dv pass never writes a warp's last 16-key
    strip (its last N % 16 keys where that is not 0): dk, dv of the plain
    version, those rows 0."""
    from iuvl_tpu_torch.ops.cuda import flash_attention as fa

    dq, dk, dv = (x.clone() for x in fa.flash_attention_bwd_plain(*a))
    r0 = (dk.shape[-2] - 1) // 16 * 16
    dk[..., r0:, :] = 0
    dv[..., r0:, :] = 0
    return dq, dk, dv


def flash_train_cases(t, main, dev):
    """B11's forward and backward on the rel-pos-augmented q, k of a global
    block, as its routes hand them: ``main`` (ViT-B 1024^2: 12 heads of N
    4096, d_qk 192, d_v 64; the training route), ViT-H 1024^2 (16 heads,
    d_qk 208 padded to 224, d_v 80; the serving route, forward only) and
    ViT-B 800^2 (N 2500, d_qk 164 padded to 192: masked last tiles); the
    backward at the plain forward's o and lse with a random cotangent."""
    from iuvl_tpu_torch.ops.cuda import flash_attention as fa
    from iuvl_tpu_torch.ops.rel_pos_attention import augment_qk_rel_pos, rel_pos_tables

    cases = []
    for tag, heads, side, d, bwd in (("vit_b_1024", 12, 64, 64, True),
                                     ("vit_h_1024", 16, 64, 80, False),
                                     ("vit_b_800", 12, 50, 64, True)):
        if tag == "vit_b_1024":
            q_aug, k_aug, v, do = main
        else:
            n = side * side
            q, k, v = (t(1, heads, n, d) for _ in range(3))
            rh, rw = rel_pos_tables(t(2 * side - 1, d, std=BIAS_STD),
                                    t(2 * side - 1, d, std=BIAS_STD), (side, side))
            q_aug, k_aug = augment_qk_rel_pos(q, k, rh, rw)
            do = t(1, heads, n, d) if bwd else None
        cases.append((f"flash_attention_fwd@{tag}", (q_aug, k_aug, v),
                      {"heads 0/1 swapped in v": _swap(2, 1, 1),
                       "relh dropped from q_aug": _zero_cols(0, d, d + side),
                       "alpha not applied at key tile 1": _planted(_flash_alpha_skipped),
                       "wrong lse (+0.05)": _planted(lambda a: (
                           lambda o, lse: (o, lse + 0.05))(*fa.flash_attention_fwd_plain(*a)))},
                      10))
        if bwd:
            o, lse = fa.flash_attention_fwd_plain(q_aug, k_aug, v)
            cases.append((f"flash_attention_bwd@{tag}", (q_aug, k_aug, v, o, lse, do),
                          {"wrong lse (+0.05)": _planted(_flash_wrong_lse),
                           "heads 0/1 swapped in do": _swap(5, 1, 1),
                           "the dq pass skips the last key tile":
                               _planted(_flash_dq_misses_last_key_tile),
                           "the last dk/dv strip unwritten": _planted(_flash_strip_unwritten)},
                          5))
    return cases


def _wb_last_strip_unwritten(a):
    """B1 leaving rows 192-195 of each window (its last 4-row strip) unwritten."""
    from iuvl_tpu_torch.ops.cuda import window_block as wb

    out = wb.window_attention_block_plain(*a).clone()
    out[:, 192:196] = 0
    return (out,)


def _wb_keys_of_next_window(a):
    """B1 taking window w's keys from window w + 1 (the last window's from
    window 0): the plain version with k rolled over the windows."""
    from iuvl_tpu_torch.ops.cuda import window_block as wb

    attend = wb.rowbias_attention
    rolled = lambda q, k, *rest: attend(q, torch.roll(k, -1, 0), *rest)  # noqa: E731
    with _patched(wb, "rowbias_attention", rolled):
        return (wb.window_attention_block_plain(*a),)


def window_block_faults(d: int) -> dict:
    """B1's planted faults (head dim d)."""
    return {"bqkv dropped": _zero(2), "bo dropped": _zero(4), "rel_pos_h dropped": _zero(5),
            "rel_pos_w dropped": _zero(6), "heads 0/1 swapped in wo": _swap(3, 1, d),
            "the last 4-row strip of each window unwritten": _planted(_wb_last_strip_unwritten),
            "window w's keys taken from window w + 1": _planted(_wb_keys_of_next_window)}


def _last_head_dropped(a):
    """B2 leaving the last head out of the projection (its o_h zero: v's last
    head zeroed)."""
    v = a[2].clone()
    v[:, -1] = 0
    return a[:2] + (v,) + a[3:]


ROWBIAS_PROJ_FAULTS = {"bo dropped": _zero(6), "relh dropped": _zero(3),
                       "relw dropped": _zero(4), "heads 0/1 swapped in v": _swap(2, 1, 1),
                       "the last head left out of the projection": _last_head_dropped}


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
    # B1 at ViT-H (C 1280, 16 heads of 80) and at ViT-B 512^2 (9 windows); B2
    # at ViT-B 512^2 (a 32 x 32 grid).
    hrh, hrw = rel_pos_tables(t(27, 80, std=s), t(27, 80, std=s), (14, 14))
    win_h = (t(25, 196, 1280), t(3 * 1280, 1280, std=1280 ** -0.5),
             t(3 * 1280, std=s, dtype=f32), t(1280, 1280, std=1280 ** -0.5),
             t(1280, std=s, dtype=f32), hrh, hrw, 16)
    win9 = (t(9, 196, c),) + win[1:]
    q5, k5, v5 = (t(1, heads, 1024, d) for _ in range(3))
    relh5, relw5 = rel_pos_features(q5, *rel_pos_tables(t(63, d, std=s), t(63, d, std=s),
                                                        (32, 32)))
    flash512 = (q5 * d ** -0.5, k5, v5, relh5, relw5, t(c, c, std=c ** -0.5),
                t(c, std=s, dtype=f32), 32)
    tail = block_tail_case(t, n, c)
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
    tail_bwd = tail[:2] + (t(n, c),) + tail[2:6] + (tail[6].t().contiguous(),)
    q_aug, k_aug = augment_qk_rel_pos(q, k, grh, grw)
    flash_train = (q_aug, k_aug, v, t(1, heads, n, d))
    coords = torch.from_numpy(rs.rand(N_TARGETS, MATCH_POINTS, 2).astype(np.float32)).to(dev)
    base, wgts, _, span = _tap_weights(256, 256, coords, f32)
    scatter = (base.to(torch.int32).contiguous(),
               (t(N_TARGETS, MATCH_POINTS, 1, dtype=f32) * wgts).contiguous(), span)
    # B12 skewed: the same points drawn within about a pixel of the maps'
    # centre, so that hundreds of rows hit one cell.
    coords = torch.from_numpy((0.5 + rs.randn(N_TARGETS, MATCH_POINTS, 2) / 256)
                              .astype(np.float32)).to(dev)
    base, wgts, _, _ = _tap_weights(256, 256, coords, f32)
    scatter_skew = (base.to(torch.int32).contiguous(),
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
        ("decode_tail", decode_tail_case(rs, dev), DECODE_TAIL_FAULTS, 5),
        ("window_attention_block", win, window_block_faults(d), 10),
        ("window_attention_block@vit_h", win_h, window_block_faults(80), 10),
        ("window_attention_block@nw9", win9, window_block_faults(d), 10),
        ("flash_attention_rowbias_proj", flash, ROWBIAS_PROJ_FAULTS, 10),
        ("flash_attention_rowbias_proj@n1024_w32", flash512, ROWBIAS_PROJ_FAULTS, 10),
        ("block_tail", tail, BLOCK_TAIL_FAULTS, 10),
        ("masks_upscale", up, UPSCALE_FAULTS, 5),
        ("t2i_stream", t2i, T2I_FAULTS, 10),
        ("i2t_block_step", i2t, I2T_FAULTS, 10),
    ] + i2t_cases(t, i2t) + t2i_stream_cases(t2i) + c5_cases(up, t2i, i2t) + block_tail_cases(
        dev) + decode_tail_cases(dev) + [
        ("window_block_backward", win_bwd,
         {"rel-pos branch dropped": lambda a: a[:5] + (torch.zeros_like(rh),
                                                        torch.zeros_like(rw)) + a[7:],
          "bqkv dropped": _zero(3), "dbo misses the last 16 rows": _tile_missed(4, 1, 16),
          "heads 0/1 swapped in g": _swap(1, 2, d),
          "dWo's split-K sum misses its last split":
              _tile_missed(3, 1, _split_k_rows(c, c, 25 * 196, dev)),
          "Wo (MN-major in do) read one 8-row group off": _rows_rolled(0, 4, 8)}, 5),
        ("block_tail_backward", tail_bwd,
         {"db2 misses the last 16 rows": _tile_missed(6, 2, 16), "LN bias dropped": _zero(4),
          "b1 dropped": _zero(6), "dscale misses the last 16 rows": _tile_missed(1, 2, 16),
          "dW2's split-K sum misses its last split":
              _tile_missed(5, 2, _split_k_rows(c, 4 * c, n, dev)),
          "g (MN-major in dW2) read one 8-row group off": _rows_rolled(5, 2, 8)}, 5),
    ] + [(name, args, {"rows one cell off": _shift(0, 1, span - 1),
                       "taps 0/1 swapped": _swap(1, 2, 1)}, 10)
         for name, args in (("tap_scatter", scatter), ("tap_scatter@skewed", scatter_skew))] + [
        ("ms_deform_level_fwd", deform_fwd,
         {"slot 2 at offset w - 1": _wrong_wrap(md.ms_deform_level_fwd_plain),
          "validity mask dropped": _no_validity(md.ms_deform_level_fwd_plain)}, 10),
        ("deform_gather_rows", gather,
         {"slot 2 at offset w - 1": _wrong_wrap(md.deform_gather_rows_plain),
          "heads 0/1 swapped in v": _swap(0, 0, 1)}, 10),
        ("deform_bwd_glue_q", glue, glue_faults, 10),
        ("deform_bwd_glue", glue, glue_faults, 10),
        ("deform_scatter_dv", scatter_dv, scatter_faults(), 10),
        ("onehot_deform_level_forward", onehot,
         {"slot s read from slot s+1's columns": lambda a: (torch.roll(a[0], -d, dims=-1),)
          + a[1:],
          "the last point dropped": _drop_last_point,
          "idx one cell off": _shift(1, 1, side5 * side5 - 1),
          "weights rounded per point, not per cell": _planted(_onehot_per_point)}, 20),
    ] + rowbias_cases(t, rs, dev) + window_cases(t, dev) + seg_scatter_cases(rs, scatter_dv) + [
        # B16 past 32 slots (C3): prompts of 34 and 50 points (40 and 56
        # tokens) in 48 and 64 slots, 8 of them pad slots.
        (f"decode_tail@tp{tp}", decode_tail_case(rs, dev, tp, tp - 8), DECODE_TAIL_FAULTS, 3)
        for tp in (48, 64)] + rowbias_general_cases(dev) + flash_train_cases(t, flash_train, dev) \
        + c8_b7_cases(i2t, dev) + c9_cases(dev)


def _bucket_last_row_dropped(a):
    """The plain scatter without the last row (in row order) of its longest
    bucket whose last row is not zero (the cells that clipped points crowd
    into carry zero rows): a bucket's sum that stops one row short."""
    from iuvl_tpu_torch.ops.cuda import msdeform as md

    contrib, idx, hw = a[:3]
    _, order, start = md.scatter_buckets_plain(idx, hw)
    lens = start[1:] - start[:-1]
    last = order[(start[1:] - 1).clamp(min=0)]
    live = (lens > 0) & (contrib[last].float().abs().sum(1) > 0)
    contrib = contrib.clone()
    contrib[last[int(torch.argmax(lens * live))]] = 0
    return (contrib,) + a[1:]


def scatter_faults() -> dict:
    """B7 scatter's planted faults: the last rows missed, a bucket's last
    row dropped, slot 2's bucket read at c - w + 1 (offset w - 1)."""
    from iuvl_tpu_torch.ops.cuda import msdeform as md

    return {"misses the last 16 rows": _tile_missed(0, 0, 16),
            "a bucket's last row dropped": _bucket_last_row_dropped,
            "slot 2 at offset w - 1": _wrong_wrap(md.deform_scatter_dv_plain)}


def c8_b7_cases(i2t, dev):
    """C8: B5 at T 80 (per-prompt keys, the kernel phase's weights and keys)
    and B16 at 96 slots (80 points, 5 output tokens and the pad point: 86
    tokens); B7's forward and scatter at the res5 level (32^2, buckets of
    ~84 rows, some past the scatter's 256-row pieces) and the scatter with
    every point of a head within a 2 x 2 cell window of res3 (four buckets
    of ~21,500 rows a head). Their own draws."""
    from iuvl_tpu_torch.models.xdecoder.pixel_decoder import encoder_reference_points
    from iuvl_tpu_torch.ops.cuda import deform_bwd_glue as dg
    from iuvl_tpu_torch.ops.cuda import msdeform as md
    from iuvl_tpu_torch.ops.msdeform import wide_idx_wslot

    rs = np.random.RandomState(SEED + 16)

    def t(*shape, dtype=torch.bfloat16):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dev, dtype)

    kp, vp = t(CHUNK, 80, i2t[2].shape[-1]), t(CHUNK, 80, i2t[3].shape[-1])
    # At 256 prompts of 96 slots t2i_plan gives B4 one key range: no merge
    # to miss.
    one_range = {k: v for k, v in DECODE_TAIL_FAULTS.items() if "key range" not in k}
    cases = [("i2t_block_step@t80", i2t[:2] + (kp, vp) + i2t[4:], I2T_FAULTS, 5),
             ("decode_tail@tp96", decode_tail_case(rs, dev, 96, 86), one_range, 3)]
    nh, pts, d = 8, 4, 64
    ref = encoder_reference_points([(32, 32), (64, 64), (128, 128)], dev)[:, 0]
    lq = ref.shape[0]

    def scatter_case(side, xy):
        idx, wslot = wide_idx_wslot(side, side, xy[0, ..., 0], xy[0, ..., 1])
        aw = torch.from_numpy(rs.rand(nh, lq, pts).astype(np.float32) / 12).to(dev)
        g4 = md.deform_gather_rows_plain(t(nh, side * side, d), idx, side)
        glue = (g4, t(nh * lq, d, dtype=torch.float32),
                (wslot * aw[..., None]).reshape(-1, 4).contiguous(), pts)
        return (dg.deform_bwd_glue_plain(*glue)[0], idx, side * side, side)

    side = 32
    xy = ref[None, None, :, None, :] * side - 0.5 + torch.from_numpy(
        rs.randn(2, nh, lq, pts, 2).astype(np.float32) * 2.5).to(dev)
    aw = torch.from_numpy(rs.rand(2, nh, lq, pts).astype(np.float32) / 12).to(dev)
    fwd = (t(2, nh, side * side, d), xy[..., 0].contiguous(), xy[..., 1].contiguous(), aw, side,
           side)
    cases.append(("ms_deform_level_fwd@32x32", fwd,
                  {"slot 2 at offset w - 1": _wrong_wrap(md.ms_deform_level_fwd_plain),
                   "validity mask dropped": _no_validity(md.ms_deform_level_fwd_plain)}, 10))
    cases.append(("deform_scatter_dv@32x32", scatter_case(side, xy), scatter_faults(), 10))
    side = 128
    corner = torch.from_numpy(rs.randint(0, side - 1, (1, nh, 1, 1, 2)).astype(np.float32))
    xy = (corner + 2 * torch.from_numpy(rs.rand(1, nh, lq, pts, 2).astype(np.float32))).to(dev)
    cases.append(("deform_scatter_dv@skewed", scatter_case(side, xy), scatter_faults(), 10))
    return cases


def c9_cases(dev):
    """C9: the deformable kernels at head widths 32 and 128 (SysLearner
    widths 256 and 1024 over 8 heads): B7's forward, gather and scatter and
    B8 (both entries) at the res3 level of the batch-2 step (8 heads, the
    21,504 queries x 4 points near their reference points, image 0 for the
    per-image kernels), B15 at the hybrid eval's res5 level; B15 also at d
    64 on a 16^2 and a 50^2 table (2,500 cells: past the shared memory, the
    L2 instance) and in fp32. Each with its d-64 planted faults. Their own
    draws."""
    from iuvl_tpu_torch.models.xdecoder.pixel_decoder import encoder_reference_points
    from iuvl_tpu_torch.ops.cuda import deform_bwd_glue as dg
    from iuvl_tpu_torch.ops.cuda import msdeform as md
    from iuvl_tpu_torch.ops.msdeform import wide_idx_wslot, wide_map

    rs = np.random.RandomState(SEED + 17)

    def t(*shape, dtype=torch.bfloat16):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dev, dtype)

    nh, pts = 8, 4
    ref = encoder_reference_points([(32, 32), (64, 64), (128, 128)], dev)[:, 0]
    lq = ref.shape[0]

    def near(b, side):
        xy = ref[None, None, :, None, :] * side - 0.5 + torch.from_numpy(
            rs.randn(b, nh, lq, pts, 2).astype(np.float32) * 2.5).to(dev)
        aw = torch.from_numpy(rs.rand(b, nh, lq, pts).astype(np.float32) / 12).to(dev)
        return xy[..., 0].contiguous(), xy[..., 1].contiguous(), aw

    def onehot_case(side, d, dtype=torch.bfloat16):
        x, y, aw = near(1, side)
        idx, wslot = wide_idx_wslot(side, side, x[0], y[0])
        v = t(1, nh, side * side, d, dtype=dtype)
        args = (wide_map(v, side).reshape(nh, side * side, 4 * d), idx.contiguous(),
                (wslot * aw[0][..., None]).transpose(-1, -2).contiguous(), pts)
        faults = {"slot s read from slot s+1's columns":
                  lambda a: (torch.roll(a[0], -d, dims=-1),) + a[1:],
                  "the last point dropped": _drop_last_point,
                  "idx one cell off": _shift(1, 1, side * side - 1)}
        if dtype == torch.bfloat16:  # in fp32 the rounding is the identity
            faults["weights rounded per point, not per cell"] = _planted(_onehot_per_point)
        return args, faults

    cases = []
    side = 128
    for d in (32, 128):
        x, y, aw = near(2, side)
        v = t(2, nh, side * side, d)
        idx, wslot = wide_idx_wslot(side, side, x[0], y[0])
        gather = (v[0], idx, side)
        glue = (md.deform_gather_rows_plain(*gather), t(nh * lq, d, dtype=torch.float32),
                (wslot * aw[0][..., None]).reshape(-1, 4).contiguous(), pts)
        glue_faults = {"dots slots 0/1 swapped": _out_cols_swapped(dg.deform_bwd_glue_plain, 1),
                       "contrib to the wrong slot (wa slots 0/1 swapped)": _swap(2, 1, 1)}
        cases += [
            (f"ms_deform_level_fwd@d{d}", (v, x, y, aw, side, side),
             {"slot 2 at offset w - 1": _wrong_wrap(md.ms_deform_level_fwd_plain),
              "validity mask dropped": _no_validity(md.ms_deform_level_fwd_plain)}, 10),
            (f"deform_gather_rows@d{d}", gather,
             {"slot 2 at offset w - 1": _wrong_wrap(md.deform_gather_rows_plain),
              "heads 0/1 swapped in v": _swap(0, 0, 1)}, 10),
            (f"deform_bwd_glue_q@d{d}", glue, glue_faults, 10),
            (f"deform_bwd_glue@d{d}", glue, glue_faults, 10),
            (f"deform_scatter_dv@d{d}", (dg.deform_bwd_glue_plain(*glue)[0], idx, side * side,
                                         side), scatter_faults(), 10),
            (f"onehot_deform_level_forward@d{d}", *onehot_case(32, d), 20)]
    for tag, side, dtype in (("n256", 16, torch.bfloat16), ("n2500", 50, torch.bfloat16),
                             ("fp32", 32, torch.float32)):
        cases.append((f"onehot_deform_level_forward@{tag}", *onehot_case(side, 64, dtype), 20))
    return cases


def block_tail_case(t, n: int, c: int) -> tuple:
    """B3's arguments at T ``n`` rows of width ``c`` (hidden 4 c): x, a,
    the LayerNorm's fp32 scale and bias, then lin1 and lin2 in nn.Linear
    layout with their biases."""
    h, s, f32 = 4 * c, BIAS_STD, torch.float32
    return (t(n, c), t(n, c), 1.0 + t(c, std=0.1, dtype=f32), t(c, std=s, dtype=f32),
            t(h, c, std=c ** -0.5), t(h, std=s), t(c, h, std=h ** -0.5), t(c, std=s))


def _tail_tile_missed(a):
    """B3 with the second 128-row tile's MLP missing: rows 128-255 keep x + a."""
    from iuvl_tpu_torch.ops.cuda import mlp_block as mb

    out = mb.block_tail_plain(*a).clone()
    out[128:256] = (a[0] + a[1])[128:256]
    return (out,)


def _tail_gelu_on_fp32(a):
    """B3 with the GELU taken on the fp32 sum of the first product and b1,
    not on its bf16 value."""
    from iuvl_tpu_torch.ops.common import layer_norm_f32
    from iuvl_tpu_torch.ops.cuda import mlp_block as mb

    x, xa, scale, bias, w1, b1, w2, b2 = a
    x1 = x + xa
    y = layer_norm_f32(x1, scale, bias, mb.EPS).to(x.dtype)
    h = torch.nn.functional.gelu(y.float() @ w1.float().t() + b1.float(), approximate="tanh")
    return (x1 + (h.to(x.dtype) @ w2.t() + b2),)


BLOCK_TAIL_FAULTS = {"b1 dropped": _zero(5), "b2 dropped": _zero(7), "LN bias dropped": _zero(3),
                     "a row tile past the first missed": _planted(_tail_tile_missed),
                     "the last K step of the second product dropped": _zero_cols(6, -64, None),
                     "GELU on the fp32 sum, not the bf16 value": _planted(_tail_gelu_on_fp32)}


def block_tail_cases(dev):
    """B3 past the kernel phase's case (ViT-B 1024^2): ViT-H (C 1280, H
    5120), ViT-B 800^2 (T 2500: a ragged last row tile) and batch 2 (T
    8192). Their own draws."""
    rs = np.random.RandomState(SEED + 6)

    def t(*shape, std=1.0, dtype=torch.bfloat16):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32) * std).to(dev, dtype)

    return [(f"block_tail@{tag}", block_tail_case(t, n, c), BLOCK_TAIL_FAULTS, 10)
            for tag, n, c in (("vit_h", 4096, 1280), ("t2500", 2500, 768), ("b2", 8192, 768))]


def decode_tail_cases(dev):
    """B16 past the kernel phase's case (256 prompts of 7 tokens in 16 slots
    over N 4096): C7's N 2500 (ViT-B 800^2, which the kernel refused
    before) and the interactive round (8 prompts, 26 tokens in 32 slots).
    Their own draws."""
    rs = np.random.RandomState(SEED + 7)
    # At 8 prompts t2i_plan splits the keys in 32 ranges of 128: one range
    # missed moves the tokens by 3.6e-3 and the masks by 7.0e-3 (plain
    # version on the CPU), at the bounds, so that fault is held at 256
    # prompts (2 ranges) only.
    round_faults = {k: v for k, v in DECODE_TAIL_FAULTS.items() if "key range" not in k}
    return [("decode_tail@n2500", decode_tail_case(rs, dev, n=2500), DECODE_TAIL_FAULTS, 5),
            ("decode_tail@8p_tp32", decode_tail_case(rs, dev, 32, 26, prompts=8),
             round_faults, 20)]


# B5's planted faults; the last one at the prompt's last token (past 16
# tokens in the T 26 and T 64 cases).
I2T_FAULTS = {"bq dropped": _zero(5), "bo dropped": _zero(7), "pe_wq dropped": _zero(1),
              "LN bias dropped": _zero(9), "heads 0/1 swapped in kp": _swap(2, 2, 16),
              "the last token's vp zeroed": lambda a: a[:3] + (_last_token_zeroed(a[3]),) + a[4:]}


# B4's planted faults. (bk adds q.bk to every key's score alike: softmax
# cancels it.)
def _t2i_last_range_missed(a):
    """B4's plain version without the keys of the last key range that the
    wrapper's split (t2i_plan, on this card) gives the call: a merge that
    misses its last range."""
    from iuvl_tpu_torch.ops.cuda import twoway_attention as ta

    q, keys, pe = a[:3]
    n = keys.shape[1]
    sms = torch.cuda.get_device_properties(keys.device).multi_processor_count
    _, splits = ta.t2i_plan(q.shape[0], n, q.shape[1], keys.shape[0], sms)
    tiles = -(-n // ta.T2I_KEY_TILE)
    cut = (splits - 1) * -(-tiles // splits) * ta.T2I_KEY_TILE
    return (ta.t2i_stream_plain(q, keys[:, :cut].contiguous(), pe[:cut].contiguous(), *a[3:]),)


T2I_FAULTS = {"bv dropped": _zero(6), "pe_wk dropped": _zero(2),
              "heads 0/1 swapped in q": _swap(0, 2, 16),
              "a merge misses its last key range": _planted(_t2i_last_range_missed)}


def _upscale_groups_swapped(a):
    """B6's plain version with the (di, dj) groups 1 and 2 swapped in the
    output columns (t, di, ei, dj, ej)."""
    from iuvl_tpu_torch.ops.cuda import mask_upscale as mu

    out = mu.masks_upscale_plain(*a)
    x = out.view(*out.shape[:2], mu.M, 2, 2, 2, 2)  # (t, di, ei, dj, ej)
    y = x.clone()
    y[:, :, :, 0, :, 1], y[:, :, :, 1, :, 0] = x[:, :, :, 1, :, 0], x[:, :, :, 0, :, 1]
    return (y.reshape(out.shape),)


UPSCALE_FAULTS = {"b1 dropped": _zero(2), "b2 dropped": _zero(6), "LN bias dropped": _zero(4),
                  "mask tokens 0/1 swapped": _swap(7, 1, 1),
                  "(di, dj) groups 1 and 2 swapped in the output columns":
                      _planted(_upscale_groups_swapped)}


def t2i_stream_cases(main):
    """B4 past the kernel phase's case (256 prompts of 7 tokens on per-prompt
    keys): block 0's call (batch-1 keys), per-prompt keys at T 26 (a
    20-click prompt) and T 64, and an interactive round (8 prompts of 26
    tokens). Their own draws, so that the other cases' inputs stay."""
    rs = np.random.RandomState(SEED + 4)
    q, keys = main[:2]

    def t(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32) * 0.25).to(q.device, q.dtype)

    cases = [("t2i_stream@batch1_t7", (q, keys[:1].contiguous()) + main[2:], 10)]
    for tok in (26, 64):
        cases.append((f"t2i_stream@t{tok}", (t(CHUNK, tok, q.shape[-1]),) + main[1:], 5))
    cases.append(("t2i_stream@round8_t26", (t(8, 26, q.shape[-1]), keys[:8].contiguous())
                  + main[2:], 20))
    return [(name, args, T2I_FAULTS, iters) for name, args, iters in cases]


def c5_cases(up, t2i, i2t):
    """C5: key counts that JAX's functions take and the kernels refused
    before: B4 and B5 at N 2500 (ViT-B at 800^2, a 50^2 grid), B6 at N 900
    (30^2); the same weights, keys, PE and hyper drawn anew (their own
    draws)."""
    rs = np.random.RandomState(SEED + 5)
    dev = up[0].device

    def t(*shape, std=1.0):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32) * std).to(dev, torch.bfloat16)

    n, cd, i_dim = 2500, t2i[1].shape[-1], t2i[0].shape[-1]
    keys, pe = t(CHUNK, n, cd), t(n, i_dim, std=BIAS_STD)
    return [("t2i_stream@n2500", (t2i[0], keys, pe) + t2i[3:], T2I_FAULTS, 10),
            ("i2t_block_step@n2500", (keys, pe) + i2t[2:], I2T_FAULTS, 10),
            ("masks_upscale@n900", (t(CHUNK, 900, up[0].shape[-1]),) + up[1:], UPSCALE_FAULTS, 5)]


def _last_token_zeroed(vp):
    vp = vp.clone()
    vp[:, -1] = 0
    return vp


def i2t_cases(t, main):
    """B5 past the kernel phase's case (256 prompts of 7 tokens on per-prompt
    keys): block 0's call (keys batch 1, one image embedding for every
    prompt), and per-prompt keys at T 26 (a 20-click prompt) and T 64."""
    keys, pe, kp, vp = main[:4]
    cases = [("i2t_block_step@batch1_t7", (keys[:1].contiguous(),) + main[1:], 10)]
    for tok in (26, 64):
        cases.append((f"i2t_block_step@t{tok}",
                      (keys, pe, t(CHUNK, tok, kp.shape[-1]), t(CHUNK, tok, vp.shape[-1]))
                      + main[4:], 5))
    return [(name, args, I2T_FAULTS, iters) for name, args, iters in cases]


# B16's planted faults, at any slot count.
DECODE_TAIL_FAULTS = {
    "slot mask dropped": _planted(lambda a: _tail_plain(a, t_valid=a[0].shape[1])),
    "heads 0/1 swapped in i2t1's token-side k": _i2t1_k_heads_swapped,
    "the final attention reads keys1": _t2i_patched(_final_reads_keys1),
    "a t2i merge misses its last key range": _t2i_patched(_merge_misses_last_range),
    "the masks' second 64-row tile missed": _planted(_masks_tile_missed)}


def _window_tail_unmasked(a):
    """B13's function with the keys past N in the last 64-key tile left
    unmasked (zero rows scoring 0 with no bias, as an unmasked padded tile
    would)."""
    from iuvl_tpu_torch.ops.cuda.window_attention import window_rel_scores

    q, k, v, rh, rw = a
    s = window_rel_scores(q, k, rh, rw)
    s = torch.cat([s, s.new_zeros(*s.shape[:-1], -s.shape[-1] % 64)], -1)
    p = torch.softmax(s, -1)[..., :k.shape[-2]].to(v.dtype)
    return ((p.float() @ v.float()).to(q.dtype),)


def window_cases(t, dev):
    """B13 at the two grids 'window' sends it at ViT-B 1024^2: the windowed
    blocks (25 windows x 12 heads of N 196, w 14) and the global ones (12
    heads of N 4096, w 64), d 64; the expanded tables rounded to bf16 as
    the wrapper of the autograd function hands them over."""
    from iuvl_tpu_torch.ops.rel_pos_attention import rel_pos_tables

    cases = []
    for tag, bh, side, iters in (("window", 300, 14, 10), ("global", 12, 64, 20)):
        n, d = side * side, 64
        q, k, v = (t(1, bh, n, d) for _ in range(3))
        rh, rw = rel_pos_tables(t(2 * side - 1, d, std=BIAS_STD),
                                t(2 * side - 1, d, std=BIAS_STD), (side, side))
        # relw[q, c ^ 1] for relw[q, c]: the neighbouring column's register.
        neighbour = torch.arange(side, device=dev) ^ 1
        faults = {"relh dropped": _zero(3), "relw dropped": _zero(4),
                  "heads 0/1 swapped in v": _swap(2, 1, 1),
                  "relw from the neighbouring column": lambda a, i=neighbour: a[:4] + (
                      a[4][:, i].contiguous(),)}
        if n % 64:
            faults["the masked tail tile left unmasked"] = _planted(_window_tail_unmasked)
        cases.append((f"window_rel_attention@{tag}",
                      (q, k, v, rh.to(torch.bfloat16), rw.to(torch.bfloat16)), faults, iters))
    return cases


def _seg_span_dropped(a):
    """B17 dropping the partial sums that pass 2 adds: the plain version
    without the rows of each first-pass block's first run where that run
    began in an earlier block (a destination spanning blocks)."""
    from iuvl_tpu_torch.ops.cuda import seg_scatter as ss

    contrib, idx, n_out = a
    order = torch.argsort(idx, stable=True)
    key = idx[order]
    rows_a = ss.block_rows(contrib.shape[1])
    start = torch.arange(key.numel(), device=key.device) // rows_a * rows_a
    drop = (start > 0) & (key == key[(start - 1).clamp(min=0)])
    kept = contrib.clone()
    kept[order[drop]] = 0
    return (ss.segmented_scatter_add_plain(kept, idx, n_out),)


def seg_scatter_cases(rs, scatter_dv):
    """B17 at the shape of B7's d_value scatter in the batch-2 train step
    (the res3 level's 688,128 (head, query, point) rows of 4 x 64 into the
    8 x 128^2 wide-map rows; the destinations of that case's taps) and at
    tests/test_seg_scatter.py's skewed case (3000 rows of 64, all into row
    0 of 512)."""
    contrib, idx, hw, _ = scatter_dv
    nh = idx.shape[0]
    dest = (idx.long() + torch.arange(nh, device=idx.device).view(nh, 1, 1) * hw)
    d_value = (contrib.to(torch.bfloat16).contiguous(), dest.reshape(-1).to(torch.int32),
               nh * hw)
    skew = (torch.from_numpy(rs.randn(3000, 64).astype(np.float32)).to(contrib.device,
                                                                        torch.bfloat16),
            torch.zeros(3000, dtype=torch.int32, device=contrib.device), 512)
    # C4: the widths and dtypes of JAX's function that the first kernel
    # refused (random rows into random destinations).
    widths = []
    for width, dtype, rows, n_out in SEG_WIDTHS:
        contrib = torch.from_numpy(rs.randn(rows, width).astype(np.float32)).to(
            skew[0].device, dtype)
        idx = torch.from_numpy(rs.randint(0, n_out, rows).astype(np.int32)).to(skew[0].device)
        widths.append((f"w{width}_{str(dtype).split('.')[-1]}", (contrib, idx, n_out), 10))
    return [(f"segmented_scatter_add@{tag}", args,
             {"misses the last 16 rows": _tile_missed(0, 0, 16),
              "rows one destination off": _shift(1, 1, args[2] - 1),
              "a spanning destination's partial sum dropped": _planted(_seg_span_dropped)},
             iters)
            for tag, args, iters in [("d_value", d_value, 10), ("skewed", skew, 10)] + widths]


# (W, dtype, rows, n_out) of the C4 cases.
SEG_WIDTHS = ((96, torch.bfloat16, 131072, 32768), (768, torch.bfloat16, 65536, 16384),
              (256, torch.float32, 131072, 32768), (256, torch.float16, 131072, 32768),
              (97, torch.float32, 131072, 32768))


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
        # The q-projection once a keys batch (once with batch-1 keys), the
        # out-projection and the attention a prompt.
        pk, n, cd = args[0].shape
        p, tok, i = args[2].shape
        flops = 2 * (pk + p) * n * cd * i + 4 * p * n * tok * i
    elif name == "window_block_backward":
        nw, n, c = args[0].shape
        flops = 22 * nw * n * c * c + 12 * nw * n * n * c
    elif name == "block_tail_backward":
        flops = 10 * args[0].shape[0] * args[0].shape[1] * args[5].shape[0]
    elif name.startswith("flash_attention_"):
        # Forward: q k^T and p v; backward: s once from the lse, dp, dq, dk, dv.
        b, h, n, dqk = args[0].shape
        dv = args[2].shape[-1]
        flops = b * h * 2 * n * n * ((dqk + dv) if name.endswith("_fwd") else (3 * dqk + 2 * dv))
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
    elif name == "window_rel_attention":
        # q k^T and p v, 4 N^2 d a head; relh and relw, 4 N w d.
        b, h, n, d = args[0].shape
        flops = b * h * (4 * n * n * d + 4 * n * args[3].shape[0] * d)
    elif name == "segmented_scatter_add":  # an fp32 add per element of contrib
        return args[0].numel(), nbytes, F32_FLOPS
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
    exists (timed only): SDPA forward, and forward + backward, for B11's
    forward and backward; ``index_add_`` for B12. None for the rest: no
    single call fuses their projections, rel-pos terms, norms or backward."""
    if name == "flash_attention_fwd":
        return lambda: torch.nn.functional.scaled_dot_product_attention(*args, scale=1.0)
    if name == "flash_attention_bwd":
        q, k, v = (a.detach().requires_grad_() for a in args[:3])
        do = args[5]

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
    if name == "window_rel_attention":
        # SDPA on the materialised (BH, N, N) bias, made outside the call.
        from iuvl_tpu_torch.ops.cuda.window_attention import window_rel_bias

        q, k, v, rh, rw = args
        bias_h, bias_w = window_rel_bias(q, rh, rw)
        bias = (bias_h + bias_w).to(q.dtype)
        del bias_h, bias_w
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=bias, scale=q.shape[-1] ** -0.5)
    if name == "segmented_scatter_add":
        contrib, idx, n_out = args
        return lambda: torch.zeros((n_out, contrib.shape[1]), device=contrib.device).index_add_(
            0, idx, contrib.float())
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
        bounds = KERNEL_BOUNDS[BOUNDS_OF.get(base, base)]
        out = as_tuple(kern(*args))
        torch.cuda.synchronize()
        if base in DETERMINISTIC:
            again = as_tuple(kern(*args))
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(out, again))
            log(f"kernel {name}: two launches bit-equal {same}")
            if not same:
                failed.append(f"{name}: two launches on the same inputs differ")
            del again
        if base == "flash_relpos_fwd":  # B14's group words against their plain version
            from iuvl_tpu_torch.ops.cuda import flash_attention as fa

            words = fa.expander_groups(*args[5:7])
            same = torch.equal(words, fa.expander_groups_plain(*args[5:7]))
            log(f"kernel {name}: expander group words {words.tolist()[:4]}... equal to the "
                f"plain version's {same}")
            if not same:
                failed.append(f"{name}: expander_groups differs from its plain version")
        if name.startswith("deform_bwd_glue"):
            glue_outs.setdefault(shape, {})[base] = out
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
            if isinstance(plant, tuple) and plant[0] == "calc":
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
    for shape, outs in glue_outs.items():
        same = all(torch.equal(a, b) for a, b in zip(outs["deform_bwd_glue_q"],
                                                     outs["deform_bwd_glue"]))
        at = "@" + shape if shape else ""
        log(f"kernel deform_bwd_glue_q and deform_bwd_glue{at} on the same inputs: identical "
            f"{same}")
        if not same:
            failed.append(f"deform_bwd_glue_q and deform_bwd_glue{at} differ")
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
    if not (counts_serve["flash_attention_rowbias_proj"] == 1 and counts["flash_attention_fwd"] == 1
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
        many_tokens_request(model, plain, chunk, rs, dev, totals, MOST_POINTS, MOST_PROMPTS)
        encode_split(model, image)
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
    # 'window': B13 in all 12 blocks, gated against its own plain version
    # ('window_plain'), whose rounding points are B13's.
    window = {}
    for dtype in ("bfloat16", "float32"):
        window[dtype] = build_sam("vit_b", dtype=dtype, attn_impl="window_plain",
                                  twoway_impl="plain", device=dev).eval()
        window[dtype].load_state_dict(model.state_dict())
    kern = build_sam("vit_b", dtype="bfloat16", attn_impl="window", device=dev).eval()
    kern.load_state_dict(model.state_dict())
    rs_w = np.random.RandomState(SEED + 1)
    timing["window"], timing["plain (window requests)"] = [], []
    with torch.inference_mode():
        for r in range(REQUESTS):
            request(r, kern, window, rs_w, dev, {**DECODE_PER_REQUEST, "window_rel_attention": 12},
                    totals, timing, label="window")
    del kern, window
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
# C8: 80 points + the pad point + 5 output tokens = 86 tokens, past the 64
# that B5 and B16 once took (96 slots).
MOST_POINTS, MOST_PROMPTS = 80, 64


def many_tokens_request(model, plain, chunk, rs, dev, totals, n_points: int = MANY_POINTS,
                        prompts: int = CHUNK) -> None:
    """One request of ``prompts`` prompts of ``n_points`` points each (26
    tokens by default) through the per-op decode ('auto': B4 and B5 at T
    n_points + 6) and through the whole-chunk decode ('chunk': B16 at that
    many tokens in slots of 16), each gated against its own plain bf16
    path's distance from fp32."""
    image = torch.from_numpy(rs.rand(1, 1024, 1024, 3).astype(np.float32) * 255).to(dev)
    points = torch.from_numpy(rs.rand(prompts, n_points, 2).astype(np.float32) * 1024).to(dev)
    labels = torch.from_numpy(rs.randint(0, 2, (prompts, n_points)).astype(np.int32)).to(dev)
    for name, kern, ref_bf16, ref_32, want in (
            ("auto", model, plain["bfloat16"], plain["float32"],
             {**ENCODE_PER_REQUEST, "masks_upscale": 1, "t2i_stream": 3, "i2t_block_step": 2}),
            ("chunk", chunk["chunk"], chunk["chunk_plain_bf16"], chunk["chunk_plain_fp32"],
             {**ENCODE_PER_REQUEST, "decode_tail": 1})):
        reset_launches()
        masks_k, enc, dec = serve(kern, image, points, labels)
        counts = launches()
        check_launches(f"{n_points}-point request {name}", counts, want)
        for k, got in counts.items():
            totals[k] = totals.get(k, 0) + got
        if (tuple(masks_k.shape) != (prompts, 4, 256, 256)
                or not bool(torch.isfinite(masks_k).all())):
            raise RuntimeError(f"{n_points}-point request {name}: masks "
                               f"{tuple(masks_k.shape)} or not finite")
        masks_p = serve(ref_bf16, image, points, labels)[0]
        masks_32 = serve(ref_32, image, points, labels)[0]
        chunk_masks_gate(f"{n_points}-point request {name} ({3 + n_points + 3} tokens)",
                         masks_k, masks_p, masks_32,
                         f"decode {dec[0] * 1e3:.2f} ms for {prompts} prompts; ",
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


def encode_split(model, image) -> None:
    """One served ``auto`` encode of ``image`` after a warm-up: its host span
    and device time by kernel (torch.profiler), the 8 largest. Launches
    made here are not the path's: the counts are reset after."""
    from torch.autograd import DeviceType

    x = model.normalize(image)
    synced(lambda: model.encode_image(x, return_fpn=False))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, span = synced(lambda: model.encode_image(x, return_fpn=False))
    reset_launches()
    avgs = sorted((a for a in prof.key_averages()
                   if a.device_type == DeviceType.CUDA and a.self_device_time_total > 0),
                  key=lambda a: a.self_device_time_total, reverse=True)
    busy = sum(a.self_device_time_total for a in avgs) / 1e3
    log(f"auto encode by kernel (one encode under torch.profiler): host span "
        f"{span * 1e3:.2f} ms, device time {busy:.3f} ms ({busy / (span * 1e3):.1%} of the "
        f"span); " + "; ".join(f"{a.key[:48]} x{a.count} {a.self_device_time_total / 1e3:.3f} ms"
                               for a in avgs[:8]))


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
                "block_tail_backward": 12, "flash_attention_fwd": 4, "flash_attention_bwd": 4,
                "tap_scatter": 10}}
PER_STEP[2] = {**PER_STEP[1], "ms_deform_level_fwd": 18, "deform_gather_rows": 36,
               "deform_bwd_glue_q": 36, "deform_scatter_dv": 36}
DEFORM_STEP = {k: v for k, v in PER_STEP[2].items() if k not in PER_STEP[1]}


def per_step(impl: str, batch: int) -> dict:
    """Launches per train step: under 'rowbias' / 'pallas_rp' each of the 12
    blocks runs the impl's forward and backward kernel once, and no B1-B3,
    B9-B11 (JAX's unfused route); under 'window' B13's forward once a block
    (its backward is plain PyTorch, as JAX's is XLA); B12, and at batch 2
    B7 and B8, as 'auto'."""
    if impl == "auto":
        return PER_STEP[batch]
    attn = ({"window_rel_attention": 12} if impl == "window"
            else {IMPL_FWD[impl]: 12, IMPL_BWD[impl]: 12})
    return {**attn, "tap_scatter": 10, **(DEFORM_STEP if batch == 2 else {})}


# The plain reference of an impl on the card: the plain versions with the
# impl's rounding points ('plain' has those of every route but B13's).
PLAIN_OF = {"window": "window_plain"}
# Phases whose gradient gate pools over this many batches at the first step's
# weights (loss_gate) instead of reading the first step's batch alone: there a
# one-ulp change in 0.1% of the attention's outputs moves one batch's ratio
# by 2x (tools/grad_spread.py; PERF.md §6).
POOLED_GRADS = {"window": 6, "rowbias": GATE_BATCHES, "pallas_rp": GATE_BATCHES}
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
    ``impl`` is the kernel path's attn_impl; the plain paths are 'plain'
    (``PLAIN_OF``: 'window_plain' under 'window').
    Returns the kernel path's launch totals."""
    from iuvl_tpu_torch.losses.criterion import CriterionConfig, SegCriterion
    from iuvl_tpu_torch.models.xdecoder import convert
    from iuvl_tpu_torch.models.xdecoder.model import SysLearnerConfig, build_syslearner
    from iuvl_tpu_torch.train.optimizer import Optimizer
    from iuvl_tpu_torch.train.train_step import TrainState, make_train_step

    cfg = SysLearnerConfig(**{**TRAIN_CONFIG, "attn_impl": impl})
    size = cfg.img_size
    ref = PLAIN_OF.get(impl, "plain")
    plain = {"bf16": dataclasses.replace(cfg, attn_impl=ref),
             "fp32": dataclasses.replace(cfg, attn_impl=ref, dtype="float32")}
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
        for _ in range(GATE_BATCHES - 1)], grad_batches=POOLED_GRADS.get(impl, 0))
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
        # gates its gradient groups (pooled in loss_gate for POOLED_GRADS) and
        # (loss_gate) its loss terms pooled over GATE_BATCHES batches.
        check_step(step, metrics, grads, gate_losses=batch == 1 and impl == "auto",
                   gate_grads=impl not in POOLED_GRADS)
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
    log(f"train step {step} kernels ({impl}): launches "
        f"{({k: v for k, v in counts.items() if v})}")
    for name, got in counts.items():
        want = per_step.get(name, 0)
        if got != want:
            raise RuntimeError(f"train step {step}: {name} launched {got} times, "
                               f"expected {want}")
        if name in totals:
            totals[name] += got


LOSS_TERMS = ("loss_mask_ce", "loss_mask_bce", "loss_mask_dice")


def check_step(step: int, metrics: dict, grads: dict, gate_losses: bool,
               gate_grads: bool = True) -> None:
    """Print the losses; on the first step gate, with ``gate_grads``, each
    parameter group's gradient (:func:`loss_gate` gates them over several
    batches where one batch is no gate) and, with ``gate_losses``, each
    loss term (class CE, mask BCE,
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
            f"{r['kernels']:.3f}{others(r, '{:.3f}'.format, ' (not gated)')}"
            + ("" if gate_grads else " (one batch, not gated)"))
        if gate_grads and not e["kernels"] <= SLICE_FACTOR * e["plain_bf16"]:
            failed.append(f"grad {group}: {e['kernels']:.3e} > {SLICE_FACTOR} x "
                          f"{e['plain_bf16']:.3e}")
    if failed:
        raise RuntimeError("train gate failed: " + "; ".join(failed))


def loss_gate(models: dict, crits: dict, text, batches: list, grad_batches: int = 0) -> None:
    """Gate each loss term (its 10 layers' values) pooled over ``batches``
    (images, targets, draws), every path at the same weights: forward and
    criterion as in a train step (autograd recording, so the training
    routes run; no update), the fp32 path's assignments on every path. The
    kernel path's relative L2 from fp32 must be at most SLICE_FACTOR times
    the plain bf16 path's. On one batch the ratio of two sound bf16 paths
    spreads over about 0.4-2.5 (PERF.md, Findings), so one batch's ten
    values per term are no gate. On the first ``grad_batches`` batches the
    backward runs too, and each parameter group's gradient is gated the
    same way, pooled over them (a sound bf16 path's one-batch gradient
    ratio reads 0.45-1.62 under 'window', 0.41-2.42 under 'rowbias' /
    'pallas_rp': PERF.md §6)."""
    from iuvl_tpu_torch.losses.matcher import batched_hungarian
    from iuvl_tpu_torch.ops.point_sample import given_draws
    from iuvl_tpu_torch.train.train_step import split_seg_outputs

    paths = ("plain_fp32", "plain_bf16", "kernels")
    values = {path: {term: [] for term in LOSS_TERMS} for path in paths}
    # pooled gradient rel L2: sum |g - g_fp32|^2 and sum |g_fp32|^2 by group
    sq = {path: {g: [0.0, 0.0] for g in GROUPS} for path in paths[1:]}
    per_batch = []
    for b, (images, targets, draws) in enumerate(batches):
        assignments, ref = None, None
        for path in paths:
            model, crit, draw = models[path], crits[path], given_draws(draws)
            with torch.enable_grad():
                obj, _ = split_seg_outputs(model.forward_seg(images, text),
                                           model.cfg.num_queries)
                costs, kept = crit.collect_costs(obj, targets, draw, MATCH_POINTS)
                if assignments is None:
                    assignments = batched_hungarian(costs)
                losses = crit.losses_from_assignments(kept, assignments, targets, draw)
                if b < grad_batches:
                    model.zero_grad(set_to_none=True)
                    sum(losses.values()).backward()
                    grad = {g: torch.cat([p.grad.float().flatten()
                                          for n, p in model.named_parameters()
                                          if n.startswith(g) and p.grad is not None])
                            for g in GROUPS}
                    model.zero_grad(set_to_none=True)
                    if ref is None:
                        ref = grad
                    else:
                        for g in GROUPS:
                            sq[path][g][0] += float(torch.linalg.vector_norm(grad[g] - ref[g]) ** 2)
                            sq[path][g][1] += float(torch.linalg.vector_norm(ref[g]) ** 2)
                    del grad
            for term in LOSS_TERMS:
                values[path][term] += [float(v.detach()) for k, v in sorted(losses.items())
                                       if k.startswith(term + "_")]
            del obj, kept, losses
        del ref
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
    for g in GROUPS if grad_batches else ():
        e = {path: (sq[path][g][0] / sq[path][g][1]) ** 0.5 for path in paths[1:]}
        log(f"train grad {g[:-1]} over {grad_batches} batches: rel L2 to fp32 kernels "
            f"{e['kernels']:.3e} plain bf16 {e['plain_bf16']:.3e}; ratio "
            f"{e['kernels'] / e['plain_bf16']:.3f}")
        if not e["kernels"] <= SLICE_FACTOR * e["plain_bf16"]:
            failed.append(f"grad {g}: {e['kernels']:.3e} > {SLICE_FACTOR} x {e['plain_bf16']:.3e}")
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
    ("vit_h 1024", "vit_h", 1024, {"window_attention_block": 1, "flash_attention_fwd": 1,
                                   "block_tail": 2}),
    ("vit_b 512", "vit_b", 512, {"window_attention_block": 1,
                                 "flash_attention_rowbias_proj": 1, "block_tail": 2}),
    ("vit_b 800", "vit_b", 800, {"window_attention_block": 1, "flash_attention_fwd": 1,
                                 "block_tail": 2}),
)
TRAIN_ROUTE = {"window_attention_block": 1, "window_block_backward": 1, "flash_attention_fwd": 1,
               "flash_attention_bwd": 1, "block_tail": 2, "block_tail_backward": 2}
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
        if label == "vit_b 800":
            for k, got in shape_chunk_decode(dev, side, serve_want).items():
                totals[k] = totals.get(k, 0) + got
    return totals


SHAPE_DECODE_PROMPTS = 64


def shape_chunk_decode(dev, side: int, encode_want: dict) -> dict:
    """C7 on the real path: one chunk of SHAPE_DECODE_PROMPTS one-point
    prompts (an 8 x 8 grid) over the embedding of a seeded side^2 image (a
    (side / 16)^2 grid of keys: N 2500 at 800^2) through CHUNK_PATHS, on a
    depth-2 ViT-B SAM (the same weights on each path, each path encoding
    the image itself); launches checked on the kernel path (B16 once); the
    masks gated as the serving requests' are. Returns the kernel path's
    launches."""
    from iuvl_tpu_torch.inference.amg import build_point_grid
    from iuvl_tpu_torch.models.sam import build_sam

    rs = np.random.RandomState(SEED + 32)
    img = torch.from_numpy(rs.rand(1, side, side, 3).astype(np.float32) * 255).to(dev)
    grid = int(SHAPE_DECODE_PROMPTS ** 0.5)
    points = torch.from_numpy(build_point_grid(grid)[:, None] * side).float().to(dev)
    labels = torch.ones(SHAPE_DECODE_PROMPTS, 1, dtype=torch.int32, device=dev)
    masks, counts = {}, {}
    for path, (attn, twoway, dtype) in CHUNK_PATHS.items():
        m = build_sam("vit_b", dtype=dtype, attn_impl=attn, twoway_impl=twoway, device=dev,
                      generator=torch.Generator().manual_seed(SEED + 33), depth=2,
                      global_attn_indexes=(1,), img_size=side).eval()
        reset_launches()
        with torch.inference_mode():
            emb, _ = m.encode_image(m.normalize(img), return_fpn=False)
            masks[path], t_dec = synced(lambda: m.decode_from_embedding(
                emb, points, labels, return_upscaled=False)["masks"])
        got = launches()
        if path == "chunk":
            check_launches(f"vit_b {side} chunk decode", got, {**encode_want, "decode_tail": 1})
            counts = got
            log(f"vit_b {side} chunk decode of {SHAPE_DECODE_PROMPTS} prompts (N "
                f"{(side // 16) ** 2}): {t_dec * 1e3:.2f} ms (host clock, the first call)")
        elif any(got.values()):
            raise RuntimeError(f"vit_b {side} chunk decode {path}: kernels launched {got}")
        del m, emb
    if masks["chunk"].shape[0] != SHAPE_DECODE_PROMPTS:
        raise RuntimeError(f"vit_b {side} chunk decode: masks {tuple(masks['chunk'].shape)}")
    chunk_masks_gate(f"vit_b {side} chunk decode of {SHAPE_DECODE_PROMPTS} prompts",
                     masks["chunk"], masks["chunk_plain_bf16"], masks["chunk_plain_fp32"])
    torch.cuda.empty_cache()
    return counts


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


VL_STEPS = 20  # greedy captioning steps (the pipeline's CAPTIONING_STEPS)
VL_PHRASES = 2  # grounding phrases of 8-20 words, padded to 77 tokens
SOT, EOT = 49406, 49407


def _recording(fn, into: list):
    """``fn``, each of its results also appended to ``into``."""
    def wrapped(*a, **kw):
        into.append(fn(*a, **kw))
        return into[-1]
    return wrapped


def _replaying(outs: list):
    """A stand-in answering its calls with ``outs``, in order."""
    it = iter(outs)
    return lambda *a, **kw: next(it)


def _vl_gate(label: str, got: dict, failed: list) -> str:
    """``got[path]`` (one tensor, or a list pooled) of each kernel path
    against its EVAL_GATES yardstick, as rel L2 to plain_fp32's: a log
    line; a ratio over SLICE_FACTOR is appended to ``failed``."""
    flat = {p: torch.cat([x.float().flatten() for x in v]) if isinstance(v, list)
            else v.float().flatten() for p, v in got.items()}
    parts = []
    for path, y in EVAL_GATES.items():
        e, ey = rel_l2(flat[path], flat["plain_fp32"]), rel_l2(flat[y], flat["plain_fp32"])
        if not e <= SLICE_FACTOR * ey:
            failed.append(f"{label} {path}: {e:.3e} > {SLICE_FACTOR} x {y}'s {ey:.3e}")
        parts.append(f"{path} {e:.3e} / {y} {ey:.3e} ({e / ey:.3f})")
    return f"vl {label}: rel L2 to plain_fp32 " + "; ".join(parts)


def vl_eval_phase(dev, smi: str) -> dict:
    """The vision-language evals at full width: EVAL_CONFIG with the
    retrieval ensemble on seeded random weights, through every path of
    EVAL_PATHS, on one seeded 1024^2 image: ``evaluate_grounding`` for
    each of VL_PHRASES phrases (``encode_text_tokens``), then again along
    plain_fp32's matched queries and mask attention; ``evaluate_retrieval`` and
    ``evaluate_retrieval_ensemble``; zero-shot classification against the
    133 COCO panoptic class embeddings; greedy captioning over VL_STEPS
    steps, KV-cached and by full re-run, then both teacher-forced along
    plain_fp32's ids. Launches checked a call (each encodes the image
    once). Gated, each kernel path against its impl's plain bf16 path at
    SLICE_FACTOR, where a discrete choice is taken along plain_fp32's: the
    grounding masks along fp32's queries and mask attention (each decoder
    layer's cross-attention bias thresholds the previous layer's logits:
    fp32's are recorded and replayed; a sound bf16 path's greedy masks
    read 2-19% from fp32's on one image, ratios 0.4-7.8), both retrieval
    embeddings, the classification logits, and each captioning mode's
    per-step logits along fp32's ids. On plain_fp32 the two captioning
    modes' ids must be equal, or part at a near-tie (a top-2 margin under
    the modes' logit difference). Printed: ms a phrase, an image and a
    caption, and the kernel paths' agreement with fp32's queries and ids
    (not gated). Returns the kernel paths' launch totals."""
    from iuvl_tpu_torch.data.class_names import get_class_names
    from iuvl_tpu_torch.models.xdecoder.model import SysLearnerConfig, build_syslearner
    from iuvl_tpu_torch.pipeline import class_text_embeddings

    cfg = SysLearnerConfig(**EVAL_CONFIG, retrieval_ensemble=True)
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 60)
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
    log(f"vl: {len(models)} x SysLearner (retrieval_ensemble) built in "
        f"{time.perf_counter() - t0:.1f} s")
    rs = np.random.RandomState(SEED + 61)
    image = torch.from_numpy(rs.rand(1, cfg.img_size, cfg.img_size, 3).astype(np.float32)
                             * 255).to(dev)
    ids = np.zeros((VL_PHRASES, cfg.contxt_len), np.int64)
    for i in range(VL_PHRASES):
        k = rs.randint(8, 21)
        ids[i, : k + 2] = [SOT, *rs.randint(1, SOT - 6, k), EOT]
    ids = torch.from_numpy(ids).to(dev)
    valid = ids > 0
    names = get_class_names("coco_panoptic")
    totals: dict = {}
    texts: dict = {}
    out = {path: {} for path in models}
    ms = {path: {} for path in models}

    def timed(path, label, fn):
        """fn() with its launches checked and its host ms kept."""
        reset_launches()
        res, secs = synced(fn)
        counts = launches()
        impl = EVAL_PATHS[path][1]
        check_launches(f"vl {label} {path}", counts,
                       PER_IMAGE[impl] if path.startswith("kernels") else {})
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        ms[path].setdefault(label, []).append(secs * 1e3)
        return res

    with torch.no_grad():
        for path, m in models.items():
            o = out[path]
            o["tok"], o["cls"] = tok, cls = m.encode_text_tokens(ids)
            for i in range(VL_PHRASES):
                biases = []  # each decoder layer's cross-attention bias
                with _patched(m.predictor, "_attn_bias_from_mask", _recording(
                        m.predictor._attn_bias_from_mask, biases)):
                    masks, matched = timed(path, "grounding", lambda: m.evaluate_grounding(
                        image, tok[i:i + 1], valid[i:i + 1], cls[None, i:i + 1],
                        return_matched=True))
                o.setdefault("matched", []).append(matched)
                o.setdefault("greedy_masks", []).append(masks)
                o.setdefault("biases", []).append(biases)
            o["retrieval"] = timed(path, "retrieval", lambda: m.evaluate_retrieval(image))
            o["ensemble"] = timed(path, "retrieval_ensemble",
                                  lambda: m.evaluate_retrieval_ensemble(image))
            dtype = EVAL_PATHS[path][2]
            if dtype not in texts:
                texts[dtype], text_s = synced(lambda: class_text_embeddings(m, names))
                log(f"vl: class embeddings {tuple(texts[dtype].shape)} in {dtype} "
                    f"{text_s * 1e3:.1f} ms")
            o["class_logits"] = o["retrieval"] @ texts[dtype][:-1].t()
            for mode, fn in (("cached", m.evaluate_captioning_cached),
                             ("full", m.evaluate_captioning)):
                o[f"ids_{mode}"], o[f"logits_{mode}"] = timed(
                    path, f"captioning_{mode}",
                    lambda: fn(image, steps=VL_STEPS, return_logits=True))
    ref = out["plain_fp32"]
    # plain_fp32's two captioning modes: the same ids, or parted at a near-tie.
    ids_c, ids_f = ref["ids_cached"], ref["ids_full"]
    lc, lf = ref["logits_cached"], ref["logits_full"]
    top2 = lc.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1])[0]
    diff = (lc - lf).abs().amax(dim=-1)[0]
    part = (ids_c != ids_f).nonzero()
    if len(part):
        step = int(part[0, 1]) - 1
        if not float(margin[step]) < float(diff[step]):
            raise RuntimeError(f"vl captioning: plain_fp32's cached and full ids part at step "
                               f"{step} with a top-2 margin {float(margin[step]):.3e} over the "
                               f"modes' logit difference {float(diff[step]):.3e}")
    log(f"vl captioning plain_fp32: cached and full ids "
        f"{'equal' if not len(part) else f'part at step {int(part[0, 1]) - 1} (near-tie)'}; "
        f"smallest top-2 margin {float(margin.min()):.3e}, largest cached / full logit "
        f"difference {float(diff.max()):.3e}")
    teacher = ids_c
    with torch.no_grad():
        for path, m in models.items():
            if path == "plain_fp32":
                continue
            o = out[path]
            tok, cls = o["tok"], o["cls"]
            o["forced_masks"] = []
            for i in range(VL_PHRASES):
                with _patched(m.predictor, "_attn_bias_from_mask",
                              _replaying(ref["biases"][i])):
                    o["forced_masks"].append(timed(
                        path, "grounding_forced", lambda: m.evaluate_grounding(
                            image, tok[i:i + 1], valid[i:i + 1], cls[None, i:i + 1],
                            matched=ref["matched"][i])))
            for mode, fn in (("cached", m.evaluate_captioning_cached),
                             ("full", m.evaluate_captioning)):
                o[f"forced_{mode}"] = timed(path, f"captioning_{mode}_forced", lambda: fn(
                    image, steps=VL_STEPS, forced_ids=teacher, return_logits=True))[1]
    ref["forced_masks"] = ref["greedy_masks"]
    ref["forced_cached"], ref["forced_full"] = lc, lf
    failed: list = []
    log(_vl_gate("grounding masks, greedy (not gated)", {
        p: o["greedy_masks"] for p, o in out.items()}, []))
    for label, key in (("grounding masks (fp32's queries and mask attention)", "forced_masks"),
                       ("retrieval embedding", "retrieval"),
                       ("ensemble backbone embedding", "ensemble"),
                       ("classification logits (133 classes)", "class_logits"),
                       ("captioning logits cached (fp32's ids)", "forced_cached"),
                       ("captioning logits full (fp32's ids)", "forced_full")):
        got = {p: (o[key][1] if key == "ensemble" else o[key]) for p, o in out.items()}
        log(_vl_gate(label, got, failed))
    steps = min(VL_STEPS, cfg.contxt_len - 1)
    for path in EVAL_GATES:
        o = out[path]
        same_q = sum(bool(torch.equal(a, b)) for a, b in zip(o["matched"], ref["matched"]))
        flips = [sum(int((a != b).sum()) for a, b in zip(mine, fp32)) / sum(
            b.numel() for b in fp32) for mine, fp32 in zip(o["biases"], ref["biases"])]
        agree = {mode: int((o[f"ids_{mode}"][0, 1: steps + 1]
                            == teacher[0, 1: steps + 1]).sum()) for mode in ("cached", "full")}
        top5 = set(o["class_logits"][0].topk(5).indices.tolist()) == set(
            ref["class_logits"][0].topk(5).indices.tolist())
        log(f"vl {path} vs plain_fp32 (not gated): grounding queries {same_q}/{VL_PHRASES} the "
            f"same, mask-attention bits that differ {[f'{x:.2e}' for x in flips]} a phrase; "
            f"caption ids the same at {agree['cached']}/{steps} steps cached, "
            f"{agree['full']}/{steps} full; classification top-5 "
            f"{'the same' if top5 else 'differs'}")
    for path in models:
        log(f"vl {path} on {smi}: " + ", ".join(
            f"{label} ms {[round(t_, 1) for t_ in ts]}" for label, ts in ms[path].items()
            if not label.endswith("forced")))
    if failed:
        raise RuntimeError("vl eval gate failed: " + "; ".join(failed))
    del models, out
    torch.cuda.empty_cache()
    return totals


# The LLM stage (LLaVA-style VQA): LLaMA-2-7B widths over the 49408 ids that
# the offline tokenizer gives (Vicuna's 32000-row table would embed most prompt
# words as NaN, as jnp.take does), its 1024-slot cache, seeded random weights.
LLM_CONFIG = dict(vocab_size=49408, dim=4096, layers=32, heads=32, kv_heads=32, ffn_dim=11008,
                  max_seq_len=1024)
LLM_VISION = dict(EVAL_CONFIG, llm_dim=4096)
# path -> (attn_impl, msdeform_impl, dtype of the vision model and of the LLM)
LLM_PATHS = {"plain_fp32": ("plain", "auto", "float32"),
             "plain_bf16": ("plain", "auto", "bfloat16"),
             "kernels": ("auto", "auto", "bfloat16"),
             "kernels_hybrid": ("auto", "hybrid", "bfloat16")}
LLM_GREEDY_TOKENS = 32
LLM_BEAM_TOKENS, LLM_BEAMS = 8, 5  # evaluate_vqa_items' defaults
LLM_INT8_TOKENS = 8
LLM_SPLICE_LEN = 256  # answer_questions' default row (the pipeline's 64 cannot hold 100 features)
LLM_QUESTION = "what color is the large object in the middle of the picture?"
CACHE_BOUND = 1e-3  # plain fp32: the cached logits against one full forward, rel L2
INT8_BYTES = 0.55  # int8 projection bytes over bf16's, at most


def _rel_ratio(label: str, got: dict, failed: list) -> str:
    """``got[path]`` of the kernel path and plain bf16 as rel L2 from
    plain_fp32's; the kernels' over SLICE_FACTOR times plain bf16's goes to
    ``failed``."""
    f = got["plain_fp32"]
    e, ey = rel_l2(got["kernels"], f), rel_l2(got["plain_bf16"], f)
    if not e <= SLICE_FACTOR * ey:
        failed.append(f"{label}: {e:.3e} > {SLICE_FACTOR} x plain_bf16's {ey:.3e}")
    return f"llm {label}: rel L2 to plain_fp32 kernels {e:.3e} / plain_bf16 {ey:.3e} ({e / ey:.3f})"


def _projection_bytes(model) -> int:
    return sum(t.numel() * t.element_size() for k, t in model.state_dict().items()
               if "_proj." in k)


def llm_phase(dev, smi: str) -> dict:
    """The LLM stage at full width: LLM_VISION (ViT-B 1024^2 with the
    ``img_to_lang`` projector to 4096) through every path of LLM_PATHS on one
    set of seeded weights, and a LLaMA-2-7B-wide LLM (LLM_CONFIG) drawn once
    in fp32 on the card, its bf16 copy the fp32 weights rounded (the kernel
    paths and plain bf16 share it). One seeded 1024^2 image and LLM_QUESTION:
    ``answer_questions`` greedy over LLM_GREEDY_TOKENS tokens on the kernels,
    ``evaluate_vqa_items`` (beam LLM_BEAMS over LLM_BEAM_TOKENS) on the
    kernels, ``answer_questions`` greedy on the 'hybrid' kernels (B15);
    launches checked a request. Gated, with plain fp32's discrete choices
    replayed: the projected image features along fp32's mask attention
    (each decoder layer's cross-attention bias thresholds the previous
    layer's mask logits), and each step's logits along fp32's greedy ids,
    through each path's cache; the kernels at most SLICE_FACTOR times as far
    from fp32 as plain bf16; on plain fp32 the cached logits against one full-sequence forward
    over the prompt and its tokens (CACHE_BOUND); every logit finite. Then
    int8: the fp32 weights quantised, one request through it, its logits
    finite, its projection bytes at most INT8_BYTES of bf16's. Printed beside
    the card: vision, splice, prefill and per-token ms, tok/s, peak memory and
    one greedy token's device time under torch.profiler. Returns the kernel
    paths' launch totals from their requests."""
    from iuvl_tpu_torch.data.tokenizer import build_tokenizer
    from iuvl_tpu_torch.models.llm.llama import LlamaConfig, build_llama
    from iuvl_tpu_torch.models.llm.multimodal import (beam_generate, greedy_generate,
                                                      prompt_pad_mask, splice_image_features,
                                                      tokenizer_image_token)
    from iuvl_tpu_torch.models.llm.quant import quantize_llama_state_dict
    from iuvl_tpu_torch.models.llm.vqa_pipeline import (answer_questions, build_vqa_prompt,
                                                        vqa_inputs)
    from iuvl_tpu_torch.models.xdecoder.model import SysLearnerConfig, build_syslearner
    from iuvl_tpu_torch.pipeline import evaluate_vqa_items

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = SysLearnerConfig(**LLM_VISION)
    models, weights = {}, None
    for path, (attn, msdeform, dtype) in LLM_PATHS.items():
        pcfg = dataclasses.replace(cfg, attn_impl=attn, msdeform_impl=msdeform, dtype=dtype)
        models[path] = build_syslearner(pcfg, device=dev, generator=None if weights else
                                        torch.Generator().manual_seed(SEED + 90)).eval()
        if weights is None:
            weights = models[path].state_dict()
        else:
            models[path].load_state_dict(weights)
    del weights
    t_vision = time.perf_counter() - t0
    t0 = time.perf_counter()
    lcfg = LlamaConfig(**LLM_CONFIG, dtype="float32", param_dtype="float32")
    llms = {"float32": build_llama(lcfg, dev, torch.Generator(device=dev).manual_seed(SEED + 91))}
    llms["bfloat16"] = build_llama(dataclasses.replace(lcfg, dtype="bfloat16",
                                                       param_dtype="bfloat16"), dev)
    llms["bfloat16"].load_state_dict(llms["float32"].state_dict())
    head32, head16 = llms["float32"].lm_head.weight, llms["bfloat16"].lm_head.weight
    if not torch.equal(head16, head32.to(torch.bfloat16)):
        raise RuntimeError("llm: the bf16 copy is not the fp32 weights rounded")
    torch.cuda.synchronize()
    n_llm = sum(p.numel() for p in llms["float32"].parameters())
    log(f"llm: {len(models)} x SysLearner (llm_dim {cfg.llm_dim}) built in {t_vision:.1f} s; LLaMA "
        f"{n_llm / 1e9:.3f} B parameters drawn on the card in fp32 and copied to bf16 in "
        f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated")
    rs = np.random.RandomState(SEED + 92)
    image = torch.from_numpy(rs.rand(1, cfg.img_size, cfg.img_size, 3).astype(np.float32)
                             * 255).to(dev)
    tok = build_tokenizer()
    totals: dict = {}
    peaks = [torch.cuda.max_memory_allocated()]

    def llm_of(path):
        return llms[LLM_PATHS[path][2]]

    def request(label, path, fn):
        """fn() with its launches checked, its host ms and the peak memory
        above what was allocated before it."""
        impl = LLM_PATHS[path][1]
        base = torch.cuda.memory_allocated()
        peaks.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        out, secs = synced(fn)
        counts = launches()
        check_launches(f"llm {label} {path}", counts,
                       PER_IMAGE[impl] if path.startswith("kernels") else {})
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        log(f"llm {label} {path}: {secs * 1e3:.1f} ms; launches "
            f"{({k: v for k, v in counts.items() if v})}; peak "
            f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.3f} GiB above "
            f"{base / 2**30:.2f} GiB resident ({smi})")
        return out

    with torch.no_grad():
        # The requests through the entry points a user calls.
        for _ in range(2):  # the first warms the allocator and cuBLAS
            texts, ids_k = request("greedy request", "kernels", lambda: answer_questions(
                models["kernels"], llm_of("kernels"), tok, image, [LLM_QUESTION],
                max_new_tokens=LLM_GREEDY_TOKENS, max_len=LLM_SPLICE_LEN, return_ids=True))
        item = {"image": image[0].cpu().numpy(), "question": LLM_QUESTION,
                "answers": [texts[0], "red", "blue"]}
        metrics = request("beam request (evaluate_vqa_items)", "kernels",
                          lambda: evaluate_vqa_items(
                              models["kernels"], llm_of("kernels"), [item], "vqa",
                              max_new_tokens=LLM_BEAM_TOKENS, num_beams=LLM_BEAMS,
                              max_len=LLM_SPLICE_LEN))
        if not all(np.isfinite(v) for v in metrics.values()):
            raise RuntimeError(f"llm beam request: non-finite metrics {metrics}")
        texts_h, ids_h = request("greedy request", "kernels_hybrid", lambda: answer_questions(
            models["kernels_hybrid"], llm_of("kernels_hybrid"), tok, image, [LLM_QUESTION],
            max_new_tokens=LLM_GREEDY_TOKENS, max_len=LLM_SPLICE_LEN, return_ids=True))
        log(f"llm answers: kernels greedy {texts[0]!r} (ids {ids_k[0, :8].tolist()}...), "
            f"hybrid greedy ids the same at {int((ids_h == ids_k).sum())}/{LLM_GREEDY_TOKENS} "
            f"steps; beam {LLM_BEAMS} accuracy {metrics}")

        # The stages of the kernel path, each timed alone.
        llm = llm_of("kernels")
        m = models["kernels"]
        toks = tok([LLM_QUESTION], max_length=cfg.contxt_len)
        ids_q = torch.from_numpy(toks["input_ids"]).to(dev)
        (ctx, _), t_text = synced(lambda: m.encode_text_tokens(ids_q))
        feats, t_vis = synced(lambda: m.forward_llm_features(image, ctx))
        prompt_ids = np.asarray([tokenizer_image_token(build_vqa_prompt(LLM_QUESTION), tok)])
        _, t_splice = synced(lambda: splice_image_features(prompt_ids, llm.embed, feats,
                                                           max_len=LLM_SPLICE_LEN))
        embeds, attn, _ = vqa_inputs(m, llm, tok, image, [LLM_QUESTION], LLM_SPLICE_LEN)
        prompt_len = embeds.shape[1]
        n_img = feats.shape[1]
        prefill_ms = cuda_ms(lambda: llm.prefill(embeds, attn), 5)
        caches = llm.prefill(embeds, attn)[1]
        pad = prompt_pad_mask(attn, llm.cfg.max_seq_len)
        emb1 = llm.embed(ids_k[:, :1])
        step_ms = cuda_ms(lambda: llm.decode_step(emb1, caches, prompt_len, pad), 10)
        beam_caches = [(kc.repeat_interleave(LLM_BEAMS, 0), vc.repeat_interleave(LLM_BEAMS, 0))
                       for kc, vc in caches]
        emb5 = emb1.repeat_interleave(LLM_BEAMS, 0)
        pad5 = pad.repeat_interleave(LLM_BEAMS, 0)
        beam_step_ms = cuda_ms(lambda: llm.decode_step(emb5, beam_caches, prompt_len, pad5), 10)
        del beam_caches
        _, t_greedy = synced(lambda: greedy_generate(llm, embeds, attn, LLM_GREEDY_TOKENS))
        _, t_beam = synced(lambda: beam_generate(llm, embeds, attn, LLM_BEAM_TOKENS, LLM_BEAMS))
        per_tok = (t_greedy * 1e3 - prefill_ms) / (LLM_GREEDY_TOKENS - 1)
        per_beam = (t_beam * 1e3 - prefill_ms) / (LLM_BEAM_TOKENS - 1)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            _, t_prof = synced(lambda: llm.decode_step(emb1, caches, prompt_len, pad))
        kernels_ = [a for a in prof.key_averages()
                    if a.device_type == torch.autograd.DeviceType.CUDA
                    and a.self_device_time_total > 0]
        dev_ms = sum(a.self_device_time_total for a in kernels_) / 1e3
        top = sorted(kernels_, key=lambda a: a.self_device_time_total, reverse=True)[:5]
        del caches
        log(f"llm kernels (bf16, batch 1, {prompt_len} prompt tokens = {n_img} image features "
            f"+ {prompt_len - n_img} text) on {smi}: question tokens {t_text * 1e3:.1f} ms, "
            f"vision (encode + pixel decoder + 'llm' task + projector) {t_vis * 1e3:.1f} ms, "
            f"splice (host ids, embed, placement) {t_splice * 1e3:.2f} ms; prefill "
            f"{prefill_ms:.2f} ms (CUDA events); greedy {LLM_GREEDY_TOKENS} tokens "
            f"{t_greedy * 1e3:.1f} ms: {per_tok:.2f} ms a new token, {1e3 / per_tok:.2f} tok/s "
            f"(one decode_step {step_ms:.2f} ms by events); beam {LLM_BEAMS} x "
            f"{LLM_BEAM_TOKENS} tokens {t_beam * 1e3:.1f} ms: {per_beam:.2f} ms a step, "
            f"{1e3 / per_beam:.2f} answer tok/s (one {LLM_BEAMS}-row decode_step "
            f"{beam_step_ms:.2f} ms by events)")
        log(f"llm kernels: one greedy token under torch.profiler: {dev_ms:.3f} ms of device "
            f"time in a {t_prof * 1e3:.2f} ms host span ({len(kernels_)} kernel names); "
            + "; ".join(f"{a.self_device_time_total / 1e3:.3f} ms {a.count}x "
                        f"{a.key[:60]}" for a in top))

        # The gate: every path's features along plain fp32's mask attention
        # (each decoder layer's cross-attention bias thresholds the previous
        # layer's mask logits: fp32's are recorded and replayed), and its
        # logits along fp32's ids; the greedy features are printed too.
        out, biases = {}, []
        for path in ("plain_fp32", "plain_bf16", "kernels"):
            m = models[path]
            greedy = vqa_inputs(m, llm_of(path), tok, image, [LLM_QUESTION],
                                LLM_SPLICE_LEN)[2] if path != "plain_fp32" else None
            along = (_recording(m.predictor._attn_bias_from_mask, biases)
                     if path == "plain_fp32" else _replaying(biases))
            with _patched(m.predictor, "_attn_bias_from_mask", along):
                e, a, f = vqa_inputs(m, llm_of(path), tok, image, [LLM_QUESTION],
                                     LLM_SPLICE_LEN)
            out[path] = {"feats": f, "greedy_feats": f if greedy is None else greedy,
                         "embeds": e, "attn": a}
        ref = out["plain_fp32"]
        ref["ids"], ref["logits"] = greedy_generate(llms["float32"], ref["embeds"], ref["attn"],
                                                    LLM_GREEDY_TOKENS, return_logits=True)
        for path in ("plain_bf16", "kernels"):
            o = out[path]
            o["ids"] = greedy_generate(llm_of(path), o["embeds"], o["attn"], LLM_GREEDY_TOKENS)
            _, o["logits"] = greedy_generate(llm_of(path), o["embeds"], o["attn"],
                                             LLM_GREEDY_TOKENS, forced_ids=ref["ids"],
                                             return_logits=True)
        full_in = torch.cat([ref["embeds"], llms["float32"].embed(ref["ids"][:, :-1])], dim=1)
        full = llms["float32"](full_in, torch.ones(full_in.shape[:2], dtype=torch.int32,
                                                   device=dev))
        full = full[:, prompt_len - 1:]
        cache_err = rel_l2(ref["logits"], full)
    failed: list = []
    log(_rel_ratio(f"projected image features {tuple(ref['feats'].shape)}, greedy mask "
                   "attention (not gated)", {p: o["greedy_feats"] for p, o in out.items()}, []))
    log(_rel_ratio(f"projected image features {tuple(ref['feats'].shape)}, fp32's mask "
                   "attention", {p: o["feats"] for p, o in out.items()}, failed))
    log(_rel_ratio(f"logits along plain_fp32's ids ({LLM_GREEDY_TOKENS} steps x "
                   f"{LLM_CONFIG['vocab_size']})", {p: o["logits"] for p, o in out.items()},
                   failed))
    for path in ("plain_bf16", "kernels"):
        same = int((out[path]["ids"] == ref["ids"]).sum())
        log(f"llm {path} vs plain_fp32 (not gated): greedy ids the same at {same}/"
            f"{LLM_GREEDY_TOKENS} steps")
    log(f"llm plain_fp32: cached logits against one full forward over prompt + tokens, rel L2 "
        f"{cache_err:.3e} (bound {CACHE_BOUND}); greedy ids cached == argmax of the full "
        f"forward at {int((full.argmax(-1) == ref['ids']).sum())}/{LLM_GREEDY_TOKENS} steps")
    if not cache_err <= CACHE_BOUND:
        failed.append(f"cached vs full forward rel L2 {cache_err:.3e} > {CACHE_BOUND}")
    for path, o in out.items():
        if not bool(torch.isfinite(o["logits"]).all()):
            failed.append(f"{path}: non-finite logits")
    if failed:
        raise RuntimeError("llm gate failed: " + "; ".join(failed))

    # int8: the fp32 weights quantised, one request through the kernels.
    with torch.no_grad():
        qsd = quantize_llama_state_dict(llms["float32"].state_dict())
        del out, full, full_in
        llms.pop("float32")
        torch.cuda.empty_cache()
        llm8 = build_llama(LlamaConfig(**LLM_CONFIG, dtype="bfloat16", param_dtype="bfloat16",
                                       quant="int8"), dev)
        llm8.load_state_dict(qsd, strict=True)
        del qsd
        q_bytes, b_bytes = _projection_bytes(llm8), _projection_bytes(llms["bfloat16"])
        texts8, ids8 = request("int8 greedy request", "kernels", lambda: answer_questions(
            models["kernels"], llm8, tok, image, [LLM_QUESTION],
            max_new_tokens=LLM_INT8_TOKENS, max_len=LLM_SPLICE_LEN, return_ids=True))
        prefill8_ms = cuda_ms(lambda: llm8.prefill(embeds, attn), 2)
        _, t8 = synced(lambda: greedy_generate(llm8, embeds, attn, LLM_INT8_TOKENS))
        _, logits8 = greedy_generate(llm8, embeds, attn, LLM_INT8_TOKENS,
                                     forced_ids=ref["ids"][:, :LLM_INT8_TOKENS],
                                     return_logits=True)
    e8 = rel_l2(logits8, ref["logits"][:, :LLM_INT8_TOKENS])
    per8 = (t8 * 1e3 - prefill8_ms) / (LLM_INT8_TOKENS - 1)
    log(f"llm int8 on {smi}: projection bytes {q_bytes / 2**30:.3f} GiB vs bf16's "
        f"{b_bytes / 2**30:.3f} GiB ({q_bytes / b_bytes:.4f}, bound {INT8_BYTES}); prefill "
        f"{prefill8_ms:.2f} ms, greedy {LLM_INT8_TOKENS} tokens {t8 * 1e3:.1f} ms: {per8:.2f} "
        f"ms a new token, {1e3 / per8:.2f} tok/s (plain PyTorch dequant a call); logits "
        f"along fp32's ids rel L2 {e8:.3e} from plain fp32 (not gated); ids the same as the "
        f"bf16 kernels' at {int((ids8 == ids_k[:, :LLM_INT8_TOKENS]).sum())}/"
        f"{LLM_INT8_TOKENS} steps; answer {texts8[0]!r}")
    if not bool(torch.isfinite(logits8).all()):
        raise RuntimeError("llm int8: non-finite logits")
    if not q_bytes <= INT8_BYTES * b_bytes:
        raise RuntimeError(f"llm int8: projection bytes {q_bytes} > {INT8_BYTES} x bf16's "
                           f"{b_bytes}")
    log(f"llm phase: peak memory allocated "
        f"{max(peaks + [torch.cuda.max_memory_allocated()]) / 2**30:.2f} GiB ({smi})")
    del models, llms, llm8, llm, m
    torch.cuda.empty_cache()
    return totals

STAGE2_YAML = "configs/step2_instruction.yaml"
# Batch 2 at the YAML's padded length: its BATCH_SIZE 8 keeps ~106 GB of LLM
# activations for the backward and does not fit one card (PERF.md section 7).
# The vocabulary of the offline tokenizer's ids (HashWord ids reach 49404).
STAGE2_OVERRIDES = ["BATCH_SIZE", "2", "STEPS_PER_EPOCH", "3", "LLM.VOCAB_SIZE", "49408"]
STAGE2_INT8 = ["BATCH_SIZE", "1", "STEPS_PER_EPOCH", "2", "LLM.VOCAB_SIZE", "49408",
               "LLM_QUANT", "int8"]
# path -> (attn_impl, dtype of the vision model and of the LLM), in the order they run
STAGE2_PATHS = {"plain_fp32": ("plain", "float32"), "plain_bf16": ("plain", "bfloat16"),
                "kernels": ("auto", "bfloat16")}
STAGE2_CORE = ("window_attention_block", "flash_attention_rowbias_proj", "block_tail")


def _bits(tensors) -> int:
    """A fingerprint of the tensors' bits: the sum of their words as
    integers (any changed bit moves it)."""
    words = {1: torch.int8, 2: torch.int16, 4: torch.int32}
    return sum(int(t.detach().reshape(-1).view(words[t.element_size()]).sum(dtype=torch.int64))
               for t in tensors)


def _token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The supervised tokens' negative log-likelihoods, whose mean is
    ``causal_lm_loss``."""
    from iuvl_tpu_torch.models.llm.multimodal import IGNORE_INDEX

    tgt = labels[:, 1:]
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    return -logp.gather(-1, tgt.clamp(min=0)[..., None])[..., 0][tgt != IGNORE_INDEX]


def _timed_trainer(cfg: dict, dev, label: str, smi: str) -> dict:
    """``Trainer(cfg, 'cuda').train()`` with each step synchronised and
    timed and its launches read (the trainer's ``make_llm_train_step``
    wrapped); the step's model, LLM, optimizer and last inputs kept, with
    fingerprints taken before the first step. Prints the step function's
    ms a step, the loop's (one step's start to the next's), launches a
    step and the peak memory."""
    from iuvl_tpu_torch.train import llm_step
    from iuvl_tpu_torch.train import trainer as trainer_mod

    held: dict = {"times": [], "counts": [], "starts": []}

    def timed_make(model, llm, optimizer, **kw):
        fn = llm_step.make_llm_train_step(model, llm, optimizer, **kw)
        frozen = [p for n, p in model.named_parameters() if n.startswith("image_encoder.")]
        held.update(model=model, llm=llm, fn=fn, proj=model.img_to_lang.weight.detach().clone(),
                    frozen=_bits(frozen), llm_bits=_bits(llm.parameters()))

        def step(*args):
            held["starts"].append(time.perf_counter())
            held["args"] = args
            reset_launches()
            out, secs = synced(lambda: fn(*args))
            held["times"].append(secs)
            held["counts"].append(launches())
            return out

        return step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _patched(trainer_mod, "make_llm_train_step", timed_make):
        trainer = trainer_mod.Trainer(cfg, dev)
        result = trainer.train()
    held.update(trainer=trainer, result=result, seconds=time.perf_counter() - t0,
                peak=torch.cuda.max_memory_allocated())
    ms = [f"{t * 1e3:.1f}" for t in held["times"]]
    # The loop's own time a step: one step's start to the next's, so with the
    # next batch's items, embed, copies to the card and text encode.
    loop = [f"{(b - a) * 1e3:.1f}" for a, b in zip(held["starts"], held["starts"][1:])]
    setup = held["starts"][0] - t0
    after_setup = (held["seconds"] - setup) / len(held["starts"])
    log(f"stage2 {label}: Trainer.train {held['seconds']:.1f} s in all, {setup:.1f} s of it "
        f"before the first step; {result}; the step function's ms a step {ms} (host clock, "
        f"synchronised); the loop's ms from one step's start to the next {loop}; (all - "
        f"set-up) / steps {after_setup * 1e3:.1f} ms (checkpoints included); launches a step "
        f"{[{k: v for k, v in c.items() if v} for c in held['counts']]}; peak "
        f"{held['peak'] / 2**30:.2f} GiB allocated ({smi})")
    if not np.isfinite(result["loss_llm"]):
        raise RuntimeError(f"stage2 {label}: loss {result}")
    return held


def stage2_phase(dev, smi: str) -> dict:
    """Stage-2 instruction tuning at full width (module docstring, 6):
    (a) the gate of one step through STAGE2_PATHS, (b) the trainer on the
    YAML with STAGE2_OVERRIDES, timed, (c) the int8 LLM. Returns the
    trainers' launch totals."""
    import os
    import shutil
    import tempfile

    from iuvl_tpu_torch.config import load_config
    from iuvl_tpu_torch.data.datasets import build_dataset
    from iuvl_tpu_torch.models.llm.llama import LlamaConfig, build_llama
    from iuvl_tpu_torch.models.xdecoder.model import build_syslearner
    from iuvl_tpu_torch.pipeline import model_config
    from iuvl_tpu_torch.runtime.checkpoint import CheckpointManager
    from iuvl_tpu_torch.train.llm_step import (make_llm_train_step, place_features,
                                               prepare_llm_batch)
    from iuvl_tpu_torch.train.trainer import llm_optimizer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.mkdtemp(prefix="iuvl_stage2_")
    cfg = load_config([STAGE2_YAML], STAGE2_OVERRIDES + ["SAVE_DIR", tmp])
    vcfg = model_config(cfg)
    max_len, n_img = cfg["LLM_MAX_LEN"], vcfg.num_queries - 1
    t0 = time.perf_counter()
    models, weights = {}, None
    for path, (attn, dtype) in STAGE2_PATHS.items():
        pcfg = dataclasses.replace(vcfg, attn_impl=attn, dtype=dtype)
        models[path] = build_syslearner(pcfg, device=dev, generator=None if weights else
                                        torch.Generator().manual_seed(SEED + 100))
        if weights is None:
            weights = models[path].state_dict()
        else:
            models[path].load_state_dict(weights)
    del weights
    lcfg = LlamaConfig(**dict(LLM_CONFIG, max_seq_len=max_len), dtype="float32",
                       param_dtype="float32")
    llms = {"float32": build_llama(lcfg, dev, torch.Generator(device=dev).manual_seed(SEED + 101))}
    llms["bfloat16"] = build_llama(dataclasses.replace(lcfg, dtype="bfloat16",
                                                       param_dtype="bfloat16"), dev)
    llms["bfloat16"].load_state_dict(llms["float32"].state_dict())
    torch.cuda.synchronize()
    log(f"stage2: {len(models)} x SysLearner ({vcfg.sam_size}, {vcfg.img_size}^2, llm_dim "
        f"{vcfg.llm_dim}) and the {sum(p.numel() for p in llms['float32'].parameters()) / 1e9:.3f}"
        f" B-parameter LLM (fp32, its bf16 copy) built in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")

    item = build_dataset(cfg["DATASETS"]["TRAIN"][0], cfg.get("INSTRUCTION_TRAIN", {}),
                         "train")[0]
    image = torch.from_numpy(item["image"][None]).to(dev)
    clip_ids = torch.from_numpy(item["clip_ids"][None]).to(dev)
    got: dict = {}
    biases: list = []
    failed: list = []
    for path, (_, dtype) in STAGE2_PATHS.items():
        m, llm = models[path], llms[dtype]
        opt = llm_optimizer(m, cfg)
        grads: dict = {}

        def capture(m=m, grads=grads, opt=opt):
            grads.update({n: p.grad.detach().clone() for n, p in m.named_parameters()
                          if n.startswith("img_to_lang.")})
            del opt.step  # the class's own again: no cycle keeps the model alive
            return opt.step()

        opt.step = capture
        step = make_llm_train_step(m, llm, opt)
        batch = prepare_llm_batch(llm, [item["input_ids"]], [item["labels"]],
                                  num_image_tokens=n_img, max_len=max_len)
        with torch.no_grad():
            ctx, _ = m.encode_text_tokens(clip_ids)
        along = (_recording(m.predictor._attn_bias_from_mask, biases)
                 if path == "plain_fp32" else _replaying(biases))
        # The supervised tokens' losses at the step's weights, forward only.
        with torch.no_grad(), _patched(m.predictor, "_attn_bias_from_mask", along):
            feats = m.project_image_features(m.llm_image_features(image, ctx))
            nll = _token_nll(llm(place_features(batch[0], feats, batch[1]), batch[2]), batch[3])
        del feats
        fixed = m.image_encoder.patch_embed.proj.weight.detach().clone()
        llm_bits = _bits(llm.parameters())
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with _patched(m.predictor, "_attn_bias_from_mask", along):
            metrics, secs = synced(lambda: step(image, ctx, *batch))
        counts = launches()
        peak = torch.cuda.max_memory_allocated() - base
        check_launches(f"stage2 gate {path}", counts,
                       PER_IMAGE["auto"] if path == "kernels" else {})
        proj = m.img_to_lang
        loss = metrics["loss_llm"].float()
        if not abs(float(nll.mean()) - float(loss)) <= 1e-5 * abs(float(loss)):
            failed.append(f"{path}: the step's loss {float(loss)} is not its tokens' mean "
                          f"{float(nll.mean())}")
        got[path] = {"loss": loss.reshape(1), "token_nll": nll,
                     "grad": torch.cat([grads["img_to_lang.weight"].float().flatten(),
                                        grads["img_to_lang.bias"].float().flatten()]),
                     "proj": torch.cat([proj.weight.detach().float().flatten(),
                                        proj.bias.detach().float().flatten()])}
        if not torch.equal(m.image_encoder.patch_embed.proj.weight, fixed):
            failed.append(f"{path}: a FIX_PARAM parameter moved")
        if _bits(llm.parameters()) != llm_bits:
            failed.append(f"{path}: the LLM's weights changed")
        if any(p.grad is not None for p in llm.parameters()):
            failed.append(f"{path}: an LLM weight has a gradient")
        for k, v in got[path].items():
            if not bool(torch.isfinite(v).all()):
                failed.append(f"{path}: non-finite {k}")
        log(f"stage2 gate {path}: loss_llm {float(metrics['loss_llm']):.6f}, projector grad "
            f"norm {float(torch.linalg.vector_norm(got[path]['grad'])):.4e}; {secs * 1e3:.1f} ms "
            f"(first step of the path); peak {peak / 2**30:.2f} GiB above {base / 2**30:.2f} GiB "
            f"resident ({smi})")
        for p in m.parameters():
            p.grad = None
        del step, opt, batch, metrics
        torch.cuda.empty_cache()
    if not torch.equal(llms["bfloat16"].lm_head.weight,
                       llms["float32"].lm_head.weight.to(torch.bfloat16)):
        failed.append("the bf16 LLM is no longer the fp32 weights rounded")
    # One loss scalar reads a rounding draw (PERF.md, the train gates): the gate
    # takes the supervised tokens' losses whose mean it is; the scalar is shown.
    log(_rel_ratio("stage2 loss_llm (not gated)", {p: v["loss"] for p, v in got.items()}, []))
    for key, label in (("token_nll", f"loss_llm's {got['kernels']['token_nll'].numel()} "
                                     "token losses"),
                       ("grad", "projector gradient"), ("proj", "updated projector")):
        log(_rel_ratio(f"stage2 {label}", {p: v[key] for p, v in got.items()}, failed))
    if failed:
        raise RuntimeError("stage2 gate failed: " + "; ".join(failed))
    # Nothing of the gate stays resident through the trainers' peaks.
    del models, llms, got, biases, along, m, llm, nll, loss
    torch.cuda.empty_cache()
    log(f"stage2 gate done: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated")

    # (b) The trainer on the YAML, timed.
    held = _timed_trainer(cfg, dev, "trainer (batch 2 x 1024)", smi)
    model, result = held["model"], held["result"]
    if result["final_step"] != cfg["STEPS_PER_EPOCH"]:
        raise RuntimeError(f"stage2 trainer: final step {result['final_step']}")
    if torch.equal(model.img_to_lang.weight, held["proj"]):
        raise RuntimeError("stage2 trainer: the projector did not move")
    if _bits(p for n, p in model.named_parameters() if n.startswith("image_encoder.")) \
            != held["frozen"]:
        raise RuntimeError("stage2 trainer: a FIX_PARAM parameter moved")
    if _bits(held["llm"].parameters()) != held["llm_bits"]:
        raise RuntimeError("stage2 trainer: the LLM's weights changed")
    totals: dict = {}
    for i, counts in enumerate(held["counts"]):
        if any(counts.get(k, 0) <= 0 for k in STAGE2_CORE) or counts != held["counts"][0]:
            raise RuntimeError(f"stage2 trainer: step {i + 1} launches {counts}")
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
    ckpt = CheckpointManager(os.path.join(held["trainer"].run_dir, "ckpt"))
    restored = ckpt.restore()
    fresh = build_syslearner(model_config(cfg), device=dev)
    fresh.load_state_dict(restored["params"], strict=True)
    trained = model.state_dict()
    bad = [k for k, v in fresh.state_dict().items() if not torch.equal(v, trained[k])]
    if restored["step"] != result["final_step"] or bad:
        raise RuntimeError(f"stage2 checkpoint: step {restored['step']}, unequal {bad[:5]}")
    log(f"stage2 checkpoint: steps {ckpt.all_steps()} under {ckpt.directory}; step "
        f"{restored['step']} restored into a fresh model, {len(trained)} tensors equal")
    del fresh, restored, trained
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, t_prof = synced(lambda: held["fn"](*held["args"]))
    kernels_ = [a for a in prof.key_averages()
                if a.device_type == torch.autograd.DeviceType.CUDA
                and a.self_device_time_total > 0]
    dev_ms = sum(a.self_device_time_total for a in kernels_) / 1e3
    top = sorted(kernels_, key=lambda a: a.self_device_time_total, reverse=True)[:6]
    log(f"stage2 trainer: one more step under torch.profiler: {dev_ms:.2f} ms of device time "
        f"in a {t_prof * 1e3:.1f} ms host span, idle {100 * (1 - dev_ms / (t_prof * 1e3)):.1f}% "
        f"({len(kernels_)} kernel names; {smi}); "
        + "; ".join(f"{a.self_device_time_total / 1e3:.2f} ms {a.count}x {a.key[:60]}"
                    for a in top))
    del held, model, prof
    torch.cuda.empty_cache()

    # (c) int8: the frozen LLM quantised, batch 1.
    cfg8 = load_config([STAGE2_YAML], STAGE2_INT8 + ["SAVE_DIR", tmp])
    held = _timed_trainer(cfg8, dev, "int8 trainer (batch 1 x 1024)", smi)
    for counts in held["counts"]:
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
    del held
    torch.cuda.empty_cache()
    shutil.rmtree(tmp, ignore_errors=True)
    return totals


# C9: the deformable core at head width 32 (SYSLEARNER_DIM 256 over 8 heads;
# JAX's pipeline sets TEXT_WIDTH from it too).
C9_CONFIG = dict(TRAIN_CONFIG, syslearner_dim=256, text_width=256)
C9_EVAL_PATHS = {"plain_fp32": ("plain", "auto", "float32"),
                 "plain_bf16_hybrid": ("plain", "hybrid", "bfloat16"),
                 "kernels_hybrid": ("auto", "hybrid", "bfloat16")}


def c9_phase(dev) -> dict:
    """The main paths at head width 32 (C9_CONFIG): one seeded 1024^2 image
    through evaluate_seg on the 'hybrid' kernels (B15 on res5), plain bf16
    'hybrid' and plain fp32, on one set of weights and seeded class
    embeddings, the kernel path held to the eval gate; then one batch-2
    'auto' train step through the kernels (the flat core: B7 and B8). Both
    launch what they launch at head width 64 and give finite outputs.
    Returns the launch totals."""
    from iuvl_tpu_torch.losses.criterion import CriterionConfig, SegCriterion
    from iuvl_tpu_torch.models.xdecoder import convert
    from iuvl_tpu_torch.models.xdecoder.model import SysLearnerConfig, build_syslearner
    from iuvl_tpu_torch.train.optimizer import Optimizer
    from iuvl_tpu_torch.train.train_step import TrainState, make_train_step

    cfg = SysLearnerConfig(**C9_CONFIG)
    gen = torch.Generator().manual_seed(SEED + 40)
    rs = np.random.RandomState(SEED + 41)
    text = torch.from_numpy(rs.randn(N_CLASSES + 1, cfg.syslearner_dim).astype(np.float32))
    text = text.to(dev)
    models, weights = {}, None
    for path, (attn, msdeform, dtype) in C9_EVAL_PATHS.items():
        pcfg = dataclasses.replace(cfg, attn_impl=attn, msdeform_impl=msdeform, dtype=dtype)
        models[path] = build_syslearner(pcfg, device=dev,
                                        generator=gen if weights is None else None).eval()
        if weights is None:
            weights = models[path].state_dict()
        else:
            models[path].load_state_dict(weights)
    del weights
    image = make_batch(rs, 1, cfg.img_size, dev)[0]
    totals, outs = {}, {}
    with torch.no_grad():
        for path, m in models.items():
            reset_launches()
            (cls, pred), secs = synced(lambda: m.evaluate_seg(image, text))
            counts = launches()
            check_launches(f"c9 eval {path}", counts,
                           PER_IMAGE["hybrid"] if path.startswith("kernels") else {})
            if path.startswith("kernels"):
                totals = {k: v for k, v in counts.items() if v}
            if not bool(torch.isfinite(cls).all() & torch.isfinite(pred).all()):
                raise RuntimeError(f"c9 eval {path}: non-finite outputs")
            outs[path] = (cls.float(), pred.float())
            log(f"c9 eval {path} (head width 32): evaluate_seg {secs * 1e3:.1f} ms, launches "
                f"{({k: v for k, v in counts.items() if v})}")
    del models
    ref = outs.pop("plain_fp32")
    failed = []
    for j, label in enumerate(("mask_cls", "mask_pred")):
        e = rel_l2(outs["kernels_hybrid"][j], ref[j])
        y = rel_l2(outs["plain_bf16_hybrid"][j], ref[j])
        log(f"c9 eval {label}: rel L2 to fp32 kernels_hybrid {e:.3e}, plain_bf16_hybrid {y:.3e}; "
            f"ratio {e / y:.3f} (bound {SLICE_FACTOR})")
        if not e <= SLICE_FACTOR * y:
            failed.append(f"{label}: {e:.3e} > {SLICE_FACTOR} x {y:.3e}")
    del outs, ref
    if failed:
        raise RuntimeError("c9 eval gate failed: " + "; ".join(failed))

    model = build_syslearner(cfg, device=dev, generator=gen)
    state = TrainState(Optimizer(model.named_parameters(), paths=convert.flax_paths(cfg),
                                 base_lr=1e-4, total_steps=1000))
    crit = SegCriterion(CriterionConfig(num_classes=N_CLASSES), impl=cfg.kernels_impl)
    step = make_train_step(model, crit, match_points=MATCH_POINTS)
    image, targets = make_batch(rs, 2, cfg.img_size, dev)
    draws = step_draws(torch.Generator(device=dev).manual_seed(SEED + 42), 10, 2)
    grads = {}
    capture_grads(state, model, grads)
    reset_launches()
    (_, metrics), secs = synced(lambda: step(state, image, text, targets, draws))
    counts = launches()
    check_step_launches(0, counts, {}, PER_STEP[2])
    for name, got in counts.items():
        totals[name] = totals.get(name, 0) + got
    bad = [k for k, v in metrics.items() if k != "assignments" and not bool(torch.isfinite(
        torch.as_tensor(v)).all())]
    bad += [k for k, g in grads.items() if not bool(torch.isfinite(g).all())]
    log(f"c9 train step (batch 2, head width 32): {secs * 1e3:.1f} ms, loss_total "
        f"{float(metrics['loss_total']):.4f}, grad_norm {float(metrics['grad_norm']):.4f}, "
        f"{len(grads)} gradients")
    if bad:
        raise RuntimeError(f"c9 train step: non-finite {bad[:8]}")
    del model, state, grads
    torch.cuda.empty_cache()
    return totals


INTERACTIVE_CONFIG = dict(sam_size="base", img_size=1024, dtype="bfloat16")
INTERACTIVE_ROUNDS = 20
INTERACTIVE_GATED = (1, 10, 20)  # rounds whose SAM decode is gated
LATENCY_CALLS = 20
# Launches a click round (a prompt batch of the 8 targets, 26 tokens): the
# per-op decode (B4 three times, B5 twice; B6 skipped: no caller reads SAM's
# masks) or B16 once; the unified decoder runs no kernel. The encode: B1-B3 (the pixel decoder's batch-1
# core is the plain 'wide' one).
PER_ROUND = {"auto": {"t2i_stream": 3, "i2t_block_step": 2},
             "chunk": {"decode_tail": 1}}


def gt_shapes(size: int = 1024) -> np.ndarray:
    """8 synthetic gt masks at input resolution: discs, boxes and an L
    (their geometry given for 1024^2, scaled to ``size``)."""
    yy, xx = np.meshgrid(np.arange(size) * 1024 / size, np.arange(size) * 1024 / size,
                         indexing="ij")
    masks = [(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
             for cy, cx, r in ((300, 320, 160), (700, 650, 210), (520, 180, 90))]
    for y0, y1, x0, x1 in ((80, 300, 560, 960), (760, 980, 60, 420), (400, 460, 300, 900)):
        box = np.zeros((size, size), bool)
        box[y0:y1, x0:x1] = True
        masks.append(box)
    ell = np.zeros((size, size), bool)
    ell[560:940, 520:640] = True
    ell[840:940, 520:960] = True
    masks.append(ell)
    masks.append((yy - 150) ** 2 + (xx - 150) ** 2 <= 70 ** 2)
    return np.stack(masks)


class _Recorder:
    """A SysLearner whose ``decode_interactive`` also keeps each round's
    prompts and logits, and whose launches a round are checked."""

    def __init__(self, model, want: dict):
        self.model, self.want, self.rounds = model, want, []

    def decode_interactive(self, *cached, points, labels):
        reset_launches()
        logits = self.model.decode_interactive(*cached, points=points, labels=labels)
        counts = launches()
        check_launches(f"interactive round {len(self.rounds) + 1}", counts, self.want)
        self.rounds.append((points.clone(), labels.clone(), logits, counts))
        return logits


def _gate_ratio(where: str, k, p, f, ref: str, failed: list) -> str:
    """The kernel path's rel L2 from fp32 against ``ref`` bf16's: a log
    fragment; a failure (over SLICE_FACTOR) is appended to ``failed``."""
    err_k, err_p = rel_l2(k, f), rel_l2(p, f)
    if not err_k <= SLICE_FACTOR * err_p:
        failed.append(f"{where}: rel L2 to fp32 {err_k:.3e} over {SLICE_FACTOR} x {ref}'s "
                      f"{err_p:.3e}")
    return f"{where} {err_k:.3e} / {err_p:.3e} ({err_k / err_p:.3f})"


def interactive_gate(design: str, model, cached, plain16, plain32, rec, image,
                     refs: tuple) -> None:
    """Replay the kernel path's prompts through the plain bf16 and fp32
    paths (each encoding the image itself) and gate, at SLICE_FACTOR x the
    plain bf16 path's distance from fp32: the cached encode products (SAM
    embedding, mask features, the pixel decoder's levels); SAM's prompt
    decode (masks, upscaled embedding) at rounds INTERACTIVE_GATED, where
    the decode kernels act; the unified decoder's logits pooled over all the
    rounds. The unified decoder's mask attention is a step function of the
    previous layer's logits, so one round's logits are no gate: a sound
    control path reads up to 1.60x on one round (tools/interactive_gate_spread.py,
    PERF.md §6); their per-round ratios at INTERACTIVE_GATED are printed."""
    failed = []
    caches = {"kernels": cached, refs[0]: plain16.encode_interactive(image),
              refs[1]: plain32.encode_interactive(image)}
    flat = {path: (c[0], c[1], torch.cat([x.float().flatten() for x in c[2]]))
            for path, c in caches.items()}
    log(f"interactive {design} encode products vs {refs[1]}: rel L2 kernels / {refs[0]} "
        "(ratio): " + "; ".join(_gate_ratio(name, flat["kernels"][i], flat[refs[0]][i],
                                            flat[refs[1]][i], refs[0], failed)
                                for i, name in enumerate(("sam_embedding", "mask_features",
                                                          "multi_scale"))))
    logits = {path: [] for path in refs}
    for r, (points, labels, k_logits, _) in enumerate(rec.rounds, 1):
        for path, m in ((refs[0], plain16), (refs[1], plain32)):
            logits[path].append(m.decode_interactive(*caches[path], points=points,
                                                     labels=labels))
        if r not in INTERACTIVE_GATED:
            continue
        dec = {path: m.decode_prompts(caches[path][0], points=points, labels=labels)
               for path, m in (("kernels", model), (refs[0], plain16), (refs[1], plain32))}
        parts = [_gate_ratio(name, dec["kernels"][key], dec[refs[0]][key], dec[refs[1]][key],
                             refs[0], failed)
                 for name, key in (("SAM masks", "masks"),
                                   ("upscaled embedding", "upscaled_embedding"))]
        err_k, err_p = (rel_l2(x, logits[refs[1]][-1]) for x in (k_logits, logits[refs[0]][-1]))
        log(f"interactive {design} round {r} vs {refs[1]}: rel L2 kernels / {refs[0]} (ratio): "
            + "; ".join(parts) + f"; logits {err_k:.3e} / {err_p:.3e} ({err_k / err_p:.3f}, "
            "one round, not gated)")
        del dec
    pooled = [torch.cat([x.flatten() for x in xs]) for xs in (
        [k for *_, k, _ in rec.rounds], logits[refs[0]], logits[refs[1]])]
    log(f"interactive {design} logits over {len(rec.rounds)} rounds vs {refs[1]}: rel L2 "
        "kernels / " + refs[0] + " (ratio): " + _gate_ratio("logits", *pooled, refs[0], failed))
    if failed:
        raise RuntimeError(f"interactive {design} gate failed: " + "; ".join(failed))


def interactive_phase(dev) -> dict:
    """SAM x X-Decoder interactive segmentation at full width: one seeded
    1024^2 image and 8 synthetic gt masks, first clicks at their
    ``conv_dt_argmax``; ``encode_interactive`` once, then the 20-round
    click loop through ``decode_interactive`` with the kernels, under
    twoway_impl 'auto' (B4, B5) and then 'chunk' (B16 at 32 slots).
    Launches checked per round. Gate (:func:`interactive_gate`): the kernel
    path's clicks replayed through the plain bf16 and fp32 paths ('plain' /
    'chunk_plain'). Printed: encode ms, ms a round, launches a round, NoC and
    mIoU@k (meaningless on random weights), and the p50 prompt latency of
    bench.py's protocol (one one-point prompt through decode_interactive
    from the cached products, median of LATENCY_CALLS synchronised calls).
    Returns the launch totals."""
    from iuvl_tpu_torch.data.visual_sampler import conv_dt_argmax
    from iuvl_tpu_torch.evaluation import InteractiveEvaluator
    from iuvl_tpu_torch.inference.interactive import make_interactive_loop
    from iuvl_tpu_torch.models.xdecoder.model import SysLearnerConfig, build_syslearner

    cfg = SysLearnerConfig(**INTERACTIVE_CONFIG)
    size = cfg.img_size
    t0 = time.perf_counter()
    models = {"auto": build_syslearner(cfg, device=dev, generator=torch.Generator().manual_seed(
        SEED + 50)).eval()}
    weights = models["auto"].state_dict()
    paths = {"chunk": ("auto", "chunk", "bfloat16"),
             "plain_bf16": ("plain", "plain", "bfloat16"),
             "plain_fp32": ("plain", "plain", "float32"),
             "chunk_plain_bf16": ("plain", "chunk_plain", "bfloat16"),
             "chunk_plain_fp32": ("plain", "chunk_plain", "float32")}
    for path, (attn, twoway, dtype) in paths.items():
        models[path] = build_syslearner(dataclasses.replace(
            cfg, attn_impl=attn, twoway_impl=twoway, dtype=dtype), device=dev).eval()
        models[path].load_state_dict(weights)
    del weights
    log(f"interactive: {len(models)} x SysLearner built in {time.perf_counter() - t0:.1f} s")
    image = torch.from_numpy(np.random.RandomState(SEED + 51).rand(1, size, size, 3).astype(
        np.float32) * 255).to(dev)
    gt_np = gt_shapes(size)
    gt = torch.from_numpy(gt_np).to(dev)
    firsts = torch.tensor([conv_dt_argmax(m)[::-1] for m in gt_np], dtype=torch.float32,
                          device=dev)
    totals: dict = {}
    with torch.inference_mode():
        for design, refs in (("auto", ("plain_bf16", "plain_fp32")),
                             ("chunk", ("chunk_plain_bf16", "chunk_plain_fp32"))):
            model = models[design]
            reset_launches()
            cached, encode_s = synced(lambda: model.encode_interactive(image))
            counts = launches()
            check_launches(f"interactive encode ({design})", counts, ENCODE_PER_REQUEST)
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
            rec = _Recorder(model, PER_ROUND[design])
            loop = make_interactive_loop(rec, max_clicks=INTERACTIVE_ROUNDS)
            gen = torch.Generator(device=dev).manual_seed(SEED + 52)
            t_loop = time.perf_counter()
            ious, final = loop(*cached, gt, firsts, gen)
            torch.cuda.synchronize()
            loop_s = time.perf_counter() - t_loop
            for *_, c in rec.rounds:
                for k, v in c.items():
                    totals[k] = totals.get(k, 0) + v
            if tuple(ious.shape) != (INTERACTIVE_ROUNDS, len(gt_np)) or not all(
                    bool(torch.isfinite(lg).all()) for *_, lg, _ in rec.rounds):
                raise RuntimeError(f"interactive {design}: ious {tuple(ious.shape)} or "
                                   "non-finite logits")
            evaluator = InteractiveEvaluator(max_clicks=INTERACTIVE_ROUNDS)
            for traj in ious.cpu().numpy().T:
                evaluator.process(traj)
            metrics = evaluator.evaluate()
            log(f"interactive {design}: encode {encode_s * 1e3:.2f} ms; {INTERACTIVE_ROUNDS} "
                f"rounds of {len(gt_np)} prompts (26 tokens) in {loop_s * 1e3:.1f} ms, "
                f"{loop_s / INTERACTIVE_ROUNDS * 1e3:.2f} ms a round; launches a round "
                f"{({k: v for k, v in rec.rounds[0][3].items() if v})}; NoC@0.85 "
                f"{metrics['NoC@0.85']:.2f}, mIoU@5 {metrics['mIoU@5']:.2f} (random weights)")
            interactive_gate(design, model, cached, models[refs[0]], models[refs[1]], rec,
                             image, (refs[0], refs[1]))
            del rec
            # p50 prompt latency (bench.py's protocol): one one-point prompt.
            point = torch.tensor([[[size / 2, size / 2]]], device=dev)
            label = torch.ones((1, 1), dtype=torch.int32, device=dev)
            lat = []
            for _ in range(LATENCY_CALLS + 2):
                lat.append(synced(lambda: model.decode_interactive(
                    *cached, points=point, labels=label))[1])
            lat = sorted(lat[2:])
            log(f"interactive {design}: p50 prompt latency {float(np.median(lat)) * 1e3:.2f} ms "
                f"(min {lat[0] * 1e3:.2f}, max {lat[-1] * 1e3:.2f}; {LATENCY_CALLS} "
                "synchronised calls of one one-point prompt through decode_interactive)")
            del cached
    del models
    torch.cuda.empty_cache()
    return totals


# -- C11: B4-B6 under autograd ------------------------------------------------
C11_BOUND = 1e-6  # the Functions' backward is the plain vjp itself: it should read 0


def _keys_cotangent_dropped(index: int):
    """A ``plain_vjp`` whose cotangent of the keys (input ``index``) is
    zero: the planted fault of a backward that loses the keys' gradient."""
    from iuvl_tpu_torch.ops.common import plain_vjp as sound

    def fault(plain, saved, needs, g, *static):
        grads = sound(plain, saved, needs, g, *static)
        grads[index] = torch.zeros_like(grads[index])
        return grads
    return fault


def c11_cases(dev) -> None:
    """C11: B4, B5 and B6 as autograd Functions at the spatial stream's
    shapes (3 one-click prompts, 7 tokens, block 0's batch-1 keys of the
    64^2 grid for B4 / B5, per-prompt keys for B6; bf16). The forward under
    autograd gives the kernel's bits (the call under ``no_grad``); the
    backward of every input equals the plain version's vjp of the same
    inputs within C11_BOUND; a planted fault (the keys' cotangent dropped)
    must break the bound."""
    from iuvl_tpu_torch.ops.cuda import mask_upscale as mu
    from iuvl_tpu_torch.ops.cuda import twoway_attention as ta

    rs = np.random.RandomState(SEED + 70)

    def t(*shape, std=1.0, dtype=torch.bfloat16):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32) * std).to(dev, dtype)

    n, c, i, p, tok = 4096, ta.C, ta.I, 3, 7
    cases = (
        ("t2i_stream", ta, ta.t2i_stream, ta.t2i_stream_plain, 1,
         (t(p, tok, i, std=0.25), t(1, n, c), t(n, i, std=BIAS_STD), t(i, c, std=c ** -0.5),
          t(i, std=BIAS_STD), t(i, c, std=c ** -0.5), t(i, std=BIAS_STD)), (ta.HEADS,)),
        ("i2t_block_step", ta, ta.i2t_block_step, ta.i2t_block_step_plain, 0,
         (t(1, n, c), t(n, i, std=BIAS_STD), t(p, tok, i), t(p, tok, i), t(i, c, std=c ** -0.5),
          t(i, std=BIAS_STD), t(c, i, std=i ** -0.5), t(c, std=BIAS_STD),
          t(c, std=0.1, dtype=torch.float32) + 1, t(c, std=0.1, dtype=torch.float32)),
         (ta.HEADS,)),
        ("masks_upscale", mu, mu.masks_upscale, mu.masks_upscale_plain, 0,
         (t(p, n, c), t(c, c, std=c ** -0.5), t(c // 4, std=BIAS_STD),
          t(c // 4, std=0.1, dtype=torch.float32) + 1, t(c // 4, std=0.1, dtype=torch.float32),
          t(c // 4, c // 2, std=(c // 4) ** -0.5), t(c // 8, std=BIAS_STD),
          t(p, mu.M, c // 8, std=0.25)), ()),
    )
    for name, module, fn, plain, keys_at, args, static in cases:
        with torch.no_grad():
            bits = fn(*args, *static)
        inputs = [a.detach().requires_grad_() for a in args]
        with torch.enable_grad():
            out = fn(*inputs, *static)
            g = torch.randn(out.shape, generator=torch.Generator(device=dev).manual_seed(SEED),
                            device=dev).to(out.dtype)
            got = torch.autograd.grad(out, inputs, g)
            ref = torch.autograd.grad(plain(*inputs, *static), inputs, g)
            with _patched(module, "plain_vjp", _keys_cotangent_dropped(keys_at)):
                faulty = torch.autograd.grad(fn(*inputs, *static), inputs, g)
        if not torch.equal(out, bits):
            raise RuntimeError(f"C11 {name}: the forward under autograd is not the kernel's bits")
        errs = [rel_l2(a, b) for a, b in zip(got, ref)]
        equal = sum(torch.equal(a, b) for a, b in zip(got, ref))
        fault_err = rel_l2(faulty[keys_at], ref[keys_at])
        log(f"C11 {name}: forward under autograd = the kernel's bits; backward vs the plain "
            f"version's vjp: max rel L2 {max(errs):.3e} over {len(errs)} inputs ({equal} "
            f"bit-equal; bound {C11_BOUND:g}); keys' cotangent dropped: {fault_err:.3e}")
        if max(errs) > C11_BOUND:
            raise RuntimeError(f"C11 {name}: backward rel L2 {max(errs):.3e} > {C11_BOUND}")
        if not fault_err > C11_BOUND:
            raise RuntimeError(f"C11 {name}: the planted fault was not caught")


# -- The joint step-1 train step ----------------------------------------------
JOINT_CONFIG = dict(TRAIN_CONFIG, retrieval_ensemble=True)
JOINT_PATHS = {"plain_fp32": ("plain", "plain", "float32"),  # attn_impl, twoway_impl, dtype
               "plain_bf16": ("plain", "plain", "bfloat16"),
               "kernels": ("auto", "auto", "bfloat16")}
JOINT_STEPS = 3
# Two VLP images: with one, the retrieval losses' softmax has no negative
# and reads 0, and backbone_proj gets no gradient.
JOINT_VLP_BATCH = 2
JOINT_GRAD_BATCHES = 4  # the gradient groups pooled over the gate's first batches
JOINT_TERMS = ("loss_mask_ce", "loss_mask_bce", "loss_mask_dice", "loss_caption",
               "loss_grounding_bce", "loss_grounding_dice", "loss_grounding_ce",
               "loss_spatial_bce", "loss_spatial_dice", "loss_captioning",
               "loss_retrieval_decoder", "loss_retrieval_backbone")
# Terms with one value a batch. Over GATE_BATCHES values a sound path's
# ratio would pass 1.25 about one time in five if the two bf16 paths' errors
# were independent (an F(16, 16) ratio), so they are pooled over
# JOINT_POOL_BATCHES more batches: forward only, the two streams they read.
PER_IMAGE_TERMS = ("loss_spatial_bce", "loss_spatial_dice", "loss_captioning",
                   "loss_retrieval_decoder", "loss_retrieval_backbone")
JOINT_POOL_BATCHES = 112
JOINT_POOL_GROUP = 4  # batches a forward in the pool (4 seg images, 8 VLP images)
JOINT_OUTPUTS = ("spatial logits", "pred_captionings", "class query", "caption embedding",
                 "backbone embedding")
JOINT_GROUPS = GROUPS + ("lang_encoder.", "prompt_encoder.", "mask_decoder.", "backbone_proj.")
# Parameters that the spatial, caption, grounding and VLP streams reach
# (JAX's step gives each a nonzero gradient): each prefix must have one
# parameter with a nonzero, finite gradient on the card.
JOINT_REACH = ("mask_decoder.transformer.layers.0.cross_attn_token_to_image.k_proj",
               "mask_decoder.transformer.layers.1.cross_attn_image_to_token.q_proj",
               "mask_decoder.transformer.final_attn_token_to_image.v_proj",
               "mask_decoder.output_upscaling", "prompt_encoder.point_embeddings.1",
               "predictor.sam_query_proj", "predictor.sam_feat_proj",
               "predictor.pos_embed_caping", "predictor.caping_embed",
               "lang_encoder.lang_encoder.blocks.0.", "lang_encoder.lang_encoder.token_embedding",
               "lang_encoder.lang_proj", "lang_encoder.logit_scale", "backbone_proj",
               "image_encoder.orig_neck")
# Launches a joint step: the seg and the VLP encodes on the training route
# (B1 + B9, B3 + B10, B11 forward and backward), the VLP pixel decoder at
# batch 2 (B7 + B8), the criterion's point sample (B12), SAM's decode of the
# spatial prompts (B4 three times, B5 twice; B6 skipped: no mask is read).
JOINT_PER_STEP = {**{k: 2 * v for k, v in PER_STEP[1].items() if k != "tap_scatter"},
                  "tap_scatter": 10, **DEFORM_STEP, "t2i_stream": 3, "i2t_block_step": 2}
JOINT_CAPTIONS = ("a man riding a bicycle next to a red car on the street",
                  "two dogs playing with a ball on the green grass",
                  "a plate of food with a fork and a knife on a wooden table",
                  "a group of people standing near a bus at the station")
JOINT_PHRASES = ("the round object on the upper left", "the large disc in the lower right",
                 "the small circle at the left edge", "the box in the top right corner",
                 "the wide rectangle at the bottom left", "the thin bar across the middle",
                 "the L shaped region at the bottom", "the small round spot in the corner")


def joint_loss_keys(n_layers: int = 10) -> set:
    """The loss keys of JAX's joint step for every stream, 10 kept layers."""
    sfx = ["_0" if i == n_layers - 1 else f"_{i + 1}" for i in range(n_layers)]
    per_layer = ("loss_mask_ce", "loss_mask_bce", "loss_mask_dice", "loss_caption",
                 "loss_grounding_bce", "loss_grounding_dice", "loss_grounding_ce")
    return {k + s for k in per_layer for s in sfx} | {
        "loss_spatial_bce_0", "loss_spatial_dice_0", "loss_captioning_0",
        "loss_retrieval_decoder_0", "loss_retrieval_backbone_0"}


def cached_draws(gen: torch.Generator):
    """A Draw from ``gen`` that gives every name the same tensor each time
    it is asked: the paths of one batch share their draws."""
    drawn = {}

    def draw(name: str, shape: tuple) -> torch.Tensor:
        if name not in drawn:
            drawn[name] = torch.rand(shape, generator=gen, device=gen.device)
        return drawn[name]
    return draw


class JointData:
    """Seeded batches of the joint step at 1024^2: one seg image with the
    8 ``gt_shapes`` masks at mask stride 4 (a random class and validity
    each), its step-1 extras from the port's ``Step1ExtrasBuilder`` (6
    phrases, up to 5 grounding sentences of 24 tokens, ``text`` mode) and
    ``spatial_prompt_arrays`` (3 ShapeSampler prompts), one template a
    class of the 134 COCO panoptic names (``ClassPromptBank``, live text),
    and JOINT_VLP_BATCH VLP images with 77-token captions."""

    def __init__(self, dev, seed: int):
        from iuvl_tpu_torch.data.class_names import get_class_names
        from iuvl_tpu_torch.data.step1 import ClassPromptBank, Step1ExtrasBuilder
        from iuvl_tpu_torch.data.tokenizer import build_tokenizer
        from iuvl_tpu_torch.data.visual_sampler import ShapeSampler

        self.dev, self.rs = dev, np.random.RandomState(seed)
        self.tok = build_tokenizer()
        self.side = JOINT_CONFIG["img_size"]
        self.masks = gt_shapes(self.side // 4).astype(np.float32)
        self.builder = Step1ExtrasBuilder(self.tok, mask_hw=self.masks.shape[1:])
        self.sampler = ShapeSampler(max_candidate=3, seed=seed)
        self.bank = ClassPromptBank(get_class_names("coco_panoptic"), self.tok)
        self.gen = torch.Generator(device=dev).manual_seed(seed)

    def batch(self):
        """(seg image, text ids, targets, vlp batch, extras) on the card and
        a Draw."""
        from iuvl_tpu_torch.data.step1 import spatial_prompt_arrays
        from iuvl_tpu_torch.losses.criterion import SegTargets

        rs, dev, n = self.rs, self.dev, len(self.masks)

        def on(x, batch_dim=True):
            x = torch.from_numpy(np.asarray(x))
            return (x[None] if batch_dim else x).to(dev)

        image = rs.rand(1, self.side, self.side, 3).astype(np.float32) * 255
        targets = SegTargets(labels=on(rs.randint(0, N_CLASSES, n)), masks=on(self.masks),
                             valid=on(rs.rand(n) > 0.2))
        extras = self.builder(JOINT_CAPTIONS[rs.randint(len(JOINT_CAPTIONS))],
                              list(JOINT_PHRASES), self.masks, mode="text", rs=rs)
        extras.update(spatial_prompt_arrays(self.sampler, self.masks, 4, rs))
        extras["grounding_target_valid"] = extras.pop("grounding_valid")
        extras = {k: on(v) for k, v in extras.items()}
        text = {k: on(v, False) for k, v in self.bank.sample(rs).items()}
        caps = self.tok([JOINT_CAPTIONS[j] for j in rs.permutation(len(JOINT_CAPTIONS))[
            :JOINT_VLP_BATCH]])  # the context length, 77 tokens
        vlp = {"images": on(rs.rand(JOINT_VLP_BATCH, self.side, self.side, 3).astype(
                   np.float32) * 255, False),
               "caption_ids": on(caps["input_ids"], False),
               "caption_mask": on(caps["attention_mask"], False)}
        return (on(image, False), text, targets, vlp, extras), cached_draws(self.gen)


def _discrete_choices(model, record: bool, taken: dict):
    """Record (``record``) or replay the step's discrete choices into or
    from ``taken``: each unified-decoder layer's mask-attention bias (a
    threshold of the previous layer's mask logits) and each importance
    sample of uncertain points (a top-k of the detached logits), in call
    order."""
    from iuvl_tpu_torch.losses import criterion, grounding

    stack = contextlib.ExitStack()
    for key, owner, name in (("mask attention", model.predictor, "_attn_bias_from_mask"),
                             ("criterion points", criterion, "uncertain_point_coords"),
                             ("grounding points", grounding, "uncertain_point_coords")):
        calls = taken.setdefault(key, [])
        stack.enter_context(_patched(owner, name, _recording(getattr(owner, name), calls)
                                     if record else _replaying(calls)))
    return stack


def _stream_outputs(model, into: dict):
    """Keep, in ``into``, the spatial stream's mask logits and the VLP
    outputs that the per-image losses read, as fp32 on the host."""
    def spatial(*a, **kw):
        out = spatial_decode(*a, **kw)
        into["spatial logits"] = out.detach().float().cpu()
        return out

    def vlp(*a, **kw):
        out = forward_vlp_train(*a, **kw)
        for key, name in (("pred_captionings", "pred_captionings"),
                          ("caption_class_emb", "caption embedding"),
                          ("backbone_emb", "backbone embedding")):
            into[name] = out[key].detach().float().cpu()
        into["class query"] = out["pred_captions"][:, -1].detach().float().cpu()
        return out

    spatial_decode, forward_vlp_train = model.spatial_decode, model.forward_vlp_train
    stack = contextlib.ExitStack()
    stack.enter_context(_patched(model, "spatial_decode", spatial))
    stack.enter_context(_patched(model, "forward_vlp_train", vlp))
    return stack


def joint_gate(models: dict, losses_of: dict, data: JointData, smi: str) -> None:
    """Gate each joint loss term (its values over the kept layers) pooled
    over GATE_BATCHES batches, every path at the same weights with the fp32
    path's matchings, the same draws, and, where a discrete choice is
    taken, fp32's (:func:`_discrete_choices`: each decoder layer's mask
    attention and each importance sample of points, recorded on plain fp32
    and replayed on the bf16 paths; without the replay one batch's ratio of
    a sound path reads 0.02-585, as the VL phase's greedy grounding did): the
    kernel path's rel L2 from fp32 at most SLICE_FACTOR times plain bf16's
    (loss_gate's rule). The PER_IMAGE_TERMS pool JOINT_POOL_BATCHES more
    batches (:func:`per_image_pool`); the stream outputs they read
    (JOINT_OUTPUTS: the spatial prompts' mask logits, the VLP captioning
    embeddings, class-query and caption embeddings, the backbone embedding)
    are gated too, pooled over the GATE_BATCHES batches. On the
    first JOINT_GRAD_BATCHES batches the backward runs too: each parameter
    group's gradient, pooled over them, is gated the same way, and on the
    first the kernel path's gradient must be finite and reach every
    JOINT_REACH prefix. Every path returns JAX's loss keys, finite; the
    plain paths launch no kernel."""
    paths = tuple(JOINT_PATHS)
    want_keys = joint_loss_keys()
    values = {path: {term: [] for term in JOINT_TERMS} for path in paths}
    streams = {path: {name: [] for name in JOINT_OUTPUTS} for path in paths}
    sq = {path: {g: [0.0, 0.0] for g in JOINT_GROUPS} for path in paths[1:]}
    peak = {path: 0 for path in paths}
    one = {term: [] for term in JOINT_TERMS}
    for b in range(GATE_BATCHES):
        args, draw = data.batch()
        assignments, ref, per, taken = None, None, {}, {}
        for path in paths:
            model = models[path]
            reset_launches()
            torch.cuda.reset_peak_memory_stats()
            kept = {}
            with torch.enable_grad(), _discrete_choices(model, path == paths[0], taken), \
                    _stream_outputs(model, kept):
                out = losses_of[path](*args, draw, assignments=assignments)
                assignments = assignments or out["assignments"]
                if b < JOINT_GRAD_BATCHES:
                    model.zero_grad(set_to_none=True)
                    out["loss_total"].backward()
                    if b == 0 and path == "kernels":
                        if not all(bool(torch.isfinite(p.grad).all())
                                   for p in model.parameters() if p.grad is not None):
                            raise RuntimeError("joint gate: a non-finite kernel-path gradient")
                        grads = dict(model.named_parameters())
                        lost = [pre for pre in JOINT_REACH if not any(
                            p.grad is not None and bool(p.grad.abs().max() > 0)
                            for n, p in grads.items() if n.startswith(pre))]
                        if lost:
                            raise RuntimeError(f"joint gate: no gradient reaches {lost}")
                    grad = {g: torch.cat([p.grad.float().flatten()
                                          for n, p in model.named_parameters()
                                          if n.startswith(g) and p.grad is not None])
                            for g in JOINT_GROUPS}
                    model.zero_grad(set_to_none=True)
                    if ref is None:
                        ref = grad
                    else:
                        for g in JOINT_GROUPS:
                            sq[path][g][0] += float(torch.linalg.vector_norm(grad[g] - ref[g]) ** 2)
                            sq[path][g][1] += float(torch.linalg.vector_norm(ref[g]) ** 2)
                    del grad
            peak[path] = max(peak[path], torch.cuda.max_memory_allocated())
            counts = launches()
            if path != "kernels" and any(counts.values()):
                raise RuntimeError(f"joint gate {path}: kernels launched {counts}")
            keys = {k for k in out if k.startswith("loss_") and k != "loss_total"}
            if keys != want_keys or not all(bool(torch.isfinite(out[k])) for k in keys):
                raise RuntimeError(f"joint gate {path}: loss keys {sorted(keys ^ want_keys)} "
                                   "missing or extra, or a loss not finite")
            for term in JOINT_TERMS:
                vals = [float(out[k].detach()) for k in sorted(keys) if k.startswith(term + "_")]
                values[path][term] += vals
                per[path, term] = vals
            for name in JOINT_OUTPUTS:
                streams[path][name].append(kept[name].flatten())
            del out, kept
        del ref, args, draw, taken
        for term in JOINT_TERMS:
            ref_t = torch.tensor(per["plain_fp32", term])
            e = [rel_l2(torch.tensor(per[path, term]), ref_t) if bool(ref_t.abs().sum()) else 0.0
                 for path in paths[1:]]
            one[term].append(round(e[1] / e[0], 2) if e[0] else None)
    t0 = time.perf_counter()
    per_image_pool(models, data, values)
    log(f"joint gate: {JOINT_POOL_BATCHES} more batches of the per-image terms in "
        f"{time.perf_counter() - t0:.1f} s")
    failed = []
    for term in JOINT_TERMS:
        vec = {path: torch.tensor(values[path][term], dtype=torch.float64) for path in paths}
        e = {path: rel_l2(vec[path], vec["plain_fp32"]) for path in paths[1:]}
        n = GATE_BATCHES + (JOINT_POOL_BATCHES if term in PER_IMAGE_TERMS else 0)
        firsts = [f"{k} values {_ratio(vec, k):.3f}" for k in (16, 64, 128)
                  if term in PER_IMAGE_TERMS and k < len(vec["kernels"])]
        prefixes = "; ratio over the first " + ", ".join(firsts) if firsts else ""
        log(f"joint {term} over {n} batches ({len(vec['kernels'])} values): rel L2 to "
            f"fp32 kernels {e['kernels']:.3e} plain bf16 {e['plain_bf16']:.3e}; ratio "
            f"{e['kernels'] / e['plain_bf16']:.3f}{prefixes} (one batch at a time, not gated: "
            f"{one[term]})")
        if not e["kernels"] <= SLICE_FACTOR * e["plain_bf16"]:
            failed.append(f"{term}: {e['kernels']:.3e} > {SLICE_FACTOR} x {e['plain_bf16']:.3e}")
    for name in JOINT_OUTPUTS:
        vec = {path: torch.cat(streams[path][name]) for path in paths}
        e = {path: rel_l2(vec[path], vec["plain_fp32"]) for path in paths[1:]}
        log(f"joint {name} over {GATE_BATCHES} batches ({vec['kernels'].numel()} values): rel L2 "
            f"to fp32 kernels {e['kernels']:.3e} plain bf16 {e['plain_bf16']:.3e}; ratio "
            f"{e['kernels'] / e['plain_bf16']:.3f}")
        if not e["kernels"] <= SLICE_FACTOR * e["plain_bf16"]:
            failed.append(f"{name}: {e['kernels']:.3e} > {SLICE_FACTOR} x {e['plain_bf16']:.3e}")
    for g in JOINT_GROUPS:
        e = {path: (sq[path][g][0] / sq[path][g][1]) ** 0.5 for path in paths[1:]}
        log(f"joint grad {g[:-1]} over {JOINT_GRAD_BATCHES} batches: rel L2 to fp32 kernels "
            f"{e['kernels']:.3e} plain bf16 {e['plain_bf16']:.3e}; ratio "
            f"{e['kernels'] / e['plain_bf16']:.3f}")
        if not e["kernels"] <= SLICE_FACTOR * e["plain_bf16"]:
            failed.append(f"grad {g}: {e['kernels']:.3e} > {SLICE_FACTOR} x {e['plain_bf16']:.3e}")
    log("joint gate: peak memory allocated (GiB) " + ", ".join(
        f"{path} {v / 2**30:.2f}" for path, v in peak.items()) + f" ({smi})")
    if failed:
        raise RuntimeError("joint gate failed: " + "; ".join(failed))


def _ratio(vec: dict, k: int) -> float:
    """The kernel path's rel L2 from fp32 over the first ``k`` values, over
    plain bf16's."""
    f = vec["plain_fp32"][:k]
    return rel_l2(vec["kernels"][:k], f) / rel_l2(vec["plain_bf16"][:k], f)


def per_image_pool(models: dict, data: "JointData", values: dict) -> None:
    """JOINT_POOL_BATCHES more values of each PER_IMAGE_TERMS term on every
    path, appended to ``values``: forward only, the two streams that these
    terms read, JOINT_POOL_GROUP batches a forward (their seg images' encode
    and spatial prompts at once, their VLP images at once), each batch's
    terms from its own rows through the step's own loss functions
    (``spatial_stream_losses``, ``vlp_stream_losses``), with the same draws
    and plain fp32's discrete choices on every path."""
    from iuvl_tpu_torch.train.train_step import spatial_stream_losses, vlp_stream_losses

    n = JOINT_VLP_BATCH
    for _ in range(JOINT_POOL_BATCHES // JOINT_POOL_GROUP):
        group = [data.batch() for _ in range(JOINT_POOL_GROUP)]
        image = torch.cat([args[0] for args, _ in group])
        points, labels = (torch.cat([args[4][k] for args, _ in group])
                          for k in ("spatial_points", "spatial_labels"))
        vlp = {k: torch.cat([args[3][k] for args, _ in group]) for k in group[0][0][3]}
        taken = {}
        for path in JOINT_PATHS:
            model = models[path]
            with torch.no_grad(), _discrete_choices(model, path == "plain_fp32", taken):
                logits = model.spatial_decode(*model.encode_interactive(image), points, labels)
                out = model.forward_vlp_train(vlp["images"], vlp["caption_ids"],
                                              vlp["caption_mask"])
                for j, ((_, _, _, vlp_j, extras), draw) in enumerate(group):
                    rows = {k: out[k][n * j: n * (j + 1)] for k in (
                        "pred_captionings", "pred_captions", "caption_class_emb",
                        "backbone_emb")}
                    terms = spatial_stream_losses(logits[j: j + 1], extras, draw, MATCH_POINTS)
                    terms.update(vlp_stream_losses({**out, **rows}, vlp_j))
                    for term in PER_IMAGE_TERMS:
                        values[path][term].append(float(terms[term + "_0"]))
            del logits, out


def joint_phase(dev, smi: str) -> dict:
    """The step-1 joint train step at full width (ViT-B 1024^2, dim 512, 100
    proposals, the 12-layer text tower, bf16, ``retrieval_ensemble``):
    ``make_joint_train_step`` with every stream (live class text, caption
    phrases, grounding, spatial prompts, VLP). The kernel path, plain bf16
    and plain fp32 on one set of seeded weights are gated by
    :func:`joint_gate`; then JOINT_STEPS steps through the kernels, launches
    checked a step (JOINT_PER_STEP), ms a step and peak memory printed.
    Returns the kernel path's launch totals."""
    from iuvl_tpu_torch.losses.criterion import CriterionConfig, SegCriterion
    from iuvl_tpu_torch.models.xdecoder import convert
    from iuvl_tpu_torch.models.xdecoder.model import SysLearnerConfig, build_syslearner
    from iuvl_tpu_torch.train.optimizer import Optimizer
    from iuvl_tpu_torch.train.train_step import TrainState, make_joint_train_step

    cfg = SysLearnerConfig(**JOINT_CONFIG)
    t0 = time.perf_counter()
    models, weights = {}, None
    for path, (attn, twoway, dtype) in reversed(JOINT_PATHS.items()):
        pcfg = dataclasses.replace(cfg, attn_impl=attn, twoway_impl=twoway, dtype=dtype)
        models[path] = build_syslearner(pcfg, device=dev, generator=None if weights else
                                        torch.Generator().manual_seed(SEED + 80))
        if weights is None:
            weights = models[path].state_dict()
        else:
            models[path].load_state_dict(weights)
    del weights
    n_params = sum(p.numel() for p in models["kernels"].parameters())
    log(f"joint: {len(models)} x SysLearner ({n_params / 1e6:.1f} M parameters each) built in "
        f"{time.perf_counter() - t0:.1f} s")
    crits = {path: SegCriterion(CriterionConfig(num_classes=N_CLASSES),
                                impl=m.cfg.kernels_impl) for path, m in models.items()}
    losses_of = {path: make_joint_train_step(m, crits[path], match_points=MATCH_POINTS,
                                             loss_only=True) for path, m in models.items()}
    t0 = time.perf_counter()
    joint_gate(models, losses_of, JointData(dev, SEED + 81), smi)
    log(f"joint gate: {time.perf_counter() - t0:.1f} s")
    model = models.pop("kernels")
    del models, losses_of
    torch.cuda.empty_cache()
    state = TrainState(Optimizer(model.named_parameters(), paths=convert.flax_paths(cfg),
                                 base_lr=1e-4, total_steps=1000))
    step = make_joint_train_step(model, crits["kernels"], match_points=MATCH_POINTS)
    data = JointData(dev, SEED + 82)
    totals = {k: 0 for k in JOINT_PER_STEP}
    times, peak = [], 0
    for i in range(JOINT_STEPS):
        args, draw = data.batch()
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        (_, metrics), secs = synced(lambda: step(state, *args, draw))
        times.append(secs)
        peak = max(peak, torch.cuda.max_memory_allocated())
        counts = launches()
        check_launches(f"joint step {i}", counts, JOINT_PER_STEP)
        for k in totals:
            totals[k] += counts[k]
        keys = joint_loss_keys()
        if not keys <= set(metrics) or not all(bool(torch.isfinite(metrics[k])) for k in keys):
            raise RuntimeError(f"joint step {i}: a loss missing or not finite")
        log(f"joint step {i}: loss_total {float(metrics['loss_total']):.4f}, grad_norm "
            f"{float(metrics['grad_norm']):.4f}, {secs * 1e3:.1f} ms; launches "
            f"{({k: v for k, v in counts.items() if v})}")
        del args, draw, metrics
    mean = float(np.mean(times[1:]))
    log(f"joint step (ViT-B 1024^2, bf16, kernels): steps 1..{JOINT_STEPS - 1} "
        f"{[round(s * 1e3, 1) for s in times[1:]]} ms, mean {mean * 1e3:.1f} ms "
        f"({1 / mean:.3f} seg img/s + {JOINT_VLP_BATCH / mean:.3f} VLP img/s); peak memory "
        f"allocated {peak / 2**30:.2f} GiB; B4 {JOINT_PER_STEP['t2i_stream']} / B5 "
        f"{JOINT_PER_STEP['i2t_block_step']} launches a step ({smi})")
    del model, state, step
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
    c11_cases(dev)
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
                                 (1, False, "pallas_rp"), (2, False, "rowbias"),
                                 (1, False, "window")):
        t0 = time.perf_counter()
        paths.append(train_phase(dev, batch, STEPS, control, impl))
        log(f"train phase, batch {batch}, {impl}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths.append(joint_phase(dev, smi))
    log(f"joint phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths.append(eval_phase(dev))
    log(f"eval phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths.append(vl_eval_phase(dev, smi))
    log(f"vl eval phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths.append(llm_phase(dev, smi))
    log(f"llm phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths.append(stage2_phase(dev, smi))
    log(f"stage2 phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths.append(c9_phase(dev))
    log(f"c9 phase (head width 32): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths.append(interactive_phase(dev))
    log(f"interactive phase: {time.perf_counter() - t0:.1f} s")
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
