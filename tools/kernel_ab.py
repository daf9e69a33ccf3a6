"""This tree's kernels against a parent tree's, on one card, in one
process, one mode a kernel (``--kernels``, any of them in one run):

- ``rowbias``: the B2b / B14 forward. Compile the parent's
  ``flash_attention_rowbias.cu`` alone with ``nvcc``, then at ViT-B's
  windowed and global shapes, ViT-H's global shape (d 80) and grids that
  reach the other code paths (a 32 x 32 grid; N 200 and 300 with dense
  random expanders, one of them with h + w = 496) hold each forward against
  the plain version (relative L2 of o and lse), check that two launches of
  this tree's forward give the same bits, time the parent, this tree, this
  tree and the parent in turn, the plain version and SDPA on the
  materialised bias. Where this tree runs its resident forward (N <= 256, a
  block an SM or more), a copy of its source built with the resident kernel
  compiled out (IUVL_RB_FWD_NO_RESIDENT) is held and timed beside it.
- ``flash``: B11 (``flash_attention_train.cu``), forward and backward
  each, at the global block's training shape (12 heads of N 4096, d_qk 192,
  d_v 64), ViT-H's serving shape (16 heads, d_qk 208 padded to 224, d_v
  80) and ViT-B at 800^2 (N 2500, d_qk 164 padded to 192): rel L2 of o,
  lse and of dq, dk, dv (at the plain forward's o and lse) to the plain
  version, two launches bit-equal, times in turns, the plain version, SDPA
  forward and forward + backward (with the kernel names its trace shows).
- ``seg_scatter``: B17 (``seg_scatter.cu``) at the shape of B7's d_value
  scatter (688,128 rows of 256 into 131,072) and the skewed case (3000
  rows of 64, all into row 0 of 512): the whole wrapper of each tree, its
  sort included, held to the plain version, two launches bit-equal, times
  in turns, ``index_add_``, the device time of each launch of a call and
  the host time of one call. Then this tree alone at the widths and dtypes
  the parent's wrapper refused (W 96 and 768 in bf16, 256 in fp32 and
  fp16, an odd W in fp32 and bf16), held and timed the same way.
- ``i2t``: B5 (``twoway_attention.cu`` ``iuvl_i2t_block_step``) on a
  256-prompt chunk over N 4096 image tokens: per-prompt keys at T 7 (the
  kernel phase's case), batch-1 keys at T 7 (the decoder's block 0),
  per-prompt keys at T 26 (a 20-click prompt) and T 64, N 2500, then T 80
  with per-prompt and batch-1 keys (C8, which the parent refuses): rel L2
  of the output to the plain version, two launches bit-equal, the
  parent's bits up to T 64, times in turns, the plain version, and the
  bound (the bytes the function must move).
- ``t2i``: B4 (``twoway_attention.cu`` ``iuvl_t2i_stream``) on a
  256-prompt chunk over N 4096: per-prompt keys at T 7 (the kernel phase's
  case), batch-1 keys at T 7 (block 0), per-prompt keys at T 26 and T 64,
  and 8 prompts of T 26 (an interactive round); then N 2500 (ViT-B at
  800^2, which the parent refuses); the same readings as ``i2t``, with
  the bound the larger of bytes and tensor-core operations.
- ``upscale``: B6 (``mask_upscale.cu`` ``iuvl_masks_upscale``) on 256
  prompts x N 4096 and on 8 prompts (a round), then N 900 (a 30^2 grid,
  which the parent refuses): the same readings.
- ``rowbias_proj``: B2 (``flash_attention.cu`` ``iuvl_rowbias_proj``),
  rel-pos attention of a global block with the output projection, at ViT-B
  1024^2 (the kernel phase's case), ViT-B 512^2 (w 32), ViT-L 1024^2 and
  head dim 80 at N 4096: the same readings as ``i2t``, and as a yardstick
  only SDPA on the materialised bias followed by ``F.linear``.
- ``window_block``: B1 (``window_block.cu`` ``iuvl_window_block``), the
  windowed blocks' attention body, at ViT-B 1024^2 (25 windows), batch 2
  (50), ViT-H (C 1280, 16 heads of 80) and ViT-B 512^2 (9 windows): the
  same readings.
- ``block_tail``: B3 (``mlp_block.cu`` ``iuvl_block_tail``), the ViT
  block's tail (residual, LayerNorm, MLP, residual), at ViT-B 1024^2 (T
  4096, C 768, H 3072), batch 2 (T 8192), ViT-H (C 1280, H 5120) and ViT-B
  800^2 (T 2500): the same readings as ``i2t``.
- ``decode_tail``: B16 (``decode_chunk.cu`` ``iuvl_decode_tail``), the
  whole-chunk decode tail, on 256 prompts over N 4096 at 16 slots (7
  tokens), 48 (40) and 64 (56), an interactive round (8 prompts, 26 tokens
  in 32 slots), N 2500 (ViT-B 800^2), then past 64 slots (C8, which the
  parent refuses): 256 and 8 prompts at 96 (86 tokens), 64 at 80 (66): rel
  L2 of the tokens and the masks to the plain version, two launches
  bit-equal, the parent's bits up to 64 slots, times in turns, the plain
  version, the bound (operations) and each kernel's device time.
- ``window_block_bwd``: B9 (``window_block_bwd.cu``
  ``iuvl_window_block_bwd``), the windowed block's backward, at B1's
  shapes: rel L2 of each of its seven outputs to the plain version,
  two launches bit-equal, times in turns, the plain version, the bound
  (operations), each launch's device time in launch order for both trees,
  and its five GEMMs through ``torch.matmul`` as a yardstick.
- ``block_tail_bwd``: B10 (``mlp_block_bwd.cu`` ``iuvl_block_tail_bwd``),
  the block tail's backward, at B3's shapes: the readings of
  ``window_block_bwd``.
- ``msdeform_fwd``: B7's forward (``msdeform.cu`` ``iuvl_msdeform_fwd``)
  at the batch-2 step's three levels (128^2, 64^2, 32^2; 8 heads of 64,
  21,504 queries x 4 points near their reference points), a skewed input
  (every point of a head within a 2 x 2 cell window) and P 3: rel L2 to
  the plain version, two launches bit-equal, the parent's bits, times in
  turns, the plain version, the bound (bytes), each tree's device time.
- ``deform_scatter``: B7's d_value scatter (``iuvl_deform_scatter``) of
  one image at the same shapes, the whole wrapper of each tree (the
  parent's zero-fill and atomics): the same readings (the parent's two
  launches differ), ``index_add_`` on the wide map's rows, the buckets'
  mean and longest row counts, and this tree's device time by launch.
- ``deform_gather``: B7's tap-row gather (``iuvl_deform_gather``) of one
  image at the same levels: rel L2 (0: a copy), two launches bit-equal,
  the parent's bits, times in turns, the plain version, ``index_select``
  on the prebuilt wide map, the bound (bytes).
- ``deform_glue``: B8, both entries (``deform_bwd_glue.cu``), at the res3
  level's rows of one image (688,128 rows of 4 x 64, a random fp32 output
  cotangent): rel L2 of contrib and dots, two launches bit-equal, the
  parent's bits, times in turns, the plain version, the bound (bytes).
- ``onehot``: B15 (``onehot_gather.cu`` ``iuvl_onehot_level_fwd``) at the
  ``hybrid`` eval's res5 level (BH 8, 32^2 cells, 21,504 queries x 4
  points near their reference points, bf16), a 16^2 and a 50^2 table,
  res5 in fp32 and with 3 points: rel L2 to the plain version
  (chip_smoke.py's bound, 3e-5), two launches bit-equal, the parent's
  bits, times in turns, the plain version, ``embedding_bag`` over the wide
  map's (cell, slot) rows, the bound (bytes), each tree's device time.

The deformable modes (``msdeform_fwd``, ``deform_scatter``,
``deform_gather``, ``deform_glue``, ``onehot``) also run this tree alone at
head widths 32 and 128, which the parent refuses.

- ``tap_scatter``: B12 (``tap_scatter.cu``) at the criterion's shape (20
  matched 256^2 masks x 12,544 points, a table of 66,049 cells) and a
  skewed case (the same points drawn within about a pixel of the map's
  centre: hundreds of rows a cell): the whole wrapper of each tree (the
  parent's zero-fill included), held to the plain version, two launches
  bit-equal, times in turns, ``index_add_`` and the cells that three or
  more rows hit.

Each mode prints ptxas's registers, shared memory and spills of its kernels
for both trees and splits one call's device time by kernel with each
launch's registers and shared memory as torch.profiler's trace records them.

    git archive <parent> iuvl_tpu_torch/csrc | tar -x -C _chip/parent
    set -o pipefail; python3 tools/kernel_ab.py --parent _chip/parent \
        --kernels window_block rowbias_proj 2>&1 | tee kernel_ab.log

The parent's entry points must have the signatures PARENT_SIGS gives them.
Needs one CUDA card.
"""

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from iuvl_tpu_torch.ops.cuda import build  # noqa: E402
from iuvl_tpu_torch.ops.cuda import decode_chunk as dc  # noqa: E402
from iuvl_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402
from iuvl_tpu_torch.ops.cuda import mask_upscale as mu  # noqa: E402
from iuvl_tpu_torch.ops.cuda import mlp_block as mb  # noqa: E402
from iuvl_tpu_torch.ops.cuda import seg_scatter as ss  # noqa: E402
from iuvl_tpu_torch.ops.cuda import tap_scatter as ts  # noqa: E402
from iuvl_tpu_torch.ops.cuda import twoway_attention as ta  # noqa: E402
from iuvl_tpu_torch.ops.cuda import window_block as wb  # noqa: E402
from iuvl_tpu_torch.ops.rel_pos_attention import (onehot_expanders, rel_pos_features,  # noqa: E402
                                                  rel_pos_tables)

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
PARENT_SIGS = {"iuvl_rowbias_fwd": [P] * 7 + [I] * 5 + [P],
               "iuvl_relpos_fwd": [P] * 10 + [I] * 5 + [P],
               "iuvl_flash_fwd": [P] * 5 + [I] * 4 + [P],
               "iuvl_flash_bwd": [P] * 10 + [I] * 4 + [P],
               # the parent's B17: bf16 rows only; its wrapper hands it the
               # int64 sorted order, a scratch and block_rows.
               "iuvl_seg_scatter": [P] * 5 + [I] * 4 + [P],
               "iuvl_i2t_block_step": [P] * 11 + [I] * 4 + [F, F, P],
               # the parent's B4 (one block a prompt, N % 32 == 0) and B6
               # (HW % 64 == 0): no scratch, no split count.
               "iuvl_t2i_stream": [P] * 8 + [I] * 4 + [P],
               "iuvl_masks_upscale": [P] * 9 + [I] * 2 + [P],
               # the parent's B12 adds into a table its wrapper zeroes.
               "iuvl_tap_scatter": [P] * 3 + [I] * 3 + [P],
               # the parent's B1 (qkv and o scratch), B2 (o and lse scratch)
               # and B3 (y and h scratch): this tree's entries.
               "iuvl_window_block": [P] * 10 + [I] * 4 + [P],
               "iuvl_rowbias_proj": [P] * 10 + [I] * 6 + [P],
               "iuvl_block_tail": [P] * 11 + [I, I, I, F, P],
               # the parent's B16 (eight workspaces, Tp <= 64).
               "iuvl_decode_tail": [P] + [I] * 6 + [P],
               # the parent's B9 and B10 (a wmma GEMM, fp32 scratch).
               "iuvl_window_block_bwd": [P] * 21 + [I] * 4 + [P],
               "iuvl_block_tail_bwd": [P] * 21 + [I, I, I, F, P],
               # the parent's deformable core: head width 64 only (B7's
               # forward, gather and scatter, B8, B15).
               "iuvl_msdeform_fwd": [P] * 5 + [I] * 7 + [P],
               "iuvl_deform_gather": [P] * 3 + [I] * 5 + [P],
               "iuvl_deform_scatter": [P] * 6 + [I] * 7 + [P],
               "iuvl_deform_bwd_glue_q": [P] * 5 + [I] * 3 + [P],
               "iuvl_deform_bwd_glue": [P] * 5 + [I] * 3 + [P],
               "iuvl_onehot_level_fwd": [P] * 4 + [I] * 5 + [P]}
SOURCE = {"rowbias": "flash_attention_rowbias.cu", "flash": "flash_attention_train.cu",
          "seg_scatter": "seg_scatter.cu", "i2t": "twoway_attention.cu",
          "tap_scatter": "tap_scatter.cu", "t2i": "twoway_attention.cu",
          "upscale": "mask_upscale.cu", "window_block": "window_block.cu",
          "rowbias_proj": "flash_attention.cu", "block_tail": "mlp_block.cu",
          "decode_tail": "decode_chunk.cu", "window_block_bwd": "window_block_bwd.cu",
          "block_tail_bwd": "mlp_block_bwd.cu", "msdeform_fwd": "msdeform.cu",
          "deform_scatter": "msdeform.cu", "deform_gather": "msdeform.cu",
          "deform_glue": "deform_bwd_glue.cu", "onehot": "onehot_gather.cu"}
ENTRIES = {"rowbias": ("iuvl_rowbias_fwd", "iuvl_relpos_fwd"),
           "flash": ("iuvl_flash_fwd", "iuvl_flash_bwd"), "seg_scatter": ("iuvl_seg_scatter",),
           "i2t": ("iuvl_i2t_block_step",), "tap_scatter": ("iuvl_tap_scatter",),
           "t2i": ("iuvl_t2i_stream",), "upscale": ("iuvl_masks_upscale",),
           "window_block": ("iuvl_window_block",), "rowbias_proj": ("iuvl_rowbias_proj",),
           "block_tail": ("iuvl_block_tail",), "decode_tail": ("iuvl_decode_tail",),
           "window_block_bwd": ("iuvl_window_block_bwd",),
           "block_tail_bwd": ("iuvl_block_tail_bwd",), "msdeform_fwd": ("iuvl_msdeform_fwd",),
           "deform_scatter": ("iuvl_deform_scatter",), "deform_gather": ("iuvl_deform_gather",),
           "deform_glue": ("iuvl_deform_bwd_glue_q", "iuvl_deform_bwd_glue"),
           "onehot": ("iuvl_onehot_level_fwd",)}
# ptxas lines of these kernels (by name) are printed, and of B11 only the
# instantiations on the path.
KERNELS = ("rb_fwd", "rb_bwd", "rb_nz", "window_stream", "window_resident", "flash_",
           "seg_scatter", "seg_pass", "i2t_", "tap_scatter", "t2i_", "masks_upscale",
           "window_block", "wb_", "rowbias_proj", "linear_", "block_tail", "tail_ln",
           "tok_", "row_pass", "upscale_kernel", "gemm_f32", "colsum", "sum_parts",
           "round_bias", "window_attn_bwd", "wbb_", "splitk", "tail_", "level_fwd",
           "scatter_kernel", "dv_", "sort_", "bucket_start", "gather_kernel", "glue_",
           "onehot")
FLASH_PATH = ("<192, 64>", "<224, 80>", "<192, 64,", "<224, 80,")
# (tag, heads, N, h, w, d, dense expanders): ViT-B's windows and global
# grid, ViT-H's global grid, a 32 x 32 grid (B2b's looked-up bias while
# streaming), N 200 and 300 with dense expanders (h + w 33 and 496; 12 and
# 2 heads, fewer than the SMs: the streaming kernels; B2b only where N = h
# w).
SHAPES = (("window", 300, 196, 14, 14, 64, False), ("global", 12, 4096, 64, 64, 64, False),
          ("global_d80", 16, 4096, 64, 64, 80, False), ("side32", 12, 1024, 32, 32, 64, False),
          ("dense200", 12, 200, 8, 25, 64, True), ("dense300", 2, 300, 200, 296, 64, True))


def ms(fn, iters=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def rel(a, b):
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def ptxas_summary(log: str, label: str) -> None:
    """Registers, shared memory and spills of the kernels named in KERNELS."""
    name = None
    demangle = shutil.which("c++filt")
    for line in log.splitlines():
        if "Compiling entry" in line:
            name = line.split("'")[1]
            if demangle:
                name = subprocess.run([demangle, name], capture_output=True,
                                      text=True).stdout.strip()
                name = re.sub(r"iuvl::\(anonymous namespace\)::", "", name).split("(")[0]
        elif (name and any(k in name for k in KERNELS)
              and ("flash_" not in name or any(i in name for i in FLASH_PATH))
              and ("registers" in line or "spill" in line)):
            print(f"ptxas {label} {name}: {line.split(':', 1)[-1].strip()}")


def compile_source(tree: Path, work: Path, kind: str, label: str = "parent", sigs=None,
                   defines=()):
    """A tree's source of ``kind`` (SOURCE) alone as a shared library (the
    parent's by default; ``defines``: -D macros), its entries typed by
    ``sigs`` (PARENT_SIGS by default); prints its ptxas summary."""
    csrc = tree / "iuvl_tpu_torch/csrc"
    out = work / f"{label}_{kind}.so"
    proc = subprocess.run(
        [build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v", *(f"-D{m}" for m in defines),
         "-I", str(csrc), "-o", str(out), str(csrc / SOURCE[kind])],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{label} build: {proc.stderr[-4000:]}")
    if label != "stream":
        ptxas_summary(proc.stderr, label)
    lib = ctypes.CDLL(str(out))
    sigs = sigs or {fn: PARENT_SIGS[fn] for fn in ENTRIES[kind]}
    for fn, argtypes in sigs.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def kernel_events(fn, work: Path, calls=5) -> list:
    """The kernel events of ``calls`` calls of ``fn`` in launch order
    (torch.profiler's chrome trace), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    path = work / "trace.json"
    prof.export_chrome_trace(str(path))
    return sorted((ev for ev in json.loads(path.read_text()).get("traceEvents", [])
                   if ev.get("cat") == "kernel"), key=lambda ev: ev["ts"])


def event_name(ev) -> str:
    return re.sub(r"\(.*", "", ev["name"].replace("iuvl::(anonymous namespace)::", ""))


def event_info(ev) -> str:
    a = ev.get("args", {})
    return (f"{a.get('registers per thread')} regs, {a.get('shared memory')} B smem, "
            f"grid {a.get('grid')}")


def kernel_split(fn, work: Path, calls=5) -> str:
    """Device ms a call of each kernel ``fn`` launches, with the launch's
    registers a thread, shared memory a block and grid."""
    rows = {}
    for ev in kernel_events(fn, work, calls):
        r = rows.setdefault(event_name(ev)[:70], dict(us=0.0, info=event_info(ev)))
        r["us"] += float(ev.get("dur", 0))
    return "; ".join(f"{name} {r['us'] / 1e3 / calls:.4f} ms ({r['info']})"
                     for name, r in rows.items())


def launch_split(fn, work: Path, calls=5) -> str:
    """Device ms of each launch of one call of ``fn``, in launch order (the
    mean over ``calls`` calls), with the launch's registers, shared memory
    and grid."""
    evs = kernel_events(fn, work, calls)
    per = len(evs) // calls
    if per * calls != len(evs):
        return f"{len(evs)} launches in {calls} calls: not a whole number a call"
    out = []
    for i in range(per):
        us = sum(float(evs[i + c * per].get("dur", 0)) for c in range(calls)) / calls
        out.append(f"{i + 1}. {event_name(evs[i]).replace('void ', '')[:60]} {us / 1e3:.4f} ms "
                   f"({event_info(evs[i])})")
    return "; ".join(out)


GEN = None  # the run's seeded CUDA generator (main)


def t(*shape, std=1.0):
    return (torch.randn(*shape, device="cuda", generator=GEN) * std).to(torch.bfloat16)


def stream():
    return torch.cuda.current_stream().cuda_stream


def ptr(*ts):
    return [x.data_ptr() for x in ts]


def in_turns(parent, this) -> tuple[list, list]:
    """Times of parent, this, this, parent (ms a call)."""
    t_par = [ms(parent)]
    t_new = [ms(this), ms(this)]
    t_par.append(ms(parent))
    return t_par, t_new


def host_ms(fn, calls=50) -> float:
    """Host ms to issue one call (the enqueue, back to back, not synchronised
    until the end)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e3


def rowbias_ab(parent_tree: Path, work: Path, bad: list) -> None:
    """The B2b / B14 forward (see the module's docstring)."""
    lib = compile_source(parent_tree, work, "rowbias")
    # This tree with the resident forward compiled out: the streaming kernel
    # on the windows, to time against the resident one.
    stream_lib = compile_source(ROOT, work, "rowbias", "stream", {
        fn: build.SIGNATURES[fn] for fn in ENTRIES["rowbias"]}, ("IUVL_RB_FWD_NO_RESIDENT",))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dev = torch.device("cuda")
    for tag, bh, n, h, w, d, dense in SHAPES:
        q, k, v = (t(1, bh, n, d) for _ in range(3))
        q = q * d ** -0.5
        relh, relw = t(1, bh, n, h, std=2.4), t(1, bh, n, w, std=2.4)
        if dense:
            eh, ew = t(h, n, std=(h + w) ** -0.5), t(w, n, std=(h + w) ** -0.5)
        else:
            eh, ew = onehot_expanders((h, w), torch.bfloat16, dev)
        kinds = ("rowbias", "relpos") if h * w == n else ("relpos",)
        for kind in kinds:
            if kind == "rowbias":
                new = lambda: fa.flash_rowbias_fwd(q, k, v, relh, relw, w)  # noqa: E731
                ins = (q, k, v, relh, relw)
                bias = (relh.float().repeat_interleave(w, -1)
                        + relw.float().repeat(1, 1, 1, h)).to(q.dtype)
            else:
                new = lambda: fa.flash_relpos_fwd(q, k, v, relh, relw, eh, ew)  # noqa: E731
                ins = (q, k, v, relh, relw, eh, ew)
                bias = (relh.float() @ eh.float() + relw.float() @ ew.float()).to(q.dtype)
            want = fa.flash_rowbias_fwd_plain(q, k, v, relh, relw, w,
                                              *((eh, ew) if kind == "relpos" else ()))

            nz = (fa.expander_groups(eh, ew),) if kind == "relpos" else ()

            def parent(lib=lib, extra=nz):
                o = torch.empty_like(v)
                lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=dev)
                assert getattr(lib, f"iuvl_{kind}_fwd")(*ptr(*ins, *extra, o, lse), bh, n, d, h,
                                                        w, stream()) == 0
                return o, lse

            got, again, par = new(), new(), parent()
            errs = [rel(x, y) for x, y in zip(got, want)]
            e_par = [rel(x, y) for x, y in zip(par, want)]
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            if not (errs[0] <= 1e-2 and errs[1] <= 1e-5) or not same:
                bad.append(f"{kind}_fwd@{tag} rel_l2 o, lse {errs}, bit-equal {same}")
            sdpa = torch.nn.functional.scaled_dot_product_attention
            # Where this tree runs the resident kernel, its streaming one too:
            # parent, this, streaming, streaming, this, parent.
            resident = n <= 256 and bh >= sms
            streaming = lambda: parent(stream_lib, nz)  # noqa: E731
            t_par = [ms(parent)]
            t_new, t_str = [ms(new)], []
            if resident:
                st = streaming()
                e_st = [rel(x, y) for x, y in zip(st, want)]
                print(f"{kind}_fwd@{tag} streaming kernel: rel_l2 o {e_st[0]:.3e} lse "
                      f"{e_st[1]:.3e}; bit-equal to the resident kernel "
                      f"{all(torch.equal(x, y) for x, y in zip(st, got))}", flush=True)
                t_str = [ms(streaming), ms(streaming)]
            t_new.append(ms(new))
            t_par.append(ms(parent))
            times = {"ms": sum(t_new) / 2, "parent": sum(t_par) / 2,
                     **({"streaming": sum(t_str) / 2} if t_str else {}),
                     "plain": ms(lambda: fa.flash_rowbias_fwd_plain(
                         q, k, v, relh, relw, w, *((eh, ew) if kind == "relpos" else ())), 5),
                     "sdpa": ms(lambda: sdpa(q, k, v, attn_mask=bias, scale=1.0))}
            print(f"{kind}_fwd@{tag} (bh {bh}, N {n}, h {h}, w {w}, d {d}"
                  f"{', dense' if dense else ''}): rel_l2 o {errs[0]:.3e} lse {errs[1]:.3e} "
                  f"(parent {e_par[0]:.3e}, {e_par[1]:.3e}); two launches bit-equal {same}; "
                  f"ms this tree {t_new[0]:.4f} {t_new[1]:.4f}, parent {t_par[0]:.4f} "
                  f"{t_par[1]:.4f}; " + ", ".join(f"{key} {val:.4f}" for key, val in times.items()),
                  flush=True)
            print(f"{kind}_fwd@{tag} device split, this tree: {kernel_split(new, work)}",
                  flush=True)
            print(f"{kind}_fwd@{tag} device split, parent: {kernel_split(parent, work)}",
                  flush=True)
            if resident:
                print(f"{kind}_fwd@{tag} device split, streaming: "
                      f"{kernel_split(streaming, work)}", flush=True)
            del bias, want, got, again, par
        torch.cuda.empty_cache()


# B11's shapes: (tag, heads, N, d_qk, d_v): the global block's training
# route at ViT-B 1024^2, ViT-H's serving route at 1024^2, ViT-B at 800^2.
FLASH_SHAPES = (("main", 12, 4096, 192, 64), ("vit_h", 16, 4096, 208, 80),
                ("n2500", 12, 2500, 164, 64))


# This tree's B11 source built again with these -D macros (the backward
# passes' pieces a tile; ex2.approx for expf): its forward and backward
# held (the pieces: bit-equal expected) and timed beside this tree's.
FLASH_VARIANTS = (("sub1", ("IUVL_FLASH_DQ_SUB=1", "IUVL_FLASH_DKV_SUB=1")),
                  ("sub2", ("IUVL_FLASH_DQ_SUB=2", "IUVL_FLASH_DKV_SUB=2")),
                  ("approx_exp", ("IUVL_FLASH_EXACT_EXP=0",)))


def flash_ab(parent_tree: Path, work: Path, bad: list) -> None:
    """B11's forward and backward (see the module's docstring)."""
    lib = compile_source(parent_tree, work, "flash")
    variants = {name: compile_source(ROOT, work, "flash", name, {
        fn: build.SIGNATURES[fn] for fn in ENTRIES["flash"]}, macros)
        for name, macros in FLASH_VARIANTS}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for tag, bh, n, d_qk, d_v in FLASH_SHAPES:
        q, k = t(1, bh, n, d_qk, std=d_qk ** -0.25), t(1, bh, n, d_qk, std=d_qk ** -0.25)
        v, do = t(1, bh, n, d_v), t(1, bh, n, d_v)
        _, _, pad = fa._require_flash("kernel_ab", q, k, v)
        qp, kp = fa._pad_last(q, pad), fa._pad_last(k, pad)

        def par_fwd(lib=lib):
            o = torch.empty_like(v)
            lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
            assert lib.iuvl_flash_fwd(*ptr(qp, kp, v, o, lse), bh, n, pad, d_v, stream()) == 0
            return o, lse

        o, lse = fa.flash_attention_fwd_plain(q, k, v)

        def par_bwd(lib=lib):
            delta = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
            dq, dk, dv = torch.empty_like(qp), torch.empty_like(kp), torch.empty_like(v)
            assert lib.iuvl_flash_bwd(*ptr(qp, kp, v, o, lse, do, delta, dq, dk, dv), bh, n,
                                      pad, d_v, stream()) == 0
            return dq[..., :d_qk], dk[..., :d_qk], dv

        new_fwd = lambda: fa.flash_attention_fwd(q, k, v)  # noqa: E731
        new_bwd = lambda: fa.flash_attention_bwd(q, k, v, o, lse, do)  # noqa: E731
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

        def sdpa_fwd_bwd():
            qg.grad = kg.grad = vg.grad = None
            with torch.enable_grad():
                sdpa(qg, kg, vg, scale=1.0).backward(do)

        for half, new, par, plain, names in (
                ("fwd", new_fwd, par_fwd, lambda: (o, lse), ("o", "lse")),
                ("bwd", new_bwd, par_bwd,
                 lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do), ("dq", "dk", "dv"))):
            want = plain()
            got, again, pgot = new(), new(), par()
            errs = [rel(x, y) for x, y in zip(got, want)]
            e_par = [rel(x, y) for x, y in zip(pgot, want)]
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            bounds = (5e-3, 1e-5) if half == "fwd" else (5e-3, 5e-3, 1e-3)
            if not all(e <= b_ for e, b_ in zip(errs, bounds)) or not same:
                bad.append(f"flash_{half}@{tag} rel_l2 {dict(zip(names, errs))}, bit-equal {same}")
            t_par, t_new = in_turns(par, new)
            lib_ms = ms(lambda: sdpa(q, k, v, scale=1.0)) if half == "fwd" else ms(sdpa_fwd_bwd)
            plain_ms = ms(lambda: fa.flash_attention_fwd_plain(q, k, v) if half == "fwd"
                          else fa.flash_attention_bwd_plain(q, k, v, o, lse, do), 3)
            print(f"flash_{half}@{tag} (bh {bh}, N {n}, d_qk {d_qk} -> {pad}, d_v {d_v}): rel_l2 "
                  + ", ".join(f"{nm} {e:.3e}" for nm, e in zip(names, errs))
                  + " (parent " + ", ".join(f"{e:.3e}" for e in e_par)
                  + f"); two launches bit-equal {same}; ms this tree {t_new[0]:.4f} "
                  f"{t_new[1]:.4f}, parent {t_par[0]:.4f} {t_par[1]:.4f}; mean this "
                  f"{sum(t_new) / 2:.4f} parent {sum(t_par) / 2:.4f}; plain {plain_ms:.4f}; "
                  f"SDPA {'fwd' if half == 'fwd' else 'fwd+bwd'} {lib_ms:.4f}", flush=True)
            vfn = par_fwd if half == "fwd" else par_bwd
            for name, vlib in variants.items():
                var = lambda vlib=vlib: vfn(vlib)  # noqa: E731
                vsame = all(torch.equal(x, y) for x, y in zip(var(), got))
                print(f"flash_{half}@{tag} variant {name}: bit-equal to this tree {vsame}; ms "
                      f"{ms(var):.4f} (this tree {ms(new):.4f}); device split "
                      f"{kernel_split(var, work)}", flush=True)
            print(f"flash_{half}@{tag} device split, this tree: {kernel_split(new, work)}",
                  flush=True)
            print(f"flash_{half}@{tag} device split, parent: {kernel_split(par, work)}",
                  flush=True)
            sd = (lambda: sdpa(q, k, v, scale=1.0)) if half == "fwd" else sdpa_fwd_bwd
            print(f"flash_{half}@{tag} device split, SDPA: {kernel_split(sd, work)}", flush=True)
            del want, got, again, pgot
        del q, k, v, do, qp, kp, o, lse, qg, kg, vg
        torch.cuda.empty_cache()


def seg_cases(dev):
    """B17's two cases, as chip_smoke.py seg_scatter_cases builds them: the
    d_value scatter's destinations (8 heads x the 21504 queries of the three
    levels x 4 points at the res3 level, 128^2, sampling within a few
    pixels of the reference points) with random rows, and the skewed case."""
    from iuvl_tpu_torch.models.xdecoder.pixel_decoder import encoder_reference_points
    from iuvl_tpu_torch.ops.msdeform import wide_idx_wslot

    rs = np.random.RandomState(0)
    nh, side, pts = 8, 128, 4
    ref = encoder_reference_points([(32, 32), (64, 64), (128, 128)], dev)[:, 0]
    jitter = torch.from_numpy(rs.randn(nh, ref.shape[0], pts, 2).astype(np.float32)
                              * 2.5).to(dev)
    xy = ref[None, :, None, :] * side - 0.5 + jitter
    idx, _ = wide_idx_wslot(side, side, xy[..., 0], xy[..., 1])
    hw = side * side
    dest = (idx.long() + torch.arange(nh, device=dev).view(nh, 1, 1) * hw).reshape(-1)
    return (("d_value", t(dest.numel(), 256), dest.to(torch.int32), nh * hw),
            ("skewed", t(3000, 64), torch.zeros(3000, dtype=torch.int32, device=dev), 512))


# C4's widths and dtypes, which the parent's B17 refused: (W, dtype, rows,
# n_out), random rows into random destinations.
SEG_WIDTHS = ((96, torch.bfloat16, 131072, 32768), (768, torch.bfloat16, 65536, 16384),
              (256, torch.float32, 131072, 32768), (256, torch.float16, 131072, 32768),
              (97, torch.float32, 131072, 32768), (33, torch.bfloat16, 131072, 32768))


def seg_ab(parent_tree: Path, work: Path, bad: list) -> None:
    """B17, the whole wrapper of each tree (see the module's docstring)."""
    lib = compile_source(parent_tree, work, "seg_scatter")
    for tag, contrib, idx, n_out in seg_cases(torch.device("cuda")):
        (rows, width), dev = contrib.shape, contrib.device

        def parent():  # the parent's wrapper, its sort included (bf16, W / 8 | 256)
            order = torch.argsort(idx, stable=True)
            rows_a = min(16 * (256 // (width // 8)), 1024)
            blocks = -(-rows // rows_a)
            out = torch.empty((n_out, width), dtype=torch.float32, device=dev)
            scratch = torch.empty((blocks * (2 * width + 2),), dtype=torch.float32, device=dev)
            assert lib.iuvl_seg_scatter(*ptr(contrib, idx, order, out, scratch), rows, n_out,
                                        width, rows_a, stream()) == 0
            return out

        new = lambda: ss.segmented_scatter_add(contrib, idx, n_out)  # noqa: E731
        want = ss.segmented_scatter_add_plain(contrib, idx, n_out)
        got, again, pgot = new(), new(), parent()
        err, e_par = rel(got, want), rel(pgot, want)
        same = torch.equal(got, again)
        if not err <= 1e-6 or not same:
            bad.append(f"seg_scatter@{tag} rel_l2 {err:.3e}, bit-equal {same}")
        t_par, t_new = in_turns(parent, new)
        zeros = lambda: torch.zeros((n_out, width), device=dev).index_add_(  # noqa: E731
            0, idx, contrib.float())
        print(f"seg_scatter@{tag} ({rows} rows of {width} into {n_out}): rel_l2 {err:.3e} "
              f"(parent {e_par:.3e}); two launches bit-equal {same}; ms this tree "
              f"{t_new[0]:.4f} {t_new[1]:.4f}, parent {t_par[0]:.4f} {t_par[1]:.4f}; mean this "
              f"{sum(t_new) / 2:.4f} parent {sum(t_par) / 2:.4f}; index_add_ {ms(zeros):.4f}; "
              f"host ms a call: this {host_ms(new):.4f} parent {host_ms(parent):.4f} "
              f"index_add_ {host_ms(zeros):.4f}", flush=True)
        print(f"seg_scatter@{tag} device split, this tree: {kernel_split(new, work)}", flush=True)
        print(f"seg_scatter@{tag} device split, parent: {kernel_split(parent, work)}", flush=True)
        print(f"seg_scatter@{tag} device split, index_add_: {kernel_split(zeros, work)}",
              flush=True)
        del got, again, pgot, want
    for width, dtype, rows, n_out in SEG_WIDTHS:
        tag = f"w{width}_{str(dtype).split('.')[-1]}"
        contrib = t(rows, width).to(dtype)
        idx = torch.randint(0, n_out, (rows,), device="cuda", generator=GEN, dtype=torch.int32)
        new = lambda: ss.segmented_scatter_add(contrib, idx, n_out)  # noqa: E731
        try:
            got = new()
        except ValueError as e:  # the wrapper refuses the case: C4 stands
            bad.append(f"seg_scatter@{tag}: refused ({e})")
            print(f"seg_scatter@{tag}: this tree refuses it: {e}", flush=True)
            continue
        want = ss.segmented_scatter_add_plain(contrib, idx, n_out)
        err, same = rel(got, want), torch.equal(got, new())
        if not err <= 1e-6 or not same:
            bad.append(f"seg_scatter@{tag} rel_l2 {err:.3e}, bit-equal {same}")
        zeros = lambda: torch.zeros((n_out, width), device="cuda").index_add_(  # noqa: E731
            0, idx, contrib.float())
        print(f"seg_scatter@{tag} ({rows} rows of {width} {dtype} into {n_out}): rel_l2 "
              f"{err:.3e}; two launches bit-equal {same}; ms this tree {ms(new):.4f}; "
              f"index_add_ {ms(zeros):.4f}; device split {kernel_split(new, work)}", flush=True)
        del got, want, contrib, idx
    torch.cuda.empty_cache()


# B5's shapes: (tag, keys batch 1, tokens, N) for a 256-prompt chunk; N
# 2500 (ViT-B at 800^2) is C5's, which the parent refuses.
I2T_SHAPES = (("kernel_t7", False, 7, 4096), ("batch1_t7", True, 7, 4096),
              ("t26", False, 26, 4096), ("t64", False, 64, 4096), ("n2500", False, 7, 2500),
              ("t80", False, 80, 4096), ("batch1_t80", True, 80, 4096))
I2T_PROMPTS = 256


def refused(fn, tag: str, bad: list, who: str):
    """fn(), or None where the wrapper refuses the shape (ValueError)."""
    try:
        return fn()
    except ValueError as e:
        bad.append(f"{tag}: {who} refuses it")
        print(f"{tag}: {who} refuses it: {e}", flush=True)
        return None


def ab_report(tag, new, parent, plain, bound, bad, limit, work) -> None:
    """Hold this tree's wrapper ``new`` (and the parent's entry, None where
    it refuses the shape) to ``plain``; two launches bit-equal; times in
    turns; the plain version's time; the bound (ms, its source); each
    kernel's device time."""
    got = refused(new, tag, bad, "this tree")
    if got is None:
        return
    want, again = plain(), new()
    err, same = rel(got, want), torch.equal(got, again)
    par = parent() if parent else None
    e_par = (f"{rel(par, want):.3e}, bit-equal to this tree's {torch.equal(par, got)}"
             if parent else "refused")
    del par
    if not err <= limit or not same:
        bad.append(f"{tag} rel_l2 {err:.3e}, bit-equal {same}")
    if parent:
        t_par, t_new = in_turns(parent, new)
        times = (f"ms this tree {t_new[0]:.4f} {t_new[1]:.4f}, parent {t_par[0]:.4f} "
                 f"{t_par[1]:.4f}; mean this {sum(t_new) / 2:.4f} parent {sum(t_par) / 2:.4f}")
    else:
        times = f"ms this tree {ms(new):.4f} {ms(new):.4f}; parent refuses"
    print(f"{tag}: rel_l2 {err:.3e} (parent {e_par}); two launches bit-equal {same}; {times}; "
          f"plain {ms(plain, 3):.4f}; bound {bound[0]:.4f} ms ({bound[1]})", flush=True)
    print(f"{tag} device split, this tree: {kernel_split(new, work)}", flush=True)
    if parent:
        print(f"{tag} device split, parent: {kernel_split(parent, work)}", flush=True)


def bound_of(tensors, flops: float) -> tuple:
    """The larger of the bytes (each tensor once) over 3.35 TB/s and the
    operations over 989 TFLOP/s (bf16 tensor cores), in ms, with its kind."""
    nbytes = sum(x.numel() * x.element_size() for x in tensors)
    by_bytes, by_ops = nbytes / 3.35e12 * 1e3, flops / 989e12 * 1e3
    return ((by_bytes, f"bytes, {nbytes / 1e6:.1f} MB") if by_bytes >= by_ops
            else (by_ops, f"operations, {flops / 1e9:.2f} GFLOP"))


def i2t_ab(parent_tree: Path, work: Path, bad: list) -> None:
    """B5 (see the module's docstring)."""
    lib = compile_source(parent_tree, work, "i2t")
    c, i = ta.C, ta.I
    for tag, shared, tok, n in I2T_SHAPES:
        b = I2T_PROMPTS
        args = (t(1 if shared else b, n, c), t(n, i, std=0.3), t(b, tok, i), t(b, tok, i),
                t(i, c, std=c ** -0.5), t(i, std=0.3), t(c, i, std=i ** -0.5), t(c, std=0.3),
                (1.0 + t(c, std=0.1)).float(), t(c, std=0.3).float())

        def parent():
            out = torch.empty((b, n, c), dtype=torch.bfloat16, device="cuda")
            assert lib.iuvl_i2t_block_step(*ptr(*args, out), b, args[0].shape[0], n, tok,
                                           (i // ta.HEADS) ** -0.5, ta.LN_EPS, stream()) == 0
            return out

        out_bytes = b * n * c * 2
        bound = bound_of(args, 0)
        bound = (bound[0] + out_bytes / 3.35e12 * 1e3, "bytes")
        label = f"i2t@{tag} (B {b}, keys batch {args[0].shape[0]}, N {n}, T {tok})"
        new = lambda: ta.i2t_block_step(*args, ta.HEADS)  # noqa: E731
        # The parent takes T <= 64 (C8); there it must give the same bits.
        ab_report(label, new, parent if tok <= 64 else None,
                  lambda: ta.i2t_block_step_plain(*args, ta.HEADS), bound, bad, 2e-4, work)
        if tok <= 64 and not torch.equal(new(), parent()):
            bad.append(f"{label}: not the parent's bits")
        del args
        torch.cuda.empty_cache()


# B4's shapes: (tag, prompts, keys batch 1, tokens, N): the kernel phase's
# case, block 0's call (batch-1 keys), 20- and 50-click prompts, an
# interactive round (8 prompts), and C5's N 2500.
T2I_SHAPES = (("kernel_t7", 256, False, 7, 4096), ("batch1_t7", 256, True, 7, 4096),
              ("t26", 256, False, 26, 4096), ("t64", 256, False, 64, 4096),
              ("round8_t26", 8, False, 26, 4096), ("n2500", 256, False, 7, 2500))


def t2i_ab(parent_tree: Path, work: Path, bad: list) -> None:
    """B4 (see the module's docstring)."""
    lib = compile_source(parent_tree, work, "t2i")
    c, i = ta.C, ta.I
    for tag, b, shared, tok, n in T2I_SHAPES:
        bk = 1 if shared else b
        args = (t(b, tok, i, std=0.25), t(bk, n, c), t(n, i, std=0.3), t(i, c, std=c ** -0.5),
                t(i, std=0.3), t(i, c, std=c ** -0.5), t(i, std=0.3))

        def parent():
            out = torch.empty((b, tok, i), dtype=torch.bfloat16, device="cuda")
            assert lib.iuvl_t2i_stream(*ptr(*args, out), b, bk, n, tok, stream()) == 0
            return out

        flops = 4 * bk * n * c * i + 4 * b * tok * n * i
        out = torch.empty((b, tok, i), dtype=torch.bfloat16, device="cuda")
        ab_report(f"t2i@{tag} (B {b}, keys batch {bk}, N {n}, T {tok})",
                  lambda: ta.t2i_stream(*args, ta.HEADS), parent if n % 32 == 0 else None,
                  lambda: ta.t2i_stream_plain(*args, ta.HEADS), bound_of((*args, out), flops),
                  bad, 5e-3, work)
        del args, out
        torch.cuda.empty_cache()


# B6's shapes: (tag, prompts, N): a 256-prompt chunk at 64^2, a round of 8
# prompts, and C5's 30^2 grid.
UPSCALE_SHAPES = (("chunk", 256, 4096), ("round8", 8, 4096), ("n900", 256, 900))


def upscale_ab(parent_tree: Path, work: Path, bad: list) -> None:
    """B6 (see the module's docstring)."""
    lib = compile_source(parent_tree, work, "upscale")
    c, c4, c8, m = mu.C, mu.C // 4, mu.C // 8, mu.M
    for tag, b, n in UPSCALE_SHAPES:
        args = (t(b, n, c), t(c, 4 * c4, std=c ** -0.5), t(c4, std=0.3),
                (1.0 + t(c4, std=0.1)).float(), t(c4, std=0.3).float(),
                t(c4, 4 * c8, std=c4 ** -0.5), t(c8, std=0.3), t(b, m, c8, std=c8 ** -0.5))

        def parent():
            out = torch.empty((b, n, m * 16), dtype=torch.bfloat16, device="cuda")
            assert lib.iuvl_masks_upscale(*ptr(*args, out), b, n, stream()) == 0
            return out

        flops = 2 * b * n * c * 4 * c4 + 2 * b * 4 * n * c4 * 4 * c8 + 2 * b * 16 * n * m * c8
        out = torch.empty((b, n, m * 16), dtype=torch.bfloat16, device="cuda")
        ab_report(f"upscale@{tag} (B {b}, N {n})", lambda: mu.masks_upscale(*args),
                  parent if n % 64 == 0 else None, lambda: mu.masks_upscale_plain(*args),
                  bound_of((*args, out), flops), bad, 2e-4, work)
        del args, out
        torch.cuda.empty_cache()


def tap_cases(dev):
    """B12's criterion shape (20 matched 256^2 masks, 12,544 points, taps
    weighted by a random cotangent) and the skewed case: the same with the
    points drawn within about a pixel of the map's centre."""
    from iuvl_tpu_torch.ops.point_sample import _tap_weights

    rs = np.random.RandomState(0)
    cases = []
    for tag, coords in (("criterion", rs.rand(20, 12544, 2)),
                        ("skewed", 0.5 + rs.randn(20, 12544, 2) / 256)):
        xy = torch.from_numpy(coords.astype(np.float32)).to(dev)
        base, wgts, _, span = _tap_weights(256, 256, xy, torch.float32)
        g = torch.from_numpy(rs.randn(20, 12544, 1).astype(np.float32)).to(dev)
        cases.append((tag, base.to(torch.int32).contiguous(), (g * wgts).contiguous(), span))
    return cases


def tap_ab(parent_tree: Path, work: Path, bad: list) -> None:
    """B12 (see the module's docstring)."""
    lib = compile_source(parent_tree, work, "tap_scatter")
    for tag, base, rows, span in tap_cases(torch.device("cuda")):
        n, p = base.shape

        def parent():  # the parent's wrapper: a zeroed table, then its kernel
            acc = torch.zeros((n, span, 4), dtype=torch.float32, device="cuda")
            assert lib.iuvl_tap_scatter(*ptr(base, rows, acc), n, p, span, stream()) == 0
            return acc

        new = lambda: ts.tap_scatter(base, rows, span)  # noqa: E731
        want = ts.tap_scatter_plain(base, rows, span)
        got, again, pgot = new(), new(), parent()
        err, e_par = rel(got, want), rel(pgot, want)
        same = torch.equal(got, again)
        if not err <= 1e-6 or not same:
            bad.append(f"tap_scatter@{tag} rel_l2 {err:.3e}, bit-equal {same}")
        flat = (base.long() + torch.arange(n, device="cuda")[:, None] * span).reshape(-1)
        hits = torch.bincount(flat, minlength=n * span)
        idx_rows = rows.reshape(-1, 4)
        index_add = lambda: torch.zeros((n * span, 4), device="cuda").index_add_(  # noqa: E731
            0, flat, idx_rows)
        t_par, t_new = in_turns(parent, new)
        nbytes = sum(x.numel() * x.element_size() for x in (base, rows, got))
        print(f"tap_scatter@{tag} ({n} maps x {p} rows, span {span}): rel_l2 {err:.3e} "
              f"(parent {e_par:.3e}); two launches bit-equal {same} (parent "
              f"{torch.equal(pgot, parent())}); cells hit by 3 or more rows "
              f"{int((hits >= 3).sum())}, most rows a cell {int(hits.max())}; ms this tree "
              f"{t_new[0]:.4f} {t_new[1]:.4f}, parent {t_par[0]:.4f} {t_par[1]:.4f}; mean this "
              f"{sum(t_new) / 2:.4f} parent {sum(t_par) / 2:.4f}; index_add_ "
              f"{ms(index_add):.4f}; plain {ms(lambda: ts.tap_scatter_plain(base, rows, span)):.4f}"
              f"; bound {nbytes / 3.35e12 * 1e3:.5f} ms ({nbytes / 1e6:.1f} MB)", flush=True)
        print(f"tap_scatter@{tag} device split, this tree: {kernel_split(new, work)}",
              flush=True)
        print(f"tap_scatter@{tag} device split, parent: {kernel_split(parent, work)}",
              flush=True)
        print(f"tap_scatter@{tag} device split, index_add_: {kernel_split(index_add, work)}",
              flush=True)
        del got, again, pgot, want


# B2's shapes: (tag, batch, heads, side, d, C): the kernel phase's case
# (ViT-B 1024^2), ViT-B 512^2 (w 32), ViT-L 1024^2, and head dim 80 at N
# 4096 (ViT-H's widths: the wrapper takes them, rowbias_supported does not).
ROWBIAS_PROJ_SHAPES = (("vit_b_1024", 1, 12, 64, 64, 768), ("vit_b_512", 1, 12, 32, 64, 768),
                       ("vit_l_1024", 1, 16, 64, 64, 1024), ("d80_n4096", 1, 16, 64, 80, 1280))


def rowbias_proj_ab(parent_tree: Path, work: Path, bad: list) -> None:
    """B2 (``flash_attention.cu`` ``iuvl_rowbias_proj``): rel-pos attention
    on the pre-scaled q with the features of the unscaled q, then the output
    projection, at ROWBIAS_PROJ_SHAPES; the readings of ``i2t``, and as a
    yardstick only SDPA on the materialised bias followed by ``F.linear``
    (two calls)."""
    lib = compile_source(parent_tree, work, "rowbias_proj")
    for tag, b, heads, side, d, c in ROWBIAS_PROJ_SHAPES:
        n = side * side
        q, k, v = (t(b, heads, n, d) for _ in range(3))
        rh, rw = rel_pos_tables(t(2 * side - 1, d, std=0.3), t(2 * side - 1, d, std=0.3),
                                (side, side))
        relh, relw = rel_pos_features(q, rh, rw)
        args = (q * d ** -0.5, k, v, relh, relw, t(c, heads * d, std=(heads * d) ** -0.5),
                t(c, std=0.3).float(), side)

        def parent():
            out = torch.empty((b, n, c), dtype=torch.bfloat16, device="cuda")
            o = torch.empty((b, heads, n, d), dtype=torch.bfloat16, device="cuda")
            lse = torch.empty((b, heads, n), dtype=torch.float32, device="cuda")
            assert lib.iuvl_rowbias_proj(*ptr(*args[:7], out, o, lse), b, heads, n, c, d, side,
                                         stream()) == 0
            return out

        flops = 4 * b * heads * n * n * d + 2 * b * n * heads * d * c
        out = torch.empty((b, n, c), dtype=torch.bfloat16, device="cuda")
        ab_report(f"rowbias_proj@{tag} (B {b}, heads {heads}, N {n}, w {side}, d {d}, C {c})",
                  lambda: fa.flash_attention_rowbias_proj(*args), parent,
                  lambda: fa.rowbias_proj_plain(*args), bound_of((*args[:7], out), flops),
                  bad, 1e-2, work)
        bias = (relh.float().repeat_interleave(side, -1)
                + relw.float().repeat(1, 1, 1, side)).to(torch.bfloat16)
        wo, bo = args[5], args[6].to(torch.bfloat16)

        def sdpa_linear():
            o = torch.nn.functional.scaled_dot_product_attention(args[0], k, v, attn_mask=bias,
                                                                 scale=1.0)
            return torch.nn.functional.linear(o.transpose(1, 2).reshape(b, n, heads * d), wo, bo)

        print(f"rowbias_proj@{tag} yardstick (two calls): SDPA on the materialised bias + "
              f"F.linear {ms(sdpa_linear):.4f} ms; {kernel_split(sdpa_linear, work)}", flush=True)
        del args, out, bias
        torch.cuda.empty_cache()


# B1's shapes: (tag, windows, C, heads): the kernel phase's case (ViT-B
# 1024^2), batch 2, ViT-H (16 heads of 80), ViT-B 512^2 (9 windows).
WINDOW_BLOCK_SHAPES = (("vit_b_1024", 25, 768, 12), ("batch2", 50, 768, 12),
                       ("vit_h", 25, 1280, 16), ("vit_b_512", 9, 768, 12))


def window_block_ab(parent_tree: Path, work: Path, bad: list) -> None:
    """B1 (``window_block.cu`` ``iuvl_window_block``): the windowed
    attention body (qkv projection, rel-pos attention over 14 x 14 windows,
    output projection) at WINDOW_BLOCK_SHAPES; the readings of ``i2t``."""
    lib = compile_source(parent_tree, work, "window_block")
    win, n = wb.WIN, wb.WIN * wb.WIN
    for tag, nw, c, heads in WINDOW_BLOCK_SHAPES:
        d = c // heads
        rh, rw = rel_pos_tables(t(2 * win - 1, d, std=0.3), t(2 * win - 1, d, std=0.3),
                                (win, win))
        args = (t(nw, n, c), t(3 * c, c, std=c ** -0.5), t(3 * c, std=0.3).float(),
                t(c, c, std=c ** -0.5), t(c, std=0.3).float(), rh, rw, heads)

        def parent():
            qkv = torch.empty((nw, 3, heads, n, d), dtype=torch.bfloat16, device="cuda")
            o = torch.empty((nw, n, c), dtype=torch.bfloat16, device="cuda")
            out = torch.empty_like(args[0])
            assert lib.iuvl_window_block(*ptr(*args[:7], qkv, o, out), nw, c, win, d,
                                         stream()) == 0
            return out

        flops = nw * (2 * n * c * 3 * c + 4 * n * n * c + 2 * n * c * c + 4 * n * c * win)
        ab_report(f"window_block@{tag} (windows {nw}, C {c}, heads {heads} of {d})",
                  lambda: wb.window_attention_block(*args), parent,
                  lambda: wb.window_attention_block_plain(*args),
                  bound_of((*args[:7], args[0]), flops), bad, 5e-4, work)
        del args
        torch.cuda.empty_cache()


# B3's shapes: (tag, T, C): ViT-B 1024^2, batch 2, ViT-H 1024^2, ViT-B 800^2.
BLOCK_TAIL_SHAPES = (("vit_b_1024", 4096, 768), ("b2", 8192, 768), ("vit_h", 4096, 1280),
                     ("t2500", 2500, 768))


def block_tail_ab(parent_tree: Path, work: Path, bad: list) -> None:
    """B3 (``mlp_block.cu`` ``iuvl_block_tail``) at BLOCK_TAIL_SHAPES; the
    readings of ``i2t``."""
    lib = compile_source(parent_tree, work, "block_tail")
    for tag, n, c in BLOCK_TAIL_SHAPES:
        h = 4 * c
        x, a = t(n, c), t(n, c)
        scale, bias = (1.0 + t(c, std=0.1)).float(), t(c, std=0.3).float()
        w1, b1 = t(h, c, std=c ** -0.5), t(h, std=0.3)
        w2, b2 = t(c, h, std=h ** -0.5), t(c, std=0.3)
        args = (x, a, scale, bias, w1, b1, w2, b2)

        def parent():
            out, y = torch.empty_like(x), torch.empty_like(x)
            hid = torch.empty((n, h), dtype=torch.bfloat16, device="cuda")
            assert lib.iuvl_block_tail(*ptr(*args, out, y, hid), n, c, h, mb.EPS,
                                       stream()) == 0
            return out

        ab_report(f"block_tail@{tag} (T {n}, C {c}, H {h})", lambda: mb.block_tail(*args),
                  parent, lambda: mb.block_tail_plain(*args),
                  bound_of((x, a, scale, bias, w1, b1, w2, b2, x), 4 * n * c * h), bad, 5e-4,
                  work)
        del args, x, a, w1, w2
        torch.cuda.empty_cache()


# B16's shapes: (tag, prompts, slots, tokens, N).
DECODE_TAIL_SHAPES = (("tp16", 256, 16, 7, 4096), ("tp48", 256, 48, 40, 4096),
                      ("tp64", 256, 64, 56, 4096), ("round8_tp32", 8, 32, 26, 4096),
                      ("n2500", 256, 16, 7, 2500), ("tp96", 256, 96, 86, 4096),
                      ("round8_tp96", 8, 96, 86, 4096), ("tp80", 64, 80, 66, 4096))


def decode_tail_args(b: int, tp: int, tv: int, n: int, seed: int = 0):
    """B16's arguments: the decoder's weights as build_sam draws them (its
    LayerNorms perturbed), ``tv`` random tokens in ``tp`` slots of ``b``
    prompts, a random (N, 256) embedding and PE."""
    from iuvl_tpu_torch.models.sam.build import init_random_
    from iuvl_tpu_torch.models.sam.mask_decoder import MaskDecoder

    dec = MaskDecoder(dtype=torch.bfloat16, twoway_impl="chunk")
    init_random_(dec, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for mod in dec.modules():
            if isinstance(mod, torch.nn.LayerNorm):
                mod.weight.add_(torch.randn(256, generator=g) * 0.1)
                mod.bias.copy_(torch.randn(256, generator=g) * 0.3)
    dec = dec.cuda()
    tok = torch.zeros(2, b, tp, 256, device="cuda")
    tok[:, :, :tv] = torch.randn(2, b, tv, 256, device="cuda", generator=GEN)
    tok[1] *= 0.5
    image = torch.randn(2, 1, n, 256, device="cuda", generator=GEN)
    image[1] *= 0.5
    bf = torch.bfloat16
    return (tok[0].to(bf), tok[1].to(bf), image[0].to(bf), image[1].to(bf), dec.tail_weights(),
            dc.HEADS, tv)


def parent_decode_call(lib, args):
    """The parent's B16 entry, from before Tp > 64: this tree's operand
    list (its precomputes made in the call, as the wrapper makes them), the
    tokens, the masks and eight workspaces (no self-attention k / v), B4's
    split count; Tp 16, 32, 48 or 64."""
    tk, tpe, keys0, key_pe, w, _, tv = args
    b, tp, c = tk.shape
    n = keys0.shape[1]
    _, splits = ta.t2i_plan(b, n, tp, b, torch.cuda.get_device_properties(0).multi_processor_count)
    bf, f32 = torch.bfloat16, torch.float32

    def call():
        ops = [x for _, x in dc._operands(tk, tpe, keys0, key_pe, w)]
        e = lambda *shape, dtype=bf: torch.empty(shape, dtype=dtype, device="cuda")  # noqa
        tok, masks = e(b, tp, c), e(b, n, 16 * dc.M, dtype=f32)
        ws = [e(b, n, c), e(b, n, c), e(b * splits * tp * (dc.I + 2 * dc.HEADS), dtype=f32),
              e(b, tp, dc.I), e(b, tp, c), e(b, tp, dc.I), e(b, 2, tp, dc.I), e(b, dc.M, c // 8)]
        ptrs = ptr(*ops, tok, masks, *ws)
        array = (ctypes.c_void_p * len(ptrs))(*ptrs)
        assert lib.iuvl_decode_tail(ctypes.addressof(array), len(ptrs), b, n, tp, tv, splits,
                                    stream()) == 0
        return tok, masks
    return call


def decode_tail_ab(parent_tree: Path, work: Path, bad: list) -> None:
    """B16 (``decode_chunk.cu`` ``iuvl_decode_tail``) at DECODE_TAIL_SHAPES:
    rel L2 of the tokens (bound 3.5e-3) and masks (1.2e-2) to the plain
    version, two launches bit-equal, times in turns, the plain version, the
    bound (the operations of chip_smoke.py's ``work``) and each kernel's
    device time."""
    lib = compile_source(parent_tree, work, "decode_tail")
    for tag, b, tp, tv, n in DECODE_TAIL_SHAPES:
        args = decode_tail_args(b, tp, tv, n)
        label = f"decode_tail@{tag} (B {b}, Tp {tp}, tokens {tv}, N {n})"
        new = lambda: dc.decode_tail(*args)  # noqa: E731
        got = refused(new, label, bad, "this tree")
        if got is None:
            continue
        want = dc.decode_tail_plain(*args)[:2]
        again = new()
        errs = [rel(x[:, :tv] if j == 0 else x, y[:, :tv] if j == 0 else y)
                for j, (x, y) in enumerate(zip(got, want))]
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        parent = parent_decode_call(lib, args) if tp <= 64 else None
        e_par = "refused"
        if parent:  # the parent takes Tp <= 64 (C8); there it must give the same bits
            par = parent()
            e_par = ", ".join(f"{rel(x[:, :tv] if j == 0 else x, y[:, :tv] if j == 0 else y):.3e}"
                              for j, (x, y) in enumerate(zip(par, want)))
            same_par = all(torch.equal(x, y) for x, y in zip(par, got))
            e_par += f"; bit-equal to this tree's {same_par}"
            if not same_par:
                bad.append(f"{label}: not the parent's bits")
            del par
        if not (errs[0] <= 3.5e-3 and errs[1] <= 1.2e-2) or not same:
            bad.append(f"{label} rel_l2 tokens, masks {errs}, bit-equal {same}")
        c, i, mlp, m, c4, c8 = 256, dc.I, dc.MLP, dc.M, 64, 32
        rows = n * (7 * c * i + c * 4 * c4 + 4 * c4 * 4 * c8 + 16 * c8 * m + 8 * tv * i)
        tokens = tv * (4 * c * c + 2 * tv * c + 6 * c * i + 2 * c * mlp + 3 * c * i) \
            + m * (2 * c * c + c * c8)
        flops = 2 * b * (rows + tokens) + 2 * 5 * n * c * i
        bound = flops / 989e12 * 1e3
        if parent:
            t_par, t_new = in_turns(parent, new)
            times = (f"ms this tree {t_new[0]:.4f} {t_new[1]:.4f}, parent {t_par[0]:.4f} "
                     f"{t_par[1]:.4f}; mean this {sum(t_new) / 2:.4f} parent "
                     f"{sum(t_par) / 2:.4f}")
        else:
            times = f"ms this tree {ms(new, 10):.4f} {ms(new, 10):.4f}; parent refuses"
        plain = lambda: dc.decode_tail_plain(*args)  # noqa: E731
        print(f"{label}: rel_l2 tokens {errs[0]:.3e}, masks {errs[1]:.3e} (parent {e_par}); "
              f"two launches bit-equal {same}; {times}; plain {ms(plain, 2):.4f}; bound "
              f"{bound:.4f} ms (operations, {flops / 1e9:.1f} GFLOP)", flush=True)
        print(f"{label} device split, this tree: {kernel_split(new, work, 3)}", flush=True)
        if parent:
            print(f"{label} device split, parent: {kernel_split(parent, work, 3)}", flush=True)
        del args, got, want, again
        torch.cuda.empty_cache()


def multi_report(label, names, new, parent, plain, bound, limits, bad, work) -> None:
    """``ab_report`` for a function of several outputs ``names``: rel L2 of
    each to ``plain`` (this tree's and the parent's, None where the parent
    refuses the shape), two launches bit-equal, times in turns, the plain
    version's time, the bound and each tree's device time split by launch."""
    got = refused(new, label, bad, "this tree")
    if got is None:
        return
    want, again = plain(), new()
    errs = {n: rel(x, y) for n, x, y in zip(names, got, want)}
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    e_par = "refused"
    if parent:
        par = parent()
        e_par = ", ".join(f"{n} {rel(x, y):.3e}" for n, x, y in zip(names, par, want))
        del par
    del again
    over = {n: e for n, e in errs.items() if not e <= limits[n]}
    if over or not same:
        bad.append(f"{label} rel_l2 over the bounds {over}, bit-equal {same}")
    if parent:
        t_par, t_new = in_turns(parent, new)
        times = (f"ms this tree {t_new[0]:.4f} {t_new[1]:.4f}, parent {t_par[0]:.4f} "
                 f"{t_par[1]:.4f}; mean this {sum(t_new) / 2:.4f} parent {sum(t_par) / 2:.4f}")
    else:
        times = f"ms this tree {ms(new):.4f} {ms(new):.4f}; parent refuses"
    print(f"{label}: rel_l2 " + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
          + f" (parent {e_par}); two launches bit-equal {same}; {times}; plain "
          f"{ms(plain, 3):.4f}; bound {bound[0]:.4f} ms ({bound[1]})", flush=True)
    print(f"{label} device split, this tree: {launch_split(new, work)}", flush=True)
    if parent:
        print(f"{label} device split, parent: {launch_split(parent, work)}", flush=True)


def matmul_yardstick(label, products) -> None:
    """Each (name, a, b) product a @ b through one torch.matmul (bf16 in,
    bf16 out), timed alone: what cuBLAS takes for the same GEMMs."""
    times = [(name, ms(lambda a=a, b=b: torch.matmul(a, b))) for name, a, b in products]
    print(f"{label} yardstick torch.matmul: " + ", ".join(f"{n} {t_:.4f}" for n, t_ in times)
          + f"; sum {sum(t_ for _, t_ in times):.4f} ms", flush=True)


# B9's shapes: those of B1 (WINDOW_BLOCK_SHAPES).
WB_BWD_NAMES = ("dx", "dwqkv", "dbqkv", "dwo", "dbo", "drh", "drw")
WB_BWD_BOUNDS = {"dx": 1e-3, "dwqkv": 5e-4, "dbqkv": 5e-4, "dwo": 5e-4, "dbo": 1e-5,
                 "drh": 5e-4, "drw": 5e-4}


def window_block_bwd_ab(parent_tree: Path, work: Path, bad: list) -> None:
    """B9 (``window_block_bwd.cu`` ``iuvl_window_block_bwd``), the windowed
    block's backward, at WINDOW_BLOCK_SHAPES: rel L2 of every output to the
    plain version (chip_smoke.py's bounds), two launches bit-equal, times in
    turns, the plain version, the bound (operations, chip_smoke.py's count),
    each launch's device time and, as a yardstick, its five GEMMs through
    torch.matmul. The parent's entry takes the wmma design's scratch (an fp32 GEMM
    output, the p and ds rows, the table partials)."""
    lib = compile_source(parent_tree, work, "window_block_bwd")
    win, n = wb.WIN, wb.WIN * wb.WIN
    for tag, nw, c, heads in WINDOW_BLOCK_SHAPES:
        d = c // heads
        rh, rw = rel_pos_tables(t(2 * win - 1, d, std=0.3), t(2 * win - 1, d, std=0.3),
                                (win, win))
        xw, g = t(nw, n, c), t(nw, n, c)
        wqkv, bqkv = t(3 * c, c, std=c ** -0.5), t(3 * c, std=0.3).float()
        wo = t(c, c, std=c ** -0.5)
        args = (xw, g, wqkv, bqkv, wo, rh, rw, heads)

        def parent():
            tt, n_pad, dev = nw * n, -(-n // 16) * 16, xw.device
            e = lambda *s, dtype=torch.bfloat16: torch.empty(s, dtype=dtype, device=dev)  # noqa
            f32 = torch.float32
            scratch = (e(tt, 3 * c, dtype=f32), e(tt, 3 * c), e(tt, 3 * c), e(tt, c),
                       e(tt, c), e(nw * heads, n_pad, n_pad), e(nw * heads, n_pad, n_pad),
                       e(nw * heads, 2, win, win, d, dtype=f32))
            dx = torch.empty_like(xw)
            grads = (e(3 * c, c, dtype=f32), e(3 * c, dtype=f32), e(c, c, dtype=f32),
                     e(c, dtype=f32), e(2, win, win, d, dtype=f32))
            assert lib.iuvl_window_block_bwd(*ptr(*args[:7], *scratch, dx, *grads), nw, c, win,
                                             d, stream()) == 0
            return dx, grads[0], grads[1], grads[2], grads[3], grads[4][0], grads[4][1]

        flops = 22 * nw * n * c * c + 12 * nw * n * n * c
        label = f"window_block_bwd@{tag} (windows {nw}, C {c}, heads {heads} of {d})"
        multi_report(label, WB_BWD_NAMES, lambda: wb.window_block_backward(*args), parent,
                     lambda: wb.window_block_backward_plain(*args),
                     bound_of((*args[:7], xw, wqkv, wo), flops), WB_BWD_BOUNDS, bad, work)
        x2, g2 = xw.reshape(-1, c), g.reshape(-1, c)
        dqkv, o = t(nw * n, 3 * c), t(nw * n, c)
        matmul_yardstick(label, (("qkv = x Wqkv^T", x2, wqkv.t()), ("do = g Wo", g2, wo),
                                 ("dx = dqkv Wqkv", dqkv, wqkv), ("dWqkv = dqkv^T x", dqkv.t(), x2),
                                 ("dWo = g^T o", g2.t(), o)))
        del args, xw, g, dqkv, o
        torch.cuda.empty_cache()


# B10's shapes: those of B3 (BLOCK_TAIL_SHAPES).
BT_BWD_NAMES = ("dxa", "dscale", "dbias", "dw1", "db1", "dw2", "db2")
BT_BWD_BOUNDS = {"dxa": 1e-3, "dscale": 5e-4, "dbias": 5e-4, "dw1": 5e-4, "db1": 5e-4,
                 "dw2": 5e-4, "db2": 1e-5}


def block_tail_bwd_ab(parent_tree: Path, work: Path, bad: list) -> None:
    """B10 (``mlp_block_bwd.cu`` ``iuvl_block_tail_bwd``), the block tail's
    backward, at BLOCK_TAIL_SHAPES: the readings of ``window_block_bwd``.
    The parent's entry takes the wmma design's scratch (y, the LayerNorm statistics,
    two (T, H) fp32 and two (T, H) bf16 arrays)."""
    lib = compile_source(parent_tree, work, "block_tail_bwd")
    for tag, n, c in BLOCK_TAIL_SHAPES:
        h = 4 * c
        x, a, g = t(n, c), t(n, c), t(n, c)
        scale, bias = (1.0 + t(c, std=0.1)).float(), t(c, std=0.3).float()
        w1, b1 = t(h, c, std=c ** -0.5), t(h, std=0.3)
        w2t = t(h, c, std=h ** -0.5)
        args = (x, a, g, scale, bias, w1, b1, w2t)

        def parent():
            f32, dev = torch.float32, x.device
            e = lambda *s, dtype=f32: torch.empty(s, dtype=dtype, device=dev)  # noqa: E731
            scratch = (e(n, c, dtype=torch.bfloat16), e(n, 2), e(n, h), e(n, h),
                       e(n, h, dtype=torch.bfloat16), e(n, h, dtype=torch.bfloat16))
            dxa = torch.empty_like(x)
            grads = (e(c), e(c), e(h, c), e(h), e(c, h), e(c))
            assert lib.iuvl_block_tail_bwd(*ptr(*args, *scratch, dxa, *grads), n, c, h, mb.EPS,
                                           stream()) == 0
            return (dxa, *grads)

        label = f"block_tail_bwd@{tag} (T {n}, C {c}, H {h})"
        multi_report(label, BT_BWD_NAMES, lambda: mb.block_tail_backward(*args), parent,
                     lambda: mb.block_tail_backward_plain(*args),
                     bound_of((*args, x, scale, bias, w1, b1, w1, w2t, w2t), 10 * n * c * h),
                     BT_BWD_BOUNDS, bad, work)
        y, hh = t(n, c), t(n, h)
        matmul_yardstick(label, (("hpre = y W1^T", y, w1.t()), ("dh = g W2", g, w2t.t()),
                                 ("dy = dhpre W1", hh, w1), ("dW1 = dhpre^T y", hh.t(), y),
                                 ("dW2 = g^T h", g.t(), hh)))
        del args, x, a, g, w1, w2t, y, hh
        torch.cuda.empty_cache()


# B7's levels of the batch-2 train step: (tag, side, skewed, head width).
# The skewed case puts every point of a head within a 2 x 2 cell window of
# the 128^2 level: four buckets of ~21,500 rows a head. Head widths 32 and
# 128 (SysLearner widths 256 and 1024 over 8 heads) this tree only.
DEFORM_SHAPES = (("res3", 128, False, 64), ("res4", 64, False, 64), ("res5", 32, False, 64),
                 ("skewed", 128, True, 64), ("res3_d32", 128, False, 32),
                 ("res3_d128", 128, False, 128))


def deform_level(side: int, skewed: bool, d: int = 64):
    """B7's inputs at one level of the batch-2 train step: 8 heads of d,
    the 21,504 queries of the three levels x 4 points sampling within a few
    pixels of their reference points (chip_smoke.py's res3 case), or every
    point of a head within a 2 x 2 cell window. Returns v (2, 8, side^2,
    d) bf16, x, y, aw (2, 8, Lq, 4) fp32."""
    from iuvl_tpu_torch.models.xdecoder.pixel_decoder import encoder_reference_points

    b, nh, pts, dev = 2, 8, 4, "cuda"
    ref = encoder_reference_points([(32, 32), (64, 64), (128, 128)], dev)[:, 0]
    lq = ref.shape[0]
    if skewed:
        corner = torch.randint(0, side - 1, (1, nh, 1, 1, 2), device=dev, generator=GEN)
        xy = corner + 2 * torch.rand(b, nh, lq, pts, 2, device=dev, generator=GEN)
    else:
        xy = ref[None, None, :, None, :] * side - 0.5 + 2.5 * torch.randn(
            b, nh, lq, pts, 2, device=dev, generator=GEN)
    aw = torch.rand(b, nh, lq, pts, device=dev, generator=GEN) / 12
    return (t(b, nh, side * side, d), xy[..., 0].contiguous(), xy[..., 1].contiguous(), aw)


def msdeform_fwd_ab(parent_tree: Path, work: Path, bad: list) -> None:
    """B7's forward (``msdeform.cu`` ``iuvl_msdeform_fwd``) at DEFORM_SHAPES,
    and at res3 with 3 points (the generic-P path): rel L2 to the plain
    version (chip_smoke.py's bound, 5e-7), two launches bit-equal, bit-equal
    to the parent (head width 64), times in turns, the plain version, the
    bound (bytes) and each tree's device time by launch."""
    from iuvl_tpu_torch.ops.cuda import msdeform as md

    lib = compile_source(parent_tree, work, "msdeform_fwd")
    for tag, side, skewed, d in DEFORM_SHAPES + (("res3_p3", 128, False, 64),):
        v, x, y, aw = deform_level(side, skewed, d)
        if tag.endswith("_p3"):
            x, y, aw = (a[..., :3].contiguous() for a in (x, y, aw))
        b, nh, hw, _ = v.shape
        lq, p = x.shape[2:]
        out = torch.empty((b, nh, lq, d), dtype=torch.float32, device="cuda")

        def parent():
            o = torch.empty_like(out)
            assert lib.iuvl_msdeform_fwd(*ptr(v, x, y, aw, o), b, nh, lq, p, side, side, 1,
                                         stream()) == 0
            return o

        label = f"msdeform_fwd@{tag} (B {b}, heads {nh} of {d}, {side}^2, Lq {lq}, P {p})"
        ab_report(label, lambda: md.ms_deform_level_fwd(v, x, y, aw, side, side),
                  parent if d == 64 else None,
                  lambda: md.ms_deform_level_fwd_plain(v, x, y, aw, side, side),
                  bound_of((v, x, y, aw, out), 0), bad, 5e-7, work)
        if d == 64 and not torch.equal(md.ms_deform_level_fwd(v, x, y, aw, side, side),
                                       parent()):
            bad.append(f"{label}: not the parent's bits")
        del v, x, y, aw, out
        torch.cuda.empty_cache()


def deform_scatter_ab(parent_tree: Path, work: Path, bad: list) -> None:
    """B7's d_value scatter (``msdeform.cu`` ``iuvl_deform_scatter``) of
    image 0 at DEFORM_SHAPES (bf16 contrib rows, a random cotangent), the
    whole wrapper of each tree (the parent's entry with the workspaces its
    wrapper hands it): rel L2 to the plain version (chip_smoke.py's bound,
    5e-8; both read 0), two launches bit-equal, the parent's bits, times in
    turns, ``index_add_`` on the wide map's rows, the bound (bytes), the
    bucket lengths, and this tree's device time by launch."""
    from iuvl_tpu_torch.ops.cuda import msdeform as md
    from iuvl_tpu_torch.ops.msdeform import wide_idx_wslot

    lib = compile_source(parent_tree, work, "deform_scatter")
    for tag, side, skewed, d in DEFORM_SHAPES:
        _, x, y, _ = deform_level(side, skewed, 16)
        idx, _ = wide_idx_wslot(side, side, x[0], y[0])
        nh, lq, p = idx.shape
        hw, rows = side * side, idx.numel()
        contrib = t(rows, 4 * d)

        def parent():
            bits, passes = md.scatter_plan(nh * hw)
            i32 = torch.int32
            ws = torch.empty(4 * rows + (-(-rows // md.SCATTER_TILE) + 1) * (1 << bits),
                             dtype=i32, device="cuda")
            start = torch.empty(nh * hw + 1, dtype=i32, device="cuda")
            part = torch.empty(-(-rows // md.SCATTER_CHUNK) * 2 * 256, device="cuda")
            dv = torch.empty((nh, hw, 64), dtype=torch.float32, device="cuda")
            assert lib.iuvl_deform_scatter(*ptr(contrib, idx, dv, ws, start, part), nh, lq * p,
                                           hw, side, bits, passes, 1, stream()) == 0
            return dv

        keys = (torch.arange(nh, device="cuda")[:, None] * hw + idx.view(nh, -1)).view(-1)
        lens = torch.bincount(keys, minlength=nh * hw)
        flat = (torch.arange(nh, device="cuda").view(nh, 1, 1) * hw + idx.long()).view(-1)
        wide = contrib.float()
        lib_call = lambda: torch.zeros((nh * hw, 4 * d), device="cuda").index_add_(  # noqa: E731
            0, flat, wide)
        label = (f"deform_scatter@{tag} ({rows} rows of 4 x {d} into heads {nh} x {side}^2; "
                 f"bucket rows mean {rows / (nh * hw):.1f}, max {int(lens.max())}, "
                 f"{int((lens > 256).sum())} over 256)")
        new = lambda: md.deform_scatter_dv(contrib, idx, hw, side)  # noqa: E731
        ab_report(label, new, parent if d == 64 else None,
                  lambda: md.deform_scatter_dv_plain(contrib, idx, hw, side),
                  bound_of((contrib, idx, torch.empty((nh, hw, d), device="cuda")), 0), bad,
                  5e-8, work)
        if d == 64 and not torch.equal(new(), parent()):
            bad.append(f"{label}: not the parent's bits")
        print(f"{label}: index_add_ on the wide map's rows {ms(lib_call):.4f} ms", flush=True)
        print(f"{label} launches, this tree: {launch_split(new, work)}", flush=True)
        del x, y, idx, contrib, wide, keys, lens, flat
        torch.cuda.empty_cache()


def deform_gather_ab(parent_tree: Path, work: Path, bad: list) -> None:
    """B7's tap-row gather (``msdeform.cu`` ``iuvl_deform_gather``) of image
    0 at DEFORM_SHAPES: rel L2 to the plain version (0: a copy), two
    launches bit-equal, the parent's bits (head width 64), times in turns,
    the plain version, ``index_select`` on the prebuilt wide map, the bound
    (bytes)."""
    from iuvl_tpu_torch.ops.cuda import msdeform as md
    from iuvl_tpu_torch.ops.msdeform import wide_idx_wslot

    lib = compile_source(parent_tree, work, "deform_gather")
    for tag, side, skewed, d in DEFORM_SHAPES:
        v, x, y, _ = deform_level(side, skewed, d)
        v = v[0].contiguous()
        idx, _ = wide_idx_wslot(side, side, x[0], y[0])
        nh, lq, p = idx.shape
        hw, rows = side * side, idx.numel()

        def parent():
            g4 = torch.empty((rows, 4 * d), dtype=v.dtype, device="cuda")
            assert lib.iuvl_deform_gather(*ptr(v, idx, g4), nh, lq * p, hw, side, 1,
                                          stream()) == 0
            return g4

        new = lambda: md.deform_gather_rows(v, idx, side)  # noqa: E731
        label = f"deform_gather@{tag} ({rows} rows of 4 x {d} from heads {nh} x {side}^2)"
        ab_report(label, new, parent if d == 64 else None,
                  lambda: md.deform_gather_rows_plain(v, idx, side),
                  bound_of((v, idx, torch.empty((rows, 4 * d), dtype=v.dtype, device="cuda")),
                           0), bad, 0.0, work)
        if d == 64 and not torch.equal(new(), parent()):
            bad.append(f"{label}: not the parent's bits")
        flat = (torch.arange(nh, device="cuda").view(nh, 1, 1) * hw + idx.long()).view(-1)
        wide = torch.cat([torch.roll(v, -off, dims=1) for off in md.tap_offsets(side)],
                         dim=-1).reshape(nh * hw, -1)
        print(f"{label}: index_select on the wide map {ms(lambda: wide.index_select(0, flat)):.4f}"
              " ms", flush=True)
        del v, x, y, idx, flat, wide
        torch.cuda.empty_cache()


GLUE_NAMES, GLUE_BOUNDS = ("contrib", "dots"), {"contrib": 0.0, "dots": 5e-7}


def deform_glue_ab(parent_tree: Path, work: Path, bad: list) -> None:
    """B8 (``deform_bwd_glue.cu``), both entries, on the res3 level's tap
    rows of image 0 (DEFORM_SHAPES' res3 cases, bf16) with a random fp32
    output cotangent and the slot weights times the attention weights:
    rel L2 of contrib and dots to the plain version (chip_smoke.py's
    bounds), two launches bit-equal, the parent's bits (head width 64), the
    two entries identical, times in turns, the plain version, the bound
    (bytes)."""
    from iuvl_tpu_torch.ops.cuda import deform_bwd_glue as dg
    from iuvl_tpu_torch.ops.cuda import msdeform as md
    from iuvl_tpu_torch.ops.msdeform import wide_idx_wslot

    lib = compile_source(parent_tree, work, "deform_glue")
    for tag, side, skewed, d in DEFORM_SHAPES:
        if not tag.startswith("res3"):
            continue
        v, x, y, aw = deform_level(side, skewed, d)
        idx, wslot = wide_idx_wslot(side, side, x[0], y[0])
        nh, lq, p = idx.shape
        g4 = md.deform_gather_rows_plain(v[0], idx, side)
        gout = torch.randn(nh * lq, d, device="cuda", generator=GEN)
        wa = (wslot * aw[0][..., None]).reshape(-1, 4).contiguous()
        args = (g4, gout, wa, p)
        outs = {}
        for entry, fn in (("iuvl_deform_bwd_glue_q", dg.deform_bwd_glue_q),
                          ("iuvl_deform_bwd_glue", dg.deform_bwd_glue)):
            def parent(entry=entry):
                contrib = torch.empty_like(g4)
                dots = torch.empty((g4.shape[0], 4), dtype=torch.float32, device="cuda")
                assert getattr(lib, entry)(*ptr(g4, gout, wa, contrib, dots), nh * lq, p, 1,
                                           stream()) == 0
                return contrib, dots

            new = lambda fn=fn: fn(*args)  # noqa: E731
            label = f"{entry[5:]}@{tag} ({g4.shape[0]} rows of 4 x {d}, P {p})"
            multi_report(label, GLUE_NAMES, new, parent if d == 64 else None,
                         lambda: dg.deform_bwd_glue_plain(*args),
                         bound_of((g4, gout, wa, g4, wa), 0), GLUE_BOUNDS, bad, work)
            outs[entry] = refused(new, label, [], "this tree")
            if outs[entry] is None:
                break
            if d == 64 and not all(torch.equal(a, b) for a, b in zip(outs[entry], parent())):
                bad.append(f"{label}: not the parent's bits")
        if None in outs.values():
            continue
        same = all(torch.equal(a, b) for a, b in zip(*outs.values()))
        print(f"deform_bwd_glue@{tag}: the two entries identical {same}", flush=True)
        if not same:
            bad.append(f"deform_bwd_glue@{tag}: the two entries differ")
        del v, x, y, aw, idx, wslot, g4, gout, wa, args, outs
        torch.cuda.empty_cache()


# B15's shapes: (tag, side, dtype, points, head width). The hybrid eval's
# res5 level, a 16^2 and a 50^2 table (2,500 cells: past the shared-memory
# instance), res5 in fp32 and with 3 points (the any-P instance); then head
# widths 32 and 128 (this tree only).
ONEHOT_SHAPES = (("res5", 32, torch.bfloat16, 4, 64), ("16x16", 16, torch.bfloat16, 4, 64),
                 ("50x50", 50, torch.bfloat16, 4, 64), ("res5_fp32", 32, torch.float32, 4, 64),
                 ("res5_p3", 32, torch.bfloat16, 3, 64), ("res5_d32", 32, torch.bfloat16, 4, 32),
                 ("res5_d128", 32, torch.bfloat16, 4, 128),
                 ("res5_fp32_d32", 32, torch.float32, 4, 32))


def onehot_level(side: int, dtype, p: int, d: int):
    """B15's inputs as the hybrid level makes them for 8 heads of d (batch
    1): the wide map (8, side^2, 4d), the clipped top-left cells (8, Lq, p)
    and the slot weights times the attention weight (8, Lq, 4, p) of the
    21,504 queries' points within a few pixels of their reference points."""
    from iuvl_tpu_torch.models.xdecoder.pixel_decoder import encoder_reference_points
    from iuvl_tpu_torch.ops.msdeform import wide_idx_wslot, wide_map

    nh, dev = 8, "cuda"
    ref = encoder_reference_points([(32, 32), (64, 64), (128, 128)], dev)[:, 0]
    lq = ref.shape[0]
    xy = ref[None, :, None, :] * side - 0.5 + 2.5 * torch.randn(nh, lq, p, 2, device=dev,
                                                                 generator=GEN)
    idx, wslot = wide_idx_wslot(side, side, xy[..., 0], xy[..., 1])
    aw = torch.rand(nh, lq, p, device=dev, generator=GEN) / 12
    v = t(1, nh, side * side, d).to(dtype)
    return (wide_map(v, side).reshape(nh, side * side, 4 * d), idx.contiguous(),
            (wslot * aw[..., None]).transpose(-1, -2).contiguous())


def onehot_ab(parent_tree: Path, work: Path, bad: list) -> None:
    """B15 (``onehot_gather.cu`` ``iuvl_onehot_level_fwd``) at ONEHOT_SHAPES:
    rel L2 to the plain version (chip_smoke.py's bound, 3e-5), two launches
    bit-equal, the parent's bits (head width 64), times in turns, the plain
    version, ``embedding_bag`` over the wide map's (cell, slot) rows (the
    weights rounded per point), the bound (bytes) and each tree's device
    time."""
    from iuvl_tpu_torch.ops.cuda import onehot_gather as og

    lib = compile_source(parent_tree, work, "onehot")
    for tag, side, dtype, p, d in ONEHOT_SHAPES:
        v4, idx, wslot = onehot_level(side, dtype, p, d)
        bh, cells, _ = v4.shape
        lq = idx.shape[1]

        def parent():
            out = torch.empty((bh, lq, d), dtype=v4.dtype, device="cuda")
            assert lib.iuvl_onehot_level_fwd(*ptr(v4, idx, wslot, out), bh, cells, lq, p,
                                             int(v4.dtype == torch.bfloat16), stream()) == 0
            return out

        new = lambda: og.onehot_deform_level_forward(v4, idx, wslot, p)  # noqa: E731
        label = (f"onehot@{tag} (BH {bh}, {cells} cells, Lq {lq}, P {p}, d {d}, "
                 f"{str(dtype)[6:]})")
        out = torch.empty((bh, lq, d), dtype=v4.dtype, device="cuda")
        ab_report(label, new, parent if d == 64 else None,
                  lambda: og.onehot_deform_level_forward_plain(v4, idx, wslot, p),
                  bound_of((v4, idx, wslot, out), 0), bad, 3e-5, work)
        if d == 64 and not torch.equal(new(), parent()):
            bad.append(f"{label}: not the parent's bits")
        table = v4.reshape(bh * cells * 4, d)
        heads = torch.arange(bh, device="cuda").view(bh, 1, 1, 1)
        slots = torch.arange(4, device="cuda").view(1, 1, 4, 1)
        rows = ((heads * cells + idx.long()[:, :, None]) * 4 + slots).reshape(-1, 4 * p)
        wts = wslot.reshape(-1, 4 * p).to(v4.dtype)
        bag = lambda: torch.nn.functional.embedding_bag(  # noqa: E731
            rows, table, per_sample_weights=wts, mode="sum")
        print(f"{label}: embedding_bag {ms(bag):.4f} ms", flush=True)
        del v4, idx, wslot, out, table, rows, wts
        torch.cuda.empty_cache()


MODES = {"rowbias": rowbias_ab, "flash": flash_ab, "seg_scatter": seg_ab, "i2t": i2t_ab,
         "tap_scatter": tap_ab, "t2i": t2i_ab, "upscale": upscale_ab,
         "window_block": window_block_ab, "rowbias_proj": rowbias_proj_ab,
         "block_tail": block_tail_ab, "decode_tail": decode_tail_ab,
         "window_block_bwd": window_block_bwd_ab, "block_tail_bwd": block_tail_bwd_ab,
         "msdeform_fwd": msdeform_fwd_ab, "deform_scatter": deform_scatter_ab,
         "deform_gather": deform_gather_ab, "deform_glue": deform_glue_ab, "onehot": onehot_ab}


def main() -> int:
    global GEN
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, required=True,
                    help="a tree holding the parent's iuvl_tpu_torch/csrc")
    ap.add_argument("--kernels", nargs="+", choices=sorted(MODES), default=["rowbias"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp())
    build.library()
    print(f"build {time.perf_counter() - t0:.1f} s")
    ptxas_summary((build.BUILD_DIR / "ptxas.log").read_text(), "this tree")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    GEN = torch.Generator(device="cuda").manual_seed(0)
    bad = []
    for mode in args.kernels:
        MODES[mode](args.parent.resolve(), work, bad)
    shutil.rmtree(work, ignore_errors=True)
    print("FAILED: " + "; ".join(bad) if bad else "kernel_ab: all within bounds")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
