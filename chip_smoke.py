"""Drive the port's SAM serving path once on one CUDA card, and check it.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):
1. device: require CUDA; print torch/CUDA versions and the card's name and
   power limit (nvidia-smi).
2. build: compile the hand-written kernels from iuvl_tpu_torch/csrc.
3. kernels: each kernel against its plain PyTorch version at the ViT-B,
   1024^2, bf16 shapes of the serving path. The relative L2 error must stay
   within the kernel's own bound (KERNEL_BOUNDS), and every planted fault
   (a bias, rel-pos or PE term dropped, a head or mask token swapped; run
   through the plain version) must move the output by more than that
   bound, so the bound is shown to catch them. Times from CUDA events after
   a warm-up.
4. slice: ViT-B bf16 with seeded random weights answers REQUESTS requests
   (one 1024^2 image encoded once without the SimpleFPN, which serving
   never reads, then 1024 point prompts decoded in chunks of 256) through
   the kernels, with per-request launch counts checked; the same requests
   go through the plain versions in bf16 and in fp32. The kernel path's
   masks must be no further from the fp32 masks than SLICE_FACTOR times the
   plain bf16 path's distance, in relative L2 of the logits and in
   1 - mean per-mask IoU of ``logits > 0``.
5. prints the kernel table as one JSON line, the nvidia-smi line, and
   ``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# Relative L2 error of each kernel against its plain bf16 version on the
# card: about 3-7x its sound reading, and 5x or more below its smallest
# planted fault's (PERF.md, Findings, lists both readings).
KERNEL_BOUNDS = {
    "window_attention_block": 5e-4,
    "flash_attention_rowbias_proj": 1e-2,
    "block_tail": 5e-4,
    "masks_upscale": 2e-4,
    "t2i_stream": 5e-3,
    "i2t_block_step": 2e-4,
}
# The kernel path's masks against the fp32 plain path's may be this many
# times as far off as the plain bf16 path's (sound: 0.99).
SLICE_FACTOR = 1.25
REQUESTS = 3
N_PROMPTS, CHUNK = 1024, 256
SEED = 0
BIAS_STD = 0.3  # biases, PE and rel-pos terms: a fair share of a unit signal
PALLAS = "iuvl_tpu/ops/pallas/"
SOURCES = {  # kernel -> (CUDA source, the TPU function it replaces)
    "window_attention_block": ("window_block.cu", "window_block.py:148"),
    "flash_attention_rowbias_proj": ("flash_attention.cu", "flash_attention.py:1271"),
    "block_tail": ("mlp_block.cu", "mlp_block.py:115"),
    "masks_upscale": ("mask_upscale.cu", "mask_upscale.py:181"),
    "t2i_stream": ("twoway_attention.cu", "twoway_attention.py:305"),
    "i2t_block_step": ("twoway_attention.cu", "twoway_attention.py:163"),
}


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


def kernels():
    """kernel name -> its wrapper (whose ``launches`` counts) and plain version."""
    from iuvl_tpu_torch.ops.cuda import flash_attention as fa
    from iuvl_tpu_torch.ops.cuda import mask_upscale as mu
    from iuvl_tpu_torch.ops.cuda import mlp_block as mb
    from iuvl_tpu_torch.ops.cuda import twoway_attention as ta
    from iuvl_tpu_torch.ops.cuda import window_block as wb

    return {
        "window_attention_block": (wb.window_attention_block, wb.window_attention_block_plain),
        "flash_attention_rowbias_proj": (fa.flash_attention_rowbias_proj,
                                         fa.rowbias_proj_plain),
        "block_tail": (mb.block_tail, mb.block_tail_plain),
        "masks_upscale": (mu.masks_upscale, mu.masks_upscale_plain),
        "t2i_stream": (ta.t2i_stream, ta.t2i_stream_plain),
        "i2t_block_step": (ta.i2t_block_step, ta.i2t_block_step_plain),
    }


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


def kernel_cases(rs: np.random.RandomState, dev):
    """(name, args, planted faults {name: args -> args}, timing iters) at the
    slice shapes, with the weight layouts the models hand the kernels."""
    from iuvl_tpu_torch.ops.cuda.mask_upscale import flat_deconv
    from iuvl_tpu_torch.ops.rel_pos_attention import rel_pos_features, rel_pos_tables

    bf, f32 = torch.bfloat16, torch.float32

    def t(*shape, std=1.0, dtype=bf):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32) * std).to(dev, dtype)

    c, heads, d, n, s = 768, 12, 64, 4096, BIAS_STD
    rh, rw = rel_pos_tables(t(27, d, std=s), t(27, d, std=s), (14, 14))
    win = (t(25, 196, c), t(3 * c, c, std=c ** -0.5), t(3 * c, std=s, dtype=f32),
           t(c, c, std=c ** -0.5), t(c, std=s, dtype=f32), rh, rw, heads)
    q, k, v = (t(1, heads, n, d) for _ in range(3))
    relh, relw = rel_pos_features(q, *rel_pos_tables(t(127, d, std=s), t(127, d, std=s),
                                                     (64, 64)))
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
    return [
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
    ]


def kernel_phase(dev) -> list[dict]:
    """Checks every kernel and prints every reading, then raises if any
    check failed."""
    rows, failed = [], []
    table = kernels()
    for name, args, faults, iters in kernel_cases(np.random.RandomState(SEED), dev):
        kern, plain = table[name]
        bound = KERNEL_BOUNDS[name]
        out = kern(*args)
        torch.cuda.synchronize()
        ref = plain(*args)
        torch.cuda.synchronize()
        if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"{name}: shape {tuple(out.shape)} vs {tuple(ref.shape)}"
                               " or non-finite output")
        err = rel_l2(out, ref)
        max_abs = float((out.float() - ref.float()).abs().max())
        # Both bf16 results against the plain version in fp32 on the same
        # (bf16-valued) inputs: how far bf16 alone moves the result.
        ref32 = plain(*[a.float() if torch.is_tensor(a) else a for a in args])
        log(f"kernel {name}: vs fp32 plain: kernel rel_l2 {rel_l2(out, ref32):.3e}, "
            f"bf16 plain rel_l2 {rel_l2(ref, ref32):.3e}")
        del ref32
        fault_errs = {f: rel_l2(plain(*plant(args)), ref) for f, plant in faults.items()}
        log(f"kernel {name}: planted faults (plain version) rel_l2 "
            + ", ".join(f"{f} {e:.3e}" for f, e in fault_errs.items()))
        ms = cuda_ms(lambda: kern(*args), iters)
        plain_ms = cuda_ms(lambda: plain(*args), iters)
        log(f"kernel {name}: rel_l2 {err:.3e} (bound {bound:g}) max_abs {max_abs:.3e} "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        if not err <= bound:
            failed.append(f"{name}: rel L2 {err} over its bound {bound}")
        weak = {f: e for f, e in fault_errs.items() if not e > bound}
        if weak:
            failed.append(f"{name}: bound {bound} would not catch {weak}")
        source, replaces = SOURCES[name]
        rows.append(dict(name=name, route="cuda", source="iuvl_tpu_torch/csrc/" + source,
                         replaces=PALLAS + replaces, max_abs_err=max_abs, ms=ms,
                         plain_ms=plain_ms))
    if failed:
        raise RuntimeError("kernel checks failed: " + "; ".join(failed))
    return rows


def serve(model, image, points, labels):
    """One request: encode once, decode the prompts in chunks. Returns the
    masks and (encode_s, [decode_s per chunk]) on the host clock."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb, _ = model.encode_image(model.normalize(image), return_fpn=False)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    masks, decode_s = [], []
    for i in range(0, N_PROMPTS, CHUNK):
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


def slice_phase(dev) -> dict:
    from iuvl_tpu_torch.models.sam import build_sam, sam_model_registry

    per_request = {"window_attention_block": 8, "flash_attention_rowbias_proj": 4,
                   "block_tail": 12, "masks_upscale": N_PROMPTS // CHUNK,
                   "t2i_stream": 3 * N_PROMPTS // CHUNK, "i2t_block_step": 2 * N_PROMPTS // CHUNK}
    wrappers = {name: kern for name, (kern, _) in kernels().items()}
    gen = torch.Generator().manual_seed(SEED)
    model = sam_model_registry["vit_b"](dtype="bfloat16", device=dev, generator=gen).eval()
    plain = {}
    for dtype in ("bfloat16", "float32"):
        plain[dtype] = build_sam("vit_b", dtype=dtype, attn_impl="plain",
                                 twoway_impl="plain").eval()
        plain[dtype].load_state_dict(model.state_dict())
        plain[dtype].to(dev)
    rs = np.random.RandomState(SEED + 1)
    totals = {k: 0 for k in per_request}
    timing = {"kernels": [], "plain": []}
    with torch.inference_mode():
        for r in range(REQUESTS):
            request(r, model, plain, rs, dev, wrappers, per_request, totals, timing)
    for path, runs in timing.items():  # steady state: requests after the first
        enc = float(np.mean([e for e, _ in runs[1:]]))
        dec = float(np.mean([np.mean(d) for _, d in runs[1:]]))
        per_image = enc + dec * (N_PROMPTS // CHUNK)
        log(f"slice {path} (mean of requests 1..{REQUESTS - 1}): encode {enc * 1e3:.2f} ms, "
            f"{dec * 1e3:.2f} ms per {CHUNK}-prompt chunk, {N_PROMPTS / per_image:.1f} masks/s")
    return totals


def request(r, model, plain, rs, dev, wrappers, per_request, totals, timing):
    """Serve request r through the kernels (checking the launch counts) and
    through the plain paths, and hold the masks against the fp32 ones."""
    image = torch.from_numpy(rs.rand(1, 1024, 1024, 3).astype(np.float32) * 255).to(dev)
    points = torch.from_numpy(rs.rand(N_PROMPTS, 1, 2).astype(np.float32) * 1024).to(dev)
    labels = torch.ones(N_PROMPTS, 1, dtype=torch.int32, device=dev)
    for fn in wrappers.values():
        fn.launches = 0
    masks_k, enc_k, dec_k = serve(model, image, points, labels)
    counts = {name: fn.launches for name, fn in wrappers.items()}
    for name, want in per_request.items():
        if counts[name] != want:
            raise RuntimeError(f"request {r}: {name} launched {counts[name]} times, "
                               f"expected {want}")
        totals[name] += counts[name]
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
    log(f"request {r}: launches {counts}; vs fp32 plain: rel_l2 kernels {err_k:.3e} "
        f"plain bf16 {err_p:.3e}, mean IoU kernels {iou_k:.5f} plain bf16 {iou_p:.5f} "
        f"over {n_masks} non-empty masks; kernels vs plain bf16 IoU {iou_kp:.5f}; "
        f"positive share kernels {pos[0]:.4f} plain {pos[1]:.4f} fp32 {pos[2]:.4f}")
    for path, enc, dec in (("kernels", enc_k, dec_k), ("plain", enc_p, dec_p)):
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


def main() -> int:
    smi = device_phase()
    dev = torch.device("cuda", 0)
    from iuvl_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s ({build.BUILD_DIR})")
    with torch.inference_mode():
        rows = kernel_phase(dev)
    launches = slice_phase(dev)
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
