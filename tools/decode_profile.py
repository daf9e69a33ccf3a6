"""Where a served chunk's decode time goes on the card: SAM ViT-B (bf16,
chip_smoke.py's serving weights) decoding 256 point prompts over one
encoded 1024^2 image, through the per-op kernels (``twoway_impl='auto'``:
B4, B5, B6) and through the whole-chunk decode (``'chunk'``: B16).

    python3 tools/decode_profile.py

Per path, after two warm-up chunks: for ``'chunk'`` the host time of each
stage of the model's own decode (prompt encoder, block 0's token side,
the B16 call with its precomputes, and the rest: token assembly, padding,
the heads; the card synchronised around each, mean of 3 chunks); then
``torch.profiler`` over 3 chunks: the host span, the device time (one stream: the kernels' sum),
its share of the span, and the 12 kernels with the most device time.
Needs one CUDA card.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from iuvl_tpu_torch.models.sam import build_sam, mask_decoder, sam_model_registry  # noqa: E402
from tools.eval_profile import device_us, kernels_of  # noqa: E402

CALLS = 3


def chunk_stages(model, decode) -> dict:
    """Host seconds of each stage of one ``decode()`` through 'chunk': the
    model's own prompt encoder, ``chunk_front`` and ``decode_tail`` calls,
    each timed with the card synchronised around it, and the rest of the
    decode (token assembly, padding, the heads) as what is left of the
    whole."""
    secs = {}

    def timed(name, fn):
        def call(*a, **k):
            out, secs[name] = cs.synced(lambda: fn(*a, **k))
            return out
        return call

    pe, tr = model.prompt_encoder, model.mask_decoder.transformer
    pe.forward = timed("prompt_encoder", pe.forward)
    tr.chunk_front = timed("token_front", tr.chunk_front)
    try:
        with cs._patched(mask_decoder, "decode_tail", timed("decode_tail",
                                                            mask_decoder.decode_tail)):
            _, whole = cs.synced(decode)
    finally:
        del pe.forward, tr.chunk_front
    secs["rest"] = whole - sum(secs.values())
    return secs


def main() -> None:
    smi = cs.device_phase()
    dev = torch.device("cuda", 0)
    base = sam_model_registry["vit_b"](dtype="bfloat16", device=dev,
                                       generator=torch.Generator().manual_seed(cs.SEED)).eval()
    rs = np.random.RandomState(cs.SEED + 1)
    image = torch.from_numpy(rs.rand(1, 1024, 1024, 3).astype(np.float32) * 255).to(dev)
    points = torch.from_numpy(rs.rand(cs.CHUNK, 1, 2).astype(np.float32) * 1024).to(dev)
    labels = torch.ones(cs.CHUNK, 1, dtype=torch.int32, device=dev)
    for impl in ("auto", "chunk"):
        m = build_sam("vit_b", dtype="bfloat16", twoway_impl=impl, device=dev).eval()
        m.load_state_dict(base.state_dict())
        with torch.no_grad():
            emb, _ = m.encode_image(m.normalize(image), return_fpn=False)
            decode = lambda: m.decode_from_embedding(emb, points, labels,  # noqa: E731
                                                     return_upscaled=False)
            for _ in range(2):
                decode()
            if impl == "chunk":
                per = [chunk_stages(m, decode) for _ in range(CALLS)]
                cs.log(f"profile {impl}: stage ms (mean of {CALLS}) " + ", ".join(
                    f"{k} {np.mean([p[k] for p in per]) * 1e3:.2f}" for k in per[0]))
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                _, span = cs.synced(lambda: [decode() for _ in range(CALLS)])
        avgs = kernels_of(prof)
        busy = sum(device_us(a) for a in avgs) / 1e3
        cs.log(f"profile {impl}: {CALLS} chunks of {cs.CHUNK}, host span {span * 1e3:.1f} ms, "
               f"device time {busy:.1f} ms ({busy / (span * 1e3):.1%} of the span, idle "
               f"{1 - busy / (span * 1e3):.1%})")
        for a in sorted(avgs, key=device_us, reverse=True)[:12]:
            cs.log(f"profile {impl}:   {device_us(a) / 1e3 / CALLS:8.3f} ms a chunk, "
                   f"{a.count // CALLS:5d} calls  {a.key[:90]}")
        del m
        torch.cuda.empty_cache()
    print(smi)


if __name__ == "__main__":
    main()
