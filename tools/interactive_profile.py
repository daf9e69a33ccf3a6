"""Where an interactive click round's time goes on the card: chip_smoke.py's
interactive set-up (the full-width SysLearner, bf16, one seeded 1024^2
image and its 8 synthetic gt masks), the image encoded once, then rounds of
the 8 targets' 20-slot prompts (26 tokens) and single one-point prompts
through ``decode_interactive``, under twoway_impl 'auto' (B4-B6) and
'chunk' (B16).

    python3 tools/interactive_profile.py

Per design and prompt batch, after two warm-up calls: the host time of
SAM's prompt decode and of the unified decoder (the card synchronised
around each, mean of 3 calls); then ``torch.profiler`` over 3 calls: the
host span, the device time (the kernels' sum), its share of the span, and
the 12 kernels with the most device time. Needs one CUDA card.
"""

import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from iuvl_tpu_torch.models.xdecoder.model import SysLearnerConfig, build_syslearner  # noqa: E402
from tools.eval_profile import device_us, kernels_of  # noqa: E402

CALLS = 3


def stages(model, decode) -> dict:
    """Host seconds of one ``decode()``: the model's own prompt decode and
    unified decoder calls, each with the card synchronised around it, and
    the rest (the cache tiling, slicing)."""
    secs = {}

    def timed(name, fn):
        def call(*a, **k):
            out, secs[name] = cs.synced(lambda: fn(*a, **k))
            return out
        return call

    model.decode_prompts = timed("sam_decode", model.decode_prompts)
    model.predictor.forward = timed("unified_decoder", model.predictor.forward)
    try:
        _, whole = cs.synced(decode)
    finally:
        del model.decode_prompts, model.predictor.forward
    secs["rest"] = whole - sum(secs.values())
    return secs


def main() -> None:
    smi = cs.device_phase()
    dev = torch.device("cuda", 0)
    cfg = SysLearnerConfig(**cs.INTERACTIVE_CONFIG)
    size = cfg.img_size
    image = torch.from_numpy(np.random.RandomState(cs.SEED + 51).rand(1, size, size, 3).astype(
        np.float32) * 255).to(dev)
    rs = np.random.RandomState(cs.SEED + 53)
    n = len(cs.gt_shapes(size))
    points = torch.zeros((n, cs.INTERACTIVE_ROUNDS, 2), device=dev)
    labels = torch.full((n, cs.INTERACTIVE_ROUNDS), -1, dtype=torch.int32, device=dev)
    points[:, :10] = torch.from_numpy(rs.rand(n, 10, 2).astype(np.float32) * size).to(dev)
    labels[:, :10] = 1
    one = (torch.tensor([[[size / 2, size / 2]]], device=dev),
           torch.ones((1, 1), dtype=torch.int32, device=dev))
    for design in ("auto", "chunk"):
        m = build_syslearner(dataclasses.replace(cfg, twoway_impl=design), device=dev,
                             generator=torch.Generator().manual_seed(cs.SEED + 50)).eval()
        with torch.inference_mode():
            cached, enc_s = cs.synced(lambda: m.encode_interactive(image))
            cached, enc_s = cs.synced(lambda: m.encode_interactive(image))
            cs.log(f"profile {design}: encode_interactive {enc_s * 1e3:.2f} ms (second call)")
            for label, (pts, lbs) in ((f"{n} prompts of 26 tokens", (points, labels)),
                                      ("one one-point prompt", one)):
                decode = lambda: m.decode_interactive(*cached, points=pts,  # noqa: E731
                                                      labels=lbs)
                for _ in range(2):
                    decode()
                per = [stages(m, decode) for _ in range(CALLS)]
                cs.log(f"profile {design}, {label}: stage ms (mean of {CALLS}) " + ", ".join(
                    f"{k} {np.mean([p[k] for p in per]) * 1e3:.2f}" for k in per[0]))
                acts = [torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]
                with torch.profiler.profile(activities=acts) as prof:
                    _, span = cs.synced(lambda: [decode() for _ in range(CALLS)])
                avgs = kernels_of(prof)
                busy = sum(device_us(a) for a in avgs) / 1e3
                cs.log(f"profile {design}, {label}: {CALLS} calls, host span {span * 1e3:.1f} "
                       f"ms, device time {busy:.1f} ms ({busy / (span * 1e3):.1%} of the span, "
                       f"idle {1 - busy / (span * 1e3):.1%})")
                for a in sorted(avgs, key=device_us, reverse=True)[:12]:
                    cs.log(f"profile {design}:   {device_us(a) / 1e3 / CALLS:8.3f} ms a call, "
                           f"{a.count // CALLS:5d} launches  {a.key[:90]}")
        del m, cached
        torch.cuda.empty_cache()
    print(smi)


if __name__ == "__main__":
    main()
