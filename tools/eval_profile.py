"""Where a seg eval call's time goes on the card: ``evaluate_seg`` of the
full-width eval config (bf16, batch 1) through the kernels, with
``msdeform_impl='auto'`` and ``'hybrid'``, on chip_smoke.py's eval weights,
first image and class embeddings.

    python3 tools/eval_profile.py

Per path, after two warm-up calls: the host time of each stage (encode,
pixel decoder, unified decoder, the resize of the mask logits; the card
synchronised around each, mean of 3 calls), then ``torch.profiler`` over 3
calls: the host span, the device time (the sum of the kernels' times: one
stream, so they do not overlap), its share of the span, and the 12
kernels with the most device time. Needs one CUDA card.
"""

import dataclasses
import os
import sys

import numpy as np
import torch
from torch.autograd import DeviceType

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from iuvl_tpu_torch.data.class_names import get_class_names  # noqa: E402
from iuvl_tpu_torch.models.xdecoder.model import SysLearnerConfig, build_syslearner  # noqa: E402
from iuvl_tpu_torch.ops.resize import resize_axis  # noqa: E402
from iuvl_tpu_torch.pipeline import class_text_embeddings  # noqa: E402

CALLS = 3


def stages(m, image, text) -> dict:
    """Host seconds of each stage of one evaluate_seg call."""
    out = {}
    (_, fpn), out["encode"] = cs.synced(lambda: m.encode_image(image, return_embedding=False))
    (mf, ms), out["pixel_decoder"] = cs.synced(lambda: m.pixel_decoder(fpn))
    res, out["predictor"] = cs.synced(lambda: m.predictor(
        ms, mf, text_embeddings=text, logit_scale=m.lang_encoder.logit_scale, task="seg"))
    _, out["resize"] = cs.synced(lambda: resize_axis(
        resize_axis(res["pred_masks"], 2, image.shape[1], "linear"), 3, image.shape[2],
        "linear"))
    return out


def device_us(avg) -> float:
    return avg.self_device_time_total


def kernels_of(prof) -> list:
    """The profile's device kernels (their averages over the calls)."""
    return [a for a in prof.key_averages()
            if a.device_type == DeviceType.CUDA and device_us(a) > 0]


def main() -> None:
    smi = cs.device_phase()
    dev = torch.device("cuda", 0)
    cfg = SysLearnerConfig(**cs.EVAL_CONFIG)
    base = build_syslearner(cfg, device=dev, generator=torch.Generator().manual_seed(cs.SEED + 30))
    rs = np.random.RandomState(cs.SEED + 31)
    image = cs.make_batch(rs, 1, cfg.img_size, torch.device("cpu"))[0].to(dev)
    with torch.no_grad():
        text = class_text_embeddings(base, get_class_names("coco_panoptic"))
    for impl in ("auto", "hybrid"):
        m = build_syslearner(dataclasses.replace(cfg, msdeform_impl=impl), device=dev).eval()
        m.load_state_dict(base.state_dict())
        with torch.no_grad():
            for _ in range(2):
                m.evaluate_seg(image, text)
            per = [stages(m, image, text) for _ in range(CALLS)]
            cs.log(f"profile kernels_{impl}: stage ms (mean of {CALLS}) " + ", ".join(
                f"{k} {np.mean([p[k] for p in per]) * 1e3:.2f}" for k in per[0]))
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                _, span = cs.synced(lambda: [m.evaluate_seg(image, text) for _ in range(CALLS)])
        avgs = kernels_of(prof)
        busy = sum(device_us(a) for a in avgs) / 1e3
        cs.log(f"profile kernels_{impl}: {CALLS} calls, host span {span * 1e3:.1f} ms, device "
               f"time {busy:.1f} ms ({busy / (span * 1e3):.1%} of the span, idle "
               f"{1 - busy / (span * 1e3):.1%})")
        for a in sorted(avgs, key=device_us, reverse=True)[:12]:
            cs.log(f"profile kernels_{impl}:   {device_us(a) / 1e3 / CALLS:8.3f} ms a call, "
                   f"{a.count // CALLS:5d} calls  {a.key[:90]}")
        del m
        torch.cuda.empty_cache()
    print(smi)


if __name__ == "__main__":
    main()
