"""Where a joint step-1 train step's time goes on the card: chip_smoke.py's
joint phase configuration (ViT-B 1024^2, bf16, the kernels, every stream:
one seg image, JOINT_VLP_BATCH VLP images) and its batches.

    python3 tools/joint_profile.py

After two warm-up steps, STEPS steps with the card synchronised around the
host Hungarian calls and around the backward and update: the host time of
each (mean a step) and of the rest of the forward. Then ``torch.profiler``
over STEPS more steps: the host span, the device time (the sum of the
kernels' and copies' times: one stream, so they do not overlap; user
annotations such as ``Optimizer.step#AdamW.step`` are spans that hold idle
gaps and the kernels inside them, and are left out), its share of the span,
and the 12 kernels with the most device time. Needs one CUDA card.
"""

import os
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from iuvl_tpu_torch.losses.criterion import CriterionConfig, SegCriterion  # noqa: E402
from iuvl_tpu_torch.models.xdecoder import convert  # noqa: E402
from iuvl_tpu_torch.models.xdecoder.model import SysLearnerConfig, build_syslearner  # noqa: E402
from iuvl_tpu_torch.train import train_step as ts  # noqa: E402
from iuvl_tpu_torch.train.optimizer import Optimizer  # noqa: E402

STEPS = 3


def timed(fn, into: list):
    """``fn`` with the card synchronised around it, its host seconds
    appended to ``into``."""
    def wrapped(*a, **kw):
        out, secs = cs.synced(lambda: fn(*a, **kw))
        into.append(secs)
        return out
    return wrapped


def main() -> None:
    smi = cs.device_phase()
    dev = torch.device("cuda", 0)
    cfg = SysLearnerConfig(**cs.JOINT_CONFIG)
    model = build_syslearner(cfg, device=dev, generator=torch.Generator().manual_seed(cs.SEED + 80))
    state = ts.TrainState(Optimizer(model.named_parameters(), paths=convert.flax_paths(cfg),
                                    base_lr=1e-4, total_steps=1000))
    step = ts.make_joint_train_step(model, SegCriterion(CriterionConfig(num_classes=cs.N_CLASSES)),
                                    match_points=cs.MATCH_POINTS)
    data = cs.JointData(dev, cs.SEED + 82)
    batches = [data.batch() for _ in range(2 + 2 * STEPS)]
    for args, draw in batches[:2]:
        step(state, *args, draw)
    matching, update, total = [], [], []
    with cs._patched(ts, "batched_hungarian", timed(ts.batched_hungarian, matching)), \
            cs._patched(ts, "_update", timed(ts._update, update)):
        for args, draw in batches[2:2 + STEPS]:
            total.append(cs.synced(lambda: step(state, *args, draw))[1])
    ms = {k: np.sum(v) / STEPS * 1e3 for k, v in (("step", total), ("matching", matching),
                                                    ("backward + update", update))}
    ms["rest of the forward"] = ms["step"] - ms["matching"] - ms["backward + update"]
    cs.log("profile joint step: host ms a step (mean of {}): ".format(STEPS)
           + ", ".join(f"{k} {v:.1f}" for k, v in ms.items()))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for args, draw in batches[2 + STEPS:]:
            step(state, *args, draw)
        torch.cuda.synchronize()
        span = time.perf_counter() - t0
    cuda = [a for a in prof.key_averages()
            if a.device_type == DeviceType.CUDA and a.self_device_time_total > 0]
    avgs = [a for a in cuda if not a.is_user_annotation]
    cs.log("profile joint step: annotations left out of the device time: " + ", ".join(
        f"{a.key} ({a.self_device_time_total / 1e3 / STEPS:.1f} ms a step)"
        for a in cuda if a.is_user_annotation))
    busy = sum(a.self_device_time_total for a in avgs) / 1e3
    cs.log(f"profile joint step: {STEPS} steps, host span {span * 1e3:.1f} ms, device time "
           f"{busy:.1f} ms ({busy / (span * 1e3):.1%} of the span, idle "
           f"{1 - busy / (span * 1e3):.1%})")
    for a in sorted(avgs, key=lambda a: a.self_device_time_total, reverse=True)[:12]:
        cs.log(f"profile joint step:   {a.self_device_time_total / 1e3 / STEPS:8.3f} ms a step, "
               f"{a.count // STEPS:5d} calls  {a.key[:90]}")
    print(smi)


if __name__ == "__main__":
    main()
