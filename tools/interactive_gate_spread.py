"""How far apart do sound bf16 paths of the interactive click loop land?
chip_smoke.py's interactive set-up (the full-width SysLearner, one seeded
1024^2 image, 8 synthetic gt masks), its kernel loop run once per decode
design ('auto', 'chunk') to fix the prompts of every round, then those
prompts replayed through the kernel path, plain bf16, and a control pair
(plain bf16 and fp32 on weights x (1 + 2^-9 u)), each against its own fp32
path (relative L2): the unified decoder's logits and SAM's prompt-decode
products (masks, upscaled embedding) of rounds ROUNDS, one round at a time
and pooled over them.

    python3 tools/interactive_gate_spread.py

Needs one CUDA card.
"""

import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from iuvl_tpu_torch.data.visual_sampler import conv_dt_argmax  # noqa: E402
from iuvl_tpu_torch.inference.interactive import make_interactive_loop  # noqa: E402
from iuvl_tpu_torch.models.xdecoder.model import SysLearnerConfig, build_syslearner  # noqa: E402

ROUNDS = (1, 5, 10, 15, 20)
OUTS = ("logits", "sam_masks", "upscaled")


def outputs(model, cached, points, labels) -> dict:
    dec = model.decode_prompts(cached[0], points=points, labels=labels)
    return {"logits": model.decode_interactive(*cached, points=points, labels=labels),
            "sam_masks": dec["masks"], "upscaled": dec["upscaled_embedding"]}


def main() -> None:
    smi = cs.device_phase()
    from iuvl_tpu_torch.ops.cuda import build

    build.library()
    dev = torch.device("cuda", 0)
    cfg = SysLearnerConfig(**cs.INTERACTIVE_CONFIG)
    base = build_syslearner(cfg, device=dev, generator=torch.Generator().manual_seed(
        cs.SEED + 50))
    weights = base.state_dict()
    shifted = cs.perturbed(weights, cs.SEED + 5, dev)
    del base
    size = cfg.img_size
    image = torch.from_numpy(np.random.RandomState(cs.SEED + 51).rand(1, size, size, 3).astype(
        np.float32) * 255).to(dev)
    gt_np = cs.gt_shapes(size)
    gt = torch.from_numpy(gt_np).to(dev)
    firsts = torch.tensor([conv_dt_argmax(m)[::-1] for m in gt_np], dtype=torch.float32,
                          device=dev)

    def build_path(attn, twoway, dtype, w):
        m = build_syslearner(dataclasses.replace(cfg, attn_impl=attn, twoway_impl=twoway,
                                                 dtype=dtype), device=dev).eval()
        m.load_state_dict(w)
        return m

    with torch.inference_mode():
        for design, plain_twoway in (("auto", "plain"), ("chunk", "chunk_plain")):
            paths = {  # name -> (model, its fp32 path)
                "kernels": (build_path("auto", design, "bfloat16", weights), "fp32"),
                "plain_bf16": (build_path("plain", plain_twoway, "bfloat16", weights), "fp32"),
                "fp32": (build_path("plain", plain_twoway, "float32", weights), None),
                "control_bf16": (build_path("plain", plain_twoway, "bfloat16", shifted),
                                 "control_fp32"),
                "control_fp32": (build_path("plain", plain_twoway, "float32", shifted), None),
            }
            rec = cs._Recorder(paths["kernels"][0], cs.PER_ROUND[design])
            kcached = paths["kernels"][0].encode_interactive(image)
            make_interactive_loop(rec, max_clicks=cs.INTERACTIVE_ROUNDS)(
                *kcached, gt, firsts, torch.Generator(device=dev).manual_seed(cs.SEED + 52))
            prompts = {r: rec.rounds[r - 1][:2] for r in ROUNDS}
            del rec, kcached
            got = {}
            for name, (m, _) in paths.items():
                cached = m.encode_interactive(image)
                got[name] = {r: outputs(m, cached, *prompts[r]) for r in ROUNDS}
                del cached
            sq = {name: {o: [0.0, 0.0] for o in OUTS} for name, (_, ref) in paths.items() if ref}
            for r in ROUNDS:
                err = {name: {o: cs.rel_l2(got[name][r][o], got[ref][r][o]) for o in OUTS}
                       for name, (_, ref) in paths.items() if ref}
                for name in sq:
                    ref = paths[name][1]
                    for o in OUTS:
                        a, b = got[name][r][o].float(), got[ref][r][o].float()
                        sq[name][o][0] += float(torch.linalg.vector_norm(a - b) ** 2)
                        sq[name][o][1] += float(torch.linalg.vector_norm(b) ** 2)
                print(f"{design} round {r}: ratio to plain bf16 (kernels, control): " + "; ".join(
                    f"{o} {err['kernels'][o] / err['plain_bf16'][o]:.3f}, "
                    f"{err['control_bf16'][o] / err['plain_bf16'][o]:.3f}" for o in OUTS)
                    + f"; plain bf16 rel L2 logits {err['plain_bf16']['logits']:.3e}", flush=True)
            pooled = {name: {o: (a / b) ** 0.5 for o, (a, b) in acc.items()}
                      for name, acc in sq.items()}
            print(f"{design} pooled over rounds {ROUNDS}: ratio to plain bf16 (kernels, control): "
                  + "; ".join(f"{o} {pooled['kernels'][o] / pooled['plain_bf16'][o]:.3f}, "
                              f"{pooled['control_bf16'][o] / pooled['plain_bf16'][o]:.3f}"
                              for o in OUTS), flush=True)
            del paths, got
            torch.cuda.empty_cache()
    print(smi)


if __name__ == "__main__":
    main()
