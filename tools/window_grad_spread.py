"""How far apart do sound bf16 paths of the seg train step land under
``attn_impl='window'``? The step-0 gradients of the full-width SysLearner
at batch 1 (chip_smoke.py's batch-1 data: the first step's batch, then the
loss gate's batches), at one set of weights (no update), through several
bf16 paths, each held against its fp32 path by parameter group (relative
L2), per batch and pooled over the batches.

    python3 tools/window_grad_spread.py [batches]

Paths: the kernels ('window': B13); B13's plain version ('window_plain');
the unfused route's other rounding points ('plain'); the control pair
('window_plain' bf16 and fp32 on weights x (1 + 2^-9 u)). Each path's
masks are scored at the same points, with the fp32 path's assignments.
Needs one CUDA card.
"""

import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from iuvl_tpu_torch.losses.criterion import CriterionConfig, SegCriterion  # noqa: E402
from iuvl_tpu_torch.losses.matcher import batched_hungarian  # noqa: E402
from iuvl_tpu_torch.models.xdecoder.model import SysLearnerConfig, build_syslearner  # noqa: E402
from iuvl_tpu_torch.ops.point_sample import given_draws  # noqa: E402
from iuvl_tpu_torch.train.train_step import split_seg_outputs  # noqa: E402


def main() -> None:
    smi = cs.device_phase()
    n_batches = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    dev = torch.device("cuda", 0)
    cfg = SysLearnerConfig(**{**cs.TRAIN_CONFIG, "attn_impl": "window"})
    ref16 = dataclasses.replace(cfg, attn_impl="window_plain")
    ref32 = dataclasses.replace(ref16, dtype="float32")
    base = build_syslearner(cfg, device=dev, generator=torch.Generator().manual_seed(cs.SEED))
    weights = base.state_dict()
    shifted = cs.perturbed(weights, cs.SEED + 5, dev)
    del base
    paths = {  # name -> (config, weights, its fp32 path)
        "window_plain_fp32": (ref32, weights, None),
        "window": (cfg, weights, "window_plain_fp32"),
        "window_plain_bf16": (ref16, weights, "window_plain_fp32"),
        "plain_bf16": (dataclasses.replace(cfg, attn_impl="plain"), weights,
                       "window_plain_fp32"),
        "control_fp32": (ref32, shifted, None),
        "control_bf16": (ref16, shifted, "control_fp32"),
    }
    models = {}
    for name, (c, w, _) in paths.items():
        models[name] = build_syslearner(c, device=dev)
        models[name].load_state_dict(w)
    del weights, shifted
    rs = np.random.RandomState(cs.SEED + 2)
    text = torch.from_numpy(rs.randn(cs.N_CLASSES + 1, cfg.syslearner_dim).astype(
        np.float32)).to(dev)
    draw_gen = torch.Generator(device=dev).manual_seed(cs.SEED + 3)
    data = [(*cs.make_batch(rs, 1, cfg.img_size, dev), cs.step_draws(draw_gen, 10, 1))]
    gate_rs = np.random.RandomState(cs.SEED + 20)
    gate_gen = torch.Generator(device=dev).manual_seed(cs.SEED + 21)
    data += [(*cs.make_batch(gate_rs, 1, cfg.img_size, dev), cs.step_draws(gate_gen, 10, 1))
             for _ in range(n_batches - 1)]
    groups = cs.GROUPS
    # pooled rel L2 over the batches: sqrt(sum |g - r|^2) / sqrt(sum |r|^2)
    sq = {name: {g: [0.0, 0.0] for g in groups} for name, (_, _, ref) in paths.items() if ref}
    for i, (image, targets, draws) in enumerate(data):
        grads, assignments = {}, None
        for name, m in models.items():
            crit = SegCriterion(CriterionConfig(num_classes=cs.N_CLASSES),
                                impl=m.cfg.kernels_impl)
            m.zero_grad(set_to_none=True)
            draw = given_draws(draws)
            obj = split_seg_outputs(m.forward_seg(image, text), m.cfg.num_queries)
            costs, kept = crit.collect_costs(obj, targets, draw, cs.MATCH_POINTS)
            if assignments is None:  # the first fp32 path's
                assignments = batched_hungarian(costs)
            sum(crit.losses_from_assignments(kept, assignments, targets, draw).values()).backward()
            grads[name] = {g: torch.cat([p.grad.float().flatten() for n, p in m.named_parameters()
                                         if n.startswith(g) and p.grad is not None])
                           for g in groups}
            m.zero_grad(set_to_none=True)
            torch.cuda.empty_cache()
        yard = [cs.rel_l2(grads["window_plain_bf16"][g], grads["window_plain_fp32"][g])
                for g in groups]
        line = []
        for name, acc in sq.items():
            ref = paths[name][2]
            for g in groups:
                acc[g][0] += float(torch.linalg.vector_norm(grads[name][g] - grads[ref][g]) ** 2)
                acc[g][1] += float(torch.linalg.vector_norm(grads[ref][g]) ** 2)
            ratios = [cs.rel_l2(grads[name][g], grads[ref][g]) / y for g, y in zip(groups, yard)]
            line.append(f"{name} " + "/".join(f"{r:.3f}" for r in ratios))
        print(f"batch {i}: gradient groups {groups}, rel L2 to fp32 over window_plain bf16's: "
              + "; ".join(line), flush=True)
        del grads
    pooled = {name: [(a / b) ** 0.5 for a, b in acc.values()] for name, acc in sq.items()}
    for name, errs in pooled.items():
        print(f"pooled over {len(data)} batches, {name}: rel L2 "
              + "/".join(f"{e:.3e}" for e in errs) + "; ratio to window_plain bf16 "
              + "/".join(f"{e / y:.3f}" for e, y in zip(errs, pooled["window_plain_bf16"])),
              flush=True)
    print(smi)


if __name__ == "__main__":
    main()
