"""How far apart do sound bf16 paths of the seg train step land? One
step-0 forward and backward of the full-width SysLearner at batch 2 (the
data of chip_smoke.py's batch-2 phase, then two more batches) through
several bf16 variants, each held against its own fp32 path: the FPN and
pixel-decoder outputs, the mask logits, the three loss terms over their 10
layers and the three gradient groups (relative L2).

    python3 tools/gate_spread.py [--share-points]

Variants: plain bf16; the kernels; the kernels with the flat deformable
core on its plain versions; plain bf16 with the flat core's kernels; the
control pair (plain bf16 on weights x (1 + 2^-9 u), against fp32 on the
same weights); the kernels and plain bf16 on the plain 'wide' core.
``--share-points``: every path evaluates its mask losses at the points its
fp32 path sampled. Needs one CUDA card.
"""

import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
import iuvl_tpu_torch.losses.criterion as crit_mod  # noqa: E402
from iuvl_tpu_torch.losses.criterion import CriterionConfig, SegCriterion  # noqa: E402
from iuvl_tpu_torch.losses.matcher import batched_hungarian  # noqa: E402
from iuvl_tpu_torch.models.xdecoder.model import SysLearnerConfig, build_syslearner  # noqa: E402
from iuvl_tpu_torch.ops.point_sample import given_draws  # noqa: E402
from iuvl_tpu_torch.train.train_step import split_seg_outputs  # noqa: E402

SHARE = "--share-points" in sys.argv


def main() -> None:
    smi = cs.device_phase()
    dev = torch.device("cuda", 0)
    cfg = SysLearnerConfig(**cs.TRAIN_CONFIG)
    plain16 = dataclasses.replace(cfg, attn_impl="plain")
    plain32 = dataclasses.replace(cfg, attn_impl="plain", dtype="float32")
    base = build_syslearner(cfg, device=dev, generator=torch.Generator().manual_seed(cs.SEED))
    weights = base.state_dict()
    shifted = cs.perturbed(weights, cs.SEED + 5, dev)
    del base
    variants = {  # name -> (config, weights, flat-core override, its fp32 path)
        "plain_fp32": (plain32, weights, None, None),
        "plain_bf16": (plain16, weights, None, "plain_fp32"),
        "kernels": (cfg, weights, None, "plain_fp32"),
        "kernels_flat_plain": (cfg, weights, "plain", "plain_fp32"),
        "plain_bf16_flat_kernels": (plain16, weights, "auto", "plain_fp32"),
        "control_fp32": (plain32, shifted, None, None),
        "control_bf16": (plain16, shifted, None, "control_fp32"),
        "kernels_wide": (dataclasses.replace(cfg, msdeform_impl="wide"), weights, None,
                         "plain_fp32"),
        "plain_bf16_wide": (dataclasses.replace(plain16, msdeform_impl="wide"), weights, None,
                            "plain_fp32"),
    }
    sample = crit_mod.uncertain_point_coords
    recorded, current = {}, {}

    def shared_points(logits, num_points, draw, name, *a, **k):
        key = (current["family"], name)
        if current["record"]:
            recorded[key] = sample(logits, num_points, draw, name, *a, **k)
        return recorded[key]

    if SHARE:
        crit_mod.uncertain_point_coords = shared_points
    crits = {imp: SegCriterion(CriterionConfig(num_classes=cs.N_CLASSES), impl=imp)
             for imp in ("auto", "plain")}
    batch, size = 2, cfg.img_size
    for seed_off, tag in ((12, "chip_smoke data"), (40, "other data"), (41, "third data")):
        rs = np.random.RandomState(cs.SEED + seed_off)
        text = torch.from_numpy(
            rs.randn(cs.N_CLASSES + 1, cfg.syslearner_dim).astype(np.float32)).to(dev)
        image, targets = cs.make_batch(rs, batch, size, dev)
        draws = cs.step_draws(torch.Generator(device=dev).manual_seed(cs.SEED + 3), 10, batch)
        res, assignments = {}, None
        recorded.clear()
        for name, (c, w, flat, ref) in variants.items():
            current.update(family=ref or name, record=ref is None)
            m = build_syslearner(c, device=dev)
            m.load_state_dict(w)
            for layer in m.pixel_decoder.layers if flat else ():
                layer.self_attn.attn_impl = flat
            acts = {}
            m.image_encoder.register_forward_hook(lambda mod, i, o: acts.__setitem__(
                "fpn", torch.cat([o[1][k].float().flatten() for k in sorted(o[1])]).detach()))
            m.pixel_decoder.register_forward_hook(lambda mod, i, o: acts.__setitem__(
                "pixdec", torch.cat([o[0].float().flatten()]
                                    + [t.float().flatten() for t in o[1]]).detach()))
            obj, _ = split_seg_outputs(m.forward_seg(image, text), c.num_queries)
            acts["pred_masks"] = obj["pred_masks"].float().detach().flatten()
            draw = given_draws(draws)
            costs, kept = crits[c.attn_impl].collect_costs(obj, targets, draw, cs.MATCH_POINTS)
            if assignments is None:
                assignments = batched_hungarian(costs)
            losses = crits[c.attn_impl].losses_from_assignments(kept, assignments, targets, draw)
            sum(losses.values()).backward()
            grads = {g: torch.cat([p.grad.float().flatten() for n, p in m.named_parameters()
                                   if n.startswith(g) and p.grad is not None])
                     for g in cs.GROUPS}
            res[name] = (acts, {k: v.detach().float() for k, v in losses.items()}, grads, ref)
            del m, obj, kept
            torch.cuda.empty_cache()
        print(f"== {tag}, shared points {SHARE}")
        keys = sorted(res["plain_fp32"][1])
        for name, (acts, losses, grads, ref) in res.items():
            if ref is None:
                continue
            ra, rl, rg, _ = res[ref]
            line = [f"{name:26s}"]
            line += [f"{k} {cs.rel_l2(acts[k], ra[k]):.3e}" for k in ("fpn", "pixdec", "pred_masks")]
            for term in cs.LOSS_TERMS:
                a = torch.stack([losses[k] for k in keys if k.startswith(term + "_")])
                b = torch.stack([rl[k] for k in keys if k.startswith(term + "_")])
                line.append(f"{term[10:]} {cs.rel_l2(a, b):.3e}")
            line += [f"g_{g[:5]} {cs.rel_l2(grads[g], rg[g]):.3e}" for g in cs.GROUPS]
            print(" | ".join(line), flush=True)
    print(smi)


if __name__ == "__main__":
    main()
