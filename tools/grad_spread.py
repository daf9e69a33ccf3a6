"""How far apart do sound bf16 paths of the seg train step land under one
encoder route? The step-0 gradients of the full-width SysLearner at batch
1 (chip_smoke.py's batch-1 data: the first step's batch, then the loss
gate's batches), at one set of weights (no update), through several bf16
paths, each held against its fp32 path by parameter group (relative L2),
per batch and pooled over the batches, as a ratio to the yardstick's (the
plain path the gate compares with).

    python3 tools/grad_spread.py --impl window [--batches 6]
    python3 tools/grad_spread.py --impl rowbias [--batches 16] [--parent _chip/parent] \
        [--data-seed S] [--forward-check]
    python3 tools/grad_spread.py --impl auto [--batches 16] [--parent _chip/parent] \
        [--variant NAME=MACRO ...] [--data-seed S] [--forward-check]

``window``: the kernels ('window': B13); B13's plain version
('window_plain', the yardstick); the unfused route's other rounding
points ('plain'). ``rowbias``: the kernels under 'rowbias' (B2b) and
'pallas_rp' (B14); with ``--parent``, the same two with a parent tree's
forward kernel in place of this tree's (its ``flash_attention_rowbias.cu``
built alone as tools/kernel_ab.py builds it; the backward is this tree's);
the unfused route's plain version ('plain', the yardstick). ``auto``: the
kernels under 'auto' (B11 on the global blocks); with ``--parent``, the
same with a parent tree's B11 (forward and backward) in place of this
tree's; with each ``--variant``, this tree's B11 source built with that
-D macro; 'plain' the yardstick. All: the control pair (the yardstick's
bf16 and fp32 on weights x (1 + 2^-9 u)). Each path's masks are scored at
the same points, with the first fp32 path's assignments; beside the
gradient groups, the three loss terms (their 10 layers' values, as
chip_smoke.py's loss gate reads them) pooled over the batches.
``--data-seed``: every batch drawn from that seed instead (a set disjoint
from the smoke's). ``--forward-check``: first, B2b's and B14's forward
(rowbias) or B11's (auto) on the first batch's own inputs against the
fp64 function (forward_check, b11_forward_check). Needs one CUDA card.
"""

import argparse
import contextlib
import dataclasses
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

TOOLS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(TOOLS))
sys.path.insert(0, TOOLS)

import chip_smoke as cs  # noqa: E402
from iuvl_tpu_torch.losses.criterion import CriterionConfig, SegCriterion  # noqa: E402
from iuvl_tpu_torch.losses.matcher import batched_hungarian  # noqa: E402
from iuvl_tpu_torch.models.xdecoder.model import SysLearnerConfig, build_syslearner  # noqa: E402
from iuvl_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402
from iuvl_tpu_torch.ops.point_sample import given_draws  # noqa: E402
from iuvl_tpu_torch.train.train_step import split_seg_outputs  # noqa: E402


def cs_root() -> Path:
    return Path(cs.__file__).resolve().parent


def parent_forward(lib, kind: str):
    """A stand-in for the wrapper ``flash_{kind}_fwd`` that calls the
    parent's C entry."""
    def fwd(q, k, v, relh, relw, *rest):
        b, heads, n, d = q.shape
        o = torch.empty_like(v)
        lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
        ins = (q, k, v, relh, relw) + (rest[:2] if kind == "relpos" else ())
        err = getattr(lib, f"iuvl_{kind}_fwd")(
            *(t.data_ptr() for t in ins + (o, lse)), b * heads, n, d, relh.shape[-1],
            relw.shape[-1], torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"parent iuvl_{kind}_fwd: CUDA error {err}"
        return o, lse
    return fwd


def b11_stand_ins(lib) -> dict:
    """Stand-ins for the B11 wrappers ``flash_attention_fwd`` / ``_bwd``
    that call a separately built B11 library (a parent's or a variant's)."""
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def fwd(q, k, v):
        bh, n, pad = fa._require_flash("b11", q, k, v)
        qp, kp = fa._pad_last(q, pad), fa._pad_last(k, pad)
        o = torch.empty_like(v)
        lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
        err = lib.iuvl_flash_fwd(*(t.data_ptr() for t in (qp, kp, v, o, lse)), bh, n, pad,
                                 v.shape[-1], stream())
        assert err == 0, f"iuvl_flash_fwd: CUDA error {err}"
        return o, lse

    def bwd(q, k, v, o, lse, do):
        bh, n, pad = fa._require_flash("b11", q, k, v)
        qp, kp = fa._pad_last(q, pad), fa._pad_last(k, pad)
        delta = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
        dq, dk, dv = torch.empty_like(qp), torch.empty_like(kp), torch.empty_like(v)
        err = lib.iuvl_flash_bwd(*(t.data_ptr() for t in (qp, kp, v, o, lse, do, delta, dq, dk,
                                                          dv)), bh, n, pad, v.shape[-1], stream())
        assert err == 0, f"iuvl_flash_bwd: CUDA error {err}"
        return dq[..., :q.shape[-1]], dk[..., :q.shape[-1]], dv

    fwd.launches = bwd.launches = 0
    return {"flash_attention_fwd": fwd, "flash_attention_bwd": bwd}


def b11_forward_check(model, image, text, libs: dict) -> None:
    """B11's forward on the path's own inputs: every call of the first
    batch's forward under 'auto' (autograd recording: the training route)
    recorded, then this tree's kernel, each of ``libs`` (name -> library)
    and the plain version held against the fp64 function of the same bf16
    inputs (o: relative L2; lse: relative L2 and largest error), and the
    share of o's elements whose bits differ from this tree's."""
    calls, wrapper = [], fa.flash_attention_fwd

    def record(*a):
        calls.append(tuple(x.detach().clone() for x in a))
        return wrapper(*a)

    record.launches = 0
    with torch.enable_grad(), cs._patched(fa, "flash_attention_fwd", record):
        model.forward_seg(image, text)
    acc = {}
    for q, k, v in calls:
        s = q.double() @ k.double().transpose(-1, -2)
        ref = (torch.softmax(s, -1) @ v.double(), torch.logsumexp(s, -1))
        del s
        outs = {"kernel": fa.flash_attention_fwd(q, k, v),
                "plain": fa.flash_attention_fwd_plain(q, k, v),
                **{name: b11_stand_ins(lib)["flash_attention_fwd"](q, k, v)
                   for name, lib in libs.items()}}
        for name, out in outs.items():
            for x, got, want in zip(("o", "lse"), out, ref):
                e = acc.setdefault(f"{name} {x}", [0.0, 0.0, 0.0])
                diff = got.double() - want
                e[0] += float((diff ** 2).sum())
                e[1] += float((want ** 2).sum())
                e[2] = max(e[2], float(diff.abs().max()))
            if name != "kernel":
                b = acc.setdefault(f"{name} o bits differ from the kernel's", [0, 0])
                b[0] += int((out[0] != outs["kernel"][0]).sum())
                b[1] += out[0].numel()
        del ref, outs
    print(f"forward check auto (B11), {len(calls)} calls of batch 0 "
          f"({tuple(calls[0][0].shape)}), rel L2 to the fp64 function: " + "; ".join(
              f"{name} {e[0] / e[1]:.4e}" if len(e) == 2 else
              f"{name} {e[0] ** 0.5 / e[1] ** 0.5:.4e} (largest {e[2]:.3e})"
              for name, e in acc.items()), flush=True)
    torch.cuda.empty_cache()


def exact_forward(q, k, v, relh, relw, eh, ew):
    """o and lse of softmax(q k^T + relh eh + relw ew) v in fp64 on the
    bf16 inputs, a batch entry at a time."""
    o = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    lse = torch.empty(q.shape[:-1], dtype=torch.float64, device=q.device)
    eh, ew = eh.double(), ew.double()
    for i in range(q.shape[0]):
        s = (q[i].double() @ k[i].double().transpose(-1, -2) + relh[i].double() @ eh
             + relw[i].double() @ ew)
        lse[i] = torch.logsumexp(s, -1)
        o[i] = torch.softmax(s, -1) @ v[i].double()
    return o, lse


def forward_check(models: dict, image, text, lib) -> None:
    """B2b's and B14's forward on the path's own inputs: every call of the
    first batch's forward under 'rowbias' and 'pallas_rp' recorded, then
    this tree's kernel, the parent's (``lib``, when given) and the plain
    version held against the fp64 function of the same bf16 inputs (o:
    relative L2; lse: relative L2 and largest error), and this tree's o
    against the parent's (relative L2, share of elements whose bits
    differ), pooled over the windowed calls (N <= 256) and the global ones."""
    from iuvl_tpu_torch.ops.rel_pos_attention import onehot_expanders

    for impl, kind in (("rowbias", "rowbias"), ("pallas_rp", "relpos")):
        wrapper = getattr(fa, f"flash_{kind}_fwd")
        calls = []

        def record(*a, wrapper=wrapper, calls=calls):
            calls.append(tuple(x.clone() if torch.is_tensor(x) else x for x in a))
            return wrapper(*a)

        record.launches = 0  # the wrapper counts its launches under its own name

        with torch.no_grad(), cs._patched(fa, f"flash_{kind}_fwd", record):
            models[impl].forward_seg(image, text)
        acc = {}  # (shape, quantity) -> [sum |x - ref|^2, sum |ref|^2, largest |x - ref|]
        for a in calls:
            q, k, v, relh, relw = a[:5]
            h, w = relh.shape[-1], relw.shape[-1]
            eh, ew = (a[5], a[6]) if kind == "relpos" else onehot_expanders(
                (h, w), torch.bfloat16, q.device)
            ref = exact_forward(q, k, v, relh, relw, eh, ew)
            outs = {"kernel": wrapper(*a[:7] if kind == "relpos" else a[:6]),
                    "plain": fa.flash_rowbias_fwd_plain(q, k, v, relh, relw, w,
                                                        *((eh, ew) if kind == "relpos" else ()))}
            if lib is not None:
                outs["parent"] = parent_forward(lib, kind)(*a[:7] if kind == "relpos" else a[:5])
            shape = "windowed" if q.shape[-2] <= 256 else "global"
            pairs = [(f"{name} {x}", got, want) for name, out in outs.items()
                     for x, got, want in zip(("o", "lse"), out, ref)]
            if "parent" in outs:
                pairs.append(("kernel o to parent o", outs["kernel"][0], outs["parent"][0]))
                bits = acc.setdefault((shape, "bits"), [0, 0, 0])
                bits[0] += int((outs["kernel"][0] != outs["parent"][0]).sum())
                bits[1] += outs["kernel"][0].numel()
            for name, got, want in pairs:
                e = acc.setdefault((shape, name), [0.0, 0.0, 0.0])
                diff = got.double() - want.double()
                e[0] += float((diff ** 2).sum())
                e[1] += float((want.double() ** 2).sum())
                e[2] = max(e[2], float(diff.abs().max()))
            del ref, outs
        for shape in ("windowed", "global"):
            n = sum(1 for a in calls if (a[0].shape[-2] <= 256) == (shape == "windowed"))
            line = [f"{name} {e[0] ** 0.5 / e[1] ** 0.5:.4e} (largest {e[2]:.3e})"
                    for (sh, name), e in acc.items() if sh == shape and name != "bits"]
            if (shape, "bits") in acc:
                b = acc[(shape, "bits")]
                line.append(f"o elements whose bits differ, kernel / parent {b[0] / b[1]:.4e}")
            print(f"forward check {impl} ({kind}), {shape}, {n} calls of batch 0, rel L2 to "
                  f"the fp64 function: " + "; ".join(line), flush=True)
        del calls
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--impl", choices=("window", "rowbias", "auto"), required=True)
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--parent", type=Path,
                    help="rowbias, auto: a tree holding the parent's csrc")
    ap.add_argument("--variant", action="append", default=[],
                    help="auto: NAME=MACRO[,MACRO...], this tree's B11 built with -DMACRO")
    ap.add_argument("--data-seed", type=int,
                    help="draw every batch from this seed (a set disjoint from the smoke's)")
    ap.add_argument("--forward-check", action="store_true",
                    help="hold the forwards to fp64 on the first batch's inputs")
    args = ap.parse_args()
    smi = cs.device_phase()
    dev = torch.device("cuda", 0)
    ref = "window_plain" if args.impl == "window" else "plain"
    cfg = SysLearnerConfig(**{**cs.TRAIN_CONFIG, "attn_impl": ref})
    ref32 = dataclasses.replace(cfg, dtype="float32")
    base = build_syslearner(cfg, device=dev, generator=torch.Generator().manual_seed(cs.SEED))
    weights = base.state_dict()
    shifted = cs.perturbed(weights, cs.SEED + 5, dev)
    del base
    yard, fp32 = f"{ref}_bf16", f"{ref}_fp32"
    paths = {fp32: (ref32, weights, None)}  # name -> (config, weights, its fp32 path)
    patches = {}  # name -> {wrapper: its stand-in}
    kernels = {"window": ("window",), "auto": ("auto",)}.get(args.impl, ("rowbias", "pallas_rp"))
    for impl in kernels:
        paths[impl] = (dataclasses.replace(cfg, attn_impl=impl), weights, fp32)
    lib = None
    if args.parent and args.impl == "rowbias":
        import kernel_ab

        lib = kernel_ab.compile_source(args.parent.resolve(), Path(tempfile.mkdtemp()), "rowbias")
        for impl, kind in (("rowbias", "rowbias"), ("pallas_rp", "relpos")):
            paths[f"{impl}_parent_fwd"] = (paths[impl][0], weights, fp32)
            patches[f"{impl}_parent_fwd"] = {f"flash_{kind}_fwd": parent_forward(lib, kind)}
    b11_libs = {}  # auto: name -> a separately built B11 library
    if args.impl == "auto":
        import kernel_ab

        work = Path(tempfile.mkdtemp())
        sigs = {fn: kernel_ab.build.SIGNATURES[fn] for fn in kernel_ab.ENTRIES["flash"]}
        if args.parent:
            b11_libs["parent_b11"] = kernel_ab.compile_source(args.parent.resolve(), work, "flash")
        for spec in args.variant:
            name, macro = spec.split("=", 1)
            b11_libs[name] = kernel_ab.compile_source(cs_root(), work, "flash", name, sigs,
                                                      tuple(macro.split(",")))
        for name, blib in b11_libs.items():
            paths[f"auto_{name}"] = (paths["auto"][0], weights, fp32)
            patches[f"auto_{name}"] = b11_stand_ins(blib)
    paths[yard] = (cfg, weights, fp32)
    if args.impl == "window":
        paths["plain_bf16"] = (dataclasses.replace(cfg, attn_impl="plain"), weights, fp32)
    paths.update({"control_fp32": (ref32, shifted, None),
                  "control_bf16": (cfg, shifted, "control_fp32")})
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
    if args.data_seed is not None:
        data = []
        gate_rs = np.random.RandomState(args.data_seed)
        gate_gen = torch.Generator(device=dev).manual_seed(args.data_seed + 1)
    data += [(*cs.make_batch(gate_rs, 1, cfg.img_size, dev), cs.step_draws(gate_gen, 10, 1))
             for _ in range(args.batches - len(data))]
    if args.forward_check and args.impl == "rowbias":
        forward_check(models, data[0][0], text, lib)
    if args.forward_check and args.impl == "auto":
        b11_forward_check(models["auto"], data[0][0], text, b11_libs)
    groups = cs.GROUPS
    # pooled rel L2 over the batches: sqrt(sum |g - r|^2) / sqrt(sum |r|^2)
    sq = {name: {g: [0.0, 0.0] for g in groups} for name, (_, _, r) in paths.items() if r}
    # each path's loss terms, their 10 layers' values a batch
    loss_vals = {name: {term: [] for term in cs.LOSS_TERMS} for name in paths}
    for i, (image, targets, draws) in enumerate(data):
        grads, assignments = {}, None
        for name, m in models.items():
            crit = SegCriterion(CriterionConfig(num_classes=cs.N_CLASSES),
                                impl=m.cfg.kernels_impl)
            m.zero_grad(set_to_none=True)
            draw = given_draws(draws)
            with contextlib.ExitStack() as stack:
                for wrapper, stand_in in patches.get(name, {}).items():
                    stack.enter_context(cs._patched(fa, wrapper, stand_in))
                obj, _ = split_seg_outputs(m.forward_seg(image, text), m.cfg.num_queries)
                costs, kept = crit.collect_costs(obj, targets, draw, cs.MATCH_POINTS)
                if assignments is None:  # the first fp32 path's
                    assignments = batched_hungarian(costs)
                losses = crit.losses_from_assignments(kept, assignments, targets, draw)
                for term in cs.LOSS_TERMS:
                    loss_vals[name][term] += [float(v.detach()) for k, v in sorted(losses.items())
                                              if k.startswith(term + "_")]
                sum(losses.values()).backward()
            del losses
            grads[name] = {g: torch.cat([p.grad.float().flatten() for n, p in m.named_parameters()
                                         if n.startswith(g) and p.grad is not None])
                           for g in groups}
            m.zero_grad(set_to_none=True)
            torch.cuda.empty_cache()
        if i == 0:  # the first step's batch alone, as chip_smoke.py's one-batch gate reads it
            for term in cs.LOSS_TERMS:
                last = {name: torch.tensor(v[term][-10:]) for name, v in loss_vals.items()}
                errs = {name: cs.rel_l2(last[name], last[paths[name][2]]) for name in sq}
                print(f"batch 0 alone, loss {term}: ratio to {yard} " + "; ".join(
                    f"{name} {e / errs[yard]:.3f}" for name, e in errs.items()), flush=True)
        base = [cs.rel_l2(grads[yard][g], grads[fp32][g]) for g in groups]
        line = []
        for name, acc in sq.items():
            r = paths[name][2]
            for g in groups:
                acc[g][0] += float(torch.linalg.vector_norm(grads[name][g] - grads[r][g]) ** 2)
                acc[g][1] += float(torch.linalg.vector_norm(grads[r][g]) ** 2)
            ratios = [cs.rel_l2(grads[name][g], grads[r][g]) / y for g, y in zip(groups, base)]
            line.append(f"{name} " + "/".join(f"{x:.3f}" for x in ratios))
        print(f"batch {i}: gradient groups {groups}, rel L2 to fp32 over {yard}'s: "
              + "; ".join(line), flush=True)
        del grads
    for term in cs.LOSS_TERMS:
        vec = {name: torch.tensor(v[term], dtype=torch.float64) for name, v in loss_vals.items()}
        errs = {name: cs.rel_l2(vec[name], vec[paths[name][2]]) for name in sq}
        print(f"pooled over {len(data)} batches, loss {term}: ratio to {yard} " + "; ".join(
            f"{name} {e / errs[yard]:.3f}" for name, e in errs.items()) + " (rel L2 "
            + "; ".join(f"{name} {e:.3e}" for name, e in errs.items()) + ")", flush=True)
    pooled = {name: [(a / b) ** 0.5 for a, b in acc.values()] for name, acc in sq.items()}
    for name, errs in pooled.items():
        print(f"pooled over {len(data)} batches, {name}: rel L2 "
              + "/".join(f"{e:.3e}" for e in errs) + f"; ratio to {yard} "
              + "/".join(f"{e / y:.3f}" for e, y in zip(errs, pooled[yard])), flush=True)
    print(smi)


if __name__ == "__main__":
    main()
