"""The port's joint step-1 train step against the JAX package's on the CPU:
the language and grounding losses (values and gradients), the two repairs
that training needs (C10: the grounding queries' positions keep their
gradient; C11: SAM's mask decoder trains through B4-B6), one
``make_joint_train_step`` step with every stream on (each loss term, the
matchings, every gradient, every parameter after the update), and the
step-1 extras builders.

Models: the tiny config of ``tests/test_torch_xdecoder.py`` (SAM
``tiny_test``, 64^2 images, SYSLEARNER_DIM 32) with a text tower of width
32, 2 layers, 4 heads, CLIP's vocabulary (HashWord ids are in range) and 77
caption slots, and ``retrieval_ensemble`` on; fp32; random weights from
numpy, bridged. The joint step: batch 2 seg images with 3 gt masks each,
6 phrases and 5 grounding sentences of 8 tokens, 3 spatial prompts, a VLP
batch of 2 images, MATCH_POINTS 64, the criterion on the last KEPT layers
and the language losses on the last 2. JAX's keys are replayed in the port
as given draws (:func:`joint_draws`, the names of
``make_joint_train_step``'s docstring). Tolerances: rel 1e-5 for the loss
functions, the JAX suite's fp32 bar 1e-4 elsewhere (gradients relative to
each tensor's largest entry), and the parameters after the update as in
``tests/test_torch_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import iuvl_tpu.losses.matcher as jmatcher
from iuvl_tpu.data import step1 as jstep1
from iuvl_tpu.data.tokenizer import build_tokenizer as j_tokenizer
from iuvl_tpu.data.visual_sampler import ShapeSampler as JShapeSampler
from iuvl_tpu.losses import grounding as jg
from iuvl_tpu.losses import language as jl
from iuvl_tpu.losses.criterion import CriterionConfig as JCriterionConfig
from iuvl_tpu.losses.criterion import SegCriterion as JSegCriterion
from iuvl_tpu.losses.criterion import SegTargets as JSegTargets
from iuvl_tpu.models.sam import build as jsb
from iuvl_tpu.models.xdecoder import unified_decoder as jud
from iuvl_tpu.models.xdecoder.model import SysLearner as JSysLearner
from iuvl_tpu.models.xdecoder.model import SysLearnerConfig as JConfig
from iuvl_tpu.train.optimizer import build_optimizer
from iuvl_tpu.train.train_step import make_joint_train_step as j_make_joint_train_step
from iuvl_tpu_torch.data import step1 as tstep1
from iuvl_tpu_torch.data.tokenizer import build_tokenizer as t_tokenizer
from iuvl_tpu_torch.data.visual_sampler import ShapeSampler as TShapeSampler
from iuvl_tpu_torch.losses import grounding as tg
from iuvl_tpu_torch.losses import language as tl
from iuvl_tpu_torch.losses.criterion import CriterionConfig, SegCriterion, SegTargets
from iuvl_tpu_torch.models.sam import build as tsb
from iuvl_tpu_torch.models.sam import convert as sam_convert
from iuvl_tpu_torch.models.xdecoder import convert
from iuvl_tpu_torch.models.xdecoder import unified_decoder as tud
from iuvl_tpu_torch.models.xdecoder.model import SysLearner, SysLearnerConfig
from iuvl_tpu_torch.train.optimizer import Optimizer
from iuvl_tpu_torch.train.train_step import TrainState, make_joint_train_step
from tests.test_torch_xdecoder import N_CLASSES, TINY, TINY_SAM, bridged_params

JOINT = dict(TINY, contxt_len=77, text_width=32, text_layers=2, text_heads=4, vocab_size=49408,
             retrieval_ensemble=True)
POINTS = 64  # MATCH_POINTS and the criterion's TRAIN_NUM_POINTS
KEPT = 2  # the criterion's top_mask_layers: each kept layer adds to JAX's compile
LANG_LAYERS = 2  # language_loss_layers
TEXT_LEN = 8
MS = 16  # the gt masks' side: the image's at mask stride 4
LR, WD = 1e-3, 0.5
RELU_MARGIN = 2e-6


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _tt(x):
    """numpy -> torch, keeping integer and bool dtypes."""
    x = np.asarray(x)
    return torch.from_numpy(x.astype(np.float32) if x.dtype.kind == "f" else x)


def _grad_tol(ref, rel: float = 1e-4) -> float:
    return rel * max(float(np.abs(ref).max()), 0.1)


def _grad_close(port, ref, name, rel: float = 1e-4):
    assert port is not None, f"{name}: no gradient"
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(port.detach().numpy(), ref, rtol=rel, atol=_grad_tol(ref, rel),
                               err_msg=name)


@pytest.fixture(scope="module")
def models():
    """(JAX model, its params (numpy), the port model with the same weights,
    the port config)."""
    jsb.SAM_VARIANTS["tiny_test"] = TINY_SAM
    tsb.SAM_VARIANTS["tiny_test"] = TINY_SAM
    jm = JSysLearner(cfg=JConfig(**JOINT, attn_impl="auto", msdeform_impl="auto"))
    cfg = SysLearnerConfig(**JOINT)
    params = bridged_params(cfg)
    tm = SysLearner(cfg)
    tm.load_state_dict(convert.flax_to_state_dict(params, cfg), strict=True)
    return jm, params, tm, cfg


# -- (a) the loss functions ---------------------------------------------------

def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _uncertain_draws(rng, name, n, points=POINTS):
    """JAX ``uncertain_point_coords``' two draws from ``rng``, by the port's
    names."""
    r1, r2 = jax.random.split(rng)
    return {f"{name}/over": jax.random.uniform(r1, (n, 3 * points, 2)),
            f"{name}/rand": jax.random.uniform(r2, (n, points - int(0.75 * points), 2))}


def _grounding_draws(rng, name, b, g, points=POINTS):
    """``grounding_cost`` / ``grounding_losses``' draws from ``rng``."""
    _, r_pts, r_loss = jax.random.split(rng, 3)
    return {f"{name}/pts": jax.random.uniform(r_pts, (b, points // 4, 2)),
            **_uncertain_draws(r_loss, name, b * g, points)}


def _given(draws):
    from iuvl_tpu_torch.ops.point_sample import given_draws
    return given_draws({k: _t(v) for k, v in draws.items()})


def _grounding_inputs(rs, b=2, q=10, g=5, d=16):
    masks = (rs.rand(b, g, MS, MS) > 0.6).astype(np.float32)
    groups = np.tile(np.eye(g, dtype=np.float32), (b, 1, 1))
    groups[0, 1, 3] = groups[0, 3, 1] = 1.0  # phrases 1 and 3 of image 0 alike
    valid = np.array([[True, True, True, True, False], [True, False, True, True, True]])
    return dict(pred_gmasks=rs.randn(b, q, MS, MS).astype(np.float32) * 3,
                pred_gtexts=rs.randn(b, q, d).astype(np.float32),
                masks=masks, class_embs=rs.randn(b, g, d).astype(np.float32),
                groups=groups, valid=valid, task_weight=np.array([2.0, 0.5], np.float32))


def _gt(x, mod):
    """GroundingTargets of the package ``mod`` (``jg`` or ``tg``)."""
    conv = jnp.asarray if mod is jg else _tt
    return mod.GroundingTargets(masks=conv(x["masks"]), class_embs=conv(x["class_embs"]),
                                group_matrix=conv(x["groups"]), valid=conv(x["valid"]),
                                task_weight=conv(x["task_weight"]))


def _case_language(name):
    rs = np.random.RandomState(3)
    n, d = 6, 16
    img, txt = _unit(rs.randn(n, d)).astype(np.float32), _unit(rs.randn(n, d)).astype(np.float32)
    valid = np.array([True, True, False, True, True, False])
    group = np.eye(n, dtype=np.float32)
    group[0, 4] = group[4, 0] = 1.0
    ls = np.float32(2.0)
    if name == "soft_cross_entropy":
        soft = np.abs(rs.randn(n, n)).astype(np.float32)
        soft /= soft.sum(-1, keepdims=True)
        return (lambda x: jl.soft_cross_entropy(x, soft),
                lambda x: tl.soft_cross_entropy(x, _t(soft)), [rs.randn(n, n).astype(np.float32)])
    if name == "vl_similarity":
        w = rs.randn(n, n).astype(np.float32)
        return (lambda a, b, s: (jl.vl_similarity(a, b, s) * w).sum(),
                lambda a, b, s: (tl.vl_similarity(a, b, s) * _t(w)).sum(), [img, txt, ls])
    if name == "contrastive_loss":
        return (lambda a, b, s: jl.contrastive_loss(a, b, s, valid=valid),
                lambda a, b, s: tl.contrastive_loss(a, b, s, valid=torch.from_numpy(valid)),
                [img, txt, ls])
    if name == "ql_multi_contrastive_loss":
        return (lambda a, b, s: jl.ql_multi_contrastive_loss(a, b, group, s, valid=valid),
                lambda a, b, s: tl.ql_multi_contrastive_loss(a, b, _t(group), s,
                                                             valid=torch.from_numpy(valid)),
                [img, txt, ls])
    raise KeyError(name)


def _case_grounding(name):
    rs = np.random.RandomState(4)
    x = _grounding_inputs(rs)
    ls = np.float32(2.0)
    rng = jax.random.PRNGKey(9)
    b, q = x["pred_gmasks"].shape[:2]
    g = x["masks"].shape[1]
    cfg_j, cfg_t = jg.GroundingConfig(num_points=POINTS), tg.GroundingConfig(num_points=POINTS)
    draw = _given(_grounding_draws(rng, "g", b, g))
    if name == "grounding_cost":
        return (lambda: jg.grounding_cost(rng, x["pred_gmasks"], x["pred_gtexts"], _gt(x, jg),
                                          ls, cfg_j),
                lambda: tg.grounding_cost(draw, "g", _t(x["pred_gmasks"]), _t(x["pred_gtexts"]),
                                          _gt(x, tg), _t(ls), cfg_t), [])
    if name == "grounding_losses":
        assigned = np.stack([rs.permutation(q)[:g] for _ in range(b)]).astype(np.int32)
        return (lambda m, t, s: jg.grounding_losses(rng, m, t, _gt(x, jg), s, cfg_j,
                                                    assigned=jnp.asarray(assigned)),
                lambda m, t, s: tg.grounding_losses(draw, "g", m, t, _gt(x, tg), s, cfg_t,
                                                    assigned=torch.from_numpy(assigned).long()),
                [x["pred_gmasks"], x["pred_gtexts"], ls])
    if name == "spatial_losses":
        sdraw = _given(_uncertain_draws(rng, "s", b * g))
        return (lambda m: jg.spatial_losses(rng, m, x["masks"], x["valid"], num_points=POINTS),
                lambda m: tg.spatial_losses(sdraw, "s", m, _t(x["masks"]),
                                            torch.from_numpy(x["valid"]), num_points=POINTS),
                [x["pred_gmasks"][:, :g]])
    raise KeyError(name)


def _case_vlp(name):
    rs = np.random.RandomState(5)
    b, q, d, t, p = 2, 10, 16, 3, 4
    ls = np.float32(2.0)
    if name == "caption_loss":
        assigned = np.stack([rs.permutation(q)[:t] for _ in range(b)]).astype(np.int32)
        labels = rs.randint(0, N_CLASSES, (b, t)).astype(np.int32)
        tvalid = np.array([[True, False, True], [True, True, True]])
        pvalid = np.array([[True, True, True, False], [True, True, False, False]])
        groups = np.tile(np.eye(p, dtype=np.float32), (b, 1, 1))
        groups[1, 0, 1] = groups[1, 1, 0] = 1.0
        args = [rs.randn(b, q, d).astype(np.float32),
                _unit(rs.randn(N_CLASSES + 1, d)).astype(np.float32),
                rs.randn(b, p, d).astype(np.float32), ls]
        return (lambda v, c, ph, s: jg.caption_loss(None, v, assigned, labels, tvalid, c, ph,
                                                    pvalid, groups, s),
                lambda v, c, ph, s: tg.caption_loss(
                    v, torch.from_numpy(assigned).long(), torch.from_numpy(labels), _tt(tvalid),
                    c, ph, _tt(pvalid), _t(groups), s), args)
    if name == "captioning_loss":
        ids = rs.randint(0, 50, (b, 7)).astype(np.int32)
        mask = (np.arange(7)[None] < np.array([[5], [7]])).astype(np.int32)
        return (lambda c, tab: jg.captioning_loss(c, tab, ids, mask),
                lambda c, tab: tg.captioning_loss(c, tab, _tt(ids), _tt(mask)),
                [rs.randn(b, 7, d).astype(np.float32), rs.randn(50, d).astype(np.float32)])
    if name == "retrieval_loss":
        return (jg.retrieval_loss, tg.retrieval_loss,
                [rs.randn(3, d).astype(np.float32), rs.randn(3, d).astype(np.float32), ls])
    raise KeyError(name)


LOSS_CASES = {**{n: _case_language for n in ("soft_cross_entropy", "vl_similarity",
                                             "contrastive_loss", "ql_multi_contrastive_loss")},
              **{n: _case_grounding for n in ("grounding_cost", "grounding_losses",
                                              "spatial_losses")},
              **{n: _case_vlp for n in ("caption_loss", "captioning_loss", "retrieval_loss")}}


def _terms(out):
    return out if isinstance(out, dict) else {"value": out}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_loss_function_matches_jax(name):
    """Each loss function of ``losses/language.py`` and
    ``losses/grounding.py`` against JAX's on the same inputs and points:
    its value(s), and the gradient of their sum with respect to every
    differentiable input (the preds, the embeddings, ``logit_scale``);
    ``grounding_cost`` (no gradient) by value; ``caption_loss`` with its
    own phrase matching."""
    jfn, tfn, args = LOSS_CASES[name](name)
    wrt = tuple(range(len(args)))
    if wrt:  # one compile for the values and the gradients
        ref, jgrads = jax.jit(jax.value_and_grad(
            lambda *a: (sum(_terms(jfn(*a)).values()), _terms(jfn(*a))), argnums=wrt,
            has_aux=True))(*args)
        ref = ref[1]
    else:
        ref, jgrads = _terms(jax.jit(jfn)()), ()
    targs = [_t(a).requires_grad_() for a in args]
    got = _terms(tfn(*targs))
    assert sorted(got) == sorted(ref), name
    for key, r in ref.items():
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5 * max(float(np.abs(np.asarray(r)).max()), 1e-3),
                                   err_msg=f"{name} {key}")
    if wrt:
        grads = torch.autograd.grad(sum(got.values()), targs)
        for i, (g, r) in enumerate(zip(grads, jgrads)):
            _grad_close(g, r, f"{name} d/d arg {i}", rel=1e-5)


# -- (b) C10: the grounding queries' positions keep their gradient ------------

DEC = dict(hidden_dim=32, dim_proj=32, num_queries=11, contxt_len=7, nheads=4,
           dim_feedforward=64, mask_dim=32, num_rounds=1)


def test_grounding_positions_carry_gradient_as_in_jax():
    """C10: a 3-layer unified decoder's ``seg_grounding`` outputs (every
    layer's masks and caption embeddings, weighted) differentiated with
    respect to the grounding tokens match ``jax.grad`` of the same function:
    JAX cuts the tokens' content from the gradient, not their positions.
    Both ``seg`` and ``seg_grounding`` give ``pred_captions`` on the final
    and every aux layer under autograd."""
    from tests.test_torch_vl_eval import _randomize_

    rs = np.random.RandomState(6)
    dec = tud.UnifiedDecoder(**DEC)
    _randomize_(dec, rs)
    with torch.no_grad():
        for t in (dec.query_feat, dec.query_embed, dec.level_embed):
            t.copy_(_t(rs.randn(*t.shape)))
    jp = {"params": sam_convert.to_flax(
        dec.state_dict(), convert.predictor_entries(num_layers=3, prefix="", flax=()))}
    ms = [rs.randn(1, s, s, 32).astype(np.float32) for s in (4, 8, 16)]
    mf = rs.randn(1, 16, 16, 32).astype(np.float32)
    text = _unit(rs.randn(N_CLASSES + 1, 32)).astype(np.float32)
    gtok = rs.randn(1, 12, 32).astype(np.float32)
    gvalid = np.arange(12)[None] < 9
    n_rows = 2 * DEC["num_queries"] - 1
    w_mask = rs.randn(4, 1, n_rows, 16, 16).astype(np.float32)
    w_cap = rs.randn(4, 1, n_rows, 32).astype(np.float32)
    jdec = jud.UnifiedDecoder(**DEC)

    def scalar(layers, wm, wc):
        return sum((o["pred_masks"] * m).sum() + (o["pred_captions"] * c).sum()
                   for o, m, c in zip(layers, wm, wc))

    @jax.jit
    def jax_grad(p, g):
        def f(g):
            out = jdec.apply(p, ms, mf, text_embeddings=text, task="seg_grounding",
                             grounding_tokens=g, grounding_valid=gvalid, logit_scale=2.0,
                             training=True)
            return scalar(out["aux_outputs"] + [out], w_mask, w_cap)
        return jax.grad(f)(g)

    ref = np.asarray(jax_grad(jp, gtok))
    g = _t(gtok).requires_grad_()
    tms, tmf = [_t(x) for x in ms], _t(mf)
    out = dec(tms, tmf, text_embeddings=_t(text), task="seg_grounding", grounding_tokens=g,
              grounding_valid=torch.from_numpy(gvalid), logit_scale=torch.tensor(2.0))
    seg = dec(tms, tmf, text_embeddings=_t(text), task="seg", logit_scale=torch.tensor(2.0))
    for o in (out, seg):
        assert all(a["pred_captions"] is not None and a["pred_captions"].requires_grad
                   for a in o["aux_outputs"] + [o]) and len(o["aux_outputs"]) == 3
    (got,) = torch.autograd.grad(scalar(out["aux_outputs"] + [out], _t(w_mask), _t(w_cap)), [g])
    assert float(np.abs(ref[0, 9:]).max()) == 0.0  # padded tokens are no keys and no content
    _grad_close(got, ref, "d/d grounding_tokens")


# -- (c) C11: SAM's mask decoder trains through B4-B6 ---------------------------

def test_sam_decode_gradients_reach_every_decoder_parameter_as_in_jax(models):
    """C11: ``decode_prompts`` (3 one-point prompts on a batch-1 image
    embedding, the spatial stream's shape) under autograd: the gradient of
    its masks, ``hyper_in`` and upscaled embedding (weighted) with respect to
    every mask-decoder and prompt-encoder parameter and to the embedding
    matches ``jax.grad`` of JAX's ``decode_prompts``; the parameters JAX's
    gradient does not reach get zero or none."""
    jm, params, tm, cfg = models
    rs = np.random.RandomState(7)
    emb = rs.randn(1, 4, 4, 256).astype(np.float32)
    points = (rs.rand(3, 1, 2) * 64).astype(np.float32)
    labels = np.ones((3, 1), np.int32)
    keys = ("masks", "hyper_in", "upscaled_embedding")
    shapes = {"masks": (3, 4, 16, 16), "hyper_in": (3, 4, 32),
              "upscaled_embedding": (3, 16, 16, 32)}
    weights = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}

    def scalar(out, w):
        return sum((out[k] * w[k]).sum() for k in keys)

    @jax.jit
    def jax_grads(p, e):
        return jax.grad(lambda p, e: scalar(jm.apply(p, e, points=points, labels=labels,
                                                     method=JSysLearner.decode_prompts),
                                            weights), argnums=(0, 1))(p, e)

    ref, ref_emb = jax_grads(params, emb)
    ref = convert.flax_to_state_dict(ref, cfg)
    tm.zero_grad(set_to_none=True)
    e = _t(emb).requires_grad_()
    out = tm.decode_prompts(e, points=_t(points), labels=torch.from_numpy(labels))
    scalar(out, {k: _t(w) for k, w in weights.items()}).backward()
    _grad_close(e.grad, ref_emb, "d/d sam_embedding")
    checked = 0
    for name, p in tm.named_parameters():
        if not name.startswith(("mask_decoder.", "prompt_encoder.")):
            continue
        r = ref[name].numpy()
        if not np.abs(r).max():
            assert p.grad is None or not bool(p.grad.abs().max()), name
            continue
        _grad_close(p.grad, r, name)
        checked += 1
    # Every attention projection of the two-way transformer is reached.
    assert checked >= 60, checked
    tm.zero_grad(set_to_none=True)


def test_forward_spatial_train_matches_jax(models):
    """The spatial-prompt stream's forward, ``forward_spatial_train``, at
    batch 2 (SAM's embedding repeated a prompt) against JAX's on the same
    images and clicks (a pad prompt among them); at batch 1 (the embedding
    broadcast lazily) it gives the first image's rows."""
    jm, params, tm, _ = models
    rs = np.random.RandomState(8)
    images = (rs.rand(2, 64, 64, 3) * 255).astype(np.float32)
    points = (rs.rand(2, 3, 2) * 64).astype(np.float32)
    labels = np.array([[1, 1, -1], [1, 1, 1]], np.int32)
    ref = np.asarray(jax.jit(lambda p, *a: jm.apply(
        p, *a, method=JSysLearner.forward_spatial_train))(params, images, points, labels))
    with torch.no_grad():
        got = tm.forward_spatial_train(_t(images), _t(points), torch.from_numpy(labels))
        one = tm.forward_spatial_train(_t(images[:1]), _t(points[:1]),
                                       torch.from_numpy(labels[:1]))
    assert tuple(got.shape) == (2, 3, MS, MS)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=_grad_tol(ref))
    np.testing.assert_allclose(one.numpy(), got[:1].numpy(), rtol=1e-5,
                               atol=_grad_tol(ref, 1e-5))


# -- (d) one joint step ---------------------------------------------------------

def step1_batch(seed: int = 28, b: int = 2):
    """Seeded inputs of one joint step (numpy): seg images and targets, the
    step-1 extras from the port's builders (``make_joint_train_step``'s
    keys), class prompt ids and a VLP batch of 2 images."""
    rs = np.random.RandomState(seed)
    tok = t_tokenizer()
    builder = tstep1.Step1ExtrasBuilder(tok, text_len=TEXT_LEN, mask_hw=(MS, MS))
    sampler = TShapeSampler(max_candidate=3, seed=seed)
    names = ["person", "dog", "grass", "sky", "car"]
    labels = np.zeros((b, 3), np.int32)
    masks = np.zeros((b, 3, MS, MS), np.float32)
    valid = np.zeros((b, 3), bool)
    extras = []
    for i in range(b):
        n = 3 - i
        for k in range(n):
            y0, x0 = rs.randint(0, MS // 2, 2)
            masks[i, k, y0: rs.randint(y0 + 2, MS), x0: rs.randint(x0 + 2, MS)] = 1.0
            labels[i, k] = rs.randint(0, N_CLASSES)
            valid[i, k] = True
        caption = "a photo of " + " and ".join(f"a {names[labels[i, k]]}" for k in range(n))
        texts = [f"the {names[labels[i, k]]} in the picture" for k in range(n)]
        item = builder(caption, texts, masks[i, :n], mode="text" if i == 0 else "class", rs=rs)
        item.update(tstep1.spatial_prompt_arrays(sampler, masks[i, :n], 4, rs))
        extras.append(item)
    seg_extras = {k: np.stack([e[k] for e in extras]) for k in extras[0]}
    seg_extras["grounding_target_valid"] = seg_extras.pop("grounding_valid")
    bank = tstep1.ClassPromptBank(names[:N_CLASSES] + ["background"], tok, text_len=TEXT_LEN)
    text = bank.sample(rs)
    cap = tok(["a dog on the grass", "two cars under a blue sky"], max_length=77)
    vlp = {"images": (rs.rand(2, 64, 64, 3) * 255).astype(np.float32),
           "caption_ids": cap["input_ids"], "caption_mask": cap["attention_mask"]}
    images = (rs.rand(b, 64, 64, 3) * 255).astype(np.float32)
    return images, {"ids": text["ids"], "mask": text["mask"]}, (labels, masks, valid), vlp, \
        seg_extras


def joint_draws(rng, n_layers: int, b: int, t: int, g: int, s: int) -> dict:
    """JAX's draws of one joint step from its key ``rng``, by the port's
    names (``make_joint_train_step``'s docstring): the criterion's chain,
    then the caption, grounding and spatial chains from ``rng`` again."""
    out = {}
    r = rng
    for i in range(n_layers):
        r, r_match, r_pts = jax.random.split(r, 3)
        out[f"layer{i}/match"] = jax.random.uniform(r_match, (b, POINTS, 2))
        out.update(_uncertain_draws(r_pts, f"layer{i}", b * t))
    lang = range(n_layers - LANG_LAYERS, n_layers)
    r = rng
    for i in lang:
        r, _, r_m = jax.random.split(r, 3)
        out[f"caption{i}/match"] = jax.random.uniform(r_m, (b, POINTS, 2))
    for i in lang:
        r, r_g = jax.random.split(r)
        out.update(_grounding_draws(r_g, f"grounding{i}", b, g))
    r, r_sp = jax.random.split(r)
    out.update(_uncertain_draws(r_sp, "spatial", b * s))
    return {k: _t(v) for k, v in out.items()}


def test_joint_step_matches_jax(models, monkeypatch):
    """One ``make_joint_train_step`` step with every stream (live class
    text, phrases, grounding, spatial prompts, VLP with the backbone
    retrieval branch) against JAX's: the same loss keys, each term at rel
    1e-4, the same matchings (JAX's host solver calls recorded), every
    parameter's gradient, and every parameter after the update. JAX's side
    is its step's own loss (``make_joint_train_step(loss_only=True)``,
    unjitted) under ``value_and_grad`` and the optax update, as its
    ``train_step`` runs them, in one program that also returns the
    gradients."""
    jm, params, tm, cfg = models
    images, text, (labels, masks, valid), vlp, extras = step1_batch()
    b, t = labels.shape
    g, s = extras["grounding_ids"].shape[1], extras["spatial_points"].shape[1]
    rng = jax.random.PRNGKey(2)
    calls = []
    lsa = jmatcher._lsa_host

    def recording_lsa(cost):
        out = lsa(cost)
        calls.append((np.asarray(cost), out))
        return out

    monkeypatch.setattr(jmatcher, "_lsa_host", recording_lsa)
    jcrit = JSegCriterion(JCriterionConfig(num_classes=N_CLASSES, num_points=POINTS,
                                           top_mask_layers=KEPT))
    tx = build_optimizer(params, base_lr=LR, weight_decay=WD, total_steps=100)
    jloss = j_make_joint_train_step(jm, jcrit, tx, match_points=POINTS,
                                    language_loss_layers=LANG_LAYERS, loss_only=True).__wrapped__
    jtargets = JSegTargets(labels=jnp.asarray(labels), masks=jnp.asarray(masks),
                           valid=jnp.asarray(valid))

    @jax.jit
    def step(p, *batch):
        def f(p):
            out = jloss(p, *batch, rng)
            return out["loss_total"], out
        (_, losses), grads = jax.value_and_grad(f, has_aux=True)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return losses, grads, optax.apply_updates(p, updates)

    losses, grads, new_params = step(params, images, text, jtargets, vlp, extras)
    n_layers = 10
    draws = joint_draws(rng, n_layers, b, t, g, s)

    before = {k: v.clone() for k, v in tm.state_dict().items()}
    crit = SegCriterion(CriterionConfig(num_classes=N_CLASSES, num_points=POINTS,
                                        top_mask_layers=KEPT))
    opt = Optimizer(tm.named_parameters(), paths=convert.flax_paths(cfg), base_lr=LR,
                    weight_decay=WD, total_steps=100)
    grads_out = {}
    update = opt.step

    def copy_then_update():  # the gradients before clipping
        grads_out.update({n: p.grad.clone() for n, p in tm.named_parameters()})
        return update()

    opt.step = copy_then_update
    train_step = make_joint_train_step(tm, crit, match_points=POINTS,
                                       language_loss_layers=LANG_LAYERS)
    # A ReLU input within RELU_MARGIN of zero is a near-tie: JAX's jitted
    # gradient may treat it as on the other side than the forwards do, and
    # one such unit moves a gradient by far more than 1e-4. The inputs are
    # chosen clear of it, and this fails loudly if they stop being so.
    relu, margins = torch.nn.functional.relu, []

    def relu_margin(x, *a, **kw):
        margins.append(float(x.detach().abs().min()))
        return relu(x, *a, **kw)

    monkeypatch.setattr(torch.nn.functional, "relu", relu_margin)
    try:
        state, metrics = train_step(
            TrainState(opt), _t(images), {k: _tt(v) for k, v in text.items()},
            SegTargets(labels=_tt(labels), masks=_t(masks), valid=_tt(valid)),
            {k: _tt(v) for k, v in vlp.items()}, {k: _tt(v) for k, v in extras.items()}, draws)
        after = {k: v.clone() for k, v in tm.state_dict().items()}
    finally:
        tm.load_state_dict(before)  # the module-scoped model stays as bridged
    assert state.step == 1
    assert min(margins) > RELU_MARGIN, (min(margins), "a ReLU near-tie")
    keys = sorted(k for k in losses if k != "loss_total")
    assert keys == sorted(k for k in metrics if k.startswith("loss_") and k != "loss_total")
    assert len(keys) == 3 * KEPT + 4 * LANG_LAYERS + 5, keys
    for key in keys + ["loss_total"]:
        np.testing.assert_allclose(float(metrics[key]), float(losses[key]), rtol=1e-4,
                                   atol=1e-5, err_msg=key)

    # The matchings: JAX's batched call (criterion, caption, grounding
    # problems in that order), then one call a caption layer for its phrases.
    a = metrics["assignments"]
    batched = [x for k in ("criterion", "caption", "grounding") for x in a[k]]
    assert len(calls) == 1 + LANG_LAYERS and len(batched) == KEPT + 2 * LANG_LAYERS
    first = calls[0][1]
    off = 0
    for x in batched:
        np.testing.assert_array_equal(x.numpy(), first[off: off + x.shape[0], : x.shape[1]])
        off += x.shape[0]
    assert sorted(c[1].tolist() for c in calls[1:]) == sorted(x.tolist() for x in a["phrase"])

    ref_grads = convert.flax_to_state_dict(grads, cfg)
    ref_params = convert.flax_to_state_dict(new_params, cfg)
    reached = 0
    for name, _ in tm.named_parameters():
        gref = ref_grads[name].numpy()
        _grad_close(grads_out[name], gref, name)
        tol_g = _grad_tol(gref)
        atol = LR * np.minimum(2.0, 2 * tol_g / (np.abs(gref) + 1e-8)) + 1e-6
        err = np.abs(after[name].numpy() - ref_params[name].numpy())
        assert np.all(err <= atol), (name, float((err - atol).max()))
        reached += bool(np.abs(gref).max() > 0)
    # The streams reach the text tower, SAM's decoder and the injection.
    for prefix in ("lang_encoder.lang_encoder.blocks.0.", "mask_decoder.transformer.layers.0.",
                   "prompt_encoder.point_embeddings.1", "predictor.sam_query_proj",
                   "predictor.sam_feat_proj", "predictor.pos_embed_caping", "backbone_proj",
                   "lang_encoder.logit_scale"):
        assert any(bool(grads_out[n].abs().max() > 0) for n in grads_out
                   if n.startswith(prefix)), prefix


# -- (e) the step-1 extras builders ------------------------------------------------

def test_step1_builders_match_jax():
    """``Step1ExtrasBuilder`` (text and class modes, and without a caption
    or grounding), ``spatial_prompt_arrays`` (a ShapeSampler of each
    package on the same seed) and ``ClassPromptBank`` against JAX's on the
    same inputs and RandomState seeds: identical arrays."""
    rs0 = np.random.RandomState(11)
    masks = (rs0.rand(4, MS, MS) > 0.5).astype(np.float32)
    masks[3] = 0.0
    masks[3, 2:6, 3:9] = 1.0
    texts = ["a red car", "the dog on the left", "a red car", "sky"]
    caption = "Two dogs are running on the green grass near a red car."
    names = ["person", "traffic light-other", "wall-stuff", "car"]
    jb = jstep1.Step1ExtrasBuilder(j_tokenizer(), text_len=TEXT_LEN, mask_hw=(12, 12))
    tb = tstep1.Step1ExtrasBuilder(t_tokenizer(), text_len=TEXT_LEN, mask_hw=(12, 12))
    for mode, cap, txt, m in (("text", caption, texts, masks), ("class", caption, names, masks),
                              ("text", None, None, None), ("class", "", names, None)):
        rs_j, rs_t = np.random.RandomState(5), np.random.RandomState(5)
        ref, got = jb(cap, txt, m, mode=mode, rs=rs_j), tb(cap, txt, m, mode=mode, rs=rs_t)
        assert sorted(ref) == sorted(got)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{mode} {k}")
    for seed in (0, 1, 2):
        rs_j, rs_t = np.random.RandomState(seed), np.random.RandomState(seed)
        ref = jstep1.spatial_prompt_arrays(JShapeSampler(max_candidate=3, seed=seed), masks,
                                           4, rs_j)
        got = tstep1.spatial_prompt_arrays(TShapeSampler(max_candidate=3, seed=seed), masks,
                                           4, rs_t)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=f"spatial {seed} {k}")
    jbank = jstep1.ClassPromptBank(names, j_tokenizer(), text_len=TEXT_LEN)
    tbank = tstep1.ClassPromptBank(names, t_tokenizer(), text_len=TEXT_LEN)
    np.testing.assert_array_equal(tbank.ids, jbank.ids)
    np.testing.assert_array_equal(tbank.mask, jbank.mask)
    ref = jbank.sample(np.random.RandomState(3))
    got = tbank.sample(np.random.RandomState(3))
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=f"bank {k}")
