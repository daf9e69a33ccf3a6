"""The port's seg train step against the JAX package's on the CPU: the
image encoder's gradients (every parameter reached, through the training
routes), then one ``make_train_step`` step — each loss term, every bridged
parameter's gradient, every parameter after the update.

Tiny config and random bridged weights of ``tests/test_torch_xdecoder.py``;
fp32; targets T = 3 binary masks at the input resolution. The criterion's
random points are drawn with ``jax.random`` from the keys ``collect_costs``
splits and handed to the port (``given_draws``), so both sample the same
points. Tolerances: the JAX suite's fp32 bar, 1e-4, relative to each
tensor's largest entry (at least 0.1) for gradients. After the update the tolerance is
scaled by the LR: AdamW's first step moves a parameter by about
lr * g / (|g| + eps), so a gradient error d moves it by at most
lr * min(2, 2 d / (|g| + eps)); d is the gradient tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from iuvl_tpu.losses.criterion import CriterionConfig as JCriterionConfig
from iuvl_tpu.losses.criterion import SegCriterion as JSegCriterion
from iuvl_tpu.losses.criterion import SegTargets as JSegTargets
from iuvl_tpu.models.xdecoder.model import SysLearner as JSysLearner
from iuvl_tpu.train.optimizer import build_optimizer
from iuvl_tpu.train.train_step import split_seg_outputs as j_split
from iuvl_tpu_torch.losses.criterion import CriterionConfig, SegCriterion, SegTargets
from iuvl_tpu_torch.models.xdecoder import convert
from iuvl_tpu_torch.train.optimizer import Optimizer
from iuvl_tpu_torch.train.train_step import TrainState, make_train_step
from tests.test_torch_xdecoder import N_CLASSES, inputs, tiny_models

POINTS, T = 64, 3
# The criterion keeps the final layer and two aux layers: every layer runs
# the same code, and each kept layer adds to JAX's compile time (10 layers:
# ~55 s of lowering and compile; 3: ~40 s).
KEPT = 3
LR, WD = 1e-3, 0.5  # a large decay, so that a wrong decay mask shows after one step


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _grad_tol(ref) -> float:
    """1e-4 of the tensor's largest gradient, and at least 1e-5: a gradient
    that is zero in exact arithmetic (a bias right before a GroupNorm of
    one channel a group) leaves fp32 noise of ~1e-6 that differs between
    the frameworks."""
    return 1e-4 * max(float(np.abs(ref).max()), 0.1)


def _grad_close(port, ref, name):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(port.numpy(), ref, rtol=1e-4, atol=_grad_tol(ref), err_msg=name)


@pytest.fixture(scope="module")
def models():
    return tiny_models()


def test_encoder_gradients_reach_every_parameter_and_match_jax(models):
    jm, params, tm, _ = models
    images, _ = inputs()
    rs = np.random.RandomState(7)
    names = ("emb", "res2", "res3", "res4", "res5")

    def outs(m, x):
        emb, fpn = m.encode_image(x)
        return [emb] + [fpn[k] for k in names[1:]]

    shapes = [o.shape for o in jax.eval_shape(lambda p: jm.apply(p, images, method=outs),
                                              params)]
    weights = [rs.randn(*s).astype(np.float32) for s in shapes]

    def loss(p):
        return sum((o * w).sum() for o, w in zip(jm.apply(p, images, method=outs), weights))

    ref = convert.flax_to_state_dict(jax.jit(jax.grad(loss))(params), tm.cfg)
    enc = tm.image_encoder
    enc.zero_grad(set_to_none=True)
    emb, fpn = tm.encode_image(_t(images))
    got = [emb] + [fpn[k] for k in names[1:]]
    sum((o * _t(w)).sum() for o, w in zip(got, weights)).backward()
    for name, p in enc.named_parameters():
        assert p.grad is not None and bool(p.grad.abs().sum() > 0), name
        _grad_close(p.grad, ref["image_encoder." + name], name)


def _targets(seed=5, b=1):
    """b images of T binary gt masks; each image's valid targets differ."""
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, N_CLASSES, (b, T)).astype(np.int32)
    masks = (rs.rand(b, T, 64, 64) > 0.6).astype(np.float32)
    valid = np.array([[True, True, False], [True, False, True]][:b])
    return labels, masks, valid


def _draws(rng, n_layers=10, b=1):
    """The uniform draws of JAX's collect_costs / loss_masks for b images,
    by the port's names (layer{i}/match, /over, /rand)."""
    out = {}
    n_uncertain = int(0.75 * POINTS)
    for i in range(n_layers):
        rng, r_match, r_pts = jax.random.split(rng, 3)
        r1, r2 = jax.random.split(r_pts)
        out[f"layer{i}/match"] = jax.random.uniform(r_match, (b, POINTS, 2))
        out[f"layer{i}/over"] = jax.random.uniform(r1, (b * T, 3 * POINTS, 2))
        out[f"layer{i}/rand"] = jax.random.uniform(r2, (b * T, POINTS - n_uncertain, 2))
    return {k: _t(v) for k, v in out.items()}


def test_train_step_matches_jax(models):
    step_matches_jax(models, b=1)


def step_matches_jax(models, b: int):
    """One ``make_train_step`` step on b images against JAX's: each loss
    term, every gradient, every parameter after the update."""
    jm, params, tm, cfg = models
    images, text = inputs(b=b)
    labels, masks, valid = _targets(b=b)
    rng = jax.random.PRNGKey(1)

    # The JAX side: make_train_step's loss_fn and update (train_step.py:338-356).
    jcrit = JSegCriterion(JCriterionConfig(num_classes=N_CLASSES, num_points=POINTS,
                                           top_mask_layers=KEPT))
    tx = build_optimizer(params, base_lr=LR, weight_decay=WD, total_steps=100)
    jt = JSegTargets(labels=jnp.asarray(labels), masks=jnp.asarray(masks),
                     valid=jnp.asarray(valid))

    def loss_fn(p):
        outputs = jm.apply(p, images, text, method=JSysLearner.forward_seg)
        obj, _ = j_split(outputs, jm.cfg.num_queries)
        losses = jcrit(rng, obj, jt, match_points=POINTS)
        return sum(losses.values()), losses

    def step(p):
        (total, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return total, losses, grads, optax.apply_updates(p, updates)

    total, losses, grads, new_params = jax.jit(step)(params)

    before = {k: v.clone() for k, v in tm.state_dict().items()}
    crit = SegCriterion(CriterionConfig(num_classes=N_CLASSES, num_points=POINTS,
                                        top_mask_layers=KEPT))
    opt = Optimizer(tm.named_parameters(), paths=convert.flax_paths(cfg), base_lr=LR,
                    weight_decay=WD, total_steps=100)
    state = TrainState(opt)
    grads_out = {}
    update = opt.step

    def copy_then_update():  # the gradients before clipping
        grads_out.update({n: p.grad.clone() for n, p in tm.named_parameters()})
        return update()

    opt.step = copy_then_update
    train_step = make_train_step(tm, crit, match_points=POINTS)
    targets = SegTargets(labels=torch.from_numpy(labels), masks=_t(masks),
                         valid=torch.from_numpy(valid))
    try:
        state, metrics = train_step(state, _t(images), _t(text), targets, _draws(rng, b=b))
        after = {k: v.clone() for k, v in tm.state_dict().items()}
    finally:
        tm.load_state_dict(before)  # the module-scoped model stays as bridged
    assert state.step == 1 and len(losses) == 3 * KEPT
    for key, ref in losses.items():
        np.testing.assert_allclose(float(metrics[key]), float(ref), rtol=1e-4, atol=1e-5,
                                   err_msg=key)
    np.testing.assert_allclose(float(metrics["loss_total"]), float(total), rtol=1e-4)
    ref_grads = convert.flax_to_state_dict(grads, cfg)
    ref_params = convert.flax_to_state_dict(new_params, cfg)
    for name, _ in tm.named_parameters():
        g = ref_grads[name].numpy()
        _grad_close(grads_out[name], g, name)
        tol_g = _grad_tol(g)
        atol = LR * np.minimum(2.0, 2 * tol_g / (np.abs(g) + 1e-8)) + 1e-6
        err = np.abs(after[name].numpy() - ref_params[name].numpy())
        assert np.all(err <= atol), (name, float((err - atol).max()))
        # A parameter moved by a non-zero gradient or by weight decay.
        if bool(ref_grads[name].abs().sum() > 0):
            assert not torch.equal(after[name], before[name]), name


def test_optimizer_matches_optax_step_by_step():
    """Five updates of clip -> AdamW (masked decay) -> LR multipliers ->
    freeze against the optax chain, across both schedule milestones: the
    port evaluates the schedule at the count of updates made, as optax
    does, so an off-by-one would show at steps 2 and 4."""
    rs = np.random.RandomState(11)
    shapes = {("enc", "dense", "kernel"): (6, 4), ("enc", "dense", "bias"): (4,),
              ("enc", "norm", "scale"): (4,), ("head", "kernel"): (4, 3),
              ("frozen_part", "kernel"): (3, 3)}

    def nest(values):
        tree = {}
        for path, v in values.items():
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = v
        return tree

    def leaf(tree, path):
        for key in path:
            tree = tree[key]
        return tree

    jparams = nest({p: rs.randn(*s_).astype(np.float32) for p, s_ in shapes.items()})
    kw = dict(base_lr=1e-2, weight_decay=0.1, total_steps=5, clip_norm=1.0, warmup_iters=0,
              lr_multipliers={"head": 0.5}, frozen_substrings=("frozen_part",))
    tx = build_optimizer(jparams, **kw)
    params = {p: torch.nn.Parameter(_t(leaf(jparams, p))) for p in shapes}
    opt = Optimizer([("/".join(p), t) for p, t in params.items()],
                    paths={"/".join(p): "params/" + "/".join(p) for p in shapes}, **kw)
    state = tx.init(jparams)
    update = jax.jit(tx.update)  # one compile for the five updates
    for step in range(5):
        grads = {p: rs.randn(*s_).astype(np.float32) for p, s_ in shapes.items()}
        updates, state = update(nest(grads), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, t in params.items():
            t.grad = _t(grads[p])
        opt.step()
        for p, t in params.items():
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(leaf(jparams, p)),
                                       rtol=1e-5, atol=1e-6, err_msg=f"step {step} {p}")


def test_criterion_draws_from_a_generator(models):
    """Without given draws the criterion's points come from a
    ``torch.Generator`` (what ``train_step`` makes of one): the same seed
    gives the same losses, another seed other losses."""
    from iuvl_tpu_torch.ops.point_sample import generator_draws
    from iuvl_tpu_torch.train.train_step import split_seg_outputs

    _, _, tm, _ = models
    images, text = inputs()
    labels, masks, valid = _targets()
    targets = SegTargets(labels=torch.from_numpy(labels), masks=_t(masks),
                         valid=torch.from_numpy(valid))
    crit = SegCriterion(CriterionConfig(num_classes=N_CLASSES, num_points=POINTS))
    with torch.no_grad():
        obj, _ = split_seg_outputs(tm.forward_seg(_t(images), _t(text)), tm.cfg.num_queries)
        totals = [float(sum(crit(obj, targets, generator_draws(torch.Generator().manual_seed(s)),
                                 match_points=POINTS).values()))
                  for s in (3, 3, 4)]
    assert totals[0] == totals[1] != totals[2]
