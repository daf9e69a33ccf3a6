"""The port's interactive segmentation against the JAX package's on the CPU.

On the tiny SysLearner of tests/test_torch_xdecoder.py (SAM ``tiny_test``,
64^2 images, SYSLEARNER_DIM 32; fp32, random numpy weights bridged):
``decode_prompts``, ``encode_interactive`` and ``decode_interactive`` for a
one-point prompt, a 20-slot padded prompt and a box; a 3-round click loop
with one deterministic click sampler on both sides (JAX's
``sample_fn_click`` patched in the test); ``single_shot_eval`` with box
and stroke prompts; ``evaluate_interactive_batches`` against JAX's loop
and evaluator; ``generate_masks`` on a SysLearner. Tolerance: 1e-4
relative (the JAX suite's fp32 bar). Host pieces: the evaluator on fixed
trajectories, the port's copies of the prompt helpers, and the NoC fixture
of scripts/bench_noc.py run on the port's first click, IoU, stop rule and
evaluator with JAX's click draws injected (the pinned NoC@0.85 8.0 and
mIoU@5 68.44 of tests/test_noc_fixture.py).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iuvl_tpu.inference.interactive as jinter
from iuvl_tpu.data import visual_sampler as jvs
from iuvl_tpu.evaluation.interactive import InteractiveEvaluator as JEvaluator
from iuvl_tpu.inference import amg as jamg
from iuvl_tpu.models.xdecoder.model import SysLearner as JSysLearner
from iuvl_tpu_torch.data import visual_sampler as tvs
from iuvl_tpu_torch.evaluation import InteractiveEvaluator
from iuvl_tpu_torch.inference import amg as tamg
from iuvl_tpu_torch.inference import interactive as tinter
from iuvl_tpu_torch.pipeline import evaluate_interactive_batches
from tests.test_torch_xdecoder import tiny_models

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

TOL = dict(atol=1e-4, rtol=1e-4)
N = 3  # targets


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(port, ref, name=""):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref, np.float32),
                               err_msg=name, **TOL)


class _JittedSys:
    """A JAX ``SysLearner`` whose ``apply`` is jitted per method, with the
    class attributes that ``make_interactive_loop``, ``single_shot_eval``
    and ``generate_masks`` look up on ``type(model)``."""

    normalize = JSysLearner.normalize
    encode_image = JSysLearner.encode_image
    decode_prompts = JSysLearner.decode_prompts
    decode_interactive = JSysLearner.decode_interactive

    def __init__(self, module):
        self.module, self.fns = module, {}

    def apply(self, params, *args, method, **kw):
        if method not in self.fns:
            self.fns[method] = jax.jit(
                lambda p, *a, **k: self.module.apply(p, *a, method=method, **k))
        return self.fns[method](params, *args, **kw)


def _gt_masks(size: int = 64):
    """Three known shapes at input resolution: a disc, a box, an L."""
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    disc = (yy - 24) ** 2 + (xx - 40) ** 2 <= 12 ** 2
    box = np.zeros((size, size), bool)
    box[8:28, 6:30] = True
    ell = np.zeros((size, size), bool)
    ell[36:60, 8:18] = True
    ell[50:60, 8:44] = True
    return np.stack([disc, box, ell])


@pytest.fixture(scope="module")
def setup():
    jm, params, tm, cfg = tiny_models()
    tm = tm.eval()
    image = np.random.RandomState(3).rand(1, 64, 64, 3).astype(np.float32) * 255
    jsys = _JittedSys(jm)
    cached = jax.tree_util.tree_map(np.asarray, jsys.apply(
        params, jnp.asarray(image), method=JSysLearner.encode_interactive))
    with torch.no_grad():
        tcached = tm.encode_interactive(_t(image))
    return dict(jm=jsys, params=params, tm=tm, image=image, cached=cached, tcached=tcached)


def _prompts():
    rs = np.random.RandomState(9)
    one = dict(points=rs.rand(N, 1, 2).astype(np.float32) * 64,
               labels=np.ones((N, 1), np.int32))
    pts = np.zeros((N, 20, 2), np.float32)
    labs = np.full((N, 20), -1, np.int32)
    pts[:, :5] = rs.rand(N, 5, 2) * 64
    labs[:, :5] = rs.randint(0, 2, (N, 5))
    box = np.sort(rs.rand(N, 2, 2).astype(np.float32) * 64, axis=1).reshape(N, 4)
    return {"one point": one, "20 slots": dict(points=pts, labels=labs),
            "box": dict(boxes=box)}


def test_encode_interactive_matches_jax(setup):
    emb, mf, ms = setup["cached"]
    temb, tmf, tms = setup["tcached"]
    _close(temb, emb, "sam_embedding")
    _close(tmf, mf, "mask_features")
    assert len(tms) == len(ms)
    for i, (a, b) in enumerate(zip(tms, ms)):
        _close(a, b, f"multi_scale[{i}]")


@pytest.mark.parametrize("prompt", ["one point", "20 slots", "box"])
def test_decode_prompts_and_decode_interactive_match_jax(setup, prompt):
    jm, params, tm = setup["jm"], setup["params"], setup["tm"]
    emb, mf, ms = setup["cached"]
    p = _prompts()[prompt]
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    dec = jm.apply(params, jnp.asarray(emb), **jp, method=JSysLearner.decode_prompts)
    logits = jm.apply(params, jnp.asarray(emb), jnp.asarray(mf), [jnp.asarray(x) for x in ms],
                      **jp, method=JSysLearner.decode_interactive)
    temb, tmf, tms = setup["tcached"]
    with torch.no_grad():
        tdec = tm.decode_prompts(temb, **tp)
        tlogits = tm.decode_interactive(temb, tmf, tms, **tp)
    for k in ("masks", "iou_pred", "upscaled_embedding", "hyper_in"):
        _close(tdec[k], dec[k], k)
    if "points" in tp:  # the SAM-only ablation round: the prompt decode itself
        with torch.no_grad():
            step = tm.evaluate_interactive_step(temb, None, tp["points"], tp["labels"])
        assert torch.equal(step["masks"], tdec["masks"])
    assert tlogits.shape == (N, 16, 16)
    _close(tlogits, logits, "interactive logits")


def _fn_centroid_jax(rng, gt, pred):
    """A deterministic click: the centroid (x, y) of the false-negative
    pixels (of the gt where there are none). It moves by a fraction of a
    pixel when one pixel flips, so the two sides' clicks stay together."""
    del rng
    n, h, w = gt.shape
    fn = gt & ~pred
    fn = jnp.where(fn.any((-2, -1), keepdims=True), fn, gt).astype(jnp.float32)
    cnt = fn.sum((-2, -1))
    xs = (fn * jnp.arange(w, dtype=jnp.float32)).sum((-2, -1)) / cnt
    ys = (fn * jnp.arange(h, dtype=jnp.float32)[:, None]).sum((-2, -1)) / cnt
    return jnp.stack([xs, ys], -1)


def _fn_centroid_torch(generator, gt, pred):
    del generator
    n, h, w = gt.shape
    fn = gt & ~pred
    fn = torch.where(fn.flatten(1).any(-1)[:, None, None], fn, gt).float()
    cnt = fn.sum((-2, -1))
    xs = (fn * torch.arange(w, dtype=torch.float32)).sum((-2, -1)) / cnt
    ys = (fn * torch.arange(h, dtype=torch.float32)[:, None]).sum((-2, -1)) / cnt
    return torch.stack([xs, ys], -1)


def test_click_loop_matches_jax(setup, monkeypatch):
    """Three rounds of the click loop through decode_interactive, the same
    deterministic clicks on both sides: the IoU per round and target, and
    the last round's masks. The logits agree to 1e-4 (the test above);
    thresholded at 0, a pixel whose logit sits within that of 0 may fall
    either way, so the masks may differ in 3 pixels (here they read equal)
    and the clicks are the false negatives' centroids, which such a pixel
    barely moves."""
    monkeypatch.setattr(jinter, "sample_fn_click", _fn_centroid_jax)
    gt = _gt_masks()
    firsts = np.stack([tvs.conv_dt_argmax(m)[::-1] for m in gt]).astype(np.float32)
    emb, mf, ms = setup["cached"]
    jloop = jinter.make_interactive_loop(setup["jm"].module, max_clicks=3)
    ious, final = jloop(setup["params"], jnp.asarray(emb), jnp.asarray(mf),
                        [jnp.asarray(x) for x in ms], jnp.asarray(gt), jnp.asarray(firsts),
                        jax.random.PRNGKey(0))
    tloop = tinter.make_interactive_loop(setup["tm"], max_clicks=3,
                                         sample_fn=_fn_centroid_torch)
    tious, tfinal = tloop(*setup["tcached"], torch.from_numpy(gt), torch.from_numpy(firsts))
    assert tious.shape == (3, N)
    _close(tious, ious, "ious")
    assert (tfinal.numpy() != np.asarray(final)).sum() <= 3
    evaluator = InteractiveEvaluator(max_clicks=3)
    out = tinter.run_interactive_eval(setup["tm"], setup["tcached"][0], torch.from_numpy(gt),
                                      torch.from_numpy(firsts), evaluator=evaluator,
                                      max_clicks=3, mask_features=setup["tcached"][1],
                                      multi_scale=setup["tcached"][2],
                                      sample_fn=_fn_centroid_torch)
    np.testing.assert_array_equal(out["ious"], tious.numpy())
    assert len(evaluator.trajectories) == N


@pytest.mark.parametrize("prompt_type", ["box", "stroke"])
def test_single_shot_eval_matches_jax(setup, prompt_type):
    gt = _gt_masks()
    boxes = np.stack([jvs.box_points(m) for m in gt])
    strokes = np.zeros_like(gt)
    strokes[:, 20:24, :] = gt[:, 20:24, :]
    strokes[:, :, 12:14] |= gt[:, :, 12:14]
    emb = setup["cached"][0]
    ious, pred = jinter.single_shot_eval(setup["jm"], setup["params"], jnp.asarray(emb), gt,
                                         prompt_type, prompt_masks=strokes, boxes=boxes,
                                         seed=4)
    tious, tpred = tinter.single_shot_eval(setup["tm"], setup["tcached"][0], gt, prompt_type,
                                           prompt_masks=strokes, boxes=boxes, seed=4)
    _close(tious, ious, "ious")
    np.testing.assert_array_equal(tpred.numpy(), np.asarray(pred))


@pytest.mark.parametrize("prompt_mode", ["Point", "Box"])
def test_evaluate_interactive_batches_matches_jax_loop(setup, prompt_mode, monkeypatch):
    """The port's ``_evaluate_interactive`` counterpart on one image: JAX's
    loop (Point: first clicks from ``click_points``, the deterministic
    sampler on both sides) or single-shot box decode, fed to JAX's
    evaluator, against the port's metrics."""
    monkeypatch.setattr(jinter, "sample_fn_click", _fn_centroid_jax)
    gt = _gt_masks()
    firsts = np.stack([tvs.conv_dt_argmax(m)[::-1] for m in gt]).astype(np.float32)
    item = {"image": setup["image"][0], "gt_masks": gt,
            "spatial_query": {"click_points": firsts, "rand_shape": gt}}
    emb, mf, ms = setup["cached"]
    evaluator = JEvaluator(max_clicks=4)
    if prompt_mode == "Point":
        jinter.run_interactive_eval(setup["jm"].module, setup["params"], jnp.asarray(emb),
                                    jnp.asarray(gt), jnp.asarray(firsts),
                                    jax.random.PRNGKey(0), evaluator=evaluator, max_clicks=4,
                                    mask_features=jnp.asarray(mf),
                                    multi_scale=[jnp.asarray(x) for x in ms])
    else:
        boxes = np.stack([jvs.box_points(m) for m in gt])
        ious, _ = jinter.single_shot_eval(setup["jm"], setup["params"], jnp.asarray(emb), gt,
                                          "box", boxes=boxes)
        for iou in np.asarray(ious):
            evaluator.process(np.full(4, iou, np.float64))
    want = evaluator.evaluate()
    got = evaluate_interactive_batches(setup["tm"], [item], name="fixture",
                                       prompt_mode=prompt_mode, max_clicks=4,
                                       sample_fn=_fn_centroid_torch)
    assert set(got) == {f"fixture/{k}" for k in want}
    for k, v in want.items():
        assert got[f"fixture/{k}"] == pytest.approx(v, rel=1e-4, abs=1e-3), k


def test_generate_masks_on_a_syslearner_matches_jax(setup):
    """AMG through ``SysLearner.decode_prompts`` (4 x 4 points in batches of
    8, every mask through the cuts, binary masks)."""
    kw = dict(points_per_side=4, batch=8, pred_iou_thresh=float("-inf"),
              stability_thresh=-1.0)
    want = jamg.generate_masks(setup["jm"], setup["params"], setup["image"], **kw)
    got = tamg.generate_masks(setup["tm"], setup["image"], **kw)
    assert len(got["records"]) == len(want["records"]) > 0
    np.testing.assert_array_equal(got["masks"], want["masks"])
    np.testing.assert_allclose(got["scores"], want["scores"], **TOL)


def test_interactive_evaluator_matches_jax_on_fixed_trajectories():
    rs = np.random.RandomState(0)
    trajs = np.clip(np.cumsum(rs.rand(7, 20) * 0.12, axis=1), 0, 1)
    trajs[0] = 0.95  # reached at the first click
    trajs[1] = 0.3  # never reached
    ours, theirs = InteractiveEvaluator(), JEvaluator()
    for t in trajs:
        ours.process(t)
        theirs.process(t)
    other = InteractiveEvaluator()
    other.merge(ours)
    assert other.evaluate() == ours.evaluate() == theirs.evaluate()
    assert InteractiveEvaluator().evaluate() == {}


def test_prompt_helpers_equal_jax():
    rs = np.random.RandomState(1)
    for _ in range(8):
        m = rs.rand(24, 30) > 0.35
        assert tvs.conv_dt_argmax(m) == jvs.conv_dt_argmax(m)
        np.testing.assert_array_equal(tvs.box_points(m), jvs.box_points(m))
        np.testing.assert_array_equal(tvs.distance_transform_conv(m),
                                      jvs.distance_transform_conv(m))
    empty = np.zeros((5, 5), bool)
    assert tvs.conv_dt_argmax(empty) == (0, 0)
    np.testing.assert_array_equal(tvs.box_points(empty), np.zeros(4, np.float32))
    # The argmax of the cascaded transform is the first click's pixel.
    m = _gt_masks()[2]
    dt = tvs.distance_transform_conv(~np.pad(m, 1))[1:-1, 1:-1]
    assert np.unravel_index(np.argmax(dt), dt.shape) == tvs.conv_dt_argmax(m)


def test_sample_fn_click_draws_false_negatives_from_its_generator():
    gt = torch.from_numpy(_gt_masks())
    pred = torch.zeros_like(gt)
    pred[0] = gt[0]  # target 0 has no false negatives: its gt is the pool
    pred[1, 8:18] = True
    clicks = [tinter.sample_fn_click(torch.Generator().manual_seed(s), gt, pred)
              for s in (0, 0, 1)]
    assert torch.equal(clicks[0], clicks[1]) and not torch.equal(clicks[0], clicks[2])
    for c in clicks:
        x, y = c.long().T
        fn = gt & ~pred
        assert bool(gt[0, y[0], x[0]]) and bool(fn[1, y[1], x[1]]) and bool(fn[2, y[2], x[2]])


def test_noc_fixture_on_the_port_gives_the_pinned_numbers():
    """scripts/bench_noc.py's fixture with the port's pieces: the first click
    from the port's conv_dt_argmax, the IoU from its mask_iou, its STOP_IOU
    gate and its InteractiveEvaluator; the next clicks are JAX's draws
    (sample_fn_click on the same threefry keys), injected."""
    from bench_noc import disk_predictor, fixture_masks

    gts = fixture_masks()
    evaluator = InteractiveEvaluator(max_clicks=20)
    draw = jax.jit(jinter.sample_fn_click)
    for i, gt in enumerate(gts):
        predict = disk_predictor(gt)
        y, x = tvs.conv_dt_argmax(gt)
        clicks = [(x, y)]
        rng = jax.random.PRNGKey(i)
        traj = []
        for _ in range(20):
            pred = predict(clicks)
            iou = float(tinter.mask_iou(torch.from_numpy(pred[None]),
                                        torch.from_numpy(gt[None]))[0])
            traj.append(iou)
            rng, r_click = jax.random.split(rng)
            click = np.asarray(draw(r_click, jnp.asarray(gt[None]), jnp.asarray(pred[None])))[0]
            if iou < tinter.STOP_IOU:
                clicks.append((float(click[0]), float(click[1])))
        evaluator.process(np.asarray(traj))
    m = evaluator.evaluate()
    assert m["NoC@0.85"] == 8.0, m
    assert m["Fail@0.85"] == 0.0, m
    np.testing.assert_allclose(m["mIoU@5"], 68.44, atol=0.5)
