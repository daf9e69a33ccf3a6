"""The port's seg eval against the JAX package's on the CPU: the text tower
(``encode_text_embeddings``, the class embeddings with the prompt
ensemble), ``evaluate_seg`` with ``msdeform_impl='auto'`` and ``'hybrid'``,
the post-processing (semantic and instance inference, the panoptic merge),
the three evaluators, and the seg-mode body of ``_evaluate_dataset``.

The tiny config of ``tests/test_torch_xdecoder.py`` with a text tower of
width 32, 2 layers, 4 heads and CLIP's vocabulary (HashWord ids reach
49407); one batch of JAX's ``synthetic_seg`` (2 images of 64^2, 4
classes). At 64^2 every pixel-decoder level has at most 1536 cells, so
``hybrid`` sends all three through the one-hot level (B15's plain version
here, JAX's Pallas kernel in interpret mode). fp32; random weights from
numpy, bridged. Tolerance: the JAX suite's fp32 bar, atol = rtol = 1e-4;
the evaluators and the panoptic merge, numpy on both sides, agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from iuvl_tpu.data import batched_iterator, build_dataset
from iuvl_tpu.evaluation import InstanceAPEvaluator as JInstance
from iuvl_tpu.evaluation import PanopticEvaluator as JPanoptic
from iuvl_tpu.evaluation import SemSegEvaluator as JSemSeg
from iuvl_tpu.inference import postprocess as jpp
from iuvl_tpu.models.xdecoder.model import SysLearner as JSysLearner
from iuvl_tpu.models.xdecoder.model import SysLearnerConfig as JConfig
from iuvl_tpu.ops.pallas import onehot_gather as jog
from iuvl_tpu.pipeline import XDecoderPipeline
from iuvl_tpu_torch.data.class_names import get_class_names
from iuvl_tpu_torch.data.tokenizer import HashWordTokenizer
from iuvl_tpu_torch.evaluation import InstanceAPEvaluator, PanopticEvaluator, SemSegEvaluator
from iuvl_tpu_torch.inference import postprocess as tpp
from iuvl_tpu_torch.models.xdecoder import convert
from iuvl_tpu_torch.models.xdecoder.model import SysLearner, SysLearnerConfig
from iuvl_tpu_torch.pipeline import class_text_embeddings, evaluate_seg_batches
from tests.test_torch_xdecoder import N_CLASSES, TINY, tiny_models

TEXT = dict(text_width=32, text_layers=2, text_heads=4, vocab_size=49408)
TOL = dict(atol=1e-4, rtol=1e-4)
NAME = "synthetic_seg"
PIPE_CFG = {"NUM_CLASSES": N_CLASSES, "CONTEXT_LEN": TINY["contxt_len"],
            "SYNTHETIC_SEG": {"NUM_CLASSES": N_CLASSES, "IMAGE_SIZE": 64, "LENGTH": 2,
                              "MAX_INSTANCES": 3}}


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(port, ref, name=""):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref, np.float32),
                               err_msg=name, **TOL)


class _Replay:
    """Stands in for the JAX model inside the JAX pipeline: its
    ``evaluate_seg`` gives fixed outputs, anything else runs the model."""

    def __init__(self, jm, outputs):
        self.jm, self.outputs = jm, outputs

    def apply(self, params, *args, method=None):
        if method is JSysLearner.evaluate_seg:
            return tuple(jnp.asarray(o) for o in self.outputs)
        return self.jm.apply(params, *args, method=method)


@pytest.fixture(scope="module")
def setup():
    """JAX's and the port's models for both impls, the synthetic batch, the
    JAX pipeline's class embeddings, and JAX's evaluate_seg outputs."""
    jm, params, tm, cfg = tiny_models(text=TEXT)
    state = tm.state_dict()
    jms, tms = {"auto": jm}, {"auto": tm}
    jms["hybrid"] = JSysLearner(cfg=JConfig(**{**jm.cfg.__dict__, "msdeform_impl": "hybrid"}))
    tms["hybrid"] = SysLearner(SysLearnerConfig(**{**cfg.__dict__, "msdeform_impl": "hybrid"}))
    tms["hybrid"].load_state_dict(state)
    pipe = XDecoderPipeline(PIPE_CFG)
    pipe.model = jm
    text = np.asarray(pipe.class_text_embeddings(params, NAME))
    ds = build_dataset(NAME, PIPE_CFG["SYNTHETIC_SEG"], "val")
    batch = next(batched_iterator(ds, 2, shuffle=False, epochs=1))
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    outs = {}
    jog.pl.pallas_call = interp
    try:
        for impl, m in jms.items():
            fn = jax.jit(lambda p, i, t, m=m: m.apply(p, i, t, method=JSysLearner.evaluate_seg))
            outs[impl] = tuple(np.asarray(o) for o in fn(params, batch["image"], text))
    finally:
        jog.pl.pallas_call = orig
    return dict(jm=jm, params=params, tms=tms, cfg=cfg, pipe=pipe, text=text, batch=batch,
                outs=outs)


def test_text_tower_bridge_round_trip(setup):
    """Every text-tower leaf maps to one port parameter and back, exactly,
    Dense kernels transposed into nn.Linear weights."""
    params, cfg, tm = setup["params"], setup["cfg"], setup["tms"]["auto"]
    sd = convert.flax_to_state_dict(params, cfg)
    tower = params["params"]["lang_encoder"]
    np.testing.assert_array_equal(sd["lang_encoder.lang_encoder.blocks.1.c_fc.weight"].numpy(),
                                  np.asarray(tower["lang_encoder"]["block1"]["c_fc"]["kernel"]).T)
    np.testing.assert_array_equal(sd["lang_encoder.lang_proj"].numpy(),
                                  np.asarray(tower["lang_proj"]))
    back = convert.state_dict_to_flax(sd, cfg)["params"]["lang_encoder"]
    flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    ref = jax.tree_util.tree_flatten_with_path(tower)[0]
    assert len(flat) == len(ref) == 2 + 2 * 12 + 2 + 2
    for path, leaf in ref:
        np.testing.assert_array_equal(flat[path], np.asarray(leaf), err_msg=str(path))
    assert {k for k in tm.state_dict() if k.startswith("lang_encoder.")} == {
        k for k in sd if k.startswith("lang_encoder.")}


def test_tokenizers_match_jax(tmp_path):
    """The HashWord fallback, and CLIP's BPE on a small merges file: the
    same ids and masks as JAX's tokenizers, the same choice of tokenizer."""
    import gzip

    from iuvl_tpu.data import tokenizer as jtok
    from iuvl_tpu_torch.data import tokenizer as ttok

    texts = ["a photo of a traffic light.", "the  Sky-other merged", "itap of my 3 dogs!"]
    for port, ref in ((ttok.HashWordTokenizer(), jtok.HashWordTokenizer()),
                      (ttok.build_tokenizer(), jtok.build_tokenizer())):
        assert type(port).__name__ == type(ref).__name__ == "HashWordTokenizer"
        for key, want in ref(texts, max_length=12).items():
            np.testing.assert_array_equal(port(texts, max_length=12)[key], want, err_msg=key)
    merges = tmp_path / "merges.txt.gz"
    with gzip.open(merges, "wt", encoding="utf-8") as f:
        f.write("#version\n" + "\n".join(["p h", "o t", "ph ot", "o </w>", "a </w>", "t h",
                                           "th e</w>", "s k", "sk y</w>"]) + "\n")
    port, ref = ttok.build_tokenizer(str(merges)), jtok.build_tokenizer(str(merges))
    assert type(port).__name__ == type(ref).__name__ == "ClipBPETokenizer"
    for key, want in ref(texts, max_length=20).items():
        np.testing.assert_array_equal(port(texts, max_length=20)[key], want, err_msg=key)
    assert port.encode_text("photo") == ref.encode_text("photo")
    assert len(port.encode_text("photo")) < len("photo")  # the merges applied


def test_encode_text_embeddings_matches_jax(setup):
    jm, params, tm = setup["jm"], setup["params"], setup["tms"]["auto"]
    tok = HashWordTokenizer()(["a photo of a cat.", "the sky", "a toy object 3 in the dark"],
                              max_length=TINY["contxt_len"])
    ref = jm.apply(params, jnp.asarray(tok["input_ids"]), jnp.asarray(tok["attention_mask"]),
                   method=JSysLearner.encode_text_embeddings)
    with torch.no_grad():
        got = tm.encode_text_embeddings(torch.from_numpy(tok["input_ids"]))
    _close(got, ref)


def test_class_text_embeddings_match_jax(setup):
    names = get_class_names(NAME, N_CLASSES)
    assert len(names) == N_CLASSES + 1
    got = class_text_embeddings(setup["tms"]["auto"], names)
    _close(got, setup["text"])


@pytest.mark.parametrize("impl", ["auto", "hybrid"])
def test_evaluate_seg_matches_jax(setup, impl):
    """mask_cls and the upsampled mask_pred (64^2 from 16^2: its edges come
    from jax.image.resize's half-pixel weights) against JAX's."""
    tm, (ref_cls, ref_pred) = setup["tms"][impl], setup["outs"][impl]
    with torch.no_grad():
        cls, pred = tm.evaluate_seg(_t(setup["batch"]["image"]), _t(setup["text"]))
    assert pred.shape == ref_pred.shape == (2, TINY["mask_proposals"] + 1, 64, 64)
    _close(cls, ref_cls, "mask_cls")
    _close(pred, ref_pred, "mask_pred")
    _close(pred[..., [0, -1], :], ref_pred[..., [0, -1], :], "mask_pred edge rows")


def test_postprocess_matches_jax(setup):
    """On JAX's outputs: semantic inference, the top-k instances (compared
    where the top-k's values are distinct: ``torch.topk`` need not break
    ties as ``jax.lax.top_k`` does), and the panoptic merge."""
    mask_cls, mask_pred = setup["outs"]["auto"]
    thing = np.array([True, False, True, True])
    for b in range(2):
        cls, pred = mask_cls[b], mask_pred[b]
        _close(tpp.semantic_inference(_t(cls), _t(pred)), jpp.semantic_inference(cls, pred))
        ref = jax.tree_util.tree_map(np.asarray, jpp.instance_inference(
            cls, pred, topk=30, thing_mask=jnp.asarray(thing)))
        got = {k: v.numpy() for k, v in tpp.instance_inference(
            _t(cls), _t(pred), topk=30, thing_mask=torch.from_numpy(thing)).items()}
        top = np.asarray(jax.lax.top_k(jax.nn.softmax(cls, -1)[:, :-1].reshape(-1), 30)[0])
        distinct = np.ones(30, bool)
        distinct[1:] &= top[1:] != top[:-1]
        distinct[:-1] &= top[:-1] != top[1:]
        assert distinct.sum() > 20
        for key in ("pred_classes", "valid", "pred_masks"):
            np.testing.assert_array_equal(got[key][distinct], ref[key][distinct], err_msg=key)
        np.testing.assert_allclose(np.sort(got["scores"]), np.sort(ref["scores"]), **TOL)
        sem = jpp.semantic_inference(cls, pred)
        _close(tpp.sem_seg_postprocess(_t(sem), (48, 56), 40, 90),
               jpp.sem_seg_postprocess(sem, (48, 56), 40, 90), "sem_seg_postprocess")
        for thr in (0.8, 0.2):
            ref_seg, ref_info = jpp.panoptic_merge(cls, pred, {0, 2}, thr)
            seg, info = tpp.panoptic_merge(cls, pred, {0, 2}, thr)
            np.testing.assert_array_equal(seg, ref_seg)
            assert info == ref_info
    assert any(tpp.panoptic_merge(c, p, {0, 2}, 0.2)[1] for c, p in zip(mask_cls, mask_pred))


def _synthetic_eval_set(seed=5, n=3, k=5, size=32):
    """n images: semantic maps (255 = ignore), panoptic segments and
    instance masks whose predictions are the gt perturbed."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        def boxes(count):
            out = np.zeros((count, size, size), bool)
            for m in out:
                y0, x0 = rs.randint(0, size // 2, 2)
                m[y0:y0 + rs.randint(4, size // 2), x0:x0 + rs.randint(4, size // 2)] = True
            return out

        gt_masks = boxes(rs.randint(2, 5))
        gt_labels = list(rs.randint(0, k, len(gt_masks)))
        pred_masks = np.concatenate([gt_masks ^ (rs.rand(*gt_masks.shape) > 0.97), boxes(2)])
        pred_labels = np.concatenate([gt_labels, rs.randint(0, k, 2)])
        pred_labels[0] = (pred_labels[0] + 1) % k
        gt_sem = np.full((size, size), 255, np.int64)
        pred_sem = rs.randint(0, k, (size, size))
        pan_gt, pan_pred = np.zeros((size, size), np.int32), np.zeros((size, size), np.int32)
        for i, (m, lab) in enumerate(zip(gt_masks, gt_labels)):
            gt_sem[m], pan_gt[m] = lab, i + 1
        for i, (m, lab) in enumerate(zip(pred_masks, pred_labels)):
            pred_sem[m], pan_pred[m] = lab, i + 1
        out.append(dict(
            pred_sem=pred_sem, gt_sem=gt_sem,
            pan=(pan_pred, [{"id": i + 1, "category_id": int(c)}
                            for i, c in enumerate(pred_labels)],
                 pan_gt, [{"id": i + 1, "category_id": int(c)} for i, c in enumerate(gt_labels)]),
            inst=(pred_masks, rs.rand(len(pred_masks)), pred_labels, gt_masks,
                  np.asarray(gt_labels))))
    return out


def test_evaluators_match_jax():
    k = 5
    evals = {"semseg": (SemSegEvaluator(k), JSemSeg(k)),
             "panoptic": (PanopticEvaluator({0, 1, 2}), JPanoptic({0, 1, 2})),
             "instance": (InstanceAPEvaluator(k), JInstance(k))}
    for item in _synthetic_eval_set(k=k):
        for ev in evals["semseg"]:
            ev.process(item["pred_sem"], item["gt_sem"])
        for ev in evals["panoptic"]:
            ev.process(*item["pan"])
        for ev in evals["instance"]:
            ev.process(*item["inst"])
    for name, (port, ref) in evals.items():
        got, want = port.evaluate(), ref.evaluate()
        assert got == want and len(got) >= 4, (name, got, want)
        assert all(np.isfinite(v) for v in got.values()), name
    assert 0 < evals["panoptic"][0].evaluate()["PQ"] < 100
    assert 0 < evals["instance"][0].evaluate()["AP"] < 100


def test_seg_eval_pipeline_matches_jax(setup):
    """JAX's ``_evaluate_dataset`` (semantic, panoptic and instance heads
    on) and the port's ``evaluate_seg_batches`` over the same batch, both
    given JAX's evaluate_seg outputs: the same metrics. The port's own
    model then runs the same batch through the kernels' plain versions."""
    outs, text, batch = setup["outs"]["auto"], setup["text"], setup["batch"]
    pipe = XDecoderPipeline(PIPE_CFG)
    pipe.model = _Replay(setup["jm"], outs)
    ref = pipe._evaluate_dataset(setup["params"], NAME, batch_size=2)

    class PortReplay:
        def evaluate_seg(self, images, text_emb):
            return _t(outs[0]), _t(outs[1])

    got = evaluate_seg_batches(PortReplay(), _t(text), [batch], NAME)
    assert got.keys() == ref.keys() and got[f"{NAME}/processed"] == 2
    for key, want in ref.items():
        assert got[key] == pytest.approx(want, rel=1e-9, abs=1e-9), key
    timings = {}
    live = evaluate_seg_batches(setup["tms"]["auto"], _t(text), [batch], NAME, timings=timings)
    assert live.keys() == ref.keys() and all(np.isfinite(v) for v in live.values())
    assert {k: len(v) for k, v in timings.items()} == {
        "evaluate_seg": 1, "semantic": 2, "panoptic": 2, "instance": 2}
