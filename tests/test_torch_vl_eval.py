"""The port's vision-language eval path against the JAX package's on the
CPU: the text tower's token and KV-cached paths, the unified decoder's
grounding and caption tasks and its cached caption decode, the
SysLearner's ``evaluate_grounding``, ``evaluate_retrieval`` (plain and
with the backbone ensemble) and greedy captioning (full re-run and
KV-cached), the four evaluators, and the pipeline's
``evaluate_grounding_items``, ``evaluate_captioning_items``,
``evaluate_retrieval_items`` and ``evaluate_classification_items``
against JAX's ``XDecoderPipeline`` over the same items.

Models: the tiny config of ``tests/test_torch_xdecoder.py`` with a text
tower of width 32, 2 layers and 4 heads, CLIP's vocabulary (49408 ids, so
that the start-of-text id 49406 is in range) and 77 caption slots, and
``retrieval_ensemble`` on (``backbone_proj`` bridged both ways); the
decoder's own tests take a standalone 3-layer decoder (one round) on
random level maps. fp32; random weights from numpy, bridged. JAX's model
methods are compiled once (:class:`JaxMethods`), and the tests that share
one are next to each other. Tolerance: the JAX suite's fp32 bar, atol =
rtol = 1e-4; ids exactly, each greedy step's top-2 logit margin asserted
well above the two port paths' logit difference, so that a near-tie fails
loudly.

The pipeline items are the JAX package's synthetic sets
(``synthetic_refcoco``, ``synthetic_captioning``, ``synthetic_retrieval``,
``synthetic_classification``) at 64^2, handed to both pipelines (JAX's
``build_dataset`` patched to return them), plus a grounding item of two
phrases whose gt is smaller than the padded image. JAX's pipeline runs as
it is, its model calls through :class:`JaxMethods` (``jax.jit`` made the
identity inside the pipeline, so that its per-call wrappers do not
compile the model again). The metrics agree to 1e-9.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iuvl_tpu.data.datasets as jdatasets
import iuvl_tpu.pipeline as jpipeline
from iuvl_tpu.data import build_dataset
from iuvl_tpu.evaluation import CaptioningEvaluator as JCaptioning
from iuvl_tpu.evaluation import ClassificationEvaluator as JClassification
from iuvl_tpu.evaluation import GroundingEvaluator as JGrounding
from iuvl_tpu.evaluation import RetrievalEvaluator as JRetrieval
from iuvl_tpu.models.sam import build as jsb
from iuvl_tpu.models.xdecoder import unified_decoder as jud
from iuvl_tpu.models.xdecoder.model import SysLearner as JSysLearner
from iuvl_tpu.models.xdecoder.model import SysLearnerConfig as JConfig
from iuvl_tpu.pipeline import XDecoderPipeline
from iuvl_tpu_torch.data.class_names import get_class_names
from iuvl_tpu_torch.evaluation import (CaptioningEvaluator, ClassificationEvaluator,
                                       GroundingEvaluator, RetrievalEvaluator)
from iuvl_tpu_torch.models.sam import build as tsb
from iuvl_tpu_torch.models.sam import convert as sam_convert
from iuvl_tpu_torch.models.xdecoder import convert
from iuvl_tpu_torch.models.xdecoder import unified_decoder as tud
from iuvl_tpu_torch.models.xdecoder.model import SysLearner, SysLearnerConfig
from iuvl_tpu_torch.pipeline import (class_text_embeddings, evaluate_captioning_items,
                                     evaluate_classification_items, evaluate_grounding_items,
                                     evaluate_retrieval_items, resize_chw_np)
from tests.test_torch_xdecoder import TINY, TINY_SAM, bridged_params

VL = dict(TINY, contxt_len=77, text_width=32, text_layers=2, text_heads=4, vocab_size=49408,
          retrieval_ensemble=True)
TOL = dict(atol=1e-4, rtol=1e-4)
STEPS = 6  # greedy captioning steps
MIN_MARGIN = 1e-3  # a step's top-2 logit margin; the port's two paths part by ~1e-6
JIT = jax.jit  # JaxMethods compiles with it also where a test patches jax.jit
PIPE_CFG = {"NUM_CLASSES": 4, "CAPTIONING_STEPS": STEPS}


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(port, ref, name=""):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref, np.float32),
                               err_msg=name, **TOL)


class JaxMethods:
    """A JAX ``SysLearner`` whose ``apply`` runs one jitted program per
    (method, keyword arguments), compiled once per input shape. It stands
    in for the model in JAX's ``XDecoderPipeline`` (with ``jax.jit`` made
    the identity there), so that the pipeline's per-call ``jax.jit(lambda
    ...)`` wrappers do not compile the model again. Two methods are served
    by another's program, so that the model compiles once for both:
    ``evaluate_retrieval`` by ``evaluate_retrieval_ensemble``'s first
    output (the same expression in JAX's model: the class query's unit
    caption embedding), and ``evaluate_captioning`` (the full re-run) by
    ``evaluate_captioning_cached``, whose ids JAX's own suite holds equal to
    it (``tests/test_captioning_cache.py``)."""

    SERVED_BY = {JSysLearner.evaluate_retrieval: (JSysLearner.evaluate_retrieval_ensemble, 0),
                 JSysLearner.evaluate_captioning: (JSysLearner.evaluate_captioning_cached, None)}

    def __init__(self, module):
        self.module, self.cfg, self._fns = module, module.cfg, {}

    def _fn(self, method, kw):
        key = (method, tuple(sorted(kw.items())))
        if key not in self._fns:
            self._fns[key] = JIT(lambda p, *a: self.module.apply(p, *a, method=method, **kw))
        return self._fns[key]

    def apply(self, params, *args, method=None, **kw):
        # numpy inputs: a committed device array keys another compile
        args = jax.tree_util.tree_map(np.asarray, args)
        method, part = self.SERVED_BY.get(method, (method, None))
        out = self._fn(method, kw)(params, *args)
        return out if part is None else out[part]

    def with_cfg(self, **changes) -> "JaxMethods":
        """The same compiled methods under a config with ``changes`` (that
        the pipeline reads, not the model)."""
        other = copy.copy(self)
        other.cfg = dataclasses.replace(self.cfg, **changes)
        return other


def phrases(seed: int = 2, n: int = 2, ctx: int = 77):
    """(n, ctx) token ids: [sot, 8-20 words, eot, zeros] and their mask."""
    rs = np.random.RandomState(seed)
    ids = np.zeros((n, ctx), np.int32)
    mask = np.zeros((n, ctx), np.int32)
    for i in range(n):
        k = rs.randint(8, 21)
        ids[i, : k + 2] = [49406, *rs.randint(1, 49400, k), 49407]
        mask[i, : k + 2] = 1
    return ids, mask


def margins(logits: torch.Tensor) -> torch.Tensor:
    """Each (image, step)'s top-2 logit margin."""
    top = logits.topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


@pytest.fixture(scope="module")
def setup():
    """JAX's model (through JaxMethods) and its params, the port's with the
    same weights and the retrieval ensemble on, and without it (``plain``);
    two batch-1 images; two phrases and JAX's token embeddings of them."""
    jsb.SAM_VARIANTS["tiny_test"] = TINY_SAM
    tsb.SAM_VARIANTS["tiny_test"] = TINY_SAM
    jx = JaxMethods(JSysLearner(cfg=JConfig(**VL, attn_impl="auto", msdeform_impl="auto")))
    cfg = SysLearnerConfig(**VL)
    params = bridged_params(cfg)
    tm = SysLearner(cfg).eval()
    tm.load_state_dict(convert.flax_to_state_dict(params, cfg), strict=True)
    plain = SysLearner(dataclasses.replace(cfg, retrieval_ensemble=False)).eval()
    plain.load_state_dict({k: v for k, v in tm.state_dict().items()
                           if not k.startswith("backbone_proj.")})
    rs = np.random.RandomState(1)
    images = (rs.rand(2, 1, 64, 64, 3) * 255).astype(np.float32)
    ids, mask = phrases()
    tok, cls = jx.apply(params, ids, mask, method=JSysLearner.encode_text_tokens)
    return dict(jx=jx, params=params, tm=tm, plain=plain, cfg=cfg, images=images, ids=ids,
                mask=mask, tok=np.asarray(tok), cls=np.asarray(cls))


def _items(name: str, n: int, **cfg) -> list:
    ds = build_dataset(name, dict(IMAGE_SIZE=64, LENGTH=n, **cfg), "val")
    return [ds[i] for i in range(n)]


def _jax_pipeline(setup, monkeypatch, name: str, items: list, ensemble: bool = True, **cfg):
    """JAX's ``_evaluate_dataset`` for ``name`` over ``items``."""
    pipe = XDecoderPipeline({**PIPE_CFG, **cfg})
    pipe.model = setup["jx"] if ensemble else setup["jx"].with_cfg(retrieval_ensemble=False)
    with monkeypatch.context() as m:
        m.setattr(jdatasets, "build_dataset", lambda *a: items)
        m.setattr(jpipeline, "build_dataset", lambda *a: items)
        m.setattr(jax, "jit", lambda f, **kw: f)
        return pipe._evaluate_dataset(setup["params"], name)


def _same(got: dict, want: dict, min_keys: int):
    assert got.keys() == want.keys() and len(got) >= min_keys, (got, want)
    for key, v in want.items():
        assert got[key] == pytest.approx(v, rel=1e-9, abs=1e-9), key


def test_bridge_round_trip_with_backbone_proj(setup):
    """``retrieval_ensemble`` adds ``backbone_proj`` (res5 width -> dim, no
    bias) to the model and the bridge, both ways exactly: the tree of the
    plain config plus that one kernel. JAX's ``evaluate_retrieval_ensemble``
    (test_evaluate_retrieval_matches_jax) reads it from this tree."""
    params, cfg, tm = setup["params"], setup["cfg"], setup["tm"]
    sd = convert.flax_to_state_dict(params, cfg)
    assert set(sd) == set(tm.state_dict())
    kernel = np.asarray(params["params"]["backbone_proj"]["kernel"])
    assert kernel.shape == (tm.image_encoder.neck.down_32[2].out_channels, 32)
    np.testing.assert_array_equal(sd["backbone_proj.weight"].numpy(), kernel.T)
    back = convert.state_dict_to_flax(sd, cfg)
    flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    ref = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(flat) == len(ref)
    for path, leaf in ref:
        np.testing.assert_array_equal(flat[path], np.asarray(leaf), err_msg=str(path))
    plain = dataclasses.replace(cfg, retrieval_ensemble=False)
    assert not hasattr(SysLearner(plain), "backbone_proj")
    plain_paths = {p for p, _ in jax.tree_util.tree_flatten_with_path(bridged_params(plain))[0]}
    extra = {jax.tree_util.keystr(p) for p, _ in ref} - {jax.tree_util.keystr(p)
                                                         for p in plain_paths}
    assert extra == {"['params']['backbone_proj']['kernel']"}
    assert len(ref) == len(plain_paths) + 1


def test_text_tower_token_and_cached_paths_match_jax(setup):
    """``forward_language_token`` (with and without ``norm``),
    ``forward_language(norm=False)`` and ``compute_similarity`` against
    JAX's; the KV-cached ``forward_token_step`` rows against JAX's and
    against the port's own full forward, position by position, past the eot
    into the padding."""
    jx, params, tm, ids = (setup[k] for k in ("jx", "params", "tm", "ids"))
    v_emb = np.random.RandomState(9).randn(2, 5, 32).astype(np.float32)

    def text_paths(m, ids, v_emb):
        return (m.encode_text_tokens(ids, norm=True), m.encode_text_embeddings(ids, norm=False),
                m.lang_encoder.compute_similarity(v_emb, m.encode_text_embeddings(ids)))

    ref_norm, ref_unnormed, ref_sim = jx.apply(params, ids, v_emb, method=text_paths)
    with torch.no_grad():
        for norm, ref in ((False, (setup["tok"], setup["cls"])), (True, ref_norm)):
            got = tm.encode_text_tokens(torch.from_numpy(ids), norm=norm)
            _close(got[0], ref[0], f"token_x norm={norm}")
            _close(got[1], ref[1], f"class_x norm={norm}")
        _close(tm.encode_text_embeddings(torch.from_numpy(ids), norm=False), ref_unnormed,
               "unnormed")
        _close(tm.lang_encoder.compute_similarity(
            _t(v_emb), tm.encode_text_embeddings(torch.from_numpy(ids))), ref_sim, "similarity")
        full, _ = tm.encode_text_tokens(torch.from_numpy(ids))

    def token_step(m, ids_t, pos, caches):
        return m.lang_encoder.forward_token_step(ids_t, pos, caches)

    steps = 24  # past every phrase's eot, into the padding
    jcaches = [(np.zeros((2, 77, 32), np.float32),) * 2 for _ in range(2)]
    caches = tm.lang_encoder.init_text_cache(2)
    ref, got = [], []
    for t in range(steps):
        row, jcaches = jx.apply(params, ids[:, t], t, jcaches, method=token_step)
        ref.append(np.asarray(row)[:, 0])
        with torch.no_grad():
            got.append(tm.lang_encoder.forward_token_step(torch.from_numpy(ids[:, t]), t,
                                                          caches)[0][:, 0])
    got = torch.stack(got, dim=1)
    _close(got, np.stack(ref, axis=1), "forward_token_step rows vs JAX")
    np.testing.assert_allclose(got.numpy(), full[:, :steps].numpy(), atol=2e-5, rtol=2e-5)


def _layer_entries() -> list:
    """The bridge entries of one decoder layer: ``predictor_entries``' for
    ``layers.0`` (``layer0``), without that prefix."""
    return [(port[len("layers.0."):], flax[1:], kind)
            for port, flax, kind in convert.predictor_entries(1, prefix="", flax=())
            if port.startswith("layers.0.")]


def _randomize_(module: torch.nn.Module, rs: np.random.RandomState) -> None:
    """Seeded weights: at fan-in scale, biases 0.1, norm scales near one."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            scale = 0.1 if name.endswith("bias") else 1 / np.sqrt(p.shape[-1])
            base = 1.0 if "norm" in name and name.endswith("weight") else 0.0
            p.copy_(torch.from_numpy((base + scale * rs.randn(*p.shape)).astype(np.float32)))


def test_caption_step_row_matches_full_layer_row():
    """One decoder layer: each caption row through ``caption_step`` (the
    query block's projections from ``collect_kv``, the caption caches
    filled row by row) against its row of the full [queries; captions]
    pass under the base self-mask, and against JAX's ``caption_step``."""
    rs = np.random.RandomState(3)
    b, nq, n_cap, c, hw = 2, 5, 4, 16, 12
    arrays = [rs.randn(b, n, c).astype(np.float32) for n in (nq, n_cap, nq, n_cap, hw, hw)]
    layer = tud.DecoderLayer(c, 4, 32, torch.float32)
    _randomize_(layer, rs)
    jp = {"params": sam_convert.to_flax(layer.state_dict(), _layer_entries())}

    mask = tud.build_base_self_mask(nq, n_cap)
    bias = torch.zeros(mask.shape).masked_fill(torch.from_numpy(mask), tud.NEG_INF)[None, None]
    tgt_q, caps, qpos, cpos, mem, mpos = (_t(x) for x in arrays)
    with torch.no_grad():
        full, _ = layer(torch.cat([tgt_q, caps], 1), mem, torch.cat([qpos, cpos], 1), mpos, None,
                        bias)
        _, q_kv = layer(tgt_q, mem, qpos, mpos, None, bias[..., :nq, :nq], collect_kv=True)
        cap_k, cap_v = torch.zeros(b, n_cap, c), torch.zeros(b, n_cap, c)
        rows = torch.cat([layer.caption_step(caps[:, t: t + 1], cpos[:, t: t + 1], q_kv,
                                             cap_k, cap_v, t) for t in range(n_cap)], dim=1)
    np.testing.assert_allclose(rows.numpy(), full[:, nq:].numpy(), atol=2e-5, rtol=2e-5)

    jlayer = jud.DecoderLayer(d_model=c, nhead=4, dim_feedforward=32)

    @jax.jit
    def jax_rows(p, tgt_q, caps, qpos, cpos, mem, mpos, q_bias):
        _, (q_k, q_v) = jlayer.apply(p, tgt_q, mem, qpos, mpos, None, q_bias, collect_kv=True)
        jk = jv = jnp.zeros((b, n_cap, c))
        out = []
        for t in range(n_cap):
            e, jk, jv = jlayer.apply(p, caps[:, t: t + 1], cpos[:, t: t + 1], mem, mpos, q_k,
                                     q_v, jk, jv, t, method=jud.DecoderLayer.caption_step)
            out.append(e)
        return jnp.concatenate(out, axis=1), jk

    ref, ref_k = jax_rows(jp, *arrays, bias[..., :nq, :nq].numpy())
    _close(rows, ref, "caption_step vs JAX")
    _close(cap_k, ref_k, "caption k cache")


# The standalone decoder: one round over the three levels (3 layers).
DEC = dict(hidden_dim=32, dim_proj=32, num_queries=11, contxt_len=7, nheads=4,
           dim_feedforward=64, mask_dim=32, num_rounds=1)
LEVELS = (4, 8, 16)  # the level maps' sides; the mask features' is 16


def test_decoder_grounding_and_caption_tasks_match_jax():
    """A 3-layer unified decoder on random level maps against JAX's:
    ``grounding_eval`` (12 grounding tokens, the last 5 padding) with every
    layer's masks and caption embeddings over [obj; cls; dup]; ``vlp`` with
    every layer's captioning embeddings, and its query rows' masks as the
    seg task's; the cached caption decode (``captioning_prefill``, then
    ``caption_decode_step`` a row) against JAX's and against the ``vlp``
    run's rows."""
    rs = np.random.RandomState(5)
    dec = tud.UnifiedDecoder(**DEC).eval()
    _randomize_(dec, rs)
    with torch.no_grad():  # the tables as flax draws them: unit normals, 0.02 projections
        for t in (dec.query_feat, dec.query_embed, dec.level_embed, dec.pos_embed_caping):
            t.copy_(torch.from_numpy(rs.randn(*t.shape).astype(np.float32)))
    jp = {"params": sam_convert.to_flax(
        dec.state_dict(), convert.predictor_entries(num_layers=3, prefix="", flax=()))}
    ms = [rs.randn(1, s, s, 32).astype(np.float32) for s in LEVELS]
    mf = rs.randn(1, 16, 16, 32).astype(np.float32)
    gtok = rs.randn(1, 12, 32).astype(np.float32)
    gvalid = np.arange(12)[None] < 7
    ctok = rs.randn(1, 7, 32).astype(np.float32)
    jdec = jud.UnifiedDecoder(**DEC)

    @jax.jit
    def jax_tasks(p, ms, mf, gtok, gvalid, ctok):
        ground = jdec.apply(p, ms, mf, task="grounding_eval", grounding_tokens=gtok,
                            grounding_valid=gvalid)
        vlp = jdec.apply(p, ms, mf, task="vlp", caption_tokens=ctok)
        prefill = jdec.apply(p, ms, mf, method=jud.UnifiedDecoder.captioning_prefill)
        caches = jdec.apply(p, 1, method=jud.UnifiedDecoder.init_caption_cache)
        rows = []
        for t in range(4):
            row, caches = jdec.apply(p, prefill, caches, ctok[:, t: t + 1], t,
                                     method=jud.UnifiedDecoder.caption_decode_step)
            rows.append(row)
        return ground, vlp, jnp.stack(rows, axis=1)

    ground, vlp, ref_rows = jax.tree_util.tree_map(
        np.asarray, jax_tasks(jp, ms, mf, gtok, gvalid, ctok))
    tms, tmf = [_t(x) for x in ms], _t(mf)
    with torch.no_grad():
        got = dec(tms, tmf, task="grounding_eval", grounding_tokens=_t(gtok),
                  grounding_valid=torch.from_numpy(gvalid))
        got_vlp = dec(tms, tmf, task="vlp", caption_tokens=_t(ctok))
        seg = dec(tms, tmf)
        prefill = dec.captioning_prefill(tms, tmf)
        caches = dec.init_caption_cache(1)
        rows = torch.stack([dec.caption_decode_step(prefill, caches, _t(ctok[:, t: t + 1]), t)[0]
                            for t in range(4)], dim=1)
    assert got["pred_masks"].shape == (1, 21, 16, 16) and got["pred_logits"] is None
    for layer, (o, r) in enumerate(zip(got["aux_outputs"] + [got],
                                       ground["aux_outputs"] + [ground])):
        for key in ("pred_masks", "pred_captions"):
            _close(o[key], r[key], f"grounding layer {layer} {key}")
    assert got_vlp["pred_captionings"].shape == (1, 7, 32)
    for layer, (o, r) in enumerate(zip(got_vlp["aux_captionings"] + [got_vlp["pred_captionings"]],
                                       vlp["aux_captionings"] + [vlp["pred_captionings"]])):
        _close(o, r, f"vlp layer {layer} captionings")
    _close(got_vlp["pred_masks"], vlp["pred_masks"], "vlp pred_masks")
    np.testing.assert_allclose(got_vlp["pred_masks"].numpy(), seg["pred_masks"].numpy(),
                               atol=1e-5, rtol=1e-5)
    _close(rows, ref_rows, "caption_decode_step rows vs JAX")
    np.testing.assert_allclose(rows.numpy(), got_vlp["pred_captionings"][:, :4].numpy(),
                               atol=2e-5, rtol=2e-5)


def test_evaluate_grounding_matches_jax(setup):
    """``evaluate_grounding`` end to end, each phrase on its own as the
    pipeline runs it (phrase 0 with half of its tokens marked padding): the
    matched query's mask, bicubically resized to 64^2 (jax.image.resize's
    kernel: F.interpolate would miss the bound); with a query given, its
    mask."""
    jx, params, tm = setup["jx"], setup["params"], setup["tm"]
    image, tok, cls = setup["images"][0], setup["tok"], setup["cls"]
    valid = setup["mask"].astype(bool)
    valid[0, 5:] = False
    for i in range(2):
        args = (tok[i: i + 1], valid[i: i + 1], cls[None, i: i + 1])
        ref = jx.apply(params, image, *args, method=JSysLearner.evaluate_grounding)
        with torch.no_grad():
            targs = (_t(args[0]), torch.from_numpy(args[1]), _t(args[2]))
            got, matched = tm.evaluate_grounding(_t(image), *targs, return_matched=True)
            other = (matched + 1) % setup["cfg"].mask_proposals
            forced = tm.evaluate_grounding(_t(image), *targs, matched=other)
        assert got.shape == (1, 1, 64, 64) and matched.shape == (1, 1)
        _close(got, ref, f"phrase {i}")
        _close(got[..., [0, -1], :], np.asarray(ref)[..., [0, -1], :], f"phrase {i} edge rows")
        assert not torch.allclose(forced, got)


def test_grounding_items_match_jax_pipeline(setup, monkeypatch):
    """Two synthetic_refcoco items and an item of two phrases whose gt
    (48 x 40) is smaller than the padded 64^2 image (the logits cropped to
    64 x 53 and resized to the gt on the host)."""
    items = _items("synthetic_refcoco", 2)
    ids, mask = phrases(seed=4)
    gt = np.zeros((48, 40), bool)
    gt[10:40, 5:30] = True
    items.append({**items[0], "image": items[1]["image"], "texts": ["a", "b"], "text_ids": ids,
                  "text_mask": mask, "gt_mask": gt, "height": 48, "width": 40})
    want = _jax_pipeline(setup, monkeypatch, "synthetic_refcoco", items)
    got = evaluate_grounding_items(setup["tm"], items, name="synthetic_refcoco")
    _same(got, want, 7)
    assert 0 < got["synthetic_refcoco/cIoU"] < 100


def test_evaluate_retrieval_matches_jax(setup):
    """``evaluate_retrieval`` and ``evaluate_retrieval_ensemble`` (the class
    query's and the backbone's unit embeddings) against JAX's."""
    jx, params, tm = setup["jx"], setup["params"], setup["tm"]
    for image in setup["images"]:
        ref_v, ref_v2 = jx.apply(params, image, method=JSysLearner.evaluate_retrieval_ensemble)
        with torch.no_grad():
            got = tm.evaluate_retrieval(_t(image))
            v, v2 = tm.evaluate_retrieval_ensemble(_t(image))
        _close(got, ref_v, "evaluate_retrieval")
        _close(v, ref_v, "ensemble: class query")
        _close(v2, ref_v2, "ensemble: backbone")
        np.testing.assert_array_equal(got.numpy(), v.numpy())
        assert abs(float((v * v2).sum())) < 0.99  # two different embeddings


@pytest.mark.parametrize("ensemble", [False, True])
def test_retrieval_items_match_jax_pipeline(setup, monkeypatch, ensemble):
    """ir@k / tr@k of three synthetic_retrieval items, with the class
    query's embedding alone and with the backbone ensemble."""
    items = _items("synthetic_retrieval", 3)
    want = _jax_pipeline(setup, monkeypatch, "synthetic_retrieval", items, ensemble=ensemble)
    got = evaluate_retrieval_items(setup["tm" if ensemble else "plain"], items,
                                   name="synthetic_retrieval")
    _same(got, want, 5)


def test_classification_items_match_jax_pipeline(setup, monkeypatch):
    """Zero-shot top-k of three synthetic_classification items against the
    class embeddings (the prompt ensemble; the background row dropped)."""
    items = _items("synthetic_classification", 3, NUM_CLASSES=4)
    want = _jax_pipeline(setup, monkeypatch, "synthetic_classification", items)
    text = class_text_embeddings(setup["plain"], get_class_names("synthetic_classification", 4))
    assert text.shape == (5, 32)
    got = evaluate_classification_items(setup["plain"], text, items,
                                        name="synthetic_classification")
    _same(got, want, 2)


def test_captioning_ids_match_jax(setup):
    """Greedy captioning over STEPS steps on two images, full re-run and
    KV-cached: the ids equal JAX's (its cached decode's, which its suite
    holds equal to its full re-run's) and each other; the two port paths'
    per-step logits agree, every step's top-2 margin far above their
    difference; decoding along given ids gives the same logits."""
    jx, params, tm = setup["jx"], setup["params"], setup["tm"]
    for image in setup["images"]:
        ref = np.asarray(jx.apply(params, image, steps=STEPS,
                                  method=JSysLearner.evaluate_captioning_cached))
        with torch.no_grad():
            full, lf = tm.evaluate_captioning(_t(image), steps=STEPS, return_logits=True)
            cached, lc = tm.evaluate_captioning_cached(_t(image), steps=STEPS,
                                                       return_logits=True)
            forced, lt = tm.evaluate_captioning_cached(_t(image), steps=STEPS, forced_ids=full,
                                                       return_logits=True)
        assert lf.shape == (1, STEPS, 49408)
        diff = float((lf - lc).abs().max())
        low = float(torch.minimum(margins(lf), margins(lc)).min())
        assert diff < 1e-4 and low > max(MIN_MARGIN, 100 * diff), (low, diff)
        np.testing.assert_array_equal(cached.numpy(), ref)
        np.testing.assert_array_equal(full.numpy(), ref)
        assert (full[:, STEPS + 1:] == 49406).all() and len(np.unique(full[:, 1: STEPS + 1])) > 1
        np.testing.assert_array_equal(forced.numpy(), full.numpy())
        np.testing.assert_array_equal(lt.numpy(), lc.numpy())


@pytest.mark.parametrize("cached", [True, False])
def test_captioning_items_match_jax_pipeline(setup, monkeypatch, cached):
    """Greedy captions of two synthetic_captioning items over STEPS steps,
    decoded and scored: KV-cached (the default) and, on request, re-running
    the decoder a token (JAX's CAPTIONING_FULL_RERUN, its model call served
    by the cached decode: :class:`JaxMethods`)."""
    items = _items("synthetic_captioning", 2)
    want = _jax_pipeline(setup, monkeypatch, "synthetic_captioning", items,
                         CAPTIONING_FULL_RERUN=not cached)
    got = evaluate_captioning_items(setup["tm"], items, name="synthetic_captioning",
                                    steps=STEPS, cached=cached)
    _same(got, want, 2)


def test_vl_evaluators_match_jax():
    """The port's copies of the grounding, retrieval (plain, ensemble and
    p2i), captioning and classification evaluators on synthetic inputs:
    the same metrics as JAX's."""
    rs = np.random.RandomState(7)
    pairs = {"grounding": (GroundingEvaluator(), JGrounding()),
             "retrieval": (RetrievalEvaluator(), JRetrieval()),
             "ensemble": (RetrievalEvaluator(ensemble=True), JRetrieval(ensemble=True)),
             "p2i": (RetrievalEvaluator(mode="p2i"), JRetrieval(mode="p2i")),
             "captioning": (CaptioningEvaluator(), JCaptioning()),
             "classification": (ClassificationEvaluator(), JClassification())}
    words = ["a", "dog", "cat", "near", "the", "red", "car", "on", "grass", "two"]
    for i in range(6):
        gt = rs.rand(16, 16) > 0.5
        pred = gt ^ (rs.rand(16, 16) > 0.8)
        img, img2 = rs.randn(8), rs.randn(8)
        texts = rs.randn(2, 8) + img
        cap = " ".join(rs.choice(words, 6))
        refs = [" ".join(rs.choice(words, rs.randint(4, 9))) for _ in range(3)]
        logits, labels = rs.randn(3, 10), rs.randint(0, 10, 3)
        for name, evs in pairs.items():
            for ev in evs:
                if name == "grounding":
                    ev.process(pred, gt)
                elif name in ("retrieval", "ensemble", "p2i"):
                    ev.process(img, i, texts, [i, i], image_emb2=img2)
                elif name == "captioning":
                    ev.process(cap, refs)
                else:
                    ev.process(logits, labels)
    for name, (port, ref) in pairs.items():
        got, want = port.evaluate(), ref.evaluate()
        assert got == want and len(got) >= 2, (name, got, want)
        assert all(np.isfinite(v) for v in got.values()), name
    assert 0 < pairs["captioning"][0].evaluate()["CIDEr"]


def test_resize_chw_matches_jax():
    """The host resize (the port's copy of ``data/augment._resize``) equals
    JAX's ``_resize_chw_np``, shrinking and growing."""
    x = np.random.RandomState(0).randn(3, 30, 44).astype(np.float32)
    for h, w in ((17, 61), (64, 40), (30, 44)):
        np.testing.assert_array_equal(resize_chw_np(x, h, w), jpipeline._resize_chw_np(x, h, w))
