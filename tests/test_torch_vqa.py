"""The port's VQA path against the JAX package's on the CPU: the prompt
strings and templates, ``tokenizer_image_token``, ``splice_image_features``
(in the row, clamped at its end, and too long), the unified decoder's
``'llm'`` task with ``forward_llm_features``, ``answer_questions`` (ids and
strings, greedy and 3 beams, a right-padded batch of 2), ``caption_images``,
``pipeline.evaluate_vqa_items`` against JAX's ``_evaluate_vqa``, and the
VQA evaluator.

Models: the tiny SysLearner of ``tests/test_vqa_pipeline.py`` (the
X-Decoder tests' ``TINY`` with a 32-wide, 2-layer text tower over CLIP's
49408 ids and ``llm_dim`` 32) and a LLaMA of dim 32, 2 layers, 4 heads, FFN
64 and 128 cache slots over 49408 ids (HashWord's ids reach 49404); fp32,
numpy weights bridged (the pipeline test's LLM: JAX's own init, seed 1,
as ``_evaluate_vqa`` draws it). JAX's SysLearner runs one jitted program
(:class:`JaxVqa`), its LLM as its pipeline runs it. Tolerance: the JAX
suite's fp32 bar, atol = rtol = 1e-4; ids exactly, each greedy step's
top-2 logit margin above 1e-3.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iuvl_tpu.data.datasets as jdatasets
import iuvl_tpu.models.llm.multimodal as jmm
import iuvl_tpu.models.llm.vqa_pipeline as jvqa
import iuvl_tpu.pipeline as jpipeline
from iuvl_tpu.data.tokenizer import build_tokenizer as jbuild_tokenizer
from iuvl_tpu.evaluation.vqa import VQAEvaluator as JVQAEvaluator
from iuvl_tpu.evaluation.vqa import normalize_answer as jnormalize
from iuvl_tpu.models.llm import conversation as jconv
from iuvl_tpu.models.llm.convert import convert_llama
from iuvl_tpu.models.llm.llama import LlamaConfig as JLlamaConfig
from iuvl_tpu.models.llm.llama import LlamaForCausalLM as JLlama
from iuvl_tpu.models.sam import build as jsb
from iuvl_tpu.models.xdecoder.model import SysLearner as JSysLearner
from iuvl_tpu.models.xdecoder.model import SysLearnerConfig as JConfig
from iuvl_tpu.pipeline import XDecoderPipeline
from iuvl_tpu_torch.data.tokenizer import build_tokenizer
from iuvl_tpu_torch.evaluation.vqa import VQAEvaluator, normalize_answer
from iuvl_tpu_torch.models.llm import conversation
from iuvl_tpu_torch.models.llm.convert import flax_to_llama_state_dict
from iuvl_tpu_torch.models.llm.llama import LlamaConfig, build_llama
from iuvl_tpu_torch.models.llm.multimodal import (IGNORE_INDEX, IMAGE_TOKEN_INDEX,
                                                  greedy_generate,
                                                  splice_image_features, tokenizer_image_token)
from iuvl_tpu_torch.models.llm.vqa_pipeline import (answer_questions, build_vqa_prompt,
                                                    caption_images, vqa_inputs)
from iuvl_tpu_torch.models.sam import build as tsb
from iuvl_tpu_torch.models.xdecoder import convert
from iuvl_tpu_torch.models.xdecoder.model import SysLearner, SysLearnerConfig
from iuvl_tpu_torch.pipeline import build_llm, evaluate_vqa_items
from tests.test_torch_llm import hf_state_dict
from tests.test_torch_xdecoder import TINY, TINY_SAM, bridged_params

VQA = dict(TINY, text_width=32, text_layers=2, text_heads=4, vocab_size=49408, llm_dim=32)
LLM = dict(vocab_size=49408, dim=32, layers=2, heads=4, kv_heads=4, ffn_dim=64,
           max_seq_len=128, dtype="float32")
TOL = dict(atol=1e-4, rtol=1e-4)
MIN_MARGIN = 1e-3
JIT = jax.jit  # the proxy compiles with it also where a test patches jax.jit
QUESTIONS = ["what is in the image?", "is the cat on the left of the red sofa near a window?"]


def _close(port, ref, name=""):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref, np.float32),
                               err_msg=name, **TOL)


def llm_head(m, images, ctx):
    """The unified decoder's 'llm' task on the images and, from its
    features, ``forward_llm_features``' output (JAX's expression)."""
    _, fpn = m.encode_image(images)
    out = m._head(fpn, None, "llm", caption_tokens=ctx)
    return out, m.project_image_features(jax.lax.stop_gradient(out["image_feature"]))


class JaxVqa:
    """A JAX ``SysLearner`` whose ``apply`` runs one jitted program a
    method, compiled once, at batch 2 (a batch-1 call runs its row twice
    and keeps the first: the rows do not interact); ``forward_llm_features``
    is served by :func:`llm_head`'s program. It stands in for the model in
    JAX's ``answer_questions`` (with ``jax.jit`` made the identity there),
    which looks its methods up on ``type(model)``."""

    encode_text_tokens = JSysLearner.encode_text_tokens
    forward_llm_features = JSysLearner.forward_llm_features

    def __init__(self, module):
        self.module, self.cfg = module, module.cfg
        self._fns = {}

    def apply(self, params, *args, method=None):
        args = [np.asarray(a) for a in args]
        one = args[0].shape[0] == 1
        if one:
            args = [np.concatenate([a, a]) for a in args]
        served = method is JSysLearner.forward_llm_features
        key = llm_head if served else method
        if key not in self._fns:
            self._fns[key] = JIT(lambda p, *a: self.module.apply(p, *a, method=key))
        out = self._fns[key](params, *args)
        out = out[1] if served else out
        return jax.tree_util.tree_map(lambda x: x[:1], out) if one else out


@pytest.fixture(scope="module")
def setup():
    """The two SysLearners and the two LLMs on the same weights; two
    batch-1 images."""
    jsb.SAM_VARIANTS["tiny_test"] = TINY_SAM
    tsb.SAM_VARIANTS["tiny_test"] = TINY_SAM
    jx = JaxVqa(JSysLearner(cfg=JConfig(**VQA, attn_impl="auto", msdeform_impl="auto")))
    cfg = SysLearnerConfig(**VQA)
    params = bridged_params(cfg)
    tm = SysLearner(cfg).eval()
    tm.load_state_dict(convert.flax_to_state_dict(params, cfg), strict=True)
    sd = hf_state_dict(LlamaConfig(**LLM), seed=3)
    llm_params = convert_llama(sd, LLM["layers"])
    tllm = build_llama(LlamaConfig(**LLM), "cpu")
    tllm.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    rs = np.random.RandomState(4)
    images = (rs.rand(2, 64, 64, 3) * 255).astype(np.float32)
    return dict(jx=jx, params=params, tm=tm, cfg=cfg, jllm=JLlama(cfg=JLlamaConfig(**LLM)),
                llm_params=llm_params, tllm=tllm, images=images)


def test_prompts_and_templates_match_jax():
    for q in QUESTIONS:
        assert build_vqa_prompt(q) == jvqa.build_vqa_prompt(q)
    assert build_vqa_prompt(QUESTIONS[0]).endswith("ASSISTANT:")
    for name in ("vicuna_v1", "llama_2", "plain"):
        convs = []
        for mod in (conversation, jconv):
            c = mod.conv_templates[name].copy()
            c.append_message(c.roles[0], "hi <image>")
            c.append_message(c.roles[1], "a cat")
            c.append_message(c.roles[0], "and?")
            c.append_message(c.roles[1], None)
            convs.append(c.get_prompt())
        assert convs[0] == convs[1], name
    tok, jtok = build_tokenizer(), jbuild_tokenizer()
    for q in QUESTIONS:
        p = build_vqa_prompt(q)
        ids = tokenizer_image_token(p, tok)
        assert ids == jmm.tokenizer_image_token(p, jtok) and ids.count(IMAGE_TOKEN_INDEX) == 1
        assert all(1000 <= i < 49408 for i in ids if i != IMAGE_TOKEN_INDEX)


@pytest.mark.parametrize("case", ["in_row", "clamped", "too_long"])
def test_splice_matches_jax(setup, case):
    """Two rows (image token at 1 and at 5, the second row padded), labels
    too: the features in their slots (``in_row``); a row whose prefix runs
    the features past ``max_len``, which ``dynamic_update_slice`` moves back
    over the prefix's end (``clamped``); more features than ``max_len``
    raises on both sides (``too_long``)."""
    rs = np.random.RandomState(5)
    n_img, max_len = {"in_row": (4, 20), "clamped": (4, 12), "too_long": (13, 12)}[case]
    pre = 10 if case == "clamped" else 5
    ids = np.zeros((2, 16), np.int32)
    ids[0, :9] = [7, IMAGE_TOKEN_INDEX, *rs.randint(1000, 49000, 7)]
    ids[1, : pre + 4] = [*rs.randint(1000, 49000, pre), IMAGE_TOKEN_INDEX,
                         *rs.randint(1000, 49000, 3)]
    labels = np.where(ids == IMAGE_TOKEN_INDEX, IGNORE_INDEX, np.where(ids > 0, ids + 1, 0))
    feats = rs.randn(2, n_img, 32).astype(np.float32)
    jllm, lp, tllm = setup["jllm"], setup["llm_params"], setup["tllm"]

    def jembed(x):
        return jllm.apply(lp, x, method=JLlama.embed)

    if case == "too_long":
        with pytest.raises(TypeError):
            jmm.splice_image_features(ids, jembed, jnp.asarray(feats), labels=labels,
                                      max_len=max_len)
        with pytest.raises(ValueError):
            splice_image_features(ids, tllm.embed, torch.from_numpy(feats), labels=labels,
                                  max_len=max_len)
        return
    ref = jmm.splice_image_features(ids, jembed, jnp.asarray(feats), labels=labels,
                                    max_len=max_len)
    with torch.no_grad():
        got = splice_image_features(ids, tllm.embed, torch.from_numpy(feats), labels=labels,
                                    max_len=max_len)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    start = pre if case == "in_row" else max_len - n_img  # row 1's image slots
    np.testing.assert_array_equal(got[0][1, start: start + n_img].numpy(), feats[1])
    np.testing.assert_array_equal(got[0][0, 1: 1 + n_img].numpy(), feats[0])


def test_llm_task_and_forward_llm_features_match_jax(setup):
    """The 'llm' task's outputs (masks, caption embeddings, every layer's,
    and ``image_feature``: the object queries through the decoder norm) and
    the projected features, on a batch of 2 with the questions' token
    embeddings; 'vqa' is the same task. The bridge has ``img_to_lang`` (512
    -> llm_dim with its bias) and nothing else more."""
    jx, params, tm, cfg = (setup[k] for k in ("jx", "params", "tm", "cfg"))
    toks = build_tokenizer()(QUESTIONS, max_length=cfg.contxt_len)
    ctx, _ = jx.apply(params, toks["input_ids"], toks["attention_mask"],
                      method=JSysLearner.encode_text_tokens)
    ref_out, ref_feat = jx.apply(params, setup["images"], np.asarray(ctx), method=llm_head)
    images = torch.from_numpy(setup["images"])
    with torch.no_grad():
        tctx, _ = tm.encode_text_tokens(torch.from_numpy(toks["input_ids"]))
        _close(tctx, ctx, "context tokens")
        _, fpn = tm.encode_image(images, return_embedding=False)
        for task in ("llm", "vqa"):
            out = tm._head(fpn, None, task, caption_tokens=tctx)
            assert out["image_feature"].shape == (2, cfg.mask_proposals, 32)
            for key in ("pred_masks", "pred_captions", "image_feature"):
                _close(out[key], ref_out[key], f"{task} {key}")
            for i, (a, r) in enumerate(zip(out["aux_outputs"], ref_out["aux_outputs"])):
                _close(a["pred_masks"], r["pred_masks"], f"{task} aux {i}")
        feat = tm.forward_llm_features(images, tctx)
    _close(feat, ref_feat, "forward_llm_features")
    sd = convert.flax_to_state_dict(params, cfg)
    assert set(sd) == set(tm.state_dict())
    np.testing.assert_array_equal(sd["img_to_lang.weight"].numpy(),
                                  np.asarray(params["params"]["img_to_lang"]["kernel"]).T)
    plain = SysLearnerConfig(**dict(VQA, llm_dim=0))
    assert not hasattr(SysLearner(plain), "img_to_lang")
    assert set(sd) - set(SysLearner(plain).state_dict()) == {"img_to_lang.weight",
                                                              "img_to_lang.bias"}


_GENERATE = {}
J_GREEDY, J_BEAM = jmm.greedy_generate, jmm.beam_generate


def _jitted_generate(fn, record: list):
    """JAX's ``fn`` (greedy or beam) compiled once per (LLM config, keyword
    arguments, shapes), its ids appended to ``record``."""
    def wrapped(model, params, embeds, mask, **kw):
        key = (fn, model.cfg, tuple(sorted(kw.items())))
        if key not in _GENERATE:
            _GENERATE[key] = JIT(lambda p, e, m: fn(model, p, e, m, **kw))
        record.append(np.asarray(_GENERATE[key](params, np.asarray(embeds), np.asarray(mask))))
        return record[-1]
    return wrapped


@contextlib.contextmanager
def jax_llm_path(monkeypatch, record: list):
    """JAX's VQA path as its pipeline runs it, the model's methods through
    :class:`JaxVqa` (``jax.jit`` the identity) and the generators compiled
    whole (:func:`_jitted_generate`)."""
    with monkeypatch.context() as m:
        m.setattr(jax, "jit", lambda f, **_: f)
        m.setattr(jvqa, "greedy_generate", _jitted_generate(J_GREEDY, record))
        m.setattr(jmm, "beam_generate", _jitted_generate(J_BEAM, record))
        yield m


def _jax_answers(setup, monkeypatch, images, questions, **kw):
    """JAX's ``answer_questions`` and the ids its generator returned."""
    ids = []
    with jax_llm_path(monkeypatch, ids):
        texts = jvqa.answer_questions(setup["jx"], setup["params"], setup["jllm"],
                                      setup["llm_params"], jbuild_tokenizer(),
                                      jnp.asarray(images), questions, **kw)
    return texts, ids[0]


@pytest.mark.parametrize("beams", [1, 3])
def test_answer_questions_matches_jax(setup, monkeypatch, beams):
    """Two images, two questions of different lengths (the shorter row
    right-padded, its decode positions from the padded length): the ids
    and the decoded strings, greedy over 5 tokens and with 3 beams."""
    images = setup["images"]
    kw = dict(max_new_tokens=5, max_len=64, num_beams=beams)
    ref_texts, ref_ids = _jax_answers(setup, monkeypatch, images, QUESTIONS, **kw)
    texts, ids = answer_questions(setup["tm"], setup["tllm"], build_tokenizer(),
                                  torch.from_numpy(images), QUESTIONS, return_ids=True, **kw)
    np.testing.assert_array_equal(ids.numpy(), ref_ids)
    assert texts == ref_texts
    if beams == 1:
        embeds, attn, _ = vqa_inputs(setup["tm"], setup["tllm"], build_tokenizer(),
                                     torch.from_numpy(images), QUESTIONS, max_len=64)
        assert attn.shape[1] < 64 and int(attn[0].sum()) < attn.shape[1]
        _, logits = greedy_generate(setup["tllm"], embeds, attn, max_new_tokens=5,
                                    forced_ids=ids, return_logits=True)
        top = logits.topk(2, dim=-1).values
        assert float((top[..., 0] - top[..., 1]).min()) > MIN_MARGIN


def test_caption_images_matches_jax(setup, monkeypatch):
    """LLM captioning: one default prompt an image, greedy over 4 tokens."""
    images = setup["images"]
    ids = []
    with jax_llm_path(monkeypatch, ids):
        ref = jvqa.caption_images(setup["jx"], setup["params"], setup["jllm"],
                                  setup["llm_params"], jbuild_tokenizer(), jnp.asarray(images),
                                  max_new_tokens=4, max_len=64)
    texts, got = caption_images(setup["tm"], setup["tllm"], build_tokenizer(),
                                torch.from_numpy(images), max_new_tokens=4, max_len=64,
                                return_ids=True)
    np.testing.assert_array_equal(got.numpy(), ids[0])
    assert texts == ref


def test_vqa_items_match_jax_pipeline(setup, monkeypatch):
    """``evaluate_vqa_items`` against JAX's ``_evaluate_vqa`` on two items
    (two images, one question), 3 beams over 4 tokens, splice and cache at
    64: the LLM built from the same config keys (``build_llm``), with the
    weights JAX's pipeline draws (its init, seed 1) bridged; the first
    item's gt answers hold the port's answer, so that the accuracy is not
    zero unless the two pipelines part."""
    cfg = {"LLM": {"VOCAB_SIZE": 49408, "DIM": 32, "LAYERS": 2, "HEADS": 4, "KV_HEADS": 4,
                   "FFN_DIM": 64}, "LLM_MAX_LEN": 64, "DTYPE": "float32",
           "VQA_NUM_BEAMS": 3, "VQA_MAX_NEW_TOKENS": 4}
    jcfg = JLlamaConfig(**dict(LLM, max_seq_len=64))
    jparams = JLlama(cfg=jcfg).init(jax.random.PRNGKey(1), jnp.zeros((1, 4, 32), jnp.float32),
                                    jnp.ones((1, 4), jnp.int32))
    llm = build_llm(cfg, "cpu")
    assert llm.cfg == LlamaConfig(**dict(LLM, max_seq_len=64))
    llm.load_state_dict(flax_to_llama_state_dict(jparams, 2), strict=True)
    items = [{"image": setup["images"][i], "question": QUESTIONS[0],
              "answers": ["yes", "two", "a cat"]} for i in range(2)]
    first = answer_questions(setup["tm"], llm, build_tokenizer(),
                             torch.from_numpy(items[0]["image"][None]), [QUESTIONS[0]],
                             max_new_tokens=4, max_len=64, num_beams=3)[0]
    items[0]["answers"] += [first] * 2
    pipe = XDecoderPipeline(cfg)
    pipe.model = setup["jx"]
    with jax_llm_path(monkeypatch, []) as m:
        m.setattr(jdatasets, "build_dataset", lambda *a: items)
        m.setattr(jpipeline, "build_dataset", lambda *a: items)
        want = pipe._evaluate_vqa(setup["params"], "vqa")
    got = evaluate_vqa_items(setup["tm"], llm, items, "vqa", max_new_tokens=4, num_beams=3,
                             max_len=64)
    assert got.keys() == want.keys() == {"vqa/vqa_accuracy"}
    assert got["vqa/vqa_accuracy"] == pytest.approx(want["vqa/vqa_accuracy"], abs=1e-9)
    assert got["vqa/vqa_accuracy"] > 0


def test_vqa_evaluator_matches_jax():
    cases = [("Two", ["2", "two", "three"]), ("a cat.", ["cat", "Cat", "dog", "cat "]),
             ("black/white", ["black white"] * 4 + ["black and white"] * 6),
             ("isnt it", ["isn't it", "is not it"] + ["no"] * 8), ("3.5", ["3.5", "35"]),
             ("", [""]), ("yes, sir!", ["yes sir"] * 3)]
    ours, ref = VQAEvaluator(), JVQAEvaluator()
    for pred, gts in cases:
        assert normalize_answer(pred) == jnormalize(pred)
        ours.process(pred, gts)
        ref.process(pred, gts)
    assert ours.scores == ref.scores
    assert ours.evaluate() == ref.evaluate() and ours.evaluate()["vqa_accuracy"] > 0
    other = VQAEvaluator()
    other.merge(ours)
    assert other.evaluate() == ours.evaluate() and VQAEvaluator().evaluate() == {}
