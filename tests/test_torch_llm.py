"""The port's LLaMA / Vicuna (``iuvl_tpu_torch/models/llm``) against the JAX
package's on the CPU: the full-sequence forward, ``prefill`` (logits and
caches) and ``decode_step`` with multi-head and grouped-query attention,
RoPE up to the cache length, ``embed``'s out-of-range ids, greedy and beam
ids (3 and 5 beams, a beam reaching eos), the int8 quantiser (bit for bit)
and its model, the weight bridge and the HF checkpoint reader.

Tiny configs: vocab 64, dim 32, 2 layers, 4 heads (GQA: 2 kv heads), FFN
64, 32 cache slots, fp32; weights from numpy seeds in HF naming, through
JAX's own ``convert_llama`` into its tree. JAX's references are jitted.
Tolerance: the JAX suite's fp32 bar, atol = rtol = 1e-4 (logits, caches);
ids exactly, each step's top-2 logit margin asserted above 1e-3 where a
tie would flip one (the two packages' logits part by ~1e-6); int8 values
and scales bit for bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iuvl_tpu.models.llm import convert as jconvert
from iuvl_tpu.models.llm import multimodal as jmm
from iuvl_tpu.models.llm.llama import LlamaConfig as JConfig
from iuvl_tpu.models.llm.llama import LlamaForCausalLM as JLlama
from iuvl_tpu.models.llm.llama import rotary_embed as jrotary
from iuvl_tpu.models.llm.quant import quantize_llama_params, quantized_size_bytes as jbytes
from iuvl_tpu_torch.models.llm import convert, multimodal
from iuvl_tpu_torch.models.llm.llama import LlamaConfig, build_llama, rotary_embed
from iuvl_tpu_torch.models.llm.quant import quantize_llama_state_dict, quantized_size_bytes

TINY = dict(vocab_size=64, dim=32, layers=2, heads=4, kv_heads=4, ffn_dim=64, max_seq_len=32,
            dtype="float32")
CONFIGS = {"mha": TINY, "gqa": dict(TINY, kv_heads=2)}
TOL = dict(atol=1e-4, rtol=1e-4)
MIN_MARGIN = 1e-3


def hf_state_dict(cfg: LlamaConfig, seed: int = 0) -> dict:
    """Seeded numpy weights under the port's (HF) names: norms near one,
    tables 0.5 N(0, 1), projections at fan-in scale."""
    rs = np.random.RandomState(seed)
    with torch.device("meta"):
        shapes = build_llama(cfg, "meta").state_dict()
    out = {}
    for k, v in shapes.items():
        if k.endswith("norm.weight") or k.endswith("layernorm.weight"):
            a = 1.0 + 0.1 * rs.randn(*v.shape)
        elif "embed_tokens" in k or "lm_head" in k:
            a = 0.5 * rs.randn(*v.shape)
        else:
            a = rs.randn(*v.shape) / np.sqrt(v.shape[1])
        out[k] = a.astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def models(name: str, quant: str = "none"):
    """(JAX model, its params, the port's model with the same weights) of
    CONFIGS[name]; with ``quant='int8'`` both quantised from the fp weights
    by their own quantiser."""
    kw = dict(CONFIGS[name], quant=quant)
    sd = hf_state_dict(LlamaConfig(**CONFIGS[name]))
    params = jconvert.convert_llama(sd, kw["layers"])
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    if quant == "int8":
        params = quantize_llama_params(params)
        tsd = quantize_llama_state_dict(tsd)
    tm = build_llama(LlamaConfig(**kw), "cpu")
    tm.load_state_dict(tsd, strict=True)
    return JLlama(cfg=JConfig(**kw)), params, tm


@functools.lru_cache(maxsize=None)
def jitted(name: str, method: str, quant: str = "none", **static):
    jm = models(name, quant)[0]
    fn = {"forward": lambda p, e, m: jm.apply(p, e, m),
          "prefill": lambda p, e, m: jm.apply(p, e, m, method=JLlama.prefill),
          "greedy": lambda p, e, m: jmm.greedy_generate(jm, p, e, m, **static),
          "beam": lambda p, e, m, eos: jmm.beam_generate(jm, p, e, m, eos_id=eos, **static),
          }[method]
    return jax.jit(fn)


def prompt(cfg: dict, seed: int = 1, b: int = 2, t: int = 8):
    """(B, T) ids and a right-padded mask (row 1 two tokens shorter)."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, cfg["vocab_size"], (b, t))
    mask = np.ones((b, t), np.int32)
    if b > 1:
        mask[1, t - 2:] = 0
        ids[1, t - 2:] = 0
    return ids, mask


def embeds(name: str, ids):
    jm, params, tm = models(name)
    with torch.no_grad():
        te = tm.embed(torch.from_numpy(ids))
    return np.asarray(jm.apply(params, jnp.asarray(ids), method=JLlama.embed)), te


def _close(port, ref, name=""):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref, np.float32),
                               err_msg=name, **TOL)


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_matches_jax(name):
    cfg = CONFIGS[name]
    ids, mask = prompt(cfg)
    je, te = embeds(name, ids)
    np.testing.assert_array_equal(te.numpy(), je)
    ref = jitted(name, "forward")(models(name)[1], je, mask)
    with torch.no_grad():
        got = models(name)[2](te, torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (2, 8, cfg["vocab_size"])
    _close(got, ref, "logits")


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_and_decode_step_match_jax(name):
    """The prefill's last-position logits and every layer's cache, then two
    decode steps (right-padded prompt masked, positions from the padded
    length): their logits and caches."""
    cfg = CONFIGS[name]
    jm, params, tm = models(name)
    ids, mask = prompt(cfg)
    je, te = embeds(name, ids)
    jl, jc = jitted(name, "prefill")(params, je, mask)
    with torch.no_grad():
        tl, tc = tm.prefill(te, torch.from_numpy(mask))
    _close(tl, jl, "prefill logits")
    assert len(tc) == cfg["layers"]
    for i, (k, v) in enumerate(tc):
        assert k.shape == (2, cfg["max_seq_len"], cfg["kv_heads"], 8)
        _close(k, jc[i]["k"], f"prefill k {i}")
        _close(v, jc[i]["v"], f"prefill v {i}")
    step = jax.jit(lambda p, e, c, off, pm: jm.apply(p, e, c, off, pm,
                                                     method=JLlama.decode_step))
    pad = np.zeros((2, cfg["max_seq_len"]), bool)
    pad[:, :8] = mask == 0
    for off, tok in ((8, [[3], [5]]), (9, [[7], [1]])):
        tok = np.asarray(tok)
        jl, jc = step(params, jm.apply(params, jnp.asarray(tok), method=JLlama.embed), jc,
                      off, pad)
        with torch.no_grad():
            tl, tc = tm.decode_step(tm.embed(torch.from_numpy(tok)), tc, off,
                                    torch.from_numpy(pad))
        _close(tl, jl, f"decode logits at {off}")
        for i, (k, v) in enumerate(tc):
            _close(k, jc[i]["k"], f"decode k {i} at {off}")
            _close(v, jc[i]["v"], f"decode v {i} at {off}")


def test_rotary_embed_matches_jax_up_to_max_seq_len():
    """Vicuna's head width and theta, every position of its 1024 slots
    (angles up to 1023 rad). The two packages' fp32 ``theta ** x`` part by
    an ulp at some frequencies (~3e-8 of their value), which at position p
    moves an angle by up to ~3e-8 p: atol 1e-5 over the first 64 positions,
    4e-4 over all."""
    rs = np.random.RandomState(2)
    x = rs.randn(1, 1024, 2, 128).astype(np.float32)
    pos = np.arange(1024)[None]
    ref = np.asarray(jax.jit(lambda a, p: jrotary(a, p, 10000.0))(x, pos))
    got = rotary_embed(torch.from_numpy(x), torch.from_numpy(pos), 10000.0).numpy()
    np.testing.assert_allclose(got[:, :64], ref[:, :64], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, ref, atol=4e-4, rtol=1e-4)


def test_embed_out_of_range_ids_match_jax():
    """``jnp.take``'s semantics: ids past the table give NaN rows, negative
    ids count from its end (below -vocab: NaN)."""
    ids = np.asarray([[0, 63, 64, 500, -1, -64, -65, 7]])
    je, te = embeds("mha", ids)
    nan = np.isnan(je).all(-1)
    np.testing.assert_array_equal(nan, [[False, False, True, True, False, False, True, False]])
    np.testing.assert_array_equal(np.isnan(te.numpy()).all(-1), nan)
    np.testing.assert_array_equal(te.numpy()[~nan], je[~nan])


def _margins_ok(tm, te, mask, ids):
    """Each teacher-forced step's top-2 logit margin (the port's cache)."""
    ids = np.array(ids)
    with torch.no_grad():
        _, logits = multimodal.greedy_generate(tm, te, torch.from_numpy(mask),
                                               max_new_tokens=ids.shape[1],
                                               forced_ids=torch.from_numpy(ids),
                                               return_logits=True)
    top = logits.topk(2, dim=-1).values
    assert float((top[..., 0] - top[..., 1]).min()) > MIN_MARGIN


@pytest.mark.parametrize("name", CONFIGS)
def test_greedy_generate_matches_jax(name):
    cfg = CONFIGS[name]
    jm, params, tm = models(name)
    ids, mask = prompt(cfg, seed=3)
    je, te = embeds(name, ids)
    ref = np.asarray(jitted(name, "greedy", max_new_tokens=10)(params, je, mask))
    got = multimodal.greedy_generate(tm, te, torch.from_numpy(mask), max_new_tokens=10)
    np.testing.assert_array_equal(got.numpy(), ref)
    _margins_ok(tm, te, mask, ref)
    # Teacher forcing along its own ids gives its ids back.
    forced = multimodal.greedy_generate(tm, te, torch.from_numpy(mask), max_new_tokens=10,
                                        forced_ids=got)
    np.testing.assert_array_equal(forced.numpy(), ref)


@pytest.mark.parametrize("beams", [3, 5])
def test_beam_generate_matches_jax(beams):
    """A right-padded batch of 2 over 7 steps, with no eos and then with an
    eos that one of JAX's final beams reached (finished beams frozen, the
    length penalty at the first eos)."""
    name = "gqa"
    jm, params, tm = models(name)
    ids, mask = prompt(CONFIGS[name], seed=5)
    je, te = embeds(name, ids)
    jax_beam = jitted(name, "beam", max_new_tokens=7, num_beams=beams)
    ref = np.asarray(jax_beam(params, je, mask, -1))
    got = multimodal.beam_generate(tm, te, torch.from_numpy(mask), max_new_tokens=7,
                                   num_beams=beams, eos_id=-1)
    np.testing.assert_array_equal(got.numpy(), ref)
    # eos: the first of the best beam's later tokens that JAX's search
    # with it still emits before its last step
    for eos in ref[0, 1:]:
        with_eos = np.asarray(jax_beam(params, je, mask, int(eos)))
        if (with_eos[0, :-1] == eos).any():
            break
    assert (with_eos[0, :-1] == eos).any()
    got = multimodal.beam_generate(tm, te, torch.from_numpy(mask), max_new_tokens=7,
                                   num_beams=beams, eos_id=int(eos))
    np.testing.assert_array_equal(got.numpy(), with_eos)


def test_top_k_breaks_ties_by_lowest_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    vals, idx = multimodal.top_k(x, 4)
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_v))


def test_quantize_matches_jax_bit_for_bit():
    """The port's quantiser against JAX's numpy one on the same weights,
    one output channel all zero (scale 1): int8 values and fp32 scales
    equal, and the same bytes."""
    sd = hf_state_dict(LlamaConfig(**TINY), seed=4)
    sd["model.layers.0.self_attn.q_proj.weight"][3] = 0.0
    sd["model.layers.1.mlp.down_proj.weight"][5, :7] *= 1e-3
    params = quantize_llama_params(jconvert.convert_llama(sd, 2))
    got = quantize_llama_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    back = convert.llama_state_dict_to_flax(got, 2)
    leaves = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    mine = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert leaves.keys() == mine.keys()
    for path, ref in leaves.items():
        assert mine[path].dtype == np.asarray(ref).dtype, path
        np.testing.assert_array_equal(mine[path], np.asarray(ref), err_msg=str(path))
    assert float(got["model.layers.0.self_attn.q_proj.weight_scale"][3]) == 1.0
    assert quantized_size_bytes(got) == jbytes(params)


def test_int8_model_matches_jax():
    """``QuantLinear`` against ``QuantDense``: the forward's logits, then
    greedy ids through the cache; the projections' bytes under half of
    fp32's."""
    jm, params, tm = models("mha", "int8")
    ids, mask = prompt(TINY, seed=6)
    je = np.asarray(jm.apply(params, jnp.asarray(ids), method=JLlama.embed))
    te = tm.embed(torch.from_numpy(ids)).detach()
    ref = jitted("mha", "forward", "int8")(params, je, mask)
    with torch.no_grad():
        _close(tm(te, torch.from_numpy(mask)), ref, "int8 logits")
    ref = np.asarray(jitted("mha", "greedy", "int8", max_new_tokens=6)(params, je, mask))
    got = multimodal.greedy_generate(tm, te, torch.from_numpy(mask), max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), ref)
    # int8 values and an fp32 scale an output channel: 1/4 + 1/fan_in of fp32's bytes
    fp = {k: v for k, v in models("mha")[2].state_dict().items() if "proj" in k}
    q_bytes = quantized_size_bytes({k: v for k, v in tm.state_dict().items() if "proj" in k})
    assert q_bytes == sum(w.numel() + 4 * w.shape[0] for w in fp.values())


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_bridge_round_trip_is_exact(quant):
    """The port's state dict -> flax -> state dict, bit for bit, and the
    flax tree is JAX's own (paths, shapes, dtypes of ``init``)."""
    _, _, tm = models("gqa", quant)
    sd = tm.state_dict()
    tree = convert.llama_state_dict_to_flax(sd, 2)
    back = convert.flax_to_llama_state_dict(tree, 2)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    jm = JLlama(cfg=JConfig(**CONFIGS["gqa"]))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 4, 32)),
                            jnp.ones((1, 4), jnp.int32))
    if quant == "int8":
        shapes = quantize_llama_params(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                                    shapes))
    want = {p: (s.shape, np.dtype(s.dtype)) for p, s in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {p: (a.shape, a.dtype) for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert got == want


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_load_hf_llama_params(fmt, tmp_path):
    """A checkpoint directory written here (two shards, an extra buffer
    that the model does not have, fp16 and fp32 tensors) -> the model's
    weights, as JAX's loader reads them; the reader also takes bf16, which
    JAX's numpy reader does not."""
    cfg = LlamaConfig(**TINY)
    sd = {k: torch.from_numpy(v) for k, v in hf_state_dict(cfg, seed=7).items()}
    sd["model.embed_tokens.weight"] = sd["model.embed_tokens.weight"].half()
    extra = {"model.layers.0.self_attn.rotary_emb.inv_freq": torch.ones(4)}
    keys = sorted(sd)
    shards = [dict((k, sd[k]) for k in keys[:9]), dict((k, sd[k]) for k in keys[9:]) | extra]
    for i, shard in enumerate(shards):
        if fmt == "bin":
            torch.save(shard, tmp_path / f"pytorch_model-0000{i + 1}-of-00002.bin")
        else:
            from safetensors.torch import save_file

            save_file(shard, str(tmp_path / f"model-0000{i + 1}-of-00002.safetensors"))
    got = convert.load_hf_llama_params(str(tmp_path), cfg)
    assert got.keys() == sd.keys()
    for k, v in sd.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    ref = jconvert.load_hf_llama_params(str(tmp_path), JConfig(**TINY))
    mine = convert.llama_state_dict_to_flax(got, 2)
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(mine)[0],
                                 jax.tree_util.tree_flatten_with_path(ref)[0]):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32), err_msg=str(path))
    with pytest.raises(FileNotFoundError):
        convert.load_hf_llama_params(str(tmp_path / "none"), cfg)
    if fmt == "safetensors":
        from safetensors.torch import save_file

        more = {"bf16": torch.randn(3, 5).bfloat16(), "i8": torch.arange(-4, 4).to(torch.int8),
                "empty": torch.zeros(0, 2)}
        save_file(more, str(tmp_path / "more.st"))
        read = convert.read_safetensors(str(tmp_path / "more.st"))
        for k, v in more.items():
            assert read[k].dtype == v.dtype and torch.equal(read[k], v), k


def test_build_llama_draws_and_quantises_on_its_device():
    """One generator seed: the int8 model holds the int8 quantisation of
    the fp32 model's draws; the norms are one; the card is the default."""
    kw = dict(TINY, kv_heads=2)
    fp = build_llama(LlamaConfig(**kw), "cpu", torch.Generator().manual_seed(3))
    q = build_llama(LlamaConfig(**kw, quant="int8"), "cpu", torch.Generator().manual_seed(3))
    want = quantize_llama_state_dict(fp.state_dict())
    got = q.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert torch.equal(fp.model.norm.weight, torch.ones(32))
    assert dataclasses.replace(fp.cfg, quant="int8") == q.cfg
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            build_llama(LlamaConfig(**kw))
