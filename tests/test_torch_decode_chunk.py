"""The port's whole-chunk decode tail (B16's plain version, the chunk
branch of ``MaskDecoder`` and ``Sam``) against the JAX package on the CPU.

The JAX inputs of ``tests/test_decode_chunk.py`` ``_setup``: a 1 x 8 x 8 x
256 embedding, 2 sparse tokens a prompt (7 tokens, padded to 16 slots),
the full decoder width (C 256, 8 heads, MLP 2048). Numpy draws the inputs
and the biases, which flax initialises to zero. fp32 tolerance:
atol 3e-4, rtol 1e-4, the JAX suite's own for its chunk oracle.
"""

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iuvl_tpu.models.sam.build import Sam as JSam
from iuvl_tpu.models.sam.build import SamConfig as JSamConfig
from iuvl_tpu.models.sam.mask_decoder import MaskDecoder as JMaskDecoder
from iuvl_tpu.ops.pallas import decode_chunk as jdc
from iuvl_tpu_torch.models.sam import Sam, SamConfig
from iuvl_tpu_torch.models.sam.convert import flax_to_state_dict, mask_decoder_entries, to_port
from iuvl_tpu_torch.models.sam.mask_decoder import MaskDecoder
from iuvl_tpu_torch.ops.cuda import decode_chunk as dc

TOL = dict(atol=3e-4, rtol=1e-4)
B, GRID, C, T_VALID = 3, 8, 256, 7
OUT_KEYS = ("masks", "iou_pred", "upscaled_embedding", "hyper_in")


def _randomize(tree, rs, pattern=("bias", "scale", "weight")):
    """Each bias and norm parameter drawn: flax starts them at 0 and 1."""
    def f(path, x):
        if jax.tree_util.keystr(path).split("'")[-2] in pattern:
            return jnp.asarray(np.asarray(x) + rs.randn(*x.shape).astype(np.float32) * 0.2)
        return x
    return jax.tree_util.tree_map_with_path(f, tree)


def _jax_tail_weights(p):
    """The ``W`` that JAX's chunk branch hands ``decode_tail`` (flax
    layouts), read off the MaskDecoder's parameter tree."""
    names = ("q_proj", "k_proj", "v_proj", "out_proj")
    attn = lambda d: {**{f"w{n[0]}": d[n]["kernel"] for n in names},  # noqa: E731
                      **{f"b{n[0]}": d[n]["bias"] for n in names}}
    ln = lambda d: dict(scale=d["scale"], bias=d["bias"])  # noqa: E731
    tr = p["transformer"]
    l0, l1 = tr["layer0"], tr["layer1"]
    w = dict(i2t0=attn(l0["cross_attn_i2t"]), ln40=ln(l0["norm4"]), self1=attn(l1["self_attn"]),
             ln11=ln(l1["norm1"]), t2i1=attn(l1["cross_attn_t2i"]), ln21=ln(l1["norm2"]),
             mlp1=dict(w1=l1["mlp_lin1"]["kernel"], b1=l1["mlp_lin1"]["bias"],
                       w2=l1["mlp_lin2"]["kernel"], b2=l1["mlp_lin2"]["bias"]),
             ln31=ln(l1["norm3"]), i2t1=attn(l1["cross_attn_i2t"]), ln41=ln(l1["norm4"]),
             final=attn(tr["final_attn_t2i"]), lnf=ln(tr["norm_final_attn"]))
    for j in range(3):
        w[f"hyper_w{j + 1}"] = jnp.stack([p[f"hyper_mlp{i}"][f"lin{j}"]["kernel"]
                                          for i in range(4)])
        w[f"hyper_b{j + 1}"] = jnp.stack([p[f"hyper_mlp{i}"][f"lin{j}"]["bias"] for i in range(4)])
    w.update(up_k1=p["upscale_deconv1"]["kernel"], up_b1=p["upscale_deconv1"]["bias"],
             up_lnw=p["upscale_ln"]["weight"], up_lnb=p["upscale_ln"]["bias"],
             up_k2=p["upscale_deconv2"]["kernel"], up_b2=p["upscale_deconv2"]["bias"])
    return w


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(np.asarray(x, np.float32))).to(dtype)


@pytest.fixture(scope="module")
def setup():
    rs = np.random.RandomState(0)
    emb = rs.randn(1, GRID, GRID, C).astype(np.float32) * 0.5
    pe = rs.randn(GRID, GRID, C).astype(np.float32) * 0.5
    sparse = rs.randn(B, 2, C).astype(np.float32) * 0.5
    dense = rs.randn(1, GRID, GRID, C).astype(np.float32) * 0.1
    args = tuple(map(jnp.asarray, (emb, pe, sparse, dense)))
    params = jax.jit(JMaskDecoder(twoway_impl="off").init)(jax.random.PRNGKey(1), *args)
    params = {"params": _randomize(params["params"], rs)}
    port = MaskDecoder(twoway_impl="chunk").eval()
    port.load_state_dict(to_port(params["params"], mask_decoder_entries(prefix="", flax=())),
                         strict=True)
    # decode_tail's own inputs: 16 slots, the pad rows zero
    t = np.zeros((B, 16, C), np.float32)
    tpe = np.zeros((B, 16, C), np.float32)
    t[:, :T_VALID] = rs.randn(B, T_VALID, C)
    tpe[:, :T_VALID] = rs.randn(B, T_VALID, C) * 0.5
    keys0 = rs.randn(1, GRID * GRID, C).astype(np.float32) * 0.5
    key_pe = rs.randn(1, GRID * GRID, C).astype(np.float32) * 0.5
    return dict(args=args, np_args=(emb, pe, sparse, dense), params=params, port=port,
                tail=(t, tpe, keys0, key_pe), jw=_jax_tail_weights(params["params"]))


@pytest.fixture(scope="module")
def plain_out(setup):
    with torch.no_grad():
        return dc.decode_tail_plain(*map(_t, setup["tail"]), setup["port"].tail_weights(),
                                    8, T_VALID)


def _close(port, ref, name, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref, np.float32),
                               err_msg=name, **(tol or TOL))


def test_the_chunk_branch_reads_the_per_op_parameter_tree():
    """The weight bridge needs no change: JAX's chunk branch creates the
    same parameters, under the same paths and shapes, as its per-op path."""
    x = jnp.zeros((1, GRID, GRID, C))
    shapes = [jax.tree_util.tree_map(lambda a: a.shape, jax.eval_shape(
        JMaskDecoder(twoway_impl=impl).init, jax.random.PRNGKey(0), x, x[0],
        jnp.zeros((2, 2, C)), x)) for impl in ("off", "chunk_xla")]
    assert shapes[0] == shapes[1]


def test_decode_tail_plain_matches_decode_tail_xla(setup, plain_out):
    ref = jax.jit(lambda *a: jdc.decode_tail_xla(*a, n_heads=8, t_valid=T_VALID))(
        *setup["tail"], setup["jw"])
    for name, got, want in zip(("tokens_out", "masks_flat", "keys2"), plain_out, ref):
        _close(got, want, name)


@pytest.fixture
def interpret():
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    jdc.pl.pallas_call = interp
    try:
        yield
    finally:
        jdc.pl.pallas_call = orig


def test_decode_tail_plain_matches_the_pallas_kernel(setup, plain_out, interpret):
    ref = jdc.decode_tail(*map(jnp.asarray, setup["tail"]), setup["jw"], 8, T_VALID)
    for name, got, want in zip(("tokens_out", "masks_flat"), plain_out, ref):
        _close(got, want, name)


def _bf16_weights(w):
    """The port's tail weights in bf16; those it keeps in fp32 (the norms,
    block 0's token-side k and v) rounded to bf16 values."""
    bf = torch.bfloat16
    out = {}
    for k, x in w.items():
        if isinstance(x, dict):
            out[k] = {kk: v.to(bf) for kk, v in x.items()}
        elif k == "hyper":
            out[k] = tuple(tuple(y.to(bf) for y in layer) for layer in x)
        else:
            keep = k.startswith("ln") or k == "i2t0_kv"
            out[k] = tuple(y.to(bf).float() if keep or (k == "up" and i in (2, 3))
                           else y.to(bf) for i, y in enumerate(x))
    return out


def _bf16_case(setup):
    """The tail's inputs in bf16 for both packages, and the weights rounded
    to bf16 values: the port's, JAX's as fp32 (what its model hands the
    Pallas kernel) and JAX's as ``decode_tail_xla`` must get them to round
    as that kernel does (bf16, but block 0's token-side k and v fp32,
    which the kernel's wrapper computes from the fp32 parameters)."""
    jin = [jnp.asarray(a).astype(jnp.bfloat16) for a in setup["tail"]]
    jw32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16).astype(jnp.float32),
                                  setup["jw"])
    jw_xla = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jw32)
    jw_xla["i2t0"] = {**jw_xla["i2t0"], **{k: jw32["i2t0"][k] for k in ("wk", "bk", "wv", "bv")}}
    port = ([_t(a, torch.bfloat16) for a in setup["tail"]],
            _bf16_weights(setup["port"].tail_weights()))
    return jin, jw32, jw_xla, port


def _rel(a, b):
    return float(torch.linalg.vector_norm(a.detach().float() - b) / torch.linalg.vector_norm(b))


def _rels(got, ref):
    """rel L2 of (tokens on the valid slots, masks, keys2) to ``ref``."""
    cut = lambda j, x: x[:, :T_VALID] if j == 0 else x  # noqa: E731
    return [_rel(cut(j, g), cut(j, _t(r))) for j, (g, r) in enumerate(zip(got, ref))]


def _proj_rounded_once(x, w, b=None, pe=None):
    y = x.float() @ w.float().t()
    y = y if pe is None else y + pe.float()
    return (y if b is None else y + b.float()).to(x.dtype)


def _token_kv_rounded_per_product(t, tpe, kv):
    kw, kb, vw, vb = (y.to(t.dtype) for y in kv)
    return t @ kw.t() + tpe @ kw.t() + kb, t @ vw.t() + vb


BF16_BOUNDS = (4e-3, 1.2e-2, 4e-3)  # tokens, masks, keys2


def test_decode_tail_plain_bf16_rounds_as_jax(setup, monkeypatch):
    """bf16 against ``decode_tail_xla`` with the Pallas kernel's weight
    rounding, whose rounding points the plain version copies one for one:
    the two differ only in the order of fp32 sums, and one flipped bf16
    unit spreads from there (tokens 0.28%, masks 0.93%, keys2 0.31% in rel
    L2). The masks' distance is mostly the upscale's tanh GELU, which JAX
    on the CPU rounds step by step (see ``test_gelu_rule_matches_jax``).
    Bounds: 0.4% / 1.2% / 0.4%. Each control misses a rounding rule and
    must break a bound: the tail computed in fp32 and cast (tokens 0.60%,
    keys2 0.58%), each projection rounded once after its bias (0.60%,
    0.58%), block 0's token-side k and v rounded per product (0.56%,
    0.60%), the slot mask dropped (27%, 43%, 34%)."""
    jin, _, jw_xla, (inputs, port_w) = _bf16_case(setup)
    ref = jdc.decode_tail_xla(*jin, jw_xla, n_heads=8, t_valid=T_VALID)
    got = dc.decode_tail_plain(*inputs, port_w, 8, T_VALID)
    assert got[0].dtype == got[2].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    errs = _rels(got, ref)
    assert all(e < b for e, b in zip(errs, BF16_BOUNDS)), errs

    def fp32_tail():
        w = {k: ({kk: v.float() for kk, v in x.items()} if isinstance(x, dict) else
                 tuple(tuple(y.float() for y in layer) for layer in x) if k == "hyper" else
                 tuple(y.float() for y in x)) for k, x in port_w.items()}
        out = dc.decode_tail_plain(*[a.float() for a in inputs], w, 8, T_VALID)
        return out[0].bfloat16(), out[1], out[2].bfloat16()

    def patched(name, fn):
        def run():
            with monkeypatch.context() as m:
                m.setattr(dc, name, fn)
                return dc.decode_tail_plain(*inputs, port_w, 8, T_VALID)
        return run

    controls = {"fp32 tail": fp32_tail,
                "projections rounded once": patched("_proj", _proj_rounded_once),
                "token k, v rounded per product": patched("_i2t0_token_kv",
                                                          _token_kv_rounded_per_product),
                "slot mask dropped": lambda: dc.decode_tail_plain(*inputs, port_w, 8, 16)}
    for name, run in controls.items():
        errs = _rels(run(), ref)
        assert any(e > b for e, b in zip(errs, BF16_BOUNDS)), (name, errs)


def test_decode_tail_plain_bf16_matches_the_pallas_kernel(setup, interpret):
    """bf16 against JAX's Pallas kernel (interpret mode) on the fp32
    weights its model hands it. On the CPU, ``decode_tail_xla`` with the
    kernel's rounding lies 0.66% (tokens) and 1.26% (masks) from it in rel
    L2; the plain version lies 0.66% and 1.29% from it. Bound: 2%, which a tail with
    the slot mask dropped exceeds (27%, 43%)."""
    jin, jw32, _, (inputs, port_w) = _bf16_case(setup)
    ref = jdc.decode_tail(*jin, jw32, 8, T_VALID)
    got = dc.decode_tail_plain(*inputs, port_w, 8, T_VALID)[:2]
    masked = dc.decode_tail_plain(*inputs, port_w, 8, 16)[:2]
    assert all(e < 0.02 for e in _rels(got, ref)), _rels(got, ref)
    assert all(e > 0.1 for e in _rels(masked, ref)), _rels(masked, ref)


def test_gelu_rule_matches_jax():
    """The upscale's GELU: exact erf in fp32 (the tanh form is up to 2e-4
    off, so this pins it); in bf16 the tanh form, within one bf16 unit of
    JAX's, which rounds each of its steps to bf16 (near -4 its 1 + tanh is
    0): half the values differ by that unit."""
    x = np.linspace(-4, 4, 4001, dtype=np.float32)
    np.testing.assert_allclose(dc.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=False)),
                               atol=1e-6)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = dc.gelu(xb)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jax.nn.gelu(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                                  approximate=True).astype(jnp.float32))
    unit = 2.0 ** -6 * np.maximum(np.abs(want), 0.25)  # one bf16 unit and a little
    assert np.all(np.abs(got.float().numpy() - want) <= unit)


def test_mask_decoder_chunk_matches_jax_chunk_xla(setup):
    ref = jax.jit(JMaskDecoder(twoway_impl="chunk_xla").apply)(setup["params"], *setup["args"])
    with torch.no_grad():
        out = setup["port"](*map(_t, setup["np_args"]))
    assert set(out) == set(OUT_KEYS)
    for k in OUT_KEYS:
        _close(out[k], ref[k], k)


def test_mask_decoder_chunk_matches_the_per_op_path(setup):
    """The same weights through 'chunk', 'chunk_plain' and 'auto' (the
    per-op kernels' plain versions on the CPU)."""
    outs = {}
    for impl in ("chunk", "chunk_plain", "auto"):
        dec = MaskDecoder(twoway_impl=impl).eval()
        dec.load_state_dict(setup["port"].state_dict())
        with torch.no_grad():
            outs[impl] = dec(*map(_t, setup["np_args"]))
    for k in OUT_KEYS:
        assert torch.equal(outs["chunk"][k], outs["chunk_plain"][k]), k
        _close(outs["chunk"][k], outs["auto"][k].numpy(), k)
    with torch.no_grad():
        lean = setup["port"](*map(_t, setup["np_args"]), return_upscaled=False)
    assert set(lean) == {"masks", "iou_pred", "hyper_in"}


def test_chunk_decode_needs_a_batch_1_embedding(setup):
    emb, pe, sparse, dense = map(_t, setup["np_args"])
    with pytest.raises(ValueError, match="batch-1 image embedding"):
        setup["port"](emb.expand(B, -1, -1, -1), pe, sparse, dense)


def test_cpu_wrapper_runs_the_plain_version_and_counts_nothing(setup, plain_out):
    before = dc.decode_tail.launches
    with torch.no_grad():
        tok, masks = dc.decode_tail(*map(_t, setup["tail"]), setup["port"].tail_weights(), 8,
                                    T_VALID)
        with_keys2 = dc.decode_tail(*map(_t, setup["tail"]), setup["port"].tail_weights(), 8,
                                    T_VALID, return_keys2=True)
    assert dc.decode_tail.launches == before
    assert torch.equal(tok, plain_out[0]) and torch.equal(masks, plain_out[1])
    assert len(with_keys2) == 3 and all(map(torch.equal, with_keys2, plain_out))
    assert masks.dtype == torch.float32 and masks.shape == (B, GRID * GRID, 64)
    # 73 kernel operands in the C entry's order, each with a declared shape
    ops = dc._operands(*map(_t, setup["tail"]), setup["port"].tail_weights())
    assert len(ops) == 73 and set(dict(ops)) == set(dc._shapes(B, GRID * GRID))
    for name, x in ops:
        assert tuple(x.shape) == dc._shapes(B, GRID * GRID)[name], name


@pytest.fixture(scope="module")
def setup10():
    """Inputs over a 10 x 10 grid (N 100: no multiple of 16, 32, 64 or 256),
    drawn as ``setup`` draws its own, for the same decoder."""
    rs, grid = np.random.RandomState(10), 10
    emb = rs.randn(1, grid, grid, C).astype(np.float32) * 0.5
    pe = rs.randn(grid, grid, C).astype(np.float32) * 0.5
    sparse = rs.randn(B, 2, C).astype(np.float32) * 0.5
    dense = rs.randn(1, grid, grid, C).astype(np.float32) * 0.1
    t = np.zeros((B, 16, C), np.float32)
    tpe = np.zeros((B, 16, C), np.float32)
    t[:, :T_VALID] = rs.randn(B, T_VALID, C)
    tpe[:, :T_VALID] = rs.randn(B, T_VALID, C) * 0.5
    keys0 = rs.randn(1, grid * grid, C).astype(np.float32) * 0.5
    key_pe = rs.randn(1, grid * grid, C).astype(np.float32) * 0.5
    return dict(np_args=(emb, pe, sparse, dense), tail=(t, tpe, keys0, key_pe))


@pytest.mark.parametrize("ref", ["decode_tail_xla", "pallas", "chunk_xla"])
def test_decode_tail_at_a_10x10_grid_matches_jax(setup, setup10, ref, interpret):
    """Any key count (C7): decode_tail's plain version against JAX's
    decode_tail_xla and the interpret-mode Pallas kernel, and the chunk
    branch against JAX's chunk_xla, at N 100."""
    if ref == "chunk_xla":
        want = jax.jit(JMaskDecoder(twoway_impl="chunk_xla").apply)(
            setup["params"], *setup10["np_args"])
        with torch.no_grad():
            got = setup["port"](*map(_t, setup10["np_args"]))
        for k in OUT_KEYS:
            _close(got[k], want[k], k)
        return
    with torch.no_grad():
        got = dc.decode_tail_plain(*map(_t, setup10["tail"]), setup["port"].tail_weights(), 8,
                                   T_VALID)
    if ref == "decode_tail_xla":
        want = jax.jit(lambda *a: jdc.decode_tail_xla(*a, n_heads=8, t_valid=T_VALID))(
            *setup10["tail"], setup["jw"])
    else:
        want = jdc.decode_tail(*map(jnp.asarray, setup10["tail"]), setup["jw"], n_heads=8,
                               t_valid=T_VALID)
    assert got[1].shape == (B, 100, 64)
    for name, g, w in zip(("tokens_out", "masks_flat", "keys2"), got, want):
        _close(g, w, name)


def test_unflatten_masks_ge_matches_jax():
    flat = np.random.RandomState(3).randn(2, 12, 64).astype(np.float32)
    _close(dc.unflatten_masks_ge(_t(flat), 3, 4, 4), jdc.unflatten_masks_ge(flat, 3, 4, 4),
           "masks", atol=0, rtol=0)


TINY = dict(embed_dim=32, depth=2, num_heads=2, global_attn_indexes=(1,), img_size=128,
            window_size=4)


def test_sam_decode_from_embedding_chunk_matches_jax():
    """``Sam(tiny_test, twoway_impl='chunk').decode_from_embedding`` on a
    batch-1 embedding, point prompts in two chunks, against JAX's
    ``'chunk_xla'`` on bridged weights."""
    rs = np.random.RandomState(7)
    jm = JSam(cfg=JSamConfig(**TINY, twoway_impl="chunk_xla"))
    # A masks= prompt makes flax create prompt_encoder/mask_conv* too.
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)),
                              jnp.zeros((1, 1, 2)), jnp.ones((1, 1), jnp.int32), None,
                              jnp.zeros((1, 4 * GRID, 4 * GRID, 1)))
    params = {"params": _randomize(params["params"], rs, ("bias",))}
    tm = Sam(SamConfig(**TINY, twoway_impl="chunk")).eval()
    tm.load_state_dict(flax_to_state_dict(params, depth=2), strict=True)
    emb = rs.randn(1, GRID, GRID, C).astype(np.float32) * 0.5
    decode = jax.jit(lambda p, e, pts, labs: jm.apply(
        p, e, points=pts, labels=labs, method=JSam.decode_from_embedding))
    for chunk in range(2):
        points = rs.rand(4, 1, 2).astype(np.float32) * 128
        labels = np.ones((4, 1), np.int32)
        ref = decode(params, emb, points, labels)
        with torch.no_grad():
            out = tm.decode_from_embedding(_t(emb), _t(points), torch.from_numpy(labels))
        for k in OUT_KEYS:
            _close(out[k], ref[k], f"chunk {chunk} {k}")
