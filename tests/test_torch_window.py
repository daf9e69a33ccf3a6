"""The port's ``attn_impl='window'`` route against the JAX package's on the
CPU: B13's plain version (``window_rel_attention_plain``) against JAX's
``window_rel_attention`` with its Pallas kernel in interpret mode, forward
(fp32 at the JAX suite's 1e-5, and bf16, which checks B13's rounding
points) and gradients down to the stored tables; the tiny SAM encoder under
``'window'``, forward and gradients; one seg train step under ``'window'``.
Inputs from seeded numpy; the interpret patch of ``pl.pallas_call`` is a
fixture, never set at import.
"""

import importlib

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iuvl_tpu.models.sam.build import Sam as JSam
from iuvl_tpu.models.sam.build import SamConfig as JSamConfig
from iuvl_tpu.ops.pallas import window_attention as jwa
from iuvl_tpu_torch.models.sam import Sam, SamConfig
from iuvl_tpu_torch.models.sam.convert import flax_to_state_dict
from iuvl_tpu_torch.ops import rel_pos_attention as trpa
from iuvl_tpu_torch.ops.cuda import window_attention as twa
from tests.test_torch_rowbias import SAM_TINY, _tiny_models
from tests.test_torch_train import _grad_close, step_matches_jax
from tests.test_torch_xdecoder import TINY_SAM

# iuvl_tpu.ops re-exports a function under the submodule's name
jrpa = importlib.import_module("iuvl_tpu.ops.rel_pos_attention")

TOL = dict(atol=1e-4, rtol=1e-4)
# (grid side, windows, heads, head dim): a windowed grid as JAX's test has it
# and a global one (a single "window" over the whole 8 x 8 grid).
GRIDS = [(5, 6, 3, 16), (8, 1, 2, 16)]


@pytest.fixture
def interpret():
    """JAX's window kernel in interpret mode (CPU), for the test's duration."""
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        kw.pop("compiler_params", None)
        return orig(*a, **kw)

    jwa.pl.pallas_call = interp
    try:
        yield
    finally:
        jwa.pl.pallas_call = orig


def _inputs(side, b, heads, d, seed):
    rs = np.random.RandomState(seed)
    n = side * side
    q, k, v = (rs.randn(b, heads, n, d).astype(np.float32) for _ in range(3))
    rph, rpw = (rs.randn(2 * side - 1, d).astype(np.float32) * 0.3 for _ in range(2))
    return q, k, v, rph, rpw, (side, side)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _close(port, ref, name="", **tol):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref, np.float32),
                               err_msg=name, **(tol or TOL))


@pytest.mark.parametrize("side, b, heads, d", GRIDS)
def test_window_plain_matches_jax_kernel_fp32(side, b, heads, d, interpret):
    q, k, v, rph, rpw, hw = _inputs(side, b, heads, d, seed=11)
    ref = jrpa.rel_pos_attention(*map(jnp.asarray, (q, k, v, rph, rpw)), hw, impl="window")
    got = twa.window_rel_attention_plain(*map(_t, (q, k, v, rph, rpw)), hw)
    _close(got, ref, atol=1e-5, rtol=0)
    # The same through the port's rel-pos entry and its kernel wrapper on the CPU.
    _close(trpa.rel_pos_attention(*map(_t, (q, k, v, rph, rpw)), hw, impl="window"), ref,
           atol=1e-5, rtol=0)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("side, b, heads, d", GRIDS)
def test_window_plain_rounds_as_the_jax_kernel_in_bf16(side, b, heads, d, interpret):
    """bf16 inputs: B13's rounding points (tables rounded after the fp32
    expansion, relh / relw in fp32, the scale on the fp32 scores, p rounded
    before p v). The port's plain version matches JAX's kernel to 5e-4 rel
    L2 (on this CPU it reads 0: the same bf16 values), and the unfused
    route of 'plain', which rounds relh / relw to bf16 and scales q in
    bf16, does not (it reads ~3.8e-3): the bound tells the two apart."""
    q, k, v, rph, rpw, hw = _inputs(side, b, heads, d, seed=12)
    bf = jnp.bfloat16
    ref = jrpa.rel_pos_attention(*(jnp.asarray(x, bf) for x in (q, k, v)),
                                 jnp.asarray(rph), jnp.asarray(rpw), hw, impl="window")
    ref = np.asarray(ref.astype(jnp.float32))
    args = [_t(x, torch.bfloat16) for x in (q, k, v)] + [_t(rph), _t(rpw)]
    got = twa.window_rel_attention_plain(*args, hw)
    assert got.dtype == torch.bfloat16
    err = _rel(got.float().numpy(), ref)
    other = _rel(trpa.rel_pos_attention(*args, hw, impl="plain").float().numpy(), ref)
    assert err <= 5e-4 < other, (err, other)


@pytest.mark.parametrize("side, b, heads, d", GRIDS)
def test_window_gradients_match_jax_custom_vjp(side, b, heads, d, interpret):
    """Gradients to q, k, v and both stored tables: the port's backward
    (autograd of the plain augmented route, recomputed) against JAX's
    custom VJP of the window kernel."""
    q, k, v, rph, rpw, hw = _inputs(side, b, heads, d, seed=13)
    wts = np.random.RandomState(14).randn(b, heads, side * side, d).astype(np.float32)

    def loss(*a):
        return (jrpa.rel_pos_attention(*a, hw, impl="window") * wts).sum()

    ref = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (q, k, v, rph, rpw)))
    leaves = [_t(x).requires_grad_() for x in (q, k, v, rph, rpw)]
    (twa.window_rel_attention(*leaves, hw) * _t(wts)).sum().backward()
    for name, leaf, r in zip(("q", "k", "v", "rel_pos_h", "rel_pos_w"), leaves, ref):
        _close(leaf.grad, r, name, atol=2e-4, rtol=1e-4)


def _jax_sam_params(rs):
    init = JSam(cfg=JSamConfig(**SAM_TINY, twoway_impl="off"))
    params = jax.jit(init.init)(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)),
                                jnp.zeros((1, 1, 2)), jnp.ones((1, 1), jnp.int32), None,
                                jnp.zeros((1, 32, 32, 1)))
    return jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(rs.randn(*x.shape).astype(np.float32) * 0.1)
        if any(s in jax.tree_util.keystr(p) for s in ("rel_pos", "pos_embed", "'bias'"))
        else x, params)


def test_tiny_sam_encoder_under_window_matches_jax(interpret):
    """The tiny SAM's image encoder (windows of 4 x 4 and a global 8 x 8
    block, every block's attention through B13's route, the plain tail)
    against JAX's under attn_impl='window': the forward, and the gradient
    of every encoder parameter for a fixed random projection of the
    embedding."""
    rs = np.random.RandomState(0)
    params = _jax_sam_params(rs)
    jm = JSam(cfg=JSamConfig(**SAM_TINY, attn_impl="window", twoway_impl="off"))
    tm = Sam(SamConfig(**SAM_TINY, attn_impl="window")).eval()
    tm.load_state_dict(flax_to_state_dict(params, depth=2), strict=True)
    x = jm.apply(params, jnp.asarray(rs.rand(2, 128, 128, 3).astype(np.float32) * 255),
                 method=JSam.normalize)
    emb, fpn = jm.apply(params, x, method=JSam.encode_image)
    with torch.no_grad():
        temb, tfpn = tm.image_encoder(_t(x))
    _close(temb, emb, "sam_embedding")
    for name in ("res2", "res3", "res4", "res5"):
        _close(tfpn[name], fpn[name], name)

    wts = rs.randn(*emb.shape).astype(np.float32)

    def loss(p):
        return (jm.apply(p, x, method=JSam.encode_image)[0] * wts).sum()

    ref = flax_to_state_dict(jax.jit(jax.grad(loss))(params), depth=2)
    (tm.image_encoder(_t(x), return_fpn=False)[0] * _t(wts)).sum().backward()
    for name, p in tm.image_encoder.named_parameters():
        if name.startswith("neck."):  # SimpleFPN: not on the embedding's path
            continue
        assert p.grad is not None, name
        _grad_close(p.grad, ref["image_encoder." + name], name)


def test_seg_train_step_under_window_matches_jax(interpret):
    """One seg train step with every encoder block's attention through B13's
    route (windows of 14 x 14 over the padded 4 x 4 grid, and the global
    block): each loss term, every gradient and every parameter after the
    update against JAX's step (tests/test_torch_train.py's bars)."""
    from iuvl_tpu.models.sam import build as jsb

    jsb.SAM_VARIANTS["tiny_test"] = TINY_SAM
    models = _tiny_models("window")
    assert models[2].cfg.kernels_impl == "auto"
    step_matches_jax(models, b=1)
