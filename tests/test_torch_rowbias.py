"""The port's ``attn_impl='rowbias'`` / ``'pallas_rp'`` route against the JAX
package's on the CPU: the plain versions of B2b (``flash_attention_rowbias``)
and B14 (``flash_attention_relpos``), forward with lse and gradients down to
the rel-pos tables, against JAX's Pallas kernels in interpret mode (their
tests' shapes and tolerances, ``tests/test_attention_ops.py``); the tiny
SAM encoder under both impls; one seg train step under ``'rowbias'`` and the
encoder gradient under ``'pallas_rp'``. Inputs from seeded numpy, fp32; the
interpret patch of ``pl.pallas_call`` is a fixture, never set at import.
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
from iuvl_tpu.models.xdecoder.model import SysLearner as JSysLearner
from iuvl_tpu.models.xdecoder.model import SysLearnerConfig as JConfig
from iuvl_tpu.ops.pallas import flash_attention as jfa
from iuvl_tpu.ops.rel_pos_attention import rel_pos_table
from iuvl_tpu_torch.models.sam import Sam, SamConfig
from iuvl_tpu_torch.models.sam import build as tsb
from iuvl_tpu_torch.models.sam.convert import flax_to_state_dict
from iuvl_tpu_torch.models.xdecoder import convert
from iuvl_tpu_torch.models.xdecoder.model import SysLearner, SysLearnerConfig
from iuvl_tpu_torch.ops import rel_pos_attention as trpa
from iuvl_tpu_torch.ops.cuda import flash_attention as tfa
from tests.test_torch_train import _grad_close, step_matches_jax
from tests.test_torch_xdecoder import (N_CLASSES, TINY, TINY_SAM, TINY_TEXT, inputs,
                                       random_params)

# iuvl_tpu.ops re-exports a function under the submodule's name
jrpa = importlib.import_module("iuvl_tpu.ops.rel_pos_attention")

TOL = dict(atol=1e-4, rtol=1e-4)
SAM_TINY = dict(embed_dim=32, depth=2, num_heads=2, global_attn_indexes=(1,), img_size=128,
                window_size=4)


@pytest.fixture
def interpret():
    """JAX's flash kernels in interpret mode (CPU), for the test's duration."""
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    jfa.pl.pallas_call = interp
    try:
        yield
    finally:
        jfa.pl.pallas_call = orig


def _inputs(h, w, heads, d, b, seed):
    """tests/test_attention_ops.py ``_inputs``: q, k, v (b, heads, h w, d),
    the rel-pos tables (2 h - 1, d), (2 w - 1, d)."""
    rs = np.random.RandomState(seed)
    n = h * w
    q, k, v = (rs.randn(b, heads, n, d).astype(np.float32) for _ in range(3))
    rph = (rs.randn(2 * h - 1, d) * 0.1).astype(np.float32)
    rpw = (rs.randn(2 * w - 1, d) * 0.1).astype(np.float32)
    return q, k, v, rph, rpw, (h, w)


def _features(q, rph, rpw, hw):
    """JAX's relh / relw of the rowbias route (fp32 here)."""
    h, w = hw
    b, heads, n, d = q.shape
    r_q = q.reshape(b, heads, h, w, d)
    relh = jnp.einsum("bnhwc,hkc->bnhwk", r_q, rel_pos_table(h, h, rph)).reshape(b, heads, n, h)
    relw = jnp.einsum("bnhwc,wkc->bnhwk", r_q, rel_pos_table(w, w, rpw)).reshape(b, heads, n, w)
    return relh, relw


def _expanders(hw):
    h, w = hw
    col = np.arange(h * w)
    return ((np.arange(h)[:, None] == col[None] // w).astype(np.float32),
            (np.arange(w)[:, None] == col[None] % w).astype(np.float32))


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(port, ref, name="", **tol):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref, np.float32),
                               err_msg=name, **(tol or TOL))


@pytest.mark.parametrize("kind, hw, seed", [("rowbias", (4, 4), 31), ("rowbias", (6, 5), 32),
                                            ("relpos", (6, 5), 21), ("relpos", (4, 4), 22)])
def test_forward_plain_matches_the_pallas_kernel(kind, hw, seed, interpret):
    """o and lse of B2b's / B14's plain version against JAX's forward in
    interpret mode (B2b with 8 x 8 blocks where the grid allows: several q
    and k blocks, the per-block relh slicing)."""
    q, k, v, rph, rpw, hw = _inputs(*hw, heads=2, d=16, b=2, seed=seed)
    relh, relw = _features(q, rph, rpw, hw)
    qs = q * 16 ** -0.5
    if kind == "rowbias":
        blocks = (8, 8) if hw == (4, 4) else (2048, 1024)
        ref = jfa._flash_rb_forward(qs, k, v, relh, relw, hw[1], *blocks, return_lse=True)
        got = tfa.flash_rowbias_fwd(_t(qs), _t(k), _t(v), _t(relh), _t(relw), hw[1])
    else:
        eh, ew = _expanders(hw)
        ref = jfa._flash_rp_forward(qs, k, v, relh, relw, eh, ew, return_lse=True)
        got = tfa.flash_relpos_fwd(_t(qs), _t(k), _t(v), _t(relh), _t(relw), _t(eh), _t(ew))
    for name, g, r in zip(("o", "lse"), got, ref):
        _close(g, r, name, atol=1e-5, rtol=1e-5)
    assert tfa.flash_rowbias_fwd.launches == tfa.flash_relpos_fwd.launches == 0


@pytest.mark.parametrize("kind", ["rowbias", "relpos"])
def test_backward_plain_matches_the_pallas_kernel(kind, interpret):
    """dq, dk, dv, drelh, drelw of the plain backward against JAX's
    backward kernels in interpret mode, at the forward's o and lse."""
    q, k, v, rph, rpw, hw = _inputs(4, 4, heads=2, d=16, b=2, seed=33)
    relh, relw = _features(q, rph, rpw, hw)
    qs = q * 16 ** -0.5
    g = np.random.RandomState(34).randn(*v.shape).astype(np.float32)
    if kind == "rowbias":
        o, lse = jfa._flash_rb_forward(qs, k, v, relh, relw, 4, 8, 8, return_lse=True)
        ref = jfa._flash_rb_backward(qs, k, v, relh, relw, o, lse, g, 4, 8, 8)
        got = tfa.flash_rowbias_bwd(*map(_t, (qs, k, v, relh, relw, o, lse, g)), 4)
    else:
        eh, ew = _expanders(hw)
        o, lse = jfa._flash_rp_forward(qs, k, v, relh, relw, eh, ew, return_lse=True)
        ref = jfa._flash_rp_backward(qs, k, v, relh, relw, eh, ew, o, lse, g)
        got = tfa.flash_relpos_bwd(*map(_t, (qs, k, v, relh, relw, eh, ew, o, lse, g)))
    for name, a, r in zip(("dq", "dk", "dv", "drelh", "drelw"), got, ref):
        _close(a, r, name, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("impl", ["rowbias", "pallas_rp"])
def test_gradients_down_to_the_tables_match_jax(impl, interpret):
    """The route's gradients into q, k, v and the stored rel-pos tables
    (autograd through rel_pos_features and the tables' expansion, the
    kernel's backward between) against ``jax.grad`` of JAX's same route in
    interpret mode (tests/test_attention_ops.py's tolerance)."""
    q, k, v, rph, rpw, hw = _inputs(4, 4, heads=2, d=16, b=2, seed=22)
    wts = np.random.RandomState(23).randn(*v.shape).astype(np.float32)

    def loss(*a):
        return (jrpa.rel_pos_attention(*a, hw, impl=impl) * wts).sum()

    ref = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (q, k, v, rph, rpw)))
    leaves = [_t(x).requires_grad_() for x in (q, k, v, rph, rpw)]
    (trpa.rel_pos_attention(*leaves, hw, impl=impl) * _t(wts)).sum().backward()
    for name, leaf, r in zip(("q", "k", "v", "rel_pos_h", "rel_pos_w"), leaves, ref):
        _close(leaf.grad, r, name, atol=2e-4, rtol=1e-4)


def test_window_impl_still_raises_naming_b13():
    q = torch.zeros(1, 1, 16, 8)
    with pytest.raises(NotImplementedError, match="B13"):
        trpa.rel_pos_attention(q, q, q, torch.zeros(7, 8), torch.zeros(7, 8), (4, 4),
                               impl="window")


@pytest.mark.parametrize("impl", ["rowbias", "pallas_rp"])
def test_tiny_sam_encoder_matches_jax(impl, interpret):
    """The tiny SAM's image encoder (windows of 4 x 4 and a global 8 x 8
    block) under ``impl``: every block's attention through the kernel
    route, the plain tail, against JAX's encoder under the same impl."""
    rs = np.random.RandomState(0)
    init = JSam(cfg=JSamConfig(**SAM_TINY, twoway_impl="off"))
    params = jax.jit(init.init)(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)),
                                jnp.zeros((1, 1, 2)), jnp.ones((1, 1), jnp.int32), None,
                                jnp.zeros((1, 32, 32, 1)))
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(rs.randn(*x.shape).astype(np.float32) * 0.1)
        if any(s in jax.tree_util.keystr(p) for s in ("rel_pos", "pos_embed", "'bias'"))
        else x, params)
    jm = JSam(cfg=JSamConfig(**SAM_TINY, attn_impl=impl, twoway_impl="off"))
    tm = Sam(SamConfig(**SAM_TINY, attn_impl=impl)).eval()
    tm.load_state_dict(flax_to_state_dict(params, depth=2), strict=True)
    x = jm.apply(params, jnp.asarray(rs.rand(2, 128, 128, 3).astype(np.float32) * 255),
                 method=JSam.normalize)
    emb, fpn = jm.apply(params, x, method=JSam.encode_image)
    with torch.no_grad():
        temb, tfpn = tm.image_encoder(_t(x))
    _close(temb, emb, "sam_embedding")
    for name in ("res2", "res3", "res4", "res5"):
        _close(tfpn[name], fpn[name], name)


def _tiny_models(impl):
    """tests/test_torch_xdecoder.py ``tiny_models`` with the encoder under
    ``impl`` on both sides (the parameter tree does not depend on it)."""
    tsb.SAM_VARIANTS["tiny_test"] = TINY_SAM
    jm = JSysLearner(cfg=JConfig(**TINY, **TINY_TEXT, attn_impl=impl, msdeform_impl="auto"))
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                        jnp.zeros((N_CLASSES + 1, 32)), method=JSysLearner.warmup))
    params = random_params(shapes)
    cfg = SysLearnerConfig(**TINY, **TINY_TEXT, attn_impl=impl)
    tm = SysLearner(cfg)
    tm.load_state_dict(convert.flax_to_state_dict(params, cfg), strict=True)
    return jm, params, tm, cfg


def test_seg_train_step_under_rowbias_matches_jax(interpret):
    """One seg train step with every encoder block's attention through
    B2b's route: each loss term, every gradient and every parameter after
    the update against JAX's step (tests/test_torch_train.py's bars)."""
    from iuvl_tpu.models.sam import build as jsb

    jsb.SAM_VARIANTS["tiny_test"] = TINY_SAM
    models = _tiny_models("rowbias")
    assert models[2].cfg.kernels_impl == "auto"
    step_matches_jax(models, b=1)


def test_encoder_gradient_under_pallas_rp_matches_jax(interpret):
    """The SysLearner encoder's gradients (SAM embedding and the four FPN
    maps, each projected on a fixed random tensor) under B14's route
    against ``jax.grad`` of JAX's."""
    from iuvl_tpu.models.sam import build as jsb

    jsb.SAM_VARIANTS["tiny_test"] = TINY_SAM
    jm, params, tm, cfg = _tiny_models("pallas_rp")
    images, _ = inputs()
    names = ("res2", "res3", "res4", "res5")

    def outs(m, x):
        emb, fpn = m.encode_image(x)
        return [emb] + [fpn[k] for k in names]

    shapes = [o.shape for o in jax.eval_shape(lambda p: jm.apply(p, images, method=outs),
                                              params)]
    rs = np.random.RandomState(7)
    weights = [rs.randn(*s).astype(np.float32) for s in shapes]

    def loss(p):
        return sum((o * w).sum() for o, w in zip(jm.apply(p, images, method=outs), weights))

    ref = convert.flax_to_state_dict(jax.jit(jax.grad(loss))(params), cfg)
    emb, fpn = tm.encode_image(_t(images))
    sum((o * _t(w)).sum() for o, w in zip([emb] + [fpn[k] for k in names], weights)).backward()
    for name, p in tm.image_encoder.named_parameters():
        assert p.grad is not None and bool(p.grad.abs().sum() > 0), name
        _grad_close(p.grad, ref["image_encoder." + name], name)
