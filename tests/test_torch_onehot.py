"""B15 (the one-hot deformable level of the ``hybrid`` core) on the CPU
against the JAX package: the plain version against the interpret-mode
Pallas kernel ``onehot_deform_level_forward``, the hybrid level
(``OnehotLevel``) and its VJP against ``_level_contribution_onehot`` and
``jax.vjp`` of it, and the ``hybrid`` core against JAX's.

Inputs from seeded numpy: locations spanning [-2, size + 2) (out-of-range
points clip to edge cells and carry weight 0 for the taps outside), and
rows whose points hit the same cell (the kernel merges their weights
before it rounds). Tolerances: fp32 at the JAX suite's bar, atol = rtol =
1e-4 (1e-5 where the arithmetic is the same); bf16 outputs within one bf16
unit of the last place (2^-8 relative): the two sum the same exact
products in fp32 in another order, then round once. The plain version and
the hybrid level are also held at head widths 32 and 128 (SysLearner widths
256 and 1024 over 8 heads), with the same tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from iuvl_tpu.ops import msdeform as jmd
from iuvl_tpu.ops.pallas import onehot_gather as jog
from iuvl_tpu_torch.ops import msdeform as tmd
from iuvl_tpu_torch.ops.cuda.onehot_gather import (onehot_deform_level_forward,
                                                   onehot_deform_level_forward_plain)

TOL = dict(atol=1e-4, rtol=1e-4)
BF16_ULP = 2.0 ** -8


@pytest.fixture
def interpret(monkeypatch):
    """The JAX package's Pallas kernels run in interpret mode (as
    tests/test_ops_parity.py runs them on the CPU)."""
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(jog.pl, "pallas_call", interp)


def level_inputs(seed=0, b=1, nh=2, h=6, w=5, d=64, lq=40, p=4):
    """v (B, nh, h*w, d), pixel coordinates x, y and attention weights
    (B, nh, Lq, P) fp32; every fourth row's points 1 and 3 at point 0's
    location (a repeated cell), and its point 2 within point 0's cell."""
    rs = np.random.RandomState(seed)
    v = rs.randn(b, nh, h * w, d).astype(np.float32)
    x = (rs.rand(b, nh, lq, p) * (w + 4) - 2).astype(np.float32)
    y = (rs.rand(b, nh, lq, p) * (h + 4) - 2).astype(np.float32)
    for t in (x, y):
        t[:, :, ::4, 1] = t[:, :, ::4, 0]
        t[:, :, ::4, 3] = t[:, :, ::4, 0]
        t[:, :, ::4, 2] = np.floor(t[:, :, ::4, 0]) + rs.rand(*t[:, :, ::4, 0].shape) * 0.99
    aw = rs.rand(b, nh, lq, p).astype(np.float32)
    aw /= aw.sum(-1, keepdims=True)
    return v, x, y, aw


def kernel_inputs(v, x, y, aw, h, w):
    """The JAX function's inputs: the wide map (BH, cells, 4d), idx
    (BH, Lq, P) int32, wslot (BH, Lq, 4, P) fp32 with the attention weight
    folded in, made by JAX's own ``_wide_idx_wslot`` and ``_wide_map``."""
    b, nh, hw, d = v.shape
    lq, p = x.shape[2:]
    idx, wslot = jmd._wide_idx_wslot(jnp.float32, h, w, jnp.asarray(x), jnp.asarray(y))
    wslot = wslot * jnp.asarray(aw)[..., None]
    v4 = jmd._wide_map(jnp.asarray(v), w).reshape(b * nh, hw, 4 * d)
    return (np.array(v4), np.array(idx).reshape(b * nh, lq, p),
            np.array(wslot.transpose(0, 1, 2, 4, 3)).reshape(b * nh, lq, 4, p))


def _plain_matches_interpret_kernel(dtype, d):
    h, w = 6, 5
    v4, idx, wslot = kernel_inputs(*level_inputs(d=d), h, w)
    # The inputs hold what the test means them to: repeated cells in a row,
    # and points clipped to the edge.
    assert (idx[:, ::4, 1] == idx[:, ::4, 0]).all() and (idx[:, ::4, 2] == idx[:, ::4, 0]).all()
    assert ((idx == 0) | (idx == h * w - 1)).any()
    jdt = jnp.dtype(dtype)
    ref = jog.onehot_deform_level_forward(jnp.asarray(v4).astype(jdt), jnp.asarray(idx),
                                          jnp.asarray(wslot), n_points=4)
    tv4 = torch.from_numpy(v4).to(getattr(torch, dtype))
    got = onehot_deform_level_forward(tv4, torch.from_numpy(idx), torch.from_numpy(wslot), 4)
    assert got.dtype == tv4.dtype and got.shape == ref.shape
    ref = np.asarray(ref.astype(jnp.float32))
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=BF16_ULP)
        assert np.mean(got == ref) > 0.98
    # The merge matters: rounding each point's weight on its own reads
    # differently in bf16 on the rows with repeated cells.
    if dtype == "bfloat16":
        per_point = np.zeros_like(got)
        for s in range(4):
            wb = torch.from_numpy(wslot[:, :, s]).bfloat16().float()  # (BH, Lq, P)
            rows = tv4.float()[:, :, s * d:(s + 1) * d]
            g = torch.stack([rows[i][torch.from_numpy(idx[i]).long()] for i in range(len(idx))])
            per_point += (wb[..., None] * g).sum(2).numpy()
        per_point = torch.from_numpy(per_point).bfloat16().float().numpy()
        assert np.abs(per_point - ref)[:, ::4].max() > np.abs(got - ref)[:, ::4].max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_interpret_kernel(dtype, interpret):
    _plain_matches_interpret_kernel(dtype, 64)


@pytest.mark.parametrize("d", [32, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_interpret_kernel_at_other_head_widths(dtype, d, interpret):
    _plain_matches_interpret_kernel(dtype, d)


def test_plain_keeps_out_of_range_indices_out():
    """An index outside the table hits no cell, as in the one-hot compare."""
    rs = np.random.RandomState(3)
    v4 = torch.from_numpy(rs.randn(1, 4, 8).astype(np.float32))
    idx = torch.tensor([[[0, 4], [-1, 3]]], dtype=torch.int32)
    wslot = torch.from_numpy(rs.rand(1, 2, 4, 2).astype(np.float32))
    got = onehot_deform_level_forward_plain(v4, idx, wslot, 2)
    want = torch.stack([sum(wslot[0, 0, s, 0] * v4[0, 0, 2 * s:2 * s + 2] for s in range(4)),
                        sum(wslot[0, 1, s, 1] * v4[0, 3, 2 * s:2 * s + 2] for s in range(4))])
    torch.testing.assert_close(got[0], want, **TOL)


def _hybrid_level_and_vjp_match_jax(d):
    h, w = 6, 5
    v, x, y, aw = level_inputs(seed=1, d=d)
    rs = np.random.RandomState(2)
    g = rs.randn(*v.shape[:2], x.shape[2], v.shape[3]).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (v, x, y, aw)]
    ref, vjp = jax.vjp(lambda vv, xx, yy, a: jmd._level_contribution_onehot(vv, h, w, xx, yy, a),
                       *jargs)
    ref_grads = vjp(jnp.asarray(g))
    targs = [torch.from_numpy(a).requires_grad_() for a in (v, x, y, aw)]
    out = tmd.OnehotLevel.apply(*targs, h, w, "auto")
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    grads = torch.autograd.grad(out, targs, torch.from_numpy(g))
    for name, got, want in zip(("v", "x", "y", "aw"), grads, ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=name, **TOL)


def test_hybrid_level_and_vjp_match_jax(interpret):
    _hybrid_level_and_vjp_match_jax(64)


@pytest.mark.parametrize("d", [32, 128])
def test_hybrid_level_and_vjp_match_jax_at_other_head_widths(d, interpret):
    _hybrid_level_and_vjp_match_jax(d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_core_matches_jax(dtype, interpret):
    """Levels of 40 x 40 (over 1536 cells: the wide gather) and 8 x 8 (the
    one-hot level) through JAX's ``ms_deform_attn_core(impl='hybrid')``:
    the output's dtype (fp32 once a wide level adds in), and its values
    (fp32 at 1e-4; bf16 with the value rounded once to bf16 more or less
    on the one-hot level, at 1e-2)."""
    rs = np.random.RandomState(4)
    shapes = [(40, 40), (8, 8)]
    b, lq, nh, p, d = 1, 24, 2, 4, 64
    value = rs.randn(b, sum(hh * ww for hh, ww in shapes), nh, d).astype(np.float32)
    loc = (rs.rand(b, lq, nh, 2, p, 2) * 1.2 - 0.1).astype(np.float32)
    aw = rs.rand(b, lq, nh, 2, p).astype(np.float32)
    aw /= aw.sum((-1, -2), keepdims=True)
    jv = jnp.asarray(value).astype(jnp.dtype(dtype))
    ref = jmd.ms_deform_attn_core(jv, shapes, jnp.asarray(loc), jnp.asarray(aw), impl="hybrid")
    got = tmd.ms_deform_attn_core(torch.from_numpy(value).to(getattr(torch, dtype)), shapes,
                                  torch.from_numpy(loc), torch.from_numpy(aw), impl="hybrid")
    assert str(got.dtype).split(".")[-1] == str(ref.dtype) == "float32"
    tol = TOL if dtype == "float32" else dict(atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)
