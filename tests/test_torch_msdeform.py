"""The port's flat deformable core and the plain versions of its kernels
(B7 forward, gather and scatter; B8 glue) against the JAX package's on the
CPU, fp32, at small shapes (those of ``tests/test_ops_parity.py``):

- ``ms_deform_attn_flat`` and :class:`FlatLevel`'s backward against
  ``_ms_deform_attn_flat`` and ``jax.vjp`` of ``_flat_level``, at batch 1
  and 2, for locations inside the maps and in [-0.3, 1.3] (zero padding),
  and at batch 2 with every point of a head within a 2 x 2 cell window
  (buckets past the scatter's 256-row pieces);
- the gather against ``_flat_gather_rows(_wide_map(v), base + idx)``, the
  scatter (with its fold) against that gather's transpose (``jax.vjp``),
  its buckets against numpy's stable argsort;
- B8 (both entry points) against ``deform_bwd_glue_q`` and
  ``deform_bwd_glue`` run in interpret mode;
- ``impl='auto'``: ``flat`` at batch 2, ``wide`` at batch 1;
- the same at head widths 32 and 128 (SysLearner widths 256 and 1024 over
  8 heads; the gather and B8 also in bf16), and the kernels' width check:
  multiples of 16 from 16 to 128.

On CPU tensors each wrapper runs its plain version, the function its CUDA
kernel is held against on the card. Tolerance: the JAX suite's fp32 bar,
1e-4 (rtol and atol).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iuvl_tpu.ops import msdeform as jmd
from iuvl_tpu.ops.pallas import deform_bwd_glue as jdg
from iuvl_tpu_torch.ops import msdeform as tmd
from iuvl_tpu_torch.ops.cuda import deform_bwd_glue as tdg
from iuvl_tpu_torch.ops.cuda import msdeform as tkm
from tests.test_torch_kernels import interpret

TOL = dict(rtol=1e-4, atol=1e-4)
SHAPES = [(8, 12), (4, 6), (2, 3)]


def _close(port, ref, name=""):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref, np.float32),
                               err_msg=name, **TOL)


def _inputs(rs, b, lo, hi, lq=7, nh=4, d=16, p=4):
    """Values, locations in [lo, hi) and softmaxed weights; lo None: each
    head's points of a level within a 2 x 2 cell window (pixel x, y in
    [c, c + 2) from a corner cell c)."""
    s = sum(h * w for h, w in SHAPES)
    value = rs.randn(b, s, nh, d).astype(np.float32)
    if lo is None:
        size = np.array([[w, h] for h, w in SHAPES], np.float32)  # (L, 2): x, y
        corner = np.floor(rs.uniform(0, (size - 1)[:, None], size=(1, 1, nh, len(SHAPES), 1, 2)))
        pix = corner + 2 * rs.rand(b, lq, nh, len(SHAPES), p, 2)
        loc = ((pix + 0.5) / size[:, None, :]).astype(np.float32)
    else:
        loc = rs.uniform(lo, hi, size=(b, lq, nh, len(SHAPES), p, 2)).astype(np.float32)
    w = rs.rand(b, lq, nh, len(SHAPES), p).astype(np.float32)
    w /= w.reshape(b, lq, nh, -1).sum(-1)[..., None, None]
    return value, loc, w


def _flat_core_and_vjp_match_jax(b, lo, hi, lq, d=16):
    rs = np.random.RandomState(21 + b)
    value, loc, w = _inputs(rs, b, lo, hi, lq, d=d)
    g = rs.randn(b, loc.shape[1], value.shape[2] * value.shape[3]).astype(np.float32)

    def core(v, l, a):
        return jmd._ms_deform_attn_flat(v, SHAPES, l, a)

    def run(g, *args):
        out, vjp = jax.vjp(core, *args)
        return out, vjp(g)

    out, grads = jax.jit(run)(g, value, loc, w)
    tv, tl, tw = (torch.from_numpy(a).requires_grad_() for a in (value, loc, w))
    got = tmd.ms_deform_attn_flat(tv, SHAPES, tl, tw)
    assert got.dtype == torch.float32
    _close(got, out, "out")
    got.backward(torch.from_numpy(g))
    for name, t, ref in zip(("d_value", "d_locations", "d_weights"), (tv, tl, tw), grads):
        # Location gradients scale with the map size: 1e-4 of the largest.
        tol = 1e-4 * max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), rtol=1e-4, atol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("b, lo, hi, lq", [
    pytest.param(b, lo, hi, 7, id=f"{lo}-{hi}-{b}") for lo, hi in ((0.05, 0.95), (-0.3, 1.3))
    for b in (1, 2)] + [pytest.param(2, None, None, 300, id="clustered-2")])
def test_flat_core_and_vjp_match_jax(b, lo, hi, lq):
    _flat_core_and_vjp_match_jax(b, lo, hi, lq)


@pytest.mark.parametrize("d", [32, 128])
def test_flat_core_and_vjp_match_jax_at_other_head_widths(d):
    _flat_core_and_vjp_match_jax(2, -0.3, 1.3, 7, d)


def _level(rs, nh=4, h=6, w=5, lq=6, p=3, d=8):
    """One image's level: values, the top-left indices and slot weights of
    locations in [-0.3, 1.3], as the port computes them."""
    v = rs.randn(nh, h * w, d).astype(np.float32)
    x = (rs.uniform(-0.3, 1.3, (nh, lq, p)) * w - 0.5).astype(np.float32)
    y = (rs.uniform(-0.3, 1.3, (nh, lq, p)) * h - 0.5).astype(np.float32)
    idx, wslot = tmd.wide_idx_wslot(h, w, torch.from_numpy(x), torch.from_numpy(y))
    return v, x, y, idx, wslot


def test_wide_idx_wslot_matches_jax():
    rs = np.random.RandomState(3)
    v, x, y, idx, wslot = _level(rs)
    j_idx, j_wslot = jmd._wide_idx_wslot(jnp.float32, 6, 5, jnp.asarray(x), jnp.asarray(y))
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(wslot.numpy(), np.asarray(j_wslot))


def _gather_rows_match_jax(d=8, dtype="float32"):
    rs = np.random.RandomState(4)
    nh, hw, w = 4, 30, 5
    v, _, _, idx, _ = _level(rs, d=d)
    base = np.arange(nh)[:, None, None] * hw
    jv = jnp.asarray(v).astype(jnp.dtype(dtype))
    ref = jmd._flat_gather_rows(jmd._wide_map(jv[None], w)[0].reshape(nh * hw, -1),
                                jnp.asarray(base + idx.numpy()).reshape(-1))
    got = tkm.deform_gather_rows(torch.from_numpy(v).to(getattr(torch, dtype)), idx, w)
    assert str(got.dtype).split(".")[-1] == dtype
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_gather_rows_match_jax_wide_map_gather():
    _gather_rows_match_jax()


@pytest.mark.parametrize("d", [32, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_rows_match_jax_at_other_head_widths(dtype, d):
    _gather_rows_match_jax(d, dtype)


def _scatter_matches_the_transpose_of_the_gather(d=8):
    rs = np.random.RandomState(5)
    nh, hw, w = 4, 30, 5
    v, _, _, idx, _ = _level(rs, d=d)
    flat = jnp.asarray(np.arange(nh)[:, None, None] * hw + idx.numpy()).reshape(-1)
    contrib = rs.randn(flat.shape[0], 4 * v.shape[-1]).astype(np.float32)

    def gather(vv):
        return jmd._flat_gather_rows(jmd._wide_map(vv[None], w)[0].reshape(nh * hw, -1), flat)

    _, vjp = jax.vjp(gather, jnp.asarray(v))
    got = tkm.deform_scatter_dv(torch.from_numpy(contrib), idx, hw, w)
    assert got.dtype == torch.float32 and got.shape == v.shape
    _close(got, vjp(jnp.asarray(contrib))[0], "d_value")


def test_scatter_matches_the_transpose_of_the_gather():
    """d_value of the tap rows' cotangent: JAX's dv4 scatter and inverse-roll
    fold are the VJP of gathering from the wide map."""
    _scatter_matches_the_transpose_of_the_gather()


@pytest.mark.parametrize("d", [32, 128])
def test_scatter_matches_the_transpose_of_the_gather_at_other_head_widths(d):
    _scatter_matches_the_transpose_of_the_gather(d)


def test_scatter_buckets_are_numpy_stable_argsort_order():
    """The scatter's buckets: rows sorted by (head, top-left cell), each
    bucket's rows in row order (numpy's stable argsort), its start the
    count of smaller keys; with crowded cells, 300 rows one cell."""
    rs = np.random.RandomState(6)
    nh, hw = 3, 20
    idx = rs.randint(0, hw, (nh, 100, 4))
    idx[1, :75] = 7
    keys, order, start = tkm.scatter_buckets_plain(torch.from_numpy(idx).int(), hw)
    want_keys = (np.arange(nh)[:, None] * hw + idx.reshape(nh, -1)).reshape(-1)
    np.testing.assert_array_equal(keys.numpy(), want_keys)
    np.testing.assert_array_equal(order.numpy(), np.argsort(want_keys, kind="stable"))
    np.testing.assert_array_equal(start.numpy(), np.searchsorted(np.sort(want_keys),
                                                                 np.arange(nh * hw + 1)))
    assert int((start[1:] - start[:-1]).max()) > tkm.SCATTER_CHUNK


def test_scatter_plan_covers_the_keys():
    for buckets, want in ((8 * 128 * 128, (9, 2)), (8 * 64 * 64, (8, 2)), (8 * 32 * 32, (7, 2)),
                          (1, (1, 1)), (512, (9, 1)), (513, (5, 2))):
        bits, passes = tkm.scatter_plan(buckets)
        assert (bits, passes) == want and bits <= tkm.SCATTER_DIGIT_BITS
        assert (buckets - 1) >> (bits * passes) == 0


def _bwd_glue_matches_jax_kernels(d=8, dtype="float32"):
    rs = np.random.RandomState(31)
    q, p = 16, 4
    g4 = rs.randn(q * p, 4 * d).astype(np.float32)
    gout = rs.randn(q, d).astype(np.float32)
    wa = rs.rand(q * p, 4).astype(np.float32)
    jg4 = jnp.asarray(g4).astype(jnp.dtype(dtype))
    with interpret(jdg):
        ref_q = jdg.deform_bwd_glue_q(jg4, jnp.asarray(gout), jnp.asarray(wa), p)
        ref = jdg.deform_bwd_glue(jg4, jnp.asarray(gout), jnp.asarray(wa), p)
    args = (torch.from_numpy(g4).to(getattr(torch, dtype)), torch.from_numpy(gout),
            torch.from_numpy(wa), p)
    for fn, (contrib_ref, dots_ref) in ((tdg.deform_bwd_glue_q, ref_q),
                                        (tdg.deform_bwd_glue, ref)):
        contrib, dots = fn(*args)
        assert contrib.dtype == args[0].dtype and dots.dtype == torch.float32
        _close(contrib, contrib_ref.astype(jnp.float32), f"{fn.__name__} contrib")
        _close(dots, dots_ref, f"{fn.__name__} dots")
        assert fn.launches == 0


def test_bwd_glue_matches_jax_kernels():
    """Both entry points against the Pallas kernels in interpret mode (nh *
    Lq a multiple of 8, as JAX's chunking asks)."""
    _bwd_glue_matches_jax_kernels()


@pytest.mark.parametrize("d", [32, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_glue_matches_jax_kernels_at_other_head_widths(dtype, d):
    _bwd_glue_matches_jax_kernels(d, dtype)


@pytest.mark.parametrize("d", [8, 16, 32, 40, 48, 64, 80, 96, 112, 128, 144])
def test_head_width_check(d):
    """The deformable kernels' wrappers take head widths that are multiples
    of 16 from 16 to 128 and raise on others (8, 40, 144): B7's values (d
    wide) and scatter rows (4d), B8's and B15's rows (4d)."""
    ok = d % 16 == 0 and 16 <= d <= 128
    assert (d in tkm.HEAD_WIDTHS) == ok
    for width, slots in ((d, 1), (4 * d, 4)):
        t = torch.empty((2, width), device="meta")
        if ok:
            tkm.check_head_width("kernel", d)
            assert tkm._check_values("kernel", "t", t, slots) == d
        else:
            with pytest.raises(ValueError, match="head width"):
                tkm.check_head_width("kernel", d)
            with pytest.raises(ValueError, match="head width"):
                tkm._check_values("kernel", "t", t, slots)


def test_bwd_glue_rounds_contrib_to_the_value_dtype():
    rs = np.random.RandomState(32)
    g4 = torch.from_numpy(rs.randn(8, 32).astype(np.float32)).bfloat16()
    gout = torch.from_numpy(rs.randn(2, 8).astype(np.float32))
    wa = torch.from_numpy(rs.rand(8, 4).astype(np.float32))
    contrib, dots = tdg.deform_bwd_glue_q(g4, gout, wa, 4)
    assert contrib.dtype == torch.bfloat16 and dots.dtype == torch.float32
    want = (wa.repeat_interleave(8, dim=1) * gout.repeat(1, 4).repeat_interleave(4, dim=0))
    torch.testing.assert_close(contrib, want.bfloat16(), rtol=0, atol=0)


@pytest.mark.parametrize("b, route", [(1, "wide"), (2, "flat")])
def test_auto_routes_by_batch(b, route, monkeypatch):
    calls = []
    monkeypatch.setattr(tmd, "ms_deform_attn_flat", lambda *a: calls.append("flat"))
    monkeypatch.setattr(tmd, "_ms_deform_attn_wide", lambda *a: calls.append("wide"))
    value, loc, w = (torch.from_numpy(a) for a in _inputs(np.random.RandomState(0), b, 0, 1))
    tmd.ms_deform_attn_core(value, SHAPES, loc, w, impl="auto")
    assert calls == [route]
    with pytest.raises(ValueError, match="not in"):
        tmd.ms_deform_attn_core(value, SHAPES, loc, w, impl="scan")
