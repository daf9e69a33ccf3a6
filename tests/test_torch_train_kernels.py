"""The plain versions of the training kernels B9-B12 against the JAX
package's contracts on the CPU, fp32, at small shapes.

- B9 (window-block backward): ``jax.vjp`` of ``_block_xla``, through the
  port's autograd function, the rel-pos table expansion included;
- B10 (block-tail backward): ``jax.vjp`` of ``_tail_xla`` (exact-erf GELU
  in fp32);
- B11 (flash attention forward with lse, and backward):
  ``flash_attention_bwd_xla`` and a softmax reference;
- B12 (tap scatter): ``jax.vjp`` of ``point_sample_trainable``, which on the
  CPU is the XLA scatter.

On CPU tensors each wrapper runs its plain version, the function the CUDA
kernel is held against on the card. Tolerance: 1e-4 relative (atol 1e-5
for values near zero), the JAX suite's fp32 bar.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iuvl_tpu.ops.pallas.flash_attention import flash_attention_bwd_xla
from iuvl_tpu.ops.pallas.mlp_block import _tail_xla
from iuvl_tpu.ops.pallas.window_block import _block_xla
from iuvl_tpu.ops.point_sample import point_sample_trainable as j_point_sample_trainable
from iuvl_tpu_torch.ops.cuda import flash_attention as fa
from iuvl_tpu_torch.ops.cuda import mlp_block as mb
from iuvl_tpu_torch.ops.cuda import tap_scatter as ts
from iuvl_tpu_torch.ops.cuda import window_block as wb
from iuvl_tpu_torch.ops.point_sample import point_sample_trainable
from iuvl_tpu_torch.ops.rel_pos_attention import rel_pos_tables

TOL = dict(rtol=1e-4, atol=1e-5)


def _rand(rs, *shape, std=1.0):
    return (rs.randn(*shape) * std).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32)).requires_grad_()


def _close(port, ref, name):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), err_msg=name, **TOL)


def _jax_vjp(fn, g, *args):
    """(fn(*args), the cotangents of args at g), in one jitted call."""
    def run(g, *a):
        out, vjp = jax.vjp(fn, *a)
        return out, vjp(g)
    return jax.jit(run)(jnp.asarray(g), *args)


@pytest.mark.parametrize("win, c, heads", [(4, 32, 2), (3, 48, 3)])
def test_window_block_backward_matches_jax_vjp(win, c, heads):
    rs = np.random.RandomState(0)
    d, nw = c // heads, 3
    xw, g = _rand(rs, nw, win * win, c), _rand(rs, nw, win * win, c)
    wqkv, bqkv = _rand(rs, c, 3 * c, std=c ** -0.5), _rand(rs, 3 * c, std=0.3)
    wo, bo = _rand(rs, c, c, std=c ** -0.5), _rand(rs, c, std=0.3)
    rph, rpw = _rand(rs, 2 * win - 1, d, std=0.3), _rand(rs, 2 * win - 1, d, std=0.3)
    out, ref = _jax_vjp(lambda *a: _block_xla(*a, win, heads), g, xw, wqkv, bqkv, wo, bo,
                        rph, rpw)
    # The port holds weights in nn.Linear layout: (out, in).
    ins = [_t(xw), _t(wqkv.T), _t(bqkv), _t(wo.T), _t(bo), _t(rph), _t(rpw)]
    rh, rw = rel_pos_tables(ins[5], ins[6], (win, win))
    got = wb.window_attention_block_train(ins[0], ins[1], ins[2], ins[3], ins[4], rh, rw, heads)
    _close(got, out, "out")
    got.backward(torch.from_numpy(g))
    names = ("dx", "dwqkv", "dbqkv", "dwo", "dbo", "drel_pos_h", "drel_pos_w")
    for name, t, r in zip(names, ins, ref):
        _close(t.grad.T if name in ("dwqkv", "dwo") else t.grad, r, name)


@pytest.mark.parametrize("t_rows, c, hidden", [(16, 32, 128), (24, 48, 96)])
def test_block_tail_backward_matches_jax_vjp(t_rows, c, hidden):
    rs = np.random.RandomState(1)
    x, a, g = _rand(rs, t_rows, c), _rand(rs, t_rows, c), _rand(rs, t_rows, c)
    scale, bias = 1 + _rand(rs, c, std=0.1), _rand(rs, c, std=0.3)
    w1, b1 = _rand(rs, c, hidden, std=c ** -0.5), _rand(rs, hidden, std=0.3)
    w2, b2 = _rand(rs, hidden, c, std=hidden ** -0.5), _rand(rs, c, std=0.3)
    out, ref = _jax_vjp(_tail_xla, g, x, a, scale, bias, w1, b1, w2, b2)
    ins = [_t(x), _t(a), _t(scale), _t(bias), _t(w1.T), _t(b1), _t(w2.T), _t(b2)]
    got = mb.block_tail_train(*ins)
    _close(got, out, "out")
    got.backward(torch.from_numpy(g))
    names = ("dx", "da", "dscale", "dbias", "dw1", "db1", "dw2", "db2")
    for name, t, r in zip(names, ins, ref):
        _close(t.grad.T if name in ("dw1", "dw2") else t.grad, r, name)


@pytest.mark.parametrize("n, d_qk, d_v", [(64, 24, 8), (48, 40, 16)])
def test_flash_attention_fwd_bwd_match_jax(n, d_qk, d_v):
    rs = np.random.RandomState(2)
    q, k = _rand(rs, 1, 2, n, d_qk, std=0.4), _rand(rs, 1, 2, n, d_qk)
    v, g = _rand(rs, 1, 2, n, d_v), _rand(rs, 1, 2, n, d_v)
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k)
    ref_o = jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, axis=-1), v)
    o, lse = fa.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v))
    _close(o, ref_o, "o")
    _close(lse, jax.nn.logsumexp(s, axis=-1), "lse")
    ref = flash_attention_bwd_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(g), 1.0)
    got = fa.flash_attention_bwd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 o, lse, torch.from_numpy(g))
    for name, t, r in zip(("dq", "dk", "dv"), got, ref):
        _close(t, r, name)


@pytest.mark.parametrize("n, h, w, p", [(3, 16, 16, 64), (2, 9, 13, 50)])
def test_tap_scatter_point_sample_backward_matches_jax_vjp(n, h, w, p):
    rs = np.random.RandomState(3)
    masks = _rand(rs, n, h, w)
    # Points inside, on the border and outside the map (zero padding).
    coords = rs.uniform(-0.05, 1.05, (n, p, 2)).astype(np.float32)
    g = _rand(rs, n, p)
    out, (ref_dm, _) = _jax_vjp(j_point_sample_trainable, g, masks, coords)
    tm = _t(masks)
    got = point_sample_trainable(tm, torch.from_numpy(coords))
    _close(got, out, "point_sample")
    got.backward(torch.from_numpy(g))
    _close(tm.grad, ref_dm, "d_masks")


def test_tap_scatter_adds_colliding_rows():
    base = torch.tensor([[0, 2, 2, 5]], dtype=torch.int32)
    rows = torch.arange(16, dtype=torch.float32).reshape(1, 4, 4)
    acc = ts.tap_scatter(base, rows, 6)
    want = torch.zeros(1, 6, 4)
    want[0, 0], want[0, 2], want[0, 5] = rows[0, 0], rows[0, 1] + rows[0, 2], rows[0, 3]
    torch.testing.assert_close(acc, want, rtol=0, atol=0)
    assert ts.tap_scatter.launches == 0  # CPU tensors: the plain version
