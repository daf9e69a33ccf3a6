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

B9's and B10's plain versions are also held against the JAX package's
Pallas backward kernels themselves (``_block_backward``, ``_tail_backward``,
run in interpret mode: the ``interpret`` fixture patches
``pl.pallas_call`` for the test's duration), in fp32 at the same bar and
in bf16, where the two share every rounding point but those named at the
test, at a stated relative L2 bound.
"""

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iuvl_tpu.ops.pallas.flash_attention import flash_attention_bwd_xla
from iuvl_tpu.ops.pallas.mlp_block import _tail_backward, _tail_xla
from iuvl_tpu.ops.pallas.window_block import _block_backward, _block_xla
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


@pytest.fixture
def interpret():
    """JAX's Pallas kernels in interpret mode (CPU), for the test's duration."""
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        kw.pop("compiler_params", None)
        return orig(*a, **kw)

    pl.pallas_call = interp
    try:
        yield
    finally:
        pl.pallas_call = orig


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _bf16(x):
    """x rounded to bf16, as fp32 (the same values for JAX and PyTorch)."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


# bf16 bounds (relative L2, port plain vs the Pallas kernel), about 3x the
# readings at these inputs (B10 2.3e-3 to 4.9e-3, B9 4.0e-3 to 6.6e-3; the
# bias gradients of g exact). B10: the Pallas kernel's GELU runs in bf16
# arithmetic (jax.nn.gelu on the bf16 hidden), the port's in fp32 and is
# rounded once, which moves h and so dW2 most. B9: the Pallas kernel adds
# bqkv in fp32 before rounding qkv and multiplies the rel-pos tables and
# their cotangents in bf16 (Rh cast to bf16); the port rounds x Wqkv^T,
# then adds bf16(bqkv), and keeps the tables in fp32, as its forward does.
TAIL_BF16 = {"dxa": 6e-3, "dscale": 1e-2, "dbias": 1e-2, "dw1": 1.2e-2, "db1": 1e-2,
             "dw2": 1.5e-2, "db2": 1e-6}
BLOCK_BF16 = {"dx": 2e-2, "dwqkv": 2e-2, "dbqkv": 1.2e-2, "dwo": 1.5e-2, "dbo": 1e-6,
              "drh": 1.8e-2, "drw": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_tail_backward_plain_matches_pallas_kernel(dtype, interpret):
    rs = np.random.RandomState(4)
    t_rows, c, hidden = 48, 32, 128  # three 16-row chunks of the kernel's serial grid
    x, a, g = (_bf16(_rand(rs, t_rows, c)) for _ in range(3))
    scale, bias = 1 + _rand(rs, c, std=0.1), _rand(rs, c, std=0.3)
    w1, b1 = _bf16(_rand(rs, c, hidden, std=c ** -0.5)), _bf16(_rand(rs, hidden, std=0.3))
    w2 = _bf16(_rand(rs, hidden, c, std=hidden ** -0.5))
    jdt = jnp.dtype(dtype)
    ref = _tail_backward(*(jnp.asarray(v, jdt) for v in (x, a)), jnp.asarray(scale),
                         jnp.asarray(bias), jnp.asarray(w1, jdt), jnp.asarray(b1),
                         jnp.asarray(w2, jdt), jnp.zeros((c,), jnp.float32),
                         jnp.asarray(g, jdt), mb.EPS)
    tdt = getattr(torch, dtype)
    got = mb.block_tail_backward_plain(
        *(torch.from_numpy(v).to(tdt) for v in (x, a, g)), torch.from_numpy(scale),
        torch.from_numpy(bias), torch.from_numpy(w1.T.copy()).to(tdt),
        torch.from_numpy(b1).to(tdt), torch.from_numpy(w2).to(tdt))
    # JAX: (dx, da, dscale, dbias, dw1 (C, H), db1, dw2 (H, C), db2).
    want = (ref[0], ref[2], ref[3], ref[4].T, ref[5], ref[6].T, ref[7])
    for name, p, r in zip(TAIL_BF16, got, want):
        p, r = p.float().numpy(), np.asarray(r, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(p, r, err_msg=name, **TOL)
        else:
            assert _rel(p, r) <= TAIL_BF16[name], (name, _rel(p, r))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_block_backward_plain_matches_pallas_kernel(dtype, interpret):
    rs = np.random.RandomState(5)
    win, c, heads, nw = 4, 32, 2, 6  # two 3-window steps of the kernel's serial grid
    d, n = c // heads, win * win
    xw, g = (_bf16(_rand(rs, nw, n, c)) for _ in range(2))
    wqkv, bqkv = _bf16(_rand(rs, c, 3 * c, std=c ** -0.5)), _rand(rs, 3 * c, std=0.3)
    wo = _bf16(_rand(rs, c, c, std=c ** -0.5))
    rph, rpw = _rand(rs, 2 * win - 1, d, std=0.3), _rand(rs, 2 * win - 1, d, std=0.3)
    rh, rw = rel_pos_tables(torch.from_numpy(rph), torch.from_numpy(rpw), (win, win))
    jdt = jnp.dtype(dtype)
    ref = _block_backward(jnp.asarray(xw, jdt), jnp.asarray(g, jdt), jnp.asarray(wqkv, jdt),
                          jnp.asarray(bqkv), jnp.asarray(wo, jdt), jnp.asarray(rh.numpy()),
                          jnp.asarray(rw.numpy()), win, heads)
    tdt = getattr(torch, dtype)
    got = wb.window_block_backward_plain(
        torch.from_numpy(xw).to(tdt), torch.from_numpy(g).to(tdt),
        torch.from_numpy(wqkv.T.copy()).to(tdt), torch.from_numpy(bqkv),
        torch.from_numpy(wo.T.copy()).to(tdt), rh, rw, heads)
    # JAX: dx, dWqkv (C, 3C), dbqkv, dWo (C, C), dbo, and the (d, n) table
    # gradients of Rh and Rw transposed: (d, win, win) -> (win, win, d).
    table = lambda x: np.asarray(x).reshape(d, win, win).transpose(1, 2, 0)  # noqa: E731
    want = (ref[0], np.asarray(ref[1]).T, ref[2].reshape(-1), np.asarray(ref[3]).T,
            ref[4].reshape(-1), table(ref[5]), table(ref[6]))
    for name, p, r in zip(BLOCK_BF16, got, want):
        p, r = p.float().numpy(), np.asarray(r, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(p, r, err_msg=name, **TOL)
        else:
            assert _rel(p, r) <= BLOCK_BF16[name], (name, _rel(p, r))
