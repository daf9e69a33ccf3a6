"""The port's plain kernel versions (what its CUDA wrappers run on CPU
tensors) against the JAX package's oracles, and where cheap against the
Pallas kernels themselves in interpret mode. fp32 unless stated, with the
JAX suite's bar of atol = rtol = 1e-4."""

import contextlib
import importlib

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iuvl_tpu.ops.pallas import flash_attention as jfa
from iuvl_tpu.ops.pallas import mask_upscale as jmu
from iuvl_tpu.models.sam.mask_decoder import _bd_constants, _pack_bd
from iuvl_tpu.ops.pallas import mlp_block as jmb
from iuvl_tpu.ops.pallas import twoway_attention as jta
from iuvl_tpu.ops.pallas import window_block as jwb
from iuvl_tpu_torch.ops import rel_pos_attention as trpa
from iuvl_tpu_torch.ops.cuda import flash_attention as tfa
from iuvl_tpu_torch.ops.cuda import mask_upscale as tmu
from iuvl_tpu_torch.ops.cuda import mlp_block as tmb
from iuvl_tpu_torch.ops.cuda import twoway_attention as tta
from iuvl_tpu_torch.ops.cuda import window_block as twb

# iuvl_tpu.ops re-exports a function under the submodule's name
jrpa = importlib.import_module("iuvl_tpu.ops.rel_pos_attention")

TOL = dict(atol=1e-4, rtol=1e-4)


@contextlib.contextmanager
def interpret(module):
    """Run ``module``'s pallas_calls in interpret mode (CPU)."""
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    module.pl.pallas_call = interp
    try:
        yield
    finally:
        module.pl.pallas_call = orig


def _rand(rs, *shape, std=1.0):
    return (rs.randn(*shape) * std).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               **(tol or TOL))


@pytest.mark.parametrize("stored, size", [(9, 5), (5, 7), (13, 4)])
def test_rel_pos_table_matches_jax(stored, size):
    """Includes the linear-resize branch, up and down (antialiased)."""
    rp = _rand(np.random.RandomState(stored), stored, 6)
    ref = jrpa.rel_pos_table(size, size, jnp.asarray(rp))
    _close(trpa.rel_pos_table(size, size, _t(rp)), ref, atol=1e-6, rtol=1e-6)


def test_pos_embed_bicubic_resize_matches_jax():
    from iuvl_tpu_torch.ops.resize import resize_axis

    pos = _rand(np.random.RandomState(1), 1, 6, 6, 4)
    for size in (9, 4):
        ref = jax.image.resize(jnp.asarray(pos), (1, size, size, 4), method="bicubic")
        out = resize_axis(resize_axis(_t(pos), 1, size, "cubic"), 2, size, "cubic")
        _close(out, ref, atol=1e-5, rtol=1e-5)


def test_naive_rel_pos_attention_matches_jax():
    rs = np.random.RandomState(2)
    q, k, v = (_rand(rs, 2, 2, 20, 8) for _ in range(3))
    rph, rpw = _rand(rs, 7, 8, std=0.3), _rand(rs, 9, 8, std=0.3)
    ref = jrpa.rel_pos_attention(*map(jnp.asarray, (q, k, v, rph, rpw)), (4, 5),
                                 impl="xla_naive")
    for fn in (trpa.rel_pos_attention_naive, trpa.rel_pos_attention):
        _close(fn(*map(_t, (q, k, v, rph, rpw)), (4, 5)), ref)


def _window_inputs(win=4, heads=2, d=16, nw=4, seed=3):
    rs = np.random.RandomState(seed)
    c = heads * d
    return dict(
        xw=_rand(rs, nw, win * win, c, std=0.5), wqkv=_rand(rs, c, 3 * c, std=0.1),
        bqkv=_rand(rs, 3 * c, std=0.1), wo=_rand(rs, c, c, std=0.1),
        bo=_rand(rs, c, std=0.1), rph=_rand(rs, 2 * win - 1, d, std=0.2),
        rpw=_rand(rs, 2 * win - 1, d, std=0.2))


def _window_port(a, win, heads):
    # JAX kernels are (in, out); the port takes nn.Linear (out, in).
    rh, rw = trpa.rel_pos_tables(_t(a["rph"]), _t(a["rpw"]), (win, win))
    return twb.window_attention_block(
        _t(a["xw"]), _t(a["wqkv"].T), _t(a["bqkv"]), _t(a["wo"].T), _t(a["bo"]), rh, rw,
        heads)


def test_window_block_plain_matches_jax_oracle_and_kernel():
    win, heads = 4, 2
    a = _window_inputs(win, heads)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    jargs = (j["xw"], j["wqkv"], j["bqkv"], j["wo"], j["bo"], j["rph"], j["rpw"], win, heads)
    out = _window_port(a, win, heads)
    assert twb.window_attention_block.launches == 0
    _close(out, jwb._block_xla(*jargs))
    with interpret(jwb):
        _close(out, jwb.window_attention_block(*jargs))


def _rowbias_inputs(h=4, w=4, heads=3, d=16, b=2, c_out=24, seed=4):
    rs = np.random.RandomState(seed)
    n = h * w
    return dict(q=_rand(rs, b, heads, n, d), k=_rand(rs, b, heads, n, d),
                v=_rand(rs, b, heads, n, d), rph=_rand(rs, 2 * h - 1, d, std=0.3),
                rpw=_rand(rs, 2 * w - 1, d, std=0.3),
                wo=_rand(rs, heads * d, c_out, std=0.1), bo=_rand(rs, c_out, std=0.1))


def test_rowbias_proj_plain_matches_jax_oracle_and_kernel():
    """Several heads, a non-zero bias, multiple q/k blocks in the kernel."""
    hw = (4, 4)
    a = _rowbias_inputs()
    j = {k: jnp.asarray(v) for k, v in a.items()}
    out = trpa.rel_pos_attention_proj(
        _t(a["q"]), _t(a["k"]), _t(a["v"]), *trpa.rel_pos_tables(_t(a["rph"]), _t(a["rpw"]), hw),
        _t(a["wo"].T), _t(a["bo"]))
    assert tfa.flash_attention_rowbias_proj.launches == 0
    jargs = (j["q"], j["k"], j["v"], j["rph"], j["rpw"], j["wo"], j["bo"], hw)
    _close(out, jrpa._attn_then_proj(*jargs, "xla_naive"))
    with interpret(jfa):
        _close(out, jrpa._rowbias_proj_route(*jargs))


def _window_port_dtype(a, win, heads, dtype):
    """The port's B1 wrapper (its plain version here) on ``dtype`` storage:
    x and the weights in ``dtype``, biases and rel-pos tables fp32."""
    rh, rw = trpa.rel_pos_tables(_t(a["rph"]), _t(a["rpw"]), (win, win))
    cast = lambda x: _t(x).to(dtype)  # noqa: E731
    return twb.window_attention_block(cast(a["xw"]), cast(a["wqkv"].T), _t(a["bqkv"]),
                                      cast(a["wo"].T), _t(a["bo"]), rh, rw, heads)


def _window_jax(a, win, heads, dtype=jnp.float32):
    j = {k: jnp.asarray(v) for k, v in a.items()}
    return (j["xw"].astype(dtype), j["wqkv"], j["bqkv"], j["wo"], j["bo"], j["rph"], j["rpw"],
            win, heads)


def test_window_block_plain_matches_jax_oracle_bf16():
    """bf16 storage, as the card holds B1 against this plain version: qkv,
    the rel-pos features, p and o rounded where _block_xla rounds them, so
    the two differ by bf16 products landing an ulp apart (the JAX suite's
    bf16 bar of 1e-2)."""
    win, heads = 4, 2
    a = _window_inputs(win, heads, seed=8)
    out = _window_port_dtype(a, win, heads, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    _close(out, jwb._block_xla(*_window_jax(a, win, heads, jnp.bfloat16)), atol=1e-2,
           rtol=1e-2)


def test_window_block_plain_matches_jax_odd_window():
    """An odd window (3 x 3, N 9: rows no multiple of 16, as B1's masked
    last strip at N 196) against JAX's oracle and its interpret-mode kernel."""
    win, heads = 3, 2
    a = _window_inputs(win, heads, nw=3, seed=9)
    out = _window_port(a, win, heads)
    _close(out, jwb._block_xla(*_window_jax(a, win, heads)))
    with interpret(jwb):
        _close(out, jwb.window_attention_block(*_window_jax(a, win, heads)))


def test_rowbias_proj_plain_matches_jax_oracle_bf16(monkeypatch):
    """bf16 storage on a grid with h != w (8 x 16, N 128: one that
    rowbias_supported admits, so rel_pos_attention_proj takes
    rowbias_proj_plain, B2's plain version). JAX's naive oracle adds the
    unrounded fp32 bias where the port rounds relh and relw to bf16, as
    JAX's fused route does: the JAX suite's bf16 bar of 1e-2."""
    hw = (8, 16)
    a = _rowbias_inputs(h=8, w=16, heads=2, d=16, b=1, c_out=32, seed=10)
    calls = []
    plain = tfa.rowbias_proj_plain
    monkeypatch.setattr(tfa, "rowbias_proj_plain", lambda *x: calls.append(1) or plain(*x))
    bf = lambda x: _t(x).to(torch.bfloat16)  # noqa: E731
    out = trpa.rel_pos_attention_proj(
        bf(a["q"]), bf(a["k"]), bf(a["v"]),
        *trpa.rel_pos_tables(_t(a["rph"]), _t(a["rpw"]), hw), bf(a["wo"].T), _t(a["bo"]))
    assert calls and out.dtype == torch.bfloat16
    j = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in a.items()}
    ref = jrpa._attn_then_proj(j["q"], j["k"], j["v"], jnp.asarray(a["rph"]),
                               jnp.asarray(a["rpw"]), j["wo"], j["bo"], hw, "xla_naive")
    assert ref.dtype == jnp.bfloat16
    _close(out, ref, atol=1e-2, rtol=1e-2)


def test_rowbias_proj_plain_matches_jax_rectangular_grid():
    """A 4 x 8 grid (h != w) in fp32 against JAX's oracle and its fused
    interpret-mode route."""
    hw = (4, 8)
    a = _rowbias_inputs(h=4, w=8, seed=11)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    tables = trpa.rel_pos_tables(_t(a["rph"]), _t(a["rpw"]), hw)
    args = (_t(a["q"]), _t(a["k"]), _t(a["v"]), *tables, _t(a["wo"].T), _t(a["bo"]))
    out = trpa.rel_pos_attention_proj(*args)
    jargs = (j["q"], j["k"], j["v"], j["rph"], j["rpw"], j["wo"], j["bo"], hw)
    _close(out, jrpa._attn_then_proj(*jargs, "xla_naive"))
    relh, relw = trpa.rel_pos_features(args[0], *tables)
    d = args[0].shape[-1]
    _close(tfa.rowbias_proj_plain(args[0] * d ** -0.5, args[1], args[2], relh, relw, args[5],
                                  args[6], hw[1]), jrpa._attn_then_proj(*jargs, "xla_naive"))
    with interpret(jfa):
        _close(out, jrpa._rowbias_proj_route(*jargs))


def _tail_inputs(t=64, c=32, hidden=128, seed=5):
    rs = np.random.RandomState(seed)
    return dict(x=_rand(rs, t, c), a=_rand(rs, t, c), scale=1 + _rand(rs, c, std=0.1),
                bias=_rand(rs, c, std=0.1), w1=_rand(rs, c, hidden, std=0.1),
                b1=_rand(rs, hidden, std=0.1), w2=_rand(rs, hidden, c, std=0.1),
                b2=_rand(rs, c, std=0.1))


def _tail_port(a, dtype=torch.float32):
    # JAX's weights (in, out) transposed: the port takes nn.Linear layouts.
    cast = lambda k: _t(a[k]).to(dtype)  # noqa: E731
    return tmb.block_tail(cast("x"), cast("a"), _t(a["scale"]), _t(a["bias"]),
                          _t(a["w1"].T).to(dtype), cast("b1"), _t(a["w2"].T).to(dtype),
                          cast("b2"))


def _tail_jax(a, dtype=jnp.float32):
    j = {k: jnp.asarray(v) for k, v in a.items()}
    return (j["x"].astype(dtype), j["a"].astype(dtype), j["scale"], j["bias"],
            j["w1"], j["b1"], j["w2"], j["b2"])


@pytest.mark.parametrize("t", [64, 100])  # 100: a ragged last row tile
def test_block_tail_plain_matches_jax_oracle_and_kernel(t):
    a = _tail_inputs(t=t)
    out = _tail_port(a)
    assert tmb.block_tail.launches == 0
    _close(out, jmb._tail_xla(*_tail_jax(a)))
    with interpret(jmb):
        _close(out, jmb.block_tail(*_tail_jax(a)))


@pytest.mark.parametrize("t", [64, 100])
def test_block_tail_plain_matches_jax_oracle_bf16(t):
    """bf16 storage: the two frameworks round at the same points, but the
    bf16 products and the tanh GELU may land one bf16 ulp (2^-8 relative)
    apart, so the bound is the JAX suite's bf16 bar of 1e-2."""
    a = _tail_inputs(t=t, seed=6)
    out = _tail_port(a, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    _close(out, jmb._tail_xla(*_tail_jax(a, jnp.bfloat16)), atol=1e-2, rtol=1e-2)


def _upscale_inputs(b=2, n=16, c=32, m=4, seed=7):
    rs = np.random.RandomState(seed)
    c4, c8 = c // 4, c // 8
    return dict(keys=_rand(rs, b, n, c, std=0.5),
                k1=_rand(rs, 2, 2, c4, c, std=0.2), b1=_rand(rs, c4, std=0.1),
                lnw=1 + _rand(rs, c4, std=0.1), lnb=_rand(rs, c4, std=0.1),
                k2=_rand(rs, 2, 2, c8, c4, std=0.3), b2=_rand(rs, c8, std=0.1),
                hyper=_rand(rs, b, m, c8, std=0.5))


def _upscale_port(a, dtype=torch.float32):
    # flax ConvTranspose kernel (kh, kw, out, in) -> torch (in, out, kh, kw)
    deconv = lambda k: tmu.flat_deconv(_t(k.transpose(3, 2, 0, 1)).to(dtype))  # noqa: E731
    cast = lambda k: _t(a[k]).to(dtype)  # noqa: E731
    return tmu.masks_upscale(cast("keys"), deconv(a["k1"]), cast("b1"), _t(a["lnw"]),
                             _t(a["lnb"]), deconv(a["k2"]), cast("b2"), cast("hyper"))


def _upscale_jax(a, dtype=jnp.float32):
    j = {k: jnp.asarray(v) for k, v in a.items()}
    return (j["keys"].astype(dtype), j["k1"], j["b1"], j["lnw"], j["lnb"], j["k2"], j["b2"],
            j["hyper"])


# N 16 (4^2) and N 36 (6^2): a grid whose rows are no multiple of the CUDA
# kernel's 64-row tile (C5), which JAX's kernel takes.
@pytest.mark.parametrize("side", [4, 6], ids=["n16", "n36"])
def test_masks_upscale_plain_matches_jax_oracle_and_kernel(side):
    a = _upscale_inputs(n=side * side)
    jargs = _upscale_jax(a)
    flat = _upscale_port(a)
    assert tmu.masks_upscale.launches == 0
    ref = jmu.masks_upscale_xla(*jargs)
    _close(flat, ref)
    _close(tmu.unflatten_masks(flat, side, side, 4), jmu.unflatten_masks(ref, side, side, 4))
    with interpret(jmu):
        _close(flat, jmu.masks_upscale(*jargs))


def test_masks_upscale_plain_matches_jax_oracle_bf16():
    """bf16 storage, the rounding points the card holds B6's kernel to: y1
    and y2 rounded before their biases, the GELUs on bf16 values, the logits
    stored in bf16. The frameworks' bf16 products and tanh GELUs may land
    one bf16 ulp (2^-8 relative) apart, so the bound is the JAX suite's
    bf16 bar of 1e-2, as for the block tail."""
    a = _upscale_inputs(n=36, seed=11)
    flat = _upscale_port(a, torch.bfloat16)
    assert flat.dtype == torch.bfloat16
    _close(flat, jmu.masks_upscale_xla(*_upscale_jax(a, jnp.bfloat16)), atol=1e-2, rtol=1e-2)


def _twoway_inputs(shared, b=3, t=5, n=24, heads=2, d=8, c=32, seed=8):
    """Weights in JAX's (in, out) layout; biases, PE and the LN params
    non-zero, so that a dropped term shows."""
    rs = np.random.RandomState(seed)
    i = heads * d
    a = dict(keys=_rand(rs, 1 if shared else b, n, c), pe=_rand(rs, n, i, std=0.5),
             q=_rand(rs, b, t, i), kp=_rand(rs, b, t, i), vp=_rand(rs, b, t, i),
             ln_w=1 + _rand(rs, c, std=0.1), ln_b=_rand(rs, c, std=0.1))
    for name, shape in (("q", (c, i)), ("k", (c, i)), ("v", (c, i)), ("o", (i, c))):
        a["w" + name] = _rand(rs, *shape, std=0.2)
        a["b" + name] = _rand(rs, shape[1], std=0.1)
    return a


@pytest.mark.parametrize("shared, t, n", [
    pytest.param(True, 5, 24, id="batch1_keys"), pytest.param(False, 5, 24, id="per_prompt_keys"),
    # A 20-click prompt's 26 tokens; N 100, no multiple of the CUDA kernel's
    # 64-key tile (C5), which JAX's kernel takes.
    pytest.param(True, 26, 24, id="batch1_keys_t26"),
    pytest.param(False, 26, 24, id="per_prompt_keys_t26"),
    pytest.param(True, 5, 100, id="batch1_keys_n100"),
    pytest.param(False, 5, 100, id="per_prompt_keys_n100")])
def test_t2i_stream_plain_matches_jax_oracle_and_kernel(shared, t, n):
    """The TPU functions take block-diagonally packed queries and return
    packed rows; the port's take and return (B, T, heads*d)."""
    heads, d = 2, 8
    per = -(-t // 8) * 8  # the packed token slots a head: T rounded up to 8
    a = _twoway_inputs(shared, t=t, n=n)
    b, t, i = a["q"].shape
    out = tta.t2i_stream(*map(_t, (a["q"], a["keys"], a["pe"], a["wk"].T, a["bk"],
                                   a["wv"].T, a["bv"])), heads)
    assert tta.t2i_stream.launches == 0
    j = {k: jnp.asarray(v) for k, v in a.items()}
    jargs = (_pack_bd(j["q"], heads, d, per), j["keys"], j["pe"][None], j["wk"], j["bk"],
             j["wv"], j["bv"])
    headmask = jnp.asarray(_bd_constants(heads, d, per)[2])

    def merge(obd):
        return (obd.reshape(b, heads, per, i) * headmask[:, None, :]).sum(1)[:, :t]

    _close(out, merge(jta.t2i_stream_xla(*jargs)))
    with interpret(jta):
        _close(out, merge(jta.t2i_stream(*jargs)))


@pytest.mark.parametrize("shared, t, n", [
    pytest.param(True, 5, 24, id="batch1_keys"), pytest.param(False, 5, 24, id="per_prompt_keys"),
    # Past 16 tokens (a 20-click prompt's 26), where the CUDA kernel holds
    # the prompt's k and v in more than one 16-token tile.
    pytest.param(True, 26, 24, id="batch1_keys_t26"),
    pytest.param(False, 26, 24, id="per_prompt_keys_t26"),
    # N 100: no multiple of the CUDA kernel's 16-row strip (C5); JAX's
    # kernel takes it.
    pytest.param(True, 5, 100, id="batch1_keys_n100"),
    pytest.param(False, 5, 100, id="per_prompt_keys_n100")])
def test_i2t_block_step_plain_matches_jax_oracle_and_kernel(shared, t, n):
    heads, d = 2, 8
    per = -(-t // 8) * 8  # the packed token slots a head: T rounded up to 8
    a = _twoway_inputs(shared, t=t, n=n, seed=9)
    out = tta.i2t_block_step(*map(_t, (a["keys"], a["pe"], a["kp"], a["vp"], a["wq"].T,
                                       a["bq"], a["wo"].T, a["bo"], a["ln_w"], a["ln_b"])),
                             heads)
    assert tta.i2t_block_step.launches == 0
    j = {k: jnp.asarray(v) for k, v in a.items()}
    smask = np.where(np.tile(np.arange(per) < t, heads), 0.0, -1e30).astype(np.float32)
    jargs = (j["keys"], j["pe"][None], _pack_bd(j["kp"], heads, d, per),
             _pack_bd(j["vp"], heads, d, per), j["wq"], j["bq"], j["wo"], j["bo"],
             j["ln_w"], j["ln_b"], jnp.asarray(_bd_constants(heads, d, per)[1]),
             jnp.asarray(smask), d ** -0.5)
    _close(out, jta.i2t_block_step_xla(*jargs))
    with interpret(jta):
        _close(out, jta.i2t_block_step(*jargs))
