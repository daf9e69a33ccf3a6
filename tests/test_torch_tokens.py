"""Shapes the port's kernels now take (C1, C2), on the CPU against the JAX
package:

- C1: ``Sam.decode_from_embedding`` on prompts of 20 points (26 tokens: the
  IoU and 4 mask tokens, 20 points and the pad point), through the per-op
  decode (``'plain'``, whose wrappers B4/B5 take any token count) and the
  whole-chunk decode (``'chunk_plain'``: 32 token slots, 26 valid), against
  JAX's ``'off'`` and ``'chunk_xla'`` on bridged weights (1e-4; 3e-4 for
  the chunk oracle, as tests/test_torch_decode_chunk.py).
- C3: the chunk decode of 40- and 58-point prompts (48 and 64 slots); C8:
  of 60- and 80-point prompts (66 and 86 tokens in 80 and 96 slots, past
  the 64 that B5 and B16 once took), and the per-op decode (``'auto'``,
  whose wrappers run their plain versions here) of the same prompts
  against JAX's ``'off'``.
- C2: the port's copy of ``rowbias_supported`` equals JAX's, and the global
  block's serving route follows it (B2 where it holds, B11's forward on the
  augmented q, k otherwise), both computing the plain function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iuvl_tpu.models.sam.build import Sam as JSam
from iuvl_tpu.models.sam.build import SamConfig as JSamConfig
from iuvl_tpu.ops.pallas.flash_attention import rowbias_supported as j_rowbias_supported
from iuvl_tpu_torch.models.sam import Sam, SamConfig
from iuvl_tpu_torch.models.sam.convert import flax_to_state_dict
from iuvl_tpu_torch.ops import rel_pos_attention as trpa
from iuvl_tpu_torch.ops.cuda import flash_attention as tfa
from tests.test_torch_decode_chunk import _randomize

TINY = dict(embed_dim=32, depth=2, num_heads=2, global_attn_indexes=(1,), img_size=128,
            window_size=4)
GRID, C, POINTS = 8, 256, 20
OUT_KEYS = ("masks", "iou_pred", "upscaled_embedding", "hyper_in")


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.fixture(scope="module")
def params():
    rs = np.random.RandomState(7)
    init = JSam(cfg=JSamConfig(**TINY, twoway_impl="off"))
    # A masks= prompt makes flax create prompt_encoder/mask_conv* too.
    p = jax.jit(init.init)(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)),
                           jnp.zeros((1, 1, 2)), jnp.ones((1, 1), jnp.int32), None,
                           jnp.zeros((1, 4 * GRID, 4 * GRID, 1)))
    return {"params": _randomize(p["params"], rs, ("bias",))}


@pytest.mark.parametrize("port_impl, jax_impl, atol", [("plain", "off", 1e-4),
                                                       ("chunk_plain", "chunk_xla", 3e-4)])
def test_decode_of_20_point_prompts_matches_jax(params, port_impl, jax_impl, atol):
    _decode_matches_jax(params, port_impl, jax_impl, atol, POINTS)


@pytest.mark.parametrize("points", [40, 58, 60, 80])
def test_chunk_decode_of_40_and_58_point_prompts_matches_jax(params, points):
    """C3 and C8: prompts of 40, 58, 60 and 80 points (46, 64, 66 and 86
    tokens) pad to 48, 64, 80 and 96 slots, each a count B16 takes (any
    multiple of 16); the chunk decode against JAX's ``'chunk_xla'``."""
    from iuvl_tpu_torch.ops.cuda.decode_chunk import SLOT

    assert SLOT == 16 and -(-(points + 6) // SLOT) * SLOT == {40: 48, 58: 64, 60: 80, 80: 96}[points]
    _decode_matches_jax(params, "chunk_plain", "chunk_xla", 3e-4, points)


@pytest.mark.parametrize("points", [60, 80])
def test_auto_decode_of_60_and_80_point_prompts_matches_jax(params, points):
    """C8: the per-op decode of prompts past 64 tokens (66 and 86), whose
    B5 now takes any token count, against JAX's ``'off'``."""
    _decode_matches_jax(params, "auto", "off", 1e-4, points)


def _decode_matches_jax(params, port_impl, jax_impl, atol, n_points):
    rs = np.random.RandomState(8)
    jm = JSam(cfg=JSamConfig(**TINY, twoway_impl=jax_impl))
    tm = Sam(SamConfig(**TINY, twoway_impl=port_impl)).eval()
    tm.load_state_dict(flax_to_state_dict(params, depth=2), strict=True)
    emb = rs.randn(1, GRID, GRID, C).astype(np.float32) * 0.5
    points = rs.rand(4, n_points, 2).astype(np.float32) * 128
    labels = rs.randint(0, 2, (4, n_points)).astype(np.int32)
    ref = jax.jit(lambda p, e, pt, lb: jm.apply(p, e, points=pt, labels=lb,
                                                method=JSam.decode_from_embedding))(
        params, jnp.asarray(emb), jnp.asarray(points), jnp.asarray(labels))
    with torch.no_grad():
        out = tm.decode_from_embedding(_t(emb), _t(points), torch.from_numpy(labels))
    for k in OUT_KEYS:
        np.testing.assert_allclose(out[k].float().numpy(), np.asarray(ref[k], np.float32),
                                   atol=atol, rtol=1e-4, err_msg=k)


def test_rowbias_supported_copy_equals_jax():
    grid = [(n, d, hw) for d in (16, 64, 80, 96) for hw in
            [(4, 4), (14, 14), (16, 16), (32, 32), (50, 50), (64, 64), (128, 32), (32, 128),
             (64, 16), (96, 96), (128, 128), (48, 48), (8, 256)]
            for n in {hw[0] * hw[1], hw[0] * hw[1] + 1}]
    got = [trpa.rowbias_supported(n, d, hw) for n, d, hw in grid]
    assert got == [j_rowbias_supported(n, d, hw) for n, d, hw in grid]
    assert any(got) and not all(got)


@pytest.mark.parametrize("hw, d, route", [((32, 32), 64, "B2"), ((32, 32), 80, "B2"),
                                          ((64, 64), 80, "B11"), ((10, 10), 64, "B11"),
                                          ((4, 4), 16, "B11")])
def test_global_serving_route_follows_rowbias_supported(hw, d, route, monkeypatch):
    """Serving (no autograd): B2 where rowbias_supported holds, else the
    augmented q, k through B11's forward; the two give the plain function
    (the materialised-bias oracle) within fp32 rounding."""
    calls = []
    for name in ("flash_attention_rowbias_proj", "flash_attention_fwd"):
        fn = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    rs = np.random.RandomState(3)
    heads, n, c = 2, hw[0] * hw[1], 2 * d
    q, k, v = (_t(rs.randn(1, heads, n, d)) for _ in range(3))
    rph, rpw = _t(rs.randn(2 * hw[0] - 1, d) * 0.1), _t(rs.randn(2 * hw[1] - 1, d) * 0.1)
    wo, bo = _t(rs.randn(c, c) / c ** 0.5), _t(rs.randn(c) * 0.1)
    rh, rw = trpa.rel_pos_tables(rph, rpw, hw)
    with torch.no_grad():
        out = trpa.rel_pos_attention_proj(q, k, v, rh, rw, wo, bo, impl="auto")
    assert calls == [{"B2": "flash_attention_rowbias_proj", "B11": "flash_attention_fwd"}[route]]
    ref = trpa.rel_pos_attention_naive(q, k, v, rph, rpw, hw)
    ref = ref.transpose(1, 2).reshape(1, n, c) @ wo.t() + bo
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-4, rtol=1e-4)
