"""B11's rounding points on the CPU: the port's plain versions
``flash_attention_fwd_plain`` / ``flash_attention_bwd_plain`` (what the
CUDA kernels of ``csrc/flash_attention_train.cu`` are held to on the card)
against JAX's Pallas kernels ``_flash_forward(..., return_lse=True)`` and
``_flash_backward`` in interpret mode, in bf16: N 200 and 300 (one and two
of the TPU's 256-key blocks, masked tails), d_qk 40 and 72, d_v 16. Inputs
from seeded numpy, rounded to bf16 once and handed to both; the backward
of both takes JAX's o and lse. The interpret patch of ``pl.pallas_call`` is
a fixture, never set at import.

Tolerances: relative L2 no looser than ``chip_smoke.py``'s
``KERNEL_BOUNDS["flash_attention"]`` (o 5e-3, lse 1e-5, dq 5e-3, dk 5e-3,
dv 1e-3): the two sides round at the same points (fp32 scores and softmax,
p rounded to bf16 for p v, ds rounded to bf16 before dq and dk, dv from
bf16(p)) but JAX rounds the unnormalised p per 256-key block against that
block's running max, the port against the row's max, and the sums run in
another order.
"""

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iuvl_tpu.ops.pallas import flash_attention as jfa
from iuvl_tpu_torch.ops.cuda import flash_attention as tfa

BOUNDS = {"o": 5e-3, "lse": 1e-5, "dq": 5e-3, "dk": 5e-3, "dv": 1e-3}


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


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _both(x: np.ndarray):
    """x rounded to bf16 once: (the torch tensor, the same values in JAX)."""
    t = torch.from_numpy(x).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


@pytest.mark.parametrize("n", [200, 300])
@pytest.mark.parametrize("d_qk", [40, 72])
def test_plain_matches_pallas_bf16(interpret, n, d_qk):
    rs = np.random.RandomState(n + d_qk)
    heads, d_v = 2, 16
    # Scores of unit spread: q carries the softmax scale, as the callers fold it in.
    (q, jq), (k, jk) = (_both(rs.randn(1, heads, n, d_qk).astype(np.float32) * s)
                        for s in (d_qk ** -0.5, 1.0))
    (v, jv), (do, jdo) = (_both(rs.randn(1, heads, n, d_v).astype(np.float32))
                          for _ in range(2))

    jo, jlse = jfa._flash_forward(jq, jk, jv, return_lse=True)
    o, lse = tfa.flash_attention_fwd_plain(q, k, v)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    errs = {"o": _rel(o.float(), jo.astype(jnp.float32)), "lse": _rel(lse, jlse)}

    # Both backward passes from JAX's forward outputs.
    o_j = torch.from_numpy(np.array(jo.astype(jnp.float32))).to(torch.bfloat16)
    lse_j = torch.from_numpy(np.array(jlse, np.float32))
    want = jfa._flash_backward(jq, jk, jv, jo, jlse, jdo)
    got = tfa.flash_attention_bwd_plain(q, k, v, o_j, lse_j, do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        errs[name] = _rel(g.float(), w.astype(jnp.float32))
    over = {name: e for name, e in errs.items() if not e <= BOUNDS[name]}
    assert not over, f"rel L2 {errs} over {BOUNDS}"
