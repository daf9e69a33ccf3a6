"""B12, the tap-row scatter-add of the point-sample backward, on the CPU:
the port's plain version (``tap_scatter_plain``, and the wrapper, which
runs it on CPU tensors) against JAX's ``tap_scatter`` with its Pallas
kernel in interpret mode. Cases: two and three maps, spans that are not a
multiple of 8 (the TPU kernel pads its table to one), cells that three or
more rows hit, and a map whose rows all land on one cell. Inputs from
seeded numpy; the sums differ only in their fp32 order."""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iuvl_tpu.ops.pallas.tap_scatter as jts
from iuvl_tpu_torch.ops.cuda import tap_scatter as tts


@pytest.fixture()
def interpret_pallas():
    orig = jts.pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        k.pop("compiler_params", None)
        return orig(*a, **k)

    with mock.patch.object(jts.pl, "pallas_call", interp):
        yield


def _case(name):
    """(base (N, P) int32, rows (N, P, 4) fp32, span) for the named case."""
    rs = np.random.RandomState(len(name))
    if name == "three_maps_collisions":
        n, p, span = 3, 200, 61
        base = rs.randint(0, span, (n, p))
        base[0, [3, 50, 51, 120, 199]] = 7  # five rows on one cell of map 0
        base[2, [0, 1, 2]] = span - 1       # three on the last cell of map 2
    elif name == "one_cell_map":
        n, p, span = 2, 150, 45
        base = rs.randint(0, span, (n, p))
        base[1] = 12                        # every row of map 1 on one cell
    else:  # two maps, few collisions
        n, p, span = 2, 97, 1003
        base = rs.randint(0, span, (n, p))
    rows = rs.randn(n, p, 4).astype(np.float32)
    return base.astype(np.int32), rows, span


@pytest.mark.parametrize("name", ["two_maps", "three_maps_collisions", "one_cell_map"])
def test_plain_and_cpu_wrapper_match_jax_kernel(interpret_pallas, name):
    base, rows, span = _case(name)
    hits = np.stack([np.bincount(b, minlength=span) for b in base])
    if name != "two_maps":
        assert hits.max() >= 3  # the case really has cells that three or more rows hit
    want = np.asarray(jts.tap_scatter(jnp.asarray(base), jnp.asarray(rows), span))
    assert want.shape == (base.shape[0], span, 4)
    b, r = torch.from_numpy(base), torch.from_numpy(rows)
    tts.tap_scatter.launches = 0
    outs = (tts.tap_scatter_plain(b, r, span), tts.tap_scatter(b, r, span))
    assert tts.tap_scatter.launches == 0  # CPU tensors: the plain version
    scale = max(float(np.abs(want).max()), 1.0)
    for got in outs:
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6 * scale)
    # Cells no row hits are exactly zero (the kernel writes every cell).
    assert not outs[0].numpy()[hits == 0].any()
