"""B17, the segmented scatter-add, on the CPU: the port's plain version
(``segmented_scatter_add_plain``, and the wrapper, which runs it on CPU
tensors) against JAX's ``segmented_scatter_add`` with its Pallas kernel in
interpret mode, at the shapes and tolerances of tests/test_seg_scatter.py:
three (rows, n_out, block, chunk) cases of 256-wide bf16 rows, rows of
other widths (96, 768, odd) in fp32 and fp16, which JAX's function takes
too, and the skewed one (every row into one destination). Inputs from
seeded numpy."""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iuvl_tpu.ops.pallas.seg_scatter as jss
from iuvl_tpu_torch.ops.cuda import seg_scatter as tss


@pytest.fixture()
def interpret_pallas():
    orig = jss.pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        k.pop("compiler_params", None)
        return orig(*a, **k)

    with mock.patch.object(jss.pl, "pallas_call", interp):
        yield


def _port(contrib, idx, n_out, block, chunk):
    """(plain version, wrapper on CPU tensors), each summing in its own
    order (index_put_ with accumulation is not ordered on the CPU), on
    contrib in its own dtype."""
    dtype = getattr(torch, jnp.dtype(contrib.dtype).name)
    c = torch.from_numpy(np.asarray(contrib.astype(jnp.float32))).to(dtype)
    i = torch.from_numpy(np.asarray(idx))
    outs = (tss.segmented_scatter_add_plain(c, i, n_out, block=block, chunk=chunk),
            tss.segmented_scatter_add(c, i, n_out, block=block, chunk=chunk))
    assert all(o.dtype == torch.float32 for o in outs)
    return [o.numpy() for o in outs]


@pytest.mark.parametrize("r,n_out,block,chunk,width,dtype", [
    pytest.param(4096, 1024, 256, 128, 256, jnp.bfloat16, id="4096-1024-256-128"),
    # r not a chunk multiple
    pytest.param(5000, 512, 512, 256, 256, jnp.bfloat16, id="5000-512-512-256"),
    # many empty blocks (must still be zeroed)
    pytest.param(700, 2048, 256, 128, 256, jnp.bfloat16, id="700-2048-256-128"),
    # widths and dtypes past the kernel's first contract (C4)
    pytest.param(1500, 512, 256, 128, 96, jnp.float32, id="w96-float32"),
    pytest.param(600, 512, 256, 128, 768, jnp.float16, id="w768-float16"),
    pytest.param(1500, 1024, 256, 128, 97, jnp.float32, id="w97-float32"),
    pytest.param(1500, 512, 512, 256, 33, jnp.float16, id="w33-float16"),
])
def test_plain_matches_jax_kernel(interpret_pallas, r, n_out, block, chunk, width, dtype):
    rs = np.random.RandomState(r)
    contrib = jnp.asarray(rs.randn(r, width), dtype)
    idx = jnp.asarray(rs.randint(0, n_out, r), jnp.int32)
    want = jss.segmented_scatter_add(contrib, idx, n_out, block=block, chunk=chunk)
    for got in _port(contrib, idx, n_out, block, chunk):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)


def test_skewed_all_rows_one_cell(interpret_pallas):
    rs = np.random.RandomState(0)
    contrib = jnp.asarray(rs.randn(3000, 64), jnp.bfloat16)
    idx = jnp.zeros(3000, jnp.int32)
    want = jss.segmented_scatter_add(contrib, idx, 512, block=512, chunk=256)
    scale = float(jnp.abs(want).max())
    for got in _port(contrib, idx, 512, 512, 256):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=3e-4 * max(scale, 1.0))


def test_cpu_wrapper_counts_nothing_and_keeps_the_block_contract():
    tss.segmented_scatter_add.launches = 0
    out = tss.segmented_scatter_add(torch.ones(3, 8), torch.tensor([0, 5, 0]), 512)
    assert tss.segmented_scatter_add.launches == 0
    assert out[0].tolist() == [2.0] * 8 and out[5].tolist() == [1.0] * 8 and out.sum() == 24
    with pytest.raises(AssertionError):
        tss.segmented_scatter_add(torch.ones(3, 8), torch.zeros(3, dtype=torch.int32), 500)
