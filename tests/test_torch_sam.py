"""The port's SAM against the JAX package's on the CPU: the weight bridge,
each module, and the encode-once / decode-many slice end to end.

Tiny config (embed 32, depth 2, 2 heads, global block 1, window 4,
128^2 image: an 8x8 grid in four 4x4 windows), fp32, JAX with its
default CPU impls and ``twoway_impl='off'``, the port with its plain
kernel versions (the CUDA wrappers given CPU tensors). Tolerance: the
JAX suite's fp32 bar, atol = rtol = 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iuvl_tpu.models.sam.build import Sam as JSam
from iuvl_tpu.models.sam.build import SamConfig as JSamConfig
from iuvl_tpu.models.sam.convert import convert_sam
from iuvl_tpu_torch.models.sam import Sam, SamConfig
from iuvl_tpu_torch.models.sam.convert import flax_to_state_dict

TINY = dict(embed_dim=32, depth=2, num_heads=2, global_attn_indexes=(1,),
            img_size=128, window_size=4)
TOL = dict(atol=1e-4, rtol=1e-4)
GRID = 8


def _perturb(params, rs):
    """flax inits rel-pos tables, pos-embed and biases to zero; make them
    random so that the bias paths are compared."""
    def f(path, x):
        name = jax.tree_util.keystr(path)
        if any(s in name for s in ("rel_pos", "pos_embed", "'bias'")):
            return jnp.asarray(rs.randn(*x.shape).astype(np.float32) * 0.1)
        return x
    return jax.tree_util.tree_map_with_path(f, params)


@pytest.fixture(scope="module")
def models():
    rs = np.random.RandomState(0)
    jm = JSam(cfg=JSamConfig(**TINY, twoway_impl="off"))
    images = jnp.zeros((1, 128, 128, 3), jnp.float32)
    points = jnp.zeros((1, 1, 2), jnp.float32)
    labels = jnp.ones((1, 1), jnp.int32)
    # A masks= prompt makes flax create prompt_encoder/mask_conv* too.
    masks = jnp.zeros((1, 4 * GRID, 4 * GRID, 1), jnp.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), images, points, labels, None, masks)
    params = _perturb(params, rs)
    tm = Sam(SamConfig(**TINY)).eval()
    tm.load_state_dict(flax_to_state_dict(params, depth=TINY["depth"]), strict=True)
    return jm, params, tm


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(port, ref, name="", **tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), err_msg=name,
                               **(tol or TOL))


def test_bridge_round_trip_is_exact(models):
    jm, params, tm = models
    sd = flax_to_state_dict(params, depth=TINY["depth"])
    assert set(sd) == set(tm.state_dict())
    back = convert_sam({k: v.numpy() for k, v in sd.items()}, depth=TINY["depth"])
    flat_ref, tree_ref = jax.tree_util.tree_flatten(params)
    flat_back, tree_back = jax.tree_util.tree_flatten(back)
    assert tree_ref == tree_back
    for a, b in zip(flat_ref, flat_back):
        np.testing.assert_array_equal(np.asarray(a), b)


def _image(seed=1):
    return np.random.RandomState(seed).rand(2, 128, 128, 3).astype(np.float32) * 255


def test_image_encoder_parity(models):
    jm, params, tm = models
    x = jm.apply(params, jnp.asarray(_image()), method=JSam.normalize)
    emb, fpn = jax.jit(lambda p, x: jm.apply(p, x, method=JSam.encode_image))(params, x)
    with torch.no_grad():
        temb, tfpn = tm.image_encoder(_t(x))
    _close(temb, emb, "sam_embedding")
    for k in ("res2", "res3", "res4", "res5"):
        _close(tfpn[k], fpn[k], k)


def _prompts(b=3, n=2, seed=2):
    rs = np.random.RandomState(seed)
    points = rs.rand(b, n, 2).astype(np.float32) * 128
    labels = rs.randint(-1, 2, (b, n)).astype(np.int32)
    boxes = np.sort(rs.rand(b, 2, 2).astype(np.float32) * 128, axis=1).reshape(b, 4)
    masks = rs.randn(b, 4 * GRID, 4 * GRID, 1).astype(np.float32)
    return points, labels, boxes, masks


@pytest.mark.parametrize("kind", ["points", "points_boxes_masks"])
def test_prompt_encoder_parity(models, kind):
    jm, params, tm = models
    points, labels, boxes, masks = _prompts()
    kw = dict(points=points, labels=labels)
    if kind != "points":
        kw.update(boxes=boxes, masks=masks)
    sparse, dense, pe = jax.jit(lambda p, kw: jm.apply(
        p, method=lambda m: (*m.prompt_encoder(**kw), m.prompt_encoder.get_dense_pe())))(
        params, kw)
    with torch.no_grad():
        tsparse, tdense = tm.prompt_encoder(**{k: _t(v) for k, v in kw.items()})
        tpe = tm.prompt_encoder.get_dense_pe()
    _close(tsparse, sparse, "sparse")
    _close(tdense, dense, "dense")
    _close(tpe, pe, "dense_pe")


def test_mask_decoder_parity(models):
    """Batch-1 image embedding broadcast over per-prompt tokens, and a
    per-prompt dense map."""
    jm, params, tm = models
    rs = np.random.RandomState(3)
    emb = rs.randn(1, GRID, GRID, 256).astype(np.float32)
    pe = rs.randn(GRID, GRID, 256).astype(np.float32)
    sparse = rs.randn(3, 3, 256).astype(np.float32)
    dense = rs.randn(3, GRID, GRID, 256).astype(np.float32) * 0.1
    ref = jax.jit(lambda p, *a: jm.apply(p, *a, method=lambda m, *a: m.mask_decoder(*a)))(
        params, emb, pe, sparse, dense)
    with torch.no_grad():
        out = tm.mask_decoder(*map(_t, (emb, pe, sparse, dense)))
    assert set(out) == set(ref)
    for k in ref:
        _close(out[k], ref[k], k)


def test_slice_encode_once_decode_many(models):
    """normalize -> encode_image once -> decode_from_embedding for two
    chunks of point prompts, as the serving path runs."""
    jm, params, tm = models
    image = _image(4)[:1]
    emb = jax.jit(lambda p, x: jm.apply(p, jm.apply(p, x, method=JSam.normalize),
                                        method=JSam.encode_image)[0])(params, image)
    decode = jax.jit(lambda p, e, pts, labs: jm.apply(
        p, e, points=pts, labels=labs, method=JSam.decode_from_embedding))
    with torch.no_grad():
        temb, fpn = tm.encode_image(tm.normalize(_t(image)), return_fpn=False)
    assert fpn is None
    _close(temb, emb, "sam_embedding")
    rs = np.random.RandomState(5)
    for chunk in range(2):
        points = rs.rand(4, 1, 2).astype(np.float32) * 128
        labels = np.ones((4, 1), np.int32)
        ref = decode(params, emb, points, labels)
        with torch.no_grad():
            out = tm.decode_from_embedding(temb, _t(points), _t(labels))
        for k in ("masks", "iou_pred", "upscaled_embedding", "hyper_in"):
            _close(out[k], ref[k], f"chunk {chunk} {k}")
        assert out["masks"].shape == (4, 4, 4 * GRID, 4 * GRID)
