"""The port's automatic mask generation against the JAX package's on the
CPU: the host helpers on the same numpy inputs (equal, or identical
strings and index sets), and ``generate_masks`` end to end on a tiny SAM
(image 64, embed 32, depth 2) through ``twoway_impl='chunk'`` (B16's plain
version on the CPU) against JAX's ``'chunk_xla'``, on bridged weights.

Here JAX's NMS, RLE encoder and crop resize take its native C++ core
(``iuvl_tpu/native``), which the module's fixture compiles into a
temporary directory of its own; the port's numpy and torch paths must give
the same kept sets, counts and uint8 pixels.
"""

import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iuvl_tpu import native
from iuvl_tpu.data import transforms as jtr
from iuvl_tpu.inference import amg as jamg
from iuvl_tpu.models.sam.build import Sam as JSam
from iuvl_tpu.models.sam.build import SamConfig as JSamConfig
from iuvl_tpu_torch.data import transforms as tr
from iuvl_tpu_torch.inference import amg
from iuvl_tpu_torch.models.sam import Sam, SamConfig
from iuvl_tpu_torch.models.sam.convert import flax_to_state_dict

TINY = dict(embed_dim=32, depth=2, num_heads=2, global_attn_indexes=(1,), img_size=64,
            window_size=4)


@pytest.fixture(scope="module", autouse=True)
def native_core(tmp_path_factory):
    """JAX's native core, compiled for this module alone: the library is a
    build product that a fresh checkout lacks, and the JAX package caches a
    miss for the life of the process, so the module must not depend on
    another test file (or another worker) having built it. The flags are
    those of ``iuvl_tpu/native/build.py``; nothing is written into the JAX
    package's directory."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.fail("g++ not found: JAX's native core (iuvl_tpu/native/preprocess.cpp), "
                    "whose NMS, RLE and resize this module's assertions hold the port "
                    "against, cannot be built")
    src = Path(native.__file__).with_name("preprocess.cpp")
    lib = tmp_path_factory.mktemp("native") / "libiuvl_preprocess.so"
    subprocess.run([gxx, "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
                    "-std=c++17", str(src), "-o", str(lib)], check=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "_LIB_PATH", str(lib))
        mp.setattr(native, "_lib", None)
        yield


def test_the_native_core_is_what_jax_runs_here():
    assert native.available()


@pytest.mark.parametrize("n, layers, scale", [(32, 0, 2), (32, 1, 2), (10, 2, 2), (7, 1, 3)])
def test_point_grids(n, layers, scale):
    want = jamg.build_all_layer_point_grids(n, layers, scale)
    got = amg.build_all_layer_point_grids(n, layers, scale)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("size, layers, ratio", [((64, 64), 1, 512 / 1500),
                                                 ((1024, 1024), 2, 512 / 1500),
                                                 ((480, 640), 1, 0.25)])
def test_crop_boxes(size, layers, ratio):
    assert amg.generate_crop_boxes(size, layers, ratio) == \
        jamg.generate_crop_boxes(size, layers, ratio)


def test_stability_score():
    logits = np.random.RandomState(0).randn(6, 16, 16).astype(np.float32) * 2
    logits[0] = -5  # empty at both offsets
    np.testing.assert_array_equal(amg.stability_score(logits), jamg.stability_score(logits))
    np.testing.assert_array_equal(amg.stability_score(logits, 0.5),
                                  jamg.stability_score(logits, 0.5))


def _masks(seed=1, n=12, h=9, w=7):
    rs = np.random.RandomState(seed)
    m = rs.rand(n, h, w) > rs.rand(n, 1, 1)
    m[0] = False           # empty
    m[1] = True            # full
    m[2] = False
    m[2, 0, 0] = True      # starts with a one-run, one pixel
    m[3] = False
    m[3, -1, -1] = True    # ends with a one-run
    return m


def test_rle_round_trips_and_coco_strings():
    masks = _masks()
    got = amg.masks_to_rles(masks)
    assert got == jamg.masks_to_rles(masks) == [jamg.mask_to_rle(m) for m in masks]
    for m, rle in zip(masks, got):
        np.testing.assert_array_equal(amg.rle_to_mask(rle), m)
        np.testing.assert_array_equal(amg.rle_to_mask(rle), jamg.rle_to_mask(rle))
        coco = amg.coco_encode_rle(rle)
        assert coco == jamg.coco_encode_rle(rle)
        assert isinstance(coco["counts"], str)
        assert amg.coco_decode_rle(coco) == jamg.coco_decode_rle(coco) == rle
        assert amg.area_from_rle(rle) == jamg.area_from_rle(rle) == int(m.sum())


def test_batched_mask_to_box():
    masks = _masks(seed=2)
    np.testing.assert_array_equal(amg.batched_mask_to_box(masks), jamg.batched_mask_to_box(masks))
    assert amg.batched_mask_to_box(np.zeros((0, 4, 4), bool)).shape == (0, 4)
    for box in amg.batched_mask_to_box(masks):
        assert amg.box_xyxy_to_xywh(box) == jamg.box_xyxy_to_xywh(box)


@pytest.mark.parametrize("thresh", [0.3, 0.7])
def test_mask_nms_keeps_jax_set(thresh):
    """Overlapping masks, empty ones, and tied scores: the same kept
    indices, in the same order."""
    rs = np.random.RandomState(3)
    base = rs.rand(20, 16, 16) > 0.7
    masks = np.concatenate([base, base ^ (rs.rand(20, 16, 16) > 0.9)])  # near-copies
    masks[5] = False
    masks[17] = False
    masks[20] = masks[21]  # a duplicate with a tied score
    scores = rs.choice(np.linspace(0, 1, 9), 40).astype(np.float32)
    want = jamg.mask_nms(masks, scores, thresh)
    got = amg.mask_nms(masks, scores, thresh)
    np.testing.assert_array_equal(got, want)
    assert 5 not in got and 17 not in got and len(got) > 1


@pytest.mark.parametrize("shape, side", [((37, 37), 64), ((24, 40), 64), ((683, 683), 1024),
                                         ((100, 61), 64)])
def test_resize_longest_side_matches_jax_to_the_uint8(shape, side):
    image = (np.random.RandomState(4).rand(*shape, 3) * 255).astype(np.uint8)
    assert tr.get_preprocess_shape(*shape, side) == jtr.get_preprocess_shape(*shape, side)
    np.testing.assert_array_equal(tr.resize_longest_side(image, side),
                                  jtr.resize_longest_side(image, side))


class _JittedSam:
    """A JAX ``Sam`` whose ``apply`` is jitted per method: ``generate_masks``
    calls the same shapes many times."""

    normalize = JSam.normalize
    encode_image = JSam.encode_image
    decode_from_embedding = JSam.decode_from_embedding

    def __init__(self, module):
        self.module, self.fns = module, {}

    def apply(self, params, *args, method, **kw):
        if method not in self.fns:
            self.fns[method] = jax.jit(
                lambda p, *a, **k: self.module.apply(p, *a, method=method, **k))
        return self.fns[method](params, *args, **kw)


@pytest.fixture(scope="module")
def sams():
    rs = np.random.RandomState(5)
    jm = JSam(cfg=JSamConfig(**TINY, twoway_impl="chunk_xla"))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                              jnp.zeros((1, 1, 2)), jnp.ones((1, 1), jnp.int32), None,
                              jnp.zeros((1, 16, 16, 1)))
    params = jax.tree_util.tree_map(
        lambda x: x + jnp.asarray(rs.randn(*x.shape).astype(np.float32) * 0.05), params)
    tm = Sam(SamConfig(**TINY, twoway_impl="chunk")).eval()
    tm.load_state_dict(flax_to_state_dict(params, depth=2), strict=True)
    image = (rs.rand(1, 64, 64, 3) * 255).astype(np.float32)
    return _JittedSam(jm), params, tm, image


def _same_records(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if k == "segmentation" and isinstance(g[k], np.ndarray):
                np.testing.assert_array_equal(g[k], w[k])
            elif k in ("predicted_iou", "stability_score"):
                assert g[k] == pytest.approx(w[k], rel=1e-4, abs=1e-5), k
            else:
                assert g[k] == w[k], k


@pytest.mark.parametrize("crop_n_layers", [0, 1])
@pytest.mark.parametrize("thresholds", ["default", "open"])
def test_generate_masks_matches_jax(sams, crop_n_layers, thresholds):
    """8 x 8 points a layer in batches of 64 (crops: 4 x 4); the default
    IoU and stability cuts, and cuts that let every mask through to NMS
    and the RLE codec; every output mode."""
    jm, params, tm, image = sams
    kw = dict(points_per_side=8, batch=64, crop_n_layers=crop_n_layers)
    if thresholds == "open":
        kw.update(pred_iou_thresh=-1e9, stability_thresh=-1.0)
    for mode in ("binary_mask", "uncompressed_rle", "coco_rle"):
        want = jamg.generate_masks(jm, params, jnp.asarray(image), output_mode=mode, **kw)
        got = amg.generate_masks(tm, image, output_mode=mode, **kw)
        assert set(got) == set(want)
        np.testing.assert_array_equal(got["masks"], want["masks"])
        np.testing.assert_allclose(got["scores"], np.asarray(want["scores"], np.float32),
                                   rtol=1e-4, atol=1e-5)
        if "rles" in want:
            assert got["rles"] == want["rles"]
        _same_records(got["records"], want["records"])
        if thresholds == "open":
            assert len(got["records"]) > 1
