"""The port's X-Decoder seg path against the JAX package's on the CPU: the
weight bridge, the pixel decoder, the unified decoder (``task='seg'``,
training) and ``SysLearner.forward_seg`` end to end.

Tiny config (the verify skill's): SAM ``tiny_test`` (embed 32, depth 2,
2 heads, global block 1), 64^2 image, SYSLEARNER_DIM 32, 10 proposals,
2 pixel-decoder layers, 4 heads, 4 classes; fp32, JAX with its default
impls, the port with its plain kernel versions (the CUDA wrappers given
CPU tensors). Random weights from numpy, bridged. Tolerance: the JAX
suite's fp32 bar, atol = rtol = 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iuvl_tpu.models.sam import build as jsb
from iuvl_tpu.models.xdecoder.model import SysLearner as JSysLearner
from iuvl_tpu.models.xdecoder.model import SysLearnerConfig as JConfig
from iuvl_tpu_torch.models.sam import build as tsb
from iuvl_tpu_torch.models.xdecoder import convert
from iuvl_tpu_torch.models.xdecoder.model import SysLearner, SysLearnerConfig

TINY_SAM = dict(embed_dim=32, depth=2, num_heads=2, global_attn_indexes=(1,))
TINY = dict(sam_size="tiny_test", img_size=64, syslearner_dim=32, mask_proposals=10,
            contxt_len=7, pixel_decoder_layers=2, nheads=4, dim_feedforward=64)
TINY_TEXT = dict(text_width=32, text_layers=2, text_heads=4, vocab_size=64)
N_CLASSES = 4
TOL = dict(atol=1e-4, rtol=1e-4)


def random_params(shapes, seed: int = 0):
    """Seeded numpy values for every leaf of a flax shape tree: Dense and
    conv kernels at fan-in scale, norm scales near one, biases and tables
    non-zero so that every path is compared."""
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        shape = s.shape
        if name.endswith("['kernel']"):
            v = rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name.endswith(("['scale']", "ln1']['weight']", "ln2']['weight']",
                            "upscale_ln']['weight']")):
            v = 1.0 + 0.1 * rs.randn(*shape)
        elif name.endswith("['logit_scale']"):
            v = np.asarray(2.0)
        elif name.endswith(("['rel_pos_h']", "['rel_pos_w']", "['bias']")):
            v = 0.1 * rs.randn(*shape)
        elif name.endswith("['pos_embed']"):
            v = 0.02 * rs.randn(*shape)
        else:
            v = 0.5 * rs.randn(*shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def flax_shapes(jm):
    """The flax parameter tree of the JAX ``SysLearner`` ``jm`` (shapes
    only): ``init`` of ``warmup``, which traces every branch (6-10 s)."""
    return jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                        jnp.zeros((N_CLASSES + 1, 32)), method=JSysLearner.warmup))


def bridged_params(cfg: SysLearnerConfig, seed: int = 0):
    """``random_params`` over the flax tree that the weight bridge gives for
    ``cfg``'s port model: flax's own tree, leaf for leaf
    (``test_bridge_round_trip_is_exact_and_covers_every_leaf`` holds them
    equal), made without tracing the JAX model."""
    with torch.device("meta"):
        shapes = SysLearner(cfg).state_dict()
    zeros = {k: torch.zeros(v.shape) for k, v in shapes.items()}
    return random_params(convert.state_dict_to_flax(zeros, cfg), seed)


def tiny_models(text: dict = TINY_TEXT):
    """(JAX model, its params (numpy), port model on the CPU with the same
    weights, port config), with the text tower ``text``."""
    jsb.SAM_VARIANTS["tiny_test"] = TINY_SAM
    tsb.SAM_VARIANTS["tiny_test"] = TINY_SAM
    jm = JSysLearner(cfg=JConfig(**TINY, **text, attn_impl="auto",
                                 msdeform_impl="auto"))
    cfg = SysLearnerConfig(**TINY, **text)
    params = bridged_params(cfg)
    tm = SysLearner(cfg)
    tm.load_state_dict(convert.flax_to_state_dict(params, cfg), strict=True)
    return jm, params, tm, cfg


def inputs(seed: int = 1, b: int = 1):
    rs = np.random.RandomState(seed)
    images = rs.rand(b, 64, 64, 3).astype(np.float32) * 255
    text = rs.randn(N_CLASSES + 1, 32).astype(np.float32)
    return images, text / np.linalg.norm(text, axis=-1, keepdims=True)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(port, ref, name=""):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref, np.float32),
                               err_msg=name, **TOL)


@pytest.fixture(scope="module")
def setup():
    jm, params, tm, cfg = tiny_models()
    images, text = inputs()

    def run(m, images, text):
        _, fpn = m.encode_image(images)
        mask_features, multi_scale = m.pixel_decoder(fpn)
        out = m.predictor(multi_scale, mask_features, text_embeddings=text,
                          logit_scale=m.lang_encoder.logit_scale, task="seg", training=True)
        return fpn, mask_features, multi_scale, out

    ref = jax.jit(lambda p, i, t: jm.apply(p, i, t, method=run))(params, images, text)
    return jm, params, tm, cfg, images, text, jax.tree_util.tree_map(np.asarray, ref)


def test_bridge_round_trip_is_exact_and_covers_every_leaf(setup):
    jm, params, tm, cfg, *_ = setup
    flax_params = random_params(flax_shapes(jm))  # over flax's own tree
    assert (jax.tree_util.tree_structure(flax_params)
            == jax.tree_util.tree_structure(params))  # the fixture's tree is flax's
    for path, ref in jax.tree_util.tree_flatten_with_path(flax_params)[0]:
        np.testing.assert_array_equal(
            np.asarray(ref), dict(jax.tree_util.tree_flatten_with_path(params)[0])[path])
    sd = convert.flax_to_state_dict(flax_params, cfg)
    assert set(sd) == set(tm.state_dict())
    back = convert.state_dict_to_flax(sd, cfg)
    flat_back = {jax.tree_util.keystr(p): v
                 for p, v in jax.tree_util.tree_flatten_with_path(back)[0]}
    unbridged = []
    for path, ref in jax.tree_util.tree_flatten_with_path(flax_params)[0]:
        key = jax.tree_util.keystr(path)
        if key not in flat_back:
            unbridged.append("/".join(str(k.key) for k in path))
            continue
        np.testing.assert_array_equal(flat_back.pop(key), np.asarray(ref), err_msg=key)
    assert not flat_back, sorted(flat_back)  # no port leaf without a flax leaf
    assert not unbridged, unbridged  # the text tower included


def test_pixel_decoder_matches_jax(setup):
    _, _, tm, _, _, _, (fpn, mask_features, multi_scale, _) = setup
    with torch.no_grad():
        mf, ms = tm.pixel_decoder({k: _t(v) for k, v in fpn.items()})
    _close(mf, mask_features, "mask_features")
    for i, (a, b) in enumerate(zip(ms, multi_scale)):
        _close(a, b, f"level {i}")


def test_unified_decoder_seg_training_matches_jax(setup):
    _, _, tm, _, _, text, (_, mask_features, multi_scale, ref) = setup
    with torch.no_grad():
        out = tm.predictor([_t(x) for x in multi_scale], _t(mask_features),
                           text_embeddings=_t(text), logit_scale=tm.lang_encoder.logit_scale)
    assert len(out["aux_outputs"]) == len(ref["aux_outputs"]) == 9
    for layer, (o, r) in enumerate(zip(out["aux_outputs"] + [out],
                                       ref["aux_outputs"] + [ref])):
        for key in ("pred_logits", "pred_masks", "pred_captions"):
            _close(o[key], r[key], f"layer {layer} {key}")


def test_forward_seg_matches_jax(setup):
    _, _, tm, _, images, text, (fpn, _, _, ref) = setup
    with torch.no_grad():
        _, tfpn = tm.encode_image(_t(images), return_embedding=False)
        out = tm.forward_seg(_t(images), _t(text))
    for k in fpn:
        _close(tfpn[k], fpn[k], k)
    for key in ("pred_logits", "pred_masks", "pred_captions"):
        _close(out[key], ref[key], key)


def test_unported_tasks_and_options_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SysLearnerConfig(remat=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SysLearnerConfig(msdeform_impl="scan")
    from iuvl_tpu_torch.models.xdecoder.unified_decoder import UnifiedDecoder

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        UnifiedDecoder(hidden_dim=32, dim_proj=32, num_queries=3, mask_dim=32)(
            [], None, task="captioning_infer")
