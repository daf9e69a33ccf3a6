"""The port stands without JAX, and on a machine without nvcc its kernels
fail loudly instead of quietly taking the plain path."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_without_jax():
    # A subprocess: tests/conftest.py has already imported jax here.
    code = (
        "import sys\n"
        "import iuvl_tpu_torch\n"
        "import iuvl_tpu_torch.models.sam as sam\n"
        "import iuvl_tpu_torch.models.sam.convert\n"
        "import iuvl_tpu_torch.ops.cuda.build\n"
        "import iuvl_tpu_torch.models.xdecoder as xd\n"
        "import iuvl_tpu_torch.models.xdecoder.convert\n"
        "import iuvl_tpu_torch.losses.criterion, iuvl_tpu_torch.losses.matcher\n"
        "import iuvl_tpu_torch.train.optimizer, iuvl_tpu_torch.train.train_step\n"
        "import iuvl_tpu_torch.ops.msdeform, iuvl_tpu_torch.ops.point_sample\n"
        "import iuvl_tpu_torch.ops.position_embedding, iuvl_tpu_torch.ops.cuda.tap_scatter\n"
        "import iuvl_tpu_torch.ops.cuda.msdeform, iuvl_tpu_torch.ops.cuda.deform_bwd_glue\n"
        "import iuvl_tpu_torch.ops.cuda.onehot_gather, iuvl_tpu_torch.pipeline\n"
        "import iuvl_tpu_torch.data.tokenizer, iuvl_tpu_torch.data.class_names\n"
        "import iuvl_tpu_torch.data.prompts, iuvl_tpu_torch.inference.postprocess\n"
        "import iuvl_tpu_torch.evaluation.semseg, iuvl_tpu_torch.evaluation.panoptic\n"
        "import iuvl_tpu_torch.evaluation.instance\n"
        "import iuvl_tpu_torch.models.xdecoder.lang_encoder\n"
        "import iuvl_tpu_torch.ops.cuda.decode_chunk, iuvl_tpu_torch.inference.amg\n"
        "import iuvl_tpu_torch.data.transforms\n"
        "sam.build_sam('vit_b', embed_dim=32, depth=2, num_heads=2, "
        "global_attn_indexes=(1,), img_size=128, window_size=4, device='cpu')\n"
        "xd.build_syslearner(xd.SysLearnerConfig(img_size=64, syslearner_dim=32, "
        "mask_proposals=4, pixel_decoder_layers=1, nheads=4, dim_feedforward=32), "
        "device='cpu')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'iuvl_tpu', 'flax'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_import_no_jax():
    """Not one source file of the port, nor chip_smoke.py, names jax,
    flax or the JAX package in an import."""
    import ast
    import pathlib

    files = [*pathlib.Path(REPO, "iuvl_tpu_torch").rglob("*.py"),
             pathlib.Path(REPO, "chip_smoke.py")]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "flax", "optax", "iuvl_tpu")]
    assert len(files) > 20 and not bad, bad


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from iuvl_tpu_torch.ops.cuda import build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    build.library.cache_clear()
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.library()
    with pytest.raises(build.KernelBuildError):
        build.launch("iuvl_block_tail", None)


def test_cpu_wrappers_run_plain_and_count_nothing():
    from iuvl_tpu_torch.ops.cuda import deform_bwd_glue as dg
    from iuvl_tpu_torch.ops.cuda import flash_attention as fa
    from iuvl_tpu_torch.ops.cuda import mask_upscale as mu
    from iuvl_tpu_torch.ops.cuda import msdeform as md
    from iuvl_tpu_torch.ops.cuda import mlp_block as mb
    from iuvl_tpu_torch.ops.cuda import onehot_gather as og
    from iuvl_tpu_torch.ops.cuda import tap_scatter as ts
    from iuvl_tpu_torch.ops.cuda import twoway_attention as ta
    from iuvl_tpu_torch.ops.cuda import window_block as wb

    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    c, heads, win = 32, 2, 4
    wb.window_attention_block(r(4, win * win, c), r(3 * c, c), r(3 * c), r(c, c), r(c),
                              r(win, win, 16), r(win, win, 16), heads)
    fa.flash_attention_rowbias_proj(r(1, heads, 16, 16), r(1, heads, 16, 16),
                                    r(1, heads, 16, 16), r(1, heads, 16, 4),
                                    r(1, heads, 16, 4), r(c, c), r(c), 4)
    mb.block_tail(r(8, c), r(8, c), r(c), r(c), r(4 * c, c), r(4 * c), r(4 * c, c), r(c))
    mu.masks_upscale(r(2, 16, c), r(c, 32), r(8), r(8), r(8), r(8, 16), r(4), r(2, 4, 4))
    ta.t2i_stream(r(2, 3, 16), r(1, 16, c), r(16, 16), r(16, c), r(16), r(16, c), r(16),
                  heads)
    ta.i2t_block_step(r(2, 16, c), r(16, 16), r(2, 3, 16), r(2, 3, 16), r(16, c), r(16),
                      r(c, 16), r(c), r(c), r(c), heads)
    wb.window_block_backward(r(4, win * win, c), r(4, win * win, c), r(3 * c, c), r(3 * c),
                             r(c, c), r(win, win, 16), r(win, win, 16), heads)
    mb.block_tail_backward(r(8, c), r(8, c), r(8, c), r(c), r(c), r(4 * c, c), r(4 * c),
                           r(4 * c, c))
    o, lse = fa.flash_attention_fwd(r(1, heads, 16, 24), r(1, heads, 16, 24), r(1, heads, 16, 8))
    fa.flash_attention_bwd(r(1, heads, 16, 24), r(1, heads, 16, 24), r(1, heads, 16, 8), o, lse,
                           r(1, heads, 16, 8))
    ts.tap_scatter(torch.zeros(2, 5, dtype=torch.int32), r(2, 5, 4), 7)
    idx = torch.randint(0, 12, (heads, 6, 4), generator=g, dtype=torch.int32)
    md.ms_deform_level_fwd(r(2, heads, 12, 8), r(2, heads, 6, 4), r(2, heads, 6, 4),
                           r(2, heads, 6, 4), 3, 4)
    g4 = md.deform_gather_rows(r(heads, 12, 8), idx, 4)
    dg.deform_bwd_glue_q(g4, r(heads * 6, 8), r(heads * 24, 4), 4)
    contrib, _ = dg.deform_bwd_glue(g4, r(heads * 6, 8), r(heads * 24, 4), 4)
    md.deform_scatter_dv(contrib, idx, 12, 4)
    og.onehot_deform_level_forward(r(heads, 12, 4 * 8), idx, r(heads, 6, 4, 4), 4)
    for fn in (wb.window_attention_block, fa.flash_attention_rowbias_proj,
               mb.block_tail, mu.masks_upscale, ta.t2i_stream, ta.i2t_block_step,
               wb.window_block_backward, mb.block_tail_backward, fa.flash_attention_fwd,
               fa.flash_attention_bwd, ts.tap_scatter, md.ms_deform_level_fwd,
               md.deform_gather_rows, dg.deform_bwd_glue_q, dg.deform_bwd_glue,
               md.deform_scatter_dv, og.onehot_deform_level_forward):
        assert fn.launches == 0, fn.__name__


@pytest.mark.parametrize("builder", ["build_sam", "build_syslearner"])
def test_builders_default_to_the_card(builder, monkeypatch):
    """An entry point builds on the card unless asked for the CPU, and
    without a card it raises instead of quietly building on the CPU."""
    from iuvl_tpu_torch.models.sam import build_sam
    from iuvl_tpu_torch.models.xdecoder import SysLearnerConfig, build_syslearner

    small = dict(img_size=64, syslearner_dim=32, mask_proposals=4, pixel_decoder_layers=1,
                 nheads=4, dim_feedforward=32)
    build = {"build_sam": lambda **kw: build_sam(
                 "vit_b", embed_dim=32, depth=2, num_heads=2, global_attn_indexes=(1,),
                 img_size=64, **kw),
             "build_syslearner": lambda **kw: build_syslearner(
                 SysLearnerConfig(**small), **kw)}[builder]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        build()
    model = build(device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}


@pytest.mark.parametrize("field, value", [("attn_impl", "pallas"), ("attn_impl", "block"),
                                          ("twoway_impl", "pallas"),
                                          ("attn_impl", "window")])
def test_unported_impls_raise(field, value):
    from iuvl_tpu_torch.models.sam import SamConfig

    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue B"):
        SamConfig(**{field: value})


@pytest.mark.parametrize("twoway_impl", ["chunk", "chunk_plain"])
def test_chunk_decode_configs_are_accepted(twoway_impl):
    from iuvl_tpu_torch.models.sam import SamConfig, build_sam

    assert SamConfig(twoway_impl=twoway_impl).twoway_impl == twoway_impl
    sam = build_sam("vit_b", embed_dim=32, depth=2, num_heads=2, global_attn_indexes=(1,),
                    img_size=64, twoway_impl=twoway_impl, device="cpu")
    assert sam.mask_decoder.twoway_impl == twoway_impl


def test_prepared_layouts_follow_weight_changes():
    """The kernels' weight layouts are made once per weight state: reused
    while the weights stay, made anew after load_state_dict."""
    from iuvl_tpu_torch.models.sam.mask_decoder import MaskDecoder

    dec = MaskDecoder(transformer_dim=32, transformer_num_heads=2, transformer_mlp_dim=16)
    attn = dec.transformer.layers[0].cross_attn_image_to_token
    first = attn.weights()
    assert attn.weights() is first
    assert dec.upscale_weights() is dec.upscale_weights()
    state = {k: v + 1 for k, v in dec.state_dict().items()}
    with torch.no_grad():
        dec.load_state_dict(state)
    again = attn.weights()
    assert again is not first
    torch.testing.assert_close(again["qw"], attn.q_proj.weight)
    torch.testing.assert_close(dec.upscale_weights()[1], dec.output_upscaling[0].bias)
