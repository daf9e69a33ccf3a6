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
        "sam.build_sam('vit_b', embed_dim=32, depth=2, num_heads=2, "
        "global_attn_indexes=(1,), img_size=128, window_size=4)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'iuvl_tpu', 'flax'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


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
    from iuvl_tpu_torch.ops.cuda import flash_attention as fa
    from iuvl_tpu_torch.ops.cuda import mask_upscale as mu
    from iuvl_tpu_torch.ops.cuda import mlp_block as mb
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
    for fn in (wb.window_attention_block, fa.flash_attention_rowbias_proj,
               mb.block_tail, mu.masks_upscale, ta.t2i_stream, ta.i2t_block_step):
        assert fn.launches == 0, fn.__name__


@pytest.mark.parametrize("field, value", [("attn_impl", "pallas"), ("attn_impl", "block"),
                                          ("twoway_impl", "pallas"),
                                          ("twoway_impl", "chunk")])
def test_unported_impls_raise(field, value):
    from iuvl_tpu_torch.models.sam import SamConfig

    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue B"):
        SamConfig(**{field: value})


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
