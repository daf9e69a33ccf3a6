"""Where does B1 (``iuvl_window_block``) part from its plain version, stage
by stage, in this tree and in a parent's? At batch 2 (50 windows, ViT-B
widths; seeded inputs), this tree's C entry is called with its own scratch
and the parent's ``window_block.cu`` (built alone with ``nvcc``, PR 12's
entry: qkv and o scratch of 208 rows a window) with its own; then each
stage is held against the plain version's same stage on the kernel's own
input: qkv against ``x @ Wqkv^T + bqkv``, o against the plain attention of
the kernel's qkv, out against the plain projection of the kernel's o, and
out against the whole plain version; relative L2 and the share of bf16
elements that differ. The last line compares the two trees' stages.

    git archive <parent> iuvl_tpu_torch/csrc | tar -x -C _chip/parent
    python3 tools/window_block_stages.py

Needs one CUDA card.
"""

import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from iuvl_tpu_torch.ops.cuda import build  # noqa: E402
from iuvl_tpu_torch.ops.rel_pos_attention import (rel_pos_features, rel_pos_tables,  # noqa: E402
                                                  rowbias_attention)

NW, N, C, HEADS, WIN = 50, 196, 768, 12, 14
D = C // HEADS


def diff(a, b) -> str:
    a, b = a.float(), b.float()
    return (f"rel {float((a - b).norm() / b.norm()):.3e}, "
            f"differ {float((a != b).float().mean()):.3e}")


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    csrc = ROOT / "_chip/parent/iuvl_tpu_torch/csrc"  # the parent tree
    work = Path(tempfile.mkdtemp())
    proc = subprocess.run(
        [build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-shared", "-I", str(csrc), "-o", str(work / "p.so"),
         str(csrc / "window_block.cu")], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-2000:]
    p_, i_ = ctypes.c_void_p, ctypes.c_int
    par = ctypes.CDLL(str(work / "p.so"))
    par.iuvl_window_block.argtypes = [p_] * 10 + [i_] * 4 + [p_]
    build.library()
    g = torch.Generator(device="cuda").manual_seed(0)

    def t(*shape, std=1.0):
        return (torch.randn(*shape, device="cuda", generator=g) * std).bfloat16()

    rh, rw = rel_pos_tables(t(27, D, std=0.3), t(27, D, std=0.3), (WIN, WIN))
    xw, wqkv, bqkv = t(NW, N, C), t(3 * C, C, std=C ** -0.5), t(3 * C, std=0.3).float()
    wo, bo = t(C, C, std=C ** -0.5), t(C, std=0.3).float()

    def attn(qkv):
        q, k, v = qkv.reshape(NW, N, 3, HEADS, D).permute(2, 0, 3, 1, 4)
        relh, relw = rel_pos_features(q, rh, rw)
        o = rowbias_attention(q * (D ** -0.5), k, v, relh, relw, WIN)
        return o.transpose(1, 2).reshape(NW, N, C)

    def proj(o):
        return o @ wo.t() + bo.bfloat16()

    qkv_p = xw @ wqkv.t() + bqkv.bfloat16()
    out_p = proj(attn(qkv_p))
    args = (xw, wqkv, bqkv, wo, bo, rh, rw)

    # this tree
    qkv_s = torch.empty((NW, 3, HEADS, N, D), dtype=torch.bfloat16, device="cuda")
    o_s = torch.empty((NW, N, C), dtype=torch.bfloat16, device="cuda")
    out_s = torch.empty_like(xw)
    build.launch("iuvl_window_block", xw.device, *(x.data_ptr() for x in (*args, qkv_s, o_s,
                                                                         out_s)), NW, C, WIN, D)
    torch.cuda.synchronize()
    qkv_k = qkv_s.permute(0, 3, 1, 2, 4).reshape(NW, N, 3 * C)
    print("this qkv vs plain:", diff(qkv_k, qkv_p))
    print("this o vs plain attention of this qkv:", diff(o_s, attn(qkv_k)))
    print("this out vs plain projection of this o:", diff(out_s, proj(o_s)))
    print("this out vs plain:", diff(out_s, out_p))

    # the parent
    qkv_q = torch.empty((NW, 208, 3 * C), dtype=torch.bfloat16, device="cuda")
    o_q = torch.empty((NW, 208, C), dtype=torch.bfloat16, device="cuda")
    out_q = torch.empty_like(xw)
    assert par.iuvl_window_block(*(x.data_ptr() for x in (*args, qkv_q, o_q, out_q)), NW, C,
                                 WIN, D, torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    qkv_q, o_q = qkv_q[:, :N].contiguous(), o_q[:, :N].contiguous()
    print("parent qkv vs plain:", diff(qkv_q, qkv_p))
    print("parent o vs plain attention of its qkv:", diff(o_q, attn(qkv_q)))
    print("parent out vs plain projection of its o:", diff(out_q, proj(o_q)))
    print("parent out vs plain:", diff(out_q, out_p))
    print("this vs parent: qkv", diff(qkv_k, qkv_q), "; o", diff(o_s, o_q), "; out",
          diff(out_s, out_q))
    shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
