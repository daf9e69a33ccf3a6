"""A short first check of B13, B17 and B16 past 32 slots on the card: build
the kernels (printing ptxas's registers and spills for them), one call each
at its path's shapes (B13 at the windowed and global grids and at head dim
80; B17 at the d_value shape, skewed and small; B16 at 16-64 slots), its
relative L2 to the plain version (B13 also to the plain version in fp32),
and its time against the plain version's (and ``index_add_``'s for B17),
CUDA events.

    python3 tools/first_kernel_check.py

Needs one CUDA card.
"""

import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from iuvl_tpu_torch.ops.cuda import build  # noqa: E402
from iuvl_tpu_torch.ops.cuda import decode_chunk as dc  # noqa: E402
from iuvl_tpu_torch.ops.cuda import seg_scatter as ss  # noqa: E402
from iuvl_tpu_torch.ops.cuda import window_attention as wa  # noqa: E402
from iuvl_tpu_torch.ops.rel_pos_attention import rel_pos_tables  # noqa: E402


def main() -> None:
    smi = cs.device_phase()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    build.library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    print(subprocess.run(
        ["bash", "-c", f"grep -A3 -i 'window_attn\\|seg_scatter\\|tok_front\\|tok_mid\\|row_pass' "
         f"{build.BUILD_DIR}/ptxas.log | grep -i 'registers\\|spill\\|Compiling' | head -80"],
        capture_output=True, text=True).stdout)
    rs = np.random.RandomState(0)
    bf = torch.bfloat16

    def t(*s, std=1.0, dtype=bf):
        return torch.from_numpy(rs.randn(*s).astype(np.float32) * std).to(dev, dtype)

    for bh, side, d in ((300, 14, 64), (12, 64, 64), (24, 14, 80), (2, 8, 64)):
        n = side * side
        q, k, v = (t(1, bh, n, d) for _ in range(3))
        rh, rw = (x.to(bf) for x in rel_pos_tables(t(2 * side - 1, d, std=0.3),
                                                   t(2 * side - 1, d, std=0.3), (side, side)))
        o = wa.window_rel_attention_fwd(q, k, v, rh, rw)
        torch.cuda.synchronize()
        p = wa.window_rel_attention_fwd_plain(q, k, v, rh, rw)
        p32 = wa.window_rel_attention_fwd_plain(*(x.float() for x in (q, k, v, rh, rw)))
        ms = cs.cuda_ms(lambda: wa.window_rel_attention_fwd(q, k, v, rh, rw), 5)
        pms = cs.cuda_ms(lambda: wa.window_rel_attention_fwd_plain(q, k, v, rh, rw), 3)
        print(f"B13 bh {bh} side {side} d {d}: rel_l2 {cs.rel_l2(o, p):.3e} (bf16 plain vs fp32 "
              f"{cs.rel_l2(p, p32):.3e}, kernel vs fp32 {cs.rel_l2(o, p32):.3e}) max_abs "
              f"{float((o.float() - p.float()).abs().max()):.3e} ms {ms:.4f} plain {pms:.4f}",
              flush=True)
    for r, w, n_out, skew in ((688128, 256, 131072, False), (3000, 64, 512, True),
                              (4096, 256, 1024, False)):
        contrib = t(r, w)
        idx = (torch.zeros(r, dtype=torch.int32, device=dev) if skew else
               torch.from_numpy(rs.randint(0, n_out, r).astype(np.int32)).to(dev))
        o = ss.segmented_scatter_add(contrib, idx, n_out)
        torch.cuda.synchronize()
        p = ss.segmented_scatter_add_plain(contrib, idx, n_out)
        ms = cs.cuda_ms(lambda: ss.segmented_scatter_add(contrib, idx, n_out), 5)
        pms = cs.cuda_ms(lambda: ss.segmented_scatter_add_plain(contrib, idx, n_out), 5)
        lib = cs.cuda_ms(lambda: torch.zeros((n_out, w), device=dev).index_add_(
            0, idx, contrib.float()), 5)
        print(f"B17 R {r} W {w} n_out {n_out} skew {skew}: rel_l2 {cs.rel_l2(o, p):.3e} max_abs "
              f"{float((o - p).abs().max()):.3e} ms {ms:.4f} plain {pms:.4f} index_add {lib:.4f}",
              flush=True)
    args = cs.decode_tail_case(rs, dev)
    for tp, tv in ((16, 7), (32, 26), (48, 46), (64, 63)):
        tok = torch.from_numpy(rs.randn(cs.CHUNK, tp, 256).astype(np.float32))
        tok[:, tv:] = 0
        tpe = torch.from_numpy(rs.randn(cs.CHUNK, tp, 256).astype(np.float32) * 0.5)
        tpe[:, tv:] = 0
        a = (tok.to(dev, bf), tpe.to(dev, bf)) + args[2:6] + (tv,)
        out = cs.decode_tail_valid(*a)
        torch.cuda.synchronize()
        ref = cs._tail_plain(a)
        ms = cs.cuda_ms(lambda: dc.decode_tail(*a), 3)
        print(f"B16 Tp {tp} t_valid {tv}: tokens {cs.rel_l2(out[0], ref[0]):.3e} masks "
              f"{cs.rel_l2(out[1], ref[1]):.3e} ms {ms:.3f}", flush=True)
    print(smi)


if __name__ == "__main__":
    main()
