"""The GEMM of ``csrc/linear_wgmma.cuh`` against a text-edited variant of
it, on one card, in one process: the variant keeps one wgmma group in
flight across the k-step's barrier (``wgmma.wait_group 1``, the next
step's copies issued behind a second barrier) where the header waits for
each step's products. Each is built alone with ``nvcc`` (its ptxas
registers and spills printed) behind a plain C entry with the B1
projection's epilogue, then at B1's qkv and projection shapes at ViT-B
1024^2, B2's projection, B1's qkv at ViT-H and at 512^2: relative L2 to
``torch.matmul`` (+ bias, rounded as the epilogue rounds), and ms a call
(CUDA events, 30 calls) of ``F.linear``, then the header and the variant,
twice in turns.

    python3 tools/gemm_variants.py

Needs one CUDA card.
"""

import ctypes
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "iuvl_tpu_torch/csrc"
OLD = """  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait<kLinStages - 2>();
    fence_async_smem();
    __syncthreads();  // step kt landed; every warpgroup's products of step kt - 1 are done
    if (kt + kLinStages - 1 < steps) issue(kt + kLinStages - 1);  // into step kt - 1's slot
    cp_async_commit();
    const int st = kt % kLinStages;
    const uint64_t da = sw128_desc(sA + st * kLinTile + 64 * kLinBK * wg);
    const uint64_t db = sw128_desc(sB + st * kLinTile);
    wg_fence_acc(acc);
    wg_fence();
#pragma unroll
    for (int s = 0; s < kLinBK / 16; ++s) wgmma_ss_n128(acc, da + 2 * s, db + 2 * s, 1);
    wg_commit();
    wg_wait<0>();
    wg_fence_acc(acc);
  }
"""
NEW = """  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait<kLinStages - 2>();
    fence_async_smem();
    __syncthreads();
    const int st = kt % kLinStages;
    const uint64_t da = sw128_desc(sA + st * kLinTile + 64 * kLinBK * wg);
    const uint64_t db = sw128_desc(sB + st * kLinTile);
    wg_fence_acc(acc);
    wg_fence();
#pragma unroll
    for (int s = 0; s < kLinBK / 16; ++s) wgmma_ss_n128(acc, da + 2 * s, db + 2 * s, 1);
    wg_commit();
    wg_wait<1>();
    wg_fence_acc(acc);
    __syncthreads();
    if (kt + kLinStages - 1 < steps) issue(kt + kLinStages - 1);
    cp_async_commit();
  }
  wg_wait<0>();
  wg_fence_acc(acc);
"""
DRIVER = r'''
#include "VARIANT.cuh"
using namespace iuvl;
extern "C" int run(const void* a, const void* b, const void* bias, void* out, int M, int N,
                   int K, void* s) {
  return linear_wgmma<kEpiRound2>((const bf16*)a, (const bf16*)b, (const float*)bias,
                                  (bf16*)out, M, N, K, 0, 0, (cudaStream_t)s);
}
'''
SHAPES = ((4900, 2304, 768), (4900, 768, 768), (4096, 768, 768), (4900, 3840, 1280),
          (1764, 2304, 768))


def ms(fn, iters=30):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def build(work: Path) -> dict:
    src = (CSRC / "linear_wgmma.cuh").read_text()
    assert OLD in src, "linear_wgmma.cuh's k loop changed: update OLD"
    variants = {"header": src, "overlap": src.replace(OLD, NEW)}
    procs, libs = {}, {}
    for name, text in variants.items():
        (work / f"{name}.cuh").write_text(text)
        (work / f"{name}.cu").write_text(DRIVER.replace("VARIANT", name))
        cmd = ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v",
               "-I", str(CSRC), "-I", str(work), "-o", str(work / f"{name}.so"),
               str(work / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True)
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name} build failed: {err[-3000:]}")
        for line in err.splitlines():
            if "registers" in line or "spill" in line:
                print(name, line.strip())
        lib = ctypes.CDLL(str(work / f"{name}.so"))
        lib.run.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        libs[name] = lib
    return libs


def main() -> None:
    work = Path(tempfile.mkdtemp())
    libs = build(work)
    g = torch.Generator(device="cuda").manual_seed(0)
    for m, n, k in SHAPES:
        a = torch.randn(m, k, device="cuda", generator=g).bfloat16()
        b = (torch.randn(n, k, device="cuda", generator=g) * k ** -0.5).bfloat16()
        bias = torch.randn(n, device="cuda", generator=g) * 0.3
        want = ((a @ b.t()).float().bfloat16().float() + bias.bfloat16().float()).bfloat16()
        lin = lambda: torch.nn.functional.linear(a, b, bias.bfloat16())  # noqa: E731
        line = f"M {m} N {n} K {k}: F.linear {ms(lin):.4f}"
        for _ in range(2):
            for name, lib in libs.items():
                out = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
                st = torch.cuda.current_stream().cuda_stream
                call = lambda: lib.run(a.data_ptr(), b.data_ptr(), bias.data_ptr(),  # noqa: E731
                                       out.data_ptr(), m, n, k, st)
                assert call() == 0
                torch.cuda.synchronize()
                err = float((out.float() - want.float()).norm() / want.float().norm())
                t = ms(call)
                line += f"; {name} {t:.4f} ({2 * m * n * k / t / 1e9:.0f} TF/s, rel {err:.1e})"
        print(line, flush=True)
    shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
