"""Do the train gates read B3's arithmetic or its rounding draws? Builds
text-edited variants of B3 (``csrc/mlp_block.cu`` with
``csrc/linear_wgmma.cuh``), each faithful to ``block_tail_plain``'s
rounding points and differing only in the order of fp32 operations, and
runs chip_smoke.py's ``auto`` train phases at batch 1 (one step, with the
control pair) and batch 2 (one step) with each variant's
``iuvl_block_tail`` in place of this tree's; prints each phase's gate
readings and whether its gates held (a failed gate is reported, not
raised). Variants:

- ``this``: the tree as it is (the LayerNorm's sums over each lane's
  columns c = lane + 32 i in order, as B3's first kernel took them);
- ``ln_pieces``: the LayerNorm's sums over each lane's 16-byte pieces of 8
  columns, a pair at a time (the first build of the GEMM design);
- ``gelu_fast``: the GELU as x / (1 + 2^(-2 u log2 e)) with ex2.approx and
  rcp.approx (B6's form) in place of ``gelu_tanh``.

    python3 tools/tail_variants.py [variant ...]

Needs one CUDA card.
"""

import ctypes
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from iuvl_tpu_torch.ops.cuda import build  # noqa: E402

GELU_FAST = ('''enum LinearEpi {''', '''__device__ __forceinline__ float gelu_v(float x) {
  constexpr float k0 = -2.f * 0.7978845608028654f * kLog2e;
  constexpr float k1 = k0 * 0.044715f;
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\\n" : "=f"(r) : "f"(1.f + ex2(x * fmaf(k1, x * x, k0))));
  return x * r;
}

enum LinearEpi {''')
GELU_CALL = ('''        v = pack_bf16(gelu_tanh(round_bf(round_bf(x0) + b0)),
                      gelu_tanh(round_bf(round_bf(x1) + b1)));''',
             '''        v = pack_bf16(gelu_v(round_bf(round_bf(x0) + b0)),
                      gelu_v(round_bf(round_bf(x1) + b1)));''')
LN_PIECES = ('''#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    v[i] = to_f(__hadd(x[base + 32 * i], a[base + 32 * i]));
    s += v[i];
    s2 += v[i] * v[i];
  }''', '''#pragma unroll
  for (int i = 0; i < kPer; ++i) v[i] = to_f(__hadd(x[base + 32 * i], a[base + 32 * i]));
#pragma unroll
  for (int u = 0; u < NV; ++u)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const size_t c = base - lane + 8 * (lane + 32 * u) + 2 * j;
      const float2 f = __bfloat1622float2(__hadd2(*reinterpret_cast<const __nv_bfloat162*>(x + c),
                                                  *reinterpret_cast<const __nv_bfloat162*>(a + c)));
      s += f.x + f.y;
      s2 += f.x * f.x + f.y * f.y;
    }''')
# variant -> {file: [(old, new), ...]}
VARIANTS = {
    "this": {},
    "ln_pieces": {"mlp_block.cu": [LN_PIECES]},
    "gelu_fast": {"linear_wgmma.cuh": [GELU_FAST, GELU_CALL]},
}


def start_build(name: str, edits: dict, work: Path):
    """A copy of csrc with the variant's edits, mlp_block.cu compiled alone
    into a shared library (nvcc started, not waited for)."""
    src = work / name
    shutil.copytree(build.SRC_DIR, src)
    for fname, pairs in edits.items():
        text = (src / fname).read_text()
        for old, new in pairs:
            if old not in text:
                raise RuntimeError(f"{name}: {fname} lacks {old[:60]!r}")
            text = text.replace(old, new, 1)
        (src / fname).write_text(text)
    out = work / f"{name}.so"
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out),
           str(src / "mlp_block.cu")]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


class Library:
    """The kernel library with ``iuvl_block_tail`` taken from a variant."""

    def __init__(self, main, variant):
        self.main, self.variant = main, variant
        fn = variant.iuvl_block_tail
        fn.argtypes = list(build.SIGNATURES["iuvl_block_tail"])
        fn.restype = ctypes.c_int

    def __getattr__(self, name):
        return getattr(self.variant if name == "iuvl_block_tail" else self.main, name)


def main() -> int:
    cs.device_phase()
    names = sys.argv[1:] or list(VARIANTS)
    main_lib = build.library()
    work = Path(tempfile.mkdtemp())
    jobs = {name: start_build(name, VARIANTS[name], work) for name in names}
    libs = {}
    for name, (out, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name} build failed:\n{err[-3000:]}")
        regs = [line.split(":", 1)[-1].strip() for line in err.splitlines()
                if "registers" in line]
        print(f"{name}: built; ptxas {regs}", flush=True)
        libs[name] = Library(main_lib, ctypes.CDLL(str(out)))
    dev = torch.device("cuda", 0)
    library = build.library
    try:
        for name, lib in libs.items():
            build.library = lambda lib=lib: lib
            for batch, control in ((1, True), (2, False)):
                t0 = time.perf_counter()
                try:
                    cs.train_phase(dev, batch, 1, control)
                    verdict = "the gates held"
                except RuntimeError as e:
                    verdict = str(e)
                print(f"variant {name}, batch {batch}: {verdict} "
                      f"({time.perf_counter() - t0:.1f} s)", flush=True)
    finally:
        build.library = library
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
