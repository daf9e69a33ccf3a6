"""B15's shared-memory instance split by part: text-edited copies of
``iuvl_tpu_torch/csrc/onehot_gather.cu``, each built alone with ``nvcc`` and
called through ``ctypes`` at the ``hybrid`` eval's res5 shape (8 heads,
1024 cells, 21,504 queries x 4 points near their reference points, bf16;
head width 64 and 32) and on a 16^2 table:

- ``base``: the source as it is;
- ``prologue``: the row loop removed (the table staged, the first rows'
  copies waited for): what the block pays before its first row;
- ``launch``: the table and the rows removed: launch, the table's barrier
  and the first rows' copies.

For each: the time a call between CUDA events over 20 calls made as the
wrapper makes them (its checks, ``torch.empty`` and the launch), the device
time a call from torch.profiler, and the host time to issue a call. The
outputs are not checked (``tools/kernel_ab.py --kernels onehot`` does that).

    python3 tools/onehot_variants.py

Needs one CUDA card.
"""

import ctypes
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from iuvl_tpu_torch.models.xdecoder.pixel_decoder import encoder_reference_points  # noqa: E402
from iuvl_tpu_torch.ops.cuda import build  # noqa: E402
from iuvl_tpu_torch.ops.cuda.build import require  # noqa: E402
from iuvl_tpu_torch.ops.msdeform import wide_idx_wslot, wide_map  # noqa: E402

SOURCE = ROOT / "iuvl_tpu_torch/csrc/onehot_gather.cu"
NO_ROWS = ("  for (int r0 = r_begin + warp * kWarpRows, slot = 0; r0 < r_end;",
           "  for (int r0 = r_end, slot = 0; r0 < r_end;")
NO_TABLE = ("  for (int i0 = threadIdx.x; i0 < end; i0 += kBatch * kThreads) {",
            "  for (int i0 = end; i0 < end; i0 += kBatch * kThreads) {")
VARIANTS = {"base": [], "prologue": [NO_ROWS], "launch": [NO_ROWS, NO_TABLE]}
# (side, head width): the res5 level at d 64 and 32, a 16^2 table.
SHAPES = ((32, 64), (32, 32), (16, 64))


def build_variants(work: Path) -> dict:
    """Each variant's library, all nvcc runs started together."""
    src, procs = SOURCE.read_text(), {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        cu = work / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-shared", "-I", str(SOURCE.parent), "-o",
             str(work / f"{name}.so"), str(cu)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name} build: {err[-4000:]}")
        lib = ctypes.CDLL(str(work / f"{name}.so"))
        lib.iuvl_onehot_level_fwd.argtypes = list(build.SIGNATURES["iuvl_onehot_level_fwd"])
        lib.iuvl_onehot_level_fwd.restype = ctypes.c_int
        libs[name] = lib
    return libs


def inputs(side: int, d: int, gen):
    """The wide map, indices and slot weights as the hybrid level makes them."""
    nh, p = 8, 4
    ref = encoder_reference_points([(32, 32), (64, 64), (128, 128)], "cuda")[:, 0]
    lq = ref.shape[0]
    xy = ref[None, :, None, :] * side - 0.5 + 2.5 * torch.randn(nh, lq, p, 2, device="cuda",
                                                                 generator=gen)
    idx, ws = wide_idx_wslot(side, side, xy[..., 0], xy[..., 1])
    aw = torch.rand(nh, lq, p, device="cuda", generator=gen) / 12
    v = torch.randn(1, nh, side * side, d, device="cuda", generator=gen).bfloat16()
    return (wide_map(v, side).reshape(nh, side * side, 4 * d).contiguous(), idx.contiguous(),
            (ws * aw[..., None]).transpose(-1, -2).contiguous())


def timings(lib, v4, idx, ws) -> tuple[float, float, float]:
    """(ms a call between events, device ms a call, host ms to issue a call)."""
    bh, cells, d4 = v4.shape
    lq, p, dev = idx.shape[1], idx.shape[2], v4.device

    def call():
        require("onehot", "v4", v4, v4.dtype, tuple(v4.shape), dev)
        require("onehot", "idx", idx, torch.int32, tuple(idx.shape), dev)
        require("onehot", "wslot", ws, torch.float32, tuple(ws.shape), dev)
        out = torch.empty((bh, lq, d4 // 4), dtype=v4.dtype, device=dev)
        err = lib.iuvl_onehot_level_fwd(v4.data_ptr(), idx.data_ptr(), ws.data_ptr(),
                                        out.data_ptr(), bh, cells, lq, p, d4 // 4, 1,
                                        torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"launch: CUDA error {err}")
        return out

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    walls = []
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        a.record()
        for _ in range(20):
            call()
        b.record()
        torch.cuda.synchronize()
        walls.append(a.elapsed_time(b) / 20)
    t0 = time.perf_counter()
    for _ in range(50):
        call()
    host = (time.perf_counter() - t0) / 50 * 1e3
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            call()
        torch.cuda.synchronize()
    device = sum(e.device_time_total for e in prof.key_averages() if "onehot" in e.key) / 20
    return min(walls), device / 1e3, host


def main() -> int:
    if not torch.cuda.is_available():
        print("onehot_variants: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    libs = build_variants(Path(tempfile.mkdtemp()))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for side, d in SHAPES:
        args = inputs(side, d, gen)
        row = ", ".join(f"{name} {' / '.join(f'{t:.4f}' for t in timings(lib, *args))}"
                        for name, lib in libs.items())
        print(f"onehot_variants@{side}x{side} d {d} (ms: events / device / host): {row}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
