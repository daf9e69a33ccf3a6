"""Build and load the port's CUDA kernels (counterpart of
``iuvl_tpu/native/build.py``).

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``,
all at once in parallel, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs
at first use, lands in ``iuvl_tpu_torch/_build/`` and is redone when a
hash of the sources and flags changes. Each C entry point launches on the
stream it is given and returns ``cudaGetLastError()``; :func:`launch`
raises when that is not 0. There is no fallback: without ``nvcc`` or with
a failed build the call raises, with the compiler's output.

Run ``python -m iuvl_tpu_torch.ops.cuda.build`` to build and print the
register and shared-memory use of every kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: name -> argument types (pointers, ints, floats; the
# stream last). Keep in step with the ``extern "C"`` functions in csrc/.
SIGNATURES = {
    "iuvl_block_tail": (P,) * 9 + (I, I, I, F, P),
    "iuvl_window_block": (P,) * 10 + (I, I, I, I, P),
    "iuvl_rowbias_proj": (P,) * 9 + (I,) * 6 + (P,),
    "iuvl_masks_upscale": (P,) * 9 + (I, I, P),
    "iuvl_t2i_stream": (P,) * 8 + (I, I, I, I, P),
    "iuvl_i2t_block_step": (P,) * 11 + (I, I, I, I, F, F, P),
    "iuvl_window_block_bwd": (P,) * 21 + (I, I, I, I, P),
    "iuvl_block_tail_bwd": (P,) * 21 + (I, I, I, F, P),
    "iuvl_flash_fwd": (P,) * 5 + (I, I, I, I, P),
    "iuvl_flash_bwd": (P,) * 10 + (I, I, I, I, P),
    "iuvl_tap_scatter": (P, P, P, I, I, I, P),
    "iuvl_msdeform_fwd": (P,) * 5 + (I,) * 7 + (P,),
    "iuvl_deform_gather": (P,) * 3 + (I,) * 5 + (P,),
    "iuvl_deform_scatter": (P,) * 3 + (I,) * 5 + (P,),
    "iuvl_deform_bwd_glue_q": (P,) * 5 + (I,) * 3 + (P,),
    "iuvl_deform_bwd_glue": (P,) * 5 + (I,) * 3 + (P,),
    "iuvl_onehot_level_fwd": (P,) * 4 + (I,) * 5 + (P,),
    "iuvl_decode_tail": (P,) + (I,) * 5 + (P,),
    "iuvl_rowbias_fwd": (P,) * 7 + (I,) * 5 + (P,),
    "iuvl_relpos_fwd": (P,) * 9 + (I,) * 5 + (P,),
    "iuvl_rowbias_bwd": (P,) * 13 + (I,) * 5 + (P,),
    "iuvl_relpos_bwd": (P,) * 15 + (I,) * 5 + (P,),
}


class KernelBuildError(RuntimeError):
    """nvcc is missing or failed; the message holds its output."""


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(home) / "bin" / "nvcc"
        nvcc = str(cand) if cand.is_file() else None
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (neither on PATH nor under $CUDA_HOME/bin or "
            "/usr/local/cuda/bin): the iuvl_tpu_torch CUDA kernels cannot be "
            "built, and CUDA tensors have no other path")
    return nvcc


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into ``_build/libiuvl_kernels_<hash>.so`` unless
    that file exists: one ``nvcc -c`` per source, all started together,
    then one link. Returns the library's path; raises KernelBuildError."""
    nvcc = find_nvcc()
    out = BUILD_DIR / f"libiuvl_kernels_{source_hash()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        procs = []
        for cu in sorted(SRC_DIR.glob("*.cu")):
            obj = work / (cu.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(cu)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        logs, failed = [], []
        for cmd, _, proc in procs:
            _, err = proc.communicate()
            logs.append(err)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
        if failed:
            raise KernelBuildError("\n".join(failed))
        tmp = work / "lib.so"
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
               *(str(obj) for _, obj, _ in procs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelBuildError(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
                                   f"{proc.stderr}")
        (BUILD_DIR / "ptxas.log").write_text("".join(logs))
        if verbose:
            print("".join(logs), file=sys.stderr)
        os.replace(tmp, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call; a failure is not
    cached, so the next call tries again)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.iuvl_error_string.argtypes = [ctypes.c_int]
    lib.iuvl_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, device, *args) -> None:
    """Call C entry ``name`` with ``args`` and ``device``'s current stream;
    raise if it reports a CUDA error."""
    lib = library()
    err = getattr(lib, name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        msg = lib.iuvl_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg}) at launch")


def require(kernel: str, name: str, t, dtype, shape, device) -> None:
    """Raise ValueError unless ``t`` is a contiguous, 16-byte aligned
    ``dtype`` tensor of ``shape`` on ``device`` — what the kernel
    ``kernel`` takes (the kernels read in 16-byte pieces)."""
    problems = []
    if t.device != device:
        problems.append(f"device {t.device}, expected {device}")
    if t.dtype != dtype:
        problems.append(f"dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        problems.append(f"shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        problems.append("not contiguous")
    if t.data_ptr() % 16:
        problems.append("not 16-byte aligned")
    if problems:
        raise ValueError(f"{kernel}: {name} has " + "; ".join(problems))


if __name__ == "__main__":
    print(build(verbose=True))
