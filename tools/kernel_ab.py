"""This tree's B2b / B14 forward against a parent tree's, on one card, in
one process: build this tree's kernels (printing ptxas's registers and
spills of the B2b / B14 and B13 kernels), compile the parent's
``flash_attention_rowbias.cu`` alone with ``nvcc`` (its ptxas summary too),
then at ViT-B's windowed and global shapes, ViT-H's global shape (d 80) and
grids that reach the other code paths (a 32 x 32 grid; N 200 and 300 with
dense random expanders, one of them with h + w = 496) hold each forward
against the plain version (relative L2 of o and lse), check that two
launches of this tree's forward give the same bits, time the parent, this
tree, this tree and the parent in turn (CUDA events, 20 calls after a
warm-up), the plain version and SDPA on the materialised bias, and split
one call's device time by kernel with each launch's registers and shared
memory as the profiler's trace records them. Where this tree runs its
resident forward (N <= 256, a block an SM or more), a copy of its source
built with the resident kernel compiled out (IUVL_RB_FWD_NO_RESIDENT) is
held and timed beside it: the streaming kernel on the same windows.

    git archive <parent> iuvl_tpu_torch/csrc | tar -x -C _chip/parent
    set -o pipefail; python3 tools/kernel_ab.py --parent _chip/parent 2>&1 \
        | tee chiprun_out/kernel_ab.log

The parent's forward entry points must have the signatures PARENT_SIGS
gives them (``iuvl_relpos_fwd`` without the group-word scratch). Needs one
CUDA card.
"""

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from iuvl_tpu_torch.ops.cuda import build  # noqa: E402
from iuvl_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402
from iuvl_tpu_torch.ops.rel_pos_attention import onehot_expanders  # noqa: E402

P, I = ctypes.c_void_p, ctypes.c_int
PARENT_SIGS = {"iuvl_rowbias_fwd": [P] * 7 + [I] * 5 + [P],
               "iuvl_relpos_fwd": [P] * 9 + [I] * 5 + [P]}
KERNELS = ("rb_fwd", "rb_bwd", "rb_nz", "window_stream", "window_resident")
# (tag, heads, N, h, w, d, dense expanders): ViT-B's windows and global
# grid, ViT-H's global grid, a 32 x 32 grid (B2b's looked-up bias while
# streaming), N 200 and 300 with dense expanders (h + w 33 and 496; 12 and
# 2 heads, fewer than the SMs: the streaming kernels; B2b only where N = h
# w).
SHAPES = (("window", 300, 196, 14, 14, 64, False), ("global", 12, 4096, 64, 64, 64, False),
          ("global_d80", 16, 4096, 64, 64, 80, False), ("side32", 12, 1024, 32, 32, 64, False),
          ("dense200", 12, 200, 8, 25, 64, True), ("dense300", 2, 300, 200, 296, 64, True))


def ms(fn, iters=20):
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


def rel(a, b):
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def ptxas_summary(log: str, label: str) -> None:
    """Registers, shared memory and spills of the kernels named in KERNELS."""
    name = None
    demangle = shutil.which("c++filt")
    for line in log.splitlines():
        if "Compiling entry" in line:
            name = line.split("'")[1]
            if demangle:
                name = subprocess.run([demangle, name], capture_output=True,
                                      text=True).stdout.strip()
                name = re.sub(r"iuvl::\(anonymous namespace\)::", "", name).split("(")[0]
        elif name and any(k in name for k in KERNELS) and ("registers" in line or "spill" in line):
            print(f"ptxas {label} {name}: {line.split(':', 1)[-1].strip()}")


def compile_rowbias(tree: Path, work: Path, label: str = "parent", sigs=None, defines=()):
    """A tree's flash_attention_rowbias.cu alone as a shared library (the
    parent's by default; ``defines``: -D macros), its forward entries typed
    by ``sigs`` (PARENT_SIGS by default)."""
    csrc = tree / "iuvl_tpu_torch/csrc"
    out = work / f"{label}_rowbias.so"
    proc = subprocess.run(
        [build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v", *(f"-D{m}" for m in defines),
         "-I", str(csrc), "-o", str(out), str(csrc / "flash_attention_rowbias.cu")],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{label} build: {proc.stderr[-4000:]}")
    if label == "parent":
        ptxas_summary(proc.stderr, label)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in (sigs or PARENT_SIGS).items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    return lib



def kernel_split(fn, work: Path, calls=5) -> str:
    """Device ms a call of each kernel ``fn`` launches, with the launch's
    registers a thread, shared memory a block and grid (torch.profiler's
    chrome trace)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    path = work / "trace.json"
    prof.export_chrome_trace(str(path))
    rows = {}
    for ev in json.loads(path.read_text()).get("traceEvents", []):
        if ev.get("cat") != "kernel":
            continue
        name = re.sub(r"\(.*", "", ev["name"].replace("iuvl::(anonymous namespace)::", ""))
        a = ev.get("args", {})
        r = rows.setdefault(name[:70], dict(
            us=0.0, info=f"{a.get('registers per thread')} regs, "
                         f"{a.get('shared memory')} B smem, grid {a.get('grid')}"))
        r["us"] += float(ev.get("dur", 0))
    return "; ".join(f"{name} {r['us'] / 1e3 / calls:.4f} ms ({r['info']})"
                     for name, r in rows.items())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, required=True,
                    help="a tree holding the parent's iuvl_tpu_torch/csrc")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp())
    build.library()
    lib = compile_rowbias(args.parent.resolve(), work)
    # This tree with the resident forward compiled out: the streaming kernel
    # on the windows, to time against the resident one.
    stream_lib = compile_rowbias(ROOT, work, "stream", {
        fn: build.SIGNATURES[fn] for fn in PARENT_SIGS}, ("IUVL_RB_FWD_NO_RESIDENT",))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"build {time.perf_counter() - t0:.1f} s")
    ptxas_summary((build.BUILD_DIR / "ptxas.log").read_text(), "this tree")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    ptr = lambda *ts: [x.data_ptr() for x in ts]  # noqa: E731

    def t(*shape, std=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * std).to(torch.bfloat16)

    bad = []
    for tag, bh, n, h, w, d, dense in SHAPES:
        q, k, v = (t(1, bh, n, d) for _ in range(3))
        q = q * d ** -0.5
        relh, relw = t(1, bh, n, h, std=2.4), t(1, bh, n, w, std=2.4)
        if dense:
            eh, ew = t(h, n, std=(h + w) ** -0.5), t(w, n, std=(h + w) ** -0.5)
        else:
            eh, ew = onehot_expanders((h, w), torch.bfloat16, dev)
        kinds = ("rowbias", "relpos") if h * w == n else ("relpos",)
        for kind in kinds:
            if kind == "rowbias":
                new = lambda: fa.flash_rowbias_fwd(q, k, v, relh, relw, w)  # noqa: E731
                ins = (q, k, v, relh, relw)
                bias = (relh.float().repeat_interleave(w, -1)
                        + relw.float().repeat(1, 1, 1, h)).to(q.dtype)
            else:
                new = lambda: fa.flash_relpos_fwd(q, k, v, relh, relw, eh, ew)  # noqa: E731
                ins = (q, k, v, relh, relw, eh, ew)
                bias = (relh.float() @ eh.float() + relw.float() @ ew.float()).to(q.dtype)
            want = fa.flash_rowbias_fwd_plain(q, k, v, relh, relw, w,
                                              *((eh, ew) if kind == "relpos" else ()))

            nz = (fa.expander_groups(eh, ew),) if kind == "relpos" else ()

            def parent(lib=lib, extra=()):
                o = torch.empty_like(v)
                lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=dev)
                assert getattr(lib, f"iuvl_{kind}_fwd")(*ptr(*ins, *extra, o, lse), bh, n, d, h,
                                                        w, stream()) == 0
                return o, lse

            got, again, par = new(), new(), parent()
            errs = [rel(x, y) for x, y in zip(got, want)]
            e_par = [rel(x, y) for x, y in zip(par, want)]
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            if not (errs[0] <= 1e-2 and errs[1] <= 1e-5) or not same:
                bad.append(f"{kind}_fwd@{tag} rel_l2 o, lse {errs}, bit-equal {same}")
            sdpa = torch.nn.functional.scaled_dot_product_attention
            # Where this tree runs the resident kernel, its streaming one too:
            # parent, this, streaming, streaming, this, parent.
            resident = n <= 256 and bh >= sms
            streaming = lambda: parent(stream_lib, nz)  # noqa: E731
            t_par = [ms(parent)]
            t_new, t_str = [ms(new)], []
            if resident:
                st = streaming()
                e_st = [rel(x, y) for x, y in zip(st, want)]
                print(f"{kind}_fwd@{tag} streaming kernel: rel_l2 o {e_st[0]:.3e} lse "
                      f"{e_st[1]:.3e}; bit-equal to the resident kernel "
                      f"{all(torch.equal(x, y) for x, y in zip(st, got))}", flush=True)
                t_str = [ms(streaming), ms(streaming)]
            t_new.append(ms(new))
            t_par.append(ms(parent))
            times = {"ms": sum(t_new) / 2, "parent": sum(t_par) / 2,
                     **({"streaming": sum(t_str) / 2} if t_str else {}),
                     "plain": ms(lambda: fa.flash_rowbias_fwd_plain(
                         q, k, v, relh, relw, w, *((eh, ew) if kind == "relpos" else ())), 5),
                     "sdpa": ms(lambda: sdpa(q, k, v, attn_mask=bias, scale=1.0))}
            print(f"{kind}_fwd@{tag} (bh {bh}, N {n}, h {h}, w {w}, d {d}"
                  f"{', dense' if dense else ''}): rel_l2 o {errs[0]:.3e} lse {errs[1]:.3e} "
                  f"(parent {e_par[0]:.3e}, {e_par[1]:.3e}); two launches bit-equal {same}; "
                  f"ms this tree {t_new[0]:.4f} {t_new[1]:.4f}, parent {t_par[0]:.4f} "
                  f"{t_par[1]:.4f}; " + ", ".join(f"{key} {val:.4f}" for key, val in times.items()),
                  flush=True)
            print(f"{kind}_fwd@{tag} device split, this tree: {kernel_split(new, work)}",
                  flush=True)
            print(f"{kind}_fwd@{tag} device split, parent: {kernel_split(parent, work)}",
                  flush=True)
            if resident:
                print(f"{kind}_fwd@{tag} device split, streaming: "
                      f"{kernel_split(streaming, work)}", flush=True)
            del bias, want, got, again, par
        torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    print("FAILED: " + "; ".join(bad) if bad else "kernel_ab: all within bounds")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
