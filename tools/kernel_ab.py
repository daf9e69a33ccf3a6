"""This tree's B13 and B2b / B14 backward against a parent tree's, on one
card, in one process: build this tree's kernels (printing ptxas's
registers and spills for the two sources), compile the parent's
``window_attention.cu`` and ``flash_attention_rowbias.cu`` alone with
``nvcc`` (and a copy of the parent's backward with its global atomic adds
made plain stores, where it has any), then at ViT-B's windowed and global
shapes (and two grids that reach the other code paths) hold each against
the plain version (relative L2), check that two
launches of this tree's backward give the same bits, time this tree's,
the parent's and the plain version (CUDA events, 20 calls after a
warm-up), and split this tree's device time by kernel (torch.profiler).

    git archive <parent> iuvl_tpu_torch/csrc | tar -x -C _chip/parent
    python3 tools/kernel_ab.py --parent _chip/parent

The parent's entry points must have the signatures they had before the
two-pass backward (``iuvl_rowbias_bwd`` with fp32 accumulators). Needs one
CUDA card.
"""

import argparse
import ctypes
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
from iuvl_tpu_torch.ops.cuda import window_attention as wa  # noqa: E402
from iuvl_tpu_torch.ops.rel_pos_attention import (  # noqa: E402
    onehot_expanders, rel_pos_features, rel_pos_tables)

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
PARENT_SIGS = {"iuvl_window_attention": [P] * 6 + [I] * 4 + [F, P],
               "iuvl_rowbias_bwd": [P] * 13 + [I] * 5 + [P],
               "iuvl_relpos_bwd": [P] * 15 + [I] * 5 + [P]}
KERNELS = ("rb_bwd", "rb_nz", "rb_delta", "window_stream", "window_resident", "window_attn_kernel",
           "rel_features")


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
    """Registers and spills of the kernels of the two sources in ``log``."""
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


def compile_parent(parent: Path, work: Path) -> dict:
    """The parent's two sources, and its backward with atomics as stores,
    each a shared library of its own."""
    csrc = parent / "iuvl_tpu_torch/csrc"
    rb = (csrc / "flash_attention_rowbias.cu").read_text()
    stores = re.sub(r"atomicAdd\((\w+) \+ ([^,]+), ([^;]+)\);", r"\1[\2] = \3;", rb)
    srcs = {"window": (csrc / "window_attention.cu").read_text(), "rowbias": rb}
    if stores != rb:
        srcs["rowbias_stores"] = stores
    procs = {}
    for name, text in srcs.items():
        cu = work / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v", "-I", str(csrc), "-o",
             str(work / f"{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"parent {name}: {err[-4000:]}")
        if name != "rowbias_stores":
            ptxas_summary(err, "parent")
        lib = ctypes.CDLL(str(work / f"{name}.so"))
        for fn, argtypes in PARENT_SIGS.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def profile(fn, calls=10) -> str:
    """Device ms a call of each kernel that ``fn`` launches."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if dev_us and ev.device_type == torch.autograd.DeviceType.CUDA:
            name = re.sub(r"\(.*", "", ev.key.replace("iuvl::(anonymous namespace)::", ""))
            rows.append(f"{name[:60]} {dev_us / 1e3 / calls:.4f}")
    return "; ".join(rows)


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
    libs = compile_parent(args.parent.resolve(), work)
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
    # ViT-B's windows and global grid; a 32 x 32 grid (ViT-B at 512^2: B13's
    # streaming kernel with looked-up bias, B2b's one-hot dq pass); an 80 x
    # 80 grid at d 80 (h + w > 128: the dq pass in two group launches).
    for tag, bh, side, d in (("window", 300, 14, 64), ("global", 12, 64, 64),
                             ("side32", 12, 32, 64), ("side80_d80", 16, 80, 80)):
        n = side * side
        q, k, v, do = (t(1, bh, n, d) for _ in range(4))
        rh, rw = rel_pos_tables(t(2 * side - 1, d, std=0.3), t(2 * side - 1, d, std=0.3),
                                (side, side))
        rhb, rwb = rh.to(torch.bfloat16), rw.to(torch.bfloat16)

        def b13_parent():
            o = torch.empty_like(q)
            assert libs["window"].iuvl_window_attention(*ptr(q, k, v, rhb, rwb, o), bh, n, d,
                                                        side, d ** -0.5, stream()) == 0
            return o

        new = lambda: wa.window_rel_attention_fwd(q, k, v, rhb, rwb)  # noqa: E731
        ref = wa.window_rel_attention_fwd_plain(q, k, v, rhb, rwb)
        e_new, e_par = rel(new(), ref), rel(b13_parent(), ref)
        if not e_new <= 1e-3:
            bad.append(f"B13@{tag} rel_l2 {e_new}")
        print(f"B13@{tag}: rel_l2 {e_new:.3e} (parent {e_par:.3e}); ms {ms(new):.4f}, parent "
              f"{ms(b13_parent):.4f}, plain "
              f"{ms(lambda: wa.window_rel_attention_fwd_plain(q, k, v, rhb, rwb), 5):.4f}",
              flush=True)
        print(f"B13@{tag} device ms a call: {profile(new)}", flush=True)

        relh, relw = rel_pos_features(q, rh, rw)
        qs = q * d ** -0.5
        eh, ew = onehot_expanders((side, side), torch.bfloat16, dev)
        o, lse = fa.flash_rowbias_fwd_plain(qs, k, v, relh, relw, side)
        for kind in ("rowbias", "relpos"):
            if kind == "rowbias":
                a = (qs, k, v, relh, relw, o, lse, do, side)
                kern, plain = fa.flash_rowbias_bwd, fa.flash_rowbias_bwd_plain
                ins = (qs, k, v, relh, relw, o, lse, do)
            else:
                a = (qs, k, v, relh, relw, eh, ew, o, lse, do)
                kern = fa.flash_relpos_bwd
                plain = lambda *x: fa.flash_rowbias_bwd_plain(  # noqa: E731
                    *x[:5], *x[7:], side, x[5], x[6])
                ins = (qs, k, v, relh, relw, eh, ew, o, lse, do)

            def parent(lib):
                dq_acc = torch.zeros(bh, n, d, device=dev)
                drel = torch.zeros(bh, n, 2 * side, device=dev)
                delta = torch.empty(bh, n, device=dev)
                dk, dv = torch.empty_like(k), torch.empty_like(v)
                fn = getattr(lib, f"iuvl_{kind}_bwd")
                assert fn(*ptr(*ins, delta, dq_acc, drel, dk, dv), bh, n, d, side, side,
                          stream()) == 0
                return (dq_acc.to(torch.bfloat16), dk, dv, drel[..., :side].to(torch.bfloat16),
                        drel[..., side:].to(torch.bfloat16))

            got, again, want = kern(*a), kern(*a), plain(*a)
            errs = [rel(x, y) for x, y in zip(got, want)]
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            e_par = [rel(x, y) for x, y in zip(parent(libs["rowbias"]), want)]
            if not all(e <= 1e-3 for e in errs) or not same:
                bad.append(f"{kind}_bwd@{tag} rel_l2 {errs}, bit-equal {same}")
            times = {"ms": ms(lambda: kern(*a)), "parent": ms(lambda: parent(libs["rowbias"]))}
            if "rowbias_stores" in libs:
                times["parent, atomics as stores"] = ms(lambda: parent(libs["rowbias_stores"]))
            times["plain"] = ms(lambda: plain(*a), 5)
            print(f"{kind}_bwd@{tag}: rel_l2 dq dk dv drelh drelw "
                  + " ".join(f"{e:.3e}" for e in errs) + " (parent "
                  + " ".join(f"{e:.3e}" for e in e_par) + f"); two launches bit-equal {same}; "
                  + ", ".join(f"{key} {val:.4f}" for key, val in times.items()), flush=True)
            print(f"{kind}_bwd@{tag} device ms a call: {profile(lambda: kern(*a))}", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    print("FAILED: " + "; ".join(bad) if bad else "kernel_ab: all within bounds")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
