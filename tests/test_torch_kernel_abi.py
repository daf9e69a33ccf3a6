"""The C entry points of the port's kernels against the ctypes argument
types that ``iuvl_tpu_torch/ops/cuda/build.py`` gives them. A mismatch is
silent on the CPU and cuts a pointer to 32 bits on the card: every
``extern "C" int iuvl_*`` definition in ``csrc/*.cu`` must have its entry
in ``SIGNATURES`` (and the other way round), with the same number of
arguments and the same kind of each (pointer -> c_void_p, int -> c_int,
float -> c_float), the stream last."""

import ctypes
import re
from pathlib import Path

import pytest

from iuvl_tpu_torch.ops.cuda.build import SIGNATURES, SRC_DIR

DEF = re.compile(r'extern\s+"C"\s+int\s+(iuvl_\w+)\s*\(([^)]*)\)\s*\{')


def _kind(param: str):
    """The ctypes type a C parameter declaration is passed as."""
    decl = " ".join(param.split())
    if "*" in decl:
        return ctypes.c_void_p
    ctype = decl.rsplit(" ", 1)[0].replace("const ", "")
    return {"int": ctypes.c_int, "float": ctypes.c_float}[ctype]


def _definitions() -> dict:
    found = {}
    for cu in sorted(SRC_DIR.glob("*.cu")):
        for name, params in DEF.findall(cu.read_text()):
            assert name not in found, f"{name} defined twice ({found[name][0]}, {cu.name})"
            found[name] = (cu.name, [p.strip() for p in params.split(",")])
    return found


DEFS = _definitions()


def test_every_entry_point_has_a_signature():
    assert set(DEFS) == set(SIGNATURES), (
        f"in csrc only: {sorted(set(DEFS) - set(SIGNATURES))}; "
        f"in SIGNATURES only: {sorted(set(SIGNATURES) - set(DEFS))}")


@pytest.mark.parametrize("name", sorted(DEFS))
def test_signature_matches_definition(name):
    source, params = DEFS[name]
    want = SIGNATURES[name]
    assert len(params) == len(want), (
        f"{name} ({source}): {len(params)} parameters, SIGNATURES has {len(want)}")
    got = [_kind(p) for p in params]
    for i, (g, w, p) in enumerate(zip(got, want, params)):
        assert g is w, f"{name} ({source}) argument {i} `{p}`: {g.__name__} vs {w.__name__}"
    assert re.fullmatch(r"void\s*\*\s*stream", params[-1]), (
        f"{name} ({source}): the last parameter is `{params[-1]}`, not the stream")


def test_parser_reads_the_kinds():
    assert _kind("const void* q") is ctypes.c_void_p
    assert _kind("void *stream") is ctypes.c_void_p
    assert _kind("int bh") is ctypes.c_int
    assert _kind("float scale") is ctypes.c_float
    assert Path(SRC_DIR).is_dir() and len(DEFS) >= 20
