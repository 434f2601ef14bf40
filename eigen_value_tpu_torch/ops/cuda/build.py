"""Build and load the Hopper kernels.

The CUDA sources under ``eigen_value_tpu_torch/csrc`` have a plain C
interface; ``nvcc`` compiles each for ``sm_90a``, all at once in parallel,
and links them into one shared library, which is loaded with ``ctypes``.
Nothing is built at import: the first call of :func:`load` builds
(seconds) into ``eigen_value_tpu_torch/_build``, named by a hash of the
sources and flags, so an unchanged tree reuses its library and a changed
one never loads a stale build.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = (
    "matvec.cu", "multiround.cu", "multiround_sym.cu", "round.cu", "rowsum.cu", "scale.cu",
    "stop.cu",
)
HEADERS = ("bulk.cuh", "mma_tf32.cuh", "prologue.cuh", "rowdot.cuh", "rowsum.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # A, x, y, n, m, ld, elem, stream (elem: A's element type, kernels._ELEM)
    "evt_matvec": (_P, _P, _P, _I, _I, ctypes.c_longlong, _I, _P),
    # A, ev_in, v_in, lam_in, budget, ev_out, v_out, adv_out, lam_out,
    # rounds_out, converged_out, rounds0, raw, n, chunk, eps, init, rel, resident,
    # l2_rows, ring, dot, part, work, stamps, elem, grid, stream
    "evt_multiround": (
        _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, ctypes.c_float, _I, _I,
        _I, _I, _I, _I, _P, _P, _P, _I, _I, _P,
    ),
    # n, resident, ring, elem, dot
    "evt_multiround_blocks": (_I, _I, _I, _I, _I),
    # A, tiles, T, C, slots, ev_in, v_in, lam_in, budget, ev_out, v_out,
    # adv_out, lam_out, rounds_out, converged_out, rounds0, raw, part, part_t, n,
    # bt, chunk, eps, init, rel, sym, split, l2_tiles, ring, form, mxu_from, fill,
    # stamps, elem, grid, stream
    "evt_multiround_sym": (
        _P, _P, _I, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I,
        _I, ctypes.c_float, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _I, _I, _P,
    ),
    # n, bt, slots, ring, elem, form (0 vpu, 1 dot, 2 mixed), fill (1: pipelined)
    "evt_multiround_sym_grid": (_I, _I, _I, _I, _I, _I, _I),
    "evt_round_grid": (_I,),
    # A, ev, v, m, v_next, ev_new, n, grid, stream
    "evt_round_matvec": (_P, _P, _P, _P, _P, _P, _I, _I, _P),
    # A, ev, v, eps, v_next, ev_new, done, lam, n, grid, stream
    "evt_round_fused": (_P, _P, _P, ctypes.c_float, _P, _P, _P, _P, _I, _I, _P),
    # A, out, n, stream
    "evt_rowsum": (_P, _P, _I, _P),
    # A, bias, out, n, stream
    "evt_rowsum_bias": (_P, _P, _P, _I, _P),
    # A, v, out, n, stream
    "evt_scale": (_P, _P, _P, _I, _P),
    # A, v, out, v_out, n, stream
    "evt_scale_rowsum": (_P, _P, _P, _P, _I, _P),
    # v, eps, n, state, out, stream
    "evt_stop": (_P, _P, _I, _P, _P, _P),
    # x, big, small, n, cvt (1: by cvt.rna, 0: the kernels' integer rounding), stream
    "evt_tf32_split": (_P, _P, _P, _I, _I, _P),
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libevt_{_digest()}.so"


def report_path() -> Path:
    """The compiler's resource report (registers, shared memory, spills)
    written by :func:`build`."""
    return BUILD_DIR / f"ptxas_{_digest()}.txt"


def _run(cmds) -> str:
    """Run the commands at once; their output, or RuntimeError on a failure."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{out}")
    return "".join(outs)


def build() -> Path:
    """Compile the kernels unless a library for these sources exists: one
    ``nvcc`` per source, all started together, then one link.  The
    compiler's resource report is kept beside the library
    (:func:`report_path`)."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    nvcc = _nvcc()
    report = _run(
        [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)] for s, o in zip(SOURCES, objs)]
    )
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    _run([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    for o in objs:
        o.unlink()
    report_path().write_text(report)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with every entry's argument
    types declared (pointers and the stream as ``c_void_p``)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
