"""ctypes binding to the native C++ runtime library (the port's own copy
of ``eigen_value_tpu.native``, which it may not import).

Mirrors the reference's Python wrapper structure
(wrapper/python/similarity_transform.py:18-78: ctypes-load the .so, make a
queue handle once, marshal NumPy arrays).  The library is built from the
repository's shared ``native/eigen_native.cpp`` (`make -C native lib`); if
it hasn't been built yet, :func:`build` compiles it on demand with g++.
It runs on the CPU: the reference-architecture datapoint of
``python -m eigen_value_tpu_torch.bench --suite native``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_SO_PATH = _NATIVE_DIR / "libeigen_native.so"


def build(force: bool = False) -> Path:
    """Build libeigen_native.so if missing or older than its source.
    Returns its path."""
    src = _NATIVE_DIR / "eigen_native.cpp"
    if (
        _SO_PATH.exists()
        and not force
        and (not src.exists() or _SO_PATH.stat().st_mtime >= src.stat().st_mtime)
    ):
        # up to date (or source-less install: trust the shipped binary)
        return _SO_PATH
    if not src.exists():
        raise FileNotFoundError(f"native source not found: {src}")
    subprocess.run(
        ["make", "-C", str(_NATIVE_DIR), "lib"],
        check=True,
        capture_output=True,
    )
    return _SO_PATH


def available() -> bool:
    try:
        return build().exists()
    except (FileNotFoundError, subprocess.CalledProcessError, OSError):
        return False


class NativeEigenValue:
    """Native CPU solver with the reference wrapper's exact API shape:
    ``similarity_transform(mat) -> (eigenvalue, eigenvector, ms, rounds)``.
    """

    def __init__(self, so_path: Optional[os.PathLike] = None) -> None:
        path = Path(so_path) if so_path else build()
        if not path.exists():
            raise FileNotFoundError(f"failed to find shared library `{path}`")
        self._lib = ctypes.CDLL(str(path))

        self._lib.make_queue.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
        self._ctx = ctypes.c_void_p()
        self._lib.make_queue(ctypes.byref(self._ctx))
        if self._ctx.value is None:
            raise RuntimeError("failed to create native context")

        mat_t = np.ctypeslib.ndpointer(dtype=np.float32, ndim=2, flags="CONTIGUOUS")
        vec_t = np.ctypeslib.ndpointer(dtype=np.float32, ndim=1, flags="CONTIGUOUS")
        itr_t = np.ctypeslib.ndpointer(dtype=np.uint32, ndim=1, flags="CONTIGUOUS")
        self._lib.max_eigen_value.restype = ctypes.c_int64
        self._lib.max_eigen_value.argtypes = [
            ctypes.c_void_p,
            mat_t,
            vec_t,
            vec_t,
            ctypes.c_uint,
            itr_t,
        ]
        self._lib.max_eigen_value_matvec.restype = ctypes.c_int64
        self._lib.max_eigen_value_matvec.argtypes = (
            self._lib.max_eigen_value.argtypes
        )
        self._lib.bench_kernel_us.restype = ctypes.c_double
        self._lib.bench_kernel_us.argtypes = [
            ctypes.c_char_p,
            ctypes.c_uint,
            ctypes.c_uint,
        ]

    def __del__(self) -> None:
        lib = getattr(self, "_lib", None)
        ctx = getattr(self, "_ctx", None)
        if lib is not None and ctx is not None and ctx.value:
            lib.free_queue(ctx)

    def similarity_transform(
        self, mat: np.ndarray, matvec_form: bool = False
    ) -> Tuple[np.float32, np.ndarray, int, int]:
        """``matvec_form=True`` runs the power-form native solver (one
        matvec per round against the original matrix, no writes —
        ops/solver_matvec.py's algebra, natively)."""
        mat = np.ascontiguousarray(mat, dtype=np.float32)
        if mat.ndim != 2 or mat.shape[0] != mat.shape[1]:
            raise ValueError("must be square matrix of floating points !")
        n = mat.shape[0]

        eigen_val = np.empty(1, dtype=np.float32)
        eigen_vec = np.empty(n, dtype=np.float32)
        iter_cnt = np.zeros(1, dtype=np.uint32)
        fn = (
            self._lib.max_eigen_value_matvec
            if matvec_form
            else self._lib.max_eigen_value
        )
        ts = fn(self._ctx, mat, eigen_val, eigen_vec, n, iter_cnt)
        return eigen_val[0], eigen_vec, int(ts), int(iter_cnt[0])

    def bench_kernel_us(self, name: str, dim: int, reps: int = 3) -> float:
        """Best-of-reps wall µs of one native kernel launch (reference
        ``benchmark_*`` family). Names: row_sums, find_max, eigvec, stop,
        next_matrix, matvec.  ``reps`` is clamped to ≥1 (the C side's
        first rep is a warmup and records nothing)."""
        us = self._lib.bench_kernel_us(name.encode(), dim, max(1, reps))
        if us < 0:
            raise ValueError(f"unknown native kernel {name!r}")
        return float(us)
