"""NumPy oracles of the reference's convergence semantics (counterpart of
``eigen_value_tpu.reference_impl``, which cannot be imported where jax is
missing: its package imports jax).

They are the yardstick that is independent of the code under test: NumPy
loops on the host, in float64 or float32, with no torch in the arithmetic.
The reference ships two implementations whose semantics differ in dtype,
stop neighbourhood and round counting, hence two oracles:

* :func:`sequential_oracle` — the reference's pure-Python solver
  (``main.py:13-47``): float64, the stop compares adjacent pairs without
  wraparound, and the count returned is ``itr + 1``.
* :func:`parallel_oracle` — the reference's parallel C++ semantics
  (``similarity_transform.cpp:5-75``): float32, the stop compares
  ``|v[i] - v[(i+1) % n]| < eps`` with wraparound, λ is read as ``v[0]``,
  and the count returned is the 0-based index of the round in which the
  stop fired.  The port's solvers follow these semantics.

The similarity update ``A ← D⁻¹ A D`` is computed elementwise
(``A[r][c] *= (1/v[r]) * v[c]``), as the reference kernel does
(``similarity_transform.cpp:324-325``).  For the sequential oracle this is
bit-identical to the reference's explicit ``diag`` and two matmuls: each
row and column of those products holds a single nonzero term.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .config import EPS, MAX_ITR


class OracleResult(NamedTuple):
    eigenvalue: float
    eigenvector: np.ndarray
    rounds: int
    converged: bool


def sequential_oracle(mat: np.ndarray, eps: float = EPS) -> OracleResult:
    """The reference's sequential semantics (``main.py:30-47``), float64.

    Stop: adjacent differences only (no wraparound); rounds counted as
    ``itr + 1``.  The reference loops ``while True``; this loop stops at a
    large bound to stay total.
    """
    A = np.asarray(mat, dtype=np.float64).copy()
    n = A.shape[0]
    ev = np.ones(n, dtype=np.float64)

    itr = 0
    for _ in range(1_000_000):
        v = A.sum(axis=1)
        m = v.max()
        ev = ev * (v / m)
        if np.all(np.abs(np.diff(v)) < eps):
            return OracleResult(float(v[0]), ev, itr + 1, True)
        A = A * ((1.0 / v)[:, None] * v[None, :])
        itr += 1
    raise RuntimeError("sequential oracle failed to converge")


def parallel_oracle(
    mat: np.ndarray,
    eps: float = EPS,
    max_itr: int = MAX_ITR,
    dtype=np.float32,
) -> OracleResult:
    """The reference's parallel C++ semantics
    (``similarity_transform.cpp:5-75``).

    Round i (0-based): row sums, their max, the eigenvector update, the
    stop check (wraparound), then the similarity update unless the stop
    fired.  Converged at round i: the count is i and λ = v[0].  At the cap
    the count is ``max_itr`` and λ the last checked v[0]
    (``converged=False``).
    """
    A = np.asarray(mat, dtype=dtype).copy()
    n = A.shape[0]
    ev = np.ones(n, dtype=dtype)
    v = np.zeros(n, dtype=dtype)

    for i in range(max_itr):
        v = A.sum(axis=1, dtype=dtype)
        m = v.max()
        ev = (ev * (v / m)).astype(dtype)
        if np.all(np.abs(v - np.roll(v, -1)) < eps):
            return OracleResult(float(v[0]), ev, i, True)
        A = (A * ((dtype(1.0) / v)[:, None] * v[None, :])).astype(dtype)
    return OracleResult(float(v[0]), ev, max_itr, False)
