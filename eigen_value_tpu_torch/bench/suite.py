"""Benchmark suite (counterpart of ``eigen_value_tpu.bench.suite``): so far
the per-kernel ladder of the O(n²) passes.

Each rung is timed marginally, (T(k+1 chained) − T(1)) / k with CUDA
events (``utils.timing.time_marginal``), and reported with its achieved
bandwidth against the card's published memory rate.  The rows keep the JAX
suite's names and keys so the two tables read side by side: ``*_xla`` is
the one-call PyTorch expression (the library's kernels), ``*_pallas`` the
port's hand-written kernel.  Times are device times: without a CUDA card
the suite raises.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from .. import fixtures
from ..ops.cuda import kernels
from ..utils.timing import detect_peak_gbps, roofline_pct, time_marginal

MATRIX_DIMS = [1 << p for p in range(7, 14)]  # 128 .. 8192

#: Scale of the row-sum chain's bias (times v[0]): too small to change a
#: sum, enough to make each launch depend on the one before.
_BIAS_SCALE = 1e-38

Step = Callable[[int, tuple], tuple]


def kernel_steps(n: int, device) -> Dict[str, Tuple[Step, tuple, int]]:
    """The ladder's rungs at dim ``n`` on ``device``, in order: name ->
    ``(step, init, bytes)`` with ``step(i, state) -> state`` one application
    and ``bytes`` what it must move (A read once; read and written once by
    the updates).

      rowsum_xla -> rowsum_pallas -> scale_xla -> scale_pallas ->
      scale_rowsum_pallas (fused) -> matvec_xla -> matvec_pallas.

    The read-only rungs share one Hilbert matrix.  The updating rungs
    rewrite their state in place, so each gets a copy of its own; with the
    constant vector of the ``scale`` rungs the factor (1/c)·c stays 1 to
    rounding, and the ``scale_rowsum`` chain is the solve's own iteration.
    On a CPU device the kernel rungs run their plain versions (what the
    tests step through).
    """
    A = fixtures.hilbert_matrix(n, device=device)
    v = kernels.rowsum_plain(A)
    ones = torch.ones(n, dtype=torch.float32, device=device)
    const = fixtures.stop_success_vector(n, device=device)
    tiny = torch.tensor(_BIAS_SCALE, dtype=torch.float32, device=device)
    nbytes = n * n * 4

    def rowsum_xla_step(i, s):
        Ai, _ = s
        return (Ai, kernels.rowsum_plain(Ai))

    def rowsum_pallas_step(i, s):
        # the bias (a device scalar made from the previous sums) threads the
        # chain through the kernel's own operand; nothing is read back
        Ai, vi = s
        return (Ai, kernels.rowsum_bias(Ai, vi[0] * tiny))

    def scale_xla_step(i, s):
        Ai, vi = s
        return (kernels.scale_plain(Ai, vi, out=Ai), vi)

    def scale_pallas_step(i, s):
        Ai, vi = s
        return (kernels.scale(Ai, vi, out=Ai), vi)

    def scale_rowsum_step(i, s):
        return kernels.scale_rowsum(s[0], s[1], out=s[0])

    def matvec_xla_step(i, s):
        Ai, xi = s
        return (Ai, kernels.matvec_plain(Ai, xi) / xi)

    def matvec_pallas_step(i, s):
        Ai, xi = s
        return (Ai, kernels.matvec(Ai, xi) / xi)

    return {
        "rowsum_xla": (rowsum_xla_step, (A, v), nbytes),
        "rowsum_pallas": (rowsum_pallas_step, (A, v), nbytes),
        "scale_xla": (scale_xla_step, (A.clone(), const), 2 * nbytes),
        "scale_pallas": (scale_pallas_step, (A.clone(), const), 2 * nbytes),
        "scale_rowsum_pallas": (scale_rowsum_step, (A.clone(), v), 2 * nbytes),
        "matvec_xla": (matvec_xla_step, (A, ones), nbytes),
        "matvec_pallas": (matvec_pallas_step, (A, ones), nbytes),
    }


def bench_kernels(dims: List[int] = MATRIX_DIMS, k: int = 64) -> List[dict]:
    """Per-kernel marginal timings for the O(n²) passes on the CUDA card:
    one row per rung of :func:`kernel_steps` and dim, with ``ms``, ``gbps``
    and ``roofline_pct`` (None where the marginal vanished or the card's
    rate is not in the table: RFC-valid JSON, never NaN)."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_kernels measures the CUDA device; none is available")
    device = torch.device("cuda")
    peak = detect_peak_gbps(device)
    rows = []
    for n in dims:
        for name, (step, init, nbytes) in kernel_steps(n, device).items():
            ms = time_marginal(step, init, k=k)
            pct = roofline_pct(ms, nbytes, peak) if ms > 0 else None
            rows.append(
                {
                    "bench": "kernel",
                    "kernel": name,
                    "dim": n,
                    "ms": ms,
                    "gbps": nbytes / (ms * 1e-3) / 1e9 if ms > 0 else None,
                    "roofline_pct": None if pct != pct else pct,
                }
            )
    return rows
