"""Iterated (mutate-A) solve over the hand-written kernels (counterpart of
``eigen_value_tpu.ops.solver_pallas``).

Same loop as :func:`..solver.solve_xla` with the O(n²) passes replaced by
the Hopper kernels: the pre-loop row sums by :func:`..cuda.kernels.rowsum`
and each round's update-and-resum by :func:`..cuda.kernels.scale_rowsum`
(one read and one write of A per round).
"""

from __future__ import annotations

from ..utils.profiling import spanned
from .cuda import kernels
from .solver import SolveResult, solve_loop


@spanned("solver.kernel")
def solve_kernel(A, eps: float, max_itr: int, ev0=None) -> SolveResult:
    """Similarity-transform solve with the fused kernel round body, one
    launch per round after one ``rowsum`` launch (the ``solve_pallas``
    counterpart; absolute stop only, as there).  On a CPU tensor the
    wrappers run their plain versions."""
    return solve_loop(
        A,
        rowsum=kernels.rowsum,
        scale_rowsum=kernels.scale_rowsum,
        eps=eps,
        max_itr=max_itr,
        ev0=ev0,
    )
