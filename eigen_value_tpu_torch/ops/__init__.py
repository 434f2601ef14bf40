"""Solvers and kernels of the port: the round-body passes and the solver
loop (counterpart of ``eigen_value_tpu.ops``)."""

from .solver import (
    SolveResult,
    rowsum_xla,
    scale_rowsum_xla,
    solve_loop,
    solve_xla,
    stop_check,
)

__all__ = [
    "SolveResult",
    "rowsum_xla",
    "scale_rowsum_xla",
    "solve_loop",
    "solve_xla",
    "stop_check",
]
