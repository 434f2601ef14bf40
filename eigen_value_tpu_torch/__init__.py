"""eigen_value_tpu_torch — the PyTorch and CUDA port of eigen_value_tpu.

Maximum eigenvalue and eigenvector of a positive square matrix by the
similarity-transform method, in its matvec ("power") form and in the
reference's iterated (mutate-A) form, with hand-written CUDA kernels for
Hopper (``csrc/``) and a plain PyTorch version beside each kernel, and the
matrix-free solve of an operator that is never materialized
(``max_eigenvalue_operator``, ``ops/structured.py``), batched solves
(``max_eigenvalue_batch``), checkpointed solves (``checkpoint``) and
differentiable eigenvalues (``ops/autodiff.py``).  Imports
torch and numpy only, never jax: ``eigen_value_tpu`` stays the reference
the port is tested against.
"""

from . import checkpoint, fixtures
from .api import (
    EigenValue,
    eigen_residual,
    max_eigenvalue,
    max_eigenvalue_batch,
    max_eigenvalue_operator,
)
from .config import DEFAULT_CONFIG, EPS, MAX_ITR, SolverConfig
from .ops.solver import SolveResult

__version__ = "0.1.0"

__all__ = [
    "EigenValue",
    "eigen_residual",
    "checkpoint",
    "fixtures",
    "max_eigenvalue",
    "max_eigenvalue_batch",
    "max_eigenvalue_operator",
    "SolverConfig",
    "SolveResult",
    "DEFAULT_CONFIG",
    "EPS",
    "MAX_ITR",
]
