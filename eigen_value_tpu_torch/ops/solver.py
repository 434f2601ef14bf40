"""Result type and stop criterion shared by every solve (counterparts of
``eigen_value_tpu.ops.solver``).  The iterated mutate-A loop
(``solve_loop`` / ``solve_xla``) is not ported yet."""

from __future__ import annotations

from typing import NamedTuple

import torch


class SolveResult(NamedTuple):
    """Result of one dense solve, as tensors on the solve's device.

    ``eigenvalue`` is v[0] at the round where convergence was detected;
    ``rounds`` is the 0-based index of the converging round;
    ``rounds == max_itr`` with ``converged == False`` means the cap was hit.
    """

    eigenvalue: torch.Tensor
    eigenvector: torch.Tensor
    rounds: torch.Tensor
    converged: torch.Tensor


def stop_check(v: torch.Tensor, eps: float, eps_mode: str = "absolute") -> torch.Tensor:
    """Wraparound stop criterion: all |v[i] - v[(i+1) % n]| < tol, a 0-d bool
    tensor on v's device.

    ``eps_mode="absolute"`` (reference-exact): tol = eps, rounded to v's
    dtype.  ``"relative"``: tol = eps · max|v|.  The comparison is strict.
    """
    e = torch.tensor(eps, dtype=v.dtype)  # a 0-d CPU tensor acts as a scalar
    if eps_mode == "relative":
        e = e * v.abs().max()
    elif eps_mode != "absolute":
        raise ValueError(f"eps_mode must be 'absolute' or 'relative', got {eps_mode!r}")
    adjacent_ok = torch.all((v[1:] - v[:-1]).abs() < e)
    wrap_ok = (v[-1] - v[0]).abs() < e
    return adjacent_ok & wrap_ok
