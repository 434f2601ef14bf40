"""Result type, stop criterion and the iterated (mutate-A) solve
(counterparts of ``eigen_value_tpu.ops.solver``).

The iterated form is the reference's own structure: the row sums of A
before the loop, then every round the similarity update of A fused with
the next row sums,

    A' = A · ((1/v_r) · v_c),    v' = rowsum(A'),

one read and one write of A per round (the power form of
``solver_matvec`` reads A once and never writes it).  The round semantics
are shared with it: the stop is checked BEFORE the update, λ = v[0],
rounds are 0-based, and the cap reports the last checked round
(:func:`_finish`).  JAX runs the loop as a ``lax.while_loop`` on the
device; here it runs on the host with one stop read per round.

The caller's matrix is never written: the first round writes A' into a
fresh buffer and every later round updates that buffer in place (peak
memory 2 × A, no copy pass).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..utils.profiling import span, spanned


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


def stop_check(v: torch.Tensor, eps, eps_mode: str = "absolute") -> torch.Tensor:
    """Wraparound stop criterion: all |v[i] - v[(i+1) % n]| < tol, a 0-d bool
    tensor on v's device (for a batch of rows v (B, n), one verdict a row).

    ``eps_mode="absolute"`` (reference-exact): tol = eps, rounded to v's
    dtype.  ``"relative"``: tol = eps · max|v| (of the row).  The comparison
    is strict.  ``eps`` is a number, or a 0-d tensor of v's dtype that is
    used where it lies (nothing is read back to the host).
    """
    if isinstance(eps, torch.Tensor):
        e = eps
    else:
        e = torch.tensor(eps, dtype=v.dtype)  # a 0-d CPU tensor acts as a scalar
    if eps_mode == "relative":
        e = e * v.abs().amax(-1, keepdim=True)
    elif eps_mode != "absolute":
        raise ValueError(f"eps_mode must be 'absolute' or 'relative', got {eps_mode!r}")
    adjacent_ok = ((v[..., 1:] - v[..., :-1]).abs() < e).all(-1)
    wrap_ok = (v[..., -1] - v[..., 0]).abs() < e.squeeze(-1)  # a view: no launch
    return adjacent_ok & wrap_ok


RowsumFn = Callable[[torch.Tensor], torch.Tensor]
#: ``(A, v, out) -> (A', v')``; ``out`` None allocates A', ``out is A``
#: updates in place.
ScaleRowsumFn = Callable[
    [torch.Tensor, torch.Tensor, Optional[torch.Tensor]], Tuple[torch.Tensor, torch.Tensor]
]


def rowsum_xla(A: torch.Tensor) -> torch.Tensor:
    """Row sums of A with PyTorch's reduction (``kernels.rowsum_plain``)."""
    from .cuda import kernels  # kernels imports this module

    return kernels.rowsum_plain(A)


def scale_rowsum_xla(A: torch.Tensor, v: torch.Tensor, out: Optional[torch.Tensor] = None):
    """Similarity update + next row sums in plain PyTorch
    (``kernels.scale_rowsum_plain``): the same reciprocal-then-multiply
    arithmetic as the kernel, in two passes."""
    from .cuda import kernels

    return kernels.scale_rowsum_plain(A, v, out=out)


class _Carry(NamedTuple):
    A: torch.Tensor
    v: torch.Tensor
    ev: torch.Tensor
    lam: torch.Tensor  # λ snapshot (v[0]) of the last round advanced past
    i: int


def _finished(ev, v, lam, converged: bool) -> tuple:
    """``(ev, λ)`` of a frozen carry: where it converged, the stop fired on
    ``v`` and the converging round's update is applied, ``ev · (v / m)``
    with m = max(v), and λ = v[0]; at the cap the carry's ev and λ.  (The
    persistent kernels evaluate the same expressions in the same f32 order
    where a solve ends inside a launch, csrc/prologue.cuh
    ``write_finish``.)"""
    if converged:
        m = torch.max(v)
        return ev * (v / m), v[0]
    return ev, lam


@spanned("solver.finish")
def _finish(out, max_itr: int) -> SolveResult:
    """Post-loop epilogue shared by every solve form but the one-launch
    solves, whose kernels write it (``out`` is a loop carry with ``ev``,
    ``v``, ``lam`` and ``i``).

    * converged at round k < max_itr: the stop fired on ``out.v``; apply the
      converging round's ev update, λ = v[0], rounds = k.
    * cap exhaustion (i == max_itr): report the last CHECKED round's λ (the
      ``lam`` carry), ev as updated through round max_itr−1,
      converged = False.
    """
    converged = out.i < max_itr
    dev = out.v.device
    ev, lam = _finished(out.ev, out.v, out.lam, converged)
    return SolveResult(
        lam,
        ev,
        torch.tensor(out.i, dtype=torch.int32, device=dev),
        torch.tensor(converged, device=dev),
    )


def solve_loop(
    A: torch.Tensor,
    *,
    rowsum: RowsumFn,
    scale_rowsum: ScaleRowsumFn,
    eps: float,
    max_itr: int,
    ev0=None,
    eps_mode: str = "absolute",
) -> SolveResult:
    """The iterated convergence loop with pluggable O(n²) passes.

    ``v0 = rowsum(A)`` runs once before the loop; the stop check is the
    loop condition, so the converging round's O(n²) update is skipped by
    leaving the loop (the reference's break-before-update); its ev update
    runs after the loop.  ``ev0`` overrides the all-ones start vector (the
    iteration is scale-invariant in ev; λ and the round count are read
    from v, which ev never feeds).  A is only read: round 0 writes its
    update to a new buffer, which the later rounds rewrite in place.
    """
    n = A.shape[0]
    if ev0 is None:
        ev0 = torch.ones(n, dtype=A.dtype, device=A.device)
    else:
        ev0 = torch.as_tensor(ev0, dtype=A.dtype, device=A.device).contiguous()
    c = _Carry(A, rowsum(A), ev0, torch.zeros((), dtype=A.dtype, device=A.device), 0)
    while c.i < max_itr:
        stop = stop_check(c.v, eps, eps_mode)
        with span("solver.read"):
            stop = bool(stop)
        if stop:
            break
        v = c.v
        m = torch.max(v)
        ev = c.ev * (v / m)
        lam = v[0]
        A2, v2 = scale_rowsum(c.A, v, None if c.i == 0 else c.A)
        c = _Carry(A2, v2, ev, lam, c.i + 1)
    return _finish(c, max_itr)


@spanned("solver.xla")
def solve_xla(
    A: torch.Tensor, eps: float, max_itr: int, ev0=None, eps_mode: str = "absolute"
) -> SolveResult:
    """Iterated solve over the plain PyTorch passes, on any device (the
    JAX package's pure-XLA solver)."""
    return solve_loop(
        A,
        rowsum=rowsum_xla,
        scale_rowsum=scale_rowsum_xla,
        eps=eps,
        max_itr=max_itr,
        ev0=ev0,
        eps_mode=eps_mode,
    )
