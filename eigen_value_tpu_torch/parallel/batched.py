"""Batched solves over (B, n, n), optionally sharded over a mesh
(counterpart of ``eigen_value_tpu.parallel.batched``).

The reference's Python test loops over independent random matrices; the
batched mode solves them together (BASELINE.json config 4: 256 independent
512² matrices).  Per-matrix convergence differs, so the loop runs until
every matrix has converged or reached the cap while freezing the finished
ones, which keeps each matrix's own round count: the semantics of JAX's
``vmap`` over ``solve_matvec``, whose batched ``while_loop`` runs on "any
still running" and select-freezes each carry.  ``torch.vmap`` cannot run a
loop whose length depends on the data, so the mask is written out here; the
host reads one flag a round.

:func:`solve_batched_sharded` shards the batch over a mesh dimension: each
rank runs :func:`solve_batched` on its slice, and the slices never
exchange, so each rank stops when its own matrices have (JAX's globally
masked loop gives the same per-matrix results and runs every device to the
slowest matrix anywhere).
"""

from __future__ import annotations

import torch

from ..config import DEFAULT_CONFIG, SolverConfig
from ..ops.cuda import kernels
from ..ops.solver import SolveResult, stop_check
from ..ops.solver_matvec import _stored
from ..ops.structured import _matmul_f32
from .sharded import _as_tensor, _batch_result, _local, require_axis


def solve_batched(
    As: torch.Tensor,
    eps: float,
    max_itr: int,
    storage_dtype=None,
    ev0=None,
    eps_mode: str = "absolute",
) -> SolveResult:
    """Solve a batch of positive matrices ``As`` of shape (B, n, n).

    Returns a SolveResult whose tensors carry a leading batch axis;
    ``rounds`` is each matrix's own (frozen at its convergence round).  Each
    round is one batched matvec against the original matrices and the
    power-form update of the live ones, with the stop checked per matrix;
    a matrix that stopped, or every matrix at ``max_itr``, keeps its state.

    The matvec: a float32 (or float64) batch is one ``torch.bmm`` in true
    float32 (pinned "highest", as JAX's vmapped ``dot_f32`` is a batched
    GEMV outside any Pallas kernel).  A batch stored in 2 bytes
    (``storage_dtype`` bf16 / f16, or already in it) follows the port's
    storage contract: one ``kernels.matvec`` a live matrix a round on the
    card (its plain version on the CPU), f32 state, no f32 copy of the batch;
    each matrix is then bit for bit ``solve_matvec_kernel`` of its own.
    That route reads the live mask (B flags) in one copy a round.

    ``ev0`` (shape (n,), shared by every matrix) overrides the all-ones
    start; ``eps_mode`` applies per matrix with the one-matrix semantics.
    """
    if As.dim() != 3 or As.shape[1] != As.shape[2]:
        raise ValueError(f"expected (B, n, n), got {tuple(As.shape)}")
    return _solve_masked(As, As.shape[2], eps, max_itr, storage_dtype, eps_mode, ev0=ev0)


def _solve_masked(As: torch.Tensor, n: int, eps: float, max_itr: int, storage_dtype=None,
                  eps_mode: str = "absolute", ev0=None, gathered=None) -> SolveResult:
    """The masked loop of :func:`solve_batched` over ``As`` of shape
    (B, rows, n): all of each matrix's rows, or, with ``gathered``, this
    rank's block of them, whose products ``gathered`` completes to (B, n)
    (the row-sharded batch: an all-gather along the rows).  The live mask
    is computed from the full v, so every rank of a row group keeps the
    same matrices live."""
    As, dtype = _stored(As, storage_dtype)
    B = As.shape[0]
    dev = As.device
    per_matrix = As.element_size() < 4
    if ev0 is None:
        ev = torch.ones(B, n, dtype=dtype, device=dev)
    else:
        ev0 = torch.as_tensor(ev0, dtype=dtype, device=dev)
        if tuple(ev0.shape) != (n,):
            raise ValueError(f"ev0 must have shape ({n},), got {tuple(ev0.shape)}")
        ev = ev0.expand(B, n).contiguous()

    def products(ev, live):
        """``As @ ev`` a row per matrix; on the 2-byte route only the live
        matrices' rows are computed (the others are masked out anyway)."""
        if not per_matrix:
            y = _matmul_f32(As, ev[:, :, None])[:, :, 0]
        else:
            y = torch.zeros(B, As.shape[1], dtype=dtype, device=dev)
            for b in range(B) if live is None else live:
                y[b] = kernels.matvec(As[b], ev[b])
        return y if gathered is None else gathered(y)

    v = products(ev, None) / ev
    lam = torch.zeros(B, dtype=dtype, device=dev)
    rounds = torch.zeros(B, dtype=torch.int32, device=dev)
    live = torch.ones(B, dtype=torch.bool, device=dev)
    for _ in range(max_itr):
        live = live & ~stop_check(v, eps, eps_mode)
        if per_matrix:
            idx = [b for b, on in enumerate(live.tolist()) if on]  # the one read
            if not idx:
                break
        elif not bool(live.any()):  # the one read of the round
            break
        else:
            idx = None
        m = torch.amax(v, 1, keepdim=True)
        ev_next = ev * (v / m)
        lam_next = v[:, 0]
        v_next = products(ev_next, idx) / ev_next
        keep = live[:, None]
        ev = torch.where(keep, ev_next, ev)
        v = torch.where(keep, v_next, v)
        lam = torch.where(live, lam_next, lam)
        rounds = rounds + live.to(torch.int32)
    # the shared epilogue (ops/solver._finish) per matrix: a converged one
    # takes its converging round's ev update and λ
    converged = rounds < max_itr
    m = torch.amax(v, 1, keepdim=True)
    ev = torch.where(converged[:, None], ev * (v / m), ev)
    lam = torch.where(converged, v[:, 0], lam)
    return SolveResult(lam, ev, rounds, converged)


def solve_batched_sharded(
    As,
    mesh,
    axis_name: str = "batch",
    config: SolverConfig = DEFAULT_CONFIG,
) -> SolveResult:
    """Batched solve with the batch sharded over ``axis_name`` of ``mesh``
    (a ``DeviceMesh``): each rank solves its slice with
    :func:`solve_batched`.  ``As`` is the whole batch on every rank (each
    rank takes its slice) or a DTensor sharded over the batch.  Per-matrix
    rounds, flags and values are those of the unsharded batch.  Every
    result is a DTensor whose leading dim is sharded over ``axis_name``."""
    As = _as_tensor(As)
    B = As.shape[0]
    n_shards = require_axis(mesh, axis_name)
    if B % n_shards != 0:
        raise ValueError(f"batch {B} not divisible by {n_shards} shards")
    b_loc = B // n_shards
    b0 = mesh.get_local_rank(axis_name) * b_loc
    local = _local(As, mesh, {axis_name: 0}, (slice(b0, b0 + b_loc),))
    res = solve_batched(local, config.eps, config.max_itr, storage_dtype=config.storage_dtype,
                        eps_mode=config.eps_mode)
    return _batch_result(res, mesh, axis_name)
