"""Checkpoint and resume of an in-flight solve (counterpart of
``eigen_value_tpu.checkpoint``).

The matvec-form solve's state is small and well defined, ``(A₀, ev, v, λ,
rounds, done)``: it can be stepped a bounded number of rounds at a time,
written to disk between steps and resumed bit for bit, so a solve split
across process restarts returns the same eigenvalue, eigenvector and round
count as one solve.  Meant for very large solves (the 65536² bf16 matrix)
and for the pattern ``step → save → (maybe die) → load → step``.

Where a step runs.  On a card whose multiround kernel holds ev (n up to
57856 on an H100) a step is ONE launch of the stripes kernel with ``chunk``
= the step's round count, as ``solve_multiround`` resumes a chunk; past
that it is a host loop over the matvec kernel, the loop of
``solve_matvec_kernel``.  On the CPU the same calls run the plain versions.
Either way chunked stepping is bit-identical to the one-launch solve of
the same route, cap included.  A float64 A steps the ``torch.mv`` loop of
``solve_matvec`` (the kernels take f32 and 2-byte A only).

A sharded A.  A ``DTensor`` A steps as JAX's sharded ``jax.Array`` does
under GSPMD: every call of this module takes it, and a round is the one of
the whole sharded solve (``parallel.sharded.placed_round``), a budget at a
time.  ``Shard(0)`` on a 1-D mesh: the gathered body's round (the rank's
rows against the replicated ev, then one all-gather of v); ``(Shard(0),
Shard(1))`` on a 2-D rows × cols mesh: the 2-D body's round; ``Replicate()``
on every dimension: the rank's local tensor steps as on one card; any other
placement raises.  The O(n) state (ev of length n, v, λ, rounds, done) is
replicated: plain tensors on the rank's device.  Stepped in chunks, a
sharded A gives the bits of the whole sharded solve.

Storage.  A 2-byte A follows the port's storage contract
(``ops/solver_matvec.py``): f32 state, the kernels read A as stored, and a
step is the f32 step of ``A_q.float()``.  JAX's ``_state_matvec`` divides
by a quantized ev instead; the port does not copy it.

The snapshot is an ``.npz`` with the JAX package's fields, so an f32 or f64
snapshot written by either package loads in the other.  numpy has no
bfloat16, so a 2-byte A is written as its raw uint16 bits with its dtype
name beside them: such a snapshot is the port's own.  For a DTensor A the
``.npz`` holds the whole matrix, as JAX's ``np.asarray(state.A)`` gathers
it: every rank takes part in ``A.full_tensor()`` and the rank at the mesh's
origin writes the file.  JAX's Orbax snapshots (sharded, multi-host state)
have their counterpart in ``torch.distributed.checkpoint``
(:func:`save_state_orbax`, :func:`load_state_orbax`, the JAX names): a
directory in which each rank writes its own shards and nothing is
gathered.  The two formats do not read each other.
"""

from __future__ import annotations

import contextlib
import os
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import EPS, MAX_ITR
from .device import multiround_fits, solve_device
from .ops.cuda import kernels
from .ops.solver import SolveResult, _finish
from .ops.solver_matvec import _Carry, _run_rounds


class SolverState(NamedTuple):
    """Resumable state of a matvec-form solve, as tensors on A's device.

    ``A`` is the original matrix (the matvec form never writes it); ``v``
    holds the row sums of the current iterate; ``rounds`` (int32) follows
    the reference's 0-based counting; ``done`` (bool) is set once the stop
    fired, and the converging round's ev update and λ are then applied.
    """

    A: torch.Tensor
    ev: torch.Tensor
    v: torch.Tensor
    lam: torch.Tensor
    rounds: torch.Tensor
    done: torch.Tensor


def _state_dtype(A: torch.Tensor) -> torch.dtype:
    """Dtype of the O(n) state: float32 for a 2-byte A (bf16 cannot hold
    the 1e-3 stop at λ-scale values), else A's own."""
    return torch.float32 if A.dtype.itemsize < 4 else A.dtype


def _product(A: torch.Tensor):
    """``A @ x`` of a step's host loop: the matvec kernel (its plain version
    on the CPU) for the dtypes the kernels read, ``torch.mv`` for any other."""
    return kernels.matvec if A.dtype in kernels._ELEM else kernels.matvec_plain


def _one_launch(A: torch.Tensor) -> bool:
    """Whether a step is one launch of the stripes kernel: A is a dtype it
    reads, and on a card its ev copy fits one block's shared memory."""
    if A.dtype not in kernels._ELEM:
        return False
    return A.device.type != "cuda" or multiround_fits(A.shape[0], A.device)


def _is_dtensor(A) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(A, DTensor)


def _route(A):
    """How a step reads A: ``(M, next_v)``.  ``next_v(ev)`` is a round's
    ``(A @ ev) / ev``, replicated; ``M`` is the tensor a single-card step
    runs on (A itself, or the local tensor of a DTensor replicated on every
    mesh dimension), None for a sharded DTensor, whose round is the sharded
    body's (``parallel.sharded.placed_round``, which also refuses any other
    placement)."""
    if _is_dtensor(A):
        from .parallel.sharded import placed_round

        next_v, local = placed_round(A)
        if next_v is not None:
            return None, next_v
        A = local
    product = _product(A)
    return A, lambda ev: product(A, ev) / ev


def _state_device(A) -> torch.device:
    """Where the O(n) state lives: A's device, a DTensor's local one."""
    return A.to_local().device if _is_dtensor(A) else A.device


def _as_matrix(A) -> torch.Tensor:
    """A as a contiguous square tensor on its own device (host input goes to
    the card, as in the API).  A tensor that already is one is returned as
    it is, so ``state.A`` aliases the caller's matrix; a misaligned one is
    cloned (the kernels read rows in aligned chunks).  A DTensor is
    returned as it is once its placement is one a step takes."""
    if _is_dtensor(A):
        if A.dim() != 2 or A.shape[0] != A.shape[1]:
            raise ValueError(f"must be a square matrix, got shape {tuple(A.shape)}")
        _route(A)  # raises on a placement a step does not take
        return A
    if not isinstance(A, torch.Tensor):
        A = torch.tensor(np.asarray(A), device=solve_device(None, A))
    if A.dim() != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"must be a square matrix, got shape {tuple(A.shape)}")
    A = A.contiguous()
    return A.clone() if A.data_ptr() % 16 else A


def init_state(A, donate: bool = False) -> SolverState:
    """Start a solve: ev = 1, v = the row sums of A (``kernels.matvec(A,
    ones) / ones``, the first product of ``solve_matvec_kernel``).

    ``donate`` keeps the JAX signature.  It has nothing to do here:
    ``state.A`` is the caller's tensor itself (never copied, never
    written), so a solve holds one A whatever it says."""
    del donate
    A = _as_matrix(A)
    n, dt, dev = A.shape[0], _state_dtype(A), _state_device(A)
    ev0 = torch.ones(n, dtype=dt, device=dev)
    v0 = _route(A)[1](ev0)
    return SolverState(
        A,
        ev0,
        v0,
        torch.zeros((), dtype=dt, device=dev),
        torch.zeros((), dtype=torch.int32, device=dev),
        torch.zeros((), dtype=torch.bool, device=dev),
    )


def step(
    state: SolverState, num_rounds: int, eps: float = EPS, max_itr: int = MAX_ITR
) -> SolverState:
    """Advance the solve by at most ``num_rounds`` rounds; a state that is
    ``done`` or at ``max_itr`` is returned with no launch.  Each of the
    rounds checks the stop before advancing (the one that finds it counts
    among the ``num_rounds``, as in JAX), so stepping in chunks of k then
    k′ is bit-identical to one chunk of k + k′.

    On the one-launch route the kernel freezes where the stop fires or the
    budget ends; a launch that advanced fewer rounds than it had, with
    budget left, found the stop, and the converging round's update is then
    applied here with ``solver._finish``'s expression (same bits).  Every
    other route runs ``solver_matvec._run_rounds`` over its round: the
    matvec kernel loop, or a sharded A's body (see the module's
    docstring)."""
    rounds = int(state.rounds)
    if bool(state.done) or rounds >= max_itr or num_rounds < 1:
        return state
    M, next_v = _route(state.A)
    dev = state.v.device
    if M is not None and _one_launch(M):
        ev, v, adv, lam = kernels.multiround(
            M, state.ev, state.v, state.lam, max_itr - rounds,
            chunk=num_rounds, eps=eps, init=False,
        )
        adv = int(adv)
        i = rounds + adv
        done = adv < num_rounds and i < max_itr
        if done:
            m = torch.max(v)
            ev, lam = ev * (v / m), v[0]
    else:
        c, done = _run_rounds(next_v, _Carry(state.ev, state.v, state.lam, rounds), eps,
                              max_itr, budget=num_rounds)
        ev, v, lam, i = c
        if done:
            lam, ev = _finish(c, max_itr)[:2]
    return SolverState(
        state.A, ev, v, lam,
        torch.tensor(i, dtype=torch.int32, device=dev),
        torch.tensor(done, device=dev),
    )


def to_result(state: SolverState) -> SolveResult:
    """The state as the public result."""
    return SolveResult(state.lam, state.ev, state.rounds, state.done)


def solve_checkpointed(
    A,
    chunk_rounds: int = 8,
    checkpoint_path: Optional[str] = None,
    eps: float = EPS,
    max_itr: int = MAX_ITR,
    donate: bool = False,
) -> SolveResult:
    """A whole solve in ``chunk_rounds``-round steps, writing an ``.npz``
    snapshot after every step when ``checkpoint_path`` is given (the
    preemption-tolerant loop).  An existing snapshot at that path is
    resumed, after checking that it was taken for this matrix (shape, dtype
    and a full-content digest, :func:`_matrix_digest`) and under this
    ``eps``; a stale snapshot or another tolerance raises instead of
    returning a wrong result.  ``donate``: see :func:`init_state`."""
    if chunk_rounds < 1:
        # a 0-round step would be a no-op and spin this loop forever
        raise ValueError(f"chunk_rounds must be >= 1, got {chunk_rounds}")
    A = _as_matrix(A)
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        state, saved_eps = load_state(checkpoint_path, with_eps=True, device=_state_device(A))
        _check_same_matrix(state.A, A, checkpoint_path)
        if saved_eps is not None and saved_eps != eps:
            raise ValueError(
                f"checkpoint {checkpoint_path!r} was written by a solve with "
                f"eps={saved_eps!r} but this resume uses eps={eps!r} — "
                "mixing stop tolerances across chunks corrupts the round "
                "count; pass the original eps or a fresh checkpoint_path"
            )
        state = state._replace(A=A)  # the same bits, held once
    else:
        state = init_state(A, donate=donate)
    while not bool(state.done) and int(state.rounds) < max_itr:
        state = step(state, chunk_rounds, eps, max_itr)
        if checkpoint_path is not None:
            save_state(checkpoint_path, state, eps=eps)
    return to_result(state)


_MASK = (1 << 32) - 1


def _mul32(a: torch.Tensor, k: int) -> torch.Tensor:
    """``a * k mod 2³²`` for int64 ``a`` in [0, 2³²) and a constant ``k <
    2³²``, with no product past 2⁴⁹ (int64 never overflows)."""
    lo = (a & 0xFFFF) * k
    hi = ((a >> 16) * k) & 0xFFFF
    return (lo + (hi << 16)) & _MASK


def _matrix_digest(A: torch.Tensor) -> torch.Tensor:
    """Bit-level content digest of a matrix, the JAX package's value for
    value (f32, f64, bf16, f16): the element bits (an f64 as two uint32
    words, low first; a 2-byte element widened), xor the position index
    times 2654435761, times 2246822519, summed, all mod 2³².  Returns a 0-d
    int64 tensor on A's device (a DTensor's local one).

    Sums mod 2³² are exact in any order, so a sharded DTensor's digest is
    each rank's block digested at its global positions, the ranks' values
    added by an integer all-reduce over each dimension that shards it."""
    if not _is_dtensor(A):
        return _block_digest(A, 0, 0, A.shape[1])
    from .parallel._collectives import all_reduce_sum_int
    from .parallel.sharded import placed_block

    local, row0, col0, dims = placed_block(A)
    total = _block_digest(local, row0, col0, A.shape[1])
    for d in dims:
        total = all_reduce_sum_int(total, A.device_mesh.get_group(d)) & _MASK
    return total


def _block_digest(A: torch.Tensor, row0: int, col0: int, width: int) -> torch.Tensor:
    """The digest's sum over the block ``A`` of a matrix ``width`` elements
    wide whose first element sits at (``row0``, ``col0``), mod 2³², on A's
    device a block of rows at a time in int64 masked to 32 bits, never
    holding more than ``kernels.PLAIN_BLOCK_BYTES`` of int64 a temporary."""
    words = 2 if A.dtype.itemsize == 8 else 1
    if words == 2:
        bits = A.reshape(A.shape[0], -1).view(torch.int32)
    elif A.dtype.itemsize == 2:
        bits = A.view(torch.int16)
    else:
        bits = A.view(torch.int32)
    rows, cols = bits.shape
    keep = (1 << (8 * bits.element_size())) - 1
    col_key = _mul32(torch.arange(words * col0, words * col0 + cols, device=A.device),
                     2654435761)
    block = max(1, kernels.PLAIN_BLOCK_BYTES // (8 * max(cols, 1)))
    total = torch.zeros((), dtype=torch.int64, device=A.device)
    for r in range(0, rows, block):
        r_idx = torch.arange(row0 + r, row0 + min(r + block, rows), device=A.device)
        row_key = _mul32((r_idx * (words * width)) & _MASK, 2654435761)
        key = (row_key[:, None] + col_key[None, :]) & _MASK
        b = bits[r:r + block].to(torch.int64) & keep
        total = (total + _mul32(b ^ key, 2246822519).sum()) & _MASK
    return total


def _check_same_matrix(saved: torch.Tensor, given, path: str) -> None:
    """Identity check between a snapshot's matrix and the caller's: shape,
    dtype and the full-content digest (one read of each, once per
    resume)."""
    if not isinstance(given, torch.Tensor):
        given = torch.as_tensor(np.asarray(given))
    if saved.shape != given.shape or saved.dtype != given.dtype:
        raise ValueError(
            f"checkpoint {path!r} holds a {saved.dtype} {tuple(saved.shape)} matrix "
            f"but the solve was called with {given.dtype} {tuple(given.shape)}"
        )
    if int(_matrix_digest(saved)) != int(_matrix_digest(given)):
        raise ValueError(
            f"checkpoint {path!r} was created for a different matrix "
            "(content digest differs) — pass a fresh checkpoint_path"
        )


# ---------------------------------------------------------------- storage

_FIELDS = SolverState._fields
#: The 2-byte dtypes, written as their uint16 bits under ``_A_dtype``.
_BITS = {torch.bfloat16: "bfloat16", torch.float16: "float16"}


def save_state(path: str, state: SolverState, eps: Optional[float] = None) -> None:
    """Write the state to one ``.npz`` (a temporary file, then
    ``os.replace``: a reader never sees half a snapshot).  ``eps`` records
    the stop tolerance, so that a resume under another one is rejected.

    A DTensor A is gathered whole (``full_tensor()``: every rank of its
    mesh calls this), the rank at the mesh's origin writes the file, and
    every rank waits for it, so that no rank resumes from an older
    snapshot."""
    if _is_dtensor(state.A):
        mesh = state.A.device_mesh
        full = state.A.full_tensor()
        if all(mesh.get_local_rank(d) == 0 for d in range(mesh.ndim)):
            save_state(path, state._replace(A=full), eps)
        del full
        for d in range(mesh.ndim):  # in order: each waits for the origin's write
            torch.distributed.barrier(group=mesh.get_group(d))
        return
    arrs = {k: t.detach().cpu() for k, t in zip(_FIELDS, state)}
    if state.A.dtype in _BITS:
        arrs["_A_dtype"] = np.asarray(_BITS[state.A.dtype])
        arrs["A"] = arrs["A"].view(torch.int16).numpy().view(np.uint16)
    arrs = {k: np.asarray(a) for k, a in arrs.items()}
    if eps is not None:
        arrs["_eps"] = np.asarray(float(eps), np.float64)
    tmp = f"{path}.tmp.{os.getpid()}.npz"  # np.savez appends .npz otherwise
    np.savez(tmp, **arrs)
    os.replace(tmp, path)


def load_state(path: str, with_eps: bool = False, device=None):
    """Load a snapshot written by :func:`save_state` (of either package) onto
    ``device`` (default: the CUDA card; ``"cpu"`` asks for the CPU).
    ``with_eps=True`` also returns the recorded stop tolerance (None for a
    snapshot that has none)."""
    dev = solve_device(device)
    with np.load(path) as z:
        arrs = {k: z[k] for k in _FIELDS}
        if "_A_dtype" in z.files:
            dt = {v: k for k, v in _BITS.items()}[str(z["_A_dtype"][()])]
            arrs["A"] = torch.from_numpy(arrs["A"].view(np.int16)).view(dt)
        eps = float(z["_eps"][()]) if "_eps" in z.files else None
    state = SolverState(*(torch.as_tensor(arrs[k]).to(dev) for k in _FIELDS))
    return (state, eps) if with_eps else state


def save_state_orbax(path: str, state: SolverState) -> None:
    """Snapshot through ``torch.distributed.checkpoint`` (the counterpart of
    JAX's Orbax snapshot): ``path`` becomes a directory in which every rank
    writes its own shards of the state's tensors, DTensors included, and
    nothing is gathered.  With no process group running, one process
    writes it all.  An existing snapshot at ``path`` is overwritten."""
    import torch.distributed.checkpoint as dcp

    with _one_process_ok():
        dcp.save(dict(state._asdict()),
                 storage_writer=dcp.FileSystemWriter(os.path.abspath(path), overwrite=True))


def load_state_orbax(path: str, template: SolverState) -> SolverState:
    """Restore a :func:`save_state_orbax` snapshot.  ``template`` gives the
    shapes, dtypes, devices and placements (a freshly built state, e.g.
    ``init_state`` of the same matrix); it is not written."""
    import torch.distributed.checkpoint as dcp

    target = {k: v.clone() for k, v in template._asdict().items()}
    with _one_process_ok():
        dcp.load(target, checkpoint_id=os.path.abspath(path))
    return SolverState(**target)


@contextlib.contextmanager
def _one_process_ok():
    """Silence ``torch.distributed.checkpoint``'s notices that it runs in
    one process when no group is running and that it overwrites an
    existing snapshot: both are the intended use here."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        warnings.filterwarnings("ignore", message="Detected an existing checkpoint")
        yield
