"""Row-partitioned and block-partitioned solves over a ``DeviceMesh``
(counterpart of ``eigen_value_tpu.parallel.sharded``).

The mesh has named dimensions where JAX's has named axes; each rank of
``torch.distributed`` is one device of it.  Design, as in JAX:

  * A is sharded along rows: the rank at coordinate p of the ``rows``
    dimension holds rows ``[p·n/P, (p+1)·n/P)``.  Every row is complete
    locally, so a rank's row sums need no collective.
  * The one exchanged object is O(n): the gathered body all-gathers v
    each round, the ring rotates ev chunks through P − 1 hops, the 2-D
    body sums its column partials and gathers v along rows.
  * max, stop and λ are computed on every rank from the replicated v (or,
    in the ring, combined by exact all-reduces), so every rank of a group
    takes the same branch each round and the loops run in lockstep.

A solve takes a whole matrix on every rank (each rank slices its own rows
or block, :func:`_validate_and_place`) or a ``DTensor`` that
``multihost.assemble_*`` built.  The rounds run on the ranks' local
tensors with the explicit collectives of ``_collectives.py``; no round
runs on DTensor operations, whose implicit redistributions would hide what
a round exchanges.  The eigenvector comes back as a ``DTensor``:
``Shard(0)`` over the row dimension, replicated over the others (JAX's
``out_specs=P(axis_name)``); λ, rounds and converged are plain tensors,
equal on every rank.

The local product is ``kernels.matvec`` (its plain version on a CPU mesh):
the gathered body's, the ring's chunk products (column blocks of the row
block, read in place through the kernel's leading dimension), the 2-D
body's block product.  Each body at P = 1 is therefore the single-card
matvec kernel loop, bit for bit.  The storage contract is the one of the
whole port (``ops/solver_matvec.py``): the local block is cast once to
``storage_dtype`` (or used as it is when already in it), the kernel reads
it in 2 bytes and multiplies it with the f32 ev, and all O(n) state is
f32.  JAX's quantized-operand bodies are not followed.

Unlike JAX, the port never falls back to the CPU: a CUDA mesh that cannot
be built raises, and a CPU mesh is built only when asked for
(``device_type="cpu"``).  The host reads one flag per round, as every
loop of the port does; the flag is the same on every rank of a group.
"""

from __future__ import annotations

import os
import socket
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..config import DEFAULT_CONFIG, SolverConfig
from ..ops.cuda import kernels
from ..ops.solver import SolveResult, _finish, stop_check
from ..ops.solver_matvec import _init_carry, _run_rounds, _stored
from ._collectives import (
    all_gather,
    all_reduce_max,
    ppermute,
    ppermute_start,
    sum_in_order,
)


def _axes(mesh: DeviceMesh) -> tuple:
    """The mesh's dimension names (none for an object that is no mesh)."""
    return tuple(getattr(mesh, "mesh_dim_names", None) or ())


def require_axis(mesh: DeviceMesh, axis_name: str) -> int:
    """The size of ``axis_name`` in ``mesh``, with a descriptive error when
    the dimension is absent."""
    if axis_name not in _axes(mesh):
        raise ValueError(
            f"mesh has no '{axis_name}' axis (axes: {_axes(mesh)}) — "
            "build it with make_row_mesh/make_global_row_mesh or pass the "
            "axis_name your mesh actually uses"
        )
    return mesh.size(_axes(mesh).index(axis_name))


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device of ``mesh``: its card on a CUDA mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _placements(mesh: DeviceMesh, shards: dict) -> list:
    """One placement per mesh dimension: ``Shard(d)`` for the dimensions
    named in ``shards`` (name -> tensor dim), ``Replicate()`` elsewhere."""
    return [Shard(shards[a]) if a in shards else Replicate() for a in _axes(mesh)]


def _local(A, mesh: DeviceMesh, shards: dict, blocks) -> torch.Tensor:
    """This rank's block of A on its device of ``mesh``.  A ``DTensor``
    must be placed on ``mesh`` as ``shards`` says and gives its local
    tensor; a whole tensor on every rank gives the slice ``blocks`` (one
    ``slice`` per tensor dim), a view.  A block whose address is not
    16-byte aligned is copied: the kernel reads rows in aligned chunks."""
    if isinstance(A, DTensor):
        want = _placements(mesh, shards)
        if A.device_mesh != mesh or list(A.placements) != want:
            raise ValueError(
                f"a DTensor input must lie on the solve's mesh with placements {want}, got "
                f"{list(A.placements)} on {A.device_mesh}"
            )
        local = A.to_local()
    else:
        local = A[blocks]
    local = local.to(_mesh_device(mesh))
    return local.clone(memory_format=torch.contiguous_format) if local.data_ptr() % 16 else local


def _as_tensor(A):
    return A if isinstance(A, torch.Tensor) else torch.as_tensor(A)


def _validate_and_place(A, mesh: DeviceMesh, axis_name: str):
    """Shared entry prologue of the 1-D row-sharded solves: a square 2-D A,
    the dimension's size, divisibility, and this rank's rows.  Returns
    ``(A_local, n, n_shards)``."""
    A = _as_tensor(A)
    if A.dim() != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"must be a square matrix, got shape {tuple(A.shape)}")
    n = A.shape[0]
    n_shards = require_axis(mesh, axis_name)
    if n % n_shards != 0:
        raise ValueError(f"dim {n} not divisible by {n_shards} shards")
    n_loc = n // n_shards
    row0 = mesh.get_local_rank(axis_name) * n_loc
    local = _local(A, mesh, {axis_name: 0}, (slice(row0, row0 + n_loc),))
    return local, n, n_shards


def _reject_sharded_unsupported(
    config: SolverConfig, entry: str, *, storage_ok: bool = True
) -> None:
    """Honor-or-reject for direct calls into the sharded entries, with the
    JAX package's words.  The matvec-family bodies honor
    ``storage_dtype``; the iterated body (``storage_ok=False``) cannot."""
    checks = [
        ("symmetric", not config.symmetric,
         "the upper-triangle kernel is single-chip (its round state "
         "lives in one chip's VMEM scratch)"),
        ("chunk", config.chunk is None,
         "the multiround kernel is single-chip only"),
        ("cache_tiles", config.cache_tiles is None,
         "the VMEM-resident tile cache is a single-chip multiround "
         "feature"),
        ("block_rows", config.block_rows is None,
         "the sharded Pallas path sizes its own tiles per shard"),
        ("block_cols", config.block_cols is None,
         "the sharded Pallas path sizes its own tiles per shard"),
        ("interpret", config.interpret is None,
         "interpret auto-resolves from the mesh's platform"),
    ]
    if not storage_ok:
        checks.append(
            ("storage_dtype", config.storage_dtype is None,
             "the iterated body mutates A and cannot honor the storage "
             "contract"),
        )
    for knob, is_default, why in checks:
        if not is_default:
            raise ValueError(
                f"{knob}={getattr(config, knob)!r} is not supported by "
                f"{entry} — {why}; it would be silently dropped"
            )


def _rows_result(res: SolveResult, mesh: DeviceMesh, axis_name: str) -> SolveResult:
    """``res`` with its local eigenvector as a DTensor sharded over
    ``axis_name`` (JAX's ``out_specs=SolveResult(P(), P(axis), P(), P())``)."""
    ev = DTensor.from_local(res.eigenvector, mesh, _placements(mesh, {axis_name: 0}),
                            run_check=False)
    return res._replace(eigenvector=ev)


def _ev0(n: int, dtype, device, ev0_scale) -> torch.Tensor:
    """The start vector: ones times ``ev0_scale`` (scale-invariant; 1.0
    gives the single-card start bit for bit)."""
    return torch.full((n,), float(ev0_scale), dtype=dtype, device=device)


def _replicated_loop(next_v, n: int, dtype, device, eps, max_itr, eps_mode, ev0_scale):
    """The single-card matvec-form rounds (``solver_matvec._run_rounds``,
    ``_init_carry``, ``solver._finish``) over a ``next_v`` whose v is
    replicated: the gathered and 2-D bodies.  ``checkpoint.step`` runs the
    same rounds over the same ``next_v`` a budget at a time
    (:func:`placed_round`)."""
    c = _init_carry(n, next_v, dtype, device, _ev0(n, dtype, device, ev0_scale))
    return _finish(_run_rounds(next_v, c, eps, max_itr, eps_mode)[0], max_itr)


def _rows_next_v(Aq: torch.Tensor, group, row0: int, product=kernels.matvec):
    """The gathered body's round: the rank's rows (from global row
    ``row0``) against the replicated ev, divided by ev's slice of those
    rows, then v gathered in rank order."""
    n_loc = Aq.shape[0]

    def next_v(ev):
        return all_gather(product(Aq, ev) / ev[row0:row0 + n_loc], group)

    return next_v


def _blocks_next_v(Aq: torch.Tensor, row_group, col_group, row0: int, col0: int):
    """The 2-D body's round on the block at (``row0``, ``col0``): the block
    product against ev's column chunk, the column partials added in column
    order, divided by ev's row chunk, then v gathered along rows."""
    n_r, n_c = Aq.shape

    def next_v(ev):
        y = sum_in_order(kernels.matvec(Aq, ev[col0:col0 + n_c]), col_group)
        return all_gather(y / ev[row0:row0 + n_r], row_group)

    return next_v


def placed_block(A: DTensor) -> tuple:
    """This rank's block of a DTensor ``A`` as a round reads it:
    ``(local, row0, col0, dims)``, the local tensor (aligned, on the rank's
    device), its global offsets, and the mesh dimensions that shard it.

    ``Shard(0)`` on a 1-D mesh is a row block, ``(Shard(0), Shard(1))`` on a
    2-D mesh a rows × cols block, ``Replicate()`` on every dimension the
    whole matrix (no dimension shards it).  Any other placement raises, as
    does a dimension of A that the mesh does not divide."""
    mesh, pl = A.device_mesh, tuple(A.placements)
    if all(isinstance(q, Replicate) for q in pl):
        dims = ()
    elif pl in ((Shard(0),), (Shard(0), Shard(1))):
        dims = tuple(range(len(pl)))
    else:
        raise ValueError(
            f"a DTensor A placed as {pl} on a {mesh.ndim}-D mesh: a step takes Shard(0) on "
            "a 1-D mesh, (Shard(0), Shard(1)) on a 2-D rows x cols mesh, or Replicate() on "
            "every dimension"
        )
    offs = [0, 0]
    for d in dims:
        size = mesh.size(d)
        if A.shape[d] % size != 0:
            raise ValueError(f"dim {A.shape[d]} not divisible by {size} shards")
        offs[d] = mesh.get_local_rank(d) * (A.shape[d] // size)
    local = A.to_local().to(_mesh_device(mesh)).contiguous()
    if local.data_ptr() % 16:
        local = local.clone()
    return local, offs[0], offs[1], dims


def placed_round(A: DTensor):
    """The round of a sharded DTensor ``A`` (:func:`placed_block`): the
    gathered body's for a row block, the 2-D body's for a rows × cols
    block, over the block as stored (a 2-byte block is read in 2 bytes, the
    state is f32).  Returns ``(next_v, local)``, ``next_v`` None for an A
    replicated on every dimension, whose local tensor steps as on one
    card."""
    local, row0, col0, dims = placed_block(A)
    mesh = A.device_mesh
    if not dims:
        return None, local
    if len(dims) == 1:
        return _rows_next_v(local, mesh.get_group(0), row0), local
    return _blocks_next_v(local, mesh.get_group(0), mesh.get_group(1), row0, col0), local


def _shard_round_body(A_blk: torch.Tensor, group, p: int, eps: float, max_itr: int,
                      eps_mode: str = "absolute") -> SolveResult:
    """The iterated (mutate-A) loop on one rank's row block: row sums,
    gathered to the full v, then each round the similarity update of the
    block (its rows scaled by 1/v[rows], its columns by v) fused with the
    next row sums, in the plain PyTorch ops of the single-card "xla" solve
    (``kernels.scale_plain``, ``kernels.rowsum_plain``).  The caller's
    block is never written: round 0 writes a new buffer, later rounds
    update it in place."""
    n_loc, n = A_blk.shape
    dtype, dev = A_blk.dtype, A_blk.device
    row0 = p * n_loc
    one = torch.ones((), dtype=dtype, device=dev)
    A = A_blk
    v = all_gather(kernels.rowsum_plain(A), group)
    ev = torch.ones(n_loc, dtype=dtype, device=dev)
    lam = torch.zeros((), dtype=dtype, device=dev)
    i = 0
    while i < max_itr and not bool(stop_check(v, eps, eps_mode)):
        m = torch.max(v)
        v_rows = v[row0:row0 + n_loc]
        ev = ev * (v_rows / m)
        lam = v[0]
        A = torch.mul(A, (one / v_rows)[:, None] * v[None, :], out=None if i == 0 else A)
        v = all_gather(kernels.rowsum_plain(A), group)
        i += 1
    converged = i < max_itr
    if converged:
        ev, lam = ev * (v[row0:row0 + n_loc] / torch.max(v)), v[0]
    return SolveResult(lam, ev, torch.tensor(i, dtype=torch.int32, device=dev),
                       torch.tensor(converged, device=dev))


def solve_sharded(
    A,
    mesh: DeviceMesh,
    axis_name: str = "rows",
    config: SolverConfig = DEFAULT_CONFIG,
) -> SolveResult:
    """Row-partitioned iterated solve of one n×n positive matrix over
    ``mesh`` (the sharded form of the single-card ``backend="xla"``).

    n must be divisible by the dimension's size.  Returns the single-card
    :class:`SolveResult`, with the eigenvector a DTensor sharded over rows.
    """
    _reject_sharded_unsupported(config, "solve_sharded", storage_ok=False)
    A_loc, _, _ = _validate_and_place(A, mesh, axis_name)
    res = _shard_round_body(A_loc, mesh.get_group(axis_name), mesh.get_local_rank(axis_name),
                            config.eps, config.max_itr, config.eps_mode)
    return _rows_result(res, mesh, axis_name)


def _shard_matvec_body(A_blk: torch.Tensor, group, p: int, eps: float, max_itr: int,
                       use_kernel: bool = True, storage_dtype=None,
                       eps_mode: str = "absolute", ev0_scale=1.0) -> SolveResult:
    """The matvec-form loop on one rank's row block: each round one local
    product against the original rows and one O(n) all-gather of v.  v is
    replicated, so the round is the single-card round, and the result's
    eigenvector is this rank's slice.  ``use_kernel`` False takes
    ``torch.mv`` in true f32 (JAX's ``use_pallas=False``, ``dot_f32``)."""
    n_loc, n = A_blk.shape
    Aq, dtype = _stored(A_blk, storage_dtype)
    row0 = p * n_loc
    next_v = _rows_next_v(Aq, group, row0, kernels.matvec if use_kernel else kernels.matvec_plain)
    res = _replicated_loop(next_v, n, dtype, Aq.device, eps, max_itr, eps_mode, ev0_scale)
    return res._replace(eigenvector=res.eigenvector[row0:row0 + n_loc].clone())


def solve_sharded_matvec(
    A,
    mesh: DeviceMesh,
    axis_name: str = "rows",
    config: SolverConfig = DEFAULT_CONFIG,
    use_pallas: Optional[bool] = None,
    ev0_scale: float = 1.0,
) -> SolveResult:
    """Row-partitioned matvec-form solve: the production multi-card path.

    ``use_pallas`` (JAX's name; default on) runs the local product as the
    matvec kernel (its plain version on a CPU mesh); False takes
    ``torch.mv`` in true f32.  ``config.storage_dtype`` is honored by the
    port's storage contract: the local block is cast once (or used as it is
    when already in it), the kernel reads it in 2 bytes, the O(n) state is
    f32.  ``config.eps_mode`` is honored with the single-card semantics.
    """
    _reject_sharded_unsupported(config, "solve_sharded_matvec")
    A_loc, _, _ = _validate_and_place(A, mesh, axis_name)
    res = _shard_matvec_body(
        A_loc, mesh.get_group(axis_name), mesh.get_local_rank(axis_name), config.eps,
        config.max_itr, use_pallas is not False, config.storage_dtype, config.eps_mode,
        ev0_scale,
    )
    return _rows_result(res, mesh, axis_name)


def _shard_matvec_ring_body(A_blk: torch.Tensor, group, p: int, n_shards: int, eps: float,
                            max_itr: int, storage_dtype=None, eps_mode: str = "absolute",
                            ev0_scale=1.0) -> SolveResult:
    """The matvec-form loop with ring communication: nothing is gathered.
    The eigenvector stays sharded, and each round's product runs as P chunk
    products ``A_blk[:, src·n_loc:(src+1)·n_loc] @ ev_src`` (column blocks
    read in place by the kernel's leading dimension) while the ev chunks
    hop around the ring: each hop starts before the product of the chunk it
    sends and is waited for after it, so the wire time hides behind the
    product.  P − 1 hops: the last chunk is consumed where it lands.

    The partials are kept by source index and added in source order
    (``parts[0] + parts[1] + …``), so the order of the sums, and the
    round count, is the same on every rank (deterministic for a given P;
    across P the grouping into P partials changes the f32 rounding, the
    ±1-round slack JAX's docstring states).  At P = 1 it is the single-card
    matvec kernel loop, bit for bit.

    v stays sharded, so the stop, max and λ are collective forms, carried
    by one MAX all-reduce a round of (not ok, local max, λ): the wraparound
    stop on local slices (the next rank's first element by one hop), the
    max of v, and λ = v[0], offered by rank 0 while every other rank offers
    −inf; a max is exact in any order.  The relative stop needs the global
    max|v| before the verdict: one more MAX all-reduce a round."""
    n_loc, n = A_blk.shape
    Aq, dtype = _stored(A_blk, storage_dtype)
    dev = Aq.device
    perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    back = [((i + 1) % n_shards, i) for i in range(n_shards)]
    no_lam = torch.tensor(float("-inf"), dtype=dtype, device=dev)
    if eps_mode not in ("absolute", "relative"):
        raise ValueError(f"eps_mode must be 'absolute' or 'relative', got {eps_mode!r}")

    def ring_matvec(ev_loc):
        parts = [None] * n_shards
        chunk = ev_loc
        for s in range(n_shards):
            src = (p - s) % n_shards  # the owner of the chunk now held
            hop = ppermute_start(chunk, perm, group) if s < n_shards - 1 else None
            parts[src] = kernels.matvec(Aq[:, src * n_loc:(src + 1) * n_loc], chunk)
            if hop is not None:
                chunk = hop.wait()
        acc = parts[0]
        for q in parts[1:]:
            acc = acc + q
        return acc

    def next_v(ev_loc):
        return ring_matvec(ev_loc) / ev_loc

    def scalars(v_loc):
        """``(stop, m, λ)`` of v: the stop a host bool (the round's one
        read), m and λ 0-d tensors on the device."""
        e = torch.tensor(eps, dtype=dtype)  # a 0-d CPU tensor acts as a scalar
        if eps_mode == "relative":
            e = e * all_reduce_max(v_loc.abs().amax(), group)
        first_of_next = ppermute(v_loc[:1], back, group)[0]
        ok = ((v_loc[1:] - v_loc[:-1]).abs() < e).all() & ((first_of_next - v_loc[-1]).abs() < e)
        out = all_reduce_max(torch.stack([(~ok).to(dtype), torch.max(v_loc),
                                          v_loc[0] if p == 0 else no_lam]), group)
        return not bool(out[0]), out[1], out[2]

    ev = _ev0(n_loc, dtype, dev, ev0_scale)
    v = next_v(ev)
    lam = torch.zeros((), dtype=dtype, device=dev)
    i = 0
    stop, m, lam_v = scalars(v)
    while i < max_itr and not stop:
        lam = lam_v
        ev = ev * (v / m)
        v = next_v(ev)
        i += 1
        if i < max_itr:
            stop, m, lam_v = scalars(v)
    converged = i < max_itr
    if converged:
        ev, lam = ev * (v / m), lam_v
    return SolveResult(lam, ev, torch.tensor(i, dtype=torch.int32, device=dev),
                       torch.tensor(converged, device=dev))


def solve_sharded_matvec_ring(
    A,
    mesh: DeviceMesh,
    axis_name: str = "rows",
    config: SolverConfig = DEFAULT_CONFIG,
    ev0_scale: float = 1.0,
) -> SolveResult:
    """Row-partitioned matvec-form solve with ring communication (no
    all-gather; ev chunks hop through P − 1 point-to-point exchanges,
    overlapped with the chunk products).  Preferred over
    :func:`solve_sharded_matvec` where the per-round gather's latency is
    visible.  ``config.storage_dtype`` and ``config.eps_mode`` are honored
    (the relative stop costs one more scalar all-reduce a round).  On a CUDA
    mesh the hops need NCCL: over gloo they raise."""
    _reject_sharded_unsupported(config, "solve_sharded_matvec_ring")
    A_loc, _, n_shards = _validate_and_place(A, mesh, axis_name)
    res = _shard_matvec_ring_body(
        A_loc, mesh.get_group(axis_name), mesh.get_local_rank(axis_name), n_shards,
        config.eps, config.max_itr, config.storage_dtype, config.eps_mode, ev0_scale,
    )
    return _rows_result(res, mesh, axis_name)


def solve_batched_rowsharded(
    As,
    mesh: DeviceMesh,
    batch_axis: str = "batch",
    row_axis: str = "rows",
    config: SolverConfig = DEFAULT_CONFIG,
) -> SolveResult:
    """Batched solve on a 2-D mesh: the batch sharded over ``batch_axis``,
    each matrix's rows over ``row_axis``.

    Each rank runs the batched masked loop (``parallel/batched.py``) on its
    local batch with the gathered body's exchange: one all-gather of the
    products along ``row_axis`` a round.  v is replicated along rows, so
    the live mask and the host's one read a round agree across a row
    group; batch shards never exchange and each ends on its own (JAX's
    globally masked loop gives the same per-matrix results).  Per-matrix
    round counts are preserved.  ``config.storage_dtype`` and
    ``config.eps_mode`` apply per matrix.  Every result is a DTensor whose
    leading dim is sharded over ``batch_axis``; the eigenvectors' second
    dim over ``row_axis``.
    """
    from .batched import _solve_masked

    _reject_sharded_unsupported(config, "solve_batched_rowsharded")
    As = _as_tensor(As)
    if As.dim() != 3 or As.shape[1] != As.shape[2]:
        raise ValueError(f"expected (B, n, n), got {tuple(As.shape)}")
    B, n, _ = As.shape
    pb, pr = require_axis(mesh, batch_axis), require_axis(mesh, row_axis)
    if B % pb != 0:
        raise ValueError(f"batch {B} not divisible by {pb} shards")
    if n % pr != 0:
        raise ValueError(f"dim {n} not divisible by {pr} shards")
    b_loc, n_loc = B // pb, n // pr
    b0 = mesh.get_local_rank(batch_axis) * b_loc
    row0 = mesh.get_local_rank(row_axis) * n_loc
    local = _local(As, mesh, {batch_axis: 0, row_axis: 1},
                   (slice(b0, b0 + b_loc), slice(row0, row0 + n_loc)))
    group = mesh.get_group(row_axis)

    def gathered(y):  # (b, n_loc) -> (b, n), the rows in rank order
        return all_gather(y.T.contiguous(), group).T

    res = _solve_masked(local, n, config.eps, config.max_itr, config.storage_dtype,
                        config.eps_mode, gathered=gathered)
    res = res._replace(eigenvector=res.eigenvector[:, row0:row0 + n_loc].contiguous())
    return _batch_result(res, mesh, batch_axis, row_axis)


def _batch_result(res: SolveResult, mesh: DeviceMesh, batch_axis: str,
                  row_axis: Optional[str] = None) -> SolveResult:
    """A batched result as DTensors: every leading dim sharded over
    ``batch_axis``, the eigenvectors' second over ``row_axis``."""
    lead = _placements(mesh, {batch_axis: 0})
    ev = _placements(mesh, {batch_axis: 0, **({row_axis: 1} if row_axis else {})})
    return SolveResult(*(DTensor.from_local(t, mesh, ev if k == 1 else lead, run_check=False)
                         for k, t in enumerate(res)))


def _shard2d_matvec_body(A_blk: torch.Tensor, row_group, col_group, i_row: int, i_col: int,
                         n_row_shards: int, eps: float, max_itr: int, storage_dtype=None,
                         eps_mode: str = "absolute", ev0_scale=1.0) -> SolveResult:
    """The matvec-form loop on one rank's (n/pr, n/pc) block.  Per round:

      1. the local block product against the replicated ev's column chunk,
         ``y = A_blk @ ev[cols_j]``                      (O(n²/(pr·pc)))
      2. the pc partials completed to row sums: gathered along
         ``col_axis`` and added in column order          (O(n/pr) wire)
      3. ``v_loc = y / ev[rows_i]``, gathered along ``row_axis``   (O(n))
      4. max / stop / λ / ev update from the replicated v: the single-card
         round.

    Step 2 is JAX's ``psum`` with its order fixed (``sum_in_order``): a
    float all-reduce adds in an order the port does not control.  Splitting
    each row sum into pc partials is another f32 grouping than one row dot,
    so across mesh shapes the round count holds within JAX's ±1 slack; at
    1 × 1 the body is the single-card matvec kernel loop, bit for bit."""
    n_r, n_c = A_blk.shape
    n = n_r * n_row_shards
    Aq, dtype = _stored(A_blk, storage_dtype)
    row0 = i_row * n_r
    next_v = _blocks_next_v(Aq, row_group, col_group, row0, i_col * n_c)
    res = _replicated_loop(next_v, n, dtype, Aq.device, eps, max_itr, eps_mode, ev0_scale)
    return res._replace(eigenvector=res.eigenvector[row0:row0 + n_r].clone())


def solve_sharded_2d(
    A,
    mesh: DeviceMesh,
    row_axis: str = "rows",
    col_axis: str = "cols",
    config: SolverConfig = DEFAULT_CONFIG,
    ev0_scale: float = 1.0,
) -> SolveResult:
    """2-D block-sharded matvec-form solve over a ``rows × cols`` mesh.

    Rank (i, j) holds one n/pr × n/pc block of A: matrix memory per card
    scales as 1/(pr·pc), against 1/pr for :func:`solve_sharded_matvec`'s
    full rows.  Per round: one local block product, one O(n/pr) gather of
    the column partials (added in column order), one O(n) gather of v along
    rows.  A 1 × pc mesh is pure column sharding.  ``config.storage_dtype``
    and ``config.eps_mode`` are honored; the eigenvector is a DTensor
    sharded over rows and replicated over cols.
    """
    _reject_sharded_unsupported(config, "solve_sharded_2d")
    A = _as_tensor(A)
    if A.dim() != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"must be a square matrix, got shape {tuple(A.shape)}")
    n = A.shape[0]
    for ax in (row_axis, col_axis):
        if ax not in _axes(mesh):
            raise ValueError(
                f"mesh has no '{ax}' axis (axes: {_axes(mesh)}) — "
                "build it with make_mesh2d"
            )
    pr, pc = require_axis(mesh, row_axis), require_axis(mesh, col_axis)
    if n % pr != 0:
        raise ValueError(f"dim {n} not divisible by {pr} row shards")
    if n % pc != 0:
        raise ValueError(f"dim {n} not divisible by {pc} col shards")
    i_row, i_col = mesh.get_local_rank(row_axis), mesh.get_local_rank(col_axis)
    n_r, n_c = n // pr, n // pc
    local = _local(A, mesh, {row_axis: 0, col_axis: 1},
                   (slice(i_row * n_r, (i_row + 1) * n_r), slice(i_col * n_c, (i_col + 1) * n_c)))
    res = _shard2d_matvec_body(
        local, mesh.get_group(row_axis), mesh.get_group(col_axis), i_row, i_col, pr,
        config.eps, config.max_itr, config.storage_dtype, config.eps_mode, ev0_scale,
    )
    return _rows_result(res, mesh, row_axis)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ensure_group(want: int, device_type: str, shape: str) -> None:
    """A process group of ``want`` ranks whose backend serves
    ``device_type``: the one running, or, for one rank with none running, a
    one-rank group started here (NCCL on the card, gloo for a CPU mesh).
    Raises on anything else: a mesh is never smaller than asked for and a
    CUDA mesh never turns into a CPU one."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise ValueError(
            f"requested a CUDA {shape} mesh but no CUDA device is visible (no CPU "
            "fallback: ask for a CPU mesh with device_type='cpu')"
        )
    backend = "nccl" if device_type == "cuda" else "gloo"
    if dist.is_initialized():
        world = dist.get_world_size()
        if world != want:
            raise ValueError(
                f"requested a {shape} mesh but only {world} ranks are in the process "
                f"group (a mesh spans the whole group: launch {want} ranks, e.g. torchrun "
                f"--nproc_per_node={want})"
            )
        if backend not in dist.get_backend():
            raise ValueError(
                f"a {device_type} mesh needs a {backend} process group, got "
                f"{dist.get_backend()!r}"
            )
        return
    if want != 1:
        raise ValueError(
            f"requested a {shape} mesh but only 1 rank runs here: start the group first "
            f"(torchrun --nproc_per_node={want}, or parallel.multihost.initialize)"
        )
    kw = {}
    if device_type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0, **kw)


def _check_cards(device_type: str) -> None:
    """Every rank of a CUDA mesh on this host needs a card of its own (two
    ranks on one card make NCCL hang, not fail)."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    if device_type == "cuda" and torch.cuda.device_count() < local:
        raise ValueError(
            f"{local} ranks on this host but only {torch.cuda.device_count()} CUDA cards: "
            "each rank of a CUDA mesh needs a card of its own"
        )


def make_mesh2d(
    pr: int,
    pc: int,
    row_axis: str = "rows",
    col_axis: str = "cols",
    device_type: str = "cuda",
) -> DeviceMesh:
    """pr × pc mesh over the ranks of the process group, in rank order
    (rank i·pc + j at (i, j)).  The group must have pr·pc ranks; a 1 × 1
    mesh with no group running starts a one-rank group (NCCL on the card,
    gloo with ``device_type="cpu"``).  No CPU fallback."""
    _ensure_group(pr * pc, device_type, f"{pr}x{pc}")
    _check_cards(device_type)
    return DeviceMesh(device_type, torch.arange(pr * pc).reshape(pr, pc),
                      mesh_dim_names=(row_axis, col_axis))


def make_row_mesh(
    n_devices: Optional[int] = None, axis_name: str = "rows", device_type: str = "cuda"
) -> DeviceMesh:
    """1-D mesh over the ranks of the process group (``n_devices``, when
    given, must be their number; by default the group's, or ``torchrun``'s
    ``WORLD_SIZE`` before the group starts).  With no group running and one
    rank asked for, a one-rank group starts here (JAX's no-setup
    ``make_row_mesh(1)``):
    NCCL on this process's CUDA card, or gloo with ``device_type="cpu"``.
    Raises where JAX would fall back to the CPU platform or give a smaller
    mesh: a CUDA mesh with no card, a mesh of another size than the
    group."""
    if n_devices is None:  # the group's ranks (torchrun's, before the group starts)
        n_devices = (dist.get_world_size() if dist.is_initialized()
                     else int(os.environ.get("WORLD_SIZE", "1")))
    _ensure_group(n_devices, device_type, f"{n_devices}-rank")
    _check_cards(device_type)
    return DeviceMesh(device_type, torch.arange(n_devices), mesh_dim_names=(axis_name,))
