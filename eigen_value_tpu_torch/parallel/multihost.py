"""Multi-host solves on ``torch.distributed`` (counterpart of
``eigen_value_tpu.parallel.multihost``).

Design, as in JAX:
  * The process group starts with :func:`initialize`, from an explicit
    address, world size and rank, or from the ``env://`` variables that
    ``torchrun`` sets.  One process is one rank and drives one device.
  * The meshes are host-major: ranks in rank order, each host's ranks one
    contiguous span (:func:`make_global_row_mesh`), and for the 2-D mesh
    hosts along ``rows`` and each host's ranks along ``cols``
    (:func:`make_global_mesh2d`), so the column partials of the 2-D solve
    stay inside a host and only the rows gather crosses hosts.
  * Each rank builds only its own rows (:func:`assemble_rowsharded`) or
    block (:func:`assemble_blocksharded`) into a ``DTensor``; no rank ever
    holds the whole matrix.
  * The solver is ``sharded.solve_sharded_matvec``: the same code runs on
    one rank or many.

A rank's host is its ``GROUP_RANK`` (the node rank ``torchrun`` sets), or
its host name when that is unset.

Weak-scaling accounting: :func:`weak_scaling_efficiency` compares measured
elements/s against the one-rank figure.
"""

from __future__ import annotations

import os
import socket
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard

from ..config import DEFAULT_CONFIG, SolverConfig
from ..ops.solver import SolveResult
from .sharded import _axes, _check_cards, _mesh_device, require_axis, solve_sharded_matvec


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device_type: str = "cuda",
    local_rank: Optional[int] = None,
) -> None:
    """Start the process group.  ``coordinator_address`` ("host:port"),
    ``num_processes`` and ``process_id`` give it explicitly; with none of
    them the ``env://`` variables that ``torchrun`` sets are read.

    ``device_type="cuda"`` binds this process to its card
    (``torch.cuda.set_device(local_rank)`` before the group, ``device_id``
    in ``init_process_group``; ``local_rank`` defaults to ``LOCAL_RANK``,
    else 0) and takes NCCL; ``"cpu"`` takes gloo.  Call once per process
    before any mesh is built."""
    kw = {}
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise ValueError("device_type='cuda' but no CUDA device is visible")
        if local_rank is None:
            local_rank = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    elif device_type != "cpu":
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    backend = "nccl" if device_type == "cuda" else "gloo"
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id, **kw)


def _device_type() -> str:
    """The device kind the running process group serves."""
    if not dist.is_initialized():
        raise ValueError("no process group is running: call multihost.initialize first")
    return "cuda" if "nccl" in dist.get_backend() else "cpu"


def _hosts() -> list:
    """Each rank's host index, in rank order: hosts numbered by the first
    rank on them."""
    me = os.environ.get("GROUP_RANK") or socket.gethostname()
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, me)
    order = {}
    for name in names:
        order.setdefault(name, len(order))
    return [order[name] for name in names]


def make_global_row_mesh(axis_name: str = "rows", device_type: Optional[str] = None) -> DeviceMesh:
    """1-D row mesh over every rank of the group, in rank order.
    ``device_type`` defaults to the group's (NCCL: cuda, gloo: cpu)."""
    device_type = device_type or _device_type()
    _check_cards(device_type)
    return DeviceMesh(device_type, torch.arange(dist.get_world_size()),
                      mesh_dim_names=(axis_name,))


def make_global_mesh2d(
    row_axis: str = "rows",
    col_axis: str = "cols",
    device_type: Optional[str] = None,
) -> DeviceMesh:
    """2-D (hosts × ranks of a host) mesh for block-sharded multi-host
    solves: ``row_axis`` runs over the hosts (so the per-round rows gather
    is the one collective that crosses hosts) and ``col_axis`` over each
    host's ranks (the column partials stay inside a host).  Pairs with
    :func:`assemble_blocksharded` and ``sharded.solve_sharded_2d``."""
    device_type = device_type or _device_type()
    _check_cards(device_type)
    hosts = _hosts()
    by_host = [[r for r, h in enumerate(hosts) if h == k] for k in range(max(hosts) + 1)]
    if len({len(b) for b in by_host}) != 1:
        raise ValueError(
            "processes own unequal device counts "
            f"({[len(b) for b in by_host]}) — cannot form a rectangular mesh"
        )
    return DeviceMesh(device_type, torch.tensor(by_host), mesh_dim_names=(row_axis, col_axis))


def _require_host_major(proc_seq) -> None:
    """The placement precondition of :func:`assemble_rowsharded`: a rank's
    block lands at its coordinate's rows only if the mesh's flat order is
    host-major (each host one contiguous span, spans in order).  Raise
    instead of placing blocks at wrong offsets."""
    if list(proc_seq) != sorted(proc_seq):
        raise ValueError(
            "mesh device order is not host-major (process indices along the "
            f"flat mesh axis: {list(proc_seq)}) — assemble_rowsharded would "
            "place row blocks at wrong global offsets; build the mesh with "
            "make_global_row_mesh or order devices by process"
        )


def _check_placement(mesh: DeviceMesh) -> None:
    """The mesh's ranks are in rank order and its hosts host-major."""
    ranks = mesh.mesh.flatten().tolist()
    _require_host_major(ranks)
    hosts = _hosts()
    _require_host_major([hosts[r] for r in ranks])


def assemble_rowsharded(local_rows, mesh: DeviceMesh, axis_name: str = "rows") -> DTensor:
    """The global row-sharded matrix, from this rank's rows.

    Each rank passes only its contiguous block of rows ``[p·n/P,
    (p+1)·n/P)`` (p its coordinate; the mesh from
    :func:`make_global_row_mesh`, where p is the rank); the result is a
    DTensor placed ``Shard(0)`` whose data never leaves the rank that made
    it.  This is how a matrix that fits no single host is fed to
    :func:`solve_multihost`."""
    local_rows = torch.as_tensor(local_rows)
    n_local, n = local_rows.shape
    require_axis(mesh, axis_name)
    if mesh.ndim != 1:
        raise ValueError(
            f"assemble_rowsharded needs a 1-D mesh over '{axis_name}' "
            f"(axis size {require_axis(mesh, axis_name)} vs {mesh.mesh.numel()} devices) — "
            "Shard(0) over one dimension would replicate blocks this function places as "
            "distinct blocks; use assemble_blocksharded for 2D layouts"
        )
    _check_placement(mesh)
    n_procs = mesh.size(0)
    if n_local * n_procs != n:
        raise ValueError(
            f"local block {tuple(local_rows.shape)} with {n_procs} "
            f"processes does not assemble to a square {n}×{n} matrix"
        )
    local = local_rows.to(_mesh_device(mesh)).contiguous()
    return DTensor.from_local(local, mesh, [Shard(0)], run_check=False)


def assemble_blocksharded(
    local_rows,
    mesh: DeviceMesh,
    row_axis: str = "rows",
    col_axis: str = "cols",
) -> DTensor:
    """The global 2-D block-sharded matrix, from this rank's row block (the
    2-D analog of :func:`assemble_rowsharded`).

    Each rank passes the rows ``[i·n/pr, (i+1)·n/pr)`` of its mesh row i;
    it keeps the column block of its coordinate j, so rank (i, j) holds
    ``A[i·n/pr:(i+1)·n/pr, j·n/pc:(j+1)·n/pc]``.  Nothing crosses ranks.
    Validated: the mesh's ranks in rank order, each mesh row on one host,
    hosts host-major with equal counts (the layout
    :func:`make_global_mesh2d` builds)."""
    local_rows = torch.as_tensor(local_rows)
    n = local_rows.shape[1]
    names = _axes(mesh)
    for ax in (row_axis, col_axis):
        require_axis(mesh, ax)
    grid = mesh.mesh.permute(names.index(row_axis), names.index(col_axis))
    pr, pc = grid.shape
    if n % pr or n % pc:
        raise ValueError(f"dim {n} not divisible by the {pr}x{pc} mesh")
    _require_host_major(grid.flatten().tolist())
    hosts = _hosts()
    row_hosts = []
    for i in range(pr):
        on = {hosts[r] for r in grid[i].tolist()}
        if len(on) != 1:
            raise ValueError(
                f"mesh row {i} spans processes {sorted(on)} — each "
                "rows-axis block must be owned by one process (build the "
                "mesh with make_global_mesh2d)"
            )
        row_hosts.append(on.pop())
    _require_host_major(row_hosts)
    counts = {h: row_hosts.count(h) for h in set(row_hosts)}
    if len(set(counts.values())) != 1:
        raise ValueError(
            f"processes own unequal mesh-row counts ({counts}) — row "
            "blocks would have unequal sizes"
        )
    if local_rows.shape[0] * pr != n:
        raise ValueError(
            f"local block {tuple(local_rows.shape)} with {pr} mesh rows "
            f"does not assemble to a square {n}×{n} matrix"
        )
    j = mesh.get_local_rank(col_axis)
    blk_c = n // pc
    local = local_rows[:, j * blk_c:(j + 1) * blk_c].to(_mesh_device(mesh)).contiguous()
    shards = {row_axis: Shard(0), col_axis: Shard(1)}
    return DTensor.from_local(local, mesh, [shards[a] for a in names], run_check=False)


def solve_multihost(
    A,
    config: SolverConfig = DEFAULT_CONFIG,
    mesh: Optional[DeviceMesh] = None,
) -> SolveResult:
    """Row-partitioned solve across every rank of the process group.

    ``A`` is a DTensor from :func:`assemble_rowsharded`, or a whole matrix
    on every rank (each rank takes its rows)."""
    mesh = mesh or make_global_row_mesh()
    return solve_sharded_matvec(A, mesh, axis_name="rows", config=config)


def elems_per_second(n: int, rounds: int, seconds: float) -> float:
    """Matrix elements processed per second: rounds × n² / t (the matvec
    form touches each element once per round)."""
    return rounds * float(n) * float(n) / seconds


def weak_scaling_efficiency(
    elems_per_s_multi: float, n_chips: int, elems_per_s_single: float
) -> float:
    """Efficiency against perfect linear scaling from the one-rank baseline."""
    return elems_per_s_multi / (n_chips * elems_per_s_single)
