"""The collectives of the sharded solves, on one named dimension of a
``DeviceMesh`` (counterparts of JAX's ``lax`` collectives under
``shard_map``).

Each helper takes the rank's local tensor and the process group of one mesh
dimension (``mesh.get_group("rows")``) and returns a local tensor:

=========================  =================================================
JAX                        here
=========================  =================================================
``all_gather(tiled=True)`` :func:`all_gather` (``all_gather_single``, or
                           ``all_gather_into_tensor`` on a torch without it)
``ppermute``               :func:`ppermute` (``batch_isend_irecv``); a pair
                           whose source and destination are this rank is a
                           local copy
``pmax`` / ``pmin``        :func:`all_reduce_max` / :func:`all_reduce_min`
``axis_index``             ``mesh.get_local_rank(name)``
``psum`` of float partials :func:`sum_in_order`: an all-gather of the
                           partials, then a sum in rank order
=========================  =================================================

Every helper runs its collective for real, on a group of one rank too
(the one-card check of the NCCL path), except a hop from a rank to itself.

An all-reduce of floats on NCCL or gloo adds in an order the port does not
control, and round counts depend on the order of every sum (the ground
rule of the kernels: no float atomics, fixed-order reductions).  So a sum
of float partials is gathered and added here in a fixed order; the
all-reduces are used only where any order gives the same bits (a max, a
min, one nonzero term).

A CUDA tensor takes NCCL: gloo's point-to-point operations take host
tensors, and its collectives would copy a card's tensors through the host.
Each helper raises on a CUDA tensor over any other backend rather than
copy.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist

#: ``all_gather_single`` where the installed torch has it (it deprecates
#: ``all_gather_into_tensor``), else ``all_gather_into_tensor``.
_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _check_backend(t: torch.Tensor, group) -> None:
    if t.is_cuda and "nccl" not in dist.get_backend(group):
        raise ValueError(
            f"a CUDA tensor over the {dist.get_backend(group)!r} backend: the sharded solves "
            f"exchange a card's tensors through NCCL only (gloo would copy them through the "
            f"host); build the mesh on an NCCL process group"
        )


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along dim 0 in rank order (JAX's
    ``all_gather(tiled=True)``)."""
    _check_backend(x, group)
    size = dist.get_world_size(group)
    x = x.contiguous()
    out = torch.empty((size * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    _GATHER(out, x, group=group)
    return out


def sum_in_order(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' ``x``, added in rank order: ``x_0 + x_1 + …``
    (JAX's ``psum`` of float partials, with the order fixed)."""
    size = dist.get_world_size(group)
    parts = all_gather(x, group).reshape(size, *x.shape)
    acc = parts[0]
    for q in range(1, size):
        acc = acc + parts[q]
    return acc


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    _check_backend(x, group)
    out = x.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over the ranks (JAX's ``pmax``): exact in any
    order."""
    return _all_reduce(x, dist.ReduceOp.MAX, group)


def all_reduce_min(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise min over the ranks (JAX's ``pmin``)."""
    return _all_reduce(x, dist.ReduceOp.MIN, group)


class Pending:
    """A started :func:`ppermute`: :meth:`wait` returns the received
    tensor.  Work on the current stream may run between the start and the
    wait (the ring overlaps its chunk products with the next hop)."""

    def __init__(self, out: torch.Tensor, works) -> None:
        self._out, self._works = out, works

    def wait(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        return self._out


def ppermute_start(x: torch.Tensor, perm: Sequence[Tuple[int, int]], group) -> Pending:
    """Start JAX's ``ppermute``: for each ``(src, dst)`` in ``perm`` (group
    ranks) rank ``src`` sends ``x`` to ``dst``; a rank that no pair names
    as destination receives zeros.  A pair from this rank to itself is a
    local copy."""
    _check_backend(x, group)
    me = dist.get_rank(group)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    out = torch.zeros_like(x)
    if src == [me] and dst == [me]:
        out.copy_(x)
        return Pending(out, [])
    ops = [dist.P2POp(dist.isend, x.contiguous(), dist.get_global_rank(group, d), group)
           for d in dst]
    ops += [dist.P2POp(dist.irecv, out, dist.get_global_rank(group, s), group) for s in src]
    return Pending(out, dist.batch_isend_irecv(ops) if ops else [])


def ppermute(x: torch.Tensor, perm: Sequence[Tuple[int, int]], group) -> torch.Tensor:
    """JAX's ``ppermute``, waited for."""
    return ppermute_start(x, perm, group).wait()
