"""Multi-device parallelism (counterpart of ``eigen_value_tpu.parallel``):
row-sharded, ring, 2-D block-sharded, iterated and batched solves over a
``torch.distributed`` ``DeviceMesh`` (``sharded.py``), the multi-host
bootstrap and assembly (``multihost.py``), and batched solves, sharded or
not (``batched.py``)."""

from .batched import solve_batched, solve_batched_sharded
from .multihost import (
    assemble_blocksharded,
    assemble_rowsharded,
    make_global_mesh2d,
    make_global_row_mesh,
    solve_multihost,
)
from .sharded import (
    make_mesh2d,
    make_row_mesh,
    solve_batched_rowsharded,
    solve_sharded,
    solve_sharded_2d,
    solve_sharded_matvec,
    solve_sharded_matvec_ring,
)

__all__ = [
    "assemble_blocksharded",
    "assemble_rowsharded",
    "make_global_mesh2d",
    "make_global_row_mesh",
    "solve_batched",
    "solve_batched_rowsharded",
    "solve_batched_sharded",
    "solve_multihost",
    "solve_sharded",
    "solve_sharded_2d",
    "solve_sharded_matvec",
    "solve_sharded_matvec_ring",
    "make_mesh2d",
    "make_row_mesh",
]
