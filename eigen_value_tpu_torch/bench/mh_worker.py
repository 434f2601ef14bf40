"""One process of a multi-process group: one "host" of the multi-host flow
(counterpart of ``eigen_value_tpu.bench.mh_worker``).

    python -m eigen_value_tpu_torch.bench.mh_worker --process-id 0 \\
        --num-processes 2 --coordinator localhost:PORT --dim 2048 \\
        [--solver gather ring 2d iterated batched] [--device cuda|cpu] [--nodes K]

Each process starts the group through ``multihost.initialize`` (NCCL on its
own card, ``--device cuda``, the process id being its card; gloo with
``--device cpu``) and builds ONLY its own Hilbert rows, with the fixture's
exact arithmetic (an int divisor, an f32 reciprocal), which
``multihost.assemble_rowsharded`` / ``assemble_blocksharded`` place.  Then,
for each ``--solver`` in turn, in the one group:

  * ``gather``: ``solve_multihost`` (the gathered row-sharded body);
  * ``ring``: ``solve_sharded_matvec_ring`` on the same mesh;
  * ``2d``: ``solve_sharded_2d`` on ``make_global_mesh2d`` (hosts × ranks of
    a host; ``--nodes K`` makes each consecutive span of ranks a host of
    its own, through ``GROUP_RANK``, the variable ``torchrun`` sets);
  * ``iterated``: ``solve_sharded`` (the iterated body);
  * ``batched``: ``max_eigenvalue_batch`` of two Hilbert matrices per batch
    shard on a batch × rows mesh (two batch shards when the group has an
    even number of ranks), each rank holding its rows of its matrices.

It prints one JSON line: the group's size and device, and per solver the
rounds, λ, converged, the global residual ``max|A·v − λ·v|`` (float64, from
each rank's own rows, combined by a max), and the least wall time over
``--reps`` solves after one untimed solve (each solve starts at a barrier
and ends at a synchronise).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

SOLVERS = ("gather", "ring", "2d", "iterated", "batched")


def hilbert_rows(row0: int, rows: int, n: int):
    """Rows ``[row0, row0 + rows)`` of the n × n Hilbert matrix, bit for bit
    ``fixtures.hilbert_matrix(n)[row0:row0 + rows]``."""
    import numpy as np

    r = np.arange(row0, row0 + rows, dtype=np.int32)[:, None]
    c = np.arange(n, dtype=np.int32)[None, :]
    return np.float32(1.0) / (r + c + 1).astype(np.float32)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="eigen_value_tpu_torch.bench.mh_worker")
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0 (default: the env:// variables of torchrun)")
    p.add_argument("--dim", type=int, default=2048)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--solver", nargs="+", choices=SOLVERS, default=["gather"])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--nodes", type=int, default=None,
                   help="treat each span of num_processes / nodes ranks as one host")
    args = p.parse_args(argv)

    if args.nodes:
        os.environ["GROUP_RANK"] = str(args.process_id // (args.num_processes // args.nodes))

    import numpy as np
    import torch
    import torch.distributed as dist

    from eigen_value_tpu_torch import max_eigenvalue_batch
    from eigen_value_tpu_torch.parallel import (
        make_mesh2d,
        multihost,
        solve_sharded,
        solve_sharded_2d,
        solve_sharded_matvec_ring,
    )
    from eigen_value_tpu_torch.parallel._collectives import all_reduce_max

    if args.device == "cpu":
        torch.set_num_threads(1)  # a group shares its host's cores
    multihost.initialize(args.coordinator, args.num_processes, args.process_id,
                         device_type=args.device,
                         local_rank=args.process_id if args.device == "cuda" else None)
    world, rank = dist.get_world_size(), dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device()) if args.device == "cuda" else None
    n = args.dim

    def sync():
        if dev is not None:
            torch.cuda.synchronize(dev)

    def residual(rows, row0, ev, lam) -> float:
        """The global max|A·v − λ·v| from this rank's ``rows`` (float64)."""
        a = torch.from_numpy(rows).double()
        ev = ev.double().cpu()
        r = (a @ ev - float(lam) * ev[row0:row0 + rows.shape[0]]).abs().max()
        t = r.reshape(1).to(dev or "cpu")
        return float(all_reduce_max(t, dist.group.WORLD))

    row_mesh = multihost.make_global_row_mesh()
    n_loc = n // world
    my_rows = hilbert_rows(rank * n_loc, n_loc, n)
    results = {}
    for solver in args.solver:
        if solver == "2d":
            mesh = multihost.make_global_mesh2d()
            i = mesh.get_local_rank("rows")
            n_r = n // mesh.size(0)
            rows, row0 = hilbert_rows(i * n_r, n_r, n), i * n_r
            A = multihost.assemble_blocksharded(rows, mesh)
            solve = lambda: solve_sharded_2d(A, mesh)  # noqa: E731
        elif solver == "batched":
            pb = 2 if world % 2 == 0 else 1
            mesh = make_mesh2d(pb, world // pb, "batch", "rows", device_type=args.device)
            n_r = n // mesh.size(1)
            row0 = mesh.get_local_rank("rows") * n_r
            rows = hilbert_rows(row0, n_r, n)
            from torch.distributed.tensor import DTensor, Shard

            local = torch.from_numpy(np.stack([rows, rows])).to(dev or "cpu")
            A = DTensor.from_local(local, mesh, [Shard(0), Shard(1)], run_check=False)
            solve = lambda: max_eigenvalue_batch(A, mesh=mesh)  # noqa: E731
        else:
            mesh, rows, row0 = row_mesh, my_rows, rank * n_loc
            A = multihost.assemble_rowsharded(rows, mesh)
            solve = {
                "gather": lambda: multihost.solve_multihost(A, mesh=mesh),
                "ring": lambda: solve_sharded_matvec_ring(A, mesh),
                "iterated": lambda: solve_sharded(A, mesh),
            }[solver]
        res = solve()  # untimed: NCCL sets up its communicators in the first exchanges
        ts = []
        for _ in range(args.reps):
            dist.barrier()
            sync()
            t0 = time.perf_counter()
            res = solve()
            sync()
            ts.append((time.perf_counter() - t0) * 1e3)
        ms = min(ts) if ts else None
        if solver == "batched":
            lam_all = res.eigenvalue.full_tensor()
            rounds_all = res.rounds.full_tensor()
            ev_all = res.eigenvector.full_tensor()
            lam, rounds = float(lam_all[0]), int(rounds_all[0])
            converged = bool(res.converged.full_tensor().all())
            resid = max(residual(rows, row0, ev_all[b], lam_all[b]) for b in range(len(lam_all)))
            extra = {"batch": len(lam_all), "rounds_all": rounds_all.tolist(),
                     "eigenvalues": lam_all.tolist()}
        else:
            lam, rounds, converged = float(res.eigenvalue), int(res.rounds), bool(res.converged)
            resid = residual(rows, row0, res.eigenvector.full_tensor(), lam)
            extra = {}
        results[solver] = {
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "rounds": rounds,
            "eigenvalue": lam, "converged": converged, "residual": resid, "ms": ms,
            "elems_per_s": multihost.elems_per_second(n, rounds, ms * 1e-3) if ts else None,
            **extra,
        }
    print(json.dumps({
        "process_id": args.process_id, "rank": rank, "num_processes": world,
        "global_devices": world, "dim": n, "device": args.device,
        "card": torch.cuda.get_device_name(dev) if dev is not None else None,
        "results": results,
    }, allow_nan=False), flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
