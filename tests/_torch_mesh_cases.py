"""The port's sharded solves, run as one rank of a gloo group on the CPU.

    python tests/_torch_mesh_cases.py RANK WORLD PORT

Every rank builds the same numpy inputs from fixed seeds (:func:`inputs`;
``tests/test_torch_sharded.py`` builds them again for the JAX package),
joins a WORLD-rank gloo group at ``localhost:PORT``, and runs every case of
:func:`cases` for that world size in the one group.  Rank 0 prints one JSON
line: per case λ, rounds, converged and the whole eigenvector (gathered
from its DTensor), and each rank's (λ, rounds).  Imports torch, numpy and
the port only (no jax, no pytest): the tests launch it as a subprocess.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def hilbert(n: int) -> np.ndarray:
    """The fixture's arithmetic: an int divisor, an f32 reciprocal."""
    i = np.arange(n, dtype=np.int32)
    return np.float32(1.0) / (i[:, None] + i[None, :] + 1).astype(np.float32)


def inputs() -> dict:
    return {
        "hilbert256": hilbert(256),
        "random128": np.random.default_rng(0xE16E7).random((128, 128), dtype=np.float32) + 1e-4,
        "random256": np.random.default_rng(256).random((256, 256), dtype=np.float32) + 1e-2,
        "batch4x128": np.random.default_rng(4).random((4, 128, 128), dtype=np.float32) + 1e-4,
        "batch8x64": np.random.default_rng(8).random((8, 64, 64), dtype=np.float32) + 1e-4,
    }


#: The 2-D mesh shapes (rows x cols, or batch x rows) run at each world size.
SHAPES_2D = {1: [(1, 1)], 2: [(2, 1), (1, 2)], 4: [(2, 2), (1, 4), (4, 1)]}


def cases(world: int) -> list:
    """The names of the cases run at ``world`` ranks (each name says what
    :func:`run_case` runs)."""
    names = ["gather", "gather_plain", "gather_relative", "gather_scaled", "ring",
             "ring_relative", "ring_cap", "iterated", "iterated_relative", "batch",
             "pair_gather", "pair_ring", "pair_iterated", "pair_2d", "api_auto", "api_matvec",
             "api_matvec_pallas", "api_xla", "api_validate", "api_2d", "api_batch",
             "api_batch_rows", "assembled_gather", "assembled_2d", "bf16_gather", "bf16_ring",
             "bf16_2d", "bf16_batch_rows", "bf16_api", "bf16_prequantized"]
    for pr, pc in SHAPES_2D[world]:
        names += [f"2d_{pr}x{pc}", f"batch_rows_{pr}x{pc}"]
    return names


def square_2d(world: int) -> tuple:
    """The mesh shape of the cases that take one 2-D shape per world."""
    return SHAPES_2D[world][0] if world != 2 else (1, 2)


def run_case(name: str, world: int, data: dict, meshes):
    import torch

    import eigen_value_tpu_torch as evt
    from eigen_value_tpu_torch.parallel import (
        assemble_rowsharded,
        solve_batched_rowsharded,
        solve_batched_sharded,
        solve_sharded,
        solve_sharded_2d,
        solve_sharded_matvec,
        solve_sharded_matvec_ring,
    )

    t = {k: torch.from_numpy(v) for k, v in data.items()}
    H = t["hilbert256"]
    rows = meshes("rows")
    bf16 = evt.SolverConfig(storage_dtype=torch.bfloat16)
    if name.startswith("2d_"):
        return solve_sharded_2d(H, meshes("2d", *map(int, name[3:].split("x"))))
    if name.startswith("batch_rows_"):
        pb, pr = map(int, name[11:].split("x"))
        return solve_batched_rowsharded(t["batch4x128"], meshes("batch_rows", pb, pr))
    sq = meshes("2d", *square_2d(world))
    run = {
        "gather": lambda: solve_sharded_matvec(H, rows),
        "gather_plain": lambda: solve_sharded_matvec(H, rows, use_pallas=False),
        "gather_relative": lambda: solve_sharded_matvec(
            H, rows, config=evt.SolverConfig(eps_mode="relative")),
        "gather_scaled": lambda: solve_sharded_matvec(H, rows, ev0_scale=2.0),
        "ring": lambda: solve_sharded_matvec_ring(H, rows),
        "ring_relative": lambda: solve_sharded_matvec_ring(
            H, rows, config=evt.SolverConfig(eps_mode="relative")),
        "ring_cap": lambda: solve_sharded_matvec_ring(H, rows, config=evt.SolverConfig(max_itr=3)),
        "iterated": lambda: solve_sharded(H, rows),
        "iterated_relative": lambda: solve_sharded(
            H, rows, config=evt.SolverConfig(eps_mode="relative")),
        "batch": lambda: solve_batched_sharded(t["batch8x64"], meshes("batch")),
        "pair_gather": lambda: solve_sharded_matvec(t["random128"], rows),
        "pair_ring": lambda: solve_sharded_matvec_ring(t["random128"], rows),
        "pair_iterated": lambda: solve_sharded(t["random128"], rows),
        "pair_2d": lambda: solve_sharded_2d(t["random128"], sq),
        "api_auto": lambda: evt.max_eigenvalue(data["hilbert256"], mesh=rows),
        "api_matvec": lambda: evt.max_eigenvalue(H, evt.SolverConfig(backend="matvec"), mesh=rows),
        "api_matvec_pallas": lambda: evt.max_eigenvalue(
            H, evt.SolverConfig(backend="matvec_pallas"), mesh=rows),
        "api_xla": lambda: evt.max_eigenvalue(H, evt.SolverConfig(backend="xla"), mesh=rows),
        "api_validate": lambda: evt.max_eigenvalue(
            assemble_rowsharded(H[torch.tensor_split(torch.arange(256), world)[rank()]], rows),
            validate=True, mesh=rows),
        "api_2d": lambda: evt.max_eigenvalue(H, mesh=sq),
        "api_batch": lambda: evt.max_eigenvalue_batch(t["batch8x64"], mesh=meshes("batch")),
        "api_batch_rows": lambda: evt.max_eigenvalue_batch(
            t["batch4x128"], mesh=meshes("batch_rows", *square_2d(world))),
        "assembled_gather": lambda: solve_sharded_matvec(
            assemble_rowsharded(H[torch.tensor_split(torch.arange(256), world)[rank()]], rows),
            rows),
        "assembled_2d": lambda: solve_sharded_2d(assembled_2d(H, sq), sq),
        "bf16_gather": lambda: solve_sharded_matvec(H, rows, config=bf16),
        "bf16_ring": lambda: solve_sharded_matvec_ring(H, rows, config=bf16),
        "bf16_2d": lambda: solve_sharded_2d(H, sq, config=bf16),
        "bf16_batch_rows": lambda: solve_batched_rowsharded(
            t["batch4x128"], meshes("batch_rows", *square_2d(world)), config=bf16),
        "bf16_api": lambda: evt.max_eigenvalue(t["random256"], bf16, mesh=rows),
        "bf16_prequantized": lambda: evt.max_eigenvalue(
            t["random256"].to(torch.bfloat16), bf16, mesh=rows),
    }
    return run[name]()


def rank() -> int:
    import torch.distributed as dist

    return dist.get_rank()


def assembled_2d(H, mesh):
    """``assemble_blocksharded`` from this rank's mesh row of H."""
    from eigen_value_tpu_torch.parallel import assemble_blocksharded

    n_r = H.shape[0] // mesh.size(0)
    i = mesh.get_local_rank("rows")
    return assemble_blocksharded(H[i * n_r:(i + 1) * n_r], mesh)


def main(argv) -> int:
    r, world, port = (int(a) for a in argv[1:4])
    import torch
    import torch.distributed as dist

    from eigen_value_tpu_torch.parallel import make_mesh2d, make_row_mesh

    torch.set_num_threads(1)  # the ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=r)
    cache = {}

    def meshes(kind, *shape):
        key = (kind, shape)
        if key not in cache:
            if kind in ("rows", "batch"):
                cache[key] = make_row_mesh(world, kind, device_type="cpu")
            elif kind == "2d":
                cache[key] = make_mesh2d(*shape, device_type="cpu")
            else:
                cache[key] = make_mesh2d(*shape, "batch", "rows", device_type="cpu")
        return cache[key]

    data = inputs()
    out = {}
    for name in cases(world):
        res = run_case(name, world, data, meshes)
        full = [x.full_tensor() if hasattr(x, "full_tensor") else x for x in res]
        mine = [full[0].tolist(), full[2].tolist()]
        ranks = [None] * world
        dist.all_gather_object(ranks, mine)
        out[name] = {"eigenvalue": full[0].tolist(), "eigenvector": full[1].tolist(),
                     "rounds": full[2].tolist(), "converged": full[3].tolist(), "ranks": ranks}
    blocks = assembled_2d(torch.from_numpy(data["hilbert256"]), meshes("2d", *square_2d(world)))
    out["assembled_2d"]["placed_equal"] = bool(
        torch.equal(blocks.full_tensor(), torch.from_numpy(data["hilbert256"])))
    if r == 0:
        print(json.dumps(out), flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
