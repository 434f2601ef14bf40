"""Distributed solves: sharded, ring, 2-D, batched and checkpointed
(counterpart of ``examples/distributed.py``).

Runs on the ranks of a ``torch.distributed`` group, one card a rank.  In
one process with no group running it starts a one-rank group: NCCL on the
card, or gloo with ``--device cpu``.  On K cards:

    torchrun --nproc_per_node=K -m eigen_value_tpu_torch.examples.distributed

(``bench/mh_worker.py`` shows the multi-host flow, each process building
only its own rows: ``parallel.multihost.assemble_rowsharded``.)
"""

import argparse
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from eigen_value_tpu_torch import checkpoint, fixtures
from eigen_value_tpu_torch.device import solve_device
from eigen_value_tpu_torch.parallel import (
    make_mesh2d,
    make_row_mesh,
    multihost,
    solve_batched_sharded,
    solve_sharded_2d,
    solve_sharded_matvec,
    solve_sharded_matvec_ring,
)


def main(device=None) -> None:
    dev = solve_device(device)
    import os

    started = not dist.is_initialized()
    if started and "WORLD_SIZE" in os.environ:
        multihost.initialize(device_type=dev.type)  # launched by torchrun
    try:
        _run(dev)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _run(dev) -> None:
    mesh = make_row_mesh(device_type=dev.type)
    n_dev = mesh.size()
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())  # this rank's card
    H = fixtures.hilbert_matrix(1024, device=dev)

    # Row-sharded solve: per-round all_gather of the O(n) vector.
    res = solve_sharded_matvec(H, mesh)
    print(
        f"sharded ({n_dev} devices): λ = {float(res.eigenvalue):.5f}, "
        f"rounds = {int(res.rounds)} (expect {fixtures.HILBERT_ROUNDS[1024]})"
    )

    # Ring: the ev chunks hop around the ranks beside each chunk's product.
    res_ring = solve_sharded_matvec_ring(H, mesh)
    print(f"ring:     λ = {float(res_ring.eigenvalue):.5f}, rounds = {int(res_ring.rounds)}")

    # 2D block sharding: n²/(pr·pc) a card — the layout for n too large
    # even for full-row shards.
    if n_dev % 2 == 0:
        pr, pc = 2, n_dev // 2
        res_2d = solve_sharded_2d(H, make_mesh2d(pr, pc, device_type=dev.type))
        print(
            f"2D {pr}x{pc}:   λ = {float(res_2d.eigenvalue):.5f}, "
            f"rounds = {int(res_2d.rounds)}"
        )

    # Batched: independent matrices, the batch sharded over the ranks.
    rng = np.random.default_rng(0)
    mats = rng.random((2 * n_dev, 256, 256), dtype=np.float32) + np.float32(1e-4)
    mesh_b = make_row_mesh(n_dev, axis_name="batch", device_type=dev.type)
    res_b = solve_batched_sharded(torch.from_numpy(mats).to(dev), mesh_b)
    print(
        f"batched:  {mats.shape[0]} × 256² solves, "
        f"rounds = {res_b.rounds.full_tensor().tolist()}"
    )

    # Checkpointed long solve: 4-round chunks, resumable snapshot on disk.
    with tempfile.TemporaryDirectory() as d:
        res_c = checkpoint.solve_checkpointed(
            H, chunk_rounds=4, checkpoint_path=f"{d}/eigen_solve.npz"
        )
    print(f"checkpointed: λ = {float(res_c.eigenvalue):.5f}, rounds = {int(res_c.rounds)}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cpu for gloo on the CPU (default: the card)")
    main(ap.parse_args().device)
