"""Large-dim single-card solves: dims the reference never reached
(counterpart of ``examples/large_scale.py``).

The matvec (power) form never writes A, so the largest solvable dim is set
by ONE resident copy of the matrix: 32768² float32 (4 GiB; the multiround
kernel, one launch a solve) and 65536² kept in bfloat16 (8 GiB; past the
multiround kernel's shared-memory limit, so the matvec kernel loop).  The
Hilbert matrix is generated on the card, directly in its storage dtype (no
float32 copy, no host transfer).

Run on the card (seconds a solve):
    python -m eigen_value_tpu_torch.examples.large_scale [--dim 32768] [--bf16-dim 65536]
"""

import argparse
import time

import torch

from eigen_value_tpu_torch import SolverConfig, fixtures, max_eigenvalue
from eigen_value_tpu_torch.device import solve_device


def solve_on_device(n: int, dev, storage_dtype=None) -> None:
    cfg = SolverConfig(storage_dtype=storage_dtype)
    # the bf16 matrix (8 GiB at 65536²) is the only copy ever made: the API
    # solves a matrix already in the storage dtype as it is
    H = fixtures.hilbert_matrix(n, dtype=storage_dtype or torch.float32, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = max_eigenvalue(H, cfg)
    lam = float(res.eigenvalue)
    wall = (time.perf_counter() - t0) * 1e3
    mode = "bf16 storage" if storage_dtype is not None else "float32"
    print(
        f"{n}² Hilbert ({mode}): λ = {lam:.5f}, "
        f"rounds = {int(res.rounds)}, converged = {bool(res.converged)}, "
        f"wall = {wall:.0f} ms (includes the kernels' build on a first call)"
    )
    # Hilbert row sums grow like ln(n); λ must be positive and the
    # eigenvector positive
    if not (bool(res.converged) and lam > 0 and float(torch.min(res.eigenvector)) > 0):
        raise AssertionError(f"{n}² {mode}: not a converged positive eigenpair")


def main(device=None, dim: int = 32768, bf16_dim: int = 65536, skip_bf16: bool = False) -> None:
    dev = solve_device(device)
    solve_on_device(dim, dev)
    if not skip_bf16:
        solve_on_device(bf16_dim, dev, storage_dtype=torch.bfloat16)


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--dim", type=int, default=32768)
    p.add_argument("--bf16-dim", type=int, default=65536)
    p.add_argument("--skip-bf16", action="store_true")
    p.add_argument("--device", default=None, help="cpu to run on the CPU (default: the card)")
    args = p.parse_args()
    main(args.device, args.dim, args.bf16_dim, args.skip_bf16)
