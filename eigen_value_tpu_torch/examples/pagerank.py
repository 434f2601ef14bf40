"""PageRank as a matrix-free eigenvalue solve: sparse + rank-one operators
(counterpart of ``examples/pagerank.py``).

The Google matrix ``G = α·P + (1−α)/n·11ᵀ`` (P the column-stochastic link
matrix, α the damping factor) is a POSITIVE matrix whose maximum
eigenvalue is exactly 1 and whose Perron eigenvector is the PageRank score
vector.  G is dense (the teleportation term touches every entry) but never
needs materializing: it is the SUM of two structured operators,

    G·x = ell_matvec(αP)·x  +  low_rank_matvec(teleportation)·x,

composed with ``add_matvec`` — O(edges + n) a round instead of O(n²).

Run: python -m eigen_value_tpu_torch.examples.pagerank [--nodes 2000 --out-degree 5] [--device cpu]
"""

import argparse

import numpy as np
import torch

from eigen_value_tpu_torch import max_eigenvalue, max_eigenvalue_operator
from eigen_value_tpu_torch.device import solve_device
from eigen_value_tpu_torch.ops.structured import (
    add_matvec,
    ell_from_coo,
    ell_matvec,
    low_rank_matvec,
)


def random_link_graph(n: int, out_degree: int, seed: int = 3):
    """COO triplets of a random directed graph: every node links to
    ``out_degree`` distinct others (no dangling nodes by construction)."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(n), out_degree)
    dst = np.concatenate([rng.choice(n - 1, size=out_degree, replace=False) for _ in range(n)])
    dst = np.where(dst >= src, dst + 1, dst)  # no self-links, stays in [0, n)
    return src, dst


def main(device=None, n: int = 2000, d: int = 5, alpha: float = 0.85) -> None:
    dev = solve_device(device)
    src, dst = random_link_graph(n, d)
    # column-stochastic P: P[dst, src] = 1/outdeg(src); here outdeg ≡ d
    cols, vals = ell_from_coo(dst, src, np.full(len(src), alpha / d), n, device=dev)
    link = ell_matvec(cols, vals)  # α·P — O(edges) a matvec
    ones = torch.ones(n, 1, device=dev)
    teleport = low_rank_matvec(ones * ((1 - alpha) / n), ones)  # (1−α)/n·11ᵀ
    google = add_matvec(link, teleport)

    res = max_eigenvalue_operator(google, n, device=dev)
    scores = res.eigenvector.double().cpu().numpy()
    scores /= scores.sum()

    # G is column-stochastic ⇒ λ_max = 1 exactly — a free correctness oracle
    lam = float(res.eigenvalue)
    print(f"operator solve (n={n}, {n * d} edges): λ = {lam:.6f}, "
          f"rounds = {int(res.rounds)}  (exact answer: λ = 1)")
    if abs(lam - 1.0) >= 2e-3:
        raise AssertionError(f"λ = {lam}, not 1")

    # cross-check the scores against the dense solver on materialized G
    G = np.full((n, n), (1 - alpha) / n, np.float32)
    np.add.at(G, (dst, src), alpha / d)
    dense = max_eigenvalue(torch.from_numpy(G).to(dev))
    ref = dense.eigenvector.double().cpu().numpy()
    ref /= ref.sum()
    err = float(np.max(np.abs(scores - ref)) / ref.max())
    print(f"dense cross-check: λ = {float(dense.eigenvalue):.6f}, "
          f"max score deviation = {err:.2e}")
    if err >= 1e-2:
        raise AssertionError(f"scores deviate from the dense solve by {err}")

    top = np.argsort(scores)[::-1][:5]
    print("top-5 nodes:", ", ".join(f"#{i} ({scores[i]:.5f})" for i in top))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=2000)
    ap.add_argument("--out-degree", type=int, default=5)
    ap.add_argument("--damping", type=float, default=0.85)
    ap.add_argument("--device", default=None, help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args()
    main(args.device, args.nodes, args.out_degree, args.damping)
