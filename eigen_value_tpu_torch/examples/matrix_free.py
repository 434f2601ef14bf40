"""Matrix-free solves: the operator API on a structured (Hankel) matrix
(counterpart of ``examples/matrix_free.py``).

The power-form loop observes A only through one matvec a round, so
``max_eigenvalue_operator`` solves any positive linear operator WITHOUT
materializing it.  The benchmark family itself is the showcase: the
Hilbert matrix ``A[r][c] = 1/(r+c+1)`` is Hankel (constant anti-diagonals,
A[r][c] = h[r+c]), whose matvec is a correlation computable by FFT in
O(n log n) — against the O(n²) dense pass — in O(n) memory.

Run: python -m eigen_value_tpu_torch.examples.matrix_free [--dim 4096] [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from eigen_value_tpu_torch import fixtures, max_eigenvalue, max_eigenvalue_operator
from eigen_value_tpu_torch.device import solve_device
from eigen_value_tpu_torch.ops.solver_matvec import solve_operator_traced
from eigen_value_tpu_torch.ops.spectral import (
    convergence_report,
    refine_eigenpair,
    subdominant_eigenpair,
)
from eigen_value_tpu_torch.ops.structured import hilbert_matvec, kron_matvec


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(device=None, n: int = 4096) -> None:
    dev = solve_device(device)

    # the Hilbert matrix as an O(n) object: its anti-diagonal profile's
    # spectrum (the solve itself never touches an n² object)
    mv = hilbert_matvec(n, device=dev)
    res = max_eigenvalue_operator(mv, n, device=dev)
    lam = float(res.eigenvalue)

    dense = max_eigenvalue(fixtures.hilbert_matrix(n, device=dev))
    print(f"operator solve (FFT Hankel, n={n}): λ = {lam:.6f}, rounds = {int(res.rounds)}")
    print(
        f"dense solve:                        λ = {float(dense.eigenvalue):.6f}, "
        f"rounds = {int(dense.rounds)}"
    )
    if abs(lam - float(dense.eigenvalue)) >= 1e-3 * lam or abs(
            int(res.rounds) - int(dense.rounds)) > 1:
        raise AssertionError("operator and dense solves disagree")
    print("operator λ matches dense within 1e-3 relative")

    # the point: per-round cost is O(n log n), memory O(n)
    _sync(dev)
    t0 = time.perf_counter()
    max_eigenvalue_operator(mv, n, device=dev)
    _sync(dev)
    print(f"full operator solve wall: {(time.perf_counter() - t0) * 1e3:.2f} ms")

    # Kronecker structure: B ⊗ C as two matmuls, never materialized;
    # λ_max factorizes as λ_max(B)·λ_max(C).
    rng = np.random.default_rng(7)
    B = torch.from_numpy(rng.random((32, 32), dtype=np.float32) + np.float32(0.1)).to(dev)
    C = torch.from_numpy(rng.random((48, 48), dtype=np.float32) + np.float32(0.1)).to(dev)
    res_k = max_eigenvalue_operator(kron_matvec(B, C), 32 * 48, device=dev)
    lam_prod = float(max_eigenvalue(B).eigenvalue) * float(max_eigenvalue(C).eigenvalue)
    print(
        f"kron operator (1536², never materialized): λ = "
        f"{float(res_k.eigenvalue):.5f} vs factor product {lam_prod:.5f}"
    )
    if abs(float(res_k.eigenvalue) - lam_prod) >= 1e-3 * lam_prod:
        raise AssertionError("the Kronecker λ is not the product of its factors'")

    # Diagnostics: the traced solve records λ per round; convergence_report
    # turns the history into the subdominant ratio |λ₂/λ₁|, and
    # refine_eigenpair polishes the f32 result to float64 on the host.
    res_t, hist = solve_operator_traced(mv, n, 1e-6, 200, device=dev)
    rep = convergence_report(hist.cpu().numpy(), int(res_t.rounds))
    print(
        f"convergence: rate |λ₂/λ₁| ≈ {rep.rate:.4f} "
        f"({rep.digits_per_round:.2f} digits/round), "
        f"remaining λ error ≈ {rep.lam_error_estimate:.2e}"
    )

    if n <= 4096:  # the host float64 polish needs the dense matrix
        A64 = fixtures.hilbert_matrix(n).double().numpy()
        ref = refine_eigenpair(A64, res)
        print(
            f"f64 polish: λ = {ref.eigenvalue:.12f} "
            f"(residual {ref.residual:.1e}, {ref.rounds} host rounds)"
        )
        # MEASURE the gap the report estimated: deflation of the refined
        # dominant pair + power iteration gives λ₂ itself
        sub = subdominant_eigenpair(A64, ref, device=dev)
        print(
            f"spectral gap: λ₂ = {sub.eigenvalue:.6e}, measured |λ₂/λ₁| = "
            f"{sub.ratio:.4f} (report estimated {rep.rate:.4f}; "
            f"{sub.rounds} deflated rounds)"
        )


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=4096)
    ap.add_argument("--device", default=None, help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args()
    main(args.device, args.dim)
