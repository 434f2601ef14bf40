"""Differentiable eigenpair: gradient-based spectral design (counterpart of
``examples/autodiff.py``).

Uses the port's autograd functions (``ops/autodiff.py``) to tune a matrix
so its Perron eigenvalue hits a target, then reads an eigenvector
sensitivity and the gradient of λ of a matrix-free Hankel operator with
respect to its O(n) profile.

Run: python -m eigen_value_tpu_torch.examples.autodiff [--device cpu]
"""

import argparse

import numpy as np
import torch

from eigen_value_tpu_torch.device import solve_device
from eigen_value_tpu_torch.ops.autodiff import eigenpair, eigenvalue, eigenvalue_operator
from eigen_value_tpu_torch.ops.structured import hankel_matvec


def main(device=None) -> None:
    dev = solve_device(device)
    rng = np.random.default_rng(0)
    A0 = torch.from_numpy(rng.random((64, 64), dtype=np.float32) + np.float32(0.1)).to(dev)
    target = 40.0

    # Gradient descent on log-entries (keeps A positive) toward target λ.
    def grad(logA):
        logA = logA.detach().requires_grad_(True)
        (g,) = torch.autograd.grad((eigenvalue(torch.exp(logA)) - target) ** 2, logA)
        return g

    logA = torch.log(A0)
    lam0 = float(eigenvalue(A0))
    for _ in range(60):
        logA = logA - 0.5 * grad(logA)
    lam1 = float(eigenvalue(torch.exp(logA)))
    print(f"λ: {lam0:.3f} → {lam1:.3f} (target {target})")
    if abs(lam1 - target) >= 0.5:
        raise AssertionError(f"λ = {lam1} missed the target {target}")

    # Eigenvector sensitivities via the full eigenpair VJP: how does each
    # matrix entry move component 0 of the Perron vector?
    A = A0.clone().requires_grad_(True)
    lam, v = eigenpair(A)
    cot = torch.zeros_like(v)
    cot[0] = 1.0
    (dA,) = torch.autograd.grad((lam, v), A, (torch.zeros_like(lam), cot))
    at = np.unravel_index(int(torch.argmax(dA.abs())), tuple(dA.shape))
    print(
        f"∂v[0]/∂A: max |sensitivity| {float(dA.abs().max()):.2e} "
        f"at entry {tuple(int(i) for i in at)}"
    )

    # Matrix-free: differentiate λ of a Hankel OPERATOR with respect to its
    # O(n) profile — the n² matrix never exists, forward or backward.
    n = 256
    h0 = (torch.tensor(1.0) / torch.arange(1, 2 * n, dtype=torch.float32)).to(dev)  # Hilbert
    lam_of_profile = eigenvalue_operator(lambda h: hankel_matvec(h, n), n, device=dev)
    h = h0.clone().requires_grad_(True)
    lam_h = lam_of_profile(h)
    (g,) = torch.autograd.grad(lam_h, h)
    lam_h = lam_h.detach()
    k = int(torch.argmax(g.abs()))
    print(
        f"matrix-free ∂λ/∂h (n={n}): λ = {float(lam_h):.5f}, "
        f"most sensitive profile entry k = {k} (gradient {float(g[k]):.4f})"
    )


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cpu to run on the CPU (default: the card)")
    main(ap.parse_args().device)
