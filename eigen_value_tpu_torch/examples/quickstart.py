"""Quickstart: the reference wrapper's workflow on the port (counterpart of
``examples/quickstart.py``).

Mirrors the reference's wrapper/python/test.py (4 solves of random positive
1024² float32 matrices, asserting A·v ≈ λ·v) plus the functional API, the
bf16 fast mode and the symmetric fast path.

Run: python -m eigen_value_tpu_torch.examples.quickstart [--device cpu]
"""

import argparse

import numpy as np
import torch

from eigen_value_tpu_torch import EigenValue, SolverConfig, max_eigenvalue
from eigen_value_tpu_torch.device import solve_device


def main(device=None) -> None:
    dev = solve_device(device)
    rng = np.random.default_rng(0)

    # ── class API: same return tuple as the reference wrapper ──────────
    ev = EigenValue(device=dev)
    ev.warmup([1024])  # builds the kernels and launch plans of 1024² (the .so setup analog)
    for i in range(4):
        mat = rng.random((1024, 1024), dtype=np.float32)
        lam, vec, ts_ms, rounds = ev.similarity_transform(mat)
        if not np.allclose(mat @ vec, lam * vec, atol=1e-3):
            raise AssertionError(f"solve {i}: A·v differs from λ·v")
        print(f"[{i}] λ = {lam:.5f}   {ts_ms:7.2f} ms   {rounds} round(s)")

    # ── functional API: a SolveResult of tensors ────────────────────────
    mat = rng.random((512, 512), dtype=np.float32)
    res = max_eigenvalue(mat, device=dev)
    print(
        f"functional: λ = {float(res.eigenvalue):.5f}, "
        f"rounds = {int(res.rounds)}, converged = {bool(res.converged)}"
    )

    # ── fast mode: A kept in bf16 (half the bytes a round; ev and sums f32) ──
    res16 = max_eigenvalue(mat, SolverConfig(storage_dtype=torch.bfloat16), device=dev)
    print(f"bf16 fast mode: λ = {float(res16.eigenvalue):.5f}")

    # ── symmetric fast path (the headline's backend) ─────────────────────
    # DECLARE a symmetric matrix and the solver streams only the upper
    # triangle, keeping part of it in the card's shared memory; or pass
    # validate=True: a matrix that checks bitwise symmetric on the card is
    # promoted to the same path.
    sym = torch.from_numpy((mat + mat.T) / 2).to(dev)
    res_sym = max_eigenvalue(sym, SolverConfig(symmetric=True))
    res_val = max_eigenvalue(sym, validate=True)  # checked + auto-promoted
    if abs(float(res_sym.eigenvalue) - float(res_val.eigenvalue)) >= 1e-3:
        raise AssertionError("declared and validated symmetric solves disagree")
    print(
        f"symmetric path: λ = {float(res_sym.eigenvalue):.5f} "
        f"({int(res_sym.rounds)} rounds; declared vs validated agree)"
    )


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cpu to run on the CPU (default: the card)")
    main(ap.parse_args().device)
