"""The oracle CLI, the reference's ``main.py`` harness (counterpart of
``python -m eigen_value_tpu.oracle``, with its arguments, anchor and table).

    python -m eigen_value_tpu_torch.oracle [--semantics sequential|parallel]
        [--min-pow 5] [--max-pow 10]

Runs a NumPy oracle (``reference_impl.py``) over random matrices 32²…1024²,
checks λ against ``np.linalg.eigvals``, and prints the reference's table
(``main.py:61-70``).  The 3×3 anchor is checked first, like the reference's
handwritten test (``main.py:51-58``).  Needs numpy only at run time (and
the port's package for its constants); no card, no jax.
"""

from __future__ import annotations

import argparse
import sys
from time import time

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="eigen_value_tpu_torch.oracle")
    p.add_argument("--min-pow", type=int, default=5)
    p.add_argument("--max-pow", type=int, default=10)
    p.add_argument(
        "--semantics",
        choices=["sequential", "parallel"],
        default="sequential",
        help="which reference semantics to run (float64/adjacent vs float32/wraparound)",
    )
    args = p.parse_args(argv)

    from ..config import EPS
    from ..reference_impl import parallel_oracle, sequential_oracle

    oracle = sequential_oracle if args.semantics == "sequential" else parallel_oracle

    # the handwritten test (main.py:51-58)
    mat = np.array([[1, 1, 2], [2, 1, 3], [2, 3, 5]], dtype=np.float64)
    res = oracle(mat)
    assert abs(res.eigenvalue - 7.5311) < EPS
    for got, want in zip(res.eigenvector, (0.3941, 0.5788, 0.9975)):
        assert abs(got - want) < EPS

    print(
        f"{args.semantics.capitalize()} Similarity Transform, "
        "for finding maximum eigen value ( with vector )\n"
    )
    rng = np.random.default_rng(0)
    for dim in range(args.min_pow, args.max_pow + 1):
        n = 1 << dim
        mat = rng.random((n, n))
        start = time() * 1000
        res = oracle(mat)
        end = time() * 1000

        assert res.converged, f"oracle did not converge at {n}²"
        assert abs(res.eigenvalue - np.max(np.real(np.linalg.eigvals(mat)))) < EPS
        print(
            f"{n:<4} x {n:>4}\t\t{end - start:>6.2f} ms\t\t{res.rounds:>8} round(s)"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
