"""Test and bench fixtures (counterparts of ``eigen_value_tpu.fixtures``).

Each generator takes an explicit ``device``; random fixtures take a
``torch.Generator``.  The anchor and round table are copies of the JAX
package's constants (importing them would pull in jax);
tests/test_torch_fixtures.py holds the copies equal to the originals.
"""

from __future__ import annotations

import numpy as np
import torch


def hilbert_matrix(n: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Hilbert matrix ``A[r][c] = 1/(r+c+1)`` with the reference's arithmetic:
    the divisor is formed in integers, converted, and the reciprocal taken in
    ``dtype`` — bitwise equal to the JAX fixture."""
    i = torch.arange(n, dtype=torch.int32, device=device)
    d = (i[:, None] + i[None, :] + 1).to(dtype)
    return torch.tensor(1.0, dtype=dtype, device=device) / d


def identity_matrix(n: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Identity matrix — every row sums to 1."""
    return torch.eye(n, dtype=dtype, device=device)


def ramp_vector(n: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """``(1, 2, ..., n)`` — max fixture: max == n."""
    return (torch.arange(n, dtype=torch.int32, device=device) + 1).to(dtype)


def stop_success_vector(n: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Constant ``1 + 1e-4``: the stop check must pass."""
    return torch.full((n,), 1.0 + 1e-4, dtype=dtype, device=device)


def stop_fail_vector(n: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """``(i+1) * 1e-4``: adjacent diffs pass but the wraparound pair
    ``|v[n-1] - v[0]|`` is large, so the stop must fail."""
    return ramp_vector(n, dtype, device) * torch.tensor(1e-4, dtype=dtype, device=device)


def random_positive_matrix(
    n: int, generator: torch.Generator | None = None, dtype=torch.float32, device="cpu"
) -> torch.Tensor:
    """Entries U(1e-4, 1): positive, bounded away from 0.  Drawn on the
    generator's device (CPU by default) and then moved, so one seed gives
    the same matrix on every device."""
    a = torch.rand((n, n), generator=generator, dtype=dtype)
    return (a * (1.0 - 1e-4) + 1e-4).to(device)


#: The 3×3 cross-implementation anchor (reference tests/test.cpp:79-104).
ANCHOR_3X3 = np.array([[1.0, 1.0, 2.0], [2.0, 1.0, 3.0], [2.0, 3.0, 5.0]])
ANCHOR_3X3_EIGENVALUE = 7.531129
ANCHOR_3X3_EIGENVECTOR = (0.394074, 0.578844, 0.997451)

#: Hardware-independent round counts for Hilbert matrices — the primary
#: parity target.
HILBERT_ROUNDS = {128: 9, 256: 10, 512: 12, 1024: 13, 2048: 14, 4096: 15, 8192: 17}
