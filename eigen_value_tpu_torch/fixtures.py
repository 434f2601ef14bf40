"""Test and bench fixtures (counterparts of ``eigen_value_tpu.fixtures``).

Each generator takes an explicit ``device``; random fixtures take a
``torch.Generator``.  The anchor and round table are copies of the JAX
package's constants (importing them would pull in jax);
tests/test_torch_fixtures.py holds the copies equal to the originals.
"""

from __future__ import annotations

import numpy as np
import torch


#: Rows of the Hilbert matrix formed at a time: the int32 divisor of a whole
#: 65536² matrix would take 16 GiB beside the 8 GiB bf16 result.
HILBERT_BLOCK_ROWS = 4096


def hilbert_matrix(n: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Hilbert matrix ``A[r][c] = 1/(r+c+1)`` with the reference's arithmetic:
    the divisor is formed in integers, converted, and the reciprocal taken in
    ``dtype`` — bitwise equal to the JAX fixture.  Formed a block of
    :data:`HILBERT_BLOCK_ROWS` rows at a time, directly in ``dtype`` on
    ``device`` (no float32 copy of a bf16 matrix)."""
    i = torch.arange(n, dtype=torch.int32, device=device)
    one = torch.tensor(1.0, dtype=dtype, device=device)
    if n <= HILBERT_BLOCK_ROWS:
        return one / (i[:, None] + i[None, :] + 1).to(dtype)
    out = torch.empty(n, n, dtype=dtype, device=device)
    for r in range(0, n, HILBERT_BLOCK_ROWS):
        rows = i[r:r + HILBERT_BLOCK_ROWS, None]
        torch.div(one, (rows + i[None, :] + 1).to(dtype), out=out[r:r + HILBERT_BLOCK_ROWS])
    return out


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


def scaled_hilbert_matrix(
    n: int, generator: torch.Generator | None = None, scale: float = 0.01, dtype=torch.float32,
    device="cpu",
) -> torch.Tensor:
    """The Hilbert matrix scaled entry by entry by ``1 + scale·s``, s
    symmetric and U(0, 1): symmetric and positive, with the Hilbert
    matrix's spectrum nearly and other bits, the kind of matrix the
    benchmark's cells solve.  Formed in float32 from the generator's draw
    (CPU by default), then cast and moved."""
    u = torch.rand((n, n), generator=generator)
    return (hilbert_matrix(n) * (1.0 + scale * ((u + u.T) / 2))).to(dtype).to(device)


#: The 3×3 cross-implementation anchor (reference tests/test.cpp:79-104).
ANCHOR_3X3 = np.array([[1.0, 1.0, 2.0], [2.0, 1.0, 3.0], [2.0, 3.0, 5.0]])
ANCHOR_3X3_EIGENVALUE = 7.531129
ANCHOR_3X3_EIGENVECTOR = (0.394074, 0.578844, 0.997451)

#: Hardware-independent round counts for Hilbert matrices — the primary
#: parity target.
HILBERT_ROUNDS = {128: 9, 256: 10, 512: 12, 1024: 13, 2048: 14, 4096: 15, 8192: 17}
