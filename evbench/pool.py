"""The caller's matrices, made on the device from ``--seed``.

``hilbert_scaled``: the Hilbert matrix scaled elementwise by a seeded
symmetric factor, ``A = H ∘ (1 + scale·(U + Uᵀ)/2)`` with ``U ~ U(0, 1)``
and ``H[i, j] = 1/(i + j + 1)``.  Every product is positive and bitwise
symmetric: each square block pair is formed once and written to both of
its places.  A seed changes the entries but not the work: the round count
of the Hilbert matrix holds for every seed (PERF.md).

``U`` is drawn by a ``torch.Generator`` on the matrix's device, a block of
rows at a time, into the matrix's own storage, and each block pair is
formed in float32 and stored once in the configuration's dtype, so a
65536² bfloat16 matrix never has a float32 copy.
"""

from __future__ import annotations

import hashlib
from typing import List

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16,
          "float64": torch.float64}
#: Rows (and columns) of one block: a float32 block of 8192 x 65536 is 2 GiB.
BLOCK = 8192


def storage_dtype(config: dict) -> torch.dtype:
    """The dtype A is held in: ``storage_dtype`` when the configuration
    states one, else ``dtype``."""
    return DTYPES[config.get("storage_dtype") or config["dtype"]]


def matrix_seed(seed: int, index: int) -> int:
    """The generator seed of pool matrix ``index`` under run seed ``seed``
    (any whole number), in 63 bits."""
    digest = hashlib.sha256(f"evbench:{seed}:{index}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def hilbert_scaled(n: int, dtype: torch.dtype, scale: float, seed: int,
                   device: torch.device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    A = torch.empty(n, n, dtype=dtype, device=device)
    for r in range(0, n, BLOCK):
        A[r:r + BLOCK] = torch.rand(min(BLOCK, n - r), n, generator=gen, device=device)
    idx = torch.arange(n, dtype=torch.float32, device=device)
    for i in range(0, n, BLOCK):
        for j in range(i, n, BLOCK):
            u = A[i:i + BLOCK, j:j + BLOCK].float()
            ut = A[j:j + BLOCK, i:i + BLOCK].float().T
            # u + ut adds the same two values at (a, b) and at (b, a): the
            # diagonal blocks come out bitwise symmetric
            s = 1.0 + scale * ((u + ut) / 2)
            h = 1.0 / (idx[i:i + BLOCK, None] + idx[None, j:j + BLOCK] + 1.0)
            block = (h * s).to(dtype)
            A[i:i + BLOCK, j:j + BLOCK] = block
            if j != i:
                A[j:j + BLOCK, i:i + BLOCK] = block.T
    return A


MATRICES = {"hilbert_scaled": hilbert_scaled}


def make_pool(config: dict, size: int, seed: int, device: torch.device) -> List[torch.Tensor]:
    """``size`` distinct matrices of the configuration for run seed ``seed``."""
    make = MATRICES[config["matrix"]]
    return [
        make(config["n"], storage_dtype(config), config["scale"], matrix_seed(seed, k), device)
        for k in range(size)
    ]
