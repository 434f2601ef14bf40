"""The caller's matrices: made from the seed, bitwise symmetric, positive."""

import pytest
import torch

from evbench import pool

CPU = torch.device("cpu")


def config(n, storage=None):
    return {"matrix": "hilbert_scaled", "n": n, "dtype": "float32", "storage_dtype": storage,
            "scale": 0.25}


@pytest.mark.parametrize("storage", [None, "bfloat16"])
@pytest.mark.parametrize("block", [pool.BLOCK, 96])
def test_symmetric_positive_and_seeded(monkeypatch, storage, block):
    monkeypatch.setattr(pool, "BLOCK", block)
    a, b = pool.make_pool(config(320, storage), 2, 2**31 + 5, CPU)
    again = pool.make_pool(config(320, storage), 2, 2**31 + 5, CPU)
    other = pool.make_pool(config(320, storage), 1, 2**31 + 6, CPU)[0]
    assert a.dtype == pool.storage_dtype(config(320, storage))
    for A in (a, b):
        assert torch.equal(A, A.T)
        assert bool((A > 0).all())
    assert torch.equal(a, again[0]) and torch.equal(b, again[1])
    assert not torch.equal(a, b) and not torch.equal(a, other)


def test_entries_are_the_scaled_hilbert():
    A = pool.make_pool(config(64), 1, 3, CPU)[0].double()
    i = torch.arange(64, dtype=torch.float64)
    scale = A * (i[:, None] + i[None, :] + 1)
    assert float(scale.min()) >= 1.0 - 1e-6 and float(scale.max()) <= 1.25 + 1e-6
    # the seed changes the entries, not their law: the mean factor is ~1.125
    assert abs(float(scale.mean()) - 1.125) < 0.01


def test_matrix_seed_takes_any_whole_number():
    seeds = {pool.matrix_seed(s, k) for s in (0, 1, 2**31 + 1, 2**40) for k in range(4)}
    assert len(seeds) == 16
    assert all(0 <= s < 2**63 for s in seeds)
