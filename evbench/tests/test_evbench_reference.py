"""The plain reference against the reference's own anchors, and against
the port's plain CPU path (the test may import the port; the reference
may not)."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from evbench import pool, reference

#: itzmeanjan/eigen_value tests/test.cpp:79-104
ANCHOR_3X3 = [[1.0, 1.0, 2.0], [2.0, 1.0, 3.0], [2.0, 3.0, 5.0]]
ANCHOR_EIGENVALUE = 7.531129
ANCHOR_EIGENVECTOR = (0.394074, 0.578844, 0.997451)
#: rounds of the Hilbert matrix in float32 (the reference's sweep)
HILBERT_ROUNDS = {128: 9, 256: 10, 512: 12, 1024: 13}


def hilbert(n):
    i = torch.arange(n, dtype=torch.int32)
    return 1.0 / (i[:, None] + i[None, :] + 1).to(torch.float32)


def test_anchor():
    """λ at the stop lies within 1e-4 of the anchor (the stop is at 1e-3),
    after 4 rounds."""
    sol = reference.solve(torch.tensor(ANCHOR_3X3, dtype=torch.float32), 1e-3, 1000)
    assert (sol.rounds, sol.converged) == (4, True)
    assert sol.eigenvalue == pytest.approx(ANCHOR_EIGENVALUE, abs=1e-4)
    ev = sol.eigenvector.numpy()
    np.testing.assert_allclose(ev / ev.max(), np.array(ANCHOR_EIGENVECTOR) / 0.997451,
                               atol=1e-4)


@pytest.mark.parametrize("n", sorted(HILBERT_ROUNDS))
def test_hilbert_round_table(n):
    sol = reference.solve(hilbert(n), 1e-3, 1000)
    assert (sol.rounds, sol.converged) == (HILBERT_ROUNDS[n], True)


def test_cap_reports_the_last_checked_round():
    sol = reference.solve(hilbert(256), 1e-3, 3)
    assert (sol.rounds, sol.converged) == (3, False)
    zero = reference.solve(hilbert(256), 1e-3, 0)
    assert (zero.rounds, zero.converged, zero.eigenvalue) == (0, False, 0.0)


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("storage", [None, "bfloat16"])
def test_against_the_ports_plain_path(symmetric, storage):
    from eigen_value_tpu_torch import SolverConfig, max_eigenvalue

    cfg = {"matrix": "hilbert_scaled", "n": 384, "dtype": "float32",
           "storage_dtype": storage, "scale": 0.25}
    A = pool.make_pool(cfg, 1, 2**31 + 11, torch.device("cpu"))[0]
    ref = reference.solve(A, 1e-3, 1000)
    got = max_eigenvalue(A, SolverConfig(symmetric=symmetric,
                                         storage_dtype=pool.DTYPES.get(storage)))
    assert (int(got.rounds), bool(got.converged)) == (ref.rounds, ref.converged)
    assert float(got.eigenvalue) == pytest.approx(ref.eigenvalue, rel=1e-6)
    np.testing.assert_allclose(got.eigenvector.double().numpy(), ref.eigenvector.numpy(),
                               rtol=0, atol=1e-6 * float(ref.eigenvector.max()))


def test_blocks_of_rows_change_nothing(monkeypatch):
    A = hilbert(300)
    whole = reference.solve(A, 1e-3, 1000)
    monkeypatch.setattr(reference, "BLOCK_BYTES", 7 * 300 * 8)
    blocked = reference.solve(A, 1e-3, 1000)
    assert blocked.rounds == whole.rounds
    assert blocked.eigenvalue == pytest.approx(whole.eigenvalue, rel=1e-14)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 2**-12, -(1.0 + 2**-11), 3e-5])
    got = reference.tf32_round(x)
    assert got[:5].tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2**-10, 1.0, -(1.0 + 2**-10)]
    # 10 mantissa bits kept: the low 13 of 23 are zero
    assert int((got.view(torch.int32) & 0x1FFF).abs().sum()) == 0


def test_fp8_rows_keep_each_rows_scale():
    blk = torch.tensor([[448.0, 1.0, 0.5], [1e-3, 2e-3, 4e-3]])
    q = reference.fp8_rows(blk)
    assert q[0, 0] == 448.0 and q[1, 2] == pytest.approx(4e-3, rel=1e-6)
    assert float(((q - blk).abs() / blk).max()) <= 2**-4


def test_reference_imports_nothing_of_the_port():
    src = Path(reference.__file__).read_text()
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0] if not node.level else "evbench")
    assert names <= {"__future__", "typing", "torch"}, names

