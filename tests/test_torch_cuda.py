"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Imports torch and the port only, so it runs on a machine without jax:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(--noconftest skips tests/conftest.py, which sets up jax).  Every test here
needs a CUDA device and skips without one.
"""

import pytest

torch = pytest.importorskip("torch")

import eigen_value_tpu_torch as evt  # noqa: E402
from eigen_value_tpu_torch import fixtures as tfx  # noqa: E402
from eigen_value_tpu_torch.api import resolve_backend  # noqa: E402
from eigen_value_tpu_torch.ops.cuda import kernels as tk  # noqa: E402
from eigen_value_tpu_torch.ops.solver_matvec import (  # noqa: E402
    solve_matvec_kernel,
    solve_multiround,
)

EPS, MAX_ITR = 1e-3, 1000
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n", [3, 1001, 4096])
def test_matvec_matches_f64(cuda, n):
    g = torch.Generator().manual_seed(n)
    A = tfx.random_positive_matrix(n, g, device=cuda)
    x = (torch.rand(n, generator=g) + 0.5).to(cuda)
    before = tk.matvec.launches
    got = tk.matvec(A, x)
    torch.cuda.synchronize()
    assert tk.matvec.launches == before + 1
    want = A.double() @ x.double()
    # positive terms: the f32 row error stays ~sqrt(n/32) ulps
    assert float(((got.double() - want).abs() / want).max()) < 2e-5
    assert torch.equal(got, tk.matvec(A, x))  # no atomics: bitwise reproducible


@pytest.mark.parametrize("init", [True, False])
def test_multiround_matches_plain(cuda, init):
    H = tfx.hilbert_matrix(1024, device=cuda)
    ev = torch.ones(1024, device=cuda)
    v, lam = ev, torch.zeros((), device=cuda)
    if not init:
        ev, v, _, lam = tk.multiround_plain(H, ev, ev, lam, MAX_ITR, chunk=3, eps=EPS, init=True)
    got = tk.multiround(H, ev, v, lam, MAX_ITR, chunk=5, eps=EPS, init=init)
    want = tk.multiround_plain(H, ev, v, lam, MAX_ITR, chunk=5, eps=EPS, init=init)
    assert int(got[2]) == int(want[2])
    for g, w in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=0)


@pytest.mark.parametrize("cap", [0, 1, 9, 13, 14])
def test_multiround_cap_bitidentical_to_kernel_loop(cuda, cap):
    H = tfx.hilbert_matrix(1024, device=cuda)
    got = solve_multiround(H, EPS, cap, chunk=4)
    want = solve_matvec_kernel(H, EPS, cap)
    assert int(got.rounds) == int(want.rounds) and bool(got.converged) == bool(want.converged)
    assert torch.equal(got.eigenvalue, want.eigenvalue)
    assert torch.equal(got.eigenvector, want.eigenvector)


def test_auto_routes_by_the_cards_shared_memory(cuda):
    cfg = evt.SolverConfig()
    assert resolve_backend(cfg, 8192, cuda) == "multiround"
    assert resolve_backend(cfg, 57856, cuda) == "multiround"  # 4n + 1 KiB = 227 KiB
    assert resolve_backend(cfg, 65536, cuda) == "matvec_pallas"


def test_default_chunk_solves_in_one_launch(cuda):
    H = tfx.hilbert_matrix(1024, device=cuda)
    before = tk.multiround.launches
    got = solve_multiround(H, EPS, MAX_ITR)
    assert tk.multiround.launches == before + 1
    assert int(got.rounds) == tfx.HILBERT_ROUNDS[1024] and bool(got.converged)


@pytest.mark.parametrize("n", [3, 96, 1000, 2048])
def test_auto_backend_solves_through_the_kernel(cuda, n):
    A = (
        torch.tensor(tfx.ANCHOR_3X3, dtype=torch.float32, device=cuda)
        if n == 3
        else tfx.hilbert_matrix(n, device=cuda)
    )
    before = tk.multiround.launches
    res = evt.max_eigenvalue(A)
    assert tk.multiround.launches > before
    assert bool(res.converged)
    if n in tfx.HILBERT_ROUNDS:
        assert int(res.rounds) == tfx.HILBERT_ROUNDS[n]
    assert float(evt.eigen_residual(A, res)) < 1e-3
    for chunk in (1, 5, 18):
        got = solve_multiround(A, EPS, MAX_ITR, chunk=chunk)
        want = solve_matvec_kernel(A, EPS, MAX_ITR)
        assert torch.equal(got.eigenvector, want.eigenvector)
        assert int(got.rounds) == int(want.rounds)
