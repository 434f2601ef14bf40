"""The port's batched solves (``eigen_value_tpu_torch/parallel/batched.py``,
``api.max_eigenvalue_batch``) against the JAX package's.

Counterparts of tests/test_parallel.py's ``TestBatched`` /
``TestBatchedMixedConvergence``, tests/test_api.py's batch tests and
tests/test_config_consistency.py's relative-stop batch: the same numpy
matrices go to JAX's ``solve_batched`` (its vmapped ``solve_matvec``, plain
XLA: no Pallas kernel runs there) and to the port on the CPU.  Round counts
and convergence flags are exact per matrix; λ within rel 1e-6 and ev within
1e-5 (the JAX tests' own bounds; the batched product sums in another order
than JAX's).  A 2-byte batch follows the port's storage contract and is held
bit for bit to ``solve_matvec_kernel`` of each stored matrix; the sharded
batch is tests/test_torch_sharded.py's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import eigen_value_tpu as J  # noqa: E402
from eigen_value_tpu.parallel.batched import solve_batched as jax_batched  # noqa: E402

import eigen_value_tpu_torch as evt  # noqa: E402
from eigen_value_tpu_torch import fixtures as tfx  # noqa: E402
from eigen_value_tpu_torch.ops.cuda import kernels as tk  # noqa: E402
from eigen_value_tpu_torch.ops.solver_matvec import solve_matvec, solve_matvec_kernel  # noqa: E402
from eigen_value_tpu_torch.parallel import solve_batched  # noqa: E402

EPS, MAX_ITR = 1e-3, 1000
LAM_REL, EV_ATOL = 1e-6, 1e-5


def batch(rng, b, n, lo=1e-4):
    return np.stack([rng.random((n, n), dtype=np.float32) + np.float32(lo) for _ in range(b)])


def assert_matches_jax(got, want):
    np.testing.assert_array_equal(got.rounds.numpy(), np.asarray(want.rounds))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
    np.testing.assert_allclose(got.eigenvalue.numpy(), np.asarray(want.eigenvalue), rtol=LAM_REL)
    np.testing.assert_allclose(got.eigenvector.numpy(), np.asarray(want.eigenvector),
                               atol=EV_ATOL)


def test_per_matrix_round_counts(rng):
    mats = batch(rng, 4, 128)
    got = solve_batched(torch.from_numpy(mats), EPS, MAX_ITR)
    assert got.rounds.dtype == torch.int32 and got.eigenvector.shape == (4, 128)
    assert_matches_jax(got, jax_batched(jnp.asarray(mats), EPS, MAX_ITR))
    for b in range(4):  # each matrix is its own single solve
        want = solve_matvec(torch.from_numpy(mats[b]), EPS, MAX_ITR)
        assert int(got.rounds[b]) == int(want.rounds)
        assert float(got.eigenvalue[b]) == pytest.approx(float(want.eigenvalue), rel=LAM_REL)


def test_batched_hilbert_converges():
    As = torch.stack([tfx.hilbert_matrix(128)] * 3)
    res = solve_batched(As, EPS, MAX_ITR)
    assert bool(res.converged.all())
    assert (res.rounds == tfx.HILBERT_ROUNDS[128]).all()
    assert torch.equal(res.eigenvalue, res.eigenvalue[:1].expand(3))  # one matrix, one answer
    single = solve_matvec(tfx.hilbert_matrix(128), EPS, MAX_ITR)
    # bmm and mv sum in their own orders
    assert float(res.eigenvalue[0]) == pytest.approx(float(single.eigenvalue), rel=LAM_REL)


@pytest.mark.parametrize("cap", [0, 2, 3])
def test_cap_hit_subset_keeps_per_matrix_flags(rng, cap):
    """Some matrices hit the cap, others converge: flags, rounds and λ stay
    per matrix, as JAX's and as each single solve gives them."""
    mats = batch(rng, 4, 96)
    got = solve_batched(torch.from_numpy(mats), EPS, cap)
    assert_matches_jax(got, jax_batched(jnp.asarray(mats), EPS, cap))
    for b in range(4):
        want = solve_matvec(torch.from_numpy(mats[b]), EPS, cap)
        assert bool(got.converged[b]) == bool(want.converged)
        assert int(got.rounds[b]) == int(want.rounds)
        assert float(got.eigenvalue[b]) == pytest.approx(float(want.eigenvalue), rel=LAM_REL)


def test_a_mixed_batch_converges_and_caps_in_one_call(rng):
    mats = batch(rng, 3, 64)
    mats[1] = np.asarray(J.fixtures.hilbert_matrix(64))  # converges later than the rest
    full = solve_batched(torch.from_numpy(mats), EPS, MAX_ITR)
    assert bool(full.converged.all()) and len(set(full.rounds.tolist())) > 1
    cap = int(full.rounds.min()) + 1
    got = solve_batched(torch.from_numpy(mats), EPS, cap)
    assert_matches_jax(got, jax_batched(jnp.asarray(mats), EPS, cap))
    assert bool(got.converged.any()) and not bool(got.converged.all())


def test_ev0_is_shared_and_scale_invariant(rng):
    mats = batch(rng, 3, 64)
    ev0 = rng.random(64, dtype=np.float32) + np.float32(0.5)
    got = solve_batched(torch.from_numpy(mats), EPS, MAX_ITR, ev0=torch.from_numpy(ev0))
    assert_matches_jax(got, jax_batched(jnp.asarray(mats), EPS, MAX_ITR, ev0=jnp.asarray(ev0)))
    with pytest.raises(ValueError, match=r"ev0 must have shape \(64,\)"):
        solve_batched(torch.from_numpy(mats), EPS, MAX_ITR, ev0=torch.ones(3, 64))


def test_relative_stop_converges_a_large_lambda_batch(rng):
    """λ ≈ 1e6·n/2: the absolute stop exhausts the cap, the relative one
    converges each matrix as its single relative solve does."""
    mats = (batch(rng, 2, 64, lo=0.1) * np.float32(1e6)).astype(np.float32)
    As = torch.from_numpy(mats)
    res_abs = evt.max_eigenvalue_batch(As, evt.SolverConfig(max_itr=50))
    assert not bool(res_abs.converged.any())
    cfg = evt.SolverConfig(max_itr=200, eps_mode="relative")
    res_rel = evt.max_eigenvalue_batch(As, cfg)
    want = jax_batched(jnp.asarray(mats), EPS, 200, eps_mode="relative")
    assert_matches_jax(res_rel, want)
    for b in range(2):
        ref = evt.max_eigenvalue(As[b], cfg)
        assert int(res_rel.rounds[b]) == int(ref.rounds)
        assert float(res_rel.eigenvalue[b]) == pytest.approx(float(ref.eigenvalue), rel=1e-5)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16])
def test_a_stored_batch_is_each_matrixs_kernel_solve(rng, dt):
    """The storage contract: each matrix is bit for bit
    ``solve_matvec_kernel`` of its stored copy, with f32 state."""
    mats = torch.from_numpy(batch(rng, 3, 128, lo=1e-2))
    got = evt.max_eigenvalue_batch(mats, evt.SolverConfig(storage_dtype=dt))
    assert got.eigenvalue.dtype == torch.float32 and bool(got.converged.all())
    for b in range(3):
        want = solve_matvec_kernel(mats[b].to(dt), EPS, MAX_ITR)
        assert int(got.rounds[b]) == int(want.rounds)
        assert torch.equal(got.eigenvalue[b], want.eigenvalue)
        assert torch.equal(got.eigenvector[b], want.eigenvector)
    f32 = evt.max_eigenvalue_batch(mats)
    np.testing.assert_allclose(got.eigenvalue.numpy(), f32.eigenvalue.numpy(), rtol=2e-3)


def test_a_prequantized_batch_is_solved_as_it_is(monkeypatch):
    """No f32 copy of a batch already in storage_dtype: every product is a
    ``kernels.matvec`` of a bf16 matrix (of the live matrices only)."""
    Hq = tfx.hilbert_matrix(128, dtype=torch.bfloat16)
    mats = torch.stack([Hq, Hq * 2])
    seen = []
    real = tk.matvec

    def spy(A, x):
        seen.append(A.dtype)
        return real(A, x)

    monkeypatch.setattr(tk, "matvec", spy)
    res = evt.max_eigenvalue_batch(mats, evt.SolverConfig(storage_dtype=torch.bfloat16))
    assert set(seen) == {torch.bfloat16}
    assert len(seen) == 2 + int(res.rounds.sum())  # the first products, then a live round each
    assert bool(res.converged.all())
    assert float(res.eigenvalue[1] / res.eigenvalue[0]) == pytest.approx(2.0, abs=0.05)


def test_max_eigenvalue_batch(rng):
    mats = batch(rng, 3, 64)
    res = evt.max_eigenvalue_batch(mats, device="cpu")  # host input, the CPU asked
    assert res.eigenvalue.shape == (3,) and res.eigenvalue.device.type == "cpu"
    for b in range(3):
        v = res.eigenvector[b].numpy()
        assert np.allclose(mats[b] @ v, float(res.eigenvalue[b]) * v, atol=1e-3)
    assert_matches_jax(res, J.max_eigenvalue_batch(mats))


def test_host_input_goes_to_the_card_or_raises(rng, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evt.max_eigenvalue_batch(batch(rng, 2, 16))


def test_a_float64_config_solves_in_float64(rng):
    mats = batch(rng, 2, 64)
    res = evt.max_eigenvalue_batch(torch.from_numpy(mats), evt.SolverConfig(dtype=torch.float64))
    assert res.eigenvector.dtype == torch.float64
    for b in range(2):
        want = solve_matvec(torch.from_numpy(mats[b]).double(), EPS, MAX_ITR)
        assert int(res.rounds[b]) == int(want.rounds)


def test_the_batch_must_be_b_n_n():
    with pytest.raises(ValueError, match=r"expected \(B, n, n\), got \(4, 5\)"):
        solve_batched(torch.ones(4, 5), EPS, MAX_ITR)
    with pytest.raises(ValueError, match=r"expected \(B, n, n\), got \(2, 4, 5\)"):
        solve_batched(torch.ones(2, 4, 5), EPS, MAX_ITR)


#: JAX's seven rejections, api.py:645-668, by knob and a piece of its words.
REJECTIONS = {
    "backend": (dict(backend="multiround"), "under vmap the hot op is a batched gemv"),
    "block_rows": (dict(block_rows=256), "the batched body runs no Pallas kernel"),
    "block_cols": (dict(block_cols=256), "the batched body runs no Pallas kernel"),
    "chunk": (dict(chunk=4), "the multiround kernel has no batched form"),
    "cache_tiles": (dict(cache_tiles=4), "the VMEM tile cache is a multiround feature"),
    "interpret": (dict(interpret=True), "the batched body runs no Pallas kernel"),
    "symmetric": (dict(symmetric=True), "the upper-triangle kernel has no batched form"),
}


@pytest.mark.parametrize("knob", sorted(REJECTIONS))
def test_max_eigenvalue_batch_rejects_what_jax_rejects_in_its_words(knob):
    kw, words = REJECTIONS[knob]
    mats = np.ones((2, 8, 8), np.float32)
    with pytest.raises(ValueError) as jax_err:
        J.max_eigenvalue_batch(mats, J.SolverConfig(**kw))
    with pytest.raises(ValueError) as port_err:
        evt.max_eigenvalue_batch(torch.from_numpy(mats), evt.SolverConfig(**kw))
    assert words in str(port_err.value)
    assert str(port_err.value).split(" — ")[1] == str(jax_err.value).split(" — ")[1]
    assert str(port_err.value).startswith(f"{knob}=")


def test_a_mesh_is_not_ported_yet():
    # the mesh door is ported (tests/test_torch_sharded.py); what is no mesh
    # with a 'batch' dimension is rejected with the JAX package's words
    with pytest.raises(ValueError, match="a batched mesh needs a 'batch' axis"):
        evt.max_eigenvalue_batch(torch.ones(2, 8, 8), mesh=object())


def test_the_matvec_backend_is_honored(rng):
    mats = torch.from_numpy(batch(rng, 2, 32))
    a = evt.max_eigenvalue_batch(mats, evt.SolverConfig(backend="matvec"))
    b = evt.max_eigenvalue_batch(mats)
    assert torch.equal(a.eigenvector, b.eigenvector)
