"""The port's differentiable solves (``eigen_value_tpu_torch/ops/autodiff.py``)
against the JAX package's ``ops/autodiff.py``, and the structured operators'
gradient in their profiles (``ops/structured.py``).

Counterparts of tests/test_autodiff.py: the same numpy inputs go to JAX's
custom VJPs and to the port's ``torch.autograd.Function``\\ s on the CPU.
Gradients are held to JAX's (f32: within the bounds stated at each test,
the two solves summing in other orders), to finite differences (the JAX
tests' bounds) and to the closed forms.  JAX's ``jit`` / ``vmap``
compositions have no counterpart: the port's solves are host loops.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from eigen_value_tpu.ops import autodiff as jad  # noqa: E402
from eigen_value_tpu.ops import structured as jst  # noqa: E402

from eigen_value_tpu_torch import fixtures as tfx  # noqa: E402
from eigen_value_tpu_torch.ops import autodiff as ad  # noqa: E402
from eigen_value_tpu_torch.ops import structured as st  # noqa: E402


def t(a, grad=False) -> torch.Tensor:
    x = torch.from_numpy(np.ascontiguousarray(a))
    return x.requires_grad_(True) if grad else x


def grad_of(fn, x: torch.Tensor) -> torch.Tensor:
    x = x.detach().clone().requires_grad_(True)
    (g,) = torch.autograd.grad(fn(x), x)
    return g


def pair_vjp(fn, x, lam_bar, v_bar):
    x = x.detach().clone().requires_grad_(True)
    lam, v = fn(x)
    (g,) = torch.autograd.grad((lam, v), x, (torch.as_tensor(lam_bar, dtype=lam.dtype), v_bar))
    return g


# ------------------------------------------------------------------ eigenvalue


def test_value_matches_solver(rng):
    m = rng.random((32, 32), dtype=np.float32) + 0.1
    lam = ad.eigenvalue(t(m))
    lam_np = np.max(np.real(np.linalg.eigvals(m.astype(np.float64))))
    assert abs(float(lam) - lam_np) < 1e-2
    assert float(lam) == pytest.approx(float(jad.eigenvalue(jnp.asarray(m))), rel=1e-6)


@pytest.mark.parametrize("n", [8, 64])
def test_grad_matches_jax(rng, n):
    m = rng.random((n, n), dtype=np.float32) + 0.5
    got = grad_of(ad.eigenvalue, t(m)).numpy()
    want = np.asarray(jax.grad(jad.eigenvalue)(jnp.asarray(m)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    # the closed form from a float64 eig
    w, V = np.linalg.eig(m.astype(np.float64))
    wl, U = np.linalg.eig(m.T.astype(np.float64))
    v, u = np.real(V[:, np.argmax(np.real(w))]), np.real(U[:, np.argmax(np.real(wl))])
    np.testing.assert_allclose(got, np.outer(u, v) / (u @ v), rtol=1e-3, atol=1e-5)


def test_grad_matches_finite_differences(rng):
    m = rng.random((8, 8)).astype(np.float32) + 0.5
    g = grad_of(ad.eigenvalue, t(m))
    h = 1e-2
    for (r, c) in [(0, 0), (2, 5), (7, 1)]:
        mp, mm = m.copy(), m.copy()
        mp[r, c] += h
        mm[r, c] -= h
        fd = (float(ad.eigenvalue(t(mp))) - float(ad.eigenvalue(t(mm)))) / (2 * h)
        assert abs(float(g[r, c]) - fd) < 5e-2, (r, c, float(g[r, c]), fd)


def test_grad_rows_sum_structure(rng):
    m = rng.random((16, 16), dtype=np.float32) + 0.5
    g = grad_of(ad.eigenvalue, t(m))
    h = 1e-3
    fd = (float(ad.eigenvalue(t(m + h))) - float(ad.eigenvalue(t(m - h)))) / (2 * h)
    assert abs(float(g.sum()) - fd) < 5e-2


def test_the_backward_pass_solves_on_the_transpose_view(rng, monkeypatch):
    """u comes from a solve on ``A.T``, a view: no copy of A."""
    m = t(rng.random((16, 16), dtype=np.float32) + 0.5)
    seen = []
    real = ad.solve_matvec

    def spy(A, eps, max_itr):
        seen.append((A.data_ptr(), A.is_contiguous()))
        return real(A, eps, max_itr)

    monkeypatch.setattr(ad, "solve_matvec", spy)
    grad_of(ad.eigenvalue, m)
    assert len(seen) == 2 and seen[0][0] == seen[1][0] and seen[1][1] is False


# ------------------------------------------------------------------- eigenpair


def _setup(n=12, seed=3):
    rng = np.random.default_rng(seed)
    A = rng.random((n, n)) + 0.1
    return A, rng.standard_normal(), rng.standard_normal(n), rng.standard_normal((n, n))


def test_pair_vjp_matches_finite_differences():
    A, lam_bar, v_bar, E = _setup()
    fn = lambda M: ad.eigenpair(M, 1e-12, 100000)  # noqa: E731 (tight: FD needs it)
    got = float((pair_vjp(fn, t(A), lam_bar, t(v_bar)) * t(E)).sum())

    def g(M):
        lam, w = fn(t(M))
        return lam_bar * float(lam) + float(t(v_bar) @ w)

    h = 1e-7
    fd = (g(A + h * E) - g(A - h * E)) / (2 * h)
    assert got == pytest.approx(fd, rel=1e-4, abs=1e-8)


def test_pair_vjp_reduces_to_eigenvalue_adjoint():
    A = t(_setup(seed=5)[0])
    dA = pair_vjp(lambda M: ad.eigenpair(M, 1e-12, 100000), A, 1.0, torch.zeros(12, dtype=A.dtype))
    g = grad_of(lambda M: ad.eigenvalue(M, 1e-12, 100000), A)
    np.testing.assert_allclose(dA.numpy(), g.numpy(), rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("n", [16, 64])
def test_pair_vjp_matches_jax(rng, n):
    A = rng.random((n, n), dtype=np.float32) + 0.1
    v_bar = rng.standard_normal(n).astype(np.float32)
    got = pair_vjp(ad.eigenpair, t(A), 0.7, t(v_bar)).numpy()
    _, vjp = jax.vjp(jad.eigenpair, jnp.asarray(A))
    (want,) = vjp((jnp.float32(0.7), jnp.asarray(v_bar)))
    # both GMRES solves stop at 30·tol (tol 1e-4): agree to ~1e-3 of the scale
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-3 * np.abs(want).max())


def test_normalization_max_is_one():
    H = tfx.hilbert_matrix(128)
    lam, v = ad.eigenpair(H)
    assert float(v.max()) == pytest.approx(1.0)
    Hd, vd = H.double(), v.double()
    assert float((Hd @ vd - float(lam) * vd).abs().max()) < 1e-3


def _fd_check(A: np.ndarray, rng, h: float, rel: float):
    """The JAX test's check, on its inputs (``rng`` continues its draws)."""
    n = A.shape[0]
    cot_v = rng.standard_normal(n).astype(np.float32)
    E = rng.standard_normal((n, n)).astype(np.float32)
    dA = pair_vjp(ad.eigenpair, t(A), 1.0, t(cot_v))
    assert bool(torch.isfinite(dA).all())

    def g(M):
        lam, w = ad.eigenpair(t(M.astype(np.float32)))
        return float(lam) + float(t(cot_v) @ w)

    fd = (g(A + h * E) - g(A - h * E)) / (2 * h)
    assert float((dA * t(E)).sum()) == pytest.approx(fd, rel=rel)


def test_float32_default_dtype_gradient_is_finite_and_close():
    rng = np.random.default_rng(7)
    _fd_check(rng.random((256, 256), dtype=np.float32) + 0.1, rng, 3e-3, 2e-2)


def test_hilbert_256_gradient():
    """Hilbert's spectrum is nearly defective: the near-singular-K stress."""
    _fd_check(tfx.hilbert_matrix(256).numpy(), np.random.default_rng(11), 1e-3, 5e-2)


def test_n1024_random_gradient():
    rng = np.random.default_rng(13)
    _fd_check(rng.random((1024, 1024), dtype=np.float32) + 0.1, rng, 1e-2, 2e-2)


def _bordered_inputs(n, seed):
    rng = np.random.default_rng(seed)
    A = t(rng.random((n, n), dtype=np.float32) + 0.1)
    lam, v = ad.eigenpair(A)
    return A, lam, v, ad._one_hot(v), t(rng.standard_normal(n + 1).astype(np.float32))


def _dense_bordered(A, lam, v, ej, rhs):
    n = A.shape[0]
    KT = np.zeros((n + 1, n + 1))
    KT[:n, :n] = A.double().numpy().T - float(lam) * np.eye(n)
    KT[:n, n] = ej.numpy()
    KT[n, :n] = -v.double().numpy()
    return np.linalg.solve(KT, rhs.double().numpy())


def test_bordered_solve_matches_a_float64_dense_solve():
    A, lam, v, ej, rhs = _bordered_inputs(64, 5)
    sol, resid = ad._solve_bordered(A, lam, v, ej, rhs, tol=1e-4)
    assert resid <= 3e-3
    want = _dense_bordered(A, lam, v, ej, rhs)
    np.testing.assert_allclose(sol.numpy(), want, rtol=1e-2, atol=1e-3 * np.abs(want).max())


def test_bordered_fallback_on_gmres_failure():
    """maxiter=0 returns the zero iterate: the check finds it and the dense
    fallback solves."""
    A, lam, v, ej, rhs = _bordered_inputs(64, 5)
    sol_fb, resid_fb = ad._solve_bordered(A, lam, v, ej, rhs, tol=1e-4, maxiter=0)
    sol_ok, _ = ad._solve_bordered(A, lam, v, ej, rhs, tol=1e-4)
    assert resid_fb < 1e-3
    np.testing.assert_allclose(sol_fb.numpy(), sol_ok.numpy(), rtol=1e-2, atol=1e-3)


def test_a_failing_gmres_is_caught_by_the_residual_check(monkeypatch):
    """The port's GMRES made to fail outright (zeros): the VJP still returns
    the dense solve's gradient."""
    rng = np.random.default_rng(9)
    A = t(rng.random((48, 48), dtype=np.float32) + 0.1)
    v_bar = t(rng.standard_normal(48).astype(np.float32))
    want = pair_vjp(ad.eigenpair, A, 1.0, v_bar)
    monkeypatch.setattr(ad, "_gmres", lambda mv, b, tol, restart, maxiter: torch.zeros_like(b))
    got = pair_vjp(ad.eigenpair, A, 1.0, v_bar)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-3 * float(want.abs().max()))


def test_large_n_fallback_is_matvec_only(monkeypatch):
    """Above _DENSE_FALLBACK_MAX_N the fallback is the 4× GMRES, and it
    rescues a forced failure (the gate shrunk rather than paying n > 1024)."""
    monkeypatch.setattr(ad, "_DENSE_FALLBACK_MAX_N", 4)
    monkeypatch.setattr(torch.linalg, "solve", None)  # no dense solve may run
    A, lam, v, ej, rhs = _bordered_inputs(64, 11)
    sol, resid = ad._solve_bordered(A, lam, v, ej, rhs, tol=1e-4, maxiter=0)
    assert resid < 3e-3


def test_a_missed_bound_warns_and_a_met_one_does_not(monkeypatch, capfd):
    A, lam, v, ej, rhs = _bordered_inputs(32, 3)
    ad._solve_bordered(A, lam, v, ej, rhs, tol=1e-4)
    assert "exceeds its bound" not in capfd.readouterr().err
    monkeypatch.setattr(ad, "_DENSE_FALLBACK_MAX_N", 4)
    monkeypatch.setattr(ad, "_gmres", lambda mv, b, tol, restart, maxiter: torch.zeros_like(b))
    ad._solve_bordered(A, lam, v, ej, rhs, tol=1e-4)
    err = capfd.readouterr().err
    assert "eigen_value_tpu_torch: eigenpair VJP bordered solve residual" in err
    assert "exceeds its bound" in err


def test_gmres_solves_a_small_system_and_stops_on_its_tolerance():
    rng = np.random.default_rng(1)
    M = t(rng.standard_normal((40, 40)) + 40 * np.eye(40))
    b = t(rng.standard_normal(40))
    calls = []

    def mv(x):
        calls.append(1)
        return M @ x

    x = ad._gmres(mv, b, 1e-10, restart=20, maxiter=10)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(M.numpy(), b.numpy()), rtol=1e-8)
    assert len(calls) < 10 * 21 + 1  # stopped before its cap
    # an invariant subspace (breakdown) keeps the normal equations definite
    D = t(np.diag(np.arange(1.0, 41.0)))
    e = torch.zeros(40, dtype=torch.float64)
    e[:3] = 1.0
    x = ad._gmres(lambda y: D @ y, e, 1e-12, restart=20, maxiter=2)
    np.testing.assert_allclose(x.numpy()[:3], [1.0, 0.5, 1 / 3], rtol=1e-10)


# ------------------------------------------------------------------ operators


def hankel_dense(h: np.ndarray, n: int) -> np.ndarray:
    return h[np.add.outer(np.arange(n), np.arange(n))]


def test_structured_profiles_keep_their_graph(rng):
    n = 16
    p = rng.random(2 * n - 1).astype(np.float32) + 0.1
    x = t(rng.random(n).astype(np.float32))
    makers = {
        "hankel": lambda q: st.hankel_matvec(q, n),
        "toeplitz": lambda q: st.toeplitz_matvec(q[:n], torch.cat([q[:1], q[n:]]), n),
        "circulant": lambda q: st.circulant_matvec(q[:n], n),
    }
    for name, make in makers.items():
        y = make(t(p, grad=True))(x)
        assert y.requires_grad, name
        q = t(p, grad=True)
        (g,) = torch.autograd.grad(make(q)(x).sum(), q)
        assert float(g.abs().sum()) > 0, name
        # a profile that needs no grad takes the host float64 spectrum, bit for bit
        frozen = make(t(p))(x)
        np.testing.assert_allclose(y.detach().numpy(), frozen.numpy(), rtol=1e-5, atol=1e-6)


def test_a_frozen_profile_keeps_the_host_spectrum_bit_for_bit(rng):
    n = 64
    h = rng.random(2 * n - 1).astype(np.float32) + 0.1
    m = st._fft_len(2 * n - 1)
    want = np.asarray(jst._spectrum_rfft(h, m))
    for prof in (t(h), t(h, grad=True).detach()):
        assert np.array_equal(st._spectrum_rfft(prof, m, torch.device("cpu")).numpy(), want)
    with torch.no_grad():  # no graph is recorded: the host path
        got = st._spectrum_rfft(t(h, grad=True), m, torch.device("cpu"))
    assert np.array_equal(got.numpy(), want)


def test_hankel_grad_matches_jax_and_the_dense_adjoint(rng):
    """The structured-gradient repair: λ through the Hankel operator has a
    nonzero gradient equal to JAX's and to the dense chain's."""
    n = 48
    h = rng.random(2 * n - 1, dtype=np.float32) + 0.1
    lam_op = ad.eigenvalue_operator(lambda hh: st.hankel_matvec(hh, n), n)
    g_op = grad_of(lam_op, t(h)).numpy()
    assert np.abs(g_op).max() > 0
    want = np.asarray(jax.grad(jad.eigenvalue_operator(
        lambda hh: jst.hankel_matvec(hh, n), n))(jnp.asarray(h)))
    np.testing.assert_allclose(g_op, want, rtol=1e-3, atol=1e-5)
    idx = torch.from_numpy(np.add.outer(np.arange(n), np.arange(n)))
    g_dense = grad_of(lambda hh: ad.eigenvalue(hh[idx]), t(h)).numpy()
    assert float(lam_op(t(h))) == pytest.approx(float(ad.eigenvalue(t(hankel_dense(h, n)))),
                                                rel=1e-4)
    np.testing.assert_allclose(g_op, g_dense, rtol=2e-2, atol=2e-3)


def test_hankel_grad_matches_finite_differences(rng):
    n = 16
    h = rng.random(2 * n - 1, dtype=np.float32) + 0.5
    lam_op = ad.eigenvalue_operator(lambda hh: st.hankel_matvec(hh, n), n)
    g = grad_of(lam_op, t(h))
    step = 1e-2
    for k in (0, 5, 2 * n - 2):
        hp, hm = h.copy(), h.copy()
        hp[k] += step
        hm[k] -= step
        fd = (float(lam_op(t(hp))) - float(lam_op(t(hm)))) / (2 * step)
        assert abs(float(g[k]) - fd) < 5e-2, (k, float(g[k]), fd)


def test_kron_factor_gradient_identity(rng):
    """λ(B ⊗ C) = λ(B)·λ(C) ⇒ ∂λ/∂B = λ(C)·∂λ(B)/∂B."""
    B = rng.random((8, 8), dtype=np.float32) + 0.2
    C = t(rng.random((6, 6), dtype=np.float32) + 0.2)
    lam_op = ad.eigenvalue_operator(lambda BB: st.kron_matvec(BB, C), 48)
    g_op = grad_of(lam_op, t(B)).numpy()
    g_factor = float(ad.eigenvalue(C)) * grad_of(ad.eigenvalue, t(B)).numpy()
    np.testing.assert_allclose(g_op, g_factor, rtol=2e-2, atol=2e-3)


def test_unconverged_solve_warns(rng, capfd):
    n = 16
    h = rng.random(2 * n - 1, dtype=np.float32) + 0.5
    lam_op = ad.eigenvalue_operator(lambda hh: st.hankel_matvec(hh, n), n, max_itr=1)
    assert np.isfinite(grad_of(lam_op, t(h)).numpy()).all()
    err = capfd.readouterr().err
    assert "eigen_value_tpu_torch: eigenvalue_operator VJP ran on an UNCONVERGED solve" in err


def test_converged_solve_does_not_warn(rng, capfd):
    n = 16
    h = rng.random(2 * n - 1, dtype=np.float32) + 0.5
    grad_of(ad.eigenvalue_operator(lambda hh: st.hankel_matvec(hh, n), n), t(h))
    assert "UNCONVERGED" not in capfd.readouterr().err


def test_pytree_theta(rng):
    """θ may be a dict (or a nested list / tuple): the gradients come back
    in its shape."""
    theta = {"B": t(rng.random((6, 6), dtype=np.float32) + 0.2, grad=True),
             "C": t(rng.random((4, 4), dtype=np.float32) + 0.2, grad=True)}
    lam_op = ad.eigenvalue_operator(lambda th: st.kron_matvec(th["B"], th["C"]), 24)
    lam = lam_op(theta)
    gB, gC = torch.autograd.grad(lam, [theta["B"], theta["C"]])
    assert torch.isfinite(gB).all() and torch.isfinite(gC).all()
    # λ is linear in each factor: ⟨B, ∂λ/∂B⟩ = λ
    assert float((theta["B"].detach() * gB).sum()) == pytest.approx(float(lam.detach()), rel=1e-3)
    jtheta = {k: jnp.asarray(v.detach().numpy()) for k, v in theta.items()}
    jg = jax.grad(jad.eigenvalue_operator(
        lambda th: jst.kron_matvec(th["B"], th["C"]), 24))(jtheta)
    np.testing.assert_allclose(gB.numpy(), np.asarray(jg["B"]), rtol=1e-3, atol=1e-5)
    nested = (theta["B"], [theta["C"]])
    lam2 = ad.eigenvalue_operator(lambda th: st.kron_matvec(th[0], th[1][0]), 24)(nested)
    gB2, gC2 = torch.autograd.grad(lam2, [theta["B"], theta["C"]])
    assert torch.equal(gB2, gB) and torch.equal(gC2, gC)
    with pytest.raises(TypeError, match="theta must be a tensor"):
        lam_op({"B": 1.0})


def test_an_unused_leaf_gets_no_gradient(rng):
    B = t(rng.random((4, 4), dtype=np.float32) + 0.2, grad=True)
    spare = torch.ones(3, requires_grad=True)
    lam = ad.eigenvalue_operator(lambda th: st.kron_matvec(th[0], th[0]), 16)((B, spare))
    lam.backward()
    assert B.grad is not None and spare.grad is None


def test_the_operator_solve_runs_on_thetas_device(rng, monkeypatch):
    seen = []
    real = ad.solve_operator

    def spy(*a, device=None, **kw):
        seen.append(device)
        return real(*a, device=device, **kw)

    monkeypatch.setattr(ad, "solve_operator", spy)
    n = 8
    grad_of(ad.eigenvalue_operator(lambda hh: st.hankel_matvec(hh, n), n),
            t(rng.random(2 * n - 1, dtype=np.float32) + 0.5))
    assert seen == [torch.device("cpu")] * 2


def test_pair_operator_value_matches_dense_pair(rng):
    n = 32
    h = rng.random(2 * n - 1, dtype=np.float32) + 0.1
    lam_d, v_d = ad.eigenpair(t(hankel_dense(h, n)))
    lam_o, v_o = ad.eigenpair_operator(lambda hh: st.hankel_matvec(hh, n), n)(t(h))
    assert float(lam_o) == pytest.approx(float(lam_d), rel=1e-4)
    np.testing.assert_allclose(v_o.numpy(), v_d.numpy(), atol=1e-4)


def test_pair_operator_vjp_matches_the_dense_chain_and_jax(rng):
    n = 24
    h = rng.random(2 * n - 1, dtype=np.float32) + 0.2
    v_bar = t(rng.standard_normal(n).astype(np.float32))
    idx = torch.from_numpy(np.add.outer(np.arange(n), np.arange(n)))
    g_dense = pair_vjp(lambda hh: ad.eigenpair(hh[idx]), t(h), 0.7, v_bar)
    pair_op = ad.eigenpair_operator(lambda hh: st.hankel_matvec(hh, n), n)
    g_op = pair_vjp(pair_op, t(h), 0.7, v_bar)
    np.testing.assert_allclose(g_op.numpy(), g_dense.numpy(), rtol=5e-2, atol=5e-3)
    _, vjp = jax.vjp(jad.eigenpair_operator(lambda hh: jst.hankel_matvec(hh, n), n),
                     jnp.asarray(h))
    (want,) = vjp((jnp.float32(0.7), jnp.asarray(v_bar.numpy())))
    np.testing.assert_allclose(g_op.numpy(), np.asarray(want), rtol=5e-2, atol=5e-3)


def test_lambda_only_cotangent_matches_eigenvalue_operator(rng):
    n = 24
    h = t(rng.random(2 * n - 1, dtype=np.float32) + 0.2)
    g_pair = pair_vjp(ad.eigenpair_operator(lambda hh: st.hankel_matvec(hh, n), n), h, 1.0,
                      torch.zeros(n))
    g_lam = grad_of(ad.eigenvalue_operator(lambda hh: st.hankel_matvec(hh, n), n), h)
    np.testing.assert_allclose(g_pair.numpy(), g_lam.numpy(), rtol=5e-2, atol=5e-3)


def test_pair_operator_warns_on_an_unconverged_forward(rng, capfd):
    n = 16
    h = t(rng.random(2 * n - 1, dtype=np.float32) + 0.5)
    pair_op = ad.eigenpair_operator(lambda hh: st.hankel_matvec(hh, n), n, max_itr=1)
    pair_vjp(pair_op, h, 1.0, torch.zeros(n))
    assert "eigenpair_operator VJP ran on an UNCONVERGED solve" in capfd.readouterr().err


def test_the_autodiff_example_runs_through_the_port():
    """examples/autodiff.py's three steps: gradient descent on log-entries
    to λ = 40, an eigenvector sensitivity, the Hilbert operator's profile
    gradient."""
    rng = np.random.default_rng(0)
    A0 = t(rng.random((64, 64), dtype=np.float32) + 0.1)
    logA = torch.log(A0)
    for _ in range(60):
        g = grad_of(lambda L: (ad.eigenvalue(torch.exp(L)) - 40.0) ** 2, logA)
        logA = logA - 0.5 * g
    assert abs(float(ad.eigenvalue(torch.exp(logA))) - 40.0) < 0.5
    cot = torch.zeros(64)
    cot[0] = 1.0
    dA = pair_vjp(ad.eigenpair, A0, 0.0, cot)
    assert torch.isfinite(dA).all() and float(dA.abs().max()) > 0
    n = 256
    h0 = torch.from_numpy(1.0 / np.arange(1, 2 * n, dtype=np.float32))
    lam_of_profile = ad.eigenvalue_operator(lambda h: st.hankel_matvec(h, n), n)
    g = grad_of(lam_of_profile, h0)
    assert float(g.abs().max()) > 0
    want = np.asarray(jax.grad(jad.eigenvalue_operator(
        lambda h: jst.hankel_matvec(h, n), n))(jnp.asarray(h0.numpy())))
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-2, atol=1e-3 * np.abs(want).max())
