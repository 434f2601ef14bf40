"""The port's λ-history solves and spectral helpers (``ops/spectral.py``)
against the JAX package.

Each test mirrors the JAX test of the same subject in tests/test_spectral.py
on the same inputs (numpy, handed to both), with the port on the CPU
(``device="cpu"``).  The host-side helpers (``convergence_report``,
``refine_eigenpair``) are numpy in both packages and are held equal bit for
bit; the traced solves are held bit for bit against the port's untraced
ones and within 1e-6 of JAX's history.  JAX draws its power-iteration starts
from ``jax.random`` and the port from a seeded ``torch.Generator``, so the
power iterations are compared with the same ``x0`` where JAX takes one, and
against ``numpy.linalg.eigh`` otherwise.  JAX's jit and vmap tests have no
counterpart (eager loops); a loop over the batch stands for the vmap one.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import eigen_value_tpu as J  # noqa: E402
from eigen_value_tpu.ops import spectral as jsp  # noqa: E402
from eigen_value_tpu.ops import structured as jst  # noqa: E402
from eigen_value_tpu.ops.solver_matvec import (  # noqa: E402
    solve_matvec_traced as jax_solve_matvec_traced,
    solve_operator_traced as jax_solve_operator_traced,
)

import eigen_value_tpu_torch as evt  # noqa: E402
from eigen_value_tpu_torch import fixtures as tfx  # noqa: E402
from eigen_value_tpu_torch.ops import spectral as sp  # noqa: E402
from eigen_value_tpu_torch.ops.solver_matvec import (  # noqa: E402
    solve_matvec,
    solve_matvec_traced,
    solve_operator,
    solve_operator_traced,
)
from eigen_value_tpu_torch.ops.structured import hilbert_matvec  # noqa: E402

EPS, MAX_ITR = 1e-3, 1000
CPU = "cpu"


def _eig(n: int) -> np.ndarray:
    """Hilbert n²'s eigenvalues in float64, largest first."""
    return np.sort(np.linalg.eigvalsh(tfx.hilbert_matrix(n).double().numpy()))[::-1]


def _same(a, b) -> bool:
    return (int(a.rounds) == int(b.rounds) and bool(a.converged) == bool(b.converged)
            and torch.equal(a.eigenvalue, b.eigenvalue)
            and torch.equal(a.eigenvector, b.eigenvector))


def test_operator_residual_matches_dense_definition():
    n = 256
    H = tfx.hilbert_matrix(n)
    res = evt.max_eigenvalue(H)
    got = float(sp.operator_residual(lambda x: H @ x, res))
    want = float(np.max(np.abs(H.numpy() @ res.eigenvector.numpy()
                               - float(res.eigenvalue) * res.eigenvector.numpy())))
    assert got == pytest.approx(want, rel=1e-6)
    assert got < 1e-2
    Hj = J.fixtures.hilbert_matrix(n)
    jres = J.max_eigenvalue(Hj)
    assert got == pytest.approx(float(jsp.operator_residual(lambda x: Hj @ x, jres)), rel=0.5)


def test_convergence_report_estimates_subdominant_ratio():
    n = 64
    H = tfx.hilbert_matrix(n)
    res, hist = solve_matvec_traced(H, 1e-6, 200)
    assert bool(res.converged)
    rep = sp.convergence_report(hist, int(res.rounds))
    w = _eig(n)
    assert rep.deltas_used >= 2
    assert rep.rate == pytest.approx(w[1] / w[0], rel=0.25)
    assert rep.digits_per_round == pytest.approx(-np.log10(rep.rate))
    actual_err = abs(float(res.eigenvalue) - w[0])
    assert rep.lam_error_estimate == pytest.approx(actual_err, abs=10 * actual_err + 1e-6)
    jres, jhist = jax_solve_matvec_traced(J.fixtures.hilbert_matrix(n), 1e-6, 200)
    jrep = jsp.convergence_report(np.asarray(jhist), int(jres.rounds))
    assert rep.rate == pytest.approx(jrep.rate, rel=0.05)


@pytest.mark.parametrize(
    "hist, rounds",
    [([2.0, 2.1], 1),
     ([4.0, 3.0, 2.5, 2.25, 2.125, 2.0625], 5),
     ([4.0, 3.0, 2.5, 2.25, 2.125, 2.0625] + [2.0625] * 10, 15),
     (np.array([2.0 - 2e-7 * 0.5**k for k in range(15)], np.float64), 14),
     (list(np.array([2.0 - 2e-7 * 0.5**k for k in range(15)], np.float64)), 14),
     (np.array([3.0, 2.2, 2.6, 2.4, 2.5, 2.45, 2.475, 2.46], np.float32), 7),
     (np.array([5.0, 4.0, 3.5, 3.25, 3.2, 3.19, 3.185], np.float32), 3)],
    ids=["short", "geometric", "flat-tail", "f64-deep-tail", "list-assumes-f32",
         "alternating", "cut-at-rounds"],
)
def test_convergence_report_is_jaxs(hist, rounds):
    """The same numpy history gives JAX's report exactly (nan where JAX's is)."""
    got, want = sp.convergence_report(hist, rounds), jsp.convergence_report(hist, rounds)
    assert got.deltas_used == want.deltas_used
    for g, w in zip(got[:3], want[:3]):
        assert (np.isnan(g) and np.isnan(w)) or g == w


def test_convergence_report_short_history_is_nan():
    rep = sp.convergence_report([2.0, 2.1], 1)
    assert np.isnan(rep.rate) and rep.deltas_used == 0


def test_convergence_report_roundoff_floor_excluded():
    hist = [4.0, 3.0, 2.5, 2.25, 2.125, 2.0625]
    pad = hist + [hist[-1]] * 10
    a = sp.convergence_report(hist, len(hist) - 1)
    b = sp.convergence_report(pad, len(pad) - 1)
    assert a.rate == pytest.approx(0.5, rel=1e-6)
    assert b.rate == pytest.approx(a.rate, rel=1e-6)


def test_convergence_report_f64_history_keeps_deep_tail():
    """The round-off floor follows the history's dtype, a tensor's too."""
    lam, r = 2.0, 0.5
    hist = np.array([lam - 2e-7 * r**k for k in range(15)], np.float64)
    for h in (hist, torch.from_numpy(hist)):
        rep = sp.convergence_report(h, len(hist) - 1)
        assert rep.deltas_used >= 2
        assert rep.rate == pytest.approx(r, rel=1e-3)
    assert np.isnan(sp.convergence_report(list(hist), len(hist) - 1).rate)
    assert np.isnan(sp.convergence_report(torch.from_numpy(hist).float(), len(hist) - 1).rate)


class TestRefineEigenpair:
    def test_hilbert_refines_to_f64(self):
        n = 512
        H = tfx.hilbert_matrix(n)
        res = evt.max_eigenvalue(H)
        A64 = H.double().numpy()
        ref = sp.refine_eigenpair(A64, res)
        lam_true = float(np.max(np.linalg.eigvalsh(A64)))
        coarse_err = abs(float(res.eigenvalue) - lam_true)
        fine_err = abs(ref.eigenvalue - lam_true)
        assert fine_err < 1e-10 * lam_true
        assert fine_err < coarse_err
        assert ref.residual < 1e-11
        assert ref.spread < 1e-9
        assert float(np.max(ref.eigenvector)) == pytest.approx(1.0)

    def test_is_jaxs_on_the_same_inputs(self):
        """The same float64 matrix and seed vector: JAX's result bit for bit
        (both are numpy on the host), a tensor seed included."""
        n = 128
        A64 = tfx.hilbert_matrix(n).double().numpy()
        seed = np.asarray(J.max_eigenvalue(J.fixtures.hilbert_matrix(n)).eigenvector)
        want = jsp.refine_eigenpair(A64, SimpleNamespace(eigenvector=seed))
        for vec in (seed, torch.tensor(seed)):
            got = sp.refine_eigenpair(A64, SimpleNamespace(eigenvector=vec))
            assert (got.eigenvalue, got.rounds, got.spread, got.residual) == (
                want.eigenvalue, want.rounds, want.spread, want.residual)
            np.testing.assert_array_equal(got.eigenvector, want.eigenvector)

    def test_matrix_free_matvec(self):
        n = 128
        H = tfx.hilbert_matrix(n)
        A64 = H.double().numpy()
        res = evt.max_eigenvalue(H)
        dense = sp.refine_eigenpair(A64, res)
        mfree = sp.refine_eigenpair(lambda x: A64 @ x, res)
        assert mfree.eigenvalue == pytest.approx(dense.eigenvalue, rel=1e-13)
        assert mfree.residual < 1e-11
        tensor = sp.refine_eigenpair(H, res)  # a tensor matrix: its float64 values
        assert tensor.eigenvalue == dense.eigenvalue

    def test_rejects_nonpositive_seed(self):
        res = evt.max_eigenvalue(tfx.hilbert_matrix(64))
        bad = res._replace(eigenvector=torch.zeros(64) - 1.0)
        with pytest.raises(ValueError, match="finite and positive"):
            sp.refine_eigenpair(np.eye(64) + 1.0, bad)

    def test_reports_rounds_and_stops(self):
        H = tfx.hilbert_matrix(256)
        ref = sp.refine_eigenpair(H.double().numpy(), evt.max_eigenvalue(H), max_rounds=50)
        assert 1 <= ref.rounds < 50


@pytest.mark.parametrize("n", [64, 128, 256])
def test_traced_solves_are_the_untraced_ones_and_jaxs_history(n):
    """Both traced solves bit for bit their untraced solves; the history within
    1e-6 of JAX's, its tail the final λ exactly."""
    H = tfx.hilbert_matrix(n)
    res, hist = solve_matvec_traced(H, EPS, MAX_ITR)
    assert _same(res, solve_matvec(H, EPS, MAX_ITR))
    res_o, hist_o = solve_operator_traced(lambda x: torch.mv(H, x), n, EPS, MAX_ITR, device=CPU)
    assert _same(res_o, res) and torch.equal(hist_o, hist)
    k = int(res.rounds)
    assert hist.shape == (MAX_ITR,) and hist.dtype == torch.float32
    assert bool((hist[k:] == res.eigenvalue).all())
    jres, jhist = jax_solve_matvec_traced(J.fixtures.hilbert_matrix(n), EPS, MAX_ITR)
    assert int(jres.rounds) == k
    np.testing.assert_allclose(hist.numpy(), np.asarray(jhist), rtol=1e-6, atol=0)


def test_traced_fft_operator_is_the_untraced_one():
    n = 512
    mv = hilbert_matvec(n, device=CPU)
    res, hist = solve_operator_traced(mv, n, EPS, MAX_ITR, device=CPU)
    assert _same(res, solve_operator(mv, n, EPS, MAX_ITR, device=CPU))
    jres, jhist = jax_solve_operator_traced(jst.hilbert_matvec(n), n, EPS, MAX_ITR)
    assert int(jres.rounds) == int(res.rounds)
    np.testing.assert_allclose(hist.numpy(), np.asarray(jhist), rtol=1e-6, atol=0)


@pytest.mark.parametrize("cap", [1, 3])
def test_traced_cap_exhaustion_pads_like_jax(cap):
    """Cap exhaustion: the history is JAX's, the last checked λ at
    max_itr - 1."""
    H = tfx.hilbert_matrix(128)
    res, hist = solve_matvec_traced(H, EPS, cap)
    jres, jhist = jax_solve_matvec_traced(J.fixtures.hilbert_matrix(128), EPS, cap)
    assert hist.shape == (cap,) == np.asarray(jhist).shape
    assert int(res.rounds) == int(jres.rounds) == cap and not bool(res.converged)
    assert _same(res, solve_matvec(H, EPS, cap))
    assert hist[-1] == res.eigenvalue
    np.testing.assert_allclose(hist.numpy(), np.asarray(jhist), rtol=1e-6, atol=0)


def test_traced_with_no_rounds():
    """max_itr = 0: an empty history and the untraced solve's result (JAX's
    traced solve rejects this cap: it traces its history write against a
    (0,)-array)."""
    H = tfx.hilbert_matrix(128)
    res, hist = solve_matvec_traced(H, EPS, 0)
    assert hist.shape == (0,) and int(res.rounds) == 0 and not bool(res.converged)
    assert _same(res, solve_matvec(H, EPS, 0))
    res_o, hist_o = solve_operator_traced(lambda x: H @ x, 128, EPS, 0, device=CPU)
    assert hist_o.shape == (0,) and _same(res_o, res)


def test_operator_traced_rate_matches_dense_rate():
    n = 64
    res_d, hist_d = solve_matvec_traced(tfx.hilbert_matrix(n), 1e-6, 200)
    res_o, hist_o = solve_operator_traced(hilbert_matvec(n, device=CPU), n, 1e-6, 200,
                                          device=CPU)
    rep_d = sp.convergence_report(hist_d, int(res_d.rounds))
    rep_o = sp.convergence_report(hist_o, int(res_o.rounds))
    assert rep_o.rate == pytest.approx(rep_d.rate, rel=0.15)


def test_convergence_report_alternating_subdominant():
    """A negative λ₂ (spectrum {16, −7.2, 0, …}): |λ₂/λ₁| = 0.45 from the
    alternating tail.  At λ = 16 the 1e-6 stop sits on float32 rounding, so
    whether a run stops is luck of the summation order (JAX's stops at round
    96, the port's torch.mv order runs to the cap); the report reads the
    same geometric tail either way."""
    n = 16
    s = np.array([(-1.0) ** i for i in range(n)])
    A = np.ones((n, n)) - 0.45 * np.outer(s, s)
    d = 1.0 + 0.3 * np.arange(n) / n
    B = (np.diag(d) @ A @ np.diag(1.0 / d)).astype(np.float32)
    res, hist = solve_matvec_traced(torch.from_numpy(B), 1e-6, 200)
    assert float(res.eigenvalue) == pytest.approx(16.0, rel=1e-6)
    rep = sp.convergence_report(hist, int(res.rounds))
    assert rep.deltas_used >= 2
    assert rep.rate == pytest.approx(0.45, rel=0.05)
    jres, jhist = jax_solve_matvec_traced(jnp.asarray(B), 1e-6, 200)
    jrep = jsp.convergence_report(np.asarray(jhist), int(jres.rounds))
    assert rep.rate == pytest.approx(jrep.rate, rel=0.05)


class TestPowerEigenpair:
    def test_recovers_dominant_pair_of_random_symmetric(self):
        rng = np.random.default_rng(7)
        M = rng.standard_normal((48, 48))
        S = ((M + M.T) / 2).astype(np.float32)
        x0 = rng.standard_normal(48).astype(np.float32)
        St = torch.from_numpy(S)
        res = sp.power_eigenpair(lambda x: St @ x, 48, eps=1e-6, max_itr=5000, x0=x0, device=CPU)
        w, V = np.linalg.eigh(S.astype(np.float64))
        k = int(np.argmax(np.abs(w)))
        assert bool(res.converged)
        assert float(res.eigenvalue) == pytest.approx(w[k], rel=1e-4)
        assert abs(float(res.eigenvector.double() @ torch.from_numpy(V[:, k]))) == pytest.approx(
            1.0, abs=1e-3)
        Sj = jnp.asarray(S)
        jres = jsp.power_eigenpair(lambda x: Sj @ x, 48, eps=1e-6, max_itr=5000, x0=x0)
        assert abs(int(res.rounds) - int(jres.rounds)) <= 2
        assert float(res.eigenvalue) == pytest.approx(float(jres.eigenvalue), rel=1e-5)

    def test_negative_dominant_eigenvalue(self):
        S = torch.diag(torch.tensor([-3.0, 2.0, 1.0]))
        res = sp.power_eigenpair(lambda x: S @ x, 3, eps=1e-6, max_itr=2000, device=CPU)
        assert bool(res.converged)
        assert float(res.eigenvalue) == pytest.approx(-3.0, rel=1e-5)

    def test_cap_exhaustion_reports_unconverged(self):
        S = torch.diag(torch.tensor([1.0, 0.999, 0.5]))
        x0 = np.array([0.3, 0.5, 0.7], np.float32)
        res = sp.power_eigenpair(lambda x: S @ x, 3, eps=1e-12, max_itr=5, x0=x0, device=CPU)
        assert not bool(res.converged)
        assert int(res.rounds) == 5
        Sj = jnp.asarray(S.numpy())
        jres = jsp.power_eigenpair(lambda x: Sj @ x, 3, eps=1e-12, max_itr=5, x0=x0)
        np.testing.assert_allclose(res.eigenvector.numpy(), np.asarray(jres.eigenvector),
                                   rtol=1e-6, atol=1e-7)
        assert float(res.residual) == pytest.approx(float(jres.residual), rel=1e-4)

    def test_default_start_is_fixed_and_device_placed(self):
        """No x0: a seeded normal start, the same vector on every call (the
        port's own; JAX's comes from jax.random)."""
        S = torch.diag(torch.tensor([4.0, 1.0]))
        a = sp.power_eigenpair(lambda x: S @ x, 2, eps=1e-6, max_itr=100, device=CPU)
        b = sp.power_eigenpair(lambda x: S @ x, 2, eps=1e-6, max_itr=100, device=CPU)
        assert float(a.eigenvalue) == pytest.approx(4.0, rel=1e-5)
        assert torch.equal(a.eigenvector, b.eigenvector) and a.eigenvector.device.type == "cpu"
        assert a.rounds.dtype == torch.int32 and a.converged.dtype == torch.bool

    def test_a_batch_of_operators_in_a_loop(self):
        """JAX vmaps the loop over a batch of diagonal operators; here each is
        solved in turn, with JAX's values."""
        diags = np.array([[5.0, 1.0, 0.5], [3.0, -1.0, 0.2]], np.float32)
        lams = [float(sp.power_eigenpair(lambda x, d=torch.from_numpy(d): d * x, 3, eps=1e-6,
                                         max_itr=500, device=CPU).eigenvalue) for d in diags]
        np.testing.assert_allclose(lams, [5.0, 3.0], rtol=1e-5)


class TestSubdominantEigenpair:
    def test_hilbert_matches_numpy_spectrum(self):
        n = 64
        H = tfx.hilbert_matrix(n)
        res, hist = solve_matvec_traced(H, 1e-6, 200)
        assert bool(res.converged)
        sub = sp.subdominant_eigenpair(H.numpy(), res, device=CPU)
        w = _eig(n)
        assert sub.converged
        assert sub.eigenvalue == pytest.approx(w[1], rel=1e-3)
        assert sub.ratio == pytest.approx(w[1] / w[0], rel=1e-3)
        assert sub.residual <= 1e-3 * w[0]
        rep = sp.convergence_report(hist, int(res.rounds))
        assert rep.rate == pytest.approx(sub.ratio, rel=0.25)
        jres, _ = jax_solve_matvec_traced(J.fixtures.hilbert_matrix(n), 1e-6, 200)
        jsub = jsp.subdominant_eigenpair(np.asarray(J.fixtures.hilbert_matrix(n)), jres)
        assert sub.eigenvalue == pytest.approx(jsub.eigenvalue, rel=1e-4)
        assert sub.eigenvector.dtype == np.float32

    @pytest.mark.parametrize("n", [256, 1024])
    def test_larger_hilbert_matches_numpy(self, n):
        """The card check's size (1024) on the CPU."""
        H = tfx.hilbert_matrix(n)
        sub = sp.subdominant_eigenpair(H, evt.max_eigenvalue(H))  # a tensor: its device
        w = _eig(n)
        assert sub.converged and sub.eigenvalue == pytest.approx(w[1], rel=1e-3)
        assert sub.residual <= 1e-3 * w[0]

    def test_unrefined_pair_still_close(self):
        n = 32
        H = tfx.hilbert_matrix(n)
        sub = sp.subdominant_eigenpair(H.numpy(), evt.max_eigenvalue(H), refine=False,
                                       device=CPU)
        assert sub.eigenvalue == pytest.approx(_eig(n)[1], rel=5e-2)

    def test_rejects_nonsymmetric(self):
        A = np.array([[1.0, 2.0], [0.0, 1.0]])
        res = evt.max_eigenvalue(tfx.hilbert_matrix(2))
        with pytest.raises(ValueError, match="SYMMETRIC") as port:
            sp.subdominant_eigenpair(A, res, device=CPU)
        with pytest.raises(ValueError) as jax_err:
            jsp.subdominant_eigenpair(A, J.max_eigenvalue(J.fixtures.hilbert_matrix(2)))
        assert str(port.value) == str(jax_err.value)

    def test_accepts_refined_pair_without_repolishing(self):
        n = 48
        H = tfx.hilbert_matrix(n)
        res = evt.max_eigenvalue(H)
        A64 = H.double().numpy()
        ref = sp.refine_eigenpair(A64, res)
        via_pair = sp.subdominant_eigenpair(A64, ref, device=CPU)
        via_solve = sp.subdominant_eigenpair(A64, res, device=CPU)
        assert via_pair.eigenvalue == pytest.approx(via_solve.eigenvalue, rel=1e-6)


class TestTopKEigenpairs:
    def test_hilbert_top4_matches_numpy(self):
        n = 64
        H = tfx.hilbert_matrix(n)
        top = sp.top_k_eigenpairs(H.numpy(), evt.max_eigenvalue(H), k=4, device=CPU)
        w = _eig(n)
        assert np.all(top.converged)
        np.testing.assert_allclose(top.eigenvalues, w[:4], rtol=1e-3)
        np.testing.assert_allclose(top.ratios, np.abs(w[:4]) / w[0], rtol=1e-3)
        G = top.eigenvectors.astype(np.float64)
        np.testing.assert_allclose(G.T @ G, np.eye(4), atol=2e-3)
        assert np.all(top.residuals <= 1e-3 * w[0])
        jtop = jsp.top_k_eigenpairs(np.asarray(J.fixtures.hilbert_matrix(n)),
                                    J.max_eigenvalue(J.fixtures.hilbert_matrix(n)), k=4)
        np.testing.assert_allclose(top.eigenvalues, jtop.eigenvalues, rtol=1e-4)

    def test_k1_is_the_refined_dominant(self):
        n = 32
        H = tfx.hilbert_matrix(n)
        res = evt.max_eigenvalue(H)
        top = sp.top_k_eigenpairs(H.numpy(), res, k=1, device=CPU)
        ref = sp.refine_eigenpair(H.double().numpy(), res)
        assert top.eigenvalues[0] == pytest.approx(ref.eigenvalue, rel=1e-10)
        assert top.ratios[0] == 1.0

    def test_k2_matches_subdominant(self):
        n = 48
        H = tfx.hilbert_matrix(n)
        res = evt.max_eigenvalue(H)
        top = sp.top_k_eigenpairs(H.numpy(), res, k=2, device=CPU)
        sub = sp.subdominant_eigenpair(H.numpy(), res, device=CPU)
        assert top.eigenvalues[1] == pytest.approx(sub.eigenvalue, rel=1e-3)

    @pytest.mark.parametrize("k, match", [(0, "k >= 1"), (5, "exceeds the dimension")])
    def test_validates_inputs(self, k, match):
        res = evt.max_eigenvalue(tfx.hilbert_matrix(4))
        with pytest.raises(ValueError, match=match) as port:
            sp.top_k_eigenpairs(np.eye(4), res, k=k, device=CPU)
        with pytest.raises(ValueError) as jax_err:
            jsp.top_k_eigenpairs(np.eye(4), J.max_eigenvalue(J.fixtures.hilbert_matrix(4)), k=k)
        assert str(port.value) == str(jax_err.value)

    def test_top3_of_hilbert_1024(self):
        """The card check's case on the CPU: k = 3 at 1024² against eigh."""
        n = 1024
        H = tfx.hilbert_matrix(n)
        top = sp.top_k_eigenpairs(H, evt.max_eigenvalue(H), k=3)
        w = _eig(n)
        assert np.all(top.converged)
        np.testing.assert_allclose(top.eigenvalues, w[:3], rtol=1e-3)
        assert np.all(top.residuals <= 1e-3 * w[0])


def test_host_input_goes_to_the_card(monkeypatch):
    """No tensor and no device: the power iteration is for the card, and
    raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        sp.power_eigenpair(lambda x: x, 3)
    with pytest.raises(RuntimeError, match="CUDA device"):
        sp.subdominant_eigenpair(np.eye(3) + 1.0, SimpleNamespace(
            eigenvalue=4.0, eigenvector=np.ones(3)), refine=False)
