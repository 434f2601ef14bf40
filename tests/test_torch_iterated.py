"""The port's iterated (mutate-A) solve and its O(n²) passes against the JAX
package.

Inputs are made with numpy from a seed and handed to both.  The JAX
kernels run as tests/test_pallas.py runs them (128-blocks, interpret
mode); on the CPU the port's wrappers run their plain versions.  The CUDA
kernels themselves are held to the same identities on the card by
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from eigen_value_tpu import fixtures as jfx  # noqa: E402
from eigen_value_tpu.bench.suite import _rowsum_bias_pallas  # noqa: E402
from eigen_value_tpu.ops.pallas import kernels as jk  # noqa: E402
from eigen_value_tpu.ops.solver import solve_xla as jax_solve_xla  # noqa: E402
from eigen_value_tpu.ops.solver_pallas import solve_pallas  # noqa: E402
from eigen_value_tpu.reference_impl import parallel_oracle  # noqa: E402
import eigen_value_tpu_torch as evt  # noqa: E402
from eigen_value_tpu_torch import fixtures as tfx  # noqa: E402
from eigen_value_tpu_torch.ops import solver as tsolver  # noqa: E402
from eigen_value_tpu_torch.ops import solver_matvec  # noqa: E402
from eigen_value_tpu_torch.ops.cuda import kernels as tk  # noqa: E402
from eigen_value_tpu_torch.ops.solver_kernel import solve_kernel  # noqa: E402

EPS, MAX_ITR = 1e-3, 1000
KW = dict(block_rows=128, block_cols=128, interpret=True)
ITERATED = ["xla", "pallas"]


def _cfg(backend, **kw):
    return evt.SolverConfig(backend=backend, **kw)


def _jax_solve(backend, a, eps=EPS, max_itr=MAX_ITR):
    a = jnp.asarray(a)
    if backend == "pallas":
        return solve_pallas(a, eps, max_itr, 128, 128, True)
    return jax_solve_xla(a, eps, max_itr)


def _close_to(got, want):
    assert int(got.rounds) == int(want.rounds)
    assert bool(got.converged) == bool(want.converged)
    assert float(got.eigenvalue) == pytest.approx(float(want.eigenvalue), rel=1e-5)
    np.testing.assert_allclose(got.eigenvector.numpy(), np.asarray(want.eigenvector), atol=1e-5)


def _positive(rng, n):
    a = rng.random((n, n), dtype=np.float32) + np.float32(0.1)
    v = rng.random(n, dtype=np.float32) + np.float32(0.5)
    return a, v


# --- the passes ---------------------------------------------------------------


@pytest.mark.parametrize("fn", [tk.rowsum_plain, tk.rowsum])
@pytest.mark.parametrize("n", [128, 512])
def test_rowsum_matches_pallas_and_jnp(n, fn, rng):
    a = rng.random((n, n), dtype=np.float32)
    got = fn(torch.from_numpy(a)).numpy()
    # rtol 1e-6 as tests/test_pallas.py: the f32 sums reduce in another order
    np.testing.assert_allclose(got, np.asarray(jk.rowsum(jnp.asarray(a), **KW)), rtol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jnp.sum(jnp.asarray(a), axis=1)), rtol=1e-6)


def test_rowsum_of_identity_is_exactly_one():
    assert (tk.rowsum(tfx.identity_matrix(256)) == 1.0).all()


@pytest.mark.parametrize("n", [128, 256])
def test_rowsum_bias_matches_pallas(n, rng):
    a = rng.random((n, n), dtype=np.float32)
    bias = np.float32(0.375)
    want = _rowsum_bias_pallas(jnp.asarray(a), jnp.asarray(bias), **KW)
    for fn in (tk.rowsum_bias_plain, tk.rowsum_bias):
        got = fn(torch.from_numpy(a), torch.tensor(bias))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("fn", [tk.scale_plain, tk.scale])
@pytest.mark.parametrize("n", [128, 256])
def test_scale_is_bitwise_the_pallas_kernel(n, fn, rng):
    a, v = _positive(rng, n)
    want = np.asarray(jk.scale(jnp.asarray(a), jnp.asarray(v), **KW))
    np.testing.assert_array_equal(fn(torch.from_numpy(a), torch.from_numpy(v)).numpy(), want)


@pytest.mark.parametrize("fn", [tk.scale_rowsum_plain, tk.scale_rowsum])
@pytest.mark.parametrize("n", [128, 256])
def test_scale_rowsum_matches_pallas_and_its_separate_passes(n, fn, rng):
    a, v = _positive(rng, n)
    A, V = torch.from_numpy(a), torch.from_numpy(v)
    A2_want, v2_want = jk.scale_rowsum(jnp.asarray(a), jnp.asarray(v), **KW)
    A2, v2 = fn(A, V)
    np.testing.assert_array_equal(A2.numpy(), np.asarray(A2_want))
    np.testing.assert_allclose(v2.numpy(), np.asarray(v2_want), rtol=1e-6)
    assert torch.equal(A2, tk.scale_plain(A, V))
    assert torch.equal(v2, tk.rowsum_plain(tk.scale_plain(A, V)))


@pytest.mark.parametrize("fn", [tk.scale, tk.scale_plain, tk.scale_rowsum, tk.scale_rowsum_plain])
def test_out_in_place_and_out_of_place_agree_and_the_input_survives(fn, rng):
    a, v = _positive(rng, 96)
    A, V = torch.from_numpy(a), torch.from_numpy(v)

    def first(r):
        return r[0] if isinstance(r, tuple) else r

    fresh = fn(A, V)
    assert np.array_equal(A.numpy(), a) and first(fresh) is not A
    buf = torch.empty_like(A)
    other = fn(A, V, out=buf)
    assert first(other) is buf and np.array_equal(A.numpy(), a)
    work = A.clone()
    inplace = fn(work, V, out=work)
    assert first(inplace) is work
    assert torch.equal(first(fresh), buf) and torch.equal(buf, work)
    if isinstance(fresh, tuple):
        assert torch.equal(fresh[1], other[1]) and torch.equal(fresh[1], inplace[1])


def test_wrappers_on_cpu_launch_nothing(rng):
    a, v = _positive(rng, 64)
    A, V = torch.from_numpy(a), torch.from_numpy(v)
    fns = (tk.rowsum, tk.rowsum_bias, tk.scale, tk.scale_rowsum)
    before = [f.launches for f in fns]
    tk.rowsum(A), tk.rowsum_bias(A, torch.tensor(1.0)), tk.scale(A, V), tk.scale_rowsum(A, V)
    assert [f.launches for f in fns] == before


def _wrapper_reject_cases():
    A, v = torch.ones(8, 8), torch.ones(8)
    return {
        "rowsum-f64": lambda: tk.rowsum(A.double()),
        "rowsum-non-square": lambda: tk.rowsum(torch.ones(8, 4)),
        "rowsum-strided": lambda: tk.rowsum(torch.ones(8, 16)[:, ::2]),
        "rowsum-device": lambda: tk.rowsum(torch.ones(8, 8, device="meta")),
        "bias-python-float": lambda: tk.rowsum_bias(A, 0.5),
        "bias-1d": lambda: tk.rowsum_bias(A, torch.ones(1)),
        "bias-f64": lambda: tk.rowsum_bias(A, torch.tensor(0.5, dtype=torch.float64)),
        "scale-v-shape": lambda: tk.scale(A, torch.ones(7)),
        "scale-out-shape": lambda: tk.scale(A, v, out=torch.ones(4, 4)),
        "scale_rowsum-out-is-v": lambda: tk.scale_rowsum(A, A[0], out=A),
        "scale_rowsum-v-f64": lambda: tk.scale_rowsum(A, v.double()),
    }


@pytest.mark.parametrize("case", sorted(_wrapper_reject_cases()))
def test_wrapper_rejects(case):
    with pytest.raises(ValueError):
        _wrapper_reject_cases()[case]()


def test_scale_rejects_a_partly_overlapping_out():
    flat = torch.ones(72)
    A, out = flat[:64].view(8, 8), flat[8:].view(8, 8)
    with pytest.raises(ValueError, match="overlap"):
        tk.scale(A, torch.ones(8), out=out)


# --- the iterated solve as a whole ----------------------------------------------


@pytest.mark.parametrize("backend", ITERATED)
@pytest.mark.parametrize("n", [128, 256, 512, 1024])
def test_hilbert_matches_the_jax_iterated_solve(n, backend):
    H = tfx.hilbert_matrix(n)
    keep = H.clone()
    got = evt.max_eigenvalue(H, _cfg(backend))
    want = _jax_solve(backend, jfx.hilbert_matrix(n))
    assert int(got.rounds) == tfx.HILBERT_ROUNDS[n]
    _close_to(got, want)
    assert torch.equal(H, keep)  # the caller's matrix is never written


@pytest.mark.parametrize("backend", ITERATED)
def test_random_matrix_matches_the_jax_iterated_solve(backend, rng):
    a = rng.random((256, 256), dtype=np.float32) + np.float32(1e-4)
    keep = a.copy()
    _close_to(evt.max_eigenvalue(a, _cfg(backend), device="cpu"), _jax_solve(backend, a))
    assert np.array_equal(a, keep)


@pytest.mark.parametrize("backend", ITERATED)
def test_anchor_3x3(backend):
    res = evt.max_eigenvalue(tfx.ANCHOR_3X3, _cfg(backend), device="cpu")
    want = jax_solve_xla(jnp.asarray(jfx.ANCHOR_3X3, jnp.float32), EPS, MAX_ITR)
    assert bool(res.converged) and int(res.rounds) == int(want.rounds)
    assert abs(float(res.eigenvalue) - tfx.ANCHOR_3X3_EIGENVALUE) < 1e-4
    np.testing.assert_allclose(res.eigenvector.numpy(), tfx.ANCHOR_3X3_EIGENVECTOR, atol=1e-3)


@pytest.mark.parametrize("backend", ITERATED)
def test_already_converged_at_round_zero(backend):
    res = evt.max_eigenvalue(torch.full((8, 8), 0.25), _cfg(backend))
    want = _jax_solve(backend, np.full((8, 8), 0.25, np.float32))
    assert bool(res.converged) and int(res.rounds) == int(want.rounds) == 0
    assert abs(float(res.eigenvalue) - 2.0) < EPS


@pytest.mark.parametrize("cap", [0, 1, 3, 9, 10])
@pytest.mark.parametrize("backend", ITERATED)
def test_cap_exhaustion_matches_jax(cap, backend):
    got = evt.max_eigenvalue(tfx.hilbert_matrix(128), _cfg(backend, max_itr=cap))
    want = _jax_solve(backend, jfx.hilbert_matrix(128), max_itr=cap)
    assert bool(got.converged) == bool(want.converged) == (cap > 9)
    assert int(got.rounds) == int(want.rounds) == min(cap, 9)
    assert float(got.eigenvalue) == pytest.approx(float(want.eigenvalue), rel=1e-5)
    np.testing.assert_allclose(got.eigenvector.numpy(), np.asarray(want.eigenvector), atol=1e-5)
    if 0 < cap <= 9:
        oracle = parallel_oracle(np.asarray(jfx.hilbert_matrix(128)), max_itr=cap)
        assert abs(float(got.eigenvalue) - oracle.eigenvalue) < 1e-4


@pytest.mark.parametrize("n", [128, 512])
def test_matches_parallel_oracle(n, rng):
    mat = rng.random((n, n), dtype=np.float32) + np.float32(1e-4)
    want = parallel_oracle(mat)
    for backend in ITERATED:
        got = evt.max_eigenvalue(torch.from_numpy(mat), _cfg(backend))
        assert bool(got.converged) == want.converged and int(got.rounds) == want.rounds
        assert abs(float(got.eigenvalue) - want.eigenvalue) < EPS
        np.testing.assert_allclose(got.eigenvector.numpy(), want.eigenvector, atol=1e-4)


def test_ev0_is_scale_invariant_and_matches_jax():
    H = tfx.hilbert_matrix(128)
    ev0 = np.full(128, 2.0, np.float32)
    base = solve_kernel(H, EPS, MAX_ITR)
    got = solve_kernel(H, EPS, MAX_ITR, ev0=ev0)
    want = solve_pallas(jfx.hilbert_matrix(128), EPS, MAX_ITR, 128, 128, True, ev0=jnp.asarray(ev0))
    assert int(got.rounds) == int(base.rounds) == int(want.rounds)
    assert torch.equal(got.eigenvalue, base.eigenvalue)  # λ is read from v, which ev never feeds
    np.testing.assert_allclose(got.eigenvector.numpy(), np.asarray(want.eigenvector), atol=1e-5)
    np.testing.assert_allclose(got.eigenvector.numpy(), 2.0 * base.eigenvector.numpy(), rtol=1e-6)
    res = tsolver.solve_xla(H, EPS, MAX_ITR, ev0=torch.ones(128))
    assert torch.equal(res.eigenvector, tsolver.solve_xla(H, EPS, MAX_ITR).eigenvector)


def test_relative_eps_mode_on_xla_matches_jax():
    a = (np.random.default_rng(7).random((128, 128), np.float32) + np.float32(0.1)) * np.float32(1e5)
    want = jax_solve_xla(jnp.asarray(a), EPS, MAX_ITR, eps_mode="relative")
    got = evt.max_eigenvalue(torch.from_numpy(a), _cfg("xla", eps_mode="relative"))
    assert int(got.rounds) == int(want.rounds) and bool(got.converged)
    assert float(got.eigenvalue) == pytest.approx(float(want.eigenvalue), rel=1e-5)


def test_kernel_solve_is_the_loop_over_its_two_passes():
    H = tfx.hilbert_matrix(128)
    calls = []

    def rowsum(A):
        calls.append("rowsum")
        return tk.rowsum(A)

    def scale_rowsum(A, v, out):
        calls.append("fresh" if out is None else "in place" if out is A else "other")
        return tk.scale_rowsum(A, v, out=out)

    got = tsolver.solve_loop(H, rowsum=rowsum, scale_rowsum=scale_rowsum, eps=EPS, max_itr=MAX_ITR)
    # one pre-pass; round 0 writes a new buffer, every later round rewrites it
    assert calls == ["rowsum", "fresh"] + ["in place"] * 8
    want = solve_kernel(H, EPS, MAX_ITR)
    assert int(got.rounds) == int(want.rounds) == 9
    assert torch.equal(got.eigenvector, want.eigenvector)


def test_both_forms_share_one_epilogue():
    assert solver_matvec._finish is tsolver._finish


def test_iterated_and_power_forms_agree():
    H = tfx.hilbert_matrix(256)
    it = evt.max_eigenvalue(H, _cfg("pallas"))
    pw = evt.max_eigenvalue(H, _cfg("matvec"))
    assert int(it.rounds) == int(pw.rounds)
    assert float(it.eigenvalue) == pytest.approx(float(pw.eigenvalue), rel=1e-5)
    np.testing.assert_allclose(it.eigenvector.numpy(), pw.eigenvector.numpy(), atol=1e-4)


# --- rejections and the device default -----------------------------------------


def _reject_cases():
    H = tfx.hilbert_matrix(128)
    cases = {"pallas+relative": _cfg("pallas", eps_mode="relative")}
    for b in ITERATED:
        cases.update({
            f"{b}+storage_dtype": _cfg(b, storage_dtype=torch.bfloat16),
            f"{b}+chunk": _cfg(b, chunk=4),
            f"{b}+cache_tiles": _cfg(b, cache_tiles=0),
            f"{b}+symmetric": _cfg(b, symmetric=True),
            f"{b}+block_rows": _cfg(b, block_rows=128),
            f"{b}+block_cols": _cfg(b, block_cols=128),
            f"{b}+interpret": _cfg(b, interpret=True),
        })
    return {name: (H, cfg) for name, cfg in cases.items()}


@pytest.mark.parametrize("case", sorted(_reject_cases()))
def test_rejected_knobs_raise(case):
    H, cfg = _reject_cases()[case]
    with pytest.raises(ValueError):
        evt.max_eigenvalue(H, cfg)


def test_storage_dtype_rejection_is_a_rule_not_a_gap():
    with pytest.raises(ValueError, match="matvec-family") as err:
        evt.max_eigenvalue(tfx.hilbert_matrix(16), _cfg("xla", storage_dtype=torch.float16))
    assert "ROADMAP" not in str(err.value)


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


@pytest.mark.parametrize("host", ["numpy", "list"])
def test_host_input_without_a_device_raises_when_there_is_no_card(host):
    _no_card()
    mat = tfx.ANCHOR_3X3 if host == "numpy" else tfx.ANCHOR_3X3.tolist()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evt.max_eigenvalue(mat)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evt.EigenValue().similarity_transform(mat)


def test_device_cpu_is_how_a_caller_asks_for_the_cpu():
    res = evt.max_eigenvalue(tfx.ANCHOR_3X3.tolist(), device="cpu")
    assert res.eigenvector.device.type == "cpu"
    assert abs(float(res.eigenvalue) - tfx.ANCHOR_3X3_EIGENVALUE) < 1e-4
    lam, vec, ms, rounds = evt.EigenValue(device="cpu").similarity_transform(tfx.ANCHOR_3X3)
    assert isinstance(lam, np.float32) and rounds == int(res.rounds) and ms >= 0.0


def test_a_tensor_stays_where_its_owner_put_it():
    res = evt.max_eigenvalue(torch.tensor(tfx.ANCHOR_3X3))  # a CPU tensor, no device=
    assert res.eigenvector.device.type == "cpu" and res.eigenvector.dtype == torch.float32
    res = evt.EigenValue().similarity_transform(torch.tensor(tfx.ANCHOR_3X3))
    assert abs(float(res[0]) - tfx.ANCHOR_3X3_EIGENVALUE) < 1e-4


def test_eigen_residual_follows_the_matrix():
    H = tfx.hilbert_matrix(128)
    res = evt.max_eigenvalue(H, _cfg("pallas"))
    assert float(evt.eigen_residual(H, res)) < 1e-3
    assert float(evt.eigen_residual(np.asarray(jfx.hilbert_matrix(128)), res)) < 1e-3
