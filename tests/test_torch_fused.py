"""The port's stop kernel, one-launch rounds and fused-round solves against
the JAX package.

Inputs are made with numpy from a seed and handed to both.  The JAX
kernels run as tests/test_pallas.py and tests/test_matvec.py run them
(interpret mode); on the CPU the port's wrappers run their plain versions.
The CUDA kernels themselves are held to the same identities on the card by
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from eigen_value_tpu import fixtures as jfx  # noqa: E402
from eigen_value_tpu.ops.pallas import kernels as jk  # noqa: E402
from eigen_value_tpu.ops.solver_matvec import (  # noqa: E402
    solve_fused_round as jax_solve_fused_round,
    solve_matvec_pallas_fused,
)
from eigen_value_tpu_torch import fixtures as tfx  # noqa: E402
from eigen_value_tpu_torch.ops.cuda import kernels as tk  # noqa: E402
from eigen_value_tpu_torch.ops.solver import stop_check  # noqa: E402
from eigen_value_tpu_torch.ops.solver_matvec import (  # noqa: E402
    solve_fused_round,
    solve_matvec_kernel,
    solve_matvec_kernel_fused,
)

EPS, MAX_ITR = 1e-3, 1000
STOP_KW = dict(lanes=256, block_rows=8, interpret=True)
ROUND_KW = dict(block_rows=64, block_cols=64, interpret=True)
BOTH_STOPS = pytest.mark.parametrize("fn", [tk.stop, tk.stop_plain], ids=["wrapper", "plain"])


def _both_stops(fn, v: np.ndarray, eps: float, **kw) -> bool:
    """The port's verdict, checked equal to the JAX kernel's."""
    got = fn(torch.from_numpy(v), eps)
    assert got.dtype == torch.bool and got.shape == ()
    want = jk.stop(jnp.asarray(v), eps, **{**STOP_KW, **kw})
    assert bool(got) == bool(want)
    return bool(got)


# --- stop -----------------------------------------------------------------------


@BOTH_STOPS
@pytest.mark.parametrize("n", [4096, 12 * 256])
def test_stop_fixture_pair(n, fn):
    assert _both_stops(fn, np.asarray(jfx.stop_success_vector(n)), EPS)
    assert not _both_stops(fn, np.asarray(jfx.stop_fail_vector(n)), EPS)


@BOTH_STOPS
@pytest.mark.parametrize("idx", [0, 255, 256, 4095, 2048 + 7])
def test_stop_single_break_detected(idx, fn):
    v = np.full(4096, 1.0, np.float32)
    v[idx] = 2.0
    assert not _both_stops(fn, v, EPS)


@BOTH_STOPS
@pytest.mark.parametrize("i", range(10))
def test_stop_fuzz(i, fn):
    rng = np.random.default_rng(100 + i)
    v = rng.random(2048, dtype=np.float32) * np.float32(0.2 if i % 2 else 1.0)
    assert _both_stops(fn, v, 0.5, block_rows=4) == bool(i % 2)


@pytest.mark.parametrize("n", [1, 3, 1001])
def test_stop_takes_any_length(n):
    # the JAX kernel's lanes/block_rows rule is its tiling's; the function has none
    ok = tfx.stop_success_vector(n)
    assert bool(tk.stop(ok, EPS)) and bool(tk.stop(ok, EPS)) == bool(stop_check(ok, EPS))
    bad = ok.clone()
    bad[n // 2] = 2.0
    assert bool(tk.stop(bad, EPS)) == (n == 1)  # n = 1 pairs v[0] with itself
    bad[n // 2] = float("nan")
    assert not bool(tk.stop(bad, EPS))


def test_stop_reads_eps_from_a_tensor_and_is_strict():
    v = torch.tensor([1.0, 1.5, 1.25])
    assert not bool(tk.stop(v, torch.tensor(0.5)))  # |1.0 - 1.5| < 0.5 is false
    assert bool(tk.stop(v, torch.tensor(0.5000001)))
    assert bool(stop_check(v, torch.tensor(0.5000001)))
    before = tk.stop.launches
    tk.stop(v, 0.5)
    assert tk.stop.launches == before  # the CPU runs the plain version, uncounted


@pytest.mark.parametrize(
    "v, eps, match",
    [
        (torch.ones(4, dtype=torch.float64), 1e-3, "float32"),
        (torch.ones(8)[::2], 1e-3, "contiguous"),
        (torch.ones(2, 2), 1e-3, "vector"),
        (torch.ones(0), 1e-3, "non-empty"),
        (torch.ones(4), torch.ones(2), "shape"),
        (torch.ones(4), torch.tensor(1e-3, dtype=torch.float64), "float32"),
        (torch.ones(4), torch.tensor(1e-3, device="meta"), "must be on"),
    ],
)
def test_stop_rejects(v, eps, match):
    with pytest.raises(ValueError, match=match):
        tk.stop(v, eps)


# --- the one-launch rounds --------------------------------------------------------


def _round_inputs(rng, n=128):
    a = rng.random((n, n), dtype=np.float32) + np.float32(1e-2)
    v = a.sum(axis=1, dtype=np.float32)
    ev = np.full(n, 0.5, np.float32)
    return a, ev, v


@pytest.mark.parametrize("fn", [tk.round_matvec, tk.round_matvec_plain], ids=["wrapper", "plain"])
def test_round_matvec_matches_pallas(fn, rng):
    a, ev, v = _round_inputs(rng)
    m = v.max()
    want_v, want_ev = jk.round_matvec(
        jnp.asarray(a), jnp.asarray(ev), jnp.asarray(v), jnp.asarray(m), **ROUND_KW
    )
    got_v, got_ev = fn(*map(torch.from_numpy, (a, ev, v)), torch.tensor(m))
    # the update is two rounded elementwise operations: the same bits
    np.testing.assert_array_equal(got_ev.numpy(), np.asarray(want_ev))
    # rtol 1e-6: the f32 row sums reduce in another order (64-blocks there)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-6)


@pytest.mark.parametrize("fn", [tk.round_fused, tk.round_fused_plain], ids=["wrapper", "plain"])
@pytest.mark.parametrize("converged", [False, True])
def test_round_fused_matches_pallas(fn, converged, rng):
    a, ev, v = _round_inputs(rng)
    if converged:
        v = np.asarray(jfx.stop_success_vector(128))
    want = jk.round_fused(jnp.asarray(a), jnp.asarray(ev), jnp.asarray(v), eps=EPS, **ROUND_KW)
    got = fn(*map(torch.from_numpy, (a, ev, v)), eps=EPS)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6)
    assert bool(got[2]) == bool(want[2]) == converged
    assert float(got[3]) == float(want[3]) == float(v[0])


def test_round_identities_inside_the_port(rng):
    a, ev, v = map(torch.from_numpy, _round_inputs(rng))
    m = torch.max(v)
    v_next, ev_new = tk.round_matvec(a, ev, v, m)
    assert torch.equal(ev_new, ev * (v / m))
    assert torch.equal(v_next, tk.matvec(a, ev_new) / ev_new)
    fused = tk.round_fused(a, ev, v, eps=EPS)
    assert torch.equal(fused[0], v_next) and torch.equal(fused[1], ev_new)
    assert bool(fused[2]) == bool(stop_check(v, EPS)) and torch.equal(fused[3], v[0])
    # a number for m is wrapped; the inputs are left alone and nothing is counted
    before = (tk.round_matvec.launches, tk.round_fused.launches)
    assert torch.equal(tk.round_matvec(a, ev, v, float(m))[0], v_next)
    assert (tk.round_matvec.launches, tk.round_fused.launches) == before


@pytest.mark.parametrize(
    "fn", [tk.round_matvec, tk.round_fused], ids=["round_matvec", "round_fused"])
@pytest.mark.parametrize(
    "a, ev, v, match",
    [
        (torch.ones(4, 4, dtype=torch.float64), torch.ones(4), torch.ones(4), "float32"),
        (torch.ones(4, 4), torch.ones(4, dtype=torch.float64), torch.ones(4), "float32"),
        (torch.ones(4, 5), torch.ones(4), torch.ones(4), "square"),
        (torch.ones(4, 4), torch.ones(5), torch.ones(4), "shape"),
        (torch.ones(4, 4), torch.ones(4), torch.ones(8)[::2], "contiguous"),
        (torch.ones(0, 0), torch.ones(0), torch.ones(0), "non-empty"),
    ],
)
def test_rounds_reject(fn, a, ev, v, match):
    args = (a, ev, v, 1.0) if fn is tk.round_matvec else (a, ev, v)
    kw = {} if fn is tk.round_matvec else {"eps": EPS}
    with pytest.raises(ValueError, match=match):
        fn(*args, **kw)


def test_round_matvec_rejects_an_m_that_is_no_scalar_here():
    a, x = torch.ones(4, 4), torch.ones(4)
    with pytest.raises(ValueError, match="shape"):
        tk.round_matvec(a, x, x, torch.ones(2))
    with pytest.raises(ValueError, match="must be on"):
        tk.round_matvec(a, x, x, torch.tensor(1.0, device="meta"))


# --- the fused-round solves -------------------------------------------------------

SOLVES = {
    "matvec_kernel_fused": (solve_matvec_kernel_fused, solve_matvec_pallas_fused),
    "fused_round": (solve_fused_round, jax_solve_fused_round),
}
BOTH_SOLVES = pytest.mark.parametrize("name", list(SOLVES))


def _close_to(got, want):
    assert int(got.rounds) == int(want.rounds)
    assert bool(got.converged) == bool(want.converged)
    # λ rel 1e-5 and ev atol 1e-5, the port's tolerances against JAX in
    # tests/test_torch_solver.py: the f32 row sums reduce in another order
    assert float(got.eigenvalue) == pytest.approx(float(want.eigenvalue), rel=1e-5)
    np.testing.assert_allclose(got.eigenvector.numpy(), np.asarray(want.eigenvector), atol=1e-5)


def _same(got, want):
    assert int(got.rounds) == int(want.rounds)
    assert bool(got.converged) == bool(want.converged)
    assert torch.equal(got.eigenvalue, want.eigenvalue)
    assert torch.equal(got.eigenvector, want.eigenvector)


@BOTH_SOLVES
@pytest.mark.parametrize("n", [128, 256, 512])
def test_fused_solves_keep_the_hilbert_table(n, name):
    ours, theirs = SOLVES[name]
    got = ours(tfx.hilbert_matrix(n), EPS, MAX_ITR)
    assert int(got.rounds) == tfx.HILBERT_ROUNDS[n] and bool(got.converged)
    _close_to(got, theirs(jfx.hilbert_matrix(n), EPS, MAX_ITR, interpret=True))
    _same(got, solve_matvec_kernel(tfx.hilbert_matrix(n), EPS, MAX_ITR))


@BOTH_SOLVES
@pytest.mark.parametrize("cap", [0, 1, 5])
def test_fused_solves_at_the_cap(cap, name):
    ours, theirs = SOLVES[name]
    got = ours(tfx.hilbert_matrix(256), EPS, cap)
    assert int(got.rounds) == cap and not bool(got.converged)
    _close_to(got, theirs(jfx.hilbert_matrix(256), EPS, cap, interpret=True))
    _same(got, solve_matvec_kernel(tfx.hilbert_matrix(256), EPS, cap))


@BOTH_SOLVES
def test_fused_solves_on_the_anchor_and_a_random_matrix(name, rng):
    ours, theirs = SOLVES[name]
    anchor = torch.tensor(tfx.ANCHOR_3X3, dtype=torch.float32)
    got = ours(anchor, EPS, MAX_ITR)
    assert float(got.eigenvalue) == pytest.approx(tfx.ANCHOR_3X3_EIGENVALUE, abs=1e-4)
    _same(got, solve_matvec_kernel(anchor, EPS, MAX_ITR))
    a = rng.random((256, 256), dtype=np.float32)
    got = ours(torch.from_numpy(a), EPS, MAX_ITR)
    _same(got, solve_matvec_kernel(torch.from_numpy(a), EPS, MAX_ITR))
    # a random matrix's row sums (~128) carry rounding near the absolute
    # stop, so between two summation orders only the eigenpair is compared
    want = theirs(jnp.asarray(a), EPS, MAX_ITR, interpret=True)
    assert float(got.eigenvalue) == pytest.approx(float(want.eigenvalue), rel=1e-5)
    ev = got.eigenvector.numpy()
    assert np.allclose(a @ ev, float(got.eigenvalue) * ev, atol=1e-3)


def test_fused_solves_leave_their_matrix_and_count_nothing_on_the_cpu():
    H = tfx.hilbert_matrix(128)
    keep = H.clone()
    before = (tk.matvec.launches, tk.round_matvec.launches, tk.round_fused.launches)
    for solve in (solve_matvec_kernel_fused, solve_fused_round):
        res = solve(H, EPS, MAX_ITR)
        assert res.rounds.dtype == torch.int32 and res.converged.dtype == torch.bool
    assert torch.equal(H, keep)
    assert (tk.matvec.launches, tk.round_matvec.launches, tk.round_fused.launches) == before
