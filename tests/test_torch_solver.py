"""The port's solve, end to end, against the JAX package.

Both packages get the same matrices (made with numpy, or by the bitwise
equal Hilbert fixtures).  On the CPU the port's kernel backends run their
plain versions; JAX runs ``solve_matvec`` and ``solve_matvec_pallas`` with
``interpret=True``, as its own tests do.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from eigen_value_tpu import SolverConfig as JaxConfig  # noqa: E402
from eigen_value_tpu import fixtures as jfx  # noqa: E402
from eigen_value_tpu.ops.solver_matvec import solve_matvec as jax_solve_matvec  # noqa: E402
from eigen_value_tpu.ops.solver_matvec import solve_matvec_pallas  # noqa: E402
from eigen_value_tpu.ops.solver_matvec import solve_multiround as jax_solve_multiround  # noqa: E402
import eigen_value_tpu_torch as evt  # noqa: E402
from eigen_value_tpu_torch import fixtures as tfx  # noqa: E402
from eigen_value_tpu_torch import api  # noqa: E402
from eigen_value_tpu_torch.api import resolve_backend  # noqa: E402
from eigen_value_tpu_torch.ops.cuda import kernels as tk  # noqa: E402
from eigen_value_tpu_torch.ops.solver_matvec import (  # noqa: E402
    solve_matvec,
    solve_matvec_kernel,
    solve_multiround,
)

EPS, MAX_ITR = 1e-3, 1000
BACKENDS = ["matvec", "matvec_pallas", "multiround"]


def _close_to(got, want, ev_atol=1e-4):
    assert int(got.rounds) == int(want.rounds)
    assert bool(got.converged) == bool(want.converged)
    assert float(got.eigenvalue) == pytest.approx(float(want.eigenvalue), rel=1e-5)
    np.testing.assert_allclose(
        got.eigenvector.numpy(), np.asarray(want.eigenvector), atol=ev_atol
    )


def _same(got, want):
    assert int(got.rounds) == int(want.rounds)
    assert bool(got.converged) == bool(want.converged)
    assert torch.equal(got.eigenvalue, want.eigenvalue)
    assert torch.equal(got.eigenvector, want.eigenvector)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", [128, 256, 512, 1024])
def test_hilbert_matches_jax_solve_matvec(n, backend):
    got = evt.max_eigenvalue(tfx.hilbert_matrix(n), evt.SolverConfig(backend=backend))
    want = jax_solve_matvec(jfx.hilbert_matrix(n), EPS, MAX_ITR)
    assert int(got.rounds) == tfx.HILBERT_ROUNDS[n] == int(want.rounds)
    _close_to(got, want)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", [128, 512])
def test_hilbert_matches_jax_matvec_pallas(n, backend):
    got = evt.max_eigenvalue(tfx.hilbert_matrix(n), evt.SolverConfig(backend=backend))
    want = solve_matvec_pallas(jfx.hilbert_matrix(n), EPS, MAX_ITR, interpret=True)
    _close_to(got, want)


def test_random_matrix_matches_jax(rng):
    a = rng.random((200, 200), dtype=np.float32) + np.float32(1e-4)
    want = jax_solve_matvec(jnp.asarray(a), EPS, MAX_ITR)
    for backend in BACKENDS:
        _close_to(evt.max_eigenvalue(a, evt.SolverConfig(backend=backend), device="cpu"), want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_anchor_3x3(backend):
    res = evt.max_eigenvalue(tfx.ANCHOR_3X3, evt.SolverConfig(backend=backend), device="cpu")
    assert bool(res.converged)
    assert abs(float(res.eigenvalue) - tfx.ANCHOR_3X3_EIGENVALUE) < 1e-4
    np.testing.assert_allclose(res.eigenvector.numpy(), tfx.ANCHOR_3X3_EIGENVECTOR, atol=1e-3)


@pytest.mark.parametrize("cap", [0, 1, 3, 9, 10, 11])
@pytest.mark.parametrize("backend", BACKENDS)
def test_cap_matches_jax(cap, backend):
    cfg = evt.SolverConfig(backend=backend, max_itr=cap, chunk=4 if backend == "multiround" else None)
    got = evt.max_eigenvalue(tfx.hilbert_matrix(256), cfg)
    want = jax_solve_matvec(jfx.hilbert_matrix(256), EPS, cap)
    assert bool(got.converged) == bool(want.converged)
    assert int(got.rounds) == int(want.rounds) == min(cap, 10)
    if cap == 0:
        assert float(got.eigenvalue) == float(want.eigenvalue) == 0.0
    else:
        assert float(got.eigenvalue) == pytest.approx(float(want.eigenvalue), rel=1e-5)


@pytest.mark.parametrize("cap", [0, 1, 3, 9, 10, 11])
def test_multiround_cap_bitidentical_to_kernel_loop(cap):
    H = tfx.hilbert_matrix(256)
    _same(solve_multiround(H, EPS, cap, chunk=4), solve_matvec_kernel(H, EPS, cap))


@pytest.mark.parametrize("chunk", [None, 1, 2, 5, 18])
def test_chunk_splits_are_bitidentical(chunk):
    H = tfx.hilbert_matrix(256)
    _same(solve_multiround(H, EPS, MAX_ITR, chunk=chunk), solve_matvec_kernel(H, EPS, MAX_ITR))


def test_relative_eps_mode_matches_jax():
    a = (np.random.default_rng(7).random((128, 128), np.float32) + np.float32(0.1)) * np.float32(1e5)
    want = jax_solve_matvec(jnp.asarray(a), EPS, MAX_ITR, eps_mode="relative")
    for backend in BACKENDS:
        cfg = evt.SolverConfig(backend=backend, eps_mode="relative")
        got = evt.max_eigenvalue(a, cfg, device="cpu")
        assert int(got.rounds) == int(want.rounds) and bool(got.converged)
        assert float(got.eigenvalue) == pytest.approx(float(want.eigenvalue), rel=1e-5)


def test_round_zero_convergence():
    M = torch.full((128, 128), 0.25)
    for backend in BACKENDS:
        res = evt.max_eigenvalue(M, evt.SolverConfig(backend=backend))
        assert bool(res.converged) and int(res.rounds) == 0
        assert float(res.eigenvalue) == pytest.approx(32.0, abs=1e-3)


def test_ev0_is_scale_invariant():
    H = tfx.hilbert_matrix(128)
    base = solve_multiround(H, EPS, MAX_ITR, chunk=10)
    got = solve_multiround(H, EPS, MAX_ITR, chunk=10, ev0=torch.ones(128))
    _same(got, base)
    assert int(solve_matvec(H, EPS, MAX_ITR, ev0=np.full(128, 2.0)).rounds) == int(base.rounds)


def _reject_cases():
    H = tfx.hilbert_matrix(16)
    return {
        "symmetric+multiround": lambda: evt.max_eigenvalue(
            H, evt.SolverConfig(backend="multiround", symmetric=True)),
        "symmetric+matvec": lambda: evt.max_eigenvalue(
            H, evt.SolverConfig(backend="matvec", symmetric=True)),
        "cache_tiles": lambda: evt.max_eigenvalue(
            H, evt.SolverConfig(backend="multiround", cache_tiles=4)),
        "cache_tiles+matvec": lambda: evt.max_eigenvalue(
            H, evt.SolverConfig(backend="matvec", cache_tiles=0)),
        "storage_dtype": lambda: evt.max_eigenvalue(
            H, evt.SolverConfig(backend="pallas", storage_dtype=torch.bfloat16)),
        "xla": lambda: evt.max_eigenvalue(
            H, evt.SolverConfig(backend="xla", storage_dtype=torch.bfloat16)),
        "pallas": lambda: evt.max_eigenvalue(
            H, evt.SolverConfig(backend="pallas", eps_mode="relative")),
        "mesh": lambda: evt.max_eigenvalue(H, mesh=object()),
        "formulation": lambda: solve_multiround(H, EPS, MAX_ITR, formulation="dot"),
        "block_rows": lambda: evt.max_eigenvalue(H, evt.SolverConfig(block_rows=128)),
        "block_cols": lambda: evt.max_eigenvalue(H, evt.SolverConfig(block_cols=128)),
        "interpret": lambda: evt.max_eigenvalue(H, evt.SolverConfig(interpret=True)),
        "chunk+matvec": lambda: evt.max_eigenvalue(H, evt.SolverConfig(chunk=4)),
        "non-square": lambda: evt.max_eigenvalue(torch.ones(3, 4)),
        "validate-positive": lambda: evt.max_eigenvalue(-H, validate=True),
        "validate-symmetric": lambda: evt.max_eigenvalue(
            torch.triu(H) + 1.0, evt.SolverConfig(symmetric=True), validate=True),
        "EigenValue-storage": lambda: evt.EigenValue(
            evt.SolverConfig(backend="xla", storage_dtype=torch.float16)).similarity_transform(H),
        "storage_dtype-f64": lambda: evt.max_eigenvalue(
            H, evt.SolverConfig(storage_dtype=torch.float64)),
        "float64+multiround": lambda: evt.max_eigenvalue(
            H, evt.SolverConfig(backend="multiround", dtype=torch.float64)),
        "float64+matvec_pallas": lambda: evt.max_eigenvalue(
            H, evt.SolverConfig(backend="matvec_pallas", dtype=torch.float64)),
        "float64+pallas": lambda: evt.max_eigenvalue(
            H, evt.SolverConfig(backend="pallas", dtype=torch.float64)),
    }


@pytest.mark.parametrize("case", sorted(_reject_cases()))
def test_rejected_knobs_raise(case):
    with pytest.raises(ValueError):
        _reject_cases()[case]()


@pytest.mark.parametrize(
    "kw",
    [dict(chunk=0), dict(max_itr=-1), dict(eps=0.0), dict(backend="bogus"),
     dict(eps_mode="bogus"), dict(cache_tiles=-1), dict(block_rows=7), dict(block_rows=0),
     dict(block_rows=-8), dict(block_rows=100), dict(block_cols=100), dict(block_cols=0),
     dict(block_cols=64), dict(block_cols=200)],
)
def test_config_validation_mirrors_jax(kw):
    with pytest.raises(ValueError):
        JaxConfig(**kw)
    with pytest.raises(ValueError):
        evt.SolverConfig(**kw)


def test_not_ported_errors_name_the_roadmap():
    # mesh= is ported (tests/test_torch_sharded.py): an object that is no
    # mesh names the dimension it lacks
    with pytest.raises(ValueError, match="mesh has no 'rows' axis"):
        _reject_cases()["mesh"]()
    # "mixed" and the pipelined fill are ported; what is left are JAX's own
    # errors: both need a resident tile, and at 128² (one tile) a cache
    # request clamps to none
    H = tfx.hilbert_matrix(128)
    for kw in (dict(formulation="mixed"), dict(cache_tiles=1, fill_mode="pipelined")):
        with pytest.raises(ValueError, match="cache_tiles > 0"):
            solve_multiround(H, EPS, MAX_ITR, symmetric=True, **kw)
        with pytest.raises(ValueError, match="cache_tiles > 0"):
            jax_solve_multiround(jfx.hilbert_matrix(128), EPS, MAX_ITR, interpret=True,
                                 symmetric=True, tile=128, **kw)
    H = tfx.hilbert_matrix(256)
    res = solve_multiround(H, EPS, MAX_ITR, symmetric=True, cache_tiles=1, fill_mode="pipelined")
    assert int(res.rounds) == tfx.HILBERT_ROUNDS[256] and bool(res.converged)


def test_symmetric_under_auto_is_consumed_by_the_dense_solve():
    H = tfx.hilbert_matrix(128)
    got = evt.max_eigenvalue(H, evt.SolverConfig(symmetric=True), validate=True)
    _same(got, evt.max_eigenvalue(H))


def test_resolve_backend():
    cpu = torch.device("cpu")
    assert resolve_backend(evt.SolverConfig(), 8192, cpu) == "matvec"
    for b in BACKENDS:
        assert resolve_backend(evt.SolverConfig(backend=b), 64, cpu) == b


def test_eigen_residual_and_similarity_transform():
    H = tfx.hilbert_matrix(256)
    res = evt.max_eigenvalue(H, evt.SolverConfig(backend="multiround"))
    assert float(evt.eigen_residual(H, res)) < 1e-3
    lam, vec, ms, rounds = evt.EigenValue(
        evt.SolverConfig(backend="multiround"), device="cpu"
    ).similarity_transform(np.asarray(jfx.hilbert_matrix(256)))
    assert isinstance(lam, np.float32) and isinstance(vec, np.ndarray)
    assert rounds == 10 and ms >= 0.0 and lam == float(res.eigenvalue)


def test_kernel_backends_on_cpu_launch_nothing():
    before = (tk.matvec.launches, tk.multiround.launches)
    for b in BACKENDS:
        evt.max_eigenvalue(tfx.hilbert_matrix(64), evt.SolverConfig(backend=b))
    assert (tk.matvec.launches, tk.multiround.launches) == before



@pytest.mark.parametrize("kw", [dict(block_rows=8), dict(block_rows=128), dict(block_cols=128),
                                dict(block_cols=512)])
def test_config_accepts_what_jax_accepts(kw):
    JaxConfig(**kw)
    evt.SolverConfig(**kw)


@pytest.mark.parametrize("backend", ["multiround", "matvec_pallas", "pallas"])
def test_kernel_backends_reject_a_non_f32_dtype_by_name(backend):
    with pytest.raises(ValueError, match="dtype=torch.float64"):
        evt.max_eigenvalue(tfx.hilbert_matrix(16),
                           evt.SolverConfig(backend=backend, dtype=torch.float64))


def test_float64_under_auto_takes_the_plain_loop_and_matches_the_oracle():
    from eigen_value_tpu.reference_impl import parallel_oracle

    cfg = evt.SolverConfig(dtype=torch.float64)
    for dev in (torch.device("cpu"), torch.device("cuda", 0)):
        assert resolve_backend(cfg, 8192, dev) == "matvec"  # on a card too
    H = tfx.hilbert_matrix(256, dtype=torch.float64)
    got = evt.max_eigenvalue(H, cfg)
    want = parallel_oracle(H.numpy(), dtype=np.float64)
    assert got.eigenvalue.dtype == got.eigenvector.dtype == torch.float64
    assert bool(got.converged) and int(got.rounds) == want.rounds == tfx.HILBERT_ROUNDS[256]
    assert float(got.eigenvalue) == pytest.approx(want.eigenvalue, rel=1e-9)
    assert float(evt.eigen_residual(H, got)) < 1e-3


def test_a_misaligned_contiguous_view_is_cloned_to_an_aligned_buffer():
    n = 128
    H = tfx.hilbert_matrix(n)
    buf = torch.empty(n * n + 1)
    view = buf[1:].view(n, n)
    view.copy_(H)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    mat = api._as_matrix(view, evt.DEFAULT_CONFIG)
    assert mat.data_ptr() % 16 == 0 and torch.equal(mat, H)
    aligned = api._as_matrix(H, evt.DEFAULT_CONFIG)
    assert aligned is H  # an aligned f32 matrix is not copied
    _same(evt.max_eigenvalue(view), evt.max_eigenvalue(H))


def test_warmup_resolves_and_rejects_on_the_cpu():
    ev = evt.EigenValue(evt.SolverConfig(backend="multiround"), device="cpu")
    assert ev.last_wall_ms is None
    ev.warmup([128, 256])
    ev.warmup([128], dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="chunk"):
        evt.EigenValue(evt.SolverConfig(backend="matvec", chunk=4), device="cpu").warmup([128])
    with pytest.raises(ValueError, match="dtype"):
        evt.EigenValue(evt.SolverConfig(backend="pallas", dtype=torch.float64),
                       device="cpu").warmup([64])
    with pytest.raises(ValueError, match="dtype"):
        ev.warmup([64], dtype=torch.int32)
    lam, _, ms, rounds = ev.similarity_transform(tfx.hilbert_matrix(128))
    assert rounds == 9 and ev.last_wall_ms == ms > 0.0


def test_warmup_without_a_device_follows_the_solves_rule(monkeypatch):
    # no card: host input raises, and so does a warmup that names no device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError) as solve_err:
        evt.EigenValue(evt.SolverConfig(backend="multiround")).similarity_transform(
            np.asarray(tfx.hilbert_matrix(128)))
    with pytest.raises(RuntimeError) as warm_err:
        evt.EigenValue(evt.SolverConfig(backend="multiround")).warmup([128])
    assert str(warm_err.value) == str(solve_err.value)
    assert "device='cpu'" in str(warm_err.value)
    ev = evt.EigenValue(evt.SolverConfig(backend="multiround"), device="cpu")
    ev.warmup([128])
    assert ev.similarity_transform(tfx.hilbert_matrix(128))[3] == 9
