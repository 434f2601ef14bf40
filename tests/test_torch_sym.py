"""The symmetric (upper-triangle) path of the port against the JAX package.

``kernels.multiround_sym`` and ``solve_multiround(symmetric=True)`` on the
CPU run the plain tiled version; JAX runs ``multiround_sym`` with
``interpret=True``, as tests/test_multiround_sym.py does.  Inputs are made
with numpy from a seed (or are the bitwise-equal Hilbert fixtures) and
handed to both.  Routing on a card is tested with a fake CUDA device: the
card's limits are patched in, nothing is launched.  The kernel itself is
tested on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from eigen_value_tpu import SolverConfig as JaxConfig  # noqa: E402
from eigen_value_tpu import fixtures as jfx  # noqa: E402
from eigen_value_tpu import max_eigenvalue as jax_max_eigenvalue  # noqa: E402
from eigen_value_tpu.ops.pallas import kernels as jk  # noqa: E402
from eigen_value_tpu.ops.solver_matvec import solve_matvec as jax_solve_matvec  # noqa: E402
from eigen_value_tpu.ops.solver_matvec import solve_multiround as jax_solve_multiround  # noqa: E402
import eigen_value_tpu_torch as evt  # noqa: E402
from eigen_value_tpu_torch import api, device  # noqa: E402
from eigen_value_tpu_torch import fixtures as tfx  # noqa: E402
from eigen_value_tpu_torch.ops.cuda import kernels as tk  # noqa: E402
from eigen_value_tpu_torch.ops.solver_matvec import solve_multiround  # noqa: E402

EPS, MAX_ITR = 1e-3, 1000
H100 = device.CudaLimits(sms=132, smem_per_block_optin=232448, l2_bytes=52428800)


def _sym(n, seed=3, scale=1.0):
    """A random symmetric matrix with all entries > 0 (numpy)."""
    r = np.random.default_rng(seed).random((n, n), np.float32) + np.float32(0.1)
    return ((r + r.T) * np.float32(scale)).astype(np.float32)


def _below_block_diagonal(n, bt):
    blk = np.arange(n) // bt
    return blk[:, None] > blk[None, :]


def _corrupt(a, bt, value=7.25):
    return np.where(_below_block_diagonal(a.shape[0], bt), np.float32(value), a)


def _solve_sym(A, chunk=18, **kw):
    return solve_multiround(torch.as_tensor(A), EPS, MAX_ITR, chunk=chunk, symmetric=True, **kw)


def _same(got, want):
    assert int(got.rounds) == int(want.rounds)
    assert bool(got.converged) == bool(want.converged)
    assert torch.equal(got.eigenvalue, want.eigenvalue)
    assert torch.equal(got.eigenvector, want.eigenvector)


@pytest.fixture
def fake_h100(monkeypatch):
    """A CUDA device whose limits are an H100's; nothing may launch on it."""
    monkeypatch.setattr(device, "cuda_limits", lambda dev: H100)
    return torch.device("cuda", 0)


# --- tile rules, held equal to JAX's -----------------------------------------


@pytest.mark.parametrize(
    "n, tile",
    [(8192, 512), (8192, 1024), (1024, 512), (640, 512), (384, 512), (96, 512),
     (3, 512), (8200, 512), (8192, 128), (384, 128), (256, 100)],
)
def test_sym_tile_matches_jax(n, tile):
    assert tk.sym_tile(n, tile) == jk.sym_tile(n, tile)


@pytest.mark.parametrize("n, bt, c", [(8192, 512, 0), (8192, 512, 96), (8192, 512, 10_000),
                                      (8192, 512, -1), (512, 128, 3), (8192, 128, 264)])
def test_sym_cache_split_matches_jax(n, bt, c):
    assert tk.sym_cache_split(n, bt, c) == jk.sym_cache_split(n, bt, c)


def test_dense_tile_split_covers_every_tile_once():
    streamed, cached = tk._tile_split(384, 128, 5, sym=False)
    assert len(cached) == 5 and len(streamed) == 4
    assert sorted(streamed + cached) == [(i, j) for i in range(3) for j in range(3)]
    assert all(abs(i - j) == 2 for i, j in cached[:2])  # furthest first
    assert len(tk._tile_split(384, 128, 100, sym=False)[1]) == 8  # one tile streams


def test_sym_auto_cache_tiles_from_the_cards_limits(fake_h100):
    # 232448 - 1024 - 4 * 8192 = 198656 bytes beside ev: three 64 KiB
    # tiles per block, one block per SM
    assert device.sym_auto_cache_tiles(8192, 128, fake_h100) == 396
    assert device.sym_auto_cache_tiles(8192, 128, fake_h100, sym=False) == 396
    assert device.sym_auto_cache_tiles(384, 128, fake_h100) == 3  # g(g-1)/2
    assert device.sym_auto_cache_tiles(384, 128, fake_h100, sym=False) == 8  # g² - 1
    assert device.sym_auto_cache_tiles(8192, 512, fake_h100) == 0  # a 1 MiB tile
    assert device.sym_auto_cache_tiles(32768, 128, fake_h100) == 132  # one a block
    assert device.sym_auto_cache_tiles(40960, 128, fake_h100) == 132  # 67584 bytes beside ev
    assert device.sym_auto_cache_tiles(41600, 128, fake_h100) == 0  # none beside ev
    assert device.sym_auto_cache_tiles(8192, 128, torch.device("cpu")) == 0


# --- the row terms' lane exchange (csrc/multiround_sym.cu rows8_sum) --------
#
# The kernel adds the 32 lane partials of each of a trip's eight rows in
# float32 on the card.  Both exchanges are emulated here lane by lane in
# float32 numpy: one xor butterfly per row (offsets 16, 8, 4, 2, 1; each
# lane adds its partner's value to its own), and the transposed one that
# replaced it (a reduce-scatter over the rows at offsets 16, 8, 4, then the
# butterfly at 2 and 1, then row u fetched from lane 4u).  They must agree
# bit for bit on every lane that keeps a row.

LANES = np.arange(32)


def _butterfly_per_row(p):
    """(32 lanes, 8 rows) partials -> (32, 8): row u's sum on every lane."""
    out = np.empty_like(p)
    for u in range(8):
        a = p[:, u].copy()
        for off in (16, 8, 4, 2, 1):
            a = a + a[LANES ^ off]
        out[:, u] = a
    return out


def _butterfly_transposed(p):
    """(32 lanes, 8 rows) partials -> (8,): row u's sum as lane r8 + u
    receives it from lane 4u, and (32,): the sum each lane holds (row l >> 2)."""
    h4, h3, h2 = (LANES & 16) != 0, (LANES & 8) != 0, (LANES & 4) != 0
    e = [np.where(h4, p[:, i + 4], p[:, i]) + np.where(h4, p[:, i], p[:, i + 4])[LANES ^ 16]
         for i in range(4)]
    f = [np.where(h3, e[i + 2], e[i]) + np.where(h3, e[i], e[i + 2])[LANES ^ 8] for i in range(2)]
    g = np.where(h2, f[1], f[0]) + np.where(h2, f[0], f[1])[LANES ^ 4]
    g = g + g[LANES ^ 2]
    g = g + g[LANES ^ 1]
    return g[np.arange(8) << 2], g


def _partials(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "hilbert":  # dot4 terms of Hilbert rows against a smooth ev
        i = rng.integers(0, 8192, (32, 8, 4))
        j = rng.integers(0, 8192, (32, 8, 4))
        ev = rng.uniform(0.5, 1.0, (32, 8, 4))
        return ((ev / (i + j + 1)).sum(axis=2)).astype(np.float32)
    if kind == "huge_tiny":  # ±1e±30 mixed in one row: absorption everywhere
        mag = np.float32(10.0) ** rng.choice([-30, -1, 0, 1, 30], (32, 8)).astype(np.float32)
        return (mag * rng.choice([-1.0, 1.0], (32, 8)) * rng.uniform(1, 2, (32, 8))).astype(
            np.float32)
    if kind == "spread":  # exponents spread over 2^-100 .. 2^100
        return (rng.uniform(-1, 1, (32, 8)) * 2.0 ** rng.integers(-100, 100, (32, 8))).astype(
            np.float32)
    if kind == "cancel":  # large pairs that cancel, and small rest
        a = rng.uniform(1e6, 1e7, (16, 8)).astype(np.float32)
        return np.concatenate([a, -a], axis=0) + rng.normal(0, 1, (32, 8)).astype(np.float32)
    if kind == "subnormal":
        return (rng.uniform(-1, 1, (32, 8)) * np.float32(1e-39)).astype(np.float32)
    return rng.standard_normal((32, 8)).astype(np.float32)


@pytest.mark.parametrize("kind", ["hilbert", "huge_tiny", "spread", "cancel", "subnormal",
                                  "normal"])
def test_the_transposed_row_exchange_is_the_per_row_butterfly_bit_for_bit(kind):
    with np.errstate(over="ignore", under="ignore"):
        for seed in range(200):
            p = _partials(kind, seed)
            assert p.dtype == np.float32
            want = _butterfly_per_row(p)
            routed, held = _butterfly_transposed(p)
            for u in range(8):
                # the per-row butterfly leaves one value on all 32 lanes
                assert len(set(want[:, u].view(np.uint32).tolist())) == 1
                assert routed[u].view(np.uint32) == want[0, u].view(np.uint32), (kind, seed, u)
                # the four lanes that hold row u agree
                assert (held[4 * u:4 * u + 4].view(np.uint32) == want[0, u].view(np.uint32)).all()


# --- kernel: plain version against the JAX kernel in interpret mode ----------


def _jax_state(A, init_chunk=3):
    ev0 = jnp.ones((A.shape[0],), jnp.float32)
    ev, v, _, lam = jk.multiround(jnp.asarray(A), ev0, ev0, 0.0, 1000, chunk=init_chunk,
                                  eps=EPS, init=True, interpret=True)
    return np.asarray(ev), np.asarray(v), np.asarray(lam)


@pytest.mark.parametrize("cache_tiles", [0, 3])
@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("init", [True, False])
@pytest.mark.parametrize("n", [256, 512])
def test_multiround_sym_plain_matches_pallas(n, init, chunk, sym, cache_tiles):
    # the triangle mode gets a symmetric matrix, the dense mode a general one
    A = np.asarray(jfx.hilbert_matrix(n)) if sym else (
        np.random.default_rng(n).random((n, n), np.float32) + np.float32(0.1))
    if init:
        ev = v = np.ones(n, np.float32)
        lam = np.float32(0.0)
    else:
        ev, v, lam = _jax_state(A)
    kw = dict(chunk=chunk, eps=EPS, init=init, tile=128, cache_tiles=cache_tiles, sym=sym)
    want = jk.multiround_sym(jnp.asarray(A), jnp.asarray(ev), jnp.asarray(v),
                             jnp.asarray(lam), 1000, interpret=True, **kw)
    before = tk.multiround_sym.launches
    got = tk.multiround_sym(torch.tensor(A), torch.tensor(ev), torch.tensor(v),
                            torch.tensor(lam), 1000, **kw)
    assert tk.multiround_sym.launches == before  # a CPU tensor runs the plain version
    assert int(got[2]) == int(want[2])
    for g, w in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)


@pytest.mark.parametrize("budget", [0, 2])
def test_multiround_sym_budget_freeze_matches_pallas(budget):
    A = np.asarray(jfx.hilbert_matrix(256))
    ev, v, lam = _jax_state(A)
    want = jk.multiround_sym(jnp.asarray(A), jnp.asarray(ev), jnp.asarray(v), jnp.asarray(lam),
                             budget, chunk=6, eps=EPS, tile=128, interpret=True)
    got = tk.multiround_sym(torch.tensor(A), torch.tensor(ev), torch.tensor(v),
                            torch.tensor(lam), budget, chunk=6, eps=EPS, tile=128)
    assert int(got[2]) == int(want[2]) == budget
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5)


def test_tiled_matvec_plain_reads_only_the_upper_block_triangle():
    a = _sym(512)
    x = torch.from_numpy(np.random.default_rng(1).random(512, np.float32) + np.float32(0.5))
    want = torch.from_numpy(a).double() @ x.double()
    got = tk.tiled_matvec_plain(torch.from_numpy(_corrupt(a, 128)), x, 128, sym=True)
    assert float(((got.double() - want).abs() / want).max()) < 1e-6
    dense = np.random.default_rng(2).random((384, 384), np.float32)
    got = tk.tiled_matvec_plain(torch.from_numpy(dense), x[:384], 128, sym=False)
    np.testing.assert_allclose(got.numpy(), dense @ x[:384].numpy(), rtol=1e-5)


def test_multiround_sym_wrapper_rejects():
    H, ev = tfx.hilbert_matrix(256), torch.ones(256)
    call = lambda **kw: tk.multiround_sym(H, ev, ev, 0.0, 10, **{"chunk": 2, "eps": EPS, **kw})  # noqa: E731
    for kw, match in [
        (dict(formulation="bogus"), "unknown formulation"),
        (dict(formulation="mixed"), "cache_tiles > 0"),
        (dict(cache_tiles=2, mxu_tiles=1), "only meaningful"),
        (dict(fill_mode="pipelined"), "cache_tiles > 0"),
        (dict(cache_tiles=2, fill_mode="bogus"), "unknown fill_mode"),
        (dict(chunk=0), "chunk"),
        (dict(eps_mode="rel"), "eps_mode"),
        (dict(tile=100), "128-aligned"),
    ]:
        with pytest.raises(ValueError, match=match):
            call(**kw)
    with pytest.raises(ValueError, match="128-aligned"):
        tk.multiround_sym(tfx.hilbert_matrix(96), torch.ones(96), torch.ones(96), 0.0, 10,
                          chunk=2, eps=EPS)
    # the ported variants run (tests/test_torch_mixed.py holds them to JAX)
    base = call(init=True)
    for kw in (dict(cache_tiles=1, mxu_tiles=0, formulation="mixed"),
               dict(cache_tiles=1, fill_mode="pipelined")):
        assert all(torch.equal(a, b) for a, b in zip(call(init=True, **kw), base))
    assert int(call(init=True, formulation="mixed", cache_tiles=1)[2]) == int(base[2]) == 1
    with pytest.raises(ValueError, match="shape"):
        tk.multiround_sym(H, torch.ones(255), ev, 0.0, 10, chunk=2, eps=EPS)
    with pytest.raises(ValueError, match="float32"):
        tk.multiround_sym(H.double(), ev.double(), ev.double(), 0.0, 10, chunk=2, eps=EPS)


# --- the solve against JAX ---------------------------------------------------


@pytest.mark.parametrize("n", [128, 256, 512])
def test_symmetric_solve_round_parity_matches_jax(n):
    H = jfx.hilbert_matrix(n)
    want = jax_solve_multiround(H, EPS, MAX_ITR, chunk=18, interpret=True, symmetric=True,
                                tile=128)
    got = _solve_sym(tfx.hilbert_matrix(n))
    assert int(got.rounds) == int(want.rounds) == tfx.HILBERT_ROUNDS[n]
    assert bool(got.converged)
    assert float(got.eigenvalue) == pytest.approx(float(want.eigenvalue), rel=1e-5)
    np.testing.assert_allclose(got.eigenvector.numpy(), np.asarray(want.eigenvector), rtol=1e-4)
    dense = jax_solve_matvec(H, EPS, MAX_ITR)
    np.testing.assert_allclose(got.eigenvector.numpy(), np.asarray(dense.eigenvector), rtol=1e-4)


@pytest.mark.parametrize("n", [128, 256, 512])
def test_symmetric_api_path_matches_jax(n):
    cfg = dict(backend="multiround", symmetric=True, block_rows=128)
    want = jax_max_eigenvalue(jfx.hilbert_matrix(n), JaxConfig(interpret=True, **cfg))
    got = evt.max_eigenvalue(tfx.hilbert_matrix(n), evt.SolverConfig(**cfg), validate=True)
    assert int(got.rounds) == int(want.rounds) == tfx.HILBERT_ROUNDS[n]
    assert float(got.eigenvalue) == pytest.approx(float(want.eigenvalue), rel=1e-5)
    np.testing.assert_allclose(got.eigenvector.numpy(), np.asarray(want.eigenvector), rtol=1e-4)


@pytest.mark.parametrize("cap", [0, 1, 9, 10])
def test_cap_exhaustion_matches_jax(cap):
    H = tfx.hilbert_matrix(256)
    want = jax_solve_multiround(jfx.hilbert_matrix(256), EPS, cap, chunk=50, interpret=True,
                                symmetric=True, tile=128)
    got = solve_multiround(H, EPS, cap, chunk=4, symmetric=True)
    assert int(got.rounds) == int(want.rounds) == min(cap, tfx.HILBERT_ROUNDS[256])
    assert bool(got.converged) == bool(want.converged) == (cap > tfx.HILBERT_ROUNDS[256])
    if cap == 0:
        assert float(got.eigenvalue) == float(want.eigenvalue) == 0.0
    else:
        assert float(got.eigenvalue) == pytest.approx(float(want.eigenvalue), rel=1e-5)
    _same(got, solve_multiround(H, EPS, cap, chunk=50, symmetric=True))


@pytest.mark.parametrize("chunk", [1, 2, 5, 16, 40])
def test_chunk_boundaries_are_invisible(chunk):
    H = tfx.hilbert_matrix(256)
    _same(_solve_sym(H, chunk=chunk), _solve_sym(H, chunk=18))


@pytest.mark.parametrize("n, cache_tiles", [(256, 0), (512, 3), (512, 6)])
def test_lower_block_triangle_is_never_read(n, cache_tiles):
    a = _sym(n)
    want = _solve_sym(a, cache_tiles=cache_tiles)
    got = _solve_sym(_corrupt(a, 128), cache_tiles=cache_tiles)
    _same(got, want)
    _same(_solve_sym(a), want)  # the cache changes nothing


def test_relative_eps_mode_matches_jax():
    a = _sym(128, scale=1e5)
    want = jax_solve_matvec(jnp.asarray(a), EPS, MAX_ITR, eps_mode="relative")
    got = _solve_sym(a, eps_mode="relative")
    assert int(got.rounds) == int(want.rounds) and bool(got.converged)
    assert float(got.eigenvalue) == pytest.approx(float(want.eigenvalue), rel=1e-5)


def test_dense_cached_mode_matches_jax():
    a = np.random.default_rng(11).random((384, 384), np.float32) + np.float32(0.1)
    want = jax_solve_matvec(jnp.asarray(a), EPS, MAX_ITR)
    for c in (1, 5):
        got = solve_multiround(torch.from_numpy(a), EPS, MAX_ITR, chunk=5, cache_tiles=c)
        assert int(got.rounds) == int(want.rounds) and bool(got.converged)
        assert float(got.eigenvalue) == pytest.approx(float(want.eigenvalue), rel=1e-5)
    one = solve_multiround(torch.from_numpy(a), EPS, MAX_ITR, chunk=1, cache_tiles=3)
    _same(one, solve_multiround(torch.from_numpy(a), EPS, MAX_ITR, chunk=18, cache_tiles=3))


def test_solve_multiround_knob_rules():
    H = tfx.hilbert_matrix(256)
    with pytest.raises(ValueError, match="tiled-kernel knob"):
        solve_multiround(H, EPS, MAX_ITR, tile=128)
    with pytest.raises(ValueError, match="mxu_tiles"):
        solve_multiround(H, EPS, MAX_ITR, mxu_tiles=1)
    with pytest.raises(ValueError, match="fill_mode"):
        solve_multiround(H, EPS, MAX_ITR, fill_mode="pipelined")
    with pytest.raises(ValueError, match="128-aligned"):
        solve_multiround(tfx.hilbert_matrix(96), EPS, MAX_ITR, symmetric=True)


# --- routing: the honored-or-rejected contract -------------------------------


def _kernel_tile(r):
    return r.kernel, r.bt


def _backend_kernel(r):
    return r.backend, r.kernel


def _plan(r):
    """What a route launches: its kernel, tile edge and resident cache."""
    return r.kernel, r.bt, r.cache_tiles


def test_explicit_multiround_uses_the_triangle():
    a = _sym(256)
    cfg = evt.SolverConfig(backend="multiround", symmetric=True, block_rows=128)
    _same(evt.max_eigenvalue(_corrupt(a, 128, 9.5), cfg, device="cpu"),
          evt.max_eigenvalue(a, cfg, device="cpu"))


def test_block_rows_is_the_tile_edge():
    cpu = torch.device("cpu")
    cfg = evt.SolverConfig(backend="multiround", symmetric=True, block_rows=256)
    assert _kernel_tile(api.route(cfg, 512, cpu)) == ("triangle", 256)
    # 384 has no 128-multiple divisor at most 256 but 128: sym_tile picks 128
    assert _kernel_tile(api.route(cfg, 384, cpu)) == ("triangle", 128)
    res = evt.max_eigenvalue(tfx.hilbert_matrix(384), evt.SolverConfig(
        backend="multiround", symmetric=True, block_rows=256))
    assert bool(res.converged)
    with pytest.raises(ValueError, match="block_rows"):  # the stripes kernel takes none
        evt.max_eigenvalue(tfx.hilbert_matrix(384), evt.SolverConfig(
            backend="multiround", block_rows=128))


def test_cache_tiles_routing(fake_h100):
    def r(n=8192, **cfg):
        return api.route(evt.SolverConfig(**cfg), n, fake_h100)

    assert r(backend="multiround", symmetric=True).cache_tiles == 396  # the card's budget
    assert r(backend="multiround", symmetric=True).bt == tk.SYM_TILE
    assert r(backend="multiround", symmetric=True, cache_tiles=0).cache_tiles == 0
    assert r(backend="multiround", symmetric=True, cache_tiles=7).cache_tiles == 7
    # dense: the stripes kernel unless a cache is asked for explicitly
    assert _plan(r(backend="multiround")) == ("stripes", None, 0)
    assert _plan(r(backend="multiround", cache_tiles=0)) == ("stripes", None, 0)
    assert _plan(r(backend="multiround", cache_tiles=5)) == ("tiled", tk.SYM_TILE, 5)
    with pytest.raises(ValueError, match="128-aligned"):
        r(8200, backend="multiround", cache_tiles=4)
    with pytest.raises(ValueError, match="cache_tiles"):
        api.route(evt.SolverConfig(backend="matvec", cache_tiles=4), 512, torch.device("cpu"))
    # the explicit and the auto cache give the same answer (CPU: plain version)
    H = tfx.hilbert_matrix(512)
    _same(evt.max_eigenvalue(H, evt.SolverConfig(backend="multiround", symmetric=True)),
          evt.max_eigenvalue(H, evt.SolverConfig(backend="multiround", symmetric=True,
                                                 cache_tiles=0)))


def test_auto_routes_a_declared_symmetric_matrix_to_the_triangle_on_a_card(fake_h100):
    sym = evt.SolverConfig(symmetric=True)
    for n in (128, 384, 8192):
        assert _backend_kernel(api.route(sym, n, fake_h100)) == ("multiround", "triangle")
    # an unalignable n keeps the stripes kernel, which has no cache
    assert _backend_kernel(api.route(sym, 8200, fake_h100)) == ("multiround", "stripes")
    with pytest.raises(ValueError, match="128-aligned"):
        api.route(evt.SolverConfig(symmetric=True, cache_tiles=4), 8200, fake_h100)
    # both multiround kernels keep ev and nothing else of the O(n) state in
    # shared memory, so the triangle reaches as far as the stripes (57856);
    # past that the declaration is consumed by the matvec kernel loop
    assert device.multiround_sym_fits(54272, 128, fake_h100)
    assert api.route(sym, 54272, fake_h100).kernel == "triangle"
    assert api.resolve_backend(sym, 54272, fake_h100) == "multiround"
    assert not device.multiround_sym_fits(58368, 128, fake_h100)
    assert api.resolve_backend(sym, 58368, fake_h100) == "matvec_pallas"
    assert api.route(sym, 58368, fake_h100).kernel == "matvec"
    # dense auto stays on the stripes kernel
    assert api.route(evt.SolverConfig(), 8192, fake_h100).kernel == "stripes"
    assert api.resolve_backend(sym, 8192, torch.device("cpu")) == "matvec"


def test_validate_promotes_only_where_the_triangle_would_run(fake_h100):
    auto = evt.SolverConfig()
    cand = api._promotion(auto, 8192, fake_h100)
    assert cand is not None and _backend_kernel(cand) == ("multiround", "triangle")
    assert _plan(cand) == _plan(api.route(evt.SolverConfig(symmetric=True), 8192, fake_h100))
    assert api._promotion(auto, 8200, fake_h100) is None  # unalignable
    # float64 routes to the torch.mv loop, declared or not: nothing to promote to
    assert api._promotion(evt.SolverConfig(dtype=torch.float64), 8192, fake_h100) is None
    # a block_rows that gives no tile: the config's own route rejects it first
    with pytest.raises(ValueError, match="block_rows=96"):
        api.route(evt.SolverConfig(block_rows=96), 8192, fake_h100)
    with pytest.raises(ValueError, match="block_rows=96"):
        api._promotion(evt.SolverConfig(block_rows=96), 8192, fake_h100)
    assert api._promotion(evt.SolverConfig(backend="multiround"), 8192, fake_h100) is None
    assert api._promotion(evt.SolverConfig(symmetric=True), 8192, fake_h100) is None
    assert api._promotion(auto, 8192, torch.device("cpu")) is None  # off the card, as JAX


BF16 = torch.bfloat16
#: the (config, n) that the route's readers take on a card: the cells of the
#: benchmark and the headline with its secondaries (at 8192 and 65536), the
#: large rows (``bench.suite.large_rows``) and ``EigenValue.warmup``'s card test
READ_ROUTES = {
    "sym": (evt.SolverConfig(symmetric=True), 8192),
    "dense": (evt.SolverConfig(), 8192),
    "bf16_sym": (evt.SolverConfig(symmetric=True, storage_dtype=BF16), 8192),
    "stream": (evt.SolverConfig(storage_dtype=BF16), 65536),
    "sym_stream": (evt.SolverConfig(symmetric=True, cache_tiles=0), 8192),
    "large_f32": (evt.SolverConfig(), 32768),
    "large_sym_f32": (evt.SolverConfig(backend="multiround", symmetric=True), 32768),
    "large_sym_bf16": (evt.SolverConfig(backend="multiround", symmetric=True,
                                        storage_dtype=BF16), 65536),
    "warmup_sym_bf16": (evt.SolverConfig(symmetric=True, storage_dtype=BF16), 4096),
    "warmup_bf16_unaligned": (evt.SolverConfig(symmetric=True, storage_dtype=BF16), 1000),
}
#: the solver each kernel's route binds
SOLVERS = {"triangle": "solve_multiround", "tiled": "solve_multiround",
           "stripes": "solve_multiround", "matvec": "solve_matvec_kernel", None: "solve_matvec"}


@pytest.mark.parametrize("case", list(READ_ROUTES))
def test_the_route_its_readers_take_is_the_one_the_solve_runs(fake_h100, monkeypatch, case):
    """What ``max_eigenvalue`` runs (its solver spied on, its matrix a
    stand-in of the right shape on the card) is the route's backend,
    kernel, tile, cache and storage; ``EigenValue.warmup`` prepares that
    route's plan."""
    from types import SimpleNamespace

    from eigen_value_tpu_torch.ops import solver_matvec as sm

    cfg, n = READ_ROUTES[case]
    r = api.route(cfg, n, fake_h100)
    ran = {}
    for name in set(SOLVERS.values()):
        monkeypatch.setattr(sm, name, lambda mat, _name=name, **kw: ran.update(kw, solver=_name))
    monkeypatch.setattr(api, "_as_matrix", lambda mat, config, device=None: mat)
    evt.max_eigenvalue(SimpleNamespace(shape=(n, n), device=fake_h100), cfg)
    assert ran["solver"] == SOLVERS[r.kernel]
    assert ran.get("symmetric", False) == (r.kernel == "triangle")
    bt = tk.sym_tile(n, ran["tile"]) if "tile" in ran else None
    assert (bt, ran.get("cache_tiles", 0)) == (r.bt, r.cache_tiles)
    assert (ran["storage_dtype"] or torch.float32) == r.storage
    assert r.backend == api.resolve_backend(cfg, n, fake_h100)
    prepared = []
    monkeypatch.setattr(tk, "prepare", lambda *a, **kw: prepared.append((a, kw)))
    evt.EigenValue(cfg, device=fake_h100).warmup([n])
    kernel = r.kernel if r.fits else None
    assert prepared == [((fake_h100, n, r.storage),
                         dict(kernel=kernel, bt=r.bt, cache_tiles=r.cache_tiles))]


def test_auto_consumes_the_declaration_on_cpu():
    H = tfx.hilbert_matrix(256)
    _same(evt.max_eigenvalue(H, evt.SolverConfig(symmetric=True)), evt.max_eigenvalue(H))


@pytest.mark.parametrize("backend", ["matvec", "matvec_pallas", "xla", "pallas"])
def test_explicit_other_backend_rejects(backend):
    with pytest.raises(ValueError, match="symmetric|not ported"):
        evt.max_eigenvalue(tfx.hilbert_matrix(128), evt.SolverConfig(backend=backend,
                                                                     symmetric=True))


def test_validate_checks_the_promise():
    a = _sym(128)
    a[3, 2] += np.float32(0.5)
    with pytest.raises(ValueError, match="not bitwise symmetric"):
        evt.max_eigenvalue(a, evt.SolverConfig(backend="multiround", symmetric=True),
                           validate=True, device="cpu")
    with pytest.raises(ValueError, match="entries > 0"):
        evt.max_eigenvalue(-_sym(128), evt.SolverConfig(backend="multiround", symmetric=True),
                           validate=True, device="cpu")


def test_validate_on_device_reads_both_checks():
    a = torch.from_numpy(_sym(64))
    assert api._validate_on_device(a, True) == (True, True)
    assert api._validate_on_device(a, False) == (True, False)
    b = a.clone()
    b[0, 1] = 5.0
    assert api._validate_on_device(b, True) == (True, False)
    assert api._validate_on_device(-a, True) == (False, True)
