"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Imports torch and the port only, so it runs on a machine without jax:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(--noconftest skips tests/conftest.py, which sets up jax).  Every test here
needs a CUDA device and skips without one.
"""

import contextlib

import pytest

torch = pytest.importorskip("torch")

import eigen_value_tpu_torch as evt  # noqa: E402
from eigen_value_tpu_torch import fixtures as tfx  # noqa: E402
from eigen_value_tpu_torch.api import resolve_backend  # noqa: E402
from eigen_value_tpu_torch.device import sym_auto_cache_tiles  # noqa: E402
from eigen_value_tpu_torch.ops.cuda import kernels as tk  # noqa: E402
from eigen_value_tpu_torch.ops.solver import solve_xla, stop_check  # noqa: E402
from eigen_value_tpu_torch.ops.solver_kernel import solve_kernel  # noqa: E402
from eigen_value_tpu_torch.ops.solver_matvec import (  # noqa: E402
    solve_fused_round,
    solve_matvec_kernel,
    solve_matvec_kernel_fused,
    solve_multiround,
)
from eigen_value_tpu_torch.utils.profiling import recording  # noqa: E402

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


# --- the triangle kernel (csrc/multiround_sym.cu) ---------------------------


def _below_block_diagonal(n, bt, device):
    blk = torch.arange(n, device=device) // bt
    return blk[:, None] > blk[None, :]


def _same(got, want):
    assert int(got.rounds) == int(want.rounds)
    assert torch.equal(got.eigenvalue, want.eigenvalue)
    assert torch.equal(got.eigenvector, want.eigenvector)


@pytest.mark.parametrize("cache", [0, "auto"])
@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("init", [True, False])
@pytest.mark.parametrize("n", [384, 1024])
def test_multiround_sym_matches_plain(cuda, n, init, sym, cache):
    # the dense mode gets an asymmetric Hilbert: rounding stays far below the stop
    A = tfx.hilbert_matrix(n, device=cuda)
    if not sym:
        A = A * (1 + 0.25 * torch.rand(n, n, generator=torch.Generator().manual_seed(n)).to(cuda))
    cache_tiles = sym_auto_cache_tiles(n, 128, cuda, sym=sym) if cache else 0
    assert not cache or cache_tiles > 0
    ev = torch.ones(n, device=cuda)
    v, lam = ev, torch.zeros((), device=cuda)
    kw = dict(chunk=5, eps=EPS, tile=128, sym=sym)
    if not init:
        ev, v, _, lam = tk.multiround_sym_plain(A, ev, ev, lam, MAX_ITR, init=True, **kw)
    before = tk.multiround_sym.launches
    got = tk.multiround_sym(A, ev, v, lam, MAX_ITR, init=init, cache_tiles=cache_tiles, **kw)
    want = tk.multiround_sym_plain(A, ev, v, lam, MAX_ITR, init=init, **kw)
    assert tk.multiround_sym.launches == before + 1
    assert int(got[2]) == int(want[2])
    for g_, w in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])):
        torch.testing.assert_close(g_, w, rtol=1e-5, atol=0)


def test_multiround_sym_invariances(cuda):
    n = 1024
    H = tfx.hilbert_matrix(n, device=cuda)
    auto = sym_auto_cache_tiles(n, 128, cuda)
    base = solve_multiround(H, EPS, MAX_ITR, symmetric=True, cache_tiles=0)
    assert int(base.rounds) == tfx.HILBERT_ROUNDS[n]
    for cache in (3, auto):
        _same(solve_multiround(H, EPS, MAX_ITR, symmetric=True, cache_tiles=cache), base)
    for chunk in (1, 5, 18):
        _same(solve_multiround(H, EPS, MAX_ITR, chunk=chunk, symmetric=True, cache_tiles=auto),
              base)
    bad = torch.where(_below_block_diagonal(n, 128, cuda), torch.full_like(H, 7.25), H)
    _same(solve_multiround(bad, EPS, MAX_ITR, symmetric=True, cache_tiles=auto), base)
    _same(solve_multiround(H, EPS, MAX_ITR, symmetric=True, cache_tiles=0), base)


def test_multiround_sym_rejects_a_cache_the_card_cannot_hold(cuda):
    n = 8192
    H = tfx.hilbert_matrix(n, device=cuda)
    most = sym_auto_cache_tiles(n, 128, cuda)
    ev = torch.ones(n, device=cuda)
    before = tk.multiround_sym.launches
    with pytest.raises(ValueError, match="does not fit"):
        tk.multiround_sym(H, ev, ev, 0.0, MAX_ITR, chunk=2, eps=EPS, cache_tiles=most + 200)
    assert tk.multiround_sym.launches == before


@pytest.mark.parametrize("n", sorted(tfx.HILBERT_ROUNDS))
def test_symmetric_path_keeps_the_hilbert_table(cuda, n):
    H = tfx.hilbert_matrix(n, device=cuda)
    assert resolve_backend(evt.SolverConfig(symmetric=True), n, cuda) == "multiround"
    plain = evt.max_eigenvalue(H, evt.SolverConfig(backend="matvec"))
    for kw in (dict(config=evt.SolverConfig(symmetric=True)), dict(validate=True)):
        before = tk.multiround_sym.launches
        res = evt.max_eigenvalue(H, **kw)
        assert tk.multiround_sym.launches > before
        assert int(res.rounds) == tfx.HILBERT_ROUNDS[n] and bool(res.converged)
        assert float(res.eigenvalue) == pytest.approx(float(plain.eigenvalue), rel=1e-5)
        assert float(evt.eigen_residual(H, res)) < 1e-3


def test_validate_does_not_promote_an_asymmetric_matrix(cuda):
    A = tfx.hilbert_matrix(512, device=cuda)
    A[0, 1] += 1.0
    before = (tk.multiround.launches, tk.multiround_sym.launches)
    evt.max_eigenvalue(A, validate=True)
    assert (tk.multiround.launches, tk.multiround_sym.launches) == (before[0] + 1, before[1])


def test_dense_tiled_cached_solve(cuda):
    H = tfx.hilbert_matrix(2048, device=cuda)
    cache = sym_auto_cache_tiles(2048, 128, cuda, sym=False)
    cfg = evt.SolverConfig(backend="multiround", cache_tiles=cache)
    before = tk.multiround_sym.launches
    res = evt.max_eigenvalue(H, cfg)
    assert tk.multiround_sym.launches == before + 1
    assert int(res.rounds) == tfx.HILBERT_ROUNDS[2048]
    want = solve_matvec_kernel(H, EPS, MAX_ITR)
    torch.testing.assert_close(res.eigenvector, want.eigenvector, rtol=1e-4, atol=0)


# --- what the persistent kernels keep on the chip (resident rows and tiles) --


@pytest.mark.parametrize("n", [128, 384, 2048, 4096, 8192])
def test_multiround_resident_rows_keep_the_matvec_loops_bits(cuda, n):
    """Rows read from shared memory, from L2 or from device memory give the
    bits of the matvec kernel loop: for every chunking, with a chunk that
    ends before a resident row was read twice (chunk 1), at the caps, and in
    a second solve on the same tensors."""
    H = tfx.hilbert_matrix(n, device=cuda)
    plan = tk.multiround_launch_plan(cuda, n)
    assert plan.resident > 0  # at these sizes every block keeps rows in shared memory
    want = solve_matvec_kernel(H, EPS, MAX_ITR)
    assert int(want.rounds) == tfx.HILBERT_ROUNDS.get(n, int(want.rounds))
    for chunk in (1, 5, 18, None):
        _same(solve_multiround(H, EPS, MAX_ITR, chunk=chunk), want)
    _same(solve_multiround(H, EPS, MAX_ITR), want)  # again, same tensors
    for cap in (0, 1, 5):
        got, ref = solve_multiround(H, EPS, cap, chunk=4), solve_matvec_kernel(H, EPS, cap)
        _same(got, ref)
        assert bool(got.converged) == bool(ref.converged)


@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("n", [128, 384, 2048, 4096, 8192])
def test_multiround_sym_bits_do_not_depend_on_where_a_tile_lives(cuda, n, sym):
    """Cache sizes 0 (1 in dense tiled mode, which a cache selects), the 264
    of the kernel's first version and the card's budget, whole-budget and
    one-round chunks, a repeated launch, and for the triangle whatever the
    lower block triangle holds: one result, bit for bit."""
    H = tfx.hilbert_matrix(n, device=cuda)
    auto = sym_auto_cache_tiles(n, 128, cuda, sym=sym)
    least = 0 if sym else 1
    base = solve_multiround(H, EPS, MAX_ITR, symmetric=sym, cache_tiles=least)
    if n in tfx.HILBERT_ROUNDS:
        assert int(base.rounds) == tfx.HILBERT_ROUNDS[n]
    caches = sorted({c for c in (least, 3, min(264, auto), auto) if least <= c <= auto})
    for cache in caches:
        for chunk in (1, 5, None):
            _same(solve_multiround(H, EPS, MAX_ITR, chunk=chunk, symmetric=sym,
                                   cache_tiles=cache), base)
    _same(solve_multiround(H, EPS, MAX_ITR, symmetric=sym, cache_tiles=auto), base)
    if sym:
        bad = torch.where(_below_block_diagonal(n, 128, cuda), torch.full_like(H, 7.25), H)
        for cache in (0, auto):
            _same(solve_multiround(bad, EPS, MAX_ITR, symmetric=True, cache_tiles=cache), base)
    ev = torch.ones(n, device=cuda)
    kw = dict(chunk=MAX_ITR + 1, eps=EPS, init=True, sym=sym, cache_tiles=auto)
    first = tk.multiround_sym(H, ev, ev, 0.0, MAX_ITR, **kw)
    again = tk.multiround_sym(H, ev, ev, 0.0, MAX_ITR, **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("n", [16384, 29056])
def test_the_persistent_kernels_where_few_or_no_rows_fit_beside_ev(cuda, n):
    """At 16384 two rows and two tiles a block fit beside ev, at 29056 no
    row and one tile: the stripes kernel streams as before the resident
    design, and the identities hold."""
    H = tfx.hilbert_matrix(n, device=cuda)
    plan = tk.multiround_launch_plan(cuda, n)
    assert plan.resident == (2 if n == 16384 else 0) and plan.l2_rows >= 1
    want = solve_matvec_kernel(H, EPS, MAX_ITR)
    for chunk in (1, None):
        _same(solve_multiround(H, EPS, MAX_ITR, chunk=chunk), want)
    auto = sym_auto_cache_tiles(n, 128, cuda)
    assert auto == (264 if n == 16384 else 132)
    base = solve_multiround(H, EPS, MAX_ITR, symmetric=True, cache_tiles=0)
    assert int(base.rounds) == int(want.rounds)
    for chunk in (1, None):
        _same(solve_multiround(H, EPS, MAX_ITR, chunk=chunk, symmetric=True, cache_tiles=auto),
              base)


def test_the_plans_on_this_card_match_what_the_kernels_run(cuda):
    """The pure-Python plans hold on the card itself: the cooperative grid
    is co-resident with the planned resident set, at the sizes the
    redesign changes most."""
    from eigen_value_tpu_torch import device as tdev

    lim = tdev.cuda_limits(cuda)
    for n in (2048, 4096, 8192, 28928, 57856):
        plan = tk.multiround_launch_plan(cuda, n)
        assert plan == tdev.multiround_plan(n, cuda) and plan.grid <= lim.sms
    for n in (2048, 4096, 8192):
        for sym in (True, False):
            auto = sym_auto_cache_tiles(n, 128, cuda, sym=sym)
            sp = tk.multiround_sym_plan(cuda, n, 128, auto, sym)
            assert sp.C == auto and sp.grid * sp.slots >= sp.C
            assert tdev.multiround_sym_fits(n, 128, cuda, sp.slots)
            assert sp.l2_tiles == tdev.sym_l2_tiles(128, cuda, sp.T)
            assert sp.split == tdev.sym_split(n, 128, cuda, sym)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_a_sym_solve_keeps_its_plan_and_hbm_bytes(cuda, dtype):
    """After a declared-symmetric 8192² solve the triangle wrapper keeps its
    launch's plan, whose HBM bytes a round are the pure helper's: on an
    H100, 952 bf16 tiles of 32 KiB (31,195,136 bytes) and 1384 f32 tiles
    of 64 KiB (90,701,824)."""
    from eigen_value_tpu_torch import device as tdev

    n = 8192
    A = tfx.hilbert_matrix(n, device=cuda).to(dtype)
    stored = {} if dtype == torch.float32 else {"storage_dtype": dtype}
    tk.multiround_sym.plan = None
    evt.max_eigenvalue(A, evt.SolverConfig(symmetric=True, **stored))
    plan = tk.multiround_sym.plan
    bt = tk.sym_tile(n, tk.SYM_TILE)
    auto = sym_auto_cache_tiles(n, bt, cuda, itemsize=dtype.itemsize)
    assert plan is not None and plan.C == auto
    assert plan.hbm_bytes == tk.sym_hbm_bytes(cuda, n, bt, auto, True, dtype)
    assert plan.hbm_bytes == (plan.T - plan.l2_tiles) * bt * bt * dtype.itemsize
    if tuple(tdev.cuda_limits(cuda)) == (132, 232448, 52428800):  # an H100 SXM's
        assert plan.hbm_bytes == {torch.bfloat16: 31_195_136, torch.float32: 90_701_824}[dtype]


def test_phase_stamps_cover_every_round(cuda):
    """With ``kernels.STAMPS`` set both persistent kernels write increasing
    timer values for every phase of every round, and results stay the same."""
    n = 2048
    H = tfx.hilbert_matrix(n, device=cuda)
    ev = torch.ones(n, device=cuda)
    kw = dict(chunk=MAX_ITR + 1, eps=EPS, init=True)
    for name, fn, grid in (
        ("multiround", lambda: tk.multiround(H, ev, ev, 0.0, MAX_ITR, **kw),
         tk.multiround_grid(cuda, n)),
        ("multiround_sym", lambda: tk.multiround_sym(H, ev, ev, 0.0, MAX_ITR, **kw),
         tk.multiround_sym_plan(cuda, n, 128, 0, True).grid),
    ):
        plain = fn()
        phases = len(tk.PHASES[name]) + 1
        # 32 rounds x 6 phases, then the triangle kernel's two fill stamps, a block
        tk.STAMPS = torch.zeros((32 * 6 + 2) * grid, dtype=torch.int64, device=cuda)
        try:
            stamped = fn()
            t = tk.STAMPS.cpu()[:32 * 6 * grid].reshape(32, 6, grid)
        finally:
            tk.STAMPS = None
        assert all(torch.equal(a, b) for a, b in zip(plain, stamped))
        rounds = int(plain[2])  # round 0 is the init pass; rounds 1..advanced run whole
        assert rounds == tfx.HILBERT_ROUNDS[n]
        assert bool((t[1:rounds + 1, :phases] > 0).all())
        assert bool((t[1:rounds + 1, 1:phases] >= t[1:rounds + 1, :phases - 1]).all())


# --- the iterated form's kernels (csrc/rowsum.cu, csrc/scale.cu) ------------


def _positive(n, cuda):
    g = torch.Generator().manual_seed(n)
    A = tfx.random_positive_matrix(n, g, device=cuda)
    v = (torch.rand(n, generator=g) + 0.5).to(cuda)
    return A, v


@pytest.mark.parametrize("n", [3, 1000, 1001, 4096])
def test_rowsum_is_matvec_with_ones_bitwise(cuda, n):
    A, _ = _positive(n, cuda)
    before = tk.rowsum.launches
    got = tk.rowsum(A)
    assert tk.rowsum.launches == before + 1
    assert torch.equal(got, tk.matvec(A, torch.ones(n, device=cuda)))
    want = A.double().sum(1)
    assert float(((got.double() - want).abs() / want).max()) < 2e-5
    assert torch.equal(got, tk.rowsum(A))


@pytest.mark.parametrize("n", [3, 1001, 4096])
def test_rowsum_bias_matches_f64_and_reads_its_bias_on_the_card(cuda, n):
    A, _ = _positive(n, cuda)
    bias = torch.tensor(0.375, device=cuda)
    before = tk.rowsum_bias.launches
    got = tk.rowsum_bias(A, bias)
    assert tk.rowsum_bias.launches == before + 1
    want = (A.double() + 0.375).sum(1)
    assert float(((got.double() - want).abs() / want).max()) < 2e-5
    assert torch.equal(tk.rowsum_bias(A, torch.zeros((), device=cuda)), tk.rowsum(A))
    with pytest.raises(ValueError):
        tk.rowsum_bias(A, torch.tensor(0.375))  # a host scalar is not read


@pytest.mark.parametrize("n", [3, 1000, 1001, 4096])
def test_scale_and_scale_rowsum_identities(cuda, n):
    A, v = _positive(n, cuda)
    keep = A.clone()
    want = tk.scale_plain(A, v)
    before = (tk.scale.launches, tk.scale_rowsum.launches)
    got = tk.scale(A, v)
    A2, v2 = tk.scale_rowsum(A, v)
    assert (tk.scale.launches, tk.scale_rowsum.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(A, keep)  # out of place leaves the input alone
    assert torch.equal(got, want)
    assert torch.equal(A2, got) and torch.equal(v2, tk.rowsum(got))
    B = A.clone()
    assert tk.scale(B, v, out=B) is B and torch.equal(B, want)
    C = A.clone()
    C2, w2 = tk.scale_rowsum(C, v, out=C)
    assert C2 is C and torch.equal(C, want) and torch.equal(w2, v2)
    with pytest.raises(ValueError, match="overlap"):
        tk.scale_rowsum(A, A[0], out=A)


@pytest.mark.parametrize("n", [3, 96, 1024, 2048])
def test_iterated_kernel_solve(cuda, n):
    A = (
        torch.tensor(tfx.ANCHOR_3X3, dtype=torch.float32, device=cuda)
        if n == 3
        else tfx.hilbert_matrix(n, device=cuda)
    )
    keep = A.clone()
    before = (tk.rowsum.launches, tk.scale_rowsum.launches, tk.matvec.launches,
              tk.multiround.launches)
    res = evt.max_eigenvalue(A, evt.SolverConfig(backend="pallas"))
    rounds = int(res.rounds)
    assert (tk.rowsum.launches, tk.scale_rowsum.launches, tk.matvec.launches,
            tk.multiround.launches) == (before[0] + 1, before[1] + rounds, before[2], before[3])
    assert torch.equal(A, keep)
    assert bool(res.converged) and float(evt.eigen_residual(A, res)) < 1e-3
    if n in tfx.HILBERT_ROUNDS:
        assert rounds == tfx.HILBERT_ROUNDS[n]
    plain = evt.max_eigenvalue(A, evt.SolverConfig(backend="xla"))
    assert rounds == int(plain.rounds)
    assert float(res.eigenvalue) == pytest.approx(float(plain.eigenvalue), rel=1e-5)
    torch.testing.assert_close(res.eigenvector, plain.eigenvector, rtol=0, atol=1e-5)
    same = solve_kernel(A, EPS, MAX_ITR)
    assert torch.equal(same.eigenvector, res.eigenvector)
    assert int(solve_xla(A, EPS, MAX_ITR).rounds) == rounds


def test_host_input_goes_to_the_card(cuda):
    res = evt.max_eigenvalue(tfx.ANCHOR_3X3)
    assert res.eigenvector.is_cuda
    assert float(res.eigenvalue) == pytest.approx(tfx.ANCHOR_3X3_EIGENVALUE, abs=1e-4)
    assert not evt.max_eigenvalue(tfx.ANCHOR_3X3, device="cpu").eigenvector.is_cuda


# --- the stop kernel and the one-launch rounds (csrc/stop.cu, csrc/round.cu) --


def _stop_both(v, eps):
    """The kernel's verdict, held equal to the plain version's."""
    before = tk.stop.launches
    got = tk.stop(v, eps)
    assert tk.stop.launches == before + 1
    assert got.is_cuda and got.dtype == torch.bool and got.shape == ()
    assert bool(got) == bool(tk.stop_plain(v, eps))
    return bool(got)


@pytest.mark.parametrize("n", [1, 3, 1000, 1001, 4096, 1 << 16, (1 << 20) + 4])
def test_stop_matches_plain(cuda, n):
    eps = torch.tensor(EPS, device=cuda)
    ok = tfx.stop_success_vector(n, device=cuda)
    assert _stop_both(ok, eps)
    fail = _stop_both(tfx.stop_fail_vector(n, device=cuda), eps)
    assert not fail or n < 1000  # a short ramp's wraparound pair is within eps
    # one break: first, last, at a block's edge (256 threads of 4 or 1 values), mid-block
    for idx in sorted({0, n - 1, min(1023, n - 1), min(1024, n - 1), min(256, n - 1), n // 2}):
        bad = ok.clone()
        bad[idx] += 1.0
        assert _stop_both(bad, eps) == (n == 1)  # n = 1 pairs v[0] with itself
        bad[idx] = float("nan")
        assert not _stop_both(bad, eps)
    assert _stop_both(ok, EPS)  # a number is wrapped on the way in


@pytest.mark.parametrize("i", range(10))
def test_stop_fuzz(cuda, i):
    g = torch.Generator().manual_seed(100 + i)
    v = (torch.rand(2048 + i, generator=g) * (0.2 if i % 2 else 1.0)).to(cuda)
    assert _stop_both(v, torch.tensor(0.5, device=cuda)) == bool(i % 2)


def test_stop_is_strict_and_reads_eps_on_the_card(cuda):
    v = torch.tensor([1.0, 1.5, 1.25, 1.0], device=cuda)
    assert not _stop_both(v, torch.tensor(0.5, device=cuda))
    assert _stop_both(v, torch.tensor(0.5000001, device=cuda))
    before = tk.stop.launches
    with pytest.raises(ValueError, match="must be on"):
        tk.stop(v, torch.tensor(0.5))  # a host tensor is not read
    with pytest.raises(ValueError, match="float32"):
        tk.stop(v.double(), 0.5)
    with pytest.raises(ValueError, match="float32"):
        tk.stop(v, torch.tensor(0.5, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        tk.stop(torch.ones(8, device=cuda)[::2], 0.5)
    assert tk.stop.launches == before


def test_stop_on_a_second_stream(cuda):
    v = tfx.stop_success_vector(1 << 16, device=cuda)
    eps = torch.tensor(EPS, device=cuda)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        a = [tk.stop(v, eps) for _ in range(50)]
    b = [tk.stop(v, eps) for _ in range(50)]
    torch.cuda.synchronize()
    assert all(bool(x) for x in a + b)


def _round_case(n, cuda):
    A, v = _positive(n, cuda)
    ev = (torch.rand(n, generator=torch.Generator().manual_seed(7 * n)) + 0.5).to(cuda)
    return A, ev, v


@pytest.mark.parametrize("n", [3, 1000, 1001, 4096])
def test_round_kernels_identities(cuda, n):
    A, ev, v = _round_case(n, cuda)
    keep = (A.clone(), ev.clone(), v.clone())
    m = torch.max(v)
    before = (tk.round_matvec.launches, tk.round_fused.launches)
    v_next, ev_new = tk.round_matvec(A, ev, v, m)
    fused = tk.round_fused(A, ev, v, eps=EPS)
    assert (tk.round_matvec.launches, tk.round_fused.launches) == (before[0] + 1, before[1] + 1)
    assert all(torch.equal(a, b) for a, b in zip((A, ev, v), keep))  # no input is written
    # bit for bit: two rounded operations, then the matvec kernel's row order
    assert torch.equal(ev_new, ev * (v / m))
    assert torch.equal(v_next, tk.matvec(A, ev_new) / ev_new)
    assert torch.equal(fused[0], v_next) and torch.equal(fused[1], ev_new)
    assert fused[2].dtype == torch.bool and not bool(fused[2])
    assert bool(fused[2]) == bool(stop_check(v, EPS)) and torch.equal(fused[3], v[0])
    # against the plain versions: cuBLAS sums in another order
    want_v, want_ev = tk.round_matvec_plain(A, ev, v, m)
    assert torch.equal(ev_new, want_ev)
    torch.testing.assert_close(v_next, want_v, rtol=2e-5, atol=0)
    want = tk.round_fused_plain(A, ev, v, eps=EPS)
    torch.testing.assert_close(fused[0], want[0], rtol=2e-5, atol=0)
    assert bool(fused[2]) == bool(want[2]) and torch.equal(fused[3], want[3])
    # ev and v may be one tensor: the inputs are only read
    twice = tk.round_matvec(A, v, v, m)
    assert torch.equal(twice[1], v * (v / m))


def test_round_fused_reports_done_and_a_nan(cuda):
    n = 1024
    A = tfx.hilbert_matrix(n, device=cuda)
    ev = torch.ones(n, device=cuda)
    ok = tfx.stop_success_vector(n, device=cuda)
    v_next, ev_new, done, lam = tk.round_fused(A, ev, ok, eps=EPS)
    assert bool(done) and torch.equal(lam, ok[0])
    ref = tk.round_matvec(A, ev, ok, torch.max(ok))  # computed even when done
    assert torch.equal(v_next, ref[0]) and torch.equal(ev_new, ref[1])
    bad = ok.clone()
    bad[n // 2] = float("nan")
    out = tk.round_fused(A, ev, bad, eps=EPS)
    assert not bool(out[2]) and bool(torch.isnan(out[1]).all())  # max(v) is NaN, as torch.max


def test_round_kernels_reject(cuda):
    A, ev, v = _round_case(64, cuda)
    before = (tk.round_matvec.launches, tk.round_fused.launches)
    with pytest.raises(ValueError, match="float32"):
        tk.round_matvec(A.double(), ev, v, 1.0)
    with pytest.raises(ValueError, match="float32"):
        tk.round_fused(A, ev.double(), v, eps=EPS)
    with pytest.raises(ValueError, match="contiguous"):
        tk.round_matvec(A.t(), ev, v, 1.0)
    with pytest.raises(ValueError, match="must be on"):
        tk.round_matvec(A, ev, v, torch.tensor(1.0))  # a host m is not read
    with pytest.raises(ValueError, match="different devices"):
        tk.round_fused(A, ev.cpu(), v, eps=EPS)
    big = torch.empty(65536, 65536, device=cuda)  # ev' no longer fits a block's shared memory
    x = torch.ones(65536, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        tk.round_fused(big, x, x, eps=EPS)
    with pytest.raises(ValueError, match="shared memory"):
        tk.round_matvec(big, x, x, 1.0)
    assert (tk.round_matvec.launches, tk.round_fused.launches) == before


@pytest.mark.parametrize("n", [3, 96, 128, 1024, 2048])
def test_fused_solves_bitidentical_with_their_launch_counts(cuda, n):
    A = (
        torch.tensor(tfx.ANCHOR_3X3, dtype=torch.float32, device=cuda)
        if n == 3
        else tfx.hilbert_matrix(n, device=cuda)
    )
    want = solve_matvec_kernel(A, EPS, MAX_ITR)
    rounds = int(want.rounds)
    if n in tfx.HILBERT_ROUNDS:
        assert rounds == tfx.HILBERT_ROUNDS[n]

    def counts():
        return (tk.matvec.launches, tk.round_matvec.launches, tk.round_fused.launches)

    before = counts()
    got = solve_matvec_kernel_fused(A, EPS, MAX_ITR)
    assert counts() == (before[0] + 1, before[1] + rounds, before[2])
    _same(got, want)
    assert bool(got.converged)
    before = counts()
    got = solve_fused_round(A, EPS, MAX_ITR)
    # the converging round's launch is the one pass more
    assert counts() == (before[0] + 1, before[1], before[2] + rounds + 1)
    _same(got, want)
    assert bool(got.converged) and got.rounds.dtype == torch.int32


@pytest.mark.parametrize("cap", [0, 1, 5])
def test_fused_solves_at_the_cap(cuda, cap):
    H = tfx.hilbert_matrix(256, device=cuda)
    want = solve_matvec_kernel(H, EPS, cap)
    for solve in (solve_matvec_kernel_fused, solve_fused_round):
        got = solve(H, EPS, cap)
        _same(got, want)
        assert int(got.rounds) == cap and not bool(got.converged)


# --- reduced-precision storage: A in bf16 / f16, ev and every sum f32 ---------

STORE = [torch.bfloat16, torch.float16]


def _random_pos(n, cuda, seed):
    g = torch.Generator().manual_seed(seed)
    return tfx.random_positive_matrix(n, g, device=cuda)


@pytest.mark.parametrize("dt", STORE)
@pytest.mark.parametrize("n", [3, 1000, 1001, 2048, 4096])
def test_2_byte_kernels_are_their_f32_kernels_bitwise(cuda, n, dt):
    A_q = tfx.hilbert_matrix(n, device=cuda).to(dt)
    A_f = A_q.float()
    x = torch.ones(n, device=cuda)
    r = _random_pos(n, cuda, n).to(dt)
    xr = torch.rand(n, generator=torch.Generator().manual_seed(1), device="cpu").to(cuda) + 0.5
    before = tk.matvec.launches
    assert torch.equal(tk.matvec(r, xr), tk.matvec(r.float(), xr))
    assert tk.matvec.launches == before + 2  # a 2-byte A launches its kernel
    z = torch.zeros((), device=cuda)
    kw = dict(chunk=MAX_ITR + 1, eps=EPS, init=True)
    got = tk.multiround(A_q, x, x, z, MAX_ITR, **kw)
    want = tk.multiround(A_f, x, x, z, MAX_ITR, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    if n % 128:
        return
    for sym in (True, False):
        ref = tk.multiround_sym(A_f, x, x, z, MAX_ITR, cache_tiles=0, sym=sym, **kw)
        for c in sorted({0, 3, sym_auto_cache_tiles(n, 128, cuda, sym, itemsize=2)}):
            got = tk.multiround_sym(A_q, x, x, z, MAX_ITR, cache_tiles=c, sym=sym, **kw)
            assert all(torch.equal(a, b) for a, b in zip(got, ref)), (sym, c)


@pytest.mark.parametrize("dt", STORE)
def test_2_byte_kernels_match_their_plain_versions(cuda, dt):
    A_q = tfx.hilbert_matrix(2048, device=cuda).to(dt)
    x = torch.rand(2048, generator=torch.Generator().manual_seed(2)).to(cuda) + 0.5
    got = tk.matvec(A_q, x)
    want = A_q.double() @ x.double()
    assert float(((got.double() - want).abs() / want).max()) < 2e-5
    ev, z = torch.ones(2048, device=cuda), torch.zeros((), device=cuda)
    for fn, plain, kw in ((tk.multiround, tk.multiround_plain, {}),
                          (tk.multiround_sym, tk.multiround_sym_plain, dict(tile=128))):
        k = fn(A_q, ev, ev, z, MAX_ITR, chunk=5, eps=EPS, init=True, **kw)
        p = plain(A_q, ev, ev, z, MAX_ITR, chunk=5, eps=EPS, init=True, **kw)
        assert int(k[2]) == int(p[2])
        for a, b in zip((k[0], k[1], k[3]), (p[0], p[1], p[3])):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=0)


def _residual_f64(A, res, cols=8192):
    v = res.eigenvector.double()
    y = sum(A[:, j:j + cols].double() @ v[j:j + cols] for j in range(0, A.shape[1], cols))
    return float((y - res.eigenvalue.double() * v).abs().max())


@pytest.mark.parametrize("dt", STORE)
def test_storage_solves_at_8192(cuda, dt):
    H = tfx.hilbert_matrix(8192, device=cuda)
    A_q = H.to(dt)
    f32 = evt.max_eigenvalue(H)
    for cfg, kernel, ref in (
        (evt.SolverConfig(storage_dtype=dt), tk.multiround,
         solve_multiround(A_q.float(), EPS, MAX_ITR)),
        (evt.SolverConfig(storage_dtype=dt, symmetric=True), tk.multiround_sym,
         solve_multiround(A_q.float(), EPS, MAX_ITR, symmetric=True, cache_tiles=0)),
    ):
        before = kernel.launches
        got = evt.max_eigenvalue(H, cfg)
        assert kernel.launches == before + 1
        assert abs(int(got.rounds) - tfx.HILBERT_ROUNDS[8192]) <= 1 and bool(got.converged)
        _same(got, ref)  # the f32 solve of the quantized matrix, bit for bit
        assert float(got.eigenvalue) == pytest.approx(float(f32.eigenvalue), rel=1e-3)
        assert _residual_f64(A_q, got) < 1e-3
    # a matrix already in the storage dtype is solved as it is; validate promotes it
    before = tk.multiround_sym.launches
    got = evt.max_eigenvalue(A_q, evt.SolverConfig(storage_dtype=dt), validate=True)
    assert tk.multiround_sym.launches == before + 1
    _same(got, ref)


def test_65536_bf16_solve_and_its_peak_memory(cuda):
    n = 65536
    A_q = torch.empty(n, n, dtype=torch.bfloat16, device=cuda)
    i = torch.arange(n, dtype=torch.int32, device=cuda)
    one = torch.tensor(1.0, dtype=torch.bfloat16, device=cuda)
    for r in range(0, n, 4096):  # fixtures.hilbert_matrix(n, bf16), a block at a time
        A_q[r:r + 4096] = one / (i[r:r + 4096, None] + i[None, :] + 1).to(torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    before = tk.matvec.launches
    got = evt.max_eigenvalue(A_q, evt.SolverConfig(storage_dtype=torch.bfloat16))
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(cuda) - base < 64 * 2**20  # no copy of A
    assert tk.matvec.launches - before == int(got.rounds) + 1
    # the JAX package's pins for this solve (its bench, large suite): 21 rounds,
    # λ 2.70946, properties of the matrix that any right solve meets
    assert abs(int(got.rounds) - 21) <= 1 and bool(got.converged)
    assert float(got.eigenvalue) == pytest.approx(2.70946, rel=2e-3)
    assert _residual_f64(A_q, got) < 1e-3
    # the loop's device work is the matvec and the glue kernels and the
    # start vector's and eps's fills: no PyTorch reduction, compare or abs
    names = _kernel_names(lambda: evt.max_eigenvalue(
        A_q, evt.SolverConfig(storage_dtype=torch.bfloat16)))
    rounds = int(got.rounds)
    assert sum("matvec_kernel" in k for k in names) == rounds + 1
    assert sum("round_glue_check" in k for k in names) == rounds + 1
    assert sum("round_glue_update" in k for k in names) == rounds + 1
    others = [k for k in names if "matvec_kernel" not in k and "round_glue" not in k]
    assert len(others) == 2 and all("Fill" in k for k in others), others


def _kernel_names(fn):
    """The names of the kernels that ``fn()`` ran on the card, in order."""
    import json
    import os
    import tempfile

    from eigen_value_tpu_torch.utils import profiling

    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp) as d:
            fn()
            torch.cuda.synchronize()
        events = json.load(open(os.path.join(d, profiling.TRACE_FILE)))["traceEvents"]
    kernels = sorted((e["ts"], e["name"]) for e in events if e.get("cat") == "kernel")
    return [name for _, name in kernels]


# --- the matvec loop's round glue (csrc/round_glue.cu): the stop, the max,
# the ev update and λ on the card before each read ------------------------


def _host_loop(A, max_itr, eps_mode="absolute"):
    """``solve_matvec_kernel`` as it was before the glue kernel: the shared
    host loop (``_run_rounds``) over ``kernels.matvec``, then ``_finish``."""
    from eigen_value_tpu_torch.ops.solver import _finish
    from eigen_value_tpu_torch.ops.solver_matvec import _init_carry, _run_rounds

    def next_v(ev):
        return tk.matvec(A, ev) / ev

    c = _init_carry(A.shape[0], next_v, torch.float32, A.device)
    return _finish(_run_rounds(next_v, c, EPS, max_itr, eps_mode)[0], max_itr)


def _bits(t):
    """A float tensor's bits, its NaNs as one pattern (a NaN's payload is
    the operation's, not the algorithm's)."""
    return t.reshape(-1).masked_fill(t.reshape(-1).isnan(), float("nan")).view(torch.int32)


def _same_bits(got, want):
    assert got.rounds.dtype == torch.int32 and got.converged.dtype == torch.bool
    assert int(got.rounds) == int(want.rounds)
    assert bool(got.converged) == bool(want.converged)
    assert torch.equal(_bits(got.eigenvalue), _bits(want.eigenvalue))
    assert torch.equal(_bits(got.eigenvector), _bits(want.eigenvector))


def _glue_matrix(kind, n, dt, cuda):
    if kind == "hilbert_scaled":  # the kind of matrix the benchmark's cells solve
        return tfx.scaled_hilbert_matrix(n, torch.Generator().manual_seed(n), dtype=dt,
                                         device=cuda)
    return tfx.random_positive_matrix(n, torch.Generator().manual_seed(n), device=cuda).to(dt)


def _counts():
    torch.cuda.synchronize()
    return tk.matvec.launches, tk.round_glue.launches


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [3, 1000, 1027])
def test_a_bound_matvec_is_matvec(cuda, n, dt):
    A = _random_pos(n, cuda, n).to(dt)
    x = torch.rand(n, generator=torch.Generator().manual_seed(3)).to(cuda) + 0.5
    y = torch.empty(n, device=cuda)
    launch = tk.matvec_bound(A, x, y)
    before = tk.matvec.launches
    for _ in range(3):
        assert launch() is y
    torch.cuda.synchronize()
    assert tk.matvec.launches == before + 3
    assert torch.equal(y, tk.matvec(A, x))
    x.mul_(2)  # the bound launch reads the buffers as they are at each call
    launch()
    assert torch.equal(y, tk.matvec(A, x))


@pytest.mark.parametrize("kind", ["hilbert_scaled", "random"])
@pytest.mark.parametrize("n", [384, 1000, 1027, 8192])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16, torch.float16])
def test_the_glue_loop_is_the_host_loop_bit_for_bit(cuda, dt, n, kind):
    """rounds, converged, λ and ev equal ``_finish(_run_rounds(...))`` over
    ``kernels.matvec`` bit for bit; a round is one matvec and two glue
    launches, and no matvec follows the cap's last round."""
    A = _glue_matrix(kind, n, dt, cuda)
    before = _counts()
    got = solve_matvec_kernel(A, EPS, MAX_ITR)
    after = _counts()
    rounds = int(got.rounds)
    glued = rounds + 1 if bool(got.converged) else MAX_ITR
    assert (after[0] - before[0], after[1] - before[1]) == (glued, 2 * glued)
    _same_bits(got, _host_loop(A, MAX_ITR))


@pytest.mark.parametrize("eps_mode", ["absolute", "relative"])
@pytest.mark.parametrize("cap", [0, 1, 3, MAX_ITR])
def test_the_glue_loop_at_the_cap_and_in_relative_mode(cuda, cap, eps_mode):
    for dt in (torch.float32, torch.bfloat16):
        A = _glue_matrix("hilbert_scaled", 1024, dt, cuda)
        before = _counts()
        got = solve_matvec_kernel(A, EPS, cap, eps_mode=eps_mode)
        after = _counts()
        want = _host_loop(A, cap, eps_mode)
        _same_bits(got, want)
        assert bool(got.converged) == (cap == MAX_ITR)
        glued = int(got.rounds) + 1 if bool(got.converged) else cap
        assert (after[0] - before[0], after[1] - before[1]) == (glued, 2 * glued)
    got = solve_matvec_kernel(A, EPS, 0)
    assert torch.equal(got.eigenvector, torch.ones(1024, device=cuda))
    assert float(got.eigenvalue) == 0.0 and int(got.rounds) == 0 and not bool(got.converged)


@pytest.mark.parametrize("where", [(17, 5), (0, 3)])
def test_a_nan_in_a_gives_the_host_loops_nans(cuda, where):
    for dt in (torch.float32, torch.bfloat16):
        A = tfx.hilbert_matrix(1000, device=cuda).to(dt)
        A[where] = float("nan")
        got = solve_matvec_kernel(A, EPS, 12)
        _same_bits(got, _host_loop(A, 12))
        assert not bool(got.converged) and int(got.rounds) == 12
        assert bool(got.eigenvector.isnan().all())


@pytest.mark.parametrize("eps_mode", ["absolute", "relative"])
@pytest.mark.parametrize("n", [1, 3, 4, 1000, 1027, 65536])
def test_round_glue_matches_its_plain_version(cuda, n, eps_mode):
    g = torch.Generator().manual_seed(n)
    ev = (torch.rand(n, generator=g) + 0.5).to(cuda)
    cases = {
        "fails": (torch.rand(n, generator=g) + 0.5).to(cuda),
        "passes": ev * (1 + 1e-5 * torch.rand(n, generator=g).to(cuda)),
        "nan": (torch.rand(n, generator=g) + 0.5).to(cuda).index_fill_(0, torch.tensor(
            [n // 2], device=cuda), float("nan")),
    }
    for name, y in cases.items():
        for i in (0, 7):
            outs = []
            for fn in (tk.round_glue, tk.round_glue_plain):
                e = ev.clone()
                lam = torch.empty((), device=cuda)
                rounds = torch.empty((), dtype=torch.int32, device=cuda)
                conv = torch.empty((), dtype=torch.bool, device=cuda)
                launches = tk.round_glue.launches
                fn(y, e, torch.tensor(EPS, device=cuda), i, lam, rounds, conv, eps_mode=eps_mode)
                torch.cuda.synchronize()
                assert tk.round_glue.launches - launches == (2 if fn is tk.round_glue else 0)
                outs.append((e, lam, int(rounds), bool(conv)))
            (e, lam, r, c), (e0, lam0, r0, c0) = outs
            assert (r, c) == (r0, c0), (name, i)
            assert r == (i if c else i + 1)
            assert c == (name == "passes" or (n == 1 and name != "nan")), (name, i)
            assert torch.equal(_bits(e), _bits(e0)) and torch.equal(_bits(lam), _bits(lam0))


def test_a_misaligned_view_is_solved(cuda):
    n = 1024
    H = tfx.hilbert_matrix(n, device=cuda)
    buf = torch.empty(n * n + 1, device=cuda)
    view = buf[1:].view(n, n)
    view.copy_(H)
    assert view.is_contiguous() and view.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        tk.matvec(view, torch.ones(n, device=cuda))  # the wrappers keep their rule
    _same(evt.max_eigenvalue(view), evt.max_eigenvalue(H))
    _same(evt.max_eigenvalue(view, evt.SolverConfig(symmetric=True)),
          evt.max_eigenvalue(H, evt.SolverConfig(symmetric=True)))


# --- the bulk-copy rings of the persistent kernels (device.STRIPES_RING /
# SYM_RING): the streamed part of A lands in shared memory by cp.async.bulk
# copies; the depth changes where the bytes come from, never the bits ------


@contextlib.contextmanager
def _ring_depth(depth):
    """Both kernels' ring at ``depth`` stages a warp for every element size
    (``"planned"``: the package's own depths) while the block runs."""
    from eigen_value_tpu_torch import device as tdev

    saved = dict(tdev.STRIPES_RING), dict(tdev.SYM_RING)
    try:
        if depth != "planned":
            for table in (tdev.STRIPES_RING, tdev.SYM_RING):
                table.update({size: depth for size in table})
        tk.multiround_launch_plan.cache_clear()
        tk.multiround_sym_plan.cache_clear()
        yield
    finally:
        tdev.STRIPES_RING.update(saved[0])
        tdev.SYM_RING.update(saved[1])
        tk.multiround_launch_plan.cache_clear()
        tk.multiround_sym_plan.cache_clear()


def _equal(a, b):
    return all(torch.equal(p, q) for p, q in zip(a, b))


@pytest.mark.parametrize("dt", STORE)
@pytest.mark.parametrize("n", [2048, 4096, 8192])
def test_2_byte_launches_are_f32_launches_at_every_ring_depth(cuda, n, dt):
    """A 2-byte launch on A_q gives the bits of the f32 launch on
    A_q.float() without a ring, at ring depths 0, 1 and the planned one, for
    the stripes kernel and for the tiled kernel with caches 0, 3 and the
    depth's auto cache in both modes; an f32 launch at each depth too."""
    A_q = tfx.hilbert_matrix(n, device=cuda).to(dt)
    A_f = A_q.float()
    x, z = torch.ones(n, device=cuda), torch.zeros((), device=cuda)
    kw = dict(chunk=MAX_ITR + 1, eps=EPS, init=True)
    with _ring_depth(0):
        ref = tk.multiround(A_f, x, x, z, MAX_ITR, **kw)
        ref_sym = {sym: tk.multiround_sym(A_f, x, x, z, MAX_ITR, cache_tiles=0, sym=sym, **kw)
                   for sym in (True, False)}
    rings = set()
    for depth in (0, 1, "planned"):
        with _ring_depth(depth):
            rings.add(tk.multiround_launch_plan(cuda, n, dtype=dt).ring)
            assert _equal(tk.multiround(A_q, x, x, z, MAX_ITR, **kw), ref), depth
            assert _equal(tk.multiround(A_f, x, x, z, MAX_ITR, **kw), ref), depth
            for sym in (True, False):
                auto = sym_auto_cache_tiles(n, 128, cuda, sym, itemsize=2)
                for c in sorted({0, 3, auto}):
                    got = tk.multiround_sym(A_q, x, x, z, MAX_ITR, cache_tiles=c, sym=sym, **kw)
                    assert _equal(got, ref_sym[sym]), (depth, sym, c)
                    rings.add(tk.multiround_sym_plan(cuda, n, 128, c, sym, dtype=dt).ring)
                got = tk.multiround_sym(A_f, x, x, z, MAX_ITR, cache_tiles=3, sym=sym, **kw)
                assert _equal(got, ref_sym[sym]), (depth, sym, "f32")
    assert rings >= {0, 1}  # the launches above did run with and without a ring


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1024, 2048, 8192])
def test_the_stripes_ring_keeps_the_matvec_loops_bits(cuda, n, dt, monkeypatch):
    """At every ring depth, with the planned resident rows and with none,
    the stripes kernel's solve is the matvec kernel loop, bit for bit, for
    every chunking."""
    storage = None if dt == torch.float32 else dt
    A = tfx.hilbert_matrix(n, device=cuda).to(dt)
    want = solve_matvec_kernel(A, EPS, MAX_ITR, storage_dtype=storage)
    planned = tk.multiround_launch_plan
    for depth in (0, 1, 2, 4):
        with _ring_depth(depth):
            own = planned(cuda, n, **({} if storage is None else {"dtype": dt}))
            for plan in {own, own._replace(resident=0, l2_rows=0)}:
                monkeypatch.setattr(tk, "multiround_launch_plan", lambda d, m, plan=plan, **_: plan)
                for chunk in (1, 5, None):
                    _same(solve_multiround(A, EPS, MAX_ITR, chunk=chunk, storage_dtype=storage),
                          want)
                monkeypatch.setattr(tk, "multiround_launch_plan", planned)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("depth", [1, "planned"])
def test_a_launch_that_freezes_early_leaves_no_copy_behind(cuda, depth, dt):
    """A launch that freezes at round 0 (a constant v stops at once) and
    one that freezes at round 5 (the budget) leave their rounds with copies
    issued ahead; each is followed by a whole launch, and every result is
    the bits of the launches without a ring."""
    n = 4096
    A = tfx.hilbert_matrix(n, device=cuda).to(dt)
    ev, z = torch.ones(n, device=cuda), torch.zeros((), device=cuda)
    v = tk.matvec(A, ev)
    whole = dict(chunk=MAX_ITR + 1, eps=EPS, init=True)
    calls = [
        lambda f, **k: f(A, ev, ev, z, MAX_ITR, chunk=18, eps=EPS, **k),  # round 0
        lambda f, **k: f(A, ev, v, z, 5, chunk=18, eps=EPS, **k),  # round 5
        lambda f, **k: f(A, ev, ev, z, MAX_ITR, **whole, **k),
    ]
    kernels = ((tk.multiround, {}), (tk.multiround_sym, dict(cache_tiles=3)))
    with _ring_depth(0):
        want = [[call(f, **k) for call in calls] for f, k in kernels]
    with _ring_depth(depth):
        assert tk.multiround_sym_plan(cuda, n, 128, 3, True, **(
            {} if dt == torch.float32 else {"dtype": dt})).ring > 0 or depth == "planned"
        for (f, k), ref in zip(kernels, want):
            got = [call(f, **k) for call in calls]
            torch.cuda.synchronize()
            assert int(got[0][2]) == 0 and int(got[1][2]) == 5
            for g, w in zip(got, ref):
                assert _equal(g, w)


def test_a_ring_needs_a_16_byte_aligned_a(cuda):
    """A 2-byte view 8 bytes off a 16-byte boundary meets the chunked
    kernels' rule (4 elements) but not a bulk copy's: a launch with a ring
    raises, and the API, which clones such a view, solves it."""
    n = 1024
    H = tfx.hilbert_matrix(n, device=cuda).to(torch.bfloat16)
    buf = torch.empty(n * n + 4, dtype=torch.bfloat16, device=cuda)
    view = buf[4:].view(n, n)
    view.copy_(H)
    assert view.data_ptr() % 16 == 8
    x = torch.ones(n, device=cuda)
    tk.matvec(view, x)  # the 4-element rule holds
    with _ring_depth(1):
        with pytest.raises(ValueError, match="16-byte aligned"):
            tk.multiround_sym(view, x, x, 0.0, MAX_ITR, chunk=2, eps=EPS)
        cfg = evt.SolverConfig(storage_dtype=torch.bfloat16, symmetric=True)
        _same(evt.max_eigenvalue(view, cfg), evt.max_eigenvalue(H, cfg))


def test_warmup_builds_the_plans_before_the_first_call(cuda):
    tk.multiround_launch_plan.cache_clear()
    tk.multiround_sym_plan.cache_clear()
    ev = evt.EigenValue(evt.SolverConfig(symmetric=True, storage_dtype=torch.bfloat16))
    assert ev.last_wall_ms is None
    ev.warmup([4096, 1000])  # the triangle kernel at 4096, the stripes one at 1000
    plans = (tk.multiround_launch_plan.cache_info(), tk.multiround_sym_plan.cache_info())
    assert plans[0].currsize == 1 and plans[1].currsize == 1
    for n in (4096, 1000):
        _, _, ms, rounds = ev.similarity_transform(tfx.hilbert_matrix(n, device=cuda))
        assert rounds == {4096: 15, 1000: 13}[n]
        assert 0 < ms <= ev.last_wall_ms
    after = (tk.multiround_launch_plan.cache_info(), tk.multiround_sym_plan.cache_info())
    assert [a.misses for a in after] == [p.misses for p in plans]  # nothing planned anew
    with pytest.raises(ValueError, match="chunk"):
        evt.EigenValue(evt.SolverConfig(backend="matvec", chunk=3)).warmup([128])


# --- the matrix-free path: structured operators and max_eigenvalue_operator ---


def _structured_cases(dev, n: int = 4096):
    """``name -> (matvec, dense A, rtol, atol)`` at dim n (kron 64 x 64), inputs
    from numpy with a seed; the JAX tests' tolerances."""
    import numpy as np

    from eigen_value_tpu_torch.convert import sparse_from_coo
    from eigen_value_tpu_torch.ops import structured as st

    rng = np.random.default_rng(n)

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    i = torch.arange(n, device=dev)
    diff = i[:, None] - i[None, :]
    h = f32(rng.random(2 * n - 1, dtype=np.float32) + 0.1)
    c = f32(rng.random(n, dtype=np.float32) + 0.1)
    r = f32(rng.random(n, dtype=np.float32) + 0.1)
    r[0] = c[0]
    U, V = (f32(rng.random((n, 3), dtype=np.float32) + 0.1) for _ in range(2))
    d = f32(rng.random(n, dtype=np.float32))
    B, C = (f32(rng.random((64, 64), dtype=np.float32) + 0.1) for _ in range(2))
    rows = np.concatenate([np.repeat(np.arange(n), 6), np.arange(n)])
    cols = np.concatenate([(np.repeat(np.arange(n), 6) + 1
                            + rng.integers(0, n - 1, size=6 * n)) % n, np.arange(n)])
    vals = np.concatenate([rng.random(6 * n, dtype=np.float32) + 0.1, np.ones(n, np.float32)])
    S = torch.zeros(n, n, device=dev)
    S.index_put_((torch.from_numpy(rows).to(dev), torch.from_numpy(cols).to(dev)), f32(vals),
                 accumulate=True)
    low_rank = st.low_rank_matvec(U, V, d)
    ell = st.ell_matvec(*st.ell_from_coo(rows, cols, vals, n, device=dev))
    L = U @ V.T + torch.diag(d)
    Hk = h[i[:, None] + i[None, :]]
    return {
        "hankel": (st.hankel_matvec(h, n), Hk, 2e-5, 1e-5),
        "toeplitz": (st.toeplitz_matvec(c, r, n),
                     torch.where(diff >= 0, c[diff.abs()], r[diff.abs()]), 2e-5, 1e-5),
        "circulant": (st.circulant_matvec(c, n), c[diff % n], 2e-5, 1e-5),
        "low_rank": (low_rank, L, 2e-5, 1e-5),
        "kron": (st.kron_matvec(B, C), torch.kron(B, C), 2e-5, 1e-5),
        "sparse": (st.sparse_matvec(sparse_from_coo(np.stack([rows, cols], 1), vals, (n, n),
                                                    device=dev)), S, 1e-5, 1e-6),
        "ell": (ell, S, 1e-5, 1e-6),
        "add": (st.add_matvec(st.scale_matvec(low_rank, 0.25), ell), 0.25 * L + S, 2e-5, 1e-5),
        "scale": (st.scale_matvec(st.hankel_matvec(h, n), 4.0), 4.0 * Hk, 2e-5, 1e-5),
    }


@pytest.mark.parametrize("name", ["hankel", "toeplitz", "circulant", "low_rank", "kron",
                                  "sparse", "ell", "add", "scale"])
def test_structured_matvec_matches_f64_on_the_card(cuda, name):
    cases = _structured_cases(cuda)
    mv, A, rtol, atol = cases[name]
    n = A.shape[0]
    x = (torch.rand(n, generator=torch.Generator().manual_seed(1)) + 0.1).to(cuda)
    got = mv(x)
    assert got.is_cuda and got.dtype == torch.float32
    want = A.double() @ x.double()
    assert bool(((got.double() - want).abs() <= atol + rtol * want.abs()).all())


def test_kron_keeps_true_f32_under_the_callers_tf32(cuda):
    from eigen_value_tpu_torch.ops.structured import kron_matvec

    g = torch.Generator().manual_seed(2)
    B, C = (torch.rand(m, m, generator=g).to(cuda) + 0.1 for m in (64, 128))
    x = torch.rand(64 * 128, generator=g).to(cuda)
    mv = kron_matvec(B, C)
    want = mv(x)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        got = mv(x)
        assert torch.get_float32_matmul_precision() == "high"  # the caller's, given back
    finally:
        torch.set_float32_matmul_precision(prev)
    assert torch.equal(got, want)


def test_dense_backed_operator_is_the_matvec_kernel_loop(cuda):
    H = tfx.hilbert_matrix(1024, device=cuda)
    want = solve_matvec_kernel(H, EPS, MAX_ITR)
    before = tk.matvec.launches
    got = evt.max_eigenvalue_operator(lambda x: tk.matvec(H, x), 1024)
    assert tk.matvec.launches - before == int(want.rounds) + 1 == 14
    _same(got, want)


@pytest.mark.parametrize("n", sorted(tfx.HILBERT_ROUNDS))
def test_hilbert_operator_on_the_card(cuda, n):
    from eigen_value_tpu_torch.ops.structured import hilbert_matvec

    mv = hilbert_matvec(n)  # no device: the card
    got = evt.max_eigenvalue_operator(mv, n)
    want = evt.max_eigenvalue(tfx.hilbert_matrix(n, device=cuda))
    assert got.eigenvector.is_cuda and bool(got.converged)
    assert abs(int(got.rounds) - tfx.HILBERT_ROUNDS[n]) <= 1
    assert float(got.eigenvalue) == pytest.approx(float(want.eigenvalue), rel=1e-4)


def test_hilbert_operator_65536_against_a_float64_loop(cuda):
    from eigen_value_tpu_torch.ops.spectral import operator_residual
    from eigen_value_tpu_torch.ops.structured import hilbert_matvec

    mv = hilbert_matvec(65536)
    got = evt.max_eigenvalue_operator(mv, 65536)
    assert bool(got.converged) and abs(int(got.rounds) - 21) <= 1
    assert float(got.eigenvalue) == pytest.approx(2.70899626, rel=1e-5)
    assert float(operator_residual(mv, got)) <= 1e-3


# --- the resumable, batched and differentiable solves ----------------------------


@pytest.mark.parametrize("chunk", [1, 5, 15])
def test_checkpoint_step_is_the_one_launch_solve(cuda, chunk):
    from eigen_value_tpu_torch import checkpoint as cp

    H = tfx.hilbert_matrix(2048, device=cuda)
    want = solve_multiround(H, EPS, MAX_ITR)
    before = tk.multiround.launches
    got = cp.solve_checkpointed(H, chunk_rounds=chunk)
    steps = -(-(int(want.rounds) + 1) // chunk)  # the last step finds the stop
    assert tk.multiround.launches - before == steps
    _same(got, want)
    _same(got, solve_matvec_kernel(H, EPS, MAX_ITR))


def test_checkpoint_digest_on_the_card_is_the_cpus(cuda):
    from eigen_value_tpu_torch import checkpoint as cp

    g = torch.Generator().manual_seed(8)
    A = torch.rand(1000, 1000, generator=g)
    for M in (A, A.to(torch.bfloat16), A.double()):
        assert int(cp._matrix_digest(M.to(cuda))) == int(cp._matrix_digest(M))


def test_a_bf16_batch_is_each_matrixs_kernel_solve(cuda):
    g = torch.Generator().manual_seed(9)
    mats = (torch.rand(4, 512, 512, generator=g) + 0.05).to(cuda, torch.bfloat16)
    before = tk.matvec.launches
    got = evt.max_eigenvalue_batch(mats, evt.SolverConfig(storage_dtype=torch.bfloat16))
    assert tk.matvec.launches - before == 4 + int(got.rounds.sum())
    for b in range(4):
        want = solve_matvec_kernel(mats[b], EPS, MAX_ITR)
        assert int(got.rounds[b]) == int(want.rounds)
        assert torch.equal(got.eigenvalue[b], want.eigenvalue)
        assert torch.equal(got.eigenvector[b], want.eigenvector)


def test_a_gradient_on_the_card_is_the_cpus(cuda):
    from eigen_value_tpu_torch.ops import autodiff as ad
    from eigen_value_tpu_torch.ops.structured import hankel_matvec

    g = torch.Generator().manual_seed(10)
    A = torch.rand(256, 256, generator=g) + 0.1

    def grad(M):
        M = M.clone().requires_grad_(True)
        (dM,) = torch.autograd.grad(ad.eigenvalue(M), M)
        return dM

    torch.testing.assert_close(grad(A.to(cuda)).cpu(), grad(A), rtol=1e-4, atol=1e-7)
    n = 128
    h = torch.rand(2 * n - 1, generator=g) + 0.1

    def hgrad(p):
        p = p.clone().requires_grad_(True)
        lam = ad.eigenvalue_operator(lambda q: hankel_matvec(q, n), n)(p)
        (dp,) = torch.autograd.grad(lam, p)
        return dp

    torch.testing.assert_close(hgrad(h.to(cuda)).cpu(), hgrad(h), rtol=1e-3, atol=1e-6)


# --- the matvec kernel's leading dimension, and the sharded solves on a
# one-rank NCCL mesh (this card; several cards are not in this file) ---


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("parts", [2, 4, 8])
def test_matvec_reads_a_column_block_in_place(cuda, dtype, parts):
    n = 2048
    A = tfx.hilbert_matrix(n, device=cuda).to(dtype)
    w = n // parts
    x = (torch.rand(w, generator=torch.Generator().manual_seed(parts)) + 0.5).to(cuda)
    for s in range(parts):
        for view in (A[:, s * w:(s + 1) * w], A[w:2 * w, s * w:(s + 1) * w]):
            assert view.stride() == (n, 1)
            got = tk.matvec(view, x)
            assert torch.equal(got, tk.matvec(view.contiguous(), x))
            want = view.double() @ x.double()
            assert float(((got.double() - want).abs() / want).max()) < 2e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matvec_refuses_a_view_whose_rows_are_not_aligned(cuda, dtype):
    x = torch.ones(64, device=cuda)
    A = torch.ones(64, 65, device=cuda, dtype=dtype)
    before = tk.matvec.launches
    with pytest.raises(ValueError, match="multiple of 4"):
        tk.matvec(A[:, :64], x)  # rows 65 elements apart
    B = torch.ones(64, 72, device=cuda, dtype=dtype)
    with pytest.raises(ValueError, match="aligned"):
        tk.matvec(B[:, 1:65], x)  # the first row one element off its chunk
    assert tk.matvec.launches == before
    C = torch.rand(64, 67, device=cuda).to(dtype)
    y = torch.ones(63, device=cuda)  # 63 columns: the scalar path takes any ld
    assert torch.equal(tk.matvec(C[:, 1:64], y), tk.matvec(C[:, 1:64].contiguous(), y))


@pytest.fixture(scope="module")
def nccl():
    """A one-rank NCCL group on this card (``make_row_mesh(1)`` starts it)
    and its meshes; the group is destroyed after the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import torch.distributed as dist

    from eigen_value_tpu_torch.parallel import make_mesh2d, make_row_mesh

    started = not dist.is_initialized()
    meshes = {"rows": make_row_mesh(1), "2d": make_mesh2d(1, 1),
              "batch": make_row_mesh(1, "batch"), "batch_rows": make_mesh2d(1, 1, "batch", "rows")}
    yield meshes
    if started:
        dist.destroy_process_group()


def _local(res):
    return [x.to_local() if hasattr(x, "to_local") else x for x in res]


@pytest.mark.parametrize("storage", [None, torch.bfloat16])
@pytest.mark.parametrize("body", ["gather", "ring", "2d", "door"])
def test_one_rank_mesh_solves_are_the_kernel_loop_bit_for_bit(cuda, nccl, body, storage):
    from eigen_value_tpu_torch.parallel import (
        solve_sharded_2d,
        solve_sharded_matvec,
        solve_sharded_matvec_ring,
    )

    H = tfx.hilbert_matrix(1024, device=cuda)
    cfg = evt.SolverConfig(storage_dtype=storage)
    want = solve_matvec_kernel(H, EPS, MAX_ITR, storage_dtype=storage)
    before = tk.matvec.launches
    got = {
        "gather": lambda: solve_sharded_matvec(H, nccl["rows"], config=cfg),
        "ring": lambda: solve_sharded_matvec_ring(H, nccl["rows"], config=cfg),
        "2d": lambda: solve_sharded_2d(H, nccl["2d"], config=cfg),
        "door": lambda: evt.max_eigenvalue(H, cfg, mesh=nccl["rows"]),
    }[body]()
    torch.cuda.synchronize()
    assert tk.matvec.launches - before == int(want.rounds) + 1
    assert all(torch.equal(g, w) for g, w in zip(_local(got), want))
    assert int(got.rounds) == tfx.HILBERT_ROUNDS[1024] or storage is not None


def test_one_rank_iterated_and_batched_mesh_solves(cuda, nccl):
    from eigen_value_tpu_torch.parallel import solve_sharded

    H = tfx.hilbert_matrix(1024, device=cuda)
    got = solve_sharded(H, nccl["rows"])
    assert all(torch.equal(g, w) for g, w in zip(_local(got), solve_xla(H, EPS, MAX_ITR)))
    g = torch.Generator().manual_seed(11)
    mats = (torch.rand(8, 256, 256, generator=g) + 1e-4).to(cuda)
    want = evt.max_eigenvalue_batch(mats)
    for mesh in (nccl["batch"], nccl["batch_rows"]):
        got = evt.max_eigenvalue_batch(mats, mesh=mesh)
        assert all(torch.equal(g, w) for g, w in zip(_local(got), want))


def test_a_cuda_exchange_over_gloo_raises(cuda, nccl):
    import torch.distributed as dist

    from eigen_value_tpu_torch.parallel import _collectives as col

    gloo = dist.new_group([0], backend="gloo")
    x = torch.ones(4, device=cuda)
    for fn in (lambda: col.ppermute(x, [(0, 0)], gloo), lambda: col.all_gather(x, gloo),
               lambda: col.all_reduce_max(x, gloo)):
        with pytest.raises(ValueError, match="NCCL"):
            fn()


@pytest.mark.parametrize("storage", [None, torch.bfloat16])
@pytest.mark.parametrize("placement", ["rows", "2d"])
def test_one_rank_stepping_of_a_sharded_a_is_the_unsharded_step(cuda, nccl, placement, storage):
    from eigen_value_tpu_torch import checkpoint as cp
    from eigen_value_tpu_torch.parallel import assemble_blocksharded, assemble_rowsharded

    H = tfx.hilbert_matrix(1024, device=cuda)
    if storage is not None:
        H = H.to(storage)
    A = (assemble_rowsharded(H, nccl["rows"]) if placement == "rows"
         else assemble_blocksharded(H, nccl["2d"]))

    def stepped(M):
        state = cp.init_state(M)
        for k in (5, 5, MAX_ITR):
            state = cp.step(state, k)
        return state

    want = stepped(H)  # one multiround launch a step
    before = tk.matvec.launches
    got = stepped(A)
    torch.cuda.synchronize()
    assert tk.matvec.launches - before == int(want.rounds) + 1
    assert all(torch.equal(g, w) for g, w in zip(got[1:], want[1:]))
    assert int(got.rounds) == tfx.HILBERT_ROUNDS[1024] and bool(got.done)


@pytest.mark.parametrize("n", [128, 256, 512, 1024, 2048])
def test_the_parallel_oracle_agrees_with_the_card(cuda, n):
    from eigen_value_tpu_torch.reference_impl import parallel_oracle

    H = tfx.hilbert_matrix(n, device=cuda)
    got = parallel_oracle(H.cpu().numpy())
    lam = float(evt.max_eigenvalue(H).eigenvalue)
    assert got.converged and got.rounds == tfx.HILBERT_ROUNDS[n]
    assert abs(got.eigenvalue - lam) <= 1e-5 * lam


# --- the headline and the tools on the card -------------------------------------------


def test_the_headline_measures_the_card(cuda):
    import json

    from eigen_value_tpu_torch.bench import headline

    rec = headline.measure(headline.Settings(dim=2048, windows=2, gap_s=0.0))
    assert rec["rounds"] == 14 and rec["backend"].startswith("multiround_sym")
    assert rec["device"]["platform"] == "gpu" and rec["device"]["name"]
    assert len(rec["clocks"]) == 2 and all(c["sm_mhz"] for c in rec["clocks"])
    assert all(w >= rec["floor_ms"] for w in rec["windows_ms"]) and rec["call_ms"] > 0
    assert rec["hankel_fft_rounds"] == 14 and rec["launches"]["multiround_sym"] > 0
    assert json.loads(json.dumps(rec, allow_nan=False)) == rec


def test_the_drift_rows_carry_the_cards_state(cuda):
    from eigen_value_tpu_torch.bench.suite import bench_drift

    rows = bench_drift(dim=2048, windows=2, gap_s=0.0, k=16)
    assert [r["bench"] for r in rows] == ["drift", "drift", "drift_summary"]
    assert all(r["sm_mhz"] and r["power_w"] and r["gbps"] > 0 for r in rows[:2])


def test_a_profiled_solve_holds_the_kernels_device_time(cuda, tmp_path):
    import json
    import os

    from eigen_value_tpu_torch.utils import profiling

    H = tfx.hilbert_matrix(2048, device=cuda)
    with profiling.trace(str(tmp_path)) as d:
        evt.max_eigenvalue(H)
    events = json.load(open(os.path.join(d, profiling.TRACE_FILE)))["traceEvents"]
    assert any(e.get("cat") == "kernel" and "multiround_kernel" in e.get("name", "")
               and e.get("dur", 0) > 0 for e in events)
    assert profiling.device_memory_stats()["allocated_bytes.all.current"] > 0


@pytest.mark.parametrize("name", ["quickstart", "serving", "pagerank"])
def test_the_examples_run_on_the_card(cuda, name, capsys):
    import importlib

    importlib.import_module(f"eigen_value_tpu_torch.examples.{name}").main()
    assert "λ = " in capsys.readouterr().out


# --- the dot formulation: the tensor cores in 3xTF32 ----------------------------------

DOT_MODES = {"stripes": {}, "triangle": dict(symmetric=True),
             "dense tiled": dict(cache_tiles=3)}


def test_tf32_split_is_the_cards_cvt_rna(cuda):
    import numpy as np

    from eigen_value_tpu_torch.ops.cuda import build

    bits = np.random.default_rng(13).integers(0, 2**32, 1 << 16, dtype=np.uint64).astype(np.uint32)
    picked = np.array([0x3F801000, 0xBF801000, 0x3F800FFF, 0x3F801001, 0x3F803000, 0x00001000,
                       0x00000FFF, 0x007FFFFF, 0x80003001, 0x00800000, 0x3F810000, 0x80000000],
                      dtype=np.uint32)
    x = np.concatenate([picked, bits]).view(np.float32)
    x = torch.from_numpy(x[np.isfinite(x) & (np.abs(x) < 3.4e38)].copy())
    xd = x.to(cuda)
    big = torch.empty(x.numel(), dtype=torch.int32, device=cuda)
    small = torch.empty_like(big)
    rc = build.load().evt_tf32_split(xd.data_ptr(), big.data_ptr(), small.data_ptr(), x.numel(),
                                     1, torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    want_big, want_small = tk.tf32_split(x)
    assert torch.equal(big.cpu(), want_big.view(torch.int32))
    assert torch.equal(small.cpu(), want_small.view(torch.int32))


def _card_split(x, cvt):
    from eigen_value_tpu_torch.ops.cuda import build

    xd = x.to("cuda")
    big = torch.empty(x.numel(), dtype=torch.int32, device=xd.device)
    small = torch.empty_like(big)
    assert build.load().evt_tf32_split(xd.data_ptr(), big.data_ptr(), small.data_ptr(),
                                       x.numel(), int(cvt),
                                       torch.cuda.current_stream().cuda_stream) == 0
    return big.cpu(), small.cpu()


def test_the_kernels_integer_rounding_is_cvt_rna(cuda):
    # chip_smoke.py step 10a's 1,044,633 values (random bit patterns from its
    # seed, finite, below 3.4e38, and its picked ties), then ±0, subnormals,
    # the largest finite values and ±inf.  The kernels round by (bits +
    # 0x1000) & ~0x1fff; they assume A and ev finite, so no NaN is held here
    # (a NaN whose carry reaches the exponent rounds to a signed zero, where
    # cvt.rna keeps a NaN).
    gen = torch.Generator().manual_seed(20261016 + 13)
    bits = torch.randint(0, 1 << 16, (1 << 20, 2), generator=gen, dtype=torch.int32)
    words = (bits[:, 0] << 16) | bits[:, 1]
    picked = torch.tensor([0x3F801000, -0x407FF000, 0x3F800FFF, 0x3F803000, 0x00001000,
                           0x00000FFF, 0x007FFFFF, 0x00800000, 0x3F810000], dtype=torch.int32)
    x = torch.cat([picked, words]).view(torch.float32)
    x = x[torch.isfinite(x) & (x.abs() < 3.4e38)]
    assert x.numel() == 1044633
    edge = torch.tensor([0x00000000, 0x80000000, 0x00000001, 0x80000001, 0x00000FFF, 0x00001000,
                         0x00001001, 0x807FF000, 0x007FFFFF, 0x807FFFFF, 0x7F7FEFFF, 0x7F7FF000,
                         0xFF7FF000, 0x7F7FFFFF, 0xFF7FFFFF],
                        dtype=torch.int64).to(torch.int32).view(torch.float32)
    x = torch.cat([x, edge]).contiguous()
    big, small = _card_split(x, cvt=False)
    cvt_big, cvt_small = _card_split(x, cvt=True)
    want_big, want_small = tk.tf32_split(x)
    assert torch.equal(big, cvt_big) and torch.equal(small, cvt_small)
    assert torch.equal(big, want_big.view(torch.int32))
    assert torch.equal(small, want_small.view(torch.int32))
    # ±inf: the big part is the infinity itself in all three; its small
    # part (inf - inf) is NaN, which the kernels never meet in a finite solve
    inf = torch.tensor([float("inf"), float("-inf")])
    big, _ = _card_split(inf, cvt=False)
    cvt_big, _ = _card_split(inf, cvt=True)
    assert torch.equal(big, cvt_big)
    assert torch.equal(big, tk.tf32_rna(inf).view(torch.int32))


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("mode", sorted(DOT_MODES))
def test_two_byte_dot_without_the_small_product_is_the_f32_launch(cuda, mode, dt):
    # a 2-byte A skips the split and the a_small product; the f32 instance on
    # A_q.float() splits it (small = 0) and adds the product of zeros
    n = 1024
    R = 1 + 0.25 * torch.rand(n, n, generator=torch.Generator().manual_seed(n + 1)).to(cuda)
    if mode == "triangle":
        R = (R + R.T) / 2
    A_q = (tfx.hilbert_matrix(n, device=cuda) * R).to(dt)
    ev = torch.ones(n, device=cuda)
    z = torch.zeros((), device=cuda)
    if mode == "stripes":
        run, kw = tk.multiround, {}
    else:
        run = tk.multiround_sym
        kw = dict(sym=mode == "triangle", cache_tiles=DOT_MODES[mode].get("cache_tiles", 3))
    for init in (True, False):
        got = run(A_q, ev, ev, z, MAX_ITR, chunk=5, eps=EPS, init=init, formulation="dot", **kw)
        want = run(A_q.float(), ev, ev, z, MAX_ITR, chunk=5, eps=EPS, init=init,
                   formulation="dot", **kw)
        assert int(got[2]) == int(want[2])
        for g, w in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])):
            assert torch.equal(g, w)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("mode", sorted(DOT_MODES))
@pytest.mark.parametrize("n", [384, 1024, 4096])
def test_dot_kernels_match_their_plain_versions(cuda, n, mode, dt):
    H = tfx.hilbert_matrix(n, device=cuda)
    # and not Hankel: every 16 x 16 piece of a Hilbert tile is symmetric, so a
    # row / column mix-up in the fragments would not show on it.  The
    # triangle gets a symmetric random scaling, the others an asymmetric one.
    R = 1 + 0.25 * torch.rand(n, n, generator=torch.Generator().manual_seed(n)).to(cuda)
    if mode == "triangle":
        R = (R + R.T) / 2
    for A in (H.to(dt), (H * R).to(dt)):
        _dot_launches_match_plain(A, mode)


def _dot_launches_match_plain(A, mode):
    n, cuda = A.shape[0], A.device
    ev = torch.ones(n, device=cuda)
    z = torch.zeros((), device=cuda)
    if mode == "stripes":
        run, plain, kw = tk.multiround, tk.multiround_plain, {}
    else:
        run, plain = tk.multiround_sym, tk.multiround_sym_plain
        kw = dict(sym=mode == "triangle", cache_tiles=DOT_MODES[mode].get("cache_tiles", 0))
    state = (ev, ev, z)
    for init in (True, False):
        before = run.launches
        got = run(A, *state, MAX_ITR, chunk=5, eps=EPS, init=init, formulation="dot", **kw)
        want = plain(A, *state, MAX_ITR, chunk=5, eps=EPS, init=init, formulation="dot", **kw)
        torch.cuda.synchronize()
        assert run.launches == before + 1
        assert int(got[2]) == int(want[2])
        # the unit's order of the products is its own: within f32 rounding of
        # the plain 3xTF32 product, as the vpu kernels are of theirs
        for g, w in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=0)
        state = (got[0], got[1], got[3])


@pytest.mark.parametrize("mode", sorted(DOT_MODES))
@pytest.mark.parametrize("n", [128, 1024, 2048, 4096])
def test_dot_solves_keep_the_table_and_their_bits(cuda, n, mode):
    H = tfx.hilbert_matrix(n, device=cuda)
    kw = dict(DOT_MODES[mode], formulation="dot")
    base = solve_multiround(H, EPS, MAX_ITR, **kw)
    vpu = solve_multiround(H, EPS, MAX_ITR, **DOT_MODES[mode])
    assert int(base.rounds) == tfx.HILBERT_ROUNDS[n] == int(vpu.rounds)
    assert float(base.eigenvalue) == pytest.approx(float(vpu.eigenvalue), rel=1e-5)
    for chunk in (1, 5):
        _same(solve_multiround(H, EPS, MAX_ITR, chunk=chunk, **kw), base)
    for dt in (torch.bfloat16, torch.float16):
        H_q = H.to(dt)
        _same(solve_multiround(H_q, EPS, MAX_ITR, **kw),
              solve_multiround(H_q.float(), EPS, MAX_ITR, **kw))
    if mode != "stripes":
        sym = mode == "triangle"
        auto = sym_auto_cache_tiles(n, 128, cuda, sym=sym, ring=False)
        # a cache of 0 without symmetric=True would be the stripes kernel
        for c in sorted({0 if sym else 1, 3, auto} - ({0} if not sym else set())):
            _same(solve_multiround(H, EPS, MAX_ITR, **dict(kw, cache_tiles=c)), base)


def test_dot_triangle_does_not_read_below_the_block_diagonal(cuda):
    n = 2048
    H = tfx.hilbert_matrix(n, device=cuda)
    bad = torch.where(_below_block_diagonal(n, 128, cuda), torch.full_like(H, 7.25), H)
    kw = dict(symmetric=True, formulation="dot")
    for c in (0, sym_auto_cache_tiles(n, 128, cuda, ring=False)):
        _same(solve_multiround(bad, EPS, MAX_ITR, cache_tiles=c, **kw),
              solve_multiround(H, EPS, MAX_ITR, cache_tiles=c, **kw))


@pytest.mark.parametrize("n", [96, 1000, 1088])
def test_the_stripes_dot_rejects_an_unaligned_n(cuda, n):
    H = tfx.hilbert_matrix(n, device=cuda)
    ev = torch.ones(n, device=cuda)
    before = tk.multiround.launches
    with pytest.raises(ValueError, match="dot-aligned"):
        tk.multiround(H, ev, ev, 0.0, 10, chunk=2, eps=EPS, formulation="dot")
    with pytest.raises(ValueError, match="dot-aligned"):
        solve_multiround(H, EPS, MAX_ITR, formulation="dot")
    assert tk.multiround.launches == before


# --- the mixed formulation and the pipelined fill of the triangle kernel ---------

MIXED_MODES = {"triangle": dict(sym=True), "dense tiled": dict(sym=False)}


def _pipelined(n, c, sym, mixed=False, mxu_tiles=None):
    """The largest cache up to ``c`` that the pipelined fill's depth rule
    (the JAX kernel's, ``kernels.pipelined_depth``) accepts."""
    def depth(c):
        m = tk.mxu_share(n, 128, c, sym, mxu_tiles) if mixed else 0
        return tk.pipelined_depth(n, 128, c, sym, m)
    while c and depth(c) > tk.PIPELINED_DEPTH:
        c -= 1
    return c


def _caches(n, sym, dt, cuda):
    """A cache with fewer resident tiles than the grid has blocks, and one
    with more (the card's auto cache where that is more)."""
    g = n // 128
    most = g * (g - 1) // 2 if sym else g * g - 1
    auto = sym_auto_cache_tiles(n, 128, cuda, sym=sym, itemsize=dt.itemsize)
    return sorted({min(3, most), max(min(most, 200), auto)})


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("mode", sorted(MIXED_MODES))
@pytest.mark.parametrize("n", [256, 2048, 8192])
def test_mixed_kernel_matches_its_plain_version(cuda, n, mode, dt):
    H = tfx.hilbert_matrix(n, device=cuda)
    R = 1 + 0.25 * torch.rand(n, n, generator=torch.Generator().manual_seed(n)).to(cuda)
    if mode == "triangle":
        R = (R + R.T) / 2
    A = (H * R).to(dt)
    del R
    ev, z = torch.ones(n, device=cuda), torch.zeros((), device=cuda)
    for c in _caches(n, MIXED_MODES[mode]["sym"], dt, cuda):
        for mxu in (None, 1):
            state = (ev, ev, z)
            for init in (True, False):
                kw = dict(chunk=5, eps=EPS, init=init, cache_tiles=c, formulation="mixed",
                          mxu_tiles=mxu, **MIXED_MODES[mode])
                before = tk.multiround_sym.launches
                got = tk.multiround_sym(A, *state, MAX_ITR, **kw)
                want = tk.multiround_sym_plain(A, *state, MAX_ITR, **kw)
                torch.cuda.synchronize()
                assert tk.multiround_sym.launches == before + 1
                assert int(got[2]) == int(want[2])
                # the tensor cores' order of the products is their own: within
                # f32 rounding of the plain 3xTF32 product (dot: 3.6-4.5e-6)
                for g, w in ((got[0], want[0]), (got[1], want[1])):
                    assert float((g - w).abs().max()) <= 1e-5
                torch.testing.assert_close(got[3], want[3], rtol=1e-5, atol=0)
                state = (got[0], got[1], got[3])


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", sorted(MIXED_MODES))
@pytest.mark.parametrize("n", [256, 2048])
def test_mixed_with_no_tensor_core_tile_is_vpu_bit_for_bit(cuda, n, mode, dt):
    H = tfx.hilbert_matrix(n, device=cuda).to(dt)
    sym = MIXED_MODES[mode]["sym"]
    for c in _caches(n, sym, dt, cuda):
        kw = dict(cache_tiles=c, symmetric=sym)
        _same(solve_multiround(H, EPS, MAX_ITR, formulation="mixed", mxu_tiles=0, **kw),
              solve_multiround(H, EPS, MAX_ITR, **kw))


@pytest.mark.parametrize("variant", ["mixed", "pipelined"])
def test_the_two_variants_keep_the_hilbert_table(cuda, variant):
    kw = dict(formulation="mixed") if variant == "mixed" else dict(fill_mode="pipelined")
    for n, rounds in tfx.HILBERT_ROUNDS.items():
        H = tfx.hilbert_matrix(n, device=cuda)
        c = sym_auto_cache_tiles(n, 128, cuda)
        if variant == "pipelined":
            c = _pipelined(n, c, True)
        if c == 0:  # 128²: one tile, none resident; JAX refuses too
            with pytest.raises(ValueError, match="cache_tiles > 0"):
                solve_multiround(H, EPS, MAX_ITR, symmetric=True, cache_tiles=1, **kw)
            continue
        res = solve_multiround(H, EPS, MAX_ITR, symmetric=True, cache_tiles=c, **kw)
        assert int(res.rounds) == rounds and bool(res.converged)
        vpu = solve_multiround(H, EPS, MAX_ITR, symmetric=True)
        assert float(res.eigenvalue) == pytest.approx(float(vpu.eigenvalue), rel=1e-5)
        for chunk in (1, 5):
            _same(solve_multiround(H, EPS, MAX_ITR, symmetric=True, cache_tiles=c, chunk=chunk,
                                   **kw), res)


@pytest.mark.parametrize("matrix", ["hilbert", "scaled"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("formulation", ["vpu", "dot", "mixed"])
@pytest.mark.parametrize("n", [2048, 4096, 8192])
def test_the_pipelined_fill_is_the_prologue_fill_bit_for_bit(cuda, n, formulation, dt, matrix):
    """Every instance (vpu: the register path in f32, the ring in 2 bytes;
    dot; mixed), triangle and dense tiled, a small cache and the largest the
    depth rule leaves of the auto one (108 at 2048²), on Hilbert and on
    Hilbert scaled at random: single launches of 1, 5 and every round, whole
    solves in chunks of 1 and 5 (each launch fills anew), and a launch that
    stops at round 0."""
    H = tfx.hilbert_matrix(n, device=cuda)
    ev, z = torch.ones(n, device=cuda), torch.zeros((), device=cuda)
    for sym in (True, False):
        A = H
        if matrix == "scaled":  # symmetric for the triangle, which reads the upper half
            R = 1 + 0.25 * torch.rand(n, n, generator=torch.Generator().manual_seed(n + sym))
            A = H * (((R + R.T) / 2) if sym else R).to(cuda)
            del R
        A = A.to(dt)
        auto = sym_auto_cache_tiles(n, 128, cuda, sym=sym, itemsize=dt.itemsize,
                                    ring=formulation == "vpu")
        for c in sorted({5, _pipelined(n, auto, sym, formulation == "mixed")}):
            kw = dict(cache_tiles=c, sym=sym, formulation=formulation, eps=EPS)
            for chunk, init in ((1, True), (5, True), (MAX_ITR + 1, True)):
                a = tk.multiround_sym(A, ev, ev, z, MAX_ITR, chunk=chunk, init=init, **kw)
                b = tk.multiround_sym(A, ev, ev, z, MAX_ITR, chunk=chunk, init=init,
                                      fill_mode="pipelined", **kw)
                assert all(torch.equal(p, q) for p, q in zip(a, b))
            for chunk in (1, 5):
                _same(*(solve_multiround(A, EPS, MAX_ITR, chunk=chunk, symmetric=sym,
                                         cache_tiles=c, formulation=formulation, fill_mode=fm)
                        for fm in ("pipelined", "prologue")))
            # a launch whose rounds stop at round 0, its copies in flight
            ev_s, v_s, _, lam = a
            stopped = [tk.multiround_sym(A, ev_s, v_s, lam, MAX_ITR, chunk=5, fill_mode=fm, **kw)
                       for fm in ("prologue", "pipelined")]
            torch.cuda.synchronize()
            assert int(stopped[1][2]) == 0
            assert all(torch.equal(p, q) for p, q in zip(*stopped))
            assert torch.equal(stopped[1][0], ev_s) and torch.equal(stopped[1][1], v_s)


def test_the_two_variants_do_not_read_below_the_block_diagonal(cuda):
    n = 2048
    H = tfx.hilbert_matrix(n, device=cuda)
    bad = torch.where(_below_block_diagonal(n, 128, cuda), torch.full_like(H, 7.25), H)
    auto = sym_auto_cache_tiles(n, 128, cuda)
    for kw in (dict(formulation="mixed"), dict(fill_mode="pipelined"),
               dict(formulation="mixed", fill_mode="pipelined", mxu_tiles=2)):
        c = auto if "fill_mode" not in kw else _pipelined(
            n, auto, True, "formulation" in kw, kw.get("mxu_tiles"))
        _same(solve_multiround(bad, EPS, MAX_ITR, symmetric=True, cache_tiles=c, **kw),
              solve_multiround(H, EPS, MAX_ITR, symmetric=True, cache_tiles=c, **kw))


@pytest.mark.parametrize("kw", [dict(formulation="mixed"), dict(formulation="mixed", mxu_tiles=2),
                                dict(fill_mode="pipelined"),
                                dict(formulation="mixed", fill_mode="pipelined")])
def test_the_jax_hardware_cases_of_the_two_variants(cuda, kw):
    """tests/test_tpu_hw.py's cases at 2048², cache 4, at tile 128 (a 512²
    f32 tile does not fit a block's shared memory)."""
    n = 2048
    H = tfx.hilbert_matrix(n, device=cuda)
    res = solve_multiround(H, EPS, MAX_ITR, chunk=tfx.HILBERT_ROUNDS[n] + 1, symmetric=True,
                           tile=128, cache_tiles=4, **kw)
    assert int(res.rounds) == tfx.HILBERT_ROUNDS[n] and bool(res.converged)
    v = res.eigenvector.double()
    assert float((H.double() @ v - res.eigenvalue.double() * v).abs().max()) <= 1e-3


def test_the_pipelined_fill_refuses_a_misaligned_matrix(cuda):
    # a bf16 A 8 bytes off a 16-byte boundary: aligned to four elements, as
    # the loads need, but not for a bulk copy; "mixed" has no ring, so only
    # the fill asks for the bulk copies
    n = 256
    buf = torch.empty(n * n + 4, dtype=torch.bfloat16, device=cuda)
    A = buf[4:].view(n, n)
    A.copy_(tfx.hilbert_matrix(n, device=cuda))
    ev = torch.ones(n, device=cuda)
    kw = dict(chunk=2, eps=EPS, cache_tiles=1, formulation="mixed")
    tk.multiround_sym(A, ev, ev, 0.0, 10, **kw)
    before = tk.multiround_sym.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        tk.multiround_sym(A, ev, ev, 0.0, 10, fill_mode="pipelined", **kw)
    assert tk.multiround_sym.launches == before


# --- the solve's result written where it ends (csrc/prologue.cuh write_finish) -----


def _parent_solve(A, max_itr, wrapper, chunk=None, **kw):
    """``solve_multiround`` as it was before the kernels wrote the result:
    the same launches, each returning its carry, then ``_finish``."""
    from eigen_value_tpu_torch.ops.solver import _finish
    from eigen_value_tpu_torch.ops.solver_matvec import _Carry

    chunk = max_itr + 1 if chunk is None else chunk
    kw = dict(chunk=chunk, eps=EPS, **kw)
    ones = torch.ones(A.shape[0], device=A.device)
    ev, v, adv, lam = wrapper(A, ones, ones, torch.zeros((), device=A.device), max_itr,
                              init=True, **kw)
    c = _Carry(ev, v, lam, int(adv))
    frozen = c.i < chunk - 1
    while not frozen and c.i < max_itr:
        ev, v, adv, lam = wrapper(A, c.ev, c.v, c.lam, max_itr - c.i, init=False, **kw)
        c = _Carry(ev, v, lam, c.i + int(adv))
        frozen = int(adv) < chunk
    return _finish(c, max_itr)


class _Spy:
    """A wrapper that keeps what each launch returns.  The wrapper counts
    its launches on the module's name for it, which the spy then holds, so
    the spy reads and writes its attributes (``launches``, ``plan``) on the
    wrapper itself."""

    def __init__(self, wrapper):
        object.__setattr__(self, "wrapper", wrapper)
        object.__setattr__(self, "outs", [])

    def __call__(self, *args, **kw):
        self.outs.append(self.wrapper(*args, **kw))
        return self.outs[-1]

    def __getattr__(self, name):
        return getattr(self.wrapper, name)

    def __setattr__(self, name, value):
        setattr(self.wrapper, name, value)


def _last_launch_result(monkeypatch, wrapper, solve):
    """``solve()`` with a spy on ``wrapper``: its result is the last
    launch's result tensors, and no ``solver.finish`` span opens."""
    spy = _Spy(wrapper)
    with monkeypatch.context() as m, recording() as spans:
        m.setattr(tk, wrapper.__name__, spy)
        got = solve()
    ev, _, _, lam, rounds, converged = spy.outs[-1]
    assert got.eigenvector is ev and got.eigenvalue is lam
    assert got.rounds is rounds and got.converged is converged
    assert "solver.finish" not in {s.name for s in spans}
    return got


#: every instance the two wrappers launch on a solve: (symmetric, cache:
#: None, 0 or "auto", formulation, fill)
FINISH_ROUTES = {
    "stripes vpu": (False, None, "vpu", "prologue"),
    "stripes dot": (False, None, "dot", "prologue"),
    "triangle vpu, no cache": (True, 0, "vpu", "prologue"),
    "triangle vpu": (True, "auto", "vpu", "prologue"),
    "triangle dot": (True, "auto", "dot", "prologue"),
    "triangle mixed": (True, "auto", "mixed", "prologue"),
    "triangle pipelined": (True, "auto", "vpu", "pipelined"),
    "triangle mixed pipelined": (True, "auto", "mixed", "pipelined"),
    "dense tiled vpu": (False, "auto", "vpu", "prologue"),
    "dense tiled pipelined": (False, "auto", "vpu", "pipelined"),
}


@pytest.mark.parametrize("chunk", [None, 3])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route", list(FINISH_ROUTES))
def test_the_kernels_write_finish_of_their_carry_bit_for_bit(cuda, monkeypatch, route, dt,
                                                             chunk):
    """The solve's rounds, converged, λ and eigenvector, written by the
    launch where the solve ends, equal ``_finish`` on the same launches'
    carry bit for bit: at the stop (Hilbert 2048² and 8192², and 8192²
    scaled at random) and at the cap; the solve returns its last launch's
    result tensors and opens no ``solver.finish`` span, and the launches
    are the carry loop's."""
    sym, cache, formulation, fill = FINISH_ROUTES[route]
    for n, scaled in ((2048, False), (8192, False), (8192, True)):
        A = tfx.hilbert_matrix(n, device=cuda)
        if scaled:  # symmetric, as the triangle reads the upper half
            R = 1 + 0.01 * torch.rand(n, n, generator=torch.Generator().manual_seed(n)).to(cuda)
            A = A * ((R + R.T) / 2)
            del R
        A = A.to(dt)
        kw, solve_kw = dict(formulation=formulation), dict(formulation=formulation)
        if cache is None:
            wrapper = tk.multiround
        else:
            wrapper = tk.multiround_sym
            c = 0 if cache == 0 else sym_auto_cache_tiles(
                n, 128, cuda, sym=sym, itemsize=dt.itemsize, ring=formulation == "vpu")
            if fill == "pipelined":
                c = _pipelined(n, c, sym, formulation == "mixed")
            kw.update(cache_tiles=c, sym=sym, fill_mode=fill)
            solve_kw.update(cache_tiles=c, symmetric=sym, fill_mode=fill)
        for max_itr in (MAX_ITR, 5):
            launches = wrapper.launches
            got = _last_launch_result(monkeypatch, wrapper,
                                      lambda: solve_multiround(A, EPS, max_itr, chunk=chunk,
                                                               **solve_kw))
            torch.cuda.synchronize()
            mid = wrapper.launches
            want = _parent_solve(A, max_itr, wrapper, chunk, **kw)
            assert wrapper.launches - mid == mid - launches
            assert got.rounds.dtype == torch.int32 and got.rounds.shape == ()
            assert got.converged.dtype == torch.bool and got.converged.shape == ()
            assert got.rounds.device == got.converged.device == A.device
            assert bool(got.converged) == (max_itr == MAX_ITR)
            assert bool(got.converged) == bool(want.converged)
            _same(got, want)
