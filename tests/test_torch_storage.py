"""Reduced-precision storage of A (``storage_dtype`` = bf16 / f16), against
the JAX package's Pallas kernels.

The contract is the kernels': A is stored in 2 bytes, each element is cast
up to f32 (exact) and multiplied with the f32 ev, the sums run in f32, and
all O(n) state is f32.  JAX's ``solve_multiround(storage_dtype=...)`` runs
it in interpret mode here, and the port's ``solve_multiround`` runs the
plain versions on the same quantized matrix.  Nothing is held against JAX's
``solve_matvec_storage``, which divides by a quantized ev (a different
contract).  A storage solve is the f32 solve of the quantized matrix, so its
residual is held against ``A_q`` in float64, not against A.

The launch plans for a 2-byte A are held against values computed by hand
for an H100 (132 SMs, 232,448 bytes of shared memory a block, 50 MB of L2);
nothing launches.  The kernels are held on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from eigen_value_tpu import fixtures as jfx  # noqa: E402
from eigen_value_tpu.ops.solver_matvec import solve_multiround as jax_multiround  # noqa: E402
from eigen_value_tpu.reference_impl import parallel_oracle  # noqa: E402
import eigen_value_tpu_torch as evt  # noqa: E402
from eigen_value_tpu_torch import api, device  # noqa: E402
from eigen_value_tpu_torch import fixtures as tfx  # noqa: E402
from eigen_value_tpu_torch.ops import solver_matvec as sm  # noqa: E402
from eigen_value_tpu_torch.ops.cuda import kernels as tk  # noqa: E402

EPS, MAX_ITR = 1e-3, 1000
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "f16": (torch.float16, jnp.float16)}
MODES = {"stripes": {}, "triangle": dict(symmetric=True, tile=128, cache_tiles=0)}


def _residual(A_q: torch.Tensor, res) -> float:
    """``max |A_q·v − λ·v|`` in float64, against the stored matrix."""
    A = A_q.double()
    v = res.eigenvector.double()
    return float((A @ v - res.eigenvalue.double() * v).abs().max())


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("n", [128, 256, 512])
def test_storage_solve_matches_the_jax_kernels(n, dt, mode):
    tdt, jdt = DTYPES[dt]
    kw = MODES[mode]
    want = jax_multiround(jfx.hilbert_matrix(n), EPS, MAX_ITR, storage_dtype=jdt,
                          interpret=True, **kw)
    H = tfx.hilbert_matrix(n)
    got = sm.solve_multiround(H, EPS, MAX_ITR, storage_dtype=tdt, **kw)
    assert got.eigenvector.dtype == got.eigenvalue.dtype == torch.float32
    assert bool(got.converged) and int(got.rounds) == int(want.rounds)
    # measured ≤ 6e-7 for both: the sums run in another order than JAX's
    assert float(got.eigenvalue) == pytest.approx(float(want.eigenvalue), rel=1e-5)
    np.testing.assert_allclose(got.eigenvector.numpy(), np.asarray(want.eigenvector), atol=1e-5)
    A_q = H.to(tdt)
    assert _residual(A_q, got) <= 1e-3
    oracle = parallel_oracle(A_q.float().numpy())
    assert abs(int(got.rounds) - oracle.rounds) <= 1


@pytest.mark.parametrize("mode", sorted(MODES))
def test_a_chunked_storage_solve_matches_jax(mode):
    kw = MODES[mode]
    want = jax_multiround(jfx.hilbert_matrix(256), EPS, MAX_ITR, chunk=4,
                          storage_dtype=jnp.bfloat16, interpret=True, **kw)
    H = tfx.hilbert_matrix(256)
    got = sm.solve_multiround(H, EPS, MAX_ITR, chunk=4, storage_dtype=torch.bfloat16, **kw)
    assert int(got.rounds) == int(want.rounds) == tfx.HILBERT_ROUNDS[256]
    assert float(got.eigenvalue) == pytest.approx(float(want.eigenvalue), rel=1e-5)
    np.testing.assert_allclose(got.eigenvector.numpy(), np.asarray(want.eigenvector), atol=1e-5)
    whole = sm.solve_multiround(H, EPS, MAX_ITR, storage_dtype=torch.bfloat16, **kw)
    assert torch.equal(got.eigenvector, whole.eigenvector)  # chunking changes no bit


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_a_storage_solve_is_the_f32_solve_of_the_quantized_matrix(dt):
    tdt = DTYPES[dt][0]
    H = tfx.hilbert_matrix(384)
    A_q = H.to(tdt)
    for solve, kw in ((sm.solve_multiround, {}),
                      (sm.solve_multiround, dict(symmetric=True, cache_tiles=0)),
                      (sm.solve_matvec_kernel, {}), (sm.solve_matvec, {})):
        got = solve(H, EPS, MAX_ITR, storage_dtype=tdt, **kw)
        want = solve(A_q.float(), EPS, MAX_ITR, **kw)
        assert int(got.rounds) == int(want.rounds)
        assert torch.equal(got.eigenvalue, want.eigenvalue)
        assert torch.equal(got.eigenvector, want.eigenvector)


# --- the API -------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["auto", "matvec", "matvec_pallas", "multiround"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_the_api_honors_storage_dtype(backend, dt):
    tdt = DTYPES[dt][0]
    H = tfx.hilbert_matrix(256)
    cfg = evt.SolverConfig(backend=backend, storage_dtype=tdt)
    got = evt.max_eigenvalue(H, cfg)
    want = sm.solve_multiround(H, EPS, MAX_ITR, storage_dtype=tdt)
    assert int(got.rounds) == int(want.rounds) == tfx.HILBERT_ROUNDS[256]
    assert torch.equal(got.eigenvalue, want.eigenvalue)
    assert torch.equal(got.eigenvector, want.eigenvector)
    # the route names the storage it was given
    assert api.route(cfg, 256, H.device).storage is tdt


def test_a_prequantized_matrix_is_solved_as_it_is():
    cfg = evt.SolverConfig(storage_dtype=torch.bfloat16)
    A_q = tfx.hilbert_matrix(256).to(torch.bfloat16)
    mat = api._as_matrix(A_q, cfg)
    assert mat is A_q  # no f32 copy, not even a bf16 one
    assert sm._stored(mat, torch.bfloat16)[0] is A_q
    # another dtype is cast to config.dtype first
    assert api._as_matrix(A_q, evt.SolverConfig(storage_dtype=torch.float16)).dtype == torch.float32
    got = evt.max_eigenvalue(A_q, cfg)
    _, vec, _, rounds = evt.EigenValue(cfg, device="cpu").similarity_transform(A_q)
    want = evt.max_eigenvalue(tfx.hilbert_matrix(256), cfg)
    assert int(got.rounds) == rounds == int(want.rounds)
    assert torch.equal(got.eigenvector, want.eigenvector)
    np.testing.assert_array_equal(vec, want.eigenvector.numpy())


def test_validate_works_on_the_stored_matrix():
    cfg = evt.SolverConfig(backend="multiround", symmetric=True, storage_dtype=torch.bfloat16)
    A_q = tfx.hilbert_matrix(256).to(torch.bfloat16)
    got = evt.max_eigenvalue(A_q, cfg, validate=True)
    assert int(got.rounds) == tfx.HILBERT_ROUNDS[256]
    bad = A_q.clone()
    bad[3, 5] = 7.0
    with pytest.raises(ValueError, match="not bitwise symmetric"):
        evt.max_eigenvalue(bad, cfg, validate=True)
    with pytest.raises(ValueError, match="entries > 0"):
        evt.max_eigenvalue(-A_q, cfg, validate=True)


@pytest.mark.parametrize(
    "cfg, match",
    [
        (dict(backend="xla", storage_dtype=torch.bfloat16), "matvec-family"),
        (dict(backend="pallas", storage_dtype=torch.float16), "matvec-family"),
        (dict(storage_dtype=torch.float64), "storage_dtype"),
        (dict(backend="multiround", storage_dtype=torch.bfloat16, dtype=torch.float64), "dtype"),
    ],
)
def test_storage_rejections(cfg, match):
    with pytest.raises(ValueError, match=match):
        evt.max_eigenvalue(tfx.hilbert_matrix(128), evt.SolverConfig(**cfg))


def test_the_fused_round_solves_keep_f32_a():
    A_q = tfx.hilbert_matrix(128).to(torch.bfloat16)
    ev = torch.ones(128)
    with pytest.raises(ValueError, match="float32"):
        tk.round_matvec(A_q, ev, ev, 1.0)
    with pytest.raises(ValueError, match="float32"):
        tk.round_fused(A_q, ev, ev, eps=EPS)


# --- the kernels' plain versions -----------------------------------------------


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("init", [True, False])
def test_multiround_plain_of_a_2_byte_a_is_bitwise_its_f32_values(dt, init):
    tdt = DTYPES[dt][0]
    A_q = tfx.hilbert_matrix(256).to(tdt)
    ev = torch.ones(256)
    v, lam = ev, torch.zeros(())
    if not init:
        ev, v, _, lam = tk.multiround_plain(A_q.float(), ev, ev, lam, MAX_ITR, chunk=3,
                                            eps=EPS, init=True)
    kw = dict(chunk=5, eps=EPS, init=init)
    got = tk.multiround(A_q, ev, v, lam, MAX_ITR, **kw)
    want = tk.multiround_plain(A_q.float(), ev, v, lam, MAX_ITR, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(tk.matvec(A_q, ev), tk.matvec_plain(A_q.float(), ev))


@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_multiround_sym_plain_of_a_2_byte_a_is_bitwise_its_f32_values(dt, sym):
    tdt = DTYPES[dt][0]
    A = tfx.hilbert_matrix(384)
    if not sym:
        A = A * (1 + 0.25 * torch.from_numpy(np.random.default_rng(3).random((384, 384),
                                                                            np.float32)))
    A_q = A.to(tdt)
    ev = torch.ones(384)
    kw = dict(chunk=6, eps=EPS, init=True, sym=sym)
    got = tk.multiround_sym(A_q, ev, ev, 0.0, MAX_ITR, **kw)
    want = tk.multiround_sym_plain(A_q.float(), ev, ev, 0.0, MAX_ITR, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_the_plain_versions_cast_a_2_byte_a_up_a_block_at_a_time(monkeypatch):
    """Past ``PLAIN_BLOCK_BYTES`` the f32 copy is made a block at a time;
    the values are those of one product (per row, per tile)."""
    A_q = tfx.hilbert_matrix(512).to(torch.bfloat16)
    x = torch.rand(512, generator=torch.Generator().manual_seed(5)) + 0.5
    whole = tk.matvec_plain(A_q, x)
    tiled = tk.tiled_matvec_plain(A_q, x, 128, True)
    seen = []
    real = tk._up

    def spy(t):
        seen.append(t.numel() * 4)
        return real(t)

    monkeypatch.setattr(tk, "PLAIN_BLOCK_BYTES", 64 * 1024)
    monkeypatch.setattr(tk, "_up", spy)
    torch.testing.assert_close(tk.matvec_plain(A_q, x), whole, rtol=1e-6, atol=0)
    torch.testing.assert_close(tk.tiled_matvec_plain(A_q, x, 128, True), tiled, rtol=1e-6, atol=0)
    assert seen and max(seen) <= 64 * 1024


@pytest.mark.parametrize(
    "args, match",
    [
        ((torch.ones(4, 4, dtype=torch.bfloat16), torch.ones(4, dtype=torch.bfloat16)), "x must"),
        ((torch.ones(4, 4, dtype=torch.float64), torch.ones(4)), "float32 or bfloat16 or float16"),
        ((torch.ones(4, 4, dtype=torch.int16), torch.ones(4)), "A must"),
    ],
)
def test_the_wrappers_take_a_2_byte_a_with_f32_vectors_only(args, match):
    with pytest.raises(ValueError, match=match):
        tk.matvec(*args)


def test_multiround_wrappers_reject_a_2_byte_ev():
    A_q = tfx.hilbert_matrix(128).to(torch.bfloat16)
    ev = torch.ones(128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="ev must be float32"):
        tk.multiround(A_q, ev, ev, 0.0, MAX_ITR, chunk=2, eps=EPS)
    with pytest.raises(ValueError, match="ev must be float32"):
        tk.multiround_sym(A_q, ev, ev, 0.0, MAX_ITR, chunk=2, eps=EPS)


@pytest.mark.parametrize("dtype, ok, bad", [(torch.float32, 4, 2), (torch.bfloat16, 4, 2),
                                            (torch.float16, 8, 1)])
def test_the_alignment_rule_is_four_elements(dtype, ok, bad):
    buf = torch.zeros(64 + 8, dtype=dtype)
    tk._check_aligned(8, buf[ok:ok + 64])  # 4 * itemsize bytes: 16 for f32, 8 for 2 bytes
    with pytest.raises(ValueError, match="aligned"):
        tk._check_aligned(8, buf[bad:bad + 64])
    tk._check_aligned(7, buf[bad:bad + 63])  # the scalar path takes any address


# --- the launch plans for a 2-byte A (an H100's limits patched in) -----------

H100 = device.CudaLimits(sms=132, smem_per_block_optin=232448, l2_bytes=52428800)


@pytest.fixture
def h100(monkeypatch):
    monkeypatch.setattr(device, "cuda_limits", lambda dev: H100)
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n, want", [
    # rows stream, so the ring takes 1 stage a warp: 32 * (1024 + 8) = 33024
    # bytes; 232448 - 1024 - 32768 - 33024 = 165632 bytes beside ev and the
    # ring hold ten 16 KiB rows (twelve without the ring); 3/8 of the L2
    # (19660800 bytes) over 132 blocks of 16 KiB rows keep nine
    (8192, (132, 10, 9, 1)),
    # 215040 bytes hold 26 rows of 8 KiB; a block has 32, and the other 664
    # rows (5.4 MB) are under 3/4 of the L2: its 5/8 keep the last six, so
    # no row streams from device memory and there is no ring
    (4096, (132, 26, 6, 0)),
    # 54 rows fit: 64 blocks (a row a warp) hold all 2048, and nothing streams
    (2048, (64, 32, 0, 0)),
    # ev alone fills the block: no room for a ring; one 113 KiB row a block
    # fits the L2 band
    (57856, (132, 0, 1, 0)),
])
def test_the_stripes_plan_for_a_2_byte_a(h100, n, want):
    assert tuple(device.multiround_plan(n, h100, itemsize=2)) == want
    assert device.multiround_smem_bytes(n, want[1], 2, want[3]) == (
        4 * n + 2 * n * want[1] + device.stripes_ring_bytes(want[3], 2))
    assert device.multiround_fits(n, h100)  # ev stays f32: the n limit is the same


@pytest.mark.parametrize("n, sym, want, want_f32", [
    # four 32 KiB tiles beside a 32 KiB ev and the ring (128 + 2 * 16 *
    # (2048 + 8) = 65920 bytes: two stages a warp), 132 blocks; six without
    # the ring.  f32: three 64 KiB tiles, no ring
    (8192, True, 528, 396),
    (8192, False, 528, 396),
    (4096, True, 496, 396),  # all 32 * 31 / 2 off-diagonal tiles
    (4096, False, 528, 396),
    (2048, True, 120, 120),
])
def test_the_auto_cache_doubles_for_2_byte_tiles(h100, n, sym, want, want_f32):
    assert device.sym_auto_cache_tiles(n, 128, h100, sym, itemsize=2) == want
    f32 = device.sym_auto_cache_tiles(n, 128, h100, sym)
    assert f32 == want_f32
    assert device.sym_smem_bytes(n, 128, 6, 2) == 4 * n + 6 * 32768
    assert device.multiround_sym_fits(n, 128, h100, 6, 2)
    assert not device.multiround_sym_fits(n, 128, h100, 7, 2)
    ring = device.sym_ring(n, 128, h100, 2)
    assert ring == 2 and device.multiround_sym_fits(n, 128, h100, 4, 2, ring)
    assert not device.multiround_sym_fits(n, 128, h100, 5, 2, ring)


def test_the_l2_tiles_and_the_split_for_2_byte_tiles(h100):
    # at 8192², cache 528: 2080 - 528 = 1552 tiles of 32 KiB (50.9 MB) stream,
    # more than 3/4 of the L2, so 3/8 of it keeps 600 of them (as it did of
    # the 1288 that streamed beside a cache of 792)
    assert device.sym_l2_tiles(128, h100, 1552, itemsize=2) == 600
    assert device.sym_l2_tiles(128, h100, 1288, itemsize=2) == 600
    assert device.sym_l2_tiles(128, h100, 1684) == 300  # the f32 plan
    # 4096², cache 496: 32 diagonal tiles (1 MB) stream, all kept
    assert device.sym_l2_tiles(128, h100, 32, itemsize=2) == 32
    # the split depends on (n, tile, card) only: no itemsize to give
    assert device.sym_split(8192, 128, h100) == 1 and device.sym_split(4096, 128, h100) == 4


def test_the_api_sizes_the_auto_cache_by_the_storage_type(h100):
    for storage, want in ((None, 396), (torch.bfloat16, 528), (torch.float16, 528)):
        cfg = evt.SolverConfig(symmetric=True, storage_dtype=storage)
        r = api.route(cfg, 8192, h100)
        assert r.backend == "multiround" and r.kernel == "triangle"
        assert r.cache_tiles == want and r.storage is (storage or torch.float32)
    # dense auto with storage: the stripes kernel up to 57856, the matvec kernel loop past it
    cfg = evt.SolverConfig(storage_dtype=torch.bfloat16)
    assert api.resolve_backend(cfg, 57856, h100) == "multiround"
    assert api.resolve_backend(cfg, 65536, h100) == "matvec_pallas"
    r = api.route(cfg, 65536, h100)
    assert r.kernel == "matvec" and r.storage is torch.bfloat16


# --- carrying a 2-byte matrix across from the JAX package ----------------------


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_convert_carries_a_2_byte_matrix_bit_for_bit(dt):
    from eigen_value_tpu_torch import convert

    tdt, jdt = DTYPES[dt]
    arr = np.asarray(jfx.hilbert_matrix(300).astype(jdt))
    got = convert.matrix_from_numpy(arr, dtype=tdt)
    want = tfx.hilbert_matrix(300).to(tdt)  # torch's f32 -> 2-byte cast: JAX's bits
    assert got.dtype == tdt and torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert torch.equal(convert.matrix_from_numpy(arr), want.float())  # the exact upcast
    by_name = convert.matrix_from_numpy(arr, dtype={"bf16": "bfloat16", "f16": "float16"}[dt])
    assert torch.equal(by_name.view(torch.int16), want.view(torch.int16))
    # the fixture built in the 2-byte type is JAX's, bit for bit
    built = np.asarray(jfx.hilbert_matrix(300, dtype=jdt)).view(np.int16)
    np.testing.assert_array_equal(tfx.hilbert_matrix(300, dtype=tdt).view(torch.int16).numpy(),
                                  built)
