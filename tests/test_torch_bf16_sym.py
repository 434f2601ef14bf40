"""A held in bfloat16 on the triangle path, against the benchmark's plain
float64 reference (``evbench/reference.py``), with no JAX.

The matrices are the benchmark's own (``evbench.pool.hilbert_scaled``,
rounded once to bfloat16), solved through ``max_eigenvalue`` with
``SolverConfig(backend="multiround", symmetric=True,
storage_dtype=torch.bfloat16)``: on the CPU the triangle wrapper's plain
version, ``kernels.multiround_sym_plain``, over the stored tiles widened
exactly to float32.  The triangle plan's HBM bytes a round are checked
against an H100's limits, patched in; nothing is launched.
"""

import pytest

torch = pytest.importorskip("torch")

import eigen_value_tpu_torch as evt  # noqa: E402
from eigen_value_tpu_torch import api, device  # noqa: E402
from eigen_value_tpu_torch.ops import solver_matvec  # noqa: E402
from eigen_value_tpu_torch.ops.cuda import kernels as tk  # noqa: E402
from eigen_value_tpu_torch.utils.profiling import recording  # noqa: E402
from evbench import compare, pool, reference  # noqa: E402

EPS, MAX_ITR = 1e-3, 1000
CONFIG = evt.SolverConfig(backend="multiround", symmetric=True, storage_dtype=torch.bfloat16,
                          eps=EPS, max_itr=MAX_ITR)
#: The relative eigenpair error (``compare.numbers``' ``pair_rel``) allowed
#: against the float64 reference.  The solve multiplies the exactly widened
#: bfloat16 entries in float32, so it differs from the reference by float32
#: rounding alone: at most 9.0e-7 on 40 matrices of 384² and 1024² (5 seeds
#: of 4 each).  The same matrices with A held in fp8 (the ``fp8`` control)
#: read at least 4.8e-3, 480 times the limit.
TOL = 1e-5
#: How near a stop check may come to eps, as a share of it, for the rounds
#: to be compared exactly: at 384² and 1024² the checks lie at least 20%
#: and 31% from eps (768² has checks within 5% of it).
MARGIN = 0.10
H100 = device.CudaLimits(sms=132, smem_per_block_optin=232448, l2_bytes=52428800)


def _pool(n, seed, size=2):
    cfg = dict(matrix="hilbert_scaled", n=n, dtype="float32", storage_dtype="bfloat16",
               scale=0.01)
    mats = pool.make_pool(cfg, size, seed, torch.device("cpu"))
    assert all(A.dtype == torch.bfloat16 for A in mats)
    return mats


def _numbers(A, got):
    """``compare.numbers`` of one answer against the reference on A, and
    the reference's solution."""
    ref = reference.solve(A, EPS, MAX_ITR)
    ans = compare.Answer(0, float(got.eigenvalue), int(got.rounds), bool(got.converged),
                         got.eigenvector)
    return compare.numbers([ans], [ans], [ref]), ref


@pytest.mark.parametrize("n", [384, 1024])
@pytest.mark.parametrize("seed", [7, 2**33 + 1])
def test_bf16_triangle_matches_the_reference(n, seed):
    for A in _pool(n, seed):
        got = evt.max_eigenvalue(A, CONFIG)
        out, ref = _numbers(A, got)
        assert ref.stop_margin >= MARGIN and ref.converged
        assert out["rounds_off"] == 0 and out["converged_off"] == 0
        assert out["pair_rel"] <= TOL, out


@pytest.mark.parametrize("n", [384, 1024])
def test_the_fp8_control_fails_the_tolerance(n):
    """A held in fp8 (a scale a row) in the program's place: the tolerance
    parts it from the program."""
    for A in _pool(n, 2**31 + 11):
        ref = reference.solve(A, EPS, MAX_ITR)
        c = reference.solve_control(A, "fp8", EPS, MAX_ITR)
        ans = compare.Answer(0, c.eigenvalue, c.rounds, c.converged, c.eigenvector)
        assert compare.numbers([ans], [ans], [ref])["pair_rel"] > 100 * TOL


def test_a_prequantized_matrix_reaches_the_solver_as_it_is(monkeypatch):
    """No float32 copy: ``_as_matrix`` returns the caller's bfloat16 tensor,
    and the triangle route's solver receives that very tensor."""
    (A,) = _pool(384, 5, size=1)
    assert api._as_matrix(A, CONFIG) is A
    seen = []
    real = solver_matvec.solve_multiround

    def spy(mat, *args, **kw):
        seen.append((mat, kw.get("symmetric"), kw.get("storage_dtype")))
        return real(mat, *args, **kw)

    monkeypatch.setattr(solver_matvec, "solve_multiround", spy)
    launched = []
    launch = tk.multiround_sym

    def launch_spy(*args, **kw):
        launched.append(launch(*args, **kw))
        return launched[-1]

    monkeypatch.setattr(tk, "multiround_sym", launch_spy)
    with recording() as spans:
        got = evt.max_eigenvalue(A, CONFIG)
    assert len(seen) == 1 and seen[0][0] is A and seen[0][1:] == (True, torch.bfloat16)
    # the triangle wrapper wrote the result: the solve returns its tensors
    ev, _, _, lam, rounds, converged = launched[-1]
    assert got.eigenvector is ev and got.eigenvalue is lam
    assert got.rounds is rounds and got.converged is converged
    assert "solver.finish" not in {s.name for s in spans}


@pytest.fixture
def fake_h100(monkeypatch):
    """A CUDA device whose limits are an H100's; nothing may launch on it."""
    monkeypatch.setattr(device, "cuda_limits", lambda dev: H100)
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype, cache, streamed, l2, want", [
    # 2080 tiles of 128², 528 resident, 600 in L2: 952 of 32 KiB
    (torch.bfloat16, 528, 1552, 600, 31_195_136),
    # 396 resident, 300 in L2: 1384 of 64 KiB
    (torch.float32, 396, 1684, 300, 90_701_824),
])
def test_the_plans_hbm_bytes_a_round_at_8192(fake_h100, dtype, cache, streamed, l2, want):
    auto = device.sym_auto_cache_tiles(8192, 128, fake_h100, itemsize=dtype.itemsize)
    assert auto == cache
    assert len(tk._tile_split(8192, 128, auto, True)[0]) == streamed
    assert device.sym_l2_tiles(128, fake_h100, streamed, itemsize=dtype.itemsize) == l2
    got = tk.sym_hbm_bytes(fake_h100, 8192, 128, auto, True, dtype)
    assert got == want == (streamed - l2) * 128 * 128 * dtype.itemsize


def test_the_hbm_bytes_follow_the_cache_and_the_declaration(fake_h100):
    # nothing resident: every tile streams, 600 bf16 tiles kept in L2
    assert tk.sym_hbm_bytes(fake_h100, 8192, 128, 0, True, torch.bfloat16) == (2080 - 600) * 32768
    # a small matrix streams nothing past the L2: 4096², bf16, 528 tiles of 32 KiB
    assert tk.sym_hbm_bytes(fake_h100, 4096, 128, 0, True, torch.bfloat16) == 0
    # dense tiled mode reads all g² tiles
    dense = tk.sym_hbm_bytes(fake_h100, 8192, 128, 396, False)
    assert dense == (4096 - 396 - 300) * 65536


def test_a_plain_solve_keeps_no_plan():
    """The plan is the card's: a CPU solve leaves the wrapper's kept plan
    as it was."""
    before = tk.multiround_sym.plan
    evt.max_eigenvalue(_pool(384, 9, size=1)[0], CONFIG)
    assert tk.multiround_sym.plan is before
