"""The last two variants of the triangle kernel, against the JAX package.

``formulation="mixed"`` puts the last ``m`` resident tiles of the tile
split on the tensor cores in 3xTF32 and keeps every other tile in the "vpu"
form; ``fill_mode="pipelined"`` fills the resident tiles behind round 0
and waits for each at its first use.  Here, on the CPU, the port runs the
plain version (``kernels.multiround_sym_plain``: the mixed tiles through
the plain 3xTF32 product, the others through the f32 one; the fill changes
nothing) and JAX runs ``solve_multiround(..., interpret=True)`` on the same
inputs (Hilbert fixtures, bitwise equal in both packages, or numpy matrices
from a seed), both at tile 128 and the same ``cache_tiles``, as the JAX
tests of these variants do (tests/test_multiround_sym.py).  The kernels
themselves are held on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from eigen_value_tpu import fixtures as jfx  # noqa: E402
from eigen_value_tpu.ops.pallas import kernels as jk  # noqa: E402
from eigen_value_tpu.ops.solver_matvec import solve_matvec as jax_solve_matvec  # noqa: E402
from eigen_value_tpu.ops.solver_matvec import solve_multiround as jax_multiround  # noqa: E402
from eigen_value_tpu_torch import device  # noqa: E402
from eigen_value_tpu_torch import fixtures as tfx  # noqa: E402
from eigen_value_tpu_torch.ops.cuda import kernels as tk  # noqa: E402
from eigen_value_tpu_torch.ops.solver_matvec import solve_multiround  # noqa: E402

EPS, MAX_ITR = 1e-3, 1000
H100 = device.CudaLimits(sms=132, smem_per_block_optin=232448, l2_bytes=52428800)
MODES = {"triangle": dict(symmetric=True, cache_tiles=4),
         "dense tiled": dict(cache_tiles=5, chunk=5)}


def _random(n=384, seed=13):
    """The JAX test's dense matrix: uniform entries above 0.1 (numpy)."""
    return np.random.default_rng(seed).random((n, n), np.float32) + np.float32(0.1)


def _matrix(mode):
    """Hilbert 512² for the triangle, the JAX test's 384² random matrix for
    the dense tiled mode (numpy)."""
    return np.array(jfx.hilbert_matrix(512)) if mode == "triangle" else _random()


def _jax(a, **kw):
    return jax_multiround(jnp.asarray(a), EPS, MAX_ITR, interpret=True, tile=128, **kw)


def _port(a, **kw):
    return solve_multiround(torch.as_tensor(a), EPS, MAX_ITR, tile=128, **kw)


def _agree(got, want):
    """Rounds exact, λ within rel 1e-5, the eigenvector within the JAX
    parity tests' rtol 1e-4 (another summation order)."""
    assert int(got.rounds) == int(want.rounds)
    assert bool(got.converged) == bool(want.converged)
    assert float(got.eigenvalue) == pytest.approx(float(want.eigenvalue), rel=1e-5)
    np.testing.assert_allclose(got.eigenvector.numpy(), np.asarray(want.eigenvector), rtol=1e-4)


def _same(got, want):
    assert int(got.rounds) == int(want.rounds)
    assert bool(got.converged) == bool(want.converged)
    assert torch.equal(got.eigenvalue, want.eigenvalue)
    assert torch.equal(got.eigenvector, want.eigenvector)


# --- formulation="mixed" -----------------------------------------------------


@pytest.mark.parametrize("mxu_tiles", [None, 0, 2, 4])
def test_mixed_triangle_matches_jax(mxu_tiles):
    kw = dict(symmetric=True, cache_tiles=4, formulation="mixed", mxu_tiles=mxu_tiles)
    got = _port(tfx.hilbert_matrix(512), **kw)
    want = _jax(jfx.hilbert_matrix(512), chunk=18, **kw)
    assert int(got.rounds) == tfx.HILBERT_ROUNDS[512]
    _agree(got, want)


@pytest.mark.parametrize("mxu_tiles", [None, 0, 2, 5])
def test_mixed_dense_tiled_matches_jax(mxu_tiles):
    a = _random()
    kw = dict(chunk=5, cache_tiles=5, formulation="mixed", mxu_tiles=mxu_tiles)
    got = _port(a, **kw)
    _agree(got, _jax(a, **kw))
    dense = jax_solve_matvec(jnp.asarray(a), EPS, MAX_ITR)
    assert int(got.rounds) == int(dense.rounds)
    assert float(got.eigenvalue) == pytest.approx(float(dense.eigenvalue), rel=1e-5)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mixed_with_no_tensor_core_tile_is_vpu_bit_for_bit(mode):
    a = _matrix(mode)
    _same(_port(a, formulation="mixed", mxu_tiles=0, **MODES[mode]), _port(a, **MODES[mode]))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mixed_takes_the_tensor_core_product_on_its_tiles(mode):
    """Every resident tile in 3xTF32 moves the result off "vpu" (another
    product, within rounding), and a share of them gives bits of its own."""
    a = _matrix(mode)
    kw = dict(MODES[mode], formulation="mixed")
    vpu, some, every = (_port(a, mxu_tiles=m, **kw) for m in (0, 2, 1000))
    assert not torch.equal(every.eigenvector, vpu.eigenvector)
    assert not torch.equal(some.eigenvector, every.eigenvector)
    for res in (some, every):
        assert int(res.rounds) == int(vpu.rounds)
        torch.testing.assert_close(res.eigenvector, vpu.eigenvector, rtol=1e-5, atol=0)


@pytest.mark.parametrize("chunk", [1, 2, 5])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_mixed_chunking_is_bit_invisible(mode, chunk):
    a = _matrix(mode)
    kw = dict(MODES[mode], formulation="mixed", mxu_tiles=2)
    _same(_port(a, **dict(kw, chunk=chunk)), _port(a, **dict(kw, chunk=40)))


def test_mixed_triangle_never_reads_below_the_block_diagonal():
    a = np.array(jfx.hilbert_matrix(512))
    blk = np.arange(512) // 128
    bad = np.where(blk[:, None] > blk[None, :], np.float32(7.25), a)
    kw = dict(symmetric=True, cache_tiles=6, formulation="mixed")
    _same(_port(bad, **kw), _port(a, **kw))


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_mixed_storage_is_the_f32_solve_of_its_values(mode, dt):
    A_q = torch.as_tensor(_matrix(mode)).to(dt)
    for fill in ("prologue", "pipelined"):
        kw = dict(MODES[mode], formulation="mixed", mxu_tiles=2, fill_mode=fill)
        got = _port(A_q, **kw)
        _same(got, _port(A_q.float(), **kw))
        _same(got, solve_multiround(A_q.float(), EPS, MAX_ITR, tile=128, storage_dtype=None,
                                    **kw))
    want = _jax(A_q.float().numpy(), formulation="mixed", mxu_tiles=2,
                **dict({"chunk": 18}, **MODES[mode]))
    _agree(_port(A_q, formulation="mixed", mxu_tiles=2, **MODES[mode]), want)


def test_the_wrapper_runs_the_plain_version_on_the_cpu():
    A, ev, z = tfx.hilbert_matrix(512), torch.ones(512), torch.zeros(())
    for kw in (dict(formulation="mixed", cache_tiles=4), dict(formulation="mixed",
                                                              cache_tiles=4, mxu_tiles=1),
               dict(cache_tiles=4, fill_mode="pipelined")):
        for init in (True, False):
            got = tk.multiround_sym(A, ev, ev, z, 50, chunk=4, eps=EPS, init=init, tile=128, **kw)
            want = tk.multiround_sym_plain(A, ev, ev, z, 50, chunk=4, eps=EPS, init=init,
                                           tile=128, **kw)
            assert all(torch.equal(g, w) for g, w in zip(got, want))


# --- which tiles are on the tensor cores: JAX's rule -------------------------


class _Captured(Exception):
    pass


def _jax_kernel_call(monkeypatch, n, bt, cache_tiles, sym, **kw):
    """The keywords and operands the JAX ``multiround_sym`` hands to
    ``pallas_call`` (the call is stopped there)."""

    def capture(kernel, **_):
        def run(*operands):
            raise _Captured(kernel.keywords, operands)
        return run

    monkeypatch.setattr(pl, "pallas_call", capture)
    A = jnp.ones((n, n), jnp.float32)
    ev = jnp.ones(n, jnp.float32)
    with pytest.raises(_Captured) as got:
        jk.multiround_sym.__wrapped__(A, ev, ev, 0.0, 10, chunk=2, eps=EPS, tile=bt,
                                      cache_tiles=cache_tiles, sym=sym, **kw)
    return got.value.args


def _jax_mxu_tiles(monkeypatch, n, bt, cache_tiles, sym, mxu_tiles):
    """The tiles the JAX kernel puts on its matrix unit: its per-step MXU
    slot array (the sixth operand) lists their cached indices."""
    keywords, operands = _jax_kernel_call(monkeypatch, n, bt, cache_tiles, sym,
                                          formulation="mixed", mxu_tiles=mxu_tiles)
    slots = np.asarray(operands[5])
    return [keywords["cached"][s] for s in sorted(slots[slots >= 0])]


@pytest.mark.parametrize("n, bt, cache_tiles, sym, mxu_tiles", [
    (256, 128, 1, True, None), (512, 128, 4, True, None), (512, 128, 6, True, None),
    (512, 128, 3, True, 2), (512, 128, 6, True, 100), (1024, 128, 20, True, None),
    (1024, 128, 28, True, None), (1024, 256, 5, True, None), (2048, 128, 120, True, None),
    (2048, 128, 37, True, 11), (384, 128, 5, False, None), (384, 128, 8, False, None),
    (384, 128, 100, False, 3), (512, 128, 15, False, None), (1024, 128, 63, False, None),
    (1024, 256, 9, False, 0),
])
def test_the_tensor_core_tiles_are_jaxs(monkeypatch, n, bt, cache_tiles, sym, mxu_tiles):
    m = tk.mxu_share(n, bt, cache_tiles, sym, mxu_tiles)
    port = list(tk._tile_split(n, bt, cache_tiles, sym)[1][len(
        tk._tile_split(n, bt, cache_tiles, sym)[1]) - m:])
    assert port == _jax_mxu_tiles(monkeypatch, n, bt, cache_tiles, sym, mxu_tiles)


@pytest.mark.parametrize("n, bt, cache_tiles, sym, mxu_tiles", [
    (512, 128, 6, True, None), (512, 128, 6, True, 2), (1024, 128, 28, True, None),
    (2048, 128, 120, True, None), (2048, 128, 108, True, None), (2048, 128, 109, True, None),
    (2048, 128, 120, True, 60), (384, 128, 8, False, None), (384, 128, 6, False, 3),
    (1024, 128, 40, False, None), (8192, 128, 396, True, None),
])
def test_the_pipelined_depth_is_jaxs(monkeypatch, n, bt, cache_tiles, sym, mxu_tiles):
    """The JAX kernel's in-flight bound, 2 · (slots + mxu_slots) from the
    keywords it hands to ``pallas_call``, against the port's rule."""
    mixed = mxu_tiles is not None
    kw = dict(formulation="mixed", mxu_tiles=mxu_tiles) if mixed else {}
    keywords, _ = _jax_kernel_call(monkeypatch, n, bt, cache_tiles, sym, **kw)
    m = tk.mxu_share(n, bt, cache_tiles, sym, mxu_tiles) if mixed else 0
    assert tk.pipelined_depth(n, bt, cache_tiles, sym, m) == \
        2 * (keywords["slots"] + keywords["mxu_slots"])


def test_the_default_share_at_8192():
    # g² = 4096 terms a round, balanced at 1 + MXU_TERM_COST: round(455.1)
    assert tk.MXU_TERM_COST == jk.MXU_TERM_COST == 3.5
    assert tk.mxu_share(8192, 128, 396, True) == 396  # the f32 auto cache, all of it
    assert tk.mxu_share(8192, 128, 528, True) == 455  # of the bf16 auto cache
    assert tk.mxu_share(8192, 128, 396, False) == 396


# --- fill_mode="pipelined" ---------------------------------------------------


@pytest.mark.parametrize("formulation", ["vpu", "dot", "mixed"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_pipelined_fill_is_the_prologue_fill_bit_for_bit(mode, formulation):
    a = _matrix(mode)
    kw = dict(MODES[mode], formulation=formulation)
    _same(_port(a, fill_mode="pipelined", **kw), _port(a, **kw))


@pytest.mark.parametrize("kw", [dict(), dict(formulation="mixed", mxu_tiles=2),
                                dict(formulation="dot")])
def test_pipelined_fill_matches_jax(kw):
    kw = dict(symmetric=True, cache_tiles=6, fill_mode="pipelined", **kw)
    got = _port(tfx.hilbert_matrix(512), **kw)
    assert int(got.rounds) == tfx.HILBERT_ROUNDS[512]
    _agree(got, _jax(jfx.hilbert_matrix(512), chunk=18, **kw))


def test_pipelined_fill_counts_a_barrier_a_slot(monkeypatch):
    """A barrier a tensor copy: one a slot where a tile is one work item
    (8192²), one a row span where a tile is cut into ``split`` of them
    (4096²: four)."""
    monkeypatch.setattr(device, "cuda_limits", lambda dev: H100)
    card = torch.device("cuda", 0)
    assert device.sym_smem_bytes(8192, 128, 3, 4, 0, pipelined=True) == \
        device.sym_smem_bytes(8192, 128, 3, 4, 0) + 24
    assert device.sym_split(8192, 128, card) == 1 and device.sym_split(4096, 128, card) == 4
    assert device.sym_smem_bytes(4096, 128, 3, 4, 0, pipelined=4) == \
        device.sym_smem_bytes(4096, 128, 3, 4, 0) + 3 * 4 * 8
    for n in (4096, 8192):  # the auto caches keep their size with the barriers
        for itemsize in (4, 2):
            assert device.sym_auto_cache_tiles(n, 128, card, itemsize=itemsize, pipelined=True) \
                == device.sym_auto_cache_tiles(n, 128, card, itemsize=itemsize)
    # the auto caches at 8192² keep their size
    for itemsize, cache in ((4, 396), (2, 528)):
        for pipelined in (False, True):
            assert device.sym_auto_cache_tiles(8192, 128, card, itemsize=itemsize,
                                               pipelined=pipelined) == cache
    # at 512², seven 32 KiB bf16 tiles fill a block to the byte beside ev:
    # no room is left for their barriers
    assert H100.smem_per_block_optin - 1024 - 4 * 512 == 7 * 128 * 128 * 2
    assert device.multiround_sym_fits(512, 128, card, 7, 2)
    assert not device.multiround_sym_fits(512, 128, card, 7, 2, pipelined=True)
    assert device.multiround_sym_fits(512, 128, card, 6, 2, pipelined=True)


# --- the errors: raised by both packages on the same condition --------------


@pytest.mark.parametrize("n, kw, match", [
    (256, dict(symmetric=True, cache_tiles=2, mxu_tiles=1), "only meaningful"),
    (256, dict(symmetric=True, formulation="mixed"), "cache_tiles > 0"),
    (256, dict(symmetric=True, formulation="mixed", cache_tiles=-3), "cache_tiles > 0"),
    (128, dict(symmetric=True, formulation="mixed", cache_tiles=1), "cache_tiles > 0"),
    (256, dict(symmetric=True, fill_mode="pipelined"), "cache_tiles > 0"),
    (128, dict(symmetric=True, cache_tiles=1, fill_mode="pipelined"), "cache_tiles > 0"),
    (256, dict(symmetric=True, cache_tiles=2, fill_mode="bogus"), "unknown fill_mode"),
    (384, dict(cache_tiles=8, chunk=5, fill_mode="pipelined"), "in flight"),
    (384, dict(cache_tiles=8, chunk=5, fill_mode="pipelined", formulation="mixed",
               mxu_tiles=4), "in flight"),
    (384, dict(chunk=5, formulation="mixed"), "cache_tiles > 0"),
    (256, dict(mxu_tiles=1), "mxu_tiles"),
    (256, dict(fill_mode="pipelined"), "fill_mode"),
])
def test_both_packages_raise(n, kw, match):
    a = _random(n)
    with pytest.raises(ValueError, match=match):
        _port(a, **kw) if "symmetric" in kw or "cache_tiles" in kw else \
            solve_multiround(torch.as_tensor(a), EPS, MAX_ITR, **kw)
    with pytest.raises(ValueError, match=match):
        _jax(a, **kw) if "symmetric" in kw or "cache_tiles" in kw else \
            jax_multiround(jnp.asarray(a), EPS, MAX_ITR, interpret=True, **kw)


@pytest.mark.parametrize("kw, match", [
    (dict(cache_tiles=2, mxu_tiles=1), "only meaningful"),
    (dict(formulation="mixed"), "cache_tiles > 0"),
    (dict(fill_mode="pipelined"), "cache_tiles > 0"),
    (dict(cache_tiles=8, sym=False, fill_mode="pipelined"), "in flight"),
])
def test_the_kernel_wrapper_and_plain_version_raise_as_jax(kw, match):
    a = torch.as_tensor(_random())
    ev = torch.ones(384)
    for fn in (tk.multiround_sym, tk.multiround_sym_plain):
        with pytest.raises(ValueError, match=match):
            fn(a, ev, ev, 0.0, 10, chunk=2, eps=EPS, tile=128, **kw)


def _kernel_phases():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "kernel_phases.py"
    spec = importlib.util.spec_from_file_location("kernel_phases", path)
    kp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kp)
    return kp


def test_round_zero_split_reads_the_fill():
    """kernel_phases.py --fill: round 0's split and the span from its start
    to the launch's last stamp, over two blocks."""
    kp = _kernel_phases()
    grid, names = 2, ("prologue", "stream", "barrier_1", "reduce", "barrier_2")
    t = torch.zeros(kp.STAMP_ROUNDS, kp.STAMP_PHASES, grid, dtype=torch.int64)
    for r in range(3):
        for b in range(grid):
            start = 1_000_000 + 100_000 * r + 1_000 * b
            stream = 40_000 if r == 0 else 30_000  # round 0 waits for its copies
            t[r, :, b] = torch.tensor([start, start + 1_000, start + 1_000 + stream,
                                       start + 3_000 + stream, start + 5_000 + stream,
                                       start + 6_000 + stream])
    t[3, 0, :] = torch.tensor([1_300_000, 1_301_000])  # the round that stopped
    got = kp.split(t.reshape(-1), grid, names, rounds=[0])
    assert got["rounds_read"] == 1 and got["stream"] == pytest.approx(40.0)
    assert got["span"] == pytest.approx(301.0)
    rest = kp.split(t.reshape(-1), grid, names)
    assert rest["stream"] == pytest.approx(30.0) and "span" not in rest


def test_fill_stamps_give_the_fills_own_time():
    """kernel_phases.py --fill's ``fill_us``: the two fill stamps a block
    after the rounds' (csrc/multiround_sym.cu fill_stamp), the mean and the
    slowest block; nothing where a kernel wrote none (an older checkout)."""
    kp = _kernel_phases()
    grid = 3
    words = (kp.STAMP_ROUNDS * kp.STAMP_PHASES + kp.FILL_STAMPS) * grid
    t = torch.zeros(words, dtype=torch.int64)
    assert kp.fill_split(t, grid) == {}
    base = kp.STAMP_ROUNDS * kp.STAMP_PHASES * grid
    t[base:base + grid] = torch.tensor([1_000_000, 1_000_500, 1_001_000])
    t[base + grid:base + 2 * grid] = torch.tensor([1_007_000, 1_009_500, 1_009_000])
    got = kp.fill_split(t, grid)
    assert got["fill_us"] == pytest.approx(8.0) and got["fill_us_max"] == pytest.approx(9.0)
    t[0] = 5  # the rounds' stamps do not enter it
    assert kp.fill_split(t, grid) == got
