"""The dot formulation of the two persistent kernels, against the JAX package.

JAX's ``multiround`` / ``multiround_sym`` with ``formulation="dot"`` contract
each row stripe or tile on the TPU's matrix unit at ``Precision.HIGHEST``;
the port runs the same rounds on Hopper's tensor cores in 3xTF32 (each f32
value split into two TF32 parts, the small·small product dropped).  Here, on
the CPU, the port runs the plain version of that product
(``kernels.matvec_tf32_plain`` over ``kernels.tf32_split``) and JAX runs its
kernels in interpret mode on the same inputs (Hilbert fixtures, bitwise
equal in both packages, or numpy matrices from a seed).  The CPU carries the
proof that dropping the small·small term keeps the Hilbert round table; the
kernels themselves are held on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import math
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from eigen_value_tpu import fixtures as jfx  # noqa: E402
from eigen_value_tpu.ops.solver_matvec import solve_multiround as jax_multiround  # noqa: E402
from eigen_value_tpu_torch import fixtures as tfx  # noqa: E402
from eigen_value_tpu_torch.ops.cuda import kernels as tk  # noqa: E402
from eigen_value_tpu_torch.ops.solver_matvec import solve_multiround  # noqa: E402

EPS, MAX_ITR = 1e-3, 1000
MODES = {"stripes": {}, "triangle": dict(symmetric=True, tile=128),
         "dense tiled": dict(tile=128, cache_tiles=4)}
STORAGE = {"bf16": torch.bfloat16, "f16": torch.float16}


def _same(got, want):
    assert int(got.rounds) == int(want.rounds)
    assert bool(got.converged) == bool(want.converged)
    assert torch.equal(got.eigenvalue, want.eigenvalue)
    assert torch.equal(got.eigenvector, want.eigenvector)


def _bits(x: float) -> int:
    return struct.unpack("<I", struct.pack("<f", x))[0]


def _rna_reference(x: float) -> float:
    """TF32 rounding of a finite f32 value, from its value: to 11 significant
    bits (10 below the subnormal boundary's exponent), to nearest, ties away
    from zero.  Exact in Python's doubles."""
    if x == 0.0:
        return x
    _, e = math.frexp(x)
    quantum = 2.0 ** (max(e, -125) - 11)
    q = abs(x) / quantum
    return math.copysign(math.floor(q + 0.5) * quantum, x)


# hand-picked: exact values, ties (away from zero), either side of a tie,
# negatives, zeros, subnormals, the smallest normal, and values exact in bf16
# and f16 (whose small part is 0)
HAND_PICKED = {
    "one": 1.0,
    "tie up": 1 + 2**-11,
    "negative tie": -(1 + 2**-11),
    "odd tie": 1 + 3 * 2**-11,
    "below a tie": 1 + 2**-11 - 2**-23,
    "above a tie": 1 + 2**-11 + 2**-23,
    "negative below a tie": -(1 + 2**-11 - 2**-23),
    "zero": 0.0,
    "negative zero": -0.0,
    "third": 1 / 3,
    "hilbert entry 1/8191": 1 / 8191,
    "largest subnormal": struct.unpack("<f", struct.pack("<I", 0x007FFFFF))[0],
    "subnormal tie": struct.unpack("<f", struct.pack("<I", 0x00001000))[0],
    "subnormal below a tie": struct.unpack("<f", struct.pack("<I", 0x00000FFF))[0],
    "negative subnormal": -struct.unpack("<f", struct.pack("<I", 0x00003001))[0],
    "smallest normal": 2.0**-126,
    "bf16 value": struct.unpack("<f", struct.pack("<I", 0x3F810000))[0],
    "f16 value": 1 + 2**-10,
    "f16 subnormal": 2.0**-24,
    "large": 3.0e38,
}


@pytest.mark.parametrize("name", sorted(HAND_PICKED))
def test_tf32_rna_gives_the_bits_of_cvt_rna(name):
    x = np.float32(HAND_PICKED[name])
    got = tk.tf32_rna(torch.tensor([x]))
    want = np.float32(_rna_reference(float(x)))
    assert got.view(torch.int32).item() & 0x1FFF == 0
    assert _bits(float(got.item())) == _bits(float(want)), (name, hex(_bits(float(x))))
    big, small = tk.tf32_split(torch.tensor([x]))
    assert torch.equal(big, got)
    rest = np.float32(x) - np.float32(big.item())  # exact
    assert _bits(float(small.item())) == _bits(_rna_reference(float(rest)))


def test_tf32_rna_on_random_bit_patterns():
    bits = np.random.default_rng(5).integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    x = bits.view(np.float32)
    x = x[np.isfinite(x) & (np.abs(x) < 3.4e38)]
    got = tk.tf32_rna(torch.from_numpy(x)).view(torch.int32).numpy().view(np.uint32)
    want = np.array([_bits(_rna_reference(float(v))) for v in x], dtype=np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dt", sorted(STORAGE))
def test_two_byte_values_are_exact_in_tf32(dt):
    q = (torch.from_numpy(np.random.default_rng(6).standard_normal(4096).astype(np.float32))
         .to(STORAGE[dt]).float())
    big, small = tk.tf32_split(q)
    assert torch.equal(big, q)
    assert torch.equal(small, torch.zeros_like(q))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tf32_product_within_1e6_of_float64(seed):
    rng = np.random.default_rng(seed)
    a = rng.random((512, 512), np.float32) + np.float32(0.01)
    x = rng.random(512, np.float32) + np.float32(0.01)
    want = a.astype(np.float64) @ x.astype(np.float64)
    got = tk.matvec_tf32_plain(torch.from_numpy(a), torch.from_numpy(x)).double().numpy()
    assert np.max(np.abs(got - want) / want) <= 1e-6
    sym = a + a.T
    want = sym.astype(np.float64) @ x.astype(np.float64)
    for s in (True, False):
        got = tk.tiled_matvec_plain(torch.from_numpy(sym), torch.from_numpy(x), 128, s,
                                    formulation="dot").double().numpy()
        assert np.max(np.abs(got - want) / want) <= 1e-6, s


@pytest.mark.parametrize("n", [128, 256])
def test_stripes_dot_against_jax(n):
    got = solve_multiround(tfx.hilbert_matrix(n), EPS, MAX_ITR, chunk=12, formulation="dot")
    want = jax_multiround(jfx.hilbert_matrix(n), EPS, MAX_ITR, chunk=12, interpret=True,
                          formulation="dot")
    assert int(got.rounds) == int(want.rounds) == tfx.HILBERT_ROUNDS[n]
    assert bool(got.converged)
    assert float(got.eigenvalue) == pytest.approx(float(want.eigenvalue), rel=1e-5)
    np.testing.assert_allclose(got.eigenvector.numpy(), np.asarray(want.eigenvector), rtol=1e-4)


@pytest.mark.parametrize("cache", [0, 4])
def test_triangle_dot_against_jax(cache):
    n = 512
    got = solve_multiround(tfx.hilbert_matrix(n), EPS, MAX_ITR, chunk=18, symmetric=True,
                           tile=128, cache_tiles=cache, formulation="dot")
    want = jax_multiround(jfx.hilbert_matrix(n), EPS, MAX_ITR, chunk=18, interpret=True,
                          symmetric=True, tile=128, cache_tiles=cache, formulation="dot")
    assert int(got.rounds) == int(want.rounds) == tfx.HILBERT_ROUNDS[n]
    assert bool(got.converged)
    assert float(got.eigenvalue) == pytest.approx(float(want.eigenvalue), rel=1e-5)
    np.testing.assert_allclose(got.eigenvector.numpy(), np.asarray(want.eigenvector), rtol=1e-4)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("n", [128, 256, 512, 1024, 2048])
def test_dot_plain_keeps_the_hilbert_table(n, mode):
    H = tfx.hilbert_matrix(n)
    got = solve_multiround(H, EPS, MAX_ITR, formulation="dot", **MODES[mode])
    vpu = solve_multiround(H, EPS, MAX_ITR, **MODES[mode])
    assert int(got.rounds) == tfx.HILBERT_ROUNDS[n]
    assert bool(got.converged)
    assert float(got.eigenvalue) == pytest.approx(float(vpu.eigenvalue), rel=1e-5)
    v = got.eigenvector.double()
    assert float((H.double() @ v - got.eigenvalue.double() * v).abs().max()) <= 1e-3


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("dt", sorted(STORAGE))
def test_storage_contract_bit_for_bit(dt, mode):
    H_q = tfx.hilbert_matrix(256).to(STORAGE[dt])
    got = solve_multiround(H_q, EPS, MAX_ITR, formulation="dot", **MODES[mode])
    want = solve_multiround(H_q.float(), EPS, MAX_ITR, formulation="dot", **MODES[mode])
    _same(got, want)
    cast = solve_multiround(tfx.hilbert_matrix(256), EPS, MAX_ITR, formulation="dot",
                            storage_dtype=STORAGE[dt], **MODES[mode])
    _same(cast, want)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("chunk", [1, 2, 5, 40])
def test_chunking_is_bit_invisible(chunk, mode):
    H = tfx.hilbert_matrix(256)
    want = solve_multiround(H, EPS, MAX_ITR, formulation="dot", **MODES[mode])
    got = solve_multiround(H, EPS, MAX_ITR, chunk=chunk, formulation="dot", **MODES[mode])
    _same(got, want)


@pytest.mark.parametrize("cache", [1, 3, 6])
def test_cache_tiles_are_bit_invisible(cache):
    H = tfx.hilbert_matrix(512)
    kw = dict(symmetric=True, tile=128, formulation="dot")
    _same(solve_multiround(H, EPS, MAX_ITR, cache_tiles=cache, **kw),
          solve_multiround(H, EPS, MAX_ITR, cache_tiles=0, **kw))


def test_wrappers_run_the_plain_version_on_the_cpu():
    A, ev = tfx.hilbert_matrix(256), torch.ones(256)
    z = torch.zeros(())
    for init in (True, False):
        got = tk.multiround(A, ev, ev, z, 50, chunk=4, eps=EPS, init=init, formulation="dot")
        want = tk.multiround_plain(A, ev, ev, z, 50, chunk=4, eps=EPS, init=init,
                                   formulation="dot")
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        got = tk.multiround_sym(A, ev, ev, z, 50, chunk=4, eps=EPS, init=init, tile=128,
                                formulation="dot")
        want = tk.multiround_sym_plain(A, ev, ev, z, 50, chunk=4, eps=EPS, init=init,
                                       tile=128, formulation="dot")
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    vpu = tk.multiround(A, ev, ev, z, 50, chunk=4, eps=EPS, init=True)
    dot = tk.multiround(A, ev, ev, z, 50, chunk=4, eps=EPS, init=True, formulation="dot")
    assert not torch.equal(vpu[1], dot[1])  # another product, within rounding
    torch.testing.assert_close(dot[1], vpu[1], rtol=1e-6, atol=0)


@pytest.mark.parametrize("n", [96, 16])
def test_stripes_dot_rejects_what_jax_rejects(n):
    with pytest.raises(ValueError, match="dot-aligned"):
        solve_multiround(tfx.hilbert_matrix(n), EPS, MAX_ITR, formulation="dot")
    with pytest.raises(ValueError, match="dot-aligned"):
        jax_multiround(jfx.hilbert_matrix(n), EPS, MAX_ITR, interpret=True, formulation="dot")
    ev = torch.ones(n)
    with pytest.raises(ValueError, match="dot-aligned"):
        tk.multiround(tfx.hilbert_matrix(n), ev, ev, 0.0, 10, chunk=2, eps=EPS,
                      formulation="dot")


@pytest.mark.parametrize("kw", [
    dict(symmetric=True, formulation="mixed", cache_tiles=4),
    dict(symmetric=True, cache_tiles=4, formulation="mixed", mxu_tiles=2),
    dict(symmetric=True, cache_tiles=4, fill_mode="pipelined"),
    dict(symmetric=True, cache_tiles=4, formulation="dot", fill_mode="pipelined"),
])
def test_unported_variants_name_the_roadmap(kw):
    # once rejected as not ported (the name is kept); "mixed", mxu_tiles and
    # the pipelined fill now run and agree with JAX's interpret-mode solve
    got = solve_multiround(tfx.hilbert_matrix(512), EPS, MAX_ITR, tile=128, **kw)
    want = jax_multiround(jfx.hilbert_matrix(512), EPS, MAX_ITR, interpret=True, tile=128,
                          chunk=18, **kw)
    assert int(got.rounds) == int(want.rounds) == tfx.HILBERT_ROUNDS[512]
    assert bool(got.converged) and bool(want.converged)
    assert float(got.eigenvalue) == pytest.approx(float(want.eigenvalue), rel=1e-5)


@pytest.mark.parametrize("kw", [dict(formulation="bogus"), dict(formulation="mixed"),
                                dict(symmetric=True, formulation="bogus")])
def test_unknown_or_misplaced_formulations_raise(kw):
    with pytest.raises(ValueError, match="formulation"):
        solve_multiround(tfx.hilbert_matrix(256), EPS, MAX_ITR, **kw)
    with pytest.raises((ValueError, AssertionError)):
        jax_multiround(jfx.hilbert_matrix(256), EPS, MAX_ITR, interpret=True, **kw)
