"""The port's kernel wrappers against the JAX package's Pallas kernels.

On the CPU a wrapper runs its kernel's plain PyTorch version; the JAX
kernels run as their own tests run them (``interpret=True``).  Inputs are
made with numpy from a seed and handed to both.  The CUDA kernels
themselves are tested on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from eigen_value_tpu import fixtures as jfx  # noqa: E402
from eigen_value_tpu.ops.pallas import kernels as jk  # noqa: E402
from eigen_value_tpu_torch import convert  # noqa: E402
from eigen_value_tpu_torch import fixtures as tfx  # noqa: E402
from eigen_value_tpu_torch.ops.cuda import build  # noqa: E402
from eigen_value_tpu_torch.ops.cuda import kernels as tk  # noqa: E402

EPS = 1e-3


@pytest.mark.parametrize("shape", [(128, 128), (256, 512)])
def test_matvec_plain_matches_pallas(shape, rng):
    a = rng.random(shape, dtype=np.float32)
    x = rng.random(shape[1], dtype=np.float32) + np.float32(0.5)
    want = jk.matvec(jnp.asarray(a), jnp.asarray(x), block_rows=128, block_cols=128,
                     interpret=True)
    got = tk.matvec_plain(torch.from_numpy(a), torch.from_numpy(x))
    # rtol 1e-6 as tests/test_matvec.py: the f32 sums reduce in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_matvec_wrapper_on_cpu_is_plain_and_uncounted(rng):
    a = torch.from_numpy(rng.random((37, 5), dtype=np.float32))
    x = torch.from_numpy(rng.random(5, dtype=np.float32))
    before = tk.matvec.launches
    assert torch.equal(tk.matvec(a, x), tk.matvec_plain(a, x))
    assert tk.matvec.launches == before


@pytest.mark.parametrize(
    "a, x, match",
    [
        (torch.ones(4, 4, dtype=torch.float64), torch.ones(4, dtype=torch.float64), "float32"),
        (torch.ones(4, 8).T, torch.ones(4), "contiguous"),
        (torch.ones(4, 4), torch.ones(5), "shape"),
        (torch.ones(4), torch.ones(4), "2-D"),
        (torch.ones(4, 4, device="meta"), torch.ones(4, device="meta"), "unsupported device"),
    ],
)
def test_matvec_wrapper_rejects(a, x, match):
    with pytest.raises(ValueError, match=match):
        tk.matvec(a, x)


def _jax_state(n, init_chunk=3):
    """A mid-solve state from the JAX kernel: (ev, v, λ) after one init chunk."""
    H = jfx.hilbert_matrix(n)
    ev0 = jnp.ones((n,), jnp.float32)
    ev, v, _, lam = jk.multiround(H, ev0, ev0, 0.0, 1000, chunk=init_chunk, eps=EPS,
                                  init=True, interpret=True)
    return np.asarray(ev), np.asarray(v), np.asarray(lam)


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("init", [True, False])
@pytest.mark.parametrize("n", [128, 256])
def test_multiround_plain_matches_pallas(n, init, chunk):
    H = np.asarray(jfx.hilbert_matrix(n))
    if init:
        ev = v = np.ones(n, np.float32)
        lam = np.float32(0.0)
    else:
        ev, v, lam = _jax_state(n)
    want = jk.multiround(jnp.asarray(H), jnp.asarray(ev), jnp.asarray(v), jnp.asarray(lam),
                         1000, chunk=chunk, eps=EPS, init=init, interpret=True)
    s = convert.state_from_numpy(ev, v, lam, 0)
    got = tk.multiround(convert.matrix_from_numpy(H), s.ev, s.v, s.lam, 1000,
                        chunk=chunk, eps=EPS, init=init)
    assert int(got[2]) == int(want[2])
    for g, w in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)


@pytest.mark.parametrize("budget", [0, 2])
def test_multiround_plain_budget_and_freeze_match_pallas(budget):
    """The budget cap freezes mid-chunk exactly where the JAX kernel does."""
    ev, v, lam = _jax_state(128)
    want = jk.multiround(jfx.hilbert_matrix(128), jnp.asarray(ev), jnp.asarray(v),
                         jnp.asarray(lam), budget, chunk=6, eps=EPS, interpret=True)
    got = tk.multiround(tfx.hilbert_matrix(128), torch.tensor(ev), torch.tensor(v),
                        torch.tensor(lam), budget, chunk=6, eps=EPS)
    assert int(got[2]) == int(want[2]) == budget
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5)
    np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=1e-5)


def test_multiround_wrapper_rejects():
    H, ev = tfx.hilbert_matrix(8), torch.ones(8)
    with pytest.raises(ValueError, match="chunk"):
        tk.multiround(H, ev, ev, 0.0, 10, chunk=0, eps=EPS)
    with pytest.raises(ValueError, match="eps_mode"):
        tk.multiround(H, ev, ev, 0.0, 10, chunk=2, eps=EPS, eps_mode="bogus")
    with pytest.raises(ValueError, match="square"):
        tk.multiround(torch.ones(8, 4), ev, ev, 0.0, 10, chunk=2, eps=EPS)
    with pytest.raises(ValueError, match="shape"):
        tk.multiround(H, torch.ones(7), ev, 0.0, 10, chunk=2, eps=EPS)
    with pytest.raises(ValueError, match="scalar"):
        tk.multiround(H, ev, ev, torch.ones(2), 10, chunk=2, eps=EPS)


def test_build_names_library_by_source_hash():
    path = build.library_path()
    assert path.parent == build.BUILD_DIR and path.name.startswith("libevt_")
    assert all((build.CSRC / s).exists() for s in build.SOURCES + build.HEADERS)
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS

