"""The port's checkpoint and resume (``eigen_value_tpu_torch/checkpoint.py``)
against the JAX package's ``checkpoint``.

Counterparts of tests/test_checkpoint.py on one device (a sharded A's
stepping is held in tests/test_torch_sharded.py and tests/test_torch_tools.py,
Orbax's counterpart here on one process): the same Hilbert inputs go to
both packages, the port on the CPU, where a step runs the multiround
kernel's plain version (or the matvec loop past the kernel's limit).
Within the port chunked stepping is held bit for bit to the one-launch
solve; against JAX the round counts are exact and λ / ev are within the
stated tolerances (the two sum in another order).  A 2-byte A is held to
JAX's ``solve_multiround(storage_dtype=...)`` in interpret mode (the
kernels' storage contract), never to ``solve_matvec_storage``.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from eigen_value_tpu import checkpoint as jcp  # noqa: E402
from eigen_value_tpu import fixtures as jfx  # noqa: E402
from eigen_value_tpu.ops.solver_matvec import (  # noqa: E402
    solve_matvec as jax_solve_matvec,
    solve_multiround as jax_multiround,
)

from eigen_value_tpu_torch import checkpoint as cp  # noqa: E402
from eigen_value_tpu_torch import fixtures as tfx  # noqa: E402
from eigen_value_tpu_torch.convert import matrix_from_numpy, solver_state_from_numpy  # noqa: E402
from eigen_value_tpu_torch.ops.cuda import kernels as tk  # noqa: E402
from eigen_value_tpu_torch.ops.solver_matvec import (  # noqa: E402
    solve_matvec,
    solve_matvec_kernel,
    solve_multiround,
)

EPS, MAX_ITR = 1e-3, 1000
DIM = 512  # 12 rounds (fixtures.HILBERT_ROUNDS)
#: λ (relative) and ev (absolute) against JAX, whose sums run in another order
LAM_REL, EV_ATOL = 1e-6, 1e-6


@pytest.fixture(scope="module")
def hilbert():
    return tfx.hilbert_matrix(DIM)


@pytest.fixture(scope="module")
def oneshot(hilbert):
    return solve_multiround(hilbert, EPS, MAX_ITR)


@pytest.fixture(scope="module")
def jax_oneshot():
    return jax_solve_matvec(jfx.hilbert_matrix(DIM), EPS, MAX_ITR)


def bitwise(res, want) -> bool:
    return (
        int(res.rounds) == int(want.rounds)
        and bool(res.converged) == bool(want.converged)
        and torch.equal(res.eigenvalue, want.eigenvalue)
        and torch.equal(res.eigenvector, want.eigenvector)
    )


def test_chunked_stepping_bitexact(hilbert, oneshot, jax_oneshot):
    state = cp.init_state(hilbert)
    for _ in range(10):  # 5-round chunks; converges inside the 3rd
        state = cp.step(state, 5)
    res = cp.to_result(state)
    assert bool(res.converged) and int(res.rounds) == tfx.HILBERT_ROUNDS[DIM]
    assert bitwise(res, oneshot)
    assert bitwise(res, solve_matvec_kernel(hilbert, EPS, MAX_ITR))
    assert int(res.rounds) == int(jax_oneshot.rounds)
    assert float(res.eigenvalue) == pytest.approx(float(jax_oneshot.eigenvalue), rel=LAM_REL)
    np.testing.assert_allclose(res.eigenvector.numpy(), np.asarray(jax_oneshot.eigenvector),
                               atol=EV_ATOL)


@pytest.mark.parametrize("chunk", [1, 3, 12, 13, 1001])
def test_every_chunking_is_the_one_launch_solve(hilbert, oneshot, chunk):
    assert bitwise(cp.solve_checkpointed(hilbert, chunk_rounds=chunk), oneshot)


@pytest.mark.parametrize("chunk", [1, 5, 1001])
def test_the_matvec_loop_route_is_the_matvec_kernel_loop(monkeypatch, hilbert, oneshot, chunk):
    """Past the multiround kernel's limit a step is the host loop of
    ``solve_matvec_kernel``: the same bits, chunk for chunk."""
    monkeypatch.setattr(cp, "_one_launch", lambda A: False)
    res = cp.solve_checkpointed(hilbert, chunk_rounds=chunk)
    assert bitwise(res, solve_matvec_kernel(hilbert, EPS, MAX_ITR))
    assert bitwise(res, oneshot)


def test_a_step_is_one_multiround_call_with_chunk_num_rounds(monkeypatch, hilbert):
    calls = []
    real = tk.multiround

    def spy(A, ev, v, lam, budget, **kw):
        calls.append((budget, kw["chunk"], kw["init"]))
        return real(A, ev, v, lam, budget, **kw)

    monkeypatch.setattr(tk, "multiround", spy)
    state = cp.step(cp.init_state(hilbert), 5, max_itr=40)
    assert calls == [(40, 5, False)] and int(state.rounds) == 5
    state = cp.step(state, 5, max_itr=40)
    assert calls[-1] == (35, 5, False)


def test_step_is_noop_after_convergence(hilbert, monkeypatch):
    state = cp.step(cp.init_state(hilbert), 1000)
    assert bool(state.done)
    monkeypatch.setattr(tk, "multiround", None)  # a launch would raise
    again = cp.step(state, 7)
    assert again is state


def test_save_load_roundtrip_resume(tmp_path, hilbert, oneshot):
    path = str(tmp_path / "state.npz")
    state = cp.step(cp.init_state(hilbert), 4)
    assert not bool(state.done)
    cp.save_state(path, state)
    resumed = cp.load_state(path, device="cpu")
    for a, b in zip(resumed, state):
        assert a.dtype == b.dtype and torch.equal(a, b)
    final = cp.step(resumed, 1000)
    assert bitwise(cp.to_result(final), oneshot)


def test_solve_checkpointed_steps_and_saves(tmp_path, hilbert, oneshot):
    path = str(tmp_path / "drv.npz")
    res = cp.solve_checkpointed(hilbert, chunk_rounds=3, checkpoint_path=path)
    assert bitwise(res, oneshot)
    # the final snapshot exists and resuming from it is a no-op solve
    res2 = cp.solve_checkpointed(hilbert, chunk_rounds=3, checkpoint_path=path)
    assert bitwise(res2, oneshot)
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]  # written atomically


def test_a_snapshot_after_one_chunk_resumes_to_the_same_bits(tmp_path, hilbert, oneshot):
    path = str(tmp_path / "cut.npz")
    cp.save_state(path, cp.step(cp.init_state(hilbert), 8), eps=EPS)
    assert bitwise(cp.solve_checkpointed(hilbert, 8, checkpoint_path=path), oneshot)


def test_stale_checkpoint_path_raises(tmp_path, hilbert):
    path = str(tmp_path / "stale.npz")
    cp.solve_checkpointed(hilbert, chunk_rounds=50, checkpoint_path=path)
    with pytest.raises(ValueError, match="different matrix"):
        cp.solve_checkpointed(hilbert * 2.0, chunk_rounds=50, checkpoint_path=path)
    with pytest.raises(ValueError, match="checkpoint"):
        cp.solve_checkpointed(tfx.hilbert_matrix(DIM * 2), chunk_rounds=50,
                              checkpoint_path=path)
    with pytest.raises(ValueError, match="holds a torch.float32"):
        cp.solve_checkpointed(hilbert.double(), chunk_rounds=50, checkpoint_path=path)


def test_interior_row_mismatch_raises(tmp_path, hilbert):
    path = str(tmp_path / "interior.npz")
    cp.solve_checkpointed(hilbert, chunk_rounds=50, checkpoint_path=path)
    other = hilbert.clone()
    other[DIM // 2, DIM // 3] *= 1.5  # one interior entry
    with pytest.raises(ValueError, match="different matrix"):
        cp.solve_checkpointed(other, chunk_rounds=50, checkpoint_path=path)


def test_eps_mismatch_on_resume_raises(tmp_path, hilbert):
    path = str(tmp_path / "eps.npz")
    cp.solve_checkpointed(hilbert, chunk_rounds=2, checkpoint_path=path, eps=EPS)
    with pytest.raises(ValueError, match="eps"):
        cp.solve_checkpointed(hilbert, chunk_rounds=2, checkpoint_path=path, eps=EPS / 10)
    assert bool(cp.solve_checkpointed(hilbert, 2, checkpoint_path=path, eps=EPS).converged)


def test_init_state_keeps_the_callers_tensor(hilbert):
    """``donate`` keeps JAX's signature; the state aliases the caller's A
    either way (it is never copied nor written)."""
    for donate in (False, True):
        state = cp.init_state(hilbert, donate=donate)
        assert state.A is hilbert
        assert state.rounds.dtype == torch.int32 and state.done.dtype == torch.bool
    torch.testing.assert_close(state.v, hilbert.sum(1), rtol=1e-6, atol=0)


def test_chunk_rounds_zero_raises(hilbert):
    with pytest.raises(ValueError, match="chunk_rounds must be >= 1, got 0"):
        cp.solve_checkpointed(hilbert, chunk_rounds=0)


@pytest.mark.parametrize("cap", [0, 3])
def test_max_itr_cap(hilbert, cap):
    res = cp.to_result(cp.step(cp.init_state(hilbert), 1000, max_itr=cap))
    want = jcp.to_result(jcp.step(jcp.init_state(jfx.hilbert_matrix(DIM)), 1000, max_itr=cap))
    assert not bool(res.converged) and int(res.rounds) == int(want.rounds) == cap
    assert float(res.eigenvalue) == pytest.approx(float(want.eigenvalue), rel=LAM_REL)
    assert bitwise(res, solve_multiround(hilbert, EPS, cap))


def test_a_jax_state_steps_on_in_the_port(hilbert, oneshot):
    jstate = jcp.step(jcp.init_state(jfx.hilbert_matrix(DIM)), 4)
    state = solver_state_from_numpy([np.asarray(x) for x in jstate])
    assert int(state.rounds) == 4 and state.rounds.dtype == torch.int32
    assert torch.equal(state.A, hilbert)
    res = cp.to_result(cp.step(state, 1000))
    assert int(res.rounds) == int(oneshot.rounds)
    assert float(res.eigenvalue) == pytest.approx(float(oneshot.eigenvalue), rel=LAM_REL)


def _x64(dtype):
    return jax.enable_x64() if dtype == "float64" else jax.enable_x64(False)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_a_jax_snapshot_loads_and_resumes_in_the_port(tmp_path, dtype):
    path = str(tmp_path / "jax.npz")
    with _x64(dtype):
        H = jfx.hilbert_matrix(256, dtype=jnp.dtype(dtype))
        jcp.save_state(path, jcp.step(jcp.init_state(H), 4), eps=EPS)
        want = jcp.to_result(jcp.step(jcp.init_state(H), 1000))
    state, eps = cp.load_state(path, with_eps=True, device="cpu")
    assert eps == EPS and state.A.dtype == getattr(torch, dtype) and int(state.rounds) == 4
    res = cp.solve_checkpointed(state.A, 5, checkpoint_path=path)
    assert int(res.rounds) == int(want.rounds)
    assert float(res.eigenvalue) == pytest.approx(float(want.eigenvalue), rel=LAM_REL)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_a_port_snapshot_loads_and_resumes_in_jax(tmp_path, dtype):
    path = str(tmp_path / "port.npz")
    H = tfx.hilbert_matrix(256, dtype=getattr(torch, dtype))
    cp.save_state(path, cp.step(cp.init_state(H), 4), eps=EPS)
    want = cp.to_result(cp.step(cp.init_state(H), 1000))
    with _x64(dtype):
        state, eps = jcp.load_state(path, with_eps=True)
        assert eps == EPS and state.A.dtype == jnp.dtype(dtype) and int(state.rounds) == 4
        res = jcp.to_result(jcp.step(state, 1000))
        assert int(res.rounds) == int(want.rounds)
        assert float(res.eigenvalue) == pytest.approx(float(want.eigenvalue), rel=LAM_REL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("shape", [(256, 256), (37, 53)])
def test_the_digest_is_jaxs(rng, dtype, shape):
    a = rng.random(shape) + 0.1
    with _x64(dtype):
        ja = jnp.asarray(a, dtype=jnp.dtype(dtype) if dtype != "bfloat16" else jnp.bfloat16)
        want = int(jcp._matrix_digest(ja))
        t = matrix_from_numpy(np.asarray(ja), dtype=getattr(torch, dtype))
    got = cp._matrix_digest(t)
    assert got.dtype == torch.int64 and got.shape == () and int(got) == want


def test_the_digest_is_the_same_in_any_block_of_rows(rng, monkeypatch):
    A = torch.from_numpy(rng.random((97, 64), dtype=np.float32))
    whole = int(cp._matrix_digest(A))
    monkeypatch.setattr(tk, "PLAIN_BLOCK_BYTES", 8 * 64 * 5)  # five rows a block
    assert int(cp._matrix_digest(A)) == whole
    B = A.clone()
    B[50, 7] = torch.nextafter(B[50, 7], torch.tensor(2.0))  # one bit
    assert int(cp._matrix_digest(B)) != whole


def test_bf16_stepping_follows_the_kernels_storage_contract(tmp_path):
    """A bf16 A: f32 state, and every chunking is the f32 solve of
    ``A_q.float()`` bit for bit; rounds and λ as JAX's kernels (interpret
    mode) give them."""
    H = tfx.hilbert_matrix(256)
    Hq = H.to(torch.bfloat16)
    want = jax_multiround(jfx.hilbert_matrix(256), EPS, MAX_ITR,
                          storage_dtype=jnp.bfloat16, interpret=True)
    state = cp.init_state(Hq)
    assert state.v.dtype == torch.float32 and state.A is Hq
    for _ in range(6):
        state = cp.step(state, 3)
    res = cp.to_result(state)
    assert bitwise(res, solve_matvec_kernel(Hq.float(), EPS, MAX_ITR))
    assert bitwise(res, solve_multiround(H, EPS, MAX_ITR, storage_dtype=torch.bfloat16))
    assert int(res.rounds) == int(want.rounds)
    assert float(res.eigenvalue) == pytest.approx(float(want.eigenvalue), rel=1e-5)
    path = str(tmp_path / "bf16.npz")
    cp.save_state(path, state, eps=EPS)
    with np.load(path) as z:
        assert z["A"].dtype == np.uint16 and str(z["_A_dtype"]) == "bfloat16"
    back = cp.load_state(path, device="cpu")
    assert back.A.dtype == torch.bfloat16 and torch.equal(back.A, Hq)


def test_a_float64_matrix_steps_the_torch_mv_loop():
    H = tfx.hilbert_matrix(256, dtype=torch.float64)
    res = cp.solve_checkpointed(H, 4)
    assert bitwise(res, solve_matvec(H, EPS, MAX_ITR))
    assert res.eigenvector.dtype == torch.float64


def test_orbax_is_not_ported_and_says_where_it_goes(hilbert, tmp_path):
    # the Orbax snapshots are ported onto torch.distributed.checkpoint: a
    # mid-solve state written and read back is bit for bit the state, and
    # the resumed solve the one-launch solve
    state = cp.step(cp.init_state(hilbert), 3)
    path = str(tmp_path / "snap")
    cp.save_state_orbax(path, state)
    template = cp.init_state(hilbert)
    keep = [t.clone() for t in template]
    back = cp.load_state_orbax(path, template)
    assert all(torch.equal(a, b) and a.dtype == b.dtype for a, b in zip(back, state))
    assert all(torch.equal(a, b) for a, b in zip(template, keep))  # not written
    cp.save_state_orbax(path, back)  # an existing snapshot is overwritten
    assert bitwise(cp.to_result(cp.step(back, 1000)), solve_multiround(hilbert, EPS, MAX_ITR))


def test_a_snapshot_goes_to_the_card_unless_the_cpu_is_asked(tmp_path, hilbert, monkeypatch):
    path = str(tmp_path / "dev.npz")
    cp.save_state(path, cp.init_state(hilbert))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cp.load_state(path)
