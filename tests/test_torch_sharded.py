"""The port's sharded solves (``eigen_value_tpu_torch.parallel``) against
the JAX package's on the same inputs.

The port runs in gloo groups of 2 and 4 CPU processes
(``tests/_torch_mesh_cases.py``, every case of a world size in one group);
JAX runs the same numpy inputs on the conftest's 8-device virtual CPU mesh
with the same P.  Tolerances are JAX's own (``tests/test_parallel.py``):
rounds exact (and equal to the Hilbert table), λ and ev within 1e-5 for
the gathered, 2-D and iterated bodies, 1e-4 for the ring; the batched
bodies' λ within rel 1e-6 (JAX's bound of a batched λ against its single
solve; λ ≈ 64 there, and ``torch.bmm`` sums in another order than XLA's
dot) and ev within 1e-5.  bf16
storage follows the port's one storage contract, so it is held against the
port's own single-device storage solve (rounds within ±1, as JAX's sharded
storage tests allow) and the reference oracle, never against JAX's
quantized-operand sharded bodies.  A DTensor A stepped through
``checkpoint`` is held against JAX's ``checkpoint.step`` of the sharded
``jax.Array`` with the tolerances of JAX's own tests
(``tests/test_checkpoint.py``: rounds exact; λ and ev within 1e-5 for
rows, λ within rel 1e-6 for 2-D), and bit for bit against the whole
sharded solve of the same body.  A world of one rank (a gloo group in
this process) holds each body and each stepping bit for bit against the
single-device solve or step.  The rejections run in this process with no
group spawned.
"""

import functools

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.distributed as dist
from jax.sharding import Mesh, NamedSharding, PartitionSpec

import _torch_mesh_cases as mc
from eigen_value_tpu import checkpoint as jcp
from eigen_value_tpu import fixtures as jfx
from eigen_value_tpu.config import SolverConfig as JConfig
from eigen_value_tpu.parallel import multihost as jmh
from eigen_value_tpu.parallel import sharded as jsh
from eigen_value_tpu.parallel.batched import solve_batched_sharded as j_batched_sharded
from eigen_value_tpu.reference_impl import parallel_oracle
import eigen_value_tpu_torch as evt
from eigen_value_tpu_torch import checkpoint as cp
from eigen_value_tpu_torch.ops import solver_matvec as sm
from eigen_value_tpu_torch.ops.cuda import kernels as tk
from eigen_value_tpu_torch.ops.solver import solve_xla
from eigen_value_tpu_torch.parallel import batched as tb
from eigen_value_tpu_torch.parallel import multihost as tmh
from eigen_value_tpu_torch.parallel import sharded as tsh

EPS, MAX_ITR = 1e-3, 1000
HERE = os.path.dirname(os.path.abspath(__file__))
DATA = mc.inputs()
_GROUPS: dict = {}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def group(world: int) -> dict:
    """Rank 0's results of every case at ``world`` ranks, run once per
    module (the cases of a world size share one group)."""
    if world not in _GROUPS:
        port = _free_port()
        env = dict(os.environ, OMP_NUM_THREADS="1")
        procs = [
            subprocess.Popen([sys.executable, os.path.join(HERE, "_torch_mesh_cases.py"),
                              str(r), str(world), str(port)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
            for r in range(world)
        ]
        outs = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=300)
                assert p.returncode == 0, f"rank failed:\n{err[-3000:]}"
                outs.append(out)
        finally:
            # a failed or timed-out rank must not leave its siblings waiting
            for q in procs:
                if q.poll() is None:
                    q.kill()
                    q.wait()
        _GROUPS[world] = json.loads(outs[0].strip().splitlines()[-1])
    return _GROUPS[world]


def cpu_mesh(n, axis="rows"):
    return Mesh(np.array(jax.devices("cpu")[:n]), (axis,))


def jax_result(case: str, world: int):
    """JAX's solve of ``case`` at ``world`` devices, on the same input."""
    H = jnp.asarray(DATA["hilbert256"])
    rel = JConfig(eps_mode="relative")
    if case.startswith("2d_"):
        pr, pc = map(int, case[3:].split("x"))
        return jsh.solve_sharded_2d(H, jsh.make_mesh2d(pr, pc))
    if case.startswith("batch_rows_"):
        pb, pr = map(int, case[11:].split("x"))
        mesh = Mesh(np.array(jax.devices("cpu")[:pb * pr]).reshape(pb, pr), ("batch", "rows"))
        return jsh.solve_batched_rowsharded(jnp.asarray(DATA["batch4x128"]), mesh)
    return {
        "gather": lambda: jsh.solve_sharded_matvec(H, cpu_mesh(world)),
        "gather_plain": lambda: jsh.solve_sharded_matvec(H, cpu_mesh(world), use_pallas=False),
        "gather_relative": lambda: jsh.solve_sharded_matvec(H, cpu_mesh(world), config=rel),
        "ring": lambda: jsh.solve_sharded_matvec_ring(H, cpu_mesh(world)),
        "ring_relative": lambda: jsh.solve_sharded_matvec_ring(H, cpu_mesh(world), config=rel),
        "ring_cap": lambda: jsh.solve_sharded_matvec_ring(H, cpu_mesh(world),
                                                          config=JConfig(max_itr=3)),
        "iterated": lambda: jsh.solve_sharded(H, cpu_mesh(world)),
        "iterated_relative": lambda: jsh.solve_sharded(H, cpu_mesh(world), config=rel),
        "batch": lambda: j_batched_sharded(jnp.asarray(DATA["batch8x64"]),
                                           cpu_mesh(world, "batch")),
    }[case]()


#: Hilbert 256 cases: (case, λ and ev tolerance, rounds on the table)
HILBERT = [("gather", 1e-5, True), ("gather_plain", 1e-5, True), ("gather_relative", 1e-5, False),
           ("ring", 1e-4, True), ("ring_relative", 1e-4, False), ("ring_cap", 1e-4, False),
           ("iterated", 1e-5, True), ("iterated_relative", 1e-5, False)]
BODIES = [(w, *c) for w in (2, 4) for c in HILBERT]
BODIES += [(w, f"2d_{pr}x{pc}", 1e-5, True) for w in (2, 4) for pr, pc in mc.SHAPES_2D[w]]


@pytest.mark.parametrize("world, case, tol, on_table", BODIES)
def test_body_matches_jax(world, case, tol, on_table):
    got = group(world)[case]
    want = jax_result(case, world)
    assert got["rounds"] == int(want.rounds)
    assert got["converged"] == bool(want.converged)
    if on_table:
        assert got["rounds"] == jfx.HILBERT_ROUNDS[256] and got["converged"]
    assert abs(got["eigenvalue"] - float(want.eigenvalue)) < tol
    np.testing.assert_allclose(np.asarray(got["eigenvector"]), np.asarray(want.eigenvector),
                               atol=tol)


BATCHED = [(w, f"batch_rows_{pb}x{pr}") for w in (2, 4) for pb, pr in mc.SHAPES_2D[w]]
BATCHED += [(2, "batch"), (4, "batch")]


@pytest.mark.parametrize("world, case", BATCHED)
def test_batched_matches_jax(world, case):
    got = group(world)[case]
    want = jax_result(case, world)
    np.testing.assert_array_equal(got["rounds"], np.asarray(want.rounds))
    np.testing.assert_array_equal(got["converged"], np.asarray(want.converged))
    np.testing.assert_allclose(got["eigenvalue"], np.asarray(want.eigenvalue), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(got["eigenvector"]), np.asarray(want.eigenvector),
                               atol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("body", ["gather", "ring", "iterated", "2d"])
def test_eigen_pair_property(world, body):
    got = group(world)[f"pair_{body}"]
    mat, v, lam = DATA["random128"], np.asarray(got["eigenvector"]), got["eigenvalue"]
    assert got["converged"]
    assert np.allclose(mat @ v, lam * v, atol=1e-3)


#: (door, the direct call it must equal bit for bit)
SAME = [("api_auto", "gather"), ("api_matvec", "gather_plain"), ("api_matvec_pallas", "gather"),
        ("api_xla", "iterated"), ("api_validate", "gather"), ("api_batch", "batch"),
        ("assembled_gather", "gather"), ("gather_scaled", "gather")]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("door, direct", SAME + [("api_2d", "2d"), ("assembled_2d", "2d"),
                                                 ("api_batch_rows", "batch_rows")])
def test_the_doors_equal_the_direct_calls(world, door, direct):
    if direct in ("2d", "batch_rows"):
        direct += "_{}x{}".format(*mc.square_2d(world))
    got, want = group(world)[door], group(world)[direct]
    assert got["rounds"] == want["rounds"] and got["eigenvalue"] == want["eigenvalue"]
    if door != "gather_scaled":  # ev0 = 2 · ones: the same λ and rounds, ev scaled
        assert got["eigenvector"] == want["eigenvector"]
    if door == "assembled_2d":
        assert got["placed_equal"]


@functools.lru_cache(maxsize=None)
def jax_stepped(world: int, kind: str):
    """JAX's ``checkpoint.step(checkpoint.init_state(Hs), 1000)`` of Hilbert
    256 sharded over rows of ``cpu_mesh(world)``, or over the 2-D mesh of
    ``square_2d(world)``."""
    H = jnp.asarray(DATA["hilbert256"])
    if kind == "rows":
        sharding = NamedSharding(cpu_mesh(world), PartitionSpec("rows", None))
    else:
        sharding = NamedSharding(jsh.make_mesh2d(*mc.square_2d(world)),
                                 PartitionSpec("rows", "cols"))
    return jcp.step(jcp.init_state(jax.device_put(H, sharding)), 1000)


#: (the stepped case, how its A is sharded, the whole sharded solve it equals)
STEPPED = [("step_rows", "rows", "gather"), ("step_rows_1", "rows", "gather"),
           ("checkpointed_rows", "rows", "gather"), ("checkpointed_npz_rows", "rows", "gather"),
           ("step_2d", "2d", "2d"), ("step_rows_bf16", "rows", "bf16_gather")]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case, kind", [c[:2] for c in STEPPED if "bf16" not in c[0]])
def test_stepping_a_sharded_a_matches_jaxs_sharded_step(world, case, kind):
    got, want = group(world)[case], jax_stepped(world, kind)
    assert bool(want.done) and got["converged"]
    assert got["rounds"] == int(want.rounds) == jfx.HILBERT_ROUNDS[256]
    if kind == "rows":
        assert abs(got["eigenvalue"] - float(want.lam)) < 1e-5
        np.testing.assert_allclose(np.asarray(got["eigenvector"]), np.asarray(want.ev),
                                   atol=1e-5)
    else:
        assert got["eigenvalue"] == pytest.approx(float(want.lam), rel=1e-6)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case, whole", [(c[0], c[2]) for c in STEPPED])
def test_stepping_in_chunks_is_the_whole_sharded_solve_bit_for_bit(world, case, whole):
    if whole == "2d":
        whole += "_{}x{}".format(*mc.square_2d(world))
    got, want = group(world)[case], group(world)[whole]
    for key in ("eigenvalue", "eigenvector", "rounds", "converged"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", ["step_rows", "step_2d"])
def test_a_sharded_digest_is_the_whole_matrixs(world, case):
    want = int(jcp._matrix_digest(jnp.asarray(DATA["hilbert256"])))
    assert group(world)[case]["digest"] == want


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_runs_in_lockstep(world):
    for case, res in group(world).items():
        assert all(r == res["ranks"][0] for r in res["ranks"]), case


def _residual(A_q: torch.Tensor, lam, ev) -> float:
    A = A_q.double()
    v = torch.as_tensor(ev, dtype=torch.float64)
    return float((A @ v - float(lam) * v).abs().max())


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("body", ["gather", "ring", "2d"])
def test_bf16_storage_follows_the_ports_contract(world, body):
    got = group(world)[f"bf16_{body}"]
    H = torch.from_numpy(DATA["hilbert256"])
    single = sm.solve_matvec_kernel(H, EPS, MAX_ITR, storage_dtype=torch.bfloat16)
    assert got["converged"] and abs(got["rounds"] - int(single.rounds)) <= 1
    assert got["eigenvalue"] == pytest.approx(float(single.eigenvalue), rel=1e-5)
    A_q = H.to(torch.bfloat16)
    assert _residual(A_q, got["eigenvalue"], got["eigenvector"]) <= 1e-3
    oracle = parallel_oracle(A_q.float().numpy())
    assert abs(got["rounds"] - oracle.rounds) <= 1
    assert got["eigenvalue"] == pytest.approx(oracle.eigenvalue, abs=1e-3)


@pytest.mark.parametrize("world", [2, 4])
def test_bf16_storage_batch_rows_and_the_door(world):
    got = group(world)["bf16_batch_rows"]
    As = torch.from_numpy(DATA["batch4x128"])
    single = tb.solve_batched(As, EPS, MAX_ITR, storage_dtype=torch.bfloat16)
    assert all(got["converged"])
    assert np.abs(np.asarray(got["rounds"]) - single.rounds.numpy()).max() <= 1
    np.testing.assert_allclose(got["eigenvalue"], single.eigenvalue.numpy(), rtol=1e-5)
    for b in range(4):
        A_q = As[b].to(torch.bfloat16)
        assert _residual(A_q, got["eigenvalue"][b], got["eigenvector"][b]) <= 1e-3
        assert abs(got["rounds"][b] - parallel_oracle(A_q.float().numpy()).rounds) <= 1
    api, pre = group(world)["bf16_api"], group(world)["bf16_prequantized"]
    assert api == pre  # a matrix already in bf16 solves as the cast one
    R = torch.from_numpy(DATA["random256"])
    one = evt.max_eigenvalue(R, evt.SolverConfig(storage_dtype=torch.bfloat16), device="cpu")
    assert api["converged"] and abs(api["rounds"] - int(one.rounds)) <= 1
    assert api["eigenvalue"] == pytest.approx(float(one.eigenvalue), rel=1e-5)


# --- one rank, in this process: the bodies bit for bit the single-device loops ---


@pytest.fixture(scope="module")
def one_rank():
    """A one-rank gloo group in this process (``make_row_mesh(1,
    device_type="cpu")`` starts it), destroyed after the module."""
    started = not dist.is_initialized()
    tsh.make_row_mesh(1, device_type="cpu")
    cache = {}

    def meshes(kind, *shape):
        key = (kind, shape)
        if key not in cache:
            if kind in ("rows", "batch"):
                cache[key] = tsh.make_row_mesh(1, kind, device_type="cpu")
            elif kind == "2d":
                cache[key] = tsh.make_mesh2d(*shape, device_type="cpu")
            else:
                cache[key] = tsh.make_mesh2d(*shape, "batch", "rows", device_type="cpu")
        return cache[key]

    yield meshes
    if started:
        dist.destroy_process_group()


def _local(res):
    return [x.to_local() if hasattr(x, "to_local") else x for x in res]


def _bitwise(got, want) -> bool:
    return all(torch.equal(g, w) for g, w in zip(_local(got), want))


H_T = torch.from_numpy(DATA["hilbert256"])
BF16 = dict(storage_dtype=torch.bfloat16)
ONE_RANK = {
    "gather": lambda: sm.solve_matvec_kernel(H_T, EPS, MAX_ITR),
    "ring": lambda: sm.solve_matvec_kernel(H_T, EPS, MAX_ITR),
    "2d_1x1": lambda: sm.solve_matvec_kernel(H_T, EPS, MAX_ITR),
    "gather_relative": lambda: sm.solve_matvec_kernel(H_T, EPS, MAX_ITR, eps_mode="relative"),
    "ring_relative": lambda: sm.solve_matvec_kernel(H_T, EPS, MAX_ITR, eps_mode="relative"),
    "ring_cap": lambda: sm.solve_matvec_kernel(H_T, EPS, 3),
    "iterated": lambda: solve_xla(H_T, EPS, MAX_ITR),
    "iterated_relative": lambda: solve_xla(H_T, EPS, MAX_ITR, eps_mode="relative"),
    "batch": lambda: tb.solve_batched(torch.from_numpy(DATA["batch8x64"]), EPS, MAX_ITR),
    "batch_rows_1x1": lambda: tb.solve_batched(torch.from_numpy(DATA["batch4x128"]), EPS, MAX_ITR),
    "bf16_gather": lambda: sm.solve_matvec_kernel(H_T, EPS, MAX_ITR, **BF16),
    "bf16_ring": lambda: sm.solve_matvec_kernel(H_T, EPS, MAX_ITR, **BF16),
    "bf16_2d": lambda: sm.solve_matvec_kernel(H_T, EPS, MAX_ITR, **BF16),
    "bf16_batch_rows": lambda: tb.solve_batched(torch.from_numpy(DATA["batch4x128"]), EPS,
                                                MAX_ITR, **BF16),
    "step_rows": lambda: _stepped(H_T, [3, 3, 1000]),
    "step_rows_1": lambda: _stepped(H_T, [1] * 20),
    "step_2d": lambda: _stepped(H_T, [3, 3, 1000]),
    "step_rows_bf16": lambda: _stepped(H_T.to(torch.bfloat16), [3, 3, 1000]),
    "checkpointed_rows": lambda: _stepped(H_T, [3, 3, 1000]),
    "checkpointed_npz_rows": lambda: _stepped(H_T, [4, 1000]),
}


def _stepped(A, chunks):
    """The port's unsharded ``checkpoint.step`` of ``A`` in ``chunks``."""
    state = cp.init_state(A)
    for k in chunks:
        state = cp.step(state, k)
    return cp.to_result(state)


@pytest.mark.parametrize("case", sorted(ONE_RANK))
def test_one_rank_is_the_single_device_solve_bit_for_bit(one_rank, case):
    got = mc.run_case(case, 1, DATA, one_rank)
    assert _bitwise(got, ONE_RANK[case]())


def test_one_rank_results_are_placed_dtensors(one_rank):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    res = mc.run_case("2d_1x1", 1, DATA, one_rank)
    assert isinstance(res.eigenvector, DTensor) and not isinstance(res.eigenvalue, DTensor)
    assert list(res.eigenvector.placements) == [Shard(0), Replicate()]
    res = mc.run_case("batch_rows_1x1", 1, DATA, one_rank)
    assert all(isinstance(x, DTensor) for x in res)
    assert list(res.eigenvector.placements) == [Shard(0), Shard(1)]
    assert list(res.rounds.placements) == [Shard(0), Replicate()]


def test_a_dtensor_placed_otherwise_is_rejected(one_rank):
    from torch.distributed.tensor import DTensor, Replicate

    rows = one_rank("rows")
    A = DTensor.from_local(H_T, rows, [Replicate()], run_check=False)
    with pytest.raises(ValueError, match="placements"):
        tsh.solve_sharded_matvec(A, rows)


# --- the rejections, with the JAX package's words ---

KNOBS = [("symmetric", True), ("chunk", 4), ("cache_tiles", 2), ("block_rows", 128),
         ("block_cols", 128), ("interpret", True)]
ENTRIES = ["solve_sharded", "solve_sharded_matvec", "solve_sharded_matvec_ring",
           "solve_sharded_2d", "solve_batched_rowsharded"]


def _message(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("knob, value", KNOBS)
@pytest.mark.parametrize("entry", ENTRIES)
def test_direct_calls_reject_single_chip_knobs_with_jaxs_words(entry, knob, value):
    want = _message(lambda: jsh._reject_sharded_unsupported(JConfig(**{knob: value}), entry))
    got = _message(lambda: tsh._reject_sharded_unsupported(evt.SolverConfig(**{knob: value}),
                                                          entry))
    assert got == want


def test_the_iterated_body_rejects_storage_with_jaxs_reason():
    want = _message(lambda: jsh._reject_sharded_unsupported(
        JConfig(storage_dtype=jnp.bfloat16), "solve_sharded", storage_ok=False))
    got = _message(lambda: tsh._reject_sharded_unsupported(
        evt.SolverConfig(storage_dtype=torch.bfloat16), "solve_sharded", storage_ok=False))
    assert got.split(" is not supported")[1] == want.split(" is not supported")[1]
    assert got.startswith("storage_dtype=torch.bfloat16 is not supported by solve_sharded")


DOOR = [dict(block_rows=128), dict(block_cols=128), dict(chunk=4), dict(cache_tiles=2),
        dict(interpret=True), dict(symmetric=True), dict(backend="multiround"),
        dict(backend="pallas")]


@pytest.mark.parametrize("kw", DOOR, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_the_mesh_door_rejects_with_jaxs_words(one_rank, kw):
    from eigen_value_tpu import max_eigenvalue as j_max_eigenvalue

    H = DATA["hilbert256"]
    want = _message(lambda: j_max_eigenvalue(H, JConfig(**kw), mesh=cpu_mesh(2)))
    got = _message(lambda: evt.max_eigenvalue(H, evt.SolverConfig(**kw), mesh=one_rank("rows")))
    assert got == want


@pytest.mark.parametrize("backend", ["matvec_pallas", "xla"])
def test_a_2d_mesh_takes_no_other_backend_than_auto_or_matvec(one_rank, backend):
    from eigen_value_tpu import max_eigenvalue as j_max_eigenvalue

    H = DATA["hilbert256"]
    want = _message(lambda: j_max_eigenvalue(H, JConfig(backend=backend),
                                             mesh=jsh.make_mesh2d(2, 4)))
    got = _message(lambda: evt.max_eigenvalue(H, evt.SolverConfig(backend=backend),
                                              mesh=one_rank("2d", 1, 1)))
    assert got == want


def test_the_door_rejects_storage_on_the_iterated_body_a_cols_only_mesh_and_device(one_rank):
    from eigen_value_tpu import max_eigenvalue as j_max_eigenvalue

    H = DATA["hilbert256"]
    want = _message(lambda: j_max_eigenvalue(
        H, JConfig(backend="xla", storage_dtype=jnp.bfloat16), mesh=cpu_mesh(2)))
    got = _message(lambda: evt.max_eigenvalue(
        H, evt.SolverConfig(backend="xla", storage_dtype=torch.bfloat16), mesh=one_rank("rows")))
    assert got == want
    with pytest.raises(ValueError, match="needs a 'rows' axis too"):
        evt.max_eigenvalue(H, mesh=tsh.make_row_mesh(1, "cols", device_type="cpu"))
    with pytest.raises(ValueError, match="the mesh places the solve"):
        evt.max_eigenvalue(H, mesh=one_rank("rows"), device="cpu")
    with pytest.raises(ValueError, match="all entries > 0"):
        evt.max_eigenvalue(-H, validate=True, mesh=one_rank("rows"))
    with pytest.raises(ValueError, match="'batch' axis"):
        evt.max_eigenvalue_batch(DATA["batch8x64"], mesh=one_rank("rows"))


def test_missing_axes_are_named(one_rank):
    H = H_T[:128, :128]
    rows = one_rank("rows")
    for entry, axis in ((tsh.solve_sharded_matvec, "wrong"), (tsh.solve_sharded, "w"),
                        (tsh.solve_sharded_matvec_ring, "w")):
        with pytest.raises(ValueError, match=f"no '{axis}' axis"):
            entry(H, rows, axis_name=axis)
    with pytest.raises(ValueError, match="no 'cols' axis"):
        tsh.solve_sharded_2d(H, rows)
    with pytest.raises(ValueError, match="no 'x' axis"):
        tmh.assemble_rowsharded(np.ones((32, 128), np.float32), rows, "x")
    with pytest.raises(ValueError, match="1-D mesh"):
        tmh.assemble_rowsharded(np.ones((128, 128), np.float32), one_rank("2d", 1, 1))
    want = _message(lambda: jsh.require_axis(cpu_mesh(4), "wrong"))
    got = _message(lambda: tsh.require_axis(rows, "wrong"))
    assert got.split(" (axes")[0] == want.split(" (axes")[0]


def test_shapes_are_checked(one_rank):
    bad = torch.ones(8, 16)
    for entry in (tsh.solve_sharded, tsh.solve_sharded_matvec, tsh.solve_sharded_matvec_ring):
        with pytest.raises(ValueError, match="square matrix"):
            entry(bad, one_rank("rows"))
    with pytest.raises(ValueError, match="square matrix"):
        tsh.solve_sharded_2d(bad, one_rank("2d", 1, 1))
    with pytest.raises(ValueError, match="expected"):
        tsh.solve_batched_rowsharded(torch.ones(2, 8, 16), one_rank("batch_rows", 1, 1))
    with pytest.raises(ValueError, match="does not assemble to a square"):
        tmh.assemble_blocksharded(np.ones((64, 256), np.float32), one_rank("2d", 1, 1))
    with pytest.raises(ValueError, match="does not assemble to a square"):
        tmh.assemble_rowsharded(np.ones((64, 256), np.float32), one_rank("rows"))


def test_meshes_are_never_smaller_than_asked_and_never_fall_back(one_rank):
    with pytest.raises(ValueError, match="only"):
        tsh.make_row_mesh(4096, device_type="cpu")
    with pytest.raises(ValueError, match="only"):
        tsh.make_mesh2d(2, 2, device_type="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no CPU fallback"):
            tsh.make_row_mesh(1)  # a CUDA mesh by default


def test_host_major_validation():
    for ok in ([0, 0, 0, 0], [0, 0, 1, 1], [0, 1, 2, 3]):
        tmh._require_host_major(ok)
        jmh._require_host_major(ok)
    for bad in ([0, 1, 0, 1], [1, 1, 0, 0]):
        want = _message(lambda: jmh._require_host_major(bad))
        assert _message(lambda: tmh._require_host_major(bad)) == want


@pytest.mark.parametrize("args", [(100, 10, 2.0), (8192, 17, 0.0035), (3, 4, 1e-6)])
def test_scaling_math_matches_jax(args):
    assert tmh.elems_per_second(*args) == jmh.elems_per_second(*args)
    e = tmh.elems_per_second(*args)
    for chips in (1, 2, 8):
        assert tmh.weak_scaling_efficiency(e, chips, e / 3) == jmh.weak_scaling_efficiency(
            e, chips, e / 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("parts", [2, 4])
def test_a_column_view_gives_the_contiguous_copys_product(dtype, parts):
    A = torch.from_numpy(DATA["random256"]).to(dtype)
    x = torch.from_numpy(np.random.default_rng(parts).random(256 // parts, dtype=np.float32))
    w = 256 // parts
    for s in range(parts):
        view = A[32:96, s * w:(s + 1) * w]
        assert not view.is_contiguous()
        want = tk.matvec_plain(view.contiguous(), x)
        assert torch.equal(tk.matvec_plain(view, x), want)
        assert torch.equal(tk.matvec(view, x), want)  # the wrapper takes the view


def test_the_matvec_wrapper_takes_rows_that_are_contiguous_only():
    A = torch.ones(8, 8)
    with pytest.raises(ValueError, match="stride"):
        tk.matvec(A[:, ::2], torch.ones(4))
    assert torch.equal(tk.matvec(A[::2], torch.ones(8)), torch.full((4,), 8.0))
