"""The port's multi-host flow with real processes (counterpart of
tests/test_multihost.py).

Groups of 2 and 4 OS processes, each one rank of a gloo group on the CPU,
run ``eigen_value_tpu_torch.bench.mh_worker``: ``multihost.initialize``,
each process building only its own Hilbert rows, ``assemble_rowsharded`` /
``assemble_blocksharded``, and the gathered, ring, 2-D, iterated and
batched solves in the one group (the 4-process group as two simulated hosts
of two ranks, so its 2-D mesh is 2 × 2).  JAX's checks: rounds equal to the
table, λ within 1e-3 of the reference oracle, the eigen-pair residual below
1e-3, and λ bit-equal across processes.
"""

import numpy as np
import pytest

from eigen_value_tpu import fixtures
from eigen_value_tpu.reference_impl import parallel_oracle
from eigen_value_tpu_torch.bench import run_mh_workers

DIM = 256
SOLVERS = ("gather", "ring", "2d", "iterated", "batched")
_RUNS: dict = {}


def run_group(nprocs: int) -> list:
    """Each worker's JSON record of an ``nprocs``-process group that runs
    every solver (once per module)."""
    if nprocs not in _RUNS:
        _RUNS[nprocs] = run_mh_workers(nprocs, DIM, 1, SOLVERS, device="cpu",
                                       nodes=max(1, nprocs // 2), timeout_s=300)
    return _RUNS[nprocs]


@pytest.mark.parametrize("nprocs", [2, 4])
@pytest.mark.parametrize("solver", SOLVERS)
def test_multi_process_solve_parity(nprocs, solver):
    outs = run_group(nprocs)
    oracle = parallel_oracle(np.asarray(fixtures.hilbert_matrix(DIM)))
    for res in outs:
        assert res["num_processes"] == nprocs
        assert res["global_devices"] == nprocs  # one device a rank
        r = res["results"][solver]
        assert r["converged"]
        assert r["rounds"] == fixtures.HILBERT_ROUNDS[DIM]
        assert r["eigenvalue"] == pytest.approx(oracle.eigenvalue, abs=1e-3)
        assert r["residual"] < 1e-3
        if solver == "batched":
            assert r["rounds_all"] == [fixtures.HILBERT_ROUNDS[DIM]] * r["batch"]
    # λ is bit-identical across processes (replicated readout)
    assert len({res["results"][solver]["eigenvalue"] for res in outs}) == 1


@pytest.mark.parametrize("nprocs, shape", [(2, {"rows": 1, "cols": 2}),
                                           (4, {"rows": 2, "cols": 2})])
def test_the_2d_mesh_is_hosts_by_ranks_of_a_host(nprocs, shape):
    for res in run_group(nprocs):
        assert res["results"]["2d"]["mesh"] == shape
