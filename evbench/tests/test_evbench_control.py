"""The control: the reference computed one precision below the
configuration's, in the program's place, has to come out not correct by
each cell's limits, where the program comes out correct.  At sizes a test
run holds (512² and 1024²); the readings at the cells' own sizes, from the
card, are in PERF.md."""

import pytest
import torch

from evbench import compare, pool, reference
from evbench.catalog import Catalog

CPU = torch.device("cpu")
CELLS = {"hilbert8192_f32.sym": True, "hilbert8192_f32.dense": False,
         "hilbert65536_bf16.stream": False}


def readings(A, solutions, refs):
    answers = [compare.Answer(p, s.eigenvalue, s.rounds, s.converged, s.eigenvector)
               for p, s in enumerate(solutions)]
    return compare.numbers(answers, answers, refs)


@pytest.mark.parametrize("n", [512, 1024])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails_where_the_program_passes(cell, n):
    from eigen_value_tpu_torch import SolverConfig, max_eigenvalue

    cat = Catalog()
    limits = cat.limits(cell)
    config = dict(cat.config(cat.workload(cell)["config"]), n=n)
    mats = pool.make_pool(config, 3, 2**31 + n, CPU)
    refs = [reference.solve(A, config["eps"], config["max_itr"]) for A in mats]
    cfg = SolverConfig(symmetric=CELLS[cell],
                       storage_dtype=pool.DTYPES.get(config["storage_dtype"]))
    program = []
    for A in mats:
        r = max_eigenvalue(A, cfg)
        program.append(reference.Solution(float(r.eigenvalue), r.eigenvector, int(r.rounds),
                                          bool(r.converged), 0.0))
    assert compare.judge(readings(mats, program, refs), limits)[0]
    assert limits["controls"]
    for kind in limits["controls"]:
        control = [reference.solve_control(A, kind, config["eps"], config["max_itr"])
                   for A in mats]
        ok, checks = compare.judge(readings(mats, control, refs), limits)
        assert not ok, (kind, checks)
