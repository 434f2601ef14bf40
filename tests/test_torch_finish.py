"""The one-launch solve's result, written where the solve ends, on the CPU:
the persistent kernels' plain versions return what the kernels write
(csrc/prologue.cuh ``write_finish``).  Bit for bit ``solver._finish`` on
the same launch's carry, at the stop, at the cap, where the stop and the
cap fall on one round, at the first check of a resumed launch, in
relative mode and over chunkings; a launch not asked for the result returns
its carry (what ``checkpoint.step`` resumes from); ``finishes`` counts one a
solve.  The card's kernels are held to the same in ``test_torch_cuda.py``."""

import pytest

torch = pytest.importorskip("torch")

from eigen_value_tpu_torch import fixtures as tfx  # noqa: E402
from eigen_value_tpu_torch.ops.cuda import kernels as tk  # noqa: E402
from eigen_value_tpu_torch.ops.solver import _finish  # noqa: E402
from eigen_value_tpu_torch.ops.solver_matvec import _Carry, solve_multiround  # noqa: E402

EPS = 1e-3
#: the solve's knobs → (wrapper, the wrapper's knobs)
KERNELS = {
    "stripes": ({}, tk.multiround, {}),
    "triangle": (dict(symmetric=True), tk.multiround_sym, dict(sym=True)),
    "dense_tiled": (dict(cache_tiles=2), tk.multiround_sym, dict(sym=False, cache_tiles=2)),
}
N = 256
ROUNDS = tfx.HILBERT_ROUNDS[N]  # 10


def parent_solve(A, max_itr, wrapper, knobs, chunk=None, eps_mode="absolute"):
    """``solve_multiround`` as it was before its kernels wrote the result:
    the same launches, each returning its carry, then ``_finish``."""
    chunk = max_itr + 1 if chunk is None else chunk
    kw = dict(chunk=chunk, eps=EPS, eps_mode=eps_mode, **knobs)
    ones = torch.ones(A.shape[0])
    ev, v, adv, lam = wrapper(A, ones, ones, torch.zeros(()), max_itr, init=True, **kw)
    c = _Carry(ev, v, lam, int(adv))
    frozen = c.i < chunk - 1
    while not frozen and c.i < max_itr:
        ev, v, adv, lam = wrapper(A, c.ev, c.v, c.lam, max_itr - c.i, init=False, **kw)
        c = _Carry(ev, v, lam, c.i + int(adv))
        frozen = int(adv) < chunk
    return _finish(c, max_itr)


def same_result(got, want):
    assert got.rounds.dtype == torch.int32 and got.rounds.shape == ()
    assert got.converged.dtype == torch.bool and got.converged.shape == ()
    assert int(got.rounds) == int(want.rounds)
    assert bool(got.converged) == bool(want.converged)
    assert torch.equal(got.eigenvalue, want.eigenvalue)
    assert torch.equal(got.eigenvector, want.eigenvector)


#: a solve → (n, max_itr, chunk, eps_mode, rounds, converged)
SOLVES = {
    "converged_128": (128, 1000, None, "absolute", 9, True),
    "converged_256": (N, 1000, None, "absolute", ROUNDS, True),
    "converged_512": (512, 1000, None, "absolute", 12, True),
    "cap_below_the_rounds": (N, 6, None, "absolute", 6, False),
    "cap_of_no_round": (N, 0, None, "absolute", 0, False),
    # the stop would fire at the check of round max_itr, which the cap takes
    "stop_where_the_budget_ends": (N, ROUNDS, 20, "absolute", ROUNDS, False),
    # the first launch advances every round but the last; the second stops
    # at its first check (r == 0), on the carry it was given
    "resumed_launch_stops_at_r0": (N, 1000, ROUNDS + 1, "absolute", ROUNDS, True),
    "relative": (N, 1000, None, "relative", None, True),
    "chunk_1": (N, 1000, 1, "absolute", ROUNDS, True),
    "chunk_2": (N, 1000, 2, "absolute", ROUNDS, True),
    "chunk_5": (N, 1000, 5, "absolute", ROUNDS, True),
    "chunk_5_at_the_cap": (N, 7, 5, "absolute", 7, False),
}


@pytest.mark.parametrize("case", list(SOLVES))
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_the_solve_is_finish_of_the_carry_bit_for_bit(kernel, case):
    n, max_itr, chunk, eps_mode, rounds, converged = SOLVES[case]
    knobs, wrapper, wkw = KERNELS[kernel]
    H = tfx.hilbert_matrix(n)
    got = solve_multiround(H, EPS, max_itr, chunk=chunk, eps_mode=eps_mode, **knobs)
    same_result(got, parent_solve(H, max_itr, wrapper, wkw, chunk, eps_mode))
    assert bool(got.converged) == converged
    if rounds is not None:
        assert int(got.rounds) == rounds


def _carry_after(rounds, wrapper, wkw, H):
    """``(ev, v, λ)`` after ``rounds`` rounds of Hilbert N² (at ``ROUNDS``,
    a launch resumed from it stops at its first check)."""
    ones = torch.ones(N)
    ev, v, adv, lam = wrapper(H, ones, ones, 0.0, 1000, chunk=rounds + 1, eps=EPS, init=True,
                              **wkw)
    assert int(adv) == rounds
    return ev, v, lam


#: a launch → (init, chunk, budget, rounds before it, eps_mode, whether it
#: ends the solve, whether the solve converged); a launch with init False
#: resumes from the carry after the rounds before it
LAUNCHES = {
    "stop": (True, 1001, 1000, 0, "absolute", True, True),
    "cap": (True, 1001, 6, 0, "absolute", True, False),
    "stop_where_the_budget_ends": (True, 20, ROUNDS, 0, "absolute", True, False),
    "resumed_stop_at_r0": (False, 3, 1000 - ROUNDS, ROUNDS, "absolute", True, True),
    "chunk_used_up": (True, 4, 1000, 0, "absolute", False, False),
    "resumed_chunk_used_up": (False, 2, 20, 3, "absolute", False, False),
    "resumed_cap": (False, 5, 2, 3, "absolute", True, False),
    "relative": (True, 1001, 1000, 0, "relative", True, True),
}


@pytest.mark.parametrize("case", list(LAUNCHES))
@pytest.mark.parametrize("kernel", ["stripes", "triangle"])
def test_a_launch_asked_for_the_result_writes_finish_of_its_carry(kernel, case):
    init, chunk, budget, before, eps_mode, ends, converged = LAUNCHES[case]
    _, wrapper, wkw = KERNELS[kernel]
    H = tfx.hilbert_matrix(N)
    if not init:
        ev, v, lam = _carry_after(before, wrapper, wkw, H)
    else:
        ev = v = torch.ones(N)
        lam = torch.zeros(())
    kw = dict(chunk=chunk, eps=EPS, init=init, eps_mode=eps_mode, **wkw)
    carry = wrapper(H, ev, v, lam, budget, **kw)
    got = wrapper(H, ev, v, lam, budget, finish=before, **kw)
    assert len(carry) == 4 and len(got) == 6
    adv = int(carry[2])
    assert torch.equal(got[1], carry[1]) and torch.equal(got[2], carry[2])
    assert int(got[4]) == before + adv and bool(got[5]) == converged
    # the launch ended the solve where it halted (advanced fewer rounds than
    # its chunk held) or used up its budget
    assert (adv < chunk - init or adv >= budget) == ends
    want = _finish(_Carry(carry[0], carry[1], carry[3], before + adv), before + budget)
    if ends:
        assert torch.equal(got[0], want.eigenvector) and torch.equal(got[3], want.eigenvalue)
    # a launch that leaves the solve running, or that reached the cap,
    # returns the carry the next launch resumes from
    if not converged:
        assert torch.equal(got[0], carry[0]) and torch.equal(got[3], carry[3])
    else:
        assert not torch.equal(got[0], carry[0])


@pytest.mark.parametrize("chunk", [None, 5])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_finishes_counts_one_a_solve(kernel, chunk):
    knobs, wrapper, _ = KERNELS[kernel]
    H = tfx.hilbert_matrix(N)
    before, launches = wrapper.finishes, wrapper.launches
    for max_itr in (1000, 4):
        solve_multiround(H, EPS, max_itr, chunk=chunk, **knobs)
    assert wrapper.finishes == before + 2
    assert wrapper.launches == launches  # the plain versions launch nothing
