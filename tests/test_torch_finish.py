"""The one-launch solve's result, written where the solve ends, on the CPU:
the persistent kernels' plain versions return what the kernels write
(csrc/prologue.cuh ``write_finish``).  Bit for bit ``solver._finish`` on
the same launch's carry, at the stop, at the cap, where the stop and the
cap fall on one round, at the first check of a resumed launch, in
relative mode and over chunkings; a launch not asked for the result returns
its carry; the solve returns its last launch's result tensors and opens no
``solver.finish`` span.  The matvec kernel loop (``solve_matvec_kernel``), whose glue
writes the result round by round (csrc/round_glue.cu), is held bit for bit
to the host loop it replaced, ``_finish(_run_rounds(...))``, on the plain
versions.  The card's kernels are held to the same in ``test_torch_cuda.py``."""

import pytest

torch = pytest.importorskip("torch")

from eigen_value_tpu_torch import fixtures as tfx  # noqa: E402
from eigen_value_tpu_torch.ops.cuda import kernels as tk  # noqa: E402
from eigen_value_tpu_torch.ops.solver import _finish, stop_check  # noqa: E402
from eigen_value_tpu_torch.ops.solver_matvec import (  # noqa: E402
    _Carry,
    _init_carry,
    _run_rounds,
    solve_matvec_kernel,
    solve_multiround,
)
from eigen_value_tpu_torch.utils.profiling import recording  # noqa: E402

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
def test_the_solve_returns_its_last_launchs_result(monkeypatch, kernel, chunk):
    knobs, wrapper, _ = KERNELS[kernel]
    H = tfx.hilbert_matrix(N)
    launches = wrapper.launches
    outs = []

    def spy(*args, **kw):
        outs.append(wrapper(*args, **kw))
        return outs[-1]

    monkeypatch.setattr(tk, wrapper.__name__, spy)
    for max_itr in (1000, 4):
        outs.clear()
        with recording() as spans:
            got = solve_multiround(H, EPS, max_itr, chunk=chunk, **knobs)
        assert (len(outs) > 1) == (chunk is not None and max_itr > chunk)
        assert all(len(out) == 6 for out in outs)  # every launch is asked for the result
        ev, _, _, lam, rounds, converged = outs[-1]
        assert got.eigenvector is ev and got.eigenvalue is lam
        assert got.rounds is rounds and got.converged is converged
        names = {s.name for s in spans}
        assert "solver.multiround" in names and "solver.finish" not in names
    assert wrapper.launches == launches  # the plain versions launch nothing


# --- the matvec kernel loop: the round glue writes the result ----------------


def host_loop(A, max_itr, eps_mode="absolute", ev0=None):
    """``solve_matvec_kernel`` as it was before its glue wrote the result:
    the shared host loop over ``kernels.matvec``, then ``_finish``."""

    def next_v(ev):
        return tk.matvec(A, ev) / ev

    c = _init_carry(A.shape[0], next_v, torch.float32, A.device, ev0)
    return _finish(_run_rounds(next_v, c, EPS, max_itr, eps_mode)[0], max_itr)


def glue_matrix(kind, n):
    if kind == "hilbert_scaled":  # the kind of matrix the benchmark's cells solve
        return tfx.scaled_hilbert_matrix(n, torch.Generator().manual_seed(n))
    return tfx.random_positive_matrix(n, torch.Generator().manual_seed(n))


@pytest.mark.parametrize("eps_mode", ["absolute", "relative"])
@pytest.mark.parametrize("n", [384, 1024])
@pytest.mark.parametrize("kind", ["hilbert_scaled", "random"])
def test_the_matvec_loop_is_finish_of_its_rounds_bit_for_bit(kind, n, eps_mode):
    A = glue_matrix(kind, n)
    launches = (tk.matvec.launches, tk.round_glue.launches)
    for max_itr in (0, 1, 3, 1000):
        got = solve_matvec_kernel(A, EPS, max_itr, eps_mode=eps_mode)
        want = host_loop(A, max_itr, eps_mode)
        same_result(got, want)
        # the random matrices stop in 2-3 rounds in relative mode
        assert bool(got.converged) == (max_itr == 1000) or kind == "random"
    assert bool(got.converged)
    assert (tk.matvec.launches, tk.round_glue.launches) == launches  # the plain versions


def test_the_matvec_loop_keeps_the_callers_start_vector():
    H = tfx.hilbert_matrix(N)
    ev0 = torch.linspace(1.0, 2.0, N)
    keep = ev0.clone()
    got = solve_matvec_kernel(H, EPS, 1000, ev0=ev0)
    assert torch.equal(ev0, keep) and got.eigenvector.data_ptr() != ev0.data_ptr()
    same_result(got, host_loop(H, 1000, ev0=ev0))


def glue_buffers(n, seed):
    g = torch.Generator().manual_seed(seed)
    y, ev = torch.rand(n, generator=g) + 0.5, torch.rand(n, generator=g) + 0.5
    scalars = [torch.empty((), dtype=dt) for dt in (torch.float32, torch.int32, torch.bool)]
    return (y, ev, *scalars)


@pytest.mark.parametrize("eps_mode", ["absolute", "relative"])
@pytest.mark.parametrize("n", [1, 3, 1000])
def test_round_glue_writes_the_rounds_expressions(n, eps_mode):
    """``round_glue`` on the CPU (its plain version): v = y / ev, the stop,
    then ev · (v / m), λ = v[0] and the round's count whatever the stop."""
    for close in (False, True):
        y, ev, lam, rounds, conv = glue_buffers(n, n)
        if close:
            y = ev * (1 + 1e-5 * torch.rand(n, generator=torch.Generator().manual_seed(1)))
        v = y / ev
        want_ev = ev * (v / torch.max(v))
        stop = bool(stop_check(v, EPS, eps_mode))
        assert stop == (close or n == 1)
        launches = tk.round_glue.launches
        tk.round_glue(y, ev, EPS, 6, lam, rounds, conv, eps_mode=eps_mode)
        assert tk.round_glue.launches == launches
        assert torch.equal(ev, want_ev) and torch.equal(lam, v[0])
        assert int(rounds) == (6 if stop else 7) and bool(conv) == stop


def _rejects(**bad):
    y, ev, lam, rounds, conv = glue_buffers(8, 0)
    kw = dict(y=y, ev=ev, eps=EPS, i=0, lam=lam, rounds=rounds, converged=conv)
    kw.update(bad)
    if kw["ev"] is None:  # y as ev too
        kw["ev"] = y
    return kw


@pytest.mark.parametrize("kw, match", [
    (_rejects(y=torch.ones(8, dtype=torch.float64)), "y must be float32"),
    (_rejects(y=torch.ones(())), "non-empty vector"),
    (_rejects(ev=torch.ones(9)), "ev must have shape"),
    (_rejects(lam=torch.zeros(1)), "lam must have shape"),
    (_rejects(rounds=torch.zeros((), dtype=torch.int64)), "rounds must be int32"),
    (_rejects(converged=torch.zeros((), dtype=torch.uint8)), "converged must be bool"),
    (_rejects(eps_mode="rel"), "eps_mode must be"),
    (_rejects(ev=None), "must not overlap"),
], ids=lambda x: x if isinstance(x, str) else None)
def test_round_glue_rejects(kw, match):
    with pytest.raises(ValueError, match=match):
        tk.round_glue(**kw)


def test_a_bound_matvec_writes_into_its_buffer():
    H = tfx.hilbert_matrix(64)
    x = torch.linspace(0.5, 1.5, 64)
    out = torch.empty(64)
    bound = tk.matvec_bound(H, x, out)
    assert bound() is out and torch.equal(out, tk.matvec(H, x))
    x.mul_(2)  # each call reads x as it is then
    assert torch.equal(bound(), tk.matvec(H, x))
    with pytest.raises(ValueError, match="out must not overlap x"):
        tk.matvec_bound(H, x, x)
    with pytest.raises(ValueError, match="out must have shape"):
        tk.matvec_bound(H, x, torch.empty(63))
