"""The one-launch solve's binding, with the plain versions in place of the
card's launch (each test's ``plain_launch``): ``kernels.multiround_solve``
and ``kernels.multiround_sym_solve`` return what one whole-budget launch of
their wrapper returns, bit for bit; a binding is kept for its key and its
plan, replaced in its (device, stream) slot by a call of another key or
under another plan, and freed by ``drop_bindings``; it checks A with the
wrapper's words; ``binds`` counts the bindings made and ``launches`` only
the card's launches.  The stripes launch gives the dot formulation's
segment sums and work counters to each launch of its own.
``solve_multiround`` on the CPU, or chunked, calls the wrappers as before.
The card's bindings are held to the same in ``test_torch_cuda.py``."""

import collections
import ctypes
import functools

import pytest

torch = pytest.importorskip("torch")

from eigen_value_tpu_torch import fixtures as tfx  # noqa: E402
from eigen_value_tpu_torch.device import StripesPlan  # noqa: E402
from eigen_value_tpu_torch.ops.cuda import kernels as tk  # noqa: E402
from eigen_value_tpu_torch.ops.solver_matvec import solve_multiround  # noqa: E402
from eigen_value_tpu_torch.utils.profiling import recording  # noqa: E402

EPS = 1e-3
N = 256
#: a bound solve → (its entry, its wrapper, the knobs both take)
BOUND = {
    "stripes": (tk.multiround_solve, tk.multiround, {}),
    "stripes_dot": (tk.multiround_solve, tk.multiround, dict(formulation="dot")),
    "triangle": (tk.multiround_sym_solve, tk.multiround_sym, dict(sym=True)),
    "triangle_cached": (tk.multiround_sym_solve, tk.multiround_sym, dict(sym=True, cache_tiles=1)),
    "dense_tiled": (tk.multiround_sym_solve, tk.multiround_sym, dict(sym=False, cache_tiles=2)),
}


#: the card's launch body of the stripes kernel, before any test replaces it
STRIPES_LAUNCHER = tk._stripes_launcher
#: a stand-in plan: the ring, the tiled kernel's split, and the cache it
#: was looked up for (which the plain version takes)
Plan = collections.namedtuple("Plan", "ring split cache_tiles")


def plain_run(plain, **knobs):
    """A launch body that runs ``plain`` (a persistent kernel's plain
    version) and writes its results into the launch's outputs."""

    def run(A, ev, v, lam, budget, chunk, init, ev_out, v_out, adv, lam_out,
            rounds_out=None, converged_out=None, rounds0=0):
        got = plain(A, ev, v, lam, budget, chunk=chunk, init=init, finish=rounds0, **knobs)
        for out, val in zip((ev_out, v_out, adv, lam_out, rounds_out, converged_out), got):
            out.copy_(val)

    return run


@pytest.fixture(autouse=True)
def plain_launch(monkeypatch):
    """Bindings on the CPU: the fit checks pass, the plans are stand-ins
    cached per key (one object a key, as the card's plans are), and each
    binding's launch body runs the plain version.  No binding outlives a
    test."""

    @functools.lru_cache(maxsize=None)
    def stripes_plan(device, n, dtype=torch.float32, dot=False):
        return Plan(0, 1, 0)

    @functools.lru_cache(maxsize=None)
    def sym_plan(device, n, bt, cache_tiles, sym, dtype=torch.float32, dot=False, mixed=False,
                 pipelined=False):
        return Plan(0, 1, cache_tiles)

    def stripes_launcher(dev, plan, n, dtype, eps, eps_mode, formulation, raw):
        return plain_run(tk.multiround_plain, eps=eps, eps_mode=eps_mode, formulation=formulation)

    def sym_launcher(dev, plan, n, bt, dtype, eps, eps_mode, sym, formulation, m, fill_mode,
                     raw, part, part_t):
        return plain_run(tk.multiround_sym_plain, eps=eps, eps_mode=eps_mode, tile=bt,
                         cache_tiles=plan.cache_tiles, sym=sym, formulation=formulation,
                         mxu_tiles=m if formulation == "mixed" else None, fill_mode=fill_mode)

    for name, value in (("multiround_fits", lambda *a, **k: True),
                        ("multiround_sym_fits", lambda *a, **k: True),
                        ("multiround_launch_plan", stripes_plan), ("multiround_sym_plan", sym_plan),
                        ("_stripes_launcher", stripes_launcher), ("_sym_launcher", sym_launcher)):
        monkeypatch.setattr(tk, name, value)
    tk.drop_bindings()
    yield
    tk.drop_bindings()


def wrapper_solve(wrapper, A, ev0, budget, chunk, **kw):
    """The one launch ``solve_multiround`` makes through the wrapper, in the
    bound solve's order: ``(ev, advanced, λ, rounds, converged)``."""
    ev = torch.ones(A.shape[0]) if ev0 is None else ev0
    out = wrapper(A, ev, ev, torch.zeros(()), budget, chunk=chunk, init=True, finish=0, **kw)
    return out[0], out[2], out[3], out[4], out[5]


def same(got, want):
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and g.device == w.device
        assert torch.equal(g, w)


#: a solve → (n, budget, chunk, ev0 kind, eps_mode)
SOLVES = {
    "converged": (N, 1000, 1001, None, "absolute"),
    "chunk_past_the_budget": (N, 1000, 5000, None, "absolute"),
    "cap": (N, 6, 7, None, "absolute"),
    "cap_of_no_round": (N, 0, 1, None, "absolute"),
    "relative": (N, 1000, 1001, None, "relative"),
    "start_vector": (N, 1000, 1001, "linspace", "absolute"),
    "n_384": (384, 1000, 1001, None, "absolute"),
}


@pytest.mark.parametrize("case", list(SOLVES))
@pytest.mark.parametrize("kind", list(BOUND))
def test_the_bound_solve_is_one_wrapper_launch_bit_for_bit(kind, case):
    n, budget, chunk, start, eps_mode = SOLVES[case]
    solve, wrapper, kw = BOUND[kind]
    A = tfx.hilbert_matrix(n)
    ev0 = None if start is None else torch.linspace(1.0, 2.0, n)
    kw = dict(kw, eps=EPS, eps_mode=eps_mode)
    got = solve(A, ev0, budget, chunk=chunk, **kw)
    same(got, wrapper_solve(wrapper, A, ev0, budget, chunk, **kw))
    assert int(got[3]) == int(got[1]) <= budget


def test_results_of_earlier_calls_are_their_own():
    solve, _, kw = BOUND["triangle_cached"]
    mats = [tfx.scaled_hilbert_matrix(N, torch.Generator().manual_seed(s)) for s in range(4)]
    first = solve(mats[0], None, 1000, chunk=1001, eps=EPS, **kw)
    kept = [t.clone() for t in first]
    later = [solve(A, None, 1000, chunk=1001, eps=EPS, **kw) for A in mats[1:]]
    for t, k in zip(first, kept):
        assert torch.equal(t, k)
    for out in later:  # each call returns tensors of its own, none of them kept
        assert all(a is not b for a, b in zip(out, first))
        held = tk._BINDINGS[(torch.device("cpu"), None)]
        assert all(t is not held.v and t is not held.ones for t in out)


def test_a_binding_is_kept_for_its_key_and_replaced_for_another():
    A = tfx.hilbert_matrix(N)
    kw = dict(chunk=1001, eps=EPS)
    binds = (tk.multiround.binds, tk.multiround_sym.binds)

    def counts():
        return tk.multiround.binds - binds[0], tk.multiround_sym.binds - binds[1]

    tk.multiround_sym_solve(A, None, 1000, **kw)
    held = tk._BINDINGS[(torch.device("cpu"), None)]
    tk.multiround_sym_solve(tfx.hilbert_matrix(N) * 2, None, 1000, **kw)  # another A, one key
    tk.multiround_sym_solve(A, torch.linspace(1.0, 2.0, N), 5, chunk=6, eps=EPS)
    assert counts() == (0, 1) and tk._BINDINGS[(torch.device("cpu"), None)] is held
    # every part of the key rebinds, and the slot keeps one binding
    for i, call in enumerate([
        lambda: tk.multiround_sym_solve(tfx.hilbert_matrix(384), None, 1000, **kw),  # n
        lambda: tk.multiround_sym_solve(A.to(torch.bfloat16), None, 1000, **kw),  # dtype
        lambda: tk.multiround_sym_solve(A, None, 1000, cache_tiles=1, **kw),  # cache
        lambda: tk.multiround_sym_solve(A, None, 1000, sym=False, **kw),  # kernel
        lambda: tk.multiround_sym_solve(A, None, 1000, chunk=1001, eps=2e-3),  # eps
        lambda: tk.multiround_sym_solve(A, None, 1000, eps_mode="relative", **kw),  # eps_mode
        lambda: tk.multiround_sym_solve(A, None, 1000, formulation="dot", **kw),  # formulation
    ]):
        call()
        call()  # a repeat does not rebind
        assert counts() == (0, 2 + i) and len(tk._BINDINGS) == 1
    tk.multiround_solve(A, None, 1000, **kw)  # the stripes kernel takes the slot over
    tk.multiround_solve(A, None, 1000, **kw)
    assert counts() == (1, 8) and len(tk._BINDINGS) == 1
    assert tk._BINDINGS[(torch.device("cpu"), None)].key[0] == "stripes"


def test_drop_bindings_frees_every_binding():
    A = tfx.hilbert_matrix(N)
    tk.multiround_solve(A, None, 1000, chunk=1001, eps=EPS)
    held = tk._BINDINGS[(torch.device("cpu"), None)]
    binds = tk.multiround.binds
    tk.drop_bindings()
    assert tk._BINDINGS == {}
    tk.multiround_solve(A, None, 1000, chunk=1001, eps=EPS)
    assert tk.multiround.binds == binds + 1
    assert tk._BINDINGS[(torch.device("cpu"), None)] is not held


@pytest.mark.parametrize("kind", ["stripes", "triangle", "dense_tiled"])
def test_another_plan_for_the_key_rebinds(kind, monkeypatch):
    """A binding holds while the plan that a launch would look up is its
    own: a cleared plan cache (a new ring depth, say) or a patched plan
    function rebinds, and the repeat after it does not."""
    solve, wrapper, kw = BOUND[kind]
    name = "multiround_launch_plan" if kind == "stripes" else "multiround_sym_plan"
    A = tfx.hilbert_matrix(N)
    binds = wrapper.binds

    def solves():
        for _ in range(2):
            solve(A, None, 1000, chunk=1001, eps=EPS, **kw)

    solves()
    assert wrapper.binds == binds + 1
    getattr(tk, name).cache_clear()
    solves()
    assert wrapper.binds == binds + 2
    other = Plan(0, 1, kw.get("cache_tiles", 0))
    monkeypatch.setattr(tk, name, lambda *args, **kwargs: other)
    solves()
    assert wrapper.binds == binds + 3 and len(tk._BINDINGS) == 1
    assert tk._BINDINGS[(torch.device("cpu"), None)].plan is other


def test_each_dot_launch_has_its_own_counters_and_sums(monkeypatch):
    """The stripes kernel's dot formulation reads work counters that are 0
    at its launch and segment sums of its own, also where another launch
    on the stream comes between a launch's set-up and its start, as two
    host threads on one stream may order them; the kernel leaves its last
    rounds' counts in the counters."""
    n = 256
    seen = []

    def launch():
        ev = torch.ones(n)
        run(torch.ones(n, n), ev, ev, torch.zeros(()), 10, 11, True, torch.empty(n),
            torch.empty(n), torch.empty((), dtype=torch.int32), torch.empty(()))

    def call(dev, entry, args, what):
        *_, dot, part, work, stamps, elem, grid, stream = args
        assert dot == 1 and what == "multiround"
        if not seen:
            seen.append(None)
            launch()  # the other thread's launch, between this one's set-up and its start
        counters = [ctypes.c_int32.from_address(work + 4 * i) for i in (0, 1)]
        seen.append((part, [c.value for c in counters]))
        for c in counters:
            c.value = 7

    monkeypatch.setattr(tk, "_entry", lambda dev, name: (None, 0))
    monkeypatch.setattr(tk, "_call", call)
    run = STRIPES_LAUNCHER(torch.device("cpu"), StripesPlan(1, 0, 0, 0), n, torch.float32, EPS,
                           "absolute", "dot", torch.empty(2 * n))
    launches = tk.multiround.launches
    launch()
    launch()
    (inner, inner_work), (outer, outer_work), (_, last_work) = seen[1:]
    assert inner_work == outer_work == last_work == [0, 0]
    assert inner != outer  # both launches' sums were alive at once, apart
    assert tk.multiround.launches == launches + 3


@pytest.mark.parametrize("kind", list(BOUND))
def test_binds_and_launches_count_as_documented(kind):
    """``binds`` counts the bindings made, on any device; ``launches`` the
    kernel launches, which the plain versions standing in make none of."""
    solve, wrapper, kw = BOUND[kind]
    A = tfx.hilbert_matrix(N)
    binds, launches = wrapper.binds, wrapper.launches
    for _ in range(3):
        solve(A, None, 1000, chunk=1001, eps=EPS, **kw)
    assert wrapper.binds == binds + 1 and wrapper.launches == launches


def _bad(kind):
    A = tfx.hilbert_matrix(N)
    return {
        "not_square": (torch.ones(N, N + 1), None, 1001, "A must be square"),
        "not_2d": (torch.ones(N), None, 1001, "A must be square"),
        "float64": (A.double(), None, 1001, "A must be float32 or bfloat16 or float16"),
        "not_contiguous": (torch.rand(N, N).T, None, 1001, "A must be contiguous"),
        "start_vector_shape": (A, torch.ones(N + 1), 1001, "ev must have shape"),
        "start_vector_dtype": (A, torch.ones(N, dtype=torch.float64), 1001,
                               "ev must be float32"),
        "chunk": (A, None, 0, "chunk must be >= 1"),
    }[kind]


@pytest.mark.parametrize("bound_first", [False, True])
@pytest.mark.parametrize("bad", ["not_square", "not_2d", "float64", "not_contiguous",
                                 "start_vector_shape", "start_vector_dtype", "chunk"])
@pytest.mark.parametrize("kind", ["stripes", "triangle"])
def test_a_binding_rejects_what_its_wrapper_rejects(kind, bad, bound_first):
    """With the wrapper's words, on a fresh slot and on one already bound
    for the key that A's n and dtype give."""
    solve, wrapper, kw = BOUND[kind]
    A, ev0, chunk, match = _bad(bad)
    if bound_first:  # float32 at n = N: A's key where A is float32 at that n
        solve(torch.ones(N, N), None, 1000, chunk=1001, eps=EPS, **kw)
    with pytest.raises(ValueError, match=match):
        solve(A, ev0, 1000, chunk=chunk, eps=EPS, **kw)
    with pytest.raises(ValueError, match=match):
        wrapper_solve(wrapper, A, ev0, 1000, chunk, eps=EPS, **kw)


@pytest.mark.parametrize("kind", list(BOUND))
def test_the_bound_solve_is_its_wrappers_span(kind):
    solve, wrapper, kw = BOUND[kind]
    A = tfx.hilbert_matrix(N)
    with recording() as spans:
        for _ in range(2):
            solve(A, None, 1000, chunk=1001, eps=EPS, **kw)
    assert [s.name for s in spans] == [f"launch.{wrapper.__name__}"] * 2


@pytest.mark.parametrize("chunk", [None, 5, 1001])
@pytest.mark.parametrize("kind", ["stripes", "triangle", "dense_tiled"])
def test_solve_multiround_on_the_cpu_calls_the_wrappers(monkeypatch, kind, chunk):
    """On the CPU ``solve_multiround`` launches through the wrappers for any
    chunk, as before, and makes no binding; so do chunked solves."""
    solve, wrapper, kw = BOUND[kind]
    knobs = {"stripes": {}, "triangle": dict(symmetric=True),
             "dense_tiled": dict(cache_tiles=2)}[kind]
    calls = []

    def spy(*args, **kwargs):
        calls.append(kwargs["init"])
        return wrapper(*args, **kwargs)

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU solve took the bound path")

    monkeypatch.setattr(tk, wrapper.__name__, spy)
    monkeypatch.setattr(tk, solve.__name__, refuse)
    binds = wrapper.binds
    got = solve_multiround(tfx.hilbert_matrix(N), EPS, 1000, chunk=chunk, **knobs)
    assert int(got.rounds) == tfx.HILBERT_ROUNDS[N] and bool(got.converged)
    assert calls[0] is True and len(calls) == (3 if chunk == 5 else 1)
    assert wrapper.binds == binds and tk._BINDINGS == {}
