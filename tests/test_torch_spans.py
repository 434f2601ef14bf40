"""The port's spans (``eigen_value_tpu_torch.utils.profiling``) on the CPU:
off, they record nothing and cost one shared object; on, every route of
``max_eigenvalue``'s single-card path gives its span tree, its reads, and
self times that add up to the call; spans close on an exception; and
``trace()`` shows them as ranges in its chrome trace.  The one-launch
routes (``solver.multiround``) and the matvec kernel loop
(``solver.matvec_kernel``, whose glue kernel writes the result each round)
open no ``solver.finish``; every other route runs ``_finish`` once."""

import json
import os
from collections import Counter

import pytest

torch = pytest.importorskip("torch")

import eigen_value_tpu_torch as evt  # noqa: E402
from eigen_value_tpu_torch import fixtures as tfx  # noqa: E402
from eigen_value_tpu_torch.ops.cuda import kernels  # noqa: E402
from eigen_value_tpu_torch.utils import profiling  # noqa: E402

N = 256
#: Hilbert 256²'s rounds (the reference's table).
ROUNDS = 10

#: backend knobs → (route span, launch spans a solve, reads a solve)
ROUTES = {
    "triangle": (dict(backend="multiround", symmetric=True), "solver.multiround",
                 {"launch.multiround_sym": 1}, 1),
    "stripes": (dict(backend="multiround"), "solver.multiround", {"launch.multiround": 1}, 1),
    "stripes_chunk4": (dict(backend="multiround", chunk=4), "solver.multiround",
                       {"launch.multiround": 3}, 3),
    "matvec_kernel_loop": (dict(backend="matvec_pallas"), "solver.matvec_kernel",
                           {"launch.matvec": ROUNDS + 1, "launch.round_glue": ROUNDS + 1},
                           ROUNDS + 1),
    "torch_mv_loop": (dict(backend="matvec"), "solver.matvec", {}, ROUNDS + 1),
    "xla": (dict(backend="xla"), "solver.xla", {}, ROUNDS + 1),
    "pallas": (dict(backend="pallas"), "solver.kernel",
               {"launch.rowsum": 1, "launch.scale_rowsum": ROUNDS}, ROUNDS + 1),
}


@pytest.fixture(scope="module")
def H():
    return tfx.hilbert_matrix(N)


def solve(H, **knobs):
    return evt.max_eigenvalue(H, evt.SolverConfig(**knobs), device="cpu")


def self_times(spans):
    """Each span's length less its direct children's, by span."""
    out = {}
    for s in spans:
        kids = [c for c in spans if c.parent == s.name and c.call == s.call
                and s.t0 <= c.t0 and c.t1 <= s.t1 and c is not s]
        out[s] = (s.t1 - s.t0) - sum(c.t1 - c.t0 for c in kids)
    return out


def test_off_returns_one_shared_object_and_records_nothing(H, monkeypatch):
    assert profiling.span("a") is profiling.span("b") is profiling.annotate("c")
    with profiling.span("a") as s:
        assert s is profiling.span("z")

    def no(*a, **k):
        raise AssertionError("a span that is off read the clock or opened a range")

    monkeypatch.setattr(profiling.time, "perf_counter_ns", no)
    monkeypatch.setattr(torch.profiler, "record_function", no)
    res = solve(H, backend="multiround", symmetric=True)
    assert int(res.rounds) == ROUNDS
    monkeypatch.undo()
    assert profiling._open == []
    with profiling.recording() as rec:
        pass
    assert rec == []


@pytest.mark.parametrize("route", list(ROUTES))
def test_each_route_gives_its_span_tree(H, route):
    knobs, solver, launches, reads = ROUTES[route]
    with profiling.recording() as rec:
        res = solve(H, **knobs)
    assert int(res.rounds) == ROUNDS and bool(res.converged)
    calls = {s.call for s in rec}
    assert len(calls) == 1 and None not in calls
    got = Counter((s.name, s.parent) for s in rec)
    want = Counter({("api.call", None): 1, ("api.prepare", "api.call"): 1,
                    (solver, "api.call"): 1, ("solver.read", solver): reads})
    if solver not in ("solver.multiround", "solver.matvec_kernel"):
        want[("solver.finish", solver)] = 1
    want.update({(name, solver): k for name, k in launches.items()})
    assert got == want
    # every span lies inside the call, and each closed in order
    call, = [s for s in rec if s.name == "api.call"]
    assert rec[-1] is call
    assert all(call.t0 <= s.t0 <= s.t1 <= call.t1 for s in rec)


@pytest.mark.parametrize("route", ["triangle", "stripes", "matvec_kernel_loop", "torch_mv_loop"])
def test_reads_are_one_a_launch_or_rounds_plus_one_on_the_loops(H, route):
    knobs = ROUTES[route][0]
    with profiling.recording() as rec:
        res = solve(H, **knobs)
    reads = sum(s.name == "solver.read" for s in rec)
    loop = route.endswith("loop")
    assert reads == (int(res.rounds) + 1 if loop else 1)


@pytest.mark.parametrize("route", ["triangle", "matvec_kernel_loop", "pallas"])
def test_self_times_add_up_to_the_call(H, route):
    with profiling.recording() as rec:
        solve(H, **ROUTES[route][0])
    call, = [s for s in rec if s.name == "api.call"]
    assert sum(self_times(rec).values()) == call.t1 - call.t0
    assert all(t >= 0 for t in self_times(rec).values())


def test_two_calls_carry_two_ids_and_spans_outside_a_call_none(H):
    with profiling.recording() as rec:
        solve(H, backend="matvec_pallas")
        solve(H, backend="multiround")
        kernels.matvec(H, torch.ones(N))
    ids = [s.call for s in rec if s.name == "api.call"]
    assert len(set(ids)) == 2 and None not in ids
    for i in ids:
        assert {s.name for s in rec if s.call == i} >= {"api.call", "api.prepare", "solver.read"}
    lone = rec[-1]
    assert (lone.name, lone.call, lone.parent) == ("launch.matvec", None, None)


def test_spans_close_on_a_value_error(H):
    bad = H.clone()
    bad[3, 5] = -1.0
    with profiling.recording() as rec:
        with pytest.raises(ValueError, match="all entries > 0"):
            evt.max_eigenvalue(bad, device="cpu", validate=True)
        with pytest.raises(ValueError, match="chunk must be >= 1"):
            kernels.multiround(H, torch.ones(N), torch.ones(N), 0.0, 5, chunk=0, eps=1e-3)
    assert [(s.name, s.parent) for s in rec] == [
        ("api.prepare", "api.call"), ("api.call", None), ("launch.multiround", None)]
    assert profiling._open == []
    # spans are off again once the recording has ended
    assert profiling.span("after") is profiling.span("again")


def test_a_nested_recording_is_refused(H):
    with profiling.recording() as outer:
        solve(H, backend="multiround")
        with pytest.raises(RuntimeError, match="already being recorded"):
            with profiling.recording():
                pass
        solve(H, backend="multiround")
    assert len(outer) == 10
    # the refusal left the outer recording's end to turn spans off
    assert profiling.span("after") is profiling._OFF


def test_outside_trace_a_span_opens_no_record_function(H, monkeypatch):
    def no(*a, **k):
        raise AssertionError("record_function outside trace()")

    monkeypatch.setattr(torch.profiler, "record_function", no)
    with profiling.recording() as rec:
        solve(H, backend="multiround", symmetric=True)
    assert len(rec) == 5


def test_wrappers_keep_their_names_and_launch_counters():
    for name in ("matvec", "multiround", "multiround_sym", "rowsum", "scale_rowsum"):
        fn = getattr(kernels, name)
        assert fn.__name__ == name and isinstance(fn.launches, int)


def test_trace_shows_the_annotation_and_the_port_spans(tmp_path, H):
    with profiling.trace(str(tmp_path / "t")) as d:
        with profiling.annotate("headline solve"):
            solve(H, backend="multiround", symmetric=True)
    events = json.load(open(os.path.join(d, profiling.TRACE_FILE)))["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"headline solve", "api.call", "api.prepare", "solver.multiround", "solver.read",
            "launch.multiround_sym"} <= names
    assert "solver.finish" not in names
