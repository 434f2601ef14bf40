"""The spans slice (``spans.py``) and its six readers: on runs made by hand
with synthetic spans and device intervals, the labels of the idle gaps,
the clock mapping, and a traced run of the 384² cells on the CPU."""

import dataclasses
import time

import pytest
import torch

from evbench import spans, trace
from evbench.catalog import Catalog
from evbench.compare import Answer
from evbench.run import Run, run_cell
from evbench.spans import SpanUs, SpansSlice

CONFIG = {"n": 8192, "dtype": "float32", "storage_dtype": None}
SIX = ("api_host_us", "solver_host_us", "host_reads_per_solve", "launch_host_us",
       "allocs_per_solve", "call_idle_us")
HOST = SIX[:4]


def one_call(c, t):
    """The spans of one triangle call ``c`` starting at ``t`` µs: 100 µs
    long, prepare 10, the route 80 (a launch of 20, a read of 30, the
    finish 10)."""
    return [
        SpanUs("api.prepare", c, "api.call", t + 2, t + 12),
        SpanUs("launch.multiround_sym", c, "solver.multiround", t + 15, t + 35),
        SpanUs("solver.read", c, "solver.multiround", t + 40, t + 70),
        SpanUs("solver.finish", c, "solver.multiround", t + 75, t + 85),
        SpanUs("solver.multiround", c, "api.call", t + 14, t + 94),
        SpanUs("api.call", c, None, t, t + 100),
    ]


def two_calls(allocs=28):
    """Two calls at 0 and 150 µs in a slice of 0–300 µs; each call's kernel
    runs 30–65 µs into it, and a read of the answer 120–125 (the caller)."""
    sp = one_call(0, 0.0) + one_call(1, 150.0)
    device = []
    for t in (0.0, 150.0):
        device += [("multiround_sym_kernel<float>", t + 30, t + 65), ("Memcpy DtoH", t + 120, t + 125)]
    records = [(0, 1e-4, [Answer(0, 2.0, 17, True)]), (1.5e-4, 2.5e-4, [Answer(1, 2.0, 17, True)])]
    return SpansSlice(0.0, 300.0, device, sp, records, allocs, spans.Clock(2, 2, 0.0))


def make_run(s=None):
    records = [(0.0, 0.001, [Answer(0, 2.0, 17, True)])]
    run = Run(CONFIG, {"solver": {"symmetric": True}, "trace_calls": 2}, 1.0, records, 0.001,
              0, [], "NVIDIA H100 80GB HBM3", None)
    run.spans = s
    return run


def read(name, run):
    return Catalog().metric(name).read(run)


def test_each_reader_on_synthetic_spans():
    run = make_run(two_calls())
    # api.call 100 less the route 80 (prepare counts)
    assert read("api_host_us", run) == pytest.approx(20.0)
    # the route 80 less its launch 20 and read 30; the finish counts
    assert read("solver_host_us", run) == pytest.approx(30.0)
    assert read("host_reads_per_solve", run) == 1.0
    assert read("launch_host_us", run) == pytest.approx(20.0)
    assert read("allocs_per_solve", run) == 14.0
    # inside each call the device runs 30–65: idle 30 + 35
    assert read("call_idle_us", run) == pytest.approx(65.0)


def test_self_times_and_layers_of_a_call_add_up_to_it():
    s = two_calls()
    call = s.calls[0]
    own = [s.self_us(x) for x in s.by_call[call.call]]
    assert sum(own) == pytest.approx(call.us)
    assert sum(s.host_us().values()) == pytest.approx(call.us)


def test_readers_absent_without_spans():
    for name in SIX:
        assert read(name, make_run(None)) is None
    # spans but no card: the allocator and the device are not read
    run = make_run(dataclasses.replace(two_calls(allocs=None), device=[], clock=None))
    assert [read(n, run) is None for n in SIX] == [False] * 4 + [True, True]


def test_a_run_without_the_traced_slices_or_the_programs_spans_has_none(monkeypatch):
    run = make_run()
    del run.spans
    assert spans.of(run) is None and run.spans is None
    run = make_run()
    del run.spans
    run.slice = trace.Slice(0.0, 1.0, [], [], [])
    monkeypatch.setattr(spans, "program_spans", lambda: None)
    assert spans.of(run) is None


def test_idle_labelled_by_innermost_span_or_caller():
    s = two_calls()
    assert s.label(20) == "launch.multiround_sym"
    assert s.label(50) == "solver.read"
    assert s.label(72) == "solver.multiround"
    assert s.label(97) == "api.call"
    assert s.label(120) == "caller" and s.label(299) == "caller"
    # the gaps and their middles: 0–30 (15, the launch), 65–120 (92.5, the
    # route), 125–180 (152.5, call 1's prepare), 215–270 (242.5, the route),
    # 275–300 (287.5, no call open)
    assert s.idle_by_span() == pytest.approx([
        ("solver.multiround", 110e-6), ("api.prepare", 55e-6), ("launch.multiround_sym", 30e-6),
        ("caller", 25e-6)])
    assert sum(v for _, v in s.idle_by_span()) == pytest.approx((300 - 80) * 1e-6)


def test_causal_shifts_are_zero_for_a_sound_placement_and_measure_a_wrong_one():
    call, reads = (5.0, 12.0), [(20.0, 60.0)]
    # the kernel starts inside its launch call and ends before the read
    # returns: no shift
    assert spans.causal_shifts([(10.0, 50.0) + call], reads) == [0.0]
    # the device's timer put 2 ms early: to start as its call began
    assert spans.causal_shifts([(-1990.0, -1950.0) + call], reads) == [1995.0]
    # 0.5 ms late: to end as the read returned
    assert spans.causal_shifts([(510.0, 550.0) + call], reads) == [-490.0]
    # bounds that cross (the kernel longer than the host allows): their middle
    assert spans.causal_shifts([(10.0, 80.0) + call], reads) == [-12.5]
    # no read after the call: bounded below only
    assert spans.causal_shifts([(-100.0, -50.0) + call], []) == [105.0]


def kernel_ops(err=0.0, drift=0.0, skip=()):
    """The launch calls and kernels of :func:`two_calls` as ``clock_check``
    takes them: each call's launch call 25–33 µs into it, its kernel
    30–65; the device's times ``err`` µs off and ``drift`` µs more a µs
    later; ``skip``: calls whose launch call the profiler left out."""
    return [(t + 30 + err + drift * t, t + 65 + err + drift * t, t + 25, t + 33)
            for c, t in enumerate((0.0, 150.0)) if c not in skip]


def test_a_slice_on_one_clock_passes_the_check():
    got = spans.clock_check(two_calls().spans, kernel_ops())
    assert got == spans.Clock(2, 2, 0.0) and got.one
    # within the slack either way
    assert spans.clock_check(two_calls().spans, kernel_ops(err=-6.0)).one
    assert spans.clock_check(two_calls().spans, kernel_ops(err=6.9)).one


@pytest.mark.parametrize("err, drift", [(-2000.0, 0.0), (500.0, 0.0), (0.0, 0.05), (-7.5, 0.0)])
def test_device_times_off_the_spans_refuse_the_slice_and_its_idle_time(err, drift):
    """The device's times 2 ms early, 0.5 ms late, drifting 7.5 µs over the
    second call past its read's end, or 2.5 µs earlier than its launch call
    began."""
    clock = spans.clock_check(two_calls().spans, kernel_ops(err, drift))
    assert clock.anchored == 2 and clock.largest_shift_us > spans.CLOCK_SLACK_US
    run = make_run(dataclasses.replace(two_calls(), clock=clock))
    assert read("call_idle_us", run) is None
    # the host's metrics do not read the device
    assert read("api_host_us", run) == pytest.approx(20.0)


def test_a_launch_span_without_its_launch_call_refuses_the_slice():
    """The profiler's host times so far off that a launch call falls
    outside the span that made it (or a launch it never recorded)."""
    clock = spans.clock_check(two_calls().spans, kernel_ops(skip=(1,)))
    assert clock == spans.Clock(2, 1, 0.0) and not clock.one
    # a launch call outside every launch span anchors nothing
    far = [(a + 400, b + 400, c0 + 400, c1 + 400) for a, b, c0, c1 in kernel_ops()]
    assert spans.clock_check(two_calls().spans, far) == spans.Clock(2, 0, 0.0)
    assert not spans.Clock(0, 0, 0.0).one


def test_of_runs_the_slice_again_while_it_is_refused(monkeypatch):
    """Refused slices are logged and run again from new calls; the first
    on one clock is kept, and after :data:`spans.ATTEMPTS` the last."""
    lines, k0s = [], []
    cell = {"call": None, "sync": None, "device": None, "records": [None] * 10,
            "log": lambda *a, **k: lines.append(a[0])}
    monkeypatch.setattr(spans, "_run_cell_locals", lambda: cell)

    def measured(verdicts):
        it = iter(verdicts)

        def measure(call, k0, calls, warm, sync, device):
            k0s.append(k0)
            return dataclasses.replace(two_calls(), clock=spans.Clock(2, 2 if next(it) else 1, 0.0))

        return measure

    monkeypatch.setattr(spans, "measure", measured([False, False, True]))
    run = make_run()
    del run.spans
    run.slice = trace.Slice(0.0, 1.0, [], [], [])
    s = spans.of(run)
    assert s.on_one_clock and read("call_idle_us", run) == pytest.approx(65.0)
    # trace_calls 2 and 2 uncounted a slice, after the window's 10 and two slices
    assert k0s == [18, 22, 26]
    assert sum("refused" in line for line in lines) == 2
    monkeypatch.setattr(spans, "measure", measured([False] * spans.ATTEMPTS))
    run = make_run()
    del run.spans
    run.slice = trace.Slice(0.0, 1.0, [], [], [])
    assert not spans.of(run).on_one_clock and read("call_idle_us", run) is None
    assert read("host_reads_per_solve", run) == 1.0


def test_of_fails_loudly_outside_run_cell():
    """A program with spans, a traced run, and no ``run.run_cell`` frame to
    take the cell's call from: an error, not six metrics gone silent."""
    run = make_run()
    del run.spans
    run.slice = trace.Slice(0.0, 1.0, [], [], [])
    with pytest.raises(RuntimeError, match="outside evbench.run.run_cell"):
        spans.of(run)


def test_clock_mapping_under_a_known_offset():
    assert spans.to_trace_us(5_000, 1_000_000, 900_000) == 105.0
    off = spans.clock_offset_ns()
    assert abs(off - (time.time_ns() - time.perf_counter_ns())) < 5_000_000


def test_clock_mapping_holds_a_profiler_range():
    """A ``record_function`` range, timed by the profiler on the host, lies
    inside the perf_counter readings taken around it, once mapped."""
    from torch.profiler import ProfilerActivity, profile, record_function

    marks = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        offset = spans.clock_offset_ns()
        for k in range(3):
            t0 = time.perf_counter_ns()
            with record_function(f"range{k}"):
                torch.ones(4096).sum()
            marks.append((t0, time.perf_counter_ns()))
    start = prof.profiler.kineto_results.trace_start_ns()
    ranges = {e.name: e.time_range for e in prof.events() if e.name.startswith("range")}
    for k, (t0, t1) in enumerate(marks):
        r = ranges[f"range{k}"]
        assert spans.to_trace_us(t0, offset, start) <= r.start + 1
        assert r.end <= spans.to_trace_us(t1, offset, start) + 1


def untraced_slice(call, k0, calls, warm, sync, host):
    """``trace.profile_slice`` on the CPU, where the profiler's slices need
    a card: the same calls, untraced."""
    records = []
    for k in range(k0, k0 + warm + calls):
        t0 = time.perf_counter()
        answers = call(k)
        if k >= k0 + warm:
            records.append((t0, time.perf_counter(), answers))
    return trace.Slice(0.0, 1.0, [], [], records)


def traced_tiny_run(tiny, monkeypatch, traffic, lines):
    monkeypatch.setattr(trace, "profile_slice", untraced_slice)
    root, cells = tiny
    return run_cell(Catalog(root), cells[traffic], 2**31 + 5, 0.2, True, torch.device("cpu"),
                    time.perf_counter(), log=lambda *a, **k: lines.append(a[0]))


@pytest.mark.parametrize("traffic", ["sym", "dense"])
def test_the_tiny_cell_traced_gains_the_span_metrics(tiny, monkeypatch, traffic):
    """A ``--trace 1`` run of the 384² cell on the CPU (the profiler's
    slices stood in for); the spans slice is the program's own."""
    lines = []
    result = traced_tiny_run(tiny, monkeypatch, traffic, lines)
    assert result["correct"]
    got = result["metrics"]
    assert set(HOST) <= set(got) and not set(SIX[4:]) & set(got)
    # on the CPU "auto" takes the torch.mv loop: a read a round and one
    # more, no kernel wrapper
    assert got["host_reads_per_solve"]["value"] == got["rounds_per_solve"]["value"] + 1
    assert got["host_reads_per_solve"]["unit"] == "reads/solve"
    assert got["launch_host_us"]["value"] == 0.0
    assert got["api_host_us"]["value"] > 0 and got["solver_host_us"]["value"] > 0
    assert any(line.startswith("traced slice (device alone, spans on)") for line in lines)


def test_a_program_without_spans_runs_traced_without_the_span_metrics(tiny, monkeypatch):
    """An older checkout of the program under this benchmark: the run is
    as before, the six metrics absent."""
    monkeypatch.setattr(spans, "program_spans", lambda: None)
    lines = []
    result = traced_tiny_run(tiny, monkeypatch, "sym", lines)
    assert result["correct"] and "rounds_per_solve" in result["metrics"]
    assert not set(SIX) & set(result["metrics"])
    assert not any("spans on" in line for line in lines)
