"""The metric readers on a run made by hand."""

import statistics

import pytest

from evbench import trace
from evbench.catalog import Catalog
from evbench.compare import Answer
from evbench.run import Run

CONFIG = {"n": 8192, "dtype": "float32", "storage_dtype": None}


class Ref:
    def __init__(self, rounds):
        self.rounds = rounds


def make_run(durations, rounds=17, slice_=None, peak=1 << 30, traffic=None):
    t, records = 0.0, []
    for d in durations:
        records.append((t, t + d, [Answer(0, 2.0, rounds, True)]))
        t += d
    return Run(CONFIG, traffic or {"solver": {"symmetric": True}}, 12.5, records, t, peak,
               [Ref(rounds)], "NVIDIA H100 80GB HBM3", slice_)


def read(name, run):
    return Catalog().metric(name).read(run)


def test_p95_is_over_every_call():
    durations = [0.001] * 95 + [0.010] * 5
    run = make_run(durations)
    got = read("call_p95_ms", run)
    ms = [1e3 * d for d in durations]
    assert got == pytest.approx(statistics.quantiles(ms, n=20, method="inclusive")[18])
    # one slow call more moves the tail: no call is left out
    assert read("call_p95_ms", make_run(durations + [0.010])) > got


def test_solve_ms_is_the_window_over_the_solves():
    run = make_run([0.002, 0.001, 0.003])
    assert read("solve_ms", run) == pytest.approx(2.0)
    assert read("solve_ms.long_call", run) == read("solve_ms", run)
    assert read("rounds_per_solve", run) == 17
    assert read("setup_s", run) == 12.5


def test_peak_memory_in_gib_and_absent_without_a_card():
    assert read("peak_mem_gib", make_run([0.001], peak=3 << 29)) == 1.5
    assert read("peak_mem_gib", make_run([0.001], peak=0)) is None


def test_trace_metrics_absent_without_a_slice():
    run = make_run([0.001])
    for name in ("device_idle_pct", "device_idle_pct.window", "solve_roofline", "multiround_sym_roofline",
                 "multiround_roofline", "matvec_roofline", "device_ops_per_solve"):
        assert read(name, run) is None


def test_idle_and_ops_from_the_slice():
    host = [(trace.SLICE, 0, 1000)]
    device = [("void (anonymous namespace)::multiround_sym_kernel<float, false>(float*)", 100, 700),
              ("Memcpy DtoH (Device -> Pageable)", 750, 760)]
    records = [(0, 0.0005, [Answer(0, 2.0, 17, True)]), (0.0005, 0.001, [Answer(0, 2.0, 17, True)])]
    run = make_run([0.001], slice_=trace.Slice(0.0, 1000.0, device, host, records))
    assert read("device_idle_pct", run) == pytest.approx(100 * (1 - 610 / 1000))
    # the same busy time, 305 µs a solve, against the window's 1 ms a solve
    assert read("device_idle_pct.window", run) == pytest.approx(100 * (1 - 0.305))
    assert read("device_ops_per_solve", run) == 1.0
    assert read("multiround_sym_roofline", run) is not None
    assert read("multiround_roofline", run) is None
    assert read("matvec_roofline", run) is None
