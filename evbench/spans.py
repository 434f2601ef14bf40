"""The spans slice: the program's own spans over a third traced slice, put
on the device trace's clock.

The port marks its layers with spans (``eigen_value_tpu_torch.utils.
profiling``: ``api.call``, ``api.prepare``, ``solver.<route>``,
``solver.read``, ``solver.finish``, ``launch.<wrapper>``), off unless a
``recording()`` is open.  With ``--trace 1`` the first reader of a span
metric runs, once for the run, ``trace_calls`` more calls after
``TRACE_WARM`` uncounted ones, the device traced alone as in the first
slice of ``trace.py`` and the spans on (``of``).  A reader gets only the
``Run``, so the cell's call is taken from the frame of ``run.run_cell``
that is reading the metrics.  A program without spans (an older checkout)
gives no slice, and its span metrics are absent.

One clock: a span's ``perf_counter_ns`` plus the offset of ``time_ns``
(the tightest of a few paired readings at the slice's start) is on the Unix
clock, as the profiler's ``trace_start_ns()`` is; their difference puts the
span on the profiler's timeline, in µs (``to_trace_us``).  The profiler
puts the CUDA runtime's calls and the device's operations on that timeline
by conversions of its own, which on the H100 host have been seen off by
0.1–9 ms in some slices (PERF.md §2).  So a slice is checked before its
device times are read (``clock_check``): every ``launch.*`` span has to
hold a launch call that the profiler paired with a device operation (its
correlation id), and each such operation has to start no earlier than
:data:`CLOCK_SLACK_US` before its call began and end no later than that
after the next ``solver.read`` span, which waits for it, ended.  Nothing is
moved: a slice that fails is logged as refused and run again, up to
:data:`ATTEMPTS` slices, and where none passes the device's idle time is
not read (``call_idle_us`` and ``idle_by_span`` are absent).

From the slice: the host time of each layer a solve (a layer's spans less
the spans of the layers below opened directly inside them), the
synchronising reads, the
allocator's allocations over the counted calls (read before and after
them, never inside a span), the device's idle time inside the calls, and
the idle time labelled by the innermost span open at each gap's middle
("caller" outside every ``api.call``: the caller's reads of the answer and
the profiler's step).
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import sys
import time
from collections import defaultdict
from typing import Callable, List, NamedTuple, Optional, Tuple

from .trace import gaps, merged, union_us

#: What an idle gap outside every ``api.call`` span is labelled with.
CALLER = "caller"
CALL = "api.call"
READ = "solver.read"
#: The route spans' names start so (``solver.read`` and ``solver.finish``
#: are their children).
ROUTE = "solver."
LAUNCH = "launch."
#: µs a device operation may lie outside the host interval that must hold
#: it before a slice is off the host's clock (the margins it has inside
#: are 5 µs and more: a launch call to its kernel's start, the kernel's end
#: to its read's return).
CLOCK_SLACK_US = 2.0
#: Spans slices run at most before the device's idle time is given up.
ATTEMPTS = 6
#: What the spans slice takes from ``run.run_cell``'s frame.
CELL_LOCALS = ("call", "sync", "device", "records", "log")


class SpanUs(NamedTuple):
    """A program span on the profiler's timeline, in µs."""

    name: str
    call: Optional[int]
    parent: Optional[str]
    t0: float
    t1: float

    @property
    def us(self) -> float:
        return self.t1 - self.t0


class Clock(NamedTuple):
    """What ``clock_check`` found in a slice."""

    #: ``launch.*`` spans
    launches: int
    #: of them, those holding a launch call paired with a device operation
    anchored: int
    #: the largest distance, µs, of such an operation outside its call's
    #: start and its read's end (``causal_shifts``)
    largest_shift_us: float

    @property
    def one(self) -> bool:
        return 0 < self.launches == self.anchored and self.largest_shift_us <= CLOCK_SLACK_US


@dataclasses.dataclass
class SpansSlice:
    start_us: float
    span_us: float
    #: ``(name, start_us, end_us)`` of each device operation inside the span
    device: List[Tuple[str, float, float]]
    spans: List[SpanUs]
    #: ``(t0, t1, answers)`` on the host clock, as in the window
    records: list
    #: the caching allocator's allocations over the counted calls (None off a card)
    allocs: Optional[int] = None
    #: the check of the device's times against the spans (None off a card)
    clock: Optional[Clock] = None

    def __post_init__(self):
        self.by_call = defaultdict(list)
        for s in self.spans:
            self.by_call[s.call].append(s)
        self.calls = sorted(self.named(CALL), key=lambda s: s.t0)

    @property
    def on_one_clock(self) -> bool:
        """Whether the device's times may be read against the spans."""
        return self.clock is not None and self.clock.one

    @property
    def solves(self) -> int:
        return sum(len(answers) for _, _, answers in self.records)

    def named(self, name: str) -> List[SpanUs]:
        return [s for s in self.spans if s.name == name]

    def children(self, s: SpanUs) -> List[SpanUs]:
        """The spans opened directly inside ``s``."""
        return [c for c in self.by_call[s.call] if c.parent == s.name
                and s.t0 <= c.t0 and c.t1 <= s.t1 and c is not s]

    def self_us(self, s: SpanUs, less: Callable[[SpanUs], bool] = lambda c: True) -> float:
        """``s``'s length less that of its direct children that ``less`` names."""
        return s.us - sum(c.us for c in self.children(s) if less(c))

    def routes(self) -> List[SpanUs]:
        return [s for s in self.spans if s.parent == CALL and s.name.startswith(ROUTE)]

    def call_idle_us(self) -> float:
        """Device-idle µs inside the ``api.call`` spans."""
        busy = merged((s, e) for _, s, e in self.device)
        return sum(e - s for c in self.calls for s, e in gaps(busy, c.t0, c.t1))

    def label(self, t: float) -> str:
        """The innermost span open at ``t``, or :data:`CALLER` outside every
        ``api.call``."""
        i = bisect.bisect_right([c.t0 for c in self.calls], t) - 1
        if i < 0 or t > self.calls[i].t1:
            return CALLER
        inside = [(s.us, s.name) for s in self.by_call[self.calls[i].call] if s.t0 <= t <= s.t1]
        return min(inside)[1]

    def idle_by_span(self) -> List[Tuple[str, float]]:
        """Idle device seconds by the span open at each gap's middle, most
        first."""
        total = defaultdict(float)
        busy = merged((s, e) for _, s, e in self.device)
        for s, e in gaps(busy, self.start_us, self.start_us + self.span_us):
            total[self.label((s + e) / 2)] += (e - s) / 1e6
        return sorted(total.items(), key=lambda kv: -kv[1])

    def host_us(self) -> dict:
        """Host µs a solve by layer, each layer's spans less the other
        layers' spans inside them: ``api`` (``api.call`` less its route
        span; ``api.prepare`` counts), ``solver`` (the route spans less their
        launches and reads; ``solver.finish`` counts), ``launch`` and ``read``
        (the spans' lengths).  The four add up to the calls' length."""
        k = self.solves
        return {
            "api": sum(self.self_us(c, lambda x: x.name.startswith(ROUTE)) for c in self.calls) / k,
            "solver": sum(self.self_us(r, lambda c: c.name.startswith(LAUNCH) or c.name == READ)
                          for r in self.routes()) / k,
            "launch": sum(s.us for s in self.spans if s.name.startswith(LAUNCH)) / k,
            "read": sum(s.us for s in self.named(READ)) / k,
        }


def clock_offset_ns(pairs: int = 5) -> int:
    """``time_ns() - perf_counter_ns()``, from the tightest of ``pairs``
    readings of ``time_ns`` between two of ``perf_counter_ns``."""
    best = None
    for _ in range(pairs):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, u - (a + b) // 2)
    return best[1]


def to_trace_us(t_ns: int, offset_ns: int, trace_start_ns: int) -> float:
    """A ``perf_counter_ns`` reading on the profiler's timeline (µs from its
    ``trace_start_ns``, on the Unix clock)."""
    return (t_ns + offset_ns - trace_start_ns) / 1e3


def causal_shifts(kernels, reads) -> List[float]:
    """The shift of each ``(start, end, call0, call1)``, a kernel and the
    host interval of the launch call that started it: the one nearest 0
    that would make ``start + shift >= call0`` and ``end + shift <= `` the
    end of the first read span (``(t0, t1)``, sorted) that starts after the
    call, or the middle of the two bounds where they cross; 0 where the
    profiler's placement is sound."""
    out = []
    starts = [r[0] for r in reads]
    for start, end, c0, c1 in kernels:
        lo = c0 - start
        i = bisect.bisect_left(starts, c1)
        hi = reads[i][1] - end if i < len(reads) else float("inf")
        out.append(min(max(0.0, lo), hi) if lo <= hi else (lo + hi) / 2)
    return out


def clock_check(spans: List[SpanUs], ops) -> Clock:
    """The device's operations against the spans, where ``ops`` holds
    ``(start, end, call0, call1)`` of each operation and the launch call
    the profiler paired it with: how many ``launch.*`` spans hold such a
    call, and the largest shift one of their operations would need."""
    wrappers = sorted((s.t0, s.t1) for s in spans if s.name.startswith(LAUNCH))
    reads = sorted((s.t0, s.t1) for s in spans if s.name == READ)
    held, launched = set(), []
    for op in ops:
        k = bisect.bisect_right(wrappers, (op[2], float("inf"))) - 1
        if k >= 0 and op[3] <= wrappers[k][1]:
            held.add(k)
            launched.append(op)
    shifts = causal_shifts(launched, reads)
    return Clock(len(wrappers), len(held), max(map(abs, shifts), default=0.0))


def program_spans():
    """The program's span module, or None where it has no ``recording``."""
    try:
        from eigen_value_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "recording") else None


def measure(call: Callable, k0: int, calls: int, warm: int, sync: Callable,
            device) -> Optional[SpansSlice]:
    """Run ``warm`` then ``calls`` calls of ``call(k)`` from index ``k0``,
    the spans on over the last ``calls``; on a card under the profiler,
    the device alone traced.  None where the program has no spans."""
    import torch

    profiling = program_spans()
    if profiling is None:
        return None
    cuda = device.type == "cuda"
    if cuda:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile, schedule

        prof = profile(activities=[ProfilerActivity.CUDA],
                       schedule=schedule(wait=0, warmup=warm, active=calls, repeat=1))
    else:
        prof = None

    def allocated():
        return torch.cuda.memory_stats(device)["allocation.all.allocated"] if cuda else None

    marks, records = [], []
    with prof if prof is not None else contextlib.nullcontext():
        for k in range(k0, k0 + warm):
            call(k)
            if prof is not None:
                prof.step()
        sync()
        a0 = allocated()
        offset = clock_offset_ns()
        with profiling.recording() as spans:
            for k in range(k0 + warm, k0 + warm + calls):
                n0 = time.perf_counter_ns()
                answers = call(k)
                n1 = time.perf_counter_ns()
                marks.append((n0, n1))
                records.append((n0 / 1e9, n1 / 1e9, answers))
                if prof is not None:
                    prof.step()
        a1 = allocated()
    clock = None
    if prof is not None:
        start_ns = prof.profiler.kineto_results.trace_start_ns()
        events = prof.events()
        device_all = [(e.name, e.time_range.start, e.time_range.end, e.id) for e in events
                      if e.device_type == DeviceType.CUDA]
        launch_calls = {e.id: (e.time_range.start, e.time_range.end) for e in events
                        if e.device_type == DeviceType.CPU and e.name.startswith("cudaLaunch")}
    else:
        start_ns, device_all, launch_calls = marks[0][0] + offset, [], {}

    def us(t):
        return to_trace_us(t, offset, start_ns)

    mapped = [SpanUs(s.name, s.call, s.parent, us(s.t0), us(s.t1)) for s in spans]
    if prof is not None:
        clock = clock_check(mapped, [(s, e) + launch_calls[i] for _, s, e, i in device_all
                                     if i in launch_calls])
    s0, s1 = us(marks[0][0]), us(marks[-1][1])
    device = [(n, max(s, s0), min(e, s1)) for n, s, e, _ in device_all if e > s0 and s < s1]
    return SpansSlice(s0, s1 - s0, device, mapped, records,
                      a1 - a0 if a0 is not None else None, clock)


def _run_cell_locals() -> dict:
    """What the spans slice needs of the ``run.run_cell`` frame on this
    thread's stack; raises where there is none or it lacks a local."""
    from .run import run_cell

    frame = sys._getframe(1)
    while frame is not None and frame.f_code is not run_cell.__code__:
        frame = frame.f_back
    if frame is None:
        raise RuntimeError("the spans slice is read outside evbench.run.run_cell")
    missing = [k for k in CELL_LOCALS if k not in frame.f_locals]
    if missing:
        raise RuntimeError(f"evbench.run.run_cell has no local {', '.join(missing)}: "
                           "the spans slice cannot run")
    return {k: frame.f_locals[k] for k in CELL_LOCALS}


def of(run) -> Optional[SpansSlice]:
    """The run's spans slice: run once, when a traced run's first reader
    asks, and again, up to :data:`ATTEMPTS` slices, while the device's
    times fail ``clock_check``; None without the traced slices or without
    spans in the program."""
    if "spans" in vars(run):
        return run.spans
    run.spans = None
    if run.slice is None or program_spans() is None:
        return None
    cell = _run_cell_locals()
    from .run import TRACE_WARM

    log = cell["log"]
    calls = run.traffic["trace_calls"]
    k0 = len(cell["records"]) + 2 * (calls + TRACE_WARM)
    for attempt in range(1, ATTEMPTS + 1):
        s = measure(cell["call"], k0, calls, TRACE_WARM, cell["sync"], cell["device"])
        k0 += calls + TRACE_WARM
        if s is None or s.clock is None or s.on_one_clock:
            break
        log(f"spans slice {attempt} of {ATTEMPTS} refused: the device's times are off the "
            f"spans' clock ({json.dumps(s.clock._asdict())})", file=sys.stderr)
    run.spans = s
    if s is None:
        return None
    traced = sum(t1 - t0 for t0, t1, _ in s.records) / len(s.records)
    untraced = run.window_s / len(run.records)
    busy = union_us((a, b) for _, a, b in s.device)
    log(f"traced slice (device alone, spans on): {len(s.records)} calls after {TRACE_WARM} "
        f"uncounted, span {s.span_us / 1e6!r} s, busy {busy / 1e6!r} s; host s a call "
        f"{traced!r} against {untraced!r} in the window ({100 * (traced / untraced - 1):+.2f}%)",
        file=sys.stderr)
    log(json.dumps({"host_us_a_solve": s.host_us(),
                    "idle_by_span": [list(kv) for kv in s.idle_by_span()[:10]]
                    if s.on_one_clock else None,
                    "clock": s.clock._asdict() if s.clock else None, "slices": attempt}),
        file=sys.stderr)
    return s
