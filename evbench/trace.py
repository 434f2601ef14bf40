"""The traced slices: a fixed number of calls under ``torch.profiler``, and
what their traces say.

The slices continue the window's loop right after the window has closed
(the window itself is never traced).  The profiler first sees a few calls
that are not counted, so that its own start-up stays out of a slice.  The
first slice traces the device alone and gives the per-layer metrics and
the device's busy time and span; the second also records the host's
operations, whose cost would inflate the device's idle share, and gives
the idle gaps their labels (``profile_slice``).  From a trace:

* the device's busy time: the union of the device intervals (kernels,
  copies, fills) inside the span, so that nothing is counted twice;
* every idle gap of the device inside the span, labelled by the innermost
  host operation that was running at its middle ("python in the call"
  or "python between calls" where the profiler saw none);
* the device operations by name.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Iterable, List, NamedTuple, Tuple

#: The names of the host ranges the slice marks (kept off the device list:
#: the profiler mirrors a host range onto the device timeline).
SLICE = "evbench.slice"
CALL = "evbench.call"
#: What a gap is labelled with where only the slice's own ranges ran.
_PLAIN = {CALL: "python in the call", SLICE: "python between calls"}


def merged(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals as disjoint sorted intervals."""
    out: List[List[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(s, e) for s, e in out]


def union_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    return sum(e - s for s, e in merged(intervals))


def gaps(busy: List[Tuple[float, float]], start: float, end: float) -> List[Tuple[float, float]]:
    """The parts of ``[start, end]`` that the disjoint sorted ``busy``
    intervals leave uncovered."""
    out, t = [], start
    for s, e in busy:
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(s, e) for s, e in out if e > s]


def label(host: List[Tuple[str, float, float]], t: float) -> str:
    """The innermost (shortest) host operation running at time ``t``."""
    inside = [(e - s, name) for name, s, e in host if s <= t <= e]
    name = min(inside)[1] if inside else SLICE
    return _PLAIN.get(name, name)


def short_name(name: str) -> str:
    """A device operation's name without its return type, anonymous
    namespace and parameter list."""
    bare = name.replace("(anonymous namespace)::", "").split("(")[0].strip()
    return (bare[5:] if bare.startswith("void ") else bare)[:96] or name[:96]


class Slice(NamedTuple):
    start_us: float
    span_us: float
    #: ``(name, start_us, end_us)`` of each device operation inside the span
    device: List[Tuple[str, float, float]]
    #: ``(name, start_us, end_us)`` of each host operation inside the span
    host: List[Tuple[str, float, float]]
    #: ``(t0, t1, answers)`` on the host clock, as in the window
    records: list

    @property
    def busy_us(self) -> float:
        return union_us((s, e) for _, s, e in self.device)

    def by_name(self) -> List[Tuple[str, float]]:
        """Device seconds a name, most first."""
        total = defaultdict(float)
        for name, s, e in self.device:
            total[short_name(name)] += (e - s) / 1e6
        return sorted(total.items(), key=lambda kv: -kv[1])

    def idle_by_host(self) -> List[Tuple[str, float]]:
        """Idle device seconds by the host operation running at each gap's
        middle, most first."""
        total = defaultdict(float)
        busy = merged((s, e) for _, s, e in self.device)
        for s, e in gaps(busy, self.start_us, self.start_us + self.span_us):
            total[label(self.host, (s + e) / 2)] += (e - s) / 1e6
        return sorted(total.items(), key=lambda kv: -kv[1])


def profile_slice(call: Callable, k0: int, calls: int, warm: int, sync: Callable,
                  host: bool) -> Slice:
    """Run ``warm`` then ``calls`` calls of ``call(k)`` from index ``k0``
    under the profiler; the slice is the last ``calls``.

    ``host=False`` traces the device alone (the profiler's host cost is
    then a few µs a launch): the slice spans its first device operation to
    its last, and the profiler's schedule keeps the ``warm`` calls out.
    ``host=True`` also records every host operation, which the idle gaps
    are labelled by (and which costs the host a good part of a call): the
    slice spans one ``record_function`` range around its calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    records = []
    if host:
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    else:
        prof = profile(activities=[ProfilerActivity.CUDA],
                       schedule=schedule(wait=0, warmup=warm, active=calls, repeat=1))
    with prof:
        for k in range(k0, k0 + warm):
            call(k)
            if not host:
                prof.step()
        sync()
        with record_function(SLICE) if host else contextlib.nullcontext():
            for k in range(k0 + warm, k0 + warm + calls):
                t0 = time.perf_counter()
                with record_function(CALL) if host else contextlib.nullcontext():
                    answers = call(k)
                records.append((t0, time.perf_counter(), answers))
                if not host:
                    prof.step()
    events = prof.events()
    device_all = [(e.name, e.time_range.start, e.time_range.end) for e in events
                  if e.device_type == DeviceType.CUDA and e.name not in (SLICE, CALL)]
    if host:
        host_all = [(e.name, e.time_range.start, e.time_range.end)
                    for e in events if e.device_type == DeviceType.CPU]
        (s0, s1), = [(s, e) for name, s, e in host_all if name == SLICE]
    else:
        host_all = []
        s0 = min(s for _, s, _e in device_all)
        s1 = max(e for _, _s, e in device_all)
    host_ops = [(n, s, e) for n, s, e in host_all if e >= s0 and s <= s1]
    device = [(n, max(s, s0), min(e, s1)) for n, s, e in device_all if e > s0 and s < s1]
    return Slice(s0, s1 - s0, device, host_ops, records)
