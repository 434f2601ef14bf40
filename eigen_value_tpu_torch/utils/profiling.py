"""Profiling helpers (counterpart of ``eigen_value_tpu.utils.profiling``):
the port's spans, and ``torch.profiler`` traces viewable in Perfetto or
``chrome://tracing``.

Spans mark the port's layer boundaries on the single-card path of
``api.max_eigenvalue``:

* ``api.call``: the whole call; ``api.prepare``: the matrix, the route and
  ``validate``'s check with its read;
* ``solver.<route>``: the solve the route picked (``solver.multiround``,
  ``solver.matvec_kernel``, ``solver.matvec``, ``solver.xla``,
  ``solver.kernel``); ``solver.read``: each synchronising read a solve
  makes; ``solver.finish``: the host's epilogue (none on
  ``solver.multiround`` and ``solver.matvec_kernel``, whose kernels write
  the result);
* ``launch.<wrapper>``: the whole body of a kernel wrapper that these
  routes call (checks, plan, buffers, the launch; on the CPU the plain
  version it runs instead).

The mesh path and the solves that no route of ``max_eigenvalue`` takes
have none but what they share with these (``solver.read`` in the host
loops, the wrappers).

Spans are off by default: :func:`span` then tests one module-level flag
and returns one shared object that does nothing (no clock read, no
allocation, no ``record_function``).  :func:`recording` turns them on for
a region and yields the list of the :class:`Span` records closed in it, on
``time.perf_counter_ns()``; the caller writes them out.  :func:`trace`
records them too and shows each as a ``record_function`` range in its
chrome trace.  A count is the number of spans of a name.  One thread
records at a time: the open spans are one stack for the process.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import tempfile
import time
from typing import Iterator, List, NamedTuple, Optional

import torch

#: The file :func:`trace` writes into its directory.
TRACE_FILE = "trace.json"
#: The span of one public call: every span opened inside it carries its id.
CALL = "api.call"


class Span(NamedTuple):
    """One closed span."""

    name: str
    #: the id of the innermost ``api.call`` span open around it (its own
    #: for an ``api.call``), None outside any
    call: Optional[int]
    #: the name of the span open around it, None at the top
    parent: Optional[str]
    #: ``time.perf_counter_ns()`` at its start and at its end
    t0: int
    t1: int


_on = False  # spans record
_emit = False  # spans also open record_function ranges (inside trace())
_records: List[Span] = []  # where closed spans go while recording
_open: list = []  # the open spans, innermost last
_calls = itertools.count()


class _Off:
    """The span while spans are off: one shared object doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    """A recording span: read the clock on entry and exit, and append its
    record on exit, an exception's included."""

    __slots__ = ("name", "call", "parent", "out", "range", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        outer = _open[-1] if _open else None
        self.parent = outer.name if outer else None
        self.call = next(_calls) if self.name == CALL else outer.call if outer else None
        self.out = _records
        self.range = torch.profiler.record_function(self.name) if _emit else None
        if self.range is not None:
            self.range.__enter__()
        _open.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _open.pop()
        self.out.append(Span(self.name, self.call, self.parent, self.t0, t1))
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager marking a region as the span ``name``: recorded
    inside :func:`recording` or :func:`trace`, nothing otherwise."""
    if not _on:
        return _OFF
    return _On(name)


def spanned(name: str):
    """A decorator running the whole body of a function as ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _On(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


#: The JAX package's name for a named region.
annotate = span


@contextlib.contextmanager
def recording() -> Iterator[List[Span]]:
    """Record spans for a region; yields the list their records are
    appended to as they close.  Recordings do not nest."""
    global _on, _records
    if _on:
        raise RuntimeError("spans are already being recorded")
    mine: List[Span] = []
    _on, _records = True, mine
    try:
        yield mine
    finally:
        _on, _records = False, []


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[str]:
    """Capture a trace of a code region, the host's and (where there is a
    card) the card's activity, with the port's spans as ``record_function``
    ranges, and write it as a chrome trace to ``<log_dir>/trace.json`` on
    exit.

    Usage::

        with profiling.trace("out/trace") as d:
            res = max_eigenvalue(A)
            torch.cuda.synchronize()
        # open d/trace.json in Perfetto

    ``log_dir`` defaults to ``eigen_value_tpu_torch_trace`` in the
    temporary directory.  Unlike the JAX package's, a trace that cannot
    start raises: on a card it always starts, and a silent no-op would hide
    a missing measurement."""
    from torch.profiler import ProfilerActivity, profile

    global _emit
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "eigen_value_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof, recording():
        saved, _emit = _emit, True
        try:
            yield log_dir
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        finally:
            _emit = saved
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def device_memory_stats() -> Optional[dict]:
    """Memory statistics of the current CUDA card
    (``torch.cuda.memory_stats``); None without a card."""
    if not torch.cuda.is_available():
        return None
    return torch.cuda.memory_stats()
