"""Profiling helpers (counterpart of ``eigen_value_tpu.utils.profiling``):
``torch.profiler`` traces viewable in Perfetto or ``chrome://tracing``."""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Iterator, Optional

import torch

#: The file :func:`trace` writes into its directory.
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[str]:
    """Capture a trace of a code region, the host's and (where there is a
    card) the card's activity, and write it as a chrome trace to
    ``<log_dir>/trace.json`` on exit.

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

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "eigen_value_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """Named region that shows up in profiler timelines."""
    return torch.profiler.record_function(name)


def device_memory_stats() -> Optional[dict]:
    """Memory statistics of the current CUDA card
    (``torch.cuda.memory_stats``); None without a card."""
    if not torch.cuda.is_available():
        return None
    return torch.cuda.memory_stats()
