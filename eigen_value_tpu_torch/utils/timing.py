"""Device timing with CUDA events (counterpart of
``eigen_value_tpu.utils.timing``).

A CUDA call returns before the card finishes, so a host clock would time
the enqueue.  Events recorded on the stream around each call and read
after a synchronise time the card's work.  There is no CPU fallback: a
time taken on the CPU is not a device time.
"""

from __future__ import annotations

import statistics
from typing import Any, Callable, NamedTuple

import torch


class Timing(NamedTuple):
    median_ms: float
    min_ms: float


def time_call(fn: Callable[[], Any], reps: int = 10, warmup: int = 1) -> Timing:
    """Median and min ms over ``reps`` calls of ``fn()`` on the current CUDA
    device, each bracketed by its own pair of events."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_call measures the CUDA device; none is available")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    ms = [float(s.elapsed_time(e)) for s, e in pairs]
    return Timing(statistics.median(ms), min(ms))


def roofline_pct(ms: float, bytes_moved: int, peak_gbps: float) -> float:
    """Achieved bandwidth as % of ``peak_gbps`` (given by the caller) for a
    memory-bound op."""
    if ms <= 0:
        return float("nan")
    return 100.0 * bytes_moved / (ms * 1e-3) / 1e9 / peak_gbps
