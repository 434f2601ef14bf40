"""Device timing with CUDA events (counterpart of
``eigen_value_tpu.utils.timing``).

A CUDA call returns before the card finishes, so a host clock would time
the enqueue.  Events recorded on the stream around each call and read
after a synchronise time the card's work.  There is no CPU fallback: a
time taken on the CPU is not a device time.
"""

from __future__ import annotations

import statistics
from typing import Any, Callable, NamedTuple, Optional

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


def time_marginal(
    step: Callable[[int, Any], Any], init: Any, k: int = 64, reps: int = 7
) -> float:
    """Marginal ms per application of ``step(i, state) -> state`` (``i`` is
    the chain index), measured as (T(k+1 chained) − T(1)) / k: each chain
    is enqueued on the current stream between two CUDA events, the two
    lengths alternate, and the least time of each over ``reps`` counts, so
    what one launch costs to start cancels.

    The chain starts from ``init`` every time; a step that updates its
    state in place carries the state on across chains, so give such a step
    a state of its own.  The host must enqueue faster than the card works
    for the chain to measure the card: true for the O(n²) passes at the
    sizes worth timing (a toy size measures launch overhead).
    """
    if not torch.cuda.is_available():
        raise RuntimeError("time_marginal measures the CUDA device; none is available")

    def chain(m: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state = init
        for i in range(m):
            state = step(i, state)
        end.record()
        end.synchronize()
        return float(start.elapsed_time(end))

    chain(1)  # build and warm up before timing
    chain(k + 1)
    t1 = tk = float("inf")
    for _ in range(reps):
        t1 = min(t1, chain(1))
        tk = min(tk, chain(k + 1))
    return max(tk - t1, 0.0) / k


#: Published device-memory rates in GB/s (NVIDIA's data sheets, SXM parts,
#: at the full power limit), by a word of the card's name.
_PEAK_GBPS = {"H100": 3350.0, "H200": 4800.0}


def detect_peak_gbps(device: Optional[torch.device] = None) -> float:
    """Published memory rate of the CUDA card in GB/s; NaN for a card the
    table does not name."""
    name = torch.cuda.get_device_name(device)
    return next((bw for key, bw in _PEAK_GBPS.items() if key in name), float("nan"))


def roofline_pct(ms: float, bytes_moved: int, peak_gbps: float) -> float:
    """Achieved bandwidth as % of ``peak_gbps`` (given by the caller) for a
    memory-bound op."""
    if ms <= 0:
        return float("nan")
    return 100.0 * bytes_moved / (ms * 1e-3) / 1e9 / peak_gbps
