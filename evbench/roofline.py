"""The least time the problem allows, from its shapes, and the card's
published peaks.

A solve of a dim-n matrix held in ``itemsize`` bytes an element that the
reference finishes in ``rounds`` rounds needs at least:

* bytes: A's entries that the declared problem needs, each read once
  (n(n + 1)/2 for a matrix declared symmetric, else n²), and the
  eigenvector written once (4n);
* operations: one product of A with a vector a round and one for the
  row sums, 2n² each: 2n²·(rounds + 1).

One launch of the matvec kernel needs A's n² entries, the vector read and
the result written (8n bytes), and 2n² operations.  A kernel's least time
is the larger of bytes ÷ the memory rate and operations ÷ the float32
rate outside the tensor cores.  Counting what the problem needs, whatever
a kernel reads again, keeps a share of it at or under 100%.
"""

from __future__ import annotations

import re
from typing import Optional

#: Published rates of one card at its full power limit (NVIDIA's data
#: sheet, H100 SXM: 3.35 TB/s of HBM3, 67 TFLOP/s float32 outside the
#: tensor cores), by a word of the card's name.
PEAKS = {"H100": {"bytes_per_s": 3.35e12, "flops_per_s": 67e12, "full_power_w": 700.0}}


def peaks(card_name: str) -> Optional[dict]:
    """The published peaks of the card, or None for a card the table lacks."""
    return next((p for key, p in PEAKS.items() if key in card_name), None)


def solve_work(n: int, itemsize: int, symmetric: bool, rounds: int) -> tuple:
    """``(bytes, operations)`` one solve needs at least."""
    entries = n * (n + 1) // 2 if symmetric else n * n
    return entries * itemsize + 4 * n, 2 * n * n * (rounds + 1)


def matvec_work(n: int, itemsize: int) -> tuple:
    """``(bytes, operations)`` of one product of a dim-n A with a vector."""
    return n * n * itemsize + 8 * n, 2 * n * n


def least_s(work: tuple, peak: dict) -> float:
    """Seconds the card needs at least for ``work`` = (bytes, operations)."""
    nbytes, flops = work
    return max(nbytes / peak["bytes_per_s"], flops / peak["flops_per_s"])


def solves_least_s(run, peak: dict) -> float:
    """The least seconds of the traced slice's solves, each at the
    reference's rounds for its matrix."""
    n = run.config["n"]
    return sum(
        least_s(solve_work(n, run.itemsize, run.symmetric, run.refs[a.matrix].rounds), peak)
        for _, _, answers in run.slice.records for a in answers
    )


def kernel_time(run, kernel: str) -> tuple:
    """``(launches, device seconds)`` of the kernel ``kernel`` (the name of
    its ``__global__`` function) in the traced slice."""
    pattern = re.compile(rf"(^|[\s:]){re.escape(kernel)}\s*[<(]")
    spans = [e - s for name, s, e in run.slice.device if pattern.search(name)]
    return len(spans), sum(spans) / 1e6


def persistent_share(run, kernel: str):
    """% of the kernel's time that the slice's solves need at least, for a
    kernel that runs a whole solve's rounds; None where it did not run or
    the card has no published peaks."""
    peak = peaks(run.card)
    if run.slice is None or peak is None:
        return None
    launches, seconds = kernel_time(run, kernel)
    return 100.0 * solves_least_s(run, peak) / seconds if launches else None
