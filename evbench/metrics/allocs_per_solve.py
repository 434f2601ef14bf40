"""Allocations a solve: the caching allocator's ``allocation.all.allocated``
over the spans slice's counted calls (read once before them and once after,
never inside a span; ``spans.py``) over the matrices they solved."""

from evbench import spans


def read(run):
    s = spans.of(run)
    return None if s is None or s.allocs is None else s.allocs / s.solves
