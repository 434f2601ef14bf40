"""Synchronising device-to-host reads a solve: the ``solver.read`` spans of
the spans slice (``spans.py``) over the matrices it solved."""

from evbench import spans


def read(run):
    s = spans.of(run)
    return None if s is None or not s.calls else len(s.named(spans.READ)) / s.solves
