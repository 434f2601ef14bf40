"""Host µs a solve in the solver layer: the length of the route's
``solver.*`` span less its ``launch.*`` and ``solver.read`` children
(``solver.finish`` counts), from the spans slice (``spans.py``)."""

from evbench import spans


def read(run):
    s = spans.of(run)
    return None if s is None or not s.calls else s.host_us()["solver"]
