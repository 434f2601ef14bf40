"""Host µs a solve in the api layer: each ``api.call`` span less the route's
``solver.*`` span opened in it (``api.prepare`` counts: the matrix, the
route, ``validate``), from the spans slice (``spans.py``)."""

from evbench import spans


def read(run):
    s = spans.of(run)
    return None if s is None or not s.calls else s.host_us()["api"]
