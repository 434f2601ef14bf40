"""Host µs a solve in the launch wrappers and plans: the total length of
the ``launch.*`` spans of the spans slice (``spans.py``)."""

from evbench import spans


def read(run):
    s = spans.of(run)
    return None if s is None or not s.calls else s.host_us()["launch"]
