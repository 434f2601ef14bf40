"""Device-idle µs a solve inside the ``api.call`` spans, on the device
trace's clock (``spans.py``); the rest of the spans slice's idle time is
the caller's.  Absent where no slice's device times passed the check
against the spans (``spans.clock_check``)."""

from evbench import spans


def read(run):
    s = spans.of(run)
    return None if s is None or not s.on_one_clock or not s.calls else s.call_idle_us() / s.solves
