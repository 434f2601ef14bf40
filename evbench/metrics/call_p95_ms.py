"""The 95th percentile of the wall time of every public call in the
window, in ms (linear between the two nearest calls)."""

import statistics


def read(run):
    ms = [1e3 * (t1 - t0) for t0, t1, _ in run.records]
    if len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=20, method="inclusive")[18]
