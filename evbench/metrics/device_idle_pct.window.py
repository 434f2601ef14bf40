"""% of the window's time a solve in which no operation ran on the device:
1 − the traced slice's busy time a solve ÷ the window's time a solve.

``device_idle_pct`` divides by the traced slice's own span, which the
profiler's host cost a call stretches; this divides the same busy time by
the untraced window's time a solve, so the two differ by the profiler's
share."""


def read(run):
    if run.slice is None or not run.slice.device:
        return None
    solves = sum(len(answers) for _, _, answers in run.slice.records)
    busy_s = run.slice.busy_us / 1e6 / solves
    return 100.0 * (1.0 - busy_s / (run.window_s / len(run.answers)))
