"""% of the traced slice's span in which no operation ran on the device:
1 − the union of the device intervals ÷ the span."""


def read(run):
    if run.slice is None or not run.slice.device:
        return None
    return 100.0 * (1.0 - run.slice.busy_us / run.slice.span_us)
