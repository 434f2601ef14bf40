"""% of the device's busy time in the traced slice that the slice's solves
need at least (``roofline.solve_work`` at the reference's rounds, against
the card's published peaks): the whole solve's share of the card's peak,
whatever kernels carry it."""

from evbench import roofline


def read(run):
    peak = roofline.peaks(run.card)
    if run.slice is None or peak is None or not run.slice.device:
        return None
    return 100.0 * roofline.solves_least_s(run, peak) / (run.slice.busy_us / 1e6)
