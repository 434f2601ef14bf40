"""% of the matvec kernel's time (``matvec_kernel``, csrc/matvec.cu) in the
traced slice that its launches need at least, one product of A with a
vector each (``roofline.matvec_work``)."""

from evbench import roofline


def read(run):
    peak = roofline.peaks(run.card)
    if run.slice is None or peak is None:
        return None
    launches, seconds = roofline.kernel_time(run, "matvec_kernel")
    if not launches:
        return None
    least = roofline.least_s(roofline.matvec_work(run.config["n"], run.itemsize), peak)
    return 100.0 * launches * least / seconds
