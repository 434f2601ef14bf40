"""% of the stripes kernel's time (``multiround_kernel``,
csrc/multiround.cu) in the traced slice that the slice's solves need at
least: the kernel runs a whole solve's rounds in a launch."""

from evbench import roofline


def read(run):
    return roofline.persistent_share(run, "multiround_kernel")
