"""% of the triangle kernel's time (``multiround_sym_kernel``,
csrc/multiround_sym.cu) in the traced slice that the slice's solves need
at least: the kernel runs a whole solve's rounds in a launch."""

from evbench import roofline


def read(run):
    return roofline.persistent_share(run, "multiround_sym_kernel")
