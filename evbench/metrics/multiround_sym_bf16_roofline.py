"""% of the triangle kernel's time (``multiround_sym_kernel``,
csrc/multiround_sym.cu) in the traced slice that the slice's solves need
at least, in the cell whose A is held in bfloat16: the same reading as
``multiround_sym_roofline``, whose entry lists the float32 cell."""

from evbench import roofline


def read(run):
    return roofline.persistent_share(run, "multiround_sym_kernel")
