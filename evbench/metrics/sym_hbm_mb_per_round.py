"""MB of A that a round of the triangle kernel reads from HBM under the
plan of the run's last launch: the streamed tiles less those the L2 is
asked to keep (``SymPlan.hbm_bytes``, kept on the wrapper as
``kernels.multiround_sym.plan``).  None where the program keeps no plan
there (an older checkout) or no triangle launch ran (the CPU)."""

from eigen_value_tpu_torch.ops.cuda import kernels


def read(run):
    nbytes = getattr(getattr(kernels.multiround_sym, "plan", None), "hbm_bytes", None)
    return None if nbytes is None else nbytes / 1e6
