"""Utilities (counterpart of ``eigen_value_tpu.utils``): timing, profiling,
the scaling model.  Not ported: the AOT cache (``utils/aot.py``) and the
tunnel's health probe (README, "not ported")."""

from . import profiling, scaling_model
from .timing import detect_peak_hbm_gbps, force, roofline_pct, time_call, time_marginal

__all__ = [
    "detect_peak_hbm_gbps",
    "force",
    "profiling",
    "roofline_pct",
    "scaling_model",
    "time_call",
    "time_marginal",
]
