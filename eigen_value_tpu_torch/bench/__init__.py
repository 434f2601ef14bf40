"""Benchmark suites of the port (counterpart of ``eigen_value_tpu.bench``):
``python -m eigen_value_tpu_torch.bench --suite kernels``."""

from .suite import MATRIX_DIMS, bench_kernels, kernel_steps

__all__ = ["MATRIX_DIMS", "bench_kernels", "kernel_steps"]
