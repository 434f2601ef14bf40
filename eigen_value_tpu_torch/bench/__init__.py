"""Benchmark suites of the port (counterpart of ``eigen_value_tpu.bench``):
``python -m eigen_value_tpu_torch.bench --suite
{e2e,kernels,vector,operator,batched,sharded,multihost}``."""

from .suite import (
    E2E_BACKENDS,
    MATRIX_DIMS,
    VECTOR_SIZES,
    batched_row,
    batched_workload,
    bench_batched,
    bench_e2e,
    bench_kernels,
    bench_multihost,
    bench_operator,
    bench_sharded,
    bench_vector_kernels,
    kernel_steps,
    operator_rungs,
    run_mh_workers,
    vector_steps,
)

__all__ = [
    "E2E_BACKENDS",
    "MATRIX_DIMS",
    "VECTOR_SIZES",
    "batched_row",
    "batched_workload",
    "bench_batched",
    "bench_e2e",
    "bench_kernels",
    "bench_multihost",
    "bench_operator",
    "bench_sharded",
    "bench_vector_kernels",
    "kernel_steps",
    "operator_rungs",
    "run_mh_workers",
    "vector_steps",
]
