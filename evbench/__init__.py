"""evbench: the benchmark of eigen_value_tpu_torch on an NVIDIA H100.

    python -m evbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

A cell (an entry of ``workloads`` in the repository's ``BENCHMARK.json``)
names a configuration (``configs/<name>.json``: the matrix and the solver's
stated semantics) and a traffic mix (``traffic/<name>.json``: the caller,
its pool of matrices, the call kind under ``calls/<kind>.py`` and the
solver knobs it passes).  Each metric is read by ``metrics/<name>.py``, and
the limits that decide ``correct`` are in ``limits/<cell>.json``.  A later
cell, mix, call kind or metric is a new file found by its name; no file
here needs an edit for it.

The benchmark measures the port only.  Nothing it runs imports ``jax``,
``jaxlib``, ``flax`` or ``eigen_value_tpu`` (checked on ``sys.modules``
once the window has closed), and ``reference.py`` imports nothing of the
port either.
"""
