"""Ports of the repository's ``examples/``: each module has ``main(device=None)``,
runs on the CUDA card unless ``device="cpu"`` is given, and is runnable as
``python -m eigen_value_tpu_torch.examples.<name>``: ``quickstart``,
``matrix_free``, ``pagerank``, ``autodiff``, ``distributed``,
``large_scale`` and ``serving`` (its solve part)."""

EXAMPLES = ("quickstart", "matrix_free", "pagerank", "autodiff", "distributed",
            "large_scale", "serving")
