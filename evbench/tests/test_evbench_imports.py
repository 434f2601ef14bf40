"""Nothing the benchmark runs loads JAX or the JAX package."""

import subprocess
import sys

from evbench.catalog import ROOT
from evbench.run import forbidden_modules


def test_top_level_names_compared_whole():
    names = ["jax", "jaxlib.xla_client", "flax.linen", "eigen_value_tpu",
             "eigen_value_tpu.ops.solver", "eigen_value_tpu_torch", "eigen_value_tpu_torch.api",
             "jaxtyping", "evbench.run", "torch"]
    assert forbidden_modules(names) == ["eigen_value_tpu", "eigen_value_tpu.ops.solver",
                                        "flax.linen", "jax", "jaxlib.xla_client"]


def test_the_harness_and_the_port_load_no_jax():
    code = (
        "import sys, json\n"
        "from evbench.catalog import Catalog\n"
        "from evbench import run, reference, calibrate, trace, roofline, pool, compare\n"
        "cat = Catalog()\n"
        "for w in cat.spec['workloads']:\n"
        "    cat.call_kind(cat.traffic(w['traffic'])['call'])\n"
        "for m in cat.spec['end_to_end'] + cat.spec['per_layer']:\n"
        "    cat.metric(m['name'])\n"
        "import eigen_value_tpu_torch.api, torch.profiler\n"
        "print(json.dumps(run.forbidden_modules(list(sys.modules))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
