"""The ported examples (``eigen_value_tpu_torch/examples``) on the CPU: each
``main(device="cpu")`` prints the lines that tests/test_examples.py reads in
the JAX example's output, and the numbers that both print on the same
inputs agree.  On the card they run in ``chip_smoke.py``'s step 9.
"""

import contextlib
import importlib
import io
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from eigen_value_tpu_torch.examples import EXAMPLES  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: What tests/test_examples.py reads in each JAX example's output; the port
#: runs on one rank where the JAX example runs on 8 virtual devices, and it
#: has no AOT artifact (README, "not ported").
LINES = {
    "quickstart": ("round(s)", "functional: λ", "bf16 fast mode"),
    "autodiff": ("target 40.0", "∂v[0]/∂A"),
    "serving": ("served solve", "rounds = 13", "residual check passed"),
    "distributed": ("sharded (1 devices)", "rounds = 13 (expect 13)", "ring:", "checkpointed"),
    "matrix_free": ("operator solve (FFT Hankel", "matches dense within 1e-3",
                    "convergence: rate", "f64 polish: λ"),
    "pagerank": ("exact answer: λ = 1", "dense cross-check", "top-5 nodes:"),
    "large_scale": ("512² Hilbert (float32)", "1024² Hilbert (bf16 storage)", "converged = True"),
}
#: Small sizes for the CPU where an example's default is the card's.
CPU_ARGS = {"large_scale": dict(dim=512, bf16_dim=1024), "matrix_free": dict(n=1024)}


def _run(name: str) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        importlib.import_module(f"eigen_value_tpu_torch.examples.{name}").main(
            device="cpu", **CPU_ARGS.get(name, {}))
    return out.getvalue()


def test_every_jax_example_has_a_port():
    jax_examples = sorted(f[:-3] for f in os.listdir(os.path.join(ROOT, "examples"))
                          if f.endswith(".py"))
    assert sorted(EXAMPLES) == jax_examples == sorted(LINES)


@pytest.mark.parametrize("name", sorted(LINES))
def test_the_example_prints_what_the_jax_examples_test_reads(name):
    text = _run(name)
    for want in LINES[name]:
        assert want in text, (want, text)


def _numbers(line: str):
    return [float(x) for x in re.findall(r"-?\d+\.\d+", line)]


def test_the_autodiff_example_lands_where_jaxs_does():
    # the JAX example's output on the same seed: λ 38.642 → 40.000; the
    # matrix-free gradient peaks at k = 16 with 0.4630
    text = _run("autodiff")
    first = next(line for line in text.splitlines() if line.startswith("λ:"))
    assert _numbers(first)[:2] == pytest.approx([38.642, 40.0], abs=2e-3)
    last = text.splitlines()[-1]
    assert "k = 16" in last and _numbers(last)[-1] == pytest.approx(0.4630, abs=1e-3)


def test_the_pagerank_example_finds_lambda_one():
    text = _run("pagerank")
    first = text.splitlines()[0]
    assert abs(_numbers(first)[0] - 1.0) < 2e-3


def test_the_examples_run_as_modules():
    out = subprocess.run([sys.executable, "-m", "eigen_value_tpu_torch.examples.serving",
                          "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and "served solve" in out.stdout


def test_without_a_card_the_examples_ask_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    from eigen_value_tpu_torch.examples import quickstart

    with pytest.raises(RuntimeError, match="CUDA device"):
        quickstart.main()
