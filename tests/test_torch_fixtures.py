"""The port's fixtures, stop check, conversions and import hygiene against
the JAX package (same inputs through both, made with numpy)."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from eigen_value_tpu import fixtures as jfx  # noqa: E402
from eigen_value_tpu.config import SolverConfig as JaxConfig  # noqa: E402
from eigen_value_tpu.ops.solver import stop_check as jax_stop_check  # noqa: E402
from eigen_value_tpu_torch import fixtures as tfx  # noqa: E402
from eigen_value_tpu_torch import convert  # noqa: E402
from eigen_value_tpu_torch.config import SolverConfig  # noqa: E402
from eigen_value_tpu_torch.device import tensor_device  # noqa: E402
from eigen_value_tpu_torch.ops.solver import stop_check  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n", [128, 300])
def test_hilbert_bitwise_equal(n):
    np.testing.assert_array_equal(
        tfx.hilbert_matrix(n).numpy(), np.asarray(jfx.hilbert_matrix(n))
    )


@pytest.mark.parametrize(
    "name", ["identity_matrix", "ramp_vector", "stop_success_vector", "stop_fail_vector"]
)
@pytest.mark.parametrize("n", [3, 128])
def test_small_fixtures_bitwise_equal(name, n):
    got = getattr(tfx, name)(n).numpy()
    want = np.asarray(getattr(jfx, name)(n))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_copied_constants_equal_jax():
    assert tfx.HILBERT_ROUNDS == jfx.HILBERT_ROUNDS
    np.testing.assert_array_equal(tfx.ANCHOR_3X3, jfx.ANCHOR_3X3)
    assert tfx.ANCHOR_3X3_EIGENVALUE == jfx.ANCHOR_3X3_EIGENVALUE
    assert tfx.ANCHOR_3X3_EIGENVECTOR == jfx.ANCHOR_3X3_EIGENVECTOR


def test_random_positive_matrix_is_seeded_and_positive():
    a = tfx.random_positive_matrix(64, torch.Generator().manual_seed(3))
    b = tfx.random_positive_matrix(64, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert a.dtype == torch.float32 and bool((a >= 1e-4).all()) and bool((a <= 1).all())


def _stop_inputs():
    rng = np.random.default_rng(11)
    return {
        "success": np.asarray(jfx.stop_success_vector(256)),
        "fail": np.asarray(jfx.stop_fail_vector(256)),
        "near": (1.0 + rng.random(256) * 2e-3).astype(np.float32),
        "scaled": (1e3 + rng.random(256) * 0.5).astype(np.float32),
        "single": np.array([2.5], np.float32),
    }


@pytest.mark.parametrize("mode", ["absolute", "relative"])
@pytest.mark.parametrize("case", sorted(_stop_inputs()))
def test_stop_check_matches_jax(case, mode):
    v = _stop_inputs()[case]
    want = bool(jax_stop_check(jnp.asarray(v), 1e-3, mode))
    assert bool(stop_check(torch.tensor(v), 1e-3, mode)) == want


def test_stop_fixtures_decide_as_documented():
    assert bool(stop_check(tfx.stop_success_vector(64), 1e-3))
    assert not bool(stop_check(tfx.stop_fail_vector(64), 1e-3))
    with pytest.raises(ValueError, match="eps_mode"):
        stop_check(tfx.stop_success_vector(4), 1e-3, "bogus")


def test_matrix_and_state_from_numpy():
    a = np.asarray(jfx.hilbert_matrix(16))
    m = convert.matrix_from_numpy(a, dtype="float32")
    assert m.dtype == torch.float32 and m.is_contiguous()
    np.testing.assert_array_equal(m.numpy(), a)
    ev = np.ones(16, np.float32)
    c = convert.state_from_numpy(ev, ev * 2, np.float32(1.5), 7)
    assert c.i == 7 and float(c.lam) == 1.5 and c.lam.dim() == 0
    assert torch.equal(c.v, torch.full((16,), 2.0))


def test_config_from_jax_fields():
    fields = dataclasses.asdict(
        JaxConfig(eps=2e-3, max_itr=50, backend="multiround", chunk=7, eps_mode="relative")
    )
    cfg = convert.config_from_fields(fields)
    assert cfg == SolverConfig(
        eps=2e-3, max_itr=50, backend="multiround", chunk=7, eps_mode="relative"
    )
    assert convert.config_from_fields(dataclasses.asdict(JaxConfig())) == SolverConfig()
    assert convert.torch_dtype(jnp.bfloat16) is torch.bfloat16
    with pytest.raises(ValueError, match="no torch dtype"):
        convert.torch_dtype("int8")


def test_tensor_device_rejects_mixed_and_unsupported():
    assert tensor_device(torch.ones(2), torch.ones(3)) == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        tensor_device(torch.ones(2, device="meta"))
    with pytest.raises(ValueError, match="different devices"):
        tensor_device(torch.ones(2), torch.ones(2, device="meta"))


def test_port_imports_no_jax():
    code = (
        "import sys, eigen_value_tpu_torch, eigen_value_tpu_torch.convert, "
        "eigen_value_tpu_torch.ops.cuda.kernels, eigen_value_tpu_torch.utils.timing; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'eigen_value_tpu.'))"
        " or m == 'eigen_value_tpu']; print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_imports_no_jax():
    import ast

    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    roots = {n.split(".")[0] for n in names}
    assert "jax" not in roots and "eigen_value_tpu" not in roots, sorted(names)
    assert "eigen_value_tpu_torch" in roots
