"""The port's NumPy oracles (``eigen_value_tpu_torch/reference_impl.py``)
and their CLI (``python -m eigen_value_tpu_torch.oracle``) against the JAX
package's, on the same numpy inputs.

Both packages run the same NumPy arithmetic, so every result is held bit
for bit: λ, the eigenvector, the round count and the converged flag.  The
CLI's table is held line for line with its time column masked.  A process
in which jax cannot be imported runs the port's oracles and CLI: that is
where the port runs.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from eigen_value_tpu import fixtures as jfx
from eigen_value_tpu import reference_impl as jref
from eigen_value_tpu.oracle.__main__ import main as jax_cli
from eigen_value_tpu_torch import fixtures as tfx
from eigen_value_tpu_torch import reference_impl as tref
from eigen_value_tpu_torch.oracle.__main__ import main as port_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HILBERT_SIZES = [3, 4, 16, 64, 100, 128, 256]


def _same(got, want) -> None:
    assert type(got.eigenvalue) is type(want.eigenvalue)
    assert got.eigenvalue == want.eigenvalue
    assert got.eigenvector.dtype == want.eigenvector.dtype
    np.testing.assert_array_equal(got.eigenvector, want.eigenvector)
    assert (got.rounds, got.converged) == (want.rounds, want.converged)


def _inputs():
    yield "anchor", np.asarray(jfx.ANCHOR_3X3)
    for n in HILBERT_SIZES:
        yield f"hilbert{n}", np.asarray(jfx.hilbert_matrix(n))
    for seed, n in ((0, 32), (1, 100), (2, 128)):
        yield f"random{n}_seed{seed}", np.random.default_rng(seed).random((n, n))


INPUTS = dict(_inputs())


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_parallel_oracle_is_jaxs_bit_for_bit(name):
    mat = INPUTS[name]
    _same(tref.parallel_oracle(mat), jref.parallel_oracle(mat))
    _same(tref.parallel_oracle(mat, dtype=np.float64), jref.parallel_oracle(mat, dtype=np.float64))


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_sequential_oracle_is_jaxs_bit_for_bit(name):
    mat = INPUTS[name]
    _same(tref.sequential_oracle(mat), jref.sequential_oracle(mat))


@pytest.mark.parametrize("cap", [0, 1, 3])
def test_a_capped_run_is_jaxs_and_does_not_converge(cap):
    H = np.asarray(jfx.hilbert_matrix(128))
    got = tref.parallel_oracle(H, max_itr=cap)
    _same(got, jref.parallel_oracle(H, max_itr=cap))
    assert got.rounds == cap and not got.converged


def test_the_defaults_and_the_table_are_the_ports():
    from eigen_value_tpu_torch.config import EPS, MAX_ITR

    assert tref.parallel_oracle.__defaults__ == (EPS, MAX_ITR, np.float32)
    assert tref.sequential_oracle.__defaults__ == (EPS,)
    assert tref.OracleResult._fields == jref.OracleResult._fields
    for n, rounds in tfx.HILBERT_ROUNDS.items():
        if n <= 256:
            assert tref.parallel_oracle(tfx.hilbert_matrix(n).numpy()).rounds == rounds


def _masked(text: str) -> str:
    return re.sub(r"\s+\d+\.\d\d ms", " <t> ms", text)  # the padding moves with the time


@pytest.mark.parametrize("semantics", ["sequential", "parallel"])
def test_the_cli_prints_jaxs_table(capsys, semantics):
    argv = ["--semantics", semantics, "--max-pow", "6"]
    assert jax_cli(argv) == 0
    want = capsys.readouterr().out
    assert port_cli(argv) == 0
    got = capsys.readouterr().out
    assert _masked(got) == _masked(want)
    assert got.startswith(f"{semantics.capitalize()} Similarity Transform")
    assert len(got.splitlines()) == 2 + 2  # the title, a blank line, 32² and 64²


def test_the_cli_names_itself():
    with pytest.raises(SystemExit):
        port_cli(["--help"])


_NO_JAX = (
    "import runpy, sys\n"
    "sys.modules['jax'] = None\n"
    "sys.modules['eigen_value_tpu'] = None\n"
    "import eigen_value_tpu_torch.reference_impl as r\n"
    "assert r.parallel_oracle([[1.0, 1.0, 2.0], [2.0, 1.0, 3.0], [2.0, 3.0, 5.0]]).rounds == 4\n"
    "sys.argv = ['oracle', '--semantics', sys.argv[1], '--max-pow', '6']\n"
    "runpy.run_module('eigen_value_tpu_torch.oracle', run_name='__main__')\n"
)


@pytest.mark.parametrize("semantics", ["sequential", "parallel"])
def test_the_oracles_run_where_jax_cannot_be_imported(semantics):
    out = subprocess.run([sys.executable, "-c", _NO_JAX, semantics], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith(f"{semantics.capitalize()} Similarity Transform")
    assert "64   x   64" in out.stdout
