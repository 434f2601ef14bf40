"""A run that finds no card, or no program, prints no result and fails."""

import json
import os
import shutil
import subprocess
import sys

from evbench.catalog import ROOT


def no_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if "correct" in json.loads(line):
                return False
        except (ValueError, TypeError):
            pass
    return True


def test_no_card_exits_nonzero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "evbench", "--workload", "hilbert8192_f32.sym", "--seed",
         str(2**31 + 1), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and no_result(out.stdout)
    assert "CUDA" in out.stderr


def test_the_benchmark_alone_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and evbench/, the run
    stops at the missing program (shown here on the CPU, past the card's
    check)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "evbench", tmp_path / "evbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = (
        "import time, torch\n"
        "from evbench.catalog import Catalog\n"
        "from evbench.run import run_cell\n"
        "run_cell(Catalog(), 'hilbert8192_f32.sym', 1, 0.1, False, torch.device('cpu'),"
        " time.perf_counter())\n"
    )
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and no_result(out.stdout)
    assert "eigen_value_tpu_torch" in out.stderr
