"""Shared fixtures of the benchmark's tests (run: python -m pytest evbench/tests).

``tiny`` is a copy of the benchmark with two more cells added from files
alone: the 8192² configuration cut to 384² under the ``sym`` and ``dense``
mixes, held to the limits of the cells they stand for.  Like the cells it
stands for, 384² keeps one round count for every seed, its stop checks
well away from eps (at 256² one seed's check lies within 6e-5 · eps of it,
where a float32 solve may take a round more or less than the reference).  The CPU runs them
through the port's plain versions; the card tests (marker ``cuda``) decide
inside a fixture whether a card exists.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_N = 384


def add_cell(root: Path, config: str, n: int, traffic: str, stands_for: str) -> str:
    """Add a cell of ``config`` cut to n² under ``traffic`` to the benchmark
    copy at ``root``, from files and entries alone; its name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    name = f"{config}_n{n}"
    cfg_file = root / "evbench" / "configs" / f"{name}.json"
    if not cfg_file.exists():
        cfg = json.loads((root / "evbench" / "configs" / f"{config}.json").read_text())
        cfg.update(name=name, n=n, reduced=["n"])
        cfg_file.write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "https://example.org/tiny",
                                 "file": f"evbench/configs/{name}.json", "reduced": ["n"],
                                 "why": "a test's cut"})
    cell = f"{name}.{traffic}"
    bench["workloads"].append({"name": cell, "config": name, "traffic": traffic, "chips": 1,
                               "why": "a test's cell"})
    shutil.copy(root / "evbench" / "limits" / f"{stands_for}.json",
                root / "evbench" / "limits" / f"{cell}.json")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return cell


@pytest.fixture
def tiny(tmp_path):
    """``(root, {"sym": cell, "dense": cell})``: a benchmark copy with the
    384² cells."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "evbench", tmp_path / "evbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    cells = {t: add_cell(tmp_path, "hilbert8192_f32", TINY_N, t, f"hilbert8192_f32.{t}")
             for t in ("sym", "dense")}
    return tmp_path, cells


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
