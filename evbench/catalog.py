"""Discovery by name: every part of a cell is a file found from the names
that ``BENCHMARK.json`` gives.

* a configuration: the ``file`` of its entry under ``configs``;
* a traffic mix: ``evbench/traffic/<traffic>.json``;
* a call kind: ``evbench/calls/<call>.py`` (the mix's ``call``), with
  ``start(config, traffic, pool) -> call(k) -> [Answer, ...]``;
* a metric: ``evbench/metrics/<name>.py``, with ``read(run) -> float | None``;
* the limits of a cell: ``evbench/limits/<workload>.json``.

Code files are loaded from their paths, so a name may hold ``.`` and ``-``.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import List

#: The root of the checkout: the directory that holds ``BENCHMARK.json``.
ROOT = Path(__file__).resolve().parents[1]


def _module_name(kind: str, name: str) -> str:
    return f"evbench._{kind}_" + re.sub(r"[^0-9A-Za-z_]", "_", name)


class Catalog:
    """The cells, configurations, mixes, call kinds, metrics and limits of
    the benchmark under ``root``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.dir = self.root / "evbench"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        for cell in self.spec["workloads"]:
            if cell["name"] == name:
                return cell
        known = ", ".join(c["name"] for c in self.spec["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (known: {known})")

    def config(self, name: str) -> dict:
        for entry in self.spec["configs"]:
            if entry["name"] == name:
                return json.loads((self.root / entry["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def limits(self, workload: str) -> dict:
        return json.loads((self.dir / "limits" / f"{workload}.json").read_text())

    def _load(self, kind: str, name: str) -> ModuleType:
        mod_name = _module_name(kind, name)
        if mod_name in sys.modules:
            return sys.modules[mod_name]
        path = self.dir / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(mod_name, path)
        if spec is None:
            raise FileNotFoundError(path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[mod_name]
            raise
        return mod

    def call_kind(self, name: str) -> ModuleType:
        return self._load("calls", name)

    def metric(self, name: str) -> ModuleType:
        return self._load("metrics", name)

    def metrics_for(self, workload: str, section: str) -> List[dict]:
        """The entries of ``section`` ("end_to_end" or "per_layer") that
        the cell reports: those without ``workloads`` and those that list
        it."""
        return [m for m in self.spec[section] if workload in m.get("workloads", [workload])]
