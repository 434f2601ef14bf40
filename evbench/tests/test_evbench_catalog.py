"""BENCHMARK.json against the benchmark's contract, and discovery by name:
every part of a cell is a file found from a name, so a cell, a mix, a call
kind or a metric is added by files and entries alone."""

import json
import re
import time

import pytest
import torch

from evbench import compare
from evbench.catalog import ROOT, Catalog
from evbench.run import run_cell

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert not p.startswith("/") and (ROOT / p).is_dir()
    assert 1 <= len(SPEC["command"]) <= 32
    for word in SPEC["command"]:
        assert LINE.match(word) and not word.startswith("/") and ".." not in word


def test_run_seconds_fit_the_full_check():
    s = SPEC["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entries():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for group in (SPEC["configs"], SPEC["workloads"], metrics):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"]) and len(c["reduced"]) <= 16
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(m["layer"])
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {m["name"]: m["bound"] for m in SPEC["end_to_end"]}["setup_s"] <= 0.25


def test_cells():
    configs = {c["name"] for c in SPEC["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs)) and 1 <= len(pairs) <= 24
    assert {w["config"] for w in SPEC["workloads"]} == configs
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(pairs) // 4)
    cat = Catalog()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and LINE.match(w["why"]) and NAME.match(w["traffic"])
        e2e = [m["name"] for m in cat.metrics_for(w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cat.metrics_for(w["name"], "per_layer")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", [])) <= {w["name"] for w in SPEC["workloads"]}


def test_every_name_finds_its_file():
    cat = Catalog()
    for w in SPEC["workloads"]:
        config, traffic = cat.config(w["config"]), cat.traffic(w["traffic"])
        assert config["n"] > 0 and traffic["pool"] >= 1
        assert callable(cat.call_kind(traffic["call"]).start)
        limits = cat.limits(w["name"])
        assert set(compare.NUMBERS) <= set(limits)
        assert limits["rounds_off"] == 0 and limits["converged_off"] == 0
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(cat.metric(m["name"]).read)
    with pytest.raises(KeyError):
        cat.workload("no_such.cell")


def test_a_cell_added_from_files_alone_runs(tiny):
    root, cells = tiny
    cat = Catalog(root)
    assert cat.spec["workloads"][-1]["name"] == cells["dense"]
    result = run_cell(cat, cells["dense"], 2**31 + 3, 0.2, False, torch.device("cpu"),
                      time.perf_counter(), log=lambda *a, **k: None)
    assert result["correct"] and result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"solve_ms", "call_p95_ms", "setup_s"}
    assert list(result)[-1] == "checks"
