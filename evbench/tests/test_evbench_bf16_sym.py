"""The cell ``hilbert8192_bf16.sym``: A held in bfloat16 on the triangle
path.  Its configuration, cell, limits and two metrics load by name; a
384² cut of the configuration under the ``sym`` mix runs correct on the
CPU; and each new reader is absent, not an error, where its source is."""

import json
import shutil
import time
import types

import pytest
import torch

from evbench import trace
from evbench.catalog import ROOT, Catalog
from evbench.compare import Answer
from evbench.run import Run, run_cell

from conftest import TINY_N, add_cell
from test_evbench_spans import untraced_slice

CELL = "hilbert8192_bf16.sym"
NEW = ("multiround_sym_bf16_roofline", "sym_hbm_mb_per_round")


def test_the_configuration_cell_limits_and_metrics_load_by_name():
    cat = Catalog()
    cell = cat.workload(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("hilbert8192_bf16", "sym", 1)
    config = cat.config("hilbert8192_bf16")
    f32 = cat.config("hilbert8192_f32")
    # the f32 rung's semantics, A stored in bfloat16, nothing cut
    assert config["storage_dtype"] == "bfloat16" and config["reduced"] == []
    for key in ("matrix", "n", "dtype", "eps", "eps_mode", "max_itr", "scale"):
        assert config[key] == f32[key]
    assert cat.traffic(cell["traffic"])["solver"] == {"symmetric": True}
    limits = cat.limits(CELL)
    assert limits["rounds_off"] == 0 and limits["converged_off"] == 0
    assert "fp8" in limits["controls"] and 0 < limits["pair_rel"] < 1e-3
    per_layer = {m["name"] for m in cat.metrics_for(CELL, "per_layer")}
    assert set(NEW) <= per_layer
    # every metric without a list of cells is the new cell's too
    assert {m["name"] for m in cat.spec["per_layer"] if "workloads" not in m} <= per_layer
    assert "multiround_sym_roofline" not in per_layer  # the f32 cell's entry
    f32_sym = {m["name"] for m in cat.metrics_for("hilbert8192_f32.sym", "per_layer")}
    assert "sym_hbm_mb_per_round" in f32_sym and "multiround_sym_bf16_roofline" not in f32_sym
    dense = {m["name"] for m in cat.metrics_for("hilbert8192_f32.dense", "per_layer")}
    assert not set(NEW) & dense
    for name in NEW:
        assert callable(cat.metric(name).read)


def _run(config=None, slice_=None, card="NVIDIA H100 80GB HBM3"):
    config = config or {"n": 8192, "dtype": "float32", "storage_dtype": "bfloat16"}
    records = [(0.0, 0.001, [Answer(0, 2.0, 17, True)])]

    class Ref:
        rounds = 17

    return Run(config, {"solver": {"symmetric": True}}, 9.0, records, 0.001, 1 << 30, [Ref()],
               card, slice_)


def test_the_bf16_roofline_counts_two_bytes_an_entry():
    """One 8192² bf16 solve of 17 rounds needs at least 2n²·18 operations
    at 67 TFLOP/s (36.1 µs), more than its n(n + 1)/2 two-byte entries at
    3.35 TB/s (20.1 µs): 9.3% of a 0.388 ms kernel."""
    kernel_us = 388.0
    device = [("void multiround_sym_kernel<__nv_bfloat16, true>(float*)", 0.0, kernel_us)]
    records = [(0.0, 0.001, [Answer(0, 2.0, 17, True)])]
    slc = trace.Slice(0.0, kernel_us, device, [(trace.SLICE, 0.0, kernel_us)], records)
    run = _run(slice_=slc)
    least_us = 2 * 8192 ** 2 * 18 / 67e12 * 1e6
    assert least_us > (8192 * 8193 // 2 * 2 + 4 * 8192) / 3.35e12 * 1e6
    got = Catalog().metric("multiround_sym_bf16_roofline").read(run)
    assert got == pytest.approx(100 * least_us / kernel_us) and 9.2 < got < 9.4


def test_the_new_readers_are_absent_without_their_sources(monkeypatch):
    from eigen_value_tpu_torch.ops.cuda import kernels

    cat = Catalog()
    # no traced slice, or a card with no published peaks
    assert cat.metric("multiround_sym_bf16_roofline").read(_run()) is None
    assert cat.metric("multiround_sym_bf16_roofline").read(_run(card="cpu")) is None
    hbm = cat.metric("sym_hbm_mb_per_round")
    # no triangle launch yet, and a program whose wrapper keeps no plan
    monkeypatch.setattr(kernels.multiround_sym, "plan", None)
    assert hbm.read(_run()) is None
    monkeypatch.delattr(kernels.multiround_sym, "plan")
    assert hbm.read(_run()) is None
    # a launch's plan: its bytes a round in MB
    monkeypatch.setattr(kernels.multiround_sym, "plan",
                        types.SimpleNamespace(hbm_bytes=31_195_136), raising=False)
    assert hbm.read(_run()) == pytest.approx(31.195136)


@pytest.fixture
def tiny_bf16(tmp_path):
    """A benchmark copy with the bf16 configuration cut to 384² under the
    ``sym`` mix, held to the bf16 cell's limits, and the two new metrics
    listing it."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "evbench", tmp_path / "evbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    cell = add_cell(tmp_path, "hilbert8192_bf16", TINY_N, "sym", CELL)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] in NEW:
            m["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path, cell


@pytest.mark.parametrize("traced", [False, True])
def test_a_384_cut_runs_correct_on_the_cpu(tiny_bf16, monkeypatch, traced):
    root, cell = tiny_bf16
    cat = Catalog(root)
    assert cat.config(cat.workload(cell)["config"])["storage_dtype"] == "bfloat16"
    monkeypatch.setattr(trace, "profile_slice", untraced_slice)
    result = run_cell(cat, cell, 2**33 + 21, 0.2, traced, torch.device("cpu"),
                      time.perf_counter(), log=lambda *a, **k: None)
    assert result["correct"] and result["attempted"] > 0 and result["failed"] == 0
    assert result["checks"]["pair_rel"]["limit"] == Catalog().limits(CELL)["pair_rel"]
    if traced:
        # read, and absent: the CPU has no peaks and launches no kernel
        assert "rounds_per_solve" in result["metrics"]
        assert not set(NEW) & set(result["metrics"])
    else:
        # call_p95_ms needs two calls, which a loaded CPU may not fit in 0.2 s
        assert {"solve_ms", "setup_s"} <= set(result["metrics"])
        assert set(result["metrics"]) <= {"solve_ms", "call_p95_ms", "setup_s"}
