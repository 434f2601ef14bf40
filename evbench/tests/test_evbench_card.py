"""On the card (marker ``cuda``): each cell's run is correct at a short
window, and a traced run reads every per-layer metric it lists."""

import time

import pytest

from evbench.catalog import Catalog
from evbench.run import run_cell

CELLS = [w["name"] for w in Catalog().spec["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_and_traced(card, cell):
    cat = Catalog()
    result = run_cell(cat, cell, 2**31 + 21, 0.5, True, card, time.perf_counter(),
                      log=lambda *a, **k: None)
    assert result["correct"], result["checks"]
    listed = {m["name"] for m in cat.metrics_for(cell, "per_layer")}
    assert set(result["metrics"]) == listed
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    for name, m in result["metrics"].items():
        if name.endswith("_roofline"):
            assert 0 < m["value"] <= 100
