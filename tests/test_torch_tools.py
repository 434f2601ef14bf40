"""The port's tools against the JAX package's, as far as the CPU can say:
the packages' exports, the checkpoint's stepping of a DTensor A, the timing
helpers, the scaling model (every function on the JAX package's v5e spec,
exactly; the H100 spec's fields), the calibrate, model, native, large and
drift suites' rows and tables, the profiling helpers and ``python -m
eigen_value_tpu_torch``.
"""

import json
import math
import re
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import eigen_value_tpu as J  # noqa: E402
import eigen_value_tpu.bench as jax_bench_pkg  # noqa: E402
import eigen_value_tpu.ops as jax_ops  # noqa: E402
import eigen_value_tpu.parallel as jax_parallel  # noqa: E402
import eigen_value_tpu.utils as jax_utils  # noqa: E402
from eigen_value_tpu.bench import suite as jax_suite  # noqa: E402
from eigen_value_tpu.bench.__main__ import main as jax_cli  # noqa: E402
from eigen_value_tpu.utils import scaling_model as jsm  # noqa: E402
from eigen_value_tpu.utils import timing as jtiming  # noqa: E402

import eigen_value_tpu_torch as evt  # noqa: E402
import eigen_value_tpu_torch.bench as tbench  # noqa: E402
import eigen_value_tpu_torch.ops as tops  # noqa: E402
import eigen_value_tpu_torch.parallel as tparallel  # noqa: E402
import eigen_value_tpu_torch.utils as tutils  # noqa: E402
from eigen_value_tpu_torch import checkpoint as cp  # noqa: E402
from eigen_value_tpu_torch import fixtures as tfx  # noqa: E402
from eigen_value_tpu_torch import native  # noqa: E402
from eigen_value_tpu_torch.bench import __main__ as cli  # noqa: E402
from eigen_value_tpu_torch.bench import suite as tsuite  # noqa: E402
from eigen_value_tpu_torch.ops import solver as tsolver  # noqa: E402
from eigen_value_tpu_torch.ops.solver_matvec import solve_matvec  # noqa: E402
from eigen_value_tpu_torch.utils import profiling  # noqa: E402
from eigen_value_tpu_torch.utils import scaling_model as tsm  # noqa: E402
from eigen_value_tpu_torch.utils import timing  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# --- the packages export what the JAX package's export ----------------------------

#: JAX names of ported modules that the port's README lists as not ported:
#: the AOT cache of ``utils/aot.py``.
NOT_PORTED = {"disable_persistent_cache", "enable_persistent_cache", "export_sharded_solver",
              "export_solver", "load_exported", "save_exported"}


@pytest.mark.parametrize(
    "jax_mod,port_mod",
    [(J, evt), (jax_ops, tops), (jax_parallel, tparallel), (jax_utils, tutils),
     (jax_bench_pkg, tbench)],
    ids=["package", "ops", "parallel", "utils", "bench"],
)
def test_the_port_exports_what_jax_exports(jax_mod, port_mod):
    missing = set(jax_mod.__all__) - set(port_mod.__all__) - NOT_PORTED
    assert not missing
    for name in port_mod.__all__:
        assert getattr(port_mod, name) is not None


def test_the_readme_lists_what_is_not_exported():
    with open(os.path.join(ROOT, "README.md"), encoding="utf-8") as f:
        readme = f.read()
    assert "utils/aot.py" in readme and "Not ported" in readme


def test_checkpoint_and_the_ops_names_are_the_modules_own():
    assert evt.checkpoint is cp and "checkpoint" in evt.__all__
    for name in jax_ops.__all__:
        assert getattr(tops, name) is getattr(tsolver, name)
    assert tbench.suite is tsuite


# --- the checkpoint steps a DTensor A ---------------------------------------------


@pytest.fixture(scope="module")
def one_rank_mesh():
    """A one-rank gloo group in this process, destroyed after the module."""
    import torch.distributed as dist

    started = not dist.is_initialized()
    mesh = tparallel.make_row_mesh(1, device_type="cpu")
    yield mesh
    if started:
        dist.destroy_process_group()


def _equal(got, want) -> bool:
    return all(torch.equal(g, w) for g, w in zip(got, want))


def test_the_checkpoint_steps_a_sharded_a_to_the_whole_matrixs_bits(one_rank_mesh):
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    H = tfx.hilbert_matrix(128)
    A = distribute_tensor(H, one_rank_mesh, [Shard(0)])
    state = cp.init_state(A)
    assert state.A is A and _equal(state[1:], cp.init_state(H)[1:])
    assert _equal(cp.step(state, 4)[1:], cp.step(cp.init_state(H), 4)[1:])
    assert _equal(cp.step(cp.init_state(H)._replace(A=A), 4)[1:],
                  cp.step(cp.init_state(H), 4)[1:])
    got = cp.solve_checkpointed(A, 4)
    assert _equal(got, cp.solve_checkpointed(H, 4))
    assert not any(isinstance(x, DTensor) for x in got)
    assert int(got.rounds) == tfx.HILBERT_ROUNDS[128]
    # the whole matrix steps as before
    assert int(cp.solve_checkpointed(A.full_tensor(), 4).rounds) == tfx.HILBERT_ROUNDS[128]


def _placed(mesh, name: str):
    from torch.distributed.tensor import DTensor, Partial, Shard

    H = tfx.hilbert_matrix(128)
    return DTensor.from_local(H, mesh, [{"Shard(1)": Shard(1), "Partial": Partial()}[name]],
                              run_check=False)


@pytest.mark.parametrize("name, shown", [("Shard(1)", "Shard(dim=1)"), ("Partial", "Partial(sum)")])
def test_an_unsupported_placement_is_refused_by_name(one_rank_mesh, name, shown):
    A = _placed(one_rank_mesh, name)
    H = tfx.hilbert_matrix(128)
    for call in (lambda: cp.init_state(A), lambda: cp.solve_checkpointed(A, 4),
                 lambda: cp.step(cp.init_state(H)._replace(A=A), 4)):
        with pytest.raises(ValueError, match=rf"placed as \({re.escape(shown)},\) on a 1-D mesh"):
            call()


# --- timing ------------------------------------------------------------------------


@pytest.mark.parametrize("pct", [None, float("nan"), 0.0, 50.0, 93.99, 94.0, 99.0, 100.0,
                                 100.01, 113.6, 180.0])
def test_the_chip_state_classes_are_jaxs(pct):
    assert timing.classify_state_pct(pct) == jtiming.classify_state_pct(pct)
    assert (timing.FAST_STATE_PCT, timing.MID_STATE_PCT) == (jtiming.FAST_STATE_PCT,
                                                             jtiming.MID_STATE_PCT)


def test_force_reads_one_number_of_the_smallest_leaf():
    res = evt.max_eigenvalue(tfx.hilbert_matrix(128), device="cpu")
    assert timing.force(res) == float(res.eigenvalue)
    assert timing.force({"a": torch.arange(5.0) + 2, "b": [torch.tensor([7.0, 8.0])]}) == 7.0
    assert timing.force(3) == 3.0


def test_the_peak_tables():
    assert timing.detect_peak_hbm_gbps is timing.detect_peak_gbps
    assert timing._PEAK_GBPS["H100"] == 3350.0 and timing._PEAK_F32_TFLOPS["H100"] == 67.0
    # the JAX table names TPU generations only: none of its keys is a CUDA card's
    assert jtiming.detect_peak_hbm_gbps() != jtiming.detect_peak_hbm_gbps()  # NaN off-TPU


def test_smi_values_parse_and_na_is_none():
    assert timing._number("700.00") == 700.0 and timing._number("[N/A]") is None


# --- the scaling model ---------------------------------------------------------------

V5E = tsm.V5E_SPEC
MEASURED = {8192: 350.0, 32768: 420.0, 131072: 700.0}
LATENCY_ONLY = {8192: 650.0, 32768: 640.0, 131072: 648.0}

MODEL_CALLS = {
    "local_matvec_us": [(8192, 1), (32768, 8), (65536, 64)],
    "gather_exchange_us": [(8192, 1), (8192, 8), (32768, 16, 2), (65536, 256, 32)],
    "ring_exchange_exposed_us": [(8192, 1), (8192, 8), (8192, 64, 8), (65536, 256, 32)],
    "exchange_2d_us": [(8192, 1, 1), (8192, 2, 4), (32768, 4, 4, 2), (65536, 16, 16, 32)],
    "round_time_2d_us": [(8192, 1, 1), (8192, 2, 4), (32768, 8, 8, 8)],
    "balanced_factorization": [(1,), (4,), (8,), (12,), (64,), (256,), (7,)],
    "round_time_us": [(8192, 1), (8192, 4, 1, True), (32768, 16, 2), (65536, 256, 32, True)],
    "scaling_efficiency": [(8192, 4), (32768, 16, 2, True), (65536, 64, 8)],
    "fit_exchange": [(MEASURED, 8), (LATENCY_ONLY, 8), (MEASURED, 2, 2)],
    "calibration_rows": [(MEASURED, 8), (LATENCY_ONLY, 2)],
}


@pytest.mark.parametrize("name,args", [(n, a) for n, calls in MODEL_CALLS.items() for a in calls])
def test_every_model_function_is_jaxs_on_the_v5e_spec(name, args):
    port, jax = getattr(tsm, name), getattr(jsm, name)
    takes_spec = name not in ("balanced_factorization", "fit_exchange", "calibration_rows")
    got = port(*args, spec=V5E) if takes_spec else port(*args)
    assert got == jax(*args)


def test_the_tables_are_jaxs_on_the_v5e_spec():
    assert tsm.prediction_table(spec=V5E) == jsm.prediction_table()
    assert tsm.prediction_table(dims=[4096, 6000], chip_counts=[1, 2, 3, 8], spec=V5E) == (
        jsm.prediction_table(dims=[4096, 6000], chip_counts=[1, 2, 3, 8]))
    assert tsm.sensitivity_table() == jsm.sensitivity_table()
    assert tsm.V5E_SPEC == tsm.ChipSpec() and jsm.DEFAULT_SPEC == jsm.ChipSpec()
    assert dict(vars(tsm.V5E_SPEC)) == dict(vars(jsm.DEFAULT_SPEC))


def test_the_h100_spec_holds_its_sources_and_says_what_is_not_measured():
    spec = tsm.H100_SPEC
    assert tsm.DEFAULT_SPEC is spec
    assert spec.hbm_gbps == pytest.approx(268.5 / 0.0893, rel=1e-3)  # MB / ms = GB/s
    assert spec.ici_gbps == 450.0 and spec.ici_latency_us == pytest.approx(62.7)
    assert spec.dcn_gbps is None and spec.dcn_latency_us is None
    # within one host everything is predicted; across hosts nothing is
    assert tsm.gather_exchange_us(8192, 8, 1) > 0
    for fn in (tsm.gather_exchange_us, tsm.ring_exchange_exposed_us, tsm.round_time_us,
               tsm.scaling_efficiency):
        assert fn(8192, 16, 2) is None
    assert tsm.round_time_2d_us(8192, 4, 4, 2) is None
    rows = tsm.prediction_table()
    assert all((r["round_us"] is None) == (r["hosts"] > 1) for r in rows)
    assert all((r["efficiency"] is None) == (r["hosts"] > 1) for r in rows)
    for r in rows:
        assert json.loads(json.dumps(r, allow_nan=False)) == r


# --- the CLI's model, native, calibrate, large and drift tables ------------------------


def _jax_cli_text(capsys, monkeypatch, suite, rows=None, *args):
    if rows is not None:
        monkeypatch.setattr(jax_suite, {"native": "bench_native", "large": "bench_large",
                                        "drift": "bench_drift",
                                        "calibrate": "bench_exchange_calibration"}[suite],
                            lambda *a, **k: rows)
    assert jax_cli(["--suite", suite, *args]) == 0
    return capsys.readouterr().out


def test_the_model_table_is_the_jax_clis(capsys, monkeypatch):
    want = _jax_cli_text(capsys, monkeypatch, "model")
    got = cli._fmt_model(tsm.prediction_table(spec=V5E), tsm.sensitivity_table())
    assert got + "\n" == want


def test_the_model_suite_needs_no_card_and_says_not_measured(capsys):
    assert cli.main(["--suite", "model"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("spec: ChipSpec(") and "dcn_gbps=None" in out
    assert "16 chip(s) /  2 host(s): not measured (the spec's DCN)" in out
    assert "latency 0.5-62.7 us" in out
    assert cli.main(["--suite", "model", "--dims", "8192", "--json"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert {r["bench"] for r in rows} == {"model", "model_sensitivity"}
    assert any(r["efficiency"] is None for r in rows) and any(r["efficiency"] for r in rows)


NATIVE_ROWS = [
    {"bench": "native", "backend": "cpu_native", "dim": 128, "ms": 3.0, "rounds": 9,
     "eigenvalue": 2.2171912, "rounds_ok": True},
    {"bench": "native", "backend": "cpu_native_matvec", "dim": 128, "ms": 0.0, "rounds": 9,
     "eigenvalue": 2.2171905, "rounds_ok": True},
    {"bench": "native_kernel", "kernel": "native_row_sums", "dim": 128, "ms": 0.0036},
]


def test_the_native_table_is_the_jax_clis(capsys, monkeypatch):
    want = _jax_cli_text(capsys, monkeypatch, "native", NATIVE_ROWS)
    assert cli._fmt_native(NATIVE_ROWS) + "\n" == want


def test_the_native_suite_runs_the_jax_suites_rows():
    if not native.available():
        pytest.skip("no C++ compiler builds native/ here")
    got, want = tsuite.bench_native([128, 256]), jax_suite.bench_native([128, 256])
    strip = lambda rows: [{k: v for k, v in r.items() if k != "ms"} for r in rows]  # noqa: E731
    assert strip(got) == strip(want)
    assert all(r["rounds_ok"] for r in got if r["bench"] == "native")
    with pytest.raises(ValueError, match="square"):
        native.NativeEigenValue().similarity_transform(np.ones((3, 4), np.float32))


CALIB_OUTS = [{"process_id": 0, "num_processes": 2, "shards": 2,
               "exchange_us": {"8192": 650.0, "32768": 860.0, "131072": 1490.0}},
              {"process_id": 1, "num_processes": 2, "shards": 2,
               "exchange_us": {"8192": 694.0, "32768": 850.0, "131072": 1480.0}}]
CALIB_CROSS = [{"process_id": r, "num_processes": 4, "shards": 4,
                "exchange_us": {"8192": 2800.0 + r, "32768": 3300.0, "131072": 3450.0}}
               for r in range(4)]


def test_the_calibration_is_jaxs_fit_and_rows():
    import dataclasses

    rows = tsuite.calibration_table(CALIB_OUTS, CALIB_CROSS)
    measured = {8192: 694.0, 32768: 860.0, 131072: 1490.0}
    # JAX's bench_exchange_calibration on the same worker records
    gbps, lat = jsm.fit_exchange(measured, 2)
    spec = dataclasses.replace(jsm.DEFAULT_SPEC, ici_gbps=gbps, ici_latency_us=lat)
    want = jsm.calibration_rows(measured, 2, spec=spec)
    for n in (8192, 32768, 131072):
        pred = jsm.gather_exchange_us(n, 4, 1, spec)
        meas = 2803.0 if n == 8192 else {32768: 3300.0, 131072: 3450.0}[n]
        want.append({"bench": "model_calibration_crossP", "dim": n, "chips": 4,
                     "fitted_on_chips": 2, "measured_us": meas, "predicted_us": pred,
                     "ratio": meas / pred})
    assert [{k: v for k, v in r.items() if not k.startswith("transport")} for r in rows] == want
    assert all(r["transport"] == "gloo-loopback" and "not NVLink" in r["transport_note"]
               for r in rows)
    assert tsm.calibration_rows(measured, 2) == jsm.calibration_rows(measured, 2)
    assert cli._fmt_calibrate(rows).count("[cross-P: fitted on 2 shards]") == 3


def test_the_calibrate_table_is_the_jax_clis(capsys, monkeypatch):
    rows = tsuite.calibration_table(CALIB_OUTS, CALIB_CROSS)
    want = _jax_cli_text(capsys, monkeypatch, "calibrate", rows)
    assert cli._fmt_calibrate(rows) + "\n" == want


def test_the_worker_measures_the_exchange_on_gloo():
    outs = tsuite.run_mh_workers(2, 256, 1, device="cpu", extra_args=["--measure-exchange"],
                                 timeout_s=300)
    assert [o["process_id"] for o in outs] == [0, 1]
    for o in outs:
        assert o["shards"] == o["num_processes"] == 2
        assert sorted(int(n) for n in o["exchange_us"]) == [256, 1024, 4096]
        assert all(us >= 0 for us in o["exchange_us"].values())


SMALL_LARGE = [("f32_512", 512, torch.float32, False), ("sym_f32_512", 512, torch.float32, True),
               ("bf16_1024", 1024, torch.bfloat16, False),
               ("sym_bf16_1000", 1000, torch.bfloat16, True)]


def test_the_large_rows_at_small_dims(monkeypatch):
    monkeypatch.setattr(tsuite, "LARGE_CONFIGS", SMALL_LARGE)
    monkeypatch.setattr(tsuite, "_marginal_resolved", lambda step, init, k, reps: (1.5, k, True))
    rows = tsuite.large_rows("cpu")
    by = {r["backend"]: r for r in rows}
    assert [r["backend"] for r in rows] == [c[0] for c in SMALL_LARGE]
    jax_keys = {"bench", "backend", "dim", "device_ms", "ms_per_round", "rounds", "eigenvalue",
                "converged", "rounds_ok"}
    for name in ("f32_512", "sym_f32_512", "bf16_1024"):
        r = by[name]
        assert jax_keys <= set(r) and r["rounds_ok"] and r["device_ms"] == 1.5
        assert r["rounds"] == tfx.HILBERT_ROUNDS[r["dim"]] == r["oracle_rounds"]
        assert r["rel_err"] <= tsuite.LARGE_REL
        assert json.loads(json.dumps(r, allow_nan=False)) == r
    assert by["sym_f32_512"]["traffic_frac"] == pytest.approx(0.625)
    assert by["sym_f32_512"]["cache_tiles"] == 0  # the CPU keeps no tile cache
    assert "skipped" in by["sym_bf16_1000"]  # no 128-aligned tile divides 1000
    # the bf16 row solves the stored bf16 values: its oracle is their float64 loop
    Aq = tfx.hilbert_matrix(1024, dtype=torch.bfloat16)
    want = solve_matvec(Aq.double(), 1e-3, 1000)
    assert by["bf16_1024"]["oracle_eigenvalue"] == float(want.eigenvalue)


def test_the_large_table_is_the_jax_clis(capsys, monkeypatch):
    rows = [
        {"bench": "large", "backend": "f32_32768", "dim": 32768, "device_ms": 30.5,
         "ms_per_round": 1.5, "rounds": 20, "eigenvalue": 2.6765, "converged": True,
         "rounds_ok": True},
        {"bench": "large", "backend": "bf16_65536", "dim": 65536, "device_ms": 66.1,
         "ms_per_round": 3.1, "rounds": 22, "eigenvalue": 2.7094, "converged": True,
         "rounds_ok": False},
        {"bench": "large", "backend": "sym_f32_32768", "dim": 32768, "error": "out of memory"},
    ]
    want = _jax_cli_text(capsys, monkeypatch, "large", rows)
    assert cli._fmt_large(rows) + "\n" == want
    skip = {"bench": "large", "backend": "sym_bf16_65536", "dim": 65536, "skipped": "why"}
    assert cli._fmt_large([skip]) == "[large:sym_bf16_65536] 65536 x 65536: skipped: why"


@pytest.mark.parametrize("ms,reason", [(0.0926, None), (0.0501, "fast_outlier"),
                                       (0.7, "stall"), (0.0, None)])
def test_the_drift_rows_flag_what_jax_flags(ms, reason):
    row = tsuite.drift_row(0, 0.0, ms, 8192, 3350.0, {"sm_mhz": 1980.0, "power_w": 300.0,
                                                      "temp_c": 40.0})
    assert row["suspect_reason"] == reason and row["suspect"] == (reason is not None)
    pct = None if ms <= 0 else 100 * 8192 * 8192 * 4 / (ms * 1e-3) / 1e9 / 3350.0
    assert row["roofline_pct"] == (None if pct is None else pytest.approx(pct))
    assert row["sm_mhz"] == 1980.0 and "chip_state" not in row


def test_the_drift_summary_and_table(capsys, monkeypatch):
    rows = [tsuite.drift_row(w, float(w), ms, 8192, 3350.0, state)
            for w, (ms, state) in enumerate([
                (0.0926, {"sm_mhz": 1980.0, "power_w": 480.0, "temp_c": 48.0}),
                (0.0931, {"sm_mhz": 1755.0, "power_w": 150.0, "temp_c": 41.0}),
                (0.7, None)])]
    summary = tsuite.drift_summary(rows, 8192, 3, 1.0)
    assert summary["suspect_windows"] == 1 and summary["spread_pct"] == 0.5
    assert summary["sm_mhz_range"] == [1755.0, 1980.0]
    assert summary["power_w_range"] == [150.0, 480.0]
    text = cli._fmt_drift(rows + [summary]).splitlines()
    jax_rows = [dict({k: v for k, v in r.items() if k not in ("sm_mhz", "power_w", "temp_c")},
                     chip_state=None) for r in rows[:2]]
    jax_rows.append(dict(summary))
    want = _jax_cli_text(capsys, monkeypatch, "drift", jax_rows).splitlines()
    # the JAX line of a clean window, then the card's state
    assert text[0].startswith(want[0]) and text[0].endswith("[1980 MHz  480 W  48 C]")
    assert text[1].startswith(want[1])
    assert "[SUSPECT: stall]" in text[2] and "[n/a  n/a  n/a]" in text[2]
    assert text[3].startswith(want[2].split(" (")[0])


# --- profiling and the package's entry point -------------------------------------------


def test_the_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    with profiling.trace(str(tmp_path / "t")) as d:
        with profiling.annotate("a solve"):
            evt.max_eigenvalue(tfx.hilbert_matrix(64), device="cpu")
    events = json.load(open(os.path.join(d, profiling.TRACE_FILE)))["traceEvents"]
    assert any(e.get("name") == "a solve" for e in events)
    assert d == str(tmp_path / "t")


def test_the_trace_raises_what_its_body_raises(tmp_path):
    with pytest.raises(ZeroDivisionError):
        with profiling.trace(str(tmp_path)):
            1 / 0


def test_device_memory_stats_without_a_card_is_none():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    assert profiling.device_memory_stats() is None


def test_python_m_the_package_is_the_bench_cli():
    out = subprocess.run([sys.executable, "-m", "eigen_value_tpu_torch", "--help"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "--suite" in out.stdout
    assert all(s in out.stdout for s in ("large", "drift", "calibrate", "model", "native"))
    out = subprocess.run([sys.executable, "-m", "eigen_value_tpu_torch", "--suite", "model",
                          "--dims", "8192"], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and "[matvec_ring] 8192² on   8 chip(s)" in out.stdout
    assert math.isfinite(tsm.H100_SPEC.hbm_gbps)
