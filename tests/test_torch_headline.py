"""The port's headline record (``eigen_value_tpu_torch/bench/headline.py``)
against the root ``bench.py``: the record's host logic (``summarize``,
``physical_floor_ms``, ``_split_suspect``, ``classify_chip_state``,
``failure_record``) on the same canned windows, and one in-process run in
the CPU mode at 128², as far as the CPU can say.  Nothing here times a
device: without a card the headline refuses to measure.
"""

import importlib.util
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from eigen_value_tpu.ops.pallas.kernels import sym_cache_split as jax_sym_cache_split  # noqa: E402
from eigen_value_tpu_torch.bench import headline  # noqa: E402
from eigen_value_tpu_torch.bench.suite import sym_traffic_frac  # noqa: E402


@pytest.fixture(scope="module")
def jax_bench():
    path = Path(__file__).resolve().parent.parent / "bench.py"
    spec = importlib.util.spec_from_file_location("jax_headline_bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.DIM == headline.DIM == 8192
    return mod


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


CLEAN3 = [(6.7, 90.0, 36.0), (6.4, 88.0, 35.0), (6.9, 91.0, 37.0)]
EVEN4 = [(6.0, 80.0, 30.0), (6.0, 80.0, 30.0), (6.6, 88.0, 36.0), (6.6, 88.0, 36.0)]
MIXED = [(0.2, 50.0, 48.0), (0.9, 60.0, 52.0), (1.1, 61.0, 52.0)]
SLOW = [(7.4, 90.0, 36.0), (7.6, 91.0, 37.0)]
FAST = [(5.6, 80.0, 30.0), (6.2, 85.0, 33.0), (7.4, 90.0, 36.0)]

SUMMARIZE_CASES = {
    "best-window": (CLEAN3, dict(rounds=17, backend="matvec_pallas")),
    "even-median": (EVEN4, dict(rounds=17, backend="matvec_pallas")),
    "single": ([(6.55, 89.0, 36.0)], dict(rounds=17, backend="xla")),
    "suspect-windows": (MIXED, dict(rounds=17, backend="multiround_sym_pallas", floor_ms=0.5)),
    "all-suspect": (MIXED, dict(rounds=17, backend="multiround_pallas", floor_ms=5.0)),
    "traffic-frac": (CLEAN3, dict(rounds=17, backend="multiround_sym_cached_pallas",
                                  frac=0.1482)),
    "extra-merged": (CLEAN3, dict(rounds=17, backend="x", extra={"bf16_ms": 1.2, "chain": 5})),
    "v5e-slow-note": (SLOW, dict(rounds=17, backend="matvec_pallas", peak_gbps=819.0)),
    "v5e-slow-note-target": (SLOW, dict(rounds=17, backend="matvec_pallas", peak_gbps=819.0,
                                        frac=0.531, fast_target_ms=3.24)),
    "v5e-states": (FAST, dict(rounds=17, backend="matvec_pallas", peak_gbps=819.0)),
    "v5e-floor-and-states": (MIXED, dict(rounds=17, backend="m", floor_ms=0.5,
                                         peak_gbps=819.0, frac=0.2)),
}


@pytest.mark.parametrize("case", list(SUMMARIZE_CASES))
def test_summarize_equals_the_root_scripts(jax_bench, case):
    windows, kw = SUMMARIZE_CASES[case]
    want = jax_bench.summarize(windows, **kw)
    assert headline.summarize(windows, **kw) == want
    assert json.loads(json.dumps(want, allow_nan=False)) == want


@pytest.mark.parametrize(
    "args",
    [(17, 819.0), (17, 3350.0), (17, 3350.0, None, 1.2, 0.1482), (9, 3350.0, 128),
     (20, 3350.0, 32768, 1.0, 0.5039), (17, float("nan")), (17, 0.0), (17, None),
     (21, 3350.0, 65536, 1.5, 1.0)],
)
def test_physical_floor_equals_the_root_scripts(jax_bench, args):
    assert headline.physical_floor_ms(*args) == jax_bench.physical_floor_ms(*args)


@pytest.mark.parametrize("floor", [0.0, 0.5, 0.95, 5.0])
def test_split_suspect_equals_the_root_scripts(jax_bench, floor):
    assert headline._split_suspect(MIXED, floor) == jax_bench._split_suspect(MIXED, floor)


@pytest.mark.parametrize(
    "args",
    [(6.4, 17, 819.0), (5.6, 17, 819.0), (7.4, 17, 819.0), (1.3, 17, 819.0, None, 0.148),
     (0.5, 9, 819.0, 128), (6.4, 17, None), (6.4, 17, float("nan")), (0.0, 17, 819.0),
     (0.74, 17, 3350.0, None, 0.25)],
)
def test_classify_chip_state_equals_the_root_scripts(jax_bench, args):
    assert headline.classify_chip_state(*args) == jax_bench.classify_chip_state(*args)


def test_failure_record_keeps_the_root_scripts_keys(jax_bench):
    want = jax_bench.failure_record(1)
    got = headline.failure_record("RuntimeError: no card")
    # the same keys and the same nulls; the error says what failed (the root
    # script's text is about its tunnel), and the port retries nothing
    assert list(got) == list(want)
    for key in ("metric", "value", "unit", "vs_baseline", "attempts"):
        assert got[key] == want[key]
    assert got["error"] == "RuntimeError: no card" and got["retry_budget_s"] == 0.0
    assert headline.failure_record("e", dim=128)["metric"] == "hilbert_128_e2e_device"


@pytest.mark.parametrize("n,bt,cache", [(8192, 512, 104), (8192, 128, 396), (2048, 128, 0),
                                        (32768, 128, 0), (1024, 256, 3)])
def test_the_traffic_fraction_is_the_root_scripts(n, bt, cache):
    passes = 18
    streamed, cached = jax_sym_cache_split(n, bt, cache)
    want = (passes * len(streamed) + len(cached)) * bt * bt / (passes * n * n)
    assert sym_traffic_frac(n, bt, cache, passes) == pytest.approx(want, rel=1e-12)
    if cache == 0:  # JAX's large rows: half the tiles plus the diagonal ones
        assert sym_traffic_frac(n, bt, 0, passes) == pytest.approx(0.5 + 0.5 * bt / n)


def test_settings_come_from_the_environment():
    assert headline.settings_from_env({}) == headline.Settings(8192, 8, 2.0, "cuda")
    got = headline.settings_from_env({"BENCH_DIM": "128", "BENCH_WINDOWS": "2",
                                      "BENCH_WINDOW_GAP_S": "0", "BENCH_DEVICE": "cpu"})
    assert got == headline.Settings(128, 2, 0.0, "cpu")
    with pytest.raises(ValueError, match="BENCH_DEVICE='tpu'"):
        headline.settings_from_env({"BENCH_DEVICE": "tpu"})
    with pytest.raises(ValueError, match="at least one window"):
        headline.settings_from_env({"BENCH_WINDOWS": "0"})


def _run_main(monkeypatch, capsys, **env):
    for key in ("BENCH_DIM", "BENCH_WINDOWS", "BENCH_WINDOW_GAP_S", "BENCH_DEVICE"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    rc = headline.main()
    lines = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(lines[-1])


def test_the_cpu_mode_gives_the_root_scripts_record(jax_bench, monkeypatch, capsys):
    rc, rec = _run_main(monkeypatch, capsys, BENCH_DEVICE="cpu", BENCH_DIM="128",
                        BENCH_WINDOWS="2", BENCH_WINDOW_GAP_S="0")
    assert rc == 0
    keys = set(jax_bench.summarize(MIXED, 17, "m", floor_ms=0.5, frac=0.5))
    assert keys - {"traffic_frac", "suspect_windows_ms"} <= set(rec)
    assert rec["rounds"] == 9 and rec["hankel_fft_rounds"] == rec["rounds"]
    assert rec["bf16_rounds"] == 9 and "PARITY DRIFT" not in rec["hankel_fft_note"]
    assert len(rec["windows_ms"]) == 2 and rec["value"] == min(rec["windows_ms"])
    assert rec["bf16_ms"] > 0 and rec["hankel_fft_ms"] > 0 and rec["call_ms"] > 0
    # a host-clock record names no device metric and no card
    assert rec["metric"] == "hilbert_128_e2e_cpu" and rec["device"] == {"platform": "cpu"}
    assert "clocks" not in rec and rec["compute_bound"] is None and rec["floor_ms"] == 0.0
    # the CPU takes the torch.mv loop: no symmetric route, no kernel launched
    assert rec["backend"] == "matvec" and rec["cache_tiles"] == 0
    assert "dense_f32_ms" not in rec and "sym_stream_ms" not in rec
    assert set(rec["launches"]) == set(headline.COUNTED) and not any(rec["launches"].values())
    assert rec["eigenvalue"] == pytest.approx(2.21719, rel=1e-5)
    assert json.loads(json.dumps(rec, allow_nan=False)) == rec
    # host-clock times under a loaded test run: positive, their arithmetic is
    # summarize's (held to the root script's above)
    assert rec["vs_baseline"] > 0 and rec["wall_chain_ms"] > 0 and rec["wall_single_ms"] > 0


def test_without_a_card_the_record_is_the_failure_record(monkeypatch, capsys):
    _no_card()
    rc, rec = _run_main(monkeypatch, capsys, BENCH_DIM="128")
    assert rc == 1 and rec["value"] is None and rec["vs_baseline"] is None
    assert rec["metric"] == "hilbert_128_e2e_device" and "CUDA device" in rec["error"]
    rc, rec = _run_main(monkeypatch, capsys, BENCH_DEVICE="tpu")
    assert rc == 1 and "BENCH_DEVICE='tpu'" in rec["error"]
