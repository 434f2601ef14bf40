"""The port's kernel ladder, vector suite, end-to-end sweep, operator suite
and marginal timing, as far as the CPU can say: the step functions leave the
state their plain chain leaves, the rungs solve on the CPU, the rungs and
tables keep the JAX suite's names, keys and formats, and every path that
would report a device time refuses to run without a card.
"""

import json

import pytest

torch = pytest.importorskip("torch")

from eigen_value_tpu.bench import suite as jax_suite  # noqa: E402
from eigen_value_tpu.bench.__main__ import _fmt_e2e as jax_fmt_e2e  # noqa: E402
from eigen_value_tpu.bench.__main__ import _fmt_kernels as jax_fmt_kernels  # noqa: E402
from eigen_value_tpu.bench.__main__ import main as jax_cli_main  # noqa: E402
from eigen_value_tpu_torch import bench  # noqa: E402
from eigen_value_tpu_torch import fixtures as tfx  # noqa: E402
from eigen_value_tpu_torch.bench import __main__ as cli  # noqa: E402
from eigen_value_tpu_torch.bench import headline  # noqa: E402
from eigen_value_tpu_torch.bench import suite as tsuite  # noqa: E402
from eigen_value_tpu_torch.ops.cuda import kernels as tk  # noqa: E402
from eigen_value_tpu_torch.utils import timing  # noqa: E402

N, K = 64, 3
LADDER = ["rowsum_xla", "rowsum_pallas", "scale_xla", "scale_pallas",
          "scale_rowsum_pallas", "matvec_xla", "matvec_pallas"]


def _plain_chain(name, k):
    """The state after k steps of rung ``name``, written out with the plain
    versions only."""
    A = tfx.hilbert_matrix(N)
    v = A.sum(1)
    if name.startswith("rowsum"):
        for _ in range(k):
            v = (A + v[0] * torch.tensor(1e-38)).sum(1) if name == "rowsum_pallas" else A.sum(1)
        return A, v
    if name.startswith("scale_rowsum"):
        for _ in range(k):
            A, v = tk.scale_rowsum_plain(A, v)
        return A, v
    if name.startswith("scale"):
        c = tfx.stop_success_vector(N)
        for _ in range(k):
            A = tk.scale_plain(A, c)
        return A, c
    x = torch.ones(N)
    for _ in range(k):
        x = torch.mv(A, x) / x
    return A, x


def test_the_ladder_has_the_jax_suites_rungs_in_order():
    assert list(bench.kernel_steps(N, "cpu")) == LADDER
    assert bench.MATRIX_DIMS == jax_suite.MATRIX_DIMS


@pytest.mark.parametrize("name", LADDER)
def test_k_steps_leave_the_state_of_the_plain_chain(name):
    step, state, nbytes = bench.kernel_steps(N, "cpu")[name]
    assert nbytes == (2 if name.startswith("scale") else 1) * N * N * 4
    for i in range(K):
        state = step(i, state)
    want = _plain_chain(name, K)
    assert torch.equal(state[0], want[0]) and torch.equal(state[1], want[1])


def test_the_updating_rungs_own_their_state():
    steps = bench.kernel_steps(N, "cpu")
    shared = steps["rowsum_xla"][1][0]
    keep = shared.clone()
    for name in ("scale_xla", "scale_pallas", "scale_rowsum_pallas"):
        step, state, _ = steps[name]
        assert state[0] is not shared
        assert step(0, state)[0] is state[0]  # rewritten in place
    assert torch.equal(shared, keep)
    assert steps["matvec_pallas"][1][0] is shared


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


@pytest.mark.parametrize(
    "call",
    [
        lambda: timing.time_marginal(lambda i, s: s, 0, k=2),
        lambda: bench.bench_kernels([N]),
        lambda: cli.main(["--suite", "kernels", "--dims", str(N), "--json"]),
        lambda: cli.main([]),
        lambda: bench.bench_vector_kernels([N]),
        lambda: bench.bench_e2e([N]),
        lambda: cli.main(["--suite", "vector", "--sizes", str(N), "--json"]),
        lambda: cli.main(["--suite", "e2e", "--dims", str(N), "--backends", "matvec_pallas",
                          "--reps", "2"]),
        lambda: bench.bench_operator([N]),
        lambda: cli.main(["--suite", "operator", "--dims", str(N)]),
        lambda: bench.bench_batched(batch=2, dim=N),
        lambda: cli.main(["--suite", "batched", "--dims", str(N), "--batch", "2"]),
        lambda: bench.bench_sharded(dim=N),
        lambda: cli.main(["--suite", "sharded", "--dims", str(N)]),
        lambda: bench.bench_multihost(dim=N),
        lambda: cli.main(["--suite", "multihost", "--dims", str(N), "--json"]),
        lambda: timing.time_chains(lambda i, s: s, 0, k=2),
        lambda: tsuite.bench_large(reps=1),
        lambda: cli.main(["--suite", "large", "--json"]),
        lambda: tsuite.bench_drift(dim=N, windows=1, gap_s=0.0),
        lambda: cli.main(["--suite", "drift", "--dims", str(N), "--windows", "1"]),
        lambda: tsuite.bench_exchange_calibration(dim=N, reps=1),
        lambda: cli.main(["--suite", "calibrate", "--dims", str(N)]),
        lambda: headline.measure(headline.Settings(dim=N, windows=1, gap_s=0.0)),
    ],
    ids=["time_marginal", "bench_kernels", "cli", "cli-default-suite", "bench_vector_kernels",
         "bench_e2e", "cli-vector", "cli-e2e", "bench_operator", "cli-operator",
         "bench_batched", "cli-batched", "bench_sharded", "cli-sharded", "bench_multihost",
         "cli-multihost", "time_chains", "bench_large", "cli-large", "bench_drift", "cli-drift",
         "bench_exchange_calibration", "cli-calibrate", "headline"],
)
def test_no_cpu_time_is_reported_as_a_device_time(call):
    _no_card()
    with pytest.raises(RuntimeError, match="CUDA device"):
        call()


@pytest.mark.parametrize("suite", [s for s in cli.SUITES if s != "kernels"])
def test_cli_rejects_the_unported_suites_by_name(suite, capsys):
    # every suite of the JAX CLI is ported: none is rejected by name any more
    assert suite in cli.PORTED
    if suite in cli.CARD_FREE:
        # the model computes and the native runtime runs on the CPU: output, no card
        assert cli.main(["--suite", suite, "--dims", "128", "--json"]) == 0
        rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
        assert all(r["bench"].startswith(suite) for r in rows)
        assert rows or suite == "native"  # no rows only where no compiler builds the runtime
        return
    # a measuring suite gets past the name check and stops only for want of a card
    _no_card()
    with pytest.raises(RuntimeError, match="CUDA device"):
        cli.main(["--suite", suite, "--dims", str(N), "--sizes", str(N), "--windows", "1"])


def test_cli_runs_the_jax_clis_all_and_names_unknown_backends():
    assert cli.PORTED == tuple(cli.SUITES) and set(cli.CARD_FREE) == {"model", "native"}
    with pytest.raises(SystemExit, match="unknown e2e backends .*'nope'"):
        cli.main(["--suite", "e2e", "--backends", "nope"])


def test_cli_knows_exactly_the_jax_clis_suites():
    parser_choices = None
    import argparse

    real = argparse.ArgumentParser.add_argument

    def spy(self, *names, **kw):
        nonlocal parser_choices
        if "--suite" in names:
            parser_choices = kw["choices"]
        return real(self, *names, **kw)

    argparse.ArgumentParser.add_argument = spy
    try:
        from eigen_value_tpu.bench.__main__ import main as jax_main

        with pytest.raises(SystemExit):
            jax_main(["--help"])
    finally:
        argparse.ArgumentParser.add_argument = real
    assert sorted(parser_choices) == sorted(cli.SUITES)


def test_rows_print_in_the_jax_clis_format_and_as_valid_json():
    rows = [
        {"bench": "kernel", "kernel": "scale_pallas", "dim": 8192, "ms": 0.2, "gbps": 2684.4,
         "roofline_pct": 80.1},
        {"bench": "kernel", "kernel": "rowsum_pallas", "dim": 128, "ms": 0.0, "gbps": None,
         "roofline_pct": None},
    ]
    assert cli._fmt_kernels(rows) == jax_fmt_kernels(rows)
    for r in rows:
        assert json.loads(json.dumps(r, allow_nan=False)) == r


def test_roofline_pct_and_the_peak_table():
    assert timing.roofline_pct(1.0, 3_350_000_000, 3350.0) == pytest.approx(100.0)
    assert timing.roofline_pct(0.0, 1, 3350.0) != timing.roofline_pct(0.0, 1, 3350.0)  # NaN
    assert timing._PEAK_GBPS["H100"] == 3350.0


# --- the vector suite -------------------------------------------------------------

VECTOR = ["find_max", "eigen_vector", "stop", "stop_pallas"]


def test_the_vector_suite_has_the_jax_suites_rows_and_sizes():
    assert list(bench.vector_steps(N, "cpu")) == VECTOR
    assert bench.VECTOR_SIZES == jax_suite.VECTOR_SIZES == [1 << 16, 1 << 19, 1 << 22, 1 << 25]


@pytest.mark.parametrize("name", VECTOR)
def test_vector_steps_step_on_the_cpu(name):
    n = 1000
    step, state, nbytes = bench.vector_steps(n, "cpu")[name]
    assert nbytes == (3 if name == "eigen_vector" else 1) * n * 4
    v = state[0]
    # the same v on every call: an explicit generator with a fixed seed, + 0.5
    assert torch.equal(v, bench.vector_steps(n, "cpu")[name][1][0])
    assert 0.5 <= float(v.min()) and float(v.max()) < 1.5 and v.dtype == torch.float32
    ev = torch.ones(n)
    for i in range(K):
        state = step(i, state)
        ev = ev * (v / torch.max(v))
    assert state[0] is v  # v is read, never written
    want = {
        "find_max": torch.max(v),
        "eigen_vector": ev,
        "stop": torch.tensor(False),  # U[0.5, 1.5) neighbours differ by more than 1e-3
        "stop_pallas": torch.tensor(False),
    }[name]
    assert torch.equal(state[1], want)


def test_the_stop_rows_agree_on_a_vector_that_stops():
    steps = bench.vector_steps(N, "cpu")
    ok = tfx.stop_success_vector(N)
    for name in ("stop", "stop_pallas"):
        assert bool(steps[name][0](0, (ok, None))[1])


# --- the end-to-end sweep ---------------------------------------------------------

BF16_RUNGS = ["matvec_bf16", "multiround_sym_bf16"]


def test_e2e_backends_keep_the_jax_suites_names_and_order():
    assert list(bench.E2E_BACKENDS) == list(jax_suite.E2E_BACKENDS)
    assert all(callable(fn) for fn in bench.E2E_BACKENDS.values())
    assert sorted(tsuite.STORAGE_RUNGS) == BF16_RUNGS
    assert set(tsuite.TILED_RUNGS) == set(jax_suite.TILED_RUNGS)
    # the tile edge is the port's own, not the TPU's
    assert {t for t, _ in tsuite.TILED_RUNGS.values()} == {tk.SYM_TILE}
    assert {k: sym for k, (_, sym) in tsuite.TILED_RUNGS.items()} == {
        k: sym for k, (_, sym) in jax_suite.TILED_RUNGS.items()}


@pytest.mark.parametrize("name", BF16_RUNGS)
def test_the_bf16_rungs_give_skip_rows(name):
    """The reduced-precision rungs are ported: they give a solved row (no
    skip) at 8192², over A stored in bf16, with the JAX suite's ±1 rounds."""
    assert tsuite._e2e_skip(name, 8192, "cpu") is None
    assert tsuite.STORAGE_RUNGS[name] is torch.bfloat16
    H = tfx.hilbert_matrix(256)
    got = bench.E2E_BACKENDS[name](H.to(torch.bfloat16))
    # the rung is the f32 solve of the quantized matrix, as stored or not
    want = bench.E2E_BACKENDS[name.replace("_bf16", "")](H.to(torch.bfloat16).float())
    assert int(got.rounds) == int(want.rounds) == tfx.HILBERT_ROUNDS[256]
    assert torch.equal(got.eigenvector, want.eigenvector)


@pytest.mark.parametrize(
    "name, n, runs",
    [
        ("xla", 1000, True),
        ("multiround", 1000, True),
        ("multiround_sym", 1024, True),
        ("multiround_sym", 1000, False),  # no 128-aligned tile divides 1000
        ("multiround_sym_bf16", 1024, True),
        ("multiround_sym_bf16", 1000, False),
        ("matvec_bf16", 1000, True),
        ("multiround_sym_cached", 1000, False),
        ("multiround_sym_cached", 128, True),  # degenerates to streaming, as in JAX
        ("multiround_cached", 1024, False),  # no card here: the auto cache is 0
    ],
)
def test_sym_alignable_keeps_the_explicit_skip_rows(name, n, runs):
    assert tsuite._sym_alignable(name, n, "cpu") == runs
    assert tsuite._sym_alignable(name, n, "cpu") == (tsuite._e2e_skip(name, n, "cpu") is None)
    if name in jax_suite.TILED_RUNGS and name != "multiround_cached":
        # the divisor rule itself is the JAX suite's, at the port's tile edge
        assert runs == (jax_suite.kernels.sym_tile(n, tk.SYM_TILE) is not None)


@pytest.mark.parametrize(
    "name", [k for k in tsuite.E2E_BACKENDS if tsuite._e2e_skip(k, 128, "cpu") is None])
def test_every_e2e_rung_solves_on_the_cpu_and_chains(name):
    n = 128  # the dense cached rung is a skip row without a card: no auto cache
    H = tfx.hilbert_matrix(n)
    res = bench.E2E_BACKENDS[name](H)
    assert int(res.rounds) == tfx.HILBERT_ROUNDS[n] and bool(res.converged)
    A, lam = tsuite._e2e_chain_step(bench.E2E_BACKENDS[name])(0, (H, res.eigenvalue))
    assert A is H and torch.equal(lam, res.eigenvalue)


def test_marginal_resolved_escalates_and_gives_up(monkeypatch):
    asked = []

    def fake(step, init, k, reps):
        asked.append(k)
        return 0.05  # ms per step: 1 ms of signal needs k >= 20

    monkeypatch.setattr(tsuite, "time_marginal", fake)
    assert tsuite._marginal_resolved(None, None, k=4) == (0.05, 64, True)
    assert asked == [4, 16, 64]
    assert tsuite._marginal_resolved(None, None, k=4, max_k=16) == (None, 16, False)
    assert [tsuite._e2e_chain_len(n) for n in (128, 1024, 2048, 8192)] == [8, 8, 4, 4]


E2E_ROWS = [
    {"bench": "e2e", "backend": "matvec_pallas", "dim": 8192, "ms": 4.6, "device_ms": 4.25,
     "ms_per_round": 0.25, "elems_per_s": 2.7e11, "rounds": 17, "eigenvalue": 2.2,
     "rounds_ok": True, "chain_k": 4},
    {"bench": "e2e", "backend": "matvec_pallas", "dim": 128, "ms": 0.9, "device_ms": None,
     "ms_per_round": None, "elems_per_s": None, "rounds": 8, "eigenvalue": 1.9,
     "rounds_ok": False, "chain_k": 1024, "below_resolution": True},
    {"bench": "e2e", "backend": "matvec_bf16", "dim": 8192, "ms": 2.6, "device_ms": 2.3,
     "ms_per_round": 0.128, "elems_per_s": 5.3e11, "rounds": 18, "eigenvalue": 2.2,
     "rounds_ok": True, "chain_k": 4},
    {"bench": "e2e", "backend": "multiround_sym", "dim": 1000,
     "skipped": tsuite._SKIP_NOT_TILEABLE},
]
VECTOR_ROWS = [
    {"bench": "vector_kernel", "kernel": "stop_pallas", "size": 1 << 25, "ms": 0.05,
     "gbps": 2684.4, "roofline_pct": 80.1},
    {"bench": "vector_kernel", "kernel": "stop", "size": 1 << 16, "ms": 0.0, "gbps": None,
     "roofline_pct": None},
]


def test_e2e_and_vector_rows_print_in_the_jax_clis_format_and_as_valid_json():
    assert cli._fmt_e2e(E2E_ROWS) == jax_fmt_e2e(E2E_ROWS)
    table = cli._fmt_e2e(E2E_ROWS)
    assert "[PARITY BREAK]" in table and "below chain resolution" in table
    assert cli._fmt_kernels(VECTOR_ROWS, size_key="size") == jax_fmt_kernels(
        VECTOR_ROWS, size_key="size")
    for r in E2E_ROWS + VECTOR_ROWS:
        line = json.dumps(r, allow_nan=False)
        assert "NaN" not in line and json.loads(line) == r


def test_cli_prints_canned_rows_as_json_lines_without_nan(monkeypatch, capsys):
    monkeypatch.setattr(tsuite, "bench_e2e", lambda dims, backends, reps: E2E_ROWS)
    monkeypatch.setattr(tsuite, "bench_kernels", lambda dims: [])
    monkeypatch.setattr(tsuite, "bench_vector_kernels", lambda sizes: VECTOR_ROWS)
    assert cli.main(["--suite", "all", "--json"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [json.loads(line) for line in lines] == E2E_ROWS + VECTOR_ROWS
    assert not any("NaN" in line for line in lines)


# --- the operator suite -----------------------------------------------------------


def _jax_operator_names(n):
    """The JAX suite's rung names at dim n (eigen_value_tpu/bench/suite.py,
    bench_operator: p = 1 << ((n - 1).bit_length() // 2), kron only where
    p·q == n, DEG = 8)."""
    p = 1 << ((n - 1).bit_length() // 2)
    kron = [f"kron_{p}x{n // p}"] if p * (n // p) == n else []
    return ["hankel_fft", *kron, "sparse_ell_deg9"]


@pytest.mark.parametrize("n", [128, 1000, 8192])
def test_operator_rungs_keep_the_jax_suites_names(n):
    assert list(bench.operator_rungs(n, "cpu")) == _jax_operator_names(n)


@pytest.mark.parametrize("n", [128, 1024])
def test_every_operator_rung_solves_on_the_cpu_and_chains(n):
    for name, (solve, ok, extra) in bench.operator_rungs(n, "cpu").items():
        res = solve(None)
        assert res.eigenvector.device.type == "cpu" and bool(res.converged)
        assert ok(res), name
        if name == "hankel_fft":
            assert int(res.rounds) == tfx.HILBERT_ROUNDS[n]
        if name.startswith("kron"):
            assert extra["eps_mode"] in ("absolute", "relative")
        again = solve(torch.ones(n))
        assert torch.equal(again.eigenvector, res.eigenvector)
        acc = tsuite._operator_chain_step(solve, n, "cpu")(0, 0.0)
        assert acc.shape == () and float(acc) == pytest.approx(float(res.eigenvalue))


def test_the_operator_rungs_solve_the_jax_suites_inputs():
    """The Hilbert and ELL rungs take the JAX suite's inputs (the ELL triplets
    from numpy's generator seeded n): JAX's solves of them give the rounds
    within ±1 and λ within 1e-5."""
    import numpy as np
    from eigen_value_tpu.ops.solver_matvec import solve_operator as jax_solve_operator
    from eigen_value_tpu.ops.structured import ell_from_coo, ell_matvec, hilbert_matvec

    n = 1024
    rng = np.random.default_rng(n)
    src = np.repeat(np.arange(n), 8)
    dst = (src + 1 + rng.integers(0, n - 1, size=src.shape)) % n
    vals = (rng.random(src.shape[0]) + 0.1).astype(np.float32)
    jell = ell_matvec(*ell_from_coo(np.concatenate([src, np.arange(n)]),
                                    np.concatenate([dst, np.arange(n)]),
                                    np.concatenate([vals, np.ones(n, np.float32)]), n))
    jax_mvs = {"hankel_fft": hilbert_matvec(n), "sparse_ell_deg9": jell}
    rungs = bench.operator_rungs(n, "cpu")
    for name, mv in jax_mvs.items():
        got, want = rungs[name][0](None), jax_solve_operator(mv, n, 1e-3, 1000)
        assert abs(int(got.rounds) - int(want.rounds)) <= 1
        assert float(got.eigenvalue) == pytest.approx(float(want.eigenvalue), rel=1e-5)


#: The JAX suite's operator row keys, in its order (eigen_value_tpu/bench/
#: suite.py, bench_operator); the Kronecker rows add eps_mode.
JAX_OPERATOR_KEYS = ["bench", "backend", "dim", "device_ms", "ms_per_round", "rounds",
                     "eigenvalue", "rounds_ok", "chain_k"]


def test_bench_operator_rows_keep_the_jax_suites_keys_and_order(monkeypatch):
    """The rows bench_operator builds, with the card's parts stood in for:
    the rungs on the CPU, a fixed marginal time and a canned dense row."""
    dense = {"bench": "e2e", "backend": "matvec", "dim": 128, "ms": 1.0, "device_ms": 0.9,
             "ms_per_round": 0.1, "elems_per_s": 1e9, "rounds": 9, "eigenvalue": 2.2,
             "rounds_ok": True, "chain_k": 8}
    real_rungs = tsuite.operator_rungs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tsuite, "operator_rungs", lambda n, device: real_rungs(n, "cpu"))
    monkeypatch.setattr(tsuite, "_marginal_resolved", lambda step, init, k, reps: (0.5, k, True))
    monkeypatch.setattr(tsuite, "bench_e2e", lambda dims, backends, reps: [
        dict(dense, dim=d) for d in dims] if backends == ["matvec"] else None)
    rows = tsuite.bench_operator([128, 1000])
    assert [(r["backend"], r["dim"]) for r in rows] == [
        ("hankel_fft", 128), ("hankel_fft", 1000), ("kron_8x16", 128),
        ("sparse_ell_deg9", 128), ("sparse_ell_deg9", 1000), ("matvec", 128), ("matvec", 1000)]
    for r in rows[:-2]:
        keys = list(JAX_OPERATOR_KEYS)
        if r["backend"].startswith("kron"):
            keys.insert(keys.index("rounds_ok"), "eps_mode")
        assert list(r) == keys and r["bench"] == "operator" and r["rounds_ok"] is True
        assert r["ms_per_round"] == 0.5 / max(r["rounds"], 1)
    assert all(r["bench"] == "operator" for r in rows[-2:])


OPERATOR_ROWS = [
    {"bench": "operator", "backend": "hankel_fft", "dim": 8192, "device_ms": 2.1,
     "ms_per_round": 0.12, "rounds": 17, "eigenvalue": 2.6, "rounds_ok": True, "chain_k": 4},
    {"bench": "operator", "backend": "kron_64x128", "dim": 8192, "device_ms": None,
     "ms_per_round": None, "rounds": 2, "eigenvalue": 2492.7, "eps_mode": "relative",
     "rounds_ok": False, "chain_k": 1024, "below_resolution": True},
]


def test_operator_rows_print_in_the_jax_clis_format(monkeypatch, capsys):
    monkeypatch.setattr(jax_suite, "bench_operator", lambda dims, reps: OPERATOR_ROWS)
    assert jax_cli_main(["--suite", "operator", "--dims", "8192"]) in (0, None)
    want = capsys.readouterr().out.rstrip("\n")
    assert cli._fmt_operator(OPERATOR_ROWS) == want
    assert "[PARITY BREAK]" in want and "below chain resolution" in want
    monkeypatch.setattr(tsuite, "bench_operator", lambda dims, reps: OPERATOR_ROWS)
    assert cli.main(["--suite", "operator", "--json"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [json.loads(line) for line in lines] == OPERATOR_ROWS


# --- the batched suite ------------------------------------------------------------

#: The JAX suite's batched row keys, in its order (eigen_value_tpu/bench/
#: suite.py, bench_batched).
JAX_BATCHED_KEYS = ["bench", "batch", "dim", "device_ms_per_batch", "solves_per_s",
                    "rounds_hist", "all_converged", "max_rel_residual", "lambda_range",
                    "rounds_ok"]


def test_the_batched_workload_is_config_4s_and_seeded():
    As = tsuite.batched_workload(3, 16, "cpu")
    assert As.shape == (3, 16, 16) and As.dtype == torch.float32
    assert float(As.min()) >= 0.05 and float(As.max()) < 1.0
    assert torch.equal(As, tsuite.batched_workload(3, 16, "cpu"))
    assert torch.equal(As[:2], tsuite.batched_workload(2, 16, "cpu"))  # a matrix at a time


def test_bench_batched_rows_keep_the_jax_suites_keys(monkeypatch):
    """The row bench_batched builds, with the card's parts stood in for:
    the workload on the CPU and a marginal time that runs the chain's step
    once (so the step's ev0 path is exercised)."""
    real = tsuite.batched_workload
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tsuite, "batched_workload", lambda b, d, device: real(b, d, "cpu"))
    steps = []

    def marginal(step, init, k, reps):
        steps.append(step(0, init))
        return 0.5

    monkeypatch.setattr(tsuite, "time_marginal", marginal)
    (row,) = tsuite.bench_batched(batch=4, dim=48, reps=1, chain=2)
    assert list(row) == JAX_BATCHED_KEYS
    assert row["bench"] == "batched" and (row["batch"], row["dim"]) == (4, 48)
    assert row["device_ms_per_batch"] == 0.5 and row["solves_per_s"] == 4 / 0.5e-3
    assert sum(row["rounds_hist"].values()) == 4 and row["all_converged"]
    assert row["rounds_ok"] and row["max_rel_residual"] <= 2e-3
    assert row["lambda_range"][0] <= row["lambda_range"][1]
    assert len(steps) == 1 and torch.isfinite(steps[0])
    assert json.loads(json.dumps(row, allow_nan=False))["rounds_hist"]


BATCHED_ROWS = [
    {"bench": "batched", "batch": 256, "dim": 512, "device_ms_per_batch": 12.5,
     "solves_per_s": 20480.0, "rounds_hist": {5: 250, 6: 6}, "all_converged": True,
     "max_rel_residual": 4.2e-7, "lambda_range": [240.1, 246.9], "rounds_ok": True},
    {"bench": "batched", "batch": 8, "dim": 64, "device_ms_per_batch": 1.0,
     "solves_per_s": 8000.0, "rounds_hist": {1000: 8}, "all_converged": False,
     "max_rel_residual": 1.0, "lambda_range": [1.0, 2.0], "rounds_ok": False},
]


def test_batched_rows_print_in_the_jax_clis_format(monkeypatch, capsys):
    monkeypatch.setattr(jax_suite, "bench_batched", lambda reps, **kw: BATCHED_ROWS)
    assert jax_cli_main(["--suite", "batched"]) in (0, None)
    want = capsys.readouterr().out.rstrip("\n")
    assert cli._fmt_batched(BATCHED_ROWS) == want
    assert "[CHECK FAILED]" in want
    got = {}
    monkeypatch.setattr(tsuite, "bench_batched",
                        lambda reps, **kw: got.update(kw, reps=reps) or BATCHED_ROWS)
    assert cli.main(["--suite", "batched", "--dims", "64", "--batch", "8", "--json"]) == 0
    assert got == {"dim": 64, "batch": 8, "reps": 5}
    lines = capsys.readouterr().out.splitlines()
    assert [json.loads(line) for line in lines] == json.loads(json.dumps(BATCHED_ROWS))


def test_the_squarest_mesh_shape_is_jaxs():
    from eigen_value_tpu.utils.scaling_model import balanced_factorization

    for p in range(1, 65):
        assert tsuite.balanced_factorization(p) == balanced_factorization(p)


def test_the_sharded_tables_name_p_and_claim_no_scaling_from_one_card():
    rows = [{"bench": "sharded", "solver": "matvec_ring", "dim": 4096, "shards": 1, "mesh": "1",
             "ms": 2.5, "rounds": 15, "rounds_ok": True},
            {"bench": "multihost", "solver": "2d", "dim": 2048, "processes": 1,
             "mesh": {"rows": 1, "cols": 1}, "ms": 1.25, "rounds": 3, "scaling_efficiency": None}]
    rows.append({"bench": "sharded", "solver": "exchange", "dim": 4096, "shards": 1, "mesh": "1",
                 "exchange_us": {"sum (baseline)": 40.0, "all_gather": 300.5}})
    text = cli._fmt_sharded(rows).splitlines()
    assert "1 shards (1)" in text[0] and "15 round(s)" in text[0] and "efficiency" not in text[0]
    assert "1 processes" in text[1] and "efficiency" not in text[1]
    assert text[2] == ("[sharded] exchange 4096 / 1 floats on 1 shards: sum (baseline) 40.0 us, "
                       "all_gather 300.5 us")
