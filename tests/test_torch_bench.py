"""The port's kernel ladder and marginal timing, as far as the CPU can say:
the step functions leave the state their plain chain leaves, and every
path that would report a device time refuses to run without a card.
"""

import json

import pytest

torch = pytest.importorskip("torch")

from eigen_value_tpu.bench import suite as jax_suite  # noqa: E402
from eigen_value_tpu.bench.__main__ import _fmt_kernels as jax_fmt_kernels  # noqa: E402
from eigen_value_tpu_torch import bench  # noqa: E402
from eigen_value_tpu_torch import fixtures as tfx  # noqa: E402
from eigen_value_tpu_torch.bench import __main__ as cli  # noqa: E402
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
    ],
    ids=["time_marginal", "bench_kernels", "cli", "cli-default-suite"],
)
def test_no_cpu_time_is_reported_as_a_device_time(call):
    _no_card()
    with pytest.raises(RuntimeError, match="CUDA device"):
        call()


@pytest.mark.parametrize("suite", [s for s in cli.SUITES if s != "kernels"])
def test_cli_rejects_the_unported_suites_by_name(suite):
    with pytest.raises(SystemExit, match=f"--suite {suite} .*Queue 1 item 13"):
        cli.main(["--suite", suite])


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
