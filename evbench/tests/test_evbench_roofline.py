"""The least time a solve allows, from its shapes, and shares of it that
cannot pass 100%."""

import pytest

from evbench import roofline, trace
from evbench.compare import Answer
from evbench.run import Run

H100 = roofline.peaks("NVIDIA H100 80GB HBM3")


def test_peaks_by_card_name():
    assert H100 == {"bytes_per_s": 3.35e12, "flops_per_s": 67e12, "full_power_w": 700.0}
    assert roofline.peaks("NVIDIA A100-SXM4-80GB") is None


def test_triangle_and_dense_bytes():
    n = 8192
    tri, ops = roofline.solve_work(n, 4, True, 17)
    dense, ops_d = roofline.solve_work(n, 4, False, 17)
    assert tri == n * (n + 1) // 2 * 4 + 4 * n
    assert dense == n * n * 4 + 4 * n
    assert ops == ops_d == 2 * n * n * 18
    # 8192² f32: the triangle is bound by its bytes, 40.1 µs; dense 80.2 µs
    assert roofline.least_s((tri, ops), H100) == pytest.approx((33_558_528 * 4 + 32_768) / 3.35e12)
    assert roofline.least_s((dense, ops), H100) == pytest.approx(268_468_224 / 3.35e12)
    # 65536² bf16 at 21 rounds is bound by its operations
    work = roofline.solve_work(65536, 2, False, 21)
    assert roofline.least_s(work, H100) == pytest.approx(2 * 65536**2 * 22 / 67e12)


def test_matvec_launch():
    nbytes, ops = roofline.matvec_work(65536, 2)
    assert nbytes == 65536**2 * 2 + 8 * 65536 and ops == 2 * 65536**2
    assert roofline.least_s((nbytes, ops), H100) == pytest.approx(nbytes / 3.35e12)


class Ref:
    rounds = 17


def run_with(kernel_us, name, symmetric=True, n=8192):
    records = [(0.0, 0.001, [Answer(0, 2.0, 17, True)])]
    device = [(f"void (anonymous namespace)::{name}<float, false>(float const*, int)", 0.0,
               kernel_us)]
    slc = trace.Slice(0.0, kernel_us * 2, device, [(trace.SLICE, 0.0, kernel_us * 2)], records)
    return Run({"n": n, "dtype": "float32", "storage_dtype": None},
               {"solver": {"symmetric": symmetric}}, 1.0, records, 0.001, 1, [Ref()],
               "NVIDIA H100 80GB HBM3", slc)


@pytest.mark.parametrize("symmetric,kernel", [(True, "multiround_sym_kernel"),
                                              (False, "multiround_kernel")])
def test_share_is_100_at_the_least_time_and_under_it_above(symmetric, kernel):
    least = roofline.least_s(roofline.solve_work(8192, 4, symmetric, 17), H100)
    at = run_with(least * 1e6, kernel, symmetric)
    assert roofline.persistent_share(at, kernel) == pytest.approx(100.0)
    slower = run_with(least * 1e6 * 18, kernel, symmetric)
    assert roofline.persistent_share(slower, kernel) == pytest.approx(100.0 / 18)
    assert roofline.persistent_share(slower, "matvec_kernel") is None


def test_kernel_names_match_whole():
    run = run_with(100.0, "multiround_sym_kernel")
    assert roofline.kernel_time(run, "multiround_sym_kernel")[0] == 1
    assert roofline.kernel_time(run, "multiround_kernel")[0] == 0
    assert roofline.kernel_time(run, "round_kernel")[0] == 0
