"""The device-time accounting of eigen_value_tpu_torch.utils.trace."""

import pytest

torch = pytest.importorskip("torch")

from eigen_value_tpu_torch.utils import trace  # noqa: E402


@pytest.mark.parametrize(
    "intervals, want",
    [
        ([], 0.0),
        ([(0.0, 2.0)], 2.0),
        ([(5.0, 6.0), (0.0, 2.0)], 3.0),  # disjoint, out of order
        ([(0.0, 4.0), (1.0, 2.0), (3.0, 7.0)], 7.0),  # nested and overlapping
        ([(0.0, 1.0), (1.0, 3.0)], 3.0),  # touching
    ],
)
def test_union_us(intervals, want):
    assert trace.union_us(intervals) == want


def test_main_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the exit without a CUDA device")
    with pytest.raises(SystemExit, match="no CUDA device"):
        trace.main(["--n", "16"])
