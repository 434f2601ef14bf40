"""On the card (marker ``cuda``): the spans and the device trace share one
clock.  On the triangle route at the ``sym`` cell's n, a spans slice whose
times pass ``spans.clock_check`` comes within ``spans.ATTEMPTS`` slices, as
the readers need; in it every solve's ``launch.multiround_sym`` span holds
the CUDA runtime's launch call of the solve's kernel, and, as the profiler
placed it, nothing moved, that kernel starts after the span starts and ends
before the solve's ``solver.read`` span ends."""

import pytest
import torch

from evbench import spans
from evbench.catalog import Catalog
from evbench.pool import make_pool

CELL = "hilbert8192_f32.sym"
CALLS = 24
WARM = 2


@pytest.mark.cuda
def test_each_kernel_lies_between_its_launch_and_its_read(card):
    cat = Catalog()
    w = cat.workload(CELL)
    config, traffic = cat.config(w["config"]), cat.traffic(w["traffic"])
    pool = make_pool(config, 2, 2**31 + 77, card)
    call = cat.call_kind(traffic["call"]).start(config, traffic, pool)
    refused = []
    for attempt in range(spans.ATTEMPTS):
        s = spans.measure(call, attempt * (CALLS + WARM), CALLS, WARM,
                          lambda: torch.cuda.synchronize(card), card)
        if s.on_one_clock:
            break
        refused.append(s.clock)
    assert s.on_one_clock, refused
    assert s.clock.launches == s.clock.anchored == len(s.calls) == CALLS
    kernels = [(a, b) for name, a, b in s.device if "multiround_sym_kernel" in name]
    assert len(kernels) == CALLS
    for c in s.calls:
        launch, = [x for x in s.by_call[c.call] if x.name == "launch.multiround_sym"]
        read, = [x for x in s.by_call[c.call] if x.name == "solver.read"]
        inside = [k for k in kernels if launch.t0 < k[0] < k[1] < read.t1]
        assert len(inside) == 1, (launch, read, kernels)
    assert s.allocs is not None and s.allocs > 0
    assert 0 < s.call_idle_us() < sum(c.us for c in s.calls)
