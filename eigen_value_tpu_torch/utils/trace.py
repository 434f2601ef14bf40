"""Where a solve's time goes on the card: device busy time and idle share.

    python -m eigen_value_tpu_torch.utils.trace [--n 8192] [--solves 5]

For each arm of a Hilbert n² solve (the stripes multiround kernel, the
triangle kernel streaming and with the card's auto tile cache, the dense
tiled kernel with that cache, the matvec kernel loop, the plain
``torch.mv`` loop, the two fused-round loops over the ``round_matvec`` and
``round_fused`` kernels, the iterated solve over the ``rowsum`` and
``scale_rowsum`` kernels, and the reduced-precision storage solves of the
matrix kept in bf16: the stripes kernel, the triangle kernel with the
card's 2-byte auto cache, the matvec kernel loop), and for the three
matrix-free rungs of the operator suite at the same n (the FFT Hilbert
operator, the Kronecker operator, the sparse ELL operator:
``bench.operator_rungs``), it times ``--solves`` solves with CUDA events,
then traces as many more under ``torch.profiler`` and adds up the device
intervals (kernels, copies, fills) the trace holds.  Prints one JSON object
per arm:

* ``ms_per_solve``: median of the untraced solves (CUDA events);
* ``device_busy_ms``: traced device time per solve, the union of the
  device intervals so that nothing is counted twice;
* ``idle_share``: ``1 - device_busy_ms / ms_per_solve``, the share of an
  untraced solve in which the card runs none of its work;
* ``traced_ms_per_solve``: host wall time per traced solve (the
  profiler's own host cost included);
* ``top``: the device activities with the most time, each as
  ``[name, calls per solve, ms per solve]``.

Needs a CUDA device; exits non-zero without one or when the trace holds no
device activity.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from functools import partial
from typing import Iterable, Tuple

import torch


def union_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def trace_arm(fn, solves: int) -> dict:
    """Time ``solves`` calls of ``fn`` with CUDA events, then trace as many."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from .timing import time_call

    untraced = time_call(fn, reps=solves, warmup=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(solves):
            fn()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / solves
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not device:
        raise SystemExit("FAILED: the trace holds no device activity")
    busy_ms = union_us((e.time_range.start, e.time_range.end) for e in device) / 1e3 / solves
    per_name = defaultdict(lambda: [0, 0.0])
    for e in device:
        per_name[e.name][0] += 1
        per_name[e.name][1] += e.time_range.elapsed_us() / 1e3
    top = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {
        "ms_per_solve": untraced.median_ms,
        "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / untraced.median_ms,
        "traced_ms_per_solve": traced_ms,
        "top": [[name[:60], calls / solves, ms / solves] for name, (calls, ms) in top],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--n", type=int, default=8192)
    parser.add_argument("--solves", type=int, default=5)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("FAILED: no CUDA device")

    from .. import EPS, MAX_ITR, SolverConfig, fixtures
    from ..api import auto_cache_tiles, route
    from ..bench.suite import operator_rungs
    from ..ops.solver_kernel import solve_kernel
    from ..ops.solver_matvec import (
        solve_fused_round,
        solve_matvec,
        solve_matvec_kernel,
        solve_matvec_kernel_fused,
        solve_multiround,
    )

    H = fixtures.hilbert_matrix(args.n, device="cuda")
    tri = route(SolverConfig(symmetric=True), args.n, H.device)
    multi = partial(solve_multiround, H, EPS, MAX_ITR)
    arms = {"multiround kernel": multi}
    if tri.kernel == "triangle":
        cache, dense_cache = tri.cache_tiles, auto_cache_tiles(args.n, tri.bt, H.device, sym=False)
        arms.update({
            "triangle kernel, streaming": partial(multi, symmetric=True, cache_tiles=0),
            f"triangle kernel, cache {cache}": partial(multi, symmetric=True, cache_tiles=cache),
            f"dense tiled kernel, cache {dense_cache}": partial(multi, cache_tiles=dense_cache),
        })
    arms.update({
        "matvec kernel loop": lambda: solve_matvec_kernel(H, EPS, MAX_ITR),
        "torch.mv loop (plain)": lambda: solve_matvec(H, EPS, MAX_ITR),
        "round_matvec kernel loop": lambda: solve_matvec_kernel_fused(H, EPS, MAX_ITR),
        "round_fused kernel loop": lambda: solve_fused_round(H, EPS, MAX_ITR),
        "iterated kernel solve": lambda: solve_kernel(H, EPS, MAX_ITR),
    })
    Hq = H.to(torch.bfloat16)
    multi_q = partial(solve_multiround, Hq, EPS, MAX_ITR)
    arms["multiround kernel, bf16 A"] = multi_q
    if tri.kernel == "triangle":
        cache_q = route(SolverConfig(symmetric=True, storage_dtype=torch.bfloat16), args.n,
                        H.device).cache_tiles
        arms[f"triangle kernel, bf16 A, cache {cache_q}"] = partial(
            multi_q, symmetric=True, cache_tiles=cache_q)
    arms["matvec kernel loop, bf16 A"] = lambda: solve_matvec_kernel(Hq, EPS, MAX_ITR)
    ones = torch.ones(args.n, device=H.device)
    for name, (solve, _, _) in operator_rungs(args.n, H.device).items():
        arms[f"operator {name}"] = partial(solve, ones)
    for name, fn in arms.items():
        print(json.dumps({"arm": name, "n": args.n, **trace_arm(fn, args.solves)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
