#!/usr/bin/env python3
"""Time the two persistent kernels and split one launch into its phases.

    python3 kernel_phases.py [--root DIR] [--sizes 2048 4096 8192] [--reps 20] [--sweep]

For every size it solves the Hilbert matrix in one whole-budget launch
(``init=True``, ``chunk = MAX_ITR + 1``: the main path's launch) of the
stripes kernel (``kernels.multiround``) and of the tiled kernel
(``kernels.multiround_sym``: the triangle streaming, the triangle with the
card's auto tile cache, the dense tiled mode with its auto cache), and
prints one JSON line per arm: median and min ms over ``--reps`` launches by
CUDA events, the card's name and power limit, and, where the kernels write
stamps, the phase split of one more launch.

The phase split: with ``kernels.STAMPS`` set to an int64 tensor on the
card, thread 0 of every block writes the card's nanosecond timer at each
phase boundary of each of the first 32 rounds (csrc/prologue.cuh
``stamp``).  A phase's time is the mean over the blocks and over rounds
1 … last (round 0 has no prologue and fills the resident set) of the
difference of two stamps; ``stream_slowest`` is, per round, the last
block's end of stream minus the first block's start: what the barrier
waits for.

``--sweep`` times the same launches under other plans than the card's own
(``eigen_value_tpu_torch.device``): the stripes kernel with and without its
resident rows and with 0, the planned and more L2-kept rows a block; the
tiled kernel with 0 to 600 L2-kept tiles and with whole tiles or 32-row
groups as work items.  The plans are replaced from outside, for the length
of this process; the package has no such switch.

``--root`` names another checkout that holds ``eigen_value_tpu_torch/``
(an earlier commit unpacked with ``git archive``), so that two versions
can be timed in turns inside one call on one card.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

STAMP_ROUNDS, STAMP_PHASES = 32, 6  # csrc/prologue.cuh
WARMUP = 10  # launches before the timed ones: a process's first arm meets an idle card
DEFAULT_PHASES = {
    "multiround": ("prologue", "stream", "barrier"),
    "multiround_sym": ("prologue", "stream", "barrier_1", "reduce", "barrier_2"),
}


def split(stamps, grid: int, names) -> dict:
    """Mean µs per phase from one launch's stamps (rounds, phases, blocks)."""
    t = stamps[: STAMP_ROUNDS * STAMP_PHASES * grid].reshape(STAMP_ROUNDS, STAMP_PHASES, grid)
    full = [r for r in range(1, STAMP_ROUNDS) if bool((t[r, : len(names) + 1] > 0).all())]
    if not full:
        return {}
    sel = t[full].double()
    out = {name: float((sel[:, p + 1] - sel[:, p]).mean()) / 1e3 for p, name in enumerate(names)}
    out["stream_slowest"] = float(
        (sel[:, 2].max(dim=1).values - sel[:, 1].min(dim=1).values).mean()) / 1e3
    out["round"] = float((sel[:, len(names)] - sel[:, 0]).mean()) / 1e3
    out["rounds_read"] = len(full)
    return out


def stamped_split(kernels, fn, kernel: str, grid: int, dev) -> dict:
    """One more launch of ``fn`` with the stamps on, and its phase split."""
    import torch

    kernels.STAMPS = torch.zeros(STAMP_ROUNDS * STAMP_PHASES * grid, dtype=torch.int64,
                                 device=dev)
    try:
        fn()
        torch.cuda.synchronize()
        names = getattr(kernels, "PHASES", DEFAULT_PHASES)[kernel]
        return split(kernels.STAMPS.cpu(), grid, names)
    finally:
        kernels.STAMPS = None


def sweep(kernels, device, evt, H, n: int, dev, reps: int, card: str) -> None:
    """One JSON line per plan variant of both kernels at dimension n."""
    from eigen_value_tpu_torch.utils.timing import time_call

    import torch

    x = torch.ones(n, device=dev)
    z = torch.zeros((), device=dev)
    kw = dict(chunk=evt.MAX_ITR + 1, eps=evt.EPS, init=True)
    bt = kernels.SYM_TILE

    def row(arm, kernel, grid, fn, **plan):
        fn()
        t = time_call(fn, reps=reps, warmup=WARMUP)
        print(json.dumps({"sweep": arm, "n": n, **plan, "ms_median": t.median_ms,
                          "ms_min": t.min_ms, "card": card,
                          "phases_us": stamped_split(kernels, fn, kernel, grid, dev)},
                         allow_nan=False), flush=True)

    planned = kernels.multiround_launch_plan
    own = planned(dev, n)  # also raises the kernel's shared-memory limit
    try:
        for resident, l2_rows in sorted({(0, 0), (own.resident, 0), (own.resident, own.l2_rows),
                                         (own.resident, own.l2_rows + 2),
                                         (own.resident, own.l2_rows + 4),
                                         (own.resident, own.l2_rows + 8)}):
            if resident + l2_rows > -(-n // own.grid):
                continue
            plan = device.StripesPlan(own.grid, resident, l2_rows)
            kernels.multiround_launch_plan = lambda d, m, plan=plan: plan
            row("multiround", "multiround", own.grid,
                lambda: kernels.multiround(H, x, x, z, evt.MAX_ITR, **kw),
                resident=resident, l2_rows=l2_rows, own=plan == own)
    finally:
        kernels.multiround_launch_plan = planned

    l2_rule, split_rule = kernels.sym_l2_tiles, kernels.sym_split
    auto = device.sym_auto_cache_tiles(n, bt, dev)
    own_split = device.sym_split(n, bt, dev)
    try:
        for cache in sorted({0, auto}):
            T = len(kernels.sym_cache_split(n, bt, cache)[0])
            own_l2 = device.sym_l2_tiles(bt, dev, T)
            variants = {(own_split, l2) for l2 in (0, 300, 400, 500, 600, own_l2) if l2 <= T}
            variants.add((1 if own_split != 1 else bt // 32, own_l2))
            for split, l2 in sorted(variants):
                kernels.sym_l2_tiles = lambda bt_, d, streamed, l2=l2: min(streamed, l2)
                kernels.sym_split = lambda n_, bt_, d, sym, split=split: split
                kernels.multiround_sym_plan.cache_clear()
                plan = kernels.multiround_sym_plan(dev, n, bt, cache, True)
                row("multiround_sym", "multiround_sym", plan.grid,
                    lambda: kernels.multiround_sym(H, x, x, z, evt.MAX_ITR, tile=bt,
                                                   cache_tiles=cache, **kw),
                    cache=cache, l2_tiles=l2, split=split,
                    own=(split, l2) == (own_split, own_l2))
    finally:
        kernels.sym_l2_tiles, kernels.sym_split = l2_rule, split_rule
        kernels.multiround_sym_plan.cache_clear()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--sizes", type=int, nargs="+", default=[2048, 4096, 8192])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sweep", action="store_true", help="also time other plans than the card's")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("FAILED: no CUDA device")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import eigen_value_tpu_torch as evt
    from eigen_value_tpu_torch import device, fixtures
    from eigen_value_tpu_torch.device import sym_auto_cache_tiles
    from eigen_value_tpu_torch.ops.cuda import kernels
    from eigen_value_tpu_torch.utils.timing import time_call

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    stamped = hasattr(kernels, "STAMPS")
    bt = kernels.SYM_TILE
    for n in args.sizes:
        H = fixtures.hilbert_matrix(n, device=dev)
        x = torch.ones(n, device=dev)
        z = torch.zeros((), device=dev)
        kw = dict(chunk=evt.MAX_ITR + 1, eps=evt.EPS, init=True)
        cache = sym_auto_cache_tiles(n, bt, dev)
        dense_cache = sym_auto_cache_tiles(n, bt, dev, sym=False)
        arms = [
            ("multiround", "multiround", None, True,
             lambda: kernels.multiround(H, x, x, z, evt.MAX_ITR, **kw)),
            ("multiround_sym, streaming", "multiround_sym", 0, True, None),
            (f"multiround_sym, cache {cache}", "multiround_sym", cache, True, None),
            (f"multiround_sym dense tiled, cache {dense_cache}", "multiround_sym", dense_cache,
             False, None),
        ]
        for label, kernel, c, sym, fn in arms:
            if fn is None:
                def fn(c=c, sym=sym):
                    return kernels.multiround_sym(H, x, x, z, evt.MAX_ITR, tile=bt,
                                                  cache_tiles=c, sym=sym, **kw)
            out = fn()
            t = time_call(fn, reps=args.reps, warmup=WARMUP)
            row = {"arm": label, "n": n, "advanced": int(out[2]), "ms_median": t.median_ms,
                   "ms_min": t.min_ms, "card": card, "root": os.path.relpath(root)}
            if stamped:
                if kernel == "multiround":
                    grid = kernels.multiround_grid(dev, n)
                else:
                    plan = kernels.multiround_sym_plan(dev, n, bt, c, sym)
                    grid = getattr(plan, "grid", None) or plan[3]
                row["grid"] = grid
                row["phases_us"] = stamped_split(kernels, fn, kernel, grid, dev)
            print(json.dumps(row, allow_nan=False), flush=True)
        if args.sweep:
            sweep(kernels, device, evt, H, n, dev, args.reps, card)
        del H
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
