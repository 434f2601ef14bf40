#!/usr/bin/env python3
"""Time the two persistent kernels and split one launch into its phases.

    python3 kernel_phases.py [--root DIR [DIR ...]] [--dtype f32|bf16|f16]
                             [--formulation vpu|dot|mixed] [--fill prologue|pipelined ...]
                             [--matrix hilbert|scaled] [--sizes 2048 4096 8192] [--reps 20]
                             [--sweep] [--rings]

For every size it solves the Hilbert matrix (``--matrix scaled``: scaled
at random from a fixed seed, as chip_smoke.py's step 10b), stored in
``--dtype`` (the
storage path's launches for bf16 / f16; ev and every sum stay f32), in one
whole-budget launch (``init=True``, ``chunk = MAX_ITR + 1``: the main path's
launch) of the stripes kernel (``kernels.multiround``) and of the tiled
kernel (``kernels.multiround_sym``: the triangle streaming, the triangle
with the card's auto tile cache, the dense tiled mode with its auto cache),
and prints one JSON line per arm and checkout: median and min ms over
``--reps`` launches by CUDA events, the launch plan, the card's name and
power limit, and, where the kernels write stamps, the phase split of one
more launch.  ``--formulation dot`` times the kernels' dot instances (the
tensor cores in 3xTF32; no ring, so the auto caches are the register
path's); ``--formulation mixed`` the tiled kernel's mixed instance (its
default share of the resident tiles in 3xTF32; the two cached arms only).
``--fill`` names the tiled kernel's cache fills to time, each against the
others in turns like the checkouts (``prologue``: the resident tiles
loaded before round 0; ``pipelined``: bulk copies waited for at first use,
the two cached arms only), and every row then also carries
``round_0_us``: the split of round 0, whose stream phase holds the
pipelined fill's waits, and ``span`` (µs from the first block's start of
round 0 to the last stamp of the launch): the launch's time less the span
is what lies outside its rounds, the prologue fill's loads among it (the
pipelined fill's issue is there too, its waits are not); and ``fill_us``
beside it: the fill's own time from the kernel's two fill stamps, the mean
over the blocks (``fill_us_max`` the slowest block's): for the prologue
fill from the launch's start to after its loads and block barrier (ev's
load, n floats, is in it), for the pipelined fill the time thread 0 takes
to issue the copies.  A checkout whose kernel writes no fill stamps gives
null.

Before the timings it prints, for every checkout, one JSON line per
instance of the two persistent kernels from that checkout's ptxas report
(``ops/cuda/build.report_path``): the element type, the instance (vpu,
vpu with the ring, dot, mixed; ``+pipelined`` for the pipelined fill), its
registers and the bytes of its spill stores and loads.

``--root`` names one or more checkouts that hold ``eigen_value_tpu_torch/``
(an earlier commit unpacked with ``git archive``; the default is this one).
Each is loaded as a package of its own in this one process, with its own
kernel library, and every arm is timed in turns across them (A B, B A,
A B, ...; a sample is the median of five launches back to back), so that
two versions are compared on one card at one time.  Each row also says whether
the launch gave the bits of the first checkout's, as a whole
(``bits_equal_root0``) and for each of its outputs (``bits_equal_root0_by``:
ev, v, the advanced count and λ).

The phase split: with ``kernels.STAMPS`` set to an int64 tensor on the
card, thread 0 of every block writes the card's nanosecond timer at each
phase boundary of each of the first 32 rounds (csrc/prologue.cuh
``stamp``).  A phase's time is the mean over the blocks and over rounds
1 … last (round 0 has no prologue and fills the resident set) of the
difference of two stamps; ``stream_slowest`` is, per round, the last
block's end of stream minus the first block's start: what the barrier
waits for.  ``stream_block_range`` is the least and the most of the
blocks' own stream phases (each a mean over the rounds), and
``slowest_blocks`` the indices of the eight slowest blocks.

``--sweep`` times the first checkout's launches under other plans than the
card's own (``eigen_value_tpu_torch.device``): the stripes kernel with and
without its resident rows and with 0, the planned and more L2-kept rows a
block; the tiled kernel with 0 to 600 L2-kept tiles and with whole tiles or
32-row groups as work items.  ``--rings`` times them at bulk-copy ring
depths 0, 1, 2 and 4 stages a warp (the stripes kernel) and 0, 1 and 2
(the triangle with its auto cache, which each depth resizes), every depth
held bit for bit to depth 0.  The plans are replaced from outside, for the
length of this process; the package has no such switch.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import types

STAMP_ROUNDS, STAMP_PHASES = 32, 6  # csrc/prologue.cuh
FILL_STAMPS = 2  # csrc/multiround_sym.cu fill_stamp: two words a block after the rounds' stamps
WARMUP = 10  # launches before the timed ones: a process's first arm meets an idle card
DEFAULT_PHASES = {
    "multiround": ("prologue", "stream", "barrier"),
    "multiround_sym": ("prologue", "stream", "barrier_1", "reduce", "barrier_2"),
}
DTYPES = {"f32": "float32", "bf16": "bfloat16", "f16": "float16"}
SCALE_SEED = 20261016 + 14  # chip_smoke.py step 10b's scaling


def matrix(n: int, kind: str, dev):
    """The Hilbert matrix of order n on ``dev`` (f32), or with ``kind ==
    "scaled"`` the Hilbert matrix times 1 + 0.25 U(0, 1), drawn on ``dev``
    from a fixed seed (chip_smoke.py step 10b's matrix): no tile piece is
    symmetric and A is not, so a row / column mix-up shows in the bits."""
    import torch

    from eigen_value_tpu_torch import fixtures

    H = fixtures.hilbert_matrix(n, device=dev)
    if kind == "scaled":
        gen = torch.Generator(device=dev).manual_seed(SCALE_SEED)
        H = H * (1 + 0.25 * torch.rand(n, n, device=dev, generator=gen))
    return H


def split(stamps, grid: int, names, rounds=range(1, STAMP_ROUNDS)) -> dict:
    """Mean µs per phase from one launch's stamps (rounds, phases, blocks),
    over ``rounds`` (by default 1 …: round 0 has no prologue and fills the
    resident set)."""
    t = stamps[: STAMP_ROUNDS * STAMP_PHASES * grid].reshape(STAMP_ROUNDS, STAMP_PHASES, grid)
    full = [r for r in rounds if bool((t[r, : len(names) + 1] > 0).all())]
    if not full:
        return {}
    sel = t[full].double()
    out = {name: float((sel[:, p + 1] - sel[:, p]).mean()) / 1e3 for p, name in enumerate(names)}
    out["stream_slowest"] = float(
        (sel[:, 2].max(dim=1).values - sel[:, 1].min(dim=1).values).mean()) / 1e3
    per_block = (sel[:, 2] - sel[:, 1]).mean(dim=0) / 1e3  # each block's stream phase
    out["stream_block_range"] = [float(per_block.min()), float(per_block.max())]
    out["slowest_blocks"] = per_block.argsort(descending=True)[:8].tolist()
    out["round"] = float((sel[:, len(names)] - sel[:, 0]).mean()) / 1e3
    out["rounds_read"] = len(full)
    if 0 in full:
        out["span"] = float(t.max() - t[0, 0].min()) / 1e3
    return out


def fill_split(stamps, grid: int) -> dict:
    """The fill's µs from one launch's two fill stamps a block: the mean
    over the blocks and the slowest block's; {} where none was written."""
    t = stamps[STAMP_ROUNDS * STAMP_PHASES * grid:
               (STAMP_ROUNDS * STAMP_PHASES + FILL_STAMPS) * grid].reshape(FILL_STAMPS, grid)
    if not bool((t > 0).all()):
        return {}
    d = (t[1] - t[0]).double() / 1e3
    return {"fill_us": float(d.mean()), "fill_us_max": float(d.max())}


def stamped_split(kernels, fn, kernel: str, grid: int, dev, rounds=range(1, STAMP_ROUNDS),
                  fill: bool = False) -> dict:
    """One more launch of ``fn`` with the stamps on, and its phase split
    over ``rounds``; with ``fill``, also the fill's (:func:`fill_split`)."""
    import torch

    kernels.STAMPS = torch.zeros((STAMP_ROUNDS * STAMP_PHASES + FILL_STAMPS) * grid,
                                 dtype=torch.int64, device=dev)
    try:
        fn()
        torch.cuda.synchronize()
        names = getattr(kernels, "PHASES", DEFAULT_PHASES)[kernel]
        stamps = kernels.STAMPS.cpu()
        out = split(stamps, grid, names, rounds)
        return {**out, **fill_split(stamps, grid)} if fill else out
    finally:
        kernels.STAMPS = None


def load_root(root: str, i: int) -> types.SimpleNamespace:
    """The port package of checkout ``root``, imported under a name of its
    own so that several checkouts live side by side in this process."""
    alias = f"_evt_root{i}"
    pkg = os.path.join(root, "eigen_value_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return types.SimpleNamespace(
        evt=mod, root=os.path.relpath(root),
        kernels=importlib.import_module(f"{alias}.ops.cuda.kernels"),
        device=importlib.import_module(f"{alias}.device"))


ELEMS = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16"}
OUTPUTS = ("ev", "v", "advanced", "lambda")


def ptxas_instances(report: str) -> list:
    """The kernel, element type, instance, registers and bytes of spill
    stores and loads of every ``multiround_kernel`` /
    ``multiround_sym_kernel`` instance in an ``nvcc -Xptxas -v`` report."""
    import re

    out, cur = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '\w*?(multiround(?:_sym)?_kernel)I"
                      r"(f|13__nv_bfloat16|6__half)((?:Lb[01]E)+)", line)
        if m:
            ring, dot, mixed, fill = ([f == "1" for f in re.findall(r"Lb([01])E", m.group(3))]
                                      + [False] * 3)[:4]
            inst = "dot" if dot else "mixed" if mixed else "vpu, ring" if ring else "vpu"
            cur = {"kernel": m.group(1), "elem": ELEMS[m.group(2)],
                   "instance": inst + (" +pipelined" if fill else ""),
                   "registers": None, "spill_stores": 0, "spill_loads": 0}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            cur = None
    return out


def print_ptxas(R) -> None:
    """One JSON line per persistent-kernel instance of checkout R's build."""
    build = importlib.import_module(f"{R.evt.__name__}.ops.cuda.build")
    build.load()
    for row in ptxas_instances(build.report_path().read_text()):
        print(json.dumps(dict(ptxas=row.pop("kernel"), root=R.root, **row)), flush=True)


def plan_fields(plan) -> dict:
    return {k: v for k, v in plan._asdict().items() if k != "table"}


def arms(R, H, dev, formulation: str = "vpu", fill: str = "prologue", fills=None) -> list:
    """(label, kernel, cache, plan, launch) of the four arms at H's size,
    under checkout R's plans for H's dtype, the formulation and the fill.
    Where the formulation or one of the ``fills`` timed beside it needs
    resident tiles ("mixed", "pipelined"), the two cached arms alone; with
    the pipelined fill among them, each at the largest cache up to the auto
    one that its depth rule accepts (``kernels.pipelined_depth``)."""
    import torch

    k, d = R.kernels, R.device
    n, bt, dt = H.shape[0], k.SYM_TILE, H.dtype
    x = torch.ones(n, device=dev)
    z = torch.zeros((), device=dev)
    kw = dict(chunk=R.evt.MAX_ITR + 1, eps=R.evt.EPS, init=True)
    sized = {} if dt == torch.float32 else {"dtype": dt}
    isz = {} if dt == torch.float32 else {"itemsize": dt.itemsize}
    if formulation != "vpu":
        kw["formulation"] = formulation
        sized[formulation] = True
    if formulation == "dot":
        isz["ring"] = False
    pipelined = "pipelined" in (fills or (fill,))
    cached_only = formulation == "mixed" or pipelined
    if fill == "pipelined":
        kw["fill_mode"] = fill
        sized["pipelined"] = isz["pipelined"] = True
    out = [] if cached_only else [
        ("multiround", "multiround", None, k.multiround_launch_plan(dev, n, **sized),
         lambda: k.multiround(H, x, x, z, R.evt.MAX_ITR, **kw))]
    for label, sym, auto in (("multiround_sym, streaming", True, False),
                             ("multiround_sym, auto cache", True, True),
                             ("multiround_sym dense tiled, auto cache", False, True)):
        if cached_only and not auto:
            continue
        c = d.sym_auto_cache_tiles(n, bt, dev, sym=sym, **isz) if auto else 0
        while pipelined and c and k.pipelined_depth(
                n, bt, c, sym, k.mxu_share(n, bt, c, sym) if formulation == "mixed" else 0
        ) > k.PIPELINED_DEPTH:
            c -= 1
        out.append((label, "multiround_sym", c, k.multiround_sym_plan(dev, n, bt, c, sym, **sized),
                    lambda c=c, sym=sym: k.multiround_sym(H, x, x, z, R.evt.MAX_ITR, tile=bt,
                                                          cache_tiles=c, sym=sym, **kw)))
    return out


def in_turns(fns, reps: int) -> list:
    """Per function, ``reps`` samples taken in turns (A B, B A, ...); a
    sample is the median of five launches back to back, each between its
    own CUDA events (so the host's wrapper time is hidden behind the card's
    work, as in a solve)."""
    from eigen_value_tpu_torch.utils.timing import time_call

    for fn in fns:
        for _ in range(WARMUP):
            fn()
    samples = [[] for _ in fns]
    for rep in range(reps):
        order = range(len(fns)) if rep % 2 == 0 else reversed(range(len(fns)))
        for j in order:
            samples[j].append(time_call(fns[j], reps=5, warmup=1).median_ms)
    return samples


def sweep(R, H, dev, reps: int, card: str) -> None:
    """One JSON line per plan variant of both kernels at H's size."""
    import torch

    kernels, device, evt = R.kernels, R.device, R.evt
    n, dt = H.shape[0], H.dtype
    sized = {} if dt == torch.float32 else {"dtype": dt}
    x = torch.ones(n, device=dev)
    z = torch.zeros((), device=dev)
    kw = dict(chunk=evt.MAX_ITR + 1, eps=evt.EPS, init=True)
    bt = kernels.SYM_TILE
    from eigen_value_tpu_torch.utils.timing import time_call

    def row(arm, kernel, grid, fn, **plan):
        fn()
        t = time_call(fn, reps=reps, warmup=WARMUP)
        print(json.dumps({"sweep": arm, "n": n, "dtype": str(dt), **plan, "ms_median": t.median_ms,
                          "ms_min": t.min_ms, "card": card,
                          "phases_us": stamped_split(kernels, fn, kernel, grid, dev)},
                         allow_nan=False), flush=True)

    planned = kernels.multiround_launch_plan
    own = planned(dev, n, **sized)  # also raises the kernel's shared-memory limit
    try:
        for resident, l2_rows in sorted({(0, 0), (own.resident, 0), (own.resident, own.l2_rows),
                                         (own.resident, own.l2_rows + 2),
                                         (own.resident, own.l2_rows + 4),
                                         (own.resident, own.l2_rows + 8)}):
            if resident + l2_rows > -(-n // own.grid):
                continue
            plan = own._replace(resident=resident, l2_rows=l2_rows)
            kernels.multiround_launch_plan = lambda d, m, plan=plan, **_: plan
            row("multiround", "multiround", own.grid,
                lambda: kernels.multiround(H, x, x, z, evt.MAX_ITR, **kw),
                resident=resident, l2_rows=l2_rows, own=plan == own)
    finally:
        kernels.multiround_launch_plan = planned

    l2_rule, split_rule = kernels.sym_l2_tiles, kernels.sym_split
    isz = {} if dt == torch.float32 else {"itemsize": dt.itemsize}
    auto = device.sym_auto_cache_tiles(n, bt, dev, **isz)
    own_split = device.sym_split(n, bt, dev)
    try:
        for cache in sorted({0, auto}):
            T = len(kernels.sym_cache_split(n, bt, cache)[0])
            own_l2 = device.sym_l2_tiles(bt, dev, T, **isz)
            variants = {(own_split, l2) for l2 in (0, 300, 400, 500, 600, own_l2) if l2 <= T}
            variants.add((1 if own_split != 1 else bt // 32, own_l2))
            for split_, l2 in sorted(variants):
                kernels.sym_l2_tiles = lambda bt_, d, streamed, l2=l2, **_: min(streamed, l2)
                kernels.sym_split = lambda n_, bt_, d, sym, split_=split_: split_
                kernels.multiround_sym_plan.cache_clear()
                plan = kernels.multiround_sym_plan(dev, n, bt, cache, True, **sized)
                row("multiround_sym", "multiround_sym", plan.grid,
                    lambda: kernels.multiround_sym(H, x, x, z, evt.MAX_ITR, tile=bt,
                                                   cache_tiles=cache, **kw),
                    cache=cache, l2_tiles=l2, split=split_,
                    own=(split_, l2) == (own_split, own_l2))
    finally:
        kernels.sym_l2_tiles, kernels.sym_split = l2_rule, split_rule
        kernels.multiround_sym_plan.cache_clear()


def rings(R, H, dev, reps: int, card: str) -> None:
    """One JSON line per ring depth of each kernel at H's size: the plan,
    ms, phases, and whether the launch gave depth 0's bits."""
    import torch

    kernels, device, evt = R.kernels, R.device, R.evt
    n, dt = H.shape[0], H.dtype
    isz = dt.itemsize
    sized = {} if dt == torch.float32 else {"dtype": dt}
    x = torch.ones(n, device=dev)
    z = torch.zeros((), device=dev)
    kw = dict(chunk=evt.MAX_ITR + 1, eps=evt.EPS, init=True)
    bt = kernels.SYM_TILE
    saved = dict(device.STRIPES_RING), dict(device.SYM_RING)
    try:
        for name, table, depths in (("multiround", device.STRIPES_RING, (0, 1, 2, 4)),
                                    ("multiround_sym", device.SYM_RING, (0, 1, 2))):
            first = None
            for depth in depths:
                table[isz] = depth  # the wrappers look the plan up anew
                kernels.multiround_launch_plan.cache_clear()
                kernels.multiround_sym_plan.cache_clear()
                if name == "multiround":
                    plan = kernels.multiround_launch_plan(dev, n, **sized)
                    fn = lambda: kernels.multiround(H, x, x, z, evt.MAX_ITR, **kw)  # noqa: E731
                else:
                    c = device.sym_auto_cache_tiles(n, bt, dev, itemsize=isz)
                    plan = kernels.multiround_sym_plan(dev, n, bt, c, True, **sized)
                    fn = lambda c=c: kernels.multiround_sym(  # noqa: E731
                        H, x, x, z, evt.MAX_ITR, tile=bt, cache_tiles=c, **kw)
                out = fn()
                first = first or out
                ms = in_turns([fn], reps)[0]
                print(json.dumps({"rings": name, "n": n, "dtype": str(dt), "ring": depth,
                                  "plan": plan_fields(plan), "ms_median": statistics.median(ms),
                                  "ms_min": min(ms),
                                  "bits_equal_depth_0": all(torch.equal(a, b)
                                                            for a, b in zip(first, out)),
                                  "card": card,
                                  "phases_us": stamped_split(kernels, fn, name, plan.grid, dev)},
                                 allow_nan=False), flush=True)
    finally:
        device.STRIPES_RING.update(saved[0])
        device.SYM_RING.update(saved[1])
        kernels.multiround_launch_plan.cache_clear()
        kernels.multiround_sym_plan.cache_clear()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", nargs="+", default=[os.path.dirname(os.path.abspath(__file__))])
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="f32")
    ap.add_argument("--matrix", choices=["hilbert", "scaled"], default="hilbert",
                    help="the Hilbert matrix, or the Hilbert matrix scaled at random (the "
                         "triangle arms then read its upper block triangle)")
    ap.add_argument("--formulation", choices=["vpu", "dot", "mixed"], default="vpu")
    ap.add_argument("--fill", choices=["prologue", "pipelined"], nargs="+", default=None,
                    help="the tiled kernel's cache fills, timed in turns; also prints round "
                         "0's split")
    ap.add_argument("--sizes", type=int, nargs="+", default=[2048, 4096, 8192])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sweep", action="store_true", help="also time other plans than the card's")
    ap.add_argument("--rings", action="store_true", help="also time other ring depths")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("FAILED: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    roots = [load_root(os.path.abspath(r), i) for i, r in enumerate(args.root)]
    dev = torch.device("cuda", 0)
    dt = getattr(torch, DTYPES[args.dtype])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    for R in roots:
        print_ptxas(R)
    for n in args.sizes:
        H = matrix(n, args.matrix, dev).to(dt)
        fills = args.fill or ["prologue"]
        variants = [(R, fill) for R in roots for fill in fills]
        per_root = [arms(R, H, dev, args.formulation, fill, fills) for R, fill in variants]
        for a in range(len(per_root[0])):
            label, kernel = per_root[0][a][:2]
            fns = [p[a][4] for p in per_root]
            outs = [fn() for fn in fns]
            samples = in_turns(fns, args.reps)
            for (R, fill), arm, out, ms in zip(variants, (p[a] for p in per_root), outs, samples):
                _, _, cache, plan, fn = arm
                row = {"arm": label, "n": n, "dtype": args.dtype, "matrix": args.matrix,
                       "formulation": args.formulation, "fill": fill, "root": R.root,
                       "advanced": int(out[2]), "ms_median": statistics.median(ms),
                       "ms_min": min(ms), "cache": cache, "plan": plan_fields(plan),
                       "bits_equal_root0": all(torch.equal(p, q) for p, q in zip(outs[0], out)),
                       "bits_equal_root0_by": {k: torch.equal(p, q) for k, p, q in
                                               zip(OUTPUTS, outs[0], out)},
                       "card": card}
                if hasattr(R.kernels, "STAMPS"):
                    row["phases_us"] = stamped_split(R.kernels, fn, kernel, plan.grid, dev)
                    if args.fill:
                        r0 = stamped_split(R.kernels, fn, kernel, plan.grid, dev, rounds=[0],
                                           fill=True)
                        row["fill_us"] = r0.pop("fill_us", None)
                        row["fill_us_max"] = r0.pop("fill_us_max", None)
                        row["round_0_us"] = r0
                print(json.dumps(row, allow_nan=False), flush=True)
        if args.sweep:
            sweep(roots[0], H, dev, args.reps, card)
        if args.rings:
            rings(roots[0], H, dev, args.reps, card)
        del H, per_root
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
