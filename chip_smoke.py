#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one CUDA card.

    python3 chip_smoke.py

Builds the Hopper kernels from eigen_value_tpu_torch/csrc and holds each
kernel against its plain PyTorch version on the card.  Then the main path:
the public API with backend "auto" solves the Hilbert matrices 128²…8192²
(auto runs the multiround kernel, one launch per solve) and one of 65536²
(16 GiB; its ev no longer fits the multiround kernel's shared memory, so
auto runs the matvec kernel loop), and EigenValue solves 8192²; the kernel
launch counters are read around exactly these calls.  It checks rounds,
λ and the eigen-residual, checks that the "matvec_pallas" backend and
every chunking of the multiround solve are bit-identical to the matvec
kernel loop at 8192², and times the arms at 8192².

The symmetric path has its own steps: the triangle kernel
(csrc/multiround_sym.cu) against its plain version at n = 128, 384, 4096
and 8192 in both modes, with and without the card's auto tile cache; its
invariances at 8192² (tile cache, chunking, the lower block triangle,
a repeated launch, all bit-identical); and, with the launch counters read
around exactly these calls, ``max_eigenvalue(H, SolverConfig(symmetric=True))``
and the ``validate=True`` promotion over the Hilbert table, plus one dense
tiled-cached solve at 8192².

The iterated (mutate-A) path: the ``rowsum``, ``rowsum_bias``, ``scale``
and ``scale_rowsum`` kernels (csrc/rowsum.cu, csrc/scale.cu) against their
plain versions and their bit identities (``rowsum == matvec(·, ones)``,
``scale == scale_plain`` in and out of place, ``scale_rowsum == (scale,
rowsum)``); then, with the launch counters read around exactly these
calls, ``max_eigenvalue(·, SolverConfig(backend="pallas"))`` over the
Hilbert table, the 3×3 anchor (a host array, so it goes to the card) and a
random positive 1000², held to ``backend="xla"`` (the plain versions on the
card) with the caller's matrix bitwise unchanged; and the kernel ladder
``bench_kernels(dims=[8192])``, whose rungs launch ``rowsum_bias``,
``scale``, ``scale_rowsum`` and ``matvec``.

Uses torch only (no jax).  Exits non-zero, without the final result line,
on any failed check or when there is no CUDA device.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

SEED = 20261016
PLAIN_TOL = 2e-5  # matvec against an f64 product: row error ~ sqrt(terms) ulps
PARITY_REL = 1e-5  # λ against the plain loop (float32 up to 8192², float64 at BIG_N)
H100_SXM_GBPS = 3350.0  # NVIDIA's data sheet, at the full 700 W
H100_SXM_F32_TFLOPS = 67.0  # the same sheet: float32 outside the tensor cores
BIG_N = 65536  # beyond the multiround kernel's shared-memory limit (57856 on an H100)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {what}")


def say(*parts) -> None:
    print(*parts, flush=True)


def f64_matvec(A, x, cols: int = 8192):
    """``A @ x`` in float64, a block of columns at a time (a 65536² matrix
    would take 32 GiB in float64 at once)."""
    y = 0.0
    for j in range(0, A.shape[1], cols):
        y = y + A[:, j:j + cols].double() @ x[j:j + cols].double()
    return y


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("FAILED: no CUDA device")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "eigen_value_tpu_torch", "csrc")):
        raise SystemExit("FAILED: eigen_value_tpu_torch/ not found beside chip_smoke.py")
    sys.path.insert(0, here)

    import eigen_value_tpu_torch as evt
    from eigen_value_tpu_torch import fixtures
    from eigen_value_tpu_torch.api import resolve_backend
    from eigen_value_tpu_torch.bench import bench_kernels
    from eigen_value_tpu_torch.device import sym_auto_cache_tiles
    from eigen_value_tpu_torch.ops.cuda import build, kernels
    from eigen_value_tpu_torch.ops.solver import solve_xla
    from eigen_value_tpu_torch.ops.solver_kernel import solve_kernel
    from eigen_value_tpu_torch.ops.solver_matvec import (
        solve_matvec,
        solve_matvec_kernel,
        solve_multiround,
    )
    from eigen_value_tpu_torch.utils.timing import roofline_pct, time_call

    dev = torch.device("cuda", 0)
    wrappers = {name: getattr(kernels, name) for name in (
        "matvec", "multiround", "multiround_sym", "rowsum", "rowsum_bias", "scale",
        "scale_rowsum")}

    def reset_counts() -> None:
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0

    def read_counts() -> dict:
        torch.cuda.synchronize()
        return {name: w.launches for name, w in wrappers.items()}

    def rel_err(got, want) -> float:
        return float(((got.double() - want).abs() / want.abs()).max())

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    card = smi.splitlines()[0]
    say(f"nvidia-smi: {card}")
    say(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul must be off")

    t0 = time.perf_counter()
    lib = build.build()
    build.load()
    say(f"build: {time.perf_counter() - t0:.1f} s -> {os.path.relpath(lib, here)}")
    report = build.report_path()
    if report.exists():
        for line in report.read_text().splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                say("  ptxas:", line.strip())
    say(f"multiround grid at 8192: {kernels.multiround_grid(dev, 8192)} blocks "
        f"of 1024 threads on {torch.cuda.get_device_properties(dev).multi_processor_count} SMs")

    gen = torch.Generator().manual_seed(SEED)

    # --- 1. matvec kernel against its plain version and an f64 product ---
    # random positive matrices, then the main path's largest shape: the
    # Hilbert row sums at BIG_N (the first product of that solve)
    big = fixtures.hilbert_matrix(BIG_N, device=dev)
    mv_err = 0.0
    mv_cases = []
    for n in (3, 1000, 1001, 4096, 8192):
        A = fixtures.random_positive_matrix(n, gen, device=dev)
        mv_cases.append((f"random n={n}", A, (torch.rand(n, generator=gen) + 0.5).to(dev)))
    mv_cases.append((f"hilbert n={BIG_N}", big, torch.ones(BIG_N, device=dev)))
    for name, A, x in mv_cases:
        want = f64_matvec(A, x)
        got = kernels.matvec(A, x)
        plain = kernels.matvec_plain(A, x)
        torch.cuda.synchronize()
        rel_k = float(((got.double() - want).abs() / want.abs()).max())
        rel_p = float(((plain.double() - want).abs() / want.abs()).max())
        diff = float((got - plain).abs().max())
        say(f"matvec {name}: kernel rel err {rel_k:.3e}, plain rel err {rel_p:.3e}, "
            f"max |kernel - plain| {diff:.3e}")
        check(rel_k <= PLAIN_TOL, f"matvec {name} rel err {rel_k} > {PLAIN_TOL}")
        check(torch.equal(got, kernels.matvec(A, x)), f"matvec {name} not deterministic")
        mv_err = max(mv_err, diff)
    del mv_cases, A

    # --- 2. one multiround chunk against multiround_plain ---
    mr_err = 0.0
    cases = [
        ("hilbert", fixtures.hilbert_matrix(8192, device=dev), 5, "absolute"),
        ("random", fixtures.random_positive_matrix(1000, gen, device=dev), 4, "relative"),
        ("anchor", torch.tensor(fixtures.ANCHOR_3X3, dtype=torch.float32, device=dev), 18, "absolute"),
    ]
    for name, A, chunk, mode in cases:
        n = A.shape[0]
        ev = torch.ones(n, device=dev)
        state = (ev, ev, torch.zeros((), device=dev))
        for init in (True, False):
            kw = dict(chunk=chunk, eps=evt.EPS, init=init, eps_mode=mode)
            got = kernels.multiround(A, *state, 1000, **kw)
            want = kernels.multiround_plain(A, *state, 1000, **kw)
            torch.cuda.synchronize()
            check(int(got[2]) == int(want[2]), f"multiround {name} init={init}: advanced "
                  f"{int(got[2])} != {int(want[2])}")
            rel = max(
                float(((g - w).abs() / w.abs()).max())
                for g, w in ((got[0], want[0]), (got[1], want[1]), (got[3], want[3]))
            )
            err = float((got[1] - want[1]).abs().max())
            say(f"multiround {name} n={n} chunk={chunk} {mode} init={init}: advanced "
                f"{int(got[2])}, max rel diff (ev, v, λ) {rel:.3e}, max |v - plain| {err:.3e}")
            check(rel <= PARITY_REL, f"multiround {name} init={init} rel diff {rel}")
            if name == "hilbert":
                mr_err = max(mr_err, err)
            state = (got[0], got[1], got[3])

    # --- 2b. one multiround_sym launch against multiround_sym_plain ---
    # the triangle mode on Hilbert, the dense tiled mode on an asymmetric
    # Hilbert (each entry scaled by 1 + U[0, 0.25)); cache 0 and the card's
    # auto budget.  (A random matrix at 8192² has row sums ~4e3, so its
    # rounding noise sits at the absolute 1e-3 stop and the stop round
    # would be a coin toss between any two summation orders.)
    sym_err = 0.0
    bt = kernels.SYM_TILE
    for n in (128, 384, 4096, 8192):
        for sym in (True, False):
            A = fixtures.hilbert_matrix(n, device=dev)
            if not sym:
                A = A * (1 + 0.25 * torch.rand(n, n, generator=gen).to(dev))
            for cache in sorted({0, sym_auto_cache_tiles(n, bt, dev, sym=sym)}):
                ev = torch.ones(n, device=dev)
                state = (ev, ev, torch.zeros((), device=dev))
                for init in (True, False):
                    kw = dict(chunk=5, eps=evt.EPS, init=init, tile=bt, sym=sym)
                    got = kernels.multiround_sym(A, *state, 1000, cache_tiles=cache, **kw)
                    want = kernels.multiround_sym_plain(A, *state, 1000, **kw)
                    torch.cuda.synchronize()
                    what = f"multiround_sym n={n} sym={sym} cache={cache} init={init}"
                    check(int(got[2]) == int(want[2]),
                          f"{what}: advanced {int(got[2])} != {int(want[2])}")
                    rel = max(
                        float(((g - w).abs() / w.abs()).max())
                        for g, w in ((got[0], want[0]), (got[1], want[1]), (got[3], want[3]))
                    )
                    err = float((got[1] - want[1]).abs().max())
                    say(f"{what}: advanced {int(got[2])}, max rel diff (ev, v, λ) {rel:.3e}, "
                        f"max |v - plain| {err:.3e}")
                    check(rel <= PARITY_REL, f"{what}: rel diff {rel} > {PARITY_REL}")
                    if sym and n == 8192:
                        sym_err = max(sym_err, err)
                    state = (got[0], got[1], got[3])
    del A

    # --- 2c. the iterated form's passes against their plain versions ---
    # random positive matrices, then the iterated solve's own first round at
    # full width: Hilbert 8192² with its row sums as v.  The sums are held to
    # a float64 sum within PLAIN_TOL; every other check is bitwise.
    it_err = {}
    bias = torch.tensor(0.375, device=dev)
    it_cases = [
        (f"random n={n}", fixtures.random_positive_matrix(n, gen, device=dev),
         (torch.rand(n, generator=gen) + 0.5).to(dev))
        for n in (3, 1000, 1001, 4096, 8192)
    ]
    A = fixtures.hilbert_matrix(8192, device=dev)
    it_cases.append(("hilbert n=8192", A, kernels.rowsum_plain(A)))
    for name, A, v in it_cases:
        n = A.shape[0]
        keep = A.clone()
        rs, rs_b = kernels.rowsum(A), kernels.rowsum_bias(A, bias)
        rel = rel_err(rs, A.double().sum(1))
        rel_b = rel_err(rs_b, (A.double() + 0.375).sum(1))
        check(rel <= PLAIN_TOL, f"rowsum {name} rel err {rel} > {PLAIN_TOL}")
        check(rel_b <= PLAIN_TOL, f"rowsum_bias {name} rel err {rel_b} > {PLAIN_TOL}")
        check(torch.equal(rs, kernels.rowsum(A)), f"rowsum {name} not deterministic")
        check(torch.equal(rs_b, kernels.rowsum_bias(A, bias)),
              f"rowsum_bias {name} not deterministic")
        check(torch.equal(rs, kernels.matvec(A, torch.ones(n, device=dev))),
              f"rowsum {name} is not matvec(A, ones) bit for bit")
        check(torch.equal(rs, kernels.rowsum_bias(A, torch.zeros((), device=dev))),
              f"rowsum_bias {name} with a zero bias is not rowsum")
        want = kernels.scale_plain(A, v)
        sc = kernels.scale(A, v)
        A2, v2 = kernels.scale_rowsum(A, v)
        torch.cuda.synchronize()
        check(torch.equal(A, keep), f"{name}: an update with another out= wrote its input")
        check(torch.equal(sc, want), f"scale {name} is not scale_plain bit for bit")
        check(torch.equal(A2, sc), f"scale_rowsum {name}: A' is not scale's")
        check(torch.equal(v2, kernels.rowsum(sc)), f"scale_rowsum {name}: v' is not rowsum(A')")
        B = A.clone()
        check(kernels.scale(B, v, out=B) is B and torch.equal(B, want),
              f"scale {name} in place differs")
        B.copy_(A)
        B2, w2 = kernels.scale_rowsum(B, v, out=B)
        check(B2 is B and torch.equal(B, want) and torch.equal(w2, v2),
              f"scale_rowsum {name} in place differs")
        v2_plain = kernels.rowsum_plain(want)
        err = {
            "rowsum": float((rs - kernels.rowsum_plain(A)).abs().max()),
            "rowsum_bias": float((rs_b - kernels.rowsum_bias_plain(A, bias)).abs().max()),
            "scale": float((sc - want).abs().max()),
            "scale_rowsum": max(float((A2 - want).abs().max()),
                                float((v2 - v2_plain).abs().max())),
        }
        say(f"iterated passes {name}: rowsum rel err {rel:.3e}, rowsum_bias rel err {rel_b:.3e}, "
            f"v' rel diff to plain {rel_err(v2, v2_plain.double()):.3e}, max |kernel - plain| {err}; "
            f"bit identities hold")
        it_err = err  # the last case is the main path's shape
    del it_cases, A, keep, want, sc, A2, B, B2

    # --- 3. the main path, through the public API, backend "auto" only ---
    mats = {n: fixtures.hilbert_matrix(n, device=dev) for n in fixtures.HILBERT_ROUNDS}
    routes = {n: resolve_backend(evt.DEFAULT_CONFIG, n, dev) for n in (*mats, BIG_N)}
    say(f"auto routes: {routes}")
    check(all(routes[n] == "multiround" for n in mats), "auto must take multiround up to 8192")
    check(routes[BIG_N] == "matvec_pallas", f"auto must take the matvec kernel loop at {BIG_N}")
    reset_counts()
    auto = {n: evt.max_eigenvalue(H) for n, H in mats.items()}
    auto_big = evt.max_eigenvalue(big)
    lam_c, vec_c, ms_c, rounds_c = evt.EigenValue().similarity_transform(mats[8192])
    launches = read_counts()
    say(f"main path launches: {launches}")
    for name, count in launches.items():
        if name in ("matvec", "multiround"):
            check(count > 0, f"the main path launched no {name} kernel")
        else:
            check(count == 0, f"a dense auto solve launched {name}")

    # the oracle here is the plain loop in float64: at this width cuBLAS's
    # float32 gemv drifts (Hilbert row sums off by ~3e-5 relative), the
    # kernel does not
    plain_big = solve_matvec(big, evt.EPS, evt.MAX_ITR)
    plain_64 = solve_matvec(big.double(), evt.EPS, evt.MAX_ITR)
    resid = float(evt.eigen_residual(big, auto_big))
    lam, lam_p, lam_64 = (float(r.eigenvalue) for r in (auto_big, plain_big, plain_64))
    rel = abs(lam - lam_64) / lam_64
    say(f"hilbert {BIG_N}: rounds {int(auto_big.rounds)} (float64 loop {int(plain_64.rounds)}, "
        f"float32 plain loop {int(plain_big.rounds)}), λ {lam!r} (float64 loop {lam_64!r}, "
        f"rel {rel:.2e}; float32 plain loop {lam_p!r}, rel {abs(lam_p - lam_64) / lam_64:.2e}), "
        f"residual {resid:.3e}")
    check(bool(auto_big.converged), f"hilbert {BIG_N} did not converge")
    check(int(auto_big.rounds) == int(plain_64.rounds), f"hilbert {BIG_N} rounds")
    check(rel <= PARITY_REL, f"hilbert {BIG_N} λ rel {rel} to the float64 loop")
    check(resid <= 1e-3, f"hilbert {BIG_N} residual {resid}")
    check(bool(torch.isfinite(auto_big.eigenvector).all()), f"hilbert {BIG_N} eigenvector finite")
    del big, plain_big, plain_64, auto_big
    torch.cuda.empty_cache()

    for n, res in auto.items():
        plain = solve_matvec(mats[n], evt.EPS, evt.MAX_ITR)
        resid = float(evt.eigen_residual(mats[n], res))
        lam, lam_p = float(res.eigenvalue), float(plain.eigenvalue)
        rel = abs(lam - lam_p) / abs(lam_p)
        say(f"hilbert {n}: rounds {int(res.rounds)} (table {fixtures.HILBERT_ROUNDS[n]}, "
            f"plain loop {int(plain.rounds)}), λ {lam!r} (plain {lam_p!r}, rel {rel:.2e}), "
            f"residual {resid:.3e}")
        check(bool(res.converged), f"hilbert {n} did not converge")
        check(int(res.rounds) == fixtures.HILBERT_ROUNDS[n], f"hilbert {n} rounds")
        check(rel <= PARITY_REL, f"hilbert {n} λ rel {rel}")
        check(resid <= 1e-3, f"hilbert {n} residual {resid}")
        check(bool(torch.isfinite(res.eigenvector).all()), f"hilbert {n} eigenvector finite")

    # --- 4. bit-identity at 8192² ---
    H = mats[8192]
    want = solve_matvec_kernel(H, evt.EPS, evt.MAX_ITR)
    loop = evt.max_eigenvalue(H, evt.SolverConfig(backend="matvec_pallas"))
    check(int(loop.rounds) == int(want.rounds) and torch.equal(loop.eigenvector, want.eigenvector),
          "matvec_pallas backend differs from solve_matvec_kernel")
    check(torch.equal(auto[8192].eigenvector, want.eigenvector),
          "auto (multiround, one launch) differs from the matvec kernel loop")
    for chunk in (1, 5, 18):
        got = solve_multiround(H, evt.EPS, evt.MAX_ITR, chunk=chunk)
        same = (
            int(got.rounds) == int(want.rounds)
            and torch.equal(got.eigenvalue, want.eigenvalue)
            and torch.equal(got.eigenvector, want.eigenvector)
        )
        say(f"multiround chunk={chunk} vs matvec kernel loop at 8192: bit-identical {same}")
        check(same, f"multiround chunk={chunk} not bit-identical to the matvec kernel loop")
    say(f"EigenValue().similarity_transform(8192): λ {float(lam_c)!r}, rounds {rounds_c}, "
        f"ms {ms_c:.3f}")
    check(rounds_c == 17 and ms_c > 0, "similarity_transform at 8192")

    # --- 4b. the symmetric path: symmetric=True and the validate promotion ---
    sym_cfg = evt.SolverConfig(symmetric=True)
    check(all(resolve_backend(sym_cfg, n, dev) == "multiround" for n in mats),
          "auto with symmetric=True must take multiround")
    reset_counts()
    declared = {n: evt.max_eigenvalue(H_, sym_cfg) for n, H_ in mats.items()}
    promoted = {n: evt.max_eigenvalue(H_, validate=True) for n, H_ in mats.items()}
    sym_launches = read_counts()
    say(f"symmetric path launches: {sym_launches}")
    check(sym_launches["multiround_sym"] > 0, "the symmetric path launched no multiround_sym")
    check(sum(sym_launches.values()) == sym_launches["multiround_sym"],
          "the symmetric path left the triangle kernel")
    for n, H_ in mats.items():
        plain = solve_matvec(H_, evt.EPS, evt.MAX_ITR)
        for how, res in (("symmetric=True", declared[n]), ("validate=True", promoted[n])):
            resid = float(evt.eigen_residual(H_, res))
            lam, lam_p = float(res.eigenvalue), float(plain.eigenvalue)
            rel = abs(lam - lam_p) / abs(lam_p)
            say(f"hilbert {n} via {how}: rounds {int(res.rounds)} (table "
                f"{fixtures.HILBERT_ROUNDS[n]}), λ {lam!r} (plain {lam_p!r}, rel {rel:.2e}), "
                f"residual {resid:.3e}")
            check(bool(res.converged), f"hilbert {n} {how} did not converge")
            check(int(res.rounds) == fixtures.HILBERT_ROUNDS[n], f"hilbert {n} {how} rounds")
            check(rel <= PARITY_REL, f"hilbert {n} {how} λ rel {rel}")
            check(resid <= 1e-3, f"hilbert {n} {how} residual {resid}")
            check(bool(torch.isfinite(res.eigenvector).all()), f"hilbert {n} {how} finite")

    n = 8192
    cache = sym_auto_cache_tiles(n, bt, dev)
    dense_cache = sym_auto_cache_tiles(n, bt, dev, sym=False)
    say(f"auto tile cache at {n}², tile {bt}: triangle {cache} tiles, dense {dense_cache} tiles "
        f"({cache * bt * bt * 4 / 1e6:.1f} MB resident)")
    check(cache > 0 and dense_cache > 0, "the auto tile cache at 8192² must be > 0")
    dense_tiled = evt.max_eigenvalue(H, evt.SolverConfig(backend="multiround",
                                                         cache_tiles=dense_cache))
    rel = abs(float(dense_tiled.eigenvalue) - float(want.eigenvalue)) / float(want.eigenvalue)
    resid = float(evt.eigen_residual(H, dense_tiled))
    say(f"dense tiled-cached solve at {n}²: rounds {int(dense_tiled.rounds)}, λ rel {rel:.2e} "
        f"to the matvec kernel loop, residual {resid:.3e}")
    check(int(dense_tiled.rounds) == 17 and rel <= PARITY_REL and resid <= 1e-3,
          "dense tiled-cached solve at 8192²")

    # --- 4c. invariances of the triangle kernel at 8192², all bit-identical ---
    def same(a, b):
        return (int(a.rounds) == int(b.rounds) and torch.equal(a.eigenvalue, b.eigenvalue)
                and torch.equal(a.eigenvector, b.eigenvector))

    def tri(A, **kw):
        return solve_multiround(A, evt.EPS, evt.MAX_ITR, symmetric=True, **kw)

    base = tri(H, cache_tiles=0)
    check(same(declared[n], tri(H, cache_tiles=cache)), "symmetric=True is not the auto cache")
    for c in (7, cache):
        ok = same(tri(H, cache_tiles=c), base)
        say(f"triangle cache_tiles={c} vs 0 at {n}²: bit-identical {ok}")
        check(ok, f"cache_tiles={c} changed the result")
    for chunk in (1, 5, 18, None):
        ok = same(tri(H, cache_tiles=cache, chunk=chunk), base)
        say(f"triangle chunk={chunk or 'whole budget'} at {n}²: bit-identical {ok}")
        check(ok, f"chunk={chunk} changed the result")
    blk = torch.arange(n, device=dev) // bt
    bad = torch.where(blk[:, None] > blk[None, :], torch.full_like(H, 7.25), H)
    for c in (0, cache):
        ok = same(tri(bad, cache_tiles=c), base)
        say(f"triangle with the lower block triangle overwritten, cache {c}: bit-identical {ok}")
        check(ok, "the triangle kernel read below the block diagonal")
    del bad, blk
    x = torch.ones(n, device=dev)
    z = torch.zeros((), device=dev)
    sym_kw = dict(chunk=evt.MAX_ITR + 1, eps=evt.EPS, init=True, tile=bt)
    first = kernels.multiround_sym(H, x, x, z, evt.MAX_ITR, cache_tiles=cache, **sym_kw)
    again = kernels.multiround_sym(H, x, x, z, evt.MAX_ITR, cache_tiles=cache, **sym_kw)
    ok = all(torch.equal(a, b) for a, b in zip(first, again))
    say(f"repeated multiround_sym launch: bitwise the same {ok}")
    check(ok, "a repeated multiround_sym launch differs")

    # --- 4d. the iterated path through the API: backend="pallas" ---
    # the Hilbert table, the 3×3 anchor as a host array (no device=: it goes
    # to the card) and a random positive 1000²
    it_cfg, xla_cfg = evt.SolverConfig(backend="pallas"), evt.SolverConfig(backend="xla")
    inputs = {f"hilbert {n_}": H_ for n_, H_ in mats.items()}
    inputs["anchor 3x3 (host array)"] = fixtures.ANCHOR_3X3
    inputs["random 1000"] = fixtures.random_positive_matrix(1000, gen, device=dev)
    keeps = {k: M.clone() if isinstance(M, torch.Tensor) else M.copy() for k, M in inputs.items()}
    reset_counts()
    iterated = {k: evt.max_eigenvalue(M, it_cfg) for k, M in inputs.items()}
    it_launches = read_counts()
    say(f"iterated path launches: {it_launches}")
    it_rounds = sum(int(r.rounds) for r in iterated.values())
    check(it_launches["rowsum"] == len(inputs), "one rowsum launch per iterated solve")
    check(it_launches["scale_rowsum"] == it_rounds,
          f"scale_rowsum launches {it_launches['scale_rowsum']} != rounds {it_rounds}")
    check(sum(it_launches.values()) == len(inputs) + it_rounds,
          "the iterated path launched another kernel")
    for k, M in inputs.items():
        res = iterated[k]
        same_input = (torch.equal(M, keeps[k]) if isinstance(M, torch.Tensor)
                      else bool((M == keeps[k]).all()))
        check(same_input, f"{k}: the iterated solve wrote the caller's matrix")
        check(res.eigenvector.is_cuda, f"{k}: solved off the card")
        plain = evt.max_eigenvalue(M, xla_cfg)
        resid = float(evt.eigen_residual(M, res))
        lam, lam_p = float(res.eigenvalue), float(plain.eigenvalue)
        rel = abs(lam - lam_p) / abs(lam_p)
        ev_diff = float((res.eigenvector - plain.eigenvector).abs().max())
        line = (f"{k} via backend='pallas': rounds {int(res.rounds)} (backend='xla' "
                f"{int(plain.rounds)}), λ {lam!r} (xla {lam_p!r}, rel {rel:.2e}), "
                f"max |ev - xla ev| {ev_diff:.2e}, residual {resid:.3e}")
        n_ = M.shape[0]
        if n_ in fixtures.HILBERT_ROUNDS:
            line += f", table {fixtures.HILBERT_ROUNDS[n_]}"
            if n_ <= 1024:
                check(int(res.rounds) == fixtures.HILBERT_ROUNDS[n_], f"{k} iterated rounds")
            else:
                # the JAX tests pin the iterated form only up to 1024: beyond,
                # report it beside a float64 run of the plain iterated loop
                f64 = solve_xla(M.double(), evt.EPS, evt.MAX_ITR)
                line += f", float64 iterated loop {int(f64.rounds)}"
                del f64
        say(line)
        check(bool(res.converged), f"{k} iterated solve did not converge")
        check(int(res.rounds) == int(plain.rounds), f"{k}: kernel and plain rounds differ")
        check(rel <= PARITY_REL, f"{k} iterated λ rel {rel}")
        check(ev_diff <= 1e-5, f"{k} iterated ev differs from the plain version's by {ev_diff}")
        check(resid <= 1e-3, f"{k} iterated residual {resid}")
        check(bool(torch.isfinite(res.eigenvector).all()), f"{k} iterated eigenvector finite")
    check({n_: resolve_backend(evt.DEFAULT_CONFIG, n_, dev) for n_ in routes} == routes,
          "the auto routes changed")
    del inputs, keeps, iterated, plain

    # --- 4e. the kernel ladder at 8192² ---
    reset_counts()
    ladder = bench_kernels(dims=[n])
    ladder_launches = read_counts()
    say(f"kernel ladder at {n}², card {card} (marginal ms per application, chained):")
    for row in ladder:
        say("  " + json.dumps(row, allow_nan=False))
    say(f"ladder launches: {ladder_launches}")
    check([r["kernel"] for r in ladder] == [
        "rowsum_xla", "rowsum_pallas", "scale_xla", "scale_pallas", "scale_rowsum_pallas",
        "matvec_xla", "matvec_pallas"], "the ladder's seven rungs")
    check(all(r["ms"] > 0 for r in ladder), "a ladder rung's marginal time vanished")
    for name in ("rowsum_bias", "scale", "scale_rowsum", "matvec"):
        check(ladder_launches[name] > 0, f"the ladder launched no {name} kernel")
    torch.cuda.empty_cache()

    # --- 5. times at 8192², CUDA events, median and min ---
    reps = 12
    rounds = int(want.rounds)
    it_rounds_n = int(solve_kernel(H, evt.EPS, evt.MAX_ITR).rounds)
    tile_mb = bt * bt * 4
    streamed = {"triangle": len(kernels.sym_cache_split(n, bt, 0)[0]),
                "triangle cached": len(kernels.sym_cache_split(n, bt, cache)[0]),
                "dense cached": (n // bt) ** 2 - dense_cache}
    arm_bytes = {
        "multiround kernel (stripes)": (rounds + 1) * n * n * 4,
        "triangle kernel, streaming": (rounds + 1) * streamed["triangle"] * tile_mb,
        f"triangle kernel, cache {cache}":
            (rounds + 1) * streamed["triangle cached"] * tile_mb + cache * tile_mb,
        f"dense tiled kernel, cache {dense_cache}":
            (rounds + 1) * streamed["dense cached"] * tile_mb + dense_cache * tile_mb,
        "matvec kernel loop": (rounds + 1) * n * n * 4,
        "torch.mv loop (plain)": (rounds + 1) * n * n * 4,
        # one read for the row sums, then a read and a write of A every round
        "iterated kernel solve": (1 + 2 * it_rounds_n) * n * n * 4,
        "iterated plain solve": (1 + 2 * it_rounds_n) * n * n * 4,
    }
    arms = {
        "multiround kernel (stripes)": lambda: solve_multiround(H, evt.EPS, evt.MAX_ITR),
        "triangle kernel, streaming": lambda: tri(H, cache_tiles=0),
        f"triangle kernel, cache {cache}": lambda: tri(H, cache_tiles=cache),
        f"dense tiled kernel, cache {dense_cache}":
            lambda: solve_multiround(H, evt.EPS, evt.MAX_ITR, cache_tiles=dense_cache),
        "matvec kernel loop": lambda: solve_matvec_kernel(H, evt.EPS, evt.MAX_ITR),
        "torch.mv loop (plain)": lambda: solve_matvec(H, evt.EPS, evt.MAX_ITR),
        "iterated kernel solve": lambda: solve_kernel(H, evt.EPS, evt.MAX_ITR),
        "iterated plain solve": lambda: solve_xla(H, evt.EPS, evt.MAX_ITR),
    }
    samples = {k: [] for k in arms}
    for rep in range(reps + 1):  # rep 0 warms up; the order alternates
        order = list(arms) if rep % 2 else list(reversed(arms))
        for k in order:
            t = time_call(arms[k], reps=1, warmup=0)
            if rep:
                samples[k].append(t.min_ms)
    say(f"solve times at {n}² ({rounds} rounds, {rounds + 1} passes; the iterated arms "
        f"{it_rounds_n} rounds), card {card}; GB/s against the bytes each arm moves (the cache "
        f"fill once):")
    for k, ms in samples.items():
        med = statistics.median(ms)
        say(f"  {k}: median {med:.4f} ms, min {min(ms):.4f} ms over {len(ms)} solves, "
            f"{arm_bytes[k] / 1e6:.1f} MB, {arm_bytes[k] / (med * 1e-3) / 1e9:.1f} GB/s at the "
            f"median ({roofline_pct(med, arm_bytes[k], H100_SXM_GBPS):.1f}% of "
            f"{H100_SXM_GBPS:.0f} GB/s)")

    t_mv = time_call(lambda: kernels.matvec(H, x), reps=20)
    t_mv_p = time_call(lambda: kernels.matvec_plain(H, x), reps=20)
    # the main path's one launch: init, the whole budget, freezes after 17 rounds
    mr_kw = dict(chunk=evt.MAX_ITR + 1, eps=evt.EPS, init=True)
    t_mr = time_call(lambda: kernels.multiround(H, x, x, z, evt.MAX_ITR, **mr_kw), reps=10)
    t_mr_p = time_call(lambda: kernels.multiround_plain(H, x, x, z, evt.MAX_ITR, **mr_kw), reps=10)
    say(f"matvec at {n}²: kernel median {t_mv.median_ms:.4f} ms "
        f"({n * n * 4 / (t_mv.median_ms * 1e-3) / 1e9:.1f} GB/s), torch.mv {t_mv_p.median_ms:.4f} ms")
    say(f"multiround init, chunk {evt.MAX_ITR + 1} ({rounds + 1} passes) at {n}²: kernel median "
        f"{t_mr.median_ms:.4f} ms, plain {t_mr_p.median_ms:.4f} ms")

    # the symmetric path's one launch: init, the whole budget, the auto cache
    t_sym = {}
    for label, c in (("streaming", 0), (f"cache {cache}", cache)):
        t_sym[label] = time_call(
            lambda: kernels.multiround_sym(H, x, x, z, evt.MAX_ITR, cache_tiles=c, **sym_kw),
            reps=10)
    t_sym_p = time_call(lambda: kernels.multiround_sym_plain(H, x, x, z, evt.MAX_ITR, **sym_kw),
                        reps=5)
    for label, t in t_sym.items():
        c = cache if label != "streaming" else 0
        b = (rounds + 1) * len(kernels.sym_cache_split(n, bt, c)[0]) * tile_mb + c * tile_mb
        say(f"multiround_sym init, chunk {evt.MAX_ITR + 1}, {label} at {n}²: kernel median "
            f"{t.median_ms:.4f} ms ({b / (t.median_ms * 1e-3) / 1e9:.1f} GB/s of {b / 1e6:.1f} MB)")
    say(f"multiround_sym_plain init, chunk {evt.MAX_ITR + 1} at {n}²: median "
        f"{t_sym_p.median_ms:.4f} ms")

    # the iterated path's passes at the solve's first round: v = rowsum(H);
    # the updates write a second buffer, so H and v stay what they are
    v1 = kernels.rowsum(H)
    buf = torch.empty_like(H)
    timed = {
        "rowsum": (lambda: kernels.rowsum(H), lambda: kernels.rowsum_plain(H),
                   lambda: H.sum(1)),
        "rowsum_bias": (lambda: kernels.rowsum_bias(H, bias),
                        lambda: kernels.rowsum_bias_plain(H, bias), None),
        "scale": (lambda: kernels.scale(H, v1, out=buf),
                  lambda: kernels.scale_plain(H, v1, out=buf),
                  lambda: H * ((1 / v1)[:, None] * v1[None, :])),
        "scale_rowsum": (lambda: kernels.scale_rowsum(H, v1, out=buf),
                         lambda: kernels.scale_rowsum_plain(H, v1, out=buf), None),
    }
    t_it = {}
    for name, fns in timed.items():
        t_it[name] = [time_call(fn, reps=20).median_ms if fn else None for fn in fns]
        say(f"{name} at {n}²: kernel median {t_it[name][0]:.4f} ms, plain {t_it[name][1]:.4f} ms, "
            f"one PyTorch call {t_it[name][2] if t_it[name][2] is None else round(t_it[name][2], 4)}")
    t_mv_lib = time_call(lambda: torch.mv(H, x), reps=20).median_ms
    del buf

    # The least time the card could take: each input read once and each
    # output written once at the published memory rate, against the float32
    # operations at the published rate outside the tensor cores.  The two
    # multiround kernels run this solve's rounds + 1 passes in one launch
    # over a matrix five times the L2, so `passes_bound_ms` adds what the
    # passes must stream when A cannot stay on the chip.
    def bound(nbytes: float, ops: float) -> dict:
        t_bytes = nbytes / (H100_SXM_GBPS * 1e9) * 1e3
        t_ops = ops / (H100_SXM_F32_TFLOPS * 1e12) * 1e3
        return {"bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}

    nn, vec, passes = n * n, 4 * n, rounds + 1
    tri_bytes = len(kernels.sym_cache_split(n, bt, 0)[0]) * tile_mb
    tri_streamed = len(kernels.sym_cache_split(n, bt, cache)[0]) * tile_mb

    def record(name, source, replaces, count, err, ms, plain_ms, library_ms, bnd, **more):
        return {"name": name, "route": "cuda", "source": f"eigen_value_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": count, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, **bnd, "library_ms": library_ms, **more}

    jk = "eigen_value_tpu/ops/pallas/kernels.py"
    say(json.dumps({"kernels": [
        record("matvec", "matvec.cu", f"{jk}:227", launches["matvec"], mv_err,
               t_mv.median_ms, t_mv_p.median_ms, t_mv_lib, bound(4 * nn + 2 * vec, 2 * nn)),
        record("multiround", "multiround.cu", f"{jk}:483", launches["multiround"], mr_err,
               t_mr.median_ms, t_mr_p.median_ms, None,
               bound(4 * nn + 4 * vec, passes * 2 * nn),
               passes_bound_ms=bound(passes * 4 * nn, 0)["bound_ms"]),
        record("multiround_sym", "multiround_sym.cu", f"{jk}:720",
               sym_launches["multiround_sym"], sym_err, t_sym[f"cache {cache}"].median_ms,
               t_sym_p.median_ms, None, bound(tri_bytes + 4 * vec, passes * 2 * nn),
               passes_bound_ms=bound(passes * tri_streamed + cache * tile_mb, 0)["bound_ms"]),
        record("rowsum", "rowsum.cu", f"{jk}:58", it_launches["rowsum"], it_err["rowsum"],
               *t_it["rowsum"], bound(4 * nn + vec, nn)),
        record("rowsum_bias", "rowsum.cu", "eigen_value_tpu/bench/suite.py:694",
               ladder_launches["rowsum_bias"], it_err["rowsum_bias"], *t_it["rowsum_bias"],
               bound(4 * nn + vec + 4, 2 * nn)),
        record("scale", "scale.cu", f"{jk}:181", ladder_launches["scale"], it_err["scale"],
               *t_it["scale"], bound(8 * nn + vec, 2 * nn + n)),
        record("scale_rowsum", "scale.cu", f"{jk}:277", it_launches["scale_rowsum"],
               it_err["scale_rowsum"], *t_it["scale_rowsum"], bound(8 * nn + 2 * vec, 3 * nn + n)),
    ]}, allow_nan=False))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
