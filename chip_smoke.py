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
kernel loop at 8192², and times the arms at 8192².  The one-launch solves
go through a binding kept per (device, stream) (``kernels.multiround_solve``
/ ``multiround_sym_solve``); at 8192² each is held bit for bit to its
wrapper's launch (f32 triangle, bf16 triangle, f32 stripes), and "main
path launches" gives the bindings made beside the launches.

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

The fused-round path: the ``stop`` kernel (csrc/stop.cu) against its plain
version at n = 1 … 2²⁵ (fixtures, single breaks, a NaN, random vectors,
and every round's v of the 8192² Hilbert solve); ``round_matvec`` and
``round_fused`` (csrc/round.cu) against their plain versions and their bit
identities (``ev' == ev * (v / m)``, ``v' == matvec(A, ev') / ev'``,
``round_fused == round_matvec`` at ``m = max v`` with ``stop_check`` and
``v[0]``); ``round_glue`` (csrc/round_glue.cu) against its plain version
bit for bit at n = 65536, 65539, 1000 and 1 (a v that goes on, one that
stops, one with a NaN; rounds 0 and 9; both stop modes), and its time at
65536 beside the plain version's and the host loop's PyTorch chain's;
then, with the launch counters read around exactly these calls,
``solve_matvec_kernel_fused`` and ``solve_fused_round`` over the Hilbert
table, the caps 0/1/5 and the 3×3 anchor, bit-identical to the matvec
kernel loop; and the ``vector`` and ``e2e`` bench suites
(``bench_vector_kernels()``, whose ``stop_pallas`` row launches ``stop``,
and ``bench_e2e(dims=[8192])``).

The two persistent kernels keep part of A on the chip, so they are also
held and timed where that changes most: at n = 2048, 4096 and 8192 the
stripes kernel against the matvec kernel loop (chunk 1 / 5 / 18, bit for
bit) and the tiled kernel across its tile caches (0, the 264 of its first
version, the card's budget), a one-round chunk and a repeated launch; then
each size's launch plan (resident rows or tiles, the L2-kept set, the bytes
a round streams from device memory), its time and its phase split (the
kernels' own stamps, read by ``kernel_phases.py``), and a third bound,
``resident_bound_ms``: one read of A plus, for every later pass, the bytes
that neither the card's shared memory nor its L2 could hold.

Reduced-precision storage (A in bf16 / f16, ev and every sum f32): the
2-byte ``matvec``, ``multiround`` and ``multiround_sym`` kernels are held
bit for bit against the f32 kernels on ``A_q.float()`` (matvec at 2048² …
65536², multiround at 2048² / 4096² / 8192², multiround_sym with caches 0,
3 and the 2-byte auto cache in both modes; the two persistent kernels at
bulk-copy ring depths 0, 1 and the planned one, against the f32 launch
without a ring) and against their plain versions; then, with the launch counters read around exactly these calls,
the storage solves through the API: Hilbert 8192² in both dtypes via auto,
``symmetric=True`` and ``validate=True`` (rounds within ±1 of the table, λ
within 1e-3 of the f32 solve, residual against A_q), and Hilbert 65536² in
bf16 via auto on the matvec kernel loop, held to the f32 solve of step 3
(±1 round, λ within 2e-3) with its peak memory below 9 GiB, beside the JAX
package's pins.  The 2-byte kernels are timed interleaved with the f32
ones and join the kernels' record as ``matvec[bf16]``, ``multiround[bf16]``
and ``multiround_sym[bf16]``.

The matrix-free path (``matrix_free_phase``): each structured matvec of
``ops/structured.py`` (Hankel, Toeplitz, circulant, low-rank, Kronecker,
sparse COO and CSR, ELL, sum, scaling) at n = 8192 against the float64
product of its dense matrix, and the Kronecker operator's true-f32 pin
under the caller's ``"high"`` precision; ``max_eigenvalue_operator`` over a
dense matvec kernel call, bit for bit the matvec kernel loop with its 18
launches counted; the FFT Hilbert operator through ``max_eigenvalue_operator``
from 128 to 2²² (the 2²² solve's rounds, time and memory printed beside a
float64 loop's); the operator suite's Kronecker and ELL rungs and the
PageRank operator; the traced solves bit for bit the untraced ones, the
convergence report, ``subdominant_eigenpair`` and ``top_k_eigenpairs`` of
Hilbert 1024² against ``numpy.linalg.eigh``; and ``bench_operator(dims=[8192])``.

The resumable, batched and differentiable solves
(``resumable_batched_autodiff_phase``): ``checkpoint.solve_checkpointed`` on
Hilbert 8192² at chunks 1, 4, 8, 17, 18 and 1001, each bit for bit
``solve_multiround`` and ``solve_matvec_kernel`` with one ``multiround``
launch a step counted; a snapshot after one chunk loaded and finished; the
digest and eps rejections; the digest against numpy's; Hilbert 65536² in
bf16 stepped in chunks of 8 through the matvec kernel loop, bit for bit the
bf16 ``solve_matvec_kernel``, under 9 GiB; BASELINE config 4 (256 random
positive 512² f32 matrices) through ``max_eigenvalue_batch``, each matrix
held to its own ``solve_matvec``, and the same batch in bf16, each matrix
bit for bit ``solve_matvec_kernel`` with its ``matvec`` launches counted and
no f32 copy; ``eigenvalue``'s gradient at 1024² against a float64
``numpy.linalg.eig``, ``eigenpair``'s VJP at 1024² and 2048² against a
float64 dense solve of the bordered system, ``eigenvalue_operator`` on the
Hankel operator at 8192 (nonzero) and 256 (against the dense float64
adjoint), and examples/autodiff.py's steps; with the times of each.

The sharded solves (``mesh_phase``, step 8), on a one-rank NCCL group on
this card (the host the port is measured on has one card, and NCCL takes
one rank a card): ``kernels.matvec`` on column-block views of Hilbert 8192²
(the ring's and the 2-D body's local products, read in place through the
kernel's leading dimension) at every chunk position of P = 2, 4 and 8, in
f32 and bf16, bit for bit the kernel on ``.contiguous()``; then, with the
launch counters read around exactly these calls, ``max_eigenvalue(H,
mesh=make_row_mesh(1))``, the ring, the 2-D solve on a 1 × 1 mesh and the
bf16 door, each bit for bit the single-card matvec kernel loop,
``solve_sharded`` bit for bit the single-card ``"xla"`` solve, and
BASELINE config 4 on a ``batch`` and a ``batch × rows`` mesh bit for bit
the unsharded batch; ``bench/mh_worker.py`` as a process of its own at
8192² (and a 2-process NCCL group where the host has two cards); and the
P = 1 mesh solves timed beside the single-card loop.

The headline and the tools (``tools_phase``, step 9): the port of the root
bench.py (``python -m eigen_value_tpu_torch.bench.headline``) in a process
of its own at 8192² with 3 windows, its record printed on a line of its own
and held to 17 rounds on the cached triangle, every window at or above the
physical floor, the root script's keys and the four secondaries; then, with
the launch counters read around exactly these calls, the bench suites
``large`` (32768² f32 dense and symmetric, 65536² bf16 on the matvec kernel
loop: 21 rounds, λ within 1e-5 of a float64 loop), ``drift`` (3 windows with
the card's clocks), ``calibrate`` (gloo groups of 2 and 4 CPU processes),
``model`` and ``native``; every ported example's ``main()`` on the card; and
one symmetric solve under ``utils.profiling.trace``, whose chrome trace must
hold the triangle kernel's device time.

The dot formulation (``dot_phase``, step 10): ``formulation="dot"`` of both
persistent kernels, the row sums and transpose terms on the tensor cores by
``mma.sync`` in 3xTF32 (csrc/mma_tf32.cuh).  The card's ``cvt.rna`` split
against ``kernels.tf32_split`` bit for bit; one launch of each dot kernel
at 8192² against its plain version (``formulation="dot"``: the same rounds
over f32 products of the TF32 parts); then, with the launch counters read
around exactly these calls, ``solve_multiround(formulation="dot")`` on
Hilbert 8192² (the stripes, the triangle with no cache and the auto cache,
dense tiled with the auto cache, the stripes and triangle with
``storage_dtype=torch.bfloat16``: 17 rounds, λ within 1e-5 of a float64
loop, residual ≤ 1e-3 in float64, rounds and λ equal to the "vpu"
solve's) and the whole Hilbert table on both kernels; the bit identities
(chunk 1 / 5 / whole budget, cache 0 / 7 / auto, A_q against A_q.float());
and the median of 12 whole-budget launches of each dot instance beside its
"vpu" instance, interleaved.

The last two variants of the triangle kernel (``mixed_fill_phase``, step
11): ``formulation="mixed"`` (the last m resident tiles in 3xTF32, m by the
JAX package's rule, every other tile "vpu") and ``fill_mode="pipelined"``
(the resident tiles brought by one 2-D tensor copy a tile, each waited for
at first use).  One
launch of each at 8192² against its plain version (Hilbert, Hilbert scaled
at random, bf16, dense tiled; max |kernel − plain| ≤ 1e-5); then, with the
launch counters read around each solve, ``solve_multiround(symmetric=True,
cache_tiles=auto)`` with mixed, pipelined and both on Hilbert 8192² in f32
and bf16 storage (17 rounds, λ within 1e-5 of a float64 loop and of "vpu",
residual ≤ 1e-3) and the Hilbert table from 256² (at 128² no tile can be
resident and both packages refuse); the bit identities (chunk 1 / 5 /
whole budget, ``mxu_tiles=0`` against "vpu", pipelined against the
prologue fill for vpu, dot and mixed, a pipelined launch that stops at
round 0, the lower block triangle, A_q against A_q.float()); and the median
of 12 whole-budget launches of each beside "vpu", interleaved, every
pipelined instance (vpu, dot, mixed; f32 and bf16) beside its prologue twin
with both fills' ``fill_us`` from the kernel's fill stamps.

The NumPy oracles and a sharded A stepped through the checkpoint
(``oracle_stepping_phase``, step 12): ``python3 -m
eigen_value_tpu_torch.oracle`` in both semantics as processes of their
own, once more with jax blocked from import, and ``parallel_oracle`` on
Hilbert 128…1024 against the card's solves; then, on a one-rank NCCL group,
Hilbert 8192² as a ``Shard(0)`` DTensor in f32 and bf16 and as a 1 × 1
block-sharded one, stepped by ``checkpoint.step`` in chunks 5, 5 and the
rest with the launch counters read around exactly these calls, each bit
for bit the plain tensor's step and the matvec kernel loop; an Orbax round
trip of the sharded state; and the stepped solves timed beside the
unsharded step.

Uses torch only (no jax).  Exits non-zero, without the final result line,
on any failed check or when there is no CUDA device.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import itertools
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
H100_SXM_TF32_TFLOPS = 495.0  # the same sheet: TF32 on the tensor cores, dense
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


def matrix_free_phase(dev, mats, dense, same, reset_counts, read_counts, card) -> dict:
    """The matrix-free path on the card: each structured matvec against the
    float64 product of its dense matrix, the dense-backed operator bit for
    bit against the matvec kernel loop, ``max_eigenvalue_operator`` on the
    FFT Hilbert operator from 128 to 2²², the bench's Kronecker and ELL
    rungs and the PageRank operator, the traced solves and the spectral
    helpers, then ``bench_operator(dims=[8192])``.  ``mats`` are the dense
    Hilbert matrices of the table and ``dense`` their solves through the API.
    Returns the launch counts read around the dense-backed operator."""
    import numpy as np
    import torch

    import eigen_value_tpu_torch as evt
    from eigen_value_tpu_torch import fixtures
    from eigen_value_tpu_torch.bench import bench_operator, operator_rungs
    from eigen_value_tpu_torch.bench.__main__ import _fmt_operator
    from eigen_value_tpu_torch.convert import sparse_from_coo
    from eigen_value_tpu_torch.ops import spectral
    from eigen_value_tpu_torch.ops import structured as st
    from eigen_value_tpu_torch.ops.cuda import kernels
    from eigen_value_tpu_torch.ops.solver_matvec import (
        solve_matvec,
        solve_matvec_kernel,
        solve_matvec_traced,
        solve_operator,
        solve_operator_traced,
    )
    from eigen_value_tpu_torch.utils.timing import time_call

    # --- 6a. each structured matvec against its dense product in float64 ---
    # n = 8192 (kron 64 x 128), inputs from numpy with a seed; the JAX tests'
    # tolerances: rtol 2e-5 / atol 1e-5 for FFT and matmul, 1e-5 / 1e-6 sparse
    n = 8192
    rng = np.random.default_rng(SEED)

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    h = rng.random(2 * n - 1, dtype=np.float32) + 0.1
    c = rng.random(n, dtype=np.float32) + 0.1
    r = rng.random(n, dtype=np.float32) + 0.1
    r[0] = c[0]
    U = rng.random((n, 4), dtype=np.float32) + 0.1
    V = rng.random((n, 4), dtype=np.float32) + 0.1
    d = rng.random(n, dtype=np.float32)
    B = rng.random((64, 64), dtype=np.float32) + 0.1
    C = rng.random((128, 128), dtype=np.float32) + 0.1
    rows = np.repeat(np.arange(n), 8)
    cols = (rows + 1 + rng.integers(0, n - 1, size=rows.shape)) % n
    vals = rng.random(rows.shape[0], dtype=np.float32) + 0.1
    rows, cols = np.concatenate([rows, np.arange(n)]), np.concatenate([cols, np.arange(n)])
    vals = np.concatenate([vals, np.ones(n, np.float32)])
    x = f32(rng.random(n, dtype=np.float32))
    i = torch.arange(n, device=dev)
    diff = i[:, None] - i[None, :]

    def want_of(A):
        return f64_matvec(A, x)

    sparse_dense = torch.zeros(n, n, device=dev)
    sparse_dense.index_put_((torch.from_numpy(rows).to(dev), torch.from_numpy(cols).to(dev)),
                            f32(vals), accumulate=True)
    want = {
        "hankel": want_of(f32(h)[i[:, None] + i[None, :]]),
        "toeplitz": want_of(torch.where(diff >= 0, f32(c)[diff.abs()], f32(r)[diff.abs()])),
        "circulant": want_of(f32(c)[diff % n]),
        "low_rank": (f32(U).double() @ (f32(V).double().T @ x.double())
                     + f32(d).double() * x.double()),
        "kron": want_of(torch.kron(f32(B), f32(C))),
        "sparse": want_of(sparse_dense),
    }
    want["ell"] = want["sparse"]
    want["sparse_csr"] = want["sparse"]
    want["add"] = 0.25 * want["low_rank"] + want["ell"]
    want["scale"] = 4.0 * want["hankel"]
    del sparse_dense, diff
    torch.cuda.empty_cache()
    coo = sparse_from_coo(np.stack([rows, cols], 1), vals, (n, n), device=dev)
    low_rank = st.low_rank_matvec(f32(U), f32(V), f32(d))
    ell = st.ell_matvec(*st.ell_from_coo(rows, cols, vals, n))  # host input: to the card
    hankel = st.hankel_matvec(f32(h), n)
    ops = {
        "hankel": (hankel, 2e-5, 1e-5),
        "toeplitz": (st.toeplitz_matvec(f32(c), f32(r), n), 2e-5, 1e-5),
        "circulant": (st.circulant_matvec(f32(c), n), 2e-5, 1e-5),
        "low_rank": (low_rank, 2e-5, 1e-5),
        "kron": (st.kron_matvec(f32(B), f32(C)), 2e-5, 1e-5),
        "sparse": (st.sparse_matvec(coo), 1e-5, 1e-6),
        "sparse_csr": (st.sparse_matvec(coo.to_sparse_csr()), 1e-5, 1e-6),
        "ell": (ell, 1e-5, 1e-6),
        "add": (st.add_matvec(st.scale_matvec(low_rank, 0.25), ell), 2e-5, 1e-5),
        "scale": (st.scale_matvec(hankel, 4.0), 2e-5, 1e-5),
    }
    reset_counts()
    errs = {}
    for name, (mv, rtol, atol) in ops.items():
        y = mv(x)
        check(y.is_cuda and y.dtype == torch.float32 and y.shape == (n,), f"{name}: result")
        err = (y.double() - want[name]).abs()
        errs[name] = float((err / want[name].abs()).max())
        check(bool((err <= atol + rtol * want[name].abs()).all()),
              f"{name} matvec off its float64 product: max rel {errs[name]:.3e}")
    say(f"structured matvecs at n = {n} (kron 64 x 128) against float64 products: max rel err "
        + json.dumps({k: float(f"{v:.3e}") for k, v in errs.items()}))

    # the Kronecker pin: true f32 under the caller's "high" (TF32) setting,
    # and the setting given back; a bare matmul under "high" beside it
    kron = ops["kron"][0]
    prev = torch.get_float32_matmul_precision()
    y_highest = kron(x)
    torch.set_float32_matmul_precision("high")
    try:
        y_high, during = kron(x), torch.get_float32_matmul_precision()
        Bt, Ct = f32(B), f32(C)
        bare = (Bt @ x.reshape(64, 128) @ Ct.T).reshape(-1)
    finally:
        torch.set_float32_matmul_precision(prev)
    bare_err = float(((bare.double() - want["kron"]).abs() / want["kron"].abs()).max())
    say(f"kron under set_float32_matmul_precision('high'): bit-identical to 'highest' "
        f"{torch.equal(y_high, y_highest)}, the caller's setting kept {during!r}; a bare "
        f"matmul under 'high' is {bare_err:.3e} off float64 (pinned: {errs['kron']:.3e})")
    check(torch.equal(y_high, y_highest) and during == "high", "the kron precision pin")

    # --- 6b. the dense-backed operator: bit for bit the matvec kernel loop ---
    H = mats[8192]
    ref = solve_matvec_kernel(H, evt.EPS, evt.MAX_ITR)
    reset_counts()
    got = evt.max_eigenvalue_operator(lambda v: kernels.matvec(H, v), 8192)
    op_launches = read_counts()
    say(f"dense-backed operator at 8192²: bit-identical to solve_matvec_kernel {same(got, ref)}, "
        f"rounds {int(got.rounds)}; launches {op_launches}")
    check(same(got, ref), "the dense-backed operator is not the matvec kernel loop")
    check(op_launches["matvec"] == int(ref.rounds) + 1 == 18
          and sum(op_launches.values()) == op_launches["matvec"],
          "the dense-backed operator's launches")

    # --- 6c. max_eigenvalue_operator on the FFT Hilbert operator ---
    reset_counts()
    for n_, H_ in mats.items():
        res = evt.max_eigenvalue_operator(st.hilbert_matvec(n_), n_)
        lam, lam_d = float(res.eigenvalue), float(dense[n_].eigenvalue)
        rel = abs(lam - lam_d) / lam_d
        resid = float(evt.eigen_residual(H_, res))
        say(f"hilbert operator {n_}: rounds {int(res.rounds)} "
            f"(table {fixtures.HILBERT_ROUNDS[n_]}), "
            f"λ {lam!r} (dense {lam_d!r}, rel {rel:.2e}), residual {resid:.3e}")
        check(bool(res.converged) and abs(int(res.rounds) - fixtures.HILBERT_ROUNDS[n_]) <= 1,
              f"hilbert operator {n_}: rounds")
        check(rel <= 1e-4 and resid <= 1e-3, f"hilbert operator {n_}: λ rel {rel}, residual")
    # the float64 FFT loop's answers (rounds, λ); past 2^18 the absolute stop
    # fires on FFT noise in ev's small tail, so there the rounds are printed only
    f64_loop = {1 << 16: (21, 2.70899626), 1 << 18: (24, 2.76461595), 1 << 22: (31, 2.84824755)}
    for n_, (r64, lam64) in f64_loop.items():
        mv = st.hilbert_matvec(n_)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        res = evt.max_eigenvalue_operator(mv, n_)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        lam = float(res.eigenvalue)
        rel = abs(lam - lam64) / lam64
        resid = float(spectral.operator_residual(mv, res))
        line = (f"hilbert operator {n_}: rounds {int(res.rounds)} (float64 FFT loop {r64}"
                f"{', JAX on the CPU 37' if n_ == 1 << 22 else ''}), λ {lam!r} (float64 loop "
                f"{lam64}, rel {rel:.2e}), residual through the operator {resid:.3e}")
        if n_ == 1 << 22:
            t = time_call(lambda: evt.max_eigenvalue_operator(mv, n_), reps=3)
            rounds = int(res.rounds)
            line += (f"; {t.median_ms:.3f} ms a solve (median of 3, card {card}), "
                     f"{t.median_ms / (rounds + 1):.4f} ms a matvec, peak memory "
                     f"{peak / 2**20:.1f} MiB above the operator's spectrum")
            check(bool(res.converged) and rel <= 2e-4 and resid <= 1e-3,
                  f"hilbert operator {n_}: converged, λ rel {rel}, residual {resid}")
        else:
            check(bool(res.converged) and abs(int(res.rounds) - r64) <= 1 and rel <= 1e-5,
                  f"hilbert operator {n_}: rounds {int(res.rounds)}, λ rel {rel}")
        say(line)
        del mv, res

    # --- 6d. the bench's Kronecker and ELL rungs, and the PageRank operator ---
    for name, (solve, ok, extra) in operator_rungs(8192, dev).items():
        res = solve(torch.ones(8192, device=dev))
        say(f"operator rung {name} at 8192: rounds {int(res.rounds)}, λ {float(res.eigenvalue)!r}, "
            f"{extra or ''} check {ok(res)}")
        check(ok(res), f"operator rung {name}")
    # examples/pagerank.py's graph (its defaults: 2000 nodes, out-degree 5, seed 3)
    pn, pd, alpha = 2000, 5, 0.85
    prng = np.random.default_rng(3)
    src = np.repeat(np.arange(pn), pd)
    dst = np.concatenate([prng.choice(pn - 1, size=pd, replace=False) for _ in range(pn)])
    dst = np.where(dst >= src, dst + 1, dst)
    link = st.ell_matvec(*st.ell_from_coo(dst, src, np.full(len(src), alpha / pd), pn))
    ones = torch.ones(pn, 1, device=dev)
    google = st.add_matvec(link, st.low_rank_matvec(ones * ((1 - alpha) / pn), ones))
    pr = evt.max_eigenvalue_operator(google, pn)
    pr_tight = evt.max_eigenvalue_operator(google, pn, evt.SolverConfig(eps=1e-5))
    err, err_t = abs(float(pr.eigenvalue) - 1), abs(float(pr_tight.eigenvalue) - 1)
    say(f"pagerank operator ({pn} nodes): λ - 1 = {err:.3e} in {int(pr.rounds)} rounds at eps "
        f"1e-3 (examples/pagerank.py holds 2e-3); {err_t:.3e} in {int(pr_tight.rounds)} rounds "
        f"at eps 1e-5")
    check(bool(pr.converged) and err <= 2e-3 and bool(pr_tight.converged) and err_t <= 1e-4,
          "the pagerank operator's λ = 1")
    fft_launches = read_counts()
    say(f"matrix-free solves' launches (cuFFT, cuBLAS, cuSPARSE and gathers only): {fft_launches}")
    check(sum(fft_launches.values()) == 0, "a matrix-free solve launched a kernel of the port")

    # --- 6e. the traced solves and the spectral helpers ---
    mv = st.hilbert_matvec(8192)
    plain = solve_operator(mv, 8192, evt.EPS, evt.MAX_ITR)
    traced, hist = solve_operator_traced(mv, 8192, evt.EPS, evt.MAX_ITR)
    traced_d, hist_d = solve_matvec_traced(H, evt.EPS, evt.MAX_ITR)
    plain_d = solve_matvec(H, evt.EPS, evt.MAX_ITR)
    k = int(traced.rounds)
    rep = spectral.convergence_report(hist, k)
    pad = bool((hist[k:] == traced.eigenvalue).all() and (hist_d[int(traced_d.rounds):]
                                                           == traced_d.eigenvalue).all())
    say(f"traced solves at 8192: operator bit-identical {same(traced, plain)}, dense "
        f"{same(traced_d, plain_d)}, tails padded {pad}; rate {rep.rate:.4f} over "
        f"{rep.deltas_used} deltas, λ error estimate {rep.lam_error_estimate:.2e}")
    check(same(traced, plain) and same(traced_d, plain_d) and pad, "the traced solves")
    check(0 < rep.rate < 1, f"convergence rate {rep.rate}")
    H1 = mats[1024]
    w = np.sort(np.linalg.eigvalsh(H1.double().cpu().numpy()))[::-1]
    sub = spectral.subdominant_eigenpair(H1, dense[1024])
    top = spectral.top_k_eigenpairs(H1, dense[1024], k=3)
    G = top.eigenvectors.astype(np.float64)
    say(f"hilbert 1024 spectrum: λ₂ {sub.eigenvalue!r} (eigh {w[1]!r}, rel "
        f"{abs(sub.eigenvalue - w[1]) / w[1]:.2e}) in {sub.rounds} rounds, ratio {sub.ratio:.6f}; "
        f"top 3 {top.eigenvalues.tolist()} (eigh {w[:3].tolist()}), rounds {top.rounds.tolist()}, "
        f"residuals {top.residuals.tolist()}")
    check(sub.converged and abs(sub.eigenvalue - w[1]) <= 1e-3 * w[1]
          and abs(sub.ratio - w[1] / w[0]) <= 1e-3 * w[1] / w[0] and sub.residual <= 1e-3 * w[0],
          "subdominant_eigenpair of hilbert 1024")
    check(bool(np.all(top.converged)) and np.allclose(top.eigenvalues, w[:3], rtol=1e-3, atol=0)
          and np.allclose(top.ratios, w[:3] / w[0], rtol=1e-3, atol=0)
          and np.allclose(G.T @ G, np.eye(3), atol=2e-3)
          and bool(np.all(top.residuals <= 1e-3 * w[0])),
          "top_k_eigenpairs of hilbert 1024")

    # --- 6f. the operator suite at 8192 ---
    rows = bench_operator(dims=[8192])
    say(f"operator suite at 8192, card {card}:")
    say(_fmt_operator(rows))
    for row in rows:
        say("  " + json.dumps(row, allow_nan=False))
    check([r["backend"] for r in rows]
          == ["hankel_fft", "kron_64x128", "sparse_ell_deg9", "matvec"],
          "the operator suite's rungs")
    check(all(r["rounds_ok"] and r["device_ms"] for r in rows), "an operator row failed")
    torch.cuda.empty_cache()
    return op_launches


def np_digest(a) -> int:
    """The checkpoint digest in numpy's own uint32 arithmetic (wraparound),
    independent of the port's blockwise int64 form."""
    import numpy as np

    if a.dtype.itemsize == 8:
        bits = a.view(np.uint32).reshape(a.shape[0], -1)
    elif a.dtype.itemsize == 2:
        bits = a.view(np.uint16).astype(np.uint32)
    else:
        bits = a.view(np.uint32)
    rows, cols = bits.shape
    idx = (np.arange(rows, dtype=np.uint32)[:, None] * np.uint32(cols)
           + np.arange(cols, dtype=np.uint32)[None, :])
    mixed = (bits ^ (idx * np.uint32(2654435761))) * np.uint32(2246822519)
    return int(mixed.sum(dtype=np.uint32))


def interleaved_ms(fns: dict, reps: int) -> dict:
    """Median ms of each callable over ``reps`` turns, the arms in turn within
    each, every call between its own pair of CUDA events."""
    import torch

    for fn in fns.values():
        fn()
    ms = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ms[k].append(float(start.elapsed_time(end)))
    return {k: statistics.median(v) for k, v in ms.items()}


def wall_ms(fn):
    """``(result, host ms)`` of one call that ends in a synchronise."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def resumable_batched_autodiff_phase(dev, mats, same, reset_counts, read_counts,
                                     hilbert_rows, card) -> dict:
    """The resumable, batched and differentiable solves on the card.

    7a: ``checkpoint.solve_checkpointed`` on Hilbert 8192² at six chunkings,
    each bit for bit ``solve_multiround`` and ``solve_matvec_kernel`` with
    one ``multiround`` launch a step; a snapshot after one chunk, loaded and
    finished; the digest and eps rejections; the digest against numpy's;
    then Hilbert 65536² in bf16 stepped through the matvec kernel loop, bit
    for bit the bf16 ``solve_matvec_kernel``, under 9 GiB.  7b: BASELINE
    config 4 (256 random positive 512² f32 matrices) through
    ``max_eigenvalue_batch``, each matrix held to its own ``solve_matvec``,
    and the same batch in bf16, each bit for bit ``solve_matvec_kernel``,
    with no f32 copy.  7c: the four autodiff functions against float64
    oracles, and examples/autodiff.py's steps.  Returns the launch counts
    read around the phase's solves."""
    import tempfile

    import numpy as np
    import torch

    import eigen_value_tpu_torch as evt
    from eigen_value_tpu_torch import checkpoint as cp
    from eigen_value_tpu_torch.bench import batched_row, batched_workload
    from eigen_value_tpu_torch.ops import autodiff as ad
    from eigen_value_tpu_torch.ops.solver_matvec import (
        solve_matvec,
        solve_matvec_kernel,
        solve_multiround,
        solve_operator,
    )
    from eigen_value_tpu_torch.ops.structured import hankel_matvec, hilbert_matvec
    from eigen_value_tpu_torch.utils.timing import time_call

    EPS, MAX = evt.EPS, evt.MAX_ITR
    counts = {}

    def add(c: dict) -> None:
        for k, x in c.items():
            counts[k] = counts.get(k, 0) + x

    # --- 7a. checkpointed solves ---
    H = mats[8192]
    ref = solve_multiround(H, EPS, MAX)
    check(same(ref, solve_matvec_kernel(H, EPS, MAX)), "solve_multiround vs the matvec loop")
    rounds = int(ref.rounds)
    for k in (1, 4, 8, 17, 18, 1001):
        reset_counts()
        res = cp.solve_checkpointed(H, chunk_rounds=k)
        c = read_counts()
        add(c)
        steps = -(-(rounds + 1) // k)  # the last step finds the stop
        ok = same(res, ref) and bool(res.converged)
        say(f"checkpoint 8192² chunk {k}: rounds {int(res.rounds)}, bit-identical to "
            f"solve_multiround and solve_matvec_kernel {ok}; launches {c} ({steps} steps)")
        check(ok and int(res.rounds) == 17, f"checkpoint chunk {k}")
        check(c["multiround"] == steps and c["matvec"] == 1
              and sum(c.values()) == steps + 1, f"checkpoint chunk {k}: launches {c}")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "h8192.npz")
        reset_counts()
        first = cp.step(cp.init_state(H), 8)
        _, save_ms = wall_ms(lambda: cp.save_state(path, first, eps=EPS))
        loaded, load_ms = wall_ms(lambda: cp.load_state(path, device=dev))
        check(all(torch.equal(a, b) for a, b in zip(loaded, first)), "npz round trip")
        fresh = loaded
        while not bool(fresh.done) and int(fresh.rounds) < MAX:
            fresh = cp.step(fresh, 8)
        resumed = cp.solve_checkpointed(H, 8, checkpoint_path=path)
        add(read_counts())
        ok = same(cp.to_result(fresh), ref) and same(resumed, ref)
        say(f"checkpoint 8192²: saved after chunk 1 ({save_ms:.1f} ms), loaded ({load_ms:.1f} "
            f"ms), finished from the load and through solve_checkpointed: bit-identical {ok}")
        check(ok, "a resumed checkpoint")
        bad = H.clone()
        bad[4000, 3000] *= 1.5
        for what, call, words in (
                ("one interior entry changed", lambda: cp.solve_checkpointed(
                    bad, 8, checkpoint_path=path), "different matrix"),
                ("eps 1e-4", lambda: cp.solve_checkpointed(
                    H, 8, checkpoint_path=path, eps=1e-4), "eps=")):
            try:
                call()
                raised = ""
            except ValueError as e:
                raised = str(e)
            say(f"checkpoint resume with {what}: raised {words!r} {words in raised}")
            check(words in raised, f"checkpoint resume with {what}")
        del bad
    digest = int(cp._matrix_digest(H))
    want = np_digest(H.cpu().numpy())
    t_dig = time_call(lambda: cp._matrix_digest(H), reps=5).median_ms
    say(f"digest 8192² f32: {digest} (numpy {want}), {t_dig:.4f} ms")
    check(digest == want, "the digest against numpy's")
    t_ck = interleaved_ms({"checkpointed chunk 8": lambda: cp.solve_checkpointed(H, 8),
                           "solve_multiround": lambda: solve_multiround(H, EPS, MAX)}, reps=12)
    say(f"8192²: checkpointed solve at chunk 8 {t_ck['checkpointed chunk 8']:.4f} ms against "
        f"the one-launch solve {t_ck['solve_multiround']:.4f} ms (medians of 12, in turns; "
        f"{card})")

    torch.cuda.empty_cache()
    Hq = hilbert_rows(BIG_N, torch.bfloat16)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    state = cp.init_state(Hq)
    while not bool(state.done) and int(state.rounds) < MAX:
        state = cp.step(state, 8)
    c = read_counts()
    add(c)
    peak = (torch.cuda.max_memory_allocated(dev) - base + Hq.numel() * 2) / 2**30
    big = cp.to_result(state)
    ref_big = solve_matvec_kernel(Hq, EPS, MAX)
    ok = same(big, ref_big)
    say(f"checkpoint {BIG_N}² bf16 in chunks of 8: rounds {int(big.rounds)}, λ "
        f"{float(big.eigenvalue)!r}, bit-identical to solve_matvec_kernel {ok}; launches {c}; "
        f"peak memory {peak:.4f} GiB with the matrix")
    check(ok and bool(big.converged), f"checkpoint {BIG_N}² bf16")
    check(c["matvec"] == int(big.rounds) + 1 and sum(c.values()) == c["matvec"],
          f"checkpoint {BIG_N}² bf16 launches {c}")
    check(peak < 9.0, f"checkpoint {BIG_N}² bf16 peak {peak} GiB")
    t_dig_big = time_call(lambda: cp._matrix_digest(Hq), reps=3).median_ms
    say(f"digest {BIG_N}² bf16: {int(cp._matrix_digest(Hq))}, {t_dig_big:.4f} ms")
    del Hq, state
    torch.cuda.empty_cache()

    # --- 7b. batched: BASELINE config 4 ---
    As = batched_workload(256, 512, dev)
    reset_counts()
    res = evt.max_eigenvalue_batch(As)
    c = read_counts()
    check(sum(c.values()) == 0, f"the f32 batch launched a kernel of the port: {c}")
    worst = 0.0
    for b in range(256):
        one = solve_matvec(As[b], EPS, MAX)
        check(int(res.rounds[b]) == int(one.rounds), f"batch matrix {b}: rounds")
        worst = max(worst, abs(float(res.eigenvalue[b]) / float(one.eigenvalue) - 1))
    t_b = time_call(lambda: evt.max_eigenvalue_batch(As), reps=5).median_ms
    row = batched_row(As, res, t_b)
    say(f"batched 256 x 512² f32: all converged {row['all_converged']}, rounds "
        f"{row['rounds_hist']}, λ rel to each single solve ≤ {worst:.2e}, max |Av − λv|/λ "
        f"{row['max_rel_residual']:.2e}; {t_b:.4f} ms a batch, {row['solves_per_s']:.1f} "
        f"solves/s ({card})")
    check(row["rounds_ok"] and worst <= PARITY_REL, "the batched solve")
    Aq = As.to(torch.bfloat16)
    del As
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    resq = evt.max_eigenvalue_batch(Aq, evt.SolverConfig(storage_dtype=torch.bfloat16))
    c = read_counts()
    add(c)
    extra = (torch.cuda.max_memory_allocated(dev) - base) / 2**20
    ok = all(same(evt.SolveResult(*(x[b] for x in resq)), solve_matvec_kernel(Aq[b], EPS, MAX))
             for b in range(256))
    say(f"batched 256 x 512² bf16: bit-identical per matrix to solve_matvec_kernel {ok}; "
        f"launches {c} (256 + {int(resq.rounds.sum())} rounds); {extra:.2f} MiB above the "
        f"batch (an f32 copy would be 256 MiB)")
    check(ok and c["matvec"] == 256 + int(resq.rounds.sum())
          and sum(c.values()) == c["matvec"], "the bf16 batch")
    check(extra < 16, f"the bf16 batch allocated {extra} MiB")
    t_bq = time_call(lambda: evt.max_eigenvalue_batch(
        Aq, evt.SolverConfig(storage_dtype=torch.bfloat16)), reps=3).median_ms
    say(f"batched 256 x 512² bf16: {t_bq:.4f} ms a batch, {256e3 / t_bq:.1f} solves/s ({card})")
    del Aq
    torch.cuda.empty_cache()

    # --- 7c. autodiff ---
    reset_counts()
    gen = torch.Generator().manual_seed(SEED + 7)
    A = (torch.rand(1024, 1024, generator=gen) + 0.1).to(dev)

    def grad(fn, x):
        x = x.detach().clone().requires_grad_(True)
        out = fn(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (g,) = torch.autograd.grad(out, x)
        torch.cuda.synchronize()
        return g, (time.perf_counter() - t0) * 1e3

    W = A[:64, :64].clone()  # first calls: cuBLAS / cuSOLVER set up their handles
    _, warm_ms = wall_ms(lambda: (grad(ad.eigenvalue, W), grad(lambda M: ad.eigenpair(M)[1].sum(), W)))
    say(f"autodiff at 64², first calls (library set-up): {warm_ms:.1f} ms")
    lam, fwd_ms = wall_ms(lambda: ad.eigenvalue(A))
    g, bwd_ms = grad(ad.eigenvalue, A)
    a64 = A.double().cpu().numpy()
    w, V = np.linalg.eig(a64)
    wl, U = np.linalg.eig(a64.T)
    v, u = np.real(V[:, np.argmax(np.real(w))]), np.real(U[:, np.argmax(np.real(wl))])
    g64 = np.outer(u, v) / (u @ v)
    err = float(np.abs(g.double().cpu().numpy() - g64).max() / np.abs(g64).max())
    lam_err = abs(float(lam) / np.max(np.real(w)) - 1)
    say(f"eigenvalue at 1024²: λ rel {lam_err:.2e} to numpy.linalg.eig, gradient max err "
        f"{err:.2e} of its largest entry against u vᵀ/(uᵀv) in float64; forward "
        f"{fwd_ms:.2f} ms, backward {bwd_ms:.2f} ms")
    check(lam_err <= 1e-5 and err <= 1e-3, "the eigenvalue gradient")

    for n_ in (1024, 2048):
        B = (torch.rand(n_, n_, generator=gen) + 0.1).to(dev)
        v_bar = torch.randn(n_, generator=gen).to(dev)
        (lam_, v_), fwd_ms = wall_ms(lambda: ad.eigenpair(B))
        ej = ad._one_hot(v_)
        rhs = torch.cat([v_bar, torch.ones(1, device=dev)])
        tol = ad._tolerance(torch.float32, EPS)
        KT_mv = ad._bordered_matvec(lambda w: torch.mv(B.T, w), lam_, v_, ej)
        first = ad._gmres(KT_mv, rhs, tol, restart=min(n_ + 1, 100), maxiter=10)
        sol, resid = ad._solve_bordered(B, lam_, v_, ej, rhs, tol)
        # the fallback branch of this n, forced (GMRES given no restart)
        fb, fb_resid = ad._solve_bordered(B, lam_, v_, ej, rhs, tol, maxiter=0)
        KT = torch.zeros(n_ + 1, n_ + 1, dtype=torch.float64, device=dev)
        KT[:n_, :n_] = B.double().T - lam_.double() * torch.eye(n_, dtype=torch.float64,
                                                                device=dev)
        KT[:n_, n_] = ej.double()
        KT[n_, :n_] = -v_.double()
        want = torch.linalg.solve(KT, rhs.double())
        first_resid = float(torch.linalg.vector_norm(KT @ first.double() - rhs.double())
                            / torch.linalg.vector_norm(rhs.double()))
        werr = float((sol.double() - want).abs().max() / want.abs().max())
        fb_err = float((fb.double() - want).abs().max() / want.abs().max())
        resid64 = float(torch.linalg.vector_norm(KT @ sol.double() - rhs.double())
                        / torch.linalg.vector_norm(rhs.double()))
        bwd_ms = []
        for _ in range(2):  # the first call at a size, then again
            B_ = B.detach().clone().requires_grad_(True)
            l2, v2 = ad.eigenpair(B_)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (dB,) = torch.autograd.grad((l2, v2), B_, (torch.ones((), device=dev), v_bar))
            torch.cuda.synchronize()
            bwd_ms.append((time.perf_counter() - t0) * 1e3)
        dB_want = -torch.outer(want[:n_], v_.double())
        derr = float((dB.double() - dB_want).abs().max() / dB_want.abs().max())
        branch = ("GMRES" if first_resid <= 30 * tol else
                  "dense fallback" if n_ <= ad._DENSE_FALLBACK_MAX_N else "GMRES retry")
        say(f"eigenpair VJP at {n_}²: first GMRES residual {first_resid:.2e}, taken {branch}, "
            f"residual {resid:.2e} (in float64 {resid64:.2e}; bound {30 * tol:.1e}); w against "
            f"a float64 dense solve {werr:.2e}, Ā {derr:.2e} of its largest entry; forward "
            f"{fwd_ms:.2f} ms, backward {bwd_ms[0]:.2f} ms (again {bwd_ms[1]:.2f} ms); forced "
            f"{'dense fallback' if n_ <= ad._DENSE_FALLBACK_MAX_N else 'GMRES retry'}: "
            f"residual {fb_resid:.2e}, against the float64 solve {fb_err:.2e}")
        # the acceptance rule is the residual; the forward error can reach the
        # residual times K's condition, so the solution is held to 5e-2 of its
        # largest entry
        check(resid <= 30 * tol and resid64 <= 30 * tol and werr <= 5e-2 and derr <= 5e-2
              and fb_resid <= 30 * tol and fb_err <= 5e-2, f"eigenpair VJP at {n_}")
        del B, B_, KT

    n_ = 8192
    h = (torch.tensor(1.0) / torch.arange(1, 2 * n_, dtype=torch.float32)).to(dev)  # hilbert_matvec's
    lam_op = ad.eigenvalue_operator(lambda q: hankel_matvec(q, n_), n_)
    lam8, fwd_ms = wall_ms(lambda: lam_op(h))
    g8, bwd_ms = grad(lam_op, h)
    _, bwd2_ms = grad(lam_op, h)
    same_fwd = torch.equal(lam8, solve_operator(hilbert_matvec(n_, device=dev), n_, EPS, MAX,
                                                device=dev).eigenvalue)
    say(f"eigenvalue_operator on the Hankel (Hilbert) operator at {n_}: λ {float(lam8)!r} "
        f"(bit-identical to max_eigenvalue_operator {same_fwd}), gradient max "
        f"{float(g8.abs().max()):.4e}, finite {bool(torch.isfinite(g8).all())}; forward "
        f"{fwd_ms:.2f} ms, backward {bwd_ms:.2f} ms (the first torch.func call; again "
        f"{bwd2_ms:.2f} ms)")
    check(same_fwd and float(g8.abs().max()) > 0 and bool(torch.isfinite(g8).all()),
          "the Hankel operator gradient at 8192")
    n_ = 256
    h = torch.rand(2 * n_ - 1, generator=gen).to(dev) + 0.1
    g256, _ = grad(ad.eigenvalue_operator(lambda q: hankel_matvec(q, n_), n_), h)
    hd = h.double().cpu().numpy()
    Hd = hd[np.add.outer(np.arange(n_), np.arange(n_))]
    w, V = np.linalg.eigh(Hd)
    v = V[:, -1]  # symmetric: u = v
    gd = np.bincount(np.add.outer(np.arange(n_), np.arange(n_)).ravel(),
                     weights=np.outer(v, v).ravel() / (v @ v))
    err = float(np.abs(g256.double().cpu().numpy() - gd).max() / np.abs(gd).max())
    say(f"eigenvalue_operator at {n_}: gradient against the dense float64 adjoint {err:.2e} "
        f"of its largest entry")
    check(err <= 1e-3, "the Hankel operator gradient at 256")

    rng = np.random.default_rng(0)  # examples/autodiff.py, through the port
    A0 = torch.from_numpy(rng.random((64, 64), dtype=np.float32) + np.float32(0.1)).to(dev)
    logA = torch.log(A0)
    lam0 = float(ad.eigenvalue(A0))
    for _ in range(60):
        gl, _ = grad(lambda L: (ad.eigenvalue(torch.exp(L)) - 40.0) ** 2, logA)
        logA = logA - 0.5 * gl
    lam1 = float(ad.eigenvalue(torch.exp(logA)))
    A0_ = A0.clone().requires_grad_(True)
    lp, vp = ad.eigenpair(A0_)
    cot = torch.zeros(64, device=dev)
    cot[0] = 1.0
    (dA,) = torch.autograd.grad((lp, vp), A0_, (torch.zeros((), device=dev), cot))
    say(f"examples/autodiff.py through the port: λ {lam0:.3f} → {lam1:.3f} (target 40); "
        f"∂v[0]/∂A max |sensitivity| {float(dA.abs().max()):.2e}")
    check(abs(lam1 - 40.0) < 0.5 and bool(torch.isfinite(dA).all()), "the autodiff example")
    c = read_counts()
    say(f"autodiff launches: {c} (torch.mv and the FFTs: no kernel of the port)")
    check(sum(c.values()) == 0, "autodiff launched a kernel of the port")
    torch.cuda.empty_cache()
    return counts


def mesh_phase(dev, mats, reset_counts, read_counts, card) -> dict:
    """The sharded solves on a one-rank NCCL group on this card (step 8).

    8a: ``kernels.matvec`` on the column blocks of Hilbert 8192² at every
    chunk position of P = 2, 4, 8, in f32 and bf16: bit for bit the kernel on
    ``.contiguous()``, within PLAIN_TOL of a float64 product; views whose
    rows are not aligned raise.  8b (launch counters read around exactly
    these calls): ``max_eigenvalue(H, mesh=make_row_mesh(1))`` through
    "auto", the ring on the same mesh, the 2-D solve on a 1 × 1 mesh and the
    bf16 storage solve through the door, each bit for bit the single-card
    matvec kernel loop with rounds + 1 ``matvec`` launches; ``solve_sharded``
    bit for bit the single-card ``backend="xla"``; BASELINE config 4 through
    ``max_eigenvalue_batch`` on a ``batch`` and a ``batch × rows`` mesh, bit
    for bit the unsharded batch.  8c: ``bench/mh_worker.py`` as a process of
    its own (one rank: ``initialize``, ``assemble_rowsharded``,
    ``solve_multihost``, the ring, 2-D, iterated and batched solves) at
    8192², and, where the host has two cards, a 2-process NCCL group.  8d:
    the host µs of each exchange of a round alone, and ms per solve of the
    P = 1 mesh solves beside the single-card loop, interleaved.  Returns the launch counts of 8b, the largest difference of
    a view's product from the plain version's, and the times."""
    import torch
    import torch.distributed as dist

    import eigen_value_tpu_torch as evt
    from eigen_value_tpu_torch.bench import batched_workload, run_mh_workers
    from eigen_value_tpu_torch.bench.suite import exchange_times
    from eigen_value_tpu_torch.ops.cuda import kernels
    from eigen_value_tpu_torch.ops.solver_matvec import solve_matvec_kernel
    from eigen_value_tpu_torch.parallel import (
        make_mesh2d,
        make_row_mesh,
        solve_sharded,
        solve_sharded_2d,
        solve_sharded_matvec,
        solve_sharded_matvec_ring,
    )

    EPS, MAX = evt.EPS, evt.MAX_ITR
    n = 8192
    H = mats[n]
    Hq = H.to(torch.bfloat16)

    def local(res):
        return [x.to_local() if hasattr(x, "to_local") else x for x in res]

    def bits(got, want) -> bool:
        return all(torch.equal(g, w) for g, w in zip(local(got), want))

    # --- 8a. the leading dimension ---
    gen = torch.Generator().manual_seed(SEED + 8)
    strided_err, views = 0.0, 0
    for A in (H, Hq):
        for parts in (2, 4, 8):
            w = n // parts
            x = (torch.rand(w, generator=gen) + 0.5).to(dev)
            for s in range(parts):
                view = A[:, s * w:(s + 1) * w]
                got = kernels.matvec(view, x)
                ok = torch.equal(got, kernels.matvec(view.contiguous(), x))
                exact = f64_matvec(view, x)
                rel = float(((got.double() - exact).abs() / exact.abs()).max())
                check(ok and rel <= PLAIN_TOL, f"matvec on a {A.dtype} column view {s}/{parts}: "
                      f"bit-identical {ok}, rel err {rel}")
                strided_err = max(strided_err,
                                  float((got - kernels.matvec_plain(view, x)).abs().max()))
                views += 1
    for bad, what in ((torch.ones(64, 65, device=dev)[:, :64], "rows 65 elements apart"),
                      (torch.ones(64, 72, device=dev)[:, 1:65], "a base 4 bytes off")):
        try:
            kernels.matvec(bad, torch.ones(64, device=dev))
        except ValueError:
            continue
        raise SystemExit(f"FAILED: matvec took a view with {what}")
    say(f"matvec on {views} column-block views of Hilbert {n}² (P = 2, 4, 8; f32 and bf16): "
        f"each bit-identical to the kernel on .contiguous(), rel err to float64 ≤ {PLAIN_TOL}; "
        f"max |kernel - plain| {strided_err:.3e}; misaligned views raise")

    # --- 8b. the mesh path, one rank of NCCL on this card ---
    rows = make_row_mesh(1)
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1, "a one-rank NCCL group")
    mesh2d = make_mesh2d(1, 1)
    batch = make_row_mesh(1, "batch")
    batch_rows = make_mesh2d(1, 1, "batch", "rows")
    bf16 = evt.SolverConfig(storage_dtype=torch.bfloat16)
    As = batched_workload(256, 512, dev)
    want = solve_matvec_kernel(H, EPS, MAX)
    want_q = solve_matvec_kernel(H, EPS, MAX, storage_dtype=torch.bfloat16)
    want_xla = evt.max_eigenvalue(H, evt.SolverConfig(backend="xla"))
    want_b = evt.max_eigenvalue_batch(As)
    solve_sharded_matvec(mats[128], rows)  # NCCL sets up its communicator here
    solve_sharded_matvec_ring(mats[128], rows)
    solve_sharded_2d(mats[128], mesh2d)
    cases = {
        "max_eigenvalue(H, mesh=make_row_mesh(1))":
            (lambda: evt.max_eigenvalue(H, mesh=rows), want),
        "solve_sharded_matvec_ring": (lambda: solve_sharded_matvec_ring(H, rows), want),
        "solve_sharded_2d on 1 x 1": (lambda: solve_sharded_2d(H, mesh2d), want),
        "max_eigenvalue(H, bf16 storage, mesh=)":
            (lambda: evt.max_eigenvalue(H, bf16, mesh=rows), want_q),
        "solve_sharded (the xla body)": (lambda: solve_sharded(H, rows), want_xla),
        "max_eigenvalue_batch(config 4, batch mesh)":
            (lambda: evt.max_eigenvalue_batch(As, mesh=batch), want_b),
        "max_eigenvalue_batch(config 4, batch x rows mesh)":
            (lambda: evt.max_eigenvalue_batch(As, mesh=batch_rows), want_b),
    }
    total = {}
    for name, (fn, ref) in cases.items():
        reset_counts()
        got = fn()
        c = read_counts()
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
        ok = bits(got, ref)
        rounds = local(got)[2]
        if rounds.dim():
            r = f"rounds {dict(zip(*[t.tolist() for t in rounds.unique(return_counts=True)]))}"
        else:
            r = f"rounds {int(rounds)}"
        say(f"mesh {name}: {r}, bit-identical to the single-card solve {ok}; launches "
            f"{ {k: v for k, v in c.items() if v} }")
        check(ok, f"mesh {name} differs from the single-card solve")
        matvec_runs = name.startswith(("max_eigenvalue(H", "solve_sharded_matvec", "solve_sharded_2d"))
        want_mv = int(ref.rounds) + 1 if matvec_runs else 0
        check(c["matvec"] == want_mv and sum(c.values()) == c["matvec"],
              f"mesh {name}: launches {c}, expected {want_mv} matvec")
    check(int(want.rounds) == 17, "Hilbert 8192² rounds")
    say(f"mesh path launches: {total}")

    # --- 8c. the multi-host worker ---
    def workers(nprocs: int, solvers) -> list:
        try:
            return run_mh_workers(nprocs, n, 3, solvers, timeout_s=300)
        except RuntimeError as e:
            raise SystemExit(f"FAILED: {e}")

    lam64 = None
    mh = workers(1, ["gather", "ring", "2d", "iterated", "batched"])[0]
    for solver, r in mh["results"].items():
        say(f"mh_worker, 1 process on {mh['card']}, {solver}: mesh {r['mesh']}, rounds "
            f"{r['rounds']}, λ {r['eigenvalue']!r}, residual {r['residual']:.3e}, "
            f"{r['ms']:.4f} ms (least of 3), {r['elems_per_s']:.4e} elements/s")
        check(r["converged"] and r["rounds"] == 17 and r["residual"] < 1e-3,
              f"mh_worker {solver}")
        lam64 = lam64 or r["eigenvalue"]
        check(abs(r["eigenvalue"] - lam64) <= 1e-5 * lam64, f"mh_worker {solver} λ")
    if torch.cuda.device_count() >= 2:
        two = workers(2, ["gather", "ring", "2d"])
        for solver in ("gather", "ring", "2d"):
            lams = {o["results"][solver]["eigenvalue"] for o in two}
            r = two[0]["results"][solver]
            say(f"mh_worker, 2 processes of NCCL on 2 cards, {solver}: rounds {r['rounds']}, "
                f"λ {r['eigenvalue']!r}, {r['ms']:.4f} ms")
            check(len(lams) == 1 and r["rounds"] == 17 and r["residual"] < 1e-3,
                  f"2-process {solver}")
    else:
        say(f"mh_worker with 2 processes of NCCL: not run, this host has "
            f"{torch.cuda.device_count()} card")

    # --- 8d. what a world of one adds to a solve ---
    # each exchange of a round alone, with the round's read (bench.suite.exchange_times)
    exch_us = exchange_times(rows.get_group("rows"), n, dev)
    say(f"exchanges alone, 1 rank of NCCL on 1 card ({card}; host µs a call with the read, "
        f"median of 15 blocks of 40): " + json.dumps({k: round(v, 2) for k, v in exch_us.items()}))
    arms = {
        "matvec kernel loop (single card)": lambda: solve_matvec_kernel(H, EPS, MAX),
        "gathered mesh solve, 1 rank": lambda: solve_sharded_matvec(H, rows),
        "ring mesh solve, 1 rank": lambda: solve_sharded_matvec_ring(H, rows),
        "2-D mesh solve, 1 x 1": lambda: solve_sharded_2d(H, mesh2d),
    }
    ms = interleaved_ms(arms, reps=20)
    base = ms["matvec kernel loop (single card)"]
    passes = int(want.rounds) + 1
    added = {k: (v - base) / passes * 1e3 for k, v in ms.items()}
    say(f"mesh times at {n}², 1 rank of NCCL on 1 card ({card}; median of 20 interleaved "
        f"solves, ms): " + json.dumps({k: round(v, 4) for k, v in ms.items()})
        + f"; µs a round added to the loop ({passes} products): "
        + json.dumps({k: round(v, 2) for k, v in added.items() if v != 0.0}))
    dist.destroy_process_group()
    return {"launches": total, "strided_max_abs_err": strided_err, "views": views, "ms": ms,
            "added_us_per_round": added, "exchange_us": exch_us}


#: The keys of the root bench.py's record (its ``summarize``, with suspect
#: windows): the port's headline keeps each of them.
JAX_RECORD_KEYS = ("metric", "value", "unit", "vs_baseline", "wall_chain_ms", "wall_single_ms",
                   "chain", "rounds", "backend", "windows_ms", "median_ms", "floor_ms",
                   "traffic_frac", "cache_tiles", "compute_bound")
#: What tests/test_examples.py reads in the JAX examples' output, by example.
EXAMPLE_LINES = {
    "quickstart": ("round(s)", "functional: λ", "bf16 fast mode"),
    "matrix_free": ("operator solve (FFT Hankel", "matches dense within 1e-3",
                    "convergence: rate", "f64 polish: λ"),
    "pagerank": ("exact answer: λ = 1", "dense cross-check", "top-5 nodes:"),
    "autodiff": ("target 40.0", "∂v[0]/∂A"),
    "distributed": ("sharded (1 devices)", "rounds = 13 (expect 13)", "ring:", "checkpointed"),
    "large_scale": ("32768² Hilbert (float32)", "65536² Hilbert (bf16 storage)"),
    "serving": ("served solve", "rounds = 13", "residual check passed"),
}


def tools_phase(dev, here, reset_counts, read_counts, card) -> dict:
    """The headline and the tools (step 9).

    9a: ``python -m eigen_value_tpu_torch.bench.headline`` in a process of
    its own at 8192² with 3 windows a second apart: its last line is the
    record (printed here on a line of its own), held to 17 rounds on the
    cached triangle, every window at or above ``floor_ms``, the root
    bench.py's keys, ``call_ms``, the card from ``nvidia-smi``, the four
    secondaries and the Hankel operator's rounds; the record's ``launches``
    are the kernels that process ran.  Then, with the launch counters read
    around exactly these calls: 9b the bench suites ``large`` (λ against a
    float64 loop, rounds against the port's table), ``drift`` (3 windows a
    second apart), ``calibrate`` (gloo groups of 2 and 4 CPU processes),
    ``model`` and ``native`` (128…1024) through the CLI's code; 9c every
    ported example's ``main()`` on the card, its lines held to what
    tests/test_examples.py reads; 9d one symmetric solve under
    ``utils.profiling.trace``, whose chrome trace must hold the triangle
    kernel's device time.  Returns the counts, the headline's added in."""
    import contextlib
    import importlib
    import io
    import tempfile

    import torch

    import eigen_value_tpu_torch as evt
    from eigen_value_tpu_torch import fixtures
    from eigen_value_tpu_torch.bench import suite
    from eigen_value_tpu_torch.bench.__main__ import (
        _fmt_calibrate,
        _fmt_drift,
        _fmt_large,
        _fmt_native,
    )
    from eigen_value_tpu_torch.bench.__main__ import main as cli_main
    from eigen_value_tpu_torch.examples import EXAMPLES
    from eigen_value_tpu_torch.utils import profiling

    # --- 9a. the headline, a process of its own ---
    t0 = time.perf_counter()
    env = dict(os.environ, BENCH_WINDOWS="3", BENCH_WINDOW_GAP_S="1")
    env.pop("BENCH_DIM", None)
    env.pop("BENCH_DEVICE", None)
    proc = subprocess.run([sys.executable, "-m", "eigen_value_tpu_torch.bench.headline"],
                          cwd=here, env=env, capture_output=True, text=True, timeout=900)
    for line in proc.stderr.splitlines()[-12:]:
        say("  headline:", line)
    check(proc.returncode == 0, f"the headline exited {proc.returncode}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    say(json.dumps(rec, allow_nan=False))
    missing = [k for k in JAX_RECORD_KEYS + ("call_ms", "call_ms_min", "device", "clocks",
                                             "bf16_ms", "dense_f32_ms", "sym_stream_ms",
                                             "hankel_fft_ms", "hankel_fft_rounds", "launches")
               if k not in rec]
    check(not missing, f"the headline record lacks {missing}")
    check(rec["metric"] == "hilbert_8192_e2e_device" and rec["rounds"] == 17
          and rec["backend"] == "multiround_sym_cached_pallas",
          f"headline: {rec['metric']}, {rec['rounds']} rounds, {rec['backend']}")
    check(rec["value"] >= rec["floor_ms"] and all(w >= rec["floor_ms"] for w in rec["windows_ms"])
          and not rec.get("suspect"), "a headline window below the physical floor")
    check(rec["hankel_fft_rounds"] == rec["rounds"], "the Hankel operator's rounds")
    check(all(rec[k] > 0 for k in ("bf16_ms", "dense_f32_ms", "sym_stream_ms", "hankel_fft_ms",
                                   "call_ms")), "a headline time is not positive")
    check(rec["device"]["name"] in card and rec["device"]["power_limit_w"] is not None,
          f"the headline's card {rec['device']} against nvidia-smi's {card}")
    check(rec["launches"]["multiround_sym"] > 0 and rec["launches"]["multiround"] > 0,
          f"the headline's launches {rec['launches']}")
    say(f"headline: {time.perf_counter() - t0:.1f} s in its own process")

    reset_counts()
    # --- 9b. the bench suites ---
    t0 = time.perf_counter()
    large = suite.bench_large()
    say(_fmt_large(large))
    for r in large:
        say(json.dumps(r, allow_nan=False))
        check("error" not in r, f"large {r['backend']}: {r.get('error')}")
        check("skipped" in r or r["rounds_ok"], f"large {r['backend']}: rounds or λ")
    by_name = {r["backend"]: r for r in large}
    big = by_name["bf16_65536"]
    check(big["rounds"] == 21 and big["rel_err"] <= 1e-5,
          f"large bf16_65536: {big['rounds']} rounds, rel {big['rel_err']}")
    check("skipped" in by_name["sym_bf16_65536"] and "skipped" not in by_name["sym_f32_32768"],
          "the large rows' routes")
    drift = suite.bench_drift(dim=8192, windows=3, gap_s=1.0)
    say(_fmt_drift(drift))
    say(json.dumps(drift[-1], allow_nan=False))
    check(len(drift) == 4 and not any(r.get("suspect") for r in drift[:-1])
          and all(r["sm_mhz"] is not None for r in drift[:-1]), "the drift windows")
    calib = suite.bench_exchange_calibration(dim=8192, reps=3)
    say(_fmt_calibrate(calib))
    check(any(r["bench"] == "model_calibration_fit" for r in calib)
          and all(r["measured_us"] > 0 for r in calib if "measured_us" in r), "the calibration")
    native = suite.bench_native([128, 256, 512, 1024])
    say(_fmt_native(native))
    check(native and all(r["rounds_ok"] for r in native if r["bench"] == "native"),
          "the native runtime's rows")
    for args in (["--suite", "model"], ["--suite", "model", "--json"]):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            check(cli_main(args) == 0, f"cli {args}")
        text = out.getvalue()
        if "--json" in args:
            rows = [json.loads(line) for line in text.splitlines()]
            check(len(rows) > 50 and any(r["efficiency"] is None for r in rows), "model --json")
        else:
            say("\n".join(text.splitlines()[:12]))
    say(f"suites: {time.perf_counter() - t0:.1f} s")

    # --- 9c. the examples on the card ---
    for name in EXAMPLES:
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            importlib.import_module(f"eigen_value_tpu_torch.examples.{name}").main()
        text = out.getvalue()
        say(f"example {name} ({time.perf_counter() - t0:.1f} s):")
        say("\n".join("  " + line for line in text.splitlines()))
        lost = [want for want in EXAMPLE_LINES[name] if want not in text]
        check(not lost, f"example {name} did not print {lost}")

    # --- 9d. a solve under the profiler ---
    H = fixtures.hilbert_matrix(8192, device=dev)
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d):
            with profiling.annotate("headline solve"):
                res = evt.max_eigenvalue(H, evt.SolverConfig(symmetric=True))
        with open(os.path.join(d, profiling.TRACE_FILE)) as f:
            events = json.load(f)["traceEvents"]
    kernel_us = sum(e.get("dur", 0) for e in events
                    if e.get("cat") == "kernel" and "multiround_sym_kernel" in e.get("name", ""))
    annotated = any(e.get("name") == "headline solve" for e in events)
    say(f"profiled solve: rounds {int(res.rounds)}, multiround_sym_kernel {kernel_us:.1f} µs of "
        f"device time in its chrome trace, annotation {annotated}; memory stats "
        f"{len(profiling.device_memory_stats())} keys")
    check(int(res.rounds) == 17 and kernel_us > 0 and annotated, "the profiled solve")
    del H
    torch.cuda.empty_cache()
    counts = read_counts()
    say(f"tools path launches (in this process): {counts}; the headline's process: "
        f"{rec['launches']}")
    for name in ("matvec", "multiround", "multiround_sym"):
        check(counts[name] > 0, f"the tools path launched no {name}")
    return {"launches": {k: c + rec["launches"].get(k, 0) for k, c in counts.items()},
            "headline": rec}



def dot_phase(dev, mats, same, reset_counts, read_counts, card) -> dict:
    """The dot formulation of the two persistent kernels (step 10).  Returns
    the numbers of their records: launches on the main path, the max abs
    error against the plain version, and the times."""
    import torch

    import eigen_value_tpu_torch as evt
    from eigen_value_tpu_torch import fixtures
    from eigen_value_tpu_torch.device import sym_auto_cache_tiles
    from eigen_value_tpu_torch.ops.cuda import build, kernels
    from eigen_value_tpu_torch.ops.solver_matvec import solve_matvec, solve_multiround
    from eigen_value_tpu_torch.utils.timing import time_call

    n, bt = 8192, kernels.SYM_TILE
    H = mats[n]
    bf16 = torch.bfloat16

    # --- 10a. the kernels' split (integer rounding) and cvt.rna are
    # kernels.tf32_split, bit for bit ---
    gen = torch.Generator().manual_seed(SEED + 13)
    bits = torch.randint(0, 1 << 16, (1 << 20, 2), generator=gen, dtype=torch.int32)
    words = (bits[:, 0] << 16) | bits[:, 1]
    picked = torch.tensor([0x3F801000, -0x407FF000, 0x3F800FFF, 0x3F803000, 0x00001000,
                           0x00000FFF, 0x007FFFFF, 0x00800000, 0x3F810000], dtype=torch.int32)
    x = torch.cat([picked, words]).view(torch.float32)
    x = x[torch.isfinite(x) & (x.abs() < 3.4e38)]
    # ±0, subnormals and the largest finite values
    edge = torch.tensor([0x00000000, 0x80000000, 0x00000001, 0x80000001, 0x807FF000, 0x807FFFFF,
                         0x7F7FEFFF, 0x7F7FF000, 0xFF7FF000, 0x7F7FFFFF, 0xFF7FFFFF],
                        dtype=torch.int64).to(torch.int32).view(torch.float32)
    x = torch.cat([x, edge]).contiguous()
    xd = x.to(dev)
    want_big, want_small = kernels.tf32_split(x)
    for cvt, what in ((0, "the kernels' integer rounding"), (1, "cvt.rna")):
        big = torch.empty(x.numel(), dtype=torch.int32, device=dev)
        small = torch.empty_like(big)
        check(build.load().evt_tf32_split(xd.data_ptr(), big.data_ptr(), small.data_ptr(),
                                          x.numel(), cvt,
                                          torch.cuda.current_stream().cuda_stream) == 0,
              "evt_tf32_split launch")
        ok = (torch.equal(big.cpu(), want_big.view(torch.int32))
              and torch.equal(small.cpu(), want_small.view(torch.int32)))
        say(f"{what} on the card against kernels.tf32_split, {x.numel()} values: "
            f"bit-identical {ok}")
        check(ok, f"kernels.tf32_split is not the card's {what}")

    # --- 10b. one launch of each dot kernel against its plain version ---
    auto = sym_auto_cache_tiles(n, bt, dev)
    auto_dense = sym_auto_cache_tiles(n, bt, dev, sym=False)
    auto_q = sym_auto_cache_tiles(n, bt, dev, itemsize=2, ring=False)
    x1 = torch.ones(n, device=dev)
    z = torch.zeros((), device=dev)
    err = {}
    one = [("multiround", kernels.multiround, kernels.multiround_plain, {}, "asymmetric"),
           ("multiround_sym", kernels.multiround_sym, kernels.multiround_sym_plain,
            dict(cache_tiles=auto), "symmetric"),
           ("multiround_sym dense", kernels.multiround_sym, kernels.multiround_sym_plain,
            dict(cache_tiles=auto_dense, sym=False), "asymmetric")]
    # Hilbert, and Hilbert scaled at random so that it is not Hankel: every
    # 16 x 16 piece of a Hilbert tile is symmetric, so a row / column mix-up
    # in the fragments would not show on it.  The triangle's scaling is
    # symmetric.
    R = 1 + 0.25 * torch.rand(n, n, device=dev,
                              generator=torch.Generator(device=dev).manual_seed(SEED + 14))
    scaled = {"asymmetric": H * R, "symmetric": H * ((R + R.T) / 2)}
    del R
    for name, run, plain, kw, scaling in one:
        worst = 0.0
        for label, A in (("Hilbert", H), (f"{scaling}ally scaled", scaled[scaling])):
            state = (x1, x1, z)
            for init in (True, False):
                a = dict(chunk=5, eps=evt.EPS, init=init, formulation="dot", **kw)
                got = run(A, *state, evt.MAX_ITR, **a)
                want = plain(A, *state, evt.MAX_ITR, **a)
                torch.cuda.synchronize()
                check(int(got[2]) == int(want[2]), f"{name}[dot] {label} init={init}: advanced "
                      f"{int(got[2])} != {int(want[2])}")
                rel = max(float(((g - w).abs() / w.abs()).max())
                          for g, w in ((got[0], want[0]), (got[1], want[1]), (got[3], want[3])))
                e_v = float((got[1] - want[1]).abs().max())
                e_ev = float((got[0] - want[0]).abs().max())
                say(f"{name}[dot] {label} {n}² chunk 5 init={init}: advanced {int(got[2])}, max "
                    f"rel diff (ev, v, λ) to the plain version {rel:.3e}, max |v - plain| "
                    f"{e_v:.3e}, max |ev - plain| {e_ev:.3e}")
                check(rel <= PARITY_REL,
                      f"{name}[dot] {label} init={init}: rel diff {rel} > {PARITY_REL}")
                worst = max(worst, e_v, e_ev)
                state = (got[0], got[1], got[3])
        err[name] = worst
    del scaled

    # --- 10c. the main path: the dot solves, launches counted ---
    arms = {
        "stripes": (H, {}),
        "triangle, no cache": (H, dict(symmetric=True, cache_tiles=0)),
        f"triangle, auto cache {auto}": (H, dict(symmetric=True, cache_tiles=auto)),
        f"dense tiled, auto cache {auto_dense}": (H, dict(cache_tiles=auto_dense)),
        "stripes, storage bf16": (H, dict(storage_dtype=bf16)),
        f"triangle, storage bf16, auto cache {auto_q}": (
            H, dict(symmetric=True, cache_tiles=auto_q, storage_dtype=bf16)),
    }
    auto_q_vpu = sym_auto_cache_tiles(n, bt, dev, itemsize=2)  # beside the vpu ring
    refs, oracle = {}, {}
    for k, (A, kw) in arms.items():  # "vpu", whose results no cache changes
        vkw = dict(kw, cache_tiles=min(kw.get("cache_tiles", 0), auto_q_vpu)) if (
            "storage_dtype" in kw and "cache_tiles" in kw) else kw
        refs[k] = solve_multiround(A, evt.EPS, evt.MAX_ITR, **vkw)
    oracle[torch.float32] = solve_matvec(H.double(), evt.EPS, evt.MAX_ITR)
    oracle[bf16] = solve_matvec(H.to(bf16).double(), evt.EPS, evt.MAX_ITR)
    table = {m: fixtures.hilbert_matrix(m, device=dev) for m in sorted(fixtures.HILBERT_ROUNDS)
             if m != n}
    table[n] = H
    reset_counts()
    runs = {k: solve_multiround(A, evt.EPS, evt.MAX_ITR, formulation="dot", **kw)
            for k, (A, kw) in arms.items()}
    table_runs = {(m, kind): solve_multiround(M, evt.EPS, evt.MAX_ITR, formulation="dot",
                                              symmetric=kind == "triangle")
                  for m, M in table.items() for kind in ("stripes", "triangle")}
    launches = read_counts()
    say(f"dot path launches: {launches}")
    check(launches["multiround"] > 0 and launches["multiround_sym"] > 0,
          "the dot path launched no multiround or multiround_sym kernel")
    check(sum(launches.values()) == launches["multiround"] + launches["multiround_sym"],
          "the dot path launched another kernel")
    for k, (A, kw) in arms.items():
        res, ref = runs[k], refs[k]
        dt = kw.get("storage_dtype", torch.float32)
        A_s = A.to(dt) if dt != torch.float32 else A
        v = res.eigenvector.double()
        resid = float((f64_matvec(A_s, v) - res.eigenvalue.double() * v).abs().max())
        lam, lam_64, lam_v = (float(res.eigenvalue), float(oracle[dt].eigenvalue),
                              float(ref.eigenvalue))
        rel_64, rel_v = abs(lam - lam_64) / lam_64, abs(lam - lam_v) / lam_v
        say(f"hilbert {n} dot, {k}: rounds {int(res.rounds)} (vpu {int(ref.rounds)}, float64 "
            f"loop {int(oracle[dt].rounds)}), λ {lam!r} (float64 loop {lam_64!r}, rel "
            f"{rel_64:.2e}; vpu {lam_v!r}, rel {rel_v:.2e}), residual {resid:.3e}")
        check(bool(res.converged) and int(res.rounds) == 17, f"dot {k}: rounds {int(res.rounds)}")
        check(int(res.rounds) == int(ref.rounds), f"dot {k}: rounds differ from vpu's")
        check(rel_64 <= PARITY_REL and rel_v <= PARITY_REL, f"dot {k}: λ rel {rel_64}, {rel_v}")
        check(resid <= 1e-3, f"dot {k}: residual {resid}")
        check(bool(torch.isfinite(res.eigenvector).all()), f"dot {k}: eigenvector not finite")
    for (m, kind), res in table_runs.items():
        check(bool(res.converged) and int(res.rounds) == fixtures.HILBERT_ROUNDS[m],
              f"dot {kind} hilbert {m}: rounds {int(res.rounds)}")
    say("dot Hilbert table, stripes / triangle: " + ", ".join(
        f"{m}: {int(table_runs[(m, 'stripes')].rounds)} / {int(table_runs[(m, 'triangle')].rounds)}"
        for m in table))

    # --- 10d. bit identities ---
    base = runs["stripes"]
    for chunk in (1, 5, None):
        ok = same(solve_multiround(H, evt.EPS, evt.MAX_ITR, chunk=chunk, formulation="dot"), base)
        say(f"dot stripes chunk={chunk or 'whole budget'} at {n}²: bit-identical {ok}")
        check(ok, f"dot stripes chunk={chunk} changed the result")
    tri = runs["triangle, no cache"]
    for c in (7, auto):
        for chunk in (1, 5, None):
            ok = same(solve_multiround(H, evt.EPS, evt.MAX_ITR, chunk=chunk, symmetric=True,
                                       cache_tiles=c, formulation="dot"), tri)
            say(f"dot triangle cache {c} chunk={chunk or 'whole budget'} at {n}² vs cache 0: "
                f"bit-identical {ok}")
            check(ok, f"dot triangle cache {c} chunk={chunk} changed the result")
    H_q = H.to(bf16)
    # each at its own auto cache (the f32 tiles take twice the room; no cache
    # changes the bits).  A 2-byte A skips its split and the a_small product,
    # which the f32 launch on A_q.float() takes (its small parts are 0)
    for dq in (bf16, torch.float16):
        A_q = H.to(dq)
        for k, kw_q, kw_f in (("stripes", {}, {}),
                              ("triangle", dict(symmetric=True, cache_tiles=auto_q),
                               dict(symmetric=True, cache_tiles=auto)),
                              ("dense tiled", dict(cache_tiles=auto_q),
                               dict(cache_tiles=auto_dense))):
            ok = same(solve_multiround(A_q, evt.EPS, evt.MAX_ITR, formulation="dot", **kw_q),
                      solve_multiround(A_q.float(), evt.EPS, evt.MAX_ITR, formulation="dot",
                                       **kw_f))
            say(f"dot {k} on A_q ({dq}) vs A_q.float(): bit-identical {ok}")
            check(ok, f"dot {k}: A_q ({dq}) differs from A_q.float()")
        del A_q
    H_h = H.to(torch.float16)

    # --- 10e. times: whole-budget launches, each dot instance beside its vpu one ---
    whole = dict(chunk=evt.MAX_ITR + 1, eps=evt.EPS, init=True)
    timed = {
        "multiround vpu": lambda: kernels.multiround(H, x1, x1, z, evt.MAX_ITR, **whole),
        "multiround dot": lambda: kernels.multiround(H, x1, x1, z, evt.MAX_ITR,
                                                     formulation="dot", **whole),
        "multiround_sym vpu": lambda: kernels.multiround_sym(H, x1, x1, z, evt.MAX_ITR,
                                                             cache_tiles=auto, **whole),
        "multiround_sym dot": lambda: kernels.multiround_sym(H, x1, x1, z, evt.MAX_ITR,
                                                             cache_tiles=auto,
                                                             formulation="dot", **whole),
        "multiround bf16 vpu": lambda: kernels.multiround(H_q, x1, x1, z, evt.MAX_ITR, **whole),
        "multiround bf16 dot": lambda: kernels.multiround(H_q, x1, x1, z, evt.MAX_ITR,
                                                          formulation="dot", **whole),
        "multiround_sym bf16 vpu": lambda: kernels.multiround_sym(
            H_q, x1, x1, z, evt.MAX_ITR, cache_tiles=auto_q_vpu, **whole),
        "multiround_sym bf16 dot": lambda: kernels.multiround_sym(
            H_q, x1, x1, z, evt.MAX_ITR, cache_tiles=auto_q, formulation="dot", **whole),
        "multiround f16 dot": lambda: kernels.multiround(H_h, x1, x1, z, evt.MAX_ITR,
                                                         formulation="dot", **whole),
        "multiround_sym f16 dot": lambda: kernels.multiround_sym(
            H_h, x1, x1, z, evt.MAX_ITR, cache_tiles=auto_q, formulation="dot", **whole),
        "dense tiled vpu": lambda: kernels.multiround_sym(H, x1, x1, z, evt.MAX_ITR,
                                                          cache_tiles=auto_dense, sym=False,
                                                          **whole),
        "dense tiled dot": lambda: kernels.multiround_sym(H, x1, x1, z, evt.MAX_ITR,
                                                          cache_tiles=auto_dense, sym=False,
                                                          formulation="dot", **whole),
    }
    ms = interleaved_ms(timed, reps=12)
    passes = int(timed["multiround dot"]()[2]) + 1
    plain = {
        "multiround": time_call(lambda: kernels.multiround_plain(
            H, x1, x1, z, evt.MAX_ITR, formulation="dot", **whole), reps=3).median_ms,
        "multiround_sym": time_call(lambda: kernels.multiround_sym_plain(
            H, x1, x1, z, evt.MAX_ITR, formulation="dot", **whole), reps=3).median_ms,
    }
    say(f"dot times at {n}², {passes} passes, card {card} (median of 12 whole-budget launches, "
        f"interleaved; triangle f32 cache {auto}, bf16 vpu cache {auto_q_vpu}, bf16 dot cache "
        f"{auto_q}):")
    for k, v in ms.items():
        vpu = ms.get(k.replace(" dot", " vpu").replace(" f16", " bf16"))
        say(f"  {k}: {v:.4f} ms" + (f" ({v / vpu:.2f}x vpu)" if " dot" in k and vpu else ""))
    say(f"  plain versions (formulation='dot', f32): multiround {plain['multiround']:.4f} ms, "
        f"multiround_sym {plain['multiround_sym']:.4f} ms")
    return {"launches": launches, "err": err, "ms": ms, "plain_ms": plain, "passes": passes,
            "auto": auto, "auto_q": auto_q, "auto_q_vpu": auto_q_vpu}


def mixed_fill_phase(dev, mats, same, reset_counts, read_counts, card) -> dict:
    """The last two variants of the triangle kernel (step 11):
    ``formulation="mixed"`` (the last m resident tiles in 3xTF32, the rest
    "vpu") and ``fill_mode="pipelined"`` (the resident tiles brought by 2-D
    tensor copies waited for at first use).  Returns the numbers of their
    records: launches on the main path, the max abs error against the plain
    version, the times, the fills' µs and the share m."""
    import torch

    import eigen_value_tpu_torch as evt
    import kernel_phases
    from eigen_value_tpu_torch import fixtures
    from eigen_value_tpu_torch.device import sym_auto_cache_tiles
    from eigen_value_tpu_torch.ops.cuda import kernels
    from eigen_value_tpu_torch.ops.solver_matvec import solve_matvec, solve_multiround
    from eigen_value_tpu_torch.utils.timing import time_call

    n, bt = 8192, kernels.SYM_TILE
    H = mats[n]
    bf16 = torch.bfloat16
    H_q = H.to(bf16)
    auto = sym_auto_cache_tiles(n, bt, dev)
    auto_q = sym_auto_cache_tiles(n, bt, dev, itemsize=2)
    auto_dense = sym_auto_cache_tiles(n, bt, dev, sym=False)
    m = {torch.float32: kernels.mxu_share(n, bt, auto, True),
         bf16: kernels.mxu_share(n, bt, auto_q, True)}
    say(f"mixed share at {n}², tile {bt}: {m[torch.float32]} of {auto} f32 tiles, {m[bf16]} "
        f"of {auto_q} bf16 tiles on the tensor cores (kernels.MXU_TERM_COST "
        f"{kernels.MXU_TERM_COST}, the JAX package's rule)")
    x1 = torch.ones(n, device=dev)
    z = torch.zeros((), device=dev)

    # --- 11a. one launch of each variant against its plain version ---
    R = 1 + 0.25 * torch.rand(n, n, device=dev,
                              generator=torch.Generator(device=dev).manual_seed(SEED + 15))
    scaled = H * ((R + R.T) / 2)
    del R
    err = {"mixed": 0.0, "pipelined": 0.0}
    cases = [("mixed", "Hilbert", H, dict(cache_tiles=auto, formulation="mixed")),
             ("mixed", "symmetrically scaled", scaled, dict(cache_tiles=auto, formulation="mixed")),
             ("mixed", "Hilbert bf16", H_q, dict(cache_tiles=auto_q, formulation="mixed")),
             ("mixed", "dense tiled, asymmetric Hilbert", H * (1 + 0.25 * torch.rand(
                 n, n, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED + 16))),
              dict(cache_tiles=auto_dense, sym=False, formulation="mixed")),
             ("pipelined", "Hilbert", H, dict(cache_tiles=auto, fill_mode="pipelined")),
             ("pipelined", "Hilbert bf16", H_q, dict(cache_tiles=auto_q, fill_mode="pipelined")),
             ("pipelined", "Hilbert, mixed", H, dict(cache_tiles=auto, formulation="mixed",
                                                     fill_mode="pipelined"))]
    for variant, label, A, kw in cases:
        state = (x1, x1, z)
        for init in (True, False):
            a = dict(chunk=5, eps=evt.EPS, init=init, **kw)
            got = kernels.multiround_sym(A, *state, evt.MAX_ITR, **a)
            want = kernels.multiround_sym_plain(A, *state, evt.MAX_ITR, **a)
            torch.cuda.synchronize()
            check(int(got[2]) == int(want[2]), f"{variant} {label} init={init}: advanced "
                  f"{int(got[2])} != {int(want[2])}")
            rel = max(float(((g - w).abs() / w.abs()).max())
                      for g, w in ((got[0], want[0]), (got[1], want[1]), (got[3], want[3])))
            e = max(float((got[1] - want[1]).abs().max()), float((got[0] - want[0]).abs().max()))
            say(f"multiround_sym[{variant}] {label} {n}² chunk 5 init={init}: advanced "
                f"{int(got[2])}, max rel diff (ev, v, λ) to the plain version {rel:.3e}, max "
                f"|kernel - plain| (v, ev) {e:.3e}")
            check(rel <= PARITY_REL and e <= 1e-5, f"{variant} {label} init={init}: rel {rel}, "
                  f"abs {e}")
            err[variant] = max(err[variant], e)
            state = (got[0], got[1], got[3])
    del scaled, cases

    # --- 11b. the main path: the solves through solve_multiround, launches
    # counted arm by arm ---
    arms = {
        "mixed f32": (H, dict(cache_tiles=auto, formulation="mixed")),
        "pipelined f32": (H, dict(cache_tiles=auto, fill_mode="pipelined")),
        "mixed + pipelined f32": (H, dict(cache_tiles=auto, formulation="mixed",
                                          fill_mode="pipelined")),
        "mixed bf16": (H, dict(cache_tiles=auto_q, formulation="mixed", storage_dtype=bf16)),
        "pipelined bf16": (H, dict(cache_tiles=auto_q, fill_mode="pipelined",
                                   storage_dtype=bf16)),
        "mixed + pipelined bf16": (H, dict(cache_tiles=auto_q, formulation="mixed",
                                           fill_mode="pipelined", storage_dtype=bf16)),
    }
    vpu = {torch.float32: solve_multiround(H, evt.EPS, evt.MAX_ITR, symmetric=True,
                                           cache_tiles=auto),
           bf16: solve_multiround(H, evt.EPS, evt.MAX_ITR, symmetric=True, cache_tiles=auto_q,
                                  storage_dtype=bf16)}
    oracle = {torch.float32: solve_matvec(H.double(), evt.EPS, evt.MAX_ITR),
              bf16: solve_matvec(H_q.double(), evt.EPS, evt.MAX_ITR)}
    launches = {"mixed": 0, "pipelined": 0}
    runs = {}
    for k, (A, kw) in arms.items():
        reset_counts()
        runs[k] = solve_multiround(A, evt.EPS, evt.MAX_ITR, symmetric=True, **kw)
        got = read_counts()
        check(got["multiround_sym"] == 1 and sum(got.values()) == 1,
              f"{k}: launches {got}, not one multiround_sym launch")
        for variant in launches:
            launches[variant] += got["multiround_sym"] if variant in k else 0
    say(f"mixed / pipelined path launches (multiround_sym, one a solve): {launches}")
    for k, (A, kw) in arms.items():
        res = runs[k]
        dt = kw.get("storage_dtype", torch.float32)
        A_s = A.to(dt) if dt != torch.float32 else A
        v = res.eigenvector.double()
        resid = float((f64_matvec(A_s, v) - res.eigenvalue.double() * v).abs().max())
        lam, lam_64, lam_v = (float(res.eigenvalue), float(oracle[dt].eigenvalue),
                              float(vpu[dt].eigenvalue))
        rel_64, rel_v = abs(lam - lam_64) / lam_64, abs(lam - lam_v) / lam_v
        say(f"hilbert {n} {k}: rounds {int(res.rounds)} (vpu {int(vpu[dt].rounds)}, float64 "
            f"loop {int(oracle[dt].rounds)}), λ {lam!r} (float64 loop {lam_64!r}, rel "
            f"{rel_64:.2e}; vpu {lam_v!r}, rel {rel_v:.2e}), residual {resid:.3e}")
        check(bool(res.converged) and int(res.rounds) == 17, f"{k}: rounds {int(res.rounds)}")
        check(rel_64 <= PARITY_REL and rel_v <= PARITY_REL, f"{k}: λ rel {rel_64}, {rel_v}")
        check(resid <= 1e-3, f"{k}: residual {resid}")
        check(bool(torch.isfinite(res.eigenvector).all()), f"{k}: eigenvector not finite")
        if "mixed" not in k:
            check(same(res, vpu[dt]), f"{k}: not the prologue fill's bits")
    # the table; at 128² (one tile) no tile can be resident, and both
    # packages refuse the two variants there.  The pipelined fill takes the
    # largest cache up to the auto one that its depth rule (the JAX
    # kernel's) accepts: at 2048² the 120 tiles of the whole triangle would
    # keep 16 copies in flight on the JAX schedule, 108 keep 8
    for variant, kw in (("mixed", dict(formulation="mixed")),
                        ("pipelined", dict(fill_mode="pipelined"))):
        rounds = {}
        for size in sorted(fixtures.HILBERT_ROUNDS):
            c = sym_auto_cache_tiles(size, bt, dev)
            while variant == "pipelined" and c and (
                    kernels.pipelined_depth(size, bt, c, True) > kernels.PIPELINED_DEPTH):
                c -= 1
            if c == 0:
                try:
                    solve_multiround(mats[size], evt.EPS, evt.MAX_ITR, symmetric=True,
                                     cache_tiles=1, **kw)
                except ValueError as e:
                    check("cache_tiles > 0" in str(e), f"{variant} {size}²: {e}")
                    rounds[size] = "refused (no resident tile)"
                    continue
                check(False, f"{variant} at {size}² ran with no resident tile")
            res = solve_multiround(mats[size], evt.EPS, evt.MAX_ITR, symmetric=True,
                                   cache_tiles=c, **kw)
            check(bool(res.converged) and int(res.rounds) == fixtures.HILBERT_ROUNDS[size],
                  f"{variant} hilbert {size}: rounds {int(res.rounds)}")
            rounds[size] = f"{int(res.rounds)} (cache {c})"
        say(f"{variant} Hilbert table (auto cache): {rounds}")

    # --- 11c. bit identities ---
    def tri(A, **kw):
        return solve_multiround(A, evt.EPS, evt.MAX_ITR, symmetric=True, **kw)

    for dt, A, c in ((torch.float32, H, auto), (bf16, H_q, auto_q)):
        name = "f32" if dt == torch.float32 else "bf16"
        mixed = tri(A, cache_tiles=c, formulation="mixed")
        for chunk in (1, 5):
            ok = same(tri(A, cache_tiles=c, formulation="mixed", chunk=chunk), mixed)
            say(f"mixed {name} chunk={chunk} vs the whole budget: bit-identical {ok}")
            check(ok, f"mixed {name} chunk={chunk} changed the result")
        for cc in (7, c):
            ok = same(tri(A, cache_tiles=cc, formulation="mixed", mxu_tiles=0),
                      tri(A, cache_tiles=cc))
            say(f"mixed {name} cache {cc}, mxu_tiles=0 vs vpu: bit-identical {ok}")
            check(ok, f"mixed {name} mxu_tiles=0 is not vpu at cache {cc}")
        for form, fc in (("vpu", c), ("dot", sym_auto_cache_tiles(n, bt, dev, itemsize=dt.itemsize,
                                                                   ring=False)), ("mixed", c)):
            for chunk in (5, None):
                ok = same(tri(A, cache_tiles=fc, formulation=form, chunk=chunk,
                              fill_mode="pipelined"),
                          tri(A, cache_tiles=fc, formulation=form, chunk=chunk))
                say(f"{form} {name} cache {fc} chunk={chunk or 'whole budget'}: pipelined vs "
                    f"prologue fill bit-identical {ok}")
                check(ok, f"{form} {name}: the pipelined fill changed the result")
        # a launch that stops at its round 0, its copies issued
        whole = dict(chunk=evt.MAX_ITR + 1, eps=evt.EPS, init=True, cache_tiles=c)
        ev, v, _, lam = kernels.multiround_sym(A, x1, x1, z, evt.MAX_ITR, **whole)
        for form in ("vpu", "mixed"):
            outs = [kernels.multiround_sym(A, ev, v, lam, evt.MAX_ITR, chunk=5, eps=evt.EPS,
                                           cache_tiles=c, formulation=form, fill_mode=fm)
                    for fm in ("prologue", "pipelined")]
            torch.cuda.synchronize()
            ok = (int(outs[1][2]) == 0 and all(torch.equal(a, b) for a, b in zip(*outs))
                  and torch.equal(outs[1][0], ev) and torch.equal(outs[1][1], v))
            say(f"{form} {name}: a pipelined launch that stops at round 0 (advanced "
                f"{int(outs[1][2])}) keeps ev and v and the prologue fill's bits: {ok}")
            check(ok, f"{form} {name}: the stopped pipelined launch")
    blk = torch.arange(n, device=dev) // bt
    bad = torch.where(blk[:, None] > blk[None, :], torch.full_like(H, 7.25), H)
    ok = same(tri(bad, cache_tiles=auto, formulation="mixed", fill_mode="pipelined"),
              tri(H, cache_tiles=auto, formulation="mixed", fill_mode="pipelined"))
    del bad, blk
    say(f"mixed + pipelined f32: the lower block triangle is never read: {ok}")
    check(ok, "mixed read below the block diagonal")
    # A_q against A_q.float(), at one cache (396 f32 tiles fit; the tile set
    # is the cache's)
    for kw in (dict(formulation="mixed"), dict(fill_mode="pipelined"),
               dict(formulation="mixed", fill_mode="pipelined")):
        ok = same(tri(H_q, cache_tiles=auto, **kw), tri(H_q.float(), cache_tiles=auto, **kw))
        say(f"{kw} cache {auto}: A_q (bf16) vs A_q.float() bit-identical {ok}")
        check(ok, f"{kw}: A_q differs from A_q.float()")

    # --- 11d. times: whole-budget launches, each beside "vpu", interleaved ---
    whole = dict(chunk=evt.MAX_ITR + 1, eps=evt.EPS, init=True)

    def launch(A, c, **kw):
        return lambda: kernels.multiround_sym(A, x1, x1, z, evt.MAX_ITR, cache_tiles=c,
                                              **whole, **kw)

    timed, grids = {}, {}
    for name, A, c in (("f32", H, auto), ("bf16", H_q, auto_q)):
        c_dot = sym_auto_cache_tiles(n, bt, dev, itemsize=A.element_size(), ring=False)
        for form, fc in (("vpu", c), ("mixed", c), ("dot", c_dot)):
            for fill in ("prologue", "pipelined"):
                k = f"{form} {name}" if fill == "prologue" else \
                    f"pipelined {name}" if form == "vpu" else f"{form} + pipelined {name}"
                timed[k] = launch(A, fc, formulation=form, fill_mode=fill)
                sized = {} if A.dtype == torch.float32 else {"dtype": A.dtype}
                grids[k] = kernels.multiround_sym_plan(
                    dev, n, bt, fc, True, **sized, **({form: True} if form != "vpu" else {}),
                    **({"pipelined": True} if fill == "pipelined" else {})).grid
    ms = interleaved_ms(timed, reps=12)
    # each fill's own µs from the kernel's fill stamps, one more launch each:
    # the prologue fill from the launch's start (ev's load in it), the pipelined
    # fill's issue
    fill_us = {k: kernel_phases.stamped_split(kernels, fn, "multiround_sym", grids[k], dev,
                                              rounds=[0], fill=True).get("fill_us")
               for k, fn in timed.items()}
    passes = int(timed["mixed f32"]()[2]) + 1
    plain = {
        "mixed": time_call(lambda: kernels.multiround_sym_plain(
            H, x1, x1, z, evt.MAX_ITR, cache_tiles=auto, formulation="mixed", **whole),
            reps=3).median_ms,
        "pipelined": time_call(lambda: kernels.multiround_sym_plain(
            H, x1, x1, z, evt.MAX_ITR, cache_tiles=auto, fill_mode="pipelined", **whole),
            reps=3).median_ms,
    }
    say(f"mixed / pipelined times at {n}², {passes} passes, card {card} (median of 12 "
        f"whole-budget launches, interleaved; f32 cache {auto}, bf16 cache {auto_q}):")
    for k, v in ms.items():
        say(f"  {k}: {v:.4f} ms, fill {fill_us[k]:.3f} µs")
    for name in ("f32", "bf16"):
        for form in ("vpu", "dot", "mixed"):
            k = f"{form} {name}"
            kp = f"pipelined {name}" if form == "vpu" else f"{form} + pipelined {name}"
            say(f"  {k}: pipelined fill {ms[kp]:.4f} ms (issue {fill_us[kp]:.3f} µs) against "
                f"the prologue fill {ms[k]:.4f} ms (fill {fill_us[k]:.3f} µs): "
                f"{100 * (ms[kp] / ms[k] - 1):+.2f}%")
    say(f"  plain versions (f32): mixed {plain['mixed']:.4f} ms, pipelined "
        f"{plain['pipelined']:.4f} ms")
    return {"launches": launches, "err": err, "ms": ms, "fill_us": fill_us, "plain_ms": plain,
            "passes": passes, "auto": auto, "auto_q": auto_q, "m": m[torch.float32],
            "m_q": m[bf16]}


def oracle_stepping_phase(dev, here, mats, auto, same, reset_counts, read_counts,
                          card) -> dict:
    """The NumPy oracles and a sharded A stepped through the checkpoint
    (step 12).

    12a: ``python3 -m eigen_value_tpu_torch.oracle`` with both semantics at
    32²…256² as processes of their own, and once more with jax blocked from
    import (rc 0, the reference's table), and
    ``reference_impl.parallel_oracle`` on Hilbert 128…1024 from the card's
    matrices: rounds on the table, λ within PARITY_REL of the card's
    ``max_eigenvalue`` (``auto``).  12b, on a one-rank NCCL group on this
    card: Hilbert 8192² as a ``Shard(0)`` DTensor, in bf16 too, and as a
    ``(Shard(0), Shard(1))`` DTensor on a 1 × 1 mesh, each stepped by
    ``checkpoint.step`` in chunks 5, 5 and the rest (launch counters read
    around exactly these calls: rounds + 1 ``matvec`` launches, nothing
    else); each state bit for bit (ev, v, λ, rounds, done) the plain
    tensor's ``step`` at the same chunks (one ``multiround`` launch a step)
    and its result the matvec kernel loop's; a ``save_state_orbax`` /
    ``load_state_orbax`` round trip after 5 rounds, resumed to the same
    bits; a 2-process NCCL group stepping where the host has two cards;
    then ms per stepped solve beside the unsharded step's, interleaved.
    Returns the launch counts of 12b and the times."""
    import tempfile

    import torch
    import torch.distributed as dist

    import eigen_value_tpu_torch as evt
    from eigen_value_tpu_torch import checkpoint as cp
    from eigen_value_tpu_torch import fixtures
    from eigen_value_tpu_torch.bench import run_mh_workers
    from eigen_value_tpu_torch.ops.solver_matvec import solve_matvec_kernel
    from eigen_value_tpu_torch.parallel import (
        assemble_blocksharded,
        assemble_rowsharded,
        make_mesh2d,
        make_row_mesh,
    )
    from eigen_value_tpu_torch.reference_impl import parallel_oracle

    EPS, MAX = evt.EPS, evt.MAX_ITR

    # --- 12a. the oracles, also where jax cannot be imported ---
    t12 = time.perf_counter()
    jax_here = "installed" if importlib.util.find_spec("jax") else "not installed"
    runs = {f"python3 -m eigen_value_tpu_torch.oracle --semantics {sem} --max-pow 8":
            (sem, ["-m", "eigen_value_tpu_torch.oracle"]) for sem in ("parallel", "sequential")}
    runs["the same, parallel, with jax and eigen_value_tpu blocked from import"] = (
        "parallel", ["-c", "import runpy, sys; sys.modules['jax'] = None; "
                     "sys.modules['eigen_value_tpu'] = None; "
                     "runpy.run_module('eigen_value_tpu_torch.oracle', run_name='__main__')"])
    # the three at once: each spends its seconds importing torch
    procs = {what: subprocess.Popen([sys.executable, *argv, "--semantics", sem, "--max-pow", "8"],
                                    cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
             for what, (sem, argv) in runs.items()}
    try:
        outs = {what: p.communicate(timeout=300) for what, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for what, (stdout, stderr) in outs.items():
        semantics, rc = runs[what][0], procs[what].returncode
        rows = [line for line in stdout.splitlines() if "round(s)" in line]
        say(f"{what} (jax {jax_here} here): rc {rc}; " + " | ".join(
            " ".join(r.split()) for r in rows))
        check(rc == 0 and len(rows) == 4
              and stdout.startswith(f"{semantics.capitalize()} Similarity Transform"),
              f"{what}: rc {rc}, {stderr[-2000:]}")
    for n in (128, 256, 512, 1024):
        got = parallel_oracle(mats[n].cpu().numpy())
        lam = float(auto[n].eigenvalue)
        rel = abs(got.eigenvalue - lam) / lam
        say(f"parallel_oracle of Hilbert {n}²: rounds {got.rounds} (table "
            f"{fixtures.HILBERT_ROUNDS[n]}), λ {got.eigenvalue!r}, the card's max_eigenvalue "
            f"{lam!r}, rel {rel:.3e}")
        check(got.converged and got.rounds == fixtures.HILBERT_ROUNDS[n] and rel <= PARITY_REL,
              f"parallel_oracle of Hilbert {n}²")

    # --- 12b. a sharded A stepped through the checkpoint, one rank of NCCL ---
    n = 8192
    H = mats[n]
    Hq = H.to(torch.bfloat16)
    rows = make_row_mesh(1)
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1, "a one-rank NCCL group")
    mesh2d = make_mesh2d(1, 1)
    chunks = (5, 5, MAX)

    def stepped(A):
        state = cp.init_state(A)
        for k in chunks:
            state = cp.step(state, k)
        return state

    def equal(a, b) -> bool:
        return all(torch.equal(x, y) for x, y in zip(a[1:], b[1:]))

    stepped(assemble_rowsharded(mats[128], rows))  # NCCL sets up its communicator here
    arms = {
        "f32 Shard(0)": (assemble_rowsharded(H, rows), H, None),
        "bf16 Shard(0)": (assemble_rowsharded(Hq, rows), Hq, torch.bfloat16),
        "f32 (Shard(0), Shard(1)) on 1 x 1": (assemble_blocksharded(H, mesh2d), H, None),
    }
    total = {}
    for name, (A, plain, storage) in arms.items():
        ref = stepped(plain)
        loop = solve_matvec_kernel(H, EPS, MAX, storage_dtype=storage)
        reset_counts()
        got = stepped(A)
        c = read_counts()
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
        ok_step, ok_loop = equal(got, ref), same(cp.to_result(got), loop)
        say(f"stepped {name} {n}² in chunks 5, 5, rest: rounds {int(got.rounds)}, done "
            f"{bool(got.done)}; bit-identical to the plain tensor's step {ok_step}, to "
            f"solve_matvec_kernel {ok_loop}; launches { {k: v for k, v in c.items() if v} }")
        check(ok_step and ok_loop and int(got.rounds) == 17 and bool(got.done),
              f"stepped {name}")
        check(c["matvec"] == int(got.rounds) + 1 and sum(c.values()) == c["matvec"],
              f"stepped {name}: launches {c}")
    say(f"stepping path launches: {total}")
    Hs = arms["f32 Shard(0)"][0]
    ref = stepped(H)
    with tempfile.TemporaryDirectory() as d:
        mid = cp.step(cp.init_state(Hs), 5)
        cp.save_state_orbax(os.path.join(d, "state"), mid)
        back = cp.load_state_orbax(os.path.join(d, "state"), cp.init_state(Hs))
    ok_trip = equal(back, mid) and torch.equal(back.A.to_local(), H)
    fin = cp.step(cp.step(back, 5), MAX)
    ok_resume = equal(fin, ref)
    say(f"stepped f32 Shard(0) {n}²: save_state_orbax after 5 rounds, loaded bit for bit "
        f"{ok_trip}, resumed to the plain step's bits {ok_resume}")
    check(ok_trip and ok_resume, "the sharded state's Orbax round trip")
    if torch.cuda.device_count() >= 2:
        try:
            two = run_mh_workers(2, n, 3, ["gather", "stepped"], timeout_s=300)
        except RuntimeError as e:
            raise SystemExit(f"FAILED: {e}")
        r, g = two[0]["results"]["stepped"], two[0]["results"]["gather"]
        say(f"mh_worker, 2 processes of NCCL on 2 cards, stepped: rounds {r['rounds']}, "
            f"λ {r['eigenvalue']!r} (gather {g['eigenvalue']!r}), {r['ms']:.4f} ms")
        check(r["rounds"] == 17 and r["eigenvalue"] == g["eigenvalue"]
              and len({o["results"]["stepped"]["eigenvalue"] for o in two}) == 1,
              "2-process stepping")
    else:
        say(f"stepping in a 2-process NCCL group: not run, this host has "
            f"{torch.cuda.device_count()} card")
    ms = interleaved_ms({
        "unsharded f32 step": lambda: stepped(H),
        "f32 Shard(0), 1 rank": lambda: stepped(Hs),
        "f32 1 x 1": lambda: stepped(arms["f32 (Shard(0), Shard(1)) on 1 x 1"][0]),
        "unsharded bf16 step": lambda: stepped(Hq),
        "bf16 Shard(0), 1 rank": lambda: stepped(arms["bf16 Shard(0)"][0]),
        "matvec kernel loop": lambda: solve_matvec_kernel(H, EPS, MAX),
    }, reps=12)
    say(f"stepped solve times at {n}² in chunks 5, 5, rest, 1 rank of NCCL on 1 card ({card}; "
        f"median of 12 interleaved solves, ms): " + json.dumps({k: round(v, 4)
                                                               for k, v in ms.items()}))
    dist.destroy_process_group()
    say(f"step 12: {time.perf_counter() - t12:.1f} s")
    return {"launches": total, "ms": ms}


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
    from eigen_value_tpu_torch.bench import bench_e2e, bench_kernels, bench_vector_kernels
    from eigen_value_tpu_torch.bench.__main__ import _fmt_e2e, _fmt_kernels
    import kernel_phases
    from eigen_value_tpu_torch import device as tdev
    from eigen_value_tpu_torch.device import cuda_limits, sym_auto_cache_tiles
    from eigen_value_tpu_torch.ops.cuda import build, kernels
    from eigen_value_tpu_torch.ops.solver import solve_xla, stop_check
    from eigen_value_tpu_torch.ops.solver_kernel import solve_kernel
    from eigen_value_tpu_torch.ops.solver_matvec import (
        solve_fused_round,
        solve_matvec,
        solve_matvec_kernel,
        solve_matvec_kernel_fused,
        solve_multiround,
    )
    from eigen_value_tpu_torch.utils.timing import roofline_pct, time_call

    dev = torch.device("cuda", 0)
    wrappers = {name: getattr(kernels, name) for name in (
        "matvec", "multiround", "multiround_sym", "rowsum", "rowsum_bias", "scale",
        "scale_rowsum", "stop", "round_matvec", "round_fused", "round_glue")}

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

    t_start = t0 = time.perf_counter()
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

    # --- 2d. the stop kernel against stop_plain: the verdicts are equal ---
    eps_t = torch.tensor(evt.EPS, device=dev)
    stop_cases = 0

    def stop_both(v, eps, what) -> bool:
        nonlocal stop_cases
        got, want = kernels.stop(v, eps), kernels.stop_plain(v, eps)
        check(got.dtype == torch.bool and got.shape == () and got.is_cuda, f"stop {what}: result")
        check(bool(got) == bool(want), f"stop {what}: kernel {bool(got)}, plain {bool(want)}")
        stop_cases += 1
        return bool(got)

    for n in (1, 3, 1000, 4096, 1 << 16, 1 << 25):
        ok = fixtures.stop_success_vector(n, device=dev)
        check(stop_both(ok, eps_t, f"n={n} success fixture"), f"stop n={n}: the success fixture")
        failed = not stop_both(fixtures.stop_fail_vector(n, device=dev), eps_t,
                               f"n={n} fail fixture")
        check(failed or n < 1000, f"stop n={n}: the fail fixture passed")
        # one break: first, last, at a block's edge (256 threads of 4 values, or of
        # 1 where n % 4 != 0) and mid-block; then a NaN at the same places
        for idx in sorted({0, n - 1, min(255, n - 1), min(256, n - 1), min(1023, n - 1),
                           min(1024, n - 1), n // 2 + 1 if n > 2 else 0}):
            bad = ok.clone()
            bad[idx] += 1.0
            check(stop_both(bad, eps_t, f"n={n} break at {idx}") == (n == 1),
                  f"stop n={n}: a break at {idx}")
            bad[idx] = float("nan")
            check(not stop_both(bad, eps_t, f"n={n} NaN at {idx}"), f"stop n={n}: a NaN at {idx}")
    for i in range(10):
        v = (torch.rand(4096 + i, generator=gen) * (0.2 if i % 2 else 1.0)).to(dev)
        check(stop_both(v, torch.tensor(0.5, device=dev), f"random vector {i}") == bool(i % 2),
              f"stop random vector {i} at eps 0.5")
    # every round's v of the 8192² Hilbert solve: only the last one stops
    H8 = fixtures.hilbert_matrix(8192, device=dev)
    ev = torch.ones(8192, device=dev)
    v = kernels.matvec(H8, ev) / ev
    verdicts = []
    while len(verdicts) <= evt.MAX_ITR:
        verdicts.append(stop_both(v, eps_t, f"hilbert 8192 round {len(verdicts)}"))
        if verdicts[-1]:
            break
        ev = ev * (v / torch.max(v))
        v = kernels.matvec(H8, ev) / ev
    check(verdicts == [False] * fixtures.HILBERT_ROUNDS[8192] + [True],
          f"stop over the hilbert 8192 solve: {verdicts}")
    say(f"stop: {stop_cases} verdicts equal to stop_plain's (n = 1 … 2^25: fixtures, single "
        f"breaks, NaNs, 10 random vectors, the {len(verdicts)} v of the hilbert 8192 solve: "
        f"only the last stops)")

    # --- 2e. the one-launch rounds against their plain versions, and bitwise
    # against the unfused expressions over the matvec kernel ---
    round_err = {}
    round_cases = [
        (f"random n={n}", fixtures.random_positive_matrix(n, gen, device=dev),
         (torch.rand(n, generator=gen) + 0.5).to(dev), (torch.rand(n, generator=gen) + 0.5).to(dev))
        for n in (3, 1000, 1001, 4096, 8192)
    ]
    # the fused solves' own first round at full width
    ones8 = torch.ones(8192, device=dev)
    round_cases.append(("hilbert n=8192", H8, ones8, kernels.matvec(H8, ones8) / ones8))
    for name, A, ev, v in round_cases:
        keep = (A.clone(), ev.clone(), v.clone())
        m = torch.max(v)
        v_next, ev_new = kernels.round_matvec(A, ev, v, m)
        fused = kernels.round_fused(A, ev, v, eps=evt.EPS)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip((A, ev, v), keep)),
              f"rounds {name}: an input was written")
        check(torch.equal(ev_new, ev * (v / m)), f"round_matvec {name}: ev' is not ev * (v / m)")
        check(torch.equal(v_next, kernels.matvec(A, ev_new) / ev_new),
              f"round_matvec {name}: v' is not matvec(A, ev') / ev' bit for bit")
        check(torch.equal(fused[0], v_next) and torch.equal(fused[1], ev_new),
              f"round_fused {name} is not round_matvec at m = max v")
        check(fused[2].dtype == torch.bool and bool(fused[2]) == bool(stop_check(v, evt.EPS)),
              f"round_fused {name}: done")
        check(torch.equal(fused[3], v[0]), f"round_fused {name}: λ is not v[0]")
        want = kernels.round_matvec_plain(A, ev, v, m)
        want_f = kernels.round_fused_plain(A, ev, v, eps=evt.EPS)
        rel = max(rel_err(v_next, want[0].double()), rel_err(fused[0], want_f[0].double()))
        check(torch.equal(ev_new, want[1]) and torch.equal(fused[1], want_f[1]),
              f"rounds {name}: ev' differs from the plain version's")
        check(rel <= PLAIN_TOL, f"rounds {name}: v' rel diff to plain {rel} > {PLAIN_TOL}")
        check(bool(fused[2]) == bool(want_f[2]) and torch.equal(fused[3], want_f[3]),
              f"round_fused {name}: done / λ differ from the plain version's")
        check(torch.equal(v_next, kernels.round_matvec(A, ev, v, m)[0]),
              f"round_matvec {name} not deterministic")
        round_err = {"round_matvec": float((v_next - want[0]).abs().max()),
                     "round_fused": float((fused[0] - want_f[0]).abs().max())}
        say(f"one-launch rounds {name}: v' rel diff to plain {rel:.3e}, max |kernel - plain| "
            f"{round_err}; bit identities hold")
    # a v that stops: done is True and the round is computed all the same
    ok = fixtures.stop_success_vector(8192, device=dev)
    fused = kernels.round_fused(H8, ones8, ok, eps=evt.EPS)
    ref = kernels.round_matvec(H8, ones8, ok, torch.max(ok))
    check(bool(fused[2]) and torch.equal(fused[0], ref[0]) and torch.equal(fused[1], ref[1]),
          "round_fused on a v that stops")
    del round_cases, A, keep, want, want_f, fused, ref, v_next, ev_new, H8

    # --- 2f. the round glue against its plain version on the same y and a
    # clone of ev, bit for bit (a NaN's payload aside): at the main path's
    # 65536, at n % 4 != 0 and at n = 1; a v that goes on, one that stops,
    # one with a NaN; round 0 and a later one; both stop modes ---
    def glue_bits(t: torch.Tensor) -> torch.Tensor:
        t = t.reshape(-1)
        return t.masked_fill(t.isnan(), float("nan")).view(torch.int32)

    def glue_out() -> tuple:
        return (torch.empty((), device=dev), torch.empty((), dtype=torch.int32, device=dev),
                torch.empty((), dtype=torch.bool, device=dev))

    glue_cases = 0
    for gn in (BIG_N, BIG_N + 3, 1000, 1):
        ev0 = (torch.rand(gn, generator=gen) + 0.5).to(dev)
        ys = {"goes on": (torch.rand(gn, generator=gen) + 0.5).to(dev),
              "stops": ev0 * (1 + 1e-5 * torch.rand(gn, generator=gen).to(dev)),
              "nan": (torch.rand(gn, generator=gen) + 0.5).to(dev)}
        ys["nan"][gn // 2] = float("nan")
        for (what, y), i, mode in itertools.product(ys.items(), (0, 9), ("absolute", "relative")):
            got, want = [], []
            for fn, into in ((kernels.round_glue, got), (kernels.round_glue_plain, want)):
                e, (lam, r, c) = ev0.clone(), glue_out()
                fn(y, e, eps_t, i, lam, r, c, mode)
                into.extend((e, lam, r, c))
            torch.cuda.synchronize()
            case = f"round_glue n={gn} {what} i={i} {mode}"
            stops = what == "stops" or (gn == 1 and what != "nan")
            check(bool(got[3]) == bool(want[3]) == stops, f"{case}: converged")
            check(int(got[2]) == int(want[2]) == (i if stops else i + 1), f"{case}: rounds")
            check(torch.equal(glue_bits(got[1]), glue_bits(want[1])), f"{case}: λ")
            check(torch.equal(glue_bits(got[0]), glue_bits(want[0])), f"{case}: ev")
            glue_cases += 1
    # timed at the main path's shape, each way on its own copy of ev (after
    # the first call the update leaves ev where it is, so every call does the
    # same work); the yardstick is the host loop's PyTorch chain that the
    # glue replaced
    ev_c = (torch.rand(BIG_N, generator=gen) + 0.5).to(dev)
    ev_k, ev_p = ev_c.clone(), ev_c.clone()
    y_g = (torch.rand(BIG_N, generator=gen) + 0.5).to(dev)
    out_k, out_p = glue_out(), glue_out()

    def glue_chain():
        v = y_g / ev_c
        stop = stop_check(v, eps_t)
        return ev_c * (v / torch.max(v)), v[0], stop

    t_glue = [time_call(lambda: kernels.round_glue(y_g, ev_k, eps_t, 9, *out_k), reps=50).median_ms,
              time_call(lambda: kernels.round_glue_plain(y_g, ev_p, eps_t, 9, *out_p),
                        reps=50).median_ms,
              time_call(glue_chain, reps=50).median_ms]
    say(f"round_glue: {glue_cases} cases equal to round_glue_plain bit for bit (n = {BIG_N}, "
        f"{BIG_N + 3}, 1000, 1; goes on / stops / NaN; rounds 0 and 9; both modes); at {BIG_N} "
        f"kernel median {t_glue[0]:.4f} ms, plain {t_glue[1]:.4f} ms, the host loop's chain "
        f"{t_glue[2]:.4f} ms (each a call, host-paced)")
    del ys, ev0, ev_k, ev_p, ev_c, y_g

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
    binds = {name: wrappers[name].binds for name in ("multiround", "multiround_sym")}
    say(f"main path launches: {launches}; binds {binds}")
    for name, count in launches.items():
        if name in ("matvec", "multiround", "round_glue"):
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
    big_f32 = (int(auto_big.rounds), lam)  # the storage phase's reference at BIG_N
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

    # --- 4a. the bound one-launch solve at 8192²: bit for bit the wrapper's
    # one launch, the binding kept from call to call ---
    ones8, zero8 = torch.ones(8192, device=dev), torch.zeros((), device=dev)
    bf16_cache = sym_auto_cache_tiles(8192, 128, dev, itemsize=2)
    for what, A_, knobs, wrapper, wkw in (
        ("f32 triangle", H, dict(symmetric=True), kernels.multiround_sym,
         dict(cache_tiles=sym_auto_cache_tiles(8192, 128, dev))),
        ("bf16 triangle", H.to(torch.bfloat16), dict(symmetric=True), kernels.multiround_sym,
         dict(cache_tiles=bf16_cache)),
        ("f32 stripes", H, {}, kernels.multiround, {}),
    ):
        kernels.drop_bindings()
        binds0 = wrapper.binds
        runs = [solve_multiround(A_, evt.EPS, evt.MAX_ITR, **knobs, **wkw) for _ in range(3)]
        ev_w, _, _, lam_w, rounds_w, conv_w = wrapper(
            A_, ones8, ones8, zero8, evt.MAX_ITR, chunk=evt.MAX_ITR + 1, eps=evt.EPS, init=True,
            finish=0, **wkw)
        ok = all(torch.equal(r.eigenvector, ev_w) and torch.equal(r.eigenvalue, lam_w)
                 and torch.equal(r.rounds, rounds_w) and torch.equal(r.converged, conv_w)
                 for r in runs)
        say(f"bound one-launch solve, {what} at 8192²: bit-identical to the wrapper's launch "
            f"{ok}, rounds {int(rounds_w)}; binds {wrapper.binds - binds0} for 3 solves")
        check(ok, f"the bound {what} solve differs from its wrapper's launch")
        check(wrapper.binds - binds0 == 1, f"the {what} solves did not keep one binding")

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

    # --- 4e. the fused-round solves: one launch per round ---
    # the references first: their matvec launches stay out of the counts
    anchor = torch.tensor(fixtures.ANCHOR_3X3, dtype=torch.float32, device=dev)
    fused_inputs = [(f"hilbert {n_}", H_, evt.MAX_ITR) for n_, H_ in mats.items()]
    fused_inputs += [(f"hilbert 256 cap {cap}", mats[256], cap) for cap in (0, 1, 5)]
    fused_inputs.append(("anchor 3x3", anchor, evt.MAX_ITR))
    refs = {k: solve_matvec_kernel(M, evt.EPS, cap) for k, M, cap in fused_inputs}
    reset_counts()
    fused_runs, per_solve = {}, {}

    def counted(solve, M, cap):
        """The solve's result and its (matvec, round_matvec, round_fused) launches."""
        ws = (kernels.matvec, kernels.round_matvec, kernels.round_fused)
        before = [w.launches for w in ws]
        res = solve(M, evt.EPS, cap)
        return res, tuple(w.launches - b for w, b in zip(ws, before))

    for k, M, cap in fused_inputs:
        a, count_a = counted(solve_matvec_kernel_fused, M, cap)
        b, count_b = counted(solve_fused_round, M, cap)
        fused_runs[k] = (a, b)
        per_solve[k] = (count_a, count_b)
    fused_launches = read_counts()
    say(f"fused-round path launches: {fused_launches}")
    check(fused_launches["round_matvec"] > 0 and fused_launches["round_fused"] > 0,
          "the fused-round path launched no round kernel")
    check(sum(fused_launches.values()) == fused_launches["matvec"]
          + fused_launches["round_matvec"] + fused_launches["round_fused"],
          "the fused-round path launched another kernel")
    for k, M, cap in fused_inputs:
        ref = refs[k]
        r = int(ref.rounds)
        stopped = bool(ref.converged)
        for how, res in zip(("solve_matvec_kernel_fused", "solve_fused_round"), fused_runs[k]):
            ok = (same(res, ref) and bool(res.converged) == stopped
                  and res.rounds.dtype == torch.int32 and res.converged.dtype == torch.bool)
            check(ok, f"{k}: {how} is not bit-identical to the matvec kernel loop")
        n_ = M.shape[0]
        if cap == evt.MAX_ITR:
            check(stopped, f"{k}: did not converge")
            if n_ in fixtures.HILBERT_ROUNDS:
                check(r == fixtures.HILBERT_ROUNDS[n_], f"{k}: rounds {r}")
            resid = float(evt.eigen_residual(M, fused_runs[k][1]))
            check(resid <= 1e-3, f"{k}: residual {resid}")
        else:
            check(r == cap and not stopped, f"{k}: rounds {r}, converged {stopped}")
        # one matvec, then a launch per round; the launch that finds the stop
        # is round_fused's one pass more
        want_counts = ((1, r, 0), (1, 0, r + (1 if stopped else 0)))
        check(per_solve[k] == want_counts, f"{k}: launches {per_solve[k]}, want {want_counts}")
        say(f"{k}: both fused-round solves bit-identical to the matvec kernel loop, rounds {r}, "
            f"converged {stopped}, launches (matvec, round_matvec, round_fused) {per_solve[k]}")
    check(per_solve["hilbert 8192"] == ((1, 17, 0), (1, 0, 18)), "launch counts at 8192²")
    lam_a = float(fused_runs["anchor 3x3"][1].eigenvalue)
    check(abs(lam_a - fixtures.ANCHOR_3X3_EIGENVALUE) <= 1e-4, f"anchor λ {lam_a}")
    del refs, fused_runs

    # --- 4f. the vector and e2e bench suites ---
    reset_counts()
    vector_rows = bench_vector_kernels()
    vector_launches = read_counts()
    say(f"vector suite, card {card} (marginal ms per application, chained; at 2^16 the host's "
        f"cost per step):")
    say(_fmt_kernels(vector_rows, size_key="size"))
    for row in vector_rows:
        say("  " + json.dumps(row, allow_nan=False))
    say(f"vector suite launches: {vector_launches}")
    check([(r["kernel"], r["size"]) for r in vector_rows] == [
        (k, 1 << p) for p in (16, 19, 22, 25)
        for k in ("find_max", "eigen_vector", "stop", "stop_pallas")], "the vector suite's rows")
    check(all(r["ms"] > 0 for r in vector_rows), "a vector row's marginal time vanished")
    check(vector_launches["stop"] > 0, "the vector suite launched no stop kernel")
    check(sum(vector_launches.values()) == vector_launches["stop"],
          "the vector suite launched another kernel")
    e2e_rows = bench_e2e(dims=[n])
    say(f"e2e suite at {n}², card {card}:")
    say(_fmt_e2e(e2e_rows))
    for row in e2e_rows:
        say("  " + json.dumps(row, allow_nan=False))
    check([r["backend"] for r in e2e_rows] == [
        "xla", "pallas_fused", "matvec", "matvec_pallas", "matvec_bf16", "multiround",
        "multiround_sym", "multiround_sym_bf16", "multiround_sym_cached", "multiround_cached"],
        "the e2e suite's rungs")
    for row in e2e_rows:
        check("skipped" not in row and row["ms"] > 0 and row["device_ms"] is not None
              and row["device_ms"] > 0, f"e2e {row['backend']}: no time")
        if row["backend"] not in ("xla", "pallas_fused"):  # the table pins the power form
            slack = 1 if "bf16" in row["backend"] else 0  # storage: the JAX suite's ±1
            check(row["rounds_ok"] and abs(row["rounds"] - 17) <= slack,
                  f"e2e {row['backend']}: rounds")
    torch.cuda.empty_cache()

    # --- 4g. the kernel ladder at 8192² ---
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

    # --- 4h. reduced-precision storage: A in bf16 / f16 ---
    # The 2-byte kernels read A as stored and multiply it with the f32 ev in
    # the f32 order, so each is held bit for bit against the f32 kernel on
    # A_q.float() (the same plan and split), then against its plain version.
    # Then, with the launch counters read around exactly these calls, the
    # storage solves through the API: Hilbert 8192² via auto (stripes),
    # symmetric=True (triangle, 2-byte auto cache) and validate=True (the
    # promotion, on a matrix already in the storage dtype), and Hilbert
    # 65536² in bf16 via auto (the matvec kernel loop; 8 GiB, built in bf16
    # on the card), whose peak memory must stay below 9 GiB: no f32 copy.
    store = {torch.bfloat16: "bf16", torch.float16: "f16"}
    whole = dict(chunk=evt.MAX_ITR + 1, eps=evt.EPS, init=True)

    def hilbert_rows(n_, dtype, rows=4096):
        """fixtures.hilbert_matrix(n_, dtype) bit for bit, a block of rows at a
        time (the whole int32 divisor of 65536² would take 16 GiB)."""
        out = torch.empty(n_, n_, dtype=dtype, device=dev)
        i = torch.arange(n_, dtype=torch.int32, device=dev)
        one = torch.tensor(1.0, dtype=dtype, device=dev)
        for r in range(0, n_, rows):
            out[r:r + rows] = one / (i[r:r + rows, None] + i[None, :] + 1).to(dtype)
        return out

    check(torch.equal(hilbert_rows(1000, torch.bfloat16, rows=96),
                      fixtures.hilbert_matrix(1000, torch.bfloat16, dev)), "hilbert_rows")

    def equal(a, b) -> bool:
        return all(torch.equal(p, q) for p, q in zip(a, b))

    def f64_residual(A, res) -> float:
        v = res.eigenvector.double()
        return float((f64_matvec(A, v) - res.eigenvalue.double() * v).abs().max())

    # ... at bulk-copy ring depths 0, 1 and the planned one (device.STRIPES_RING
    # / SYM_RING: the streamed part of A by cp.async.bulk into shared memory),
    # each 2-byte launch against the f32 launch without a ring
    @contextlib.contextmanager
    def ring_depth(depth):
        saved = dict(tdev.STRIPES_RING), dict(tdev.SYM_RING)
        try:
            if depth != "planned":
                for table in (tdev.STRIPES_RING, tdev.SYM_RING):
                    table.update({size: depth for size in table})
            kernels.multiround_launch_plan.cache_clear()
            kernels.multiround_sym_plan.cache_clear()
            yield
        finally:
            tdev.STRIPES_RING.update(saved[0])
            tdev.SYM_RING.update(saved[1])
            kernels.multiround_launch_plan.cache_clear()
            kernels.multiround_sym_plan.cache_clear()

    rings_used = set()
    for dt, tag in store.items():
        for n_ in (2048, 4096, 8192):
            Hq, x_ = mats[n_].to(dt), torch.ones(n_, device=dev)
            Hf = Hq.float()
            ok_mv = torch.equal(kernels.matvec(Hq, x_), kernels.matvec(Hf, x_))
            with ring_depth(0):
                ref_mr = kernels.multiround(Hf, x_, x_, z, evt.MAX_ITR, **whole)
                ref_sym = {sym_: kernels.multiround_sym(Hf, x_, x_, z, evt.MAX_ITR, cache_tiles=0,
                                                        tile=bt, sym=sym_, **whole)
                           for sym_ in (True, False)}
            ok_mr, ok_sym, tried_mr, tried = True, True, [], []
            for depth in (0, 1, "planned"):
                with ring_depth(depth):
                    ring = kernels.multiround_launch_plan(dev, n_, dtype=dt).ring
                    tried_mr.append(ring)
                    rings_used.add(("multiround", ring))
                    ok_mr &= equal(kernels.multiround(Hq, x_, x_, z, evt.MAX_ITR, **whole), ref_mr)
                    for sym_ in (True, False):
                        auto_ = sym_auto_cache_tiles(n_, bt, dev, sym_, itemsize=2)
                        for c in sorted({0, 3, auto_}):
                            ring = kernels.multiround_sym_plan(dev, n_, bt, c, sym_, dtype=dt).ring
                            rings_used.add(("multiround_sym", ring))
                            tried.append(f"{'sym' if sym_ else 'dense'} {c}/ring {ring}")
                            ok_sym &= equal(kernels.multiround_sym(
                                Hq, x_, x_, z, evt.MAX_ITR, cache_tiles=c, tile=bt, sym=sym_,
                                **whole), ref_sym[sym_])
            say(f"{tag} {n_}²: against the f32 kernels on A_q.float() without a ring: matvec "
                f"bit-identical {ok_mv}, multiround at ring depths {tried_mr} {ok_mr}, "
                f"multiround_sym cache/ring {', '.join(tried)} {ok_sym}")
            check(ok_mv and ok_mr and ok_sym,
                  f"{tag} {n_}²: a 2-byte kernel is not its f32 kernel")
    del Hq, Hf
    check({("multiround", 0), ("multiround", 1), ("multiround_sym", 0),
           ("multiround_sym", 1)} <= rings_used, f"the ring depths tried: {sorted(rings_used)}")

    # each 2-byte kernel against its plain version at 8192²; matvec also
    # against a float64 product of the stored values
    H8q = {dt: H.to(dt) for dt in store}
    auto2 = sym_auto_cache_tiles(n, bt, dev, itemsize=2)
    st_err = {}
    for dt, tag in store.items():
        Hq = H8q[dt]
        xr = (torch.rand(n, generator=gen) + 0.5).to(dev)
        got = kernels.matvec(Hq, xr)
        rel_k = rel_err(got, f64_matvec(Hq, xr))
        check(rel_k <= PLAIN_TOL, f"matvec {tag} rel err {rel_k} > {PLAIN_TOL}")
        err = {"matvec": float((got - kernels.matvec_plain(Hq, xr)).abs().max())}
        for name, fn, plain, kw in (
                ("multiround", kernels.multiround, kernels.multiround_plain, {}),
                ("multiround_sym", kernels.multiround_sym, kernels.multiround_sym_plain,
                 dict(tile=bt))):
            ev = torch.ones(n, device=dev)
            state = (ev, ev, torch.zeros((), device=dev))
            for init in (True, False):
                args = dict(chunk=5, eps=evt.EPS, init=init, **kw)
                extra = dict(cache_tiles=auto2) if name == "multiround_sym" else {}
                k_out = fn(Hq, *state, evt.MAX_ITR, **args, **extra)
                p_out = plain(Hq, *state, evt.MAX_ITR, **args)
                torch.cuda.synchronize()
                check(int(k_out[2]) == int(p_out[2]), f"{name} {tag} init={init}: advanced")
                rel = max(float(((g - w).abs() / w.abs()).max())
                          for g, w in ((k_out[0], p_out[0]), (k_out[1], p_out[1]),
                                       (k_out[3], p_out[3])))
                check(rel <= PARITY_REL, f"{name} {tag} init={init}: rel diff {rel} to plain")
                err[name] = max(err.get(name, 0.0), float((k_out[1] - p_out[1]).abs().max()))
                state = (k_out[0], k_out[1], k_out[3])
        say(f"2-byte kernels {tag} at {n}² against their plain versions: matvec rel err to "
            f"float64 {rel_k:.3e}, max |kernel - plain| {err}")
        st_err[dt] = err

    # the references of the counted solves, before the counters are reset
    refs = {dt: (solve_multiround(H8q[dt].float(), evt.EPS, evt.MAX_ITR),
                 tri(H8q[dt].float(), cache_tiles=0)) for dt in store}
    del H8q  # the peak below is the 65536² bf16 matrix, the 8192² f32 ones and the solve
    torch.cuda.empty_cache()
    Hbig = hilbert_rows(BIG_N, torch.bfloat16)
    xbig = torch.ones(BIG_N, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    reset_counts()
    big_bf16 = evt.max_eigenvalue(Hbig, evt.SolverConfig(storage_dtype=torch.bfloat16))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    H8q = {dt: H.to(dt) for dt in store}
    st_runs, st_counts = {}, {}
    for dt, tag in store.items():
        cfg = evt.SolverConfig(storage_dtype=dt)
        st_runs[(dt, "auto")] = evt.max_eigenvalue(H, cfg)
        st_runs[(dt, "symmetric=True")] = evt.max_eigenvalue(
            H, evt.SolverConfig(storage_dtype=dt, symmetric=True))
        st_runs[(dt, "validate=True")] = evt.max_eigenvalue(H8q[dt], cfg, validate=True)
        st_counts[dt] = read_counts()
    st_launches = st_counts[torch.float16]
    bf16_launches = st_counts[torch.bfloat16]
    f16_launches = {k: c - bf16_launches[k] for k, c in st_launches.items()}
    say(f"storage path launches: {st_launches} (bf16 solves {bf16_launches}, f16 solves "
        f"{f16_launches})")
    for name, count in st_launches.items():
        if name in ("matvec", "multiround", "multiround_sym", "round_glue"):
            check(bf16_launches[name] > 0, f"the bf16 storage path launched no {name} kernel")
        else:
            check(count == 0, f"the storage path launched {name}")
    check(f16_launches["multiround"] > 0 and f16_launches["multiround_sym"] > 0,
          "the f16 storage path left the persistent kernels")

    lam32 = float(auto[n].eigenvalue)
    for (dt, how), res in st_runs.items():
        tag, r = store[dt], int(res.rounds)
        resid = f64_residual(H8q[dt], res)
        lam = float(res.eigenvalue)
        rel = abs(lam - lam32) / lam32
        ref = refs[dt][0 if how == "auto" else 1]
        bits = same(res, ref)
        say(f"hilbert {n} {tag} via {how}: rounds {r} (table {fixtures.HILBERT_ROUNDS[n]}, "
            f"{'exact' if r == fixtures.HILBERT_ROUNDS[n] else 'within ±1'}), λ {lam!r} (f32 "
            f"{lam32!r}, rel {rel:.2e}), residual against A_q {resid:.3e}, bit-identical to "
            f"the f32 solve of A_q.float() {bits}")
        check(bool(res.converged) and abs(r - fixtures.HILBERT_ROUNDS[n]) <= 1,
              f"hilbert {n} {tag} {how}: rounds {r}")
        check(rel <= 1e-3 and resid <= 1e-3 and bits, f"hilbert {n} {tag} {how}")
        check(res.eigenvector.dtype == torch.float32, f"{tag} {how}: state not f32")

    r_big, lam_big = int(big_bf16.rounds), float(big_bf16.eigenvalue)
    resid_big = f64_residual(Hbig, big_bf16)
    rel_big = abs(lam_big - big_f32[1]) / big_f32[1]
    jax_rounds, jax_lam = 21, 2.70946  # eigen_value_tpu/bench/suite.py:1083
    say(f"hilbert {BIG_N} bf16 via auto: rounds {r_big} (the f32 solve {big_f32[0]}; JAX pins "
        f"{jax_rounds}), λ {lam_big!r} (the f32 solve {big_f32[1]!r}, rel {rel_big:.2e}; JAX pins "
        f"{jax_lam}, rel {abs(lam_big - jax_lam) / jax_lam:.2e}), residual against A_q "
        f"{resid_big:.3e}, peak memory {peak / 2**30:.4f} GiB ({base / 2**30:.4f} GiB before "
        f"the solve, {(peak - base) / 2**20:.2f} MiB more during it)")
    check(bool(big_bf16.converged) and abs(r_big - big_f32[0]) <= 1, f"{BIG_N} bf16 rounds")
    check(rel_big <= 2e-3 and resid_big <= 1e-3, f"{BIG_N} bf16 λ rel {rel_big}, residual")
    check(peak < 9 * 2**30 and peak - base < 64 * 2**20,
          f"{BIG_N} bf16 solve peak {peak / 2**30:.3f} GiB: a copy of A?")
    got = kernels.matvec(Hbig, xbig)
    rel_k = rel_err(got, f64_matvec(Hbig, xbig))
    err_big = float((got - kernels.matvec_plain(Hbig, xbig)).abs().max())
    Hf = Hbig.float()
    ok = torch.equal(got, kernels.matvec(Hf, xbig))
    del Hf
    torch.cuda.empty_cache()
    say(f"matvec bf16 at {BIG_N}²: bit-identical to the f32 kernel on A_q.float() {ok}, rel err "
        f"to float64 {rel_k:.3e}, max |kernel - plain| {err_big:.3e}")
    check(ok and rel_k <= PLAIN_TOL, f"matvec bf16 at {BIG_N}²")
    st_err[torch.bfloat16]["matvec"] = err_big

    # times: CUDA events, the median of 12 rounds of interleaved arms (each
    # sample the median of 5 calls back to back), f32 beside the 2-byte ones
    Hq8 = H8q[torch.bfloat16]
    xq = x.to(torch.bfloat16)
    xq_big = xbig.to(torch.bfloat16)
    st_arms = {
        "matvec f32": lambda: kernels.matvec(H, x),
        "matvec bf16": lambda: kernels.matvec(Hq8, x),
        "matvec f16": lambda: kernels.matvec(H8q[torch.float16], x),
        "torch.mv bf16": lambda: torch.mv(Hq8, xq),
        f"matvec bf16 {BIG_N}": lambda: kernels.matvec(Hbig, xbig),
        f"torch.mv bf16 {BIG_N}": lambda: torch.mv(Hbig, xq_big),
        "multiround f32": lambda: kernels.multiround(H, x, x, z, evt.MAX_ITR, **whole),
        "multiround bf16": lambda: kernels.multiround(Hq8, x, x, z, evt.MAX_ITR, **whole),
        "multiround f16": lambda: kernels.multiround(H8q[torch.float16], x, x, z, evt.MAX_ITR,
                                                     **whole),
        f"multiround_sym f32 cache {cache}": lambda: kernels.multiround_sym(
            H, x, x, z, evt.MAX_ITR, cache_tiles=cache, **sym_kw),
        f"multiround_sym bf16 cache {auto2}": lambda: kernels.multiround_sym(
            Hq8, x, x, z, evt.MAX_ITR, cache_tiles=auto2, **sym_kw),
        f"multiround_sym f16 cache {auto2}": lambda: kernels.multiround_sym(
            H8q[torch.float16], x, x, z, evt.MAX_ITR, cache_tiles=auto2, **sym_kw),
    }
    st_samples = {k: [] for k in st_arms}
    for rep in range(13):  # rep 0 warms up; the order alternates
        for k in (st_arms if rep % 2 else reversed(list(st_arms))):
            t = time_call(st_arms[k], reps=5, warmup=1).median_ms
            if rep:
                st_samples[k].append(t)
    st_ms = {k: statistics.median(v) for k, v in st_samples.items()}
    say(f"2-byte kernel times, card {card} (median of 12 interleaved samples, ms): "
        + json.dumps({k: round(v, 4) for k, v in st_ms.items()}))
    st_plain = {
        "matvec": time_call(lambda: kernels.matvec_plain(Hbig, xbig), reps=3).median_ms,
        "multiround": time_call(lambda: kernels.multiround_plain(Hq8, x, x, z, evt.MAX_ITR,
                                                                 **whole), reps=3).median_ms,
        "multiround_sym": time_call(lambda: kernels.multiround_sym_plain(
            Hq8, x, x, z, evt.MAX_ITR, **sym_kw), reps=3).median_ms,
    }
    mr2_adv = int(kernels.multiround(Hq8, x, x, z, evt.MAX_ITR, **whole)[2])
    mr2_plan = kernels.multiround_launch_plan(dev, n, dtype=torch.bfloat16)
    sym2_plan = kernels.multiround_sym_plan(dev, n, bt, auto2, True, dtype=torch.bfloat16)
    st_phases = {
        "multiround": kernel_phases.stamped_split(kernels, st_arms["multiround bf16"],
                                                  "multiround", mr2_plan.grid, dev),
        "multiround_sym": kernel_phases.stamped_split(
            kernels, st_arms[f"multiround_sym bf16 cache {auto2}"], "multiround_sym",
            sym2_plan.grid, dev),
    }
    say(f"2-byte plain versions (ms): {st_plain}; bf16 plans at {n}²: stripes {tuple(mr2_plan)}, "
        f"triangle grid {sym2_plan.grid} slots {sym2_plan.slots} resident {sym2_plan.C} "
        f"L2 {sym2_plan.l2_tiles} ring {sym2_plan.ring}; phases (µs) {json.dumps(st_phases)}")
    del Hbig, xq_big
    torch.cuda.empty_cache()

    # --- 5. times at 8192², CUDA events, median and min ---
    reps = 12
    rounds = int(want.rounds)
    it_rounds_n = int(solve_kernel(H, evt.EPS, evt.MAX_ITR).rounds)
    rounds2 = int(st_runs[(torch.bfloat16, "auto")].rounds)
    tile_mb, tile2 = bt * bt * 4, bt * bt * 2
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
        "round_matvec kernel loop": (rounds + 1) * n * n * 4,
        # the launch that finds the stop reads A once more
        "round_fused kernel loop": (rounds + 2) * n * n * 4,
        # one read for the row sums, then a read and a write of A every round
        "iterated kernel solve": (1 + 2 * it_rounds_n) * n * n * 4,
        "iterated plain solve": (1 + 2 * it_rounds_n) * n * n * 4,
        # the storage solves of a matrix kept in bf16: 2 bytes an element
        "multiround kernel (stripes), bf16 A": (rounds2 + 1) * n * n * 2,
        f"triangle kernel, bf16 A, cache {auto2}":
            (rounds2 + 1) * len(kernels.sym_cache_split(n, bt, auto2)[0]) * tile2 + auto2 * tile2,
    }
    arms = {
        "multiround kernel (stripes)": lambda: solve_multiround(H, evt.EPS, evt.MAX_ITR),
        "triangle kernel, streaming": lambda: tri(H, cache_tiles=0),
        f"triangle kernel, cache {cache}": lambda: tri(H, cache_tiles=cache),
        f"dense tiled kernel, cache {dense_cache}":
            lambda: solve_multiround(H, evt.EPS, evt.MAX_ITR, cache_tiles=dense_cache),
        "matvec kernel loop": lambda: solve_matvec_kernel(H, evt.EPS, evt.MAX_ITR),
        "torch.mv loop (plain)": lambda: solve_matvec(H, evt.EPS, evt.MAX_ITR),
        "round_matvec kernel loop": lambda: solve_matvec_kernel_fused(H, evt.EPS, evt.MAX_ITR),
        "round_fused kernel loop": lambda: solve_fused_round(H, evt.EPS, evt.MAX_ITR),
        "iterated kernel solve": lambda: solve_kernel(H, evt.EPS, evt.MAX_ITR),
        "iterated plain solve": lambda: solve_xla(H, evt.EPS, evt.MAX_ITR),
        "multiround kernel (stripes), bf16 A": lambda: solve_multiround(Hq8, evt.EPS, evt.MAX_ITR),
        f"triangle kernel, bf16 A, cache {auto2}": lambda: tri(Hq8, cache_tiles=auto2),
    }
    samples = {k: [] for k in arms}
    for rep in range(reps + 1):  # rep 0 warms up; the order alternates
        order = list(arms) if rep % 2 else list(reversed(arms))
        for k in order:
            t = time_call(arms[k], reps=1, warmup=0)
            if rep:
                samples[k].append(t.min_ms)
    say(f"solve times at {n}² ({rounds} rounds, {rounds + 1} passes, {rounds + 2} in the "
        f"round_fused loop; the iterated arms {it_rounds_n} rounds), card {card}; GB/s against "
        f"the bytes each arm moves (the cache fill once):")
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

    # --- 5b. the two persistent kernels where their resident sets matter ---
    # bit identities, the launch plan, the time and the phase split of the
    # main path's one launch at 2048², 4096² and 8192²
    lim = cuda_limits(dev)
    resident_rows = {}
    for n_ in (2048, 4096, 8192):
        H_ = mats[n_]
        x_ = torch.ones(n_, device=dev)
        loop_ = solve_matvec_kernel(H_, evt.EPS, evt.MAX_ITR)
        ok = all(same(solve_multiround(H_, evt.EPS, evt.MAX_ITR, chunk=ch), loop_)
                 for ch in (1, 5, 18))
        check(ok, f"multiround at {n_}²: a chunking differs from the matvec kernel loop")
        auto_c = sym_auto_cache_tiles(n_, bt, dev)
        auto_d = sym_auto_cache_tiles(n_, bt, dev, sym=False)
        base_ = tri(H_, cache_tiles=0)
        ok_sym = all(same(tri(H_, cache_tiles=c, chunk=ch), base_)
                     for c in sorted({min(264, auto_c), auto_c}) for ch in (1, None))
        dense_ = solve_multiround(H_, evt.EPS, evt.MAX_ITR, cache_tiles=1)
        ok_dense = all(same(solve_multiround(H_, evt.EPS, evt.MAX_ITR, cache_tiles=c, chunk=ch),
                            dense_) for c in sorted({min(264, auto_d), auto_d}) for ch in (1, None))
        runs = [kernels.multiround_sym(H_, x_, x_, z, evt.MAX_ITR, cache_tiles=auto_c, tile=bt,
                                       **whole) for _ in range(2)]
        ok_again = all(torch.equal(a, b) for a, b in zip(*runs))
        say(f"{n_}²: multiround chunk 1/5/18 bit-identical to the matvec kernel loop {ok}; "
            f"multiround_sym cache 0/{min(264, auto_c)}/{auto_c}, chunk 1, bit-identical {ok_sym}; "
            f"dense tiled cache 1/{min(264, auto_d)}/{auto_d}, chunk 1, bit-identical {ok_dense}; "
            f"a repeated launch {ok_again}")
        check(ok_sym and ok_dense and ok_again, f"multiround_sym at {n_}²: an invariance broke")

        plan = kernels.multiround_launch_plan(dev, n_)
        kept = min(n_, plan.grid * plan.resident)
        in_l2 = min(n_ - kept, plan.grid * plan.l2_rows)
        row = {
            "kernel": "multiround", "n": n_, "card": card, "grid": plan.grid,
            "ring": plan.ring, "resident_rows": kept, "l2_rows": in_l2,
            "resident_mb": kept * 4 * n_ / 1e6,
            "streamed_mb_per_round": (n_ - kept - in_l2) * 4 * n_ / 1e6,
        }
        fn = lambda: kernels.multiround(H_, x_, x_, z, evt.MAX_ITR, **whole)  # noqa: E731
        row["ms"] = time_call(fn, reps=10).median_ms
        row["phases_us"] = kernel_phases.stamped_split(kernels, fn, "multiround", plan.grid, dev)
        resident_rows[("multiround", n_)] = row
        say("  " + json.dumps(row, allow_nan=False))
        for label, c, sym_ in (("streaming", 0, True), (f"cache {auto_c}", auto_c, True),
                               (f"dense tiled, cache {auto_d}", auto_d, False)):
            sp = kernels.multiround_sym_plan(dev, n_, bt, c, sym_)
            row = {
                "kernel": "multiround_sym", "arm": label, "n": n_, "card": card, "grid": sp.grid,
                "ring": sp.ring, "slots": sp.slots, "resident_tiles": sp.C, "l2_tiles": sp.l2_tiles,
                "split": sp.split, "resident_mb": sp.C * tile_mb / 1e6,
                "streamed_mb_per_round": (sp.T - sp.l2_tiles) * tile_mb / 1e6,
            }
            fn = lambda: kernels.multiround_sym(  # noqa: E731
                H_, x_, x_, z, evt.MAX_ITR, cache_tiles=c, tile=bt, sym=sym_, **whole)
            row["ms"] = time_call(fn, reps=10).median_ms
            row["phases_us"] = kernel_phases.stamped_split(kernels, fn, "multiround_sym",
                                                           sp.grid, dev)
            resident_rows[("multiround_sym", n_, label)] = row
            say("  " + json.dumps(row, allow_nan=False))
    for row in resident_rows.values():
        check(row["ms"] > 0 and row["phases_us"].get("rounds_read", 0) > 0,
              f"{row['kernel']} at {row['n']}²: no time or no phase stamps")

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

    # the fused-round path's kernels at their paths' shapes: a round of the
    # solve's first state (ev = ones, v = the row sums, m = max v), and the
    # stop at the vector suite's largest size, eps on the card
    m1 = torch.max(v1)
    big_v = (torch.rand(1 << 25, generator=gen) + 0.5).to(dev)
    timed = {
        "round_matvec": (lambda: kernels.round_matvec(H, x, v1, m1),
                         lambda: kernels.round_matvec_plain(H, x, v1, m1)),
        "round_fused": (lambda: kernels.round_fused(H, x, v1, eps=evt.EPS),
                        lambda: kernels.round_fused_plain(H, x, v1, eps=evt.EPS)),
        "stop": (lambda: kernels.stop(big_v, eps_t), lambda: kernels.stop_plain(big_v, eps_t)),
    }
    for name, fns in timed.items():
        t_it[name] = [time_call(fn, reps=20).median_ms for fn in fns] + [None]
        at = "2^25" if name == "stop" else f"{n}²"
        say(f"{name} at {at}: kernel median {t_it[name][0]:.4f} ms, plain {t_it[name][1]:.4f} ms "
            f"(no one PyTorch call computes it; matvec beside it: {t_mv.median_ms:.4f} ms)")
    del big_v

    # --- 6. the matrix-free path ---
    matrix_free_phase(dev, mats, auto, same, reset_counts, read_counts, card)

    # --- 7. the resumable, batched and differentiable solves ---
    p7 = resumable_batched_autodiff_phase(dev, mats, same, reset_counts, read_counts,
                                          hilbert_rows, card)
    say(f"resumable / batched / autodiff launches: {p7}")
    check(p7["multiround"] > 0 and p7["matvec"] > 0, "phase 7 launched no multiround or matvec")

    # --- 8. the sharded solves, one rank of NCCL on this card ---
    p8 = mesh_phase(dev, mats, reset_counts, read_counts, card)
    check(p8["launches"]["matvec"] > 0, "the mesh path launched no matvec")

    # --- 9. the headline and the tools ---
    p9 = tools_phase(dev, here, reset_counts, read_counts, card)["launches"]

    # --- 10. the dot formulation ---
    p10 = dot_phase(dev, mats, same, reset_counts, read_counts, card)

    # --- 11. the mixed formulation and the pipelined fill ---
    p11 = mixed_fill_phase(dev, mats, same, reset_counts, read_counts, card)

    # --- 12. the oracles, and a sharded A stepped through the checkpoint ---
    p12 = oracle_stepping_phase(dev, here, mats, auto, same, reset_counts, read_counts, card)
    check(p12["launches"]["matvec"] > 0, "the stepping path launched no matvec")

    # The least time the card could take: each input read once and each
    # output written once at the published memory rate, against the float32
    # operations at the published rate outside the tensor cores.  The two
    # multiround kernels run this solve's rounds + 1 passes in one launch
    # over a matrix five times the L2, so `passes_bound_ms` adds what the
    # passes stream when nothing of A stays on the chip between them, and
    # `resident_bound_ms` what they must stream when as much of A stays as
    # the card's shared memory (the kernel's resident set) and its whole L2
    # could hold: one read of A, then for every later pass the rest.
    def bound(nbytes: float, ops: float, tflops: float = H100_SXM_F32_TFLOPS) -> dict:
        t_bytes = nbytes / (H100_SXM_GBPS * 1e9) * 1e3
        t_ops = ops / (tflops * 1e12) * 1e3
        return {"bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}

    nn, vec, passes = n * n, 4 * n, rounds + 1
    tri_bytes = len(kernels.sym_cache_split(n, bt, 0)[0]) * tile_mb
    tri_streamed = len(kernels.sym_cache_split(n, bt, cache)[0]) * tile_mb
    tri2_streamed = len(kernels.sym_cache_split(n, bt, auto2)[0]) * tile2

    def mixed_bound(nbytes: float, passes: int, tf32_elems: int) -> dict:
        t_bytes = nbytes / (H100_SXM_GBPS * 1e9) * 1e3
        t_ops = (passes * 6 * tf32_elems / (H100_SXM_TF32_TFLOPS * 1e12)
                 + passes * 2 * (nn - tf32_elems) / (H100_SXM_F32_TFLOPS * 1e12)) * 1e3
        return {"bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}

    def resident_bound(total: int, on_chip: int, passes: int = passes) -> float:
        rest = max(0, total - on_chip - lim.l2_bytes)
        return bound(total + (passes - 1) * rest, 0)["bound_ms"]

    mr_row = resident_rows[("multiround", n)]
    sym_row = resident_rows[("multiround_sym", n, f"cache {cache}")]

    def at_sizes(kernel, arm=None):
        return {str(k[1]): r["ms"] for k, r in resident_rows.items()
                if k[0] == kernel and (arm is None or k[2].split(",")[0].startswith(arm))}

    def record(name, source, replaces, count, err, ms, plain_ms, library_ms, bnd, **more):
        return {"name": name, "route": "cuda", "source": f"eigen_value_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": count, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, **bnd, "library_ms": library_ms, **more}

    jk = "eigen_value_tpu/ops/pallas/kernels.py"
    say(json.dumps({"kernels": [
        record("matvec", "matvec.cu", f"{jk}:227",
               launches["matvec"] + p7["matvec"] + p8["launches"]["matvec"] + p9["matvec"]
               + p12["launches"]["matvec"],
               mv_err,
               t_mv.median_ms, t_mv_p.median_ms, t_mv_lib, bound(4 * nn + 2 * vec, 2 * nn),
               mesh_launches=p8["launches"]["matvec"], tools_launches=p9["matvec"],
               stepping_launches=p12["launches"]["matvec"],
               strided_max_abs_err=p8["strided_max_abs_err"], strided_views=p8["views"]),
        record("multiround", "multiround.cu", f"{jk}:483",
               launches["multiround"] + p7["multiround"] + p9["multiround"], mr_err,
               t_mr.median_ms, t_mr_p.median_ms, None,
               bound(4 * nn + 4 * vec, passes * 2 * nn),
               passes_bound_ms=bound(passes * 4 * nn, 0)["bound_ms"],
               resident_bound_ms=resident_bound(4 * nn, mr_row["resident_rows"] * 4 * n),
               ring_stages=mr_row["ring"],
               resident_rows=mr_row["resident_rows"], l2_rows=mr_row["l2_rows"],
               streamed_mb_per_round=mr_row["streamed_mb_per_round"],
               phases_us=mr_row["phases_us"], ms_at=at_sizes("multiround"),
               tools_launches=p9["multiround"]),
        record("multiround_sym", "multiround_sym.cu", f"{jk}:720",
               sym_launches["multiround_sym"] + p9["multiround_sym"], sym_err,
               t_sym[f"cache {cache}"].median_ms,
               t_sym_p.median_ms, None, bound(tri_bytes + 4 * vec, passes * 2 * nn),
               passes_bound_ms=bound(passes * tri_streamed + cache * tile_mb, 0)["bound_ms"],
               resident_bound_ms=resident_bound(tri_bytes, cache * tile_mb),
               ring_stages=sym_row["ring"],
               slots=sym_row["slots"], resident_tiles=sym_row["resident_tiles"],
               l2_tiles=sym_row["l2_tiles"],
               streamed_mb_per_round=sym_row["streamed_mb_per_round"],
               phases_us=sym_row["phases_us"], ms_at=at_sizes("multiround_sym", "cache"),
               tools_launches=p9["multiround_sym"]),
        record("rowsum", "rowsum.cu", f"{jk}:58", it_launches["rowsum"], it_err["rowsum"],
               *t_it["rowsum"], bound(4 * nn + vec, nn)),
        record("rowsum_bias", "rowsum.cu", "eigen_value_tpu/bench/suite.py:694",
               ladder_launches["rowsum_bias"], it_err["rowsum_bias"], *t_it["rowsum_bias"],
               bound(4 * nn + vec + 4, 2 * nn)),
        record("scale", "scale.cu", f"{jk}:181", ladder_launches["scale"], it_err["scale"],
               *t_it["scale"], bound(8 * nn + vec, 2 * nn + n)),
        record("scale_rowsum", "scale.cu", f"{jk}:277", it_launches["scale_rowsum"],
               it_err["scale_rowsum"], *t_it["scale_rowsum"], bound(8 * nn + 2 * vec, 3 * nn + n)),
        # v read once, eps, one byte out; a subtraction and a compare per element.
        # max_abs_err: every verdict of step 2d equalled stop_plain's
        record("stop", "stop.cu", f"{jk}:99", vector_launches["stop"], 0.0, *t_it["stop"],
               bound(4 * (1 << 25) + 5, 2 * (1 << 25)), size=1 << 25),
        # A, ev, v and m read, v' and ev' written; the products and sums, then
        # three operations per row for the update and the division
        record("round_matvec", "round.cu", f"{jk}:340", fused_launches["round_matvec"],
               round_err["round_matvec"], *t_it["round_matvec"],
               bound(4 * nn + 4 * vec + 4, 2 * nn + 3 * n), matvec_ms=t_mv.median_ms),
        record("round_fused", "round.cu", f"{jk}:1434", fused_launches["round_fused"],
               round_err["round_fused"], *t_it["round_fused"],
               bound(4 * nn + 4 * vec + 5, 2 * nn + 7 * n), matvec_ms=t_mv.median_ms),
        # y and ev read, ev written at 65536 (and eps, λ, rounds, converged);
        # a divide, two maxima, a subtraction, an abs and the update's divide
        # and multiply per element.  Replaces no Pallas kernel: JAX's
        # lax.while_loop leaves this glue to XLA.  max_abs_err: every case of
        # step 2f equalled round_glue_plain bit for bit
        record("round_glue", "round_glue.cu", "none (XLA's fusion in lax.while_loop)",
               launches["round_glue"] + bf16_launches["round_glue"], 0.0, *t_glue,
               bound(3 * 4 * BIG_N + 13, 7 * BIG_N), size=BIG_N,
               library_is="the host loop's PyTorch chain: y / ev, stop_check, max, ev * (v / m), "
                          "v[0]"),
        # A in bf16 (2 bytes an element), ev and every sum f32; launches are
        # the bf16 storage solves' (the f16 ones: f16_launches, printed above)
        record("matvec[bf16]", "matvec.cu", f"{jk}:227", bf16_launches["matvec"],
               st_err[torch.bfloat16]["matvec"], st_ms[f"matvec bf16 {BIG_N}"], st_plain["matvec"],
               st_ms[f"torch.mv bf16 {BIG_N}"],
               bound(2 * BIG_N * BIG_N + 8 * BIG_N, 2 * BIG_N * BIG_N), size=BIG_N,
               library_is="torch.mv(A_q, ev.to(torch.bfloat16)): it quantizes ev, another function",
               ms_at={"8192": st_ms["matvec bf16"], str(BIG_N): st_ms[f"matvec bf16 {BIG_N}"]},
               f32_ms_at_8192=st_ms["matvec f32"], f16_ms_at_8192=st_ms["matvec f16"],
               library_ms_at_8192=st_ms["torch.mv bf16"]),
        record("multiround[bf16]", "multiround.cu", f"{jk}:556", bf16_launches["multiround"],
               st_err[torch.bfloat16]["multiround"], st_ms["multiround bf16"],
               st_plain["multiround"], None,
               bound(2 * nn + 4 * vec, (mr2_adv + 1) * 2 * nn),
               passes_bound_ms=bound((mr2_adv + 1) * 2 * nn, 0)["bound_ms"],
               resident_bound_ms=resident_bound(2 * nn, min(n, mr2_plan.grid * mr2_plan.resident)
                                                * 2 * n, mr2_adv + 1),
               ring_stages=mr2_plan.ring,
               resident_rows=min(n, mr2_plan.grid * mr2_plan.resident),
               l2_rows=min(n - min(n, mr2_plan.grid * mr2_plan.resident),
                           mr2_plan.grid * mr2_plan.l2_rows),
               streamed_mb_per_round=(n - min(n, mr2_plan.grid * mr2_plan.resident)
                                      - min(n - min(n, mr2_plan.grid * mr2_plan.resident),
                                            mr2_plan.grid * mr2_plan.l2_rows)) * 2 * n / 1e6,
               f32_ms=st_ms["multiround f32"], f16_ms=st_ms["multiround f16"],
               phases_us=st_phases["multiround"]),
        record("multiround_sym[bf16]", "multiround_sym.cu", f"{jk}:889",
               bf16_launches["multiround_sym"], st_err[torch.bfloat16]["multiround_sym"],
               st_ms[f"multiround_sym bf16 cache {auto2}"], st_plain["multiround_sym"], None,
               bound(tri_bytes // 2 + 4 * vec, passes * 2 * nn),
               passes_bound_ms=bound(passes * tri2_streamed + auto2 * tile2, 0)["bound_ms"],
               resident_bound_ms=resident_bound(tri_bytes // 2, auto2 * tile2),
               ring_stages=sym2_plan.ring, slots=sym2_plan.slots, resident_tiles=sym2_plan.C,
               l2_tiles=sym2_plan.l2_tiles,
               streamed_mb_per_round=(sym2_plan.T - sym2_plan.l2_tiles) * tile2 / 1e6,
               f32_ms=st_ms[f"multiround_sym f32 cache {cache}"],
               f16_ms=st_ms[f"multiround_sym f16 cache {auto2}"],
               phases_us=st_phases["multiround_sym"]),
        # the dot formulation: the same bytes; the operations the function
        # needs, 3 TF32 products (6 flops) an element a pass, against the TF32
        # peak.  `issued_bound_ms` counts what the kernels issue: 8 columns of
        # the m16n8k8 unit (7 of them zero) times 3 products, 48 flops.
        record("multiround[dot]", "multiround.cu", f"{jk}:546-554, {jk}:631-651",
               p10["launches"]["multiround"], p10["err"]["multiround"],
               p10["ms"]["multiround dot"], p10["plain_ms"]["multiround"], None,
               bound(4 * nn + 4 * vec, p10["passes"] * 6 * nn, H100_SXM_TF32_TFLOPS),
               issued_bound_ms=bound(0, p10["passes"] * 48 * nn, H100_SXM_TF32_TFLOPS)["bound_ms"],
               helper="eigen_value_tpu_torch/csrc/mma_tf32.cuh",
               vpu_ms=p10["ms"]["multiround vpu"], bf16_ms=p10["ms"]["multiround bf16 dot"],
               bf16_vpu_ms=p10["ms"]["multiround bf16 vpu"], passes=p10["passes"]),
        record("multiround_sym[dot]", "multiround_sym.cu", f"{jk}:890-915, {jk}:948-965",
               p10["launches"]["multiround_sym"], p10["err"]["multiround_sym"],
               p10["ms"]["multiround_sym dot"], p10["plain_ms"]["multiround_sym"], None,
               bound(tri_bytes + 4 * vec, p10["passes"] * 6 * nn, H100_SXM_TF32_TFLOPS),
               issued_bound_ms=bound(0, p10["passes"] * 48 * nn, H100_SXM_TF32_TFLOPS)["bound_ms"],
               helper="eigen_value_tpu_torch/csrc/mma_tf32.cuh", cache_tiles=p10["auto"],
               vpu_ms=p10["ms"]["multiround_sym vpu"],
               bf16_ms=p10["ms"]["multiround_sym bf16 dot"],
               bf16_vpu_ms=p10["ms"]["multiround_sym bf16 vpu"],
               bf16_cache_tiles=p10["auto_q"], bf16_vpu_cache_tiles=p10["auto_q_vpu"],
               dense_max_abs_err=p10["err"]["multiround_sym dense"], passes=p10["passes"]),
        # mixed: the same bytes; its m resident tiles take 6 TF32 flops an
        # element a pass (each tile element serves two terms), the rest 2 f32
        # flops, the two units' times added
        record("multiround_sym[mixed]", "multiround_sym.cu", f"{jk}:981-1016, {jk}:1237-1283",
               p11["launches"]["mixed"], p11["err"]["mixed"], p11["ms"]["mixed f32"],
               p11["plain_ms"]["mixed"], None,
               mixed_bound(tri_bytes + 4 * vec, p11["passes"], 2 * p11["m"] * bt * bt),
               helper="eigen_value_tpu_torch/csrc/mma_tf32.cuh", cache_tiles=p11["auto"],
               mxu_tiles=p11["m"], vpu_ms=p11["ms"]["vpu f32"],
               bf16_ms=p11["ms"]["mixed bf16"], bf16_vpu_ms=p11["ms"]["vpu bf16"],
               bf16_cache_tiles=p11["auto_q"], bf16_mxu_tiles=p11["m_q"],
               bf16_bound_ms=mixed_bound(tri_bytes // 2 + 4 * vec, p11["passes"],
                                         2 * p11["m_q"] * bt * bt)["bound_ms"],
               passes=p11["passes"]),
        record("multiround_sym[pipelined]", "multiround_sym.cu",
               f"{jk}:779-800, {jk}:943-946, {jk}:1224-1236",
               p11["launches"]["pipelined"], p11["err"]["pipelined"],
               p11["ms"]["pipelined f32"], p11["plain_ms"]["pipelined"], None,
               bound(tri_bytes + 4 * vec, p11["passes"] * 2 * nn), cache_tiles=p11["auto"],
               prologue_fill_ms=p11["ms"]["vpu f32"], bf16_ms=p11["ms"]["pipelined bf16"],
               bf16_prologue_fill_ms=p11["ms"]["vpu bf16"],
               mixed_ms=p11["ms"]["mixed + pipelined f32"],
               mixed_bf16_ms=p11["ms"]["mixed + pipelined bf16"],
               dot_ms=p11["ms"]["dot + pipelined f32"],
               dot_prologue_fill_ms=p11["ms"]["dot f32"],
               dot_bf16_ms=p11["ms"]["dot + pipelined bf16"],
               dot_bf16_prologue_fill_ms=p11["ms"]["dot bf16"],
               fill_us=p11["fill_us"], passes=p11["passes"],
               passes_bound_ms=bound(p11["passes"] * tri_streamed + cache * tile_mb,
                                     0)["bound_ms"],
               resident_bound_ms=resident_bound(tri_bytes, cache * tile_mb)),
    ]}, allow_nan=False))
    say(f"wall: {time.perf_counter() - t_start:.1f} s")
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
