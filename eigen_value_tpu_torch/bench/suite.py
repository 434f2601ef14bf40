"""Benchmark suite (counterpart of ``eigen_value_tpu.bench.suite``): the
end-to-end sweep over the solve forms (``bench_e2e``), the per-kernel ladder
of the O(n²) passes (``bench_kernels``), the O(n) vector kernels
(``bench_vector_kernels``), the matrix-free operators beside the dense
solve (``bench_operator``), the batched solve (``bench_batched``), the
sharded solves in the world the process was launched in (``bench_sharded``)
and in ``mh_worker`` groups (``bench_multihost``), the max-size single-card
rows (``bench_large``), the card's drift over time (``bench_drift``), the
exchange calibration of the scaling model (``bench_exchange_calibration``)
and the native C++ runtime on the CPU (``bench_native``).

Each kernel rung is timed marginally, (T(k+1 chained) − T(1)) / k with CUDA
events (``utils.timing.time_marginal``), and reported with its achieved
bandwidth against the card's published memory rate.  The rows keep the JAX
suite's names and keys so the two tables read side by side: ``*_xla`` is
the one-call PyTorch expression (the library's kernels), ``*_pallas`` the
port's hand-written kernel.  Times are device times: without a CUDA card
the suite raises.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import fixtures
from ..api import auto_cache_tiles, route
from ..config import EPS, MAX_ITR, SolverConfig
from ..ops.cuda import kernels
from ..ops.solver import solve_xla, stop_check
from ..ops.solver_kernel import solve_kernel
from ..ops.solver_matvec import solve_matvec, solve_matvec_kernel, solve_multiround
from ..utils.timing import card_state, detect_peak_gbps, roofline_pct, time_call, time_marginal

MATRIX_DIMS = [1 << p for p in range(7, 14)]  # 128 .. 8192
VECTOR_SIZES = [1 << p for p in range(16, 26, 3)]  # 2^16 .. 2^25
#: Seed of the vector suite's v (an explicit generator: one v on every run).
VECTOR_SEED = 0

#: Scale of the row-sum chain's bias (times v[0]): too small to change a
#: sum, enough to make each launch depend on the one before.
_BIAS_SCALE = 1e-38

Step = Callable[[int, tuple], tuple]


def kernel_steps(n: int, device) -> Dict[str, Tuple[Step, tuple, int]]:
    """The ladder's rungs at dim ``n`` on ``device``, in order: name ->
    ``(step, init, bytes)`` with ``step(i, state) -> state`` one application
    and ``bytes`` what it must move (A read once; read and written once by
    the updates).

      rowsum_xla -> rowsum_pallas -> scale_xla -> scale_pallas ->
      scale_rowsum_pallas (fused) -> matvec_xla -> matvec_pallas.

    The read-only rungs share one Hilbert matrix.  The updating rungs
    rewrite their state in place, so each gets a copy of its own; with the
    constant vector of the ``scale`` rungs the factor (1/c)·c stays 1 to
    rounding, and the ``scale_rowsum`` chain is the solve's own iteration.
    On a CPU device the kernel rungs run their plain versions (what the
    tests step through).
    """
    A = fixtures.hilbert_matrix(n, device=device)
    v = kernels.rowsum_plain(A)
    ones = torch.ones(n, dtype=torch.float32, device=device)
    const = fixtures.stop_success_vector(n, device=device)
    tiny = torch.tensor(_BIAS_SCALE, dtype=torch.float32, device=device)
    nbytes = n * n * 4

    def rowsum_xla_step(i, s):
        Ai, _ = s
        return (Ai, kernels.rowsum_plain(Ai))

    def rowsum_pallas_step(i, s):
        # the bias (a device scalar made from the previous sums) threads the
        # chain through the kernel's own operand; nothing is read back
        Ai, vi = s
        return (Ai, kernels.rowsum_bias(Ai, vi[0] * tiny))

    def scale_xla_step(i, s):
        Ai, vi = s
        return (kernels.scale_plain(Ai, vi, out=Ai), vi)

    def scale_pallas_step(i, s):
        Ai, vi = s
        return (kernels.scale(Ai, vi, out=Ai), vi)

    def scale_rowsum_step(i, s):
        return kernels.scale_rowsum(s[0], s[1], out=s[0])

    def matvec_xla_step(i, s):
        Ai, xi = s
        return (Ai, kernels.matvec_plain(Ai, xi) / xi)

    def matvec_pallas_step(i, s):
        Ai, xi = s
        return (Ai, kernels.matvec(Ai, xi) / xi)

    return {
        "rowsum_xla": (rowsum_xla_step, (A, v), nbytes),
        "rowsum_pallas": (rowsum_pallas_step, (A, v), nbytes),
        "scale_xla": (scale_xla_step, (A.clone(), const), 2 * nbytes),
        "scale_pallas": (scale_pallas_step, (A.clone(), const), 2 * nbytes),
        "scale_rowsum_pallas": (scale_rowsum_step, (A.clone(), v), 2 * nbytes),
        "matvec_xla": (matvec_xla_step, (A, ones), nbytes),
        "matvec_pallas": (matvec_pallas_step, (A, ones), nbytes),
    }


def bench_kernels(dims: List[int] = MATRIX_DIMS, k: int = 64) -> List[dict]:
    """Per-kernel marginal timings for the O(n²) passes on the CUDA card:
    one row per rung of :func:`kernel_steps` and dim, with ``ms``, ``gbps``
    and ``roofline_pct`` (None where the marginal vanished or the card's
    rate is not in the table: RFC-valid JSON, never NaN)."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_kernels measures the CUDA device; none is available")
    device = torch.device("cuda")
    peak = detect_peak_gbps(device)
    rows = []
    for n in dims:
        for name, (step, init, nbytes) in kernel_steps(n, device).items():
            ms = time_marginal(step, init, k=k)
            pct = roofline_pct(ms, nbytes, peak) if ms > 0 else None
            rows.append(
                {
                    "bench": "kernel",
                    "kernel": name,
                    "dim": n,
                    "ms": ms,
                    "gbps": nbytes / (ms * 1e-3) / 1e9 if ms > 0 else None,
                    "roofline_pct": None if pct != pct else pct,
                }
            )
    return rows


# --- the end-to-end sweep ------------------------------------------------------

#: The tiled rungs' (tile edge, symmetric?): one table for the backends
#: below and the skip predicate.  The edge is the port's own
#: (``kernels.SYM_TILE``: a tile must fit a block's shared memory), not the
#: JAX suite's, which were tuned to a TPU's memory (1024 for its bf16 rung).
TILED_RUNGS = {
    "multiround_sym": (kernels.SYM_TILE, True),
    "multiround_sym_bf16": (kernels.SYM_TILE, True),
    "multiround_sym_cached": (kernels.SYM_TILE, True),
    "multiround_cached": (kernels.SYM_TILE, False),
}

#: The storage type of the reduced-precision rungs.  ``bench_e2e`` quantizes
#: their matrix once, outside the timing, as a caller of the storage mode
#: keeps it (the JAX suite's rungs cast inside the timed solve).
STORAGE_RUNGS = {"matvec_bf16": torch.bfloat16, "multiround_sym_bf16": torch.bfloat16}


def _tiled(name: str, cached: bool) -> Callable:
    tile, sym = TILED_RUNGS[name]
    storage = STORAGE_RUNGS.get(name)

    def solve(A):
        n = A.shape[0]
        if sym:
            cfg = SolverConfig(backend="multiround", symmetric=True, block_rows=tile,
                               storage_dtype=storage, cache_tiles=None if cached else 0)
        else:  # the dense tiled kernel at the card's budget, which no route sizes
            cache = auto_cache_tiles(n, kernels.sym_tile(n, tile), A.device, sym=False)
            cfg = SolverConfig(backend="multiround", block_rows=tile, storage_dtype=storage,
                               cache_tiles=cache)
        return route(cfg, n, A.device).solve(A)

    return solve


#: The JAX suite's rungs, by its names and in its order.  ``pallas_fused``
#: is the iterated solve over the kernels, ``matvec_pallas`` the matvec
#: kernel loop, ``matvec_bf16`` that loop over A in bf16, and
#: ``multiround_sym_bf16`` the triangle kernel over bf16 tiles with the
#: card's 2-byte auto cache (reduced-precision storage: the kernels'
#: contract, not JAX's ``solve_matvec_storage``); the multiround rungs run
#: their whole budget in one launch (the kernels leave their round loop
#: once the solve is frozen, so no chunk needs tuning to the round count).
E2E_BACKENDS: Dict[str, Callable] = {
    "xla": lambda A: solve_xla(A, EPS, MAX_ITR),
    "pallas_fused": lambda A: solve_kernel(A, EPS, MAX_ITR),
    "matvec": lambda A: solve_matvec(A, EPS, MAX_ITR),
    "matvec_pallas": lambda A: solve_matvec_kernel(A, EPS, MAX_ITR),
    "matvec_bf16": lambda A: solve_matvec_kernel(A, EPS, MAX_ITR,
                                                 storage_dtype=STORAGE_RUNGS["matvec_bf16"]),
    "multiround": lambda A: solve_multiround(A, EPS, MAX_ITR),
    "multiround_sym": _tiled("multiround_sym", cached=False),
    "multiround_sym_bf16": _tiled("multiround_sym_bf16", cached=True),
    "multiround_sym_cached": _tiled("multiround_sym_cached", cached=True),
    "multiround_cached": _tiled("multiround_cached", cached=True),
}

_SKIP_NOT_TILEABLE = (
    "tiled rung not measurable at this dim (no 128-aligned square tile "
    "divides n, or the auto cache sizes to zero): the stripes/dense rungs "
    "keep the job"
)


def _sym_alignable(backend: str, n: int, device) -> bool:
    """False when a tiled rung cannot run at dim ``n`` on ``device``: no
    128-aligned square tile divides n, or (cached rungs) the card's auto
    cache sizes to zero, so the rung would measure the uncached kernel
    under the cached label.  ``bench_e2e`` records a skip row instead."""
    if backend not in TILED_RUNGS:
        return True
    tile, sym = TILED_RUNGS[backend]
    bt = kernels.sym_tile(n, tile)
    return bt is not None and (backend != "multiround_cached"
                               or auto_cache_tiles(n, bt, torch.device(device), sym=sym) > 0)


def _e2e_skip(backend: str, n: int, device) -> Optional[str]:
    """Why rung ``backend`` gives a skip row at dim ``n`` on ``device``, or
    None when it runs."""
    return None if _sym_alignable(backend, n, device) else _SKIP_NOT_TILEABLE


def _e2e_chain_step(fn: Callable) -> Step:
    """Chain step for marginal e2e timing: one solve of the state's matrix.
    Eager PyTorch hoists nothing and every solve reads the card back before
    it returns, so the chain needs no data dependence from solve to solve;
    the state keeps the last eigenvalue so a caller can look at it."""

    def step(i, state):
        A, _ = state
        return (A, fn(A).eigenvalue)

    return step


def _marginal_resolved(step, init, k: int, reps: int = 5, min_signal_ms: float = 1.0,
                       max_k: int = 1024):
    """``time_marginal`` with resolution escalation: the chain length
    quadruples until the long-minus-short difference (``ms · k``) clears
    ``min_signal_ms``, so a reported time is never the clamped-to-zero
    artifact of a chain too short to resolve.  CUDA events tick at about
    half a microsecond and a chain's host-side start varies by tens of
    microseconds, so 1 ms of signal holds both under a few percent.
    Returns ``(device_ms | None, k_used, resolved)``: when even ``max_k``
    steps stay under the floor the time is None with ``resolved=False``."""
    while True:
        ms = time_marginal(step, init, k=k, reps=reps)
        if ms * k >= min_signal_ms:
            return ms, k, True
        if k >= max_k:
            return None, k, False
        k = min(k * 4, max_k)


def _e2e_chain_len(n: int) -> int:
    """First chain length at dim ``n``.  A solve here reads the card back at
    least once, which alone costs tens of microseconds, and CUDA events
    resolve half a microsecond: a few solves already clear the signal floor
    of :func:`_marginal_resolved`, and the escalation covers the rest.
    (The JAX suite chained up to 32 solves to average out milliseconds of
    launch jitter on a remote device; there is no such term here.)"""
    return 8 if n <= 1024 else 4


def bench_e2e(
    dims: List[int] = MATRIX_DIMS,
    backends: Optional[List[str]] = None,
    reps: int = 5,
) -> List[dict]:
    """End-to-end Hilbert solves on the CUDA card, one row per rung of
    :data:`E2E_BACKENDS` and dim, with the JAX suite's keys.

    ``ms`` is the median of ``reps`` single solves, each between its own
    pair of CUDA events.  ``device_ms`` is the marginal time of one solve in
    a chain of solves (``time_marginal`` with :func:`_marginal_resolved`'s
    escalation).  A solve of this port has host reads inside it (the stop
    of a loop round, the ``advanced`` count of a multiround launch), so
    ``device_ms`` is the time of one solve INCLUDING the card's idle gaps
    while the host works, not the card's busy time: ``utils/trace.py``
    separates the two.  ``elems_per_s`` counts n² elements per round.  A
    rung that cannot run gives a row with ``skipped`` and no time.  The
    bf16 rungs solve the Hilbert matrix quantized to bf16 once, before the
    timing, and their ``rounds_ok`` allows the table ±1, as the JAX
    suite's."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_e2e measures the CUDA device; none is available")
    device = torch.device("cuda")
    rows = []
    for name in backends or list(E2E_BACKENDS):
        fn = E2E_BACKENDS[name]
        for n in dims:
            skipped = _e2e_skip(name, n, device)
            if skipped:
                rows.append({"bench": "e2e", "backend": name, "dim": n, "skipped": skipped})
                continue
            A = fixtures.hilbert_matrix(n, device=device).to(STORAGE_RUNGS.get(name, torch.float32))
            res = fn(A)  # build and warm up
            rounds = int(res.rounds)
            ms = time_call(lambda: fn(A), reps=reps).median_ms
            dev_ms, chain_k, resolved = _marginal_resolved(
                _e2e_chain_step(fn), (A, res.eigenvalue), k=_e2e_chain_len(n), reps=reps
            )
            row = {
                "bench": "e2e",
                "backend": name,
                "dim": n,
                "ms": ms,
                "device_ms": dev_ms,
                "ms_per_round": dev_ms / max(rounds, 1) if resolved else None,
                "elems_per_s": rounds * n * n / (dev_ms * 1e-3) if resolved else None,
                "rounds": rounds,
                "eigenvalue": float(res.eigenvalue),
                "rounds_ok": abs(rounds - fixtures.HILBERT_ROUNDS.get(n, rounds))
                <= (1 if name in STORAGE_RUNGS else 0),
                "chain_k": chain_k,
            }
            if not resolved:
                row["below_resolution"] = True
            rows.append(row)
    return rows


# --- the matrix-free operators -------------------------------------------------

#: Off-diagonal entries per row of the sparse ELL rung (its diagonal is one more).
ELL_DEG = 8
#: Past this λ_B·λ_C the Kronecker rung takes the relative stop: f32 noise
#: (~λ·(p+q)·2⁻²⁴) crowds the absolute eps = 1e-3 (the JAX suite's rule).
KRON_RELATIVE_ABOVE = 500.0

#: ``(solve(ev0) -> SolveResult, ok(result) -> bool, extra row keys)``
OperatorRung = Tuple[Callable, Callable, dict]


def operator_rungs(n: int, device) -> Dict[str, OperatorRung]:
    """The operator suite's rungs at dim ``n`` on ``device``, in the JAX
    suite's order and names:

      hankel_fft (Hilbert as an FFT Hankel operator; rounds within ±1 of
      the table) -> kron_{p}x{q} (B ⊗ C with p·q = n, random positive
      factors; λ within 2e-3 of λ_B·λ_C) -> sparse_ell_deg9 (a random
      nonnegative matrix with a positive diagonal and eight off-diagonal
      entries a row, through the ELL gather; residual through the operator
      within 1e-2·max(λ, 1)).

    The Hilbert and ELL inputs are the JAX suite's (the ELL triplets come
    from ``numpy.random.default_rng(n)``); the Kronecker factors are
    U[0.1, 1) from a ``torch.Generator`` seeded n, not JAX's ``jax.random``
    draw.  On a CPU device every rung runs its plain form (what the tests
    step through)."""
    from ..ops.solver_matvec import solve_operator
    from ..ops.structured import ell_from_coo, ell_matvec, hilbert_matvec, kron_matvec

    def rung(mv, eps_mode="absolute"):
        return lambda ev0: solve_operator(mv, n, EPS, MAX_ITR, ev0=ev0, eps_mode=eps_mode,
                                          device=device)

    rungs = {}
    want = fixtures.HILBERT_ROUNDS.get(n)
    rungs["hankel_fft"] = (
        rung(hilbert_matvec(n, device=device)),
        lambda r: abs(int(r.rounds) - (int(r.rounds) if want is None else want)) <= 1,
        {},
    )
    p = 1 << ((n - 1).bit_length() // 2)  # p·q = n, p ≤ q, powers of two
    q = n // p
    if p * q == n:
        g = torch.Generator().manual_seed(n)
        B = (torch.rand(p, p, generator=g) * 0.9 + 0.1).to(device)
        C = (torch.rand(q, q, generator=g) * 0.9 + 0.1).to(device)
        lam_prod = float(solve_matvec(B, EPS, MAX_ITR).eigenvalue) * float(
            solve_matvec(C, EPS, MAX_ITR).eigenvalue)
        eps_mode = "relative" if lam_prod > KRON_RELATIVE_ABOVE else "absolute"
        rungs[f"kron_{p}x{q}"] = (
            rung(kron_matvec(B, C), eps_mode),
            lambda r: bool(r.converged)
            and abs(float(r.eigenvalue) - lam_prod) <= 2e-3 * lam_prod,
            {"eps_mode": eps_mode},
        )
    rng = np.random.default_rng(n)
    src = np.repeat(np.arange(n), ELL_DEG)
    dst = (src + 1 + rng.integers(0, n - 1, size=src.shape)) % n
    vals = (rng.random(src.shape[0]) + 0.1).astype(np.float32)
    ell = ell_matvec(*ell_from_coo(np.concatenate([src, np.arange(n)]),
                                   np.concatenate([dst, np.arange(n)]),
                                   np.concatenate([vals, np.ones(n, np.float32)]), n,
                                   device=device))

    def ell_ok(r):
        lam = float(r.eigenvalue)
        resid = float(torch.max(torch.abs(ell(r.eigenvector) - r.eigenvalue * r.eigenvector)))
        return bool(r.converged) and resid <= 1e-2 * max(lam, 1.0)

    rungs[f"sparse_ell_deg{ELL_DEG + 1}"] = (rung(ell), ell_ok, {})
    return rungs


def _operator_chain_step(fn: Callable, n: int, device) -> Step:
    """Chain step for marginal matrix-free timing (the JAX suite's): the
    start vector carries the previous solve's λ and ``eigenvector[0]``,
    scaled to nothing, so each solve depends on the one before.  The state
    is that sum (a number before the first step)."""

    def step(i, acc):
        sc = 1.0 + acc * _BIAS_SCALE
        r = fn(torch.ones(n, dtype=torch.float32, device=device) * sc)
        return r.eigenvalue + r.eigenvector[0] * _BIAS_SCALE

    return step


def bench_operator(dims: List[int] = MATRIX_DIMS, reps: int = 5) -> List[dict]:
    """Matrix-free operators against the dense solve on the CUDA card: one
    row per rung of :func:`operator_rungs` and dim (all dims of a rung
    together, as in the JAX suite), then the dense ``matvec`` rows of
    :func:`bench_e2e` for the same dims.

    ``device_ms`` is the marginal time of one solve in a chain of solves
    (with :func:`_marginal_resolved`'s escalation): like the e2e rows, it
    includes the card's idle gaps while the host reads each round's stop.
    ``rounds_ok`` is the rung's check; the Kronecker rows record their stop
    in ``eps_mode``."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_operator measures the CUDA device; none is available")
    device = torch.device("cuda")
    rows = []
    for n in dims:
        for name, (solve, ok, extra) in operator_rungs(n, device).items():
            res = solve(None)  # the all-ones start; builds and warms up
            rounds = int(res.rounds)
            dev_ms, chain_k, resolved = _marginal_resolved(
                _operator_chain_step(solve, n, device), 0.0, k=4, reps=reps)
            row = {
                "bench": "operator",
                "backend": name,
                "dim": n,
                "device_ms": dev_ms,
                "ms_per_round": dev_ms / max(rounds, 1) if resolved else None,
                "rounds": rounds,
                "eigenvalue": float(res.eigenvalue),
                **extra,
                "rounds_ok": ok(res),
                "chain_k": chain_k,
            }
            if not resolved:
                row["below_resolution"] = True
            rows.append(row)
    # a rung's dims together, in the rungs' order (sorted is stable: dims stay in order)
    rows.sort(key=lambda r: ("hankel", "kron", "sparse").index(r["backend"].split("_")[0]))
    return rows + [dict(r, bench="operator")
                   for r in bench_e2e(dims, backends=["matvec"], reps=reps)]


# --- the O(n) vector kernels ---------------------------------------------------


def vector_steps(n: int, device) -> Dict[str, Tuple[Step, tuple, int]]:
    """The vector suite's rows at size ``n`` on ``device``: name ->
    ``(step, init, bytes)`` as :func:`kernel_steps` gives them.

      find_max (read v) -> eigen_vector (read v and ev, write ev) ->
      stop (the plain expression, read v) -> stop_pallas (the kernel).

    v is U[0.5, 1.5) from a generator with a fixed seed; the second slot of
    a state holds the step's result.  Eager PyTorch hoists nothing, so the
    read-only steps need no dependence from one application to the next;
    ``stop_pallas`` reads its eps from a 0-d tensor on the device, as a
    chain on the card does.  On a CPU device it runs the plain version
    (what the tests step through)."""
    gen = torch.Generator().manual_seed(VECTOR_SEED)
    v = (torch.rand(n, generator=gen, dtype=torch.float32) + 0.5).to(device)
    ev = torch.ones(n, dtype=torch.float32, device=device)
    eps = torch.tensor(EPS, dtype=torch.float32, device=device)
    none = torch.zeros((), dtype=torch.float32, device=device)

    def find_max_step(i, s):
        return (s[0], torch.max(s[0]))

    def eigen_vector_step(i, s):
        vi, evi = s
        return (vi, evi * (vi / torch.max(vi)))

    def stop_step(i, s):
        return (s[0], stop_check(s[0], EPS))

    def stop_pallas_step(i, s):
        return (s[0], kernels.stop(s[0], eps))

    return {
        "find_max": (find_max_step, (v, none), n * 4),
        "eigen_vector": (eigen_vector_step, (v, ev), 3 * n * 4),
        "stop": (stop_step, (v, none), n * 4),
        "stop_pallas": (stop_pallas_step, (v, none), n * 4),
    }


def bench_vector_kernels(sizes: List[int] = VECTOR_SIZES, k: int = 256) -> List[dict]:
    """The O(n) kernels (find_max, the eigenvector update, the stop as
    PyTorch's expression and as the hand-written kernel) at vector sizes
    2^16..2^25 on the CUDA card: one row per step of :func:`vector_steps`
    and size, with ``ms`` (marginal, chained), ``gbps`` and
    ``roofline_pct``.

    ``time_marginal`` measures the card only while the host enqueues faster
    than the card works.  At 2^16 (256 KB) it does not: a step's kernels
    take a few microseconds and its Python about as long or longer, so that
    row is the host's cost per step and an upper bound on the card's; the
    row is reported as measured, not hidden.  The eigen_vector step is
    three PyTorch kernels (max, divide, multiply) and moves more than the
    3 n floats it is charged."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_vector_kernels measures the CUDA device; none is available")
    device = torch.device("cuda")
    peak = detect_peak_gbps(device)
    rows = []
    for n in sizes:
        for name, (step, init, nbytes) in vector_steps(n, device).items():
            ms = time_marginal(step, init, k=k)
            pct = roofline_pct(ms, nbytes, peak) if ms > 0 else None
            rows.append(
                {
                    "bench": "vector_kernel",
                    "kernel": name,
                    "size": n,
                    "ms": ms,
                    "gbps": nbytes / (ms * 1e-3) / 1e9 if ms > 0 else None,
                    "roofline_pct": None if pct != pct else pct,
                }
            )
    return rows


# --- the batched solve ----------------------------------------------------------

#: Seed of the batched suite's matrices (numpy's generator: the same batch on
#: every device; the JAX suite draws its own with ``jax.random.key(4)``).
BATCHED_SEED = 4


def batched_workload(batch: int, dim: int, device) -> torch.Tensor:
    """BASELINE config 4's input: ``batch`` independent positive ``dim``²
    float32 matrices, entries uniform in [0.05, 1), drawn a matrix at a time
    from ``numpy.random.default_rng(BATCHED_SEED)``."""
    rng = np.random.default_rng(BATCHED_SEED)
    As = torch.empty(batch, dim, dim, dtype=torch.float32, device=device)
    for b in range(batch):
        mat = rng.random((dim, dim), dtype=np.float32) * np.float32(0.95) + np.float32(0.05)
        As[b] = torch.from_numpy(mat)
    return As


def batched_row(As: torch.Tensor, res, device_ms: float) -> dict:
    """The JAX suite's row for one batched solve: solves/s from the marginal
    time of a whole batch, the per-matrix round histogram, and the batched
    eigen-pair check ``rounds_ok``: every matrix converged and max over the
    batch of |A·v − λ·v| / λ ≤ 2e-3 (float64; the reference's atol 1e-3 at
    λ ≈ 2.6, scaled to these λ ≈ dim/2)."""
    v = res.eigenvector.double()
    lam = res.eigenvalue.double()
    resid = (torch.bmm(As.double(), v[:, :, None])[:, :, 0] - lam[:, None] * v).abs().amax(1)
    rel = float((resid / lam).max())
    rounds, counts = np.unique(res.rounds.cpu().numpy(), return_counts=True)
    converged = bool(res.converged.all())
    return {
        "bench": "batched",
        "batch": As.shape[0],
        "dim": As.shape[1],
        "device_ms_per_batch": device_ms,
        "solves_per_s": As.shape[0] / max(device_ms * 1e-3, 1e-9),
        "rounds_hist": {int(r): int(c) for r, c in zip(rounds, counts)},
        "all_converged": converged,
        "max_rel_residual": rel,
        "lambda_range": [float(lam.min()), float(lam.max())],
        "rounds_ok": converged and rel <= 2e-3,
    }


def bench_batched(batch: int = 256, dim: int = 512, reps: int = 5, chain: int = 4) -> List[dict]:
    """Batched throughput, BASELINE config 4: ``batch`` independent random
    positive ``dim``² float32 solves through ``parallel.solve_batched`` on the
    CUDA card (the reference's analog: its wrapper test's Python loop over
    independent matrices).  ``device_ms_per_batch`` is the marginal time of
    one batch in a chain (``time_marginal``); each solve's start vector
    carries the previous one's λ, scaled to nothing.  Like the e2e rows it
    includes the card's idle time while the host reads a round's flag."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_batched measures the CUDA device; none is available")
    from ..parallel.batched import solve_batched

    device = torch.device("cuda")
    As = batched_workload(batch, dim, device)
    res = solve_batched(As, EPS, MAX_ITR)

    def step(i, acc):
        sc = 1.0 + acc * _BIAS_SCALE
        r = solve_batched(As, EPS, MAX_ITR,
                          ev0=torch.ones(dim, dtype=torch.float32, device=As.device) * sc)
        return r.eigenvalue[0] + r.eigenvector[0, 0] * _BIAS_SCALE

    return [batched_row(As, res, time_marginal(step, 0.0, k=chain, reps=reps))]


# --- the sharded and multi-process solves ------------------------------------


def balanced_factorization(p: int) -> tuple:
    """(pr, pc) with pr·pc = p and pr the largest divisor ≤ √p: the
    squarest mesh shape (the JAX package's ``utils.scaling_model``)."""
    pr = 1
    for cand in range(1, int(p**0.5) + 1):
        if p % cand == 0:
            pr = cand
    return pr, p // pr


def exchange_times(group, n: int, device, blocks: int = 15, calls: int = 40) -> dict:
    """Host µs a call of each exchange of a round on ``group`` (the process
    group of one mesh dimension), each call followed by the read of one
    element, as the loops read a flag every round: an all-gather of ``n``
    floats (the gathered body's v), a MAX all-reduce of 3 floats (the
    ring's stop, max and λ), the ring's hop of ``n`` floats to the next
    rank, and, as the baseline, a sum of the ``n`` floats.  The median over
    ``blocks`` blocks of ``calls`` calls, the arms in turn within a block;
    one block first, untimed."""
    import statistics
    import time

    import torch.distributed as dist

    from ..parallel._collectives import all_gather, all_reduce_max, ppermute

    size = dist.get_world_size(group)
    x, three = torch.ones(n, device=device), torch.ones(3, device=device)
    fns = {
        "sum (baseline)": lambda: x.sum(),
        "all_gather": lambda: all_gather(x, group),
        "max_all_reduce": lambda: all_reduce_max(three, group),
        "ring_hop": lambda: ppermute(x, [(i, (i + 1) % size) for i in range(size)], group),
    }
    samples = {k: [] for k in fns}
    for b in range(blocks + 1):
        for k, fn in fns.items():
            dist.barrier(group)
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            for _ in range(calls):
                bool(fn().reshape(-1)[0] > 0)
            if b:
                samples[k].append((time.perf_counter() - t0) / calls * 1e6)
    return {k: statistics.median(v) for k, v in samples.items()}


def bench_sharded(dim: int = 4096, reps: int = 5) -> List[dict]:
    """The sharded solves of Hilbert ``dim``² in the world this process was
    launched in: P is the process group's size (``torchrun
    --nproc_per_node=K``), or 1 with a one-rank NCCL group started here.
    The gathered, ring and 2-D solves (the 2-D one on the squarest pr × pc
    mesh of P); ms per solve with CUDA events on this rank after a barrier
    (a solve ends on every rank together: its loop runs in lockstep),
    rounds against the table, elements/s per card; then one ``exchange``
    row: the host µs of each exchange of a round alone, on the rows group
    (:func:`exchange_times`, vectors of ``dim / P`` floats).  One P per
    launch: the rows carry P and claim no scaling."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_sharded measures CUDA devices; none is available")
    import os

    import torch.distributed as dist

    from ..parallel import (
        make_mesh2d,
        make_row_mesh,
        multihost,
        solve_sharded_2d,
        solve_sharded_matvec,
        solve_sharded_matvec_ring,
    )

    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        multihost.initialize()  # launched by torchrun: its env:// variables
    rows_mesh = make_row_mesh()
    p = dist.get_world_size()
    pr, pc = balanced_factorization(p)
    mesh2d = make_mesh2d(pr, pc)
    A = fixtures.hilbert_matrix(dim, device=torch.device("cuda", torch.cuda.current_device()))
    solvers = {
        "matvec_gather": (lambda: solve_sharded_matvec(A, rows_mesh), f"{p}"),
        "matvec_ring": (lambda: solve_sharded_matvec_ring(A, rows_mesh), f"{p}"),
        "matvec_2d": (lambda: solve_sharded_2d(A, mesh2d), f"{pr}x{pc}"),
    }
    out = []
    for name, (fn, shape) in solvers.items():
        rounds = int(fn().rounds)  # also sets up the communicators
        dist.barrier()
        ms = time_call(fn, reps=reps).median_ms
        out.append({
            "bench": "sharded", "solver": name, "dim": dim, "shards": p, "mesh": shape,
            "ms": ms, "rounds": rounds,
            "rounds_ok": rounds == fixtures.HILBERT_ROUNDS.get(dim, rounds),
            "elems_per_s_per_chip": rounds * dim * dim / (ms * 1e-3) / p,
            "card": torch.cuda.get_device_name(), "transport": "nccl",
        })
    ex = exchange_times(rows_mesh.get_group("rows"), dim // p, A.device)
    out.append({"bench": "sharded", "solver": "exchange", "dim": dim, "shards": p,
                "mesh": f"{p}", "exchange_us": ex, "card": torch.cuda.get_device_name(),
                "transport": "nccl"})
    return out


def run_mh_workers(nprocs: int, dim: int, reps: int, solvers=("gather",), device: str = "cuda",
                   nodes: Optional[int] = None, timeout_s: float = 600.0,
                   extra_args=()) -> List[dict]:
    """Start ``nprocs`` processes of ``bench/mh_worker.py`` as one group
    (rank 0 at a free port of localhost) and return each one's JSON record;
    ``extra_args`` go to every worker (``--measure-exchange``).  A failed or
    timed-out worker raises, and its siblings are killed rather than left
    waiting in the group's rendezvous."""
    import json
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [root, env.get("PYTHONPATH")]))
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, "-m", "eigen_value_tpu_torch.bench.mh_worker", "--device", device,
           "--num-processes", str(nprocs), "--coordinator", f"localhost:{port}",
           "--dim", str(dim), "--reps", str(reps), "--solver", *solvers]
    if nodes:
        cmd += ["--nodes", str(nodes)]
    cmd += list(extra_args)
    procs = [subprocess.Popen(cmd + ["--process-id", str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env, cwd=root)
             for r in range(nprocs)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout_s)
            if p.returncode != 0:
                raise RuntimeError(f"mh_worker failed:\n{err[-3000:]}")
            lines = [line for line in out.splitlines() if line.startswith("{")]
            if not lines:
                raise RuntimeError(f"mh_worker printed no JSON line:\n{out[-2000:]}")
            outs.append(json.loads(lines[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def bench_multihost(dim: int = 2048, reps: int = 3) -> List[dict]:
    """The multi-process flow on this host's cards: ``mh_worker`` groups of
    one process, and of two where the host has two cards, each process on
    its own card with NCCL.  Per solver (gathered, ring, 2-D) the least ms
    of ``reps`` solves, rounds and elements/s; ``scaling_efficiency``
    against the one-process row only where a group of two ran (null
    otherwise: one card claims no scaling)."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_multihost measures CUDA devices; none is available")
    solvers = ("gather", "ring", "2d")
    groups = [1] + ([2] if torch.cuda.device_count() >= 2 else [])
    base = {}
    rows = []
    for nprocs in groups:
        rec = run_mh_workers(nprocs, dim, reps, solvers)[0]
        for solver in solvers:
            r = rec["results"][solver]
            if nprocs == 1:
                base[solver] = r["elems_per_s"]
            rows.append({
                "bench": "multihost", "solver": solver, "processes": rec["num_processes"],
                "global_devices": rec["global_devices"], "dim": dim, "mesh": r["mesh"],
                "ms": r["ms"], "rounds": r["rounds"], "elems_per_s": r["elems_per_s"],
                "scaling_efficiency": (r["elems_per_s"] / (nprocs * base[solver])
                                       if nprocs > 1 else None),
                "card": rec["card"], "transport": "nccl",
            })
    return rows


# --- the max-size single-card rows ----------------------------------------------

#: The port's own round counts of the large rows (chip_smoke.py's 65536² bf16 solve;
#: the float64 oracle's count at 32768²); smaller dims take the Hilbert table.
LARGE_ROUNDS = {32768: 20, 65536: 21}
#: λ against the float64 oracle of the stored matrix, relative (at 65536²
#: cuBLAS's f32 gemv drifts ~3e-5, so the oracle is a float64 loop).
LARGE_REL = 1e-5

#: The JAX suite's rows, by its names: (name, n, dtype of A, symmetric).  The
#: bf16 rows keep the port's one storage contract (A kept in bf16, ev and
#: every sum f32), never JAX's ``solve_matvec_storage``.
LARGE_CONFIGS = [
    ("f32_32768", 32768, torch.float32, False),
    ("sym_f32_32768", 32768, torch.float32, True),
    ("bf16_65536", 65536, torch.bfloat16, False),
    ("sym_bf16_65536", 65536, torch.bfloat16, True),
]

_SKIP_SYM_TOO_LARGE = (
    "the triangle kernel keeps ev in one block's shared memory (n up to 57856 on "
    "an H100); past it a symmetric declaration takes the matvec kernel loop, "
    "which the dense row of this dim measures"
)


def sym_traffic_frac(n: int, bt: int, cache_tiles: int, passes: int) -> float:
    """Bytes the triangle kernel moves in ``passes`` passes as a fraction
    of ``passes`` dense passes: the streamed tiles (diagonal ones whole)
    every pass, the cached tiles once a solve."""
    streamed, cached = kernels.sym_cache_split(n, bt, cache_tiles)
    return (passes * len(streamed) + len(cached)) * bt * bt / (passes * n * n)


def large_row(name: str, n: int, res, oracle, device_ms: Optional[float],
              sym_plan: Optional[Tuple[int, int]] = None) -> dict:
    """One large row: the solve ``res`` of Hilbert n² beside the float64
    ``oracle`` (a ``SolveResult``) of the same stored matrix.  ``rounds_ok``:
    converged, the rounds of :data:`LARGE_ROUNDS` (the Hilbert table below
    it) and λ within :data:`LARGE_REL` of the oracle.  ``sym_plan`` is the
    triangle's ``(tile, cache_tiles)``, which adds ``traffic_frac``."""
    rounds, lam = int(res.rounds), float(res.eigenvalue)
    lam64 = float(oracle.eigenvalue)
    want = {**fixtures.HILBERT_ROUNDS, **LARGE_ROUNDS}.get(n, int(oracle.rounds))
    rel = abs(lam - lam64) / lam64
    row = {
        "bench": "large",
        "backend": name,
        "dim": n,
        "device_ms": device_ms,
        "ms_per_round": None if device_ms is None else device_ms / max(rounds, 1),
        "rounds": rounds,
        "eigenvalue": lam,
        "converged": bool(res.converged),
        "oracle_rounds": int(oracle.rounds),
        "oracle_eigenvalue": lam64,
        "rel_err": rel,
        "rounds_ok": bool(res.converged) and rounds == want and rel <= LARGE_REL,
    }
    if sym_plan is not None:
        bt, cache = sym_plan
        row["cache_tiles"] = cache
        row["traffic_frac"] = round(sym_traffic_frac(n, bt, cache, rounds + 1), 4)
    return row


def large_rows(device, configs=None, reps: int = 3) -> List[dict]:
    """The rows of :func:`bench_large` for ``configs`` (default
    :data:`LARGE_CONFIGS`) on ``device``; on the CPU the plain versions
    run (what the tests step through at small dims)."""
    from ..api import max_eigenvalue

    device = torch.device(device)
    oracles = {}
    rows = []
    for name, n, dtype, sym in configs or LARGE_CONFIGS:
        storage = None if dtype == torch.float32 else dtype
        # a symmetric row is the triangle kernel's: auto's route on a card
        cfg = SolverConfig(backend="multiround" if sym else "auto", symmetric=sym,
                           storage_dtype=storage)
        r = route(cfg, n, device)
        if not r.fits:
            rows.append({"bench": "large", "backend": name, "dim": n,
                         "skipped": _SKIP_SYM_TOO_LARGE})
            continue
        A = None
        try:
            A = fixtures.hilbert_matrix(n, dtype=dtype, device=device)
            if (n, dtype) not in oracles:  # the float64 loop on the stored values
                oracles[(n, dtype)] = solve_matvec(A.double(), EPS, MAX_ITR)
                if device.type == "cuda":
                    torch.cuda.empty_cache()
            solve = lambda M, cfg=cfg: max_eigenvalue(M, cfg)  # noqa: E731
            res = solve(A)  # build and warm up
            dev_ms, _, _ = _marginal_resolved(_e2e_chain_step(solve), (A, res.eigenvalue),
                                              k=2, reps=reps)
            plan = (r.bt, r.cache_tiles) if sym else None
            rows.append(large_row(name, n, res, oracles[(n, dtype)], dev_ms, plan))
        except torch.cuda.OutOfMemoryError as e:
            rows.append({"bench": "large", "backend": name, "dim": n, "error": str(e)})
        finally:
            del A
            if device.type == "cuda":
                torch.cuda.empty_cache()  # the next row's matrix is as large
    return rows


def bench_large(reps: int = 3) -> List[dict]:
    """Max-size single-card rows on the CUDA card, the JAX suite's names:
    Hilbert 32768² in float32 (4 GiB; the stripes kernel and the triangle
    kernel with the card's auto cache) and 65536² in bf16 (8 GiB, built on
    the card directly in bf16; past the multiround kernels' shared-memory
    limit at n = 57856, so the matvec kernel loop, and a skip row for the
    symmetric declaration there).  ``device_ms`` is the marginal time of one
    solve in a chain (:func:`_marginal_resolved`); λ is checked against a
    float64 loop on the stored values and the rounds against
    :data:`LARGE_ROUNDS`, where JAX pins both to its own silicon."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_large measures the CUDA device; none is available")
    return large_rows(torch.device("cuda", torch.cuda.current_device()), reps=reps)


# --- the card's drift over time ------------------------------------------------------

#: Suspect bounds of a drift window, % of the published memory rate: above
#: it no real reading can be (an artifact of the differencing), below it the
#: chain was stalled (another process on the card, a host stall).
DRIFT_FAST_OUTLIER_PCT = 120.0
DRIFT_STALL_PCT = 20.0


def drift_row(window: int, t_s: float, ms: float, dim: int, peak_gbps: float,
              state: Optional[dict] = None) -> dict:
    """One drift window: the production matvec's marginal ``ms`` per pass
    of Hilbert ``dim``², its GB/s and % of ``peak_gbps``, the suspect flags,
    and the card's ``state`` (``utils.timing.card_state``) after the
    window."""
    nbytes = dim * dim * 4
    pct = roofline_pct(ms, nbytes, peak_gbps) if ms > 0 else None
    pct = None if pct != pct else pct
    reason = None
    if pct is not None and pct > DRIFT_FAST_OUTLIER_PCT:
        reason = "fast_outlier"
    elif pct is not None and pct < DRIFT_STALL_PCT:
        reason = "stall"
    return {
        "bench": "drift",
        "kernel": "matvec_pallas",
        "dim": dim,
        "window": window,
        "t_s": round(t_s, 1),
        "ms": ms,
        "gbps": nbytes / (ms * 1e-3) / 1e9 if ms > 0 else None,
        "roofline_pct": pct,
        "suspect": reason is not None,
        "suspect_reason": reason,
        **(state or {"sm_mhz": None, "power_w": None, "temp_c": None}),
    }


def drift_summary(rows: List[dict], dim: int, windows: int, gap_s: float) -> dict:
    """The drift suite's summary row: the spread of the clean windows and
    the card's clock and power range across them."""
    clean = [r for r in rows if not r["suspect"] and r["ms"] > 0]
    ms = [r["ms"] for r in clean]
    spread = (max(ms) / min(ms) - 1.0) if ms else None

    def span(key):
        vals = [r[key] for r in clean if r.get(key) is not None]
        return [min(vals), max(vals)] if vals else None

    return {
        "bench": "drift_summary",
        "dim": dim,
        "windows": windows,
        "gap_s": gap_s,
        "suspect_windows": sum(1 for r in rows if r["suspect"]),
        "min_ms": min(ms) if ms else None,
        "max_ms": max(ms) if ms else None,
        "spread_pct": round(spread * 100, 1) if spread is not None else None,
        "sm_mhz_range": span("sm_mhz"),
        "power_w_range": span("power_w"),
        "temp_c_range": span("temp_c"),
        "roofline_note": (
            "roofline_pct is against the card's published memory rate (3.35 TB/s "
            "for an H100 SXM at its full 700 W); a clean window stays below 100"
        ),
    }


def bench_drift(dim: int = 8192, windows: int = 10, gap_s: float = 20.0,
                k: int = 64) -> List[dict]:
    """The card's drift over time: the production matvec kernel's marginal
    time per pass of Hilbert ``dim``² (``time_marginal``) in ``windows``
    windows ``gap_s`` apart, one row per window with its GB/s, % of the
    published memory rate and the card's SM clock, power draw and
    temperature from ``nvidia-smi`` (a card under a power or heat limit
    lowers its clocks), then a summary row with the spread (suspect windows
    left out).  A window above 120% of the published rate is suspect
    (``fast_outlier``: an artifact of the differencing), one below 20% too
    (``stall``).  Use it before trusting a comparison across calls."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_drift measures the CUDA device; none is available")
    import time

    device = torch.device("cuda", torch.cuda.current_device())
    peak = detect_peak_gbps(device)
    A = fixtures.hilbert_matrix(dim, device=device)
    ones = torch.ones(dim, dtype=torch.float32, device=device)

    def step(i, s):
        return (s[0], kernels.matvec(s[0], s[1]) / s[1])

    rows: List[dict] = []
    t0 = None
    for w in range(windows):
        if w:
            time.sleep(gap_s)
        ms = time_marginal(step, (A, ones), k=k)
        t0 = time.perf_counter() if t0 is None else t0
        rows.append(drift_row(w, time.perf_counter() - t0, ms, dim, peak, card_state()))
    return rows + [drift_summary(rows, dim, windows, gap_s)]


# --- the scaling model's exchange calibration ------------------------------------


def _worst_exchange(outs: List[dict]) -> Dict[int, float]:
    """Per vector length, the slowest process's µs (a gather is done when
    its slowest rank is)."""
    measured: Dict[int, float] = {}
    for o in outs:
        for n, us in o["exchange_us"].items():
            measured[int(n)] = max(measured.get(int(n), 0.0), float(us))
    return measured


def calibration_table(outs: List[dict], outs_cross: List[dict]) -> List[dict]:
    """The calibrate suite's rows from the ``--measure-exchange`` records of
    a group (``outs``) and of a larger one (``outs_cross``): the JAX
    suite's fit of the scaling model's exchange to the first group, its
    predicted-vs-measured rows, and the larger group's exchange predicted
    by that one fit (``model_calibration_crossP``).  Every row says what it
    fitted: gloo between CPU processes of one host, not NVLink."""
    import dataclasses

    from ..utils.scaling_model import (
        DEFAULT_SPEC,
        calibration_rows,
        fit_exchange,
        gather_exchange_us,
    )

    transport = {"transport": "gloo-loopback",
                 "transport_note": "fits gloo between CPU processes of one host, not NVLink"}
    shards = outs[0]["shards"]
    measured = _worst_exchange(outs)
    gbps, lat = fit_exchange(measured, shards, DEFAULT_SPEC.itemsize)
    spec = dataclasses.replace(DEFAULT_SPEC, ici_gbps=gbps, ici_latency_us=lat)
    rows = [dict(r, **transport) for r in calibration_rows(measured, shards, spec=spec)]
    shards_x = outs_cross[0]["shards"]
    measured_x = _worst_exchange(outs_cross)
    for n in sorted(measured_x):
        pred = gather_exchange_us(n, shards_x, 1, spec)
        rows.append({
            "bench": "model_calibration_crossP",
            "dim": n,
            "chips": shards_x,
            "fitted_on_chips": shards,
            "measured_us": measured_x[n],
            "predicted_us": pred,
            "ratio": measured_x[n] / pred if pred > 0 else None,
            **transport,
        })
    return rows


def bench_exchange_calibration(dim: int = 8192, reps: int = 5) -> List[dict]:
    """Fit the scaling model's exchange (``utils.scaling_model.fit_exchange``)
    to measured all-gathers, as the JAX suite does: ``mh_worker
    --measure-exchange`` in a group of 2 processes on loopback gloo times
    the gather of n floats at n = dim, 4·dim and 16·dim, the fit gives the
    transport's bandwidth and per-step latency, and a group of 4 checks the
    fit's dependence on P (:func:`calibration_table`).  The fit describes
    gloo between CPU processes, not the card's NVLink: it validates the
    model's functional form, not the H100 spec's link numbers.  It runs on
    the card's host beside the other suites and, like every measuring
    suite, raises where there is no card, so that no other machine's
    numbers are filed beside the card's."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "bench_exchange_calibration runs on the CUDA device's host; no CUDA device "
            "is available")
    args = ["--measure-exchange"]
    outs = run_mh_workers(2, dim, reps, device="cpu", extra_args=args)
    outs_cross = run_mh_workers(4, dim, reps, device="cpu", extra_args=args)
    return calibration_table(outs, outs_cross)


# --- the native C++ runtime (CPU) ----------------------------------------------


def bench_native(dims: List[int] = MATRIX_DIMS) -> List[dict]:
    """End-to-end sweep through the native C++ runtime on the CPU (the
    reference-architecture datapoint; ABI parity with the reference's
    libsimilarity_transform.so), both solver forms, then its kernels' wall
    µs.  Empty when the library cannot be built (no compiler).  Needs no
    card: every time here is the host's, and the rows say ``native``."""
    from .. import native

    if not native.available():
        return []
    solver = native.NativeEigenValue()
    rows = []
    for n in dims:
        H = fixtures.hilbert_matrix(n).numpy()
        for form, matvec in (("cpu_native", False), ("cpu_native_matvec", True)):
            lam, vec, ms, rounds = solver.similarity_transform(H, matvec_form=matvec)
            rows.append({
                "bench": "native",
                "backend": form,
                "dim": n,
                "ms": float(ms),
                "rounds": rounds,
                "eigenvalue": float(lam),
                "rounds_ok": rounds == fixtures.HILBERT_ROUNDS.get(n, rounds),
            })
    for name in ("row_sums", "next_matrix", "matvec"):
        for n in dims:
            rows.append({
                "bench": "native_kernel",
                "kernel": f"native_{name}",
                "dim": n,
                "ms": solver.bench_kernel_us(name, n) / 1e3,
            })
    return rows
