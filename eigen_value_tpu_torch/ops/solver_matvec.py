"""Matvec ("power-form") solver (counterpart of
``eigen_value_tpu.ops.solver_matvec``).

The similarity update is a diagonal conjugation, so the iterated matrix is
never formed: with the eigenvector accumulator ev_k = Π v_i/m_i, each
round's row sums are

    v_k = (A_0 @ ev_k) / ev_k,

one matvec against the original matrix per round.  Round semantics are the
reference's: the stop is checked BEFORE the update, λ = v[0], rounds are
0-based, and the cap reports the last checked round (``solver._finish``).

Here the loop runs on the host with one stop read per round (JAX runs it
as a ``lax.while_loop`` on the device); :func:`solve_matvec_kernel` issues
each round's stop, max, update and λ as one glue kernel before that read,
so after it the host only launches the next matvec.
:func:`solve_multiround` moves up to ``chunk`` rounds into one kernel
launch (the stripes kernel, or the tiled triangle kernel for a
declared-symmetric matrix) and reads one count per launch.
:func:`solve_matvec_kernel_fused` and :func:`solve_fused_round` keep the
host loop and fuse a round's O(n) glue into its one O(n²) launch.
:func:`solve_operator` runs the same loop over any ``matvec`` (the
matrix-free solve), and the ``*_traced`` solves record λ each round.

Reduced-precision storage (``storage_dtype`` = ``torch.bfloat16`` /
``torch.float16``, on :func:`solve_matvec`, :func:`solve_matvec_kernel` and
:func:`solve_multiround`): A is cast once to the storage type (a matrix
already in it is used as it is, with no f32 copy), every round reads it in
2 bytes, converts each element to f32 exactly and multiplies it with the
f32 ev, summing in f32 in the order of the f32 path; all O(n) state (ev, v,
λ, the stop) stays f32.  That is the contract of the JAX package's Pallas
kernels (``kernels.py:556-561``), used here on every path.  JAX's one-chip
``solve_matvec_storage`` divides by a quantized ev instead; the port does
not follow it.  The fused-round solves keep float32 A only, as in JAX.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import torch

from ..device import solve_device
from ..utils.profiling import span, spanned
from .cuda import kernels
from .solver import SolveResult, _finish, stop_check


class _Carry(NamedTuple):
    ev: torch.Tensor
    v: torch.Tensor
    lam: torch.Tensor  # λ snapshot (v[0]) of the last round advanced past
    i: int


def _make_cond_body(matvec, eps: float, max_itr: int, eps_mode: str = "absolute"):
    """The one definition of the matvec-form round.  ``cond`` reads the stop
    back to the host once per round."""

    def cond(c: _Carry) -> bool:
        if c.i >= max_itr:
            return False
        stop = stop_check(c.v, eps, eps_mode)
        with span("solver.read"):
            return not bool(stop)

    def body(c: _Carry) -> _Carry:
        v = c.v
        m = torch.max(v)
        ev = c.ev * (v / m)
        lam = v[0]
        return _Carry(ev, matvec(ev), lam, c.i + 1)

    return cond, body


def _stored(A: torch.Tensor, storage_dtype) -> tuple:
    """``(A_q, state dtype)``: A cast once to ``storage_dtype`` (None keeps
    it), and the dtype of the O(n) state, float32 for a 2-byte A (bf16
    cannot hold the 1e-3 stop at λ-scale values)."""
    if storage_dtype is not None:
        A = A.to(storage_dtype)
    return A, (torch.float32 if A.element_size() < 4 else A.dtype)


def _run_rounds(next_v, c: _Carry, eps: float, max_itr: int, eps_mode: str = "absolute",
                budget: Optional[int] = None) -> tuple:
    """Rounds of :func:`_make_cond_body` from carry ``c``, each checking the
    stop before it advances, until the stop fires, ``max_itr`` is reached
    or ``budget`` rounds have been checked (None: no budget).  The check
    that finds the stop counts among the budget, so ``budget`` k then k′
    is one budget of k + k′, bit for bit.  Returns ``(carry, stopped)``;
    ``stopped`` means that the stop fired before ``max_itr``, and
    ``solver._finish`` then applies the converging round's update."""
    cond, body = _make_cond_body(next_v, eps, max_itr, eps_mode)
    k = 0
    while budget is None or k < budget:
        if not cond(c):
            return c, c.i < max_itr
        c = body(c)
        k += 1
    return c, False


def _init_carry(n: int, matvec, dtype, device, ev0=None) -> _Carry:
    if ev0 is None:
        ev0 = torch.ones(n, dtype=dtype, device=device)
    else:
        ev0 = torch.as_tensor(ev0, dtype=dtype, device=device).contiguous()
    v0 = matvec(ev0)  # == row sums of A_0 for the all-ones start
    return _Carry(ev0, v0, torch.zeros((), dtype=dtype, device=device), 0)


def solve_matvec_loop(
    A: torch.Tensor,
    matvec,
    eps: float,
    max_itr: int,
    ev0=None,
    eps_mode: str = "absolute",
) -> SolveResult:
    """Convergence loop over a pluggable ``matvec(ev) -> (A @ ev) / ev``.
    The O(n) state has A's dtype, float32 for a 2-byte A."""
    c = _init_carry(A.shape[0], matvec, _stored(A, None)[1], A.device, ev0)
    return _finish(_run_rounds(matvec, c, eps, max_itr, eps_mode)[0], max_itr)


@spanned("solver.matvec")
def solve_matvec(
    A: torch.Tensor,
    eps: float,
    max_itr: int,
    ev0=None,
    eps_mode: str = "absolute",
    storage_dtype=None,
) -> SolveResult:
    """Matvec-form solve with ``torch.mv`` in full float32 (any n, any
    device; the JAX ``dot_f32`` loop).  With ``storage_dtype`` A is kept in
    2 bytes and cast up a block of rows at a time (``kernels.matvec_plain``)."""
    A, _ = _stored(A, storage_dtype)

    def matvec(ev):
        return kernels.matvec_plain(A, ev) / ev

    return solve_matvec_loop(A, matvec, eps, max_itr, ev0=ev0, eps_mode=eps_mode)


@spanned("solver.matvec_kernel")
def solve_matvec_kernel(
    A: torch.Tensor,
    eps: float,
    max_itr: int,
    ev0=None,
    eps_mode: str = "absolute",
    storage_dtype=None,
) -> SolveResult:
    """Matvec-form solve over the hand-written matvec kernel, one launch per
    round (the ``solve_matvec_pallas`` counterpart).  With ``storage_dtype``
    the kernel reads A in 2 bytes: the storage route of ``matvec_pallas``
    and ``matvec``, and the only single-card route past n = 57856 (65536² is
    8 GiB in bf16).

    A round is the matvec ``y = A @ ev`` and ``kernels.round_glue``, which
    forms v = y / ev, checks the stop, and writes the update of ev, λ,
    rounds and converged whatever the stop, all before the round's one
    read; so the host's only step after a read is the next matvec launch,
    and no ``_finish`` follows: after the glue of the last round the buffers
    hold the result, bit for bit ``_finish(_run_rounds(...))`` over
    ``kernels.matvec``.  The matvec after the last round at the cap would
    be unused and is not launched; nor is the read of that round.  The
    matvec is bound once (``kernels.matvec_bound``), so the launch after a
    read repeats none of its checks."""
    A, _ = _stored(A, storage_dtype)
    n, dev = A.shape[0], A.device
    f32 = torch.float32
    if ev0 is None:
        ev = torch.ones(n, dtype=f32, device=dev)
    else:  # updated in place below: never the caller's tensor
        ev = torch.as_tensor(ev0, dtype=f32, device=dev).contiguous().clone()
    lam = torch.empty((), dtype=f32, device=dev)
    rounds = torch.empty((), dtype=torch.int32, device=dev)
    converged = torch.empty((), dtype=torch.bool, device=dev)
    if max_itr <= 0:
        return SolveResult(lam.zero_(), ev, rounds.zero_(), converged.zero_())
    e = torch.full((), eps, dtype=f32, device=dev)  # a fill: no host-to-device copy
    y = torch.empty(n, dtype=f32, device=dev)
    matvec = kernels.matvec_bound(A, ev, y)  # y = A @ ev, the checks paid once
    matvec()
    for i in range(max_itr):
        kernels.round_glue(y, ev, e, i, lam, rounds, converged, eps_mode)
        if i + 1 == max_itr:
            break
        with span("solver.read"):
            if bool(converged):
                break
        matvec()
    return SolveResult(lam, ev, rounds, converged)


def solve_operator(
    matvec,
    n: int,
    eps: float,
    max_itr: int,
    dtype=torch.float32,
    ev0=None,
    eps_mode: str = "absolute",
    device=None,
) -> SolveResult:
    """Matrix-free solve: ``matvec(x) -> A @ x`` for an implicit positive
    matrix that is never materialized (JAX ``solve_operator``).

    The power-form loop observes A only through one matvec per round, so any
    positive linear operator works: structured matrices with fast matvecs
    (Hankel / Toeplitz by FFT: the Hilbert matrix is Hankel, O(n log n) a
    round instead of O(n²); ``ops/structured.py``), sums and scalings of
    operators, matrices too large to store.  Semantics are the dense
    solve's: the wraparound stop checked before the update, λ = v[0],
    0-based rounds, the cap reporting the last checked round.  Round counts
    may differ by one from the dense solve where the operator's rounding
    differs from the dense row sums (FFT).  The O(n) state has ``dtype`` and
    lives on ``device`` (None: the CUDA card), which is where ``matvec``
    must take and return its vectors.
    """
    dev = solve_device(device)

    def next_v(ev):
        return matvec(ev) / ev

    c = _init_carry(n, next_v, dtype, dev, ev0)
    return _finish(_run_rounds(next_v, c, eps, max_itr, eps_mode)[0], max_itr)


def solve_matvec_traced(A: torch.Tensor, eps: float, max_itr: int):
    """:func:`solve_matvec` that also records the λ estimate (v[0] at each
    round's stop check).  Returns ``(SolveResult, lam_history)`` with
    ``lam_history`` of shape ``(max_itr,)`` on A's device; the entries past
    the converging round repeat the final λ.  Its matvec is the one
    :func:`solve_matvec` uses, so the two are bit-identical."""
    A, dtype = _stored(A, None)

    def next_v(ev):
        return kernels.matvec_plain(A, ev) / ev

    return _solve_traced(next_v, A.shape[0], dtype, eps, max_itr, device=A.device)


def solve_operator_traced(
    matvec,
    n: int,
    eps: float,
    max_itr: int,
    dtype=torch.float32,
    eps_mode: str = "absolute",
    device=None,
):
    """:func:`solve_operator` with the λ history of
    :func:`solve_matvec_traced` (feed it to ``ops.spectral.
    convergence_report`` to estimate |λ₂/λ₁|; for a stochastic operator such
    as the PageRank matrix that ratio is the chain's mixing rate)."""

    def next_v(ev):
        return matvec(ev) / ev

    return _solve_traced(next_v, n, dtype, eps, max_itr, eps_mode, solve_device(device))


def _solve_traced(next_v, n: int, dtype, eps: float, max_itr: int,
                  eps_mode: str = "absolute", device=None):
    """The loop of :func:`solve_operator` writing each round's λ into a
    ``(max_itr,)`` history on the device at the host's round index (no read
    back), then the JAX epilogue: the converging round's λ at
    ``min(rounds, max_itr - 1)`` and the final λ past ``rounds``."""
    cond, body = _make_cond_body(next_v, eps, max_itr, eps_mode)
    c = _init_carry(n, next_v, dtype, device)
    hist = torch.zeros(max_itr, dtype=dtype, device=device)
    while cond(c):
        i = c.i
        c = body(c)
        hist[i] = c.lam  # the body just advanced past round i
    res = _finish(c, max_itr)
    if max_itr > 0:
        # the converging round ran no body: write its λ (on cap exhaustion
        # this rewrites hist[max - 1] with the value it holds), then pad
        hist[min(c.i, max_itr - 1)] = res.eigenvalue
        hist[c.i + 1:] = res.eigenvalue
    return res, hist


def _first_row_sums(A: torch.Tensor):
    """``(ones, v0)``: the all-ones start and ``v0 = (A @ ones) / ones`` by
    the matvec kernel, the round 0 of both fused-round solves."""
    ones = torch.ones(A.shape[0], dtype=A.dtype, device=A.device)
    return ones, kernels.matvec(A, ones) / ones


def solve_matvec_kernel_fused(A: torch.Tensor, eps: float, max_itr: int) -> SolveResult:
    """Matvec-form solve whose round is ONE launch of
    :func:`kernels.round_matvec` (the ev update, the matvec and the
    division), with the max, the λ snapshot and the stop check left to the
    host loop (the ``solve_matvec_pallas_fused`` counterpart).  Same loop
    structure, one stop read per round and epilogue as
    :func:`solve_matvec_kernel`, and bit-identical results, cap exhaustion
    included.  One ``matvec`` launch, then one ``round_matvec`` launch per
    round; absolute stop only."""
    ones, v0 = _first_row_sums(A)
    c = _Carry(ones, v0, torch.zeros((), dtype=A.dtype, device=A.device), 0)
    while c.i < max_itr and not bool(stop_check(c.v, eps)):
        m = torch.max(c.v)
        lam = c.v[0]  # λ snapshot of the round being advanced past
        v_next, ev_new = kernels.round_matvec(A, c.ev, c.v, m)
        c = _Carry(ev_new, v_next, lam, c.i + 1)
    return _finish(c, max_itr)


def solve_fused_round(A: torch.Tensor, eps: float, max_itr: int) -> SolveResult:
    """Matvec-form solve where EACH ROUND IS ONE KERNEL LAUNCH
    (:func:`kernels.round_fused`): the max, the ev update, the wraparound
    stop, the λ readout and the matvec.  The host reads ``done`` once per
    round and launches nothing else.  Bit-identical to
    :func:`solve_matvec_kernel`.

    The trade: ``done`` is known only after the launch, so the converging
    round's matvec is computed and dropped, one O(n²) pass more per solve
    (k + 2 passes for k rounds against k + 1).  That call has already
    applied the converging round's ev update, so there is no epilogue."""
    ev, v = _first_row_sums(A)
    lam = torch.zeros((), dtype=A.dtype, device=A.device)
    i, done = 0, False
    while not done and i < max_itr:
        v_next, ev, done_t, lam = kernels.round_fused(A, ev, v, eps=eps)
        done = bool(done_t)  # the one host read of the round
        if not done:
            v, i = v_next, i + 1
    return SolveResult(
        lam,
        ev,
        torch.tensor(i, dtype=torch.int32, device=A.device),
        torch.tensor(done, device=A.device),
    )


@spanned("solver.multiround")
def solve_multiround(
    A: torch.Tensor,
    eps: float,
    max_itr: int,
    chunk: Optional[int] = None,
    ev0=None,
    eps_mode: str = "absolute",
    formulation: str = "vpu",
    symmetric: bool = False,
    tile: Optional[int] = None,
    cache_tiles: int = 0,
    mxu_tiles: Optional[int] = None,
    fill_mode: str = "prologue",
    storage_dtype=None,
) -> SolveResult:
    """Matvec-form solve with up to ``chunk`` rounds per launch of a
    multiround kernel.

    Any split into chunks gives bit-identical results: the kernel checks
    the stop before each round and freezes where it fires.  The first
    launch (``init=True``) spends its round 0 on the row-sum pass.  A
    launch that advanced fewer rounds than it had froze (stop or budget),
    so the host reads only that count, the solve's one read where it takes
    one launch.  Once frozen the kernel leaves its round loop, so an
    oversized chunk wastes no pass; the default (None) is the whole budget,
    ``max_itr + 1`` rounds, in one launch.  Every launch is asked for the
    solve's result (``finish``), and the one where the solve ends writes
    it on the card by :func:`solver._finish`'s rule and expressions, bit for
    bit, so nothing is launched or copied to the card after it.

    Without ``symmetric`` or a cache this is the stripes kernel, whose
    v-sequence is bit-identical to :func:`solve_matvec_kernel`.
    ``symmetric=True`` declares A symmetric and takes the tiled triangle
    kernel (:func:`kernels.multiround_sym`), which reads only the upper
    block triangle: a non-symmetric A gives a wrong answer, as with a BLAS
    ``symv``.  ``cache_tiles > 0`` without the declaration takes the same
    kernel in dense tiled mode.  ``tile`` (square edge, default
    ``kernels.SYM_TILE``) is a tiled-kernel knob; the tiled kernel sums in
    another order than the stripes one, so its results agree with the
    stripes kernel's in rounds and within rounding.

    ``formulation``, ``mxu_tiles`` and ``fill_mode`` keep the JAX names.
    ``formulation="dot"`` runs either kernel's products on the tensor cores
    in 3xTF32 (never plain TF32; the stripes need n % 128 == 0, as JAX's):
    bit-identical across chunkings, caches and A_q against A_q.float(), and
    within rounding of "vpu" with the same rounds.  ``formulation="mixed"``
    (tiled kernel, ``cache_tiles > 0``) takes the last ``mxu_tiles`` resident
    tiles in that form and every other tile as "vpu" (None: the JAX
    package's default share, ``kernels.mxu_share``); ``fill_mode="pipelined"``
    fills the resident tiles by 2-D tensor copies waited for at first use,
    bit for bit the prologue fill.  Each raises where the JAX solve does.

    ``storage_dtype`` (as JAX ``solve_multiround``): A is cast once and the
    kernels read it in 2 bytes; the O(n) state is f32, as it is for a
    matrix that is already 2-byte.  The result equals the f32 solve of
    ``A_q.float()`` bit for bit.
    """
    A, dtype = _stored(A, storage_dtype)
    if symmetric or cache_tiles > 0:
        kernel = partial(
            kernels.multiround_sym,
            tile=kernels.SYM_TILE if tile is None else tile,
            cache_tiles=cache_tiles,
            sym=symmetric,
            formulation=formulation,
            mxu_tiles=mxu_tiles,
            fill_mode=fill_mode,
        )
    else:
        if mxu_tiles is not None:
            raise ValueError(
                "mxu_tiles needs the tiled kernel (symmetric=True or "
                "cache_tiles > 0) with formulation='mixed'"
            )
        if fill_mode != "prologue":
            raise ValueError("fill_mode needs the tiled kernel with cache_tiles > 0")
        if formulation == "mixed":
            raise ValueError(
                "formulation='mixed' needs cache_tiles > 0 (the matrix-unit share is "
                "carved out of the resident tiles)"
            )
        if tile is not None:
            raise ValueError(
                f"tile={tile} is a tiled-kernel knob (symmetric=True or "
                f"cache_tiles > 0); the stripes kernel streams full-width rows"
            )
        kernel = partial(kernels.multiround, formulation=formulation)
    n = A.shape[0]
    if ev0 is None:
        ev0 = torch.ones(n, dtype=dtype, device=A.device)
    else:
        ev0 = torch.as_tensor(ev0, dtype=dtype, device=A.device).contiguous()
    if chunk is None:
        chunk = max_itr + 1
    kw = dict(chunk=chunk, eps=eps, eps_mode=eps_mode)
    zero = torch.zeros((), dtype=dtype, device=A.device)
    ev, v, adv, lam, rounds, converged = kernel(A, ev0, ev0, zero, max_itr, init=True,
                                                finish=0, **kw)
    with span("solver.read"):
        i = int(adv)
    frozen = i < chunk - 1  # round 0 of the first launch is the row-sum pass
    while not frozen and i < max_itr:
        ev, v, adv, lam, rounds, converged = kernel(A, ev, v, lam, max_itr - i, init=False,
                                                    finish=i, **kw)
        with span("solver.read"):
            adv = int(adv)
        i += adv
        frozen = adv < chunk
    return SolveResult(lam, ev, rounds, converged)
