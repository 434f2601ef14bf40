"""Spectral diagnostics and refinement around the solver (counterpart of
``eigen_value_tpu.ops.spectral``).

* :func:`operator_residual` — ``max |A·v − λ·v|`` through a matrix-free
  operator (``api.eigen_residual`` covers the dense case).
* :func:`convergence_report` — the per-round λ history of
  :func:`..solver_matvec.solve_matvec_traced` converges geometrically with
  ratio r = |λ₂/λ₁| (the method is renormalized power iteration), so
  successive history deltas estimate the subdominant ratio, the digits
  gained per round and the error left, at no extra compute.  Numpy on the
  host, the JAX package's arithmetic.
* :func:`refine_eigenpair` — a float64 host-side polish of a converged
  float32 solve: a handful of O(n²) float64 power-form rounds in numpy.
* :func:`power_eigenpair` / :func:`subdominant_eigenpair` /
  :func:`top_k_eigenpairs` — classic normalized power iteration for
  symmetric operators (no positivity assumed) on the device, the second
  eigenpair by Hotelling deflation of the refined dominant pair, and the
  k-pair generalization by successive deflation.

The JAX package runs the power iteration as a ``lax.while_loop`` on the
device; here it is a host loop with one read of the stop per round.  Its
default random start is drawn from a ``torch.Generator`` seeded on the CPU
and moved to the device, so the CPU and the card start from the same
vector; it differs from JAX's ``jax.random`` start (pass ``x0`` to
:func:`power_eigenpair` to fix one).  Every matmul runs in true float32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import solve_device
from .structured import _host, _matmul_f32

#: numpy's type for a torch dtype in the host results (numpy has no bf16).
_NP = {torch.float16: np.float16, torch.float32: np.float32, torch.float64: np.float64,
       torch.bfloat16: np.float32}


def _start(n: int, seed: int, dtype, device: torch.device) -> torch.Tensor:
    """The default start: a standard normal vector from a CPU generator
    seeded ``seed``, the same on every device."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, generator=g, dtype=torch.float64).to(device=device, dtype=dtype)


def operator_residual(matvec, result) -> torch.Tensor:
    """``max |A·v − λ·v|`` for a matrix-free operator — the eigen-pair
    acceptance check (atol 1e-3) when only a matvec exists, a 0-d tensor
    where the eigenvector lives."""
    v = result.eigenvector
    return torch.max(torch.abs(matvec(v) - result.eigenvalue * v))


class ConvergenceReport(NamedTuple):
    """Asymptotics extracted from a per-round λ history (host floats)."""

    rate: float  # estimated |λ₂/λ₁| ∈ (0, 1); nan if history too short
    digits_per_round: float  # −log10(rate)
    lam_error_estimate: float  # |λ_final − λ_∞| ≈ |last Δ|·rate/(1−rate)
    deltas_used: int  # successive-delta ratios the estimate averaged


def convergence_report(lam_history, rounds: int) -> ConvergenceReport:
    """Estimate the convergence rate (≈ the subdominant eigenvalue ratio
    |λ₂/λ₁|) from the λ-per-round history of
    :func:`..solver_matvec.solve_matvec_traced`.

    λ_k − λ_∞ ≈ C·rᵏ with r = λ₂/λ₁ ⇒ the ratio of successive deltas
    Δ_k = λ_{k+1} − λ_k estimates r; |r| is reported.  A negative λ₂
    alternates the delta signs — |q| still estimates |λ₂/λ₁|, so both signs
    are accepted (then the ``lam_error_estimate`` bound |Δ|·r/(1−r) is
    conservative: the true remaining error is ≈ |Δ|·r/(1+r)).  The geometric
    mean over the usable tail is returned; ratios from deltas at round-off
    scale (|Δ| ≤ 100·eps·λ, eps taken from the history's dtype: a float64
    history keeps its deeper tail) are excluded.  Works on any geometric
    tail, cap-exhausted runs included.  A plain Python list is taken to be
    of float32 origin (the solver's dtype); pass the solver's own tensor or
    array to get its dtype's floor.
    """
    if isinstance(lam_history, torch.Tensor):
        fl = lam_history.is_floating_point()
        hist_eps = float(torch.finfo(lam_history.dtype).eps) if fl else None
        lam_history = lam_history.detach().cpu().double().numpy()
    else:
        in_dtype = getattr(lam_history, "dtype", None)
        fl = in_dtype is not None and np.issubdtype(in_dtype, np.floating)
        hist_eps = float(np.finfo(in_dtype).eps) if fl else None
    if hist_eps is None:
        hist_eps = float(np.finfo(np.float32).eps)
    hist = np.asarray(lam_history, np.float64)[: int(rounds) + 1]
    if hist.size < 3:
        return ConvergenceReport(float("nan"), float("nan"), float("nan"), 0)
    deltas = np.diff(hist)
    scale = max(abs(float(hist[-1])), 1e-30)
    floor = 100 * hist_eps * scale
    ratios = []
    for k in range(len(deltas) - 1):
        if abs(deltas[k]) > floor and abs(deltas[k + 1]) > floor:
            q = deltas[k + 1] / deltas[k]
            # geometric decay toward λ∞ (|q| < 1); q < 0 = alternating
            # convergence (negative λ₂); |q| ≥ 1 transients excluded
            if 0 < abs(q) < 1:
                ratios.append(abs(q))
    if not ratios:
        return ConvergenceReport(float("nan"), float("nan"), float("nan"), 0)
    ratios = ratios[-5:]  # the tail is the asymptote; early rounds carry
    # transients from the non-dominant spectrum
    rate = float(np.exp(np.mean(np.log(ratios))))
    last = abs(float(deltas[-1]))
    err = last * rate / (1.0 - rate) if rate < 1 else float("inf")
    return ConvergenceReport(rate, float(-np.log10(rate)), err, len(ratios))


class RefinedPair(NamedTuple):
    eigenvalue: float  # float64 λ estimate (v[0] readout, parity semantics)
    eigenvector: np.ndarray  # float64, max-normalized like the solver's
    rounds: int  # extra f64 rounds actually run
    spread: float  # (max v − min v)/λ of the last round — the stop measure
    residual: float  # max |A·v − λ·v| of the returned pair, float64


def _host64(a) -> np.ndarray:
    return np.asarray(_host(a), np.float64)


def refine_eigenpair(A, result, max_rounds: int = 50, tol: float = 1e-12) -> RefinedPair:
    """Polish a converged solve to float64 accuracy with a few host-side
    power-form rounds.

    ``A`` is the dense matrix (a tensor on any device, or anything
    ``np.asarray`` accepts) or a callable float64 numpy matvec for
    matrix-free operators.  ``result`` is the :class:`..solver.SolveResult`
    (or anything with ``eigenvector``) whose vector seeds the iteration;
    each round shrinks the remaining error by |λ₂/λ₁|.

    Stops when the row-sum spread (max−min)/λ falls below ``tol``, stops
    improving (the float64 round-off floor, ~n·2⁻⁵²·λ), or after
    ``max_rounds``.  Returns float64 (λ, v) plus the achieved spread and
    residual.  Numpy on the host: a round is one O(n²) host matmul.
    """
    matvec = A if callable(A) else _host64(A).__matmul__
    q = _host64(result.eigenvector)
    if not np.all(np.isfinite(q)) or np.any(q <= 0):
        raise ValueError(
            "seed eigenvector must be finite and positive — refine polishes "
            "a CONVERGED solve (check result.converged)"
        )
    lam = float("nan")
    spread = float("inf")
    k = 0
    for k in range(1, max_rounds + 1):
        y = matvec(q)
        v = y / q
        lam = float(v[0])
        prev_spread, spread = spread, float((v.max() - v.min()) / abs(lam))
        q = q * (v / v.max())
        if spread < tol or spread >= prev_spread:  # done, or round-off floor
            break
    vhat = q / q.max()
    residual = float(np.max(np.abs(matvec(vhat) - lam * vhat)))
    return RefinedPair(lam, vhat, k, spread, residual)


class PowerResult(NamedTuple):
    """Eigenpair from :func:`power_eigenpair` (tensors on the device)."""

    eigenvalue: torch.Tensor  # Rayleigh quotient of the returned vector
    eigenvector: torch.Tensor  # unit 2-norm
    rounds: torch.Tensor  # matvecs spent inside the loop (int32)
    converged: torch.Tensor  # residual ≤ eps·|λ| reached before the cap
    residual: torch.Tensor  # ‖A·v − λ·v‖₂ of the returned pair


def power_eigenpair(
    matvec, n: int, eps: float = 1e-6, max_itr: int = 1000, x0=None,
    dtype=torch.float32, device=None,
) -> PowerResult:
    """Classic normalized power iteration — the general-operator sibling of
    the similarity-transform solver, with no positivity assumption.

    Converges to the largest-|λ| eigenpair of a symmetric operator (λ may be
    negative — the iterate's alternating sign cancels in the Rayleigh
    quotient), at rate |λ_sub/λ_dom| a round; it stalls when the two largest
    magnitudes tie.  It exists for operators outside the similarity
    transform's contract, above all the Hotelling-deflated operators of
    :func:`subdominant_eigenpair`, which deflation makes indefinite.

    Stop: relative residual ‖A·x − λ·x‖₂ ≤ eps·|λ|, checked on the
    pre-update iterate (one host read a round); the returned pair is
    evaluated again, one extra matvec.  ``x0`` defaults to a fixed-seed
    normal vector (almost surely not orthogonal to the dominant
    eigenvector, where ``ones`` is exactly orthogonal to odd-symmetric
    ones); it is not JAX's ``jax.random`` start.  The loop runs on
    ``device`` (None: ``x0``'s device if it is a tensor, else the card).
    """
    dev = solve_device(device, x0)
    if x0 is None:
        x0 = _start(n, 0, dtype, dev)
    x = torch.as_tensor(x0).to(device=dev, dtype=dtype)
    x = x / torch.linalg.norm(x)
    tiny = torch.tensor(np.finfo(np.float32).tiny, dtype=dtype, device=dev)

    def apply(x):
        y = matvec(x)
        lam = torch.dot(x, y)  # Rayleigh quotient (x has unit norm)
        return y, lam, torch.linalg.norm(y - lam * x)

    itr = 0
    lam = resid = None
    while itr < max_itr and (resid is None or bool(resid > eps * torch.abs(lam))):
        y, lam, resid = apply(x)
        x = y / torch.maximum(torch.linalg.norm(y), tiny)
        itr += 1
    # the loop's (λ, resid) describe the previous iterate; evaluate the
    # returned vector again so the record matches what the caller gets
    _, lam, resid = apply(x)
    # converged needs both the tolerance and an exit before the cap: a capped
    # run whose last (never checked) update lands within tolerance may sit on
    # a tied-magnitude pair
    converged = itr < max_itr and bool(resid <= eps * torch.abs(lam))
    return PowerResult(
        lam, x, torch.tensor(itr, dtype=torch.int32, device=dev),
        torch.tensor(converged, device=dev), resid,
    )


def _require_symmetric(A, fn_name: str) -> np.ndarray:
    """float64 copy of ``A``, validated square and symmetric (Hotelling
    deflation with the right eigenvector assumes left = right)."""
    A64 = _host64(A)
    if A64.ndim != 2 or A64.shape[0] != A64.shape[1]:
        raise ValueError(f"need a square matrix, got {A64.shape}")
    if not np.allclose(A64, A64.T, rtol=1e-6, atol=1e-12):
        raise ValueError(
            f"{fn_name} requires a SYMMETRIC matrix (Hotelling deflation "
            "with the right eigenvector assumes left = right)"
        )
    return A64


def _deflation_seed(A64: np.ndarray, result, refine: bool):
    """(λ₁, unit-2-norm v̂₁) in float64 from any solve result.  A
    :class:`RefinedPair` is used as it is (already polished); otherwise
    ``refine=True`` polishes via :func:`refine_eigenpair`."""
    if isinstance(result, RefinedPair):
        lam1 = float(result.eigenvalue)
        v1 = np.asarray(result.eigenvector, np.float64)
    elif refine:
        rp = refine_eigenpair(A64, result)
        lam1, v1 = rp.eigenvalue, rp.eigenvector
    else:
        lam1 = float(result.eigenvalue)
        v1 = _host64(result.eigenvector)
    return lam1, v1 / np.linalg.norm(v1)


class SubdominantPair(NamedTuple):
    eigenvalue: float  # λ₂ (signed)
    eigenvector: np.ndarray  # unit 2-norm, ``dtype``
    ratio: float  # |λ₂/λ₁| — the measured convergence rate / spectral gap
    rounds: int  # power-iteration matvecs spent
    converged: bool
    residual: float  # ‖A·v₂ − λ₂·v₂‖₂ through the ORIGINAL A


def subdominant_eigenpair(
    A, result, eps: float = 1e-5, max_itr: int = 5000, refine: bool = True,
    dtype=torch.float32, device=None,
) -> SubdominantPair:
    """The second eigenpair (λ₂, v₂) of a symmetric positive matrix, by
    Hotelling deflation of the solver's dominant pair: a measured spectral
    gap beside :func:`convergence_report`'s estimate.

    ``result`` is any converged solve's :class:`..solver.SolveResult`, or a
    :class:`RefinedPair` used as it is.  Otherwise the dominant pair is first
    polished in float64 on the host (``refine=True``): the deflated operator
    B = A − λ₁·v̂₁v̂₁ᵀ carries a spurious eigenvalue of the order of the
    dominant residual in the v₁ direction, so an unpolished eps = 1e-3 pair
    bounds λ₂'s accuracy at ~1e-3·λ₁.  The deflated iteration runs on
    ``device`` (None: A's device if it is a tensor, else the card) in
    ``dtype`` through :func:`power_eigenpair`, from a fixed-seed normal start
    projected off v̂₁.  Only for symmetric A; needs |λ₂| > |λ₃|.
    """
    A64 = _require_symmetric(A, "subdominant_eigenpair")
    lam1, v1n = _deflation_seed(A64, result, refine)
    dev = solve_device(device, A)

    n = A64.shape[0]
    Aj = torch.tensor(A64, dtype=dtype, device=dev)
    v1j = torch.tensor(v1n, dtype=dtype, device=dev)
    lam1j = torch.tensor(lam1, dtype=dtype, device=dev)

    def deflated(x):
        return _matmul_f32(Aj, x) - lam1j * torch.dot(v1j, x) * v1j

    # start orthogonal to v̂₁: every round works on the deflated subspace
    x0 = _start(n, 0, dtype, dev)
    x0 = x0 - torch.dot(v1j, x0) * v1j
    pr = power_eigenpair(deflated, n, eps=eps, max_itr=max_itr, x0=x0, dtype=dtype, device=dev)
    v2 = np.asarray(_host(pr.eigenvector), _NP[dtype])
    lam2 = float(pr.eigenvalue)
    resid = float(np.linalg.norm(A64 @ v2.astype(np.float64) - lam2 * v2.astype(np.float64)))
    return SubdominantPair(
        lam2, v2, abs(lam2) / abs(lam1), int(pr.rounds), bool(pr.converged), resid,
    )


class TopKPairs(NamedTuple):
    eigenvalues: np.ndarray  # (k,) signed, ordered by decreasing |λ|
    eigenvectors: np.ndarray  # (n, k) columns, unit 2-norm, ``dtype``
    ratios: np.ndarray  # (k,) |λ_i/λ₁| — cumulative gap profile
    rounds: np.ndarray  # (k,) power-iteration matvecs per pair (0 = dominant)
    converged: np.ndarray  # (k,) bool
    residuals: np.ndarray  # (k,) ‖A·v_i − λ_i·v_i‖₂ through the ORIGINAL A


def top_k_eigenpairs(
    A, result, k: int, eps: float = 1e-5, max_itr: int = 5000,
    refine: bool = True, dtype=torch.float32, device=None,
) -> TopKPairs:
    """The ``k`` largest-|λ| eigenpairs of a symmetric positive matrix by
    successive Hotelling deflation — :func:`subdominant_eigenpair` iterated,
    each stage deflating every pair found so far (B_j = A − Σ_{i<j}
    λ_i·v_iv_iᵀ) and projecting its start and result off them (computed
    vectors are only eps-orthogonal, so without the projection the dominant
    directions come back through round-off).  Stage j starts from a normal
    vector of a generator seeded j.

    Accuracy compounds: pair j inherits the residuals of pairs < j, so deep
    k needs the float64-refined dominant pair (``refine=True``) and a tight
    ``eps``; the per-pair ``residuals`` (through the original A) report what
    was achieved.  Needs |λ_j| > |λ_{j+1}| at every computed stage.
    """
    if k < 1:
        raise ValueError(f"need k >= 1, got {k}")
    A64 = _require_symmetric(A, "top_k_eigenpairs")
    n = A64.shape[0]
    if k > n:
        raise ValueError(f"k={k} exceeds the dimension n={n}")
    lam1, v1 = _deflation_seed(A64, result, refine)
    dev = solve_device(device, A)
    npdt = _NP[dtype]

    lams = [lam1]
    vecs = [v1.astype(npdt)]
    rounds = [0]
    # a RefinedPair seed has no converged flag — its polish implies one
    conv = getattr(result, "converged", True)
    converged = [bool(conv.item() if isinstance(conv, torch.Tensor) else conv)]
    Aj = torch.tensor(A64, dtype=dtype, device=dev)
    for j in range(1, k):
        V = torch.tensor(np.stack(vecs, axis=1), dtype=dtype, device=dev)  # (n, j)
        lamv = torch.tensor(np.array(lams), dtype=dtype, device=dev)

        def deflated(x, _V=V, _lamv=lamv):
            return _matmul_f32(Aj, x) - _matmul_f32(_V, _lamv * _matmul_f32(_V.T, x))

        x0 = _start(n, j, dtype, dev)
        x0 = x0 - _matmul_f32(V, _matmul_f32(V.T, x0))
        pr = power_eigenpair(deflated, n, eps=eps, max_itr=max_itr, x0=x0, dtype=dtype,
                             device=dev)
        v = _host64(pr.eigenvector)
        # project out the found subspace again: the iterate re-acquires
        # O(eps) components of earlier directions through imperfect deflation
        Vh = np.stack([np.asarray(vi, np.float64) for vi in vecs], axis=1)
        v = v - Vh @ (Vh.T @ v)
        v /= np.linalg.norm(v)
        lam = float(v @ (A64 @ v))  # Rayleigh quotient through the true A
        lams.append(lam)
        vecs.append(v.astype(npdt))
        rounds.append(int(pr.rounds))
        converged.append(bool(pr.converged))

    Vout = np.stack(vecs, axis=1)
    lam_arr = np.array(lams)
    resid = np.array([
        float(np.linalg.norm(A64 @ Vout[:, i].astype(np.float64)
                             - lam_arr[i] * Vout[:, i].astype(np.float64)))
        for i in range(k)
    ])
    return TopKPairs(
        lam_arr, Vout, np.abs(lam_arr) / abs(lam_arr[0]),
        np.array(rounds), np.array(converged), resid,
    )
