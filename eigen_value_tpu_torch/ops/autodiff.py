"""Differentiable maximum eigenvalue and eigenpair (counterpart of
``eigen_value_tpu.ops.autodiff``), as ``torch.autograd.Function``\\ s.

The solve's host loop is not differentiable, but the Perron eigenvalue has
a closed-form adjoint: with right eigenvector v (A v = λ v) and left
eigenvector u (Aᵀ u = λ u),

    ∂λ/∂A = u vᵀ / (uᵀ v)

(invariant to either vector's scale).  The forward pass is the port's
``solve_matvec`` (``torch.mv`` in true f32, the JAX ``dot_f32`` loop); the
backward pass solves once more on Aᵀ, which is positive iff A is
(``torch.mv`` on the view ``A.T``: no copy).  The eigenpair's backward pass
solves the bordered adjoint system by a restarted GMRES written here in
PyTorch (:func:`_gmres`), on the solve's device.

The operator forms (:func:`eigenvalue_operator`, :func:`eigenpair_operator`)
never materialize A: the transpose's matvec is the vector-Jacobian product
of the matvec at frozen θ (``torch.func.vjp``, the counterpart of
``jax.linear_transpose``), and the θ cotangent is the gradient of the scalar
``uᵀ·matvec_θ(v)``.  θ is a tensor or a dict / list / tuple of tensors
(nested), flattened by hand.

Not ported: JAX's ``jit`` and ``vmap`` of these functions.  The solves are
host loops whose length depends on the data: they can be neither traced
nor vmapped.
"""

from __future__ import annotations

import sys
from typing import Callable, List, Optional

import torch

from ..config import EPS, MAX_ITR
from ..device import solve_device
from .solver_matvec import solve_matvec, solve_operator


class _Eigenvalue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, eps, max_itr):
        res = solve_matvec(A, eps, max_itr)
        ctx.save_for_backward(A, res.eigenvector)
        ctx.eps, ctx.max_itr = eps, max_itr
        return res.eigenvalue

    @staticmethod
    def backward(ctx, lam_bar):
        A, v = ctx.saved_tensors
        u = solve_matvec(A.T, ctx.eps, ctx.max_itr).eigenvector  # left eigenvector of A
        dA = lam_bar * torch.outer(u, v) / torch.dot(u, v)
        return dA, None, None


def eigenvalue(A: torch.Tensor, eps: float = EPS, max_itr: int = MAX_ITR) -> torch.Tensor:
    """Maximum eigenvalue of a positive square matrix (a tensor),
    differentiable in A."""
    return _Eigenvalue.apply(A, eps, max_itr)


class _Eigenpair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, eps, max_itr):
        res = solve_matvec(A, eps, max_itr)
        v = res.eigenvector / torch.max(res.eigenvector)
        ctx.save_for_backward(A, res.eigenvalue, v)
        ctx.eps = eps
        return res.eigenvalue, v

    @staticmethod
    def backward(ctx, lam_bar, v_bar):
        A, lam, v = ctx.saved_tensors
        n = A.shape[0]
        ej = _one_hot(v)
        rhs = torch.cat([v_bar, lam_bar.reshape(1)])
        sol, _ = _solve_bordered(A, lam, v, ej, rhs, _tolerance(A.dtype, ctx.eps))
        w = sol[:n]
        return -torch.outer(w, v), None, None


def eigenpair(A: torch.Tensor, eps: float = EPS, max_itr: int = MAX_ITR):
    """``(λ, v)`` of a positive square matrix, differentiable in A (both the
    eigenvalue and the eigenvector).

    ``v`` is normalized to ``max component = 1`` (``e_jᵀ v = 1`` with ``j =
    argmax(v)``, locally constant for a simple Perron pair).  The eigen
    equation's differential with that normalization gives the bordered
    system ``[[A − λI, −v], [e_jᵀ, 0]] [dv; dλ] = [−dA·v; 0]``, whose matrix
    K is nonsingular for a simple eigenpair.  The backward pass solves the
    adjoint ``Kᵀ[w; s] = [v̄; λ̄]`` and returns ``Ā = −w vᵀ``; for v̄ = 0 this
    is :func:`eigenvalue`'s adjoint.  The solve is checked by its residual,
    with fallbacks (:func:`_solve_bordered`).
    """
    return _Eigenpair.apply(A, eps, max_itr)


def _one_hot(v: torch.Tensor) -> torch.Tensor:
    ej = torch.zeros_like(v)
    ej[torch.argmax(v)] = 1
    return ej


def _tolerance(dtype: torch.dtype, eps: float) -> float:
    """The bordered solve's relative tolerance.  It must be reachable or
    GMRES runs to its cap and returns garbage: at least ~50 machine epsilons
    of the dtype (f32: ~6e-6) and a tenth of the forward solve's eps ((λ, v)
    are only eps-accurate, so the system is inconsistent below that)."""
    return max(50.0 * float(torch.finfo(dtype).eps), 1e-9, 0.1 * float(eps))


#: Largest n for which the fallback of a failed GMRES is a dense direct
#: solve of the (n+1)² bordered matrix (≤ ~4 MB in f32); above it the
#: fallback is a 4× longer GMRES, matvecs only.
_DENSE_FALLBACK_MAX_N = 1024


def _normalized(x: torch.Tensor, thresh) -> tuple:
    """``(x / |x|, |x|)``, or zeros for both where ``|x| <= thresh``, with no
    read back to the host (JAX's ``_safe_normalize``)."""
    norm = torch.linalg.vector_norm(x)
    ok = norm > thresh
    unit = torch.where(ok, x / torch.where(ok, norm, torch.ones_like(norm)), torch.zeros_like(x))
    return unit, torch.where(ok, norm, torch.zeros_like(norm))


def _gmres(matvec: Callable, b: torch.Tensor, tol: float, restart: int, maxiter: int):
    """Restarted GMRES for ``matvec(x) = b`` from x = 0 (JAX's
    ``gmres(..., atol=0, solve_method="batched")``): each restart builds a
    ``restart``-dimensional Krylov basis by Arnoldi with classical
    Gram-Schmidt applied twice, then solves the Hessenberg least squares;
    restarts run while ``|b − A x| > tol·|b|``, up to ``maxiter``.  A
    breakdown (an invariant subspace) keeps the unused rows of H at the
    identity, as in JAX, so the least squares keeps full rank.  The host
    reads one residual a restart; an Arnoldi step reads nothing.

    The least squares is a Householder QR in float64 (H is at most
    151 × 150).  JAX solves its normal equations in the working dtype,
    which squares H's condition: in float32 on an H100 that made the
    restarts of the 2048² bordered system diverge."""
    n = b.shape[0]
    restart = min(restart, n)
    eps = torch.finfo(b.dtype).eps
    x = torch.zeros_like(b)
    atol = tol * float(torch.linalg.vector_norm(b))
    r, r_norm = _normalized(b - matvec(x), 0.0)
    for _ in range(maxiter):
        if not float(r_norm) > atol:
            break
        V = torch.zeros(restart + 1, n, dtype=b.dtype, device=b.device)
        V[0] = r
        H = torch.eye(restart, restart + 1, dtype=b.dtype, device=b.device)
        alive = torch.ones((), dtype=torch.bool, device=b.device)
        for k in range(restart):
            w = matvec(V[k])
            w_norm0 = torch.linalg.vector_norm(w)
            Q = V[:k + 1]
            h = Q @ w
            w = torch.addmv(w, Q.T, h, alpha=-1)
            h2 = Q @ w  # "twice is enough"
            w = torch.addmv(w, Q.T, h2, alpha=-1)
            unit, w_norm = _normalized(w, eps * w_norm0)
            row = torch.cat([h + h2, w_norm.reshape(1), H.new_zeros(restart - k - 1)])
            H[k] = torch.where(alive, row, H[k])
            V[k + 1] = torch.where(alive, unit, V[k + 1])
            alive = alive & (w_norm != 0)
        Qh, R = torch.linalg.qr(H.T.double())  # min |Hᵀ y − r_norm·e₁|
        y = torch.linalg.solve_triangular(R, r_norm.double() * Qh[:1].T, upper=True)
        x = torch.addmv(x, V[:-1].T, y[:, 0].to(b.dtype))
        r, r_norm = _normalized(b - matvec(x), 0.0)
    return x


def _warn_if_unconverged(resid: float, bound: float) -> None:
    """A warning on stderr when even the fallback solve missed its residual
    bound: the gradient is then best-effort, never silently."""
    if resid > bound:
        print(
            f"eigen_value_tpu_torch: eigenpair VJP bordered solve residual "
            f"{resid:.3e} exceeds its bound {bound:.3e}; the returned gradient "
            f"may be inaccurate (near-defective spectrum?)",
            file=sys.stderr,
        )


def _bordered_matvec(rmv: Callable, lam, v, ej) -> Callable:
    """``[w; s] ↦ Kᵀ[w; s] = [(Aᵀ − λI)w + e_j·s; −vᵀw]`` for ``rmv(w) = Aᵀw``."""
    n = v.shape[0]

    def KT_mv(ws):
        w, s = ws[:n], ws[n]
        return torch.cat([rmv(w) - lam * w + ej * s, -torch.dot(v, w).reshape(1)])

    return KT_mv


def _checked_gmres(KT_mv: Callable, rhs: torch.Tensor, tol: float, maxiter: int = 10,
                   dense: Optional[Callable] = None):
    """GMRES on ``Kᵀ x = rhs``, accepted only if its relative residual is
    within 30·tol (restarted GMRES can stagnate on a near-singular K, a
    small spectral gap, or at large n); otherwise ``dense()`` when given,
    else a GMRES with a 4× budget.  A fallback that still misses the bound
    prints a warning.  Returns ``(x, rel_residual)``."""
    n = rhs.shape[0] - 1
    scale = torch.linalg.vector_norm(rhs) + torch.finfo(rhs.dtype).tiny

    def rel_resid(x) -> float:
        return float(torch.linalg.vector_norm(KT_mv(x) - rhs) / scale)

    sol = _gmres(KT_mv, rhs, tol, restart=min(n + 1, 100), maxiter=maxiter)
    if rel_resid(sol) > 30.0 * tol:
        if dense is not None:
            sol = dense()
        else:
            sol = _gmres(KT_mv, rhs, tol, restart=min(n + 1, 150), maxiter=4 * max(maxiter, 10))
    resid = rel_resid(sol)
    _warn_if_unconverged(resid, 30.0 * tol)
    return sol, resid


def _solve_bordered(A, lam, v, ej, rhs, tol, maxiter=10):
    """Solve ``Kᵀ x = rhs`` for the bordered adjoint system of a dense A,
    checked (:func:`_checked_gmres`): the fallback is a dense direct solve of
    the (n+1)² system for n ≤ ``_DENSE_FALLBACK_MAX_N``, else the longer
    GMRES.  Returns ``(x, rel_residual)``."""
    n = A.shape[0]
    At = A.T

    def dense():
        KT = torch.zeros(n + 1, n + 1, dtype=A.dtype, device=A.device)
        KT[:n, :n] = At - lam * torch.eye(n, dtype=A.dtype, device=A.device)
        KT[:n, n] = ej
        KT[n, :n] = -v
        return torch.linalg.solve(KT, rhs)

    KT_mv = _bordered_matvec(lambda w: torch.mv(At, w), lam, v, ej)
    return _checked_gmres(KT_mv, rhs, tol, maxiter, dense if n <= _DENSE_FALLBACK_MAX_N else None)


# --------------------------------------------------------------- operators


def _flatten(theta) -> tuple:
    """``(leaves, rebuild)``: the tensors of θ (a tensor, or a dict / list /
    tuple of them, nested) in order, and the function that puts tensors in
    their places."""
    if isinstance(theta, torch.Tensor):
        return [theta], lambda leaves: leaves[0]
    if isinstance(theta, dict):
        keys, parts = list(theta), [_flatten(theta[k]) for k in theta]
    elif isinstance(theta, (list, tuple)):
        keys, parts = None, [_flatten(t) for t in theta]
    else:
        raise TypeError(
            f"theta must be a tensor or a dict / list / tuple of tensors, got {type(theta)}"
        )
    sizes = [len(leaves) for leaves, _ in parts]

    def rebuild(leaves: List[torch.Tensor]):
        out, at = [], 0
        for (_, part), size in zip(parts, sizes):
            out.append(part(leaves[at:at + size]))
            at += size
        if keys is not None:
            return dict(zip(keys, out))
        return type(theta)(out)

    return [t for leaves, _ in parts for t in leaves], rebuild


def _transpose(matvec: Callable, n: int, dtype, device) -> Callable:
    """``y ↦ Aᵀ y`` for the linear ``matvec``: its vector-Jacobian product
    (at 0; a linear map's is the same everywhere)."""
    _, vjp = torch.func.vjp(matvec, torch.zeros(n, dtype=dtype, device=device))
    return lambda y: vjp(y)[0]


def _theta_grad(make_matvec, leaves, rebuild, left, right):
    """The gradient in θ's leaves of ``leftᵀ·matvec_θ(right)`` (None for a
    leaf the matvec does not use)."""
    with torch.enable_grad():
        live = [t.detach().requires_grad_(True) for t in leaves]
        s = torch.dot(left, make_matvec(rebuild(live))(right))
        return torch.autograd.grad(s, live, allow_unused=True)


def _warn_if_operator_unconverged(converged: bool, api_name="eigenvalue_operator") -> None:
    """A warning on stderr when a matrix-free adjoint used a solve that hit
    the iteration cap; ``api_name`` is the entry point the user called."""
    if not converged:
        print(
            f"eigen_value_tpu_torch: {api_name} VJP ran on an "
            "UNCONVERGED solve (iteration cap hit); the returned "
            "gradient uses pre-convergence eigenvector iterates and "
            "may be inaccurate — raise max_itr or loosen eps",
            file=sys.stderr,
        )


def eigenvalue_operator(
    make_matvec, n: int, eps: float = EPS, max_itr: int = MAX_ITR, device=None
):
    """Matrix-free differentiable maximum eigenvalue.

    ``make_matvec(theta)`` builds a positive-operator matvec ``x ↦ A(θ)·x``;
    the returned function ``theta ↦ λ_max(A(θ))`` is differentiable without
    A ever being materialized: the forward solve is ``solve_operator``; the
    left eigenvector a solve against Aᵀ, whose matvec is the VJP of the
    matvec at frozen θ; and ``∂λ/∂θ = uᵀ(∂A/∂θ)v / (uᵀv)`` is the gradient of
    ``uᵀ·matvec_θ(v)`` at frozen u, v.  The solves run on ``device``, else on
    θ's device (the CUDA card for a θ with no tensor).  A forward or
    transpose solve that hit the cap prints a warning.
    """

    class _Lambda(torch.autograd.Function):
        @staticmethod
        def forward(ctx, rebuild, *leaves):
            dev = solve_device(device, *leaves)
            res = solve_operator(make_matvec(rebuild(list(leaves))), n, eps, max_itr, device=dev)
            ctx.save_for_backward(*leaves, res.eigenvector)
            ctx.rebuild, ctx.dev, ctx.converged = rebuild, dev, res.converged
            return res.eigenvalue

        @staticmethod
        def backward(ctx, lam_bar):
            *leaves, v = ctx.saved_tensors
            rmv = _transpose(make_matvec(ctx.rebuild(leaves)), n, v.dtype, ctx.dev)
            ures = solve_operator(rmv, n, eps, max_itr, dtype=v.dtype, device=ctx.dev)
            u = ures.eigenvector
            _warn_if_operator_unconverged(bool(ctx.converged & ures.converged))
            scale = lam_bar / torch.dot(u, v)
            grads = _theta_grad(make_matvec, leaves, ctx.rebuild, u, v)
            return (None, *(None if g is None else g * scale for g in grads))

    def lam_fn(theta):
        leaves, rebuild = _flatten(theta)
        return _Lambda.apply(rebuild, *leaves)

    return lam_fn


def eigenpair_operator(
    make_matvec, n: int, eps: float = EPS, max_itr: int = MAX_ITR, device=None
):
    """Matrix-free differentiable ``(λ, v)`` (v normalized to max component
    1), the operator form of :func:`eigenpair`.  The backward pass solves the
    same bordered adjoint ``Kᵀ[w; s] = [v̄; λ̄]`` through matvecs only (Aᵀw is
    the matvec's VJP) and returns the θ cotangent ``−∂(wᵀ·matvec_θ(v))/∂θ``,
    the matrix-free reading of ``Ā = −w vᵀ``.  There is no dense fallback (no
    dense matrix exists): a GMRES that misses its bound retries with a 4×
    budget and warns if it still misses.
    """

    class _Pair(torch.autograd.Function):
        @staticmethod
        def forward(ctx, rebuild, *leaves):
            dev = solve_device(device, *leaves)
            res = solve_operator(make_matvec(rebuild(list(leaves))), n, eps, max_itr, device=dev)
            v = res.eigenvector / torch.max(res.eigenvector)
            ctx.save_for_backward(*leaves, res.eigenvalue, v)
            ctx.rebuild, ctx.dev, ctx.converged = rebuild, dev, res.converged
            return res.eigenvalue, v

        @staticmethod
        def backward(ctx, lam_bar, v_bar):
            *leaves, lam, v = ctx.saved_tensors
            _warn_if_operator_unconverged(bool(ctx.converged), api_name="eigenpair_operator")
            rmv = _transpose(make_matvec(ctx.rebuild(leaves)), n, v.dtype, ctx.dev)
            KT_mv = _bordered_matvec(rmv, lam, v, _one_hot(v))
            rhs = torch.cat([v_bar, lam_bar.reshape(1)])
            sol, _ = _checked_gmres(KT_mv, rhs, _tolerance(v.dtype, eps))
            grads = _theta_grad(make_matvec, leaves, ctx.rebuild, sol[:n], v)
            return (None, *(None if g is None else -g for g in grads))

    def pair_fn(theta):
        leaves, rebuild = _flatten(theta)
        return _Pair.apply(rebuild, *leaves)

    return pair_fn
