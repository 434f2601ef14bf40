"""The plain reference, and the control computed below its precision.

The method of itzmeanjan/eigen_value (``include/similarity_transform.hpp``)
in its power form, which never forms the transformed matrix:

    v₀ = A·1 (the row sums);  each round, while i < max_itr and the
    wraparound stop  max_k |v[k] − v[(k + 1) mod n]| < eps  does not hold:
        m = max v;  ev ← ev·(v/m);  λ ← v[0];  v ← (A·ev)/ev;  i ← i + 1
    then, if the stop held (i < max_itr): ev ← ev·(v/max v), λ = v[0].

The stop is absolute and checked before the update, rounds count from 0,
and at the cap the last checked round's λ is reported with converged
false, as in the reference.  ``(A·ev)/ev`` is the row-sum vector of the
reference's ``D⁻¹AD``, so its rounds are the reference's rounds.

:func:`solve` runs it in float64 on the stored matrix, a block of rows at a
time on the matrix's own device.  :func:`solve_control` runs the same loop
with the product computed one precision below the configuration's:

* ``tf32``: both operands of A·ev rounded to TF32 (10 mantissa bits,
  nearest, ties away, as ``cvt.rna``), products and sums in float32, the
  O(n) state in float32: the tensor cores' TF32 in place of float32 with
  TF32 off;
* ``fp8``: A held in float8 e4m3 with a scale a row (the row's largest
  entry maps to 448), the product and the state in float32: fp8 in place
  of a bfloat16 A.

Imports torch only: nothing of the program under test, nothing it made.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

#: Bytes of the widened copy of a block of rows made at once.
BLOCK_BYTES = 512 << 20


class Solution(NamedTuple):
    eigenvalue: float
    eigenvector: torch.Tensor
    rounds: int
    converged: bool
    #: min over the stop checks of |gap − eps| / eps: how near a check came
    #: to deciding the other way
    stop_margin: float


def _blocked_matvec(A: torch.Tensor, dtype: torch.dtype,
                    widen: Callable[[torch.Tensor], torch.Tensor],
                    vec: Callable[[torch.Tensor], torch.Tensor] = lambda x: x):
    """``x -> A @ vec(x)`` in ``dtype``, widening A a block of rows at a time."""
    n = A.shape[0]
    rows = max(1, BLOCK_BYTES // (n * torch.empty((), dtype=dtype).element_size()))

    def matvec(x: torch.Tensor) -> torch.Tensor:
        xv = vec(x)
        out = torch.empty(n, dtype=dtype, device=A.device)
        for r in range(0, n, rows):
            torch.mv(widen(A[r:r + rows]), xv, out=out[r:r + rows])
        return out

    return matvec


def _gap(v: torch.Tensor) -> float:
    """The stop's largest wraparound difference of v."""
    if v.numel() < 2:
        return 0.0
    return float(torch.maximum((v[1:] - v[:-1]).abs().max(), (v[-1] - v[0]).abs()))


def power_solve(matvec, n: int, dtype: torch.dtype, device, eps: float,
                max_itr: int) -> Solution:
    """The reference's loop over ``matvec(x) -> A @ x``, state in ``dtype``."""
    ev = torch.ones(n, dtype=dtype, device=device)
    v = matvec(ev) / ev
    lam = torch.zeros((), dtype=dtype, device=device)
    i, margin = 0, float("inf")
    while i < max_itr:
        gap = _gap(v)
        margin = min(margin, abs(gap - eps) / eps)
        if gap < eps:
            break
        m = v.max()
        ev = ev * (v / m)
        lam = v[0]
        v = matvec(ev) / ev
        i += 1
    converged = i < max_itr
    if converged:
        ev = ev * (v / v.max())
        lam = v[0]
    return Solution(float(lam), ev, i, converged, margin)


def _no_tf32() -> None:
    """Matrix products in float32 mean float32 here (PyTorch's default)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def solve(A: torch.Tensor, eps: float, max_itr: int) -> Solution:
    """The reference in float64 on the stored A (any float dtype; every
    float32, bfloat16 and float16 value is exact in float64)."""
    _no_tf32()
    f64 = torch.float64
    mv = _blocked_matvec(A, f64, lambda blk: blk.to(f64))
    return power_solve(mv, A.shape[0], f64, A.device, eps, max_itr)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits; to nearest, ties
    away from zero), kept in float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def fp8_rows(blk: torch.Tensor) -> torch.Tensor:
    """Rows held in float8 e4m3 with a scale a row, read back in float32."""
    f = blk.to(torch.float32)
    scale = f.abs().amax(1, keepdim=True) / 448.0
    return (f / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


CONTROLS = {
    "tf32": dict(widen=lambda blk: tf32_round(blk.to(torch.float32)), vec=tf32_round),
    "fp8": dict(widen=fp8_rows),
}


def solve_control(A: torch.Tensor, kind: str, eps: float, max_itr: int) -> Solution:
    """The reference's loop with its product one precision below the
    configuration's (``CONTROLS``), the state in float32."""
    _no_tf32()
    f32 = torch.float32
    mv = _blocked_matvec(A, f32, **CONTROLS[kind])
    return power_solve(mv, A.shape[0], f32, A.device, eps, max_itr)
