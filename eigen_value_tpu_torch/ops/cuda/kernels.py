"""Wrappers of the Hopper kernels, each with its plain PyTorch version.

Counterparts of ``eigen_value_tpu.ops.pallas.kernels.matvec`` and
``.multiround``: same arguments and returns.  A wrapper checks device,
dtype (float32), shape and contiguity and raises on anything else.  For
CPU tensors it runs the plain version; for CUDA tensors it launches the
kernel or raises — there is no fallback.  ``<wrapper>.launches`` counts
kernel launches (a plain int; plain-version calls do not count).

The plain versions run anywhere.  ``matvec_plain`` is ``torch.mv``: a GEMV
in full float32 (cuBLAS gemv on the card, which has no TF32 mode; TF32
would put row-sum noise above the absolute 1e-3 stop once λ ≳ 1).
"""

from __future__ import annotations

import functools

import torch

from ...device import multiround_fits, tensor_device
from ..solver import stop_check


def _check_f32(name: str, t: torch.Tensor, shape: tuple) -> None:
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_aligned(cols: int, *tensors: torch.Tensor) -> None:
    # the float4 path (cols % 4 == 0) reads 16-byte aligned rows
    if cols % 4 == 0 and any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the float4 kernels need 16-byte aligned tensors")


def _launch(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed with cudaError {rc}")


def matvec_plain(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` in float32 with PyTorch's GEMV.  Its sums run in cuBLAS's
    order, not the kernel's: on an H100 the Hilbert 65536² row sums come
    out ~3e-5 relative off a float64 product, the kernel's ~2e-7."""
    return torch.mv(A, x)


def matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` for A (n, m) and x (m,), float32."""
    if A.dim() != 2:
        raise ValueError(f"A must be 2-D, got shape {tuple(A.shape)}")
    n, m = A.shape
    _check_f32("A", A, (n, m))
    _check_f32("x", x, (m,))
    dev = tensor_device(A, x)
    if dev.type == "cpu":
        return matvec_plain(A, x)
    _check_aligned(m, A, x)
    from . import build

    y = torch.empty(n, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(
            build.load().evt_matvec(A.data_ptr(), x.data_ptr(), y.data_ptr(), n, m, stream),
            "matvec",
        )
    matvec.launches += 1
    return y


matvec.launches = 0


def _as_scalar(lam, dev: torch.device) -> torch.Tensor:
    lam = torch.as_tensor(lam, dtype=torch.float32, device=dev)
    if lam.numel() != 1:
        raise ValueError(f"lam must be a scalar, got shape {tuple(lam.shape)}")
    return lam.reshape(())


def multiround_plain(
    A: torch.Tensor,
    ev: torch.Tensor,
    v: torch.Tensor,
    lam,
    budget: int,
    *,
    chunk: int,
    eps: float,
    init: bool = False,
    eps_mode: str = "absolute",
):
    """Up to ``chunk`` matvec-form rounds, round for round what the kernel
    does.  Each round checks the stop BEFORE advancing and the solve freezes
    at the round that stops (or that reaches ``budget`` advanced rounds).
    ``init=True`` makes round 0 the row-sum pass (no check, not counted; v
    is then ignored).  Returns ``(ev, v, advanced, λ)``."""
    lam = _as_scalar(lam, A.device)
    adv = 0
    frozen = False
    raw = None
    for r in range(chunk):
        if r != 0:
            v = raw / ev
        if not init or r != 0:
            if bool(stop_check(v, eps, eps_mode)) or adv >= budget:
                frozen = True
                break
            lam = v[0]
            m = torch.max(v)
            ev = ev * (v / m)
            adv += 1
        raw = matvec_plain(A, ev)
    if not frozen:
        v = raw / ev
    return ev, v, torch.tensor(adv, dtype=torch.int32, device=A.device), lam


@functools.lru_cache(maxsize=None)
def multiround_grid(device: torch.device, n: int) -> int:
    """Blocks of the multiround kernel that are co-resident on ``device``
    at dimension ``n`` (the cooperative launch's grid), computed once."""
    from . import build

    with torch.cuda.device(device):
        grid = build.load().evt_multiround_grid(n)
    if grid < 0:
        raise RuntimeError(f"multiround occupancy query failed with cudaError {-grid}")
    return grid


def multiround(
    A: torch.Tensor,
    ev: torch.Tensor,
    v: torch.Tensor,
    lam,
    budget: int,
    *,
    chunk: int,
    eps: float,
    init: bool = False,
    eps_mode: str = "absolute",
):
    """Up to ``chunk`` matvec-form rounds in one launch of the persistent
    kernel; semantics of :func:`multiround_plain`.  Returns
    ``(ev, v, advanced, λ)`` with ``advanced`` an int32 tensor."""
    if A.dim() != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"A must be square, got shape {tuple(A.shape)}")
    n = A.shape[0]
    if n == 0:
        raise ValueError("A must be non-empty")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if eps_mode not in ("absolute", "relative"):
        raise ValueError(f"unknown eps_mode {eps_mode!r}")
    _check_f32("A", A, (n, n))
    _check_f32("ev", ev, (n,))
    _check_f32("v", v, (n,))
    dev = tensor_device(A, ev, v)
    lam = _as_scalar(lam, dev)
    budget = int(budget)
    if dev.type == "cpu":
        return multiround_plain(
            A, ev, v, lam, budget, chunk=chunk, eps=eps, init=init, eps_mode=eps_mode
        )
    _check_aligned(n, A)
    if not multiround_fits(n, dev):
        raise ValueError(
            f"n={n}: the multiround kernel keeps ev ({4 * n} bytes) in one "
            f"block's shared memory, more than this card allows; use "
            f"backend='matvec_pallas'"
        )
    from . import build

    ev_out = torch.empty(n, dtype=torch.float32, device=dev)
    v_out = torch.empty(n, dtype=torch.float32, device=dev)
    adv = torch.empty((), dtype=torch.int32, device=dev)
    lam_out = torch.empty((), dtype=torch.float32, device=dev)
    raw = torch.empty(2 * n, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = build.load().evt_multiround(
            A.data_ptr(), ev.data_ptr(), v.data_ptr(), lam.data_ptr(),
            min(budget, 2**31 - 1),
            ev_out.data_ptr(), v_out.data_ptr(), adv.data_ptr(), lam_out.data_ptr(),
            raw.data_ptr(), n, min(chunk, 2**31 - 1), eps, int(init),
            int(eps_mode == "relative"), multiround_grid(dev, n), stream,
        )
        _launch(rc, "multiround")
    multiround.launches += 1
    return ev_out, v_out, adv, lam_out


multiround.launches = 0
