"""Public API (counterpart of ``eigen_value_tpu.api``).

``max_eigenvalue`` is the functional entry returning a :class:`SolveResult`
of tensors; ``EigenValue.similarity_transform(mat)`` returns the reference
wrapper's ``(λ, v, ms, rounds)``.  A matrix solves where it lives: on a
CUDA device through the hand-written kernels, on the CPU through their
plain versions.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Optional, Tuple

import numpy as np
import torch

from .config import DEFAULT_CONFIG, SolverConfig
from .device import multiround_fits
from .ops.solver import SolveResult


def resolve_backend(config: SolverConfig, n: int, device: torch.device) -> str:
    """Resolve "auto" to a concrete backend for a dim-n solve on ``device``.

    On a CUDA device "auto" takes the multiround kernel at every n whose ev
    vector fits its shared memory (the JAX package's 6144 boundary is a TPU
    VMEM-residency cliff with no counterpart here), the matvec kernel loop
    beyond; on the CPU it takes the ``torch.mv`` loop, as JAX does off-TPU.
    """
    if config.backend != "auto":
        return config.backend
    if device.type == "cuda":
        return "multiround" if multiround_fits(n, device) else "matvec_pallas"
    return "matvec"


def _not_ported(knob: str, item: str) -> ValueError:
    return ValueError(f"{knob} is not ported to eigen_value_tpu_torch yet (ROADMAP: {item})")


def _solve_fn(config: SolverConfig, backend: str):
    """The solve callable for ``backend``.  Every knob is honored or
    rejected with a ValueError (the JAX package's contract); the knobs this
    port has not implemented name their ROADMAP item."""
    if backend in ("xla", "pallas"):
        raise _not_ported(
            f"backend={backend!r} (the iterated mutate-A solve)", "Queue 1 item 7"
        )
    if config.storage_dtype is not None:
        raise _not_ported(
            f"storage_dtype={config.storage_dtype}", "Queue 1 item 6"
        )
    if config.cache_tiles:
        raise _not_ported(
            f"cache_tiles={config.cache_tiles} (the resident tile cache of "
            f"multiround_sym)",
            "Queue 2 item 3",
        )
    if config.symmetric and config.backend != "auto":
        if backend == "multiround":
            raise _not_ported(
                "symmetric=True with backend='multiround' (the upper-triangle "
                "kernel multiround_sym)",
                "Queue 2 item 3",
            )
        raise ValueError(
            f"symmetric=True is implemented by the multiround backend only; "
            f"backend={config.backend!r} would silently stream the full matrix"
        )
    for knob in ("block_rows", "block_cols", "interpret"):
        if getattr(config, knob) is not None:
            raise ValueError(
                f"{knob}={getattr(config, knob)!r} is a TPU tile/interpret knob: "
                f"the Hopper kernels give each row to one warp and the device of "
                f"the matrix picks kernel or plain version, so it would be "
                f"silently dropped"
            )
    if config.chunk is not None and backend != "multiround":
        raise ValueError(
            f"chunk={config.chunk} is a multiround-backend knob but the "
            f"{'resolved' if config.backend == 'auto' else 'requested'} backend "
            f"is {backend!r}; it would be silently dropped"
        )
    if config.cache_tiles is not None and backend != "multiround":
        raise ValueError(
            f"cache_tiles={config.cache_tiles} is a multiround-backend knob but "
            f"the backend is {backend!r}; it would be silently dropped"
        )
    from .ops import solver_matvec as sm

    kw = dict(eps=config.eps, max_itr=config.max_itr, eps_mode=config.eps_mode)
    if backend == "multiround":
        return partial(sm.solve_multiround, chunk=config.chunk, **kw)
    if backend == "matvec_pallas":
        return partial(sm.solve_matvec_kernel, **kw)
    return partial(sm.solve_matvec, **kw)


def _as_matrix(mat, dtype) -> torch.Tensor:
    if not isinstance(mat, torch.Tensor):
        mat = torch.tensor(np.asarray(mat))  # a copy: host arrays may be read-only
    if mat.dim() != 2 or mat.shape[0] != mat.shape[1]:
        raise ValueError(f"must be a square matrix, got shape {tuple(mat.shape)}")
    return mat.to(dtype).contiguous()


def max_eigenvalue(
    mat, config: SolverConfig = DEFAULT_CONFIG, validate: bool = False, mesh=None
) -> SolveResult:
    """Maximum eigenvalue and eigenvector of a positive square matrix.

    ``mat`` (a tensor, or anything ``torch.as_tensor`` takes) is cast to
    ``config.dtype`` and solved on its device.  ``validate=True`` checks
    positivity on the device, and bitwise symmetry when ``symmetric=True``
    is declared, and raises instead of returning garbage.  ``mesh`` (the
    sharded solves) is rejected until ported.
    """
    if mesh is not None:
        raise _not_ported("mesh= (the sharded solves)", "Queue 1 item 10")
    mat = _as_matrix(mat, config.dtype)
    backend = resolve_backend(config, mat.shape[0], mat.device)
    solve = _solve_fn(config, backend)
    if validate:
        if not bool(torch.all(mat > 0)):
            raise ValueError("similarity-transform method requires all entries > 0")
        if config.symmetric and not bool(torch.equal(mat, mat.T)):
            raise ValueError(
                "symmetric=True declared but the matrix is not bitwise symmetric"
            )
    return solve(mat)


def eigen_residual(mat, result: SolveResult) -> torch.Tensor:
    """``max |A·v − λ·v|`` computed in float64 (the reference wrapper test's
    acceptance check, atol 1e-3)."""
    A = torch.as_tensor(mat).to(torch.float64)
    v = result.eigenvector.to(A.device, torch.float64)
    lam = result.eigenvalue.to(A.device, torch.float64)
    return torch.max(torch.abs(A @ v - lam * v))


class EigenValue:
    """Class API with the reference wrapper's return convention:
    ``similarity_transform(mat) -> (eigenvalue, eigenvector, ts_ms, rounds)``.

    ``device`` pins solves to one device (None: the matrix's own).  On a
    CUDA device ``ts_ms`` is the solve's time between two CUDA events on
    the current stream, read after a synchronise; on the CPU it is the wall
    time of the solve.
    """

    def __init__(
        self, config: SolverConfig = DEFAULT_CONFIG, device: Optional[torch.device] = None
    ) -> None:
        self.config = config
        self.device = torch.device(device) if device is not None else None

    def similarity_transform(self, mat) -> Tuple[np.float32, np.ndarray, float, int]:
        mat = _as_matrix(mat, self.config.dtype)
        if self.device is not None:
            mat = mat.to(self.device)
        if mat.is_cuda:
            with torch.cuda.device(mat.device):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                res = max_eigenvalue(mat, self.config)
                end.record()
                end.synchronize()
                ms = float(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            res = max_eigenvalue(mat, self.config)
            ms = (time.perf_counter() - t0) * 1e3
        return (
            res.eigenvalue.cpu().numpy()[()],
            res.eigenvector.cpu().numpy(),
            ms,
            int(res.rounds),
        )
