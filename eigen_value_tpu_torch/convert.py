"""Carry matrices, solve state and configs across from the JAX package.

In this system data and solve state stand where a model would have
weights: these helpers take the JAX side's values as numpy arrays (or a
config's fields as a dict) and give the port's tensors, so both packages
can be fed the same inputs.  Dtypes travel by *name* ("float32", ...).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .checkpoint import SolverState
from .config import SolverConfig
from .ops.solver_matvec import _Carry

_DTYPES = {
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
}


def torch_dtype(dtype: Any) -> torch.dtype:
    """A torch dtype from a torch dtype, a dtype name, or anything numpy
    (or ml_dtypes) recognises, such as ``jnp.float32``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"no torch dtype for {dtype!r}") from None


def matrix_from_numpy(a, device="cpu", dtype=torch.float32) -> torch.Tensor:
    """A contiguous ``dtype`` copy of an array-like on ``device``.  A
    bfloat16 array (``np.asarray`` of a JAX bf16 array has ml_dtypes'
    bfloat16, which torch cannot take) is carried by its bits, so
    ``dtype=torch.bfloat16`` gives the same bits; float16 goes through
    numpy's own type."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device=device, dtype=torch_dtype(dtype))
    return torch.tensor(arr, dtype=torch_dtype(dtype), device=device)


def state_from_numpy(ev, v, lam, rounds: int, device="cpu", dtype=torch.float32) -> _Carry:
    """A matvec-form solve state ``(ev, v, λ, rounds)`` — the JAX loop
    carry — as the port's carry."""
    dt = torch_dtype(dtype)

    def vec(x):
        return torch.tensor(np.asarray(x), dtype=dt, device=device)

    return _Carry(vec(ev), vec(v), vec(lam).reshape(()), int(rounds))


def solver_state_from_numpy(state, device="cpu") -> SolverState:
    """A JAX ``checkpoint.SolverState`` given as numpy arrays (``A, ev, v,
    lam, rounds, done``, e.g. ``[np.asarray(x) for x in state]``) as the
    port's :class:`~.checkpoint.SolverState` on ``device``: A keeps its dtype
    (a bfloat16 A by its bits), the O(n) state its own, ``rounds`` int32 and
    ``done`` bool.  Stepping it further follows the port's contracts."""
    A, ev, v, lam, rounds, done = (np.asarray(x) for x in state)
    A = matrix_from_numpy(A, device, dtype=A.dtype.name)

    def vec(x):
        return torch.from_numpy(np.array(x)).to(device)

    return SolverState(
        A,
        vec(ev),
        vec(v),
        vec(lam).reshape(()),
        torch.tensor(int(rounds), dtype=torch.int32, device=device),
        torch.tensor(bool(done), device=device),
    )


def sparse_from_coo(indices, data, shape, device="cpu") -> torch.Tensor:
    """A coalesced torch sparse COO tensor from the numpy parts of a JAX
    BCOO matrix (``A_sp.indices``, (nse, 2), and ``A_sp.data``, (nse,)), so
    one matrix feeds both packages' ``sparse_matvec``.  Entries whose index
    lies outside ``shape`` (BCOO's padding) are dropped; duplicates sum."""
    idx = np.asarray(indices).reshape(-1, len(shape))
    vals = np.asarray(data)
    keep = np.all(idx < np.asarray(shape), axis=1)
    return torch.sparse_coo_tensor(
        torch.from_numpy(idx[keep].T.astype(np.int64)),
        torch.from_numpy(np.ascontiguousarray(vals[keep])),
        tuple(shape),
        device=device,
        check_invariants=True,
    ).coalesce()


def config_from_fields(fields: Mapping[str, Any]) -> SolverConfig:
    """A :class:`SolverConfig` from another package's config fields (e.g.
    ``dataclasses.asdict`` of the JAX config), with dtypes mapped by name."""
    kw = dict(fields)
    if "dtype" in kw:
        kw["dtype"] = torch_dtype(kw["dtype"])
    if kw.get("storage_dtype") is not None:
        kw["storage_dtype"] = torch_dtype(kw["storage_dtype"])
    return SolverConfig(**kw)
