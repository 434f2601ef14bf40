"""Public API (counterpart of ``eigen_value_tpu.api``).

``max_eigenvalue`` is the functional entry returning a :class:`SolveResult`
of tensors; ``EigenValue.similarity_transform(mat)`` returns the reference
wrapper's ``(λ, v, ms, rounds)``.

Where a solve runs.  A ``torch.Tensor`` solves where it lives (its owner
placed it): on a CUDA device through the hand-written kernels, on the CPU
through their plain versions.  Host input (a numpy array, a list, anything
that is not a tensor) has no device of its own and goes to the CUDA card;
with no card that raises, it never runs on the CPU unasked.
``device="cpu"`` (an argument of ``max_eigenvalue`` and of ``EigenValue``)
is how a caller asks for the CPU; a ``device`` also moves a tensor.

Reduced-precision storage (``SolverConfig(storage_dtype=torch.bfloat16)``
or ``torch.float16``) is honored by "matvec", "matvec_pallas", "multiround"
and "auto": a matrix already in the storage dtype is solved as it is (no f32
copy), any other is cast to ``config.dtype`` and then once to the storage
dtype.  The kernels read A in 2 bytes and multiply it with the f32 ev; all
O(n) state is f32 (``ops/solver_matvec.py``).  Where the JAX package routes
"matvec" / "matvec_pallas" storage to ``solve_matvec_storage`` (which
divides by a quantized ev), the port runs its own loops with the kernels'
contract.
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .config import DEFAULT_CONFIG, SolverConfig
from .device import multiround_fits, multiround_sym_fits, solve_device, sym_auto_cache_tiles
from .ops import solver_matvec as sm
from .ops.cuda import kernels
from .ops.solver import SolveResult, solve_xla
from .ops.solver_kernel import solve_kernel
from .utils.profiling import span


def _cache_unservable(cache_tiles: int, n: int, tile: int, consequence: str) -> ValueError:
    """The honored-or-rejected error for an explicit cache request that the
    tiled kernel cannot serve at this dim and tile (JAX's
    ``_cache_unalignable``)."""
    why = (
        f"kernels.sym_tile(n, {tile}) is None — "
        f"{'raise block_rows to >= 128' if tile < 128 else 'this dim has no such divisor'}"
        if kernels.sym_tile(n, tile) is None
        else "the triangle kernel's state does not fit one block on this card"
    )
    return ValueError(
        f"cache_tiles={cache_tiles} needs a 128-aligned square tile that divides "
        f"n={n} ({why}); {consequence}. Drop cache_tiles or adjust block_rows."
    )


#: The backends that run hand-written kernels (plain versions on the CPU).
_KERNEL_BACKENDS = ("matvec_pallas", "multiround", "pallas")
#: The storage dtypes the kernels read (float32 is no reduction, but a
#: valid storage as in JAX).
_STORAGE = (torch.bfloat16, torch.float16, torch.float32)


class Route(NamedTuple):
    """Where a dim-n solve under a config goes on a device (:func:`route`).
    ``kernel`` is "triangle", "tiled" (the dense tiled kernel), "stripes",
    "matvec" (the matvec kernel loop), "iterated" (rowsum and scale_rowsum)
    or None (torch operations alone).  ``fits``: whether the card holds the
    persistent kernel's state at n (always off the card and for the loops);
    a launch that does not fit raises."""

    backend: str  # "auto" resolved: resolve_backend's answer
    solve: Callable  # solve(mat) -> SolveResult, every knob bound
    kernel: Optional[str]
    bt: Optional[int]  # the tiled kernels' tile edge (None elsewhere, or with no tile)
    cache_tiles: int  # the tiled kernels' resident tiles of the storage type (0 elsewhere)
    storage: torch.dtype  # A's element type as the solve reads it
    fits: bool


def _check_knobs(config: SolverConfig, backend: str) -> None:
    """Every knob is honored by ``backend`` or rejected with a ValueError
    (the JAX package's contract); the knobs this port has not implemented
    name their ROADMAP item."""
    if config.dtype != torch.float32 and backend in _KERNEL_BACKENDS:
        raise ValueError(
            f"dtype={config.dtype} with backend={backend!r}: the kernels take float32 "
            f"matrices (or a 2-byte storage_dtype); backend='matvec' or 'auto' solves "
            f"in {config.dtype}"
        )
    if config.storage_dtype is not None and config.storage_dtype not in _STORAGE:
        raise ValueError(
            f"storage_dtype={config.storage_dtype!r}: the kernels read A as "
            f"torch.bfloat16, torch.float16 or torch.float32"
        )
    if config.storage_dtype is not None and backend in ("xla", "pallas"):
        raise ValueError(
            f"storage_dtype={config.storage_dtype} requires a matvec-family "
            f"backend (the iterated form rewrites A in float32 every round); "
            f"got backend={backend!r}"
        )
    if config.eps_mode != "absolute" and backend == "pallas":
        raise ValueError(
            "eps_mode='relative' is not supported by the iterated kernel "
            "backend ('pallas' keeps the absolute stop, as in the JAX package); "
            "use the matvec family or 'xla'"
        )
    if config.symmetric and backend != "multiround" and config.backend != "auto":
        raise ValueError(
            f"symmetric=True is implemented by the multiround backend only; "
            f"backend={config.backend!r} would silently stream the full matrix"
        )
    for knob in ("block_cols", "interpret"):
        if getattr(config, knob) is not None:
            raise ValueError(
                f"{knob}={getattr(config, knob)!r} is a TPU tile/interpret knob: "
                f"the Hopper kernels take square tiles or give a row to a warp, "
                f"and the device of the matrix picks kernel or plain version, so "
                f"it would be silently dropped"
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


def auto_cache_tiles(
    n: int, bt: Optional[int], device: torch.device, storage: torch.dtype = torch.float32,
    sym: bool = True,
) -> int:
    """The resident tiles an unset ``cache_tiles`` takes on the triangle
    kernel (``sym=False``: the dense tiled one, which no route sizes): the
    card's budget at (n, bt) in tiles of ``storage``; 0 with no tile."""
    return sym_auto_cache_tiles(n, bt, device, sym, storage.itemsize) if bt else 0


def route(config: SolverConfig, n: int, device: torch.device) -> Route:
    """The route of a dim-n solve under ``config`` on ``device``: its
    backend, bound solve, kernel, tile edge, resident cache and storage
    type, each decided here once.  Raises the ValueError of any knob the
    route cannot honor.

    "auto" on a CUDA device takes the multiround backend at every n whose
    state fits its kernel: the triangle kernel for a declared-symmetric,
    sym-tileable n, else the stripes kernel, whose ev copy must fit shared
    memory (the JAX package's 6144 boundary is a TPU VMEM-residency cliff
    with no counterpart here); the matvec kernel loop beyond.  On the CPU
    it takes the ``torch.mv`` loop, as JAX does off-TPU.  A ``dtype`` other
    than float32 takes the ``torch.mv`` loop everywhere: the kernels take
    float32 (or a 2-byte ``storage_dtype``) only.  An unset ``cache_tiles``
    on the triangle kernel is :func:`auto_cache_tiles`."""
    on_card = device.type == "cuda"
    tile = config.block_rows or kernels.SYM_TILE  # the tiled kernels' tile edge, as in JAX
    bt = kernels.sym_tile(n, tile)
    # whether the card holds the state of the tiled kernel that the config
    # asks for, and of the stripes kernel (asked only where a route needs it)
    tiled_fits = (config.symmetric or bool(config.cache_tiles)) and bt is not None and (
        not on_card or multiround_sym_fits(n, bt, device))
    stripes_fits = None
    backend = config.backend
    if backend == "auto":
        if not on_card or config.dtype != torch.float32:
            backend = "matvec"
        elif config.symmetric and tiled_fits:
            backend = "multiround"
        else:
            stripes_fits = multiround_fits(n, device)
            backend = "multiround" if stripes_fits else "matvec_pallas"
    _check_knobs(config, backend)
    storage = config.dtype if config.storage_dtype is None else config.storage_dtype
    kw = dict(eps=config.eps, max_itr=config.max_itr, eps_mode=config.eps_mode)
    stored = dict(storage_dtype=config.storage_dtype)
    tiled = {}
    if backend == "multiround":
        if config.symmetric and (config.backend != "auto" or tiled_fits):
            # the triangle kernel; block_rows is its tile edge, and an unset
            # cache_tiles takes the card's auto budget (0 streams)
            cache = config.cache_tiles
            if cache is None:
                cache = auto_cache_tiles(n, bt, device, storage)
            tiled = dict(symmetric=True, tile=tile, cache_tiles=cache)
        elif config.symmetric:
            # auto consumed the declaration, but the triangle kernel cannot
            # take this dim: the stripes kernel keeps the job, and has no cache
            if config.cache_tiles:
                raise _cache_unservable(
                    config.cache_tiles, n, tile,
                    "the cache-less stripes fallback would silently drop it",
                )
        elif config.cache_tiles:
            # an explicit dense cache: the tiled kernel over all g² tiles
            if bt is None:
                raise _cache_unservable(
                    config.cache_tiles, n, tile,
                    "the stripes kernel would silently run without the cache",
                )
            tiled = dict(tile=tile, cache_tiles=config.cache_tiles)
    if config.block_rows is not None and not tiled:
        raise ValueError(
            f"block_rows={config.block_rows} is the tiled kernel's tile edge "
            f"(symmetric=True or cache_tiles > 0 with the multiround backend); "
            f"backend {backend!r} here gives each row to one warp and takes no "
            f"tile shape, so it would be silently dropped"
        )
    if backend == "multiround":
        solve = partial(sm.solve_multiround, chunk=config.chunk, **tiled, **stored, **kw)
        if not tiled:
            if stripes_fits is None:
                stripes_fits = not on_card or multiround_fits(n, device)
            return Route(backend, solve, "stripes", None, 0, storage, stripes_fits)
        kernel = "triangle" if config.symmetric else "tiled"
        return Route(backend, solve, kernel, bt, tiled["cache_tiles"], storage, tiled_fits)
    if backend == "matvec_pallas":
        kernel, solve = "matvec", partial(sm.solve_matvec_kernel, **stored, **kw)
    elif backend == "pallas":
        kernel, solve = "iterated", partial(solve_kernel, eps=config.eps, max_itr=config.max_itr)
    elif backend == "xla":
        kernel, solve = None, partial(solve_xla, **kw)
    else:
        kernel, solve = None, partial(sm.solve_matvec, **stored, **kw)
    return Route(backend, solve, kernel, None, 0, storage, True)


def resolve_backend(config: SolverConfig, n: int, device: torch.device) -> str:
    """Resolve "auto" to a concrete backend for a dim-n solve on ``device``
    (:func:`route`'s rule)."""
    return route(config, n, device).backend


def _promotion(config: SolverConfig, n: int, device: torch.device) -> Optional[Route]:
    """The route that ``validate=True`` promotes an undeclared ``auto``
    solve to, if the matrix proves bitwise symmetric: the declared route,
    only where it takes the triangle kernel (on a card, at a sym-tileable n
    whose state fits), as at the JAX package's ``max_eigenvalue``."""
    if config.symmetric or config.backend != "auto" or device.type != "cuda":
        return None
    cand = route(dataclasses.replace(config, symmetric=True), n, device)
    return cand if cand.kernel == "triangle" else None


def _validate_on_device(mat: torch.Tensor, check_sym: bool) -> Tuple[bool, bool]:
    """Positivity and (when asked) bitwise symmetry, read back to the host
    in one copy."""
    checks = [torch.all(mat > 0)]
    if check_sym:
        checks.append(torch.all(mat == mat.T))
    flags = torch.stack(checks).tolist()
    return flags[0], check_sym and flags[-1]


def _as_matrix(mat, config: SolverConfig, device=None) -> torch.Tensor:
    """``mat`` as a contiguous square tensor on the solve's device
    (``device`` when given; else a tensor's own, and the CUDA card for host
    input, which raises when there is none), in ``config.dtype`` or, when
    it is already in ``config.storage_dtype``, as it is (a pre-quantized
    matrix gets no f32 copy; JAX ``api.py:533-539``).  A tensor whose
    address is not 16-byte aligned (a view such as ``buf[1:].view(n, n)``)
    is cloned: the kernels read rows in aligned chunks."""
    device = solve_device(device, mat)
    if not isinstance(mat, torch.Tensor):
        mat = torch.tensor(np.asarray(mat))  # a copy: host arrays may be read-only
    if mat.dim() != 2 or mat.shape[0] != mat.shape[1]:
        raise ValueError(f"must be a square matrix, got shape {tuple(mat.shape)}")
    prequantized = config.storage_dtype is not None and mat.dtype == config.storage_dtype
    mat = mat.to(device=device, dtype=mat.dtype if prequantized else config.dtype).contiguous()
    return mat.clone() if mat.data_ptr() % 16 else mat


def max_eigenvalue(
    mat,
    config: SolverConfig = DEFAULT_CONFIG,
    validate: bool = False,
    mesh=None,
    device=None,
) -> SolveResult:
    """Maximum eigenvalue and eigenvector of a positive square matrix.

    ``mat`` is cast to ``config.dtype`` (or, with ``storage_dtype``, solved
    as it is when already in that dtype) and never written.  A tensor is
    solved on its own device, host input (a numpy array, a list) on the
    CUDA card; ``device`` overrides both (``"cpu"`` asks for the CPU).
    ``validate=True`` checks positivity on the device, and bitwise symmetry
    when ``symmetric=True``
    is declared, and raises instead of returning garbage.  Under "auto" on
    a card it also checks symmetry where the triangle kernel could take the
    solve, and a matrix that passes is solved there (as the JAX package
    does on the TPU).

    ``mesh`` (a ``torch.distributed`` ``DeviceMesh`` with a ``"rows"``
    dimension, e.g. ``parallel.make_row_mesh``) runs the row-partitioned
    solve over its ranks instead of the single-card one; a mesh with both
    ``"rows"`` and ``"cols"`` runs the 2-D block-sharded solve
    (``parallel/sharded.py``).  ``backend`` maps to the sharded body of the
    same structure: "auto" and "matvec_pallas" the gathered body over the
    matvec kernel, "matvec" the gathered body over ``torch.mv`` in true f32,
    "xla" the iterated body; "pallas", "multiround" and ``symmetric=True``
    are single-card only and raise, as the JAX package's do.  ``mat`` is the
    whole matrix on every rank (each rank takes its rows or block) or a
    DTensor from ``parallel.multihost.assemble_*``; the eigenvector comes
    back as a DTensor sharded over rows.  The mesh places the solve, so
    ``device`` is rejected with it.
    """
    if mesh is not None:
        return _max_eigenvalue_mesh(mat, config, validate, mesh, device)
    with span("api.call"):
        with span("api.prepare"):
            mat = _as_matrix(mat, config, device)
            n = mat.shape[0]
            solve = route(config, n, mat.device).solve
            if validate:
                cand = _promotion(config, n, mat.device)
                pos, sym_ok = _validate_on_device(mat, config.symmetric or cand is not None)
                if not pos:
                    raise ValueError("similarity-transform method requires all entries > 0")
                if config.symmetric and not sym_ok:
                    raise ValueError(
                        "symmetric=True declared but the matrix is not bitwise symmetric"
                    )
                if cand is not None and sym_ok:
                    solve = cand.solve
        return solve(mat)


def _mesh_input(mat, config: SolverConfig, mesh, device):
    """A mesh solve's input: a DTensor as it is, anything else as a tensor;
    cast to ``config.dtype`` unless already in ``storage_dtype`` (no f32
    copy of a pre-quantized matrix)."""
    from torch.distributed.tensor import DTensor

    if device is not None:
        raise ValueError(
            "device= with mesh=: the mesh places the solve (each rank on its own "
            "device); drop device"
        )
    if not isinstance(mat, torch.Tensor):
        mat = torch.tensor(np.asarray(mat))  # a copy: host arrays may be read-only
    if not (config.storage_dtype is not None and mat.dtype == config.storage_dtype):
        mat = mat.to(config.dtype)
    return mat, isinstance(mat, DTensor)


def _all_positive(mat, is_dtensor: bool, mesh) -> bool:
    """``validate=True``'s positivity check on a mesh input: a whole matrix
    on every rank is checked where it is; a DTensor's local blocks are
    checked and the verdicts combined over every mesh dimension."""
    from .parallel._collectives import all_reduce_min
    from .parallel.sharded import _axes

    if not is_dtensor:
        return bool(torch.all(mat > 0))
    ok = torch.all(mat.to_local() > 0).to(torch.int32).reshape(1)
    for name in _axes(mesh):
        ok = all_reduce_min(ok, mesh.get_group(name))
    return bool(ok)


def _max_eigenvalue_mesh(mat, config: SolverConfig, validate: bool, mesh, device):
    """The mesh door of :func:`max_eigenvalue`, with the JAX package's
    rejections (``api.py`` of ``eigen_value_tpu``)."""
    from .parallel.sharded import _axes, solve_sharded, solve_sharded_2d, solve_sharded_matvec

    _reject_unsupported(
        config,
        "the mesh path",
        (
            ("block_rows", config.block_rows is None,
             "the sharded Pallas path sizes its own tiles per shard "
             "(parallel/sharded.py local_matvec)"),
            ("block_cols", config.block_cols is None,
             "the sharded Pallas path sizes its own tiles per shard "
             "(parallel/sharded.py local_matvec)"),
            ("chunk", config.chunk is None,
             "the multiround kernel is single-chip only"),
            ("cache_tiles", config.cache_tiles is None,
             "the VMEM-resident tile cache is a single-chip "
             "multiround feature (one chip's VMEM holds the tiles)"),
            ("interpret", config.interpret is None,
             "interpret auto-resolves from the mesh's platform (CPU "
             "meshes interpret, TPU meshes compile)"),
        ),
    )
    if config.symmetric:
        raise ValueError(
            "symmetric=True has no sharded form (the upper-triangle "
            "kernel is single-chip — its round state lives in one "
            "chip's VMEM scratch; the sharded solvers stream full row "
            "blocks); it would be silently dropped. Solve single-chip "
            "or drop the declaration."
        )
    is_2d = "cols" in _axes(mesh)
    if config.backend == "multiround":
        raise ValueError(
            "backend='multiround' is single-chip only (its round "
            "state lives in one chip's VMEM scratch); the mesh path "
            "would silently ignore it. Use backend='auto' for the "
            "sharded solvers, or solve single-chip."
        )
    if config.backend == "pallas":
        raise ValueError(
            "backend='pallas' (the iterated fused kernel) has no "
            "sharded form; use backend='auto' (matvec-form sharded "
            "solve) or 'xla' (iterated sharded solve)"
        )
    if is_2d and config.backend not in ("auto", "matvec"):
        raise ValueError(
            f"backend={config.backend!r} has no 2D block-sharded "
            "form (solve_sharded_2d runs the matvec-form XLA body); "
            "use backend='auto' or 'matvec'"
        )
    if config.storage_dtype is not None and config.storage_dtype not in _STORAGE:
        raise ValueError(
            f"storage_dtype={config.storage_dtype!r}: the kernels read A as "
            f"torch.bfloat16, torch.float16 or torch.float32"
        )
    mat, is_dtensor = _mesh_input(mat, config, mesh, device)
    if mat.dim() != 2 or mat.shape[0] != mat.shape[1]:
        raise ValueError(f"must be a square matrix, got shape {tuple(mat.shape)}")
    if validate and not _all_positive(mat, is_dtensor, mesh):
        raise ValueError("similarity-transform method requires all entries > 0")
    if is_2d:
        if "rows" not in _axes(mesh):
            raise ValueError(
                "a mesh with a 'cols' axis needs a 'rows' axis too "
                "(size 1 for pure column sharding) — got axes "
                f"{_axes(mesh)}; build it with "
                "parallel.make_mesh2d(1, pc)"
            )
        return solve_sharded_2d(mat, mesh, config=config)
    if config.backend == "xla":
        # the iterated (mutate-A) sharded body: the sharded "xla" rung
        if config.storage_dtype is not None:
            raise ValueError(
                "storage_dtype requires a matvec-family backend on the "
                "mesh path too (the iterated sharded body mutates A "
                "and cannot honor the storage contract)"
            )
        return solve_sharded(mat, mesh, config=config)
    return solve_sharded_matvec(mat, mesh, config=config,
                                use_pallas=config.backend != "matvec")


def _reject_unsupported(config: SolverConfig, entry: str, checks) -> None:
    """Raise on config knobs ``entry`` cannot honor (the honored-or-rejected
    contract).  ``checks`` is an iterable of ``(knob, is_default, why)``."""
    for knob, is_default, why in checks:
        if not is_default:
            raise ValueError(
                f"{knob}={getattr(config, knob)!r} is not supported by "
                f"{entry} — {why}; it would be silently dropped"
            )


def max_eigenvalue_batch(
    mats, config: SolverConfig = DEFAULT_CONFIG, mesh=None, device=None
) -> SolveResult:
    """Batched solves over ``mats`` of shape (B, n, n); the result's tensors
    carry a leading batch axis with per-matrix round counts (see
    ``parallel/batched.py`` for the masked loop).  The device rule is
    :func:`max_eigenvalue`'s: ``device`` when given, else a tensor's own,
    else the CUDA card.

    Honors eps / max_itr / dtype / eps_mode / storage_dtype.  A batch already
    in ``storage_dtype`` is solved as it is, with no f32 copy; any other is
    cast to ``config.dtype``.  The batched body is the power-form loop, so
    any other backend and the kernel knobs are rejected with the JAX
    package's words.

    ``mesh`` (a ``DeviceMesh``) mirrors :func:`max_eigenvalue`'s door: a
    ``"batch"`` dimension shards the batch (``solve_batched_sharded``); with
    a ``"rows"`` dimension too each matrix's rows are sharded as well
    (``solve_batched_rowsharded``, BASELINE config 4's layout).  The result
    is then DTensors sharded over the batch.
    """
    from .parallel.batched import solve_batched

    _reject_unsupported(
        config,
        "max_eigenvalue_batch",
        (
            ("backend", config.backend in ("auto", "matvec"),
             "the batched body is the vmapped matvec-form solver "
             "(parallel/batched.py); under vmap the hot op is a batched "
             "gemv and the Pallas/multiround kernels have no batched form"),
            ("block_rows", config.block_rows is None,
             "the batched body runs no Pallas kernel"),
            ("block_cols", config.block_cols is None,
             "the batched body runs no Pallas kernel"),
            ("chunk", config.chunk is None,
             "the multiround kernel has no batched form"),
            ("cache_tiles", config.cache_tiles is None,
             "the VMEM tile cache is a multiround feature; the batched "
             "body runs no Pallas kernel"),
            ("interpret", config.interpret is None,
             "the batched body runs no Pallas kernel"),
            ("symmetric", not config.symmetric,
             "the upper-triangle kernel has no batched form; the batched "
             "gemv streams full matrices"),
        ),
    )
    if mesh is not None:
        from .parallel.sharded import _axes

        mats, _ = _mesh_input(mats, config, mesh, device)
        if "batch" not in _axes(mesh):
            raise ValueError(
                f"a batched mesh needs a 'batch' axis — got axes "
                f"{_axes(mesh)}; build it with "
                "make_row_mesh(pb, 'batch') or make_mesh2d(pb, pr, 'batch', 'rows')"
            )
        if "rows" in _axes(mesh):
            from .parallel.sharded import solve_batched_rowsharded

            return solve_batched_rowsharded(mats, mesh, config=config)
        from .parallel.batched import solve_batched_sharded

        return solve_batched_sharded(mats, mesh, config=config)
    device = solve_device(device, mats)
    if not isinstance(mats, torch.Tensor):
        mats = torch.tensor(np.asarray(mats))  # a copy: host arrays may be read-only
    prequantized = config.storage_dtype is not None and mats.dtype == config.storage_dtype
    mats = mats.to(device=device, dtype=mats.dtype if prequantized else config.dtype)
    return solve_batched(
        mats.contiguous(),
        config.eps,
        config.max_itr,
        storage_dtype=config.storage_dtype,
        eps_mode=config.eps_mode,
    )


def max_eigenvalue_operator(
    matvec, n: int, config: SolverConfig = DEFAULT_CONFIG, device=None
) -> SolveResult:
    """Matrix-free solve: ``matvec(x) -> A @ x`` for an implicit positive
    operator that is never materialized (structured matrices with fast
    matvecs, operator sums, matrices too large to store).  See
    :func:`eigen_value_tpu_torch.ops.solver_matvec.solve_operator` for the
    semantics and the round-count caveat.  The solve's O(n) state lives on
    ``device``: the CUDA card unless ``"cpu"`` (or another device) is
    passed; ``matvec`` takes and returns vectors there.

    λ-scale limit of the default stop: the reference-exact ``eps_mode=
    "absolute"`` compares adjacent row sums against a raw eps = 1e-3 while
    the row sums converge to λ; f32 rounding noise scales with λ, so for
    operators with λ ≳ 10³ (Kronecker products of unnormalized factors:
    λ = λ_B·λ_C) the check may never fire and the solve exhausts
    ``max_itr``.  For those pass ``SolverConfig(eps_mode="relative")`` or
    pre-scale with :func:`~eigen_value_tpu_torch.ops.structured.scale_matvec`
    (λ scales by exactly α).

    Honors eps / max_itr / dtype / eps_mode; a matrix-free solve observes A
    only through ``matvec``, so the dense-backend knobs are rejected rather
    than silently dropped, with the JAX package's words.
    """
    _reject_unsupported(
        config,
        "max_eigenvalue_operator",
        (
            ("backend", config.backend in ("auto", "matvec"),
             "a matrix-free solve IS the matvec-form loop; dense backends "
             "don't apply"),
            ("storage_dtype", config.storage_dtype is None,
             "the operator is never materialized — reduced-precision "
             "storage belongs inside the caller's matvec"),
            ("block_rows", config.block_rows is None,
             "no Pallas kernel runs on the operator path"),
            ("block_cols", config.block_cols is None,
             "no Pallas kernel runs on the operator path"),
            ("chunk", config.chunk is None,
             "the multiround kernel needs a materialized matrix"),
            ("cache_tiles", config.cache_tiles is None,
             "the VMEM tile cache needs a materialized matrix"),
            ("interpret", config.interpret is None,
             "no Pallas kernel runs on the operator path"),
            ("symmetric", not config.symmetric,
             "a matrix-free solve observes A only through matvec — "
             "exploiting symmetry belongs inside the caller's matvec"),
        ),
    )
    return sm.solve_operator(
        matvec,
        n,
        config.eps,
        config.max_itr,
        dtype=config.dtype,
        eps_mode=config.eps_mode,
        device=device,
    )


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

    ``device`` pins solves to one device (None: a tensor's own, the CUDA
    card for host input; ``"cpu"`` asks for the CPU).  On a CUDA device
    ``ts_ms`` is the solve's time between two CUDA events on the current
    stream, read after a synchronise; on the CPU it is the wall time of the
    solve.  ``last_wall_ms`` is the host's wall time of the last solve
    (on a card up to the synchronise), None before the first.
    """

    def __init__(
        self, config: SolverConfig = DEFAULT_CONFIG, device: Optional[torch.device] = None
    ) -> None:
        self.config = config
        self.device = torch.device(device) if device is not None else None
        self.last_wall_ms: Optional[float] = None

    def warmup(self, dims, dtype=None) -> None:
        """Prepare the solves of these dims so that the first timed call
        does not pay for it (the JAX class compiles them here): on a card,
        build the kernel library (``ops/cuda/build.load``: nvcc, seconds)
        and the launch plans of the :func:`route` a solve takes at each
        dim, in the config's storage type.  Everywhere, resolve the
        routes and raise now on a config that a solve would reject.
        ``dtype`` is the matrices' dtype (JAX's argument; default
        ``config.dtype``): a matrix is cast by the config, or kept when it
        is already in ``storage_dtype``, so the routes and plans are the
        same for every floating dtype."""
        dtype = self.config.dtype if dtype is None else dtype
        if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
            raise ValueError(f"dtype must be a torch floating dtype, got {dtype!r}")
        # where host input goes: the card, or an error without one unless
        # device="cpu" was asked for (a solve's own rule)
        dev = solve_device(self.device)
        if dev.type == "cuda" and dev.index is None:  # the plans are kept per card
            dev = torch.device("cuda", torch.cuda.current_device())
        for n in dims:
            r = route(self.config, n, dev)
            if dev.type == "cuda" and r.kernel is not None:
                # a plan the card cannot hold is left to the launch, which raises
                kernels.prepare(dev, n, r.storage, kernel=r.kernel if r.fits else None,
                                bt=r.bt, cache_tiles=r.cache_tiles)

    def similarity_transform(self, mat) -> Tuple[np.float32, np.ndarray, float, int]:
        mat = _as_matrix(mat, self.config, self.device)
        t0 = time.perf_counter()
        if mat.is_cuda:
            with torch.cuda.device(mat.device):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                res = max_eigenvalue(mat, self.config)
                end.record()
                end.synchronize()
                ms = float(start.elapsed_time(end))
            self.last_wall_ms = (time.perf_counter() - t0) * 1e3
        else:
            res = max_eigenvalue(mat, self.config)
            ms = self.last_wall_ms = (time.perf_counter() - t0) * 1e3
        return (
            res.eigenvalue.cpu().numpy()[()],
            res.eigenvector.cpu().numpy(),
            ms,
            int(res.rounds),
        )
