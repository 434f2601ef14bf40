"""Wrappers of the Hopper kernels, each with its plain PyTorch version.

Counterparts of ``eigen_value_tpu.ops.pallas.kernels.matvec``,
``.multiround``, ``.multiround_sym``, ``.rowsum``, ``.scale``,
``.scale_rowsum``, ``.stop``, ``.round_matvec`` and ``.round_fused``, and of
the bench's ``_rowsum_bias_pallas``: same arguments and returns, except that
``scale`` and ``scale_rowsum`` take an ``out=`` (JAX arrays are immutable,
tensors are not: the caller says where A' goes, and its own matrix is never
written unless it names it), and that no kernel takes a tile shape or an
``interpret`` flag.  ``matvec_bound`` binds one ``matvec`` launch on kept
buffers for a loop to repeat.  ``round_glue`` has no JAX counterpart: it is
the O(n) glue of a matvec-loop round, which JAX's ``lax.while_loop`` leaves
to XLA, as one kernel (csrc/round_glue.cu).  A wrapper checks device,
dtype, shape and contiguity and raises on anything else.  For CPU tensors
it runs the plain version; for CUDA tensors it launches the kernel or
raises — there is no fallback.

Every tensor is float32, except the A of ``matvec``, ``multiround`` and
``multiround_sym``, which may also be bfloat16 or float16 (reduced-precision
storage).  Those three kernels read a 2-byte A as it is, convert each
element to f32 (exact) and multiply it with the f32 vector in the order of
the f32 kernel, so ``kernel(A_q)`` equals ``kernel(A_q.float())`` bit for
bit; ev, v, λ and every sum stay f32.  (JAX's ``solve_matvec_storage``
divides by a quantized vector instead; the port follows its kernels.)
``<wrapper>.launches`` counts kernel launches (a plain int; plain-version
calls do not count).  ``multiround_sym.plan`` keeps the :class:`SymPlan`
of the triangle kernel's last launch on the card (None before one), whose
``hbm_bytes`` the benchmark reads.  The whole body of each wrapper that a
route of ``api.max_eigenvalue`` calls (``matvec``, ``round_glue``,
``multiround``, ``multiround_sym``, ``rowsum``, ``scale_rowsum``), checks,
plan, buffers and launch or plain version, is the span ``launch.<wrapper>``
(``utils/profiling.py``).

``multiround_solve`` and ``multiround_sym_solve`` are a whole solve in one
launch of a persistent kernel, bound once per (device, current stream):
the binding keeps the plan, the library's entry with its fixed arguments,
the scratch and the constant inputs, and a call with the same key (n, A's
dtype, the kernel and its knobs, eps) and the same plan only checks A,
allocates what it returns and launches, under its wrapper's span and
launch count.  ``multiround.binds`` / ``multiround_sym.binds`` count the
bindings made; :func:`drop_bindings` frees them.

The two persistent kernels can report where a launch's time went: with
``STAMPS`` set to an int64 tensor on the card ((32 rounds x 6 phases + 2)
x the grid's blocks), every block writes the card's nanosecond timer at the
boundaries named in ``PHASES`` (csrc/prologue.cuh ``stamp``) and around the
triangle kernel's fill of its resident tiles (csrc/multiround_sym.cu
``fill_stamp``; ``kernel_phases.py`` reads them).  ``None``, the default, costs a launch
one branch.

The plain versions run anywhere.  ``matvec_plain`` is ``torch.mv``: a GEMV
in full float32 (cuBLAS gemv on the card, which has no TF32 mode; TF32
would put row-sum noise above the absolute 1e-3 stop once λ ≳ 1).  A
2-byte A is cast up to f32 in blocks of rows (or tiles) of at most
``PLAIN_BLOCK_BYTES``, so the plain versions never hold an f32 copy of it.

The two persistent kernels take ``formulation="dot"`` as the JAX kernels
do: their products on the tensor cores in 3xTF32 (csrc/mma_tf32.cuh; each
f32 value split into a TF32 big part and a TF32 small part, the
small·small term dropped), never plain TF32.  Its plain version is
:func:`matvec_tf32_plain`, the same three products in f32 (TF32 off), over
:func:`tf32_split`, which gives the bits of the card's ``cvt.rna``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from ...device import (
    cuda_limits,
    multiround_fits,
    multiround_plan,
    multiround_sym_fits,
    sym_auto_cache_tiles,
    sym_ring,
    sym_l2_tiles,
    sym_smem_bytes,
    sym_split,
    tensor_device,
)
from ...utils.profiling import spanned
from ..solver import _finished, stop_check


#: The element types a kernel's A may have, and their codes in the C
#: entries (csrc/rowdot.cuh ``with_elem``).
_ELEM = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: Bytes of the f32 copy of a 2-byte A that a plain version makes at once.
PLAIN_BLOCK_BYTES = 64 << 20


def _check_f32(name: str, t: torch.Tensor, shape: tuple, dtypes=(torch.float32,)) -> None:
    if t.dtype not in dtypes:
        want = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise ValueError(f"{name} must be {want}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_stored(name: str, A: torch.Tensor, shape: tuple) -> None:
    """The checks of a kernel's A: float32, or bfloat16 / float16 storage."""
    _check_f32(name, A, shape, tuple(_ELEM))


def _square(A: torch.Tensor) -> int:
    if A.dim() != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"A must be square, got shape {tuple(A.shape)}")
    return A.shape[0]


def _check_aligned(cols: int, *tensors: torch.Tensor) -> None:
    # with cols % 4 == 0 a row is read in chunks of four elements: 16 bytes
    # of f32, 8 of bf16 / f16, each aligned to its size
    if cols % 4 == 0 and any(t.data_ptr() % (4 * t.element_size()) for t in tensors):
        raise ValueError("the chunked kernels need tensors aligned to 4 elements")


def _check_ring_aligned(ring: int, A: torch.Tensor) -> None:
    # a bulk copy moves 16-byte units between 16-byte aligned addresses
    if ring and A.data_ptr() % 16:
        raise ValueError(
            "A must be 16-byte aligned: the plan streams it through bulk copies "
            "(api.max_eigenvalue clones a misaligned matrix)"
        )


def _sized(dtype: torch.dtype, name: str = "dtype") -> dict:
    """The keyword that names A's storage in a plan call: none for float32,
    whose plans keep their two-argument form (kernel_phases.py patches
    them with it)."""
    if dtype == torch.float32:
        return {}
    return {name: dtype if name == "dtype" else dtype.itemsize}


def _formulated(formulation: str) -> dict:
    """The keyword that asks a plan call for the dot or the mixed instance:
    none for "vpu", so that a launch looks its plan up under the key that
    :func:`prepare` cached it under."""
    return {formulation: True} if formulation in ("dot", "mixed") else {}


#: The triangle kernel's formulations and their codes in the C entry
#: (csrc/multiround_sym.cu ``instance``).
_FORMS = {"vpu": 0, "dot": 1, "mixed": 2}


#: Phase stamps of the persistent kernels: None, or the tensor they write.
STAMPS: Optional[torch.Tensor] = None
#: The phases between a round's stamps, in order.
PHASES = {
    "multiround": ("prologue", "stream", "barrier"),
    "multiround_sym": ("prologue", "stream", "barrier_1", "reduce", "barrier_2"),
}


def _stamps_ptr() -> Optional[int]:
    return None if STAMPS is None else STAMPS.data_ptr()


def _launch(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed with cudaError {rc}")


def _up(A: torch.Tensor) -> torch.Tensor:
    """A 2-byte A's values in float32 (exact); any other A as it is."""
    return A.float() if A.element_size() < 4 else A


def matvec_plain(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` in float32 with PyTorch's GEMV.  Its sums run in cuBLAS's
    order, not the kernel's: on an H100 the Hilbert 65536² row sums come
    out ~3e-5 relative off a float64 product, the kernel's ~2e-7.  A 2-byte
    A is cast up ``PLAIN_BLOCK_BYTES`` of f32 rows at a time (one block, the
    call on ``A.float()``, when it fits)."""
    rows = max(1, PLAIN_BLOCK_BYTES // (4 * max(1, A.shape[1])))
    if A.element_size() >= 4 or A.shape[0] <= rows:
        return torch.mv(_up(A), x)
    return torch.cat([torch.mv(_up(A[r:r + rows]), x) for r in range(0, A.shape[0], rows)])


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to
    10 fraction bits, to nearest, ties away from zero; the low 13 bits are
    0.  On the f32 bits: add half of the last kept bit to the magnitude,
    then clear the 13 low bits (the sign bit is untouched below the
    largest finite values; infinities stay, a NaN stays a NaN)."""
    bits = x.contiguous().view(torch.int32)
    out = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isnan(x), x, out)


def tf32_split(x: torch.Tensor):
    """``(big, small)`` with ``big = rna(x)`` and ``small = rna(x - big)``
    (``x - big`` is exact): the two TF32 parts the dot formulation's kernels
    multiply.  A bf16 or f16 value is exact in TF32, so its small part is
    0."""
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def _mv3(a_big, a_small, e_big, e_small, mv) -> torch.Tensor:
    # the kernel's three products: a_big·e_small + a_small·e_big, then + a_big·e_big
    return (mv(a_big, e_small) + mv(a_small, e_big)) + mv(a_big, e_big)


def matvec_tf32_plain(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` in 3xTF32, the dot formulation's product: A and x split by
    :func:`tf32_split`, then ``A_big·x_small + A_small·x_big + A_big·x_big``
    by f32 GEMVs (TF32 off; the small·small term, 2^-22 relative, is
    dropped).  The sums run in PyTorch's order, not the tensor cores', so
    this is the kernel's function and not its bits.  A is split
    ``PLAIN_BLOCK_BYTES`` of f32 rows at a time, the same blocks for every
    dtype, so a 2-byte A gives the bits of ``A.float()``."""
    xb, xs = tf32_split(x)
    rows = max(1, PLAIN_BLOCK_BYTES // (4 * max(1, A.shape[1])))
    out = []
    for r in range(0, A.shape[0], rows):
        ab, a_s = tf32_split(_up(A[r:r + rows]))
        out.append(_mv3(ab, a_s, xb, xs, torch.mv))
    return torch.cat(out)


def _entry(dev: torch.device, name: str) -> tuple:
    """The library's entry ``name`` and the stream that is ``dev``'s
    current one now."""
    from . import build

    with torch.cuda.device(dev):
        entry = getattr(build.load(), name)
    return entry, _stream(dev)


def _stream(dev: torch.device) -> int:
    """The raw handle of ``dev``'s current stream (torch.cuda.current_stream
    builds a Stream object: 6.4 µs a call on an H100's host, against 0.4)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _call(dev: torch.device, entry, args: tuple, what: str) -> None:
    """``entry(*args)`` with ``dev`` the current device, entered only when
    it is not."""
    if torch.cuda.current_device() == dev.index:
        rc = entry(*args)
    else:
        with torch.cuda.device(dev):
            rc = entry(*args)
    _launch(rc, what)


def _leading_dim(A: torch.Tensor) -> int:
    """The distance in elements between the rows of a 2-D A whose rows are
    contiguous (``stride(1) == 1``): ``A.stride(0)``, at least the row
    length.  Raises on any other layout."""
    if A.dtype not in _ELEM:
        raise ValueError(f"A must be float32 or bfloat16 or float16, got {A.dtype}")
    n, m = A.shape
    if m > 1 and A.stride(1) != 1:
        raise ValueError(f"A's rows must be contiguous (stride(1) == 1), got strides {A.stride()}")
    ld = A.stride(0) if n > 1 else m
    if ld < m:
        raise ValueError(f"A's rows overlap: stride(0) = {ld} < {m} columns")
    return ld


def _matvec_checks(A: torch.Tensor, x: torch.Tensor, out: Optional[torch.Tensor] = None) -> tuple:
    """:func:`matvec`'s checks, and :func:`matvec_bound`'s with its
    ``out``; ``(n, m, ld, device)``."""
    if A.dim() != 2:
        raise ValueError(f"A must be 2-D, got shape {tuple(A.shape)}")
    n, m = A.shape
    ld = _leading_dim(A)
    _check_f32("x", x, (m,))
    if out is None:
        dev = tensor_device(A, x)
    else:
        _check_f32("out", out, (n,))
        dev = tensor_device(A, x, out)
        if _overlap(out, x):
            raise ValueError("out must not overlap x")
    if dev.type == "cuda":
        _check_aligned(m, A, x)
        if m % 4 == 0 and ld % 4:
            raise ValueError(f"A's rows are {ld} elements apart: the chunked kernel needs a "
                             f"multiple of 4")
    return n, m, ld, dev


def _matvec_launcher(A: torch.Tensor, x: torch.Tensor, y: torch.Tensor, n: int, m: int,
                     ld: int, dev: torch.device):
    """A function that launches ``y = A @ x`` on the stream that is ``dev``'s
    current one now, counts it in ``matvec.launches`` and returns y: the one
    launch body of :func:`matvec` and :func:`matvec_bound`.  The library's
    entry and every argument are bound here, so a call only launches."""
    entry, stream = _entry(dev, "evt_matvec")
    args = (A.data_ptr(), x.data_ptr(), y.data_ptr(), n, m, ld, _ELEM[A.dtype], stream)

    def run() -> torch.Tensor:
        _call(dev, entry, args, "matvec")
        matvec.launches += 1
        return y

    return run


@spanned("launch.matvec")
def matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` for A (n, m) float32, bfloat16 or float16 and x (m,)
    float32; the result is float32.  A may be a view whose rows are
    contiguous and ``ld = A.stride(0)`` elements apart (a column block of a
    larger matrix, as the sharded solves multiply): the kernel reads row r
    at ``A + r·ld`` and gives the bits of ``A.contiguous()``.  With m % 4
    == 0 the base address and ld must keep every row aligned to four
    elements (16 bytes of f32, 8 of bf16 / f16): the kernel reads rows in
    chunks of four."""
    n, m, ld, dev = _matvec_checks(A, x)
    if dev.type == "cpu":
        return matvec_plain(A, x)
    y = torch.empty(n, dtype=torch.float32, device=dev)
    return _matvec_launcher(A, x, y, n, m, ld, dev)()


matvec.launches = 0


def matvec_bound(A: torch.Tensor, x: torch.Tensor, out: torch.Tensor):
    """``out = A @ x`` as :func:`matvec` computes it, bound once for a loop
    that reruns one product on buffers it keeps (``out`` (n,) float32, not
    overlapping x): the checks, the library's entry and the current stream
    are taken here, and each call of the returned function launches the
    kernel on that stream, reading x as it is then, and returns ``out`` (the
    span ``launch.matvec`` and the count are :func:`matvec`'s).  The loop
    must leave the current device as it was here.  On the CPU each call runs
    the plain version into ``out``."""
    n, m, ld, dev = _matvec_checks(A, x, out)
    if dev.type == "cpu":
        def run():
            return out.copy_(matvec_plain(A, x))
    else:
        run = _matvec_launcher(A, x, out, n, m, ld, dev)
    return spanned("launch.matvec")(run)


def _as_scalar(lam, dev: torch.device) -> torch.Tensor:
    lam = torch.as_tensor(lam, dtype=torch.float32, device=dev)
    if lam.numel() != 1:
        raise ValueError(f"lam must be a scalar, got shape {tuple(lam.shape)}")
    return lam.reshape(())


def _rounds_plain(matvec, ev, v, lam, budget, chunk, eps, init, eps_mode, finish):
    """Up to ``chunk`` rounds over ``matvec(ev) -> A @ ev``: the round
    structure of both multiround kernels, and their outputs
    (csrc/prologue.cuh ``write_finish``), shared by their plain versions."""
    lam = _as_scalar(lam, ev.device)
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
        raw = matvec(ev)
    if not frozen:
        v = raw / ev
    dev = ev.device
    carry = (ev, v, torch.tensor(adv, dtype=torch.int32, device=dev), lam)
    if finish is None:
        return carry
    converged = frozen and adv < budget
    ev, lam = _finished(ev, v, lam, converged)
    return (ev, v, carry[2], lam, torch.tensor(finish + adv, dtype=torch.int32, device=dev),
            torch.tensor(converged, device=dev))


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
    formulation: str = "vpu",
    finish: Optional[int] = None,
):
    """Up to ``chunk`` matvec-form rounds, round for round what the kernel
    does.  Each round checks the stop BEFORE advancing and the solve freezes
    at the round that stops (or that reaches ``budget`` advanced rounds).
    ``init=True`` makes round 0 the row-sum pass (no check, not counted; v
    is then ignored).  ``formulation="dot"`` multiplies in 3xTF32
    (:func:`matvec_tf32_plain`).  Returns ``(ev, v, advanced, λ)``, the
    carry; with ``finish`` (the solve's rounds before this call) also the
    solve's result, as :func:`multiround` returns it."""
    _check_formulation(formulation, A.shape[0])
    mv = matvec_tf32_plain if formulation == "dot" else matvec_plain
    return _rounds_plain(
        lambda e: mv(A, e), ev, v, lam, budget, chunk, eps, init, eps_mode, finish
    )


def _check_formulation(formulation: str, n: int) -> None:
    """The stripes kernel's formulations, as the JAX kernel's: "vpu", and
    "dot", whose row stripes need a divisor of n that is a multiple of 128
    (every stripe a whole number of the unit's 128-column lanes)."""
    if formulation not in ("vpu", "dot"):
        raise ValueError(f"unknown formulation {formulation!r} (the stripes kernel has "
                         f"'vpu' and 'dot')")
    if formulation == "dot" and n % 128:
        raise ValueError(f"dim {n} admits no dot-aligned row stripe (need a divisor that is a "
                         f"multiple of 128)")


@functools.lru_cache(maxsize=None)
def multiround_launch_plan(
    device: torch.device, n: int, dtype: torch.dtype = torch.float32, dot: bool = False
):
    """:func:`device.multiround_plan` at dimension ``n`` for A stored in
    ``dtype``, checked once against what the card will run side by side (a
    cooperative launch needs every block resident).  ``dot``: the dot
    formulation's instance, which has no ring."""
    from . import build

    plan = multiround_plan(n, device, dtype.itemsize, ring=not dot)
    with torch.cuda.device(device):
        cap = build.load().evt_multiround_blocks(n, plan.resident, plan.ring, _ELEM[dtype],
                                                 int(dot))
    if cap < 0:
        raise RuntimeError(f"multiround occupancy query failed with cudaError {-cap}")
    if cap < plan.grid:
        raise RuntimeError(
            f"n={n}: the card runs {cap} blocks of the multiround kernel side by side "
            f"with {plan.resident} resident rows and {plan.ring} ring stages a warp each, "
            f"the plan needs {plan.grid}"
        )
    return plan


def multiround_grid(device: torch.device, n: int) -> int:
    """Blocks of the multiround kernel at dimension ``n`` on ``device``
    (the cooperative launch's grid)."""
    return multiround_launch_plan(device, n).grid


def _solved(finish: Optional[int], dev: torch.device) -> tuple:
    """The 0-d rounds (int32) and converged (bool) that a launch asked for
    its solve's result (``finish`` not None) writes; none otherwise."""
    if finish is None:
        return ()
    return (torch.empty((), dtype=torch.int32, device=dev),
            torch.empty((), dtype=torch.bool, device=dev))


def _carry_out(n: int, dev: torch.device) -> tuple:
    """Fresh outputs of a launch's carry: ev, v, advanced (int32) and λ."""
    return (torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty((), dtype=torch.int32, device=dev),
            torch.empty((), dtype=torch.float32, device=dev))


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_chunk(chunk: int) -> None:
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")


def _operands(A, ev, v, n: int) -> None:
    """The persistent kernels' checks of A (n, n), ev and v, in their
    order."""
    _check_stored("A", A, (n, n))
    _check_f32("ev", ev, (n,))
    _check_f32("v", v, (n,))


def _stripes_checks(A, ev, v, chunk, eps_mode, formulation) -> tuple:
    """The stripes wrapper's checks of its operands and knobs, in its
    order; ``(n, device)``."""
    n = _square(A)
    if n == 0:
        raise ValueError("A must be non-empty")
    _check_chunk(chunk)
    if eps_mode not in ("absolute", "relative"):
        raise ValueError(f"unknown eps_mode {eps_mode!r}")
    _check_formulation(formulation, n)
    _operands(A, ev, v, n)
    return n, tensor_device(A, ev, v)


def _stripes_plan(dev: torch.device, n: int, dtype: torch.dtype, formulation: str):
    return multiround_launch_plan(dev, n, **_sized(dtype), **_formulated(formulation))


def _stripes_card(A, v, n: int, dev: torch.device, formulation: str) -> tuple:
    """The card's checks of a stripes launch, its plan and its scratch:
    ``(plan, raw)``."""
    _check_aligned(n, A, v)
    if not multiround_fits(n, dev):
        raise ValueError(
            f"n={n}: the multiround kernel keeps ev ({4 * n} bytes) in one "
            f"block's shared memory, more than this card allows; use "
            f"backend='matvec_pallas'"
        )
    plan = _stripes_plan(dev, n, A.dtype, formulation)
    _check_ring_aligned(plan.ring, A)
    return plan, torch.empty(2 * n, dtype=torch.float32, device=dev)


def _stripes_launcher(dev, plan, n: int, dtype: torch.dtype, eps, eps_mode: str,
                      formulation: str, raw):
    """A function that launches the stripes kernel under ``plan`` on the
    stream that is ``dev``'s current one now, over ``raw`` (which the
    caller keeps alive), and counts it in ``multiround.launches``: the one
    launch body of :func:`multiround` and of the bound solve
    :func:`multiround_solve`.  A call passes what may change between
    launches: A, the inputs, the budget, the chunk, ``init``, the outputs
    (rounds and converged None where the result is not asked for) and the
    rounds before the launch."""
    entry, stream = _entry(dev, "evt_multiround")
    dot = formulation == "dot"
    scratch = (raw.data_ptr(), n)
    knobs = (int(eps_mode == "relative"), plan.resident, plan.l2_rows, plan.ring, int(dot))
    elem = _ELEM[dtype]

    def run(A, ev, v, lam, budget, chunk, init, ev_out, v_out, adv, lam_out,
            rounds_out=None, converged_out=None, rounds0=0):
        # the dot formulation's segment sums, kDotSegments (8) floats a row,
        # and its rounds' work counters, which must read 0 at the launch: the
        # kernel leaves its last rounds' counts there, and a zeroing of kept
        # counters would be a step apart from the launch, which two threads
        # on one stream could interleave; so both are the launch's own
        part = torch.empty(8 * n, dtype=torch.float32, device=dev) if dot else None
        work = torch.zeros(2, dtype=torch.int32, device=dev) if dot else None
        _call(dev, entry, (
            A.data_ptr(), ev.data_ptr(), v.data_ptr(), lam.data_ptr(), min(budget, 2**31 - 1),
            ev_out.data_ptr(), v_out.data_ptr(), adv.data_ptr(), lam_out.data_ptr(),
            _ptr(rounds_out), _ptr(converged_out), rounds0, *scratch, min(chunk, 2**31 - 1),
            eps, int(init), *knobs, _ptr(part), _ptr(work), _stamps_ptr(), elem, plan.grid,
            stream,
        ), "multiround")
        multiround.launches += 1

    return run


@spanned("launch.multiround")
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
    formulation: str = "vpu",
    finish: Optional[int] = None,
):
    """Up to ``chunk`` matvec-form rounds in one launch of the persistent
    kernel; semantics of :func:`multiround_plain`.  A is float32, bfloat16
    or float16 (read as stored, every product and sum in f32); ev and v
    are float32.  ``formulation="dot"`` (n % 128 == 0) takes the row sums
    on the tensor cores in 3xTF32: bit-identical across chunkings and
    between A_q and A_q.float(), within rounding of "vpu".  Returns ``(ev,
    v, advanced, λ)`` with ``advanced`` an int32 tensor: the carry, from
    which a launch resumes.

    ``finish``, the solve's rounds before this launch, asks for the solve's
    result as well: ``(ev, v, advanced, λ, rounds, converged)``, rounds an
    int32 and converged a bool, 0-d on the card.  rounds is ``finish +
    advanced``, and converged whether the launch halted at the stop with
    budget left (``solver._finish``'s rule).  A converged launch returns the
    solve's eigenvector and λ in place of the carry's (the converging
    round's update, ``solver._finished``, bit for bit); any other returns
    the carry, which the next launch resumes from where the solve goes
    on."""
    n, dev = _stripes_checks(A, ev, v, chunk, eps_mode, formulation)
    lam = _as_scalar(lam, dev)
    budget = int(budget)
    if dev.type == "cpu":
        return multiround_plain(
            A, ev, v, lam, budget, chunk=chunk, eps=eps, init=init, eps_mode=eps_mode,
            formulation=formulation, finish=finish,
        )
    plan, raw = _stripes_card(A, v, n, dev, formulation)
    out = _carry_out(n, dev)
    solved = _solved(finish, dev)
    _stripes_launcher(dev, plan, n, A.dtype, eps, eps_mode, formulation, raw)(
        A, ev, v, lam, budget, chunk, init, *out, *solved, rounds0=finish or 0)
    return out + solved


multiround.launches = 0
multiround.binds = 0


#: The triangle kernel's default tile edge on Hopper.  The JAX default (512)
#: was measured on a v5e, whose VMEM holds megabytes; a 512-edge f32 tile is
#: 1 MiB, more than one block's 227 KB of shared memory.  128 divides every
#: sym-tileable n, lets a 64 KiB tile sit resident beside the block's state,
#: and costs 0.8% extra traffic at 8192² (the diagonal tiles' lower halves).
#: An explicit ``tile`` (``block_rows`` in the config) wins.
SYM_TILE = 128


def sym_tile(n: int, tile: int = SYM_TILE) -> Optional[int]:
    """Largest square tile edge ≤ ``tile`` that divides ``n`` and is a
    multiple of 128 (the rule of the JAX package's ``sym_tile``); None if
    the dim admits none."""
    top = min(tile, n) // 128 * 128
    return next((b for b in range(top, 127, -128) if n % b == 0), None)


def sym_cache_split(n: int, bt: int, cache_tiles: int):
    """Partition the upper-triangle tile grid into (streamed, cached), as
    the JAX package's ``sym_cache_split``: up to ``cache_tiles`` strictly
    off-diagonal tiles, those furthest from the diagonal first, are
    cached; a negative count caches nothing.  Tuples of (i, j)."""
    g = n // bt
    offdiag = sorted(
        ((i, j) for i in range(g) for j in range(i + 1, g)), key=lambda ij: ij[0] - ij[1]
    )
    c = max(0, min(cache_tiles, len(offdiag)))
    streamed = tuple(sorted([(i, i) for i in range(g)] + offdiag[c:]))
    return streamed, tuple(offdiag[:c])


@functools.lru_cache(maxsize=None)
def _tile_split(n: int, bt: int, cache_tiles: int, sym: bool):
    """(streamed, cached) tiles of the kernel: the triangle split, or in
    dense tiled mode all g² tiles with up to g² − 1 cached, furthest from
    the diagonal first (the JAX kernel's rule)."""
    if sym:
        return sym_cache_split(n, bt, cache_tiles)
    g = n // bt
    all_tiles = [(i, j) for i in range(g) for j in range(g)]
    c = max(0, min(cache_tiles, len(all_tiles) - 1))
    cached = tuple(sorted(all_tiles, key=lambda ij: -abs(ij[0] - ij[1]))[:c])
    cset = set(cached)
    return tuple(t for t in all_tiles if t not in cset), cached


@functools.lru_cache(maxsize=None)
def _tile_index(device: torch.device, n: int, bt: int, sym: bool):
    """Row and column block of every tile the plain version reads, and
    which of them give a transpose term, as index tensors (built once)."""
    streamed, _ = _tile_split(n, bt, 0, sym)
    ti = torch.tensor([i for i, _ in streamed], device=device)
    tj = torch.tensor([j for _, j in streamed], device=device)
    off = (ti != tj) if sym else torch.zeros_like(ti, dtype=torch.bool)
    return ti, tj, off


def _tile_products(tiles: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """``tiles[k] @ vecs[k]`` for every k in 3xTF32 (batched f32 GEMVs)."""
    tb, ts = tf32_split(tiles)
    eb, es = tf32_split(vecs)
    return _mv3(tb, ts, eb, es, lambda a, e: torch.bmm(a, e.unsqueeze(-1)).squeeze(-1))


#: The TPU kernel's measured cost of a tile term on its matrix unit against
#: one on its vector unit (a v5e; eigen_value_tpu/ops/pallas/kernels.py:54).
#: It sets the default share of the "mixed" formulation, so that the port
#: and the JAX package put the same resident tiles on the matrix unit; it is
#: not a measurement of the H100's tensor cores and is not tuned for them.
MXU_TERM_COST = 3.5


@functools.lru_cache(maxsize=None)
def mxu_share(n: int, bt: int, cache_tiles: int, sym: bool, mxu_tiles: Optional[int] = None) -> int:
    """Resident tiles of the "mixed" formulation on the tensor cores: the
    last m of the split's C cached tiles (:func:`_tile_split`), with m =
    ``mxu_tiles`` or, for None, the JAX rule's unit-balance point
    ``round(total / (1 + MXU_TERM_COST) / per_cached)``, where ``total``
    counts the tile terms of a round (a streamed diagonal tile 1, any other
    tile 2, every tile 1 in dense mode) and ``per_cached`` is 2 (1 dense);
    clamped to [0, C].  455 of the 396 f32 (so all 396) or 528 bf16 tiles
    of the auto caches at 8192², bt = 128."""
    streamed, cached = _tile_split(n, bt, cache_tiles, sym)
    C = len(cached)
    if mxu_tiles is None:
        per_cached = 2 if sym else 1
        t_stream = sum(1 if i == j else 2 for i, j in streamed) if sym else len(streamed)
        mxu_tiles = round((t_stream + per_cached * C) / (1.0 + MXU_TERM_COST) / per_cached)
    return max(0, min(mxu_tiles, C))


@functools.lru_cache(maxsize=None)
def _mxu_mask(device: torch.device, n: int, bt: int, sym: bool, cache_tiles: int, m: int):
    """Which of :func:`_tile_index`'s tiles a "mixed" solve takes in the dot
    form: the last ``m`` cached ones; None when there are none."""
    if not m:
        return None
    on = set(_tile_split(n, bt, cache_tiles, sym)[1][-m:])
    return torch.tensor([t in on for t in _tile_split(n, bt, 0, sym)[0]], device=device)


def tiled_matvec_plain(
    A: torch.Tensor, ev: torch.Tensor, bt: int, sym: bool, formulation: str = "vpu",
    mxu: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``A @ ev`` over square bt-edge tiles, reading only the upper block
    triangle when ``sym``: each tile's row term ``T @ ev[j_blk]`` and, off
    the diagonal, its transpose term ``ev[i_blk] @ T`` land in the slot of
    their (row block, column block), and the slots are summed over column
    blocks.  Batched f32 products (no TF32), over at most
    ``PLAIN_BLOCK_BYTES`` of f32 tiles at a time (a 2-byte A is cast up
    there); ``formulation="dot"`` takes each term in 3xTF32 (``T^T @
    ev[i_blk]`` for the transpose term), and ``mxu`` (a bool per tile of
    the plain version's order, :func:`_mxu_mask`) the terms of those tiles
    alone: the "mixed" formulation."""
    n = A.shape[0]
    g = n // bt
    ti, tj, off = _tile_index(A.device, n, bt, sym)
    blocks = A.view(g, bt, g, bt)
    evb = ev.view(g, bt)
    part = ev.new_zeros(g, g, bt)
    step = max(1, PLAIN_BLOCK_BYTES // (4 * bt * bt))
    for s in range(0, len(ti), step):
        i, j, o = ti[s:s + step], tj[s:s + step], off[s:s + step]
        tiles = _up(blocks[i, :, j, :])  # (tiles, bt, bt): only these are read
        if formulation == "dot":
            part[i, j] = _tile_products(tiles, evb[j])
            if sym:
                part[j[o], i[o]] = _tile_products(tiles[o].transpose(1, 2), evb[i[o]])
            continue
        part[i, j] = torch.bmm(tiles, evb[j].unsqueeze(-1)).squeeze(-1)
        if sym:
            part[j[o], i[o]] = torch.bmm(evb[i[o]].unsqueeze(1), tiles[o]).squeeze(1)
        d = None if mxu is None else mxu[s:s + step]
        if d is not None and bool(d.any()):  # their slots again, in 3xTF32
            i, j, o, tiles = i[d], j[d], o[d], tiles[d]
            part[i, j] = _tile_products(tiles, evb[j])
            if sym:
                part[j[o], i[o]] = _tile_products(tiles[o].transpose(1, 2), evb[i[o]])
    return part.sum(dim=1).reshape(n)


def _check_tiled_knobs(
    n: int, bt: int, cache_tiles: int, sym: bool, formulation: str, mxu_tiles, fill_mode: str
) -> int:
    """The JAX kernel's rules for ``mxu_tiles`` and ``fill_mode``, with its
    conditions and in its order (eigen_value_tpu/ops/pallas/kernels.py
    ``multiround_sym``), so that both packages accept the same calls.
    Returns the "mixed" share m (:func:`mxu_share`; 0 otherwise)."""
    mixed = formulation == "mixed"
    C = len(_tile_split(n, bt, cache_tiles, sym)[1])
    if mxu_tiles is not None and not mixed:
        raise ValueError("mxu_tiles is only meaningful with formulation='mixed'")
    if mixed and not C:
        raise ValueError(
            "formulation='mixed' needs cache_tiles > 0 (the tensor-core share is carved "
            "out of the resident tiles)"
        )
    if fill_mode not in ("prologue", "pipelined"):
        raise ValueError(f"unknown fill_mode {fill_mode!r}")
    if fill_mode == "pipelined" and not C:
        raise ValueError(
            "fill_mode='pipelined' schedules the cache fill; it needs cache_tiles > 0"
        )
    m = mxu_share(n, bt, cache_tiles, sym, mxu_tiles) if mixed else 0
    depth = pipelined_depth(n, bt, cache_tiles, sym, m) if fill_mode == "pipelined" else 0
    if depth > PIPELINED_DEPTH:
        raise ValueError(
            f"fill_mode='pipelined' would keep up to {depth} fill DMAs in flight "
            f"(2 steps x {depth // 2} slots) — over the {PIPELINED_DEPTH}-deep queue budget; "
            f"use the prologue fill or cache fewer tiles relative to the streamed count"
        )
    return m


#: The most fill copies the JAX kernel's pipelined fill may keep in flight:
#: its TPU's DMA queue, kept as the API's limit so that both packages
#: accept the same calls (the port issues all of a block's copies at once).
PIPELINED_DEPTH = 8


def pipelined_depth(n: int, bt: int, cache_tiles: int, sym: bool, m: int = 0) -> int:
    """The fill copies that the JAX kernel's ``fill_mode="pipelined"``
    keeps in flight: it issues the tiles of its step t + 1 at step t, each
    of its T streamed steps taking ceil(share / T) slots of each share (the
    C − m "vpu" tiles and the m "mixed" ones), so two steps' slots.  At most
    :data:`PIPELINED_DEPTH`; at 2048², bt 128, every one of the 120
    resident tiles gives 16, and 108 the most that passes."""
    streamed, cached = _tile_split(n, bt, cache_tiles, sym)
    T, C = len(streamed), len(cached)
    return 2 * (-(-(C - m) // T) + -(-m // T))


def _check_tiled(A, ev, v, chunk, eps_mode, tile) -> int:
    """Shape/dtype checks of the tiled kernel; returns its tile edge."""
    n = _square(A)
    _check_chunk(chunk)
    if eps_mode not in ("absolute", "relative"):
        raise ValueError(f"unknown eps_mode {eps_mode!r}")
    _operands(A, ev, v, n)
    bt = sym_tile(n, tile)
    if bt is None:
        raise ValueError(
            f"dim {n} admits no 128-aligned square tile for the symmetric "
            f"kernel (need a divisor of n that is a multiple of 128, at most "
            f"tile={tile}); use the dense multiround kernel"
        )
    return bt


def multiround_sym_plain(
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
    tile: int = SYM_TILE,
    cache_tiles: int = 0,
    sym: bool = True,
    formulation: str = "vpu",
    mxu_tiles: Optional[int] = None,
    fill_mode: str = "prologue",
    finish: Optional[int] = None,
):
    """The rounds of :func:`multiround_plain` over :func:`tiled_matvec_plain`
    (in 3xTF32 for ``formulation="dot"``; for "mixed", the last
    :func:`mxu_share` of the ``cache_tiles`` resident tiles in 3xTF32 and
    every other tile as "vpu").  Where tiles live and how the cache is
    filled never change the result, so the plain version keeps nothing
    resident; ``cache_tiles`` picks the "mixed" tiles, and ``fill_mode`` is
    checked by the kernel's rules and otherwise ignored."""
    _check_formulation_name(formulation)
    bt = _check_tiled(A, ev, v, chunk, eps_mode, tile)
    n = A.shape[0]
    m = _check_tiled_knobs(n, bt, int(cache_tiles), bool(sym), formulation, mxu_tiles, fill_mode)
    mxu = _mxu_mask(A.device, n, bt, bool(sym), int(cache_tiles), m) if formulation == "mixed" \
        else None
    return _rounds_plain(
        lambda e: tiled_matvec_plain(A, e, bt, sym, formulation, mxu),
        ev, v, lam, int(budget), chunk, eps, init, eps_mode, finish,
    )


def _check_formulation_name(formulation: str) -> None:
    if formulation not in _FORMS:
        raise ValueError(f"unknown formulation {formulation!r}")


class SymPlan(NamedTuple):
    table: torch.Tensor  # (T + C, 2) int32 on the card: streamed tiles, then resident
    T: int  # streamed tiles
    C: int  # resident tiles; tile s lives in block s % grid
    grid: int
    slots: int  # resident tiles per block
    split: int  # work items per tile (device.sym_split)
    l2_tiles: int  # streamed tiles read with the L2 evict_last policy
    ring: int = 0  # bulk-copy stages a warp for the streamed tiles (device.sym_ring)
    hbm_bytes: int = 0  # bytes of A a round reads from HBM (sym_hbm_bytes)


def sym_hbm_bytes(
    device: torch.device, n: int, bt: int, cache_tiles: int, sym: bool,
    dtype: torch.dtype = torch.float32,
) -> int:
    """Bytes of A that a round of the triangle kernel reads from HBM under
    the plan of (device, n, bt, cache_tiles, sym, A's dtype): the streamed
    tiles less those the L2 is asked to keep (:func:`sym_l2_tiles`), whole
    bt x bt tiles as stored; the resident tiles stay in shared memory.
    Reads the card's limits and nothing else, so it holds on any machine
    that knows them.  At 8192² with the auto caches on an H100: 952 bf16
    tiles of 32 KiB (2080 tiles, 528 resident, 600 in L2), 31,195,136
    bytes; 1384 f32 tiles of 64 KiB (396 resident, 300 in L2),
    90,701,824."""
    T = len(_tile_split(n, bt, cache_tiles, sym)[0])
    l2 = sym_l2_tiles(bt, device, T, **_sized(dtype, "itemsize"))
    return (T - l2) * bt * bt * dtype.itemsize


@functools.lru_cache(maxsize=None)
def multiround_sym_plan(
    device: torch.device, n: int, bt: int, cache_tiles: int, sym: bool,
    dtype: torch.dtype = torch.float32, dot: bool = False, mixed: bool = False,
    pipelined: bool = False,
):
    """Launch plan of the triangle kernel, built once per (device, n, bt,
    cache_tiles, sym, A's dtype, formulation, fill): the tile table on the
    card, the grid, the resident tiles per block, and what the card's size
    decides (the split of tiles into work items, the L2-kept tiles).  The
    dot and mixed formulations' instances have no ring.  The ``pipelined``
    fill adds a barrier a resident work item (``split`` a slot) and aligns
    the tiles.  Raises
    ValueError when the cache does not fit the card (a request is rejected,
    never shrunk)."""
    from . import build

    size = dtype.itemsize
    streamed, cached = _tile_split(n, bt, cache_tiles, sym)
    T, C = len(streamed), len(cached)
    sms = cuda_limits(device).sms
    slots0 = -(-C // sms)  # the grid holds at least one block per SM
    ring = 0 if dot or mixed else sym_ring(n, bt, device, size)
    split = sym_split(n, bt, device, sym)
    fill = split if pipelined else 0  # the pipelined fill's copies a resident tile
    if not multiround_sym_fits(n, bt, device, slots0, size, ring, fill):
        most = sym_auto_cache_tiles(n, bt, device, sym, size, ring=bool(ring),
                                    pipelined=pipelined)
        raise ValueError(
            f"cache_tiles={cache_tiles} does not fit the card: {slots0} resident "
            f"{bt}x{bt} {dtype} tiles per block and {ring} ring stages a warp need "
            f"{sym_smem_bytes(n, bt, slots0, size, ring, fill)} bytes of shared memory; "
            f"at most {most} tiles fit at n={n}"
        )
    form = _FORMS["dot" if dot else "mixed" if mixed else "vpu"]
    with torch.cuda.device(device):
        cap = build.load().evt_multiround_sym_grid(n, bt, slots0, ring, _ELEM[dtype], form, fill)
    if cap < 0:
        raise RuntimeError(f"multiround_sym occupancy query failed with cudaError {-cap}")
    if cap == 0:
        raise ValueError(f"n={n}, tile {bt}: one block of the triangle kernel does not fit")
    grid = min(cap, max(T + C, -(-n // 1024), 1))
    slots = -(-C // grid) if C else 0
    tab = torch.tensor(streamed + cached, dtype=torch.int32, device=device).reshape(-1, 2)
    return SymPlan(tab.contiguous(), T, C, grid, slots, split,
                   sym_l2_tiles(bt, device, T, **_sized(dtype, "itemsize")), ring,
                   sym_hbm_bytes(device, n, bt, cache_tiles, sym, dtype))


def _sym_checks(A, ev, v, chunk, eps_mode, tile, cache_tiles, sym, formulation, mxu_tiles,
                fill_mode) -> tuple:
    """The tiled wrapper's checks of its operands and knobs, in its order;
    ``(n, tile edge, "mixed" share, device)``."""
    _check_formulation_name(formulation)
    bt = _check_tiled(A, ev, v, chunk, eps_mode, tile)
    n = A.shape[0]
    m = _check_tiled_knobs(n, bt, int(cache_tiles), bool(sym), formulation, mxu_tiles, fill_mode)
    return n, bt, m, tensor_device(A, ev, v)


def _sym_plan(dev: torch.device, n: int, bt: int, cache_tiles: int, sym: bool,
              dtype: torch.dtype, formulation: str, fill_mode: str) -> SymPlan:
    return multiround_sym_plan(dev, n, bt, int(cache_tiles), bool(sym), **_sized(dtype),
                               **_formulated(formulation),
                               **({"pipelined": True} if fill_mode == "pipelined" else {}))


def _sym_card(A, v, n: int, bt: int, dev: torch.device, cache_tiles: int, sym: bool,
              formulation: str, fill_mode: str) -> tuple:
    """The card's checks of a tiled launch, its plan and its scratch:
    ``(plan, raw, part, part_t)``."""
    _check_aligned(n, A, v)
    if not multiround_sym_fits(n, bt, dev):
        raise ValueError(
            f"n={n}: the triangle kernel keeps ev ({sym_smem_bytes(n, bt)} bytes) in "
            f"one block's shared memory, more than this card allows; use the matvec "
            f"kernel"
        )
    plan = _sym_plan(dev, n, bt, cache_tiles, sym, A.dtype, formulation, fill_mode)
    _check_ring_aligned(plan.ring or fill_mode == "pipelined", A)
    raw = torch.empty(n, dtype=torch.float32, device=dev)
    # one slot of bt floats per (row block, column block): the row terms, and
    # for a symmetric A the transpose terms of each of a tile's work items
    part = torch.empty((n // bt) * n, dtype=torch.float32, device=dev)
    part_t = torch.empty((n // bt) * n * plan.split if sym else 1, dtype=torch.float32,
                         device=dev)
    return plan, raw, part, part_t


def _sym_launcher(dev, plan, n: int, bt: int, dtype: torch.dtype, eps, eps_mode: str, sym: bool,
                  formulation: str, m: int, fill_mode: str, raw, part, part_t):
    """A function that launches the tiled kernel under ``plan`` on the
    stream that is ``dev``'s current one now, over this scratch (which the
    caller keeps alive), counts it in ``multiround_sym.launches`` and keeps
    ``plan`` as ``multiround_sym.plan``: the one launch body of
    :func:`multiround_sym` and of the bound solve
    :func:`multiround_sym_solve`.  A call passes what may change between
    launches, as :func:`_stripes_launcher`'s does."""
    entry, stream = _entry(dev, "evt_multiround_sym")
    tiles = (plan.table.data_ptr(), plan.T, plan.C, plan.slots)
    scratch = (raw.data_ptr(), part.data_ptr(), part_t.data_ptr(), n, bt)
    knobs = (int(eps_mode == "relative"), int(sym), plan.split, plan.l2_tiles, plan.ring,
             _FORMS[formulation], plan.C - m, plan.split if fill_mode == "pipelined" else 0)
    elem = _ELEM[dtype]

    def run(A, ev, v, lam, budget, chunk, init, ev_out, v_out, adv, lam_out,
            rounds_out=None, converged_out=None, rounds0=0):
        _call(dev, entry, (
            A.data_ptr(), *tiles, ev.data_ptr(), v.data_ptr(), lam.data_ptr(),
            min(budget, 2**31 - 1), ev_out.data_ptr(), v_out.data_ptr(), adv.data_ptr(),
            lam_out.data_ptr(), _ptr(rounds_out), _ptr(converged_out), rounds0, *scratch,
            min(chunk, 2**31 - 1), eps, int(init), *knobs, _stamps_ptr(), elem, plan.grid,
            stream,
        ), "multiround_sym")
        multiround_sym.launches += 1
        multiround_sym.plan = plan

    return run


@spanned("launch.multiround_sym")
def multiround_sym(
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
    tile: int = SYM_TILE,
    cache_tiles: int = 0,
    sym: bool = True,
    formulation: str = "vpu",
    mxu_tiles: Optional[int] = None,
    fill_mode: str = "prologue",
    finish: Optional[int] = None,
):
    """Up to ``chunk`` matvec-form rounds in one launch of the tiled
    kernel; semantics of :func:`multiround_plain`, ``finish`` as in
    :func:`multiround`.  ``sym=True`` declares A symmetric and reads only
    the upper block triangle; ``sym=False`` reads all tiles (dense tiled
    mode).  ``cache_tiles`` tiles (off-diagonal
    ones when ``sym``; clamped to the cacheable count, as in JAX) stay in
    shared memory across the launch's rounds.  Returns
    ``(ev, v, advanced, λ)``; results are bit-identical for every
    ``cache_tiles`` and every chunking.  A is float32, bfloat16 or float16
    (tiles stream and stay resident as stored, every product and sum in
    f32, the same work items and slots: a 2-byte A gives the bits of its f32
    values); ev and v are float32.  ``formulation="dot"`` takes each tile's
    terms on the tensor cores in 3xTF32, with the same invariances.
    ``formulation="mixed"`` takes the last ``mxu_tiles`` resident tiles
    (None: :func:`mxu_share`'s default, the JAX rule) in the dot form and
    every other tile as "vpu"; at ``mxu_tiles=0`` it gives the "vpu" bits.
    ``fill_mode="pipelined"`` fills the resident tiles by 2-D tensor
    copies, one a tile or, where a tile is cut into row spans that
    different warps take, one a span, all issued by one thread before round
    0; a warp waits for its own at the first read, and the bits are the
    prologue fill's.  It needs A 16-byte aligned and raises if its tensor
    map cannot be encoded: it never turns into another fill.  (8192², the
    auto caches, NVIDIA H100 80GB HBM3 at 700 W: -0.9..+1.6% of the
    prologue fill's launch, whose fill takes 8.9-10.5 µs; PERF.md §6.)
    Both raise where the JAX kernel does (:func:`_check_tiled_knobs`)."""
    n, bt, m, dev = _sym_checks(A, ev, v, chunk, eps_mode, tile, cache_tiles, sym, formulation,
                                mxu_tiles, fill_mode)
    lam = _as_scalar(lam, dev)
    budget = int(budget)
    if dev.type == "cpu":
        return multiround_sym_plain(
            A, ev, v, lam, budget, chunk=chunk, eps=eps, init=init, eps_mode=eps_mode,
            tile=tile, cache_tiles=cache_tiles, sym=sym, formulation=formulation,
            mxu_tiles=mxu_tiles, fill_mode=fill_mode, finish=finish,
        )
    plan, *scratch = _sym_card(A, v, n, bt, dev, cache_tiles, sym, formulation, fill_mode)
    out = _carry_out(n, dev)
    solved = _solved(finish, dev)
    _sym_launcher(dev, plan, n, bt, A.dtype, eps, eps_mode, sym, formulation, m, fill_mode,
                  *scratch)(A, ev, v, lam, budget, chunk, init, *out, *solved,
                            rounds0=finish or 0)
    return out + solved


multiround_sym.launches = 0
multiround_sym.binds = 0
multiround_sym.plan = None


# --- the one-launch solve, bound once per (device, stream) -----------------


class _Binding:
    """What a (device, stream) keeps for the one-launch solves of one key:
    the plan and ``replan``, which looks it up again as a launch would (so
    a new plan, after a cleared plan cache or a patched plan function,
    shows as another object); the launch body with the plan, the library's
    entry, the stream and the scratch bound (``run``); the scratch itself,
    the carry's v (which a one-launch solve never returns) and the constant
    inputs ev0 = ones(n) and λ0 = 0, which the kernels read and never
    write.  A call checks A and ev0 with the wrapper's checks as far as
    this binding's launch may take them, allocates only what it returns and
    launches."""

    def __init__(self, key: tuple, n: int, dev: torch.device, ones: torch.Tensor, plan, replan,
                 run, ring: bool, scratch: tuple):
        self.key, self.n, self.dev, self.ones = key, n, dev, ones
        self.plan, self.replan, self.run, self.ring = plan, replan, run, ring
        self.zero = torch.zeros((), dtype=torch.float32, device=dev)
        self.v = torch.empty(n, dtype=torch.float32, device=dev)
        self.scratch = scratch  # the buffers that run's pointers point into

    def __call__(self, A: torch.Tensor, ev0: Optional[torch.Tensor], budget: int, chunk: int):
        n, dev = self.n, self.dev
        _check_chunk(chunk)
        ev = self.ones if ev0 is None else ev0
        _operands(A, ev, ev, n)
        if ev0 is not None:
            tensor_device(A, ev0)
        _check_aligned(n, A, ev)
        _check_ring_aligned(self.ring, A)
        ev_out = torch.empty(n, dtype=torch.float32, device=dev)
        adv = torch.empty((), dtype=torch.int32, device=dev)
        lam = torch.empty((), dtype=torch.float32, device=dev)
        rounds = torch.empty((), dtype=torch.int32, device=dev)
        converged = torch.empty((), dtype=torch.bool, device=dev)
        self.run(A, ev, ev, self.zero, int(budget), chunk, True, ev_out, self.v, adv, lam,
                 rounds, converged, 0)
        return ev_out, adv, lam, rounds, converged


#: The bindings of the one-launch solves, one at most for each (device,
#: current stream): a key of another n, dtype, kernel or knob, or another
#: plan for the same key, replaces it.
_BINDINGS: dict = {}


def drop_bindings() -> None:
    """Drop every binding of the one-launch solves (:func:`multiround_solve`,
    :func:`multiround_sym_solve`) and the scratch and constant inputs each
    keeps, one binding for each (device, stream) that has solved: the
    triangle kernel's two slot buffers hold (n / bt) · n floats or more
    each, 4 MiB in all at 8192² and 200 MiB at 57856², bt 128.  The next
    solve binds anew."""
    _BINDINGS.clear()


def _bound(wrapper, A: torch.Tensor, key: tuple, bind, *args) -> _Binding:
    """The binding of (A's device, its current stream) if it holds ``key``
    and the plan a launch would look up now; else ``bind(key, A, *args)``,
    which replaces the slot's binding and is counted in
    ``wrapper.binds``.  Two threads that find a slot without the key at
    once may each bind: the later binding replaces the earlier, and each
    call launches over its own binding's scratch."""
    dev = A.device
    slot = (dev, _stream(dev) if dev.type == "cuda" else None)
    held = _BINDINGS.get(slot)
    if held is None or held.key != key or held.replan() is not held.plan:
        _BINDINGS.pop(slot, None)  # its memory goes back before the new binding takes its own
        held = _BINDINGS[slot] = bind(key, A, *args)
        wrapper.binds += 1
    return held


def _bind_stripes(key, A, chunk, eps, eps_mode, formulation) -> _Binding:
    ones = torch.ones(A.shape[0], dtype=torch.float32, device=A.device)
    n, dev = _stripes_checks(A, ones, ones, chunk, eps_mode, formulation)
    plan, raw = _stripes_card(A, ones, n, dev, formulation)
    dtype = A.dtype
    run = _stripes_launcher(dev, plan, n, dtype, eps, eps_mode, formulation, raw)
    return _Binding(key, n, dev, ones, plan, lambda: _stripes_plan(dev, n, dtype, formulation),
                    run, bool(plan.ring), (raw,))


@spanned("launch.multiround")
def multiround_solve(A: torch.Tensor, ev0: Optional[torch.Tensor], budget: int, *, chunk: int,
                     eps: float, eps_mode: str = "absolute", formulation: str = "vpu"):
    """A whole solve in one launch of the stripes kernel on the card: what
    ``multiround(A, ev0, ev0, 0, budget, chunk=chunk, eps=eps, init=True,
    eps_mode=eps_mode, formulation=formulation, finish=0)`` returns, bit
    for bit, less the carry's v: ``(ev, advanced, λ, rounds, converged)``.
    ``ev0`` None starts from ones.

    It launches through the binding of (A's device, its current stream),
    made by the first call of a key (n, A's dtype, the kernel, the
    formulation, eps and eps_mode) and replaced by a call of another key or
    under another plan: the plan, the library's entry with every argument
    that does not change between calls, the scratch, the carry's v and ev0
    = ones, λ0 = 0 are kept there (:func:`drop_bindings`), so a call checks
    A, allocates the five tensors it returns and launches.  Launches on one
    stream run in order, so their calls share the scratch; each returns its
    own tensors.  (The dot formulation's segment sums and work counters are
    each launch's own, as the wrapper's are.)"""
    key = ("stripes", _square(A), A.dtype, formulation, eps, eps_mode)
    return _bound(multiround, A, key, _bind_stripes, chunk, eps, eps_mode,
                  formulation)(A, ev0, budget, chunk)


def _bind_sym(key, A, chunk, eps, eps_mode, tile, cache_tiles, sym, formulation, mxu_tiles,
              fill_mode) -> _Binding:
    ones = torch.ones(A.shape[0], dtype=torch.float32, device=A.device)
    n, bt, m, dev = _sym_checks(A, ones, ones, chunk, eps_mode, tile, cache_tiles, sym,
                                formulation, mxu_tiles, fill_mode)
    plan, *scratch = _sym_card(A, ones, n, bt, dev, cache_tiles, sym, formulation, fill_mode)
    dtype = A.dtype
    run = _sym_launcher(dev, plan, n, bt, dtype, eps, eps_mode, sym, formulation, m, fill_mode,
                        *scratch)
    return _Binding(key, n, dev, ones, plan,
                    lambda: _sym_plan(dev, n, bt, cache_tiles, sym, dtype, formulation, fill_mode),
                    run, bool(plan.ring) or fill_mode == "pipelined", tuple(scratch))


@spanned("launch.multiround_sym")
def multiround_sym_solve(A: torch.Tensor, ev0: Optional[torch.Tensor], budget: int, *,
                         chunk: int, eps: float, eps_mode: str = "absolute",
                         tile: int = SYM_TILE, cache_tiles: int = 0, sym: bool = True,
                         formulation: str = "vpu", mxu_tiles: Optional[int] = None,
                         fill_mode: str = "prologue"):
    """A whole solve in one launch of the tiled kernel on the card: what
    ``multiround_sym(A, ev0, ev0, 0, budget, ..., init=True, finish=0)``
    returns, bit for bit, less the carry's v, through the binding of (A's
    device, its current stream) as :func:`multiround_solve`'s; the key adds
    the tiled kernel's knobs (triangle or dense tiled, tile, cache_tiles,
    mxu_tiles, fill_mode).  Each launch keeps its plan as
    ``multiround_sym.plan``."""
    key = ("triangle" if sym else "tiled", _square(A), A.dtype, tile, cache_tiles, formulation,
           mxu_tiles, fill_mode, eps, eps_mode)
    return _bound(multiround_sym, A, key, _bind_sym, chunk, eps, eps_mode, tile, cache_tiles,
                  sym, formulation, mxu_tiles, fill_mode)(A, ev0, budget, chunk)


def prepare(
    device: torch.device, n: int, dtype: torch.dtype = torch.float32, *,
    kernel: Optional[str] = None, bt: Optional[int] = None, cache_tiles: int = 0,
) -> None:
    """What a first launch at dim ``n`` on A of ``dtype`` would otherwise
    pay for, done now: the kernel library, and the launch plan of a route's
    persistent kernel (``api.Route``: "stripes", or "triangle" / "tiled" at
    tile edge ``bt`` with ``cache_tiles``) that fits the card, cached as the
    wrappers look them up."""
    from . import build

    build.load()
    if kernel in ("triangle", "tiled"):
        multiround_sym_plan(device, n, bt, int(cache_tiles), kernel == "triangle", **_sized(dtype))
    elif kernel == "stripes":
        multiround_launch_plan(device, n, **_sized(dtype))


# --- the iterated (mutate-A) form's O(n²) passes and the ladder's rungs ------


def _check_square(A: torch.Tensor) -> int:
    n = _square(A)
    _check_f32("A", A, (n, n))
    return n


def rowsum_plain(A: torch.Tensor) -> torch.Tensor:
    """``v[r] = Σ_c A[r, c]`` with PyTorch's reduction (its own order)."""
    return torch.sum(A, dim=1)


@spanned("launch.rowsum")
def rowsum(A: torch.Tensor) -> torch.Tensor:
    """Row sums of a square float32 A.  On a card the sums run in the
    matvec kernel's order: ``rowsum(A)`` equals ``matvec(A, ones)`` bit for
    bit."""
    n = _check_square(A)
    dev = tensor_device(A)
    if dev.type == "cpu":
        return rowsum_plain(A)
    _check_aligned(n, A)
    from . import build

    out = torch.empty(n, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(build.load().evt_rowsum(A.data_ptr(), out.data_ptr(), n, stream), "rowsum")
    rowsum.launches += 1
    return out


rowsum.launches = 0


def rowsum_bias_plain(A: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``Σ_c (A[r, c] + bias)``: the add materialises (a write and a read
    of n² floats more than the kernel moves)."""
    return torch.sum(A + bias, dim=1)


def rowsum_bias(A: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Row sums of ``A + bias`` in one read of A.  ``bias`` is a 0-d float32
    tensor on A's device and is read there, by the kernel: a timing chain
    whose bias comes from the previous result never waits for the host."""
    n = _check_square(A)
    if not isinstance(bias, torch.Tensor):
        raise ValueError("bias must be a 0-d float32 tensor on A's device")
    _check_f32("bias", bias, ())
    dev = tensor_device(A, bias)
    if dev.type == "cpu":
        return rowsum_bias_plain(A, bias)
    _check_aligned(n, A)
    from . import build

    out = torch.empty(n, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(
            build.load().evt_rowsum_bias(A.data_ptr(), bias.data_ptr(), out.data_ptr(), n, stream),
            "rowsum_bias",
        )
    rowsum_bias.launches += 1
    return out


rowsum_bias.launches = 0


def _check_scale(A: torch.Tensor, v: torch.Tensor, out: Optional[torch.Tensor]):
    """Checks of the update kernels; returns ``(n, device, out)`` with
    ``out`` allocated when the caller gave none."""
    n = _check_square(A)
    _check_f32("v", v, (n,))
    if out is None:
        out = torch.empty_like(A)
    _check_f32("out", out, (n, n))
    dev = tensor_device(A, v, out)
    if out.data_ptr() != A.data_ptr() and _overlap(out, A):
        raise ValueError("out must be A itself or a buffer that does not overlap it")
    if _overlap(out, v):
        raise ValueError("out must not overlap v")
    return n, dev, out


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.numel() * b.element_size() and b0 < a0 + a.numel() * a.element_size()


def scale_plain(
    A: torch.Tensor, v: torch.Tensor, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The similarity update ``A' = A · ((1/v_r) · v_c)``: a true IEEE
    reciprocal, then two rounded products, right-associated as in the
    reference, so every implementation gives the same bits.  Written to
    ``out`` (A itself for an in-place update; a new tensor when None)."""
    one = torch.ones((), dtype=A.dtype, device=A.device)
    return torch.mul(A, (one / v)[:, None] * v[None, :], out=out)


def scale(A: torch.Tensor, v: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``A' = A · ((1/v_r) · v_c)`` for square float32 A, written to ``out``
    (None: a new tensor; A itself: in place) and returned."""
    n, dev, out = _check_scale(A, v, out)
    if dev.type == "cpu":
        return scale_plain(A, v, out=out)
    _check_aligned(n, A, v, out)
    from . import build

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(
            build.load().evt_scale(A.data_ptr(), v.data_ptr(), out.data_ptr(), n, stream),
            "scale",
        )
    scale.launches += 1
    return out


scale.launches = 0


def scale_rowsum_plain(A: torch.Tensor, v: torch.Tensor, out: Optional[torch.Tensor] = None):
    """``(A', v')`` with ``A' = scale_plain(A, v)`` and ``v' = rowsum_plain(A')``:
    two passes where the kernel makes one."""
    A2 = scale_plain(A, v, out=out)
    return A2, rowsum_plain(A2)


@spanned("launch.scale_rowsum")
def scale_rowsum(A: torch.Tensor, v: torch.Tensor, out: Optional[torch.Tensor] = None):
    """The iterated form's round pass, one read and one write of A:
    ``(A', v')`` with ``A'`` as :func:`scale` gives it (to ``out``) and
    ``v'[r] = Σ_c A'[r, c]`` over the stored values, so ``v'`` equals
    ``rowsum(A')`` bit for bit.  ``v'`` is always a new tensor: every row's
    update reads all of ``v``."""
    n, dev, out = _check_scale(A, v, out)
    if dev.type == "cpu":
        return scale_rowsum_plain(A, v, out=out)
    _check_aligned(n, A, v, out)
    from . import build

    v_out = torch.empty(n, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(
            build.load().evt_scale_rowsum(
                A.data_ptr(), v.data_ptr(), out.data_ptr(), v_out.data_ptr(), n, stream
            ),
            "scale_rowsum",
        )
    scale_rowsum.launches += 1
    return out, v_out


scale_rowsum.launches = 0


# --- the stop criterion and the one-launch rounds ----------------------------


def _operand(x, dev: torch.device, name: str) -> torch.Tensor:
    """A scalar that a kernel reads on the card: a 0-d float32 tensor on
    ``dev`` as it is (one that lies elsewhere raises: moving it would wait
    for its device), a number wrapped into one."""
    if not isinstance(x, torch.Tensor):
        return torch.tensor(x, dtype=torch.float32, device=dev)
    _check_f32(name, x, ())
    if x.device != dev:
        raise ValueError(f"{name} must be on {dev}, got {x.device}")
    return x


def stop_plain(v: torch.Tensor, eps) -> torch.Tensor:
    """``all |v[i] - v[(i+1) % n]| < eps`` with PyTorch's operations
    (``solver.stop_check``): a shifted difference, an ``abs``, a compare
    and a reduction, each a pass of its own."""
    return stop_check(v, eps)


@functools.lru_cache(maxsize=None)
def _stop_state(device: torch.device, stream: int) -> torch.Tensor:
    """The two words (flag, ticket) through which the blocks of a ``stop``
    launch combine their results (csrc/stop.cu).  The kernel leaves them
    zero, so they are zeroed once, here; launches on one stream are
    ordered, so each (device, stream) has its own pair."""
    return torch.zeros(2, dtype=torch.int32, device=device)


def stop(v: torch.Tensor, eps) -> torch.Tensor:
    """Wraparound stop criterion ``all |v[i] - v[(i+1) % n]| < eps`` (strict;
    a NaN gives False) for float32 v of any length n ≥ 1, in one launch and
    one read of v.  ``eps`` is a 0-d float32 tensor on v's device and is
    read there, by the kernel (a number is wrapped into one).  Returns a
    0-d bool tensor on v's device; nothing is read back."""
    if v.dim() != 1 or v.shape[0] < 1:
        raise ValueError(f"v must be a non-empty vector, got shape {tuple(v.shape)}")
    n = v.shape[0]
    _check_f32("v", v, (n,))
    dev = tensor_device(v)
    eps = _operand(eps, dev, "eps")
    if dev.type == "cpu":
        return stop_plain(v, eps)
    _check_aligned(n, v)
    from . import build

    out = torch.empty((), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        state = _stop_state(dev, stream)
        _launch(
            build.load().evt_stop(v.data_ptr(), eps.data_ptr(), n, state.data_ptr(),
                                  out.data_ptr(), stream),
            "stop",
        )
    stop.launches += 1
    return out


stop.launches = 0


#: Blocks of a ``round_glue`` launch at most, each with a slot of three
#: partial maxima in the scratch: eight for each of an H100's 132 SMs.
GLUE_SLOTS = 1056


def round_glue_plain(y, ev, eps, i: int, lam, rounds, converged, eps_mode: str = "absolute"):
    """:func:`round_glue` with PyTorch's operations: the host loop's
    expressions in their order (``v = y / ev``, ``solver.stop_check``,
    ``m = torch.max(v)``, ``ev · (v / m)``, ``λ = v[0]``), written into the
    same buffers."""
    v = y / ev
    stop = stop_check(v, eps, eps_mode)
    m = torch.max(v)
    ev.copy_(ev * (v / m))
    lam.copy_(v[0])
    converged.copy_(stop)
    rounds.fill_(i + 1).sub_(stop.to(rounds.dtype))


@functools.lru_cache(maxsize=None)
def _glue_state(device: torch.device, stream: int) -> tuple:
    """``(ticket, scratch)`` through which the blocks of a ``round_glue``
    launch combine their partial maxima (csrc/round_glue.cu): one word the
    kernel leaves zero, so it is zeroed once, here, and m with
    :data:`GLUE_SLOTS` slots of three floats.  Launches on one stream are
    ordered, so each (device, stream) has its own."""
    return (torch.zeros(1, dtype=torch.int32, device=device),
            torch.empty(1 + 3 * GLUE_SLOTS, dtype=torch.float32, device=device))


@spanned("launch.round_glue")
def round_glue(y: torch.Tensor, ev: torch.Tensor, eps, i: int, lam: torch.Tensor,
               rounds: torch.Tensor, converged: torch.Tensor, eps_mode: str = "absolute"):
    """Round ``i``'s glue of the matvec-form loop after its matvec
    ``y = A @ ev``, all on the card: ``v = y / ev``; the wraparound stop on
    v (strict, a NaN fails; ``eps_mode`` as ``solver.stop_check``);
    ``m = max(v)`` (NaN propagating); then, whatever the stop,
    ``ev ← ev · (v / m)`` in place, ``lam ← v[0]``,
    ``rounds ← stop ? i : i + 1`` and ``converged ← stop``.  After the
    glue of the round where the loop ends (the stop, or ``i + 1 ==
    max_itr``) the four buffers hold ``solver._finish``'s result bit for
    bit.  y and ev are float32 (n,), lam float32, rounds int32 and
    converged bool 0-d; ``eps`` is a 0-d float32 tensor on their device,
    read there (a number is wrapped into one).  Two launches (the check,
    then the update) on the current stream; nothing is read back."""
    if y.dim() != 1 or y.shape[0] < 1:
        raise ValueError(f"y must be a non-empty vector, got shape {tuple(y.shape)}")
    n = y.shape[0]
    _check_f32("y", y, (n,))
    _check_f32("ev", ev, (n,))
    _check_f32("lam", lam, ())
    _check_f32("rounds", rounds, (), (torch.int32,))
    _check_f32("converged", converged, (), (torch.bool,))
    if eps_mode not in ("absolute", "relative"):
        raise ValueError(f"eps_mode must be 'absolute' or 'relative', got {eps_mode!r}")
    dev = tensor_device(y, ev, lam, rounds, converged)
    eps = _operand(eps, dev, "eps")
    if _overlap(y, ev):
        raise ValueError("y must not overlap ev")
    if dev.type == "cpu":
        return round_glue_plain(y, ev, eps, i, lam, rounds, converged, eps_mode)
    _check_aligned(n, y, ev)
    from . import build

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ticket, scratch = _glue_state(dev, stream)
        _launch(
            build.load().evt_round_glue(
                y.data_ptr(), ev.data_ptr(), eps.data_ptr(), int(eps_mode == "relative"), n, i,
                ticket.data_ptr(), scratch.data_ptr(), GLUE_SLOTS, lam.data_ptr(),
                rounds.data_ptr(), converged.data_ptr(), stream,
            ),
            "round_glue",
        )
    round_glue.launches += 2


round_glue.launches = 0


def round_matvec_plain(A: torch.Tensor, ev: torch.Tensor, v: torch.Tensor, m):
    """``(v', ev')`` with ``ev' = ev · (v / m)`` and ``v' = (A @ ev') / ev'``:
    the unfused expressions of the host loop's round over
    :func:`matvec_plain`."""
    ev_new = ev * (v / m)
    return matvec_plain(A, ev_new) / ev_new, ev_new


@functools.lru_cache(maxsize=None)
def round_grid(device: torch.device, n: int) -> int:
    """Blocks of the one-round kernels at dimension ``n`` on ``device``
    (csrc/round.cu ``evt_round_grid``), computed once."""
    from . import build

    with torch.cuda.device(device):
        grid = build.load().evt_round_grid(n)
    if grid < 0:
        raise RuntimeError(f"round kernel occupancy query failed with cudaError {-grid}")
    return grid


def _check_round(A: torch.Tensor, ev: torch.Tensor, v: torch.Tensor) -> torch.device:
    """Checks shared by the one-round kernels; the tensors' device."""
    n = _check_square(A)
    if n == 0:
        raise ValueError("A must be non-empty")
    _check_f32("ev", ev, (n,))
    _check_f32("v", v, (n,))
    dev = tensor_device(A, ev, v)
    if dev.type == "cuda":
        _check_aligned(n, A)
        if not multiround_fits(n, dev):
            raise ValueError(
                f"n={n}: the one-round kernels keep ev' ({4 * n} bytes) in one "
                f"block's shared memory, more than this card allows; use the "
                f"matvec kernel loop (backend='matvec_pallas')"
            )
    return dev


def round_matvec(A: torch.Tensor, ev: torch.Tensor, v: torch.Tensor, m):
    """One matvec-form round minus its reductions, in one launch: given the
    round's ``v`` and its max ``m`` (a 0-d float32 tensor on A's device,
    read by the kernel; a number is wrapped into one), returns
    ``(v_next, ev_new)`` with ``ev_new = ev · (v / m)`` and
    ``v_next = (A @ ev_new) / ev_new``.  On a card both hold bit for bit
    against ``ev * (v / m)`` and ``matvec(A, ev_new) / ev_new``.  The
    results are new tensors; no input is written."""
    dev = _check_round(A, ev, v)
    m = _operand(m, dev, "m")
    if dev.type == "cpu":
        return round_matvec_plain(A, ev, v, m)
    from . import build

    n = A.shape[0]
    v_next = torch.empty(n, dtype=torch.float32, device=dev)
    ev_new = torch.empty(n, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(
            build.load().evt_round_matvec(
                A.data_ptr(), ev.data_ptr(), v.data_ptr(), m.data_ptr(),
                v_next.data_ptr(), ev_new.data_ptr(), n, round_grid(dev, n), stream,
            ),
            "round_matvec",
        )
    round_matvec.launches += 1
    return v_next, ev_new


round_matvec.launches = 0


def round_fused_plain(A: torch.Tensor, ev: torch.Tensor, v: torch.Tensor, *, eps: float):
    """``(v', ev', done, λ)``: the whole round in PyTorch's operations:
    ``m = max v``, the wraparound stop on v, ``λ = v[0]``, then
    :func:`round_matvec_plain`."""
    v_next, ev_new = round_matvec_plain(A, ev, v, torch.max(v))
    return v_next, ev_new, stop_check(v, eps), v[0].clone()


def round_fused(A: torch.Tensor, ev: torch.Tensor, v: torch.Tensor, *, eps: float):
    """One whole matvec-form round in one launch.  Returns
    ``(v_next, ev_new, done, lam)`` with ``m = max(v)``,
    ``done = all |v[k] − v[(k+1) % n]| < eps`` (a 0-d bool tensor; absolute
    eps only, as in the JAX kernel), ``lam = v[0]``, and ``ev_new``,
    ``v_next`` as :func:`round_matvec` gives them for that ``m``, bit for
    bit.  ``v_next`` and ``ev_new`` are computed even when ``done``.
    Nothing is read back; the results are new tensors."""
    dev = _check_round(A, ev, v)
    if dev.type == "cpu":
        return round_fused_plain(A, ev, v, eps=eps)
    from . import build

    n = A.shape[0]
    v_next = torch.empty(n, dtype=torch.float32, device=dev)
    ev_new = torch.empty(n, dtype=torch.float32, device=dev)
    done = torch.empty((), dtype=torch.bool, device=dev)
    lam = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(
            build.load().evt_round_fused(
                A.data_ptr(), ev.data_ptr(), v.data_ptr(), eps, v_next.data_ptr(),
                ev_new.data_ptr(), done.data_ptr(), lam.data_ptr(), n, round_grid(dev, n),
                stream,
            ),
            "round_fused",
        )
    round_fused.launches += 1
    return v_next, ev_new, done, lam


round_fused.launches = 0
