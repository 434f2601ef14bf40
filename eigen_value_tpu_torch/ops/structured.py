"""Fast matvecs for structured matrices, the operands of the matrix-free
solve (:func:`..api.max_eigenvalue_operator`); counterpart of
``eigen_value_tpu.ops.structured``.

A structured positive matrix need never be materialized: its matvec is all
the power-form solver observes.  The factories here replace the O(n²) dense
pass with the structure's own cost: O(n log n) FFTs for Hankel, Toeplitz and
circulant matrices (the benchmark family itself: the Hilbert matrix
``A[r][c] = 1/(r+c+1)`` is Hankel with profile ``h[k] = 1/(k+1)``), two thin
matmuls for Kronecker and low-rank operators, O(nnz) for sparse ones; the
combinators (:func:`add_matvec`, :func:`scale_matvec`) compose them.

No Pallas kernel stands behind any of these in the JAX package: XLA's FFT,
matmul and gather do the work.  Here the same work is ``torch.fft`` (cuFFT on
the card), ``torch.matmul`` in true float32 (cuBLAS), a torch sparse product
(cuSPARSE) and a gather.

Where a factory's tensors live: on the device of the tensors it is given;
numpy input (or none, as for :func:`hilbert_matvec`) goes to the CUDA card,
which raises without one, unless ``device`` says otherwise (``"cpu"`` asks
for the CPU).  A matvec takes and returns a tensor on that device.  FFT
rounding differs from the dense row-sum order, so round counts may differ by
one from the dense solve.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import solve_device


def _host(a) -> np.ndarray:
    """A numpy view or copy of an array-like or a tensor (on any device)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a)


def _tensor(a, device: torch.device, dtype=None) -> torch.Tensor:
    """``a`` (numpy or a tensor) as a contiguous tensor on ``device``."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(device=device, dtype=dtype).contiguous()


def _fft_len(min_len: int) -> int:
    """Smallest power of two ≥ min_len (power-of-two FFTs are the fast path
    of every FFT library)."""
    return 1 << (min_len - 1).bit_length()


def _traced(*profiles) -> bool:
    """Whether autograd records and a profile is a tensor that requires
    grad: its spectrum must then stay in the graph (JAX's traced path)."""
    return torch.is_grad_enabled() and any(
        isinstance(p, torch.Tensor) and p.requires_grad for p in profiles
    )


def _spectrum_rfft(arr, m: int, device: torch.device) -> torch.Tensor:
    """rfft of a profile vector, computed once on the host as the JAX
    package computes it: numpy's float64 FFT of the float32 profile, cast to
    complex64, then moved to ``device``.  Both packages so hold the same
    spectrum bit for bit; only the per-round float32 FFTs differ (XLA's,
    PyTorch's on the CPU, cuFFT on the card).  A spectrum computed in
    float32 moves the Hilbert round count at n = 2²².

    A profile that requires grad takes ``torch.fft.rfft`` in float32 on
    ``device`` instead, as JAX takes ``jnp.fft.rfft`` for a traced profile,
    so that the matvec is differentiable in it (``ops/autodiff.py``)."""
    if _traced(arr):
        return torch.fft.rfft(arr.to(device).float(), m)
    prof = np.asarray(_host(arr), np.float32).astype(np.float64)
    return torch.from_numpy(np.fft.rfft(prof, m).astype(np.complex64)).to(device)


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matmul in true float32 on every device (the JAX package pins
    ``Precision.HIGHEST``), whatever the caller set
    (``torch.set_float32_matmul_precision`` or
    ``torch.backends.cuda.matmul.allow_tf32``); the caller's setting is put
    back after the call.  With TF32 a product keeps about three decimal
    digits, and the row-sum noise at λ ≳ 1 dwarfs the absolute eps = 1e-3
    stop: the Kronecker and low-rank solves would run to MAX_ITR.  The
    setting is the process's, so a matmul that another thread runs meanwhile
    sees it too."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        return torch.matmul(a, b)
    finally:
        torch.set_float32_matmul_precision(prev)


def hankel_matvec(h, n: int, device=None):
    """Matvec closure for the n×n Hankel matrix ``A[r][c] = h[r+c]``
    (constant anti-diagonals; ``len(h) = 2n-1``).

    ``y[r] = Σ_c h[r+c] x[c]`` is a correlation, the slice ``[n-1 : 2n-1]``
    of the linear convolution ``h ⊛ reverse(x)``, computed by real FFT in
    O(n log n).
    """
    if h.shape[0] != 2 * n - 1:
        raise ValueError(f"need len(h) == 2n-1 == {2 * n - 1}, got {h.shape[0]}")
    dev = solve_device(device, h)
    # m >= 2n-1 suffices: circular aliasing wraps the entries s >= m onto
    # s - m < n-1, all in the discarded prefix of the slice.  rfft rejects
    # bf16/f16, so compute in f32 and cast back.
    m = _fft_len(2 * n - 1)
    Hf = _spectrum_rfft(h, m, dev)

    def matvec(x: torch.Tensor) -> torch.Tensor:
        z = torch.fft.irfft(Hf * torch.fft.rfft(x.flip(0).float(), m), m)
        return z[n - 1 : 2 * n - 1].to(x.dtype)

    return matvec


def toeplitz_matvec(c, r, n: int, device=None):
    """Matvec closure for the n×n Toeplitz matrix with first column ``c``
    and first row ``r`` (``A[i][j] = c[i-j]`` for i ≥ j, ``r[j-i]`` for
    j ≥ i; ``c[0]`` must equal ``r[0]``).

    ``y = A x`` is the middle slice of the linear convolution of the
    diagonal profile ``t = [r[n-1..1] reversed | c]`` with ``x``:
    ``y[i] = Σ_j t[(n-1) + (i-j)] x[j]``.
    """
    if c.shape[0] != n or r.shape[0] != n:
        raise ValueError(f"need len(c) == len(r) == n == {n}")
    dev = solve_device(device, c, r)
    # t[k] = A[i][j] with i-j = k-(n-1): on the host, or in the autograd
    # graph when a profile requires grad
    if _traced(c, r):
        c, r = _tensor(c, dev), _tensor(r, dev)
        t = torch.cat([torch.flip(r[1:], (0,)), c])
    else:
        t = np.concatenate(
            [np.asarray(_host(r), np.float32)[1:][::-1], np.asarray(_host(c), np.float32)]
        )
    m = _fft_len(2 * n - 1)  # aliasing only corrupts the discarded prefix
    Tf = _spectrum_rfft(t, m, dev)

    def matvec(x: torch.Tensor) -> torch.Tensor:
        z = torch.fft.irfft(Tf * torch.fft.rfft(x.float(), m), m)
        return z[n - 1 : 2 * n - 1].to(x.dtype)

    return matvec


def hilbert_matvec(n: int, dtype=torch.float32, device=None):
    """The Hilbert matrix ``A[r][c] = 1/(r+c+1)`` as an O(n)-memory FFT
    operator: the benchmark family without its n² bytes.  The profile
    ``1/arange(1, 2n)`` is formed in ``dtype`` (as the JAX package forms
    it) on the host; the operator lives on ``device`` (default: the card)."""
    dev = solve_device(device)
    h = torch.tensor(1.0, dtype=dtype) / torch.arange(1, 2 * n, dtype=dtype)
    return hankel_matvec(h, n, device=dev)


def circulant_matvec(c, n: int, device=None):
    """Matvec closure for the n×n circulant matrix ``A[i][j] =
    c[(i-j) mod n]`` (first column ``c``).

    Circulants diagonalize in the Fourier basis, so ``y = A x`` is the exact
    circular convolution ``irfft(rfft(c)·rfft(x))``: no padding, no
    aliasing slice, any n (odd too).  O(n log n) per matvec, O(n) memory.
    """
    if c.shape[0] != n:
        raise ValueError(f"need len(c) == n == {n}, got {c.shape[0]}")
    dev = solve_device(device, c)
    Cf = _spectrum_rfft(c, n, dev)

    def matvec(x: torch.Tensor) -> torch.Tensor:
        z = torch.fft.irfft(Cf * torch.fft.rfft(x.float()), n)
        return z.to(x.dtype)

    return matvec


def low_rank_matvec(U, V, diag=None, device=None):
    """Matvec closure for ``A = U Vᵀ (+ diag)``, a positive rank-k matrix
    (plus an optional elementwise-nonnegative diagonal), never materialized.

    ``y = U (Vᵀ x) + diag·x`` is two skinny matmuls, O(n·k) operations and
    memory against the dense pass's O(n²), in true float32.  Positivity
    contract (the solver requires a positive A): every entry of ``U Vᵀ``
    must be > 0 — entrywise-positive ``U`` and ``V`` suffice — and
    ``diag``, if given, must be ≥ 0 elementwise.  Rank-one positive updates
    of a known operator (the teleportation term of a PageRank chain) are the
    canonical use.
    """
    n, k = U.shape
    n2, k2 = V.shape
    if n != n2 or k != k2:
        raise ValueError(
            f"need U and V both n×k, got {tuple(U.shape)} and {tuple(V.shape)}"
        )
    if diag is not None and tuple(diag.shape) != (n,):
        raise ValueError(f"need diag of shape ({n},), got {tuple(diag.shape)}")
    dev = solve_device(device, U, V, diag)
    U, V = _tensor(U, dev), _tensor(V, dev)
    Vt = V.T
    if diag is not None:
        diag = _tensor(diag, dev)

    def matvec(x: torch.Tensor) -> torch.Tensor:
        y = _matmul_f32(U, _matmul_f32(Vt, x)).to(x.dtype)
        return y if diag is None else y + diag * x

    return matvec


def sparse_matvec(A_sp):
    """Matvec closure for a torch sparse COO or CSR matrix (the
    counterpart of JAX's BCOO): O(nnz) per round instead of the dense
    pass's O(n²), cuSPARSE on the card.  A COO matrix is coalesced once
    (duplicate entries sum).  The matvec runs where ``A_sp`` lives.

    Positivity contract: the method's convergence theory assumes a positive
    matrix, and a sparse matrix is at best nonnegative.  The iteration stays
    well-defined (all iterates positive) whenever every row has a positive
    entry, and the row sums converge to λ_max whenever the matrix is
    primitive (irreducible and aperiodic — e.g. irreducible with a positive
    diagonal entry).  For an irreducible periodic matrix the row sums
    oscillate and the solve hits the cap (``converged=False``), as the dense
    solve does on that input.
    """
    if not isinstance(A_sp, torch.Tensor) or A_sp.layout not in (
        torch.sparse_coo,
        torch.sparse_csr,
    ):
        raise TypeError(
            f"need a torch sparse COO or CSR tensor (in place of a BCOO), got "
            f"{type(A_sp) if not isinstance(A_sp, torch.Tensor) else A_sp.layout}"
        )
    n, n2 = A_sp.shape
    if n != n2:
        raise ValueError(f"need a square matrix, got {tuple(A_sp.shape)}")
    if A_sp.layout == torch.sparse_coo:
        A_sp = A_sp.coalesce()

    def matvec(x: torch.Tensor) -> torch.Tensor:
        return A_sp @ x

    return matvec


def ell_matvec(cols, vals, device=None):
    """Matvec closure for a sparse matrix in padded ELL row format:
    ``cols`` / ``vals`` are (n, k), row ``i`` holding its ≤k nonzeros
    ``A[i, cols[i, j]] = vals[i, j]`` (unused slots padded with ``vals = 0``;
    their ``cols`` entry is arbitrary, 0 by convention).

    ``y = (vals * x[cols]).sum(1)`` is one dense gather and a row sum: no
    scatter, static shapes, O(n·k) per round.  The column indices are
    widened to int64 once, here, for the gather.  Positivity contract as in
    :func:`sparse_matvec` (rows must not be all padding).
    """
    if tuple(cols.shape) != tuple(vals.shape) or cols.ndim != 2:
        raise ValueError(
            f"need matching (n, k) cols/vals, got {tuple(cols.shape)} and "
            f"{tuple(vals.shape)}"
        )
    dev = solve_device(device, cols, vals)
    cols = _tensor(cols, dev, torch.int64)
    vals = _tensor(vals, dev)

    def matvec(x: torch.Tensor) -> torch.Tensor:
        return torch.sum(vals * x[cols], dim=1)

    return matvec


def ell_from_coo(rows, cols, vals, n: int, device=None):
    """Pack COO triplets into the padded (cols, vals) ELL arrays of
    :func:`ell_matvec`: numpy in, an int32 and a float32 tensor out on
    ``device`` (default: the card).  k = the largest row degree; duplicate
    (row, col) entries land in separate slots, so the matvec's row sum adds
    them.  Vectorized (argsort, cumsum, one fancy-indexed scatter): the
    sizes this layout exists for have 10⁵–10⁶ rows.
    """
    dev = solve_device(device)
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    if len(rows) and (rows.min() < 0 or rows.max() >= n):
        raise ValueError(f"row indices must be in [0, {n}), got [{rows.min()}, {rows.max()}]")
    if len(cols) and (cols.min() < 0 or cols.max() >= n):
        raise ValueError(f"col indices must be in [0, {n}), got [{cols.min()}, {cols.max()}]")
    order = np.argsort(rows, kind="stable")
    rows_s, cols_s, vals_s = rows[order], cols[order], np.asarray(vals)[order]
    counts = np.bincount(rows_s, minlength=n) if len(rows) else np.zeros(n, np.int64)
    k = int(counts.max()) if len(rows) else 1
    ell_cols = np.zeros((n, max(k, 1)), np.int32)
    ell_vals = np.zeros((n, max(k, 1)), np.float32)
    if len(rows):
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(len(rows_s)) - starts[rows_s]  # position within the row
        ell_cols[rows_s, slot] = cols_s
        ell_vals[rows_s, slot] = vals_s
    return torch.from_numpy(ell_cols).to(dev), torch.from_numpy(ell_vals).to(dev)


def add_matvec(*matvecs):
    """Operator sum: the matvec of ``A₁ + A₂ + …`` from the constituent
    matvecs.  Sums of positive (or nonnegative, per the sparse contract)
    operators are positive: sparse + rank-one teleportation is the PageRank
    operator (examples/pagerank.py)."""
    if not matvecs:
        raise ValueError("need at least one matvec")

    def matvec(x: torch.Tensor) -> torch.Tensor:
        y = matvecs[0](x)
        for mv in matvecs[1:]:
            y = y + mv(x)
        return y

    return matvec


def scale_matvec(matvec, alpha: float):
    """Operator scaling: the matvec of ``α·A`` (α > 0 preserves positivity
    and scales λ_max by exactly α with the eigenvector unchanged; a
    normalization for operators whose λ is large against the absolute
    stop)."""
    if alpha <= 0:
        raise ValueError(f"alpha must be > 0 to preserve positivity, got {alpha}")

    def scaled(x: torch.Tensor) -> torch.Tensor:
        return alpha * matvec(x)

    return scaled


def kron_matvec(B, C, device=None):
    """Matvec closure for the Kronecker product ``A = B ⊗ C`` (B p×p, C q×q,
    A n×n with n = p·q), never materialized.

    With x viewed row-major as the p×q matrix X (``x[i·q + j] = X[i,j]``),
    ``(B ⊗ C) x = vec(B X Cᵀ)``: two dense matmuls in true float32,
    O(pq(p+q)) operations against the dense pass's O(p²q²).  B, C positive
    ⇒ A positive, and λ_max(A) = λ_max(B)·λ_max(C).
    """
    p, p2 = B.shape
    q, q2 = C.shape
    if p != p2 or q != q2:
        raise ValueError(f"need square factors, got {tuple(B.shape)} and {tuple(C.shape)}")
    dev = solve_device(device, B, C)
    B, C = _tensor(B, dev), _tensor(C, dev)
    Ct = C.T

    def matvec(x: torch.Tensor) -> torch.Tensor:
        X = x.reshape(p, q)
        # true f32: at λ = λ_B·λ_C (10²–10³ for random positive factors) a
        # TF32 product leaves row-sum noise far above the absolute stop
        Y = _matmul_f32(_matmul_f32(B, X), Ct)
        return Y.reshape(-1).to(x.dtype)

    return matvec
