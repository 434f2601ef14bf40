"""Solver configuration, with the same field names and backend strings as
``eigen_value_tpu.config`` so that one config means the same thing in both
packages.

The reference's two compile-time knobs (``EPS = 1e-3``, ``MAX_ITR = 1000``,
reference ``include/similarity_transform.hpp:4-5``) keep their values.
``dtype`` is a torch dtype here.  Backend strings keep their names; on
this side ``_pallas`` means "the hand-written kernel" (CUDA C++ for
Hopper), so ``"matvec_pallas"`` is the loop over the port's matvec kernel
and ``"pallas"`` the iterated solve over its ``rowsum`` and ``scale_rowsum``
kernels; ``"xla"`` means plain PyTorch.

CONSISTENCY CONTRACT (as in the JAX package): every entry point either
honors a knob or rejects it with a ValueError; nothing is silently dropped.
The knobs this port does not implement yet are rejected at solve time by
``api.route``, each naming its ROADMAP item.  Construction checks the
same fields as the JAX config, so a config is valid in both packages or in
neither (float64 aside: JAX needs x64 mode for it, the port does not).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

#: Convergence tolerance — reference include/similarity_transform.hpp:4.
EPS: float = 1e-3
#: Iteration cap — reference include/similarity_transform.hpp:5.
MAX_ITR: int = 1000

BACKENDS = ("auto", "xla", "pallas", "matvec", "matvec_pallas", "multiround")


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """All knobs of the similarity-transform solver.

    Attributes:
      eps: tolerance on adjacent row-sum differences (wraparound pair
        included).
      max_itr: iteration cap.
      eps_mode: "absolute" (reference-exact, tol = eps) or "relative"
        (tol = eps * max|v|).
      dtype: matrix and state dtype.  The kernels take float32: under
        "auto" any other dtype (float64, say) takes the plain "matvec" loop
        on every device, and the kernel backends ("matvec_pallas",
        "multiround", "pallas") reject it.
      backend: "auto" | "xla" | "pallas" | "matvec" | "matvec_pallas" |
        "multiround".
          * "xla": the iterated (mutate-A) form in plain PyTorch: row sums
            once, then every round ``A' = A·((1/v_r)·v_c)`` and its row
            sums.  Twice the bytes of the power form per round; kept
            because it is the reference's own structure.
          * "pallas": the same loop over the hand-written kernels
            (csrc/rowsum.cu, csrc/scale.cu), one read and one write of A
            per round; absolute stop only.  Neither takes
            ``storage_dtype``, ``chunk``, ``cache_tiles`` or ``symmetric``.
            The caller's matrix is not written: the rounds rewrite a
            second buffer (peak memory 2 × A).
          * "matvec": power-form loop with ``torch.mv`` in true f32.
          * "matvec_pallas": the same loop over the hand-written matvec
            kernel (csrc/matvec.cu).
          * "multiround": up to ``chunk`` rounds per launch of a persistent
            kernel: the stripes kernel (csrc/multiround.cu), or the tiled
            triangle kernel (csrc/multiround_sym.cu) for ``symmetric=True``
            or an explicit ``cache_tiles > 0``.
        "auto" picks, for a matrix on a CUDA device, "multiround" (the
        triangle kernel when ``symmetric`` is declared and n has a
        128-aligned square tile, else the stripes kernel while its ev copy
        fits shared memory), else "matvec_pallas"; "matvec" for a matrix
        on the CPU.
      block_rows: the tiled kernel's square tile edge (default
        ``kernels.SYM_TILE`` = 128); rejected wherever the tiled kernel
        does not run (the other kernels give each row to one warp).
      block_cols / interpret: TPU tile and interpret knobs.  The port
        decides between kernel and plain version by the tensor's device,
        so any non-None value is rejected.
      storage_dtype: reduced-precision storage of A (``torch.bfloat16`` or
        ``torch.float16``) for "matvec", "matvec_pallas" and "multiround"
        (and "auto"); "xla" and "pallas" reject it.  A is cast once (a
        matrix already in this dtype is solved as it is, with no f32 copy);
        the kernels read it in 2 bytes, convert each element to f32 exactly
        and multiply it with the f32 ev, summing in the f32 order; all O(n)
        state is f32.  The result is the f32 solve of the quantized matrix,
        bit for bit on the kernels, so it agrees with the f32 solve of A
        within the quantization (±1 round; hold it against ``A_q``).  The
        JAX package's one-chip ``solve_matvec_storage`` divides by a
        quantized ev instead; the port keeps its kernels' contract on every
        path.  Halves the bytes a round reads, and the triangle kernel's
        auto cache holds twice the tiles.
      chunk: rounds per launch for "multiround" (None = the whole budget
        in one launch; the kernel leaves its loop once frozen).
      symmetric: declares A bitwise symmetric.  With "multiround", or under
        "auto" on a card at a sym-tileable n, the triangle kernel reads only
        the upper block triangle (a wrong declaration gives a wrong
        answer; ``validate=True`` checks it).  Elsewhere under "auto" it is
        consumed by the dense solve (identical results).
      cache_tiles: tiles the tiled kernel keeps resident in shared memory
        across a launch's rounds.  None = the card's budget for the
        triangle kernel (``device.sym_auto_cache_tiles``) and no tiled
        kernel for a dense matrix; 0 = streaming; > 0 without
        ``symmetric`` = the dense tiled kernel with that cache.  A request
        the card cannot hold is rejected.
    """

    eps: float = EPS
    max_itr: int = MAX_ITR
    eps_mode: str = "absolute"
    dtype: Any = torch.float32
    backend: str = "auto"
    block_rows: Optional[int] = None
    block_cols: Optional[int] = None
    interpret: Optional[bool] = None
    storage_dtype: Optional[Any] = None
    chunk: Optional[int] = None
    symmetric: bool = False
    cache_tiles: Optional[int] = None

    def __post_init__(self) -> None:
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.chunk is not None and self.chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {self.chunk}")
        if self.max_itr < 0:
            raise ValueError("max_itr must be >= 0")
        if self.eps <= 0:
            raise ValueError("eps must be > 0")
        if self.cache_tiles is not None and self.cache_tiles < 0:
            raise ValueError(f"cache_tiles must be >= 0, got {self.cache_tiles}")
        if self.eps_mode not in ("absolute", "relative"):
            raise ValueError(
                f"eps_mode must be 'absolute' or 'relative', got {self.eps_mode!r}"
            )
        if not isinstance(self.dtype, torch.dtype) or not self.dtype.is_floating_point:
            raise ValueError(f"dtype must be a torch floating dtype, got {self.dtype!r}")
        # the JAX config's tile checks (its Mosaic tiling), so one config is
        # valid in both packages or in neither
        if self.block_cols is not None and (self.block_cols < 128 or self.block_cols % 128):
            raise ValueError(
                f"block_cols must be a positive multiple of 128, got {self.block_cols}"
            )
        if self.block_rows is not None and (self.block_rows < 8 or self.block_rows % 8):
            raise ValueError(
                f"block_rows must be a positive multiple of 8, got {self.block_rows}"
            )


DEFAULT_CONFIG = SolverConfig()
