"""Where a solve runs, and what the card allows the kernels.

The device is the tensor's: a CUDA tensor runs the hand-written kernels, a
CPU tensor runs their plain PyTorch versions.  The kernels' limits are read
from the card (``torch.cuda.get_device_properties``), never assumed.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

#: Static shared memory of the multiround kernels beyond their dynamic
#: share (two small reduction arrays), rounded up.
_MULTIROUND_STATIC_SMEM = 1024
#: Warps of one block of the stripes kernel (csrc/prologue.cuh, kWarps).
_WARPS = 32
#: Warps of one block of the triangle kernel (csrc/multiround_sym.cu, kWarps).
_SYM_WARPS = 16
#: The triangle kernel cuts its tiles into 32-row work items when the card
#: has fewer than this many tiles a block: a block has sixteen warps, and
#: with fewer tiles a warp per tile leaves warps without work.
_SYM_SPLIT_BELOW = 12
#: Bulk-copy ring stages a warp of each persistent kernel keeps, by A's
#: element size (csrc/multiround.cu, csrc/multiround_sym.cu): the streamed
#: part of A lands in shared memory by bulk copies, the next round's first
#: stages across the grid barrier; 0 reads it into registers.  Measured at
#: 8192² on an H100 (kernel_phases.py --rings; PERF.md): in bf16 the
#: stripes kernel gains 1% from one stage and the triangle 10% from two; in
#: f32 any ring loses (the stripes kernel 12%, the triangle 6%), so f32
#: keeps the register path.
STRIPES_RING = {2: 1, 4: 0}
SYM_RING = {2: 2, 4: 0}
#: Elements of A in one stage of the stripes kernel's ring (128 chunks of
#: four), and rows x columns of one stage of the triangle kernel's.
_STRIPES_STAGE = 512
_SYM_STAGE = 8 * 128


class CudaLimits(NamedTuple):
    sms: int
    smem_per_block_optin: int
    l2_bytes: int = 0


def tensor_device(*tensors: torch.Tensor) -> torch.device:
    """The one device all ``tensors`` live on; raises if they differ or the
    device is neither CPU nor CUDA."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    (dev,) = devs
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def solve_device(device=None, *inputs) -> torch.device:
    """Where work on ``inputs`` runs: ``device`` when given, else the device
    of the first tensor among ``inputs``, else the CUDA card.  Host input
    (numpy, lists, or nothing) has no device of its own and never runs on
    the CPU unasked: without a card this raises."""
    if device is not None:
        return torch.device(device)
    for t in inputs:
        if isinstance(t, torch.Tensor):
            return t.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "host input (not a torch.Tensor) is solved on the CUDA device and none is "
            "available; pass device='cpu' to solve on the CPU"
        )
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def cuda_limits(device: torch.device) -> CudaLimits:
    p = torch.cuda.get_device_properties(device)
    return CudaLimits(p.multi_processor_count, p.shared_memory_per_block_optin, p.L2_cache_size)


def l2_resident_bytes(device: torch.device, rest_bytes: int) -> int:
    """How much of A a persistent kernel asks the card's L2 to keep from one
    round to the next (``evict_last`` loads, everything else ``evict_first``),
    when ``rest_bytes`` of A lie outside its shared memory.  3/8 of the L2
    (19.7 MB of an H100's 50 MB) while most of those bytes must stream past
    the kept set every round: at 8192^2 a kept set of 17-22 MB came back from
    L2 in the next pass, one of 26 MB less often and one of 35 MB not at all.
    5/8 of the L2 once the rest is at most 3/4 of it: with little streaming
    by, 28-32 MB came back at 4096^2 and 37 MB did not."""
    l2 = cuda_limits(device).l2_bytes
    return l2 * 5 // 8 if rest_bytes <= l2 * 3 // 4 else l2 * 3 // 8


def stripes_ring_bytes(ring: int, itemsize: int) -> int:
    """Shared memory of the stripes kernel's ring: ``ring`` stages a warp
    of 512 elements (1 KB of bf16, 2 KB of f32) and an 8-byte mbarrier
    each, for its 32 warps."""
    return ring * _WARPS * (_STRIPES_STAGE * itemsize + 8)


def multiround_smem_bytes(n: int, resident: int = 0, itemsize: int = 4, ring: int = 0) -> int:
    """Dynamic shared memory of one block of the stripes kernel
    (csrc/multiround.cu ``smem_bytes``): ev (n floats), ``resident`` rows
    of A, n elements of ``itemsize`` bytes each (4, or 2 for bf16 / f16
    storage), and the ring's ``ring`` stages a warp."""
    return n * (4 + resident * itemsize) + stripes_ring_bytes(ring, itemsize)


def multiround_fits(n: int, device: torch.device) -> bool:
    """Whether the multiround kernel's shared-memory copy of ev (n floats)
    fits one block on this card — its own limit, in place of the TPU's
    VMEM budget.  227 KB on an H100 allows n up to 57856."""
    need = multiround_smem_bytes(n) + _MULTIROUND_STATIC_SMEM
    return need <= cuda_limits(device).smem_per_block_optin


class StripesPlan(NamedTuple):
    grid: int  # blocks, at most one per SM
    resident: int  # rows of A a block keeps in shared memory for the launch
    l2_rows: int  # streamed rows a block reads with the L2 evict_last policy
    ring: int = 0  # bulk-copy stages a warp for the streamed rows (0: registers)


def stripes_ring(n: int, device: torch.device, itemsize: int = 4) -> int:
    """Ring stages a warp of the stripes kernel at dimension n for A stored
    in ``itemsize`` bytes (``STRIPES_RING``): 0 where a row is not a whole
    number of 16-byte units (a bulk copy's), or where the ring does not fit
    beside ev."""
    depth = STRIPES_RING.get(itemsize, 0)
    if not depth or n % 4 or (n * itemsize) % 16:
        return 0
    need = multiround_smem_bytes(n, 0, itemsize, depth) + _MULTIROUND_STATIC_SMEM
    return depth if need <= cuda_limits(device).smem_per_block_optin else 0


def _stripes(n: int, device: torch.device, itemsize: int, ring: int) -> StripesPlan:
    lim = cuda_limits(device)
    row = itemsize * n
    free = (lim.smem_per_block_optin - _MULTIROUND_STATIC_SMEM
            - multiround_smem_bytes(n, 0, itemsize, ring))
    fit = max(0, free // row)
    want = -(-n // _WARPS)
    if fit:
        want = max(want, -(-n // fit))
    grid = max(1, min(lim.sms, want))
    per_block = -(-n // grid)
    resident = min(fit, per_block)
    keep = l2_resident_bytes(device, (n - min(n, grid * resident)) * row)
    l2_rows = min(per_block - resident, keep // (grid * row))
    return StripesPlan(grid, resident, l2_rows, ring)


def multiround_plan(
    n: int, device: torch.device, itemsize: int = 4, ring: bool = True
) -> StripesPlan:
    """How the stripes kernel spends the card at dimension n, for A stored
    in ``itemsize`` bytes an element.  Block b owns rows b, b + grid, ...;
    it keeps in shared memory as many of them as fit beside ev and the ring
    (6 f32 or 10 bf16 rows at n = 8192 on an H100, every f32 row at n <=
    2048, none past n = 28928 in f32), and asks the L2 to keep the next
    ``l2_rows`` (:func:`l2_resident_bytes` over the grid).  The grid gives
    every warp a row and, where rows fit, is large enough that every row is
    resident, up to one block per SM.  Where rows stream from device memory
    (past the resident rows and the L2 band), they go through
    :func:`stripes_ring` stages a warp, whose bytes are taken from the
    resident rows; where every row stays on the chip there is no ring (one
    stage a warp cost 15% at 4096² in bf16, where the ring only re-reads
    the L2).  ``ring=False`` plans the register path alone (the dot
    formulation has no ring instance): its rows take the ring's bytes."""
    plan = _stripes(n, device, itemsize, 0)
    depth = stripes_ring(n, device, itemsize) if ring else 0
    if depth and plan.grid * (plan.resident + plan.l2_rows) < n:
        plan = _stripes(n, device, itemsize, depth)
    return plan


def sym_ring_bytes(ring: int, itemsize: int) -> int:
    """Shared memory of the triangle kernel's ring: ``ring`` stages a warp
    of 8 rows x 128 columns (2 KB of bf16, 4 KB of f32) and an 8-byte
    mbarrier each, for its 16 warps, and 128 bytes to align the stages (a
    tensor copy's destination)."""
    return ring and 128 + ring * _SYM_WARPS * (_SYM_STAGE * itemsize + 8)


def sym_smem_bytes(
    n: int, bt: int, slots: int = 0, itemsize: int = 4, ring: int = 0, pipelined: bool = False
) -> int:
    """Dynamic shared memory of one block of the triangle kernel
    (csrc/multiround_sym.cu ``smem_bytes``): ev (n floats), ``slots``
    resident bt x bt tiles of ``itemsize``-byte elements, with the
    ``pipelined`` fill an 8-byte mbarrier a slot, and the ring's ``ring``
    stages a warp.  A tile's column sums stay in registers."""
    bars = 8 * slots if pipelined else 0
    return 4 * n + slots * bt * bt * itemsize + bars + sym_ring_bytes(ring, itemsize)


def multiround_sym_fits(
    n: int, bt: int, device: torch.device, slots: int = 0, itemsize: int = 4, ring: int = 0,
    pipelined: bool = False,
) -> bool:
    """Whether one block of the triangle kernel, with ``slots`` resident
    tiles (filled by bulk copies when ``pipelined``) and ``ring`` ring
    stages a warp, fits the card's shared memory."""
    need = sym_smem_bytes(n, bt, slots, itemsize, ring, pipelined) + _MULTIROUND_STATIC_SMEM
    return need <= cuda_limits(device).smem_per_block_optin


def sym_ring(n: int, bt: int, device: torch.device, itemsize: int = 4) -> int:
    """Ring stages a warp of the triangle kernel at (n, bt) for A stored in
    ``itemsize`` bytes (``SYM_RING``): every such launch streams tiles (the
    diagonal ones at least); 0 where the ring does not fit beside ev."""
    depth = SYM_RING.get(itemsize, 0)
    return depth if depth and multiround_sym_fits(n, bt, device, 0, itemsize, depth) else 0


def sym_auto_cache_tiles(
    n: int, bt: int, device: torch.device, sym: bool = True, itemsize: int = 4,
    ring: bool = True, pipelined: bool = False,
) -> int:
    """The largest resident tile cache the triangle kernel can hold at
    (n, bt) on ``device`` for A stored in ``itemsize`` bytes an element: as
    many bt x bt tiles as fit one block's shared memory beside ev and the
    ring (:func:`sym_ring`; three 64 KiB f32 tiles with no ring, or four
    32 KiB bf16 ones beside a 64 KiB ring, at n = 8192 on an H100),
    times the kernel's co-resident grid (one block per SM once the cache
    fills the block), capped at the cacheable count — g(g-1)/2 off-diagonal
    tiles for the symmetric kernel, g^2 - 1 for the dense tiled one (one
    tile must stream).  0 when one tile does not fit, and on the CPU, where
    the plain version keeps nothing resident.  (The JAX package sizes its
    cache from the v5e's VMEM, by the tile's itemsize as here; the budget
    here is the card's own.)  ``ring=False``: the budget of the register
    path alone (the dot formulation; six bf16 tiles a block at n = 8192).
    ``pipelined``: each tile also takes its fill's 8-byte mbarrier (the
    same count at n = 8192: 396 f32 tiles, 528 bf16 ones)."""
    if device.type != "cuda":
        return 0
    lim = cuda_limits(device)
    depth = sym_ring(n, bt, device, itemsize) if ring else 0
    free = (lim.smem_per_block_optin - _MULTIROUND_STATIC_SMEM
            - sym_smem_bytes(n, bt, 0, itemsize, depth))
    slots = max(0, free // (itemsize * bt * bt + (8 if pipelined else 0)))
    g = n // bt
    cap = g * (g - 1) // 2 if sym else g * g - 1
    return max(0, min(slots * lim.sms, cap))


def sym_split(n: int, bt: int, device: torch.device, sym: bool = True) -> int:
    """Work items a tile is cut into (by rows) in the triangle kernel: 1, or
    bt / 32 when the card has fewer than ``_SYM_SPLIT_BELOW`` tiles a block
    (n <= 6144 at bt = 128 on an H100's 132 SMs; 8192 keeps whole tiles, one
    for each of a block's sixteen warps).  The split depends on (n, bt, card)
    only, never on the cache or on A's storage type, so results depend on
    neither."""
    g = n // bt
    tiles = g * (g + 1) // 2 if sym else g * g
    return bt // 32 if tiles < _SYM_SPLIT_BELOW * cuda_limits(device).sms else 1


def sym_l2_tiles(bt: int, device: torch.device, streamed: int, itemsize: int = 4) -> int:
    """Streamed tiles the triangle kernel asks the L2 to keep: what fits
    :func:`l2_resident_bytes` (300 f32 tiles of 64 KiB on an H100 at 8192^2,
    500 once at most 600 stream; 600 bf16 tiles of 32 KiB), at most all of
    them."""
    tile = itemsize * bt * bt
    return min(streamed, l2_resident_bytes(device, streamed * tile) // tile)
