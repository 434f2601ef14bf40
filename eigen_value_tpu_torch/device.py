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
#: Warps of one block of the triangle kernel, each with bt floats of column
#: sums in shared memory (csrc/multiround_sym.cu, kWarps).
_SYM_WARPS = 32


class CudaLimits(NamedTuple):
    sms: int
    smem_per_block_optin: int


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


@functools.lru_cache(maxsize=None)
def cuda_limits(device: torch.device) -> CudaLimits:
    p = torch.cuda.get_device_properties(device)
    return CudaLimits(p.multi_processor_count, p.shared_memory_per_block_optin)


def multiround_fits(n: int, device: torch.device) -> bool:
    """Whether the multiround kernel's shared-memory copy of ev (n floats)
    fits one block on this card — its own limit, in place of the TPU's
    VMEM budget.  227 KB on an H100 allows n up to 57856."""
    return 4 * n + _MULTIROUND_STATIC_SMEM <= cuda_limits(device).smem_per_block_optin


def sym_smem_bytes(n: int, bt: int, slots: int = 0) -> int:
    """Dynamic shared memory of one block of the triangle kernel
    (csrc/multiround_sym.cu ``smem_bytes``): ev (n floats), each warp's
    column sums (bt floats a warp) and ``slots`` resident bt x bt tiles."""
    return 4 * (n + _SYM_WARPS * bt + slots * bt * bt)


def multiround_sym_fits(n: int, bt: int, device: torch.device, slots: int = 0) -> bool:
    """Whether one block of the triangle kernel, with ``slots`` resident
    tiles, fits the card's shared memory."""
    need = sym_smem_bytes(n, bt, slots) + _MULTIROUND_STATIC_SMEM
    return need <= cuda_limits(device).smem_per_block_optin


def sym_auto_cache_tiles(n: int, bt: int, device: torch.device, sym: bool = True) -> int:
    """The largest resident tile cache the triangle kernel can hold at
    (n, bt) on ``device``: as many bt x bt tiles as fit one block's shared
    memory beside its own state, times the kernel's co-resident grid (one
    block per SM once the cache fills the block), capped at the cacheable
    count — g(g-1)/2 off-diagonal tiles for the symmetric kernel, g^2 - 1
    for the dense tiled one (one tile must stream).  0 when one tile does
    not fit, and on the CPU, where the plain version keeps nothing
    resident.  (The JAX package sizes its cache from the v5e's VMEM; the
    budget here is the card's own.)"""
    if device.type != "cuda":
        return 0
    lim = cuda_limits(device)
    free = lim.smem_per_block_optin - _MULTIROUND_STATIC_SMEM - sym_smem_bytes(n, bt)
    slots = max(0, free // (4 * bt * bt))
    g = n // bt
    cap = g * (g - 1) // 2 if sym else g * g - 1
    return max(0, min(slots * lim.sms, cap))
