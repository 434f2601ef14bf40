"""Where a solve runs, and what the card allows the kernels.

The device is the tensor's: a CUDA tensor runs the hand-written kernels, a
CPU tensor runs their plain PyTorch versions.  The kernels' limits are read
from the card (``torch.cuda.get_device_properties``), never assumed.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

#: Static shared memory of the multiround kernel beyond its n-float ev copy
#: (two small reduction arrays), rounded up.
_MULTIROUND_STATIC_SMEM = 1024


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
