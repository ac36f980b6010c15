"""Where the port's entry points run, and the host-to-device copy they
stage their inputs with.

``device=None`` means CUDA and raises without it; ``"cpu"`` runs the
plain PyTorch versions of the kernels.  Used by ``decode_batch`` and by
the registry's ``load``/``load_all``/``encode``.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device, caller: str) -> torch.device:
    """``device`` as a ``torch.device``: None is CUDA, which must be
    available; only "cuda" and "cpu" devices are taken."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"{caller}: CUDA is not available; pass "
                               "device='cpu' to run the plain versions")
        return torch.device("cuda")
    d = torch.device(device)
    if d.type not in ("cuda", "cpu"):
        raise ValueError(f"{caller}: unsupported device {d}")
    return d


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device``; a CUDA copy goes through
    pinned memory without blocking the host.  On the CPU the tensor
    shares the array's memory, or a copy's when the array is read-only
    (a view of ``bytes``, which torch will not share)."""
    if not arr.flags.writeable:
        if device.type != "cuda":
            return torch.from_numpy(arr.copy())
        dtype = torch.from_numpy(np.zeros(0, arr.dtype)).dtype
        pinned = torch.empty(arr.shape, dtype=dtype, pin_memory=True)
        pinned.numpy()[...] = arr
        return pinned.to(device, non_blocking=True)
    host = torch.from_numpy(arr)
    if device.type != "cuda":
        return host
    pinned = torch.empty_like(host, pin_memory=True)
    pinned.copy_(host)
    return pinned.to(device, non_blocking=True)
