"""Device timing on an NVIDIA GPU with CUDA events, and the least time
the card could take for a piece of work (its roofline bound).

Used by ``chip_smoke.py`` and ``ffpic_tpu_torch.tune_unpack_tile``.
The peaks are the NVIDIA H100 SXM data sheet's, valid at its full 700 W
power limit.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
SCALAR_OPS_PER_S = 67e12      # H100 SXM f32 outside the tensor cores,
#                               also taken for int32 operations


def gpu_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms, warm: CUDA events around
    ``iters`` calls queued behind a spin kernel, so the card runs them
    back to back however slowly the host enqueues them."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def gpu_ms_cold(fn, iters: int, flush) -> float:
    """Mean device time of ``fn()`` in ms right after ``flush`` (a
    buffer twice the 50 MB L2) was overwritten, so its inputs come from
    device memory; each call timed alone by CUDA events, behind a spin
    kernel."""
    fn()
    total = 0.0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(iters):
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000)
        flush.zero_()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time in ms for the card to move ``nbytes`` and do ``ops``
    scalar operations, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
