"""Device timing on an NVIDIA GPU with CUDA events, and the least time
the card could take for a piece of work (its roofline bound).

Used by ``chip_smoke.py`` and ``ffpic_tpu_torch.tune_unpack_tile``.
The peaks are the NVIDIA H100 SXM's, valid at its full 700 W power
limit: memory, f32 and bf16 (dense, tensor cores) from the data sheet;
int32 and f64 from the CUDA C++ programming guide's throughput table
for compute capability 9.0 (64 int32 and 64 f64 multiply-adds per clock
per SM, half the 128 f32 lanes) over the 132 SMs at the SM's maximum
clock of 1,980 MHz (``nvidia-smi --query-gpu=clocks.max.sm``; the data
sheet gives 34 TFLOP/s f64 outside the tensor cores); f64 on the tensor
cores (mma.m16n8k16 .f64) at 128 multiply-adds per clock per SM over the
same SMs and clock, 66.9 T, the data sheet's 67 TFLOP/s (``python3 -m
ffpic_tpu_torch.compare_kernels --tree . --kernels fp64`` measures 127.7
a clock an SM).  A multiply-add counts as 2 operations in every rate.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12                   # device memory
F32_OPS_PER_S = 67e12                       # f32 outside the tensor cores
INT32_OPS_PER_S = 64 * 132 * 1.98e9 * 2     # 33.45e12
F64_OPS_PER_S = 64 * 132 * 1.98e9 * 2       # 33.45e12
F64_TC_OPS_PER_S = 128 * 132 * 1.98e9 * 2   # 66.9e12, f64 tensor cores
BF16_OPS_PER_S = 989e12                     # dense, tensor cores


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


def bound(nbytes: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    """Least time in ms for the card to move ``nbytes`` and do ``ops``
    operations at ``ops_per_s`` (``F32_OPS_PER_S``, ``INT32_OPS_PER_S``,
    ``F64_OPS_PER_S``, or ``F64_TC_OPS_PER_S`` where the f64 work runs on
    the tensor cores, whichever type the work is in), and which of
    the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
