"""Stage tracing for the port.

Host stages are perf_counter spans aggregated per name (``stage``,
``enable``, ``report``, ``reset``), copied from
``ffpic_tpu/utils/trace.py``; tracing is off until ``enable()``.  Device
work is annotated with NVTX ranges (``device_trace``), which
``torch.profiler`` traces show beside the kernels.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

__all__ = ["device_trace", "enable", "report", "reset", "stage"]

_stats: dict[str, list[float]] = defaultdict(list)
_enabled = False


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


@contextlib.contextmanager
def stage(name: str):
    """Time a host-side pipeline stage."""
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _stats[name].append(time.perf_counter() - t0)


def report() -> dict:
    """Per-stage aggregate: count, total, mean (seconds)."""
    return {k: dict(count=len(v), total=sum(v), mean=sum(v) / len(v))
            for k, v in _stats.items() if v}


def reset() -> None:
    _stats.clear()


@contextlib.contextmanager
def device_trace(name: str, device: torch.device):
    """NVTX range around device work on a CUDA device; a no-op on the
    CPU, where there is no NVTX."""
    if device.type != "cuda":
        yield
        return
    with torch.cuda.nvtx.range(name):
        yield
