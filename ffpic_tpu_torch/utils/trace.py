"""Stage tracing for the port.

Host stages are perf_counter spans aggregated per name (``stage``,
``enable``, ``report``, ``reset``), copied from
``ffpic_tpu/utils/trace.py``; tracing is off until ``enable()``.  Device
work is annotated with NVTX ranges (``device_trace``), which
``torch.profiler`` traces show beside the kernels.  ``start_profiler``
and ``stop_profiler`` are the counterparts of the original's
(``ffpic_tpu/utils/trace.py:45-52``, ``jax.profiler``): a
``torch.profiler`` run over the host and, where a card is present, its
kernels, written as a Chrome trace into ``logdir``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict

import torch

__all__ = ["device_trace", "enable", "report", "reset", "stage",
           "start_profiler", "stop_profiler"]

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


_profiler = None          # (torch.profiler.profile, logdir) while running
_profiler_lock = threading.Lock()


def start_profiler(logdir: str = "/tmp/ffpic_trace") -> None:
    """Start a ``torch.profiler`` run: CPU activity, and CUDA activity
    when a card is present.  One run at a time; ``stop_profiler`` ends
    it and writes its trace into ``logdir``."""
    global _profiler
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with _profiler_lock:
        if _profiler is not None:
            raise RuntimeError("a profiler run is already in progress")
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        _profiler = (prof, logdir)


def stop_profiler() -> str:
    """Stop the run ``start_profiler`` began and write its Chrome trace
    into its ``logdir`` (made if missing); returns the trace's path.
    Without a run in progress it raises ``RuntimeError``, as
    ``jax.profiler.stop_trace`` does."""
    global _profiler
    with _profiler_lock:
        if _profiler is None:
            raise RuntimeError("no profiler run is in progress")
        prof, logdir = _profiler
        _profiler = None
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"ffpic_trace_{os.getpid()}_"
                                f"{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path
