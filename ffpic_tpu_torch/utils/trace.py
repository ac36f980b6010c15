"""Stage tracing for the port.

Host stages reuse ``ffpic_tpu.utils.trace`` (perf_counter spans,
aggregated per name; ``enable``/``report``/``reset``), which has no
framework in it.  Device work is annotated with NVTX ranges, which
``torch.profiler`` traces show beside the kernels.
"""

from __future__ import annotations

import contextlib

import torch

from ffpic_tpu.utils.trace import enable, report, reset, stage

__all__ = ["device_trace", "enable", "report", "reset", "stage"]


@contextlib.contextmanager
def device_trace(name: str, device: torch.device):
    """NVTX range around device work on a CUDA device; a no-op on the
    CPU, where there is no NVTX."""
    if device.type != "cuda":
        yield
        return
    with torch.cuda.nvtx.range(name):
        yield
