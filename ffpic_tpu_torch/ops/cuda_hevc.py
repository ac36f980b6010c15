"""ctypes wrappers of the CUDA kernels in ``csrc/hevc_decode.cu``: K14
``hevc_residuals`` and K15 ``hevc_yuv_to_rgba``.

As in ``ops.cuda_vp8``: each wrapper takes CUDA tensors only, checks
device, dtype, shape and layout and raises on anything else, allocates
its output with ``torch.empty`` (K15 writes every pixel of it),
launches on the current stream and raises if the launch reports an
error, without synchronising.  ``launches`` counts each kernel's
launches.  The plain PyTorch versions live in ``ops.hevc_kernels``; the
kernels never run on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from ffpic_tpu_torch.ops import _build
from ffpic_tpu_torch.ops.cuda_vp8 import _cuda
from ffpic_tpu_torch.ops.hevc_kernels import StagedTiles

launches = {"hevc_residuals": 0, "hevc_yuv_to_rgba": 0}

_vp = ctypes.c_void_p
_int = ctypes.c_int
_SIGNATURES = {
    "ffpic_hevc_residuals": [_vp, _vp, _vp, _vp, _int, _int],
    "ffpic_hevc_yuv_to_rgba": [_vp, _vp, _vp, _vp, _vp, _int, _vp, _int,
                               _int, _int],
}
_launch = _build.launcher(_SIGNATURES, launches)
_MODES = {"reference": 0, "bt601": 1, "rgb": 2}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def hevc_residuals(levels: torch.Tensor, bit_depth: int, desc: torch.Tensor,
                   ctas: torch.Tensor) -> torch.Tensor:
    """K14: ``levels`` int16 (exactly the TUs' n² sum) and the launch
    plan of ``hevc_kernels.plan_residuals`` (``desc`` (m, 2) int32, one
    row a TU, largest first; ``ctas`` (k, 4) int32) -> int16 residuals,
    one per level; a CTA of 128 threads per row of ``ctas``, a TU of n
    points on n lanes.  The plan and the level count are trusted as the
    route made them (checking them here would read the device): the
    kernel reads and writes where the plan points."""
    if desc.dim() != 2:
        raise ValueError(f"desc: expected (m, 2), got {tuple(desc.shape)}")
    _cuda(desc, "desc", torch.int32, (desc.shape[0], 2))
    if ctas.dim() != 2:
        raise ValueError(f"ctas: expected (k, 4), got {tuple(ctas.shape)}")
    k = ctas.shape[0]
    _cuda(ctas, "ctas", torch.int32, (k, 4))
    if levels.dim() != 1:
        raise ValueError(f"levels: expected 1-D, got {tuple(levels.shape)}")
    _cuda(levels, "levels", torch.int16)
    if len({t.device for t in (desc, ctas, levels)}) != 1:
        raise ValueError("the plan and levels must share a device")
    if bit_depth not in range(8, 15):
        raise ValueError(f"bit depth {bit_depth}: K14 takes 8 to 14")
    if k >= 2 ** 31:
        raise ValueError(f"{k} CTAs: too many for one launch")
    if any(t.data_ptr() % 16 for t in (desc, ctas, levels)):
        raise ValueError("desc, ctas and levels must be 16-byte aligned")
    out = torch.empty_like(levels)
    if k:
        _launch("ffpic_hevc_residuals", "hevc_residuals",
                _vp(desc.data_ptr()), _vp(ctas.data_ptr()),
                _vp(levels.data_ptr()), _vp(out.data_ptr()), k, bit_depth)
    return out


def hevc_yuv_to_rgba(st: StagedTiles, mode: str = "bt601") -> torch.Tensor:
    """K15: every tile of a picture, as ``hevc_kernels.stage_tiles``
    staged it (its planes, descriptors and cells in one int16 buffer on
    the device) -> a new (H, W, 4) RGBA uint8 canvas, every pixel
    written once: a tile's colour where one covers it (the last in paste
    order), (0, 0, 0, 255) elsewhere.  ``mode``: "reference", "bt601" or
    "rgb".  A thread per four pixels of a row.  Only ``stage_tiles``
    makes a ``StagedTiles``, so the kernel trusts its index (checking it
    here would read the device)."""
    if not isinstance(st, StagedTiles):
        raise ValueError(f"expected StagedTiles, got {type(st).__name__}")
    if mode not in _MODES:
        raise ValueError(f"mode {mode!r}: expected one of {list(_MODES)}")
    _cuda(st.planes, "planes", torch.int16)
    h, w = len(st.row_cell), len(st.col_cell)
    if not h <= 4 * 65535:
        raise ValueError(f"canvas {h}x{w}: too tall for one launch")
    out = torch.empty((h, w, 4), dtype=torch.uint8, device=st.planes.device)
    _launch("ffpic_hevc_yuv_to_rgba", "hevc_yuv_to_rgba",
            _vp(st.planes.data_ptr()), _vp(st.desc.data_ptr()),
            _vp(st.row_cell.data_ptr()), _vp(st.col_cell.data_ptr()),
            _vp(st.cell_map.data_ptr()), st.cell_map.shape[1],
            _vp(out.data_ptr()), h, w, _MODES[mode])
    return out
