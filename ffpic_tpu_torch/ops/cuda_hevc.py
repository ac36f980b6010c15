"""ctypes wrappers of the CUDA kernels in ``csrc/hevc_decode.cu``: K14
``hevc_residuals`` and K15 ``hevc_yuv_to_rgba``.

As in ``ops.cuda_vp8``: each wrapper takes CUDA tensors only, checks
device, dtype, shape and layout and raises on anything else, allocates
its output with ``torch.empty`` (K15 writes into a canvas it is given),
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

launches = {"hevc_residuals": 0, "hevc_yuv_to_rgba": 0}

_vp = ctypes.c_void_p
_int = ctypes.c_int
_i64 = ctypes.c_longlong
_SIGNATURES = {
    "ffpic_hevc_residuals": [_vp, _vp, _vp, _vp, _int, _int],
    "ffpic_hevc_yuv_to_rgba": [_vp, _i64, _vp, _i64, _vp, _i64, _vp, _i64,
                               _int, _int, _int],
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


def _plane16(t, name: str, rows: int, cols: int) -> None:
    """A 2-D int16 CUDA plane of at least ``rows`` x ``cols`` whose rows
    are contiguous, at any pitch."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got "
                         f"{getattr(t, 'device', type(t))}")
    if t.dtype != torch.int16 or t.dim() != 2:
        raise ValueError(f"{name}: expected 2-D int16, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if t.shape[0] < rows or t.shape[1] < cols:
        raise ValueError(f"{name} {tuple(t.shape)}: needs at least {rows} "
                         f"rows of {cols}")
    if t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{name}: each row must be contiguous")


def hevc_yuv_to_rgba(Y: torch.Tensor, U: torch.Tensor | None,
                     V: torch.Tensor | None, out_h: int, out_w: int,
                     mode: str = "bt601", out: torch.Tensor | None = None,
                     y0: int = 0, x0: int = 0) -> torch.Tensor:
    """K15: int16 Y (>= out_h, >= out_w) and U, V (>= (out_h + 1) // 2,
    >= (out_w + 1) // 2), or both None for 4:0:0, at any row pitch ->
    RGBA uint8: a new (out_h, out_w, 4) tensor, or, with ``out`` (a
    contiguous (CH, CW, 4) uint8 canvas), the part that fits written at
    row ``y0``, column ``x0`` and ``out`` returned.  ``mode``:
    "reference", "bt601" or "rgb".  A thread per pixel."""
    if mode not in _MODES:
        raise ValueError(f"mode {mode!r}: expected one of {list(_MODES)}")
    if (U is None) != (V is None):
        raise ValueError("U and V: both planes or neither")
    if out is None:
        h, w = out_h, out_w
        _plane16(Y, "Y", h, w)
        out = torch.empty((h, w, 4), dtype=torch.uint8, device=Y.device)
        y0 = x0 = 0
    else:
        if out.dim() != 3 or out.shape[2] != 4:
            raise ValueError(f"out: expected (CH, CW, 4), got "
                             f"{tuple(out.shape)}")
        _cuda(out, "out", torch.uint8)
        if not (0 <= y0 < out.shape[0] and 0 <= x0 < out.shape[1]):
            raise ValueError(f"offset ({y0}, {x0}) outside the canvas "
                             f"{tuple(out.shape[:2])}")
        h = min(out_h, out.shape[0] - y0)
        w = min(out_w, out.shape[1] - x0)
        _plane16(Y, "Y", h, w)
    if U is not None:
        _plane16(U, "U", (h + 1) // 2, (w + 1) // 2)
        _plane16(V, "V", (h + 1) // 2, (w + 1) // 2)
    if len({t.device for t in (Y, U, V, out) if t is not None}) != 1:
        raise ValueError("Y, U, V and out must share a device")
    if h <= 0 or w <= 0:
        return out
    if (h + 7) // 8 > 65535 or w >= 2 ** 31:
        raise ValueError(f"{w}x{h}: too large for one launch")
    start = out[y0, x0]
    _launch("ffpic_hevc_yuv_to_rgba", "hevc_yuv_to_rgba",
            _vp(Y.data_ptr()), Y.stride(0),
            _vp(None if U is None else U.data_ptr()),
            0 if U is None else U.stride(0),
            _vp(None if V is None else V.data_ptr()),
            0 if V is None else V.stride(0),
            _vp(start.data_ptr()), out.shape[1], h, w, _MODES[mode])
    return out
