"""ctypes wrappers of the CUDA kernels in ``csrc/resize.cu``: K16
``resize_rgba`` and K17 ``normalize_resize``.

As in ``ops.cuda_png``: each wrapper takes CUDA tensors only, checks
device, dtype, shape and layout and raises on anything else, allocates
its output with ``torch.empty``, launches on the current stream and
raises if the launch reports an error, without synchronising.
``launches`` counts each kernel's launches.  The plain PyTorch versions
live in ``ops.resize``; the kernels never run on the CPU.  The taps of
each axis are ``ops.resize.taps``, cached there on the device.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ffpic_tpu_torch.ops import _build
from ffpic_tpu_torch.ops.resize import MEAN, STD, taps

launches = {"resize_rgba": 0, "normalize_resize": 0}

_vp = ctypes.c_void_p
_int = ctypes.c_int
_i64 = ctypes.c_longlong
_AXES = [_vp, _vp, _vp, _int] * 2
_SIGNATURES = {
    "ffpic_resize_rgba": [_vp, _i64, _i64, _int, _vp, _int, _int, _int,
                          _int, _int, *_AXES],
    "ffpic_normalize_resize": [_vp, _i64, _i64, _int, _vp, _int, _int, _int,
                               _int, _int, *_AXES, _vp, _vp],
}
_launch = _build.launcher(_SIGNATURES, launches)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _images(img: torch.Tensor, name: str, min_c: int):
    """``img`` as (N, H, W, C) uint8 on CUDA whose pixels are contiguous
    (any row and image pitch, so a crop of a larger decode needs no copy):
    (tensor, N, H, W, C, image pitch, row pitch)."""
    if not isinstance(img, torch.Tensor) or img.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got "
                         f"{getattr(img, 'device', type(img))}")
    if img.dtype != torch.uint8 or img.dim() < 3 or img.shape[-1] < min_c:
        raise ValueError(f"{name}: expected (..., H, W, C>={min_c}) uint8, "
                         f"got {img.dtype} {tuple(img.shape)}")
    if img.dim() == 3:
        img = img[None]
    elif img.dim() > 4:
        img = img.reshape(-1, *img.shape[-3:])
    n, h, w, c = img.shape
    if img.stride(-1) != 1 or (w > 1 and img.stride(-2) != c):
        img = img.contiguous()
    if n > 65535 or max(h, w) >= 2 ** 31:
        raise ValueError(f"{name}: {tuple(img.shape)} too large for one "
                         "launch")
    return img, n, h, w, c, img.stride(0), img.stride(1)


def _axis_args(in_size: int, out_size: int, device) -> list:
    """The taps of one axis as launch arguments; nulls when the axis
    keeps its size (the kernel skips it)."""
    if in_size == out_size:
        return [None, None, None, 0]
    start, count, wts = taps(in_size, out_size, device)
    return [_vp(start.data_ptr()), _vp(count.data_ptr()),
            _vp(wts.data_ptr()), wts.shape[1]]


def _checked(size):
    h, w = (int(s) for s in size)
    if h <= 0 or w <= 0:
        raise ValueError(f"size {size}: both sides must be positive")
    return h, w


def resize_rgba(img: torch.Tensor, size) -> torch.Tensor:
    """K16: (..., H, W, C) uint8 -> (..., h, w, C) uint8, bilinear with
    antialiasing (``ops.resize.resize_rgba_plain``)."""
    lead = img.shape[:-3] if isinstance(img, torch.Tensor) else ()
    x, n, hi, wi, c, img_pitch, row_pitch = _images(img, "resize_rgba", 1)
    h, w = _checked(size)
    out = torch.empty((n, h, w, c), dtype=torch.uint8, device=x.device)
    if n:
        _launch("ffpic_resize_rgba", "resize_rgba", _vp(x.data_ptr()),
                img_pitch, row_pitch, c, _vp(out.data_ptr()), n, hi, wi, h, w,
                *_axis_args(hi, h, x.device), *_axis_args(wi, w, x.device))
    return out.view(*lead, h, w, c)


def normalize_resize(batch: torch.Tensor, size=None, mean=MEAN,
                     std=STD) -> torch.Tensor:
    """K17: (..., H, W, C>=3) uint8 RGBA -> (..., h, w, 3) f32: rgb / 255,
    the resize to ``size`` when given, then (x - mean) / std in one pass
    (``ops.resize.normalize_plain``)."""
    lead = batch.shape[:-3] if isinstance(batch, torch.Tensor) else ()
    x, n, hi, wi, c, img_pitch, row_pitch = _images(batch, "normalize_resize",
                                                    3)
    h, w = (hi, wi) if size is None else _checked(size)
    m = np.ascontiguousarray(mean, np.float32)
    s = np.ascontiguousarray(std, np.float32)
    if m.shape != (3,) or s.shape != (3,):
        raise ValueError(f"mean {m.shape} / std {s.shape}: expected 3 each")
    out = torch.empty((n, h, w, 3), dtype=torch.float32, device=x.device)
    if n:
        _launch("ffpic_normalize_resize", "normalize_resize",
                _vp(x.data_ptr()), img_pitch, row_pitch, c,
                _vp(out.data_ptr()), n, hi, wi, h, w,
                *_axis_args(hi, h, x.device), *_axis_args(wi, w, x.device),
                _vp(m.ctypes.data), _vp(s.ctypes.data))
    return out.view(*lead, h, w, 3)
