"""ctypes wrappers of the CUDA kernels in ``csrc/vp8_decode.cu``: K12
``vp8_residuals``, K13 ``vp8_yuv_to_rgba`` and K18 ``vp8_wavefront``.

As in ``ops.cuda_jpeg``: each wrapper takes CUDA tensors only, checks
device, dtype, shape and layout and raises on anything else, allocates
its output with ``torch.empty``, launches on the current stream and
raises if the launch reports an error, without synchronising.
``launches`` counts each kernel's launches.  The plain PyTorch versions
live in ``ops.vp8_kernels`` (K18's in ``ops.vp8_wavefront``); the
kernels never run on the CPU.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ffpic_tpu_torch.ops import _build
from ffpic_tpu_torch.ops.vp8_kernels import batch_outputs

launches = {"vp8_residuals": 0, "vp8_yuv_to_rgba": 0, "vp8_wavefront": 0}

_vp = ctypes.c_void_p
_int = ctypes.c_int
_i64 = ctypes.c_longlong
_SIGNATURES = {
    "ffpic_vp8_residuals": [_vp, _vp, _vp, _vp, _i64, _vp],
    "ffpic_vp8_yuv_to_rgba": [_vp, _int],
    "ffpic_vp8_wavefront": [_vp, _vp, _vp, _vp, _vp, _int, _int],
}
_launch = _build.launcher(_SIGNATURES, launches)
FRAME_WORDS = 11         # vp8_decode.cu's ColorFrame: 88 bytes
MAX_FRAMES = 64          # vp8_decode.cu's kMaxFrames: frames a launch


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _typed(t, name: str, dtype: torch.dtype, shape: tuple | None = None):
    """A tensor of ``dtype`` (and ``shape``)."""
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name}: expected a CUDA tensor, got {type(t)}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")


def _on_card(t: torch.Tensor, name: str) -> None:
    """A contiguous tensor on a CUDA device."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _cuda(t, name: str, dtype: torch.dtype, shape: tuple | None = None):
    """A contiguous CUDA tensor of ``dtype`` (and ``shape``)."""
    _typed(t, name, dtype, shape)
    _on_card(t, name)


def _plane(t, name: str, rows: int, cols: int) -> None:
    """A 2-D uint8 CUDA plane of at least ``rows`` x ``cols`` whose rows
    are contiguous, at any pitch."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got "
                         f"{getattr(t, 'device', type(t))}")
    if t.dtype != torch.uint8 or t.dim() != 2:
        raise ValueError(f"{name}: expected 2-D uint8, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if t.shape[0] < rows or t.shape[1] < cols:
        raise ValueError(f"{name} {tuple(t.shape)}: needs at least {rows} "
                         f"rows of {cols}")
    if t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{name}: each row must be contiguous")


def vp8_residuals(levels: torch.Tensor, dq_per_mb: torch.Tensor,
                  has_y2: torch.Tensor) -> torch.Tensor:
    """K12: levels (mbh, mbw, 25, 16) int32, dq_per_mb (mbh, mbw, 6)
    int32 [y1dc, y1ac, y2dc, y2ac, uvdc, uvac], has_y2 (mbh, mbw) bool
    -> residuals (mbh, mbw, 24, 4, 4) int16; a thread per 4x4 block."""
    if levels.dim() != 4:
        raise ValueError(f"levels: expected (mbh, mbw, 25, 16), got "
                         f"{tuple(levels.shape)}")
    mbh, mbw = levels.shape[:2]
    _cuda(levels, "levels", torch.int32, (mbh, mbw, 25, 16))
    _cuda(dq_per_mb, "dq_per_mb", torch.int32, (mbh, mbw, 6))
    _cuda(has_y2, "has_y2", torch.bool, (mbh, mbw))
    if levels.device != dq_per_mb.device or levels.device != has_y2.device:
        raise ValueError("levels, dq_per_mb and has_y2 must share a device")
    if mbh * mbw * 24 >= 2 ** 31 * 256:
        raise ValueError(f"{mbw}x{mbh} macroblocks: too large for one launch")
    out = torch.empty((mbh, mbw, 24, 4, 4), dtype=torch.int16,
                      device=levels.device)
    if out.numel():
        _launch("ffpic_vp8_residuals", "vp8_residuals",
                _vp(levels.data_ptr()), _vp(dq_per_mb.data_ptr()),
                _vp(has_y2.data_ptr()), _vp(out.data_ptr()), mbh * mbw)
    return out


def frame_words(frames, outs) -> np.ndarray:
    """The descriptors of a K13 launch: (k, ``FRAME_WORDS``) int64, a row
    a frame of ``frames`` ((Y, U, V, h, w, alpha) CUDA planes) and its
    output of ``outs``: the addresses of Y, U, V, alpha (0 without) and
    the output, the four row pitches in bytes (alpha's 0 without), h | w
    << 32, and a word the launcher fills (the frame's first tile and its
    tiles across); ``vp8_decode.cu``'s ``ColorFrame``."""
    words = np.zeros((len(frames), FRAME_WORDS), np.int64)
    for k, ((Y, U, V, h, w, alpha), out) in enumerate(zip(frames, outs)):
        a = (alpha.data_ptr(), alpha.stride(0)) if alpha is not None \
            else (0, 0)
        words[k] = [Y.data_ptr(), U.data_ptr(), V.data_ptr(), a[0],
                    out.data_ptr(), Y.stride(0), U.stride(0), V.stride(0),
                    a[1], h | w << 32, 0]
    return words


def _frame(frame, k: int) -> tuple:
    """Frame ``k`` of a K13 list, checked: (Y, U, V, h, w, alpha) with Y
    and alpha (or None) planes of at least h x w and U, V of at least
    (h + 1) // 2 x (w + 1) // 2, uint8 CUDA tensors whose rows are
    contiguous, at any pitch."""
    Y, U, V, h, w, alpha = frame
    h, w = int(h), int(w)
    if not 0 < h < 2 ** 31 - 256 or not 0 < w < 2 ** 31 - 256:
        raise ValueError(f"frame {k}: {w}x{h} is empty or too large")
    ch, cw = (h + 1) // 2, (w + 1) // 2
    _plane(Y, "Y", h, w)
    _plane(U, "U", ch, cw)
    _plane(V, "V", ch, cw)
    if alpha is not None:
        _plane(alpha, "alpha", h, w)
    if len({t.device for t in (Y, U, V, alpha) if t is not None}) != 1:
        raise ValueError(f"frame {k}: Y, U, V and alpha must share a device")
    return Y, U, V, h, w, alpha


def vp8_yuv_to_rgba_batch(frames, outs=None):
    """K13 over a list of frames in one launch (a launch for each
    ``MAX_FRAMES``): ``frames`` (Y, U, V, h, w, alpha) as ``_frame``
    takes them, of any sizes and pitches, alpha or none each ->
    ``outs``, each frame's (h, w, 4) uint8 RGBA: a (k, h, w, 4) tensor
    where the sizes agree, else a list (``vp8_kernels.batch_outputs``;
    given, it is written in place and returned).  The descriptors hold
    only addresses: ``frames`` and the outputs stay referenced here until
    every launch is enqueued; after that stream order keeps their memory
    from being reused early."""
    frames = [_frame(f, k) for k, f in enumerate(frames)]
    outs, views = batch_outputs(frames, outs)
    for v in views:
        _cuda(v, "out", torch.uint8)
        if v.device != frames[0][0].device:
            raise ValueError("the outputs must lie on the frames' device")
        if v.data_ptr() % 4:
            raise ValueError("out: each frame's RGBA must be 4-byte aligned")
    for k in range(0, len(frames), MAX_FRAMES):
        words = frame_words(frames[k:k + MAX_FRAMES],
                            views[k:k + MAX_FRAMES])
        _launch("ffpic_vp8_yuv_to_rgba", "vp8_yuv_to_rgba",
                _vp(words.ctypes.data), len(words))
    return outs


def vp8_yuv_to_rgba(Y: torch.Tensor, U: torch.Tensor, V: torch.Tensor,
                    h: int, w: int,
                    alpha: torch.Tensor | None = None) -> torch.Tensor:
    """K13 on one frame: Y (>= h, >= w), U and V (>= (h+1)//2, >=
    (w+1)//2) uint8 planes at any row pitch, alpha None or (>= h, >= w)
    -> (h, w, 4) uint8 RGBA; ``vp8_yuv_to_rgba_batch`` with one frame."""
    return vp8_yuv_to_rgba_batch([(Y, U, V, h, w, alpha)])[0]


def vp8_wavefront(residual: torch.Tensor, ymode: torch.Tensor,
                  bmodes: torch.Tensor) -> torch.Tensor:
    """K18: residual (mbh, mbw, 16, 4, 4), ymode (mbh, mbw) and bmodes
    (mbh, mbw, 16), int32 -> the luma plane (16 mbh, 16 mbw) uint8, in
    one launch; a warp a macroblock row.  Its scratch, a row ticket and
    each macroblock's hand-off record (4 words of 64 bits), is zeroed for
    every launch."""
    if not isinstance(ymode, torch.Tensor) or ymode.dim() != 2:
        raise ValueError(f"ymode: expected (mbh, mbw), got "
                         f"{getattr(ymode, 'shape', type(ymode))}")
    mbh, mbw = ymode.shape
    args = ((residual, "residual", (mbh, mbw, 16, 4, 4)),
            (ymode, "ymode", (mbh, mbw)), (bmodes, "bmodes", (mbh, mbw, 16)))
    for t, name, shape in args:      # dtype and shape before the device
        _typed(t, name, torch.int32, shape)
    for t, name, _ in args:
        _on_card(t, name)
    if residual.device != ymode.device or residual.device != bmodes.device:
        raise ValueError("residual, ymode and bmodes must share a device")
    if residual.data_ptr() % 16:
        raise ValueError("residual: must be 16-byte aligned (a lane loads "
                         "its 8 residuals 16 bytes at a time)")
    out = torch.empty((16 * mbh, 16 * mbw), dtype=torch.uint8,
                      device=residual.device)
    if out.numel():
        scratch = torch.zeros(1 + 4 * mbh * mbw, dtype=torch.int64,
                              device=residual.device)
        _launch("ffpic_vp8_wavefront", "vp8_wavefront",
                _vp(residual.data_ptr()), _vp(ymode.data_ptr()),
                _vp(bmodes.data_ptr()), _vp(out.data_ptr()),
                _vp(scratch.data_ptr()), mbh, mbw)
    return out
