"""ctypes wrappers of the CUDA kernels in ``csrc/png_decode.cu``: K6
``unfilter_subup`` and K7 ``assemble_rgba``.

As in ``ops.cuda_jpeg``: each wrapper takes CUDA tensors only, checks
device, dtype, shape and layout and raises on anything else, allocates
its output with ``torch.empty``, launches on the current stream and
raises if the launch reports an error, without synchronising.
``launches`` counts each kernel's launches.  The plain PyTorch versions
live in ``ops.png_kernels``; the kernels never run on the CPU.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ffpic_tpu_torch.ops import _build
from ffpic_tpu_torch.ops.png_kernels import NCH, check_format

launches = {"unfilter_subup": 0, "assemble_rgba": 0}

_vp = ctypes.c_void_p
_int = ctypes.c_int
_i64 = ctypes.c_longlong
_SIGNATURES = {
    "ffpic_unfilter_subup": [_vp, _i64, _vp, _i64, _int, _int, _int, _int,
                             _int, _vp, _vp, _int, _vp],
    "ffpic_assemble_rgba": [_vp, _i64, _vp, _vp, _vp, _int, _int, _int, _int,
                            _vp],
}
_launch = _build.launcher(_SIGNATURES, launches)
_PITCH = 16        # K6's output rows start 16-byte aligned
# K6's bands (csrc/png_decode.cu): chunks of a multiple of UNFILTER_STEP
# bytes, at most UNFILTER_CHUNK, and rows * chunk at most UNFILTER_TILE
# bytes of shared memory, at most UNFILTER_ROWS rows
UNFILTER_STEP = 768
UNFILTER_CHUNK = 7680
UNFILTER_TILE = 30720
UNFILTER_ROWS = 64
UNFILTER_BLOCK = 32         # bands a block of the look-back (kBlock)
UNFILTER_BANDS = 256        # bands enough to spread a launch over the card
_EPOCHS = 2 ** 29           # status words hold 4 * epoch + state
_status: dict = {}          # (device, stream) -> [int32 tensor, epoch]
_STREAMS = 64               # streams whose status words are kept
_status_lock = threading.Lock()


def unfilter_bands(h: int, stride: int) -> tuple[int, int]:
    """(rows, chunk): the rows of a band of K6 and the bytes of a row it
    takes at a time, for h rows of ``stride`` bytes: as many rows as its
    tile holds, but few enough for UNFILTER_BANDS bands where h allows."""
    step = UNFILTER_STEP
    chunk = min(-(-stride // step) * step, UNFILTER_CHUNK)
    rows = min(UNFILTER_ROWS, UNFILTER_TILE // chunk, h // UNFILTER_BANDS)
    return max(1, rows), chunk


def _status_words(dev: torch.device, words: int):
    """K6's status words for a launch on the current stream and the
    launch's epoch: one int32 buffer a device and stream, zeroed when it
    is made (or grown, or its epochs run out), whose words later launches
    tell apart by the epoch; word 0, the band ticket, is back at 0 after
    every launch."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    with _status_lock:
        ent = _status.get(key)
        if ent is None or ent[0].numel() < words or ent[1] + 1 >= _EPOCHS:
            ent = [torch.zeros(max(words, 4096), dtype=torch.int32,
                               device=dev), 0]
            _status.pop(key, None)
            if len(_status) >= _STREAMS:
                # the oldest stream's buffer: freed memory goes back to
                # that stream's pool, so no launch on another reuses it
                # while one of its own may still read it
                del _status[next(iter(_status))]
            _status[key] = ent
        ent[1] += 1
        return ent[0], ent[1]


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _rows(t: torch.Tensor, name: str) -> None:
    """A 2-D uint8 CUDA tensor whose rows are contiguous, at any pitch."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got "
                         f"{getattr(t, 'device', type(t))}")
    if t.dtype != torch.uint8 or t.dim() != 2:
        raise ValueError(f"{name}: expected 2-D uint8, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{name}: each row must be contiguous")


def unfilter_subup(tagged: torch.Tensor, bpp: int) -> torch.Tensor:
    """K6: (H, stride + 1) uint8 filtered rows (any row pitch), each its
    filter type in {0, 1, 2} and then its bytes -> (H, stride) uint8
    reconstructed rows, a view of an (H, pitch) buffer with pitch the
    stride rounded up to 16 bytes; one launch over bands of rows
    (``unfilter_bands``) that carry the column sums to each other through
    status words (``_status_words``) and a scratch row for each band and
    each block of bands."""
    _rows(tagged, "tagged")
    h, stride = tagged.shape[0], tagged.shape[1] - 1
    if bpp not in (1, 2, 3, 4, 6, 8):
        raise ValueError(f"bpp {bpp}: PNG pixels take 1, 2, 3, 4, 6 or 8 "
                         "bytes")
    if stride < 0:
        raise ValueError("tagged: each row needs its filter type byte")
    if h >= 2 ** 31 or stride >= 2 ** 31:
        raise ValueError(f"{h}x{stride} rows: too large for one launch")
    pitch = -(-stride // _PITCH) * _PITCH
    out = torch.empty((h, pitch), dtype=torch.uint8, device=tagged.device)
    if h and stride:
        rows, chunk = unfilter_bands(h, stride)
        bands = -(-h // rows)
        # a status word and a scratch row for each band and each block of
        # UNFILTER_BLOCK bands, a word a chunk
        blocks = -(-bands // UNFILTER_BLOCK)
        status, epoch = _status_words(
            tagged.device, 1 + (bands + blocks) * -(-stride // chunk))
        agg = torch.empty((bands + blocks, pitch), dtype=torch.uint8,
                          device=tagged.device)
        _launch("ffpic_unfilter_subup", "unfilter_subup",
                _vp(tagged.data_ptr()), tagged.stride(0),
                _vp(out.data_ptr()), pitch, h, stride, bpp, rows, chunk,
                _vp(status.data_ptr()), _vp(agg.data_ptr()), epoch)
    return out[:, :stride]


def assemble_rgba(recon: torch.Tensor, palette: np.ndarray, trns: np.ndarray,
                  color_type: int, bitdepth: int, width: int,
                  height: int) -> torch.Tensor:
    """K7: (H, stride) uint8 reconstructed rows (any row pitch) -> (H, W, 4)
    uint8 RGBA, four pixels (a 16-byte store) a thread in a grid-stride
    loop, contiguous rows as one run; of the ``palette`` (256, 4) uint8
    and ``trns`` (256,) int32 host arrays the launch takes by value only
    what its colour type reads (the palette with the tRNS alpha for
    colour type 3, the colour key for 0 and 2)."""
    check_format(color_type, bitdepth)
    _rows(recon, "recon")
    need = (width * NCH[color_type] * bitdepth + 7) // 8
    if recon.shape[0] != height or recon.shape[1] < need:
        raise ValueError(f"recon {tuple(recon.shape)}: expected {height} rows "
                         f"of at least {need} bytes")
    pal = np.ascontiguousarray(palette, np.uint8)
    key = np.ascontiguousarray(trns, np.int32)
    if pal.shape != (256, 4) or key.shape != (256,):
        raise ValueError(f"palette {pal.shape} / trns {key.shape}: expected "
                         "(256, 4) and (256,)")
    if height >= 2 ** 31 or width >= 2 ** 31:
        raise ValueError(f"{width}x{height}: too large for one launch")
    out = torch.empty((height, width, 4), dtype=torch.uint8,
                      device=recon.device)
    if out.numel():
        _launch("ffpic_assemble_rgba", "assemble_rgba", _vp(recon.data_ptr()),
                recon.stride(0), _vp(pal.ctypes.data), _vp(key.ctypes.data),
                _vp(out.data_ptr()), width, height, color_type, bitdepth)
    return out
