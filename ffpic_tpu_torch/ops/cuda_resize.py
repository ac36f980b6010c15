"""ctypes wrappers of the CUDA kernels in ``csrc/resize.cu``: K16
``resize_rgba`` and K17 ``normalize_resize``.

As in ``ops.cuda_png``: each wrapper takes CUDA tensors only, checks
device, dtype, shape and layout and raises on anything else, allocates
its output with ``torch.empty``, launches on the current stream and
raises if the launch reports an error, without synchronising.
``launches`` counts each kernel's launches.  The plain PyTorch versions
live in ``ops.resize``; the kernels never run on the CPU.  The taps of
each axis are ``ops.resize.taps``, cached there on the device; the
descriptors hold only their addresses, so a launch keeps the tap
tensors it was given referenced until it is enqueued (the cache may
drop them, and the allocator reuse their memory, before then).

One launch covers a batch of up to ``MAX_SLOTS`` images: each image (a
slot) gets a descriptor of ten 64-bit words (``slot_words``, the layout
of ``resize.cu``'s ``Slot``), passed by value as a kernel parameter, so
images of other sizes and pitches share the launch and the output is
written as one ``(N, h, w, C)`` tensor; a larger batch takes a launch
for each ``MAX_SLOTS`` of its images.

K16 by ``nearest`` (``ops.resize.kernel_of``) launches a gather of the
kept pixels by the ``start`` tables (``ffpic_resize_nearest``), every
other method the banded kernel it shares with K17 (``ffpic_resize_rgba``);
both count as ``resize_rgba``, and ``instance`` names the kernel
instance that K16's last launch took, as ptxas names it.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ffpic_tpu_torch.ops import _build
from ffpic_tpu_torch.ops.resize import MEAN, STD, kernel_of, taps

launches = {"resize_rgba": 0, "normalize_resize": 0}
instance = {"resize_rgba": None}

_vp = ctypes.c_void_p
_int = ctypes.c_int
_SIGNATURES = {
    "ffpic_resize_rgba": [_vp, _int, _int, _vp, _int, _int, _int, _int,
                          _vp],
    "ffpic_resize_nearest": [_vp, _int, _int, _vp, _int, _int, _vp],
    "ffpic_normalize_resize": [_vp, _int, _int, _vp, _int, _int, _int, _int,
                               _vp, _vp],
}
_launch = _build.launcher(_SIGNATURES, launches)
SLOT_WORDS = 10          # resize.cu's Slot: src, row, then each Axis's 4
MAX_SLOTS = 64           # resize.cu's kMaxSlots
ROWS = 2                 # resize.cu's kRows: output rows a CTA


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _views(imgs, name: str, min_c: int) -> list:
    """``imgs`` (a tensor (..., H, W, C), or a sequence of (H, W, C)
    tensors of one C) as (H, W, C) uint8 CUDA views on one device whose
    pixels are contiguous (any row pitch, so a crop of a larger decode
    needs no copy; a copy where the pixels are not)."""
    if isinstance(imgs, torch.Tensor):
        if imgs.dim() < 3:
            raise ValueError(f"{name}: expected (..., H, W, C), got "
                             f"{tuple(imgs.shape)}")
        imgs = list(imgs.reshape(-1, *imgs.shape[-3:])) \
            if imgs.dim() > 3 else [imgs]
    out = []
    for img in imgs:
        if not isinstance(img, torch.Tensor) or img.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got "
                             f"{getattr(img, 'device', type(img))}")
        if img.dtype != torch.uint8 or img.dim() != 3 or \
                img.shape[-1] < min_c:
            raise ValueError(f"{name}: expected (H, W, C>={min_c}) uint8, "
                             f"got {img.dtype} {tuple(img.shape)}")
        h, w, c = img.shape
        if img.stride(-1) != 1 or (w > 1 and img.stride(-2) != c):
            img = img.contiguous()
        if min(h, w) <= 0 or max(h, w) >= 2 ** 31:
            raise ValueError(f"{name}: image {tuple(img.shape)} is empty or "
                             "too large")
        out.append(img)
    if len({(v.shape[-1], v.device) for v in out}) > 1:
        raise ValueError(f"{name}: the images must share C and a device")
    return out


def _axis_words(in_size: int, out_size: int, device,
                method: str = "bilinear") -> tuple:
    """One axis's four words of a descriptor: the addresses of its taps'
    ``start``, ``count`` and weights (0 when the axis keeps its size,
    which the kernel skips), then K | in_size << 32; and the tap tensors
    at those addresses (none when skipped)."""
    if in_size == out_size:
        return [0, 0, 0, in_size << 32], ()
    start, count, wts = taps(in_size, out_size, device, method)
    return [start.data_ptr(), count.data_ptr(), wts.data_ptr(),
            wts.shape[1] | in_size << 32], (start, count, wts)


@functools.lru_cache(maxsize=64)
def band_rows(in_size: int, out_size: int, method: str = "bilinear") -> int:
    """The most input rows that the runs of ``ROWS`` neighbouring output
    rows span (a CTA's band, whose weights it stages)."""
    start, count, _ = taps(in_size, out_size, torch.device("cpu"), method)
    start, count = start.numpy(), count.numpy()
    pad = -len(start) % ROWS
    lo = np.where(count > 0, start, np.iinfo(np.int32).max)
    hi = np.where(count > 0, start + count, 0)
    lo = np.pad(lo, (0, pad), constant_values=np.iinfo(np.int32).max)
    hi = np.pad(hi, (0, pad))
    lo, hi = lo.reshape(-1, ROWS).min(1), hi.reshape(-1, ROWS).max(1)
    return int(np.maximum(hi - np.minimum(lo, hi), 0).max())


def slot_words(views: list, size, device, method: str = "bilinear") -> tuple:
    """The descriptors of a launch over ``views`` ((H, W, C) tensors, as
    ``_views`` returns them) to ``size`` by ``method``: (N, 10) int64, a
    row a slot (its first pixel's address, its row pitch in bytes, the
    vertical axis's words, the horizontal axis's), the widest W of a
    slot whose W changes (its row's width in shared memory, 0 if none),
    the most input rows a CTA's band of a slot spans (``band_rows``),
    and the tap tensors whose addresses the descriptors hold, which the
    caller keeps until the launch is enqueued."""
    h, w = size
    words = np.empty((len(views), SLOT_WORDS), np.int64)
    line_w = vk = 0
    held = []
    for k, v in enumerate(views):
        hi, wi = v.shape[:2]
        vert, vt = _axis_words(hi, h, device, method)
        horiz, ht = _axis_words(wi, w, device, method)
        words[k] = [v.data_ptr(), v.stride(0), *vert, *horiz]
        held += [*vt, *ht]
        if wi != w:
            line_w = max(line_w, wi)
        if hi != h:
            vk = max(vk, band_rows(hi, h, method))
    return words, line_w, vk, held


def _checked(size):
    h, w = (int(s) for s in size)
    if h <= 0 or w <= 0:
        raise ValueError(f"size {size}: both sides must be positive")
    return h, w


def _run(fn: str, counter: str, views: list, size, out: torch.Tensor,
         method: str, tail) -> None:
    """``out`` (N, h, w, ...) from ``views``: a launch of ``fn`` for each
    ``MAX_SLOTS`` images, its last arguments ``tail(line_w, vk)`` (the
    part's extents, ``slot_words``)."""
    for k in range(0, len(views), MAX_SLOTS):
        part = views[k:k + MAX_SLOTS]
        # ``held`` keeps every tap table the words point at alive through
        # the launch; once it is enqueued, stream order makes reuse safe
        words, line_w, vk, held = slot_words(part, size, out.device, method)
        _launch(fn, counter, _vp(words.ctypes.data), len(part),
                views[0].shape[-1], _vp(out[k].data_ptr()), *size,
                *tail(line_w, vk))


def _resize(views: list, size, out: torch.Tensor, method: str) -> None:
    """K16 over ``views`` into ``out``: the gather by ``nearest``, the
    banded kernel by every other method (``instance`` names the one the
    last launch took)."""
    picked = ctypes.c_int()
    at = _vp(ctypes.addressof(picked))
    if kernel_of(method) == "nearest":
        _run("ffpic_resize_nearest", "resize_rgba", views, size, out, method,
             lambda line_w, vk: (at,))
        instance["resize_rgba"] = f"resize_gather<{picked.value}>"
    else:
        _run("ffpic_resize_rgba", "resize_rgba", views, size, out, method,
             lambda line_w, vk: (line_w, vk, at))
        instance["resize_rgba"] = f"resize<0,{picked.value}>"


def resize_batch(slots, size, method: str = "bilinear") -> torch.Tensor:
    """K16 over a batch in one launch: the (H_n, W_n, C) uint8 slots, of
    any sizes and pitches, -> (N, h, w, C) uint8 by ``method``
    (``ops.resize.resize_batch_plain``)."""
    kernel_of(method)
    views = _views(slots, "resize_rgba", 1)
    h, w = _checked(size)
    if not views:
        raise ValueError("resize_rgba: no slots")
    out = torch.empty((len(views), h, w, views[0].shape[-1]),
                      dtype=torch.uint8, device=views[0].device)
    _resize(views, (h, w), out, method)
    return out


def resize_rgba(img: torch.Tensor, size,
                method: str = "bilinear") -> torch.Tensor:
    """K16: (..., H, W, C) uint8 -> (..., h, w, C) uint8 by ``method``
    (``ops.resize.resize_rgba_plain``); every image of the leading
    dimensions in one launch."""
    kernel_of(method)
    if not isinstance(img, torch.Tensor) or img.dim() < 3:
        raise ValueError("resize_rgba: expected a CUDA tensor (..., H, W, "
                         f"C), got {getattr(img, 'device', type(img))}")
    lead, c = img.shape[:-3], img.shape[-1]
    h, w = _checked(size)
    views = _views(img, "resize_rgba", 1)
    out = torch.empty((len(views), h, w, c), dtype=torch.uint8,
                      device=img.device)
    if views and img.numel():
        _resize(views, (h, w), out, method)
    return out.view(*lead, h, w, c)


def normalize_resize(batch: torch.Tensor, size=None, mean=MEAN,
                     std=STD) -> torch.Tensor:
    """K17: (..., H, W, C>=3) uint8 RGBA -> (..., h, w, 3) f32: rgb / 255,
    the resize to ``size`` when given, then (x - mean) / std in one pass
    (``ops.resize.normalize_plain``); every image in one launch."""
    if not isinstance(batch, torch.Tensor) or batch.dim() < 3:
        raise ValueError("normalize_resize: expected a CUDA tensor (..., H, "
                         f"W, C), got {getattr(batch, 'device', type(batch))}")
    lead = batch.shape[:-3]
    h, w = tuple(batch.shape[-3:-1]) if size is None else _checked(size)
    views = _views(batch, "normalize_resize", 3)
    m = np.ascontiguousarray(mean, np.float32)
    s = np.ascontiguousarray(std, np.float32)
    if m.shape != (3,) or s.shape != (3,):
        raise ValueError(f"mean {m.shape} / std {s.shape}: expected 3 each")
    out = torch.empty((len(views), h, w, 3), dtype=torch.float32,
                      device=batch.device)
    if views and batch.numel():
        _run("ffpic_normalize_resize", "normalize_resize", views, (h, w),
             out, "bilinear", lambda line_w, vk: (
                 line_w, vk, _vp(m.ctypes.data), _vp(s.ctypes.data)))
    return out.view(*lead, h, w, 3)
