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
kept pixels by the ``start`` tables (``ffpic_resize_nearest``), by
cubic and Lanczos the band kernel (``ffpic_resize_band``: pass 1 on the
FP64 tensor cores over up to 7 output rows a CTA, pass 2 there too over
groups of ``GROUP`` output columns, ``group_taps``; where two of its
rows' lines do not fit shared memory its launcher takes the banded
kernel's ``resize<0,1>``), and by bilinear the banded kernel it shares
with K17 (``ffpic_resize_rgba``); all count as ``resize_rgba``, and
``instance`` names the kernel instance that K16's last launch took, as
ptxas names it, and its output rows a CTA.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ffpic_tpu_torch.ops import _build
from ffpic_tpu_torch.ops.resize import MEAN, STD, kernel_of, taps

launches = {"resize_rgba": 0, "normalize_resize": 0}
instance = {"resize_rgba": None, "rows": None}

_vp = ctypes.c_void_p
_int = ctypes.c_int
_SIGNATURES = {
    "ffpic_resize_rgba": [_vp, _int, _int, _vp, _int, _int, _int, _int,
                          _vp],
    "ffpic_resize_nearest": [_vp, _int, _int, _vp, _int, _int, _vp],
    "ffpic_resize_band": [_vp, _vp, _int, _int, _vp, _int, _int, _int, _vp,
                          _vp],
    "ffpic_normalize_resize": [_vp, _int, _int, _vp, _int, _int, _int, _int,
                               _vp, _vp],
}
_launch = _build.launcher(_SIGNATURES, launches)
SLOT_WORDS = 10          # resize.cu's Slot: src, row, then each Axis's 4
MAX_SLOTS = 64           # resize.cu's kMaxSlots
ROWS = 2                 # resize.cu's kRows: output rows a CTA
BAND_SPANS = 16          # resize.cu's kBandSpans: entries of band_spans
GROUP_WORDS = 3          # resize.cu's Group: start, weights, steps
GROUP = 8                # resize.cu's kGroup: output columns a pass-2 group
# the kernels resize_band takes (jax.image.resize's cubic and Lanczos)
BAND_KERNELS = ("cubic", "lanczos3", "lanczos5")


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


@functools.lru_cache(maxsize=256)
def band_rows(in_size: int, out_size: int, method: str = "bilinear",
              rows: int = ROWS) -> int:
    """The most input rows that the runs of ``rows`` neighbouring output
    rows span, the first of them a multiple of ``rows`` (a CTA's band,
    whose weights it stages)."""
    start, count, _ = taps(in_size, out_size, torch.device("cpu"), method)
    start, count = start.numpy(), count.numpy()
    pad = -len(start) % rows
    lo = np.where(count > 0, start, np.iinfo(np.int32).max)
    hi = np.where(count > 0, start + count, 0)
    lo = np.pad(lo, (0, pad), constant_values=np.iinfo(np.int32).max)
    hi = np.pad(hi, (0, pad))
    lo, hi = lo.reshape(-1, rows).min(1), hi.reshape(-1, rows).max(1)
    return int(np.maximum(hi - np.minimum(lo, hi), 0).max())


def band_spans(views: list, h: int, method: str) -> np.ndarray:
    """``resize_band``'s table of bands: entry r - 1 the most input rows
    that the runs of r output rows of a slot of ``views`` whose H changes
    span (``band_rows``), r = 1 .. ``BAND_SPANS``; int32."""
    spans = np.zeros(BAND_SPANS, np.int32)
    for n in {v.shape[0] for v in views} - {h}:
        spans = np.maximum(spans, np.array(
            [band_rows(n, h, method, r) for r in range(1, BAND_SPANS + 1)],
            np.int32))
    return spans


@functools.lru_cache(maxsize=64)
def group_taps(in_size: int, out_size: int, device, method: str):
    """Pass 2's table of ``resize_band`` for one axis: the output indices
    in groups of ``GROUP`` (the last padded with indices that have no
    taps), each group reading one window of ``16 steps`` inputs, the same
    for all: its first input ``start`` (G,) int32 (the least ``start`` of
    its indices' runs, moved left where the window would pass the last
    input, 0 where the input is narrower than the window) and the f32
    weights (G, steps, 32, 4) in the order an mma.m16n8k16 product's B
    takes them: [g, s, l, v] is index g * GROUP + l // 4's weight for
    input start + 16 s + l % 4 + 4 v, its tap's weight or 0.  So a walk
    of the window in order sums each index's taps in ascending input
    order, each once."""
    start, count, wts = taps(in_size, out_size, torch.device("cpu"), method)
    start, count = start.numpy().astype(np.int64), count.numpy()
    groups = -(-out_size // GROUP)
    pad = groups * GROUP - out_size
    s = np.pad(start, (0, pad)).reshape(groups, GROUP)
    c = np.pad(count, (0, pad)).reshape(groups, GROUP)
    first = np.where(c > 0, s, in_size).min(1)
    end = np.where(c > 0, s + c, 0).max(1)
    first = np.where(end > 0, first, 0)
    steps = max(-(-int((end - first).max()) // 16), 1)
    first = np.clip(first, 0, max(in_size - 16 * steps, 0))
    w = np.zeros((groups, 16 * steps, GROUP), np.float32)
    j = np.arange(out_size)
    tap = np.arange(wts.shape[1])
    keep = tap[None, :] < count[:, None]
    at = start[:, None] - first[j // GROUP][:, None] + tap[None, :]
    w[np.broadcast_to((j // GROUP)[:, None], at.shape)[keep], at[keep],
      np.broadcast_to((j % GROUP)[:, None], at.shape)[keep]] = \
        wts.numpy()[keep]
    lane, v = np.arange(32)[:, None], np.arange(4)[None, :]
    mma = w.reshape(groups, steps, 16, GROUP)[:, :, lane % 4 + 4 * v,
                                              lane // 4]
    return (torch.from_numpy(first.astype(np.int32)).to(device),
            torch.from_numpy(np.ascontiguousarray(mma)).to(device))


def group_words(views: list, size, device, method: str) -> tuple:
    """``resize_band``'s pass-2 entries of a launch over ``views``:
    (N, 3) int64, a row a slot (the addresses of its ``group_taps``'
    ``start`` and weights, and the window's steps; zeros where W does not
    change), and the tensors at those addresses, which the caller keeps
    until the launch is enqueued."""
    words = np.zeros((len(views), GROUP_WORDS), np.int64)
    held = []
    for n, v in enumerate(views):
        if v.shape[1] != size[1]:
            first, w = group_taps(v.shape[1], size[1], device, method)
            words[n] = [first.data_ptr(), w.data_ptr(), w.shape[1]]
            held += [first, w]
    return words, held


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


def _band(views: list, size, out: torch.Tensor, method: str) -> int:
    """K16 by cubic and Lanczos: a launch of ``ffpic_resize_band`` for
    each ``MAX_SLOTS`` images; returns the rows a CTA of ``resize_band``
    that the last launch took (0: it took ``resize<0,1>``)."""
    rows = ctypes.c_int()
    for n in range(0, len(views), MAX_SLOTS):
        part = views[n:n + MAX_SLOTS]
        # the tables the words point at stay referenced through the launch
        words, line_w, _, held = slot_words(part, size, out.device, method)
        groups, group_held = group_words(part, size, out.device, method)
        spans = band_spans(part, size[0], method)
        _launch("ffpic_resize_band", "resize_rgba", _vp(words.ctypes.data),
                _vp(groups.ctypes.data), len(part), views[0].shape[-1],
                _vp(out[n].data_ptr()), *size, line_w,
                _vp(spans.ctypes.data), _vp(ctypes.addressof(rows)))
    return rows.value


def _resize(views: list, size, out: torch.Tensor, method: str) -> None:
    """K16 over ``views`` into ``out``: the gather by ``nearest``,
    ``resize_band`` by cubic and Lanczos (``resize<0,1>`` where two rows'
    lines do not fit it), the banded kernel by bilinear (``instance``
    names the one the last launch took, and its rows a CTA)."""
    picked = ctypes.c_int()
    at = _vp(ctypes.addressof(picked))
    kernel = kernel_of(method)
    if kernel == "nearest":
        _run("ffpic_resize_nearest", "resize_rgba", views, size, out, method,
             lambda line_w, vk: (at,))
        instance["resize_rgba"] = f"resize_gather<{picked.value}>"
        instance["rows"] = None
    elif kernel in BAND_KERNELS:
        rows = _band(views, size, out, method)
        instance["resize_rgba"] = "resize_band" if rows else "resize<0,1>"
        instance["rows"] = rows or 1
    else:
        _run("ffpic_resize_rgba", "resize_rgba", views, size, out, method,
             lambda line_w, vk: (line_w, vk, at))
        instance["resize_rgba"] = f"resize<0,{picked.value}>"
        instance["rows"] = picked.value


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
