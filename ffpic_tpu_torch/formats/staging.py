"""What the host-only codecs share: their pixel budget and the copy of
their host-decoded RGBA pictures to the device.

BMP, GIF, TGA, PNM, PSD, TIFF and ICO decode on the host, as their
originals in ``ffpic_tpu/formats/`` do, into ``(H, W, 4)`` uint8 numpy
arrays; ``load`` then stages each picture's pixels to the device it was
given (``to_device_pics``), and ``decode_batch`` stages all of a
batch's such members in one pinned buffer and one copy
(``stage_rgba``).
"""

from __future__ import annotations

import numpy as np
import torch

from ffpic_tpu_torch.utils.device import to_device

# The most pixels a host codec allocates for one picture (the TIFF
# original's sample budget, ``ffpic_tpu/formats/tiff.py:112``): a
# corrupt header that claims more raises ``ValueError`` before anything
# is allocated, where the originals other than TIFF allocate it.
MAX_PIXELS = 1 << 28


def check_size(w: int, h: int, codec: str) -> None:
    """Refuse a picture of more than ``MAX_PIXELS`` pixels."""
    if w * h > MAX_PIXELS:
        raise ValueError(f"{codec}: {w}x{h} exceeds the pixel budget of "
                         f"{MAX_PIXELS}")


def to_device_pics(pics: list, device) -> list:
    """The host codec's pictures with their host pixels on ``device``
    (pixels already on a device, and header-only pictures, pass as they
    are)."""
    for p in pics:
        if isinstance(p.pixels, np.ndarray):
            p.pixels = to_device(np.ascontiguousarray(p.pixels), device)
    return pics


def stage_rgba(arrays: list, device: torch.device):
    """Host ``(h, w, 4)`` uint8 arrays -> (batch, views): one tensor on
    ``device`` for each array, all from one staging buffer; on CUDA one
    pinned buffer and one copy.  When every array has one shape the
    buffer is a ``(k, h, w, 4)`` tensor, returned as ``batch`` (the
    views are its rows); else ``batch`` is None and each array starts
    at a 16-byte boundary of a flat buffer."""
    shapes = [a.shape for a in arrays]
    same = len(set(shapes)) == 1
    sizes = [int(np.prod(s)) for s in shapes]
    offs = []
    at = 0
    for n in sizes:
        offs.append(at)
        at += n if same else -(-n // 16) * 16
    host = torch.empty(at, dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    hv = host.numpy()
    for a, o, n in zip(arrays, offs, sizes):
        hv[o:o + n] = a.reshape(-1)
    flat = host.to(device, non_blocking=True) if device.type == "cuda" \
        else host
    if same:
        batch = flat.view(len(arrays), *shapes[0])
        return batch, list(batch)
    return None, [flat[o:o + n].view(s)
                  for o, n, s in zip(offs, sizes, shapes)]
