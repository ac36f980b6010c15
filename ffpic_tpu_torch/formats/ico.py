"""ICO/CUR codec of the port.

Copied from ``ffpic_tpu/formats/ico.py``: every directory entry, BMP
payloads (1/4/8-bit palette, 24 and 32 bits) with their AND-mask
transparency, and PNG payloads (``:25-27``), which go through the port's
``png.load`` on the device (K6 for Sub/Up rows, K7) and keep their
pixels there.  The host decode is ``decode``; the registry's ``load``
stages the BMP entries' pixels to the device.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ffpic_tpu_torch.formats import png
from ffpic_tpu_torch.formats.pic import Pic, PixelFormat
from ffpic_tpu_torch.formats.registry import Codec, register


def probe(data: bytes) -> bool:
    if len(data) < 6:
        return False
    res, typ, count = struct.unpack_from("<HHH", data, 0)
    return res == 0 and typ in (1, 2) and 0 < count < 64


def _decode_entry(data: bytes, off: int, size: int, device: torch.device):
    """An entry's RGBA pixels: a PNG entry's as the port's ``png.load``
    leaves them on ``device``, a BMP entry's as a host array."""
    blob = data[off:off + size]
    if blob[:8] == b"\x89PNG\r\n\x1a\n":
        return png.load(blob, device=device)[0].pixels
    # BMP payload: BITMAPINFOHEADER with doubled height (XOR + AND masks)
    hdrsize = struct.unpack_from("<I", blob, 0)[0]
    w, h2, _planes, bpp = struct.unpack_from("<iiHH", blob, 4)
    h = h2 // 2
    pos = hdrsize
    pal = None
    if bpp <= 8:
        ncolors = struct.unpack_from("<I", blob, 32)[0] or (1 << bpp)
        pal = np.frombuffer(blob, np.uint8, ncolors * 4, pos) \
            .reshape(ncolors, 4)[:, [2, 1, 0, 3]].copy()
        pal[:, 3] = 255
        pos += ncolors * 4

    if bpp == 32:
        pitch = w * 4
        px = np.frombuffer(blob, np.uint8, pitch * h, pos).reshape(h, w, 4)
        rgba = px[::-1][..., [2, 1, 0, 3]].copy()
        pos += pitch * h
        # AND mask still present but alpha channel wins for 32bpp
        return rgba
    if bpp == 24:
        pitch = ((w * 3 + 3) // 4) * 4
        rows = np.frombuffer(blob, np.uint8, pitch * h, pos).reshape(h, pitch)
        bgr = rows[:, :w * 3].reshape(h, w, 3)[::-1]
        rgba = np.dstack([bgr[..., [2, 1, 0]], np.full((h, w), 255, np.uint8)])
        pos += pitch * h
    elif bpp in (1, 4, 8):
        pitch = ((w * bpp + 31) // 32) * 4
        rows = np.frombuffer(blob, np.uint8, pitch * h, pos).reshape(h, pitch)
        if bpp == 8:
            idx = rows[:, :w]
        else:
            bits = np.unpackbits(rows, axis=1)
            if bpp == 1:
                idx = bits[:, :w]
            else:
                idx = (bits.reshape(h, -1, 4) *
                       np.array([8, 4, 2, 1])).sum(2)[:, :w].astype(np.uint8)
        rgba = pal[idx][::-1].copy()
        pos += pitch * h
    else:
        return None

    # AND mask: 1bpp transparency
    mask_pitch = ((w + 31) // 32) * 4
    if pos + mask_pitch * h <= len(blob):
        mrows = np.frombuffer(blob, np.uint8, mask_pitch * h, pos) \
            .reshape(h, mask_pitch)
        mbits = np.unpackbits(mrows, axis=1)[:, :w][::-1]
        rgba[..., 3] = np.where(mbits == 1, 0, rgba[..., 3])
    return rgba


def decode(data: bytes, skip_decode: bool = False, *,
           device) -> list[Pic]:
    """Every entry's picture: BMP entries with their pixels on the host,
    PNG entries decoded on ``device`` (a header-only parse needs no
    device)."""
    _res, typ, count = struct.unpack_from("<HHH", data, 0)
    entries = []
    for i in range(count):
        w8, h8, ncol, _r, planes, bpp, size, off = struct.unpack_from(
            "<BBBBHHII", data, 6 + 16 * i)
        entries.append(dict(width=w8 or 256, height=h8 or 256, colors=ncol,
                            bpp=bpp, size=size, offset=off))
    meta = dict(kind="icon" if typ == 1 else "cursor", entries=entries)
    if skip_decode:
        e = entries[0]
        return [Pic(width=e["width"], height=e["height"], depth=32,
                    pitch=e["width"] * 4, codec="ICO", meta=meta)]
    pics = []
    for e in entries:
        rgba = _decode_entry(data, e["offset"], e["size"], device)
        if rgba is None:
            continue
        h, w = rgba.shape[:2]
        if isinstance(rgba, np.ndarray):
            rgba = np.ascontiguousarray(rgba)
        pics.append(Pic(pixels=rgba, width=w, height=h,
                        depth=32, pitch=w * 4, format=PixelFormat.RGBA32,
                        codec="ICO", meta=meta))
    return pics


def info(pic: Pic) -> str:
    m = pic.meta
    lines = [f"ICO file format ({m['kind']}, {len(m['entries'])} images)"]
    for e in m["entries"]:
        lines.append(f"\t{e['width']}x{e['height']} bpp {e['bpp']} "
                     f"size {e['size']}")
    return "\n".join(lines)


register(Codec(name="ICO", alias="CUR", probe=probe, decode=decode, info=info))
