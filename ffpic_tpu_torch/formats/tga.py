"""TGA codec of the port.

Copied from ``ffpic_tpu/formats/tga.py`` (``probe`` ``:15``, which has
no magic and is probed last, ``_rle_decode``, ``load``, ``info``,
``encode``): colormapped, truecolor and grayscale, uncompressed and RLE,
both origins; the encoder writes 32 bpp uncompressed, top origin.  The
host decode is ``decode``; the registry's ``load`` stages its pixels to
the device.
"""

from __future__ import annotations

import struct

import numpy as np

from ffpic_tpu_torch.formats.pic import Pic, PixelFormat
from ffpic_tpu_torch.formats.registry import Codec, register


def probe(data: bytes) -> bool:
    if len(data) < 18:
        return False
    # TGA has no magic; validate header fields like the reference does
    cmap_type = data[1]
    img_type = data[2]
    bpp = data[16]
    if cmap_type > 1 or img_type not in (0, 1, 2, 3, 9, 10, 11):
        return False
    if bpp not in (8, 15, 16, 24, 32):
        return False
    # v2 footer signature is definitive when present
    if data[-18:-2] == b"TRUEVISION-XFILE":
        return True
    w, h = struct.unpack_from("<HH", data, 12)
    return 0 < w <= 16384 and 0 < h <= 16384 and img_type != 0


def _rle_decode(data: bytes, count: int, nb: int) -> bytes:
    out = bytearray()
    pos = 0
    while len(out) < count * nb and pos < len(data):
        hdr = data[pos]
        pos += 1
        n = (hdr & 0x7F) + 1
        if hdr & 0x80:
            out += data[pos:pos + nb] * n
            pos += nb
        else:
            out += data[pos:pos + n * nb]
            pos += n * nb
    return bytes(out)


def decode(data: bytes, skip_decode: bool = False, *,
           device) -> list[Pic]:
    """The file's pictures with their pixels on the host (``device``
    is not used: no nested decode)."""
    (id_len, cmap_type, img_type) = data[0], data[1], data[2]
    cmap_first, cmap_len, cmap_bpp = struct.unpack_from("<HHB", data, 3)
    x0, y0, w, h = struct.unpack_from("<HHHH", data, 8)
    bpp = data[16]
    desc = data[17]
    top_origin = bool(desc & 0x20)
    meta = dict(width=w, height=h, bpp=bpp, img_type=img_type,
                colormap=cmap_len, top_origin=top_origin)
    if skip_decode:
        return [Pic(width=w, height=h, depth=32, pitch=w * 4, codec="TGA",
                    meta=meta)]

    pos = 18 + id_len
    cmap = None
    if cmap_type:
        nb = (cmap_bpp + 7) // 8
        raw = np.frombuffer(data, np.uint8, cmap_len * nb, pos) \
            .reshape(cmap_len, nb)
        pos += cmap_len * nb
        cmap = np.zeros((cmap_first + cmap_len, 4), np.uint8)
        cmap[:, 3] = 255
        if nb == 3:
            cmap[cmap_first:, :3] = raw[:, [2, 1, 0]]
        elif nb == 4:
            cmap[cmap_first:] = raw[:, [2, 1, 0, 3]]
        elif nb == 2:
            v = raw[:, 0].astype(np.uint16) | (raw[:, 1].astype(np.uint16) << 8)
            cmap[cmap_first:, 0] = ((v >> 10) & 31) * 255 // 31
            cmap[cmap_first:, 1] = ((v >> 5) & 31) * 255 // 31
            cmap[cmap_first:, 2] = (v & 31) * 255 // 31

    nb = (bpp + 7) // 8
    if img_type >= 9:
        pix = np.frombuffer(_rle_decode(data[pos:], w * h, nb), np.uint8,
                            w * h * nb).reshape(h, w, nb)
    else:
        pix = np.frombuffer(data, np.uint8, w * h * nb, pos) \
            .reshape(h, w, nb)

    if img_type in (1, 9):          # colormapped
        rgba = cmap[pix[..., 0]]
    elif img_type in (3, 11):       # grayscale
        g = pix[..., 0]
        rgba = np.dstack([g, g, g, np.full((h, w), 255, np.uint8)])
    else:                            # truecolor BGR(A) / 16-bit
        if nb == 2:
            v = pix[..., 0].astype(np.uint16) | \
                (pix[..., 1].astype(np.uint16) << 8)
            r = (((v >> 10) & 31) * 255 // 31).astype(np.uint8)
            g = (((v >> 5) & 31) * 255 // 31).astype(np.uint8)
            b = ((v & 31) * 255 // 31).astype(np.uint8)
            rgba = np.dstack([r, g, b, np.full((h, w), 255, np.uint8)])
        elif nb == 3:
            rgba = np.dstack([pix[..., [2, 1, 0]],
                              np.full((h, w), 255, np.uint8)])
        else:
            rgba = pix[..., [2, 1, 0, 3]]

    if not top_origin:
        rgba = rgba[::-1]
    rgba = np.ascontiguousarray(rgba)
    return [Pic(pixels=rgba, width=w, height=h, depth=32, pitch=w * 4,
                format=PixelFormat.RGBA32, codec="TGA", meta=meta)]


def info(pic: Pic) -> str:
    m = pic.meta
    kinds = {0: "none", 1: "colormap", 2: "truecolor", 3: "gray",
             9: "RLE colormap", 10: "RLE truecolor", 11: "RLE gray"}
    return (f"TGA file format\n\twidth {m['width']}, height {m['height']}, "
            f"bpp {m['bpp']}\n\ttype {kinds.get(m['img_type'])}, "
            f"colormap {m['colormap']} entries")


def encode(pic: Pic, *, device=None, **options) -> bytes:
    """On the host whatever ``device`` is."""
    rgba = pic.to_rgba32()
    h, w = rgba.shape[:2]
    hdr = bytearray(18)
    hdr[2] = 2            # uncompressed truecolor
    struct.pack_into("<HH", hdr, 12, w, h)
    hdr[16] = 32
    hdr[17] = 0x28        # top-origin, 8 alpha bits
    return bytes(hdr) + rgba[..., [2, 1, 0, 3]].tobytes()


register(Codec(name="TGA", alias="TARGA", probe=probe, decode=decode,
               info=info, encode=encode))
