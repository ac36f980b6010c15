"""BMP codec of the port.

Copied from ``ffpic_tpu/formats/bmp.py`` (``probe``, ``_decode_rle``
``:29``, ``_mask_shift`` ``:80``, ``load`` ``:88``, ``info`` ``:185``,
``encode`` ``:193``): 1/4/8-bit palette with RLE8/RLE4, 16/24/32-bit
with BI_BITFIELDS masks, top-down and bottom-up; the encoder writes the
32 bpp top-down BGRA file of the reference's bmpwriter.  The host decode
is ``decode``; the registry's ``load`` stages its pixels to the device,
and ``encode`` runs on the host whatever ``device`` is.  A header that
claims more than ``staging.MAX_PIXELS`` pixels raises ``ValueError``
before anything is allocated.
"""

from __future__ import annotations

import struct

import numpy as np

from ffpic_tpu_torch.formats.pic import Pic, PixelFormat
from ffpic_tpu_torch.formats.registry import Codec, register
from ffpic_tpu_torch.formats.staging import check_size

BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS = 0, 1, 2, 3


def probe(data: bytes) -> bool:
    return len(data) > 54 and data[:2] == b"BM"


def _decode_rle(data: bytes, w: int, h: int, bpp4: bool) -> np.ndarray:
    """RLE8/RLE4 decode (reference bmp.c:44-145). Returns (h, w) palette
    indices, bottom-up row order (flipped by caller)."""
    out = np.zeros((h, w), np.uint8)
    x = y = 0
    i = 0
    n = len(data)
    while i + 1 < n and y < h:
        cnt, val = data[i], data[i + 1]
        i += 2
        if cnt > 0:
            if bpp4:
                hi, lo = val >> 4, val & 0xF
                for k in range(cnt):
                    if x < w:
                        out[y, x] = hi if (k % 2 == 0) else lo
                        x += 1
            else:
                end = min(x + cnt, w)
                out[y, x:end] = val
                x = end
        else:
            if val == 0:        # end of line
                x, y = 0, y + 1
            elif val == 1:      # end of bitmap
                break
            elif val == 2:      # delta
                if i + 1 < n:
                    x += data[i]
                    y += data[i + 1]
                    i += 2
            else:               # absolute run
                cnt2 = val
                if bpp4:
                    nb = (cnt2 + 1) // 2
                    for k in range(cnt2):
                        b = data[i + k // 2]
                        v = (b >> 4) if (k % 2 == 0) else (b & 0xF)
                        if x < w:
                            out[y, x] = v
                            x += 1
                    i += nb + (nb & 1)  # pad to word
                else:
                    for k in range(cnt2):
                        if x < w:
                            out[y, x] = data[i + k]
                            x += 1
                    i += cnt2 + (cnt2 & 1)
    return out


def _mask_shift(mask: int) -> tuple[int, int]:
    if mask == 0:
        return 0, 8
    shift = (mask & -mask).bit_length() - 1
    width = (mask >> shift).bit_length()
    return shift, width


def decode(data: bytes, skip_decode: bool = False, *,
           device) -> list[Pic]:
    """The file's picture with its pixels on the host (``device`` is
    not used: BMP has no nested decode)."""
    (bfsize, _res, offset) = struct.unpack_from("<III", data, 2)
    hdrsize = struct.unpack_from("<I", data, 14)[0]
    if hdrsize >= 40:
        w, h, planes, bpp, comp, imgsize = struct.unpack_from(
            "<iiHHII", data, 18)
        clr_used = struct.unpack_from("<I", data, 46)[0] if hdrsize >= 36 else 0
    else:  # BITMAPCOREHEADER
        w, h, planes, bpp = struct.unpack_from("<hhHH", data, 18)
        comp, imgsize, clr_used = 0, 0, 0
    top_down = h < 0
    h = abs(h)

    meta = dict(width=w, height=h, bpp=bpp, compression=comp,
                header_size=hdrsize, top_down=top_down, colors_used=clr_used)
    if skip_decode:
        return [Pic(width=w, height=h, depth=32, pitch=w * 4,
                    codec="BMP", meta=meta)]
    check_size(w, h, "BMP")

    # palette (BGRA quads after the info header)
    pal = None
    if bpp <= 8:
        ncolors = clr_used or (1 << bpp)
        pal_off = 14 + hdrsize
        pal = np.frombuffer(data, np.uint8, ncolors * 4, pal_off) \
            .reshape(ncolors, 4).copy()
        pal[:, 3] = 255  # palette alpha is reserved/0 on disk

    if comp in (BI_RLE8, BI_RLE4):
        idx = _decode_rle(data[offset:], w, h, comp == BI_RLE4)
        if not top_down:
            idx = idx[::-1]
        bgra = pal[idx]
    elif bpp <= 8:
        pitch = ((w * bpp + 31) // 32) * 4
        rows = np.frombuffer(data, np.uint8, pitch * h, offset) \
            .reshape(h, pitch)
        if bpp == 8:
            idx = rows[:, :w]
        else:
            bits = np.unpackbits(rows, axis=1)
            if bpp == 1:
                idx = bits[:, :w]
            elif bpp == 4:
                idx = (bits.reshape(h, -1, 4) *
                       np.array([8, 4, 2, 1])).sum(axis=2)[:, :w].astype(np.uint8)
            else:
                raise ValueError(f"unsupported bpp {bpp}")
        if not top_down:
            idx = idx[::-1]
        bgra = pal[idx]
    elif bpp == 24:
        pitch = ((w * 3 + 3) // 4) * 4
        rows = np.frombuffer(data, np.uint8, pitch * h, offset).reshape(h, pitch)
        bgr = rows[:, :w * 3].reshape(h, w, 3)
        if not top_down:
            bgr = bgr[::-1]
        bgra = np.dstack([bgr, np.full((h, w), 255, np.uint8)])
    elif bpp in (16, 32):
        nbytes = bpp // 8
        pitch = ((w * nbytes + 3) // 4) * 4
        rows = np.frombuffer(data, np.uint8, pitch * h, offset).reshape(h, pitch)
        raw = rows[:, :w * nbytes].reshape(h, w, nbytes)
        vals = raw.astype(np.uint32)
        word = vals[..., 0]
        for b in range(1, nbytes):
            word |= vals[..., b] << (8 * b)
        if comp == BI_BITFIELDS:
            rm, gm, bm = struct.unpack_from("<III", data, 54)
            am = struct.unpack_from("<I", data, 66)[0] if hdrsize >= 56 else 0
        elif bpp == 16:
            rm, gm, bm, am = 0x7C00, 0x03E0, 0x001F, 0
        else:
            rm, gm, bm, am = 0xFF0000, 0x00FF00, 0x0000FF, 0xFF000000

        def chan(mask):
            if mask == 0:
                return np.full((h, w), 255, np.uint8)
            sh, bw = _mask_shift(mask)
            v = (word & mask) >> sh
            if bw < 8:  # expand to 8 bits
                v = (v * 255) // ((1 << bw) - 1)
            return v.astype(np.uint8)

        r, g, b = chan(rm), chan(gm), chan(bm)
        a = chan(am) if am else np.full((h, w), 255, np.uint8)
        bgra = np.stack([b, g, r, a], axis=-1)
        if not top_down:
            bgra = bgra[::-1]
    else:
        raise ValueError(f"unsupported bmp bpp {bpp}")

    rgba = np.ascontiguousarray(bgra[..., [2, 1, 0, 3]])
    return [Pic(pixels=rgba, width=w, height=h, depth=32, pitch=w * 4,
                format=PixelFormat.RGBA32, codec="BMP", meta=meta)]


def info(pic: Pic) -> str:
    m = pic.meta
    return (f"BMP file format\n"
            f"\twidth {m['width']}, height {m['height']}, bpp {m['bpp']}\n"
            f"\tcompression {m['compression']}, header {m['header_size']}, "
            f"{'top-down' if m['top_down'] else 'bottom-up'}")


def encode(pic: Pic, *, device=None, **options) -> bytes:
    """32bpp top-down BGRA BMP, byte for byte the reference's bmpwriter
    sink; on the host whatever ``device`` is."""
    bgra = pic.to_bgra32()
    h, w = bgra.shape[:2]
    img = bgra.tobytes()
    hdr = struct.pack("<2sIHHI", b"BM", 14 + 40 + len(img), 0, 0, 14 + 40)
    # negative height = top-down
    ihdr = struct.pack("<IiiHHIIiiII", 40, w, -h, 1, 32, 0, len(img),
                       2835, 2835, 0, 0)
    return hdr + ihdr + img


register(Codec(name="BMP", alias="DIB", probe=probe, decode=decode, info=info,
               encode=encode))
