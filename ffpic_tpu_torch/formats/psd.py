"""PSD codec of the port.

Copied from ``ffpic_tpu/formats/psd.py``: the header, colour-mode,
resource and layer-record walk and the composite image, raw or PackBits
rows (``_unpackbits_rows`` ``:20``, ``load`` ``:42``); RGB, grey,
duotone, indexed and CMYK, 8 and 16 bits.  The host decode is
``decode``; the registry's ``load`` stages its pixels to the device.
Two deliberate differences on corrupt files, both ``ValueError`` before
any allocation: a picture of more than ``staging.MAX_PIXELS`` pixels,
and a table of row counts that runs past the end of the file (the
original builds a ``struct`` format of ``h * channels`` letters first,
as the TIFF original does with a tag's count).
"""

from __future__ import annotations

import struct

import numpy as np

from ffpic_tpu_torch.formats.pic import Pic, PixelFormat
from ffpic_tpu_torch.formats.registry import Codec, register
from ffpic_tpu_torch.formats.staging import check_size


def probe(data: bytes) -> bool:
    return data[:4] == b"8BPS" and len(data) > 26


def _unpackbits_rows(data: bytes, counts: np.ndarray, h: int,
                     stride: int) -> np.ndarray:
    out = np.zeros((h, stride), np.uint8)
    pos = 0
    for y in range(h):
        row = bytearray()
        end = pos + int(counts[y])
        p = pos
        while p < end and len(row) < stride:
            c = data[p]
            p += 1
            if c < 128:
                row += data[p:p + c + 1]
                p += c + 1
            elif c > 128:
                row += bytes([data[p]]) * (257 - c)
                p += 1
        out[y, :len(row)] = np.frombuffer(bytes(row[:stride]), np.uint8)
        pos = end
    return out


def decode(data: bytes, skip_decode: bool = False, *,
           device) -> list[Pic]:
    """The composite image, pixels on the host (``device`` is not used:
    no nested decode)."""
    sig, ver, _r1, _r2, nch, h, w, depth, mode = struct.unpack_from(
        ">4sH4sHHIIHH", data, 0)
    mode_names = {0: "bitmap", 1: "grayscale", 2: "indexed", 3: "RGB",
                  4: "CMYK", 7: "multichannel", 8: "duotone", 9: "Lab"}
    meta = dict(width=w, height=h, channels=nch, depth=depth,
                mode=mode_names.get(mode, str(mode)), layers=[])
    pos = 26
    cm_len = struct.unpack_from(">I", data, pos)[0]
    cm_data = data[pos + 4:pos + 4 + cm_len]
    pos += 4 + cm_len
    res_len = struct.unpack_from(">I", data, pos)[0]
    pos += 4 + res_len
    lm_len = struct.unpack_from(">I", data, pos)[0]
    # layer records: count + per-layer rect/channels/blend (names only)
    if lm_len >= 6:
        lpos = pos + 4
        linfo_len = struct.unpack_from(">I", data, lpos)[0]
        if linfo_len >= 2:
            nlayers = abs(struct.unpack_from(">h", data, lpos + 4)[0])
            meta["layers"] = [f"layer{i}" for i in range(nlayers)]
    pos += 4 + lm_len

    if skip_decode:
        return [Pic(width=w, height=h, depth=32, pitch=w * 4, codec="PSD",
                    meta=meta)]

    check_size(w, h, "PSD")
    # composite image data
    comp = struct.unpack_from(">H", data, pos)[0]
    pos += 2
    stride = w * (depth // 8)
    planes = []
    if comp == 0:
        for c in range(nch):
            planes.append(np.frombuffer(data, np.uint8, stride * h, pos)
                          .reshape(h, stride))
            pos += stride * h
    elif comp == 1:
        cnt_sz = 2 if ver == 1 else 4
        if pos + cnt_sz * h * nch > len(data):
            raise ValueError("PSD: row counts past the end of the file")
        fmt = ">" + ("H" if ver == 1 else "I") * (h * nch)
        counts = np.array(struct.unpack_from(fmt, data, pos)) \
            .reshape(nch, h)
        pos += cnt_sz * h * nch
        for c in range(nch):
            total = int(counts[c].sum())
            planes.append(_unpackbits_rows(data[pos:pos + total], counts[c],
                                           h, stride))
            pos += total
    else:
        raise ValueError(f"unsupported PSD compression {comp}")

    def to8(plane):
        if depth == 16:
            return plane.reshape(h, w, 2)[..., 0]  # big-endian high byte
        return plane[:, :w]

    if mode == 3 and nch >= 3:       # RGB(A)
        r, g, b = to8(planes[0]), to8(planes[1]), to8(planes[2])
        a = to8(planes[3]) if nch > 3 else np.full((h, w), 255, np.uint8)
        rgba = np.dstack([r, g, b, a])
    elif mode in (1, 8) and nch >= 1:  # gray / duotone
        g = to8(planes[0])
        a = to8(planes[1]) if nch > 1 else np.full((h, w), 255, np.uint8)
        rgba = np.dstack([g, g, g, a])
    elif mode == 2 and cm_len >= 768:  # indexed
        pal = np.frombuffer(cm_data, np.uint8, 768).reshape(3, 256).T
        idx = to8(planes[0])
        rgba = np.dstack([pal[idx], np.full((h, w), 255, np.uint8)])
    elif mode == 4 and nch >= 4:     # CMYK (stored inverted)
        c, m_, y_, k = (to8(p).astype(np.int32) for p in planes[:4])
        r = (c * k) // 255
        g = (m_ * k) // 255
        b = (y_ * k) // 255
        rgba = np.dstack([r.astype(np.uint8), g.astype(np.uint8),
                          b.astype(np.uint8),
                          np.full((h, w), 255, np.uint8)])
    else:
        g = to8(planes[0])
        rgba = np.dstack([g, g, g, np.full((h, w), 255, np.uint8)])

    return [Pic(pixels=np.ascontiguousarray(rgba), width=w, height=h,
                depth=32, pitch=w * 4, format=PixelFormat.RGBA32,
                codec="PSD", meta=meta)]


def info(pic: Pic) -> str:
    m = pic.meta
    return ("PSD file format\n"
            f"\twidth {m['width']}, height {m['height']}\n"
            f"\tchannels {m['channels']}, depth {m['depth']}, "
            f"mode {m['mode']}\n"
            f"\tlayers {len(m['layers'])}")


register(Codec(name="PSD", alias="PHOTOSHOP", probe=probe, decode=decode,
               info=info))
