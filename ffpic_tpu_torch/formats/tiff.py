"""TIFF codec of the port.

Copied from ``ffpic_tpu/formats/tiff.py``: the IFD walk (``load``
``:260``, with ``_read_ifd`` ``:47`` and ``_first`` from the port's
``formats.tiff_tags``), strips and tiles, none, PackBits, deflate and
LZW (through the port's native decoder) with the horizontal predictor,
bilevel, grey, palette and RGB, every IFD a picture, and JPEG-in-TIFF
(``:140-162``): each strip or tile, with the JPEGTables tag spliced in,
goes through the port's ``jpg.load(mode="bt601")`` on the device (K2,
K4) and its pixels come back to the host.  The host decode is
``decode``; the registry's ``load`` stages its pixels to the device.
One deliberate difference: a tag whose count of values runs past the end
of the file raises ``ValueError`` before its ``struct`` format is built
(``tiff_tags._read_ifd``).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from ffpic_tpu_torch.coding.lzw import lzw_decode_tiff
from ffpic_tpu_torch.formats import jpg
from ffpic_tpu_torch.formats.pic import Pic, PixelFormat
from ffpic_tpu_torch.formats.registry import Codec, register
from ffpic_tpu_torch.formats.tiff_tags import _first, _read_ifd


def probe(data: bytes) -> bool:
    return data[:4] in (b"II*\x00", b"MM\x00*")


def _packbits(data: bytes, max_out: int) -> bytes:
    out = bytearray()
    pos = 0
    n = len(data)
    while pos < n and len(out) < max_out:
        c = data[pos]
        pos += 1
        if c < 128:
            out += data[pos:pos + c + 1]
            pos += c + 1
        elif c > 128:
            if pos < n:
                out += bytes([data[pos]]) * (257 - c)
                pos += 1
    return bytes(out)


def _ifirst(tags, tag, default=None):
    """Integer tag value; corrupted type/count fields can make the
    IFD reader hand back bytes or lists where scalars belong — treat
    any non-int as a corrupt file, not a TypeError."""
    v = _first(tags, tag, default)
    if v is not None and not isinstance(v, int):
        raise ValueError(f"TIFF: corrupt tag {tag} type")
    return v


def _decode_ifd(data: bytes, tags: dict, bo: str,
                device: torch.device) -> Pic | None:
    w = _ifirst(tags, 256)
    h = _ifirst(tags, 257)
    if not w or not h:
        return None
    bits = tags.get(258, [1])
    if isinstance(bits, list):
        bps = bits[0] if bits else 1
    else:
        bps = bits
    if not isinstance(bps, int):
        raise ValueError("TIFF: corrupt bits-per-sample tag")
    comp = _ifirst(tags, 259, 1)
    photo = _ifirst(tags, 262, 1)
    spp = _ifirst(tags, 277, 1)
    # fuzzed IFD fields otherwise drive the decompress targets into
    # gigabyte territory (stride*h allocations + LZW want sizes)
    if not (0 < w < 65536 and 0 < h < 65536):
        raise ValueError("TIFF: corrupt image dimensions")
    if not (1 <= spp <= 8) or bps not in (1, 2, 4, 8, 16, 32):
        raise ValueError("TIFF: corrupt samples/bits per sample")
    if w * h * spp > (1 << 28):
        raise ValueError("TIFF: image exceeds sample budget")
    predictor = _ifirst(tags, 317, 1)
    rows_per_strip = _ifirst(tags, 278, h)
    offsets = tags.get(273, [])
    counts = tags.get(279, [])
    if not isinstance(offsets, list):
        offsets = [offsets]
    if not isinstance(counts, list):
        counts = [counts]
    if not all(isinstance(x, int) for x in offsets + counts):
        raise ValueError("TIFF: corrupt strip offset/count tags")

    if comp == 7 and photo == 6:
        photo = 2        # the embedded JPEG decoder already outputs RGB

    def _decomp(blob: bytes, want: int, row_w: int = 0) -> bytes:
        if comp == 1:
            return blob[:want]
        if comp == 5:
            return lzw_decode_tiff(blob, want)
        if comp == 32773:
            return _packbits(blob, want)
        if comp in (8, 32946):
            try:
                return zlib.decompress(blob)[:want]
            except zlib.error as e:
                raise ValueError(f"TIFF: bad deflate stream: {e}")
        if comp == 7:
            # JPEG-in-TIFF (TIFF/EP style): each strip/tile is an
            # abbreviated JPEG stream; tag 347 (JPEGTables) holds the
            # shared DQT/DHT wrapped in its own SOI...EOI — splice its
            # body after the strip's SOI (the reference's tiff.c stops
            # at LZW/PackBits/deflate)
            stream = blob
            tables = tags.get(347)
            if isinstance(tables, (bytes, bytearray)) \
                    and len(tables) > 4 and stream[:2] == b"\xff\xd8":
                stream = stream[:2] + bytes(tables[2:-2]) + stream[2:]
            px = jpg.load(stream, device=device,
                          mode="bt601")[0].np_pixels()
            if row_w:
                # the JPEG decoder pads rows to the MCU width; crop to
                # the strip/tile raster width or rows after the first
                # are skewed for widths not a multiple of the MCU size
                px = px[:, :row_w]
            if spp == 1:
                out = px[..., 0]
            else:
                out = px[..., :spp]
            return np.ascontiguousarray(out).tobytes()[:want]
        raise ValueError(f"unsupported TIFF compression {comp}")

    stride = (w * spp * bps + 7) // 8
    tile_w = _ifirst(tags, 322, 0)
    tile_h = _ifirst(tags, 323, 0)
    if (tile_w or tile_h) and not (0 < tile_w < 65536
                                   and 0 < tile_h < 65536
                                   and tile_w * tile_h <= (1 << 24)):
        raise ValueError("TIFF: corrupt tile dimensions")
    if tile_w and tile_h:
        # tiled organization (beyond the reference, tiff.c is
        # strips-only): decode each tile and paste into the raster
        t_offsets = tags.get(324, [])
        t_counts = tags.get(325, [])
        if not isinstance(t_offsets, list):
            t_offsets = [t_offsets]
        if not isinstance(t_counts, list):
            t_counts = [t_counts]
        if not all(isinstance(x, int) for x in t_offsets + t_counts):
            raise ValueError("TIFF: corrupt tile offset/count tags")
        tiles_x = -(-w // tile_w)
        t_stride = (tile_w * spp * bps + 7) // 8
        rows_buf = np.zeros((h, stride), np.uint8)
        for idx, (off, cnt) in enumerate(zip(t_offsets, t_counts)):
            want = t_stride * tile_h
            td = _decomp(data[off:off + cnt], want, row_w=tile_w)
            td = bytes(td[:want]).ljust(want, b"\0")
            tarr = np.frombuffer(td, np.uint8).reshape(tile_h, t_stride)
            ty, tx = divmod(idx, tiles_x)
            y0t, x0t = ty * tile_h, tx * tile_w
            hh = min(tile_h, h - y0t)
            bw = min(t_stride, stride - x0t * spp * bps // 8)
            if hh <= 0 or bw <= 0:
                continue
            rows_buf[y0t:y0t + hh,
                     x0t * spp * bps // 8:x0t * spp * bps // 8 + bw] \
                = tarr[:hh, :bw]
        rows = rows_buf
    else:
        raw = bytearray()
        for off, cnt in zip(offsets, counts):
            nrows = min(rows_per_strip, h - len(raw) // stride)
            raw += _decomp(data[off:off + cnt], stride * nrows, row_w=w)
        raw = bytes(raw[:stride * h]).ljust(stride * h, b"\0")
        rows = np.frombuffer(raw, np.uint8).reshape(h, stride)

    if bps == 1:
        bitsarr = np.unpackbits(rows, axis=1)[:, :w]
        # photometric 0 = WhiteIsZero
        g = np.where(bitsarr == (0 if photo == 0 else 1), 255, 0) \
            .astype(np.uint8)
        rgba = np.dstack([g, g, g, np.full((h, w), 255, np.uint8)])
    elif bps == 8:
        px = rows[:, :w * spp].reshape(h, w, spp)
        if predictor == 2:
            px = np.cumsum(px.astype(np.int64), axis=1).astype(np.uint8)
        if photo == 3:  # palette
            cmap = tags.get(320, [])
            ncol = 1 << bps
            pal = np.zeros((ncol, 4), np.uint8)
            pal[:, 3] = 255
            for c in range(3):
                pal[:, c] = (np.array(cmap[c * ncol:(c + 1) * ncol]) >> 8) \
                    .astype(np.uint8)
            rgba = pal[px[..., 0]]
        elif spp == 1:
            g = px[..., 0] if photo != 0 else 255 - px[..., 0]
            rgba = np.dstack([g, g, g, np.full((h, w), 255, np.uint8)])
        elif spp == 3:
            rgba = np.dstack([px, np.full((h, w), 255, np.uint8)])
        else:
            rgba = px[..., :4].copy()
    elif bps == 16:
        bo_np = "<" if bo == "<" else ">"
        px = np.frombuffer(rows.tobytes(), bo_np + "u2") \
            .reshape(h, -1)[:, :w * spp].reshape(h, w, spp)
        if predictor == 2:
            px = np.cumsum(px.astype(np.int64), axis=1).astype(np.uint16)
        px8 = (px >> 8).astype(np.uint8)
        if spp == 1:
            g = px8[..., 0]
            rgba = np.dstack([g, g, g, np.full((h, w), 255, np.uint8)])
        else:
            rgba = np.dstack([px8[..., :3],
                              np.full((h, w), 255, np.uint8)]) if spp == 3 \
                else px8[..., :4].copy()
    else:
        raise ValueError(f"unsupported bits/sample {bps}")

    meta = dict(width=w, height=h, bits=bps, samples=spp, photometric=photo,
                compression=comp, predictor=predictor,
                description=tags.get(270, ""), software=tags.get(305, ""))
    return Pic(pixels=np.ascontiguousarray(rgba), width=w, height=h,
               depth=32, pitch=w * 4, format=PixelFormat.RGBA32,
               codec="TIFF", meta=meta)


def decode(data: bytes, skip_decode: bool = False, *,
           device) -> list[Pic]:
    """Every IFD's picture, pixels on the host; JPEG strips and tiles
    decode on ``device`` and come back (a header-only parse needs no
    device)."""
    bo = "<" if data[:2] == b"II" else ">"
    pos = struct.unpack_from(bo + "I", data, 4)[0]
    pics = []
    seen = set()
    while pos and pos not in seen and pos < len(data):
        seen.add(pos)
        tags, pos = _read_ifd(data, pos, bo)
        if skip_decode:
            w, h = _first(tags, 256, 0), _first(tags, 257, 0)
            pics.append(Pic(width=w, height=h, depth=32, pitch=w * 4,
                            codec="TIFF",
                            meta=dict(width=w, height=h,
                                      compression=_first(tags, 259, 1),
                                      tags=sorted(tags))))
            continue
        p = _decode_ifd(data, tags, bo, device)
        if p is not None:
            pics.append(p)
    return pics


def info(pic: Pic) -> str:
    m = pic.meta
    comp_names = {1: "none", 5: "LZW", 8: "deflate", 32773: "PackBits",
                  32946: "deflate"}
    lines = ["TIFF file format",
             f"\twidth {m['width']}, height {m['height']}"]
    if "bits" in m:
        lines.append(f"\tbits {m['bits']}, samples {m['samples']}, "
                     f"photometric {m['photometric']}")
    lines.append(f"\tcompression {comp_names.get(m['compression'], m['compression'])}")
    return "\n".join(lines)


register(Codec(name="TIFF", alias="TIF", probe=probe, decode=decode,
               info=info))
