"""PNM/PAM codec of the port.

Copied from ``ffpic_tpu/formats/pnm.py`` (``probe``, ``_tokens``,
``load``, ``info``, ``encode``): P1-P7, ASCII and binary, maxval scaling
and PAM with alpha; the encoder writes P6. The host decode is
``decode``; the registry's ``load`` stages its pixels to the device.
"""

from __future__ import annotations

import re

import numpy as np

from ffpic_tpu_torch.formats.pic import Pic, PixelFormat
from ffpic_tpu_torch.formats.registry import Codec, register


def probe(data: bytes) -> bool:
    return len(data) > 2 and data[0:1] == b"P" and data[1:2] in b"1234567"


def _tokens(data: bytes, start: int):
    """Yield whitespace-separated tokens skipping '#' comments."""
    pos = start
    n = len(data)
    while pos < n:
        while pos < n and data[pos:pos + 1].isspace():
            pos += 1
        if pos < n and data[pos] == ord("#"):
            while pos < n and data[pos] not in (10, 13):
                pos += 1
            continue
        t0 = pos
        while pos < n and not data[pos:pos + 1].isspace():
            pos += 1
        if pos > t0:
            yield data[t0:pos], pos


def decode(data: bytes, skip_decode: bool = False, *,
           device) -> list[Pic]:
    """The file's pictures with their pixels on the host (``device``
    is not used: no nested decode)."""
    magic = data[:2].decode()
    kind = int(magic[1])

    if kind == 7:  # PAM
        header = {}
        pos = 2
        while True:
            eol = data.index(b"\n", pos)
            line = data[pos:eol].decode("latin1").strip()
            pos = eol + 1
            if line.startswith("#") or not line:
                continue
            if line == "ENDHDR":
                break
            k, _, v = line.partition(" ")
            header[k] = v.strip()
        w = int(header["WIDTH"])
        h = int(header["HEIGHT"])
        depth = int(header["DEPTH"])
        maxval = int(header["MAXVAL"])
        meta = dict(width=w, height=h, kind=7, maxval=maxval, depth=depth,
                    tupltype=header.get("TUPLTYPE", ""))
        if skip_decode:
            return [Pic(width=w, height=h, depth=32, pitch=w * 4,
                        codec="PNM", meta=meta)]
        dt = np.dtype(">u2") if maxval > 255 else np.uint8
        arr = np.frombuffer(data, dt, w * h * depth, pos) \
            .reshape(h, w, depth).astype(np.float32)
        arr8 = np.clip(arr * 255.0 / maxval + 0.5, 0, 255).astype(np.uint8)
        if depth == 1:
            rgba = np.dstack([arr8[..., 0]] * 3 +
                             [np.full((h, w), 255, np.uint8)])
        elif depth == 2:
            rgba = np.dstack([arr8[..., 0]] * 3 + [arr8[..., 1]])
        elif depth == 3:
            rgba = np.dstack([arr8, np.full((h, w), 255, np.uint8)])
        else:
            rgba = arr8[..., :4]
        return [Pic(pixels=rgba, width=w, height=h, depth=32, pitch=w * 4,
                    format=PixelFormat.RGBA32, codec="PNM", meta=meta)]

    toks = _tokens(data, 2)
    w_b, pos = next(toks)
    h_b, pos = next(toks)
    w, h = int(w_b), int(h_b)
    maxval = 1
    if kind not in (1, 4):
        mv_b, pos = next(toks)
        maxval = int(mv_b)
    meta = dict(width=w, height=h, kind=kind, maxval=maxval)
    if skip_decode:
        return [Pic(width=w, height=h, depth=32, pitch=w * 4, codec="PNM",
                    meta=meta)]

    if kind in (1, 2, 3):  # ascii
        vals = []
        need = w * h * (3 if kind == 3 else 1)
        for t, pos in toks:
            vals.append(int(t))
            if len(vals) >= need:
                break
        arr = np.array(vals, np.int32)
        if kind == 1:
            gray = np.where(arr.reshape(h, w) == 1, 0, 255).astype(np.uint8)
            rgba = np.dstack([gray] * 3 + [np.full((h, w), 255, np.uint8)])
        elif kind == 2:
            gray = np.clip(arr.reshape(h, w) * 255.0 / maxval + 0.5,
                           0, 255).astype(np.uint8)
            rgba = np.dstack([gray] * 3 + [np.full((h, w), 255, np.uint8)])
        else:
            rgb = np.clip(arr.reshape(h, w, 3) * 255.0 / maxval + 0.5,
                          0, 255).astype(np.uint8)
            rgba = np.dstack([rgb, np.full((h, w), 255, np.uint8)])
    else:  # binary: pos currently at end of last header token; skip 1 ws
        start = pos + 1
        if kind == 4:
            stride = (w + 7) // 8
            rows = np.frombuffer(data, np.uint8, stride * h, start) \
                .reshape(h, stride)
            bits = np.unpackbits(rows, axis=1)[:, :w]
            gray = np.where(bits == 1, 0, 255).astype(np.uint8)
            rgba = np.dstack([gray] * 3 + [np.full((h, w), 255, np.uint8)])
        else:
            nch = 3 if kind == 6 else 1
            dt = np.dtype(">u2") if maxval > 255 else np.uint8
            arr = np.frombuffer(data, dt, w * h * nch, start) \
                .reshape(h, w, nch).astype(np.float32)
            arr8 = np.clip(arr * 255.0 / maxval + 0.5, 0, 255) \
                .astype(np.uint8)
            if nch == 1:
                rgba = np.dstack([arr8[..., 0]] * 3 +
                                 [np.full((h, w), 255, np.uint8)])
            else:
                rgba = np.dstack([arr8, np.full((h, w), 255, np.uint8)])
    return [Pic(pixels=rgba, width=w, height=h, depth=32, pitch=w * 4,
                format=PixelFormat.RGBA32, codec="PNM", meta=meta)]


def info(pic: Pic) -> str:
    m = pic.meta
    names = {1: "PBM ascii", 2: "PGM ascii", 3: "PPM ascii", 4: "PBM raw",
             5: "PGM raw", 6: "PPM raw", 7: "PAM"}
    return (f"PNM file format ({names.get(m['kind'])})\n"
            f"\twidth {m['width']}, height {m['height']}, "
            f"maxval {m.get('maxval', 1)}")


def encode(pic: Pic, *, device=None, **options) -> bytes:
    """On the host whatever ``device`` is."""
    rgb = pic.to_rgba32()[..., :3]
    h, w = rgb.shape[:2]
    return f"P6\n{w} {h}\n255\n".encode() + rgb.tobytes()


register(Codec(name="PNM", alias="PPM", probe=probe, decode=decode, info=info,
               encode=encode))
