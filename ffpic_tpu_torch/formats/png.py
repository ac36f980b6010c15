"""PNG codec of the port: host chunk walk, inflate and (for Average or
Paeth rows) unfilter; the rest on the device.

Copied from ``ffpic_tpu/formats/png.py`` (``SIGNATURE``, ``ADAM7``,
``_NCH``, ``probe``, ``_unfilter_py`` at ``:37-84``, the chunk walk of
``load`` at ``:106-174``, ``info``, ``_filter_rows``, ``encode`` and the
registration at ``:214-284``), split as ``formats/jpg.py`` is split:

* ``parse`` is the host part: the chunk walk with CRC verification,
  ``skip_decode``, inflate (span ``png.inflate``) and, for each pass
  (one, or Adam7's seven) whose rows use Average or Paeth, the native
  C unfilter (``native.png_unfilter``, span ``png.unfilter``), the
  reference's own routing (``png.py:93-103``).  A pass whose filters
  are all None, Sub or Up keeps its filter-tagged rows for the device.
  The port's native build raises on failure, so no Python unfilter runs
  on this path; ``_unfilter_py`` is kept as the oracle of the tests.
* ``to_pic`` is the device part: the staging copy (span ``png.h2d``),
  K6 ``unfilter_subup`` for a None/Sub/Up pass, whose result stays on
  the device, then K7 ``assemble_rgba`` (span ``png.device``), through
  ``ops.png_kernels``; on the CPU their plain versions.  Adam7 passes
  are assembled into one device tensor by strided assignment (the
  reference builds that image in numpy).

``decode_batch`` runs ``parse`` in its worker pool and ``to_pic`` on the
caller's thread.  ``encode`` is host-only, as in the reference.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field

import numpy as np
import torch

from ffpic_tpu_torch import native
from ffpic_tpu_torch.formats.pic import Pic, PixelFormat
from ffpic_tpu_torch.formats.registry import Codec, register
from ffpic_tpu_torch.ops import png_kernels
from ffpic_tpu_torch.utils import trace
from ffpic_tpu_torch.utils.checksum import crc32
from ffpic_tpu_torch.utils.device import to_device

SIGNATURE = b"\x89PNG\r\n\x1a\n"

# Adam7 pass geometry: (x0, y0, dx, dy)
ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)]

_NCH = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def probe(data: bytes) -> bool:
    return data[:8] == SIGNATURE


def chunk(name: bytes, payload: bytes) -> bytes:
    """One PNG chunk: length, name, payload, CRC of name and payload."""
    return (struct.pack(">I", len(payload)) + name + payload
            + struct.pack(">I", crc32(name + payload)))


def _unfilter_py(raw: np.ndarray, height: int, stride: int,
                 bpp: int) -> np.ndarray:
    """Pure-Python oracle for the five filters (reference
    png.c:106-168); differential test target for the C and device
    paths."""
    out = np.zeros((height, stride), np.int32)
    raw = raw.reshape(height, stride + 1)
    for y in range(height):
        ft = raw[y, 0]
        src = raw[y, 1:].astype(np.int32)
        prev = out[y - 1] if y > 0 else np.zeros(stride, np.int32)
        if ft == 0:
            out[y] = src
        elif ft == 1:
            for i in range(stride):
                a = out[y, i - bpp] if i >= bpp else 0
                out[y, i] = (src[i] + a) & 255
        elif ft == 2:
            out[y] = (src + prev) & 255
        elif ft == 3:
            for i in range(stride):
                a = out[y, i - bpp] if i >= bpp else 0
                out[y, i] = (src[i] + ((a + prev[i]) >> 1)) & 255
        elif ft == 4:
            for i in range(stride):
                a = out[y, i - bpp] if i >= bpp else 0
                c = prev[i - bpp] if i >= bpp else 0
                b = prev[i]
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                out[y, i] = (src[i] + pred) & 255
        else:
            raise ValueError(f"bad filter {ft}")
    return out.astype(np.uint8)


@dataclass
class PngPass:
    """One filtered sub-image: the whole image, or one Adam7 pass placed
    at rows y0::dy and columns x0::dx."""
    x0: int
    y0: int
    dx: int
    dy: int
    width: int
    height: int
    rows: np.ndarray | None = None    # (height, stride + 1) tagged, for K6
    recon: np.ndarray | None = None   # (height, stride) unfiltered on host


@dataclass
class PngFile:
    width: int = 0
    height: int = 0
    bitdepth: int = 0
    color_type: int = 0
    interlace: int = 0
    meta: dict = field(default_factory=dict)
    palette: np.ndarray | None = None     # (256, 4) uint8
    trns: np.ndarray | None = None        # (256,) int64, -1 where absent
    passes: list = field(default_factory=list)
    bpp: int = 1


def _host_pass(raw: np.ndarray, x0: int, y0: int, dx: int, dy: int,
               width: int, height: int, stride: int, bpp: int) -> PngPass:
    """The reference's ``_unfilter`` routing (``png.py:87-103``), its
    device half left for ``to_pic``."""
    p = PngPass(x0, y0, dx, dy, width, height)
    if height == 0 or stride == 0:
        p.recon = np.zeros((height, stride), np.uint8)
        return p
    rows = raw.reshape(height, stride + 1)
    if rows[:, 0].max(initial=0) <= 2:
        p.rows = rows
    else:
        with trace.stage("png.unfilter"):
            p.recon = native.png_unfilter(raw, height, stride, bpp)
    return p


def parse(data: bytes, skip_decode: bool = False,
          verify_crc: bool = True) -> PngFile:
    """The host part of a decode: chunks (CRC-checked), then unless
    ``skip_decode`` the inflated rows of each pass, unfiltered on the
    host where they use Average or Paeth."""
    if not probe(data):
        raise ValueError("not a PNG")
    pos = 8
    idat = bytearray()
    meta: dict = {"chunks": []}
    palette = np.zeros((256, 4), np.uint8)
    palette[:, 3] = 255
    trns = np.full(256, -1, np.int64)
    w = h = bitdepth = color_type = interlace = 0

    while pos + 8 <= len(data):
        length, ctype = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + length]
        crc = struct.unpack_from(">I", data, pos + 8 + length)[0]
        if verify_crc and crc32(data[pos + 4:pos + 8 + length]) != crc:
            raise ValueError(f"CRC mismatch in {ctype!r} chunk")
        pos += 12 + length
        name = ctype.decode("latin1")
        meta["chunks"].append(name)

        if name == "IHDR":
            w, h, bitdepth, color_type, _comp, _filt, interlace = \
                struct.unpack(">IIBBBBB", body)
            meta.update(width=w, height=h, bitdepth=bitdepth,
                        color_type=color_type, interlace=interlace)
        elif name == "PLTE":
            n = length // 3
            palette[:n, :3] = np.frombuffer(body, np.uint8,
                                            n * 3).reshape(n, 3)
            meta["palette_size"] = n
        elif name == "tRNS":
            if color_type == 3:
                a = np.frombuffer(body, np.uint8)
                trns[:len(a)] = a
            elif color_type == 0:
                trns[0] = struct.unpack(">H", body[:2])[0]
            elif color_type == 2:
                trns[0], trns[1], trns[2] = struct.unpack(">HHH", body[:6])
            meta["trns"] = True
        elif name == "IDAT":
            idat += body
        elif name == "gAMA":
            meta["gamma"] = struct.unpack(">I", body)[0] / 100000
        elif name == "pHYs":
            x, y, unit = struct.unpack(">IIB", body)
            meta["phys"] = (x, y, unit)
        elif name == "tEXt":
            k, _, v = body.partition(b"\x00")
            meta.setdefault("text", {})[k.decode("latin1")] = \
                v.decode("latin1", "replace")
        elif name == "tIME":
            meta["time"] = struct.unpack(">HBBBBB", body)
        elif name == "sRGB":
            meta["srgb_intent"] = body[0] if body else 0
        elif name == "bKGD":
            meta["bkgd"] = body.hex()
        elif name == "IEND":
            break

    f = PngFile(width=w, height=h, bitdepth=bitdepth, color_type=color_type,
                interlace=interlace, meta=meta, palette=palette, trns=trns)
    if skip_decode:
        return f
    nch = _NCH[color_type]
    png_kernels.check_format(color_type, bitdepth)
    f.bpp = bpp = max(1, (bitdepth * nch) // 8)
    with trace.stage("png.inflate"):
        raw = np.frombuffer(zlib.decompress(bytes(idat)), np.uint8)

    def stride_of(width):
        return (width * nch * bitdepth + 7) // 8

    if interlace == 0:
        f.passes.append(_host_pass(raw, 0, 0, 1, 1, w, h, stride_of(w), bpp))
        return f
    # Adam7: each pass is an independently filtered sub-image
    off = 0
    for (x0, y0, dx, dy) in ADAM7:
        pw = (w - x0 + dx - 1) // dx
        ph = (h - y0 + dy - 1) // dy
        if pw == 0 or ph == 0:
            continue
        st = stride_of(pw)
        nbytes = ph * (st + 1)
        f.passes.append(_host_pass(raw[off:off + nbytes], x0, y0, dx, dy, pw,
                                   ph, st, bpp))
        off += nbytes
    return f


def _pass_rgba(f: PngFile, p: PngPass, device: torch.device) -> torch.Tensor:
    with trace.stage("png.h2d"):
        if p.recon is not None:
            recon = to_device(p.recon, device)
        else:
            rows = to_device(p.rows, device)
    with trace.stage("png.device"):
        if p.recon is None:
            recon = png_kernels.unfilter_device_subup(rows, f.bpp)
        return png_kernels.assemble_rgba(recon, f.palette,
                                         f.trns.astype(np.int32),
                                         f.color_type, f.bitdepth, p.width,
                                         p.height)


def to_pic(f: PngFile, device: torch.device) -> Pic:
    """The device part of a decode: each pass's rows to RGBA on
    ``device``; Adam7 passes written into one tensor at their places."""
    w, h = f.width, f.height
    if f.interlace == 0:
        rgba = _pass_rgba(f, f.passes[0], device)
    else:
        rgba = torch.zeros((h, w, 4), dtype=torch.uint8, device=device)
        for p in f.passes:
            rgba[p.y0::p.dy, p.x0::p.dx] = _pass_rgba(f, p, device)
    return Pic(pixels=rgba, width=w, height=h, depth=32, pitch=w * 4,
               format=PixelFormat.RGBA32, codec="PNG", meta=f.meta)


def load(data: bytes, skip_decode: bool = False, *, device: torch.device,
         verify_crc: bool = True) -> list[Pic]:
    f = parse(data, skip_decode, verify_crc)
    if skip_decode:
        return [Pic(width=f.width, height=f.height, depth=32,
                    pitch=f.width * 4, codec="PNG", meta=f.meta)]
    return [to_pic(f, device)]


def info(pic: Pic) -> str:
    m = pic.meta
    ct_names = {0: "grayscale", 2: "truecolor", 3: "palette",
                4: "gray+alpha", 6: "truecolor+alpha"}
    lines = ["PNG file format",
             f"\twidth {m['width']}, height {m['height']}",
             f"\tbit depth {m['bitdepth']}, "
             f"color type {ct_names.get(m['color_type'])}",
             f"\tinterlace {'Adam7' if m.get('interlace') else 'none'}"]
    if "palette_size" in m:
        lines.append(f"\tpalette {m['palette_size']} colors"
                     + (" + tRNS" if m.get("trns") else ""))
    if "gamma" in m:
        lines.append(f"\tgAMA {m['gamma']:.5f}")
    if "text" in m:
        for k, v in m["text"].items():
            lines.append(f"\ttEXt {k}: {v[:60]}")
    lines.append(f"\tchunks: {' '.join(m['chunks'])}")
    return "\n".join(lines)


def _filter_rows(px: np.ndarray) -> np.ndarray:
    """Adaptive per-row filter selection (None/Sub/Up/Average/Paeth)
    by the minimum-sum-of-absolute-differences heuristic, fully
    vectorized.  The filters are exact inverses of _unfilter_py and
    are covered by the decode roundtrip tests."""
    h, stride = px.shape
    src = px.astype(np.int32)
    left = np.zeros_like(src)
    left[:, 4:] = src[:, :-4]                      # bpp = 4 (RGBA)
    up = np.zeros_like(src)
    up[1:] = src[:-1]
    ul = np.zeros_like(src)
    ul[1:, 4:] = src[:-1, :-4]

    p = left + up - ul
    pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
    pred = np.where((pa <= pb) & (pa <= pc), left,
                    np.where(pb <= pc, up, ul))
    cands = np.stack([src,
                      (src - left) & 255,
                      (src - up) & 255,
                      (src - ((left + up) >> 1)) & 255,
                      (src - pred) & 255])          # (5, h, stride)
    # SAD heuristic: treat filtered bytes as signed, smaller is better
    signed = np.where(cands < 128, cands, 256 - cands)
    best = signed.sum(axis=2).argmin(axis=0)        # (h,)
    rows = np.zeros((h, stride + 1), np.uint8)
    rows[:, 0] = best
    rows[:, 1:] = cands[best, np.arange(h)].astype(np.uint8)
    return rows


def encode(pic: Pic, *, device: torch.device, level: int = 6,
           **options) -> bytes:
    """32-bit RGBA, adaptive filters, zlib; on the host whatever
    ``device`` is (a CUDA picture's pixels are copied back first)."""
    rgba = pic.to_rgba32()
    h, w = rgba.shape[:2]
    rows = _filter_rows(rgba.reshape(h, -1))
    comp = zlib.compress(rows.tobytes(), level)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    return (SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", comp) +
            chunk(b"IEND", b""))


register(Codec(name="PNG", alias="APNG", probe=probe, load=load, info=info,
               encode=encode))
