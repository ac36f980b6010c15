"""WebP container codec of the port.

Copied from ``ffpic_tpu/formats/webp.py`` (``probe``, the colour
helpers ``_fancy_upsample``, ``_yuv_to_rgb_libwebp``,
``_yuv_to_rgb_reference``, ``_decode_alpha``, ``_decode_frame_rgba``,
``_blend_libwebp``, ``_load_animation``, ``load``, ``info``,
``encode``): VP8 (lossy key frame, ``formats.vp8``), VP8X extended
files, the ALPH chunk (raw or VP8L-compressed, with its filters),
EXIF/XMP chunks listed, VP8L lossless (``formats.vp8l``), and ANIM/ANMF
animations composited to full canvases with libwebp-exact blending and
disposal.  Split as ``formats.png`` is split:

* ``parse`` is the host part: the chunk walk and the decode of the
  payload, on the host: the VP8 decode (span ``webp.vp8_decode``;
  under ``FFPIC_VP8_DEVICE`` its residual transform runs on the device,
  see ``formats.vp8``), the alpha plane, then the colour conversion
  (span ``webp.host_color``: ``native.vp8_color_libwebp``, or with
  ``FFPIC_HOST_COLOR`` set the numpy ``_yuv_to_rgb_libwebp``;
  ``mode="reference"`` takes ``_yuv_to_rgb_reference``).  With
  ``FFPIC_VP8_DEVICE_COLOR`` set (and ``mode="libwebp"``) it keeps the
  MB-padded Y, U, V planes and the alpha plane for the device instead.
  VP8L and animation frames decode on the host as in the original;
* ``to_pics`` is the device part: the staging copy (span ``webp.h2d``)
  of the RGBA pixels, or of the planes (``stage_planes``, one copy)
  followed by the ``vp8_yuv_to_rgba`` kernel (span
  ``webp.device_color``; its plain version on the CPU), which also
  writes the alpha plane.  Pixels land on the load's device, as the
  port's JPEG and PNG pictures do.

``decode_batch`` runs ``parse`` in its worker pool and ``to_pics`` on
the caller's thread, except for the stills that kept their planes: it
stages all of those with one ``stage_planes`` and colours them in one
K13 launch (``vp8_kernels.vp8_yuv_to_rgba_batch``).  ``encode``
(lossless VP8L, animated VP8X + ANIM + ANMF for a picture with frames)
is host-only, as in the original.
``_decode_alpha`` keeps the original's horizontal filter (its first
column unfiltered) and its per-pixel Python loop for the gradient
filter.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field

import numpy as np
import torch

from ffpic_tpu_torch import native
from ffpic_tpu_torch.formats.pic import Pic, PixelFormat
from ffpic_tpu_torch.formats.registry import Codec, register
from ffpic_tpu_torch.formats.vp8 import VP8Decoder
from ffpic_tpu_torch.formats.vp8l import decode_vp8l
from ffpic_tpu_torch.ops import vp8_kernels
from ffpic_tpu_torch.utils import trace
from ffpic_tpu_torch.utils.device import to_device
from ffpic_tpu_torch.utils.vlog import get_logger

log = get_logger("webp")


def probe(data: bytes) -> bool:
    return (len(data) > 16 and data[:4] == b"RIFF" and
            data[8:12] == b"WEBP")


def _fancy_upsample(chroma: np.ndarray, H: int, W: int) -> np.ndarray:
    """libwebp's 'fancy' 2x chroma upsampler (upsampling.c): each
    output pixel is a (9a+3b+3c+d+8)>>4 diamond blend of the four
    nearest chroma samples, borders replicated."""
    c = chroma.astype(np.int32)
    ch, cw = c.shape
    cN = np.vstack([c[:1], c[:-1]])
    cS = np.vstack([c[1:], c[-1:]])
    cW = np.hstack([c[:, :1], c[:, :-1]])
    cE = np.hstack([c[:, 1:], c[:, -1:]])
    cNW = np.hstack([cN[:, :1], cN[:, :-1]])
    cNE = np.hstack([cN[:, 1:], cN[:, -1:]])
    cSW = np.hstack([cS[:, :1], cS[:, :-1]])
    cSE = np.hstack([cS[:, 1:], cS[:, -1:]])
    out = np.zeros((2 * ch, 2 * cw), np.int32)
    out[0::2, 0::2] = (9 * c + 3 * (cN + cW) + cNW + 8) >> 4
    out[0::2, 1::2] = (9 * c + 3 * (cN + cE) + cNE + 8) >> 4
    out[1::2, 0::2] = (9 * c + 3 * (cS + cW) + cSW + 8) >> 4
    out[1::2, 1::2] = (9 * c + 3 * (cS + cE) + cSE + 8) >> 4
    return out[:H, :W].astype(np.uint8)


def _yuv_to_rgb_libwebp(Y, U, V, H, W):
    """libwebp yuv.h fixed point: value>>6 after MultHi (>>8) terms."""
    y = Y[:H, :W].astype(np.int32)
    # crop chroma to its valid sample grid first so the upsampler's
    # edge replication (not MB padding) feeds the borders
    ch, cw = (H + 1) // 2, (W + 1) // 2
    u = _fancy_upsample(U[:ch, :cw], H, W).astype(np.int32)
    v = _fancy_upsample(V[:ch, :cw], H, W).astype(np.int32)

    def mult_hi(val, coeff):
        return (val * coeff) >> 8

    yv = mult_hi(y, 19077)
    r = yv + mult_hi(v, 26149) - 14234
    g = yv - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708
    b = yv + mult_hi(u, 33050) - 17685

    def clip8(x):
        return np.clip(x >> 6, 0, 255).astype(np.uint8)

    return clip8(r), clip8(g), clip8(b)


def _yuv_to_rgb_reference(Y, U, V, H, W):
    """C reference plane path (colorspace.c:316-318): nearest upsample,
    full-range treatment with the quirky coefficients + truncation."""
    y = Y[:H, :W].astype(np.float64)
    u = np.repeat(np.repeat(U, 2, 0), 2, 1)[:H, :W].astype(np.float64) - 128
    v = np.repeat(np.repeat(V, 2, 0), 2, 1)[:H, :W].astype(np.float64) - 128
    r = np.clip(np.trunc(y + 1.28 * v), 0, 255).astype(np.uint8)
    g = np.clip(np.trunc(y - 0.215 * u - 0.381 * v), 0, 255).astype(np.uint8)
    b = np.clip(np.trunc(y + 2.128 * u), 0, 255).astype(np.uint8)
    return r, g, b


def _decode_alpha(alph: bytes, H: int, W: int) -> np.ndarray | None:
    """ALPH chunk: method 0 = raw, method 1 = VP8L-compressed (the
    latter needs the VP8L decoder — returns None until it lands)."""
    if not alph:
        return None
    b0 = alph[0]
    method = b0 & 3
    filt = (b0 >> 2) & 3
    if method == 0:
        a = np.frombuffer(alph, np.uint8, W * H, 1).reshape(H, W).copy()
    elif method == 1:
        from ffpic_tpu_torch.formats.vp8l import decode_alpha_stream
        a = decode_alpha_stream(alph[1:], W, H)
    else:
        return None
    if filt == 1:    # horizontal
        a = a.astype(np.int32)
        for x in range(1, W):
            a[:, x] = (a[:, x] + a[:, x - 1]) & 255
        a = a.astype(np.uint8)
    elif filt == 2:  # vertical
        a = (np.cumsum(a.astype(np.int64), axis=0) & 255).astype(np.uint8)
    elif filt == 3:  # gradient — serial recurrence
        a = a.astype(np.int32)
        for yy in range(H):
            for xx in range(W):
                l = a[yy, xx - 1] if xx else 0
                t = a[yy - 1, xx] if yy else 0
                tl = a[yy - 1, xx - 1] if (xx and yy) else 0
                g = np.clip(l + t - tl, 0, 255)
                a[yy, xx] = (a[yy, xx] + g) & 255
        a = a.astype(np.uint8)
    return a


def _host_rgba(Y, U, V, H: int, W: int, a, mode: str) -> np.ndarray:
    """The host colour of a decoded VP8 frame (``webp.py:298-330``
    without the device branch): the native libwebp conversion, the numpy
    one under ``FFPIC_HOST_COLOR``, or the C reference's plane path for
    ``mode="reference"``; alpha from ``a`` or 255."""
    if mode == "libwebp" and not os.environ.get("FFPIC_HOST_COLOR"):
        with trace.stage("webp.host_color"):
            return native.vp8_color_libwebp(
                np.ascontiguousarray(Y[:H, :W]), U, V, H, W, a)
    conv = (_yuv_to_rgb_libwebp if mode == "libwebp"
            else _yuv_to_rgb_reference)
    r, g, b = conv(Y, U, V, H, W)
    if a is None:
        a = np.full((H, W), 255, np.uint8)
    return np.dstack([r, g, b, a])


def _decode_frame_rgba(sub: dict, mode: str, device) -> np.ndarray:
    """Decode one animation frame's VP8/VP8L (+ALPH) payload to a
    numpy RGBA array on the host: frames feed the host compositor
    (``device`` as in ``parse``)."""
    if "VP8 " in sub:
        dec = VP8Decoder(sub["VP8 "], device=device)
        H, W = dec.hdr.height, dec.hdr.width
        Y, U, V = dec.decode()
        a = _decode_alpha(sub.get("ALPH", b""), H, W)
        return _host_rgba(Y, U, V, H, W, a, mode)
    if "VP8L" in sub:
        return np.asarray(decode_vp8l(sub["VP8L"]))
    raise ValueError("ANMF frame without VP8/VP8L payload")


def _blend_libwebp(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """libwebp's non-premultiplied alpha-blend of a new frame over
    the canvas (demux/anim_decode.c BlendPixelNonPremult), exact
    integer arithmetic as of libwebp 1.6: the dst weight is
    (dst_a * (256 - src_a)) >> 8, the per-pixel divide is a
    truncated 0x1000000/blend_a reciprocal multiply, and fully
    opaque / fully transparent source pixels short-circuit."""
    src32 = src.astype(np.uint64)
    dst32 = dst.astype(np.uint64)
    sa = src32[..., 3]
    scale = (dst32[..., 3] * (256 - sa)) >> 8
    ba = sa + scale
    recip = 0x1000000 // np.maximum(ba, 1)
    out = np.empty_like(src)
    for c in range(3):
        out[..., c] = (((src32[..., c] * sa + dst32[..., c] * scale)
                        * recip) >> 24).astype(np.uint8)
    out[..., 3] = ba.astype(np.uint8)
    out = np.where((sa == 255)[..., None], src, out)
    return np.where((sa == 0)[..., None], dst, out)


def chunks_of(buf: bytes, pos: int, what: str):
    """The (tag, body) RIFF chunks of ``buf`` from ``pos`` on, each body
    padded to an even size; a chunk that claims more bytes than are left
    raises ValueError."""
    while pos + 8 <= len(buf):
        tag = buf[pos:pos + 4].decode("latin1")
        size = struct.unpack_from("<I", buf, pos + 4)[0]
        if pos + 8 + size > len(buf):
            raise ValueError(f"truncated {what}: chunk {tag!r} claims "
                             f"{size} bytes past the end")
        yield tag, buf[pos + 8:pos + 8 + size]
        pos += 8 + size + (size & 1)


def _load_animation(anmf: list, chunks: dict, meta: dict,
                    skip_decode: bool, mode: str, device) -> list:
    """ANIM/ANMF animation: each frame decodes like a still WebP and
    composites onto the canvas per its blend/dispose flags —
    WebPAnimDecoder semantics (dispose-to-background clears to
    TRANSPARENT black; the ANIM background color is a player hint).
    The reference's webp.c has no animation support at all.  Returns
    the (canvas, delay_ms) of each frame on the host, none for
    ``skip_decode``."""
    cw, ch = meta.get("canvas", (0, 0))
    if "ANIM" in chunks and len(chunks["ANIM"]) >= 6:
        bg, loop = struct.unpack_from("<IH", chunks["ANIM"], 0)
        meta["background"] = bg
        meta["loop"] = loop
    meta.update(width=cw, height=ch, format="animation",
                frames=len(anmf))
    if skip_decode:
        return []
    canvas = np.zeros((ch, cw, 4), np.uint8)
    frames: list = []
    dispose_rect = None
    for payload in anmf:
        if len(payload) < 16:
            raise ValueError("truncated ANMF header")
        fx = int.from_bytes(payload[0:3], "little") * 2
        fy = int.from_bytes(payload[3:6], "little") * 2
        fw = int.from_bytes(payload[6:9], "little") + 1
        fh = int.from_bytes(payload[9:12], "little") + 1
        dur = int.from_bytes(payload[12:15], "little")
        flags = payload[15]
        no_blend = bool(flags & 2)
        dispose_bg = bool(flags & 1)
        if fy + fh > ch or fx + fw > cw:
            raise ValueError("ANMF frame rect outside canvas")
        sub = dict(chunks_of(payload, 16, "ANMF subchunk"))
        rgba = _decode_frame_rgba(sub, mode, device)[:fh, :fw]
        if dispose_rect is not None:
            dy, dx, dh, dw = dispose_rect
            canvas[dy:dy + dh, dx:dx + dw] = 0
        target = canvas[fy:fy + fh, fx:fx + fw]
        if no_blend:
            target[:] = rgba
        else:
            target[:] = _blend_libwebp(rgba, target)
        dispose_rect = (fy, fx, fh, fw) if dispose_bg else None
        frames.append((canvas.copy(), dur))
    if not frames:
        raise ValueError("animated WebP with zero ANMF frames")
    return frames


@dataclass
class WebpFile:
    """A parsed WebP: its metadata, and unless ``skip_decode`` what the
    host decoded of its pixels, one of: the RGBA pixels, the MB-padded
    (Y, U, V, alpha) planes for the device colour, or an animation's
    (canvas, delay_ms) frames."""
    width: int = 0
    height: int = 0
    meta: dict = field(default_factory=dict)
    rgba: np.ndarray | None = None
    yuva: tuple | None = None
    frames: list = field(default_factory=list)


def parse(data: bytes, skip_decode: bool = False, mode: str = "libwebp",
          device=None) -> WebpFile:
    """The host part of a decode (``webp.py:246-352``).  ``device`` is
    where ``FFPIC_VP8_DEVICE``'s residual transform runs (None: CUDA)."""
    riff_size = struct.unpack_from("<I", data, 4)[0]
    chunks: dict[str, bytes] = {}
    anmf: list[bytes] = []
    order = []
    for tag, body in chunks_of(data, 12, "WEBP"):
        if tag == "ANMF":
            anmf.append(body)
        else:
            chunks[tag] = body
        order.append(tag)

    meta = dict(chunks=order, riff_size=riff_size)
    if "VP8X" in chunks:
        x = chunks["VP8X"]
        meta["features"] = x[0]
        meta["canvas"] = (1 + (int.from_bytes(x[4:7], "little")),
                          1 + (int.from_bytes(x[7:10], "little")))

    if anmf:
        with trace.stage("webp.animation"):
            frames = _load_animation(anmf, chunks, meta, skip_decode, mode,
                                     device)
        return WebpFile(width=meta["width"], height=meta["height"],
                        meta=meta, frames=frames)

    if "VP8 " in chunks:
        dec = VP8Decoder(chunks["VP8 "], device=device)
        W, H = dec.hdr.width, dec.hdr.height
        meta.update(width=W, height=H, format="lossy VP8",
                    version=dec.version)
        f = WebpFile(width=W, height=H, meta=meta)
        if skip_decode:
            return f
        with trace.stage("webp.vp8_decode"):
            Y, U, V = dec.decode()
        meta["partitions"] = dec.hdr.n_partitions
        meta["filter"] = ("simple" if dec.hdr.filter_type
                          else "normal")
        meta["quant_yac"] = dec.hdr.q_yac
        a = _decode_alpha(chunks.get("ALPH", b""), H, W)
        if mode == "libwebp" and os.environ.get("FFPIC_VP8_DEVICE_COLOR"):
            f.yuva = (Y, U, V, a)
        else:
            f.rgba = _host_rgba(Y, U, V, H, W, a, mode)
        return f

    if "VP8L" in chunks:
        l = chunks["VP8L"]
        if l[0] != 0x2F:
            raise ValueError("bad VP8L signature")
        bits = int.from_bytes(l[1:5], "little")
        W = (bits & 0x3FFF) + 1
        H = ((bits >> 14) & 0x3FFF) + 1
        meta.update(width=W, height=H, format="lossless VP8L",
                    alpha_hint=(bits >> 28) & 1)
        f = WebpFile(width=W, height=H, meta=meta)
        if not skip_decode:
            f.rgba = decode_vp8l(l)
        return f

    raise ValueError("no VP8/VP8L payload in WebP container")


def _pic(f: WebpFile, pixels, delay_ms: int = 0) -> Pic:
    return Pic(pixels=pixels, width=f.width, height=f.height, depth=32,
               pitch=f.width * 4, format=PixelFormat.RGBA32, codec="WEBP",
               delay_ms=delay_ms, meta=f.meta)


def stage_planes(fs, device) -> list:
    """The planes that ``parse`` kept of WebP stills (``f.yuva``), staged
    on ``device`` in one copy (``vp8_kernels.stage_frames``: each plane
    cropped, at a 16-byte-aligned offset and pitch), as K13's frames."""
    return vp8_kernels.stage_frames(
        [(Y, U, V, f.height, f.width, a) for f in fs
         for Y, U, V, a in (f.yuva,)], device)


def to_pics(f: WebpFile, device: torch.device) -> list[Pic]:
    """The device part of a decode: the pictures with their pixels on
    ``device``, an animation's canvases one by one."""
    if f.frames:
        with trace.stage("webp.h2d"):
            return [_pic(f, to_device(c, device), d) for c, d in f.frames]
    if f.yuva is None:
        with trace.stage("webp.h2d"):
            return [_pic(f, to_device(f.rgba, device))]
    with trace.stage("webp.h2d"):
        frame, = stage_planes([f], device)
    with trace.stage("webp.device_color"), \
            trace.device_trace("vp8_yuv_to_rgba", device):
        rgba = vp8_kernels.vp8_yuv_to_rgba(*frame)
    return [_pic(f, rgba)]


def load(data: bytes, skip_decode: bool = False, *, device: torch.device,
         mode: str = "libwebp") -> list[Pic]:
    f = parse(data, skip_decode, mode, device)
    if skip_decode:
        return [Pic(width=f.width, height=f.height, depth=32,
                    pitch=f.width * 4, codec="WEBP", meta=f.meta)]
    return to_pics(f, device)


def info(pic: Pic) -> str:
    m = pic.meta
    lines = ["WEBP file format",
             f"\twidth {m.get('width')}, height {m.get('height')}",
             f"\t{m.get('format', '?')}"]
    if "partitions" in m:
        lines.append(f"\tpartitions {m['partitions']}, "
                     f"{m['filter']} loop filter, "
                     f"q_yac {m['quant_yac']}")
    lines.append(f"\tchunks: {' '.join(m['chunks'])}")
    return "\n".join(lines)


def _chunk(tag: bytes, payload: bytes) -> bytes:
    """RIFF chunk with the even-size padding byte."""
    pad = b"\x00" if len(payload) & 1 else b""
    return tag + struct.pack("<I", len(payload)) + payload + pad


def _u24(v: int) -> bytes:
    return struct.pack("<I", v)[:3]


def encode(pic, *, device: torch.device, loops: int = 0,
           **options) -> bytes:
    """Lossless WebP (VP8L) encode; multi-frame pics emit an
    animated VP8X+ANIM+ANMF container (full-canvas frames, blending
    off — lossless round-trip by construction).  The reference has
    no WebP encoder and even its VP8L *decoder* is a stub
    (webp.c:1928-1999).  On the host whatever ``device`` is (a CUDA
    picture's pixels are copied back first)."""
    from ffpic_tpu_torch.formats.vp8l_enc import encode_webp_lossless, \
        encode_vp8l
    rgba = pic.np_pixels() if hasattr(pic, "np_pixels") \
        else np.asarray(pic.pixels)
    frames = list(getattr(pic, "frames", None) or [])
    if not frames:
        return encode_webp_lossless(rgba)

    cw, ch = pic.width, pic.height
    has_alpha = False
    body = bytearray()
    for fr in [pic] + frames:
        fa = fr.np_pixels() if hasattr(fr, "np_pixels") \
            else np.asarray(fr.pixels)
        if fa.shape[0] != ch or fa.shape[1] != cw:
            raise ValueError("animated WebP frames must match the "
                             "canvas size")
        if fa.shape[-1] == 4 and (fa[..., 3] != 255).any():
            has_alpha = True
        dur = int(getattr(fr, "delay_ms", 0) or 0)
        # full-canvas frame, blending off (flag bit 1), keep-dispose
        anmf = (_u24(0) + _u24(0) + _u24(cw - 1) + _u24(ch - 1)
                + _u24(dur) + bytes([2])
                + _chunk(b"VP8L", encode_vp8l(fa)))
        body += _chunk(b"ANMF", anmf)

    vp8x = (bytes([(0x10 if has_alpha else 0) | 0x02, 0, 0, 0])
            + _u24(cw - 1) + _u24(ch - 1))
    anim = struct.pack("<IH", 0, int(loops))    # bg color + loops
    payload = (_chunk(b"VP8X", vp8x) + _chunk(b"ANIM", anim)
               + bytes(body))
    return (b"RIFF" + struct.pack("<I", len(payload) + 4)
            + b"WEBP" + payload)


register(Codec(name="WEBP", probe=probe, load=load, info=info,
               encode=encode))
