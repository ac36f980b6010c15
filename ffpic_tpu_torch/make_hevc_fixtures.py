"""Write the HEVC inter fixtures of ``ffpic_tpu_torch/testdata`` from a
seed, with libx265 and libde265 (through ctypes, as the JAX package's
``tools/x265_oracle.py`` and ``tools/de265_oracle.py`` drive them).

    python3 -m ffpic_tpu_torch.make_hevc_fixtures [--seed 0] [--out DIR]

* ``inter_1080p.265``: a raw Annex-B stream of 5 frames of 1920x1080,
  GOP 8, 2 B-frames, QP 30, with every inter tool the JAX package's
  inter tests turn on (``ALL``: SAO, temporal MVP, deblocking, 3
  references, 5 merge candidates);
* ``sequence_1080p.heic``: a 1920x1080 still primary item (the port's
  encoder, quality 50) and a ``moov/trak`` image sequence that carries a
  3-frame stream of the same kind (``heif_sequence``: one sample an
  access unit, its slice NAL units length-prefixed, the parameter sets
  in the sample entry's ``hvcC``);
* ``hevc_fixtures.json``: each file's sha256, and libde265's decode of
  each picture (the stream's pictures, the primary item, the sequence's
  frames) in display order as the shape and sha256 of its Y, U and V
  planes.  libde265 is a decoder independent of both packages, so a
  decode that matches these digests is bit-exact.

The card's machine has neither library, so the files are committed;
``chip_smoke.py`` decodes them there and holds the planes against the
digests.  The frames are ``frames``: a copy of the JAX package's inter
test content (``tests/test_hevc_inter_decode.py:36-51``), a gradient
with noise (``NOISE`` at 1080p) that rolls sideways and a patch that
moves, so that the encoder finds real motion.  x265 turns wavefront
parallel processing on, so each slice carries entry points, and the
stream's fourth picture has an emulation prevention byte inside a
substream (``formats.hevc.rbsp_entry_points``).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import struct

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "testdata")
STREAM = "inter_1080p.265"
SEQUENCE = "sequence_1080p.heic"
DIGESTS = "hevc_fixtures.json"
X265 = "/usr/lib/x86_64-linux-gnu/libx265.so.199"
DE265 = "/usr/lib/x86_64-linux-gnu/libde265.so.0"

# the luma noise of the 1080p frames: about 360 KB for the 5-frame
# stream, the size of the 1080p streams the JAX package's inter decode
# was timed on
NOISE = 12
# the JAX package's inter test tool sets (tests/test_hevc_inter_decode.py)
BASE = {"sao": 0, "weightp": 0, "temporal-mvp": 0, "open-gop": 0,
        "no-deblock": 1, "ref": 1, "max-merge": 2}
ALL = {"sao": 1, "weightp": 0, "temporal-mvp": 1, "open-gop": 0,
       "no-deblock": 0, "ref": 3, "max-merge": 5}


def frames(n: int, h: int, w: int, noise: int = 30, seed: int = 3) -> list:
    """``n`` 8-bit 4:2:0 frames, each [Y, U, V]: a gradient with noise
    rolled 3 columns a frame, a 16x16 patch moving 5 columns a frame, a
    noisy U rolled one column a frame, a flat V."""
    rng = np.random.default_rng(seed)
    base = np.clip(np.linspace(0, 255, w)[None, :] +
                   np.linspace(0, 80, h)[:, None] +
                   rng.integers(0, noise, (h, w)), 0, 255) \
        .astype(np.uint8)
    cb = np.clip(128 + rng.integers(-20, 20, (h // 2, w // 2)), 0,
                 255).astype(np.uint8)
    out = []
    for i in range(n):
        y = np.roll(base, 3 * i, 1).copy()
        x0 = (10 + 5 * i) % max(1, w - 16)
        y[20:36, x0:x0 + 16] = 200
        out.append([y, np.roll(cb, i, 1).copy(),
                    np.full((h // 2, w // 2), 110, np.uint8)])
    return out


# --- libx265 -----------------------------------------------------------------

class _Nal(ctypes.Structure):
    _fields_ = [("type", ctypes.c_uint32),
                ("sizeBytes", ctypes.c_uint32),
                ("payload", ctypes.POINTER(ctypes.c_uint8))]


def have_libraries() -> bool:
    """Whether libx265 and libde265 load."""
    try:
        ctypes.CDLL(X265)
        ctypes.CDLL(DE265)
        return True
    except OSError:
        return False


def x265_encode(planes, gop: int = 8, bframes: int = 0,
                preset: str = "ultrafast", qp: int = 30,
                extra: dict | None = None) -> bytes:
    """An Annex-B stream of 8-bit 4:2:0 frames ([Y, U, V] uint8 planes)
    with real P (and B) slices, single-threaded so that the bytes depend
    on the input alone.  The x265_picture's plane and stride fields are
    found by probing for its bitDepth field, as ``tools/x265_oracle.py``
    does."""
    lib = ctypes.CDLL(X265)
    lib.x265_param_alloc.restype = ctypes.c_void_p
    par = lib.x265_param_alloc()
    if not par:
        raise RuntimeError("x265_param_alloc")
    h, w = planes[0][0].shape
    if lib.x265_param_default_preset(ctypes.c_void_p(par), preset.encode(),
                                     b"psnr") != 0:
        raise RuntimeError("x265_param_default_preset")

    def setp(k, v):
        r = lib.x265_param_parse(ctypes.c_void_p(par), k.encode(),
                                 str(v).encode())
        if r != 0:
            raise RuntimeError(f"x265_param_parse {k}={v}: {r}")

    for k, v in (("input-res", f"{w}x{h}"), ("fps", "25"),
                 ("input-csp", "i420"), ("keyint", gop),
                 ("min-keyint", gop), ("bframes", bframes), ("qp", qp),
                 ("frame-threads", 1), ("pools", "1"), ("scenecut", 0),
                 ("annexb", 1), ("repeat-headers", 1), ("info", 0),
                 ("log-level", "none"), *(extra or {}).items()):
        setp(k, v)
    lib.x265_encoder_open_199.restype = ctypes.c_void_p
    enc = lib.x265_encoder_open_199(ctypes.c_void_p(par))
    if not enc:
        raise RuntimeError("x265_encoder_open")
    lib.x265_picture_alloc.restype = ctypes.c_void_p
    pic = lib.x265_picture_alloc()
    lib.x265_picture_init(ctypes.c_void_p(par), ctypes.c_void_p(pic))
    raw = ctypes.string_at(pic, 256)
    # planes[3] at off, stride[3] at off + 24, bitDepth (8) at off + 36
    poff = next((off for off in range(16, 96, 8)
                 if struct.unpack_from("<i", raw, off + 36)[0] == 8), None)
    if poff is None:
        raise RuntimeError("x265_picture layout probe failed")
    base = ctypes.addressof(ctypes.cast(
        pic, ctypes.POINTER(ctypes.c_uint8)).contents)
    out = bytearray()
    pp_nal = ctypes.POINTER(_Nal)()
    pi_nal = ctypes.c_uint32()

    def drain():
        for i in range(pi_nal.value):
            n = pp_nal[i]
            out.extend(ctypes.string_at(n.payload, n.sizeBytes))

    keep = []
    for fr in planes:
        y, u, v = (np.ascontiguousarray(p, np.uint8) for p in fr)
        keep.append((y, u, v))
        ptrs = (ctypes.c_void_p * 3)(y.ctypes.data, u.ctypes.data,
                                     v.ctypes.data)
        ctypes.memmove(base + poff, ptrs, 24)
        ctypes.memmove(base + poff + 24,
                       (ctypes.c_int32 * 3)(w, w // 2, w // 2), 12)
        if lib.x265_encoder_encode(ctypes.c_void_p(enc), ctypes.byref(pp_nal),
                                   ctypes.byref(pi_nal), ctypes.c_void_p(pic),
                                   None) < 0:
            raise RuntimeError("x265_encoder_encode")
        drain()
    while lib.x265_encoder_encode(ctypes.c_void_p(enc), ctypes.byref(pp_nal),
                                  ctypes.byref(pi_nal), None, None) > 0:
        drain()
    lib.x265_encoder_close(ctypes.c_void_p(enc))
    lib.x265_picture_free(ctypes.c_void_p(pic))
    lib.x265_param_free(ctypes.c_void_p(par))
    return bytes(out)


# --- libde265 ----------------------------------------------------------------

def de265_decode(stream: bytes) -> list:
    """libde265's pictures of an Annex-B stream in output (display)
    order, each [Y, U, V] uint8 planes (uint16 above 8 bits)."""
    lib = ctypes.CDLL(DE265)
    lib.de265_new_decoder.restype = ctypes.c_void_p
    lib.de265_get_next_picture.restype = ctypes.c_void_p
    lib.de265_get_image_plane.restype = ctypes.POINTER(ctypes.c_uint8)
    ctx = ctypes.c_void_p(lib.de265_new_decoder())
    if not ctx:
        raise RuntimeError("de265_new_decoder")
    rc = lib.de265_push_data(ctx, stream, ctypes.c_int(len(stream)),
                             ctypes.c_longlong(0), None)
    if rc != 0:
        raise RuntimeError(f"de265_push_data: {rc}")
    lib.de265_flush_data(ctx)
    out = []
    more = ctypes.c_int(1)
    while more.value:
        if lib.de265_decode(ctx, ctypes.byref(more)) not in (0, 20):
            break
        while True:
            pic = lib.de265_get_next_picture(ctx)
            if not pic:
                break
            pic = ctypes.c_void_p(pic)
            planes = []
            for c in range(3):
                w = lib.de265_get_image_width(pic, ctypes.c_int(c))
                h = lib.de265_get_image_height(pic, ctypes.c_int(c))
                bits = lib.de265_get_bits_per_pixel(pic, ctypes.c_int(c))
                stride = ctypes.c_int()
                ptr = lib.de265_get_image_plane(pic, ctypes.c_int(c),
                                                ctypes.byref(stride))
                bypp = 2 if bits > 8 else 1
                buf = ctypes.string_at(ptr, stride.value * h)
                planes.append(np.frombuffer(
                    buf, np.uint16 if bypp == 2 else np.uint8)
                    .reshape(h, stride.value // bypp)[:, :w].copy())
            out.append(planes)
    lib.de265_free_decoder(ctx)
    return out


# --- containers and digests --------------------------------------------------

def plane_digest(plane) -> dict:
    """A plane's shape and the sha256 of its samples (uint8 where they
    fit, else little-endian uint16), as ``hevc_fixtures.json`` keeps
    them."""
    a = np.asarray(plane)
    a = a.astype(np.uint8 if int(a.max(initial=0)) < 256 else "<u2")
    return {"shape": list(a.shape),
            "sha256": hashlib.sha256(np.ascontiguousarray(a)).hexdigest()}


def picture_digests(planes, shapes=None) -> list:
    """The digests of a picture's planes, each cut to ``shapes`` (the
    reference decoder's cropped sizes) where given."""
    if shapes is not None:
        planes = [p[:h, :w] for p, (h, w) in zip(planes, shapes)]
    return [plane_digest(p) for p in planes]


def access_units(stream: bytes) -> tuple[dict, list]:
    """The stream's parameter sets {NAL type: NAL unit} (the first of
    each of VPS, SPS, PPS) and its access units, each the list of its
    slice segment NAL units."""
    from ffpic_tpu_torch.formats import hevc
    params, aus = {}, []
    for nalu in hevc.split_annexb(stream):
        t = hevc.nal_type(nalu)
        if t in (32, 33, 34):
            params.setdefault(t, nalu)
        elif t < 32:
            if (nalu[2] >> 7) & 1 or not aus:
                aus.append([])
            aus[-1].append(nalu)
    return params, aus


def heif_sequence(primary: bytes, stream: bytes) -> bytes:
    """A HEIC of ``primary`` (a HEIC with one still item) and a
    ``moov/trak`` hvc1 image sequence carrying ``stream``: one sample an
    access unit, its slice NAL units with 4-byte lengths, its own VPS,
    SPS and PPS in the sample entry's hvcC (``formats.heif_enc.
    sequence_heic``, the container ``encode_heif_sequence`` writes and
    ``formats.heif._decode_sequence`` reads)."""
    from ffpic_tpu_torch.formats import hevc
    from ffpic_tpu_torch.formats.heif_enc import hvcc_record, sequence_heic
    params, aus = access_units(stream)
    sps = hevc.parse_sps(params[33])
    samples = [b"".join(struct.pack(">I", len(n)) + n for n in au)
               for au in aus]
    return sequence_heic(primary, samples, sps.pic_width_cropped,
                         sps.pic_height_cropped,
                         hvcc_record(params[32], params[33], params[34]))


def item_annexb(data: bytes) -> bytes:
    """The primary item of a HEIC as an Annex-B stream: its hvcC's
    parameter sets, then its NAL units."""
    from ffpic_tpu_torch.formats import heif, hevc
    s = heif.parse_structure(data)
    item = s["items"][s["primary"]]
    hv = item["properties"]["hvcC"]
    nalus = [n for k in ("vps", "sps", "pps") for n in hv["nalus"][k]]
    nalus += hevc.split_nalus_length_prefixed(
        heif.read_item(data, s, s["primary"]), hv["length_size"])
    return b"".join(b"\x00\x00\x00\x01" + n for n in nalus)


def make(seed: int = 0) -> dict:
    """{file name: bytes} of the three fixtures."""
    from ffpic_tpu_torch.formats.heif_enc import encode_heif
    from ffpic_tpu_torch.formats.pic import Pic
    from ffpic_tpu_torch.make_heif_fixtures import synth_rgb
    stream = x265_encode(frames(5, 1080, 1920, NOISE, seed=3 + seed),
                         gop=8, bframes=2, qp=30, extra=ALL)
    seq = x265_encode(frames(3, 1080, 1920, NOISE, seed=4 + seed), gop=8,
                      bframes=2, qp=30, extra=ALL)
    rgb = synth_rgb(1080, 1920, seed=21 + seed)
    rgba = np.dstack([rgb, np.full(rgb.shape[:2], 255, np.uint8)])
    primary = encode_heif(Pic(pixels=rgba, width=1920, height=1080),
                          quality=50)
    heic = heif_sequence(primary, seq)
    digests = {
        STREAM: {"sha256": hashlib.sha256(stream).hexdigest(),
                 "pictures": [picture_digests(p)
                              for p in de265_decode(stream)]},
        SEQUENCE: {"sha256": hashlib.sha256(heic).hexdigest(),
                   "primary": [picture_digests(p) for p in
                               de265_decode(item_annexb(heic))],
                   "pictures": [picture_digests(p)
                                for p in de265_decode(seq)]}}
    return {STREAM: stream, SEQUENCE: heic,
            DIGESTS: (json.dumps(digests, indent=1) + "\n").encode()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    for name, blob in make(args.seed).items():
        path = os.path.join(args.out, name)
        with open(path, "wb") as f:
            f.write(blob)
        print(f"{path}: {len(blob)} bytes, sha256 "
              f"{hashlib.sha256(blob).hexdigest()}")


if __name__ == "__main__":
    main()
