"""HEIF/HEIC *writer*: RGB(A) -> HEVC Main Still Picture in an
ISOBMFF container — single hvc1 item, optional grid tiling and
auxiliary alpha item.

The reference has no HEIF encoder at all (format/heif.c is
decode-only); this is a capability beyond parity.  The HEVC payload
comes from coding/hevc_enc.SliceEncoder; tiles are independent streams
(the same structure iPhone HEICs use) so decode-side batching has real
inputs to chew on.

Copied from ``ffpic_tpu/formats/heif_enc.py`` for the PyTorch port,
with its imports rewritten to the port's modules.  What differs:
``encode_heif`` and ``encode_heif_sequence`` copy a picture's pixels
to the host first (they may lie on the card).
"""

from __future__ import annotations

import struct

import numpy as np

from ffpic_tpu_torch.coding.hevc_enc import (EncPolicy, SliceEncoder,
                                             make_nalu, write_vps)

# ---------------------------------------------------------------------------
# color conversion (BT.601 full-range, round-half-up) + padding
# ---------------------------------------------------------------------------


def rgb_to_yuv420(rgb: np.ndarray):
    r = rgb[:, :, 0].astype(np.float64)
    g = rgb[:, :, 1].astype(np.float64)
    b = rgb[:, :, 2].astype(np.float64)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    y = np.clip(np.floor(y + 0.5), 0, 255).astype(np.int32)
    H, W = y.shape
    # pad to even before 2x2 mean
    cb = np.pad(cb, ((0, H & 1), (0, W & 1)), mode="edge")
    cr = np.pad(cr, ((0, H & 1), (0, W & 1)), mode="edge")

    def sub(c):
        c = (c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2]
             + c[1::2, 1::2]) / 4.0
        return np.clip(np.floor(c + 0.5), 0, 255).astype(np.int32)
    return y, sub(cb), sub(cr)


def _pad_planes(y, u, v, align=8):
    H, W = y.shape
    ph = (-H) % align
    pw = (-W) % align
    y = np.pad(y, ((0, ph), (0, pw)), mode="edge")
    u = np.pad(u, ((0, ph // 2), (0, pw // 2)), mode="edge")
    v = np.pad(v, ((0, ph // 2), (0, pw // 2)), mode="edge")
    return y, u, v, ph, pw


# ---------------------------------------------------------------------------
# box plumbing
# ---------------------------------------------------------------------------

def _box(tag: str, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + tag.encode() + payload


def _full(tag: str, version: int, flags: int, payload: bytes) -> bytes:
    return _box(tag, struct.pack(">I", (version << 24) | flags) + payload)


def _hvcc(sps_rbsp: bytes, pps_rbsp: bytes, ptl_bytes: bytes = None,
          chroma_format: int = 1) -> bytes:
    """HEVCDecoderConfigurationRecord (ISO 14496-15 §8.3.3.1)."""
    return hvcc_record(make_nalu(32, write_vps()), make_nalu(33, sps_rbsp),
                       make_nalu(34, pps_rbsp), chroma_format)


def hvcc_record(vps: bytes, sps: bytes, pps: bytes,
                chroma_format: int = 1) -> bytes:
    """An HEVCDecoderConfigurationRecord over these VPS, SPS and PPS NAL
    units (4-byte NAL lengths); ``_hvcc`` with the encoder's own."""
    rec = bytearray()
    rec.append(1)                              # configurationVersion
    rec.append(0x01)                           # space/tier/profile: Main
    rec += struct.pack(">I", 0x60000000)       # compat flags
    rec += bytes(6)                            # constraint flags
    rec.append(90)                             # level
    rec += struct.pack(">H", 0xF000)           # min_spatial_segmentation
    rec.append(0xFC)                           # parallelismType
    rec.append(0xFC | chroma_format)
    rec.append(0xF8)                           # bit_depth_luma - 8
    rec.append(0xF8)                           # bit_depth_chroma - 8
    rec += struct.pack(">H", 0)                # avgFrameRate
    rec.append((1 << 3) | (1 << 2) | 3)        # numTL=1, nested, len-1=3
    rec.append(3)                              # numOfArrays
    for ntype, nalu in ((32, vps), (33, sps), (34, pps)):
        rec.append(0x80 | ntype)               # array_completeness
        rec += struct.pack(">H", 1)
        rec += struct.pack(">H", len(nalu))
        rec += nalu
    return bytes(rec)


def _ispe(w: int, h: int) -> bytes:
    return _full("ispe", 0, 0, struct.pack(">II", w, h))


def _colr_601_full() -> bytes:
    """nclx declaring what rgb_to_yuv420 actually produces: BT.601
    matrix (5), sRGB primaries/transfer (1/13), full range."""
    return _box("colr", b"nclx" + struct.pack(">HHHB", 1, 13, 5, 0x80))


def _infe(item_id: int, item_type: bytes, hidden: bool = False) -> bytes:
    return _full("infe", 2, 1 if hidden else 0,
                 struct.pack(">HH", item_id, 0) + item_type + b"\0")


def _encode_tile(planes, qp, policy, ctb_log2=5) -> tuple:
    """Encode one YUV tile; returns (idr_nalu, sps_rbsp, pps_rbsp)."""
    y, u, v = planes
    H, W = y.shape
    enc = SliceEncoder(
        dict(width=W, height=H, ctb_log2=ctb_log2, min_tb_log2=2),
        dict(sign_hiding=True), qp, (y, u, v), policy)
    return enc.encode(), enc.sps_rbsp, enc.pps_rbsp


def _host_rgba(pic) -> np.ndarray:
    """A picture's (H, W, C) pixels as a host array."""
    if pic.pixels is None:
        raise ValueError("pic has no decoded pixels to encode")
    rgba = pic.np_pixels() if hasattr(pic, "np_pixels") \
        else np.asarray(pic.pixels)
    if rgba.ndim != 3:
        raise ValueError("pic has no decoded pixels to encode")
    return rgba


def encode_heif(pic, quality: int = 75, tile: int | None = None,
                qp: int | None = None) -> bytes:
    """Encode a Pic (RGBA pixels) to HEIC bytes.

    quality 0-100 maps to QP (or pass qp directly); tile=N writes an
    iPhone-style grid of NxN tiles when the image exceeds one tile.
    """
    rgba = _host_rgba(pic)
    H, W = rgba.shape[:2]
    if qp is None:
        qp = int(np.clip(51 - quality // 2, 0, 51))
    policy = EncPolicy(seed=0, split_prob=0.35, tt_split_prob=0.25,
                       nxn_prob=0.15,
                       mode_candidates=tuple(range(0, 35, 2)) + (1,))

    has_alpha = rgba.shape[2] == 4 and bool((rgba[:, :, 3] != 255).any())

    items = []      # (item_id, type, payload, props[(box, essential)])
    refs = []       # (reftype, from, [to])
    primary_id = 1

    use_grid = tile is not None and (W > tile or H > tile)
    if use_grid:
        cols = -(-W // tile)
        rows = -(-H // tile)
        tile_ids = list(range(2, 2 + rows * cols))
        grid_payload = bytes((0, 1)) + bytes((rows - 1, cols - 1)) + \
            struct.pack(">II", W, H)
        items.append((1, b"grid", grid_payload,
                      [(_ispe(W, H), False)]))
        refs.append(("dimg", 1, tile_ids))
        next_id = 2
        for r0 in range(rows):
            for c0 in range(cols):
                x0, y0 = c0 * tile, r0 * tile
                sub = rgba[y0:y0 + tile, x0:x0 + tile]
                sub = np.pad(sub, ((0, tile - sub.shape[0]),
                                   (0, tile - sub.shape[1]), (0, 0)),
                             mode="edge")
                y, u, v = rgb_to_yuv420(sub)
                y, u, v, ph, pw = _pad_planes(y, u, v)
                idr, sps_r, pps_r = _encode_tile((y, u, v), qp, policy)
                payload = struct.pack(">I", len(idr)) + idr
                items.append((next_id, b"hvc1", payload, [
                    (_box("hvcC", _hvcc(sps_r, pps_r)), True),
                    (_ispe(tile, tile), False)]))
                next_id += 1
    else:
        y, u, v = rgb_to_yuv420(rgba)
        y, u, v, ph, pw = _pad_planes(y, u, v)
        idr, sps_r, pps_r = _encode_tile((y, u, v), qp, policy)
        payload = struct.pack(">I", len(idr)) + idr
        items.append((1, b"hvc1", payload, [
            (_box("hvcC", _hvcc(sps_r, pps_r)), True),
            (_ispe(W, H), False), (_colr_601_full(), False)]))
        next_id = 2

    if has_alpha:
        a = rgba[:, :, 3].astype(np.int32)
        au = np.full(((a.shape[0] + 1) // 2, (a.shape[1] + 1) // 2),
                     128, np.int32)
        ya, ua, va, _, _ = _pad_planes(a, au, au.copy())
        idr, sps_r, pps_r = _encode_tile((ya, ua, va), min(qp, 30),
                                         policy)
        aux_id = next_id
        auxc = _full("auxC", 0, 0,
                     b"urn:mpeg:hevc:2015:auxid:1\0")
        items.append((aux_id, b"hvc1",
                      struct.pack(">I", len(idr)) + idr, [
                          (_box("hvcC", _hvcc(sps_r, pps_r)), True),
                          (_ispe(W, H), False), (auxc, False)]))
        refs.append(("auxl", aux_id, [primary_id]))

    return _assemble(items, refs, primary_id)


def _assemble(items, refs, primary_id,
              brand: bytes = b"heic",
              compat: bytes = b"heicmif1") -> bytes:
    """Build ftyp + meta (+iloc resolved) + mdat.  brand/compat let
    the same assembler emit AVIF containers (av01 items)."""
    ftyp = _box("ftyp", brand + struct.pack(">I", 0) + compat)

    hdlr = _full("hdlr", 0, 0,
                 struct.pack(">I", 0) + b"pict" + bytes(12) + b"\0")
    pitm = _full("pitm", 0, 0, struct.pack(">H", primary_id))

    # ipco: dedupe property boxes, ipma: per-item associations
    ipco_children = []
    assoc = {}
    for item_id, _t, _p, props in items:
        idxs = []
        for pbox, essential in props:
            if pbox in ipco_children:
                idx = ipco_children.index(pbox) + 1
            else:
                ipco_children.append(pbox)
                idx = len(ipco_children)
            idxs.append((idx, essential))
        assoc[item_id] = idxs
    ipco = _box("ipco", b"".join(ipco_children))
    ipma_body = struct.pack(">I", len(items))
    for item_id, _t, _p, _props in items:
        idxs = assoc[item_id]
        ipma_body += struct.pack(">HB", item_id, len(idxs))
        for idx, ess in idxs:
            ipma_body += bytes(((0x80 if ess else 0) | idx,))
    ipma = _full("ipma", 0, 0, ipma_body)
    iprp = _box("iprp", ipco + ipma)

    infes = b"".join(_infe(i, t) for i, t, _p, _pr in items)
    iinf = _full("iinf", 0, 0, struct.pack(">H", len(items)) + infes)

    iref_body = b""
    for rtype, frm, tos in refs:
        iref_body += _box(rtype, struct.pack(">H", frm)
                          + struct.pack(">H", len(tos))
                          + b"".join(struct.pack(">H", t) for t in tos))
    iref = _full("iref", 0, 0, iref_body) if refs else b""

    # iloc needs mdat payload offsets: compute with a two-pass build
    payloads = [(i, p) for i, _t, p, _pr in items]

    def build_iloc(base_off):
        body = bytes((0x44, 0x00))          # offset_size 4, length 4
        body += struct.pack(">H", len(payloads))
        off = base_off
        for item_id, p in payloads:
            body += struct.pack(">HHH", item_id, 0, 1)   # id, dref, 1 ext
            body += struct.pack(">II", off, len(p))
            off += len(p)
        return _full("iloc", 0, 0, body)

    probe_meta = _box("meta", struct.pack(">I", 0) + hdlr + pitm
                      + build_iloc(0) + iinf + iref + iprp)
    mdat_payload = b"".join(p for _i, p in payloads)
    base = len(ftyp) + len(probe_meta) + 8      # mdat header
    meta = _box("meta", struct.pack(">I", 0) + hdlr + pitm
                + build_iloc(base) + iinf + iref + iprp)
    assert len(meta) == len(probe_meta)
    mdat = _box("mdat", mdat_payload)
    return ftyp + meta + mdat


def encode_heif_sequence(pics, qp: int = 27) -> bytes:
    """Write a HEIC with a still primary item (first frame) plus a
    moov/trak hvc1 image sequence carrying every frame — the container
    shape heif.c:431-462 reads.  Minimal sample tables (stsd/stsc/
    stsz/stco), one chunk."""
    first = pics[0]
    base = encode_heif(first, qp=qp)

    policy = EncPolicy(seed=0, split_prob=0.35, tt_split_prob=0.25,
                       nxn_prob=0.15,
                       mode_candidates=tuple(range(0, 35, 2)) + (1,))
    samples = []
    sps_r = pps_r = None
    for p in pics:
        rgba = _host_rgba(p)
        y, u, v = rgb_to_yuv420(rgba)
        y, u, v, _, _ = _pad_planes(y, u, v)
        idr, sps_r, pps_r = _encode_tile((y, u, v), qp, policy)
        samples.append(struct.pack(">I", len(idr)) + idr)

    return sequence_heic(base, samples, rgba.shape[1], rgba.shape[0],
                         _hvcc(sps_r, pps_r))


def sequence_heic(base: bytes, samples: list, width: int, height: int,
                  hvcc: bytes) -> bytes:
    """``base`` (a HEIC with its still items) followed by a moov/trak
    hvc1 image sequence of ``samples`` (each an access unit's
    length-prefixed NAL units) with the sample entry's ``hvcc`` record.
    Minimal sample tables (stsd/stsc/stsz/stco), one chunk."""
    sample_entry = (struct.pack(">I4s", 0, b"hvc1") + bytes(6)
                    + struct.pack(">H", 1) + bytes(16)
                    + struct.pack(">HH", width, height)
                    + struct.pack(">II", 0x480000, 0x480000)
                    + bytes(4) + struct.pack(">H", 1) + bytes(32)
                    + struct.pack(">Hh", 24, -1)
                    + _box("hvcC", hvcc))
    sample_entry = (struct.pack(">I", len(sample_entry))
                    + sample_entry[4:])
    stsd = _full("stsd", 0, 0, struct.pack(">I", 1) + sample_entry)
    stsc = _full("stsc", 0, 0,
                 struct.pack(">IIII", 1, 1, len(samples), 1))
    stsz = _full("stsz", 0, 0,
                 struct.pack(">II", 0, len(samples))
                 + b"".join(struct.pack(">I", len(s)) for s in samples))
    # stco offset resolved after sizing
    payload = b"".join(samples)

    def build_moov(chunk_off):
        stco = _full("stco", 0, 0, struct.pack(">II", 1, chunk_off))
        stbl = _box("stbl", stsd + stsc + stsz + stco)
        minf = _box("minf", stbl)
        mdia = _box("mdia", minf)
        trak = _box("trak", mdia)
        return _box("moov", trak)

    probe_moov = build_moov(0)
    chunk_off = len(base) + len(probe_moov) + 8   # + mdat header
    moov = build_moov(chunk_off)
    assert len(moov) == len(probe_moov)
    return base + moov + _box("mdat", payload)
