"""AVIF codec — full pixel decode (beyond-reference).

The C reference parses the container and the AV1 sequence header and
stops (format/avif.c:382-405 is a frame stub); here the primary item
(single av01, or a grid of av01 tiles) is decoded to pixels with the
in-repo AV1 intra decoder (coding/av1_tile.py + formats/av1_recon.py,
bit-exact vs dav1d including deblock/CDEF/loop-restoration), then
converted to RGBA honoring the colr/nclx box (CICP matrix + range),
the auxiliary alpha item, and irot/imir transforms.

Reuses the ISOBMFF layer from formats/heif.py (same meta/iloc/iref
structure; only the coded payload differs).

Copied from ``ffpic_tpu/formats/avif.py`` for the PyTorch port whole
(``probe``, the CICP colour, ``_decode_item_yuv``/``_rgba``,
``_decode_grid``, ``_decode_alpha``, ``_alpha_plane``, the still
``load`` with irot/imir and the ``sequence_header`` meta, the ``av01``
track of an animated AVIF (``_track_setup``, ``_track_decode`` through
``av1_recon.Av1Decoder``, the cover replaced by the track's frames with
their ``delay_ms`` and ``meta["frames"]``, the reference's two exception
scopes), ``info`` and ``encode``), on the port's ``heif.parse_structure``,
``read_item``, ``_grid_layout``, ``_grid_workers``, ``_find_alpha_item``,
``basemedia`` and ``heif_enc._assemble``, with these changes:

* the host decode is ``decode``; the registry's ``load`` stages its
  pixels to the device, and ``decode_batch``'s pool calls it for an
  AVIF member (and takes its first picture), as for the port's other
  host codecs;
* the colour always takes the native ``av1_color_cicp``: the port does
  not honour ``FFPIC_HOST_COLOR`` (``_yuv_to_rgba_np`` stays the oracle
  the tests hold the C against);
* ``encode`` reads the picture's pixels from wherever they lie
  (``heif_enc._host_rgba``) and runs on the host whatever ``device`` is;
* host span (``utils/trace.stage``) ``avif.color``, beside the AV1
  decoder's ``av1.*`` spans.
"""

from __future__ import annotations

import struct

import numpy as np

from ffpic_tpu_torch import native
from ffpic_tpu_torch.formats.pic import Pic
from ffpic_tpu_torch.formats.registry import Codec, register
from ffpic_tpu_torch.formats import heif as heif_mod
from ffpic_tpu_torch.formats import basemedia as bm
from ffpic_tpu_torch.utils.trace import stage
from ffpic_tpu_torch.utils.vlog import get_logger

log = get_logger("avif")


def probe(data: bytes) -> bool:
    return (len(data) > 12 and data[4:8] == b"ftyp" and
            data[8:12] in (b"avif", b"avis"))


# ---------------------------------------------------------------- YUV->RGBA

# CICP MatrixCoefficients -> (Kr, Kb).  2 (unspecified) falls back to
# BT.601 — what libavif assumes for display when nothing else is
# signalled.
_CICP_KR_KB = {
    1: (0.2126, 0.0722),    # BT.709
    4: (0.30, 0.11),        # FCC
    5: (0.299, 0.114),      # BT.470BG
    6: (0.299, 0.114),      # BT.601
    7: (0.299, 0.114),      # SMPTE 240 (approx)
    9: (0.2627, 0.0593),    # BT.2020 NCL
    10: (0.2627, 0.0593),   # BT.2020 CL (approximated as NCL)
}


def _norm_plane(p, bd: int, limited: bool, chroma: bool) -> np.ndarray:
    """Code values -> float 0..255 (luma) / centred (chroma)."""
    x = p.astype(np.float32)
    lo = 16 << (bd - 8)
    if chroma:
        x -= float(1 << (bd - 1))
        x *= 255.0 / ((224 << (bd - 8)) if limited else ((1 << bd) - 1))
    else:
        if limited:
            x = (x - lo) * (255.0 / (219 << (bd - 8)))
        else:
            x *= 255.0 / ((1 << bd) - 1)
    return x


def _up2(a: np.ndarray, axis: int) -> np.ndarray:
    """2x bilinear upsample for center-sited chroma (libjpeg 'fancy'
    weights 3/4-1/4): out[2i] = (3c[i]+c[i-1]+2)>>2,
    out[2i+1] = (3c[i]+c[i+1]+2)>>2 — matches libavif's filtered
    chroma upsampling to within rounding."""
    a = np.moveaxis(a, axis, 0).astype(np.int32)
    prev = np.concatenate([a[:1], a[:-1]], 0)
    nxt = np.concatenate([a[1:], a[-1:]], 0)
    out = np.empty((a.shape[0] * 2,) + a.shape[1:], np.int32)
    out[0::2] = (3 * a + prev + 2) >> 2
    out[1::2] = (3 * a + nxt + 2) >> 2
    return np.moveaxis(out, 0, axis)


def _upsample(p, sx: int, sy: int, h: int, w: int) -> np.ndarray:
    if sy:
        p = _up2(p, 0)
    if sx:
        p = _up2(p, 1)
    return p[:h, :w]


def _color_params(meta, nclx):
    """The nclx box wins over the sequence header's color_config
    (both carry CICP; MIAF says the container overrides), defaulting
    to BT.601 when both say 'unspecified'."""
    bd = meta["bit_depth"]
    if nclx:
        mc = nclx.get("matrix", 2)
        full = bool(nclx.get("full_range", True))
    else:
        mc = meta["matrix_coefficients"]
        full = bool(meta["color_range"])
    return bd, mc, not full


def _yuv_to_rgba(planes, meta, nclx) -> np.ndarray:
    """CICP color conversion: native C (host_av1.c av1_color_cicp,
    bit-exact vs the numpy oracle below)."""
    bd, mc, limited = _color_params(meta, nclx)
    h, w = planes[0].shape
    with stage("avif.color"):
        if meta["mono"] or len(planes) == 1:
            return native.av1_color_cicp(planes[:1], h, w, 0, 0, bd,
                                         limited, mode=2)
        if mc == 0:
            return native.av1_color_cicp(planes, h, w, 0, 0, bd,
                                         limited, mode=1)
        sx, sy = meta["subsampling"]
        kr, kb = _CICP_KR_KB.get(mc, (0.299, 0.114))
        return native.av1_color_cicp(planes, h, w, sx, sy, bd,
                                     limited, mode=0, kr=kr, kb=kb)


def _yuv_to_rgba_np(planes, meta, nclx) -> np.ndarray:
    """Numpy float32 oracle for the CICP conversion."""
    bd, mc, limited = _color_params(meta, nclx)

    h, w = planes[0].shape
    if meta["mono"] or len(planes) == 1:
        g8 = np.clip(np.floor(
            _norm_plane(planes[0], bd, limited, False) + 0.5),
            0, 255).astype(np.uint8)
        rgba = np.empty((h, w, 4), np.uint8)
        rgba[:, :, 0] = rgba[:, :, 1] = rgba[:, :, 2] = g8
        rgba[:, :, 3] = 255
        return rgba

    if mc == 0:                           # identity: planes are G, B, R
        sc = 255.0 / ((1 << bd) - 1)
        g, b, r = (np.clip(np.floor(p.astype(np.float32) * sc + 0.5),
                           0, 255) for p in planes)
        return np.stack([r, g, b, np.full((h, w), 255.0)],
                        -1).astype(np.uint8)

    sx, sy = meta["subsampling"]
    yy = _norm_plane(planes[0], bd, limited, False)
    uu = _norm_plane(_upsample(planes[1], sx, sy, h, w), bd, limited,
                     True)
    vv = _norm_plane(_upsample(planes[2], sx, sy, h, w), bd, limited,
                     True)
    kr, kb = _CICP_KR_KB.get(mc, (0.299, 0.114))
    kg = 1.0 - kr - kb
    r = np.floor(yy + 2 * (1 - kr) * vv + 0.5)
    b = np.floor(yy + 2 * (1 - kb) * uu + 0.5)
    g = np.floor(yy - (2 * kb * (1 - kb) / kg) * uu
                 - (2 * kr * (1 - kr) / kg) * vv + 0.5)
    rgba = np.stack([np.clip(r, 0, 255), np.clip(g, 0, 255),
                     np.clip(b, 0, 255), np.full((h, w), 255.0)],
                    -1).astype(np.uint8)
    return rgba


# ------------------------------------------------------------- item decode

def _decode_item_yuv(data, s, item_id):
    from ffpic_tpu_torch.formats.av1_recon import decode_frame
    payload = heif_mod.read_item(data, s, item_id)
    return decode_frame(payload)


def _decode_item_rgba(data, s, item_id, nclx):
    planes, meta = _decode_item_yuv(data, s, item_id)
    props = s["items"][item_id].get("properties", {})
    rgba = _yuv_to_rgba(planes, meta, nclx)
    w = min(props.get("width") or rgba.shape[1], rgba.shape[1])
    h = min(props.get("height") or rgba.shape[0], rgba.shape[0])
    return rgba[:h, :w]


def _decode_grid(data, s, tile_ids, grid, nclx):
    """Grid of av01 tiles — each an independent entropy+recon unit
    (the host-thread split point, heif.c:273-312 analog).  Tiles are
    pasted in YUV space and color-converted ONCE so chroma upsampling
    crosses tile seams (per-tile RGB conversion leaves visible seam
    rounding; libavif reassembles in YUV too)."""
    W, H = grid["width"], grid["height"]
    cols = grid["cols"]
    nw = heif_mod._grid_workers(len(tile_ids))
    if nw > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=nw) as ex:
            tiles = list(ex.map(
                lambda tid: _decode_item_yuv(data, s, tid), tile_ids))
    else:
        tiles = [_decode_item_yuv(data, s, tid) for tid in tile_ids]

    meta0 = tiles[0][1]
    sx, sy = meta0["subsampling"]
    nplanes = 1 if meta0["mono"] else 3
    cw, ch = (W + sx) >> sx, (H + sy) >> sy
    dt = tiles[0][0][0].dtype
    canvases = [np.zeros((H, W), dt)] + \
        [np.zeros((ch, cw), dt) for _ in range(nplanes - 1)]
    for idx, (planes, _m) in enumerate(tiles):
        r, c = divmod(idx, cols)
        th, tw = planes[0].shape
        y0, x0 = r * th, c * tw
        if y0 >= H or x0 >= W:
            continue
        canvases[0][y0:y0 + th, x0:x0 + tw] = \
            planes[0][:H - y0, :W - x0]
        for pi in range(1, nplanes):
            cy0, cx0 = y0 >> sy, x0 >> sx
            p = planes[pi]
            canvases[pi][cy0:cy0 + p.shape[0], cx0:cx0 + p.shape[1]] \
                = p[:ch - cy0, :cw - cx0]
    return _yuv_to_rgba(canvases, meta0, nclx)


def _decode_alpha(data, s, alpha_id):
    """Aux alpha item: a monochrome (or luma-only-used) av01 item,
    possibly itself a grid."""
    item = s["items"][alpha_id]
    if item.get("type") == "grid":
        grid = heif_mod._grid_layout(heif_mod.read_item(data, s,
                                                        alpha_id))
        a_tiles = []
        for rtype, frm, tos in s["refs"]:
            if rtype == "dimg" and frm == alpha_id:
                a_tiles = tos
        W, H = grid["width"], grid["height"]
        canvas = np.zeros((H, W), np.uint8)
        for idx, tid in enumerate(a_tiles):
            r, c = divmod(idx, grid["cols"])
            canvas_tile = _alpha_plane(*_decode_item_yuv(data, s, tid))
            th, tw = canvas_tile.shape
            y0, x0 = r * th, c * tw
            if y0 < H and x0 < W:
                canvas[y0:y0 + th, x0:x0 + tw] = \
                    canvas_tile[:H - y0, :W - x0]
        return canvas
    return _alpha_plane(*_decode_item_yuv(data, s, alpha_id))


def _alpha_plane(planes, meta):
    bd = meta["bit_depth"]
    limited = not bool(meta["color_range"])
    return np.clip(np.floor(
        _norm_plane(planes[0], bd, limited, False) + 0.5),
        0, 255).astype(np.uint8)


# --------------------------------------------------------------------- load

def decode(data: bytes, skip_decode: bool = False, *,
           device) -> list[Pic]:
    """The still picture as host (H, W, 4) uint8 RGBA (``device`` is
    not used: the whole decode runs on the host)."""
    s = heif_mod.parse_structure(data)
    primary_id = s["primary"]
    items = s["items"]
    primary = items.get(primary_id, {})
    props = primary.get("properties", {})
    W = props.get("width", 0)
    H = props.get("height", 0)
    meta = dict(primary=primary_id, n_items=len(items),
                items={i: it["type"] for i, it in items.items()})

    tile_ids = []
    if primary.get("type") == "grid":
        grid = heif_mod._grid_layout(heif_mod.read_item(data, s,
                                                        primary_id))
        meta["grid"] = grid
        W, H = grid["width"], grid["height"]
        for rtype, frm, tos in s["refs"]:
            if rtype == "dimg" and frm == primary_id:
                tile_ids = tos

    # sequence-header info for picinfo (full parser — the lightweight
    # duplicate this module used to carry is gone)
    seq_item = primary_id if primary.get("type") == "av01" else \
        (tile_ids[0] if tile_ids else None)
    if seq_item is not None:
        try:
            from ffpic_tpu_torch.coding import av1_headers as Hh
            payload = heif_mod.read_item(data, s, seq_item)
            for obu in Hh.parse_obus(payload):
                if obu["type"] == Hh.OBU_SEQUENCE_HEADER:
                    sh = Hh.parse_sequence_header(obu["payload"])
                    meta["sequence_header"] = dict(
                        profile=sh.profile,
                        still_picture=sh.still_picture,
                        width=sh.max_frame_width,
                        height=sh.max_frame_height,
                        bit_depth=sh.bit_depth,
                        mono=sh.mono_chrome,
                        subsampling=(sh.subsampling_x,
                                     sh.subsampling_y))
                    if not W:
                        W, H = sh.max_frame_width, sh.max_frame_height
                    break
        except (IndexError, ValueError):
            pass

    meta.update(width=W, height=H)
    pic = Pic(width=W, height=H, depth=32, pitch=W * 4, codec="AVIF",
              meta=meta)
    if skip_decode:
        return [pic]

    nclx = props.get("nclx")
    if nclx is None and tile_ids:
        nclx = items[tile_ids[0]]["properties"].get("nclx")

    if primary.get("type") == "grid":
        rgba = _decode_grid(data, s, tile_ids, meta["grid"], nclx)
    elif primary.get("type") == "av01":
        rgba = _decode_item_rgba(data, s, primary_id, nclx)[:H, :W]
    else:
        raise NotImplementedError(
            f"AVIF primary item type {primary.get('type')!r}")

    alpha_id = heif_mod._find_alpha_item(s, primary_id, tile_ids)
    if alpha_id is not None:
        try:
            a = _decode_alpha(data, s, alpha_id)
            if a is not None and a.shape == rgba.shape[:2]:
                rgba = rgba.copy()
                rgba[:, :, 3] = a
                meta["alpha"] = True
        except (ValueError, NotImplementedError) as e:
            log.warning("alpha aux item decode failed: %s", e)

    # irot (anti-clockwise 90s) then imir, libavif's application order
    rot = props.get("rotation", 0)
    if rot:
        rgba = np.ascontiguousarray(np.rot90(rgba, rot // 90))
        meta["rotation"] = rot
    mir = props.get("mirror")
    if mir is not None:
        rgba = np.ascontiguousarray(
            np.fliplr(rgba) if mir == 0 else np.flipud(rgba))
        meta["mirror"] = mir
    pic.width, pic.height = rgba.shape[1], rgba.shape[0]
    pic.pitch = pic.width * 4
    meta.update(width=pic.width, height=pic.height)

    pic.pixels = rgba
    pics = [pic]
    # animated AVIF (avis): decode the av01 track samples through the
    # stateful multi-frame decoder (Av1Decoder — inter prediction,
    # reference slots, show_existing_frame).  The C reference parses
    # no AV1 pixels at all; frame oracle is dav1d
    # (tests/test_av1_inter.py::test_avis_end_to_end).  The still
    # cover item duplicates the first track frame, so on a successful
    # track decode the cover Pic is REPLACED by the track frames —
    # each animation frame appears exactly once, matching this repo's
    # GIF/WebP convention.  ONLY the untrusted container walk
    # (basemedia.track_samples struct.unpack walks) gets the broad
    # except — a malformed moov must not sink the already-decoded
    # cover image.  Decoder errors from the already-validated OBU
    # stream propagate as typed codec errors; anything else
    # (IndexError/KeyError from a decoder regression) raises.
    try:
        setup = _track_setup(data, nclx)
    except (ValueError, NotImplementedError, struct.error,
            IndexError, KeyError) as e:
        log.warning("avis moov walk failed: %s", e)
        setup = None
    if setup is not None:
        try:
            track = []
            for rgba_f, dur in _track_decode(data, setup):
                # apply the cover item's irot/imir so all frames
                # agree in orientation with frame 0
                if rot:
                    rgba_f = np.ascontiguousarray(
                        np.rot90(rgba_f, rot // 90))
                if mir is not None:
                    rgba_f = np.ascontiguousarray(
                        np.fliplr(rgba_f) if mir == 0 else
                        np.flipud(rgba_f))
                track.append((rgba_f, dur))
        except (ValueError, NotImplementedError) as e:
            log.warning("avis track decode failed: %s", e)
            meta["degraded"] = f"track decode failed: {e}"
            track = []
        if track:
            pics = []
            for fi, (rgba_f, dur) in enumerate(track):
                fh_, fw_ = rgba_f.shape[:2]
                fmeta = meta if fi == 0 else dict(width=fw_,
                                                  height=fh_)
                pics.append(Pic(width=fw_, height=fh_, depth=32,
                                pitch=fw_ * 4, codec="AVIF",
                                pixels=rgba_f, delay_ms=dur,
                                meta=fmeta))
            meta["frames"] = len(pics)
            meta.update(width=pics[0].width, height=pics[0].height)
    return pics


def _track_setup(data: bytes, item_nclx):
    """Untrusted container walk for an av01 track: sample table,
    av1C config OBUs, and color info.  Returns None when no av01
    track exists; raises on malformed boxes (caller catches)."""
    boxes = bm.parse_boxes(data, 0, len(data))
    tr = bm.track_samples(data, boxes, "av01")
    if tr is None:
        return None
    es = tr["entry_start"]
    children = bm.parse_boxes(data, es + 86, es + tr["entry_size"])
    av1c = bm.find_box(children, "av1C")
    # av1C: 4 fixed bytes then configOBUs (usually the sequence header)
    cfg = (data[av1c.start + 4:av1c.start + av1c.size]
           if av1c is not None else b"")
    nclx = item_nclx
    colr = bm.find_box(children, "colr")
    if colr is not None and data[colr.start:colr.start + 4] == b"nclx":
        import struct as _st
        nclx = dict(
            primaries=_st.unpack_from(">H", data, colr.start + 4)[0],
            transfer=_st.unpack_from(">H", data, colr.start + 6)[0],
            matrix=_st.unpack_from(">H", data, colr.start + 8)[0],
            full_range=bool(data[colr.start + 10] >> 7))
    return dict(tr=tr, cfg=cfg, nclx=nclx)


def _track_decode(data: bytes, setup):
    """Decode av01 track samples (animated AVIF) to RGBA frames.
    Yields (rgba, duration_ms) per SHOWN frame.  The first track frame
    usually duplicates the still cover item — both are returned; the
    caller's Pic list mirrors the GIF/WebP frame convention."""
    tr, cfg, nclx = setup["tr"], setup["cfg"], setup["nclx"]
    from ffpic_tpu_torch.formats.av1_recon import Av1Decoder
    dec = Av1Decoder()
    if cfg:
        dec.decode_obus(cfg)
    for (off, size), dur in zip(tr["samples"], tr["durations"]):
        for planes, fmeta in dec.decode_obus(data[off:off + size]):
            yield _yuv_to_rgba(planes, fmeta, nclx), dur


def info(pic: Pic) -> str:
    m = pic.meta
    lines = ["AVIF file format",
             f"\twidth {m['width']}, height {m['height']}",
             f"\tprimary item {m['primary']}, {m['n_items']} items"]
    if m.get("grid"):
        g = m["grid"]
        lines.append(f"\tgrid {g['rows']}x{g['cols']} tiles")
    if "sequence_header" in m:
        sh = m["sequence_header"]
        lines.append(f"\tAV1 profile {sh.get('profile')} "
                     f"{sh.get('width')}x{sh.get('height')} "
                     f"{sh.get('bit_depth')}-bit "
                     f"still={sh.get('still_picture')}")
    if m.get("alpha"):
        lines.append("\talpha: auxiliary item")
    return "\n".join(lines)


def encode(pic, quality: int = 75, *, device=None, **_options) -> bytes:
    """Encode a Pic to AVIF using the in-repo AV1 still-picture
    encoder (coding/av1_enc.py) + the shared ISOBMFF assembler, on the
    host whatever ``device`` is.

    quality 100 = mathematically lossless (CICP identity color, the
    RGB channels ride the 4:4:4 planes as G,B,R, qindex 0 / WHT);
    otherwise BT.601 full-range 4:2:0 at a quality-mapped qindex.
    The reference (format/avif.c) can neither decode nor encode AVIF.
    """
    import struct as _st
    from ffpic_tpu_torch.coding.av1_enc import encode_av1
    from ffpic_tpu_torch.formats.heif_enc import (_assemble, _box, _full,
                                                  _host_rgba)
    rgba = _host_rgba(pic)
    Hh, Ww = rgba.shape[:2]
    rgb = rgba[..., :3].astype(np.float64)
    if quality >= 100:
        g, b, r = rgb[..., 1], rgb[..., 2], rgb[..., 0]
        planes = [g.astype(np.uint8), b.astype(np.uint8),
                  r.astype(np.uint8)]
        obus = encode_av1(planes, 8, (0, 0), 0)
        profile, sx, sy, matrix = 1, 0, 0, 0
    else:
        qindex = int(np.clip(round((100 - quality) * 2.2 + 8),
                             1, 255))
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        y = 0.299 * r + 0.587 * g + 0.114 * b
        cb = 128.0 + (b - y) * (0.5 / (1.0 - 0.114))
        cr = 128.0 + (r - y) * (0.5 / (1.0 - 0.299))
        # 2x2 box-average chroma subsample (pad to even first)
        def sub(p):
            ph = p[:, :, None] if False else p
            pe = np.pad(p, ((0, Hh & 1), (0, Ww & 1)), mode="edge")
            return ((pe[0::2, 0::2] + pe[0::2, 1::2]
                     + pe[1::2, 0::2] + pe[1::2, 1::2]) / 4.0)
        yq = np.clip(np.round(y), 0, 255).astype(np.uint8)
        uq = np.clip(np.round(sub(cb)), 0, 255).astype(np.uint8)
        vq = np.clip(np.round(sub(cr)), 0, 255).astype(np.uint8)
        obus = encode_av1([yq, uq, vq], 8, (1, 1), qindex)
        profile, sx, sy, matrix = 0, 1, 1, 6
    flags = (0 << 6) | (0 << 5) | (0 << 4) | (sx << 3) | (sy << 2)
    av1c = _box("av1C", bytes([0x81, profile << 5, flags, 0]))
    ispe = _full("ispe", 0, 0, _st.pack(">II", Ww, Hh))
    pixi = _full("pixi", 0, 0, bytes([3, 8, 8, 8]))
    colr = _box("colr", b"nclx" + _st.pack(">HHH", 1, 13, matrix)
                + bytes([0x80]))
    items = [(1, b"av01", obus,
              [(ispe, False), (av1c, True), (pixi, False),
               (colr, False)])]
    return _assemble(items, [], 1, brand=b"avif",
                     compat=b"avifmif1miaf")


register(Codec(name="AVIF", probe=probe, decode=decode, info=info,
               encode=encode))
