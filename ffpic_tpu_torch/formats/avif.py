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

Copied from ``ffpic_tpu/formats/avif.py`` for the PyTorch port
(``probe``, the CICP colour, ``_decode_item_yuv``/``_rgba``,
``_decode_grid``, ``_decode_alpha``, ``_alpha_plane``, the still
``load`` with irot/imir and the ``sequence_header`` meta,
``_track_setup``, ``info``), on the port's ``heif.parse_structure``,
``read_item``, ``_grid_layout``, ``_grid_workers``, ``_find_alpha_item``
and ``basemedia``, with these changes:

* the host decode is ``decode``; the registry's ``load`` stages its
  pixels to the device, and ``decode_batch``'s pool calls it for an
  AVIF member, as for the port's other host codecs;
* the colour always takes the native ``av1_color_cicp``: the port does
  not honour ``FFPIC_HOST_COLOR`` (``_yuv_to_rgba_np`` stays the oracle
  the tests hold the C against);
* a file with an ``av01`` track (animated AVIF) raises
  ``NotImplementedError`` naming ``ROADMAP.md`` Queue 1 item 19
  (``av1_tile.INTER_ITEM``), before the cover is decoded: the reference
  returns the track's frames in place of the cover, or the cover with
  ``meta["degraded"]`` when the track fails (``:356-397``), and the
  port decodes no track yet.  A track box the walk cannot read leaves
  the cover, as in the reference.  ``encode`` raises the same error
  (the reference's encoder, ``coding/av1_enc.py``, waits for the item);
* host span (``utils/trace.stage``) ``avif.color``, beside the AV1
  decoder's ``av1.*`` spans.
"""

from __future__ import annotations

import struct

import numpy as np

from ffpic_tpu_torch import native
from ffpic_tpu_torch.coding.av1_tile import INTER_ITEM
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
    # animated AVIF (avis): the reference decodes the av01 track in
    # place of the cover; the port has no inter decoder yet.  As in
    # the reference, a moov the walk cannot read leaves the cover
    try:
        setup = _track_setup(data, nclx)
    except (ValueError, NotImplementedError, struct.error,
            IndexError, KeyError) as e:
        log.warning("avis moov walk failed: %s", e)
        setup = None
    if setup is not None:
        raise NotImplementedError(
            f"animated AVIF (an av01 track) is not ported yet; it waits "
            f"for {INTER_ITEM}")

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
    return [pic]


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


def encode(pic, **_options) -> bytes:
    """The reference encodes with its AV1 still encoder
    (``coding/av1_enc.py``), which the port does not have yet."""
    raise NotImplementedError(
        f"the AVIF encoder is not ported yet; it waits for {INTER_ITEM}")


register(Codec(name="AVIF", probe=probe, decode=decode, info=info,
               encode=encode))
