"""HEIF/HEIC container codec of the port.

Container parity with the reference's format/heif.c: ftyp brand probe
(heif.c:22-63), meta box family (iloc/iinf/ipco/ipma/iref/pitm/idat),
hvcC parameter-set extraction (heif.c:78-125), item pre-read including
idat and multi-extent items (heif.c:212-242), grid tiling
(heif.c:273-312), auxiliary alpha items, Exif items, and moov/trak
image sequences.

Pixel decode is FULL: hvc1 items run through the HEVC Main/Main-Still
slice decoder (native C syntax + recon, coding/hevc_slice.py oracle) —
single items, grids, auxiliary alpha, 8- and 10-bit (Main10), with
real deblocking and SAO (the reference stubs/disables those).
``encode`` writes HEIC (formats/heif_enc.py) — single item, grid
tiles, alpha aux; the reference has no HEIF encoder.

Copied from ``ffpic_tpu/formats/heif.py`` (``probe``, ``_parse_hvcc``,
``_item_properties``, ``parse_structure``, ``read_item``,
``_grid_layout``, ``load``, ``_decode_item_yuv``, ``_yuv_pic_to_rgba``,
``_decode_item_rgba``, ``_grid_workers``, ``_decode_grid``,
``_find_alpha_item``, ``_decode_alpha``, ``info``, ``encode``,
``_decode_sequence``), with
its imports rewritten to the port's modules (EXIF through
``formats.jpg._parse_exif``).  Split as ``formats.webp`` is split:

* ``parse`` is the host part (span ``heif.parse`` for the boxes): the
  HEVC decode of every item, grid tiles in a thread pool
  (``_grid_workers``), each tile's CABAC syntax and reconstruction on
  the host (``formats.hevc``; under ``FFPIC_HEVC_DEVICE`` the residual
  transform runs on the device, on the stream that was current where
  ``parse`` was called: a single item's in one launch of its own, a
  grid's in three phases, ``_decode_tiles``: every tile's syntax pass
  in the pool, then one staging, one launch over all tiles' TUs and one
  read-back on the calling thread, then every tile's recon in the
  pool), then the host colour (span ``heif.color``:
  ``native.hevc_color``), the paste into the canvas, the alpha item
  (span ``heif.alpha``) and ``irot``, and the frames of an image
  sequence (``_decode_sequence``: ``hevc.SequenceDecoder`` over the
  track's samples, P/B pictures motion-compensated on the host), as the
  original does them.  With ``FFPIC_HEIF_DEVICE_COLOR`` set (and a mode
  other than nclx) it stops at each tile's and each frame's planes,
  cast to int16 as the original stages them;
* ``to_pics`` is the device part: the staging copy (span ``heif.h2d``)
  of the RGBA pixels, or of every tile's planes, descriptors and the
  canvas's cells in one copy, then one launch of the
  ``hevc_yuv_to_rgba`` kernel over every tile (span ``heif.color``;
  ``hevc_kernels.hevc_tiles_to_rgba``, its plain version on the CPU),
  which writes each canvas pixel once, the tiles' colour and the
  uncovered (0, 0, 0, 255), where the original reads each tile back and
  pastes it on the host; the alpha plane and ``irot`` are then applied
  on the device (span ``heif.alpha``); then each sequence frame, its
  host RGBA copied or its planes coloured in one launch of its own
  (``frame_pixels``).  Pixels land on the load's device, as the port's
  other codecs' do.

``decode_batch`` runs ``parse`` in its worker pool, without the
sequence (it returns the primary picture, as the original's does), and
``to_pics`` on the caller's thread.  ``FFPIC_NO_NATIVE`` is not honoured
(the numpy colour of the original is left out): the port's native
build raises on failure.  Under ``FFPIC_HEIF_DEVICE_COLOR`` a 10-bit
item is coloured as if its samples were 8-bit, as in the original
(``ROADMAP.md`` Queue 3).
"""

from __future__ import annotations

import os
import struct
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from ffpic_tpu_torch import native
from ffpic_tpu_torch.formats.pic import Pic
from ffpic_tpu_torch.formats.registry import Codec, register
from ffpic_tpu_torch.formats import basemedia as bm
from ffpic_tpu_torch.formats import hevc
from ffpic_tpu_torch.ops import hevc_kernels
from ffpic_tpu_torch.utils import trace
from ffpic_tpu_torch.utils.device import resolve_device, to_device
from ffpic_tpu_torch.utils.vlog import get_logger

log = get_logger("heif")

BRANDS = {b"heic", b"heix", b"hevc", b"hevx", b"mif1", b"msf1", b"heim",
          b"heis", b"hevm", b"hevs"}


def probe(data: bytes) -> bool:
    if len(data) < 12 or data[4:8] != b"ftyp":
        return False
    major = data[8:12]
    if major in (b"avif", b"avis"):   # AVIF claims these (avif.py)
        return False
    if major in BRANDS:
        return True
    size = struct.unpack_from(">I", data, 0)[0]
    for off in range(16, min(size, 64), 4):
        if data[off:off + 4] in BRANDS:
            return True
    return False


def _parse_hvcc(data: bytes, box: bm.Box) -> dict:
    """hvcC: config record with parameter-set NALU arrays
    (heif.c:78-125)."""
    p = box.start
    cfg_version = data[p]
    length_size = (data[p + 21] & 3) + 1
    num_arrays = data[p + 22]
    p += 23
    nalus = {"vps": [], "sps": [], "pps": [], "sei": []}
    names = {32: "vps", 33: "sps", 34: "pps", 39: "sei", 40: "sei"}
    for _ in range(num_arrays):
        ntype = data[p] & 0x3F
        cnt = struct.unpack_from(">H", data, p + 1)[0]
        p += 3
        for _ in range(cnt):
            ln = struct.unpack_from(">H", data, p)[0]
            p += 2
            nalus.setdefault(names.get(ntype, str(ntype)), []) \
                .append(data[p:p + ln])
            p += ln
    return dict(length_size=length_size, nalus=nalus,
                version=cfg_version)


def _item_properties(data, boxes, item_id, ipma, ipco_children):
    props = {}
    for idx, _ess in ipma.get(item_id, []):
        if 1 <= idx <= len(ipco_children):
            b = ipco_children[idx - 1]
            if b.type == "ispe":
                w, h = struct.unpack_from(">II", data, b.start + 4)
                props["width"], props["height"] = w, h
            elif b.type == "hvcC":
                props["hvcC"] = _parse_hvcc(data, b)
            elif b.type == "av1C":
                props["av1C"] = data[b.start:b.start + b.size]
            elif b.type == "irot":
                props["rotation"] = (data[b.start] & 3) * 90
            elif b.type == "imir":
                # ISO 23008-12 6.5.12: axis 0 = vertical (left-right
                # flip), 1 = horizontal (top-bottom flip)
                props["mirror"] = data[b.start] & 1
            elif b.type == "colr":
                ctype = data[b.start:b.start + 4]
                props["colr"] = ctype
                if ctype == b"nclx" and b.size >= 11:
                    props["nclx"] = dict(
                        primaries=struct.unpack_from(
                            ">H", data, b.start + 4)[0],
                        transfer=struct.unpack_from(
                            ">H", data, b.start + 6)[0],
                        matrix=struct.unpack_from(
                            ">H", data, b.start + 8)[0],
                        full_range=bool(data[b.start + 10] >> 7))
            elif b.type == "pixi":
                n = data[b.start + 4]
                props["bits_per_channel"] = list(
                    data[b.start + 5:b.start + 5 + n])
            elif b.type == "auxC":
                e = data.index(b"\0", b.start + 4)
                props["aux_type"] = data[b.start + 4:e].decode(
                    "latin1", "replace")
    return props


def parse_structure(data: bytes) -> dict:
    boxes = bm.parse_boxes(data, 0, len(data))
    meta = bm.find_box(boxes, "meta")
    if meta is None:
        raise ValueError("no meta box")
    out = {"items": {}, "primary": None, "grid": None, "refs": [],
           "sequence": bool(bm.find_box(boxes, "moov"))}

    pitm = bm.find_box(meta.children, "pitm")
    if pitm:
        if pitm.version == 0:
            out["primary"] = struct.unpack_from(">H", data,
                                                pitm.start + 4)[0]
        else:
            out["primary"] = struct.unpack_from(">I", data,
                                                pitm.start + 4)[0]

    iloc = bm.find_box(meta.children, "iloc")
    iinf = bm.find_box(meta.children, "iinf")
    ipma_box = bm.find_box(meta.children, "iprp/ipma")
    ipco = bm.find_box(meta.children, "iprp/ipco")
    iref = bm.find_box(meta.children, "iref")
    idat = bm.find_box(meta.children, "idat")

    locs = bm.parse_iloc(data, iloc) if iloc else {}
    infos = bm.parse_iinf(data, iinf) if iinf else {}
    ipma = bm.parse_ipma(data, ipma_box) if ipma_box else {}
    out["refs"] = bm.parse_iref(data, iref) if iref else []

    for item_id, info in infos.items():
        item = dict(info)
        item["extents"] = locs.get(item_id, [])
        item["properties"] = _item_properties(
            data, boxes, item_id, ipma, ipco.children if ipco else [])
        out["items"][item_id] = item

    out["idat"] = (idat.start, idat.size) if idat else None
    return out


def read_item(data: bytes, structure: dict, item_id: int) -> bytes:
    """Assemble an item's bytes from its extents (file or idat
    construction, heif.c:212-242)."""
    item = structure["items"][item_id]
    blob = bytearray()
    for method, off, ln in item["extents"]:
        if method == 1:   # idat
            base = structure["idat"][0]
            blob += data[base + off:base + off + ln]
        else:
            blob += data[off:off + ln]
    return bytes(blob)


def _grid_layout(grid_bytes: bytes) -> dict:
    ver, flags, rows, cols = grid_bytes[0], grid_bytes[1], \
        grid_bytes[2] + 1, grid_bytes[3] + 1
    if flags & 1:
        w, h = struct.unpack_from(">II", grid_bytes, 4)
    else:
        w, h = struct.unpack_from(">HH", grid_bytes, 4)
    return dict(rows=rows, cols=cols, width=w, height=h)


@dataclass
class HeifFile:
    """What ``parse`` leaves for ``to_pics``: the picture's header, and
    its pixels as host RGBA (``rgba``, alpha and ``irot`` applied), or,
    under ``FFPIC_HEIF_DEVICE_COLOR``, one ``_Tile`` per item to colour
    on the device (``grid`` the canvas's (H, W) for a grid, None for a
    single item) with the alpha plane and the rotation still to apply;
    ``frames`` the image sequence's frames in presentation order, each
    its host RGBA or, under ``FFPIC_HEIF_DEVICE_COLOR``, a ``_Tile``."""
    pic: Pic
    rgba: np.ndarray | None = None
    tiles: list = field(default_factory=list)
    grid: tuple | None = None
    mode: str = "bt601"
    alpha: np.ndarray | None = None
    rotation: int = 0
    frames: list = field(default_factory=list)


@dataclass
class _Tile:
    """One item's planes for the device colour: int16 Y and, for 4:2:0,
    U and V; the (out_h, out_w) the original crops its RGBA to, and its
    place (y0, x0) in the canvas."""
    planes: list
    out_h: int
    out_w: int
    y0: int = 0
    x0: int = 0


def _device_color(mode) -> bool:
    """``FFPIC_HEIF_DEVICE_COLOR``: the colour runs on the device (not
    for an nclx mode, which stays on the host as in the original)."""
    return bool(os.environ.get("FFPIC_HEIF_DEVICE_COLOR")) \
        and not isinstance(mode, dict)


def parse(data: bytes, skip_decode: bool = False, mode="bt601",
          device=None, sequence: bool = True) -> HeifFile:
    """The host part of a decode (``heif.py:180-302``).  ``device`` is
    where ``FFPIC_HEVC_DEVICE``'s residual transform runs (None: CUDA).
    ``sequence=False`` leaves an image sequence's frames undecoded."""
    with trace.stage("heif.parse"):
        s = parse_structure(data)
    primary_id = s["primary"]
    items = s["items"]
    meta = dict(primary=primary_id,
                n_items=len(items),
                items={i: dict(type=it["type"],
                               size=sum(e[2] for e in it["extents"]),
                               **{k: v for k, v in it["properties"].items()
                                  if k != "hvcC"})
                       for i, it in items.items()},
                sequence=s["sequence"])

    primary = items.get(primary_id, {})
    props = primary.get("properties", {})
    W = props.get("width", 0)
    H = props.get("height", 0)

    tile_ids = []
    if primary.get("type") == "grid":
        grid = _grid_layout(read_item(data, s, primary_id))
        meta["grid"] = grid
        W, H = grid["width"], grid["height"]
        for rtype, frm, tos in s["refs"]:
            if rtype == "dimg" and frm == primary_id:
                tile_ids = tos
    hvcc = props.get("hvcC")
    if hvcc is None and tile_ids:
        hvcc = items[tile_ids[0]]["properties"].get("hvcC")

    if hvcc:
        sps_list = hvcc["nalus"].get("sps", [])
        if sps_list:
            sps = hevc.parse_sps(sps_list[0])
            meta["hevc"] = dict(
                profile=sps.ptl.profile_idc, level=sps.ptl.level_idc,
                bit_depth=sps.bit_depth_luma,
                chroma_format=sps.chroma_format,
                coded_size=(sps.width, sps.height),
                ctb=1 << sps.ctb_log2)
            if not W:
                W, H = sps.pic_width_cropped, sps.pic_height_cropped

    # EXIF metadata item (item_type 'Exif', cdsc-linked): payload is a
    # u32 tiff-header offset, then usually "Exif\0\0" + TIFF — reuse
    # the JPEG APP1 parser (the reference ignores Exif items entirely)
    for iid, it in items.items():
        if it.get("type") != "Exif":
            continue
        try:
            from ffpic_tpu_torch.formats.jpg import _parse_exif
            raw = read_item(data, s, iid)
            off = struct.unpack_from(">I", raw, 0)[0]
            body = raw[4 + off:] if 4 + off < len(raw) else raw[4:]
            if body[:6] == b"Exif\x00\x00":
                body = body[6:]
            meta["exif"] = _parse_exif(body)
        except Exception:
            pass                         # malformed EXIF is non-fatal
        break

    # colr/nclx override: wild HEICs are usually BT.709 limited range;
    # only the default mode is overridden (explicit modes win)
    if mode == "bt601":
        nclx = props.get("nclx")
        if nclx is None and tile_ids:
            nclx = items[tile_ids[0]]["properties"].get("nclx")
        if nclx is not None and (nclx.get("matrix", 5) not in (5, 6)
                                 or not nclx.get("full_range", True)):
            mode = nclx

    meta.update(width=W, height=H)
    pic = Pic(width=W, height=H, depth=32, pitch=W * 4, codec="HEIF",
              meta=meta)
    f = HeifFile(pic=pic, mode=mode)
    if skip_decode:
        return f
    if os.environ.get("FFPIC_HEVC_DEVICE"):
        device = resolve_device(device, "heif")
    on_device = _device_color(mode)

    # ---- pixel decode: single hvc1 item or grid of tiles ----------------
    if primary.get("type") == "grid":
        if on_device:
            f.tiles = _decode_grid_tiles(data, s, tile_ids, meta["grid"],
                                         device)
            f.grid = (H, W)
            shape = (H, W)
        else:
            rgba = _decode_grid(data, s, tile_ids, meta["grid"], mode,
                                device)
    elif primary.get("type") == "hvc1":
        if on_device:
            t = _decode_item_planes(data, s, primary_id, device)
            t.out_h, t.out_w = min(t.out_h, H), min(t.out_w, W)
            f.tiles = [t]
            shape = (t.out_h, t.out_w)
        else:
            rgba = _decode_item_rgba(data, s, primary_id, mode,
                                     device)[:H, :W]
    else:
        raise NotImplementedError(
            f"HEIF primary item type {primary.get('type')!r} "
            "(only hvc1/grid decode to pixels)")
    if not on_device:
        shape = rgba.shape[:2]

    # auxiliary alpha plane (heif.c:347-388 blends; we fill the real
    # alpha channel instead — strictly more information)
    alpha_id = _find_alpha_item(s, primary_id, tile_ids)
    if alpha_id is not None:
        try:
            with trace.stage("heif.alpha"):
                a = _decode_alpha(data, s, alpha_id, meta, tile_ids,
                                  primary_id, device)
            if a is not None and a.shape == shape:
                if on_device:
                    f.alpha = a
                else:
                    rgba = rgba.copy()
                    rgba[:, :, 3] = a
                meta["alpha"] = True
        except (ValueError, NotImplementedError) as e:
            log.warning("alpha aux item decode failed: %s", e)

    # irot: anti-clockwise rotation in 90-degree units (ISO 23008-12
    # 6.5.10) — the reference parses but never applies it
    rot = props.get("rotation", 0)
    if rot:
        h, w = shape if (rot // 90) % 2 == 0 else shape[::-1]
        pic.width, pic.height = w, h
        pic.pitch = pic.width * 4
        meta.update(width=pic.width, height=pic.height, rotation=rot)
        if on_device:
            f.rotation = rot
        else:
            rgba = np.ascontiguousarray(np.rot90(rgba, rot // 90))
    if not on_device:
        f.rgba = rgba
    if s["sequence"] and sequence:
        boxes = bm.parse_boxes(data, 0, len(data))
        f.frames = _decode_sequence(data, boxes, mode, device, on_device)
    return f


def to_pics(f: HeifFile, device: torch.device) -> list[Pic]:
    """The device part of a decode: the picture with its pixels on
    ``device``, then the image sequence's frames."""
    pic = f.pic
    if f.rgba is not None:
        with trace.stage("heif.h2d"):
            pic.pixels = _to_device(f.rgba, device)
    else:
        pic.pixels = _tiles_to_rgba(f, device)
    pics = [pic]
    for fr in f.frames:
        px = frame_pixels(fr, f.mode, device)
        fh, fw = px.shape[:2]
        pics.append(Pic(width=fw, height=fh, depth=32, pitch=fw * 4,
                        codec="HEIF", pixels=px,
                        meta=dict(width=fw, height=fh)))
    return pics


def _tiles_to_rgba(f: HeifFile, device: torch.device) -> torch.Tensor:
    """The primary picture's tiles coloured on ``device`` in one launch,
    with its alpha plane and rotation."""
    with trace.stage("heif.h2d"):
        staged = _stage_tiles(f, device)
    with trace.stage("heif.color"), \
            trace.device_trace("hevc_yuv_to_rgba", device):
        rgba = hevc_kernels.hevc_tiles_to_rgba(staged, f.mode)
    with trace.stage("heif.alpha"):
        if f.alpha is not None:
            rgba[:, :, 3].copy_(_to_device(f.alpha, device))
        if f.rotation:
            rgba = torch.rot90(rgba, f.rotation // 90, dims=(0, 1)) \
                .contiguous()
    return rgba


def frame(pic, mode, on_device: bool):
    """A decoded sequence picture (an image sequence's frame, a raw
    stream's picture) as ``frame_pixels`` takes it: its host RGBA
    (``_yuv_pic_to_rgba``, span ``heif.color``), or with ``on_device``
    its planes (``_tile_planes``) for the device colour."""
    if on_device:
        return _tile_planes(pic, pic.sps, {})
    with trace.stage("heif.color"):
        return _yuv_pic_to_rgba(pic, pic.sps, None, None, mode)


def frame_pixels(fr, mode, device: torch.device) -> torch.Tensor:
    """A ``frame`` on ``device``: its host RGBA copied, or its planes
    staged and coloured by one launch of the ``hevc_yuv_to_rgba`` kernel
    over the frame as its one tile (the original's ``color_convert`` on
    the frame, ``heif.py:356-371``; its plain version on the CPU)."""
    if isinstance(fr, np.ndarray):
        with trace.stage("heif.h2d"):
            return _to_device(fr, device)
    with trace.stage("heif.h2d"):
        st = hevc_kernels.stage_tiles([fr.planes], [(0, 0, fr.out_h,
                                                     fr.out_w)],
                                      fr.out_h, fr.out_w, device)
    with trace.stage("heif.color"), \
            trace.device_trace("hevc_yuv_to_rgba", device):
        return hevc_kernels.hevc_tiles_to_rgba(st, mode)


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return to_device(np.ascontiguousarray(arr), device)


def _stage_tiles(f: HeifFile, device: torch.device):
    """Every tile's int16 planes, a descriptor each and the canvas cut
    into cells in one host-to-device copy (``hevc_kernels.stage_tiles``;
    through pinned memory on CUDA): a grid's canvas, or a single item's
    own crop as a canvas of one tile."""
    h, w = f.grid if f.grid is not None else (f.tiles[0].out_h,
                                              f.tiles[0].out_w)
    return hevc_kernels.stage_tiles(
        [t.planes for t in f.tiles],
        [(t.y0, t.x0, t.out_h, t.out_w) for t in f.tiles], h, w, device)


def load(data: bytes, skip_decode: bool = False, *, device: torch.device,
         mode="bt601") -> list[Pic]:
    f = parse(data, skip_decode, mode, device)
    if skip_decode:
        return [f.pic]
    return to_pics(f, device)


def _decode_item_yuv(data, s, item_id, device=None, defer=False):
    """Decode one hvc1 item's NALUs to a reconstructed Picture
    (heif.c decode_hvc1, heif.c:244-256 -> coding/hevc.c:7194), or with
    ``defer`` to a ``hevc.PendingPicture`` where its residuals would go
    to the device (``hevc.decode_picture``'s ``defer_residuals``)."""
    item = s["items"][item_id]
    props = item["properties"]
    hvcc = props.get("hvcC")
    if hvcc is None:
        # tiles may share the first tile's hvcC via ipma; fall back
        raise ValueError(f"item {item_id} has no hvcC")
    sps_l = hvcc["nalus"].get("sps", [])
    pps_l = hvcc["nalus"].get("pps", [])
    if not sps_l or not pps_l:
        raise ValueError("hvcC missing SPS/PPS")
    sps = hevc.parse_sps(sps_l[0])
    pps = hevc.parse_pps(pps_l[0])
    blob = read_item(data, s, item_id)
    slices = []
    for nalu in hevc.split_nalus_length_prefixed(blob,
                                                 hvcc["length_size"]):
        t = hevc.nal_type(nalu)
        if t == hevc.NAL_SPS:
            sps = hevc.parse_sps(nalu)
        elif t == hevc.NAL_PPS:
            pps = hevc.parse_pps(nalu)
        elif (t in (hevc.NAL_IDR_W_RADL, hevc.NAL_IDR_N_LP)
              or t == hevc.NAL_CRA or 16 <= t <= 18):
            # CRA/BLA stills (the wild-iPhone norm) decode like IDR;
            # collect ALL slice segment NALUs — multi-slice pictures
            # and dependent segments decode together
            slices.append(nalu)
    if not slices:
        raise ValueError("no slice NALU in hvc1 item")
    pic = hevc.decode_picture(sps, pps, slices, device=device,
                              defer_residuals=defer)
    return pic, sps, props


def _out_size(pic, sps, out_w, out_h):
    """The (out_w, out_h) a decoded item is cropped to: its ispe size
    (or the SPS's cropped size), at most the planes' (heif.py:349-350)."""
    out_w = min(out_w or sps.pic_width_cropped, pic.planes[0].shape[1])
    out_h = min(out_h or sps.pic_height_cropped, pic.planes[0].shape[0])
    return out_w, out_h


def _yuv_pic_to_rgba(pic, sps, out_w, out_h, mode):
    """Crop + chroma upsample + color convert on the host
    (``native.hevc_color``; the original's device branch is
    ``_decode_item_planes`` and K15, its numpy branch is left out)."""
    out_w, out_h = _out_size(pic, sps, out_w, out_h)
    bd = pic.bd
    nclx = mode if isinstance(mode, dict) else None
    if nclx is not None:
        kr, kb = {1: (0.2126, 0.0722), 9: (0.2627, 0.0593),
                  10: (0.2627, 0.0593)}.get(
            nclx.get("matrix", 5), (0.299, 0.114))
        kg = 1.0 - kr - kb
        coeffs = (2 * (1 - kr), -(2 * kb * (1 - kb) / kg),
                  -(2 * kr * (1 - kr) / kg), 2 * (1 - kb))
        limited = not nclx.get("full_range", True)
        trunc = False
    elif mode == "reference":
        coeffs = (1.280, -0.215, -0.381, 2.128)
        limited, trunc = False, True
    else:
        coeffs = (1.402, -0.344136, -0.714136, 1.772)
        limited, trunc = False, False
    rgba = native.hevc_color(pic.planes, bd, coeffs, limited, trunc)
    return rgba[:out_h, :out_w]


def _decode_item_rgba(data, s, item_id, mode, device=None):
    return _host_colour(*_decode_item_yuv(data, s, item_id, device), mode)


def _host_colour(pic, sps, props, mode):
    with trace.stage("heif.color"):
        return _yuv_pic_to_rgba(pic, sps, props.get("width"),
                                props.get("height"), mode)


def _decode_item_planes(data, s, item_id, device=None) -> _Tile:
    return _tile_planes(*_decode_item_yuv(data, s, item_id, device))


def _tile_planes(pic, sps, props) -> _Tile:
    """One item decoded for the device colour: its planes cast to int16,
    as the original stages them (``heif.py:363-366``)."""
    out_w, out_h = _out_size(pic, sps, props.get("width"),
                             props.get("height"))
    planes = [p.astype(np.int16) for p in pic.planes]
    return _Tile(planes=planes, out_h=out_h, out_w=out_w)


def _grid_workers(n_tiles: int) -> int:
    """Host-parallelism over grid tiles (SURVEY §2.6(a)): each tile is
    an independent entropy+recon unit, and the native decode path
    releases the GIL across its ctypes calls, so tiles scale across
    host cores.  Defaults to the core count; FFPIC_THREADS overrides."""
    env = os.environ.get("FFPIC_THREADS")
    if env:
        return max(1, min(int(env), n_tiles))
    return max(1, min(os.cpu_count() or 1, n_tiles))


def _map_tiles(fn, tile_ids, device):
    """``fn(tile_id)`` over the tiles in ``_grid_workers`` threads, in
    order.  A worker launches on the stream current on this thread (the
    caller's), not on its own thread's default stream."""
    stream = (torch.cuda.current_stream(device)
              if device is not None and device.type == "cuda" else None)

    def run(tid):
        with torch.cuda.stream(stream):
            return fn(tid)
    nw = _grid_workers(len(tile_ids))
    if nw > 1:
        with ThreadPoolExecutor(max_workers=nw) as ex:
            return list(ex.map(run, tile_ids))
    return [run(tid) for tid in tile_ids]


def _decode_tiles(data, s, tile_ids, device, finish) -> list:
    """``finish(pic, sps, props)`` of every grid tile's decoded picture,
    in order, in ``_grid_workers`` threads.  Under ``FFPIC_HEVC_DEVICE``
    in three phases, so that the grid's residual transform is one
    launch: every tile's syntax pass in the pool (a tile whose residuals
    would take a launch of its own comes back as a
    ``hevc.PendingPicture``, its share of the launch's plan made and its
    levels pinned there, ``hevc_kernels.stage_part``, span
    ``hevc.residuals_part`` in each worker); on this thread one staging
    of all their TUs and levels, one launch and one read-back for each
    bit depth among them (``hevc_kernels.residuals_grid``, span
    ``hevc.residuals_device``); then every tile's recon with its slice
    of the residuals, and ``finish``, in the pool.  The transform reads
    only a TU's levels, QP and flags, so no byte changes.  Spans: the
    pool's wall ``heif.grid_tiles``, or ``heif.grid_syntax`` and
    ``heif.grid_recon`` for the first and last phases."""
    if not hevc.device_residuals():
        with trace.stage("heif.grid_tiles"):
            return _map_tiles(
                lambda tid: finish(*_decode_item_yuv(data, s, tid, device)),
                tile_ids, device)

    def syntax(tid):
        pic, sps, props = _decode_item_yuv(data, s, tid, device, defer=True)
        if not isinstance(pic, hevc.PendingPicture):
            return pic, sps, props, None
        with trace.stage("hevc.residuals_part"):
            staged = hevc_kernels.stage_part(pic.tu_meta, pic.levels, device)
        return pic, sps, props, staged
    with trace.stage("heif.grid_syntax"):
        items = _map_tiles(syntax, tile_ids, device)
    pending = [k for k, item in enumerate(items) if item[3] is not None]
    resid = {}
    with trace.stage("hevc.residuals_device"):
        for bd in sorted({items[k][0].bit_depth for k in pending}):
            ks = [k for k in pending if items[k][0].bit_depth == bd]
            resid.update(zip(ks, hevc_kernels.residuals_grid(
                [items[k][3] for k in ks], bd, device)))

    def run(k):
        pic, sps, props, _ = items[k]
        if k in resid:
            pic = pic.finish(resid[k])
        return finish(pic, sps, props)
    with trace.stage("heif.grid_recon"):
        return _map_tiles(run, range(len(items)), device)


def _decode_grid(data, s, tile_ids, grid, mode, device=None):
    """Grid image: decode every dimg tile and paste row-major
    (heif.c:273-312).  Each tile is an independent batch element —
    the host-thread split point."""
    W, H = grid["width"], grid["height"]
    cols = grid["cols"]
    canvas = np.zeros((H, W, 4), np.uint8)
    canvas[:, :, 3] = 255
    tiles = _decode_tiles(data, s, tile_ids, device,
                          lambda *item: _host_colour(*item, mode))
    for idx, tile in enumerate(tiles):
        r, c = divmod(idx, cols)
        th, tw = tile.shape[:2]
        y0, x0 = r * th, c * tw
        if y0 >= H or x0 >= W:
            continue
        canvas[y0:y0 + th, x0:x0 + tw] = tile[:H - y0, :W - x0]
    return canvas


def _decode_grid_tiles(data, s, tile_ids, grid, device=None) -> list:
    """``_decode_grid`` for the device colour: every tile's planes, each
    placed where ``_decode_grid`` pastes it."""
    tiles = _decode_tiles(data, s, tile_ids, device, _tile_planes)
    for idx, t in enumerate(tiles):
        r, c = divmod(idx, grid["cols"])
        t.y0, t.x0 = r * t.out_h, c * t.out_w
    return tiles


def _find_alpha_item(s, primary_id, tile_ids):
    """auxl reference onto the primary (or its tiles) whose auxC urn
    mentions alpha."""
    targets = {primary_id, *tile_ids}
    for rtype, frm, tos in s["refs"]:
        if rtype == "auxl" and (primary_id in tos
                                or any(t in targets for t in tos)):
            it = s["items"].get(frm, {})
            aux = it.get("properties", {}).get("aux_type", "")
            # "urn:mpeg:hevc:2015:auxid:1" (ISO 23008-12) is the alpha
            # aux type; libheif also writes urns containing "alpha"
            if "alpha" in aux.lower() or aux.rstrip("\x00").endswith(
                    "auxid:1"):
                return frm
    return None


def _decode_alpha(data, s, alpha_id, meta, tile_ids, primary_id,
                  device=None):
    """Aux alpha image: mono or 4:2:0 luma; may itself be a grid."""
    item = s["items"][alpha_id]
    if item.get("type") == "grid":
        grid = _grid_layout(read_item(data, s, alpha_id))
        a_tiles = []
        for rtype, frm, tos in s["refs"]:
            if rtype == "dimg" and frm == alpha_id:
                a_tiles = tos
        W, H = grid["width"], grid["height"]
        canvas = np.zeros((H, W), np.uint8)
        for idx, tid in enumerate(a_tiles):
            r, c = divmod(idx, grid["cols"])
            pic, sps, props = _decode_item_yuv(data, s, tid, device)
            t = np.clip(pic.planes[0], 0, 255).astype(np.uint8)
            th = min(props.get("height") or sps.pic_height_cropped,
                     t.shape[0])
            tw = min(props.get("width") or sps.pic_width_cropped,
                     t.shape[1])
            y0, x0 = r * th, c * tw
            if y0 < H and x0 < W:
                canvas[y0:y0 + th, x0:x0 + tw] = \
                    t[:min(th, H - y0), :min(tw, W - x0)]
        return canvas
    pic, sps, props = _decode_item_yuv(data, s, alpha_id, device)
    a = np.clip(pic.planes[0], 0, 255).astype(np.uint8)
    h = min(props.get("height") or sps.pic_height_cropped, a.shape[0])
    w = min(props.get("width") or sps.pic_width_cropped, a.shape[1])
    return a[:h, :w]


def info(pic: Pic) -> str:
    m = pic.meta
    lines = ["HEIF file format",
             f"\twidth {m['width']}, height {m['height']}",
             f"\tprimary item {m['primary']}, {m['n_items']} items"]
    if m.get("grid"):
        g = m["grid"]
        lines.append(f"\tgrid {g['rows']}x{g['cols']} tiles")
    if m.get("hevc"):
        h = m["hevc"]
        lines.append(f"\tHEVC profile {h['profile']} level {h['level']} "
                     f"{h['bit_depth']}-bit chroma {h['chroma_format']} "
                     f"CTB {h['ctb']}")
    for i, it in m["items"].items():
        lines.append(f"\titem {i}: {it['type']} {it.get('width', '')}"
                     f"x{it.get('height', '')} ({it['size']} bytes)")
    return "\n".join(lines)


def encode(pic: Pic, *, device: torch.device, **options) -> bytes:
    """HEIC bytes of ``pic`` (``formats.heif_enc.encode_heif``), on the
    host whatever ``device`` is."""
    from ffpic_tpu_torch.formats.heif_enc import encode_heif
    return encode_heif(pic, **options)


register(Codec(name="HEIF", alias="HEIC", probe=probe, load=load,
               info=info, encode=encode))


# ---------------------------------------------------------------------------
# image sequences (moov/trak, heif.c:431-462)
# ---------------------------------------------------------------------------

def _decode_sequence(data: bytes, boxes, mode, device=None,
                     on_device: bool = False) -> list:
    """Decode hvc1 track samples to frames in presentation order, each
    a ``frame`` (its host RGBA, or with ``on_device`` its planes).
    ``device`` is where ``FFPIC_HEVC_DEVICE``'s residuals run.  A
    sample whose decode raises ``ValueError`` or
    ``NotImplementedError`` is skipped, as in the original."""
    moov = bm.find_box(boxes, "moov")
    if moov is None:
        return []
    frames = []
    for trak in [b for b in moov.children if b.type == "trak"]:
        stbl = bm.find_box(trak.children, "mdia/minf/stbl")
        if stbl is None:
            continue
        stsd = bm.find_box(stbl.children, "stsd")
        stsz = bm.find_box(stbl.children, "stsz")
        stco = bm.find_box(stbl.children, "stco")
        stsc = bm.find_box(stbl.children, "stsc")
        if not (stsd and stsz and stco and stsc):
            continue
        # stsd -> first hvc1 visual sample entry -> hvcC child box
        p = stsd.start + 8
        entry_size, entry_type = struct.unpack_from(">I4s", data, p)
        if entry_type != b"hvc1":
            continue
        hvcc_pos = p + 86
        hb = bm.parse_boxes(data, hvcc_pos, p + entry_size)
        hvcc_box = bm.find_box(hb, "hvcC")
        if hvcc_box is None:
            continue
        hvcc = _parse_hvcc(data, hvcc_box)
        sps_l = hvcc["nalus"].get("sps", [])
        pps_l = hvcc["nalus"].get("pps", [])
        if not sps_l or not pps_l:
            continue
        sps = hevc.parse_sps(sps_l[0])
        pps = hevc.parse_pps(pps_l[0])
        # sample sizes
        v = struct.unpack_from(">I", data, stsz.start)[0] & 0xFFFFFF
        uniform = struct.unpack_from(">I", data, stsz.start + 4)[0]
        n_samples = struct.unpack_from(">I", data, stsz.start + 8)[0]
        if uniform:
            sizes = [uniform] * n_samples
        else:
            sizes = list(struct.unpack_from(f">{n_samples}I", data,
                                            stsz.start + 12))
        n_chunks = struct.unpack_from(">I", data, stco.start + 4)[0]
        chunk_off = struct.unpack_from(f">{n_chunks}I", data,
                                       stco.start + 8)
        n_stsc = struct.unpack_from(">I", data, stsc.start + 4)[0]
        stsc_e = [struct.unpack_from(">III", data, stsc.start + 8
                                     + 12 * k) for k in range(n_stsc)]
        # expand samples-per-chunk runs
        spc = []
        for k in range(n_chunks):
            cur = 1
            for first, per, _desc in stsc_e:
                if first <= k + 1:
                    cur = per
            spc.append(cur)
        # full sequence decode (I/P/B) through the DPB-backed
        # SequenceDecoder — P/B samples motion-compensate for real
        # (beyond the reference, which has no inter pixel path)
        seq = hevc.SequenceDecoder(device)
        seq.sps[sps.sps_id] = sps
        seq.pps[pps.pps_id] = pps
        decoded = []                   # (poc, Picture) decode order
        si = 0
        for ci in range(n_chunks):
            off = chunk_off[ci]
            for _ in range(spc[ci]):
                if si >= n_samples:
                    break
                blob = data[off:off + sizes[si]]
                off += sizes[si]
                si += 1
                try:
                    for nalu in hevc.split_nalus_length_prefixed(
                            blob, hvcc["length_size"]):
                        pic = seq.push(nalu)
                        if pic is not None:
                            decoded.append(pic)
                except (ValueError, NotImplementedError) as e:
                    log.warning("sequence sample %d skipped: %s",
                                si, e)
        try:
            pic = seq.flush()
            if pic is not None:
                decoded.append(pic)
        except (ValueError, NotImplementedError) as e:
            log.warning("sequence flush failed: %s", e)
        frames += [frame(pic, mode, on_device)
                   for pic in hevc.display_order(decoded)]
    return frames
