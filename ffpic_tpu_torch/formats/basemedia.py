"""ISOBMFF (ISO base media file format) box parser.

Parity with the reference's format/basemedia.{h,c}: generic box walk,
full-box version/flags, and the HEIF/AVIF meta-box family: ftyp, meta,
hdlr, pitm, iloc, iinf/infe, iref, iprp/ipco/ipma, idat, plus
moov/trak sample tables (stsc/stco/stsz) for image sequences.

Copied from ``ffpic_tpu/formats/basemedia.py`` for the PyTorch port,
with its imports rewritten to the port's modules.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field


@dataclass
class Box:
    type: str
    start: int       # offset of payload in the file
    size: int        # payload size
    children: list = field(default_factory=list)
    version: int = 0
    flags: int = 0


CONTAINER_BOXES = {"meta", "moov", "trak", "mdia", "minf", "stbl", "iprp",
                   "ipco", "dinf", "edts", "mvex", "grpl"}
FULLBOX = {"meta", "hdlr", "pitm", "iloc", "iinf", "infe", "ipma", "iref",
           "idat", "mvhd", "tkhd", "mdhd", "stsd", "stsc", "stco", "stsz",
           "stts", "ispe", "pixi", "colr", "auxC"}


def parse_boxes(data: bytes, start: int, end: int,
                depth: int = 0) -> list[Box]:
    boxes = []
    pos = start
    while pos + 8 <= end:
        size, btype = struct.unpack_from(">I4s", data, pos)
        btype = btype.decode("latin1")
        hdr = 8
        if size == 1:
            size = struct.unpack_from(">Q", data, pos + 8)[0]
            hdr = 16
        elif size == 0:
            size = end - pos
        payload = pos + hdr
        b = Box(type=btype, start=payload, size=pos + size - payload)
        if btype in FULLBOX and b.size >= 4:
            vf = struct.unpack_from(">I", data, payload)[0]
            b.version = vf >> 24
            b.flags = vf & 0xFFFFFF
        if btype in CONTAINER_BOXES and depth < 8:
            sub = payload + (4 if btype == "meta" else 0)
            b.children = parse_boxes(data, sub, pos + size, depth + 1)
        boxes.append(b)
        pos += size
        if size <= 0:
            break
    return boxes


def find_box(boxes: list[Box], path: str) -> Box | None:
    head, _, rest = path.partition("/")
    for b in boxes:
        if b.type == head:
            return find_box(b.children, rest) if rest else b
    return None


def find_all(boxes: list[Box], btype: str) -> list[Box]:
    out = []
    for b in boxes:
        if b.type == btype:
            out.append(b)
        out += find_all(b.children, btype)
    return out


# ---------------------------------------------------------------------------
# track sample tables (moov/trak/mdia/minf/stbl)

def track_samples(data: bytes, boxes: list[Box],
                  entry_type: str) -> dict | None:
    """Walk the first moov track whose stsd sample entry matches
    entry_type ('av01', 'hvc1', ...).  Returns a dict with the sample
    entry byte range, per-sample (offset, size) pairs, per-sample
    durations in ms (from stts + mdhd timescale), or None if no such
    track exists.  Mirrors the reference's sequence walk
    (format/heif.c:431-462) but codec-agnostic."""
    moov = find_box(boxes, "moov")
    if moov is None:
        return None
    for trak in [b for b in moov.children if b.type == "trak"]:
        stbl = find_box(trak.children, "mdia/minf/stbl")
        mdhd = find_box(trak.children, "mdia/mdhd")
        if stbl is None:
            continue
        stsd = find_box(stbl.children, "stsd")
        stsz = find_box(stbl.children, "stsz")
        stco = find_box(stbl.children, "stco") or \
            find_box(stbl.children, "co64")
        stsc = find_box(stbl.children, "stsc")
        stts = find_box(stbl.children, "stts")
        if not (stsd and stsz and stco and stsc):
            continue
        # walk ALL stsd sample entries for a match (a conformant file
        # may list several, or lead with a non-matching one)
        n_entries = struct.unpack_from(">I", data, stsd.start + 4)[0]
        stsd_end = stsd.start + stsd.size
        p = stsd.start + 8
        entry_size = 0
        matched = False
        for _ in range(min(max(n_entries, 1), 64)):
            if p + 8 > stsd_end:
                break
            entry_size, etype = struct.unpack_from(">I4s", data, p)
            if etype.decode("latin1") == entry_type:
                matched = True
                break
            if entry_size <= 8:
                break
            p += entry_size
        if not matched:
            continue
        # mdhd timescale (version 0: 12 bytes in; version 1: 20)
        timescale = 0
        if mdhd is not None:
            off = 12 if mdhd.version == 0 else 20
            timescale = struct.unpack_from(
                ">I", data, mdhd.start + off)[0]
        # stsz sample sizes
        uniform = struct.unpack_from(">I", data, stsz.start + 4)[0]
        n_samples = struct.unpack_from(">I", data, stsz.start + 8)[0]
        if uniform:
            sizes = [uniform] * n_samples
        else:
            sizes = list(struct.unpack_from(
                f">{n_samples}I", data, stsz.start + 12))
        # chunk offsets
        n_chunks = struct.unpack_from(">I", data, stco.start + 4)[0]
        fmt = ">%d%s" % (n_chunks, "I" if stco.type == "stco" else "Q")
        chunk_off = struct.unpack_from(fmt, data, stco.start + 8)
        # samples-per-chunk runs
        n_stsc = struct.unpack_from(">I", data, stsc.start + 4)[0]
        stsc_e = sorted(
            (struct.unpack_from(">III", data, stsc.start + 8 + 12 * k)
             for k in range(n_stsc)),
            key=lambda e: e[0])
        spc = []
        for k in range(n_chunks):
            cur = 1
            for first, per, _desc in stsc_e:
                if first <= k + 1:
                    cur = per
            spc.append(cur)
        samples = []
        si = 0
        for ci in range(n_chunks):
            off = chunk_off[ci]
            for _ in range(spc[ci]):
                if si >= n_samples:
                    break
                samples.append((off, sizes[si]))
                off += sizes[si]
                si += 1
        # stts -> per-sample duration (ms)
        durations = [0] * n_samples
        if stts is not None and timescale:
            # round cumulative TIMESTAMPS, not per-sample deltas: a
            # 30 fps track (delta 33.333 ms) would otherwise lose
            # ~10 ms of animation per second to rounding drift
            n_stts = struct.unpack_from(">I", data, stts.start + 4)[0]
            si = 0
            ts = 0
            for k in range(n_stts):
                cnt, delta = struct.unpack_from(
                    ">II", data, stts.start + 8 + 8 * k)
                for _ in range(cnt):
                    if si >= n_samples:
                        break
                    end = ts + delta
                    durations[si] = (int(round(end * 1000 / timescale))
                                     - int(round(ts * 1000 / timescale)))
                    ts = end
                    si += 1
        return dict(entry_start=p, entry_size=entry_size,
                    samples=samples, durations=durations,
                    timescale=timescale)
    return None


# ---------------------------------------------------------------------------
# meta-box item tables

def parse_iloc(data: bytes, box: Box) -> dict[int, list[tuple[int, int, int]]]:
    """item_id -> [(construction_method, offset, length), ...]"""
    p = box.start + 4
    v = box.version
    b0, b1 = data[p], data[p + 1]
    offset_size = b0 >> 4
    length_size = b0 & 0xF
    base_offset_size = b1 >> 4
    index_size = b1 & 0xF if v in (1, 2) else 0
    p += 2
    if v < 2:
        count = struct.unpack_from(">H", data, p)[0]
        p += 2
    else:
        count = struct.unpack_from(">I", data, p)[0]
        p += 4

    def read_n(n, p):
        if n == 0:
            return 0, p
        if n == 4:
            return struct.unpack_from(">I", data, p)[0], p + 4
        if n == 8:
            return struct.unpack_from(">Q", data, p)[0], p + 8
        return struct.unpack_from(">H", data, p)[0], p + 2

    items = {}
    for _ in range(count):
        if v < 2:
            item_id = struct.unpack_from(">H", data, p)[0]
            p += 2
        else:
            item_id = struct.unpack_from(">I", data, p)[0]
            p += 4
        method = 0
        if v in (1, 2):
            method = struct.unpack_from(">H", data, p)[0] & 0xF
            p += 2
        _dref, = struct.unpack_from(">H", data, p)
        p += 2
        base, p = read_n(base_offset_size, p)
        ext_count = struct.unpack_from(">H", data, p)[0]
        p += 2
        extents = []
        for _ in range(ext_count):
            if index_size:
                _, p = read_n(index_size, p)
            off, p = read_n(offset_size, p)
            ln, p = read_n(length_size, p)
            extents.append((method, base + off, ln))
        items[item_id] = extents
    return items


def parse_iinf(data: bytes, box: Box) -> dict[int, dict]:
    """item_id -> {type, name}"""
    p = box.start + 4
    if box.version == 0:
        count = struct.unpack_from(">H", data, p)[0]
        p += 2
    else:
        count = struct.unpack_from(">I", data, p)[0]
        p += 4
    infos = {}
    for b in parse_boxes(data, p, box.start + box.size):
        if b.type != "infe":
            continue
        q = b.start + 4
        if b.version >= 2:
            if b.version == 2:
                item_id = struct.unpack_from(">H", data, q)[0]
                q += 2
            else:
                item_id = struct.unpack_from(">I", data, q)[0]
                q += 4
            _prot = struct.unpack_from(">H", data, q)[0]
            q += 2
            itype = data[q:q + 4].decode("latin1")
            q += 4
            e = data.index(b"\0", q)
            name = data[q:e].decode("utf8", "replace")
            infos[item_id] = dict(type=itype, name=name)
    return infos


def parse_ipma(data: bytes, box: Box) -> dict[int, list[tuple[int, bool]]]:
    """item_id -> [(property_index_1based, essential), ...]"""
    p = box.start + 4
    count = struct.unpack_from(">I", data, p)[0]
    p += 4
    out = {}
    for _ in range(count):
        if box.version < 1:
            item_id = struct.unpack_from(">H", data, p)[0]
            p += 2
        else:
            item_id = struct.unpack_from(">I", data, p)[0]
            p += 4
        assoc_count = data[p]
        p += 1
        assocs = []
        for _ in range(assoc_count):
            if box.flags & 1:
                v = struct.unpack_from(">H", data, p)[0]
                p += 2
                assocs.append((v & 0x7FFF, bool(v & 0x8000)))
            else:
                v = data[p]
                p += 1
                assocs.append((v & 0x7F, bool(v & 0x80)))
        out[item_id] = assocs
    return out


def parse_iref(data: bytes, box: Box) -> list[tuple[str, int, list[int]]]:
    """[(ref_type, from_item, [to_items])]"""
    p = box.start + 4
    wide = box.version != 0
    refs = []
    for b in parse_boxes(data, p, box.start + box.size):
        q = b.start
        if wide:
            frm = struct.unpack_from(">I", data, q)[0]
            q += 4
            cnt = struct.unpack_from(">H", data, q)[0]
            q += 2
            tos = list(struct.unpack_from(f">{cnt}I", data, q))
        else:
            frm = struct.unpack_from(">H", data, q)[0]
            q += 2
            cnt = struct.unpack_from(">H", data, q)[0]
            q += 2
            tos = list(struct.unpack_from(f">{cnt}H", data, q))
        refs.append((b.type, frm, tos))
    return refs
