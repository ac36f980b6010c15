"""JPEG codec of the port: host marker parse and native Huffman decode,
the device pipeline on the card, and the geometry of the packed emission.

Copied from ``ffpic_tpu/formats/jpg.py`` (``JpegFile``,
``PackedIneligible``, ``probe``, ``_find_scan_end``, ``parse_and_decode``
at ``:43-262``; ``to_pic``, ``_parse_exif``, ``_meta``, ``load``,
``info``, ``encode`` and the registration at ``:278-432``), over the
port's ``formats.jpg_host`` (``FrameComp``, ``ScanComp``).  Every scan
goes through the native decoder (``ffpic_tpu_torch.native``), so
coefficient planes are always in natural raster order: the original
takes its pure-Python Huffman decoder (``jpg_host.JpegEntropyDecoder``)
under ``FFPIC_NO_NATIVE`` or without its library, and the port keeps
that decoder only as the oracle the tests hold the native one against.
EXIF is read with the port's copy of the TIFF tag walker
(``formats.tiff_tags``).

``to_pic`` stages the dense planes of all components in one pinned
copy and runs ``ops.jpeg_kernels.decode_mcu_planes`` on them: K2
(dequant + IDCT) and K4 (``assemble_mcu``) on the card, the plain
PyTorch versions on the CPU.

``mcu_block_map`` and ``packed_block_map`` give the block map of the
packed emission (``ffpic_tpu.formats.jpg.packed_block_map`` builds it
through a module that imports jax).
"""

from __future__ import annotations

import functools
import struct
from dataclasses import dataclass, field

import numpy as np
import torch

from ffpic_tpu_torch import native
from ffpic_tpu_torch.formats.jpg_encode import encode_baseline
from ffpic_tpu_torch.formats.jpg_host import FrameComp, ScanComp
from ffpic_tpu_torch.formats.pic import Pic, PixelFormat
from ffpic_tpu_torch.formats.registry import Codec, register
from ffpic_tpu_torch.formats.tiff_tags import _first, _read_ifd
from ffpic_tpu_torch.ops import jpeg_kernels
from ffpic_tpu_torch.ops.golden import ZIGZAG
from ffpic_tpu_torch.utils import trace
from ffpic_tpu_torch.utils.device import to_device

# markers
SOI, EOI, SOS, DQT, DHT, DRI, COM = 0xD8, 0xD9, 0xDA, 0xDB, 0xC4, 0xDD, 0xFE
SOF_MARKERS = {0xC0: "baseline", 0xC1: "extended", 0xC2: "progressive"}
APP0 = 0xE0
APP1 = 0xE1


def _align8(x: int) -> int:
    return (x + 7) & ~7


@dataclass
class JpegFile:
    width: int = 0
    height: int = 0
    precision: int = 8
    mode: str = "baseline"
    comps: list = field(default_factory=list)        # FrameComp
    dqt: dict = field(default_factory=dict)          # id -> (64,) int32 raster
    dqt_precision: dict = field(default_factory=dict)
    dht_raw: dict = field(default_factory=dict)      # (class, id) -> (counts, syms)
    restart_interval: int = 0
    comment: bytes = b""
    app0: dict = field(default_factory=dict)
    exif: dict = field(default_factory=dict)
    scans: list = field(default_factory=list)        # scan metadata for info()
    coeffs: list = field(default_factory=list)       # per-comp (nby,nbx,64) raster
    packed: tuple | None = None  # (counts, ks, vals, nnz) fast path
    mcus_x: int = 0
    mcus_y: int = 0


class PackedIneligible(Exception):
    """Raised by parse_and_decode(packed=True) when the file is not a
    single-interleaved-scan baseline JPEG; the caller retries on the
    dense path."""


def probe(data: bytes) -> bool:
    # SOI at the start; a missing EOI is accepted (truncated files decode)
    return len(data) > 3 and data[0] == 0xFF and data[1] == 0xD8


def _find_scan_end(data: bytes, pos: int) -> int:
    """End of entropy-coded data: the next marker that is not stuffing
    or RSTn, found in one vectorised pass."""
    arr = np.frombuffer(data, np.uint8, len(data) - pos, pos)
    if arr.size < 2:
        return len(data)
    ff = np.flatnonzero(arr[:-1] == 0xFF)
    if ff.size:
        nxt = arr[ff + 1]
        real = ((nxt != 0x00) & (nxt != 0xFF)
                & ~((nxt >= 0xD0) & (nxt <= 0xD7)))
        hits = np.flatnonzero(real)
        if hits.size:
            return pos + int(ff[hits[0]])
    return len(data)


def parse_and_decode(data: bytes, skip_decode: bool = False,
                     start: int = 0, quirks: bool = False,
                     packed: bool = False) -> tuple[JpegFile, int]:
    """Parse one JPEG image starting at ``start``; entropy-decode each
    of its scans unless ``skip_decode``.  Returns (JpegFile, offset
    after the image).

    quirks=True replicates the C reference's off-spec behaviour for
    bit-parity conformance testing: its scan reader drops the final
    entropy byte of every scan.

    packed=True takes the packed-emission path for single-interleaved-
    scan baseline files: no dense coefficient planes are built; instead
    ``j.packed = (counts, ks, vals, nnz)`` in MCU decode order (see
    ``native.jpeg_decode_scan_packed``).  Raises PackedIneligible when
    the file needs the dense path.
    """
    j = JpegFile()
    n = len(data)
    if start + 2 > n or data[start] != 0xFF or data[start + 1] != SOI:
        raise ValueError("missing SOI")
    i = start + 2
    while i + 1 < n:
        if data[i] != 0xFF:
            i += 1
            continue
        m = data[i + 1]
        i += 2
        if m == 0xFF or m == 0x00:
            continue
        if m == EOI:
            break
        if m == SOI:
            continue
        if 0xD0 <= m <= 0xD7:
            continue
        if i + 2 > n:
            break
        (seglen,) = struct.unpack_from(">H", data, i)
        seg = data[i + 2:i + seglen]
        nxt = i + seglen

        if m in SOF_MARKERS:
            j.mode = SOF_MARKERS[m]
            j.precision, j.height, j.width, ncomp = struct.unpack_from(
                ">BHHB", seg, 0)
            for c in range(ncomp):
                cid, hv, tq = struct.unpack_from(">BBB", seg, 6 + 3 * c)
                j.comps.append(FrameComp(cid=cid, h=hv >> 4, v=hv & 0xF, tq=tq))
            hmax = max(c.h for c in j.comps)
            vmax = max(c.v for c in j.comps)
            mcus_x = j.mcus_x = -(-j.width // (8 * hmax))
            mcus_y = j.mcus_y = -(-j.height // (8 * vmax))
            for c in j.comps:
                c.nbx = mcus_x * c.h
                c.nby = mcus_y * c.v
                comp_w = -(-j.width * c.h // hmax)   # ceil(W*h/hmax)
                comp_h = -(-j.height * c.v // vmax)
                c.nbx_actual = -(-comp_w // 8)
                c.nby_actual = -(-comp_h // 8)
            if not packed:
                j.coeffs = [np.zeros((c.nby, c.nbx, 64), np.int16)
                            for c in j.comps]
        elif m == DQT:
            p = 0
            while p < len(seg):
                pq, tq = seg[p] >> 4, seg[p] & 0xF
                p += 1
                tbl = np.zeros(64, np.int32)
                if pq:
                    vals = np.frombuffer(seg, ">u2", 64, p).astype(np.int32)
                    p += 128
                else:
                    vals = np.frombuffer(seg, "u1", 64, p).astype(np.int32)
                    p += 64
                tbl[ZIGZAG] = vals  # store de-zigzagged
                j.dqt[tq] = tbl
                j.dqt_precision[tq] = pq
        elif m == DHT:
            p = 0
            while p < len(seg):
                tc, th = seg[p] >> 4, seg[p] & 0xF
                p += 1
                counts = list(seg[p:p + 16])
                p += 16
                total = sum(counts)
                syms = list(seg[p:p + total])
                p += total
                j.dht_raw[(tc, th)] = (counts, syms)
        elif m == DRI:
            (j.restart_interval,) = struct.unpack_from(">H", seg, 0)
        elif m == COM:
            j.comment = seg
        elif m == APP1 and seg[:6] == b"Exif\x00\x00":
            try:
                j.exif = _parse_exif(seg[6:])
            except Exception:
                pass                     # malformed EXIF is non-fatal
        elif m == APP0 and seg[:5] == b"JFIF\x00":
            maj, mnr, unit, xd, yd = struct.unpack_from(">BBBHH", seg, 5)
            j.app0 = dict(version=f"{maj}.{mnr}", unit=unit,
                          xdensity=xd, ydensity=yd)
        elif m == SOS:
            ns = seg[0]
            scan_comps = []
            cid_to_idx = {c.cid: k for k, c in enumerate(j.comps)}
            for c in range(ns):
                cs, tt = seg[1 + 2 * c], seg[2 + 2 * c]
                scan_comps.append(ScanComp(comp_idx=cid_to_idx[cs],
                                           dc_tbl=tt >> 4, ac_tbl=tt & 0xF))
            ss, se, a = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
            ah, al = a >> 4, a & 0xF
            j.scans.append(dict(comps=[sc.comp_idx for sc in scan_comps],
                                ss=ss, se=se, ah=ah, al=al))
            scan_end = _find_scan_end(data, nxt)
            if not skip_decode:
                scan_data = data[nxt:scan_end]
                if quirks and len(scan_data) > 1:
                    scan_data = scan_data[:-1]  # the reference drops it
                if packed:
                    if (j.mode != "baseline" or ns != len(j.comps)
                            or j.packed is not None):
                        raise PackedIneligible(
                            "needs the general (dense) scan path")
                    j.packed = native.jpeg_decode_scan_packed(
                        scan_data, j.dht_raw, j.comps, scan_comps,
                        j.restart_interval, j.mcus_x, j.mcus_y)
                else:
                    native.jpeg_decode_scan(
                        scan_data, j.dht_raw, j.comps, scan_comps,
                        ss, se, ah, al, j.restart_interval,
                        j.mcus_x, j.mcus_y, j.coeffs)
            nxt = scan_end
        i = nxt
    return j, i


def mcu_block_map(samplings, mcus_x: int, mcus_y: int,
                  actual=None) -> np.ndarray:
    """The g-th block in MCU decode order (components in frame order,
    v*h blocks raster within the MCU) -> flat index into the
    concatenated per-component coefficient space, as int32.

    Single-component scans are non-interleaved (ITU-T81 A.2.2): pass
    ``actual=(nby_actual, nbx_actual)`` and the map is a raster walk of
    the actual block grid with the padded plane stride."""
    if len(samplings) == 1 and actual is not None:
        _v, h = samplings[0]
        nbya, nbxa = actual
        by, bx = np.mgrid[0:nbya, 0:nbxa]
        g = (by * (mcus_x * h) + bx).reshape(-1)
    else:
        maps = []
        base = 0
        my, mx = np.mgrid[0:mcus_y, 0:mcus_x]
        for (v, h) in samplings:
            nbx = mcus_x * h
            vi, hi = np.mgrid[0:v, 0:h]
            by = my[:, :, None, None] * v + vi[None, None]
            bx = mx[:, :, None, None] * h + hi[None, None]
            maps.append((base + by * nbx + bx).reshape(mcus_y, mcus_x, v * h))
            base += mcus_y * v * nbx
        # interleave per MCU: component-major within each MCU
        g = np.concatenate(maps, axis=2).reshape(-1)
    return g.astype(np.int32)


@functools.lru_cache(maxsize=32)
def _block_map_tensor(samplings, mcus_x, mcus_y, actual, device):
    return torch.from_numpy(
        mcu_block_map(samplings, mcus_x, mcus_y, actual)).to(device)


def packed_block_map(j, device) -> torch.Tensor:
    """int32 block map for ``j.packed`` on ``device``, made once per
    geometry and device; single-component files use the
    non-interleaved raster layout the packed scan emits."""
    samps = tuple((c.v, c.h) for c in j.comps)
    actual = None
    if len(j.comps) == 1:
        actual = (j.comps[0].nby_actual, j.comps[0].nbx_actual)
    return _block_map_tensor(samps, j.mcus_x, j.mcus_y, actual,
                             torch.device(device))


def to_pic(j: JpegFile, device: torch.device, order: str = "rgba",
           mode: str = "reference", quirks: bool = False,
           upsample: str = "nearest") -> Pic:
    """Run the device pipeline over the decoded coefficient planes: one
    staged copy of every component's blocks, then
    ``decode_mcu_planes`` on ``device``.

    quirks=True mirrors the reference's grayscale handling: a single
    component gets all-zero dummy chroma whose -128 offset tints the
    output; the default is the neutral-chroma grayscale decode.  The
    picture is 8-aligned wide (the reference's convention); the pixels
    past ``j.width`` come from the MCU padding.
    """
    if len(j.comps) == 3 and tuple(c.cid for c in j.comps) == (82, 71, 66):
        mode = "rgb"     # component ids 'R','G','B': no YCbCr transform
    hmax = max(c.h for c in j.comps)
    vmax = max(c.v for c in j.comps)
    out_w = _align8(j.width)
    out_h = j.height

    quants = np.stack([j.dqt[c.tq] for c in j.comps])
    samplings = tuple((vmax // c.v, hmax // c.h) for c in j.comps)
    shapes = tuple((c.nby, c.nbx) for c in j.comps)
    with trace.stage("torch.jpg.h2d"):
        coeffs = to_device(np.concatenate(
            [c.reshape(-1, 64) for c in j.coeffs]).reshape(-1, 8, 8), device)
    px = jpeg_kernels.decode_mcu_planes(
        coeffs, shapes, quants, samplings, out_h, out_w,
        order=order, mode=mode, gray_chroma=(0 if quirks else 128),
        upsample=upsample)
    fmt = PixelFormat.RGBA32 if order == "rgba" else PixelFormat.BGRA32
    return Pic(pixels=px, width=out_w, height=out_h, depth=32,
               pitch=out_w * 4, format=fmt, codec="JPG",
               meta=_meta(j))


_EXIF_TAGS = {0x010F: "make", 0x0110: "model", 0x0112: "orientation",
              0x0131: "software", 0x0132: "datetime",
              0x829A: "exposure_time", 0x829D: "f_number",
              0x8827: "iso", 0x920A: "focal_length",
              0x9003: "datetime_original",
              0xA002: "pixel_x", 0xA003: "pixel_y"}


def _parse_exif(blob: bytes) -> dict:
    """EXIF = a TIFF structure (IFD0 + ExifIFD sub-directory), read with
    the TIFF tag walker; surfaces orientation and camera tags."""
    if blob[:2] == b"II":
        bo = "<"
    elif blob[:2] == b"MM":
        bo = ">"
    else:
        raise ValueError("bad TIFF header in EXIF")
    pos = struct.unpack_from(bo + "I", blob, 4)[0]
    tags, _ = _read_ifd(blob, pos, bo)
    sub = _first(tags, 0x8769)
    if isinstance(sub, int) and 0 < sub < len(blob):
        try:
            tags.update(_read_ifd(blob, sub, bo)[0])
        except Exception:
            pass
    out = {}
    for tag, name in _EXIF_TAGS.items():
        v = _first(tags, tag)
        if v is None:
            continue
        if isinstance(v, tuple) and len(v) == 2:   # rational
            out[name] = v[0] / v[1] if v[1] else 0.0
        else:
            out[name] = v
    return out


def _meta(j: JpegFile) -> dict:
    return dict(
        width=j.width, height=j.height, precision=j.precision, mode=j.mode,
        components=[dict(cid=c.cid, h=c.h, v=c.v, tq=c.tq) for c in j.comps],
        dqt={k: v.tolist() for k, v in j.dqt.items()},
        dht={f"{'AC' if tc else 'DC'}{th}": counts
             for (tc, th), (counts, _s) in j.dht_raw.items()},
        restart_interval=j.restart_interval,
        comment=j.comment.decode("latin1", "replace") if j.comment else "",
        app0=j.app0, exif=j.exif, scans=j.scans,
    )


def load(data: bytes, skip_decode: bool = False, *, device: torch.device,
         quirks: bool = False, order: str = "rgba", mode: str = "reference",
         upsample: str = "nearest") -> list[Pic]:
    """Every picture of the file (several JPEGs back to back give
    several), decoded on ``device``; trailing garbage between them is
    skipped."""
    pics = []
    off = 0
    n = len(data)
    while off < n - 4:
        try:
            with trace.stage("torch.jpg.host_entropy"):
                j, off = parse_and_decode(data, skip_decode, off,
                                          quirks=quirks)
        except ValueError:
            break
        if skip_decode:
            p = Pic(width=_align8(j.width), height=j.height, depth=32,
                    pitch=_align8(j.width) * 4, codec="JPG", meta=_meta(j))
        else:
            with trace.stage("torch.jpg.device_pipeline"):
                p = to_pic(j, device, order=order, mode=mode, quirks=quirks,
                           upsample=upsample)
        pics.append(p)
        # skip trailing garbage until a plausible next SOI
        while off < n - 1 and not (data[off] == 0xFF and data[off + 1] == SOI):
            off += 1
    return pics


def info(pic: Pic) -> str:
    m = pic.meta
    lines = ["JPEG file format"]
    lines.append(f"\twidth {m['width']}, height {m['height']}")
    lines.append(f"\tprecision {m['precision']}, mode {m['mode']}, "
                 f"components num {len(m['components'])}")
    for c in m["components"]:
        lines.append(f"\t cid {c['cid']} vertical {c['v']}, horizon {c['h']}, "
                     f"quantization id {c['tq']}")
    if m.get("app0"):
        a = m["app0"]
        lines.append(f"\tAPP0: JFIF version {a['version']} "
                     f"xdensity {a['xdensity']} ydensity {a['ydensity']}")
    if m.get("exif"):
        kv = " ".join(f"{k}={v}" for k, v in sorted(m["exif"].items()))
        lines.append(f"\tEXIF: {kv}")
    for tid, tbl in m["dqt"].items():
        lines.append(f"\tDQT {tid}: " + " ".join(map(str, tbl[:8])) + " ...")
    if m["restart_interval"]:
        lines.append(f"\tDRI interval {m['restart_interval']}")
    if m["comment"]:
        lines.append(f"\tComment: {m['comment']}")
    lines.append(f"\tscans: {len(m['scans'])}")
    return "\n".join(lines)


def encode(pic: Pic, *, device: torch.device, **options) -> bytes:
    """Baseline 4:2:0 with the ITU-T81 K.3-K.6 tables
    (``formats.jpg_encode.encode_baseline``)."""
    return encode_baseline(pic, device=device, **options)


register(Codec(name="JPG", alias="JPEG", probe=probe, load=load, info=info,
               encode=encode))
