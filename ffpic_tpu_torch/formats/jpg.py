"""JPEG host layer of the port: marker parse, native Huffman decode and
the geometry of the packed emission.

Copied from ``ffpic_tpu/formats/jpg.py:43-263`` (``JpegFile``,
``PackedIneligible``, ``_find_scan_end``, ``parse_and_decode``) and
``ffpic_tpu/formats/jpg_host.py`` (``FrameComp``, ``ScanComp``), cut to
what ``decode_batch`` reaches: every scan goes through the native
decoder (``ffpic_tpu_torch.native``), so the Python Huffman decoder,
its LUTs and the zigzag-order planes it made are not copied, nor are
EXIF, the ``quirks``/``skip_decode``/``start`` options, ``to_pic``,
``load`` and the registry (``ROADMAP.md`` Queue 1 items 1 and 3).
Coefficient planes are always in natural raster order.  The original's
logger (``utils.vlog``) has no call in the copied code, so there is
none here.

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
from ffpic_tpu_torch.ops.golden import ZIGZAG

# markers
SOI, EOI, SOS, DQT, DHT, DRI = 0xD8, 0xD9, 0xDA, 0xDB, 0xC4, 0xDD
SOF_MARKERS = {0xC0: "baseline", 0xC1: "extended", 0xC2: "progressive"}


@dataclass
class ScanComp:
    comp_idx: int      # index into frame components
    dc_tbl: int
    ac_tbl: int


@dataclass
class FrameComp:
    cid: int
    h: int
    v: int
    tq: int            # quant table id
    # derived block-grid geometry
    nbx: int = 0       # MCU-padded blocks across
    nby: int = 0
    nbx_actual: int = 0  # non-interleaved (ceil) blocks across
    nby_actual: int = 0


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
    scans: list = field(default_factory=list)        # scan metadata
    coeffs: list = field(default_factory=list)       # per-comp (nby,nbx,64) raster
    packed: tuple | None = None  # (counts, ks, vals, nnz) fast path
    mcus_x: int = 0
    mcus_y: int = 0


class PackedIneligible(Exception):
    """Raised by parse_and_decode(packed=True) when the file is not a
    single-interleaved-scan baseline JPEG; the caller retries on the
    dense path."""


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


def parse_and_decode(data: bytes, packed: bool = False
                     ) -> tuple[JpegFile, int]:
    """Parse one JPEG image and entropy-decode each of its scans.
    Returns (JpegFile, offset after the image).

    packed=True takes the packed-emission path for single-interleaved-
    scan baseline files: no dense coefficient planes are built; instead
    ``j.packed = (counts, ks, vals, nnz)`` in MCU decode order (see
    ``native.jpeg_decode_scan_packed``).  Raises PackedIneligible when
    the file needs the dense path.
    """
    j = JpegFile()
    n = len(data)
    if n < 2 or data[0] != 0xFF or data[1] != SOI:
        raise ValueError("missing SOI")
    i = 2
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
            scan_data = data[nxt:scan_end]
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
