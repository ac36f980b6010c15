"""JPEG host-side entropy decode (pure Python oracle path).

Implements baseline (SOF0/SOF1) and progressive (SOF2) Huffman scan
decoding with spectral selection + successive approximation, restart
intervals, and interleaved/non-interleaved scans — the semantics of the
reference's decode_data_unit/JPG_decode_scan (format/jpg.c:255-585) —
but emitting whole-image planar coefficient tensors per component
(blocks_y, blocks_x, 8, 8) for the TPU pipeline instead of decoding
per-MCU to pixels.

This module is the correctness oracle; the production path is the C
implementation in ffpic_tpu/native/host_jpeg.c, differentially tested
against this one.

Copied from ``ffpic_tpu/formats/jpg_host.py`` for the PyTorch port whole,
with its import rewritten to the port's ``ops.golden.ZIGZAG``.  In the
port it is only the oracle that the tests hold the native Huffman
decode (``native/host_jpeg.c``) against: no decode path calls it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ffpic_tpu_torch.ops.golden import ZIGZAG


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


class HuffLUT:
    """Flat maxlen-bit LUT decoder table from DHT (counts, symbols)."""

    __slots__ = ("maxlen", "sym", "length")

    def __init__(self, counts, symbols):
        code = 0
        k = 0
        maxlen = 0
        entries = []
        for bitlen in range(1, 17):
            for _ in range(counts[bitlen - 1]):
                entries.append((code, bitlen, symbols[k]))
                k += 1
                code += 1
                maxlen = bitlen
            code <<= 1
        self.maxlen = maxlen
        n = 1 << maxlen if maxlen else 1
        self.sym = np.full(n, -1, np.int16)
        self.length = np.zeros(n, np.uint8)
        for c, l, s in entries:
            shift = maxlen - l
            base = c << shift
            self.sym[base:base + (1 << shift)] = s
            self.length[base:base + (1 << shift)] = l


class ScanBitReader:
    """MSB-first reader over destuffed scan bytes; restart-aware.

    The scan buffer is pre-processed (0xFF00 -> 0xFF); restart markers
    delimit segments and the reader is re-initialized per segment.
    """

    __slots__ = ("data", "pos", "bit", "n")

    def __init__(self, data: bytes):
        self.data = data
        self.n = len(data)
        self.pos = 0
        self.bit = 0

    def read_bit(self) -> int:
        if self.pos >= self.n:
            return 0  # spec: pad with zeros at segment end
        b = (self.data[self.pos] >> (7 - self.bit)) & 1
        self.bit += 1
        if self.bit == 8:
            self.bit = 0
            self.pos += 1
        return b

    def receive(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v


def _extend(v: int, n: int) -> int:
    """EXTEND (ITU-T81 F.2.2.1) == the reference's get_vlc
    (format/jpg.c:219-229)."""
    if n == 0:
        return 0
    if v < (1 << (n - 1)):
        return v - (1 << n) + 1
    return v


def _decode_symbol(r: ScanBitReader, t: HuffLUT) -> int:
    # bit-at-a-time canonical walk (oracle path; C uses the flat LUT)
    code = 0
    for length in range(1, 17):
        code = (code << 1) | r.read_bit()
        window = code << (t.maxlen - length) if length <= t.maxlen else None
        if window is None:
            break
        if t.length[window] == length and t.sym[window] >= 0:
            return int(t.sym[window])
    raise ValueError("invalid huffman code in scan")


def destuff_segments(raw: bytes) -> list[bytes]:
    """Split the entropy-coded data into restart segments, removing
    0xFF00 stuffing. Mirrors read_compressed_scan (jpg.c:587-637) but
    keeps segment boundaries so DC predictors/EOB runs reset exactly
    where RSTn markers sat."""
    segments = []
    cur = bytearray()
    i = 0
    n = len(raw)
    while i < n:
        b = raw[i]
        if b != 0xFF:
            cur.append(b)
            i += 1
            continue
        if i + 1 >= n:
            break
        nxt = raw[i + 1]
        if nxt == 0x00:
            cur.append(0xFF)
            i += 2
        elif 0xD0 <= nxt <= 0xD7:
            segments.append(bytes(cur))
            cur = bytearray()
            i += 2
        elif nxt == 0xFF:
            i += 1  # fill byte
        else:
            break  # next marker: end of scan
    segments.append(bytes(cur))
    return segments


class JpegEntropyDecoder:
    """Decodes one scan into the persistent coefficient planes."""

    def __init__(self, frame_comps: list[FrameComp], coeffs: list[np.ndarray],
                 restart_interval: int = 0):
        self.comps = frame_comps
        self.coeffs = coeffs  # list of (nby, nbx, 64) int16, zigzag order
        self.restart_interval = restart_interval

    def decode_scan(self, raw: bytes, scan_comps: list[ScanComp],
                    dc_tables: dict, ac_tables: dict,
                    ss: int, se: int, ah: int, al: int) -> None:
        segments = destuff_segments(raw)
        interleaved = len(scan_comps) > 1
        seg_idx = 0
        r = ScanBitReader(segments[0])
        pred = {sc.comp_idx: 0 for sc in scan_comps}
        eobrun = 0

        def next_segment():
            nonlocal r, seg_idx, eobrun
            seg_idx += 1
            if seg_idx < len(segments):
                r = ScanBitReader(segments[seg_idx])
            for k in pred:
                pred[k] = 0
            eobrun = 0

        hmax = max(c.h for c in self.comps)
        vmax = max(c.v for c in self.comps)

        if interleaved:
            # MCU grid from any component: nbx = mcus_x * h
            c0 = self.comps[scan_comps[0].comp_idx]
            mcus_x = c0.nbx // c0.h
            mcus_y = c0.nby // c0.v
            units = mcus_x * mcus_y
        else:
            c0 = self.comps[scan_comps[0].comp_idx]
            units = c0.nbx_actual * c0.nby_actual

        ri = self.restart_interval
        count_in_interval = 0

        for u in range(units):
            if ri and count_in_interval == ri:
                next_segment()
                count_in_interval = 0
            count_in_interval += 1

            if interleaved:
                my, mx = divmod(u, mcus_x)
                for sc in scan_comps:
                    fc = self.comps[sc.comp_idx]
                    for vi in range(fc.v):
                        for hi in range(fc.h):
                            by = my * fc.v + vi
                            bx = mx * fc.h + hi
                            blk = self.coeffs[sc.comp_idx][by, bx]
                            eobrun = self._decode_block(
                                r, blk, sc, dc_tables, ac_tables, pred,
                                ss, se, ah, al, eobrun)
            else:
                sc = scan_comps[0]
                fc = self.comps[sc.comp_idx]
                by, bx = divmod(u, fc.nbx_actual)
                blk = self.coeffs[sc.comp_idx][by, bx]
                eobrun = self._decode_block(r, blk, sc, dc_tables, ac_tables,
                                            pred, ss, se, ah, al, eobrun)

    def _decode_block(self, r, blk, sc, dc_tables, ac_tables, pred,
                      ss, se, ah, al, eobrun) -> int:
        """Returns updated eobrun. blk is a (64,) int16 view in zigzag
        order (blk[k] = coefficient at zigzag index k)."""
        if ss == 0:
            if ah == 0:
                t = dc_tables[sc.dc_tbl]
                s = _decode_symbol(r, t)
                diff = _extend(r.receive(s), s) if s else 0
                pred[sc.comp_idx] += diff
                blk[0] = pred[sc.comp_idx] << al
            else:
                if r.read_bit():
                    blk[0] |= (1 << al)
        if se == 0:
            return eobrun
        # AC
        k = max(ss, 1)
        if ah == 0:
            # first visit (baseline or progressive-first)
            if ss != 0 and eobrun > 0:
                return eobrun - 1
            t = ac_tables[sc.ac_tbl]
            while k <= se:
                rs = _decode_symbol(r, t)
                rr, s = rs >> 4, rs & 0xF
                if s == 0:
                    if rr == 15:
                        k += 16
                        continue
                    if ss != 0:
                        eobrun = (1 << rr) - 1
                        if rr:
                            eobrun += r.receive(rr)
                    return eobrun
                k += rr
                if k > se:
                    break
                blk[k] = _extend(r.receive(s), s) << al
                k += 1
            return eobrun
        # AC refinement (ITU-T81 G.1.2.3)
        p1 = 1 << al
        m1 = (-1) << al
        t = ac_tables[sc.ac_tbl]
        if eobrun == 0:
            while k <= se:
                rs = _decode_symbol(r, t)
                rr, s = rs >> 4, rs & 0xF
                s_val = 0
                if s == 0:
                    if rr != 15:
                        eobrun = (1 << rr)
                        if rr:
                            eobrun += r.receive(rr)
                        break
                    # ZRL: skip 16 zero-history coeffs, correcting nonzeros
                else:
                    s_val = p1 if r.read_bit() else m1
                # advance over coefficients: correct nonzero-history ones,
                # count down rr zero-history positions (libjpeg-style walk)
                while k <= se:
                    if blk[k] != 0:
                        if r.read_bit():
                            if (blk[k] & p1) == 0:
                                blk[k] += p1 if blk[k] >= 0 else m1
                    else:
                        if rr == 0:
                            break
                        rr -= 1
                    k += 1
                if s and k <= se:
                    blk[k] = s_val
                k += 1
        if eobrun > 0:
            while k <= se:
                if blk[k] != 0:
                    if r.read_bit():
                        if (blk[k] & p1) == 0:
                            blk[k] += p1 if blk[k] >= 0 else m1
                k += 1
            eobrun -= 1
        return eobrun


def dezigzag_planes(coeffs_zz: np.ndarray) -> np.ndarray:
    """(nby, nbx, 64) zigzag-order -> (nby, nbx, 8, 8) raster."""
    out = np.zeros_like(coeffs_zz)
    out[..., ZIGZAG] = coeffs_zz
    return out.reshape(*coeffs_zz.shape[:2], 8, 8)
