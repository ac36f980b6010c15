"""OpenEXR block codecs: PIZ, B44/B44A, PXR24, RLE/ZIP transforms.

The reference (format/exr.c:207) reads only UNCOMPRESSED scanline
files; everything here is beyond it.  Implemented from the published
OpenEXR bitstream algorithms (PIZ = used-value LUT + 2D Haar-style
wavelet + canonical Huffman with run codes; B44 = 4x4 half blocks
quantized to 14/3 bytes; PXR24 = float->24-bit + per-scanline deltas
split into byte planes + zlib).  The bit formats follow the spec
(ImfHuf/ImfWav/ImfPizCompressor layouts); the original's tests hold
them against OpenEXR's own writer and reader
(tests/test_exr_oracle.py), with structural known-answer tests and
encoder/decoder round-trips (tests/test_exr_codecs.py).

All functions speak the "raw block" format the scanline/tile readers
use: little-endian bytes, scanline-interleaved, channels sorted by
name within each line.  PIZ/B44 internally reorder to channel-major
planes exactly like the OpenEXR tmp buffers.

The wavelet, LUT, B44 block math and byte shuffles are vectorized
numpy (whole-block array ops); only the inherently serial Huffman bit
loop is scalar Python.

Copied from ``ffpic_tpu/coding/exr_codec.py`` for the PyTorch port, with
its imports rewritten to the port's modules; PIZ's Huffman decode runs
under the span ``exr.piz_huffman``.  DWA's ``unRleAc`` reads the AC
token stream without a bounds check, as the original does
(``:1187-1200``): a short stream raises ``IndexError``, which the
registry's ``corrupt_as_value_error`` turns into ``ValueError``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ffpic_tpu_torch.utils.trace import stage

HUF_ENCBITS = 16
HUF_ENCSIZE = (1 << HUF_ENCBITS) + 1  # 65537: 16-bit values + 1 rlc slot
HUF_DECBITS = 14
HUF_DECSIZE = 1 << HUF_DECBITS
HUF_DECMASK = HUF_DECSIZE - 1

BITMAP_SIZE = 1 << (HUF_ENCBITS - 3)  # 8192

_SHORT_ZEROCODE_RUN = 59
_LONG_ZEROCODE_RUN = 63
_SHORTEST_LONG_RUN = 2 + _LONG_ZEROCODE_RUN - _SHORT_ZEROCODE_RUN  # 6
_LONGEST_LONG_RUN = 255 + _SHORTEST_LONG_RUN  # 261


# ---------------------------------------------------------------------------
# bit IO (MSB-first, the ImfHuf c/lc accumulator convention)

class _BitWriter:
    __slots__ = ("buf", "c", "lc")

    def __init__(self):
        self.buf = bytearray()
        self.c = 0
        self.lc = 0

    def write(self, nbits: int, val: int) -> None:
        c = (self.c << nbits) | (val & ((1 << nbits) - 1))
        lc = self.lc + nbits
        buf = self.buf
        while lc >= 8:
            lc -= 8
            buf.append((c >> lc) & 0xFF)
        self.c = c & ((1 << lc) - 1) if lc else 0
        self.lc = lc

    def bit_count(self) -> int:
        return len(self.buf) * 8 + self.lc

    def flush(self) -> bytes:
        if self.lc:
            self.buf.append((self.c << (8 - self.lc)) & 0xFF)
            self.c = 0
            self.lc = 0
        return bytes(self.buf)


# ---------------------------------------------------------------------------
# canonical Huffman (ImfHuf layout)

def _canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Assign canonical code values for the given per-symbol bit
    lengths: for each length, codes are numerically increasing with
    symbol index; bases derived longest-first (len 58 downward), each
    shorter base = (prev base + prev count) >> 1."""
    n = np.bincount(lengths, minlength=59).astype(np.int64)
    base = np.zeros(59, np.int64)
    c = 0
    for i in range(58, 0, -1):
        base[i] = c
        c = (c + n[i]) >> 1
    codes = np.zeros(len(lengths), np.int64)
    used = np.nonzero(lengths)[0]
    for ln in np.unique(lengths[used]):
        sel = used[lengths[used] == ln]
        codes[sel] = base[ln] + np.arange(len(sel))
    return codes


def _build_lengths(freq: np.ndarray) -> np.ndarray:
    """Huffman code lengths from symbol frequencies (heap merge).
    Any valid prefix code decodes — the table is serialized in the
    stream — so tie-breaking need not match any other builder."""
    import heapq
    syms = np.nonzero(freq)[0]
    lengths = np.zeros(len(freq), np.int32)
    if len(syms) == 1:
        lengths[syms[0]] = 1
        return lengths
    heap = [(int(freq[s]), int(s), int(s)) for s in syms]
    # entries: (weight, tiebreak, node_id); trees tracked via parent map
    heapq.heapify(heap)
    parent: dict[int, list[int]] = {int(s): [int(s)] for s in syms}
    next_id = HUF_ENCSIZE
    while len(heap) > 1:
        w1, _, n1 = heapq.heappop(heap)
        w2, _, n2 = heapq.heappop(heap)
        members = parent.pop(n1) + parent.pop(n2)
        lengths[members] += 1
        parent[next_id] = members
        heapq.heappush(heap, (w1 + w2, next_id, next_id))
        next_id += 1
    if lengths.max(initial=0) > 58:
        raise ValueError("huffman code length > 58 bits")
    return lengths


def _pack_enc_table(lengths: np.ndarray, im: int, iM: int) -> bytes:
    """Serialize code lengths im..iM as the 6-bit run-length scheme."""
    bw = _BitWriter()
    i = im
    while i <= iM:
        ln = int(lengths[i])
        if ln == 0:
            zerun = 1
            while i < iM and zerun < _LONGEST_LONG_RUN \
                    and lengths[i + 1] == 0:
                i += 1
                zerun += 1
            if zerun >= 2:
                if zerun >= _SHORTEST_LONG_RUN:
                    bw.write(6, _LONG_ZEROCODE_RUN)
                    bw.write(8, zerun - _SHORTEST_LONG_RUN)
                else:
                    bw.write(6, _SHORT_ZEROCODE_RUN + zerun - 2)
                i += 1
                continue
        bw.write(6, ln)
        i += 1
    return bw.flush()


def _unpack_enc_table(blob: bytes, im: int, iM: int) -> np.ndarray:
    lengths = np.zeros(HUF_ENCSIZE, np.int32)
    c = 0
    lc = 0
    pos = 0
    n = len(blob)
    i = im
    while i <= iM:
        while lc < 6:
            if pos >= n:
                raise ValueError("EXR huffman table truncated")
            c = (c << 8) | blob[pos]
            pos += 1
            lc += 8
        lc -= 6
        ln = (c >> lc) & 0x3F
        if ln == _LONG_ZEROCODE_RUN:
            while lc < 8:
                if pos >= n:
                    raise ValueError("EXR huffman table truncated")
                c = (c << 8) | blob[pos]
                pos += 1
                lc += 8
            lc -= 8
            zerun = ((c >> lc) & 0xFF) + _SHORTEST_LONG_RUN
            if i + zerun > iM + 1:
                raise ValueError("EXR huffman table corrupt (long run)")
            i += zerun
        elif ln >= _SHORT_ZEROCODE_RUN:
            zerun = ln - _SHORT_ZEROCODE_RUN + 2
            if i + zerun > iM + 1:
                raise ValueError("EXR huffman table corrupt (short run)")
            i += zerun
        else:
            lengths[i] = ln
            i += 1
    return lengths


def huf_compress(data: np.ndarray) -> bytes:
    """ImfHuf hufCompress: 20-byte header (im, iM, tableLength, nBits,
    0) + packed length table + MSB-first code stream with the
    run-length symbol at index iM."""
    data = np.ascontiguousarray(data, np.uint16)
    if data.size == 0:
        return b""
    freq = np.bincount(data, minlength=HUF_ENCSIZE).astype(np.int64)
    im = int(np.nonzero(freq)[0][0])
    iM = int(np.nonzero(freq)[0][-1]) + 1  # run-length pseudo-symbol
    freq[iM] = 1
    lengths = _build_lengths(freq)
    codes = _canonical_codes(lengths)
    table = _pack_enc_table(lengths, im, iM)

    # split into runs of <= 256 identical values (count byte = extras)
    d = data.astype(np.int32)
    change = np.nonzero(np.diff(d))[0]
    starts = np.concatenate(([0], change + 1))
    ends = np.concatenate((change + 1, [len(d)]))
    bw = _BitWriter()
    rl_len = int(lengths[iM])
    rl_code = int(codes[iM])
    for s_idx, e_idx in zip(starts, ends):
        v = int(data[s_idx])
        total = int(e_idx - s_idx)
        clen = int(lengths[v])
        ccode = int(codes[v])
        if clen == 0:
            raise ValueError("symbol without code")
        while total > 0:
            chunk = min(total, 256)
            total -= chunk
            run = chunk - 1
            if clen + rl_len + 8 < clen * run:
                bw.write(clen, ccode)
                bw.write(rl_len, rl_code)
                bw.write(8, run)
            else:
                for _ in range(chunk):
                    bw.write(clen, ccode)
    nbits = bw.bit_count()
    stream = bw.flush()
    head = struct.pack("<IIIII", im, iM, len(table), nbits, 0)
    return head + table + stream


def huf_decompress(blob: bytes, n_out: int) -> np.ndarray:
    """Inverse of :func:`huf_compress`; accepts any conforming stream
    (table-driven, not tied to our encoder's tie-breaking)."""
    if n_out == 0:
        return np.zeros(0, np.uint16)
    if len(blob) < 20:
        raise ValueError("EXR huffman block truncated")
    im, iM, tlen, nbits, _room = struct.unpack_from("<IIIII", blob, 0)
    if im >= HUF_ENCSIZE or iM >= HUF_ENCSIZE or im > iM:
        raise ValueError("EXR huffman header corrupt")
    if 20 + tlen > len(blob):
        raise ValueError("EXR huffman table truncated")
    lengths = _unpack_enc_table(blob[20:20 + tlen], im, iM)
    codes = _canonical_codes(lengths)
    data = blob[20 + tlen:]
    if nbits > 8 * len(data):
        raise ValueError("EXR huffman data truncated")
    rlc = iM

    # first-level LUT over 14-bit windows for codes <= 14 bits
    lut_len = np.zeros(HUF_DECSIZE, np.int32)
    lut_sym = np.zeros(HUF_DECSIZE, np.int32)
    long_codes: dict[tuple[int, int], int] = {}
    used = np.nonzero(lengths)[0]
    for sym in used:
        ln = int(lengths[sym])
        code = int(codes[sym])
        if ln <= HUF_DECBITS:
            lo = code << (HUF_DECBITS - ln)
            hi = lo + (1 << (HUF_DECBITS - ln))
            lut_len[lo:hi] = ln
            lut_sym[lo:hi] = sym
        else:
            long_codes[(ln, code)] = int(sym)
    max_len = int(lengths.max(initial=0))

    out = np.empty(n_out, np.uint16)
    no = 0
    c = 0
    lc = 0
    pos = 0
    nbytes = (nbits + 7) // 8
    lut_len_l = lut_len.tolist()
    lut_sym_l = lut_sym.tolist()
    while no < n_out:
        # refill
        while lc < max(HUF_DECBITS, 8) and pos < nbytes:
            c = ((c << 8) | data[pos]) & 0xFFFFFFFFFFFFFFFF
            pos += 1
            lc += 8
        if lc >= HUF_DECBITS:
            w = (c >> (lc - HUF_DECBITS)) & HUF_DECMASK
        else:
            if lc <= 0:
                raise ValueError("EXR huffman data exhausted")
            w = (c << (HUF_DECBITS - lc)) & HUF_DECMASK
        ln = lut_len_l[w]
        if ln and ln <= lc:
            sym = lut_sym_l[w]
            lc -= ln
        else:
            sym = -1
            for ln2 in range(HUF_DECBITS + 1, max_len + 1):
                while lc < ln2 and pos < nbytes:
                    c = ((c << 8) | data[pos]) & 0xFFFFFFFFFFFFFFFF
                    pos += 1
                    lc += 8
                if lc < ln2:
                    break
                cand = (c >> (lc - ln2)) & ((1 << ln2) - 1)
                s = long_codes.get((ln2, cand))
                if s is not None:
                    sym = s
                    lc -= ln2
                    break
            if sym < 0:
                raise ValueError("EXR huffman invalid code")
        if sym == rlc:
            while lc < 8 and pos < nbytes:
                c = ((c << 8) | data[pos]) & 0xFFFFFFFFFFFFFFFF
                pos += 1
                lc += 8
            if lc < 8:
                raise ValueError("EXR huffman run truncated")
            lc -= 8
            cs = (c >> lc) & 0xFF
            if no == 0 or no + cs > n_out:
                raise ValueError("EXR huffman run overflow")
            out[no:no + cs] = out[no - 1]
            no += cs
        else:
            out[no] = sym
            no += 1
    return out


# ---------------------------------------------------------------------------
# 2D wavelet (ImfWav wav2Encode/wav2Decode)

def _wenc14(a, b):
    as_ = a.astype(np.int16).astype(np.int32)
    bs = b.astype(np.int16).astype(np.int32)
    ms = (as_ + bs) >> 1
    ds = as_ - bs
    return (ms & 0xFFFF).astype(np.uint16), (ds & 0xFFFF).astype(np.uint16)


def _wdec14(l, h):
    ls = l.astype(np.int16).astype(np.int32)
    hs = h.astype(np.int16).astype(np.int32)
    ai = ls + (hs & 1) + (hs >> 1)
    a = ai.astype(np.int16).astype(np.int32)
    b = (a - hs).astype(np.int16)
    return (a & 0xFFFF).astype(np.uint16), \
        (b.astype(np.int32) & 0xFFFF).astype(np.uint16)


_NBITS = 16
_A_OFFSET = 1 << (_NBITS - 1)
_MOD_MASK = (1 << _NBITS) - 1


def _wenc16(a, b):
    ao = (a.astype(np.int32) + _A_OFFSET) & _MOD_MASK
    bi = b.astype(np.int32)
    m = (ao + bi) >> 1
    d = ao - bi
    m = np.where(d < 0, (m + _A_OFFSET) & _MOD_MASK, m)
    d &= _MOD_MASK
    return m.astype(np.uint16), d.astype(np.uint16)


def _wdec16(l, h):
    m = l.astype(np.int32)
    d = h.astype(np.int32)
    b = (m - (d >> 1)) & _MOD_MASK
    a = (d + b - _A_OFFSET) & _MOD_MASK
    return a.astype(np.uint16), b.astype(np.uint16)


def wav2_encode(a: np.ndarray, mx: int) -> None:
    """In-place forward wavelet over a 2D uint16 view (any strides).
    Per level: quad transform on the (2p x 2p) grids, then the odd
    column inside each processed row band and the odd row below —
    the leftover corner element stays untouched, exactly the ImfWav
    traversal."""
    ny, nx = a.shape
    n = min(nx, ny)
    enc = _wenc14 if mx < (1 << 14) else _wenc16
    p, p2 = 1, 2
    while p2 <= n:
        Y = np.arange(0, ny - p2 + 1, p2)
        X = np.arange(0, nx - p2 + 1, p2)
        i00, i01 = enc(a[np.ix_(Y, X)], a[np.ix_(Y, X + p)])
        i10, i11 = enc(a[np.ix_(Y + p, X)], a[np.ix_(Y + p, X + p)])
        v0l, v0h = enc(i00, i10)
        v1l, v1h = enc(i01, i11)
        a[np.ix_(Y, X)] = v0l
        a[np.ix_(Y + p, X)] = v0h
        a[np.ix_(Y, X + p)] = v1l
        a[np.ix_(Y + p, X + p)] = v1h
        if nx & p:
            px = X[-1] + p2
            cl, ch = enc(a[Y, px], a[Y + p, px])
            a[Y, px] = cl
            a[Y + p, px] = ch
        if ny & p:
            py = Y[-1] + p2
            rl, rh = enc(a[py, X], a[py, X + p])
            a[py, X] = rl
            a[py, X + p] = rh
        p = p2
        p2 <<= 1


def wav2_decode(a: np.ndarray, mx: int) -> None:
    """In-place inverse of :func:`wav2_encode` (vertical un-pairing
    first, then horizontal, levels walked coarse to fine)."""
    ny, nx = a.shape
    n = min(nx, ny)
    dec = _wdec14 if mx < (1 << 14) else _wdec16
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1
    while p >= 1:
        Y = np.arange(0, ny - p2 + 1, p2)
        X = np.arange(0, nx - p2 + 1, p2)
        i00, i10 = dec(a[np.ix_(Y, X)], a[np.ix_(Y + p, X)])
        i01, i11 = dec(a[np.ix_(Y, X + p)], a[np.ix_(Y + p, X + p)])
        o00, o01 = dec(i00, i01)
        o10, o11 = dec(i10, i11)
        a[np.ix_(Y, X)] = o00
        a[np.ix_(Y, X + p)] = o01
        a[np.ix_(Y + p, X)] = o10
        a[np.ix_(Y + p, X + p)] = o11
        if nx & p:
            px = X[-1] + p2
            ca, cb = dec(a[Y, px], a[Y + p, px])
            a[Y, px] = ca
            a[Y + p, px] = cb
        if ny & p:
            py = Y[-1] + p2
            ra, rb = dec(a[py, X], a[py, X + p])
            a[py, X] = ra
            a[py, X + p] = rb
        p2 = p
        p >>= 1


# ---------------------------------------------------------------------------
# PIZ

def _block_channel_sizes(chans, w: int, nlines: int):
    """(name-sorted channel list, per-channel short-pair size).  size =
    pixel bytes / 2: half -> 1 short per sample, float/uint -> 2."""
    order = sorted(chans, key=lambda c: c["name"])
    sizes = [1 if c["type"] == 1 else 2 for c in order]
    return order, sizes


def piz_compress(raw: bytes, chans, w: int, nlines: int) -> bytes:
    """raw: scanline-interleaved LE block (the uncompressed chunk
    layout).  Returns the PIZ chunk payload."""
    order, sizes = _block_channel_sizes(chans, w, nlines)
    total = sum(w * nlines * s for s in sizes)
    data = np.frombuffer(raw, "<u2", count=total).copy()

    # gather scanline-interleaved -> channel-major tmp
    tmp = np.empty(total, np.uint16)
    line_shorts = sum(w * s for s in sizes)
    src = data.reshape(nlines, line_shorts)
    off_tmp = 0
    off_line = 0
    views = []
    for s in sizes:
        nsh = w * s
        ch = tmp[off_tmp:off_tmp + nlines * nsh].reshape(nlines, nsh)
        ch[:] = src[:, off_line:off_line + nsh]
        views.append(ch)
        off_tmp += nlines * nsh
        off_line += nsh

    # used-value bitmap + forward LUT
    bitmap = np.zeros(BITMAP_SIZE, np.uint8)
    used = np.zeros(1 << 16, bool)
    used[tmp] = True
    used[0] = False  # zero is implicit
    uidx = np.nonzero(used)[0]
    np.bitwise_or.at(bitmap, uidx >> 3, (1 << (uidx & 7)).astype(np.uint8))
    lut = np.zeros(1 << 16, np.uint16)
    present = used.copy()
    present[0] = True
    lut[present] = np.arange(np.count_nonzero(present), dtype=np.uint16)
    max_value = int(np.count_nonzero(present)) - 1
    tmp[:] = lut[tmp]

    nz = np.nonzero(bitmap)[0]
    if len(nz):
        min_nz, max_nz = int(nz[0]), int(nz[-1])
        bm_bytes = bitmap[min_nz:max_nz + 1].tobytes()
    else:
        min_nz, max_nz = BITMAP_SIZE - 1, 0
        bm_bytes = b""

    for ch, s in zip(views, sizes):
        for j in range(s):
            wav2_encode(ch.reshape(nlines, w, s)[:, :, j], max_value)

    huf = huf_compress(tmp)
    return struct.pack("<HH", min_nz, max_nz) + bm_bytes + \
        struct.pack("<i", len(huf)) + huf


def piz_decompress(blob: bytes, chans, w: int, nlines: int) -> bytes:
    """PIZ chunk payload -> scanline-interleaved raw block bytes."""
    order, sizes = _block_channel_sizes(chans, w, nlines)
    total = sum(w * nlines * s for s in sizes)
    if len(blob) < 4:
        raise ValueError("PIZ block truncated")
    min_nz, max_nz = struct.unpack_from("<HH", blob, 0)
    pos = 4
    bitmap = np.zeros(BITMAP_SIZE, np.uint8)
    if min_nz >= BITMAP_SIZE or max_nz >= BITMAP_SIZE:
        raise ValueError("PIZ bitmap bounds corrupt")
    if min_nz <= max_nz:
        nbm = max_nz - min_nz + 1
        if pos + nbm > len(blob):
            raise ValueError("PIZ bitmap truncated")
        bitmap[min_nz:max_nz + 1] = np.frombuffer(blob, np.uint8, nbm, pos)
        pos += nbm
    bitmap[0] &= 0xFE

    bits = np.unpackbits(bitmap[:, None], axis=1, bitorder="little").ravel()
    bits[0] = 1  # zero implicit
    nz = np.nonzero(bits)[0].astype(np.uint16)
    max_value = len(nz) - 1
    # full-size reverse LUT, zero-filled: indices past maxValue decode
    # to 0 (matching reverseLutFromBitmap's tail fill)
    rev = np.zeros(1 << 16, np.uint16)
    rev[:len(nz)] = nz

    if pos + 4 > len(blob):
        raise ValueError("PIZ block truncated")
    (hlen,) = struct.unpack_from("<i", blob, pos)
    pos += 4
    if hlen < 0 or pos + hlen > len(blob):
        raise ValueError("PIZ huffman length corrupt")
    with stage("exr.piz_huffman"):
        tmp = huf_decompress(blob[pos:pos + hlen], total)

    off = 0
    views = []
    for s in sizes:
        ch = tmp[off:off + nlines * w * s].reshape(nlines, w * s)
        for j in range(s):
            wav2_decode(ch.reshape(nlines, w, s)[:, :, j], max_value)
        views.append(ch)
        off += nlines * w * s
    tmp = rev[tmp]

    out = np.empty((nlines, sum(w * s for s in sizes)), np.uint16)
    off_line = 0
    off_tmp = 0
    for s in sizes:
        nsh = w * s
        out[:, off_line:off_line + nsh] = \
            tmp[off_tmp:off_tmp + nlines * nsh].reshape(nlines, nsh)
        off_line += nsh
        off_tmp += nlines * nsh
    return out.astype("<u2").tobytes()


# ---------------------------------------------------------------------------
# B44 / B44A

def _half_to_t(s: np.ndarray) -> np.ndarray:
    """Monotonic reordering of half bits: NaN/Inf -> 0x8000, negatives
    -> ~s (descending), positives -> s | 0x8000 (ascending)."""
    s = s.astype(np.uint16)
    t = np.where(s & 0x8000, ~s, s | 0x8000).astype(np.uint16)
    t = np.where((s & 0x7C00) == 0x7C00, np.uint16(0x8000), t)
    return t


def _t_to_half(t: np.ndarray) -> np.ndarray:
    t = t.astype(np.uint16)
    return np.where(t & 0x8000, t & 0x7FFF, ~t).astype(np.uint16)


def _shift_and_round(x: np.ndarray, shift: int) -> np.ndarray:
    x = x.astype(np.int64) << 1
    a = (1 << shift) - 1
    shift += 1
    b = (x >> shift) & 1
    return (x + a + b) >> shift


_R_PAIRS = [(0, 4), (4, 8), (8, 12), (0, 1), (4, 5), (8, 9), (12, 13),
            (1, 2), (5, 6), (9, 10), (13, 14), (2, 3), (6, 7), (10, 11),
            (14, 15)]


def b44_pack(t: np.ndarray, flat_ok: bool):
    """t: (N, 16) transformed blocks.  Returns (bytes14 (N,14) uint8,
    is_flat (N,) bool)."""
    n = t.shape[0]
    tmax = t.max(axis=1).astype(np.int64)
    shift = np.full(n, -1, np.int64)
    d = np.zeros((n, 16), np.int64)
    r = np.zeros((n, 15), np.int64)
    pend = np.ones(n, bool)
    for sh in range(17):
        if not pend.any():
            break
        dd = _shift_and_round(tmax[pend, None] - t[pend].astype(np.int64), sh)
        rr = np.stack([dd[:, i] - dd[:, j] + 0x20 for i, j in _R_PAIRS],
                      axis=1)
        ok = (rr.min(axis=1) >= 0) & (rr.max(axis=1) <= 0x3F)
        idx = np.nonzero(pend)[0]
        sel = idx[ok]
        shift[sel] = sh
        d[sel] = dd[ok]
        r[sel] = rr[ok]
        pend[sel] = False
    if pend.any():
        raise ValueError("B44 shift search failed")  # cannot happen: sh=16
    is_flat = np.zeros(n, bool)
    if flat_ok:
        is_flat = (r.min(axis=1) == 0x20) & (r.max(axis=1) == 0x20)
    # t0 adjusted so the block max reconstructs as accurately as possible
    t0 = (tmax - (d[:, 0] << shift)) & 0xFFFF
    b = np.zeros((n, 14), np.uint8)
    b[:, 0] = t0 >> 8
    b[:, 1] = t0 & 0xFF
    b[:, 2] = (shift << 2) | (r[:, 0] >> 4)
    b[:, 3] = (r[:, 0] << 4) | (r[:, 1] >> 2)
    b[:, 4] = (r[:, 1] << 6) | r[:, 2]
    b[:, 5] = (r[:, 3] << 2) | (r[:, 4] >> 4)
    b[:, 6] = (r[:, 4] << 4) | (r[:, 5] >> 2)
    b[:, 7] = (r[:, 5] << 6) | r[:, 6]
    b[:, 8] = (r[:, 7] << 2) | (r[:, 8] >> 4)
    b[:, 9] = (r[:, 8] << 4) | (r[:, 9] >> 2)
    b[:, 10] = (r[:, 9] << 6) | r[:, 10]
    b[:, 11] = (r[:, 11] << 2) | (r[:, 12] >> 4)
    b[:, 12] = (r[:, 12] << 4) | (r[:, 13] >> 2)
    b[:, 13] = (r[:, 13] << 6) | r[:, 14]
    return b, is_flat


def b44_unpack(b: np.ndarray) -> np.ndarray:
    """b: (N, 14) uint8 packed blocks -> (N, 16) t values."""
    b = b.astype(np.int64)
    shift = b[:, 2] >> 2
    bias = 0x20 << shift
    r = np.empty((b.shape[0], 15), np.int64)
    r[:, 0] = ((b[:, 2] << 4) | (b[:, 3] >> 4)) & 0x3F
    r[:, 1] = ((b[:, 3] << 2) | (b[:, 4] >> 6)) & 0x3F
    r[:, 2] = b[:, 4] & 0x3F
    r[:, 3] = (b[:, 5] >> 2) & 0x3F
    r[:, 4] = ((b[:, 5] << 4) | (b[:, 6] >> 4)) & 0x3F
    r[:, 5] = ((b[:, 6] << 2) | (b[:, 7] >> 6)) & 0x3F
    r[:, 6] = b[:, 7] & 0x3F
    r[:, 7] = (b[:, 8] >> 2) & 0x3F
    r[:, 8] = ((b[:, 8] << 4) | (b[:, 9] >> 4)) & 0x3F
    r[:, 9] = ((b[:, 9] << 2) | (b[:, 10] >> 6)) & 0x3F
    r[:, 10] = b[:, 10] & 0x3F
    r[:, 11] = (b[:, 11] >> 2) & 0x3F
    r[:, 12] = ((b[:, 11] << 4) | (b[:, 12] >> 4)) & 0x3F
    r[:, 13] = ((b[:, 12] << 2) | (b[:, 13] >> 6)) & 0x3F
    r[:, 14] = b[:, 13] & 0x3F
    rs = (r << shift[:, None]) - bias[:, None]
    t = np.empty((b.shape[0], 16), np.int64)
    t[:, 0] = (b[:, 0] << 8) | b[:, 1]
    t[:, 4] = t[:, 0] + rs[:, 0]
    t[:, 8] = t[:, 4] + rs[:, 1]
    t[:, 12] = t[:, 8] + rs[:, 2]
    t[:, 1] = t[:, 0] + rs[:, 3]
    t[:, 5] = t[:, 4] + rs[:, 4]
    t[:, 9] = t[:, 8] + rs[:, 5]
    t[:, 13] = t[:, 12] + rs[:, 6]
    t[:, 2] = t[:, 1] + rs[:, 7]
    t[:, 6] = t[:, 5] + rs[:, 8]
    t[:, 10] = t[:, 9] + rs[:, 9]
    t[:, 14] = t[:, 13] + rs[:, 10]
    t[:, 3] = t[:, 2] + rs[:, 11]
    t[:, 7] = t[:, 6] + rs[:, 12]
    t[:, 11] = t[:, 10] + rs[:, 13]
    t[:, 15] = t[:, 14] + rs[:, 14]
    return (t & 0xFFFF).astype(np.uint16)


def _to_blocks(plane: np.ndarray) -> np.ndarray:
    """(ny, nx) -> (nblocks, 16) 4x4 blocks, edges replicated."""
    ny, nx = plane.shape
    py = (-ny) % 4
    px = (-nx) % 4
    if py or px:
        plane = np.pad(plane, ((0, py), (0, px)), mode="edge")
    by = plane.shape[0] // 4
    bx = plane.shape[1] // 4
    return plane.reshape(by, 4, bx, 4).transpose(0, 2, 1, 3) \
        .reshape(by * bx, 16)


def _from_blocks(blocks: np.ndarray, ny: int, nx: int) -> np.ndarray:
    by = (ny + 3) // 4
    bx = (nx + 3) // 4
    full = blocks.reshape(by, bx, 4, 4).transpose(0, 2, 1, 3) \
        .reshape(by * 4, bx * 4)
    return full[:ny, :nx]


def b44_compress(raw: bytes, chans, w: int, nlines: int,
                 optimize_flat: bool) -> bytes:
    """Scanline-interleaved block -> B44 (optimize_flat=False) or B44A
    payload.  HALF channels go through 4x4 quantized blocks; other
    channel types are stored verbatim (channel-major), per the B44
    format."""
    order, sizes = _block_channel_sizes(chans, w, nlines)
    line_shorts = sum(w * s for s in sizes)
    src = np.frombuffer(raw, "<u2",
                        count=nlines * line_shorts).reshape(nlines, -1)
    out = bytearray()
    off_line = 0
    for c, s in zip(order, sizes):
        nsh = w * s
        plane = src[:, off_line:off_line + nsh]
        off_line += nsh
        if c["type"] != 1:  # not HALF: raw copy, channel-major
            out += plane.astype("<u2").tobytes()
            continue
        t = _half_to_t(plane)
        blocks = _to_blocks(t)
        b, is_flat = b44_pack(blocks, optimize_flat)
        if optimize_flat and is_flat.any():
            lens = np.where(is_flat, 3, 14)
            flat = b.copy()
            flat[:, 2] = 0xFC
            b = np.where(is_flat[:, None], flat, b)
            mask = np.arange(14)[None, :] < lens[:, None]
            out += b[mask].tobytes()
        else:
            out += b.tobytes()
    return bytes(out)


def b44_decompress(blob: bytes, chans, w: int, nlines: int) -> bytes:
    order, sizes = _block_channel_sizes(chans, w, nlines)
    buf = np.frombuffer(blob, np.uint8)
    pos = 0
    out = np.empty((nlines, sum(w * s for s in sizes)), np.uint16)
    off_line = 0
    for c, s in zip(order, sizes):
        nsh = w * s
        if c["type"] != 1:
            nb = nlines * nsh * 2
            if pos + nb > len(buf):
                raise ValueError("B44 block truncated")
            out[:, off_line:off_line + nsh] = np.frombuffer(
                blob, "<u2", nlines * nsh, pos).reshape(nlines, nsh)
            pos += nb
            off_line += nsh
            continue
        by = (nlines + 3) // 4
        bx = (w + 3) // 4
        nblocks = by * bx
        # sequential walk: 3-byte flat blocks (b[2] == 0xfc) vs 14-byte
        offs = np.empty(nblocks, np.int64)
        lens = np.empty(nblocks, np.int64)
        p = pos
        nbuf = len(buf)
        for i in range(nblocks):
            if p + 3 > nbuf:
                raise ValueError("B44 block truncated")
            offs[i] = p
            if buf[p + 2] == 0xFC:
                lens[i] = 3
                p += 3
            else:
                if p + 14 > nbuf:
                    raise ValueError("B44 block truncated")
                lens[i] = 14
                p += 14
        pos = p
        b = np.zeros((nblocks, 14), np.uint8)
        gather = offs[:, None] + np.arange(14)[None, :]
        valid = np.arange(14)[None, :] < lens[:, None]
        b[valid] = buf[gather[valid]]
        t = np.empty((nblocks, 16), np.uint16)
        full = lens == 14
        if full.any():
            t[full] = b44_unpack(b[full])
        if (~full).any():
            t0 = ((b[~full, 0].astype(np.uint16) << 8) | b[~full, 1])
            t[~full] = t0[:, None]
        plane = _from_blocks(_t_to_half(t), nlines, w)
        out[:, off_line:off_line + nsh] = plane
        off_line += nsh
    return out.astype("<u2").tobytes()


# ---------------------------------------------------------------------------
# PXR24

def float_to_float24(f: np.ndarray) -> np.ndarray:
    """float32 bits -> 24-bit float (sign, 8-bit exp, 15-bit mantissa),
    round-to-nearest with overflow clamp; NaN payload preserved
    (truncated, forced nonzero)."""
    i = f.view(np.uint32) if f.dtype == np.float32 else \
        np.asarray(f, np.float32).view(np.uint32)
    s = i & 0x80000000
    e = i & 0x7F800000
    m = i & 0x007FFFFF
    fin = (e | m) + 0x80  # round half up on the dropped byte
    fin24 = fin >> 8
    fin24 = np.where(fin24 >= 0x7F8000, 0x7F7FFF, fin24)  # clamp to max
    nan = (e == 0x7F800000) & (m != 0)
    inf = (e == 0x7F800000) & (m == 0)
    m24 = np.maximum(m >> 8, 1)
    out = np.where(nan, 0x7F8000 | m24, np.where(inf, 0x7F8000, fin24))
    return (s >> 8) | out


def float24_to_float(p24: np.ndarray) -> np.ndarray:
    return (p24.astype(np.uint32) << 8).view(np.float32)


def pxr24_compress(raw: bytes, chans, w: int, nlines: int) -> bytes:
    order, sizes = _block_channel_sizes(chans, w, nlines)
    pixsz = [2 if c["type"] == 1 else 4 for c in order]
    line_bytes = sum(w * p for p in pixsz)
    src = np.frombuffer(raw, np.uint8,
                        count=nlines * line_bytes).reshape(nlines, -1)
    parts = []
    off = 0
    for c, p in zip(order, pixsz):
        nb = w * p
        seg = src[:, off:off + nb]
        off += nb
        if c["type"] == 1:  # HALF: 16-bit deltas, 2 byte planes
            v = seg.reshape(nlines, w, 2).copy().view("<u2")[:, :, 0] \
                .astype(np.int64)
            d = np.diff(v, axis=1, prepend=0) & 0xFFFF
            parts.append(((d >> 8) & 0xFF).astype(np.uint8))
            parts.append((d & 0xFF).astype(np.uint8))
        elif c["type"] == 2:  # FLOAT: 24-bit quantize, 3 byte planes
            v = seg.reshape(nlines, w, 4).copy().view("<f4")[:, :, 0]
            p24 = float_to_float24(v).astype(np.int64)
            d = np.diff(p24, axis=1, prepend=0) & 0xFFFFFF
            parts.append(((d >> 16) & 0xFF).astype(np.uint8))
            parts.append(((d >> 8) & 0xFF).astype(np.uint8))
            parts.append((d & 0xFF).astype(np.uint8))
        else:  # UINT: 32-bit deltas, 4 byte planes
            v = seg.reshape(nlines, w, 4).copy().view("<u4")[:, :, 0] \
                .astype(np.int64)
            d = np.diff(v, axis=1, prepend=0) & 0xFFFFFFFF
            for sh in (24, 16, 8, 0):
                parts.append(((d >> sh) & 0xFF).astype(np.uint8))
    # parts holds (nlines, w) byte planes already in the OpenEXR tmp
    # order (channels in name order, each channel's planes contiguous
    # per scanline): stacking on axis 1 gives (line, plane, w)
    tmp = np.stack(parts, axis=1)
    return zlib.compress(np.ascontiguousarray(tmp).tobytes())


def pxr24_decompress(blob: bytes, chans, w: int, nlines: int) -> bytes:
    order, sizes = _block_channel_sizes(chans, w, nlines)
    pixsz = [2 if c["type"] == 1 else 4 for c in order]
    nplanes = sum(2 if c["type"] == 1 else (3 if c["type"] == 2 else 4)
                  for c in order)
    want = nlines * nplanes * w
    raw = zlib.decompress(blob)
    if len(raw) < want:
        raise ValueError("PXR24 block truncated")
    tmp = np.frombuffer(raw, np.uint8, want).reshape(nlines, nplanes, w) \
        .astype(np.int64)
    out = np.empty((nlines, sum(w * p for p in pixsz)), np.uint8)
    plane = 0
    off = 0
    for c, p in zip(order, pixsz):
        nb = w * p
        if c["type"] == 1:
            d = (tmp[:, plane] << 8) | tmp[:, plane + 1]
            plane += 2
            v = (np.cumsum(d, axis=1) & 0xFFFF).astype("<u2")
            out[:, off:off + nb] = v.view(np.uint8).reshape(nlines, nb)
        elif c["type"] == 2:
            d = (tmp[:, plane] << 16) | (tmp[:, plane + 1] << 8) | \
                tmp[:, plane + 2]
            plane += 3
            p24 = (np.cumsum(d, axis=1) & 0xFFFFFF).astype(np.uint32)
            v = float24_to_float(p24).astype("<f4")
            out[:, off:off + nb] = v.view(np.uint8).reshape(nlines, nb)
        else:
            d = (tmp[:, plane] << 24) | (tmp[:, plane + 1] << 16) | \
                (tmp[:, plane + 2] << 8) | tmp[:, plane + 3]
            plane += 4
            v = (np.cumsum(d, axis=1) & 0xFFFFFFFF).astype("<u4")
            out[:, off:off + nb] = v.view(np.uint8).reshape(nlines, nb)
        off += nb
    return out.tobytes()


# ---------------------------------------------------------------------------
# RLE + ZIP forward transforms (for the encoder; decode lives in exr.py)

def zip_deconstruct(raw: bytes) -> bytes:
    """Inverse of the ZIP reconstruct: de-interleave even/odd bytes
    into halves, then byte-delta with +128 bias."""
    b = np.frombuffer(raw, np.uint8)
    n = len(b)
    half = (n + 1) // 2
    t = np.empty(n, np.uint8)
    t[:half] = b[0::2]
    t[half:] = b[1::2]
    d = t.astype(np.int64)
    d[1:] = (d[1:] - d[:-1] + (128 + 256)) & 0xFF
    return d.astype(np.uint8).tobytes()


def rle_compress(raw: bytes) -> bytes:
    """OpenEXR RLE (applied after zip_deconstruct): runs >= 3 stored as
    (count-1, byte); literals as (-(len), bytes), len <= 127."""
    b = np.frombuffer(raw, np.uint8)
    out = bytearray()
    i = 0
    n = len(b)
    while i < n:
        run = 1
        while i + run < n and b[i + run] == b[i] and run < 127:
            run += 1
        if run >= 3:
            out.append(run - 1)
            out.append(b[i])
            i += run
        else:
            start = i
            i += run
            while i < n and i - start < 125:
                nxt = 1
                while i + nxt < n and b[i + nxt] == b[i] and nxt < 3:
                    nxt += 1
                if nxt >= 3:
                    break
                i += nxt
            ln = i - start
            out.append(256 - ln)
            out += b[start:i].tobytes()
    return bytes(out)


# ---------------------------------------------------------------------------
# DWAA / DWAB decode (OpenEXR ImfDwaCompressor semantics)
# ---------------------------------------------------------------------------
# The reference reads only uncompressed EXR scanlines (exr.c:207);
# DWA is beyond-reference surface validated against the real OpenEXR
# library (tests/test_exr_oracle.py).  Layout: an 11-field uint64 LE
# header, then zlib'd UNKNOWN-channel data, the huffman/deflate AC
# stream, the zip'd DC stream and the zlib+RLE stream.  Lossy-DCT
# channels decode as half-quantized 8x8 float DCT blocks with an
# optional Rec.709 CSC across {R,G,B} sets and a final
# nonlinear->linear half lookup.

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int32)

_TO_LINEAR = None


def _dwa_to_linear() -> np.ndarray:
    """dwaLookups toLinear table (half bits -> half bits): the DWA
    quantization space is sign-preserving gamma-2.2 below 1.0 and
    logarithmic above (continuous in value and slope at 1.0):
    |y| <= 1 -> |y|^2.2, |y| > 1 -> exp(2.2*(|y|-1)); non-finite
    inputs map to 0."""
    global _TO_LINEAR
    if _TO_LINEAR is None:
        bits = np.arange(65536, dtype=np.uint16)
        h = bits.view(np.float16).astype(np.float64)
        a = np.abs(h)
        with np.errstate(invalid="ignore", over="ignore"):
            v = np.where(a <= 1.0, np.power(a, 2.2),
                         np.exp(2.2 * (a - 1.0)))
            v = np.sign(h) * v
            v = np.where(np.isfinite(h), v, 0.0)
            _TO_LINEAR = v.astype(np.float16).view(np.uint16)
    return _TO_LINEAR


def _dct_inverse_8x8(blocks: np.ndarray) -> np.ndarray:
    """OpenEXR dctInverse8x8 (float32 butterflies, same operation
    order as dctInverse8x8_scalar) over (n, 8, 8) blocks."""
    import math
    f32 = np.float32
    # constants exactly as the library's float expressions fold:
    # .5f * cosf((k * 3.14159f) / n) with every step in float32 and
    # a correctly-rounded cosf
    pi = f32(3.14159)

    def cn(k, n):
        arg = (f32(k) * pi) / f32(n) if k != 1 else pi / f32(n)
        return f32(.5) * f32(math.cos(float(arg)))

    a = cn(1, 4)
    b = cn(1, 16)
    c = cn(1, 8)
    d = cn(3, 16)
    e = cn(5, 16)
    f = cn(3, 8)
    g = cn(7, 16)

    def pass_rows(x):
        # x: (n, 8, 8) operate on last axis
        r = [x[..., i] for i in range(8)]
        al0, al1 = c * r[2], f * r[2]
        al2, al3 = c * r[6], f * r[6]
        be0 = ((b * r[1] + d * r[3]) + e * r[5]) + g * r[7]
        be1 = ((d * r[1] - g * r[3]) - b * r[5]) - e * r[7]
        be2 = ((e * r[1] - b * r[3]) + g * r[5]) + d * r[7]
        be3 = ((g * r[1] - e * r[3]) + d * r[5]) - b * r[7]
        th0 = a * (r[0] + r[4])
        th3 = a * (r[0] - r[4])
        th1 = al0 + al3
        th2 = al1 - al2
        ga0 = th0 + th1
        ga1 = th3 + th2
        ga2 = th3 - th2
        ga3 = th0 - th1
        return np.stack([ga0 + be0, ga1 + be1, ga2 + be2, ga3 + be3,
                         ga3 - be3, ga2 - be2, ga1 - be1, ga0 - be0],
                        axis=-1)

    x = pass_rows(blocks.astype(np.float32))
    x = pass_rows(x.transpose(0, 2, 1)).transpose(0, 2, 1)
    return x


def _csc709_inverse(blocks3):
    """csc709Inverse on [R-slot, G-slot, B-slot] float blocks."""
    f32 = np.float32
    y, by, ry = blocks3
    r = y + f32(1.5747) * ry
    g = (y - f32(0.1873) * by) - f32(0.4682) * ry
    b = y + f32(1.8556) * by
    return [r, g, b]


# default channel rules (used for version < 2 streams):
# (suffix, cscIdx or -1, scheme, pixel type); scheme 0=UNKNOWN,
# 1=LOSSY_DCT, 2=RLE; types 0=UINT 1=HALF 2=FLOAT
_DWA_DEFAULT_RULES = (
    ("r", 0, 1, 1), ("r", 0, 1, 2),
    ("g", 1, 1, 1), ("g", 1, 1, 2),
    ("b", 2, 1, 1), ("b", 2, 1, 2),
    ("y", -1, 1, 1), ("y", -1, 1, 2),
    ("by", -1, 1, 1), ("by", -1, 1, 2),
    ("ry", -1, 1, 1), ("ry", -1, 1, 2),
    ("a", -1, 2, 0), ("a", -1, 2, 1), ("a", -1, 2, 2),
)


def _dwa_parse_rules(blob: bytes):
    """Version-2 serialized channel rules: uint16 total size
    (self-inclusive), then per rule a nul-terminated name, a packed
    byte ((cscIdx+1) << 4 | scheme << 2 | ...) and the pixel type."""
    import struct
    size = struct.unpack_from("<H", blob, 0)[0]
    rules = []
    p = 2
    while p < size:
        e = blob.index(b"\0", p)
        name = blob[p:e].decode("latin1").lower()
        b0, b1 = blob[e + 1], blob[e + 2]
        rules.append((name, (b0 >> 4) - 1, (b0 >> 2) & 3, b1))
        p = e + 3
    return rules, size


def _dwa_classify(chans, rules):
    """Match each channel's lowercase suffix + pixel type against the
    rule list.  Returns (dct_groups, rle_idx, unk_idx): dct_groups is
    a list of channel-index lists (len 3 = CSC set in cscIdx order,
    len 1 = single lossy channel)."""
    csc_cand: dict = {}
    singles = []
    rle_idx = []
    unk_idx = []
    for i, ch in enumerate(chans):
        name = ch["name"]
        pre, _, suf = name.rpartition(".")
        s = suf.lower()
        if ch.get("xs", 1) != 1 or ch.get("ys", 1) != 1:
            raise NotImplementedError("DWA with subsampled channels")
        rule = next((r for r in rules
                     if r[0] == s and r[3] == ch["type"]), None)
        if rule is None or rule[2] == 0:
            unk_idx.append(i)
        elif rule[2] == 2:
            rle_idx.append(i)
        elif rule[1] >= 0:
            csc_cand.setdefault(pre, {})[rule[1]] = i
        else:
            singles.append(i)
    groups = []
    for pre in sorted(csc_cand):
        m = csc_cand[pre]
        if len(m) == 3:
            groups.append([m[0], m[1], m[2]])
        else:
            singles.extend(m.values())
    for i in sorted(singles):
        groups.append([i])
    return groups, rle_idx, unk_idx


def dwa_decompress(blob: bytes, chans, w: int, nlines: int) -> bytes:
    """DWAA/DWAB chunk payload -> scanline-interleaved raw block
    bytes (the uncompressed chunk layout)."""
    import struct
    import zlib
    if len(blob) < 88:
        raise ValueError("DWA chunk too small")
    (version, unk_unc_sz, unk_cmp_sz, ac_cmp_sz, dc_cmp_sz,
     rle_cmp_sz, rle_unc_sz, rle_raw_sz, ac_count, dc_count,
     ac_compression) = struct.unpack_from("<11Q", blob, 0)
    if version > 2:
        raise ValueError(f"DWA version {version}")
    pos = 88
    if version >= 2:
        rules, rule_size = _dwa_parse_rules(blob[pos:])
        pos += rule_size
    else:
        rules = list(_DWA_DEFAULT_RULES)
    unk_data = blob[pos:pos + unk_cmp_sz]
    pos += unk_cmp_sz
    ac_data = blob[pos:pos + ac_cmp_sz]
    pos += ac_cmp_sz
    dc_data = blob[pos:pos + dc_cmp_sz]
    pos += dc_cmp_sz
    rle_data = blob[pos:pos + rle_cmp_sz]

    groups, rle_idx, unk_idx = _dwa_classify(chans, rules)

    # streams
    if ac_count:
        if ac_compression == 0:            # STATIC_HUFFMAN
            ac = huf_decompress(bytes(ac_data), int(ac_count))
        else:                              # DEFLATE
            raw = zlib.decompress(bytes(ac_data))
            ac = np.frombuffer(raw, "<u2").astype(np.uint16)
    else:
        ac = np.zeros(0, np.uint16)
    if dc_count:
        from ffpic_tpu_torch.formats.exr import _zip_reconstruct
        dc = np.frombuffer(
            _zip_reconstruct(zlib.decompress(bytes(dc_data))), "<u2")
        if len(dc) != dc_count:
            raise ValueError("DWA DC count mismatch")
    else:
        dc = np.zeros(0, np.uint16)
    if rle_raw_sz:
        from ffpic_tpu_torch.formats.exr import _rle_decode
        rle_raw = _rle_decode(zlib.decompress(bytes(rle_data)),
                              int(rle_raw_sz))
    else:
        rle_raw = b""
    unk_raw = zlib.decompress(bytes(unk_data)) if unk_unc_sz else b""

    nbx = (w + 7) // 8
    nby = (nlines + 7) // 8
    nblocks = nbx * nby
    to_linear = _dwa_to_linear()
    planes = [None] * len(chans)

    # lossy-DCT channel groups share the AC token stream; DC values
    # are planar per channel in group traversal order
    ac_pos = 0
    dc_pos = 0
    ac = np.asarray(ac, np.uint16)
    for grp in groups:
        ncomp = len(grp)
        zig = np.zeros((ncomp, nblocks, 64), np.uint16)
        for blk in range(nblocks):
            for ci in range(ncomp):
                zig[ci, blk, 0] = dc[dc_pos + ci * nblocks + blk]
                # unRleAc
                k = 1
                while k < 64:
                    tok = int(ac[ac_pos])
                    ac_pos += 1
                    if tok == 0xFF00:
                        break
                    if (tok >> 8) == 0xFF:
                        k += tok & 0xFF
                    else:
                        zig[ci, blk, k] = tok
                        k += 1
        dc_pos += ncomp * nblocks
        # dezigzag -> half -> float -> IDCT
        comps = []
        for ci in range(ncomp):
            dez = np.zeros((nblocks, 64), np.uint16)
            dez[:, _ZIGZAG] = zig[ci]
            fl = dez.view(np.float16).astype(np.float32) \
                .reshape(nblocks, 8, 8)
            comps.append(_dct_inverse_8x8(fl))
        if ncomp == 3:
            comps = _csc709_inverse(comps)
        for ci, chan_idx in enumerate(grp):
            halves = comps[ci].astype(np.float16).view(np.uint16)
            halves = to_linear[halves]
            # blocks -> plane (crop overhang)
            full = halves.reshape(nby, nbx, 8, 8) \
                .transpose(0, 2, 1, 3).reshape(nby * 8, nbx * 8)
            planes[chan_idx] = full[:nlines, :w].copy()

    # RLE channels: per channel, byte-planes of size w*nlines
    rp = 0
    rb = np.frombuffer(rle_raw, np.uint8)
    for i in rle_idx:
        bpp = 2 if chans[i]["type"] == 1 else 4
        npix = w * nlines
        byte_planes = [rb[rp + k * npix: rp + (k + 1) * npix]
                       for k in range(bpp)]
        rp += bpp * npix
        inter = np.empty(npix * bpp, np.uint8)
        for k in range(bpp):
            inter[k::bpp] = byte_planes[k]
        planes[i] = inter
    # UNKNOWN channels: planar per channel, rows consecutive
    up = 0
    ub = np.frombuffer(unk_raw, np.uint8)
    for i in unk_idx:
        bpp = 2 if chans[i]["type"] == 1 else 4
        nbytes = w * nlines * bpp
        planes[i] = ub[up:up + nbytes]
        up += nbytes

    # assemble the scanline-interleaved uncompressed layout
    out = bytearray()
    for row in range(nlines):
        for i, ch in enumerate(chans):
            bpp = 2 if ch["type"] == 1 else 4
            p = planes[i]
            if p is None:
                raise ValueError("DWA: unclassified channel "
                                 f"{ch['name']}")
            if p.dtype == np.uint16:
                out += p[row].tobytes()
            else:
                out += p[row * w * bpp:(row + 1) * w * bpp].tobytes()
    return bytes(out)
