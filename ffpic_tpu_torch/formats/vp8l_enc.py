"""VP8L (lossless WebP) encoder of the port.

Copied from ``ffpic_tpu/formats/vp8l_enc.py`` (``LsbWriter``,
``encode_stream``, ``encode_vp8l``, ``encode_webp_lossless``), so that
``encode`` writes the original's bytes.  Simple-but-valid coding: an
optional subtract-green transform, one Huffman group, no colour cache,
no LZ77 backward references, every pixel four literal codes, written
LSB-first with canonical codes bit-reversed (spec 6.2).  Host-only, as
in the original.
"""

from __future__ import annotations

import struct

import numpy as np

from ffpic_tpu_torch.formats.vp8l import CLCL_ORDER


class LsbWriter:
    __slots__ = ("buf", "cur", "nbits")

    def __init__(self):
        self.buf = bytearray()
        self.cur = 0
        self.nbits = 0

    def write(self, value: int, nbits: int) -> None:
        self.cur |= (value & ((1 << nbits) - 1)) << self.nbits
        self.nbits += nbits
        while self.nbits >= 8:
            self.buf.append(self.cur & 0xFF)
            self.cur >>= 8
            self.nbits -= 8

    def bytes(self) -> bytes:
        out = bytes(self.buf)
        if self.nbits:
            out += bytes((self.cur & 0xFF,))
        return out


def _rev(code: int, length: int) -> int:
    r = 0
    for _ in range(length):
        r = (r << 1) | (code & 1)
        code >>= 1
    return r


def _huff_lengths(freqs: np.ndarray, max_len: int) -> np.ndarray:
    """Length-limited huffman code lengths (>=2 used symbols)."""
    import heapq
    freqs = freqs.astype(np.int64)
    while True:
        heap = [(int(f), i, None) for i, f in enumerate(freqs) if f]
        heapq.heapify(heap)
        if len(heap) < 2:
            raise ValueError("need >= 2 symbols")
        nodes = []
        while len(heap) > 1:
            a = heapq.heappop(heap)
            b = heapq.heappop(heap)
            node = (a[0] + b[0], len(freqs) + len(nodes), (a, b))
            nodes.append(node)
            heapq.heappush(heap, node)
        lengths = np.zeros(len(freqs), np.int32)
        stack = [(heap[0], 0)]
        while stack:
            (f, i, kids), depth = stack.pop()
            if kids is None:
                lengths[i] = max(depth, 1)
            else:
                stack.append((kids[0], depth + 1))
                stack.append((kids[1], depth + 1))
        if lengths.max() <= max_len:
            return lengths
        # flatten the distribution and retry (clamps depth)
        freqs = (freqs + 1) >> 1


def _canonical_codes(lengths: np.ndarray) -> np.ndarray:
    maxlen = int(lengths.max())
    counts = np.bincount(lengths[lengths > 0], minlength=maxlen + 1)
    code = 0
    next_code = [0] * (maxlen + 1)
    for l in range(1, maxlen + 1):
        code = (code + counts[l - 1]) << 1
        next_code[l] = code
    codes = np.zeros(len(lengths), np.int64)
    for sym in range(len(lengths)):
        l = int(lengths[sym])
        if l:
            codes[sym] = next_code[l]
            next_code[l] += 1
    return codes


def _write_tree(w: LsbWriter, freqs: np.ndarray):
    """Write one huffman code (spec 6.2.2); returns (lengths, codes)
    for encoding symbols afterwards."""
    used = np.nonzero(freqs)[0]
    if len(used) == 0:
        # unused alphabet: simple code, single symbol 0
        w.write(1, 1)            # simple
        w.write(0, 1)            # num symbols - 1 = 0
        w.write(0, 1)            # first symbol in 1 bit
        w.write(0, 1)            # symbol 0
        return None, None
    if len(used) == 1 and used[0] < 2:
        w.write(1, 1)
        w.write(0, 1)
        w.write(0, 1)            # 1-bit first symbol
        w.write(int(used[0]), 1)
        ln = np.zeros(len(freqs), np.int32)
        return ln, np.zeros(len(freqs), np.int64)
    if len(used) == 1:
        w.write(1, 1)
        w.write(0, 1)
        w.write(1, 1)            # 8-bit first symbol
        w.write(int(used[0]), 8)
        return np.zeros(len(freqs), np.int32), \
            np.zeros(len(freqs), np.int64)
    if len(used) == 2 and used[0] < 256 and used[1] < 256:
        w.write(1, 1)            # simple
        w.write(1, 1)            # two symbols
        w.write(1, 1)            # first symbol in 8 bits
        w.write(int(used[0]), 8)
        w.write(int(used[1]), 8)
        ln = np.zeros(len(freqs), np.int32)
        ln[used] = 1
        codes = np.zeros(len(freqs), np.int64)
        codes[used[0]], codes[used[1]] = 0, 1
        return ln, codes

    lengths = _huff_lengths(freqs, 15)
    codes = _canonical_codes(lengths)

    # RLE the length sequence with 0-run codes 17/18 (and literals)
    seq = []                     # (cl_symbol, extra_value, extra_bits)
    i = 0
    n = len(lengths)
    while i < n:
        if lengths[i] == 0:
            j = i
            while j < n and lengths[j] == 0:
                j += 1
            run = j - i
            while run >= 11:
                take = min(run, 138)
                seq.append((18, take - 11, 7))
                run -= take
            while run >= 3:
                take = min(run, 10)
                seq.append((17, take - 3, 3))
                run -= take
            for _ in range(run):
                seq.append((0, 0, 0))
            i = j
        else:
            seq.append((int(lengths[i]), 0, 0))
            i += 1
    # trailing zeros can be dropped entirely via max_symbol... keep
    # all (write "no limit" bit)

    cl_freq = np.zeros(19, np.int64)
    for s, _, _ in seq:
        cl_freq[s] += 1
    used_cl = np.nonzero(cl_freq)[0]
    if len(used_cl) == 1:
        cl_lengths = np.zeros(19, np.int32)
        cl_lengths[used_cl[0]] = 1
        # a 1-length code needs a sibling for completeness: give
        # length 1 to another symbol (harmless, never coded)
        other = 0 if used_cl[0] != 0 else 1
        cl_lengths[other] = 1
    else:
        cl_lengths = _huff_lengths(cl_freq, 7)
    cl_codes = _canonical_codes(cl_lengths)

    w.write(0, 1)                # not simple
    # num_code_lengths: trim trailing zeros in CLCL_ORDER
    order = list(CLCL_ORDER)
    num_clcl = 19
    while num_clcl > 4 and cl_lengths[order[num_clcl - 1]] == 0:
        num_clcl -= 1
    w.write(num_clcl - 4, 4)
    for k in range(num_clcl):
        w.write(int(cl_lengths[order[k]]), 3)
    w.write(0, 1)                # no max_symbol limit
    for s, extra, ebits in seq:
        w.write(_rev(int(cl_codes[s]), int(cl_lengths[s])),
                int(cl_lengths[s]))
        if ebits:
            w.write(extra, ebits)
    return lengths, codes


def encode_stream(w: LsbWriter, argb: np.ndarray,
                  subtract_green: bool = True) -> None:
    """Encode an (h, w, 4) ARGB array as a VP8L image stream."""
    h, wd = argb.shape[:2]
    img = argb.astype(np.int32)
    if subtract_green:
        w.write(1, 1)            # transform present
        w.write(2, 2)            # subtract green
        img = img.copy()
        img[..., 1] = (img[..., 1] - img[..., 2]) & 255   # R -= G
        img[..., 3] = (img[..., 3] - img[..., 2]) & 255   # B -= G
    w.write(0, 1)                # no more transforms
    w.write(0, 1)                # no color cache
    w.write(0, 1)                # no meta huffman

    a = img[..., 0].ravel()
    r = img[..., 1].ravel()
    g = img[..., 2].ravel()
    b = img[..., 3].ravel()

    gfreq = np.bincount(g, minlength=256 + 24).astype(np.int64)
    rfreq = np.bincount(r, minlength=256).astype(np.int64)
    bfreq = np.bincount(b, minlength=256).astype(np.int64)
    afreq = np.bincount(a, minlength=256).astype(np.int64)

    gl, gc = _write_tree(w, gfreq)
    rl, rc = _write_tree(w, rfreq)
    bl, bc = _write_tree(w, bfreq)
    al, ac = _write_tree(w, afreq)
    _write_tree(w, np.zeros(40, np.int64))   # distances: unused

    for i in range(len(g)):
        gi = int(g[i])
        if gl is not None and gl[gi]:
            w.write(_rev(int(gc[gi]), int(gl[gi])), int(gl[gi]))
        ri = int(r[i])
        if rl is not None and rl[ri]:
            w.write(_rev(int(rc[ri]), int(rl[ri])), int(rl[ri]))
        bi = int(b[i])
        if bl is not None and bl[bi]:
            w.write(_rev(int(bc[bi]), int(bl[bi])), int(bl[bi]))
        ai = int(a[i])
        if al is not None and al[ai]:
            w.write(_rev(int(ac[ai]), int(al[ai])), int(al[ai]))


def encode_vp8l(rgba: np.ndarray) -> bytes:
    """RGBA (h, w, 4) uint8 -> VP8L chunk payload."""
    h, wd = rgba.shape[:2]
    if wd > 16384 or h > 16384:
        raise ValueError("VP8L dimensions exceed 16384")
    argb = np.ascontiguousarray(rgba[..., [3, 0, 1, 2]])
    has_alpha = bool((rgba[..., 3] != 255).any())
    w = LsbWriter()
    w.write(wd - 1, 14)
    w.write(h - 1, 14)
    w.write(1 if has_alpha else 0, 1)
    w.write(0, 3)                # version
    encode_stream(w, argb)
    return b"\x2f" + w.bytes()


def encode_webp_lossless(rgba: np.ndarray) -> bytes:
    """RGBA -> complete lossless .webp file (RIFF/VP8L)."""
    payload = encode_vp8l(np.asarray(rgba))
    chunk = b"VP8L" + struct.pack("<I", len(payload)) + payload
    if len(payload) & 1:
        chunk += b"\x00"
    riff = b"WEBP" + chunk
    return b"RIFF" + struct.pack("<I", len(riff)) + riff
