"""DEFLATE/zlib decoder (RFC 1951/1950).

Component parity with the reference's coding/deflate.c:468-543 —
zlib header check (mod-31), stored/fixed/dynamic blocks, canonical
code-length tree decode, LZ77 window copies — with the Adler-32
verification the reference skips (deflate.c:475,501) actually
performed. This pure-Python implementation defines semantics and backs
the unit tests; production PNG decode uses CPython's zlib (C speed)
via utils.checksum/zlib, differentially tested against this.

Copied from ``ffpic_tpu/coding/deflate.py`` for the PyTorch port, over
the port's ``utils/bitstream.py`` and ``utils/checksum.py``: the port's
PNG decode inflates with zlib, and this module stays the oracle its
tests hold zlib against.
"""

from __future__ import annotations

from ffpic_tpu_torch.utils.bitstream import BitReader, LSB
from ffpic_tpu_torch.utils.checksum import adler32

LENGTH_BASE = [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31,
               35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258]
LENGTH_EXTRA = [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2,
                3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0]
DIST_BASE = [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193,
             257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145,
             8193, 12289, 16385, 24577]
DIST_EXTRA = [0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6,
              7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13]
CLEN_ORDER = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15]


class _Tree:
    """Canonical huffman decode table from per-symbol code lengths,
    decoded LSB-first (DEFLATE bit order: codes are read MSB-of-code
    first but packed LSB-first in bytes)."""

    def __init__(self, lengths):
        self.counts = [0] * 16
        for l in lengths:
            if l:
                self.counts[l] += 1
        # offsets per length
        offs = [0] * 16
        total = 0
        for l in range(1, 16):
            offs[l] = total
            total += self.counts[l]
        self.symbols = [0] * total
        pos = list(offs)
        for sym, l in enumerate(lengths):
            if l:
                self.symbols[pos[l]] = sym
                pos[l] += 1

    def decode(self, r: BitReader) -> int:
        code = 0
        first = 0
        index = 0
        for l in range(1, 16):
            code |= r.read_bit()
            count = self.counts[l]
            if code - first < count:
                return self.symbols[index + (code - first)]
            index += count
            first = (first + count) << 1
            code <<= 1
        raise ValueError("invalid huffman code in deflate stream")


FIXED_LIT = _Tree([8] * 144 + [9] * 112 + [7] * 24 + [8] * 8)
FIXED_DIST = _Tree([5] * 30)


def inflate_raw(r: BitReader, out: bytearray) -> None:
    while True:
        bfinal = r.read_bit()
        btype = r.read_bits(2)
        if btype == 0:                    # stored
            r.align_byte()
            ln = int.from_bytes(r.read_bytes(2), "little")
            nln = int.from_bytes(r.read_bytes(2), "little")
            if ln ^ 0xFFFF != nln:
                raise ValueError("stored block length mismatch")
            out += r.read_bytes(ln)
        else:
            if btype == 1:                # fixed trees
                lit, dist = FIXED_LIT, FIXED_DIST
            elif btype == 2:              # dynamic trees
                hlit = r.read_bits(5) + 257
                hdist = r.read_bits(5) + 1
                hclen = r.read_bits(4) + 4
                clen = [0] * 19
                for i in range(hclen):
                    clen[CLEN_ORDER[i]] = r.read_bits(3)
                ct = _Tree(clen)
                lens = []
                while len(lens) < hlit + hdist:
                    s = ct.decode(r)
                    if s < 16:
                        lens.append(s)
                    elif s == 16:
                        rep = 3 + r.read_bits(2)
                        lens += [lens[-1]] * rep
                    elif s == 17:
                        lens += [0] * (3 + r.read_bits(3))
                    else:
                        lens += [0] * (11 + r.read_bits(7))
                lit = _Tree(lens[:hlit])
                dist = _Tree(lens[hlit:])
            else:
                raise ValueError("invalid block type 3")
            while True:
                s = lit.decode(r)
                if s < 256:
                    out.append(s)
                elif s == 256:
                    break
                else:
                    s -= 257
                    length = LENGTH_BASE[s] + r.read_bits(LENGTH_EXTRA[s])
                    d = dist.decode(r)
                    distance = DIST_BASE[d] + r.read_bits(DIST_EXTRA[d])
                    if distance > len(out):
                        raise ValueError("distance beyond window")
                    for _ in range(length):   # may self-overlap
                        out.append(out[-distance])
        if bfinal:
            return


def inflate(data: bytes, verify_adler: bool = True) -> bytes:
    """zlib-wrapped inflate (RFC 1950)."""
    if len(data) < 6:
        raise ValueError("zlib stream too short")
    cmf, flg = data[0], data[1]
    if (cmf & 0xF) != 8:
        raise ValueError("not deflate")
    if (cmf * 256 + flg) % 31 != 0:
        raise ValueError("zlib header check failed")
    if flg & 0x20:
        raise ValueError("preset dictionary unsupported")
    r = BitReader(data[2:-4], LSB)
    out = bytearray()
    inflate_raw(r, out)
    if verify_adler:
        want = int.from_bytes(data[-4:], "big")
        got = adler32(bytes(out))
        if want != got:
            raise ValueError(f"adler32 mismatch {want:#x} != {got:#x}")
    return bytes(out)
