"""Canonical Huffman coding (JPEG DHT convention).

Covers the reference's huffman component (coding/huffman.c:91-222,
312-364): table construction from the (count[16], symbols) DHT wire
format, decode via a single flat fast LUT, symbol encode, and a
frequency-scan tree builder for adaptive encoding.

Design difference from the reference: instead of an 8-bit first-level
LUT plus linear slow lists for 9-16 bit codes, we build one flat
``2**maxlen`` LUT mapping every possible ``maxlen``-bit prefix to
(symbol, code length). With JPEG's 16-bit cap that is at most 64K
entries — trivially cheap on the host and branch-free to decode. The
native C decoder uses the same construction.

Copied from ``ffpic_tpu/coding/huffman.py`` (``HuffmanTable``,
``HuffmanDecoder``, ``HuffmanEncoder``) for the PyTorch port, over the
port's ``utils/bitstream.py``.
"""

from __future__ import annotations

import numpy as np

from ffpic_tpu_torch.utils.bitstream import BitReader


class HuffmanTable:
    """Canonical table from DHT-style (counts per length 1..16, symbols)."""

    def __init__(self, counts, symbols):
        counts = list(counts)
        if len(counts) != 16:
            raise ValueError("need 16 length counts (codes of length 1..16)")
        symbols = list(symbols)
        if sum(counts) != len(symbols):
            raise ValueError("symbol count mismatch")
        self.counts = counts
        self.symbols = symbols

        # canonical code assignment (ITU-T81 Annex C)
        self.codes: list[tuple[int, int, int]] = []  # (code, length, symbol)
        code = 0
        k = 0
        self.maxlen = 0
        for bitlen in range(1, 17):
            for _ in range(counts[bitlen - 1]):
                self.codes.append((code, bitlen, symbols[k]))
                code += 1
                k += 1
                self.maxlen = bitlen
            code <<= 1

        # flat LUT: every maxlen-bit value whose prefix is a code maps to it
        n = 1 << self.maxlen if self.maxlen else 1
        self.lut_sym = np.full(n, -1, dtype=np.int16)
        self.lut_len = np.zeros(n, dtype=np.uint8)
        for c, l, s in self.codes:
            shift = self.maxlen - l
            base = c << shift
            self.lut_sym[base:base + (1 << shift)] = s
            self.lut_len[base:base + (1 << shift)] = l

    def encode_map(self) -> dict[int, tuple[int, int]]:
        """symbol -> (code, bitlen)"""
        return {s: (c, l) for c, l, s in self.codes}

    @classmethod
    def from_frequencies(cls, freqs: dict[int, int], max_len: int = 16):
        """Build a length-limited canonical table from symbol frequencies —
        the analog of the reference's ``huffman_scan_buff`` tree builder
        (coding/huffman.c:312-362), done the package-merge-lite way:
        plain Huffman then clamp lengths to ``max_len`` by demotion."""
        items = sorted(freqs.items())
        if not items:
            raise ValueError("no symbols")
        if len(items) == 1:
            sym = items[0][0]
            return cls([1] + [0] * 15, [sym])
        import heapq
        heap = [(f, i, (s,)) for i, (s, f) in enumerate(items)]
        heapq.heapify(heap)
        depth = {s: 0 for s, _ in items}
        uid = len(heap)
        while len(heap) > 1:
            f1, _, s1 = heapq.heappop(heap)
            f2, _, s2 = heapq.heappop(heap)
            for s in s1 + s2:
                depth[s] += 1
            heapq.heappush(heap, (f1 + f2, uid, s1 + s2))
            uid += 1
        # clamp overlong codes (rarely needed for JPEG-scale alphabets)
        for s in depth:
            depth[s] = min(depth[s], max_len)
        # re-normalize to a valid prefix set (Kraft sum <= 1)
        lens = sorted(depth.items(), key=lambda kv: (kv[1], kv[0]))
        while sum(2 ** (max_len - l) for _, l in lens) > (1 << max_len):
            for i in range(len(lens) - 1, -1, -1):
                if lens[i][1] < max_len:
                    lens[i] = (lens[i][0], lens[i][1] + 1)
                    break
        counts = [0] * 16
        symbols = []
        for s, l in lens:
            counts[l - 1] += 1
            symbols.append(s)
        return cls(counts, symbols)


class HuffmanDecoder:
    """Bit-reader-driven decoder (slow/reference path; native C is the
    production path)."""

    def __init__(self, reader: BitReader):
        self.reader = reader

    def decode_symbol(self, table: HuffmanTable) -> int:
        avail = min(table.maxlen, self.reader.bits_left())
        if avail <= 0:
            raise EOFError("bitstream exhausted")
        window = self.reader.peek_bits(avail) << (table.maxlen - avail)
        sym = int(table.lut_sym[window])
        length = int(table.lut_len[window])
        if sym < 0 or length > avail:
            raise ValueError("invalid huffman code")
        self.reader.skip_bits(length)
        return sym


class HuffmanEncoder:
    def __init__(self, writer):
        self.writer = writer

    def encode_symbol(self, table: HuffmanTable, symbol: int) -> None:
        code, bitlen = table.encode_map()[symbol]
        self.writer.write_bits(code, bitlen)
