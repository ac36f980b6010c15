"""VP8 boolean (arithmetic) decoder, RFC 6386 section 7.

Copied from ``ffpic_tpu/coding/booldec.py`` (``BoolDecoder``): the RFC
reference formulation with a 16-bit value window, range renormalised
into [128, 255], literal and signed reads and int8-tree walks.  It
parses the VP8 frame header; the native decoder (``native/host_vp8.c``)
resumes its state for the coefficient probabilities, the macroblock
headers and the token partitions.
"""

from __future__ import annotations


class BoolDecoder:
    __slots__ = ("data", "pos", "value", "range", "bit_count")

    def __init__(self, data: bytes):
        self.data = data
        b0 = data[0] if len(data) > 0 else 0
        b1 = data[1] if len(data) > 1 else 0
        self.value = (b0 << 8) | b1
        self.pos = 2
        self.range = 255
        self.bit_count = 0

    def get_bool(self, prob) -> int:
        split = 1 + (((self.range - 1) * int(prob)) >> 8)
        big = split << 8
        if self.value >= big:
            ret = 1
            self.range -= split
            self.value -= big
        else:
            ret = 0
            self.range = split
        while self.range < 128:
            self.value <<= 1
            self.range <<= 1
            self.bit_count += 1
            if self.bit_count == 8:
                self.bit_count = 0
                nb = self.data[self.pos] if self.pos < len(self.data) else 0
                self.value |= nb
                self.pos += 1
        return ret

    def get_bit(self) -> int:
        return self.get_bool(128)

    def get_literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.get_bool(128)
        return v

    def get_signed(self, n: int) -> int:
        """n-bit magnitude followed by sign bit (RFC 6386 9.3)."""
        v = self.get_literal(n)
        return -v if self.get_bool(128) else v

    def maybe_get_signed(self, n: int) -> int:
        """flagged update: 1 bit presence, then signed value (9.3)."""
        return self.get_signed(n) if self.get_bool(128) else 0

    def get_tree(self, tree, probs, start: int = 0) -> int:
        """Walk an int8 token tree: positive entries are child indices,
        -v entries are leaves for symbol v (coding/booldec.c:162-169)."""
        i = start
        while True:
            i = tree[i + self.get_bool(probs[i >> 1])]
            if i <= 0:
                return -i
