"""AV1 multi-symbol arithmetic ENCODER (daala od_ec formulation) —
the exact pair of coding/av1_msac.py's decoder.

The C reference (junka/ffpic) has no AV1 support at all; this encoder
exists to (a) emit AVIF output (`transcode -c avif`), and (b)
manufacture conformance streams our image lacks encoders for (10-bit
AV1 in particular) so the decoder's 10-bit paths get a dav1d
cross-check.  Validation: symbol-level roundtrip vs the Msac decoder
plus end-to-end dav1d decodes of full streams
(tests/test_av1_enc.py).

Carry handling follows libaom's entenc (precarry 16-bit slots,
carries resolved in one reverse pass at done()); the probability
arithmetic mirrors the decoder exactly (EC_PROB_SHIFT/EC_MIN_PROB
terms), and the adaptive CDF update is the same rule the decoder
applies, so encoder and decoder CDFs stay in lockstep.

Copied from ``ffpic_tpu/coding/av1_msac_enc.py`` for the PyTorch port
unchanged.
"""
from __future__ import annotations

EC_PROB_SHIFT = 6
EC_MIN_PROB = 4


class MsacEnc:
    __slots__ = ("low", "rng", "cnt", "pre", "allow_update")

    def __init__(self, allow_update: bool = True):
        self.low = 0
        self.rng = 0x8000
        self.cnt = -9
        self.pre = []            # precarry 16-bit slots
        self.allow_update = allow_update

    # ---------------------------------------------------- primitives
    def _normalize(self, low, rng):
        d = 16 - rng.bit_length()
        c = self.cnt
        s = c + d
        if s >= 0:
            c += 16
            m = (1 << c) - 1
            if s >= 8:
                self.pre.append((low >> c) & 0xFFFF)
                low &= m
                c -= 8
                m >>= 8
            self.pre.append((low >> c) & 0xFFFF)
            s = c + d - 24
            low &= m
        self.low = low << d
        self.rng = rng << d
        self.cnt = s

    def _encode_q15(self, fl, fh, s, n):
        l = self.low
        r = self.rng
        N = n - 1
        if fl < 32768:
            u = (((r >> 8) * (fl >> EC_PROB_SHIFT)) >> 1) \
                + EC_MIN_PROB * (N - (s - 1))
            v = (((r >> 8) * (fh >> EC_PROB_SHIFT)) >> 1) \
                + EC_MIN_PROB * (N - s)
            l += r - u
            r = u - v
        else:
            v = (((r >> 8) * (fh >> EC_PROB_SHIFT)) >> 1) \
                + EC_MIN_PROB * (N - s)
            r -= v
        self._normalize(l, r)

    # ------------------------------------------------------- symbols
    def encode_symbol(self, cdf, sym: int):
        """Adaptive multi-symbol encode over a decoder-layout cdf
        ([p0..pn-2, 0, counter], inverted probs)."""
        n = len(cdf) - 1
        fl = 32768 if sym == 0 else int(cdf[sym - 1])
        fh = 0 if sym == n - 1 else int(cdf[sym])
        self._encode_q15(fl, fh, sym, n)
        if self.allow_update:
            count = cdf[n]
            rate = 3 + (count > 15) + (count > 31) + \
                (1 if n < 4 else 2)
            for i in range(n - 1):
                if i < sym:
                    cdf[i] += (32768 - cdf[i]) >> rate
                else:
                    cdf[i] -= cdf[i] >> rate
            cdf[n] = count + (count < 32)

    def encode_bool(self, bit: int, f: int = 1 << 14):
        """Non-adapting bool with 15-bit probability f of ZERO."""
        l = self.low
        r = self.rng
        v = (((r >> 8) * (f >> EC_PROB_SHIFT)) >> 1) + EC_MIN_PROB
        if bit:
            r_new = v
            l += r - v
        else:
            r_new = r - v
        self._normalize(l, r_new)

    def encode_literal(self, v: int, n: int):
        for i in range(n - 1, -1, -1):
            self.encode_bool((v >> i) & 1)

    def encode_golomb(self, v: int):
        """Pair of av1_msac.decode_golomb (31-run capped exp-golomb
        over bool-equi bits)."""
        x = v + 1
        length = x.bit_length() - 1
        for _ in range(length):
            self.encode_bool(0)
        self.encode_bool(1)
        for i in range(length - 1, -1, -1):
            self.encode_bool((x >> i) & 1)

    def encode_ns(self, v: int, n: int):
        """ns(n) literal (spec 4.10.7)."""
        w = n.bit_length()
        m = (1 << w) - n
        if v < m:
            if w > 1:
                self.encode_literal(v, w - 1)
        else:
            x = v + m
            self.encode_literal(x >> 1, w - 1)
            self.encode_bool(x & 1)

    # ---------------------------------------------------------- done
    def done(self) -> bytes:
        """Flush (libaom od_ec_enc_done): round low up to a 0x4000
        boundary, emit the tail, then resolve carries."""
        l = self.low
        c = self.cnt
        s = 10 + c
        m = 0x3FFF
        e = ((l + m) & ~m) | (m + 1)
        if s > 0:
            n = (1 << (c + 16)) - 1
            while True:
                self.pre.append((e >> (c + 16)) & 0xFFFF)
                e &= n
                s -= 8
                c -= 8
                n >>= 8
                if s <= 0:
                    break
        out = bytearray(len(self.pre))
        carry = 0
        for i in range(len(self.pre) - 1, -1, -1):
            v = self.pre[i] + carry
            out[i] = v & 0xFF
            carry = v >> 8
        return bytes(out)
