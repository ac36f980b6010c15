"""CABAC arithmetic *encoder* (ITU-T H.265 9.3.4) — the mirror of
coding/cabac.py's decoder.  The reference has no encoder at all
(coding/cabac.c is decode-only); this exists so the framework can
write HEVC streams (HEIF encode) and, critically, generate conformance
torture streams for the slice decoder's differential tests.

State per 9.3.4.3: ivlLow, ivlCurrRange, firstBitFlag, bitsOutstanding.
Output is MSB-first bits into a bytearray.

Copied from ``ffpic_tpu/coding/cabac_enc.py`` for the PyTorch port, with
its imports rewritten to the port's modules.
"""

from __future__ import annotations

from ffpic_tpu_torch.coding.cabac import LPS_TABLE, NEXT_STATE_LPS, \
    NEXT_STATE_MPS, ContextModel


class BitSink:
    """MSB-first bit accumulator."""

    __slots__ = ("buf", "cur", "nbits")

    def __init__(self):
        self.buf = bytearray()
        self.cur = 0
        self.nbits = 0

    def put(self, bit: int) -> None:
        self.cur = (self.cur << 1) | (bit & 1)
        self.nbits += 1
        if self.nbits == 8:
            self.buf.append(self.cur)
            self.cur = 0
            self.nbits = 0

    def put_bits(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.put((value >> i) & 1)

    def byte_align(self, bit: int = 0) -> None:
        while self.nbits:
            self.put(bit)

    def bytes(self) -> bytes:
        assert self.nbits == 0, "sink not byte-aligned"
        return bytes(self.buf)


class CabacEncoder:
    """Spec-formulation binary arithmetic encoder (9.3.4.3)."""

    def __init__(self, sink: BitSink | None = None):
        self.sink = sink or BitSink()
        self.low = 0
        self.range = 510
        self.first_bit = True
        self.outstanding = 0

    # -- 9.3.4.3.3 PutBit ----------------------------------------------
    def _put_bit(self, b: int) -> None:
        if self.first_bit:
            self.first_bit = False
        else:
            self.sink.put(b)
        while self.outstanding:
            self.sink.put(1 - b)
            self.outstanding -= 1

    # -- 9.3.4.3.2 RenormE ---------------------------------------------
    def _renorm(self) -> None:
        while self.range < 256:
            if self.low >= 512:
                self.low -= 512
                self._put_bit(1)
            elif self.low < 256:
                self._put_bit(0)
            else:
                self.low -= 256
                self.outstanding += 1
            self.range <<= 1
            self.low <<= 1

    # -- 9.3.4.3.1 EncodeDecision ----------------------------------------
    def decision(self, ctx: ContextModel, bin_val: int) -> None:
        q = (self.range >> 6) & 3
        lps = LPS_TABLE[ctx.state][q]
        self.range -= lps
        if bin_val != ctx.mps:
            self.low += self.range
            self.range = lps
            if ctx.state == 0:
                ctx.mps = 1 - ctx.mps
            ctx.state = NEXT_STATE_LPS[ctx.state]
        else:
            ctx.state = NEXT_STATE_MPS[ctx.state]
        self._renorm()

    # -- 9.3.4.3.4 EncodeBypass ------------------------------------------
    def bypass(self, bin_val: int) -> None:
        self.low <<= 1
        if bin_val:
            self.low += self.range
        if self.low >= 1024:
            self.low -= 1024
            self._put_bit(1)
        elif self.low < 512:
            self._put_bit(0)
        else:
            self.low -= 512
            self.outstanding += 1

    def bypass_n(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.bypass((value >> i) & 1)

    # -- 9.3.4.3.5 EncodeTerminate ----------------------------------------
    def terminate(self, bin_val: int) -> None:
        self.range -= 2
        if bin_val:
            self.low += self.range
            self._flush()
        else:
            self._renorm()

    def _flush(self) -> None:
        self.range = 2
        self._renorm()
        self._put_bit((self.low >> 9) & 1)
        self.sink.put_bits(((self.low >> 7) & 3) | 1, 2)

    # -- PCM bridge (9.3.1 mirror of cabac.py pcm_begin/end) -------------
    def pcm_begin(self) -> None:
        """After encoding pcm_flag=1 via terminate(1) (which flushed
        the codeword): alignment zero bits to the byte boundary; raw
        sample bits then go straight into the sink."""
        self.sink.byte_align(0)

    def write_raw(self, value: int, n: int) -> None:
        self.sink.put_bits(value, n)

    def pcm_end(self) -> None:
        """Restart the arithmetic codeword after pcm_sample (engine
        init as at slice start: first output bit suppressed, contexts
        kept)."""
        self.low = 0
        self.range = 510
        self.first_bit = True
        self.outstanding = 0

    # -- binarizations (mirrors of cabac.py 9.3.3) ------------------------
    def truncated_rice(self, value: int, c_max: int, rice: int,
                       ctx_fn=None, bypass_prefix: bool = False) -> None:
        max_pre = c_max >> rice
        prefix = value >> rice
        for i in range(min(prefix, max_pre)):
            if bypass_prefix or ctx_fn is None:
                self.bypass(1)
            else:
                self.decision(ctx_fn(i), 1)
        if prefix < max_pre:
            if bypass_prefix or ctx_fn is None:
                self.bypass(0)
            else:
                self.decision(ctx_fn(prefix), 0)
            if rice:
                self.bypass_n(value & ((1 << rice) - 1), rice)
        # saturated prefix: no terminating 0, no suffix (value == c_max)

    def egk(self, value: int, k: int) -> None:
        """EGk bypass binarization (9.3.3.3): unary prefix of length
        pre (ones, then zero), then (pre + k) suffix bits."""
        pre = 0
        while value >= (((1 << (pre + 1)) - 1) << k):
            pre += 1
        for _ in range(pre):
            self.bypass(1)
        self.bypass(0)
        rem = value - ((((1 << pre) - 1)) << k)
        if pre + k:
            self.bypass_n(rem, pre + k)

    def fixed_length(self, value: int, c_max: int) -> None:
        self.bypass_n(value, c_max.bit_length())

    def truncated_binary(self, value: int, c_max: int) -> None:
        n = c_max + 1
        k = n.bit_length() - 1
        u = (1 << (k + 1)) - n
        if value < u:
            self.bypass_n(value, k)
        else:
            self.bypass_n(value + u, k + 1)
