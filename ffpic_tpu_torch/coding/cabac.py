"""HEVC CABAC arithmetic decoder (ITU-T H.265 section 9.3).

Component parity with the reference's coding/cabac.c engine: 64-state
MPS/LPS transition tables, 64x4 LPS range table, decision/bypass/
terminate decodes, and the TR / EGk / FL / TB binarizations. Context
model *tables* (the ~200 initValues per slice initType) ship with the
HEVC slice decoder; this module provides the engine plus per-context
state init from (initValue, qp) per spec 9.3.2.2.

Differentially tested bin-for-bin against the reference C decoder
(tests/test_cabac.py builds a harness over refbuild/libffpic.a).

Copied from ``ffpic_tpu/coding/cabac.py`` for the PyTorch port, with its
imports rewritten to the port's modules.
"""

from __future__ import annotations

from ffpic_tpu_torch.utils.bitstream import BitReader

# H.265 Table 9-53 (state transitions)
NEXT_STATE_MPS = [
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
    33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48,
    49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 62, 63,
]
NEXT_STATE_LPS = [
    0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12,
    13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24,
    24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
    33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63,
]
# H.265 Table 9-52 (LPS range by state and range quartile)
LPS_TABLE = [
    (128, 176, 208, 240), (128, 167, 197, 227), (128, 158, 187, 216),
    (123, 150, 178, 205), (116, 142, 169, 195), (111, 135, 160, 185),
    (105, 128, 152, 175), (100, 122, 144, 166), (95, 116, 137, 158),
    (90, 110, 130, 150), (85, 104, 123, 142), (81, 99, 117, 135),
    (77, 94, 111, 128), (73, 89, 105, 122), (69, 85, 100, 116),
    (66, 80, 95, 110), (62, 76, 90, 104), (59, 72, 86, 99),
    (56, 69, 81, 94), (53, 65, 77, 89), (51, 62, 73, 85),
    (48, 59, 69, 80), (46, 56, 66, 76), (43, 53, 63, 72),
    (41, 50, 59, 69), (39, 48, 56, 65), (37, 45, 54, 62),
    (35, 43, 51, 59), (33, 41, 48, 56), (32, 39, 46, 53),
    (30, 37, 43, 50), (29, 35, 41, 48), (27, 33, 39, 45),
    (26, 31, 37, 43), (24, 30, 35, 41), (23, 28, 33, 39),
    (22, 27, 32, 37), (21, 26, 30, 35), (20, 24, 29, 33),
    (19, 23, 27, 31), (18, 22, 26, 30), (17, 21, 25, 28),
    (16, 20, 23, 27), (15, 19, 22, 25), (14, 18, 21, 24),
    (14, 17, 20, 23), (13, 16, 19, 22), (12, 15, 18, 21),
    (12, 14, 17, 20), (11, 14, 16, 19), (11, 13, 15, 18),
    (10, 12, 15, 17), (10, 12, 14, 16), (9, 11, 13, 15),
    (9, 11, 12, 14), (8, 10, 12, 14), (8, 9, 11, 13),
    (7, 9, 11, 12), (7, 9, 10, 12), (7, 8, 10, 11),
    (6, 8, 9, 11), (6, 7, 9, 10), (6, 7, 8, 9),
    (2, 2, 2, 2),
]


class ContextModel:
    """(pStateIdx, valMPS), initialized per H.265 9.3.2.2."""

    __slots__ = ("state", "mps")

    def __init__(self, init_value: int = 154, qp: int = 26):
        slope = (init_value >> 4) * 5 - 45
        offset = ((init_value & 15) << 3) - 16
        pre = min(max(((slope * min(max(qp, 0), 51)) >> 4) + offset, 1), 126)
        self.mps = 1 if pre > 63 else 0
        self.state = (pre - 64) if self.mps else (63 - pre)


class CabacDecoder:
    """Spec-formulation engine: 9-bit ivlCurrRange / ivlOffset."""

    def __init__(self, reader: BitReader):
        self.r = reader
        self.range = 510
        self.offset = reader.read_bits(9)

    def _renorm(self):
        while self.range < 256:
            self.range <<= 1
            bit = self.r.read_bit() if not self.r.eof() else 0
            self.offset = ((self.offset << 1) | bit) & 0xFFFF

    def decision(self, ctx: ContextModel) -> int:
        q = (self.range >> 6) & 3
        lps = LPS_TABLE[ctx.state][q]
        self.range -= lps
        if self.offset >= self.range:
            bin_val = 1 - ctx.mps
            self.offset -= self.range
            self.range = lps
            if ctx.state == 0:
                ctx.mps = 1 - ctx.mps
            ctx.state = NEXT_STATE_LPS[ctx.state]
        else:
            bin_val = ctx.mps
            ctx.state = NEXT_STATE_MPS[ctx.state]
        self._renorm()
        return bin_val

    def bypass(self) -> int:
        bit = self.r.read_bit() if not self.r.eof() else 0
        self.offset = ((self.offset << 1) | bit) & 0xFFFF
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def bypass_n(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bypass()
        return v

    def terminate(self) -> int:
        self.range -= 2
        if self.offset >= self.range:
            return 1
        self._renorm()
        return 0

    # -- PCM bridge (9.3.1 / 9.3.2.6) -----------------------------------
    def pcm_begin(self) -> None:
        """After a terminating pcm_flag bin: in this spec-formulation
        engine the reader's position already equals the encoder's
        post-flush position (9-bit init lookahead == flush output +
        suppressed first bit), so only the pcm_alignment_zero_bit
        skipping remains."""
        while not self.r.byte_aligned():
            self.r.read_bit()            # pcm_alignment_zero_bit

    def read_raw(self, n: int) -> int:
        """u(n) PCM sample bits, straight from the bitstream."""
        return self.r.read_bits(n)

    def pcm_end(self) -> None:
        """Re-initialize the arithmetic engine after pcm_sample
        (9.3.1: contexts are NOT reset)."""
        self.range = 510
        self.offset = self.r.read_bits(9)

    # -- binarizations (9.3.3) -----------------------------------------
    def fixed_length(self, c_max: int) -> int:
        """FL binarization (9.3.3.5): cLen = ceil(log2(cMax + 1))."""
        n = (c_max).bit_length()  # == ceil(log2(cMax+1)) for cMax >= 1
        return self.bypass_n(n)

    def truncated_binary(self, c_max: int) -> int:
        """TB binarization (9.3.3.6)."""
        n = c_max + 1
        k = n.bit_length() - 1
        u = (1 << (k + 1)) - n
        v = self.bypass_n(k)
        if v >= u:
            v = (v << 1) | self.bypass()
            v -= u
        return v

    def truncated_rice(self, c_max: int, rice: int,
                       ctx_fn=None, bypass_prefix: bool = False) -> int:
        """TR binarization (9.3.3.2): unary prefix (context-coded or
        bypass) + rice-bit suffix."""
        prefix = 0
        max_pre = c_max >> rice
        while prefix < max_pre:
            if bypass_prefix or ctx_fn is None:
                b = self.bypass()
            else:
                b = self.decision(ctx_fn(prefix))
            if not b:
                break
            prefix += 1
        value = prefix << rice
        # H.265 9.3.3.2: the FL suffix is present only when cMax >
        # symbolVal, i.e. decoder-side: when the unary prefix did NOT
        # saturate.  A saturated prefix means symbolVal == cMax exactly.
        if rice and prefix < max_pre:
            value += self.bypass_n(rice)
        elif rice:
            value = c_max
        return value

    def exp_golomb_k(self, k: int, max_pre_len: int = 32) -> int:
        """EGk bypass binarization (9.3.3.3)."""
        pre = 0
        while pre < max_pre_len and self.bypass():
            pre += 1
        length = pre + k
        value = ((1 << pre) - 1) << k
        if length:
            value += self.bypass_n(length)
        return value
