"""Bit-granular readers/writers for the host entropy stages.

Mirrors the semantics of the reference's ``bits_vec`` reader/writer
(reference: utils/bitstream.h:12-72, utils/bitstream.c):

* MSB-first order — JPEG Huffman, PNG/Exp-Golomb style codes.
* LSB-first order — DEFLATE, GIF-LZW, VP8 headers.
* ``step_back`` support (the JPEG Huffman slow path relies on it,
  reference coding/huffman.c:199).
* Byte alignment and EOF checks.
* A growable writer with optional JPEG 0xFF byte-stuffing
  (reference utils/bitstream.c:236-268).

These are host-side utilities; hot decode paths use the native module in
``ffpic_tpu/native`` instead.

Copied from ``ffpic_tpu/utils/bitstream.py`` for the PyTorch port, with
its imports rewritten to the port's modules.
"""

from __future__ import annotations

MSB = 0  # most significant bit first (JPEG Huffman)
LSB = 1  # least significant bit first (DEFLATE, LZW-GIF)


class BitReader:
    """Bit reader over a bytes-like buffer.

    Positions are tracked as an absolute bit offset, so ``step_back`` and
    re-init behave exactly like the reference's cursor/offset pair.
    """

    __slots__ = ("data", "order", "bitpos", "nbits")

    def __init__(self, data, order: int = MSB):
        self.data = bytes(data)
        self.order = order
        self.bitpos = 0
        self.nbits = 8 * len(self.data)

    # -- queries ----------------------------------------------------------
    def eof(self) -> bool:
        return self.bitpos >= self.nbits

    def bits_left(self) -> int:
        return self.nbits - self.bitpos

    def byte_aligned(self) -> bool:
        return (self.bitpos & 7) == 0

    @property
    def byte_offset(self) -> int:
        return self.bitpos >> 3

    # -- reads ------------------------------------------------------------
    def read_bit(self) -> int:
        if self.bitpos >= self.nbits:
            raise EOFError("bitstream exhausted")
        byte = self.data[self.bitpos >> 3]
        off = self.bitpos & 7
        self.bitpos += 1
        if self.order == MSB:
            return (byte >> (7 - off)) & 1
        return (byte >> off) & 1

    def read_bits(self, n: int) -> int:
        """Read ``n`` bits as an unsigned integer.

        MSB order: first bit read is the most significant of the result.
        LSB order: first bit read is the least significant of the result
        (DEFLATE convention).
        """
        if n == 0:
            return 0
        if self.bitpos + n > self.nbits:
            raise EOFError("bitstream exhausted")
        v = 0
        if self.order == MSB:
            for _ in range(n):
                byte = self.data[self.bitpos >> 3]
                off = self.bitpos & 7
                v = (v << 1) | ((byte >> (7 - off)) & 1)
                self.bitpos += 1
        else:
            for i in range(n):
                byte = self.data[self.bitpos >> 3]
                off = self.bitpos & 7
                v |= ((byte >> off) & 1) << i
                self.bitpos += 1
        return v

    def peek_bits(self, n: int) -> int:
        pos = self.bitpos
        try:
            return self.read_bits(n)
        finally:
            self.bitpos = pos

    def skip_bits(self, n: int) -> None:
        self.bitpos += n

    def step_back(self, n: int = 1) -> None:
        if self.bitpos - n < 0:
            raise ValueError("cannot step back past start")
        self.bitpos -= n

    def align_byte(self) -> None:
        self.bitpos = (self.bitpos + 7) & ~7

    def reset(self, bit_offset: int = 0) -> None:
        self.bitpos = bit_offset

    def read_bytes(self, n: int) -> bytes:
        """Byte-aligned raw read."""
        self.align_byte()
        start = self.bitpos >> 3
        if start + n > len(self.data):
            raise EOFError("bitstream exhausted")
        self.bitpos += 8 * n
        return self.data[start:start + n]


class BitWriter:
    """Growable bit writer.

    ``stuff_jpeg=True`` inserts a 0x00 after every emitted 0xFF byte, the
    JPEG entropy-stream convention (reference utils/bitstream.c:236-268).
    """

    __slots__ = ("buf", "order", "cur", "curbits", "stuff_jpeg")

    def __init__(self, order: int = MSB, stuff_jpeg: bool = False):
        self.buf = bytearray()
        self.order = order
        self.cur = 0
        self.curbits = 0
        self.stuff_jpeg = stuff_jpeg

    def _emit(self, byte: int) -> None:
        self.buf.append(byte)
        if self.stuff_jpeg and byte == 0xFF:
            self.buf.append(0x00)

    def write_bit(self, b: int) -> None:
        if self.order == MSB:
            self.cur = (self.cur << 1) | (b & 1)
        else:
            self.cur |= (b & 1) << self.curbits
        self.curbits += 1
        if self.curbits == 8:
            self._emit(self.cur)
            self.cur = 0
            self.curbits = 0

    def write_bits(self, value: int, n: int) -> None:
        if self.order == MSB:
            for i in range(n - 1, -1, -1):
                self.write_bit((value >> i) & 1)
        else:
            for i in range(n):
                self.write_bit((value >> i) & 1)

    def align_byte(self, fill: int = 1) -> None:
        """Pad to a byte boundary. JPEG pads with 1-bits."""
        while self.curbits:
            self.write_bit(fill)

    def getvalue(self) -> bytes:
        if self.curbits:
            raise ValueError("unaligned bits pending; call align_byte()")
        return bytes(self.buf)

    def __len__(self) -> int:
        return len(self.buf)
