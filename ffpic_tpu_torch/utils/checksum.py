"""CRC-32 and Adler-32 of the port.

Copied from ``ffpic_tpu/utils/checksum.py`` whole: ``crc32`` and
``adler32`` delegate to the C implementations in Python's ``zlib``;
``crc32_py`` and ``adler32_py`` are the pure-Python references the
tests hold them against (``checksum.py:40,47``).
"""

from __future__ import annotations

import zlib


def crc32(data: bytes, crc: int = 0) -> int:
    """CRC-32 (IEEE 802.3 polynomial, reflected) as used by PNG."""
    return zlib.crc32(data, crc) & 0xFFFFFFFF


def adler32(data: bytes, value: int = 1) -> int:
    """Adler-32 as used by zlib streams."""
    return zlib.adler32(data, value) & 0xFFFFFFFF


# -- pure-python references (differentially tested against zlib) ---------

def _make_crc_table() -> list[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (0xEDB88320 ^ (c >> 1)) if (c & 1) else (c >> 1)
        table.append(c)
    return table


_CRC_TABLE = _make_crc_table()


def crc32_py(data: bytes, crc: int = 0) -> int:
    c = crc ^ 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def adler32_py(data: bytes, value: int = 1) -> int:
    MOD = 65521
    a = value & 0xFFFF
    b = (value >> 16) & 0xFFFF
    for byte in data:
        a = (a + byte) % MOD
        b = (b + a) % MOD
    return (b << 16) | a
