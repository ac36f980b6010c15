"""CRC-32 and Adler-32 of the port.

Copied from ``ffpic_tpu/utils/checksum.py:15-22`` (``crc32``,
``adler32``): both delegate to the C implementations in Python's
``zlib``.
"""

from __future__ import annotations

import zlib


def crc32(data: bytes, crc: int = 0) -> int:
    """CRC-32 (IEEE 802.3 polynomial, reflected) as used by PNG."""
    return zlib.crc32(data, crc) & 0xFFFFFFFF


def adler32(data: bytes, value: int = 1) -> int:
    """Adler-32 as used by zlib streams."""
    return zlib.adler32(data, value) & 0xFFFFFFFF
