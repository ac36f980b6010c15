"""Utilities of the port.

Exports the names of ``ffpic_tpu/utils/__init__.py:1-5``.
"""

from ffpic_tpu_torch.utils.bitstream import BitReader, BitWriter
from ffpic_tpu_torch.utils.checksum import adler32, crc32
from ffpic_tpu_torch.utils.vlog import get_logger

__all__ = ["BitReader", "BitWriter", "crc32", "adler32", "get_logger"]
