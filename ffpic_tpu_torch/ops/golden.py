"""Integer tables and the numpy forward DCT of the JPEG path.

Copied from ``ffpic_tpu/ops/golden.py`` (``IDCT_P13``, ``FDCT_P13``,
``ZIGZAG``, ``_wrap_i32``, ``_wrap_i16`` and ``fdct8x8``), so that the
port does not import the JAX package.  The tests hold each copy against
its original.

* 13-bit 8x8 integer IDCT basis with libjpeg's off-by-one quirks, and
  the 13-bit forward DCT basis (``dct_1d_8`` with >>1, both passes >>13).
* ``ZIGZAG[k]``: the raster position of zigzag position k.
"""

from __future__ import annotations

import numpy as np

IDCT_P13 = np.array([
    [8192, 11363, 10703, 9633, 8192, 6437, 4433, 2260],
    [8192, 9633, 4433, -2259, -8192, -11362, -10704, -6436],
    [8192, 6437, -4433, -11362, -8192, 2261, 10704, 9633],
    [8192, 2260, -10703, -6436, 8192, 9633, -4433, -11363],
    [8192, -2260, -10703, 6436, 8192, -9633, -4433, 11363],
    [8192, -6437, -4433, 11362, -8192, -2261, 10704, -9633],
    [8192, -9633, 4433, 2259, -8192, 11362, -10704, 6436],
    [8192, -11363, 10703, -9633, 8192, -6437, 4433, -2260],
], dtype=np.int64)

FDCT_P13 = np.array([
    [5792, 5792, 5792, 5792, 5792, 5792, 5792, 5792],
    [8034, 6811, 4551, 1598, -1598, -4551, -6811, -8034],
    [7568, 3134, -3134, -7568, -7568, -3134, 3134, 7568],
    [6811, -1598, -8034, -4551, 4551, 8034, 1598, -6811],
    [5792, -5792, -5792, 5792, 5792, -5792, -5792, 5792],
    [4551, -8034, 1598, 6811, -6811, -1598, 8034, -4551],
    [3134, -7568, 7568, -3134, -3134, 7568, -7568, 3134],
    [1598, -4551, 6811, -8034, 8034, -6811, 4551, -1598],
], dtype=np.int64)

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10,
    17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int32)


def _wrap_i32(x):
    return (x.astype(np.int64) & 0xFFFFFFFF).astype(np.uint32).astype(np.int32)


def _wrap_i16(x):
    return (x.astype(np.int64) & 0xFFFF).astype(np.uint16).astype(np.int16)


def fdct8x8(blocks: np.ndarray) -> np.ndarray:
    """13-bit forward DCT of (..., 8, 8) int16 level-shifted samples
    (y - 128): row pass first, then column pass, each (>>1 inner, >>13
    with rounding), int32 sums wrapping and int16 between the passes."""
    x = blocks.astype(np.int64)
    row = np.einsum("iu,...yu->...yi", FDCT_P13, x) >> 1
    row = _wrap_i32(row)
    row = _wrap_i16((row + (1 << 12)) >> 13)
    col = np.einsum("iu,...ux->...ix", FDCT_P13, row.astype(np.int64)) >> 1
    col = _wrap_i32(col)
    return _wrap_i16((col + (1 << 12)) >> 13)
