"""Integer tables of the JPEG path and the numpy models of VP8's 4x4
transforms.

Copied from ``ffpic_tpu/ops/golden.py`` (``IDCT_P13``, ``FDCT_P13``,
``ZIGZAG``, ``_wrap_i16``, ``vp8_idct4x4``, ``vp8_iwht4x4``), so that
the port does not import the JAX package.  The tests hold each copy
against its original.  The forward DCT itself is
``ops.jpeg_kernels.forward_dct`` (plain) and the ``fdct`` kernel.

* 13-bit 8x8 integer IDCT basis with libjpeg's off-by-one quirks, and
  the 13-bit forward DCT basis (``dct_1d_8`` with >>1, both passes >>13).
* ``ZIGZAG[k]``: the raster position of zigzag position k.
* ``vp8_idct4x4`` and ``vp8_iwht4x4``: VP8's 4x4 inverse DCT and
  inverse Walsh-Hadamard transform with in-place int16 semantics, the
  numpy oracle of ``ops.vp8_kernels``' plain versions.
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


def _wrap_i16(x):
    return (x.astype(np.int64) & 0xFFFF).astype(np.uint16).astype(np.int16)


def vp8_idct4x4(blocks: np.ndarray) -> np.ndarray:
    """Exact mirror of the VP8 4x4 IDCT (utils/idct.c:121-150),
    in-place int16 semantics; returns int16 (..., 4, 4) residuals."""
    inp = blocks.astype(np.int64)  # [..., y, x]
    c1, c2 = 20091, 35468
    # vertical pass over columns i (x index): in[r*4 + i]
    i0, i1, i2, i3 = inp[..., 0, :], inp[..., 1, :], inp[..., 2, :], inp[..., 3, :]
    a0 = i0 + i2
    a1 = i0 - i2
    a2 = ((i1 * c2) >> 16) - i3 - ((i3 * c1) >> 16)
    a3 = i1 + ((i1 * c1) >> 16) + ((i3 * c2) >> 16)
    t0 = _wrap_i16(a0 + a3)
    t3 = _wrap_i16(a0 - a3)
    t1 = _wrap_i16(a1 + a2)
    t2 = _wrap_i16(a1 - a2)
    tmp = np.stack([t0, t1, t2, t3], axis=-2).astype(np.int64)  # [..., r, i]
    # horizontal pass over rows
    j0, j1, j2, j3 = tmp[..., :, 0], tmp[..., :, 1], tmp[..., :, 2], tmp[..., :, 3]
    a0 = j0 + j2
    a1 = j0 - j2
    a2 = ((j1 * c2) >> 16) - j3 - ((j3 * c1) >> 16)
    a3 = j1 + ((j1 * c1) >> 16) + ((j3 * c2) >> 16)
    o0 = _wrap_i16((a0 + a3 + 4) >> 3)
    o3 = _wrap_i16((a0 - a3 + 4) >> 3)
    o1 = _wrap_i16((a1 + a2 + 4) >> 3)
    o2 = _wrap_i16((a1 - a2 + 4) >> 3)
    return np.stack([o0, o1, o2, o3], axis=-1)


def vp8_iwht4x4(blocks: np.ndarray) -> np.ndarray:
    """VP8 inverse Walsh-Hadamard for the Y2 DC block
    (format/webp.c:1067-1096, IWHT_long path)."""
    inp = blocks.astype(np.int64)
    i0, i1, i2, i3 = inp[..., 0, :], inp[..., 1, :], inp[..., 2, :], inp[..., 3, :]
    a1 = i0 + i3
    b1 = i1 + i2
    c1 = i1 - i2
    d1 = i0 - i3
    tmp = np.stack([a1 + b1, c1 + d1, a1 - b1, d1 - c1], axis=-2)
    j0, j1, j2, j3 = tmp[..., :, 0], tmp[..., :, 1], tmp[..., :, 2], tmp[..., :, 3]
    a1 = j0 + j3
    b1 = j1 + j2
    c1 = j1 - j2
    d1 = j0 - j3
    a2 = a1 + b1 + 3
    b2 = c1 + d1
    c2 = a1 - b1
    d2 = d1 - c1
    out = np.stack([(a2 + 0) >> 3, (b2 + 3) >> 3, (c2 + 3) >> 3, (d2 + 3) >> 3],
                   axis=-1)
    return _wrap_i16(out)
