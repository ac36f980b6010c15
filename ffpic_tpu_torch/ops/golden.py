"""Integer tables of the JPEG path and the numpy models of the
reference's transforms, colour and dequantisation.

Copied from ``ffpic_tpu/ops/golden.py`` (``IDCT_P13``, ``FDCT_P13``,
``ZIGZAG``, ``_wrap_i32``, ``_wrap_i16``, ``idct8x8_16``, ``fdct8x8``,
``vp8_idct4x4``, ``vp8_iwht4x4``, ``hevc_dst4x4``,
``yuv_to_bgra_planes``, ``dequant``; ``:74-208``), so that the port
does not import the JAX package.  The tests hold each copy against its
original.  The forward DCT itself is
``ops.jpeg_kernels.forward_dct`` (plain) and the ``fdct`` kernel.

* 13-bit 8x8 integer IDCT basis with libjpeg's off-by-one quirks, and
  the 13-bit forward DCT basis (``dct_1d_8`` with >>1, both passes >>13).
* ``ZIGZAG[k]``: the raster position of zigzag position k.
* ``vp8_idct4x4`` and ``vp8_iwht4x4``: VP8's 4x4 inverse DCT and
  inverse Walsh-Hadamard transform with in-place int16 semantics, the
  numpy oracle of ``ops.vp8_kernels``' plain versions.
* ``idct8x8_16``, ``fdct8x8``, ``hevc_dst4x4``, ``yuv_to_bgra_planes``
  and ``dequant``: the numpy mirrors of the reference C library's 8x8
  IDCT and FDCT, HEVC 4-point DST, 16-bit YUV to BGRA and JPEG
  dequantisation.
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


def idct8x8_16(blocks: np.ndarray) -> np.ndarray:
    """Exact mirror of idct_8x8_16 (utils/idct.c:512-534).

    blocks: (..., 8, 8) int array in raster order [y][x] (dequantized).
    Returns (..., 8, 8) int16 samples (level-shifted by +128, clamped
    to [0, 65535] then stored as int16 exactly like the C code).
    """
    x = blocks.astype(np.int64)
    # column pass: colbuf[i] = sum_u T[i,u] * in[u*8 + x]
    col = np.einsum("iu,...ux->...ix", IDCT_P13, x)
    col = _wrap_i32(col)  # C accumulates in 32-bit int
    col = _wrap_i16((col + (1 << 10)) >> 11)  # stored into int16 colidcts
    # row pass: rowbuf[i] = sum_u T[i,u] * colidcts[y*8 + u]
    row = np.einsum("iu,...yu->...yi", IDCT_P13, col.astype(np.int64))
    row = _wrap_i32(row)
    out = np.clip((row + (257 << 17)) >> 18, 0, 65535)
    return _wrap_i16(out)


def fdct8x8(blocks: np.ndarray) -> np.ndarray:
    """Exact mirror of fdct_8x8_8 (utils/idct.c:778-807).

    blocks: (..., 8, 8) int16 level-shifted samples (y-128).
    Row pass first (stride 1), then column pass, both (>>1 inner, >>13
    with rounding).
    """
    x = blocks.astype(np.int64)
    # dct_1d_8 over rows: out[i] = (sum_u D[i,u]*in[y,u]) >> 1
    row = np.einsum("iu,...yu->...yi", FDCT_P13, x) >> 1
    row = _wrap_i32(row)
    row = _wrap_i16((row + (1 << 12)) >> 13)
    col = np.einsum("iu,...ux->...ix", FDCT_P13, row.astype(np.int64)) >> 1
    col = _wrap_i32(col)
    return _wrap_i16((col + (1 << 12)) >> 13)




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


def hevc_dst4x4(blocks: np.ndarray, bitdepth: int = 8) -> np.ndarray:
    """HEVC 4-pt DST (utils/idct.c:9-55): two 1-D passes with clip3."""
    M = np.array([[29, 55, 74, 84],
                  [74, 74, 0, -74],
                  [84, -29, -74, 55],
                  [55, -84, 74, -29]], dtype=np.int64)
    bd_shift = max(20 - bitdepth, 0)
    lo, hi = -(1 << 15), (1 << 15) - 1

    def pass1d(vec, shift):
        # out[i] = clip3(lo, hi, (sum_j M[j][i]*in[j] + (shift-1)) >> shift)
        s = np.einsum("ji,...j->...i", M, vec)
        return np.clip((s + (shift - 1)) >> shift, lo, hi)

    x = blocks.astype(np.int64)
    # first pass: over columns, in[i + j*4] -> input vector along j (rows)
    e = pass1d(np.swapaxes(x, -1, -2), 7)       # e[i][:] per column i
    out = pass1d(np.swapaxes(e, -1, -2), bd_shift)
    return np.swapaxes(out, -1, -2).astype(np.int16)


def yuv_to_bgra_planes(yp, up, vp, samp_v: int, samp_h: int) -> np.ndarray:
    """Plane-level mirror of YUV_to_BGRA32_16bit (colorspace.c:133-172).

    yp: (H, W) int; up/vp: (ceil(H/v), ceil(W/h)) int (pre-offset by
    +128 as decoded). Returns (H, W, 4) uint8 BGRA. Float math in
    float64 with C truncation-toward-zero, as the C code does.
    """
    H, W = yp.shape
    yy = yp.astype(np.float64)
    uu = up.astype(np.float64) - 128.0
    vv = vp.astype(np.float64) - 128.0
    if samp_v != 1 or samp_h != 1:
        uu = np.repeat(np.repeat(uu, samp_v, axis=0), samp_h, axis=1)[:H, :W]
        vv = np.repeat(np.repeat(vv, samp_v, axis=0), samp_h, axis=1)[:H, :W]
    r = np.clip(np.trunc(yy + 1.280 * vv), 0, 255)
    g = np.clip(np.trunc(yy - 0.215 * uu - 0.381 * vv), 0, 255)
    b = np.clip(np.trunc(yy + 2.128 * uu), 0, 255)
    a = np.full_like(r, 255.0)
    return np.stack([b, g, r, a], axis=-1).astype(np.uint8)


def dequant(blocks: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """dequant_data_unit (format/jpg.c:247-253): int16 product wrap."""
    prod = blocks.astype(np.int64) * quant.astype(np.int64)
    return _wrap_i16(prod)
