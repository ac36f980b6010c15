"""HEVC (ITU-T H.265) spec constants and derived tables for the slice
decoder: transform matrices, scan orders, significance-context maps,
quantization scales, intra angle tables, deblocking thresholds, chroma
QP mapping.

Everything here is an H.265 protocol constant (cited to the spec
section) — generated programmatically where the spec's tables have
closed form (the DCT matrix folds onto 33 base cosines), embedded
otherwise.  Reference parity anchors: the transform matrix equals the
table the reference embeds at coding/hevc.c:3826-3859 (asserted by
tests/test_hevc_transforms.py), the scan orders match hevc.c:2580-2658.

Copied from ``ffpic_tpu/coding/hevc_consts.py`` for the PyTorch port,
with its imports rewritten to the port's modules.
"""

from __future__ import annotations

import functools

import numpy as np

# --- transform matrices (8.6.4.2) -----------------------------------------

# Base cosine column of the 32-point integer DCT: entry j approximates
# 64*sqrt(2)*cos(j*pi/64) with the spec's hand-tuned integers (j=0 is
# the DC basis 64).  All 1024 entries of transMatrixCol fold onto these
# 33 values via cos symmetry.
_DCT_BASE = (64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73,
             70, 67, 64, 61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22,
             18, 13, 9, 4, 0)

# 4-point DST-VII used for 4x4 intra luma residuals (8.6.4.2 eq. 8-303)
DST4 = np.array([[29, 55, 74, 84],
                 [74, 74, 0, -74],
                 [84, -29, -74, 55],
                 [55, -84, 74, -29]], dtype=np.int32)


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """N-point rows of the HEVC integer DCT (N in 4/8/16/32); row k,
    col i equals transMatrixCol[k * (32/N)][i] of the 32x32 spec table."""
    assert n in (4, 8, 16, 32)
    m = np.empty((n, n), dtype=np.int32)
    step = 32 // n
    for row in range(n):
        k = row * step
        for col in range(n):
            if k == 0:
                m[row, col] = 64
                continue
            a = (k * (2 * col + 1)) % 128
            if a > 64:
                a = 128 - a            # cos(a*pi/64) == cos((128-a)*pi/64)
            if a > 32:
                m[row, col] = -_DCT_BASE[64 - a]
            else:
                m[row, col] = _DCT_BASE[a]
    m.setflags(write=False)
    return m


# --- quantization (8.6.3) ---------------------------------------------------

LEVEL_SCALE = (40, 45, 51, 57, 64, 72)      # levelScale[qP % 6]

# Chroma QP mapping for 4:2:0 (Table 8-10): qPi 30..43 -> qPc; outside
# that range qPc = qPi (clamped at 51 via qPi-6 ... handled in code).
CHROMA_QP_TABLE = (29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37)


def chroma_qp(qp_i: int) -> int:
    """qPc from qPi per Table 8-10 (4:2:0)."""
    if qp_i < 30:
        return qp_i
    if qp_i > 43:
        return qp_i - 6
    return CHROMA_QP_TABLE[qp_i - 30]


# --- scan orders (6.5.3-6.5.5) ----------------------------------------------

@functools.lru_cache(maxsize=None)
def scan_order(log2_size: int, idx: int) -> np.ndarray:
    """ScanOrder[log2_size][idx] as an (N*N, 2) array of (x, y).

    idx: 0 = up-right diagonal (6.5.3), 1 = horizontal (6.5.4),
    2 = vertical (6.5.5).  Used both for coefficient positions inside a
    sub-block (log2_size=2) and for sub-block positions in a TB.
    """
    n = 1 << log2_size
    pos = []
    if idx == 0:
        i = 0
        x = y = 0
        while i < n * n:
            while y >= 0:
                if x < n and y < n:
                    pos.append((x, y))
                    i += 1
                y -= 1
                x += 1
            y = x
            x = 0
    elif idx == 1:
        for y in range(n):
            for x in range(n):
                pos.append((x, y))
    else:
        for x in range(n):
            for y in range(n):
                pos.append((x, y))
    a = np.array(pos, dtype=np.int32)
    a.setflags(write=False)
    return a


# --- sig_coeff_flag context maps (9.3.4.2.5) --------------------------------

# ctxIdxMap for 4x4 TBs (Table 9-39), indexed by (y << 2) + x
SIG_CTX_4X4 = (0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8)


# --- intra prediction (8.4.4.2.6) -------------------------------------------

# intraPredAngle by predModeIntra 2..34 (Table 8-5)
INTRA_PRED_ANGLE = (32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13,
                    -17, -21, -26, -32, -26, -21, -17, -13, -9, -5, -2,
                    0, 2, 5, 9, 13, 17, 21, 26, 32)

# invAngle for predModeIntra 11..25 (Table 8-6): 8192 / intraPredAngle
INV_ANGLE = (-4096, -1638, -910, -630, -482, -390, -315, -256, -315,
             -390, -482, -630, -910, -1638, -4096)


# --- deblocking filter (8.7.2, Table 8-12) ----------------------------------

BETA_TABLE = (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 6, 7, 8,
              9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28,
              30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56, 58,
              60, 62, 64)

TC_TABLE = (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
            1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5,
            6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24)


# --- golden (bit-exact) transform path (8.6.2-8.6.4) ------------------------

def dequant(levels: np.ndarray, qp: int, bit_depth: int = 8,
            scaling: np.ndarray | None = None) -> np.ndarray:
    """Scaling process for transform coefficients (8.6.3).

    levels: (n, n) int array of TransCoeffLevel (natural raster order,
    [y][x]).  Returns int32 d[y][x] clipped to 16-bit.
    """
    n = levels.shape[0]
    log2n = n.bit_length() - 1
    bd_shift = bit_depth + log2n - 5
    m = 16 if scaling is None else scaling
    lv = levels.astype(np.int64)
    d = ((lv * m * LEVEL_SCALE[qp % 6]) << (qp // 6))
    d = (d + (1 << (bd_shift - 1))) >> bd_shift
    return np.clip(d, -32768, 32767).astype(np.int32)


def inverse_transform(d: np.ndarray, dst: bool = False,
                      bit_depth: int = 8) -> np.ndarray:
    """2-D inverse transform (8.6.4.1): column pass, 16-bit clip at
    shift 7, then row pass at shift 20-bitDepth.  d is [y][x] int32.
    Returns residual r[y][x] int32 (unclipped to bit depth; caller adds
    to prediction and clips).
    """
    n = d.shape[0]
    m = DST4 if dst else dct_matrix(n)
    mt = m.T.astype(np.int64)
    # vertical (column) transform: e[x][y] = sum_j M[j][y] * d[j][x]
    e = mt @ d.astype(np.int64)            # (y out, x) = sum over freq rows
    shift1 = 7
    e = np.clip((e + (1 << (shift1 - 1))) >> shift1, -32768, 32767)
    # horizontal (row) transform
    shift2 = 20 - bit_depth
    r = e @ m.astype(np.int64)             # sum over freq cols
    r = (r + (1 << (shift2 - 1))) >> shift2
    return np.clip(r, -32768, 32767).astype(np.int32)


def forward_transform(res: np.ndarray, dst: bool = False,
                      bit_depth: int = 8) -> np.ndarray:
    """Forward transform matching inverse_transform's scaling (used by
    the encoder; mirrors the HM reference shifts: shift1 =
    log2N + bitDepth - 9, shift2 = log2N + 6)."""
    n = res.shape[0]
    log2n = n.bit_length() - 1
    m = (DST4 if dst else dct_matrix(n)).astype(np.int64)
    shift1 = log2n + bit_depth - 9
    shift2 = log2n + 6
    t = m @ res.astype(np.int64)
    if shift1 > 0:
        t = (t + (1 << (shift1 - 1))) >> shift1
    elif shift1 < 0:
        t = t << -shift1
    c = t @ m.T
    c = (c + (1 << (shift2 - 1))) >> shift2
    return np.clip(c, -32768, 32767).astype(np.int32)


def quantize(coef: np.ndarray, qp: int, bit_depth: int = 8,
             intra: bool = True) -> np.ndarray:
    """Simple forward quantizer matching dequant (encoder side).

    level = sign * ((|c| * f[qp%6] + offset) >> shift) with the HM
    quantScales f = {26214,23302,20560,18396,16384,14564} and shift =
    29 + qp/6 - bitDepth - log2N; offset = intra ? 171/512 : 85/512 of
    the step.
    """
    qscale = (26214, 23302, 20560, 18396, 16384, 14564)
    n = coef.shape[0]
    log2n = n.bit_length() - 1
    shift = 29 + qp // 6 - bit_depth - log2n
    add = (171 if intra else 85) << (shift - 9)
    c = coef.astype(np.int64)
    lv = (np.abs(c) * qscale[qp % 6] + add) >> shift
    lv = np.clip(lv, 0, 32767)
    return (np.sign(c) * lv).astype(np.int32)
