"""AV1 geometry / mode / scan constants (spec sections 5-9).

Tables are either generated from their normative closed forms
(cos128, zigzag scans, quantizer lookups live in av1_cdf_tables) or
transcribed from the spec and cross-checked byte-for-byte against the
tables compiled into this image's dav1d/libaom binaries (see
tools/extract_av1_cdfs.py and the session notes in PARITY.md).  The C
reference (junka/ffpic) has no AV1 decode layer at all.

Copied from ``ffpic_tpu/coding/av1_consts.py`` for the PyTorch port
unchanged.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------- block sizes
# (w4, h4) in 4-sample units, indexed by BLOCK_*
BLOCK_4X4, BLOCK_4X8, BLOCK_8X4, BLOCK_8X8, BLOCK_8X16, BLOCK_16X8, \
    BLOCK_16X16, BLOCK_16X32, BLOCK_32X16, BLOCK_32X32, BLOCK_32X64, \
    BLOCK_64X32, BLOCK_64X64, BLOCK_64X128, BLOCK_128X64, \
    BLOCK_128X128, BLOCK_4X16, BLOCK_16X4, BLOCK_8X32, BLOCK_32X8, \
    BLOCK_16X64, BLOCK_64X16 = range(22)
BLOCK_INVALID = 255

BLOCK_W4 = [1, 1, 2, 2, 2, 4, 4, 4, 8, 8, 8, 16, 16, 16, 32, 32,
            1, 4, 2, 8, 4, 16]
BLOCK_H4 = [1, 2, 1, 2, 4, 2, 4, 8, 4, 8, 16, 8, 16, 32, 16, 32,
            4, 1, 8, 2, 16, 4]

_DIMS_TO_BLOCK = {(BLOCK_W4[i], BLOCK_H4[i]): i for i in range(22)}


def block_from_dims(w4: int, h4: int) -> int:
    return _DIMS_TO_BLOCK[(w4, h4)]


def plane_block_size(bsize: int, subx: int, suby: int) -> int:
    """ss_size_lookup: chroma residual block size."""
    w4 = max(BLOCK_W4[bsize] >> subx, 1)
    h4 = max(BLOCK_H4[bsize] >> suby, 1)
    return _DIMS_TO_BLOCK[(w4, h4)]


# ---------------------------------------------------------------- partitions
PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT, \
    PARTITION_HORZ_A, PARTITION_HORZ_B, PARTITION_VERT_A, \
    PARTITION_VERT_B, PARTITION_HORZ_4, PARTITION_VERT_4 = range(10)


def partition_subsize(partition: int, bsize: int) -> int:
    """Partition_Subsize[partition][bSize] for square bSize >= 8x8."""
    w4 = BLOCK_W4[bsize]
    if partition == PARTITION_NONE:
        return bsize
    if partition == PARTITION_SPLIT:
        return _DIMS_TO_BLOCK[(w4 >> 1, w4 >> 1)]
    if partition in (PARTITION_HORZ, PARTITION_HORZ_A, PARTITION_HORZ_B):
        return _DIMS_TO_BLOCK[(w4, w4 >> 1)]
    if partition in (PARTITION_VERT, PARTITION_VERT_A, PARTITION_VERT_B):
        return _DIMS_TO_BLOCK[(w4 >> 1, w4)]
    if partition == PARTITION_HORZ_4:
        return _DIMS_TO_BLOCK.get((w4, w4 >> 2), BLOCK_INVALID)
    if partition == PARTITION_VERT_4:
        return _DIMS_TO_BLOCK.get((w4 >> 2, w4), BLOCK_INVALID)
    raise ValueError(partition)


# ---------------------------------------------------------------- intra modes
DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED, \
    D203_PRED, D67_PRED, SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED, \
    PAETH_PRED = range(13)
UV_CFL_PRED = 13

# spec: Intra_Mode_Context[]
INTRA_MODE_CONTEXT = [0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0]

# base angle per directional mode (V..D67)
MODE_TO_ANGLE = {V_PRED: 90, H_PRED: 180, D45_PRED: 45,
                 D135_PRED: 135, D113_PRED: 113, D157_PRED: 157,
                 D203_PRED: 203, D67_PRED: 67}

FILTER_DC_PRED, FILTER_V_PRED, FILTER_H_PRED, FILTER_D157_PRED, \
    FILTER_PAETH_PRED = range(5)
# Fimode_To_Intra_Dir (spec): tx-type derivation for filter-intra blocks
FIMODE_TO_INTRA_DIR = [DC_PRED, V_PRED, H_PRED, D157_PRED, DC_PRED]

# ---------------------------------------------------------------- tx sizes
TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64, TX_4X8, TX_8X4, \
    TX_8X16, TX_16X8, TX_16X32, TX_32X16, TX_32X64, TX_64X32, \
    TX_4X16, TX_16X4, TX_8X32, TX_32X8, TX_16X64, TX_64X16 = range(19)

TX_W = [4, 8, 16, 32, 64, 4, 8, 8, 16, 16, 32, 32, 64, 4, 16, 8, 32,
        16, 64]
TX_H = [4, 8, 16, 32, 64, 8, 4, 16, 8, 32, 16, 64, 32, 16, 4, 32, 8,
        64, 16]

_SQ_FROM_LOG = {2: TX_4X4, 3: TX_8X8, 4: TX_16X16, 5: TX_32X32,
                6: TX_64X64}

# Tx_Size_Sqr: square tx of the smaller dimension
TX_SIZE_SQR = [_SQ_FROM_LOG[min(TX_W[t], TX_H[t]).bit_length() - 1]
               for t in range(19)]
# Tx_Size_Sqr_Up: square tx of the larger dimension
TX_SIZE_SQR_UP = [_SQ_FROM_LOG[max(TX_W[t], TX_H[t]).bit_length() - 1]
                  for t in range(19)]

# Split_Tx_Size (spec): next-smaller tx for tx_depth steps
SPLIT_TX_SIZE = {
    TX_8X8: TX_4X4, TX_16X16: TX_8X8, TX_32X32: TX_16X16,
    TX_64X64: TX_32X32, TX_4X8: TX_4X4, TX_8X4: TX_4X4,
    TX_8X16: TX_8X8, TX_16X8: TX_8X8, TX_16X32: TX_16X16,
    TX_32X16: TX_16X16, TX_32X64: TX_32X32, TX_64X32: TX_32X32,
    TX_4X16: TX_4X8, TX_16X4: TX_8X4, TX_8X32: TX_8X16,
    TX_32X8: TX_16X8, TX_16X64: TX_16X32, TX_64X16: TX_32X16,
}

_TXDIMS_TO_SIZE = {(TX_W[t], TX_H[t]): t for t in range(19)}


def max_tx_size_rect(bsize: int) -> int:
    """Max_Tx_Size_Rect: largest (possibly rectangular) tx for bsize."""
    w = min(BLOCK_W4[bsize] * 4, 64)
    h = min(BLOCK_H4[bsize] * 4, 64)
    # rect txs exist up to 1:4 aspect; wider blocks clamp aspect
    while (w, h) not in _TXDIMS_TO_SIZE:
        if w > h:
            w >>= 1
        else:
            h >>= 1
    return _TXDIMS_TO_SIZE[(w, h)]


def max_uv_tx_size(bsize: int, subx: int, suby: int) -> int:
    pb = plane_block_size(bsize, subx, suby)
    w = min(BLOCK_W4[pb] * 4, 32)
    h = min(BLOCK_H4[pb] * 4, 32)
    while (w, h) not in _TXDIMS_TO_SIZE:
        if w > h:
            w >>= 1
        else:
            h >>= 1
    return _TXDIMS_TO_SIZE[(w, h)]


def tx_size_from_dims(w: int, h: int) -> int:
    return _TXDIMS_TO_SIZE[(w, h)]


# txSzCtx for coefficient cdfs (spec 5.11.39)
TX_SIZE_CTX = [(TX_SIZE_SQR[t] + TX_SIZE_SQR_UP[t] + 1) >> 1
               for t in range(19)]

# coefficient-area-adjusted tx (64-point txs keep only 32x32 coeffs)
ADJUSTED_TX_SIZE = {TX_64X64: TX_32X32, TX_64X32: TX_32X32,
                    TX_32X64: TX_32X32, TX_64X16: TX_32X16,
                    TX_16X64: TX_16X32}


def adjusted_tx_size(tx: int) -> int:
    return ADJUSTED_TX_SIZE.get(tx, tx)


# ---------------------------------------------------------------- tx types
DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST, \
    FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST, IDTX, V_DCT, \
    H_DCT, V_ADST, H_ADST, V_FLIPADST, H_FLIPADST = range(16)

TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT = range(3)


def tx_type_class(tx_type: int) -> int:
    if tx_type in (V_DCT, V_ADST, V_FLIPADST):
        return TX_CLASS_VERT
    if tx_type in (H_DCT, H_ADST, H_FLIPADST):
        return TX_CLASS_HORIZ
    return TX_CLASS_2D


TX_SET_DCTONLY, TX_SET_INTRA_1, TX_SET_INTRA_2 = range(3)

# symbol -> tx type for the two intra sets (spec Tx_Type_Intra_Inv_Set*)
TX_TYPE_INTRA_INV_SET1 = [IDTX, DCT_DCT, V_DCT, H_DCT, ADST_ADST,
                          ADST_DCT, DCT_ADST]
TX_TYPE_INTRA_INV_SET2 = [IDTX, DCT_DCT, ADST_ADST, ADST_DCT,
                          DCT_ADST]


def get_tx_set_intra(tx_size: int, reduced_tx_set: bool) -> int:
    """get_tx_set for intra blocks (spec 5.11.48): DCT-only at any
    32-point dimension (intra has no IDTX-at-32 set, unlike inter)."""
    if TX_SIZE_SQR_UP[tx_size] >= TX_32X32:
        return TX_SET_DCTONLY
    if reduced_tx_set:
        return TX_SET_INTRA_2
    if TX_SIZE_SQR[tx_size] == TX_16X16:
        return TX_SET_INTRA_2
    return TX_SET_INTRA_1


# spec Intra_Mode_To_Tx_Type (chroma & implicit luma tx type)
INTRA_MODE_TO_TX_TYPE = [
    DCT_DCT,    # DC
    ADST_DCT,   # V
    DCT_ADST,   # H
    DCT_DCT,    # D45
    ADST_ADST,  # D135
    ADST_DCT,   # D113
    DCT_ADST,   # D157
    DCT_ADST,   # D203
    ADST_DCT,   # D67
    ADST_ADST,  # SMOOTH
    ADST_DCT,   # SMOOTH_V
    DCT_ADST,   # SMOOTH_H
    ADST_ADST,  # PAETH
    DCT_DCT,    # UV_CFL
]


def tx_type_in_set(tx_set: int, tx_type: int) -> bool:
    if tx_set == TX_SET_DCTONLY:
        return tx_type == DCT_DCT
    if tx_set == TX_SET_INTRA_1:
        return tx_type in TX_TYPE_INTRA_INV_SET1
    return tx_type in TX_TYPE_INTRA_INV_SET2


# ------------------------------------------------ inter tx sets (intrabc)
# spec Tx_Type_Inter_Inv_Set1/2/3 (5.11.48); inter sets are used by
# intrabc blocks in still pictures
TX_SET_INTER_1, TX_SET_INTER_2, TX_SET_INTER_3 = 1, 2, 3
TX_TYPE_INTER_INV_SET1 = [
    IDTX, V_DCT, H_DCT, V_ADST, H_ADST, V_FLIPADST, H_FLIPADST,
    DCT_DCT, ADST_DCT, DCT_ADST, FLIPADST_DCT, DCT_FLIPADST,
    ADST_ADST, FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST]
TX_TYPE_INTER_INV_SET2 = [
    IDTX, V_DCT, H_DCT, DCT_DCT, ADST_DCT, DCT_ADST, FLIPADST_DCT,
    DCT_FLIPADST, ADST_ADST, FLIPADST_FLIPADST, ADST_FLIPADST,
    FLIPADST_ADST]
TX_TYPE_INTER_INV_SET3 = [IDTX, DCT_DCT]


def get_tx_set_inter(tx_size: int, reduced_tx_set: bool) -> int:
    """get_tx_set for inter (intrabc) blocks (spec 5.11.48)."""
    if TX_SIZE_SQR_UP[tx_size] > TX_32X32:
        return TX_SET_DCTONLY
    if TX_SIZE_SQR_UP[tx_size] == TX_32X32:
        return TX_SET_INTER_3
    if reduced_tx_set:
        return TX_SET_INTER_3
    if TX_SIZE_SQR[tx_size] == TX_16X16:
        return TX_SET_INTER_2
    return TX_SET_INTER_1


def tx_type_in_set_inter(tx_set: int, tx_type: int) -> bool:
    if tx_set == TX_SET_DCTONLY:
        return tx_type == DCT_DCT
    if tx_set == TX_SET_INTER_1:
        return True
    if tx_set == TX_SET_INTER_2:
        return tx_type in TX_TYPE_INTER_INV_SET2
    return tx_type in TX_TYPE_INTER_INV_SET3


_TX_BY_DIMS = None


def find_tx_size(w: int, h: int) -> int:
    """tx enum with exactly (w, h) pixel dims (spec find_tx_size)."""
    global _TX_BY_DIMS
    if _TX_BY_DIMS is None:
        _TX_BY_DIMS = {(TX_W[t], TX_H[t]): t for t in range(19)}
    return _TX_BY_DIMS[(w, h)]


# ---------------------------------------------------------------- scans
def _zigzag(w: int, h: int) -> list[tuple[int, int]]:
    """Alternating-diagonal zigzag (square default scan)."""
    out = []
    for d in range(w + h - 1):
        cells = [(r, d - r) for r in range(max(0, d - w + 1),
                                           min(h, d + 1))]
        if d % 2 == 0:
            cells = cells[::-1]
        out.extend(cells)
    return out


def _diag(w: int, h: int) -> list[tuple[int, int]]:
    """Uni-directional diagonal (rect default scan).

    Tall txs (w < h) traverse each anti-diagonal from the top-right
    cell downward; wide txs from the bottom-left cell upward —
    byte-identical to the tables compiled into dav1d/libaom.
    """
    out = []
    for d in range(w + h - 1):
        cells = [(r, d - r) for r in range(max(0, d - w + 1),
                                           min(h, d + 1))]
        if w > h:
            cells = cells[::-1]
        out.extend(cells)
    return out


def _make_scan(w: int, h: int, kind: str) -> np.ndarray:
    if kind == "default":
        cells = _zigzag(w, h) if w == h else _diag(w, h)
    elif kind == "mrow":        # raster: row by row
        cells = [(r, c) for r in range(h) for c in range(w)]
    elif kind == "mcol":        # column by column
        cells = [(r, c) for c in range(w) for r in range(h)]
    else:
        raise ValueError(kind)
    return np.array([r * w + c for r, c in cells], dtype=np.int32)


_SCAN_CACHE: dict = {}


def get_scan(tx_size: int, tx_type: int) -> np.ndarray:
    """Scan order over the adjusted (<=32x32) coefficient area."""
    adj = adjusted_tx_size(tx_size)
    w, h = TX_W[adj], TX_H[adj]
    cls = tx_type_class(tx_type)
    kind = ("mrow" if cls == TX_CLASS_VERT else
            "mcol" if cls == TX_CLASS_HORIZ else "default")
    key = (w, h, kind)
    s = _SCAN_CACHE.get(key)
    if s is None:
        s = _make_scan(w, h, kind)
        _SCAN_CACHE[key] = s
    return s


# ------------------------------------------------- coefficient ctx offsets
# matches aom av1_nz_map_ctx_offset generation / dav1d lo_ctx_offsets
# (extracted from this image's libavif binary at .rodata 0x471940)
LO_CTX_OFFSETS_SQUARE = [
    [0, 1, 6, 6, 21], [1, 6, 6, 21, 21], [6, 6, 21, 21, 21],
    [6, 21, 21, 21, 21], [21, 21, 21, 21, 21]]
LO_CTX_OFFSETS_WIDE = [
    [0, 16, 6, 6, 21], [16, 16, 6, 21, 21], [16, 16, 21, 21, 21],
    [16, 16, 21, 21, 21], [16, 16, 21, 21, 21]]
LO_CTX_OFFSETS_TALL = [
    [0, 11, 11, 11, 11], [11, 11, 11, 11, 11], [6, 6, 21, 21, 21],
    [6, 21, 21, 21, 21], [21, 21, 21, 21, 21]]

LO_CTX_OFFSETS_1D = [26, 31, 36]

SKIP_CONTEXTS = [[1, 2, 2, 2, 3], [1, 4, 4, 4, 5], [1, 4, 4, 4, 5],
                 [1, 4, 4, 4, 5], [1, 4, 4, 4, 6]]


def lo_ctx_offset_table(w: int, h: int):
    if w == h:
        return LO_CTX_OFFSETS_SQUARE
    return LO_CTX_OFFSETS_WIDE if w > h else LO_CTX_OFFSETS_TALL


# ---------------------------------------------------------------- cos table
def _gen_cos128() -> np.ndarray:
    import math
    return np.array([int(4096 * math.cos(i * math.pi / 128) + 0.5)
                     for i in range(65)], dtype=np.int64)


COS128_TABLE = _gen_cos128()


def cos128(angle: int) -> int:
    angle &= 255
    if angle <= 64:
        return int(COS128_TABLE[angle])
    if angle <= 128:
        return -int(COS128_TABLE[128 - angle])
    if angle <= 192:
        return -int(COS128_TABLE[angle - 128])
    return int(COS128_TABLE[256 - angle])


def sin128(angle: int) -> int:
    return cos128(angle - 64)


# ------------------------------------------------------------ intra tables
# Dr_Intra_Derivative (spec 7.11.2.7): tangent lookup, degrees -> slope
DR_INTRA_DERIVATIVE = {
    3: 1023, 6: 547, 9: 372, 14: 273, 17: 215, 20: 178, 23: 151,
    26: 132, 29: 116, 32: 102, 36: 90, 39: 80, 42: 71, 45: 64,
    48: 57, 51: 51, 54: 45, 58: 40, 61: 35, 64: 31, 67: 27, 70: 23,
    73: 19, 76: 15, 81: 11, 84: 7, 87: 3,
}

# Sm_Weights_Tx_* (spec 7.11.2.6): smooth prediction weights per size
SM_WEIGHTS = {
    4: [255, 149, 85, 64],
    8: [255, 197, 146, 105, 73, 50, 37, 32],
    16: [255, 225, 196, 170, 145, 123, 102, 84, 68, 54, 43, 33, 26,
         20, 17, 16],
    32: [255, 240, 225, 210, 196, 182, 169, 157, 145, 133, 122, 111,
         101, 92, 83, 74, 66, 59, 52, 45, 39, 34, 29, 25, 21, 17,
         14, 12, 10, 9, 8, 8],
    64: [255, 248, 240, 233, 225, 218, 210, 203, 196, 189, 182, 176,
         169, 163, 156, 150, 144, 138, 133, 127, 121, 116, 111, 106,
         101, 96, 91, 86, 82, 77, 73, 69, 65, 61, 57, 54, 50, 47,
         44, 41, 38, 35, 32, 29, 27, 25, 22, 20, 18, 16, 15, 13, 12,
         10, 9, 8, 7, 6, 6, 5, 5, 4, 4, 4],
}

# filter-intra 7-tap filters (spec Intra_Filter_Taps, 5 modes x 8 px x 7);
# byte-verified against the table at .rodata 0x442370 in this image's
# libavif (aom av1_filter_intra_taps)
INTRA_FILTER_TAPS = [
    # FILTER_DC
    [[-6, 10, 0, 0, 0, 12, 0], [-5, 2, 10, 0, 0, 9, 0],
     [-3, 1, 1, 10, 0, 7, 0], [-3, 1, 1, 2, 10, 5, 0],
     [-4, 6, 0, 0, 0, 2, 12], [-3, 2, 6, 0, 0, 2, 9],
     [-3, 2, 2, 6, 0, 2, 7], [-3, 1, 2, 2, 6, 3, 5]],
    # FILTER_V
    [[-10, 16, 0, 0, 0, 10, 0], [-6, 0, 16, 0, 0, 6, 0],
     [-4, 0, 0, 16, 0, 4, 0], [-2, 0, 0, 0, 16, 2, 0],
     [-10, 16, 0, 0, 0, 0, 10], [-6, 0, 16, 0, 0, 0, 6],
     [-4, 0, 0, 16, 0, 0, 4], [-2, 0, 0, 0, 16, 0, 2]],
    # FILTER_H
    [[-8, 8, 0, 0, 0, 16, 0], [-8, 0, 8, 0, 0, 16, 0],
     [-8, 0, 0, 8, 0, 16, 0], [-8, 0, 0, 0, 8, 16, 0],
     [-4, 4, 0, 0, 0, 0, 16], [-4, 0, 4, 0, 0, 0, 16],
     [-4, 0, 0, 4, 0, 0, 16], [-4, 0, 0, 0, 4, 0, 16]],
    # FILTER_D157
    [[-2, 8, 0, 0, 0, 10, 0], [-1, 3, 8, 0, 0, 6, 0],
     [-1, 2, 3, 8, 0, 4, 0], [0, 1, 2, 3, 8, 2, 0],
     [-1, 4, 0, 0, 0, 3, 10], [-1, 3, 4, 0, 0, 4, 6],
     [-1, 2, 3, 4, 0, 4, 4], [-1, 2, 2, 3, 4, 3, 3]],
    # FILTER_PAETH
    [[-12, 14, 0, 0, 0, 14, 0], [-10, 0, 14, 0, 0, 12, 0],
     [-9, 0, 0, 14, 0, 11, 0], [-8, 0, 0, 0, 14, 10, 0],
     [-10, 12, 0, 0, 0, 0, 14], [-9, 1, 12, 0, 0, 0, 12],
     [-8, 0, 0, 12, 0, 1, 11], [-7, 0, 0, 1, 12, 1, 9]],
]

# Mode_To_Angle helper for filter ctx
ANGLE_STEP = 3


# ------------------------------------------------------------- loop restore
# Sgr_Params (spec 7.17.3): per lr_sgr_set (r0, s0, r1, s1) where s =
# Round((1 << SGRPROJ_MTABLE_BITS) / (n^2 * e)) is the precomputed scale
# the decoders store instead of e.  Machine-carved from libaom 3.6.0
# .rodata (av1_sgr_params, int32 {r[2], s[2]}) and byte-cross-validated
# against dav1d 1.0.0 and Pillow's static dav1d 1.5.1
# (dav1d_sgr_params uint16 {s0, s1}); see session notes.  The C
# reference (junka/ffpic) has no AV1 decode at all (avif.c:382-405).
SGR_PARAMS = [
    (2, 140, 1, 3236), (2, 112, 1, 2158), (2, 93, 1, 1618),
    (2, 80, 1, 1438), (2, 70, 1, 1295), (2, 58, 1, 1177),
    (2, 47, 1, 1079), (2, 37, 1, 996), (2, 30, 1, 925),
    (2, 25, 1, 863), (0, 0, 1, 2589), (0, 0, 1, 1618),
    (0, 0, 1, 1177), (0, 0, 1, 925), (2, 56, 0, 0), (2, 22, 0, 0),
]

# Wiener_Taps_{Min,Max,Mid,K} (spec 5.11.58 / 6.10.15)
WIENER_TAPS_MIN = [-5, -23, -17]
WIENER_TAPS_MAX = [10, 8, 46]
WIENER_TAPS_MID = [3, -7, 15]
WIENER_TAPS_K = [1, 2, 3]

# Sgrproj_Xqd_{Min,Max,Mid} (spec 5.11.58)
SGRPROJ_XQD_MIN = [-96, -32]
SGRPROJ_XQD_MAX = [31, 95]
SGRPROJ_XQD_MID = [-32, 31]
SGRPROJ_PRJ_SUBEXP_K = 4
SGRPROJ_PRJ_BITS = 7
SGRPROJ_RST_BITS = 4
SGRPROJ_SGR_BITS = 8
SGRPROJ_MTABLE_BITS = 20
SGRPROJ_RECIP_BITS = 12


def count_units_in_frame(unit_size: int, frame_size: int) -> int:
    """Spec count_units_in_frame (5.9.22)."""
    return max((frame_size + (unit_size >> 1)) // unit_size, 1)


# =================================================================== inter
# Inter-frame constants (spec 6.10.4, 7.10, 7.11.3).  The C reference
# has no AV1 layer at all; dav1d is the conformance oracle.

# reference frames (spec: ref enum; NONE uses -1)
NONE_FRAME = -1
INTRA_FRAME, LAST_FRAME, LAST2_FRAME, LAST3_FRAME, GOLDEN_FRAME, \
    BWDREF_FRAME, ALTREF2_FRAME, ALTREF_FRAME = range(8)
FWD_REFS = (LAST_FRAME, LAST2_FRAME, LAST3_FRAME, GOLDEN_FRAME)
BWD_REFS = (BWDREF_FRAME, ALTREF2_FRAME, ALTREF_FRAME)
REFS_PER_FRAME = 7

# single-mv inter modes continue the YMode enum after PAETH_PRED
NEARESTMV, NEARMV, GLOBALMV, NEWMV, NEAREST_NEARESTMV, \
    NEAR_NEARMV, NEAREST_NEWMV, NEW_NEARESTMV, NEAR_NEWMV, \
    NEW_NEARMV, GLOBAL_GLOBALMV, NEW_NEWMV = range(13, 25)

# compound-mode decomposition (spec compound_mode -> per-ref modes)
COMP_MODE_PAIR = {
    NEAREST_NEARESTMV: (NEARESTMV, NEARESTMV),
    NEAR_NEARMV: (NEARMV, NEARMV),
    NEAREST_NEWMV: (NEARESTMV, NEWMV),
    NEW_NEARESTMV: (NEWMV, NEARESTMV),
    NEAR_NEWMV: (NEARMV, NEWMV),
    NEW_NEARMV: (NEWMV, NEARMV),
    GLOBAL_GLOBALMV: (GLOBALMV, GLOBALMV),
    NEW_NEWMV: (NEWMV, NEWMV),
}

# interpolation filters
EIGHTTAP, EIGHTTAP_SMOOTH, EIGHTTAP_SHARP, BILINEAR, SWITCHABLE = \
    range(5)

# motion modes
SIMPLE, OBMC_CAUSAL, LOCALWARP = range(3)

# interintra modes
II_DC_PRED, II_V_PRED, II_H_PRED, II_SMOOTH_PRED = range(4)
INTERINTRA_TO_INTRA = [DC_PRED, V_PRED, H_PRED, SMOOTH_PRED]

# compound types (comp_group_idx == 1 space)
COMPOUND_WEDGE, COMPOUND_DIFFWTD = range(2)

# global motion transform types
IDENTITY, TRANSLATION, ROTZOOM, AFFINE = range(4)
GM_ABS_TRANS_BITS = 12
GM_ABS_TRANS_ONLY_BITS = 9
GM_ABS_ALPHA_BITS = 12
GM_ALPHA_PREC_BITS = 15
GM_TRANS_PREC_BITS = 6
GM_TRANS_ONLY_PREC_BITS = 3
WARPEDMODEL_PREC_BITS = 16
WARPEDMODEL_TRANS_CLAMP = 1 << 23
WARPEDMODEL_NONDIAG_CLAMP = 1 << 13
WARPEDDIFF_PREC_BITS = 10
DIV_LUT_PREC_BITS = 14
DIV_LUT_BITS = 8

# mv limits
MV_UPP = 1 << 14          # (spec: mv range (-2^14, 2^14))
MV_BORDER = 128           # 16 px in 1/8 units
MAX_FRAME_DISTANCE = 31
MAX_OFFSET_WIDTH = 8      # motion field projection clamps (7.9.2)
MAX_OFFSET_HEIGHT = 0
REF_CAT_LEVEL = 640
MAX_REF_MV_STACK_SIZE = 8
MFMV_STACK_SIZE = 3

# Size_Group (spec: y-mode / interintra ctx by block size)
SIZE_GROUP = [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3,
              1, 1, 2, 2, 3, 3]

# Wedge_Bits (spec 7.11.3.11): nonzero for 8x8..32x32-ish shapes
WEDGE_BITS = [0, 0, 0, 4, 4, 4, 4, 4, 4, 4, 0, 0, 0, 0, 0, 0,
              0, 0, 4, 4, 0, 0]

# frame types
KEY_FRAME, INTER_FRAME, INTRA_ONLY_FRAME, SWITCH_FRAME = range(4)
PRIMARY_REF_NONE = 7
NUM_REF_FRAMES = 8
