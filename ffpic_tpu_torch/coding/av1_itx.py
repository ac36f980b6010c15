"""AV1 inverse transforms (spec 7.13.3): DCT 4-64, ADST 4/8/16 (+flip),
identity, Walsh-Hadamard, and the 2D driver with rect scaling,
row/column rounding shifts and intermediate-range clamping.

Formulation: every rotation is Round2(a*cos128(t) - b*sin128(t), 12)
(plain arithmetic-shift rounding, negatives handled by the constants
themselves, which matches dav1d's inline-negated forms bit-exactly);
every add/sub butterfly clamps to the current stage range (bd+8 bits
for the row pass, max(bd+6,16) for the column pass, spec 7.13.3).
Networks validated structurally against the closed-form transforms in
tests/test_av1_itx.py and bit-exactly against dav1d YUV output
(tests/test_av1.py).  The C reference (junka/ffpic) has no AV1
decode layer (avif.c:382-405 stub).

Production path: the batched driver dispatches to the lane-major C
executor (native/host_av1_itx.c, 3.5-6x over the numpy lanes; see
_native_itx) — the scalar + numpy forms below stay as the oracles
the differential sweep pins the C against.

Copied from ``ffpic_tpu/coding/av1_itx.py`` for the PyTorch port with
its imports rewritten to the port's modules and one change: the batch
route takes the port's native ``av1_itx_batch`` / ``av1_wht_batch``
(``ffpic_tpu_torch/native/host_av1_itx.c``; a failed build raises)
unless ``FFPIC_AV1_HOST_ITX=0`` pins the numpy lanes, the test route
the reference has under the same name.  The original also falls back
to numpy without its library (``:42-50``).
"""

from __future__ import annotations

import os

import numpy as np

from ffpic_tpu_torch.coding.av1_consts import (
    cos128, sin128, TX_W, TX_H, adjusted_tx_size, tx_type_class,
    DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT,
    DCT_FLIPADST, FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST,
    IDTX, V_DCT, H_DCT, V_ADST, H_ADST, V_FLIPADST, H_FLIPADST,
)


def _r2(v: int) -> int:
    return (v + 2048) >> 12


from ffpic_tpu_torch.coding.av1_consts import COS128_TABLE as _COS128_TABLE

_COS_I32 = np.ascontiguousarray(np.asarray(_COS128_TABLE, np.int32))


def _native_itx() -> bool:
    """Lane-major C transforms (native/host_av1_itx.c), bit-exact
    with the numpy lane path below (tests/test_av1_itx.py
    differential sweep); FFPIC_AV1_HOST_ITX=0 pins numpy."""
    return os.environ.get("FFPIC_AV1_HOST_ITX", "1") != "0"


def _brev(x: int, bits: int) -> int:
    out = 0
    for _ in range(bits):
        out = (out << 1) | (x & 1)
        x >>= 1
    return out


# ---------------------------------------------------------------- DCT
# Rotation-round angle tables for the odd half-network, keyed by
# (M, level): pairs (i, M-1-i) for i in each listed run, first run
# plain angle, mirror run angle+64.  Derived from the recursive
# radix-2 structure; verified against the closed-form IDCT matrix.
def _odd_rot_rounds(M: int):
    """Yields, per intermediate level, a list of (i, angle) pairs."""
    import math
    levels = int(math.log2(M))
    rounds = []
    for L in range(1, levels - 1):
        # runs of length 2**(L-1)... generic candidate; validated by
        # the float check in tests (structure is fixed by it).
        run = 1 << (L - 1)
        span = 1 << (L + 1)          # group size at next hadamard
        base = _initial_angles(M >> (L + 1))
        pairs = []
        for q in range(M >> (L + 2)):
            a = base[q]
            start = q * span + run
            for k in range(run):
                pairs.append((start + k, a))
            for k in range(run):
                pairs.append((start + run + k, a + 64))
        rounds.append(pairs)
    return rounds


def _initial_angles(M: int):
    """Initial rotation angles of the odd network of size M."""
    cnt = M >> 1
    bits = max(0, cnt.bit_length() - 1)
    out = []
    for j in range(cnt):
        m = 1 + 4 * _brev(j, bits)
        out.append(64 - m * (32 // M))
    return out


def _idct_odd(x, lo, hi):
    """Odd half of the inverse DCT: x = [in1, in3, ...], len M."""
    M = len(x)
    N = 2 * M
    cnt = M >> 1
    bits = max(0, cnt.bit_length() - 1)
    o = [0] * M
    for j in range(cnt):
        m = 1 + 4 * _brev(j, bits)
        ang = 64 - m * (128 // (2 * N))
        a = x[(m - 1) >> 1]
        b = x[(N - m - 1) >> 1]
        c, s = cos128(ang), sin128(ang)
        o[j] = _r2(a * c - b * s)
        o[M - 1 - j] = _r2(a * s + b * c)
    import math
    levels = int(math.log2(M))
    rot_rounds = _odd_rot_rounds(M)
    for L in range(1, levels):
        g_sz = 1 << L
        for g in range(M >> L):
            base = g * g_sz
            for i in range(g_sz >> 1):
                a_i, b_i = base + i, base + g_sz - 1 - i
                va, vb = o[a_i], o[b_i]
                if g & 1:
                    o[a_i] = _clip(vb - va, lo, hi)
                    o[b_i] = _clip(vb + va, lo, hi)
                else:
                    o[a_i] = _clip(va + vb, lo, hi)
                    o[b_i] = _clip(va - vb, lo, hi)
        if L < levels - 1:
            for i, ang in rot_rounds[L - 1]:
                j = M - 1 - i
                c, s = cos128(ang), sin128(ang)
                va, vb = o[i], o[j]
                o[i] = _r2(vb * c - va * s)
                o[j] = _r2(vb * s + va * c)
        else:
            for i in range(M >> 2, M >> 1):
                j = M - 1 - i
                va, vb = o[i], o[j]
                o[i] = _r2((vb - va) * 2896)
                o[j] = _r2((vb + va) * 2896)
    return o


def _clip(v, lo, hi):
    """Scalar or lane-vector clamp: every 1-D network below is generic
    over python ints and int64 numpy lanes (same +,-,*,>> semantics;
    numpy >> on negative int64 is arithmetic like python's), so the
    batched driver reuses the exact scalar networks bit-for-bit."""
    if isinstance(v, np.ndarray):
        return np.clip(v, lo, hi)
    return lo if v < lo else (hi if v > hi else v)


def inv_dct(x, lo, hi):
    """Inverse DCT of length 4/8/16/32/64 (list of python ints)."""
    N = len(x)
    if N == 4:
        in0, in1, in2, in3 = x
        t0 = _r2((in0 + in2) * 2896)
        t1 = _r2((in0 - in2) * 2896)
        t2 = _r2(in1 * 1567 - in3 * 3784)
        t3 = _r2(in1 * 3784 + in3 * 1567)
        return [_clip(t0 + t3, lo, hi), _clip(t1 + t2, lo, hi),
                _clip(t1 - t2, lo, hi), _clip(t0 - t3, lo, hi)]
    e = inv_dct(x[0::2], lo, hi)
    o = _idct_odd(x[1::2], lo, hi)
    h = N >> 1
    out = [0] * N
    for i in range(h):
        out[i] = _clip(e[i] + o[h - 1 - i], lo, hi)
        out[N - 1 - i] = _clip(e[i] - o[h - 1 - i], lo, hi)
    return out


# ---------------------------------------------------------------- ADST
def inv_adst4(x, lo, hi):
    # SINPI network (spec 7.13.3; 12-bit sinpi constants)
    S1, S2, S3, S4 = 1321, 2482, 3344, 3803
    x0, x1, x2, x3 = x
    s0 = S1 * x0
    s1 = S2 * x0
    s2 = S3 * x1
    s3 = S4 * x2
    s4 = S1 * x2
    s5 = S2 * x3
    s6 = S4 * x3
    a7 = x0 - x2
    b7 = a7 + x3
    s0 = s0 + s3
    s1 = s1 - s4
    s3 = s2
    s2 = S3 * b7
    s0 = s0 + s5
    s1 = s1 - s6
    o0 = s0 + s3
    o1 = s1 + s3
    o2 = s2
    o3 = s0 + s1 - s3
    return [_r2(o0), _r2(o1), _r2(o2), _r2(o3)]


def inv_adst8(x, lo, hi):
    # stage 1: reorder
    x0, x1, x2, x3, x4, x5, x6, x7 = (
        x[7], x[0], x[5], x[2], x[3], x[4], x[1], x[6])
    # stage 2: initial rotations, angles 4,20,36,52
    s = [0] * 8
    for k, (a, b, ang) in enumerate((
            (x0, x1, 4), (x2, x3, 20), (x4, x5, 36), (x6, x7, 52))):
        c, sn = cos128(ang), sin128(ang)
        s[2 * k] = _r2(a * c + b * sn)
        s[2 * k + 1] = _r2(a * sn - b * c)
    # stage 3: butterflies span 4
    t = [0] * 8
    for i in range(4):
        t[i] = _clip(s[i] + s[i + 4], lo, hi)
        t[i + 4] = _clip(s[i] - s[i + 4], lo, hi)
    # stage 4: rotations on 4..7 with angle 16 / 48
    c16, s16 = cos128(16), sin128(16)
    u = list(t)
    u[4] = _r2(t[4] * c16 + t[5] * s16)
    u[5] = _r2(t[4] * s16 - t[5] * c16)
    u[6] = _r2(-t[6] * s16 + t[7] * c16)
    u[7] = _r2(t[6] * c16 + t[7] * s16)
    # stage 5: butterflies span 2
    v = [0] * 8
    for base in (0, 4):
        for i in range(2):
            v[base + i] = _clip(u[base + i] + u[base + i + 2], lo, hi)
            v[base + i + 2] = _clip(u[base + i] - u[base + i + 2],
                                    lo, hi)
    # stage 6: cos32 rotations on (2,3) and (6,7)
    w = list(v)
    w[2] = _r2((v[2] + v[3]) * 2896)
    w[3] = _r2((v[2] - v[3]) * 2896)
    w[6] = _r2((v[6] + v[7]) * 2896)
    w[7] = _r2((v[6] - v[7]) * 2896)
    # stage 7: output permutation with alternating negation
    return [w[0], -w[4], w[6], -w[2], w[3], -w[7], w[5], -w[1]]


def inv_adst16(x, lo, hi):
    # stage 1: reorder
    idx = [15, 0, 13, 2, 11, 4, 9, 6, 7, 8, 5, 10, 3, 12, 1, 14]
    y = [x[i] for i in idx]
    # stage 2: initial rotations, angles 2,10,18,26,34,42,50,58
    s = [0] * 16
    for k in range(8):
        a, b = y[2 * k], y[2 * k + 1]
        ang = 2 + 8 * k
        c, sn = cos128(ang), sin128(ang)
        s[2 * k] = _r2(a * c + b * sn)
        s[2 * k + 1] = _r2(a * sn - b * c)
    # stage 3: butterflies span 8
    t = [0] * 16
    for i in range(8):
        t[i] = _clip(s[i] + s[i + 8], lo, hi)
        t[i + 8] = _clip(s[i] - s[i + 8], lo, hi)
    # stage 4: rotations on 8..15 with angles 8/40 (+mirrored)
    u = list(t)
    c8, s8 = cos128(8), sin128(8)
    c40, s40 = cos128(40), sin128(40)
    u[8] = _r2(t[8] * c8 + t[9] * s8)
    u[9] = _r2(t[8] * s8 - t[9] * c8)
    u[10] = _r2(t[10] * c40 + t[11] * s40)
    u[11] = _r2(t[10] * s40 - t[11] * c40)
    u[12] = _r2(-t[12] * s8 + t[13] * c8)
    u[13] = _r2(t[12] * c8 + t[13] * s8)
    u[14] = _r2(-t[14] * s40 + t[15] * c40)
    u[15] = _r2(t[14] * c40 + t[15] * s40)
    # stage 5: butterflies span 4
    v = [0] * 16
    for base in (0, 8):
        for i in range(4):
            v[base + i] = _clip(u[base + i] + u[base + i + 4], lo, hi)
            v[base + i + 4] = _clip(u[base + i] - u[base + i + 4],
                                    lo, hi)
    # stage 6: rotations on (4..7) and (12..15) with angle 16
    w = list(v)
    c16, s16 = cos128(16), sin128(16)
    for base in (4, 12):
        w[base] = _r2(v[base] * c16 + v[base + 1] * s16)
        w[base + 1] = _r2(v[base] * s16 - v[base + 1] * c16)
        w[base + 2] = _r2(-v[base + 2] * s16 + v[base + 3] * c16)
        w[base + 3] = _r2(v[base + 2] * c16 + v[base + 3] * s16)
    # stage 7: butterflies span 2
    q = [0] * 16
    for base in (0, 4, 8, 12):
        for i in range(2):
            q[base + i] = _clip(w[base + i] + w[base + i + 2], lo, hi)
            q[base + i + 2] = _clip(w[base + i] - w[base + i + 2],
                                    lo, hi)
    # stage 8: cos32 on (2,3),(6,7),(10,11),(14,15)
    r = list(q)
    for base in (2, 6, 10, 14):
        r[base] = _r2((q[base] + q[base + 1]) * 2896)
        r[base + 1] = _r2((q[base] - q[base + 1]) * 2896)
    # stage 9: output permutation with alternating negation
    return [r[0], -r[8], r[12], -r[4], r[6], -r[14], r[10], -r[2],
            r[3], -r[11], r[15], -r[7], r[5], -r[13], r[9], -r[1]]


# ------------------------------------------------------------ identity
def inv_identity(x, n, lo, hi):
    if n == 4:
        return [_r2(v * 5793) for v in x]
    if n == 8:
        return [v * 2 for v in x]
    if n == 16:
        return [_r2(v * 2 * 5793) for v in x]
    return [v * 4 for v in x]


# ---------------------------------------------------------------- WHT
def inv_wht4x4(coeffs: np.ndarray) -> np.ndarray:
    """Lossless 4x4 inverse Walsh-Hadamard (input already dequantized;
    row pass applies the spec's >>2 pre-shift)."""
    T = coeffs.astype(np.int64).copy()
    out = np.zeros((4, 4), np.int64)
    for r in range(4):
        a, c, d, b = (int(T[r, 0]) >> 2, int(T[r, 1]) >> 2,
                      int(T[r, 2]) >> 2, int(T[r, 3]) >> 2)
        a += c
        d -= b
        e = (a - d) >> 1
        b = e - b
        c = e - c
        a -= b
        d += c
        out[r] = (a, b, c, d)
    for cix in range(4):
        a, c, d, b = (int(out[0, cix]), int(out[1, cix]),
                      int(out[2, cix]), int(out[3, cix]))
        a += c
        d -= b
        e = (a - d) >> 1
        b = e - b
        c = e - c
        a -= b
        d += c
        out[:, cix] = (a, b, c, d)
    return out


# ------------------------------------------------------------ 2D driver
_ROW_SHIFT = {
    (4, 4): 0, (8, 8): 1, (16, 16): 2, (32, 32): 2, (64, 64): 2,
    (4, 8): 0, (8, 4): 0, (8, 16): 1, (16, 8): 1, (16, 32): 1,
    (32, 16): 1, (32, 64): 1, (64, 32): 1, (4, 16): 1, (16, 4): 1,
    (8, 32): 2, (32, 8): 2, (16, 64): 2, (64, 16): 2,
}

_DCT, _ADST, _FLIP, _IDT = range(4)

# (vertical, horizontal) 1D kernel per tx type
_TYPE_1D = {
    DCT_DCT: (_DCT, _DCT), ADST_DCT: (_ADST, _DCT),
    DCT_ADST: (_DCT, _ADST), ADST_ADST: (_ADST, _ADST),
    FLIPADST_DCT: (_FLIP, _DCT), DCT_FLIPADST: (_DCT, _FLIP),
    FLIPADST_FLIPADST: (_FLIP, _FLIP), ADST_FLIPADST: (_ADST, _FLIP),
    FLIPADST_ADST: (_FLIP, _ADST), IDTX: (_IDT, _IDT),
    V_DCT: (_DCT, _IDT), H_DCT: (_IDT, _DCT),
    V_ADST: (_ADST, _IDT), H_ADST: (_IDT, _ADST),
    V_FLIPADST: (_FLIP, _IDT), H_FLIPADST: (_IDT, _FLIP),
}


def _apply_1d(kind, vec, n, lo, hi):
    if kind == _DCT:
        return inv_dct(vec, lo, hi)
    if kind == _IDT:
        return inv_identity(vec, n, lo, hi)
    if n == 4:
        return inv_adst4(vec, lo, hi)
    if n == 8:
        return inv_adst8(vec, lo, hi)
    return inv_adst16(vec, lo, hi)


def inverse_transform(coeffs: np.ndarray, tx_size: int, tx_type: int,
                      bit_depth: int = 8,
                      lossless: bool = False) -> np.ndarray:
    """2D inverse transform -> residual (h, w) int32.

    coeffs: dequantized array with the ADJUSTED dims (<=32 per side)
    as produced by the tile decoder; output has the full tx dims.
    """
    if lossless:
        return inv_wht4x4(coeffs).astype(np.int32)
    w, h = TX_W[tx_size], TX_H[tx_size]
    adj = adjusted_tx_size(tx_size)
    aw, ah = TX_W[adj], TX_H[adj]
    vk, hk = _TYPE_1D[tx_type]
    log2w, log2h = w.bit_length() - 1, h.bit_length() - 1
    rect2 = abs(log2w - log2h) == 1
    row_shift = _ROW_SHIFT[(w, h)]
    row_bits = bit_depth + 8
    col_bits = max(bit_depth + 6, 16)
    rlo, rhi = -(1 << (row_bits - 1)), (1 << (row_bits - 1)) - 1
    clo, chi = -(1 << (col_bits - 1)), (1 << (col_bits - 1)) - 1

    buf = [[0] * w for _ in range(h)]
    src = coeffs
    for r in range(ah):
        row = [int(src[r, c]) for c in range(aw)] + [0] * (w - aw)
        if rect2:
            row = [(v * 2896 + 2048) >> 12 for v in row]
        row = [_clip(v, rlo, rhi) for v in row]
        row = _apply_1d(hk, row, w, rlo, rhi)
        if row_shift:
            add = 1 << (row_shift - 1)
            row = [(v + add) >> row_shift for v in row]
        buf[r] = row
    out = np.zeros((h, w), np.int32)
    for c in range(w):
        col = [_clip(buf[r][c], clo, chi) for r in range(h)]
        col = _apply_1d(vk, col, h, clo, chi)
        for r in range(h):
            out[r, c] = (col[r] + 8) >> 4
    if hk == _FLIP:
        out = out[:, ::-1]
    if vk == _FLIP:
        out = out[::-1, :]
    return np.ascontiguousarray(out)


def inverse_transform_batch(coeffs: np.ndarray, tx_size: int,
                            tx_type: int, bit_depth: int = 8,
                            lossless: bool = False) -> np.ndarray:
    """Batched 2D inverse transform: (B, ah, aw) -> (B, h, w) int32.

    Same 1-D butterfly networks as inverse_transform, applied once
    with numpy int64 LANES (lane = one row/column of one TU) instead
    of per-scalar recursion — bit-exact by construction since every
    op (+,-,*,arithmetic >>, clip) is elementwise.  This is where the
    AV1 decode time went (scalar transforms were ~75% of a frame);
    batching all same-(size,type) TUs of a frame amortizes the
    network's Python overhead across B*rows lanes."""
    if lossless:
        if _native_itx():
            from ffpic_tpu_torch import native
            return native.av1_wht_batch(
                np.ascontiguousarray(coeffs, np.int32))
        return np.stack([inv_wht4x4(c) for c in coeffs]).astype(
            np.int32)
    B = coeffs.shape[0]
    w, h = TX_W[tx_size], TX_H[tx_size]
    adj = adjusted_tx_size(tx_size)
    aw, ah = TX_W[adj], TX_H[adj]
    vk, hk = _TYPE_1D[tx_type]
    log2w, log2h = w.bit_length() - 1, h.bit_length() - 1
    rect2 = abs(log2w - log2h) == 1
    row_shift = _ROW_SHIFT[(w, h)]
    row_bits = bit_depth + 8
    col_bits = max(bit_depth + 6, 16)
    rlo, rhi = -(1 << (row_bits - 1)), (1 << (row_bits - 1)) - 1
    clo, chi = -(1 << (col_bits - 1)), (1 << (col_bits - 1)) - 1

    if bit_depth <= 10 and _native_itx():
        from ffpic_tpu_torch import native
        return native.av1_itx_batch(
            np.ascontiguousarray(coeffs, np.int32), aw, ah, w, h,
            hk, vk, rect2, row_shift, rlo, rhi, clo, chi, _COS_I32)

    # int32 lanes for <=10-bit: rotations are a clipped bd+8-bit value
    # times a 12-bit cos (<= 2^30); the widest sums (ADST4 row-pass
    # accumulators) sit at the int32 boundary exactly as in dav1d's
    # int32_t production path (the spec's intermediate-range clamps
    # are designed around it).  Half the memory traffic of int64;
    # 12-bit (profile 2) would need int64 and is out of scope.
    dt = np.int32 if bit_depth <= 10 else np.int64
    src = coeffs.astype(dt)
    lanes = B * ah
    zero = np.zeros(lanes, dt)
    row = [src[:, :, c].reshape(lanes) for c in range(aw)] + \
        [zero] * (w - aw)
    if rect2:
        row = [(v * 2896 + 2048) >> 12 for v in row]
    row = [np.clip(v, rlo, rhi) for v in row]
    row = _apply_1d(hk, row, w, rlo, rhi)
    if row_shift:
        add = 1 << (row_shift - 1)
        row = [(v + add) >> row_shift for v in row]
    # rows >= ah carry all-zero coefficients and every network maps
    # zero lanes to zero, so only the first ah rows are materialized
    buf = np.zeros((B, h, w), dt)
    for c in range(w):
        buf[:, :ah, c] = row[c].reshape(B, ah)
    col = [np.clip(buf[:, r, :].reshape(B * w), clo, chi)
           for r in range(h)]
    col = _apply_1d(vk, col, h, clo, chi)
    out = np.empty((B, h, w), np.int32)
    for r in range(h):
        out[:, r, :] = ((col[r] + 8) >> 4).reshape(B, w)
    if hk == _FLIP:
        out = out[:, :, ::-1]
    if vk == _FLIP:
        out = out[:, ::-1, :]
    return np.ascontiguousarray(out)
