"""AV1 inter-prediction reconstruction: translational motion
compensation with the six subpel filter families, compound blending
(average, distance-weighted, wedge, difference-weighted), smooth
interintra, overlapped block motion compensation, and warped motion
(global + local with the least-squares model fit) — spec 7.11.3.

The C reference (junka/ffpic) has no AV1 layer; dav1d is the
bit-exact oracle.  All math is integer numpy on int32/int64 in the
spec's InterRound0/InterRound1 precision scheme.

Copied from ``ffpic_tpu/formats/av1_mc.py`` for the PyTorch port whole,
with its imports rewritten to the port's modules (the lazy imports of
``av1_inter.select_warp_samples`` and ``av1_intra`` too).  It runs on
the host, as in the reference, under ``av1_recon``'s ``av1.mc`` span.
"""

from __future__ import annotations

import numpy as np

from ffpic_tpu_torch.coding import av1_consts as C
from ffpic_tpu_torch.coding import av1_refs as R
from ffpic_tpu_torch.coding.av1_mc_tables import TABLES as MC

SUBPEL = MC["subpel_filters"].astype(np.int32)     # (6, 16, 8)
WARPED = MC["warped_filters"].astype(np.int32)     # (193, 8)
OBMC_MASK = MC["obmc_mask"]                        # (5, 32)
II_WEIGHTS = MC["ii_weights_1d"].astype(np.int32)  # (32,)
QUANT_DIST_LOOKUP = MC["quant_dist_lookup"]
QUANT_DIST_WEIGHT = MC["quant_dist_weight"]
DIV_LUT = MC["div_lut"].astype(np.int64)


def rounds(bd: int, is_compound: bool):
    """InterRound0/InterRound1 (spec 7.11.3.2)."""
    r0 = 5 if bd == 12 else 3
    if is_compound:
        r1 = 7
    else:
        r1 = 2 * 7 - r0          # 11 (9 for 12-bit)
    return r0, r1


def _round2(a, n):
    if n == 0:
        return a
    return (a + (1 << (n - 1))) >> n


def _filter_set(interp: int, size: int) -> np.ndarray:
    """Filter family selection (7.11.3.4): 4-tap variants replace
    REGULAR/SMOOTH when the block dimension is <= 4."""
    if size <= 4:
        if interp == C.EIGHTTAP:
            return SUBPEL[4]
        if interp == C.EIGHTTAP_SMOOTH:
            return SUBPEL[5]
        if interp == C.BILINEAR:
            return SUBPEL[3]
        return SUBPEL[2]         # sharp has no 4-tap variant
    return SUBPEL[interp if interp <= C.BILINEAR else 0]


def _gather_patch(ref: np.ndarray, y0: int, x0: int, h: int,
                  w: int) -> np.ndarray:
    """(h, w) patch at (y0, x0) with edge-replication (the spec
    clamps every sample read to the reference bounds)."""
    rh, rw = ref.shape
    if 0 <= y0 and y0 + h <= rh and 0 <= x0 and x0 + w <= rw:
        return ref[y0:y0 + h, x0:x0 + w].astype(np.int32)
    ys = np.clip(np.arange(y0, y0 + h), 0, rh - 1)
    xs = np.clip(np.arange(x0, x0 + w), 0, rw - 1)
    return ref[ys[:, None], xs[None, :]].astype(np.int32)


def mc_translation(ref: np.ndarray, x: int, y: int, w: int, h: int,
                   mv, sx: int, sy: int, interp, bd: int,
                   is_compound: bool) -> np.ndarray:
    """Translational MC for one plane rect (spec 7.11.3.3 without
    reference scaling): mv in 1/8 luma px (row, col); (x, y) are
    plane coords.  Returns int32 (h, w): pixel-domain when not
    compound, InterRound1-domain otherwise."""
    r0, r1 = rounds(bd, is_compound)
    # plane-unit 1/16-subpel position
    mvy16 = int(mv[0]) << (1 - sy)
    mvx16 = int(mv[1]) << (1 - sx)
    py = (y << 4) + mvy16
    px = (x << 4) + mvx16
    iy, fy = py >> 4, py & 15
    ix, fx = px >> 4, px & 15
    # interp[0] = vertical (y) filter, interp[1] = horizontal (x)
    fh = _filter_set(interp[0], h)[fy]
    fw = _filter_set(interp[1], w)[fx]
    src = _gather_patch(ref, iy - 3, ix - 3, h + 7, w + 7)
    src = src.astype(np.int64)
    # horizontal pass -> (h+7, w) in round0 domain
    hbuf = np.zeros((h + 7, w), np.int64)
    for t in range(8):
        if fw[t]:
            hbuf += int(fw[t]) * src[:, t:t + w]
    hbuf = _round2(hbuf, r0)
    out = np.zeros((h, w), np.int64)
    for t in range(8):
        if fh[t]:
            out += int(fh[t]) * hbuf[t:t + h]
    out = _round2(out, r1)
    if not is_compound:
        out = np.clip(out, 0, (1 << bd) - 1)
    return out.astype(np.int32)


REF_SCALE_SHIFT = 14
SCALE_SUBPEL_BITS = 10


def mc_translation_scaled(fs, ref_enum: int, plane: int, x: int,
                          y: int, w: int, h: int, mv, sx: int,
                          sy: int, interp, bd: int,
                          is_compound: bool) -> np.ndarray:
    """Translational MC from a SCALED reference (spec 7.11.3.3/4
    with reference scaling; libaom av1_init_inter_params +
    av1_convolve_2d_scale): positions in 1/1024 (q10) units stepped
    by the q10 scale factor, 1/16-phase 8-tap filters in both
    directions.  Used whenever the ref's upscaled geometry differs
    from the current coded geometry (superres inter frames,
    resolution-switching sequences)."""
    rf = _ref_frame(fs, ref_enum)
    ref = rf.planes[plane]
    fh = fs.fh
    xs_fp = ((rf.upscaled_width << REF_SCALE_SHIFT) +
             (fh.width >> 1)) // fh.width
    ys_fp = ((rf.height << REF_SCALE_SHIFT) +
             (fh.height >> 1)) // fh.height
    step_x = (xs_fp + 8) >> 4          # q10 per output pixel
    step_y = (ys_fp + 8) >> 4
    r0, r1 = rounds(bd, is_compound)

    def scale_pos(v_q4, fp):
        off = (fp - (1 << REF_SCALE_SHIFT)) * 8
        # SCALE_EXTRA_OFF = (1 << SCALE_EXTRA_BITS)/2 = 32
        return _round2s(v_q4 * fp + off, 8) + 32

    pos_x = scale_pos((x << 4) + (int(mv[1]) << (1 - sx)), xs_fp)
    pos_y = scale_pos((y << 4) + (int(mv[0]) << (1 - sy)), ys_fp)
    ix, fx0 = pos_x >> SCALE_SUBPEL_BITS, pos_x & 1023
    iy, fy0 = pos_y >> SCALE_SUBPEL_BITS, pos_y & 1023
    im_h = (((h - 1) * step_y + fy0) >> SCALE_SUBPEL_BITS) + 8
    src_w = (((w - 1) * step_x + fx0) >> SCALE_SUBPEL_BITS) + 8
    src = _gather_patch(ref, iy - 3, ix - 3, im_h,
                        src_w).astype(np.int64)
    xq = fx0 + step_x * np.arange(w)
    cols = xq >> SCALE_SUBPEL_BITS
    taps_x = _filter_set(interp[1], w)[(xq & 1023) >> 6] \
        .astype(np.int64)                          # (w, 8)
    hbuf = np.zeros((im_h, w), np.int64)
    for t in range(8):
        hbuf += taps_x[:, t][None, :] * src[:, cols + t]
    hbuf = _round2(hbuf, r0)
    yq = fy0 + step_y * np.arange(h)
    rws = yq >> SCALE_SUBPEL_BITS
    taps_y = _filter_set(interp[0], h)[(yq & 1023) >> 6] \
        .astype(np.int64)                          # (h, 8)
    out = np.zeros((h, w), np.int64)
    for t in range(8):
        out += taps_y[:, t][:, None] * hbuf[rws + t, :]
    out = _round2(out, r1)
    if not is_compound:
        out = np.clip(out, 0, (1 << bd) - 1)
    return out.astype(np.int32)


def _mc_any(fs, ref_enum: int, plane: int, x, y, w, h, mv, sx, sy,
            interp, bd, is_compound):
    """Translational MC dispatch: scaled path when the reference
    geometry differs from the current coded frame.

    The scaled path (superres inter / resolution switching) is
    bit-exact vs dav1d (tests/test_av1_inter.py superres-inter cases,
    sweep configs across denominators 9-16, 8/10-bit, deep GOPs).
    Round 4's "±1-LSB residue" was NOT this convolve: it was the
    parse-side _ref_is_scaled gate comparing against upscaled_width,
    reading motion_mode where dav1d reads the OBMC bool."""
    if _is_scaled(fs, ref_enum):
        return mc_translation_scaled(fs, ref_enum, plane, x, y, w,
                                     h, mv, sx, sy, interp, bd,
                                     is_compound)
    return mc_translation(_ref_plane(fs, ref_enum, plane), x, y, w,
                          h, mv, sx, sy, interp, bd, is_compound)


def dist_weights(seq, fh, ref0: int, ref1: int):
    """Distance-weighted compound weights (spec 7.11.3.15):
    (weight for pred0, weight for pred1), summing to 16."""
    d1 = min(C.MAX_FRAME_DISTANCE, abs(R.get_relative_dist(
        seq, fh.order_hint, fh.order_hints[ref0])))
    d0 = min(C.MAX_FRAME_DISTANCE, abs(R.get_relative_dist(
        seq, fh.order_hints[ref1], fh.order_hint)))
    order = int(d0 <= d1)
    if d0 == 0 or d1 == 0:
        fwd = int(QUANT_DIST_LOOKUP[3][order])
        bck = int(QUANT_DIST_LOOKUP[3][1 - order])
    else:
        for i in range(3):
            c0 = int(QUANT_DIST_WEIGHT[i][order])
            c1 = int(QUANT_DIST_WEIGHT[i][1 - order])
            if (d0 * c0 > d1 * c1) if order else (d0 * c0 < d1 * c1):
                break
        else:
            i = 3
        fwd = int(QUANT_DIST_LOOKUP[i][order])
        bck = int(QUANT_DIST_LOOKUP[i][1 - order])
    # fwd weights the second (forward/later) prediction, bck the
    # first — i.e. (pred0 * bck + pred1 * fwd)
    return bck, fwd


# ------------------------------------------------------------- wedge masks
_MASTER = None


def _master_masks():
    """MasterMask[6][64][64] (spec 7.11.3.11), built from the three
    extracted master rows; oblique rows shift by one master column
    every two rows (63-degree slope)."""
    global _MASTER
    if _MASTER is not None:
        return _MASTER
    rows = MC["wedge_master_rows"].astype(np.uint8)
    odd, even, vert = rows[0], rows[1], rows[2]
    m = np.zeros((6, 64, 64), np.uint8)
    idx = np.arange(64)
    ob63 = np.zeros((64, 64), np.uint8)
    for j in range(64):
        if j & 1:
            src, off = odd, 15
        else:
            src, off = even, 16
        ob63[j] = src[np.clip(idx - off + (j >> 1), 0, 63)]
    m[C_WEDGE_OBLIQUE63] = ob63
    m[C_WEDGE_OBLIQUE27] = ob63.T
    m[C_WEDGE_OBLIQUE117] = 64 - ob63[:, ::-1]
    m[C_WEDGE_OBLIQUE153] = 64 - ob63[::-1, :]
    m[C_WEDGE_VERTICAL] = np.broadcast_to(vert, (64, 64))
    m[C_WEDGE_HORIZONTAL] = np.broadcast_to(vert, (64, 64)).T
    _MASTER = m
    return m


C_WEDGE_HORIZONTAL, C_WEDGE_VERTICAL, C_WEDGE_OBLIQUE27, \
    C_WEDGE_OBLIQUE63, C_WEDGE_OBLIQUE117, C_WEDGE_OBLIQUE153 = \
    range(6)


def wedge_mask(bsize: int, wedge_index: int, wedge_sign: int) \
        -> np.ndarray:
    """Luma-resolution wedge mask (h, w) of 0..64 weights for
    pred0."""
    w = C.BLOCK_W4[bsize] * 4
    h = C.BLOCK_H4[bsize] * 4
    if w > h:
        book = 2                 # hgtw/hltw naming is libaom's; the
    elif w < h:                  # stacked order is (hltw, heqw,
        book = 0                 # hgtw) = (w<h, w==h, w>h)
    else:
        book = 1
    cb = MC["wedge_codebook"][book][wedge_index]
    direction, x8, y8 = int(cb[0]), int(cb[1]), int(cb[2])
    xoff = 32 - ((w * x8) >> 3)
    yoff = 32 - ((h * y8) >> 3)
    master = _master_masks()[direction]
    ys = np.clip(np.arange(yoff, yoff + h), 0, 63)
    xs = np.clip(np.arange(xoff, xoff + w), 0, 63)
    msk = master[ys[:, None], xs[None, :]].astype(np.int32)
    if wedge_sign:
        msk = 64 - msk
    return msk


def diffwtd_mask(p0: np.ndarray, p1: np.ndarray, mask_type: int,
                 bd: int) -> np.ndarray:
    """DIFFWTD mask (spec 7.11.3.12) from the two compound
    (InterRound1-domain) predictions."""
    r0, r1 = rounds(bd, True)
    shift = 2 * 7 - r0 - r1 + (bd - 8)      # back to pixel diffs
    diff = np.abs(p0.astype(np.int64) - p1.astype(np.int64))
    # libaom diffwtd_mask: plain floor shift, NO add-half rounding
    diff = (diff >> shift) if shift > 0 else diff
    m = np.clip(38 + diff // 16, 0, 64).astype(np.int32)
    if mask_type:
        m = 64 - m
    return m


def interintra_mask(bsize_w: int, bsize_h: int, mode: int) \
        -> np.ndarray:
    """Smooth interintra weights for the INTRA prediction
    (spec 7.11.3.13)."""
    scale = 32 // max(bsize_w, bsize_h)
    j = np.arange(bsize_h)[:, None]
    i = np.arange(bsize_w)[None, :]
    if mode == C.II_V_PRED:
        m = II_WEIGHTS[np.broadcast_to(j * scale,
                                       (bsize_h, bsize_w))]
    elif mode == C.II_H_PRED:
        m = II_WEIGHTS[np.broadcast_to(i * scale,
                                       (bsize_h, bsize_w))]
    elif mode == C.II_SMOOTH_PRED:
        m = II_WEIGHTS[np.minimum(i, j) * scale]
    else:
        m = np.full((bsize_h, bsize_w), 32, np.int32)
    return m.astype(np.int32)


# ------------------------------------------------------------------ warp
def _floor_log2(v: int) -> int:
    return v.bit_length() - 1


def _round2s(v: int, n: int) -> int:
    if n == 0:
        return v
    if v >= 0:
        return (v + (1 << (n - 1))) >> n
    return -((-v + (1 << (n - 1))) >> n)


def _resolve_divisor(d: int):
    """Spec 7.11.3.7: (divFactor, divShift) such that x/d ~=
    (x * divFactor) >> divShift."""
    n = _floor_log2(abs(d))
    e = abs(d) - (1 << n)
    if n > C.DIV_LUT_BITS:
        f = _round2s(e, n - C.DIV_LUT_BITS)
    else:
        f = e << (C.DIV_LUT_BITS - n)
    shift = n + C.DIV_LUT_PREC_BITS
    factor = int(DIV_LUT[f])
    return (-factor if d < 0 else factor), shift


WARP_PARAM_REDUCE_BITS = 6


def setup_shear(mat):
    """Spec 7.11.3.6: (valid, alpha, beta, gamma, delta)."""
    def i16clip(v):
        return max(-32768, min(32767, v))

    alpha0 = i16clip(mat[2] - (1 << C.WARPEDMODEL_PREC_BITS))
    beta0 = i16clip(mat[3])
    div_factor, div_shift = _resolve_divisor(mat[2])
    v = mat[4] << C.WARPEDMODEL_PREC_BITS
    gamma0 = i16clip(_round2s(v * div_factor, div_shift))
    w = mat[3] * mat[4]
    delta0 = i16clip(mat[5] -
                     _round2s(w * div_factor, div_shift) -
                     (1 << C.WARPEDMODEL_PREC_BITS))
    alpha = _round2s(alpha0, WARP_PARAM_REDUCE_BITS) \
        * (1 << WARP_PARAM_REDUCE_BITS)
    beta = _round2s(beta0, WARP_PARAM_REDUCE_BITS) \
        * (1 << WARP_PARAM_REDUCE_BITS)
    gamma = _round2s(gamma0, WARP_PARAM_REDUCE_BITS) \
        * (1 << WARP_PARAM_REDUCE_BITS)
    delta = _round2s(delta0, WARP_PARAM_REDUCE_BITS) \
        * (1 << WARP_PARAM_REDUCE_BITS)
    valid = (4 * abs(alpha) + 7 * abs(beta) <
             (1 << C.WARPEDMODEL_PREC_BITS)) and \
            (4 * abs(gamma) + 4 * abs(delta) <
             (1 << C.WARPEDMODEL_PREC_BITS))
    return valid, alpha, beta, gamma, delta


def warp_affine(ref: np.ndarray, mat, shear, x: int, y: int,
                w: int, h: int, sx: int, sy: int, bd: int,
                is_compound: bool) -> np.ndarray:
    """Spec 7.11.3.5 block warp: 8x8-subblock affine MC over a
    (h, w) plane rect at plane coords (x, y).  Returns pixel-domain
    (or InterRound1-domain when compound) int32."""
    _, alpha, beta, gamma, delta = shear
    r0, r1 = rounds(bd, is_compound)
    rh, rw = ref.shape
    refi = ref.astype(np.int64)
    out = np.zeros((h, w), np.int64)
    ll = np.arange(8)                        # l + 4 for l = -4..3
    for i in range(0, h, 8):
        bh = min(8, h - i)
        for j in range(0, w, 8):
            bw = min(8, w - j)
            src_x = (x + j + 4) << sx
            src_y = (y + i + 4) << sy
            dst_x = mat[2] * src_x + mat[3] * src_y + mat[0]
            dst_y = mat[4] * src_x + mat[5] * src_y + mat[1]
            x4 = dst_x >> sx
            y4 = dst_y >> sy
            ix4 = x4 >> C.WARPEDMODEL_PREC_BITS
            sx4 = x4 & ((1 << C.WARPEDMODEL_PREC_BITS) - 1)
            iy4 = y4 >> C.WARPEDMODEL_PREC_BITS
            sy4 = y4 & ((1 << C.WARPEDMODEL_PREC_BITS) - 1)
            sx4 += alpha * (-4) + beta * (-4)
            sy4 += gamma * (-4) + delta * (-4)
            sx4 &= ~((1 << WARP_PARAM_REDUCE_BITS) - 1)
            sy4 &= ~((1 << WARP_PARAM_REDUCE_BITS) - 1)
            # horizontal pass: 15 rows x 8 cols into tmp
            tmp = np.zeros((15, 8), np.int64)
            for kk in range(15):             # k + 7 for k = -7..7
                iy = min(max(iy4 + kk - 7, 0), rh - 1)
                sxv = sx4 + beta * (kk - 3) + alpha * ll
                offs = ((sxv + (1 << (C.WARPEDDIFF_PREC_BITS - 1)))
                        >> C.WARPEDDIFF_PREC_BITS) + 64
                coeffs = WARPED[np.clip(offs, 0, 192)]
                row = refi[iy]
                acc = np.zeros(8, np.int64)
                ixb = ix4 + ll - 4 - 3
                for m in range(8):
                    acc += coeffs[:, m] * row[np.clip(ixb + m,
                                                      0, rw - 1)]
                tmp[kk] = (acc + (1 << (r0 - 1))) >> r0
            # vertical pass
            for kk in range(bh):             # k + 4 for k = -4..
                syv = sy4 + delta * kk + gamma * ll[:bw]
                offs = ((syv + (1 << (C.WARPEDDIFF_PREC_BITS - 1)))
                        >> C.WARPEDDIFF_PREC_BITS) + 64
                coeffs = WARPED[np.clip(offs, 0, 192)]
                acc = np.zeros(bw, np.int64)
                for m in range(8):
                    acc += coeffs[:, m] * tmp[kk + m, :bw]
                out[i + kk, j:j + bw] = (acc + (1 << (r1 - 1))) >> r1
    if not is_compound:
        out = np.clip(out, 0, (1 << bd) - 1)
    return out.astype(np.int32)


LS_MV_MAX = 256
WARPEDMODEL_TRANS_CLAMP = 1 << 23
WARPEDMODEL_NONDIAG_CLAMP = 1 << 13


# LS accumulation terms, pinned against libaom 3.6's find_affine_int
# machine code (LS_STEP=8 folded in: each term is ((4a+16)(4b+16) +
# round) >> 6, i.e. the x8-unit sample coordinates are pre-scaled and
# the full downshift happens PER TERM -- there is no post-accumulation
# downshift or clamp, only range asserts).
def _ls_square(a: int) -> int:
    return (a * a * 4 + a * 32 + 128) >> 4


def _ls_product1(a: int, b: int) -> int:
    return (a * b * 4 + (a + b) * 16 + 64) >> 4


def _ls_product2(a: int, b: int) -> int:
    return (a * b * 4 + (a + b) * 16 + 128) >> 4


def warp_estimation(samples, mi_row, mi_col, bsize, mv):
    """Spec 7.11.3.8: least-squares local warp fit.  Returns
    (valid, mat[6])."""
    bw4, bh4 = C.BLOCK_W4[bsize], C.BLOCK_H4[bsize]
    mid_y = mi_row * 4 + bh4 * 2 - 1
    mid_x = mi_col * 4 + bw4 * 2 - 1
    su_y, su_x = mid_y * 8, mid_x * 8
    du_y, du_x = su_y + mv[0], su_x + mv[1]
    a00 = a01 = a11 = 0
    bx0 = bx1 = by0 = by1 = 0
    np_used = 0
    for (sy_, sx_, dy_, dx_) in samples:
        sx = sx_ - su_x
        sy = sy_ - su_y
        dx = dx_ - du_x
        dy = dy_ - du_y
        if abs(sx - dx) < LS_MV_MAX and abs(sy - dy) < LS_MV_MAX:
            a00 += _ls_square(sx)
            a01 += _ls_product1(sx, sy)
            a11 += _ls_square(sy)
            bx0 += _ls_product2(sx, dx)
            bx1 += _ls_product1(sy, dx)
            by0 += _ls_product1(sx, dy)
            by1 += _ls_product2(sy, dy)
            np_used += 1
    if np_used == 0:
        return False, None
    det = a00 * a11 - a01 * a01
    if det == 0:
        return False, None
    div_factor, div_shift = _resolve_divisor(det)
    div_shift -= C.WARPEDMODEL_PREC_BITS
    if div_shift < 0:
        div_factor <<= -div_shift
        div_shift = 0
    # clamp bounds pinned to libaom machine code: SYMMETRIC +/-
    # (CLAMP-1), i.e. the lower bound is -8191 / 57345, not -8192
    def diag(v):
        return max((1 << C.WARPEDMODEL_PREC_BITS) -
                   WARPEDMODEL_NONDIAG_CLAMP + 1,
                   min((1 << C.WARPEDMODEL_PREC_BITS) +
                       WARPEDMODEL_NONDIAG_CLAMP - 1, v))

    def nondiag(v):
        return max(-WARPEDMODEL_NONDIAG_CLAMP + 1,
                   min(WARPEDMODEL_NONDIAG_CLAMP - 1, v))

    mat = [0, 0, 1 << 16, 0, 0, 1 << 16]
    mat[2] = diag(_round2s((a11 * bx0 - a01 * bx1) * div_factor,
                           div_shift))
    mat[3] = nondiag(_round2s((-a01 * bx0 + a00 * bx1) * div_factor,
                              div_shift))
    mat[4] = nondiag(_round2s((a11 * by0 - a01 * by1) * div_factor,
                              div_shift))
    mat[5] = diag(_round2s((-a01 * by0 + a00 * by1) * div_factor,
                           div_shift))
    half = 1 << (C.WARPEDMODEL_PREC_BITS - 3)      # mv 1/8 px scale
    vx = mv[1] * half - (mid_x * (mat[2] -
                                  (1 << C.WARPEDMODEL_PREC_BITS)) +
                         mid_y * mat[3])
    vy = mv[0] * half - (mid_x * mat[4] +
                         mid_y * (mat[5] -
                                  (1 << C.WARPEDMODEL_PREC_BITS)))
    mat[0] = max(-WARPEDMODEL_TRANS_CLAMP,
                 min(WARPEDMODEL_TRANS_CLAMP - 1, vx))
    mat[1] = max(-WARPEDMODEL_TRANS_CLAMP,
                 min(WARPEDMODEL_TRANS_CLAMP - 1, vy))
    return True, mat


# ------------------------------------------------------------ block driver
def _ref_plane(fs, ref_enum: int, plane: int):
    rf = fs.refs[fs.fh.ref_frame_idx[ref_enum - C.LAST_FRAME]]
    return rf.planes[plane]


def _ref_frame(fs, ref_enum: int):
    return fs.refs[fs.fh.ref_frame_idx[ref_enum - C.LAST_FRAME]]


def _is_scaled(fs, ref_enum: int) -> bool:
    """Spec av1_is_scaled: the ref's stored (upscaled) geometry vs
    the CURRENT CODED (post-superres-downscale) geometry — with
    superres active every ref is scaled."""
    rf = _ref_frame(fs, ref_enum)
    return (rf.upscaled_width != fs.fh.width or
            rf.height != fs.fh.height)


def _block_warp_params(fs, b):
    """(use_warp, mat, shear) for one block — local fit (cached on
    the block) or the ref's global model."""
    fh = fs.fh
    if b.motion_mode == C.LOCALWARP:
        if b.warp_params is None:
            from ffpic_tpu_torch.coding.av1_inter import select_warp_samples
            sel = select_warp_samples(b.warp_samples or [],
                                      b.mvs2[0], b.bsize)
            ok, mat = warp_estimation(sel,
                                      b.mi_row, b.mi_col, b.bsize,
                                      b.mvs2[0])
            shear = setup_shear(mat) if ok else (False, 0, 0, 0, 0)
            b.warp_params = (ok and shear[0], mat, shear)
        return b.warp_params
    ref = b.refs[0]
    if (b.y_mode in (C.GLOBALMV, C.GLOBAL_GLOBALMV) and
            fh.gm_type[ref] > C.TRANSLATION and
            not fh.force_integer_mv and
            min(C.BLOCK_W4[b.bsize], C.BLOCK_H4[b.bsize]) * 4 >= 8
            and not _is_scaled(fs, ref)):
        mat = fh.gm_params[ref]
        shear = setup_shear(mat)
        return shear[0], mat, shear
    return False, None, None


def _pred_one_ref(fs, b, i, plane, px, py, pw, ph, sx, sy,
                  is_compound, mv=None, ref_enum=None, interp=None):
    """Prediction from one ref over a plane rect: warp when the
    block's motion model allows it and the plane rect is >= 8x8
    (spec 7.11.3.1 useWarp), else translational MC."""
    bd = fs.seq.bit_depth
    ref_enum = b.refs[i] if ref_enum is None else ref_enum
    mv = b.mvs2[i] if mv is None else mv
    interp = b.interp if interp is None else interp
    ref = _ref_plane(fs, ref_enum, plane)
    if pw >= 8 and ph >= 8 and not _is_scaled(fs, ref_enum):
        # libaom do_warp: warp never runs against a SCALED reference
        # (superres frames fall back to scaled translation even when
        # the syntax coded LOCALWARP)
        fh = fs.fh
        if i == 0 and b.motion_mode == C.LOCALWARP:
            wp = _block_warp_params(fs, b)
            if wp[0]:
                return warp_affine(ref, wp[1], wp[2], px, py, pw,
                                   ph, sx, sy, bd, is_compound)
        elif (b.y_mode in (C.GLOBALMV, C.GLOBAL_GLOBALMV) and
              fh.gm_type[ref_enum] > C.TRANSLATION and
              not fh.force_integer_mv and
              min(C.BLOCK_W4[b.bsize],
                  C.BLOCK_H4[b.bsize]) * 4 >= 8 and
              not _is_scaled(fs, ref_enum)):
            shear = setup_shear(fh.gm_params[ref_enum])
            if shear[0]:
                return warp_affine(ref, fh.gm_params[ref_enum],
                                   shear, px, py, pw, ph, sx, sy,
                                   bd, is_compound)
    return _mc_any(fs, ref_enum, plane, px, py, pw, ph, mv, sx,
                   sy, interp, bd, is_compound)


def _blend_compound(fs, b, p0, p1, plane, luma_mask, bd):
    """Compound blend in the InterRound1 domain -> pixel domain.
    luma_mask: the wedge/diffwtd mask at luma resolution (None for
    average / distance modes)."""
    seq, fh = fs.seq, fs.fh
    post = 2 * 7 - sum(rounds(bd, True)) + 1     # InterPostRound
    if b.comp_group_idx == 0:
        if b.compound_idx:
            out = _round2(p0.astype(np.int64) + p1, post)
        else:
            w0, w1 = dist_weights(seq, fh, b.refs[0], b.refs[1])
            out = _round2(p0.astype(np.int64) * w0 +
                          p1.astype(np.int64) * w1, post + 4 - 1)
    else:
        msk = luma_mask
        if plane:
            msk = _subsample_mask(msk, seq.subsampling_x,
                                  seq.subsampling_y)
        out = _round2(p0.astype(np.int64) * msk +
                      p1.astype(np.int64) * (64 - msk),
                      post + 6 - 1)
    return np.clip(out, 0, (1 << bd) - 1).astype(np.int32)


def _subsample_mask(msk, sx, sy):
    """Spec 7.11.3.14: average-subsample a luma mask for chroma."""
    if sx and sy:
        m = (msk[0::2, 0::2].astype(np.int32) +
             msk[0::2, 1::2] + msk[1::2, 0::2] + msk[1::2, 1::2])
        return (m + 2) >> 2
    if sx:
        return (msk[:, 0::2].astype(np.int32) + msk[:, 1::2] + 1) >> 1
    if sy:
        return (msk[0::2].astype(np.int32) + msk[1::2] + 1) >> 1
    return msk.astype(np.int32)


def predict_inter_block(fs, planes, b):
    """Whole-block inter prediction written into the working planes
    (spec 7.11.3.1): per-plane MC (with the sub-8x8 chroma
    combination), compound blending, smooth/wedge interintra, and
    OBMC overlap blending."""
    from ffpic_tpu_torch.formats import av1_intra as intra
    seq, fh = fs.seq, fs.fh
    bd = seq.bit_depth
    r, c = b.mi_row, b.mi_col
    bw4, bh4 = C.BLOCK_W4[b.bsize], C.BLOCK_H4[b.bsize]
    is_compound = b.refs[1] > C.INTRA_FRAME
    nplanes = seq.num_planes if b.has_chroma else 1
    luma_mask = None
    for plane in range(nplanes):
        sx = seq.subsampling_x if plane else 0
        sy = seq.subsampling_y if plane else 0
        px = (c * 4) >> sx
        py = (r * 4) >> sy
        pw = max(1, bw4 >> sx) * 4
        ph = max(1, bh4 >> sy) * 4
        if plane and ((bw4 == 1 and sx) or (bh4 == 1 and sy)):
            if _sub8x8_chroma(fs, planes[plane], b, plane, sx, sy):
                continue
            # fall through: whole chroma rect from this block's mv
            px = ((c - (c & sx if bw4 == 1 else 0)) * 4) >> sx
            py = ((r - (r & sy if bh4 == 1 else 0)) * 4) >> sy
        p0 = _pred_one_ref(fs, b, 0, plane, px, py, pw, ph, sx, sy,
                           is_compound)
        if is_compound:
            p1 = _pred_one_ref(fs, b, 1, plane, px, py, pw, ph,
                               sx, sy, True)
            if plane == 0 and b.comp_group_idx:
                if b.compound_type == C.COMPOUND_WEDGE:
                    luma_mask = wedge_mask(b.bsize, b.wedge_index,
                                           b.wedge_sign)
                else:
                    luma_mask = diffwtd_mask(p0, p1, b.mask_type, bd)
            out = _blend_compound(fs, b, p0, p1, plane, luma_mask,
                                  bd)
        elif b.interintra:
            # intra part from reconstructed neighbors, blended with
            # the inter prediction (7.11.3.13)
            mode = C.INTERINTRA_TO_INTRA[b.ii_mode]
            arr = planes[plane]
            max_x = (fs.mi_cols * 4) >> sx
            max_y = (fs.mi_rows * 4) >> sy
            ip = intra.predict(
                arr, px, py, pw, ph, mode, 0, -1,
                b.avail_lc if plane else b.avail_l,
                b.avail_uc if plane else b.avail_u,
                False, False, max_x - 1, max_y - 1, bd,
                seq.enable_intra_edge_filter, 0)
            if b.ii_wedge:
                msk = wedge_mask(b.bsize, b.wedge_index, 0)
                if plane:
                    msk = _subsample_mask(msk, sx, sy)
            else:
                msk = interintra_mask(pw, ph, b.ii_mode)
            out = _round2(ip.astype(np.int64) * msk +
                          p0.astype(np.int64) * (64 - msk), 6)
            out = np.clip(out, 0, (1 << bd) - 1).astype(np.int32)
        else:
            out = p0
        planes[plane][py:py + ph, px:px + pw] = out
    if b.motion_mode == C.OBMC_CAUSAL:
        _obmc(fs, planes, b)


def _sub8x8_chroma(fs, plane_arr, b, plane, sx, sy) -> bool:
    """Chroma prediction for sub-8x8 blocks combines the covering
    luma blocks' motion when ALL of them are inter (7.11.3.1 /
    dav1d's is_sub8x8 contract).  Returns True when handled."""
    seq = fs.seq
    bd = seq.bit_depth
    r, c = b.mi_row, b.mi_col
    bw4, bh4 = C.BLOCK_W4[b.bsize], C.BLOCK_H4[b.bsize]
    left = bw4 == 1 and sx
    above = bh4 == 1 and sy
    cells = []
    if left and above:
        cells = [(r - 1, c - 1), (r - 1, c), (r, c - 1), (r, c)]
    elif left:
        cells = [(r, c - 1), (r, c)]
    elif above:
        cells = [(r - 1, c), (r, c)]
    for (mr, mc_) in cells:
        if int(fs.ref_frame[mr, mc_, 0]) <= C.INTRA_FRAME:
            return False
    # chroma origin of the 8x8 group
    gy = ((r - (r & sy if bh4 == 1 else 0)) * 4) >> sy
    gx = ((c - (c & sx if bw4 == 1 else 0)) * 4) >> sx
    qh = 4 >> (1 - (bh4 == 1 and sy))    # quadrant h: 2 if split
    qw = 4 >> (1 - (bw4 == 1 and sx))
    qh = 2 if above else 4
    qw = 2 if left else 4
    for (mr, mc_) in cells:
        dy = (mr - (r - 1 if above else r)) if above else 0
        dx = (mc_ - (c - 1 if left else c)) if left else 0
        mv = [int(fs.mv2[mr, mc_, 0, 0]), int(fs.mv2[mr, mc_, 0, 1])]
        ref_enum = int(fs.ref_frame[mr, mc_, 0])
        interp = [int(fs.interp[mr, mc_, 0]),
                  int(fs.interp[mr, mc_, 1])]
        oy = gy + dy * qh
        ox = gx + dx * qw
        pred = _mc_any(fs, ref_enum, plane,
                       ox, oy, qw, qh, mv, sx, sy, interp, bd,
                       False)
        plane_arr[oy:oy + qh, ox:ox + qw] = pred
    return True


def _obmc(fs, planes, b):
    """Overlapped block motion compensation (spec 7.11.3.9/10):
    blend the current prediction with re-predictions from up to 4
    above and 4 left inter neighbors."""
    seq = fs.seq
    bd = seq.bit_depth
    r, c = b.mi_row, b.mi_col
    bw4, bh4 = C.BLOCK_W4[b.bsize], C.BLOCK_H4[b.bsize]
    r0_t, r1_t, c0_t, c1_t = b.tile
    nplanes = seq.num_planes if b.has_chroma else 1

    def mask_for(length):
        return OBMC_MASK[length.bit_length() - 2, :length] \
            .astype(np.int64)

    if r > r0_t and min(bw4, bh4) * 4 >= 8:
        count = 0
        limit = min(4, bw4.bit_length() - 1 + (bw4 > 1))
        limit = min(4, max(1, bw4 >> 1))
        x4 = 0
        while x4 < min(bw4, c1_t - c) and count < limit:
            mc_ = min((c + x4) | 1, fs.mi_cols - 1)
            cand_bs = int(fs.bsize[r - 1, mc_])
            cand_w4 = C.BLOCK_W4[cand_bs]
            step = max(cand_w4, 2)
            if int(fs.ref_frame[r - 1, mc_, 0]) > C.INTRA_FRAME:
                count += 1
                ow4 = min(bw4, cand_w4, 16)
                oh4 = min(bh4, 16) >> 1
                oh4 = min(oh4, 8)            # 32 px cap
                mv = [int(fs.mv2[r - 1, mc_, 0, 0]),
                      int(fs.mv2[r - 1, mc_, 0, 1])]
                ref_enum = int(fs.ref_frame[r - 1, mc_, 0])
                interp = [int(fs.interp[r - 1, mc_, 0]),
                          int(fs.interp[r - 1, mc_, 1])]
                for plane in range(nplanes):
                    sx = seq.subsampling_x if plane else 0
                    sy = seq.subsampling_y if plane else 0
                    # above-pass chroma gate (libaom
                    # av1_skip_u4x4_pred_in_obmc dir==0 / dav1d
                    # obmc): small chroma blocks (4x4/8x4/4x8, i.e.
                    # bw4*hmul + bh4*vmul < 16) skip the ABOVE
                    # blend only — the left pass still applies
                    if plane and (bw4 * (4 >> sx) +
                                  bh4 * (4 >> sy) < 16):
                        continue
                    pw = max(1, (ow4 * 4) >> sx)
                    ph = max(1, (oh4 * 4) >> sy)
                    if pw < 2 or ph < 2:
                        continue
                    px = ((c + x4) * 4) >> sx
                    py = (r * 4) >> sy
                    pred = _mc_any(
                        fs, ref_enum, plane,
                        px, py, pw, ph, mv, sx, sy, interp, bd,
                        False).astype(np.int64)
                    m = mask_for(ph)[:, None]
                    cur = planes[plane][py:py + ph,
                                        px:px + pw].astype(np.int64)
                    planes[plane][py:py + ph, px:px + pw] = \
                        _round2(m * cur + (64 - m) * pred, 6)
            x4 += step
    if c > c0_t and min(bw4, bh4) * 4 >= 8:
        count = 0
        limit = min(4, max(1, bh4 >> 1))
        y4 = 0
        while y4 < min(bh4, r1_t - r) and count < limit:
            mr = min((r + y4) | 1, fs.mi_rows - 1)
            cand_bs = int(fs.bsize[mr, c - 1])
            cand_h4 = C.BLOCK_H4[cand_bs]
            step = max(cand_h4, 2)
            if int(fs.ref_frame[mr, c - 1, 0]) > C.INTRA_FRAME:
                count += 1
                oh4 = min(bh4, cand_h4, 16)
                ow4 = min(min(bw4, 16) >> 1, 8)
                mv = [int(fs.mv2[mr, c - 1, 0, 0]),
                      int(fs.mv2[mr, c - 1, 0, 1])]
                ref_enum = int(fs.ref_frame[mr, c - 1, 0])
                interp = [int(fs.interp[mr, c - 1, 0]),
                          int(fs.interp[mr, c - 1, 1])]
                for plane in range(nplanes):
                    sx = seq.subsampling_x if plane else 0
                    sy = seq.subsampling_y if plane else 0
                    pw = max(1, (ow4 * 4) >> sx)
                    ph = max(1, (oh4 * 4) >> sy)
                    if pw < 2 or ph < 2:
                        continue
                    px = (c * 4) >> sx
                    py = ((r + y4) * 4) >> sy
                    pred = _mc_any(
                        fs, ref_enum, plane,
                        px, py, pw, ph, mv, sx, sy, interp, bd,
                        False).astype(np.int64)
                    m = mask_for(pw)[None, :]
                    cur = planes[plane][py:py + ph,
                                        px:px + pw].astype(np.int64)
                    planes[plane][py:py + ph, px:px + pw] = \
                        _round2(m * cur + (64 - m) * pred, 6)
            y4 += step
