"""AV1 decoder-level reference-frame state: slot snapshots, order
hints, motion-field projection, and the frame-end update process
(spec 7.8/7.9/7.19/7.20/7.21).

The C reference (junka/ffpic) has no AV1 layer at all
(format/avif.c:382-405 is a stub); dav1d is the conformance oracle
for everything here (tests/test_av1_inter.py).  The motion-field
machinery follows the spec via dav1d's equivalent formulation: the
projection pass stores (source mv, source->its-ref distance) in one
projected 8x8 grid, and candidates re-project per target ref at
lookup time with Div_Mult — bit-identical to the spec's per-ref
MotionFieldMvs because get_mv_projection is linear in the numerator.

Copied from ``ffpic_tpu/coding/av1_refs.py`` for the PyTorch port whole,
with its imports rewritten to the port's modules (``parse_frame_header``
imports it for every frame).
"""

from __future__ import annotations

import numpy as np

from ffpic_tpu_torch.coding import av1_consts as C
from ffpic_tpu_torch.coding.av1_mc_tables import TABLES as MC

DIV_MULT = MC["div_mult"]          # Div_Mult[32] (spec 7.9.3)
INVALID_REF = 0                    # rp ref slot 0 = no saved mv
REFMVS_LIMIT = (1 << 12) - 1       # spec: saved |mv| bound


def get_relative_dist(seq, a: int, b: int) -> int:
    """Spec 5.9.3 get_relative_dist (wrapping order-hint delta)."""
    if not seq.enable_order_hint:
        return 0
    diff = a - b
    m = 1 << (seq.order_hint_bits - 1)
    return (diff & (m - 1)) - (diff & m)


def mv_projection(mv, num: int, den: int):
    """Spec 7.9.3 get_mv_projection: scale mv by num/den with the
    Div_Mult reciprocal table, round-to-even-ish clip per spec."""
    den = min(den, C.MAX_FRAME_DISTANCE)
    num = max(-C.MAX_FRAME_DISTANCE, min(C.MAX_FRAME_DISTANCE, num))
    frac = num * int(DIV_MULT[den])
    out = []
    for v in mv:
        s = int(v) * frac
        # Round2Signed(s, 14) then clip (spec 7.9.3)
        r = ((abs(s) + 8192) >> 14) * (1 if s >= 0 else -1)
        out.append(max(-(1 << 14) + 1, min((1 << 14) - 1, r)))
    return out


def lower_mv_precision(fh, mv):
    """Spec 7.10.2.10: reduce candidate precision per frame flags."""
    out = list(mv)
    for i in range(2):
        v = out[i]
        if fh.force_integer_mv:
            a = abs(v)
            a2 = ((a + 3) >> 3) << 3
            v = a2 if v >= 0 else -a2
        elif not fh.allow_high_precision_mv:
            if v & 1:
                v += -1 if v > 0 else 1
        out[i] = v
    return out


class RefFrame:
    """One reference slot: the decoded frame plus the side state the
    spec saves with it (7.20)."""

    __slots__ = ("planes", "width", "height", "upscaled_width",
                 "render_width", "render_height", "mi_rows",
                 "mi_cols", "frame_type", "order_hint",
                 "order_hints", "mvs8", "ref8", "seg_ids", "cdfs",
                 "gm_params", "lf_ref_deltas", "lf_mode_deltas",
                 "feature_enabled", "feature_data", "bit_depth",
                 "showable", "subsampling", "grain")

    def intra_only(self) -> bool:
        return self.frame_type in (C.KEY_FRAME, C.INTRA_ONLY_FRAME)


def save_frame_state(seq, fh, fs, planes, cdfs) -> RefFrame:
    """Build the RefFrame snapshot for this decoded frame: planes +
    motion field storage (spec 7.19) + saved params (7.20)."""
    rf = RefFrame()
    rf.planes = [p.copy() for p in planes]
    rf.width, rf.height = fh.width, fh.height
    rf.upscaled_width = fh.upscaled_width
    rf.render_width, rf.render_height = fh.render_width, \
        fh.render_height
    rf.mi_rows, rf.mi_cols = fh.mi_rows, fh.mi_cols
    rf.frame_type = fh.frame_type
    rf.order_hint = fh.order_hint
    rf.order_hints = list(getattr(fh, "order_hints", [0] * 8))
    rf.bit_depth = seq.bit_depth
    rf.subsampling = (seq.subsampling_x, seq.subsampling_y)
    rf.seg_ids = fs.seg.copy()
    rf.cdfs = cdfs
    rf.gm_params = [list(g) for g in getattr(
        fh, "gm_params", [[0] * 6 for _ in range(8)])]
    rf.lf_ref_deltas = list(fh.loop_filter_ref_deltas)
    rf.lf_mode_deltas = list(fh.loop_filter_mode_deltas)
    rf.feature_enabled = [list(r) for r in fh.feature_enabled] \
        if fh.feature_enabled else [[0] * 8 for _ in range(8)]
    rf.feature_data = [list(r) for r in fh.feature_data] \
        if fh.feature_data else [[0] * 8 for _ in range(8)]
    rf.showable = True
    rf.grain = getattr(fh, "grain", None)
    # --- motion field storage (7.19): per 8x8, sample the mi at the
    # odd/odd position; store the mv of ref list 1 if it points to a
    # strictly-past frame and is within REFMVS_LIMIT, else list 0,
    # else nothing.  ref8 stores the ref enum (1..7), 0 = none.
    h8, w8 = fh.mi_rows >> 1, fh.mi_cols >> 1
    rf.mvs8 = np.zeros((h8, w8, 2), np.int16)
    rf.ref8 = np.zeros((h8, w8), np.uint8)
    if not fh.frame_is_intra and h8 and w8:
        past = np.zeros(8, bool)          # ref enum -> is past frame
        for r in range(1, 8):
            past[r] = get_relative_dist(
                seq, fh.order_hints[r], fh.order_hint) < 0
        rows = np.minimum(np.arange(h8) * 2 + 1, fh.mi_rows - 1)
        cols = np.minimum(np.arange(w8) * 2 + 1, fh.mi_cols - 1)
        refs = fs.ref_frame[rows[:, None], cols[None, :]]   # (h8,w8,2)
        mvs = fs.mv2[rows[:, None], cols[None, :]]          # (h8,w8,2,2)
        for lst in (1, 0):
            r = refs[:, :, lst].astype(np.int32)
            ok = (r > C.INTRA_FRAME) & past[np.clip(r, 0, 7)] & \
                (np.abs(mvs[:, :, lst]).max(axis=2) <= REFMVS_LIMIT) \
                & (rf.ref8 == 0)
            rf.mvs8[ok] = mvs[:, :, lst][ok]
            rf.ref8[ok] = r[ok]
    return rf


def update_ref_slots(refs: list, fh, rf: RefFrame) -> None:
    """Spec 7.20: store rf into every slot whose refresh bit is set."""
    for i in range(C.NUM_REF_FRAMES):
        if (fh.refresh_frame_flags >> i) & 1:
            refs[i] = rf


class MotionField:
    """Current-frame projected temporal MVs (spec 7.9 / dav1d
    load_tmvs): rp_mv (h8, w8, 2) + rp_ref (h8, w8) where rp_ref is
    the source->its-ref distance (0 = invalid), plus pocdiff[8] for
    re-projection per target ref at candidate-lookup time."""

    def __init__(self, seq, fh, refs):
        h8, w8 = fh.mi_rows >> 1, fh.mi_cols >> 1
        self.h8, self.w8 = h8, w8
        self.rp_mv = np.zeros((h8, w8, 2), np.int16)
        self.rp_ref = np.zeros((h8, w8), np.int16)
        # pocdiff[ref enum] = dist(cur, ref) clamped
        self.pocdiff = [0] * 8
        for r in range(1, 8):
            self.pocdiff[r] = max(-31, min(31, get_relative_dist(
                seq, fh.order_hint, fh.order_hints[r])))
        if not fh.use_ref_frame_mvs or not seq.enable_order_hint:
            return
        # --- select up to MFMV_STACK_SIZE source frames (7.9.1)
        def slot(ref_enum):
            return refs[fh.ref_frame_idx[ref_enum - C.LAST_FRAME]]

        mfmv = []                      # (ref_enum, ref2cur, ref2ref[8])
        total = 2
        last = slot(C.LAST_FRAME)
        if last is not None and not last.intra_only() and \
                last.order_hints[C.ALTREF_FRAME] != \
                fh.order_hints[C.GOLDEN_FRAME]:
            mfmv.append(C.LAST_FRAME)
            total = 3
        if get_relative_dist(seq, fh.order_hints[C.BWDREF_FRAME],
                             fh.order_hint) > 0 and \
                slot(C.BWDREF_FRAME) is not None and \
                not slot(C.BWDREF_FRAME).intra_only():
            mfmv.append(C.BWDREF_FRAME)
        if get_relative_dist(seq, fh.order_hints[C.ALTREF2_FRAME],
                             fh.order_hint) > 0 and \
                slot(C.ALTREF2_FRAME) is not None and \
                not slot(C.ALTREF2_FRAME).intra_only():
            mfmv.append(C.ALTREF2_FRAME)
        if len(mfmv) < total and get_relative_dist(
                seq, fh.order_hints[C.ALTREF_FRAME],
                fh.order_hint) > 0 and \
                slot(C.ALTREF_FRAME) is not None and \
                not slot(C.ALTREF_FRAME).intra_only():
            mfmv.append(C.ALTREF_FRAME)
        if len(mfmv) < 3 and slot(C.LAST2_FRAME) is not None and \
                not slot(C.LAST2_FRAME).intra_only():
            mfmv.append(C.LAST2_FRAME)
        # --- project each source frame's saved mvs into this frame
        for ref_enum in mfmv:
            src = slot(ref_enum)
            if src is None or src.mi_rows != fh.mi_rows or \
                    src.mi_cols != fh.mi_cols:
                continue
            src_hint = fh.order_hints[ref_enum]
            ref2cur = get_relative_dist(seq, src_hint, fh.order_hint)
            if abs(ref2cur) > C.MAX_FRAME_DISTANCE:
                continue
            # sign: forward sources (LAST/LAST2) project with -1
            dst_sign = -1 if ref_enum < C.BWDREF_FRAME else 1
            ref2cur = -ref2cur if ref_enum < C.BWDREF_FRAME else \
                ref2cur
            # distances from src frame to each of ITS refs
            ref2ref = [0] * 8
            for m in range(1, 8):
                d = get_relative_dist(seq, src_hint,
                                      src.order_hints[m])
                if 0 < d <= C.MAX_FRAME_DISTANCE:
                    ref2ref[m] = d
            self._project(src, ref2cur, ref2ref, dst_sign)

    def _project(self, src: RefFrame, ref2cur: int, ref2ref: list,
                 dst_sign: int) -> None:
        """One source frame's projection pass (7.9.2, vectorized)."""
        h8, w8 = self.h8, self.w8
        sref = src.ref8[:h8, :w8].astype(np.int32)
        r2r = np.array(ref2ref, np.int32)[np.clip(sref, 0, 7)]
        valid = (sref > 0) & (r2r > 0)
        if not valid.any():
            return
        ys, xs = np.nonzero(valid)
        mvs = src.mvs8[ys, xs].astype(np.int64)
        den = r2r[ys, xs].astype(np.int64)
        frac = ref2cur * DIV_MULT[den]
        proj = mvs * frac[:, None]
        proj = np.where(proj >= 0, (proj + 8192) >> 14,
                        -((-proj + 8192) >> 14))
        proj = np.clip(proj, -(1 << 14) + 1, (1 << 14) - 1)
        # offset in 8x8 units; dst_sign flips direction
        off = np.where(proj >= 0, proj >> 6, -((-proj) >> 6)) * \
            dst_sign
        pos_y = ys + off[:, 0]
        pos_x = xs + off[:, 1]
        # spec get_block_position: y stays in its own 8-aligned group
        # (MAX_OFFSET_HEIGHT=0); x may stray one group each way
        # (MAX_OFFSET_WIDTH=8)
        base_y = ys & ~7
        base_x = xs & ~7
        ok = (pos_y >= 0) & (pos_y < h8) & (pos_x >= 0) & \
            (pos_x < w8) & (pos_y >= base_y) & (pos_y < base_y + 8) \
            & (pos_x >= base_x - 8) & (pos_x < base_x + 16)
        ys, xs = ys[ok], xs[ok]
        self.rp_mv[pos_y[ok], pos_x[ok]] = src.mvs8[ys, xs]
        self.rp_ref[pos_y[ok], pos_x[ok]] = den[ok]

    def candidate(self, fh, y8: int, x8: int, ref_enum: int):
        """Projected temporal mv for one target ref at (y8, x8), or
        None (spec add_tpl_ref_mv's MotionFieldMvs lookup)."""
        d = int(self.rp_ref[y8, x8])
        if d == 0:
            return None
        mv = mv_projection(self.rp_mv[y8, x8],
                           self.pocdiff[ref_enum], d)
        return lower_mv_precision(fh, mv)


# ------------------------------------------------------------ global motion
def gm_get_motion_vector(gm, gm_type: int, fh, bsize: int,
                         mi_col: int, mi_row: int):
    """Spec 7.10.2.1 setup_global_mv core: the mv (1/8 px, (row,
    col)) a global-motion model produces at this block's center."""
    if gm_type == C.IDENTITY:
        return [0, 0]
    if gm_type == C.TRANSLATION:
        mv = [gm[0] >> (C.WARPEDMODEL_PREC_BITS - 3),
              gm[1] >> (C.WARPEDMODEL_PREC_BITS - 3)]
        return lower_mv_precision(fh, mv)
    bw4, bh4 = C.BLOCK_W4[bsize], C.BLOCK_H4[bsize]
    x = mi_col * 4 + bw4 * 2 - 1
    y = mi_row * 4 + bh4 * 2 - 1
    xc = (gm[2] - (1 << C.WARPEDMODEL_PREC_BITS)) * x + gm[3] * y \
        + gm[0]
    yc = gm[4] * x + (gm[5] - (1 << C.WARPEDMODEL_PREC_BITS)) * y \
        + gm[1]
    shift = C.WARPEDMODEL_PREC_BITS - 3
    if fh.allow_high_precision_mv:
        mv = [_round2s(yc, shift), _round2s(xc, shift)]
    else:
        mv = [_round2s(yc, shift + 1) * 2, _round2s(xc, shift + 1) * 2]
    return lower_mv_precision(fh, mv)


def _round2s(v: int, n: int) -> int:
    if v >= 0:
        return (v + (1 << (n - 1))) >> n
    return -((-v + (1 << (n - 1))) >> n)
