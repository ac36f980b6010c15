"""HEVC inter-prediction motion derivation (ITU-T H.265 8.5.3):
merge candidate list, AMVP predictor list, temporal MVP and MV
scaling, over a per-picture 4x4-granularity motion field.

Derivation is pure decode-order state — no pixel dependency — so it
runs inline during the CABAC syntax pass (coding/hevc_slice.py) and
the resulting per-PU motion is emitted as InterOp entries whose
motion compensation (formats/hevc_mc.py) batches freely afterwards:
inter prediction reads only *reference* pictures, never the current
one, which is the TPU-friendly seam (all MC for a picture is one
gather+filter batch; only intra blocks need the host wavefront).

The C reference parses inter syntax and discards it
(its coding/hevc.c:6285-6397) — this module is
beyond-reference surface, validated bit-exactly against libde265
(tests/test_hevc_inter_decode.py).

Copied from ``ffpic_tpu/coding/hevc_inter.py`` for the PyTorch port,
unchanged: host numpy, as the original is (no device program reads the
motion field).  The motion field keeps POCs, not reference indices, and
``MotionDeriver._ridx`` maps a POC back to its first index in the list,
as the original does (``ROADMAP.md`` Queue 3).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

NO_REF = -(1 << 30)          # sentinel POC for "no reference"


def _clip3(lo, hi, v):
    return lo if v < lo else (hi if v > hi else v)


class MotionField:
    """Per-picture motion at 4x4 luma granularity.

    mv[list, y4, x4, 0:2] — quarter-pel (x, y)
    refpoc[list, y4, x4]  — POC of the reference picture or NO_REF
    (storing the POC rather than the ref index makes temporal MVP
    scaling and deblock bS comparison independent of the collocated
    picture's reference lists, 8.5.3.2.8 / 8.7.2.4)
    """

    def __init__(self, w: int, h: int):
        mh, mw = (h + 3) // 4, (w + 3) // 4
        self.mv = np.zeros((2, mh, mw, 2), np.int16)
        self.refpoc = np.full((2, mh, mw), NO_REF, np.int32)

    def stamp(self, x0, y0, w, h, m: "PuMotion") -> None:
        ys, xs = slice(y0 // 4, (y0 + h) // 4), \
            slice(x0 // 4, (x0 + w) // 4)
        for lx in range(2):
            if m.pred[lx]:
                self.mv[lx, ys, xs] = m.mv[lx]
                self.refpoc[lx, ys, xs] = m.poc[lx]
            else:
                self.mv[lx, ys, xs] = 0
                self.refpoc[lx, ys, xs] = NO_REF


@dataclass
class PuMotion:
    """Motion of one prediction unit (both lists)."""
    mv: list = field(default_factory=lambda: [(0, 0), (0, 0)])
    poc: list = field(default_factory=lambda: [NO_REF, NO_REF])
    ref_idx: list = field(default_factory=lambda: [-1, -1])
    pred: list = field(default_factory=lambda: [False, False])

    def same_motion(self, o: "PuMotion") -> bool:
        """Merge-pruning comparison (mv + refIdx per list,
        8.5.3.2.3)."""
        for lx in range(2):
            if self.pred[lx] != o.pred[lx]:
                return False
            if self.pred[lx] and (self.mv[lx] != o.mv[lx]
                                  or self.ref_idx[lx] != o.ref_idx[lx]):
                return False
        return True


@dataclass
class InterSliceCtx:
    """Everything the in-parse motion derivation needs for one slice."""
    poc: int
    # per list: [(poc, Picture, long_term)] — RefPicListX (8.3.4)
    ref_list: list = field(default_factory=lambda: [[], []])
    field_: MotionField | None = None          # current picture's field
    temporal_mvp: bool = False
    col_field: MotionField | None = None       # collocated picture
    col_poc: int = 0
    col_from_l0: bool = True                   # collocated_from_l0_flag
    max_merge: int = 5
    par_mrg_level: int = 2                     # Log2ParMrgLevel
    slice_type: int = 1                        # 0=B 1=P
    mvd_l1_zero: bool = False
    ctb_log2: int = 6
    pic_w: int = 0
    pic_h: int = 0
    # weight table: (luma_log2_denom, chroma_log2_denom,
    #                wp[list][ref] = (wY,oY,wCb,oCb,wCr,oCr) | None)
    wp: tuple | None = None

    def no_backward(self) -> bool:
        """NoBackwardPredFlag (8.5.3.2.9): every reference POC in both
        lists <= current POC."""
        for lst in self.ref_list:
            for poc, _pic, _lt in lst:
                if poc > self.poc:
                    return False
        return True


def scale_mv(mv, tb: int, td: int):
    """8.5.3.2.8 temporal/POC-distance MV scaling."""
    td = _clip3(-128, 127, td)
    tb = _clip3(-128, 127, tb)
    num = 16384 + (abs(td) >> 1)
    tx = num // td if td > 0 else -(num // -td)
    dsf = _clip3(-4096, 4095, (tb * tx + 32) >> 6)
    out = []
    for c in mv:
        p = dsf * c
        v = (abs(p) + 127) >> 8
        out.append(_clip3(-32768, 32767, -v if p < 0 else v))
    return (out[0], out[1])


class MotionDeriver:
    """Merge (8.5.3.2.3) + AMVP (8.5.3.2.10) candidate derivation.

    `sd` is the SliceDecoder: supplies the availability zone map and
    the decoded/intra 4x4 maps (z-scan availability 6.4.1/6.4.2 via
    the decode-order stamps)."""

    def __init__(self, sd, ctx: InterSliceCtx):
        self.sd = sd
        self.ctx = ctx
        self.fld = ctx.field_

    # -- availability -----------------------------------------------------
    def _pb_avail(self, xNb, yNb, xCb, yCb, nCbS, nPbW, nPbH,
                  part_idx):
        """6.4.2 prediction-block availability (+ MODE_INTRA check)."""
        sd = self.sd
        if xNb < 0 or yNb < 0 or xNb >= self.ctx.pic_w \
                or yNb >= self.ctx.pic_h:
            return False
        same_cb = (xCb <= xNb < xCb + nCbS
                   and yCb <= yNb < yCb + nCbS)
        if not same_cb:
            # 6.4.1 z-scan availability: decoded (stamped in decode
            # order) and same slice+tile zone
            if not sd.decoded_map[yNb // 4, xNb // 4]:
                return False
            if sd.zone[yNb // 4, xNb // 4] != sd.cur_zone:
                return False
        elif ((nPbW << 1) == nCbS and (nPbH << 1) == nCbS
                and part_idx == 1 and yCb + nPbH <= yNb
                and xCb + nPbW > xNb):
            return False               # NxN partIdx1 below-left quadrant
        if sd.intra_map[yNb // 4, xNb // 4]:
            return False
        return True

    def _nb_motion(self, xNb, yNb) -> PuMotion:
        fld = self.fld
        m = PuMotion()
        y4, x4 = yNb // 4, xNb // 4
        for lx in range(2):
            poc = int(fld.refpoc[lx, y4, x4])
            if poc != NO_REF:
                m.pred[lx] = True
                m.poc[lx] = poc
                m.mv[lx] = (int(fld.mv[lx, y4, x4, 0]),
                            int(fld.mv[lx, y4, x4, 1]))
                m.ref_idx[lx] = self._ridx(lx, poc)
        return m

    def _ridx(self, lx, poc):
        for i, (p, _pic, _lt) in enumerate(self.ctx.ref_list[lx]):
            if p == poc:
                return i
        return 0

    # -- merge (8.5.3.2.3) -------------------------------------------------
    def merge_candidates(self, xCb, yCb, nCbS, xPb, yPb, nPbW, nPbH,
                         part_idx, part_mode):
        ctx = self.ctx
        # parallel merge window (8.5.3.2.3) + singleMCLFlag
        if ctx.par_mrg_level > 2 and nCbS == 8:
            xPb, yPb, nPbW, nPbH = xCb, yCb, nCbS, nCbS
            part_idx = 0
            part_mode = 0
        cands: list[PuMotion] = []

        def in_par_window(xNb, yNb):
            pl = ctx.par_mrg_level
            return (pl > 2 and (xPb >> pl) == (xNb >> pl)
                    and (yPb >> pl) == (yNb >> pl))

        def spatial(xNb, yNb, excluded):
            if excluded or in_par_window(xNb, yNb):
                return None
            if not self._pb_avail(xNb, yNb, xCb, yCb, nCbS,
                                  nPbW, nPbH, part_idx):
                return None
            return self._nb_motion(xNb, yNb)

        # A1
        a1 = spatial(xPb - 1, yPb + nPbH - 1,
                     part_idx == 1 and part_mode in (2, 6, 7))
        if a1 is not None:
            cands.append(a1)
        # B1 (pruned vs A1's motion — the comparison target is the
        # neighbor's motion whether or not it entered the list)
        b1 = spatial(xPb + nPbW - 1, yPb - 1,
                     part_idx == 1 and part_mode in (1, 4, 5))
        if b1 is not None and not (a1 is not None
                                   and b1.same_motion(a1)):
            cands.append(b1)
        # B0 (pruned vs B1)
        b0 = spatial(xPb + nPbW, yPb - 1, False)
        if b0 is not None and not (b1 is not None
                                   and b0.same_motion(b1)):
            cands.append(b0)
        # A0 (pruned vs A1)
        a0 = spatial(xPb - 1, yPb + nPbH, False)
        if a0 is not None and not (a1 is not None
                                   and a0.same_motion(a1)):
            cands.append(a0)
        # B2 (only when < 4, pruned vs A1 and B1)
        if len(cands) < 4:
            b2 = spatial(xPb - 1, yPb - 1, False)
            if b2 is not None \
                    and not (a1 is not None and b2.same_motion(a1)) \
                    and not (b1 is not None and b2.same_motion(b1)):
                cands.append(b2)

        # temporal (8.5.3.2.7, refIdx 0 both lists)
        if ctx.temporal_mvp and len(cands) < ctx.max_merge:
            t = PuMotion()
            ok = False
            for lx in range(2 if ctx.slice_type == 0 else 1):
                r = self._temporal_mv(xPb, yPb, nPbW, nPbH, lx, 0)
                if r is not None:
                    t.pred[lx] = True
                    t.mv[lx] = r
                    t.ref_idx[lx] = 0
                    t.poc[lx] = ctx.ref_list[lx][0][0]
                    ok = True
            if ok:
                cands.append(t)

        # combined bi-predictive (8.5.3.2.4, B slices)
        if ctx.slice_type == 0 and 1 < len(cands) < ctx.max_merge:
            pairs = ((0, 1), (1, 0), (0, 2), (2, 0), (1, 2), (2, 1),
                     (0, 3), (3, 0), (1, 3), (3, 1), (2, 3), (3, 2))
            n_orig = len(cands)
            for i0, i1 in pairs:
                if len(cands) >= ctx.max_merge:
                    break
                if i0 >= n_orig or i1 >= n_orig:
                    break
                c0, c1 = cands[i0], cands[i1]
                if not (c0.pred[0] and c1.pred[1]):
                    continue
                if c0.poc[0] == c1.poc[1] and c0.mv[0] == c1.mv[1]:
                    continue
                m = PuMotion()
                m.pred = [True, True]
                m.mv = [c0.mv[0], c1.mv[1]]
                m.poc = [c0.poc[0], c1.poc[1]]
                m.ref_idx = [c0.ref_idx[0], c1.ref_idx[1]]
                cands.append(m)

        # zero candidates (8.5.3.2.5)
        nref = (min(len(ctx.ref_list[0]), len(ctx.ref_list[1]))
                if ctx.slice_type == 0 else len(ctx.ref_list[0]))
        zidx = 0
        while len(cands) < ctx.max_merge:
            r = zidx if zidx < nref else 0
            m = PuMotion()
            m.pred[0] = True
            m.mv[0] = (0, 0)
            m.ref_idx[0] = r
            m.poc[0] = ctx.ref_list[0][r][0]
            if ctx.slice_type == 0:
                m.pred[1] = True
                m.mv[1] = (0, 0)
                m.ref_idx[1] = r
                m.poc[1] = ctx.ref_list[1][r][0]
            cands.append(m)
            zidx += 1
        return cands

    def merge(self, xCb, yCb, nCbS, xPb, yPb, nPbW, nPbH, part_idx,
              part_mode, merge_idx) -> PuMotion:
        cands = self.merge_candidates(xCb, yCb, nCbS, xPb, yPb, nPbW,
                                      nPbH, part_idx, part_mode)
        m = cands[merge_idx]
        # 8x4/4x8 bi -> uni L0 (8.5.3.2.3 final step)
        if nPbW + nPbH == 12 and m.pred[0] and m.pred[1]:
            m = PuMotion(mv=[m.mv[0], (0, 0)],
                         poc=[m.poc[0], NO_REF],
                         ref_idx=[m.ref_idx[0], -1],
                         pred=[True, False])
        return m

    # -- temporal MVP (8.5.3.2.7/8) -----------------------------------------
    def _temporal_mv(self, xPb, yPb, nPbW, nPbH, lx, ref_idx):
        ctx = self.ctx
        if ctx.col_field is None:
            return None
        # bottom-right, then center
        xBr, yBr = xPb + nPbW, yPb + nPbH
        if (yPb >> ctx.ctb_log2) == (yBr >> ctx.ctb_log2) \
                and yBr < ctx.pic_h and xBr < ctx.pic_w:
            r = self._col_mv((xBr >> 4) << 4, (yBr >> 4) << 4,
                             lx, ref_idx)
            if r is not None:
                return r
        xc = xPb + (nPbW >> 1)
        yc = yPb + (nPbH >> 1)
        return self._col_mv((xc >> 4) << 4, (yc >> 4) << 4, lx,
                            ref_idx)

    def _col_mv(self, xCol, yCol, lx, ref_idx):
        """8.5.3.2.8 collocated motion vector."""
        ctx = self.ctx
        cf = ctx.col_field
        y4, x4 = yCol // 4, xCol // 4
        if y4 >= cf.refpoc.shape[1] or x4 >= cf.refpoc.shape[2]:
            return None
        p0 = int(cf.refpoc[0, y4, x4])
        p1 = int(cf.refpoc[1, y4, x4])
        if p0 == NO_REF and p1 == NO_REF:
            return None                     # intra / not coded
        if p0 == NO_REF:
            use = 1
        elif p1 == NO_REF:
            use = 0
        elif ctx.no_backward():
            use = lx
        else:
            # 8.5.3.2.8: listCol = LN with N = collocated_from_l0_flag
            use = 1 if ctx.col_from_l0 else 0
        ref_poc_col = int(cf.refpoc[use, y4, x4])
        mv_col = (int(cf.mv[use, y4, x4, 0]),
                  int(cf.mv[use, y4, x4, 1]))
        tgt_poc, _pic, tgt_lt = ctx.ref_list[lx][ref_idx]
        if tgt_lt:
            return None                     # LT col matching gated
        col_diff = ctx.col_poc - ref_poc_col
        cur_diff = ctx.poc - tgt_poc
        if col_diff == cur_diff:
            return mv_col
        return scale_mv(mv_col, cur_diff, col_diff)

    # -- AMVP (8.5.3.2.10-14) ----------------------------------------------
    def amvp(self, xCb, yCb, nCbS, xPb, yPb, nPbW, nPbH, part_idx,
             lx, ref_idx, mvp_flag) -> tuple:
        ctx = self.ctx
        tgt_poc = ctx.ref_list[lx][ref_idx][0]

        def avail(xNb, yNb):
            return self._pb_avail(xNb, yNb, xCb, yCb, nCbS, nPbW,
                                  nPbH, part_idx)

        def match(xNb, yNb, scaled_ok):
            """Return predictor mv from neighbor (step-1: same ref
            pic either list; step-2 when scaled_ok: POC-scaled)."""
            m = self._nb_motion(xNb, yNb)
            for ly in (lx, 1 - lx):
                if m.pred[ly] and m.poc[ly] == tgt_poc:
                    return m.mv[ly]
            if not scaled_ok:
                return None
            for ly in (lx, 1 - lx):
                if m.pred[ly]:
                    td = ctx.poc - m.poc[ly]
                    tb = ctx.poc - tgt_poc
                    if td == tb:
                        return m.mv[ly]
                    return scale_mv(m.mv[ly], tb, td)
            return None

        a0_av = avail(xPb - 1, yPb + nPbH)
        a1_av = avail(xPb - 1, yPb + nPbH - 1)
        is_scaled = a0_av or a1_av
        mv_a = None
        # step 1 (same-ref, no scaling) over A0 then A1
        for av, (xn, yn) in ((a0_av, (xPb - 1, yPb + nPbH)),
                             (a1_av, (xPb - 1, yPb + nPbH - 1))):
            if av:
                m = self._nb_motion(xn, yn)
                for ly in (lx, 1 - lx):
                    if m.pred[ly] and m.poc[ly] == tgt_poc:
                        mv_a = m.mv[ly]
                        break
            if mv_a is not None:
                break
        if mv_a is None:
            # step 2 (scaled) over A0 then A1
            for av, (xn, yn) in ((a0_av, (xPb - 1, yPb + nPbH)),
                                 (a1_av, (xPb - 1, yPb + nPbH - 1))):
                if av:
                    mv_a = match(xn, yn, True)
                if mv_a is not None:
                    break

        b_locs = ((xPb + nPbW, yPb - 1), (xPb + nPbW - 1, yPb - 1),
                  (xPb - 1, yPb - 1))
        mv_b = None
        for xn, yn in b_locs:
            if avail(xn, yn):
                mv_b = match(xn, yn, False)
            if mv_b is not None:
                break
        if not is_scaled and mv_b is not None:
            # B becomes A; recompute B with scaling (8.5.3.2.12)
            mv_a = mv_b
            mv_b = None
            for xn, yn in b_locs:
                if avail(xn, yn):
                    mv_b = match(xn, yn, True)
                if mv_b is not None:
                    break
        elif not is_scaled and mv_b is None:
            # still allow scaled B as the A slot replacement
            for xn, yn in b_locs:
                if avail(xn, yn):
                    mv_a = match(xn, yn, True)
                if mv_a is not None:
                    break

        cands = []
        if mv_a is not None:
            cands.append(mv_a)
        if mv_b is not None and mv_b != mv_a:
            cands.append(mv_b)
        if len(cands) < 2 and ctx.temporal_mvp:
            t = self._temporal_mv(xPb, yPb, nPbW, nPbH, lx, ref_idx)
            if t is not None:
                cands.append(t)
        while len(cands) < 2:
            cands.append((0, 0))
        return cands[mvp_flag]
