"""AV1 inter-block syntax: reference-frame coding, the MV-candidate
stack (spec 7.10.2 find_mv_stack), inter modes, motion modes,
compound types, interintra, and interpolation filters (spec 5.11.15
onward).

The C reference (junka/ffpic) has no AV1 layer; dav1d is the
bit-exact conformance oracle (tests/test_av1_inter.py, tools/
av1_sweep.py inter configs).  Everything here runs on the
pure-Python symbol path — inter frames route around the native
whole-SB parser so the adapted CDF state lives in CdfContext and
participates in frame-end save / primary-ref load.

Copied from ``ffpic_tpu/coding/av1_inter.py`` for the PyTorch port whole,
with its imports rewritten to the port's modules (the lazy import of
``av1_refs`` in ``read_ref_frames`` too).
"""

from __future__ import annotations

from ffpic_tpu_torch.coding import av1_consts as C
from ffpic_tpu_torch.coding import av1_refs as R
from ffpic_tpu_torch.coding.av1_mv import read_mv_full


def _clip3(lo, hi, v):
    return lo if v < lo else (hi if v > hi else v)


def has_newmv(mode: int) -> bool:
    return mode in (C.NEWMV, C.NEW_NEWMV, C.NEAR_NEWMV,
                    C.NEW_NEARMV, C.NEAREST_NEWMV, C.NEW_NEARESTMV)


class MvStack:
    """find_mv_stack output: candidate list + contexts."""

    __slots__ = ("mvs", "weights", "num_found", "new_mv_ctx",
                 "ref_mv_ctx", "zero_mv_ctx", "drl_ctx",
                 "global_mvs", "num_nearest")


def find_mv_stack(td, b, is_compound: bool) -> MvStack:
    """Spec 7.10.2: build the ranked MV-candidate stack for
    RefFrame[0..1] and derive the newmv/refmv/zeromv/drl contexts."""
    fs, fh, seq = td.fs, td.fh, td.seq
    r, c = b.mi_row, b.mi_col
    bw4, bh4 = C.BLOCK_W4[b.bsize], C.BLOCK_H4[b.bsize]
    refs = b.refs

    st = MvStack()
    stack = []          # each: [mv0(list2), mv1(list2), weight]
    new_mv_count = [0]
    found_match = [False]

    # ---- global mvs (7.10.2.1)
    gmv = []
    for i in range(2 if is_compound else 1):
        ref = refs[i]
        if ref <= C.INTRA_FRAME:
            gmv.append([0, 0])
        else:
            gmv.append(R.gm_get_motion_vector(
                fh.gm_params[ref], fh.gm_type[ref], fh, b.bsize,
                c, r))
    if not is_compound:
        gmv.append([0, 0])
    st.global_mvs = gmv

    def is_inside(mr, mc):
        return td.r0 <= mr < td.r1 and td.c0 <= mc < td.c1

    def add_candidate(mr, mc, weight):
        """add_ref_mv_candidate (7.10.2.7)."""
        if not fs.is_inter[mr, mc]:
            return
        cand_mode = int(fs.y_mode[mr, mc])
        cand_gm = bool(fs.gm_flag[mr, mc])
        if is_compound:
            if (int(fs.ref_frame[mr, mc, 0]) != refs[0] or
                    int(fs.ref_frame[mr, mc, 1]) != refs[1]):
                return
            cand = []
            for i in range(2):
                if cand_gm and fh.gm_type[refs[i]] > C.TRANSLATION:
                    cand.append(list(gmv[i]))
                else:
                    cand.append([int(fs.mv2[mr, mc, i, 0]),
                                 int(fs.mv2[mr, mc, i, 1])])
            found_match[0] = True
            if has_newmv(cand_mode):
                new_mv_count[0] += 1
            for ent in stack:
                if ent[0] == cand[0] and ent[1] == cand[1]:
                    ent[2] += weight
                    return
            if len(stack) < C.MAX_REF_MV_STACK_SIZE:
                stack.append([cand[0], cand[1], weight])
            return
        for lst in range(2):
            if int(fs.ref_frame[mr, mc, lst]) != refs[0]:
                continue
            if cand_gm and fh.gm_type[refs[0]] > C.TRANSLATION:
                cand = list(gmv[0])
            else:
                cand = [int(fs.mv2[mr, mc, lst, 0]),
                        int(fs.mv2[mr, mc, lst, 1])]
            found_match[0] = True
            if has_newmv(cand_mode):
                new_mv_count[0] += 1
            hit = False
            for ent in stack:
                if ent[0] == cand:
                    ent[2] += weight
                    hit = True
                    break
            if not hit and len(stack) < C.MAX_REF_MV_STACK_SIZE:
                stack.append([cand, [0, 0], weight])
            return

    # spec 7.10.2 setup: maxRowOffset/maxColOffset (the -6 reach
    # clamped to the tile edge, 0 when the edge row/col is absent)
    # and the processedRows/Cols cells that let a tall/wide adjacent
    # candidate SKIP the outer scans entirely.
    row_adj = 1 if (bh4 < 2 and (r & 1)) else 0
    col_adj = 1 if (bw4 < 2 and (c & 1)) else 0
    MVREF_ROW_COLS = 3
    # libaom setup_ref_mv_list narrows the scan reach for sub-8px
    # blocks PER DIMENSION: height < 8px -> row base -(2<<1),
    # width < 8px -> col base -(2<<1) (then the tile clamp)
    max_row_offset = 0
    if r > td.r0:
        row_base = -(2 << 1) if bh4 < 2 else -(MVREF_ROW_COLS << 1)
        max_row_offset = max(row_base + row_adj, td.r0 - r)
    max_col_offset = 0
    if c > td.c0:
        col_base = -(2 << 1) if bw4 < 2 else -(MVREF_ROW_COLS << 1)
        max_col_offset = max(col_base + col_adj, td.c0 - c)
    processed_rows = [0]
    processed_cols = [0]

    def scan_row(delta_row):
        end4 = min(min(bw4, fs.mi_cols - c), 16)
        delta_col = 0
        use_step16 = bw4 >= 16
        if abs(delta_row) > 1:
            delta_row += r & 1
            delta_col = 1 - (c & 1)
        i = 0
        while i < end4:
            mr, mc = r + delta_row, c + delta_col + i
            if not is_inside(mr, mc):
                break
            cand_w4 = int(C.BLOCK_W4[fs.bsize[mr, mc]])
            ln = min(2, cand_w4)
            if abs(delta_row) > 1:
                ln = max(2, ln)
            if use_step16:
                ln = max(4, ln)
            # weight boost for a covering candidate (spec
            # 7.10.2.2): a candidate at least as wide as the block
            # weights by its height up to the remaining scan reach,
            # and marks the rows it covers as processed so outer
            # row scans are skipped
            weight = 2
            if bw4 >= 2 and bw4 <= cand_w4:
                inc = min(-max_row_offset + delta_row + 1,
                          int(C.BLOCK_H4[fs.bsize[mr, mc]]))
                weight = max(weight, inc)
                processed_rows[0] = inc - delta_row - 1
            add_candidate(mr, mc, ln * weight)
            i += ln

    def scan_col(delta_col):
        end4 = min(min(bh4, fs.mi_rows - r), 16)
        delta_row = 0
        use_step16 = bh4 >= 16
        if abs(delta_col) > 1:
            delta_row = 1 - (r & 1)
            delta_col += c & 1
        i = 0
        while i < end4:
            mr, mc = r + delta_row + i, c + delta_col
            if not is_inside(mr, mc):
                break
            cand_h4 = int(C.BLOCK_H4[fs.bsize[mr, mc]])
            ln = min(2, cand_h4)
            if abs(delta_col) > 1:
                ln = max(2, ln)
            if use_step16:
                ln = max(4, ln)
            weight = 2
            if bh4 >= 2 and bh4 <= cand_h4:
                inc = min(-max_col_offset + delta_col + 1,
                          int(C.BLOCK_W4[fs.bsize[mr, mc]]))
                weight = max(weight, inc)
                processed_cols[0] = inc - delta_col - 1
            add_candidate(mr, mc, ln * weight)
            i += ln

    def scan_point(delta_row, delta_col):
        mr, mc = r + delta_row, c + delta_col
        if is_inside(mr, mc) and fs.bsize[mr, mc] != 255:
            add_candidate(mr, mc, 4)

    # ---- adjacent scans
    found_match[0] = False
    if r > td.r0:
        scan_row(-1)
    found_above = found_match[0]
    found_match[0] = False
    if c > td.c0:
        scan_col(-1)
    found_left = found_match[0]
    found_match[0] = False
    if max(bw4, bh4) <= 16:
        scan_point(-1, bw4)
    if found_match[0]:
        found_above = True
    close_matches = int(found_above) + int(found_left)
    num_nearest = len(stack)
    num_new = new_mv_count[0]
    if num_nearest > 0:
        for ent in stack[:num_nearest]:
            ent[2] += C.REF_CAT_LEVEL
    st.zero_mv_ctx = 0

    # ---- temporal scan (7.10.2.5)
    mf = fs.motion_field
    if fh.use_ref_frame_mvs and mf is not None:
        # libaom av1_find_mv_refs: the temporal grid steps 8x8 (2 mi)
        # for blocks below 64px and 16x16 (4 mi) at 64px+ — a 16x16
        # block samples FOUR positions, not one
        step_w4 = 4 if bw4 >= 16 else 2
        step_h4 = 4 if bh4 >= 16 else 2

        def add_tpl(delta_row, delta_col, set_zero_ctx=False):
            mr = r + delta_row
            mc = c + delta_col
            if not is_inside(mr, mc):
                return
            y8, x8 = mr >> 1, mc >> 1
            if y8 >= mf.h8 or x8 >= mf.w8:
                return
            if is_compound:
                cand0 = mf.candidate(fh, y8, x8, refs[0])
                cand1 = mf.candidate(fh, y8, x8, refs[1])
                if cand0 is None or cand1 is None:
                    # spec 7.10.2.6: an INVALID center candidate
                    # still sets ZeroMvContext = 1 (not left at 0)
                    if set_zero_ctx:
                        st.zero_mv_ctx = 1
                    return
                if set_zero_ctx:
                    st.zero_mv_ctx = 1 if (
                        abs(cand0[0] - gmv[0][0]) >= 16 or
                        abs(cand0[1] - gmv[0][1]) >= 16) else 0
                for ent in stack:
                    if ent[0] == cand0 and ent[1] == cand1:
                        ent[2] += 2
                        return
                if len(stack) < C.MAX_REF_MV_STACK_SIZE:
                    stack.append([cand0, cand1, 2])
                return
            cand = mf.candidate(fh, y8, x8, refs[0])
            if cand is None:
                # spec 7.10.2.6: invalid center candidate => ctx 1
                if set_zero_ctx:
                    st.zero_mv_ctx = 1
                return
            if set_zero_ctx:
                st.zero_mv_ctx = 1 if (
                    abs(cand[0] - gmv[0][0]) >= 16 or
                    abs(cand[1] - gmv[0][1]) >= 16) else 0
            for ent in stack:
                if ent[0] == cand:
                    ent[2] += 2
                    return
            if len(stack) < C.MAX_REF_MV_STACK_SIZE:
                stack.append([cand, [0, 0], 2])

        dr = 0
        while dr < min(bh4, 16):
            dc = 0
            while dc < min(bw4, 16):
                add_tpl(dr, dc, set_zero_ctx=(dr == 0 and dc == 0))
                dc += step_w4
            dr += step_h4
        allow_ext = (bh4 >= 2 and bw4 >= 2 and
                     bh4 < 16 and bw4 < 16)
        if allow_ext:
            # positions outside the block, limited to the same
            # 64x64 row group and one group of columns each way
            sb_r8 = (r >> 1) & ~7
            sb_c8 = (c >> 1) & ~7
            for dr, dc in ((bh4, -2), (bh4, bw4), (bh4 - 2, bw4)):
                mr, mc = r + dr, c + dc
                y8, x8 = mr >> 1, mc >> 1
                if y8 < sb_r8 or y8 >= sb_r8 + 8:
                    continue
                if x8 < sb_c8 - 8 or x8 >= sb_c8 + 16:
                    continue
                if not is_inside(mr, mc):
                    continue
                add_tpl(dr, dc)

    # ---- outer spatial scans
    found_match[0] = False
    scan_point(-1, -1)
    if found_match[0]:
        found_above = True
    for idx in (2, 3):
        off = -2 * idx + 1
        # outer scans run only within the clamped reach and only
        # past rows/cols a covering adjacent candidate has already
        # processed (spec 7.10.2 find_mv_stack outer loop)
        row_off = off + row_adj
        if (abs(row_off) <= abs(max_row_offset) and
                abs(row_off) > processed_rows[0]):
            found_match[0] = False
            scan_row(off)
            if found_match[0]:
                found_above = True
        col_off = off + col_adj
        if (abs(col_off) <= abs(max_col_offset) and
                abs(col_off) > processed_cols[0]):
            found_match[0] = False
            scan_col(off)
            if found_match[0]:
                found_left = True
    total_matches = int(found_above) + int(found_left)

    # ---- sorting (stable, by descending weight, two segments)
    def stable_sort(lo, hi):
        seg = stack[lo:hi]
        seg.sort(key=lambda e: -e[2])
        stack[lo:hi] = seg

    stable_sort(0, num_nearest)
    stable_sort(num_nearest, len(stack))

    # ---- extra search (7.10.2.12/13)
    if len(stack) < 2:
        ref_id = [[], []]
        ref_diff = [[], []]

        def add_extra(mr, mc):
            for lst in range(2):
                if len(stack) >= 2 and not is_compound:
                    return
                cand_ref = int(fs.ref_frame[mr, mc, lst])
                if cand_ref <= C.INTRA_FRAME:
                    continue
                mv = [int(fs.mv2[mr, mc, lst, 0]),
                      int(fs.mv2[mr, mc, lst, 1])]
                if is_compound:
                    for rl in range(2):
                        cmv = list(mv)
                        if cand_ref == refs[rl]:
                            if len(ref_id[rl]) < 2:
                                ref_id[rl].append(cmv)
                        elif len(ref_diff[rl]) < 2:
                            if fh.ref_sign_bias[cand_ref] != \
                                    fh.ref_sign_bias[refs[rl]]:
                                cmv = [-cmv[0], -cmv[1]]
                            ref_diff[rl].append(cmv)
                else:
                    cmv = list(mv)
                    if fh.ref_sign_bias[cand_ref] != \
                            fh.ref_sign_bias[refs[0]]:
                        cmv = [-cmv[0], -cmv[1]]
                    for ent in stack:
                        if ent[0] == cmv:
                            break
                    else:
                        if len(stack) < C.MAX_REF_MV_STACK_SIZE:
                            stack.append([cmv, [0, 0], 2])

        for pass_ in range(2):
            idx = 0
            limit = min(bw4 if pass_ == 0 else bh4,
                        (fs.mi_cols - c) if pass_ == 0
                        else (fs.mi_rows - r), 16)
            while idx < limit and (is_compound or len(stack) < 2):
                if pass_ == 0:
                    mr, mc = r - 1, c + idx
                else:
                    mr, mc = r + idx, c - 1
                if not is_inside(mr, mc):
                    break
                add_extra(mr, mc)
                if pass_ == 0:
                    idx += min(bw4,
                               int(C.BLOCK_W4[fs.bsize[mr, mc]]))
                else:
                    idx += min(bh4,
                               int(C.BLOCK_H4[fs.bsize[mr, mc]]))
        if is_compound:
            # compound padding COUNTS toward NumMvFound (spec
            # 7.10.2.12 increments it in the combined-list loop)
            combined = []
            for rl in range(2):
                comb = ref_id[rl] + ref_diff[rl]
                while len(comb) < 2:
                    comb.append(list(gmv[rl]))
                combined.append(comb)
            if len(stack) == 1:
                # spec: if combinedMvs[0] duplicates the existing
                # stack entry, append combinedMvs[1] instead (a
                # blind append would make NEARMV a NEAREST dup)
                if (list(combined[0][0]) == list(stack[0][0]) and
                        list(combined[1][0]) == list(stack[0][1])):
                    stack.append([list(combined[0][1]),
                                  list(combined[1][1]), 2])
                else:
                    stack.append([list(combined[0][0]),
                                  list(combined[1][0]), 2])
            else:
                for idx in range(2):
                    if len(stack) < 2:
                        stack.append([list(combined[0][idx]),
                                      list(combined[1][idx]), 2])
            real_count = len(stack)
        else:
            # single-ref padding fills the stack SLOTS only —
            # NumMvFound stays (libaom pads mv_ref_list without
            # bumping refmv_count; the drl gates key off the real
            # count while NEAREST/NEAR legally read the pad slots)
            real_count = len(stack)
            while len(stack) < 2:
                stack.append([list(gmv[0]), [0, 0], 2])
    else:
        real_count = len(stack)

    # ---- context derivation
    if close_matches == 0:
        st.new_mv_ctx = min(total_matches, 1)
        st.ref_mv_ctx = total_matches
    elif close_matches == 1:
        st.new_mv_ctx = 3 - min(num_new, 1)
        st.ref_mv_ctx = 2 + total_matches
    else:
        st.new_mv_ctx = 5 - min(num_new, 1)
        st.ref_mv_ctx = 5

    # ---- clamping (7.10.2.14)
    border_r = C.MV_BORDER + bh4 * 4 * 8
    border_c = C.MV_BORDER + bw4 * 4 * 8
    mb_top = -(r * 32)
    mb_bottom = (fs.mi_rows - bh4 - r) * 32
    mb_left = -(c * 32)
    mb_right = (fs.mi_cols - bw4 - c) * 32
    for ent in stack:
        for i in range(2 if is_compound else 1):
            ent[i][0] = _clip3(mb_top - border_r,
                               mb_bottom + border_r, ent[i][0])
            ent[i][1] = _clip3(mb_left - border_c,
                               mb_right + border_c, ent[i][1])

    st.mvs = [[ent[0], ent[1]] for ent in stack]
    st.weights = [ent[2] for ent in stack]
    st.num_found = real_count
    st.num_nearest = num_nearest
    drl = []
    for idx in range(max(0, len(stack) - 1)):
        z = 2
        if st.weights[idx] >= C.REF_CAT_LEVEL:
            z = 0 if st.weights[idx + 1] >= C.REF_CAT_LEVEL else 1
        drl.append(z)
    st.drl_ctx = drl
    return st


# =================================================================== syntax
def _seg_feature_active(fh, seg_id: int, feature: int) -> bool:
    return bool(fh.segmentation_enabled and
                fh.feature_enabled[seg_id][feature])


SEG_LVL_ALT_Q, SEG_LVL_ALT_LF_Y_V, SEG_LVL_ALT_LF_Y_H, \
    SEG_LVL_ALT_LF_U, SEG_LVL_ALT_LF_V, SEG_LVL_REF_FRAME, \
    SEG_LVL_SKIP, SEG_LVL_GLOBALMV = range(8)

# spec Compound_Mode_Ctx_Map (verified against libaom's
# compound_mode_ctx_map .rodata — root cause of the round-4
# deep-GOP desync: rows 1/2 were mis-transcribed as
# {3,4,4,4,4}/{5,6,7,7,7}, sending e.g. (NewMvCtx=2,RefMvCtx=3)
# to row 4 instead of row 3 — same decoded mode, drifted msac
# state, desync ~10 blocks later)
_COMP_MODE_CTX_MAP = [
    [0, 1, 1, 1, 1],
    [1, 2, 3, 4, 4],
    [4, 4, 5, 6, 7],
]


def _neighbor(td, r, c, which):
    """(avail, mi_row, mi_col) for the above/left mode-info unit."""
    if which == 0:
        return (r > td.r0, r - 1, c)
    return (c > td.c0, r, c - 1)


def read_skip_mode(td, b, r, c) -> int:
    fh, fs = td.fh, td.fs
    if (_seg_feature_active(fh, b.seg_id, SEG_LVL_SKIP) or
            _seg_feature_active(fh, b.seg_id, SEG_LVL_REF_FRAME) or
            _seg_feature_active(fh, b.seg_id, SEG_LVL_GLOBALMV) or
            not fh.skip_mode_present or
            C.BLOCK_W4[b.bsize] * 4 < 8 or
            C.BLOCK_H4[b.bsize] * 4 < 8):
        return 0
    ctx = 0
    if b.avail_u:
        ctx += int(fs.skip_mode[r - 1, c])
    if b.avail_l:
        ctx += int(fs.skip_mode[r, c - 1])
    return td.sym(td.cdf["skip_mode"][ctx])


def read_is_inter(td, b, r, c) -> int:
    """Spec 5.11.15 read_is_inter."""
    fh, fs = td.fh, td.fs
    if b.skip_mode:
        return 1
    if _seg_feature_active(fh, b.seg_id, SEG_LVL_REF_FRAME):
        return int(fh.feature_data[b.seg_id][SEG_LVL_REF_FRAME]
                   != C.INTRA_FRAME)
    if _seg_feature_active(fh, b.seg_id, SEG_LVL_GLOBALMV):
        return 1
    au, al = b.avail_u, b.avail_l
    if au and al:
        a_intra = not fs.is_inter[r - 1, c]
        l_intra = not fs.is_inter[r, c - 1]
        ctx = 3 if (a_intra and l_intra) else \
            int(a_intra or l_intra)
    elif au or al:
        intra = not fs.is_inter[r - 1, c] if au else \
            not fs.is_inter[r, c - 1]
        ctx = 2 * int(intra)
    else:
        ctx = 0
    return td.sym(td.cdf["intra_inter"][ctx])


def _count_refs(td, b, r, c):
    """neighbors_ref_counts: per ref enum, occurrences among the
    above/left mi units' (up to) two refs."""
    fs = td.fs
    counts = [0] * 8
    for avail, mr, mc in (_neighbor(td, r, c, 0),
                          _neighbor(td, r, c, 1)):
        if not avail:
            continue
        for lst in range(2):
            rf = int(fs.ref_frame[mr, mc, lst])
            if rf >= C.LAST_FRAME:
                counts[rf] += 1
    return counts


def _cnt_ctx(a: int, bb: int) -> int:
    return 1 if a == bb else (0 if a < bb else 2)


def _is_bwd(ref: int) -> bool:
    return ref >= C.BWDREF_FRAME


def _nbr_fields(td, b, r, c, which):
    """(avail, is_intra, single, uni_comp, ref0) for a neighbor."""
    fs = td.fs
    avail, mr, mc = _neighbor(td, r, c, which)
    if not avail:
        return (False, False, False, False, -1)
    inter = bool(fs.is_inter[mr, mc])
    r0 = int(fs.ref_frame[mr, mc, 0])
    r1 = int(fs.ref_frame[mr, mc, 1])
    comp = r1 > C.INTRA_FRAME
    uni = comp and (_is_bwd(r0) == _is_bwd(r1))
    return (True, not inter, not comp, uni, r0)


def read_ref_frames(td, b, r, c):
    """Spec 5.11.25 read_ref_frames."""
    fh = td.fh
    if b.skip_mode:
        b.refs = list(fh.skip_mode_frame)
        return
    if _seg_feature_active(fh, b.seg_id, SEG_LVL_REF_FRAME):
        b.refs = [int(fh.feature_data[b.seg_id][SEG_LVL_REF_FRAME]),
                  C.NONE_FRAME]
        return
    if (_seg_feature_active(fh, b.seg_id, SEG_LVL_SKIP) or
            _seg_feature_active(fh, b.seg_id, SEG_LVL_GLOBALMV)):
        b.refs = [C.LAST_FRAME, C.NONE_FRAME]
        return
    bw4, bh4 = C.BLOCK_W4[b.bsize], C.BLOCK_H4[b.bsize]
    comp_mode = 0
    if fh.reference_select and min(bw4, bh4) >= 2:
        # comp_mode ctx
        (au, a_intra, a_sg, a_uni, a0) = _nbr_fields(td, b, r, c, 0)
        (al, l_intra, l_sg, l_uni, l0) = _nbr_fields(td, b, r, c, 1)
        if au and al:
            if a_sg and l_sg:
                ctx = int(_is_bwd(a0)) ^ int(_is_bwd(l0))
            elif a_sg:
                ctx = 2 + int(_is_bwd(a0) or a_intra)
            elif l_sg:
                ctx = 2 + int(_is_bwd(l0) or l_intra)
            else:
                ctx = 4
        elif au:
            ctx = int(_is_bwd(a0)) if a_sg else 3
        elif al:
            ctx = int(_is_bwd(l0)) if l_sg else 3
        else:
            ctx = 1
        comp_mode = td.sym(td.cdf["comp_inter"][ctx])
    counts = _count_refs(td, b, r, c)
    fwd = counts[1] + counts[2] + counts[3] + counts[4]
    bwd = counts[5] + counts[6] + counts[7]
    if comp_mode:
        # ---- comp_ref_type ctx (libaom comp_reference_type_context)
        (au, a_intra, a_sg, a_uni, a0) = _nbr_fields(td, b, r, c, 0)
        (al, l_intra, l_sg, l_uni, l0) = _nbr_fields(td, b, r, c, 1)
        if au and al:
            if a_intra and l_intra:
                ctx = 2
            elif a_intra or l_intra:
                sg, uni = (l_sg, l_uni) if a_intra else (a_sg, a_uni)
                ctx = 2 if sg else 1 + 2 * int(uni)
            elif a_sg and l_sg:
                ctx = 1 + 2 * int(_is_bwd(a0) == _is_bwd(l0))
            elif a_sg or l_sg:
                uni = l_uni if a_sg else a_uni
                ctx = 1 if not uni else \
                    3 + int(_is_bwd(a0) == _is_bwd(l0))
            else:
                if not a_uni and not l_uni:
                    ctx = 0
                elif not a_uni or not l_uni:
                    ctx = 2
                else:
                    ctx = 3 + int((a0 == C.BWDREF_FRAME) ==
                                  (l0 == C.BWDREF_FRAME))
        elif au or al:
            intra, sg, uni = (a_intra, a_sg, a_uni) if au else \
                (l_intra, l_sg, l_uni)
            if intra or sg:
                ctx = 2
            else:
                # libaom comp_reference_type_context one-edge comp
                # case: 3 * has_uni_comp_refs (0 bidir / 3 unidir),
                # NOT the both-edges 1+2*uni ladder
                ctx = 3 * int(uni)
        else:
            ctx = 2
        bidir = td.sym(td.cdf["comp_ref_type"][ctx])
        if not bidir:
            # unidirectional pairs
            t = td.cdf["uni_comp_ref"]
            ctx0 = _cnt_ctx(fwd, bwd)
            if td.sym(t[ctx0][0]):
                b.refs = [C.BWDREF_FRAME, C.ALTREF_FRAME]
            else:
                ctx1 = _cnt_ctx(counts[2],
                                counts[3] + counts[4])
                if td.sym(t[ctx1][1]):
                    ctx2 = _cnt_ctx(counts[3], counts[4])
                    b.refs = [C.LAST_FRAME,
                              C.GOLDEN_FRAME if td.sym(t[ctx2][2])
                              else C.LAST3_FRAME]
                else:
                    b.refs = [C.LAST_FRAME, C.LAST2_FRAME]
            return
        t = td.cdf["comp_ref"]
        ctx0 = _cnt_ctx(counts[1] + counts[2],
                        counts[3] + counts[4])
        if not td.sym(t[ctx0][0]):
            ctx1 = _cnt_ctx(counts[1], counts[2])
            ref0 = C.LAST2_FRAME if td.sym(t[ctx1][1]) \
                else C.LAST_FRAME
        else:
            ctx2 = _cnt_ctx(counts[3], counts[4])
            ref0 = C.GOLDEN_FRAME if td.sym(t[ctx2][2]) \
                else C.LAST3_FRAME
        t = td.cdf["comp_bwdref"]
        ctx0 = _cnt_ctx(counts[5] + counts[6], counts[7])
        if td.sym(t[ctx0][0]):
            ref1 = C.ALTREF_FRAME
        else:
            ctx1 = _cnt_ctx(counts[5], counts[6])
            ref1 = C.ALTREF2_FRAME if td.sym(t[ctx1][1]) \
                else C.BWDREF_FRAME
        b.refs = [ref0, ref1]
        return
    # ---- single ref tree
    t = td.cdf["single_ref"]
    ctx = _cnt_ctx(fwd, bwd)
    if td.sym(t[ctx][0]):                      # backward
        ctx2 = _cnt_ctx(counts[5] + counts[6], counts[7])
        if td.sym(t[ctx2][1]):
            ref = C.ALTREF_FRAME
        else:
            ctx6 = _cnt_ctx(counts[5], counts[6])
            ref = C.ALTREF2_FRAME if td.sym(t[ctx6][5]) \
                else C.BWDREF_FRAME
    else:                                      # forward
        ctx3 = _cnt_ctx(counts[1] + counts[2],
                        counts[3] + counts[4])
        if td.sym(t[ctx3][2]):
            ctx5 = _cnt_ctx(counts[3], counts[4])
            ref = C.GOLDEN_FRAME if td.sym(t[ctx5][4]) \
                else C.LAST3_FRAME
        else:
            ctx4 = _cnt_ctx(counts[1], counts[2])
            ref = C.LAST2_FRAME if td.sym(t[ctx4][3]) \
                else C.LAST_FRAME
    b.refs = [ref, C.NONE_FRAME]


def read_segment_id_inter(td, b, r, c, re, ce, pre_skip: bool):
    """Spec 5.11.16 inter_segment_id (temporal prediction path)."""
    fs, fh = td.fs, td.fh
    if not fh.segmentation_enabled:
        b.seg_id = 0
        return True
    bw4, bh4 = C.BLOCK_W4[b.bsize], C.BLOCK_H4[b.bsize]
    # predicted id: min over the block extent of the prev seg map
    prev = fh.prev_seg_ids
    if prev is not None and prev.shape == fs.seg.shape:
        pred = int(prev[r:re, c:ce].min())
    else:
        pred = 0
    if not fh.segmentation_update_map:
        b.seg_id = pred
        return True
    if pre_skip and not fh.seg_id_pre_skip:
        b.seg_id = 0
        return True
    if not pre_skip:
        if b.skip:
            td.above_seg_pred[c:c + bw4] = 0
            td.left_seg_pred[r:r + bh4] = 0
            b.seg_id = td._read_segment_id(r, c, re, ce, True)
            return True
    if fh.segmentation_temporal_update:
        ctx = int(td.left_seg_pred[r]) + int(td.above_seg_pred[c])
        predicted = td.sym(td.cdf["seg_pred"][ctx])
        if predicted:
            b.seg_id = pred
        else:
            b.seg_id = td._read_segment_id(r, c, re, ce, b.skip
                                           if not pre_skip else
                                           False)
        td.above_seg_pred[c:c + bw4] = predicted
        td.left_seg_pred[r:r + bh4] = predicted
    else:
        b.seg_id = td._read_segment_id(r, c, re, ce, b.skip
                                       if not pre_skip else False)
    return True


def _has_nearmv(mode: int) -> bool:
    return mode in (C.NEARMV, C.NEAR_NEARMV, C.NEAR_NEWMV,
                    C.NEW_NEARMV)


def inter_block_mode_info(td, b, r, c):
    """Spec 5.11.23: ref frames, mode, drl, MVs, interintra,
    motion mode, compound type, interpolation filters."""
    fs, fh, seq = td.fs, td.fh, td.seq
    bw4, bh4 = C.BLOCK_W4[b.bsize], C.BLOCK_H4[b.bsize]
    read_ref_frames(td, b, r, c)
    is_compound = b.refs[1] > C.INTRA_FRAME
    st = find_mv_stack(td, b, is_compound)
    b.mv_stack = st
    if b.skip_mode:
        b.y_mode = C.NEAREST_NEARESTMV
    elif (_seg_feature_active(fh, b.seg_id, SEG_LVL_SKIP) or
          _seg_feature_active(fh, b.seg_id, SEG_LVL_GLOBALMV)):
        b.y_mode = C.GLOBALMV
    elif is_compound:
        ctx = _COMP_MODE_CTX_MAP[st.ref_mv_ctx >> 1][
            min(st.new_mv_ctx, 4)]
        b.y_mode = C.NEAREST_NEARESTMV + td.sym(
            td.cdf["inter_compound_mode"][ctx])
    else:
        if not td.sym(td.cdf["newmv"][st.new_mv_ctx]):
            b.y_mode = C.NEWMV
        elif not td.sym(td.cdf["globalmv"][st.zero_mv_ctx]):
            b.y_mode = C.GLOBALMV
        else:
            b.y_mode = C.NEARMV if td.sym(
                td.cdf["refmv"][st.ref_mv_ctx]) else C.NEARESTMV
    # ---- drl index
    b.ref_mv_idx = 0
    if b.y_mode in (C.NEWMV, C.NEW_NEWMV):
        for idx in range(2):
            if st.num_found > idx + 1:
                if not td.sym(td.cdf["drl"][st.drl_ctx[idx]]):
                    b.ref_mv_idx = idx
                    break
                b.ref_mv_idx = idx + 1
    elif _has_nearmv(b.y_mode):
        b.ref_mv_idx = 1
        for idx in (1, 2):
            if st.num_found > idx + 1:
                if not td.sym(td.cdf["drl"][st.drl_ctx[idx]]):
                    b.ref_mv_idx = idx
                    break
                b.ref_mv_idx = idx + 1
    # ---- assign_mv (5.11.26)
    b.mvs2 = [[0, 0], [0, 0]]
    for i in range(1 + int(is_compound)):
        comp_mode = C.COMP_MODE_PAIR[b.y_mode][i] \
            if b.y_mode >= C.NEAREST_NEARESTMV else b.y_mode
        if comp_mode == C.GLOBALMV:
            b.mvs2[i] = list(st.global_mvs[i])
        else:
            if comp_mode == C.NEARESTMV:
                idx = 0
            elif comp_mode == C.NEARMV:
                idx = b.ref_mv_idx
            else:                       # NEWMV
                idx = 0 if st.num_found <= 1 else b.ref_mv_idx
            pred = st.mvs[idx][i]
            if comp_mode == C.NEWMV:
                b.mvs2[i] = read_mv_full(
                    td.m, td.cdf.mv, pred, fh.force_integer_mv,
                    fh.allow_high_precision_mv)
            else:
                b.mvs2[i] = list(pred)
    # ---- interintra (5.11.28)
    b.interintra = False
    if (not b.skip_mode and seq.enable_interintra_compound and
            not is_compound and C.BLOCK_8X8 <= b.bsize <=
            C.BLOCK_32X32):
        grp = C.SIZE_GROUP[b.bsize]
        if td.sym(td.cdf["interintra"][grp]):
            b.interintra = True
            b.ii_mode = td.sym(td.cdf["interintra_mode"][grp])
            b.refs[1] = C.INTRA_FRAME
            b.angle_y = 0
            b.angle_uv = 0
            b.ii_wedge = False
            if C.WEDGE_BITS[b.bsize] > 0:
                if td.sym(td.cdf["wedge_interintra"][b.bsize]):
                    b.ii_wedge = True
                    b.wedge_index = td.sym(
                        td.cdf["wedge_idx"][b.bsize])
    # ---- motion mode (5.11.27)
    b.motion_mode = C.SIMPLE
    b.warp_samples = None
    if not (b.skip_mode or not fh.is_motion_mode_switchable or
            min(bw4, bh4) * 4 < 8 or
            (not fh.force_integer_mv and
             b.y_mode in (C.GLOBALMV, C.GLOBAL_GLOBALMV) and
             fh.gm_type[b.refs[0]] > C.TRANSLATION) or
            is_compound or b.refs[1] == C.INTRA_FRAME or
            not _has_overlappable(td, b, r, c)):
        samples = find_warp_samples(td, b, r, c)
        b.warp_samples = samples
        if (fh.force_integer_mv or len(samples) == 0 or
                not fh.allow_warped_motion or
                _ref_is_scaled(td, b.refs[0])):
            if td.sym(td.cdf["obmc"][b.bsize]):
                b.motion_mode = C.OBMC_CAUSAL
        else:
            b.motion_mode = td.sym(td.cdf["motion_mode"][b.bsize])
    # ---- compound type (5.11.29)
    b.comp_group_idx = 0
    b.compound_idx = 1
    b.compound_type = -1
    if b.skip_mode:
        pass
    elif is_compound:
        if seq.enable_masked_compound:
            ctx = 0
            if b.avail_u:
                if fs.ref_frame[r - 1, c, 1] > C.INTRA_FRAME:
                    ctx += int(fs.comp_group[r - 1, c])
                elif fs.ref_frame[r - 1, c, 0] == C.ALTREF_FRAME:
                    ctx += 3
            if b.avail_l:
                if fs.ref_frame[r, c - 1, 1] > C.INTRA_FRAME:
                    ctx += int(fs.comp_group[r, c - 1])
                elif fs.ref_frame[r, c - 1, 0] == C.ALTREF_FRAME:
                    ctx += 3
            ctx = min(5, ctx)
            b.comp_group_idx = td.sym(td.cdf["comp_group_idx"][ctx])
        if b.comp_group_idx == 0:
            if seq.enable_jnt_comp:
                from ffpic_tpu_torch.coding.av1_refs import \
                    get_relative_dist
                fwd_d = abs(get_relative_dist(
                    seq, fh.order_hints[b.refs[1]], fh.order_hint))
                bck_d = abs(get_relative_dist(
                    seq, fh.order_hint, fh.order_hints[b.refs[0]]))
                ctx = 3 * int(fwd_d == bck_d)
                if b.avail_u:
                    if fs.ref_frame[r - 1, c, 1] > C.INTRA_FRAME:
                        ctx += int(fs.compound_idx[r - 1, c])
                    elif fs.ref_frame[r - 1, c, 0] == \
                            C.ALTREF_FRAME:
                        ctx += 1
                if b.avail_l:
                    if fs.ref_frame[r, c - 1, 1] > C.INTRA_FRAME:
                        ctx += int(fs.compound_idx[r, c - 1])
                    elif fs.ref_frame[r, c - 1, 0] == \
                            C.ALTREF_FRAME:
                        ctx += 1
                b.compound_idx = td.sym(td.cdf["compound_idx"][ctx])
            else:
                b.compound_idx = 1
        else:
            if C.WEDGE_BITS[b.bsize] > 0:
                b.compound_type = td.sym(
                    td.cdf["compound_type"][b.bsize])
            else:
                b.compound_type = C.COMPOUND_DIFFWTD
            if b.compound_type == C.COMPOUND_WEDGE:
                b.wedge_index = td.sym(td.cdf["wedge_idx"][b.bsize])
                b.wedge_sign = td.literal(1)
            else:
                b.mask_type = td.literal(1)
    # ---- interpolation filters
    if fh.interp_filter == C.SWITCHABLE:
        b.interp = [C.EIGHTTAP, C.EIGHTTAP]
        ndirs = 2 if seq.enable_dual_filter else 1
        for d in range(ndirs):
            if _needs_interp_filter(td, b):
                ctx = ((d & 1) * 2 +
                       int(b.refs[1] > C.INTRA_FRAME)) * 4
                left_t = above_t = 3
                if b.avail_l:
                    if (fs.ref_frame[r, c - 1, 0] == b.refs[0] or
                            fs.ref_frame[r, c - 1, 1] == b.refs[0]):
                        left_t = int(fs.interp[r, c - 1, d])
                if b.avail_u:
                    if (fs.ref_frame[r - 1, c, 0] == b.refs[0] or
                            fs.ref_frame[r - 1, c, 1] == b.refs[0]):
                        above_t = int(fs.interp[r - 1, c, d])
                if left_t == above_t:
                    ctx += left_t
                elif left_t == 3:
                    ctx += above_t
                elif above_t == 3:
                    ctx += left_t
                else:
                    ctx += 3
                b.interp[d] = td.sym(
                    td.cdf["switchable_interp"][ctx])
        if not seq.enable_dual_filter:
            b.interp[1] = b.interp[0]
    else:
        b.interp = [fh.interp_filter, fh.interp_filter]


def _ref_is_scaled(td, ref: int) -> bool:
    """libaom av1_is_scaled: the ref's stored (upscaled) geometry vs
    the current CODED width (post-superres-downscale, fh.width — NOT
    upscaled_width: with superres active every ref is scaled, which
    gates the motion-mode read to the OBMC bool)."""
    rf = td.fs.refs[td.fh.ref_frame_idx[ref - C.LAST_FRAME]]
    if rf is None:
        return False
    return (rf.upscaled_width != td.fh.width or
            rf.height != td.fh.height)


def _needs_interp_filter(td, b) -> bool:
    fh = td.fh
    large = min(C.BLOCK_W4[b.bsize],
                C.BLOCK_H4[b.bsize]) * 4 >= 8
    if b.skip_mode or b.motion_mode == C.LOCALWARP:
        return False
    if large and b.y_mode == C.GLOBALMV:
        return fh.gm_type[b.refs[0]] == C.TRANSLATION
    if large and b.y_mode == C.GLOBAL_GLOBALMV:
        return (fh.gm_type[b.refs[0]] == C.TRANSLATION or
                fh.gm_type[b.refs[1]] == C.TRANSLATION)
    return True


def _has_overlappable(td, b, r, c) -> bool:
    fs = td.fs
    bw4, bh4 = C.BLOCK_W4[b.bsize], C.BLOCK_H4[b.bsize]
    if b.avail_u:
        w4 = 0
        while w4 < bw4:
            mc = min((c + w4) | 1, fs.mi_cols - 1)
            if fs.ref_frame[r - 1, mc, 0] > C.INTRA_FRAME:
                return True
            w4 += 2
    if b.avail_l:
        h4 = 0
        while h4 < bh4:
            mr = min((r + h4) | 1, fs.mi_rows - 1)
            if fs.ref_frame[mr, c - 1, 0] > C.INTRA_FRAME:
                return True
            h4 += 2
    return False


LEAST_SQUARES_SAMPLES_MAX = 8
LEAST_SQUARES_MV_MAX = 256


def find_warp_samples(td, b, r, c):
    """Spec 7.10.4 / libaom av1_findSamples: collect neighbor
    samples that share RefFrame[0] (single-ref only) for the
    local-warp least-squares fit.  Returns (cand_y8, cand_x8,
    cand_y8+mvr, cand_x8+mvc) rows in absolute x8 units.

    Conformance-critical subtleties (pinned vs dav1d, see
    tests/test_av1_inter.py):
    - sample centers are PSEUDO-centers anchored at the scan offset
      (col_offset*4 + nb_w/2 - 1 relative to this block's origin),
      NOT the neighbor's true block-origin center — they differ when
      a wide neighbor's origin lies left of / above the scan point;
    - the top-left sample is skipped (do_tl=0) when the above
      neighbor extends left of us or the left neighbor extends above
      us; the top-right sample is skipped (do_tr=0) when the above
      neighbor extends past our right edge;
    - there is NO motion-vector validity filter at scan time (the
      ±LS_MV_MAX gate lives in the estimation accumulation loop, and
      the outlier threshold in select_warp_samples)."""
    fs = td.fs
    bw4, bh4 = C.BLOCK_W4[b.bsize], C.BLOCK_H4[b.bsize]
    samples = []
    do_tl = True
    do_tr = True

    def match(mr, mc):
        return (fs.bsize[mr, mc] != 255 and
                int(fs.ref_frame[mr, mc, 0]) == b.refs[0] and
                int(fs.ref_frame[mr, mc, 1]) == C.NONE_FRAME)

    def record(mr, mc, row_off, sign_r, col_off, sign_c):
        nb_w = C.BLOCK_W4[fs.bsize[mr, mc]] * 4
        nb_h = C.BLOCK_H4[fs.bsize[mr, mc]] * 4
        x = col_off * 4 + sign_c * (nb_w >> 1) - 1
        y = row_off * 4 + sign_r * (nb_h >> 1) - 1
        mv_r = int(fs.mv2[mr, mc, 0, 0])
        mv_c = int(fs.mv2[mr, mc, 0, 1])
        ay8 = (r * 4 + y) * 8
        ax8 = (c * 4 + x) * 8
        samples.append((ay8, ax8, ay8 + mv_r, ax8 + mv_c))

    if b.avail_u:
        src_w4 = C.BLOCK_W4[int(fs.bsize[r - 1, c])]
        if bw4 <= src_w4:
            col_off = -(c % src_w4)
            if col_off < 0:
                do_tl = False
            if col_off + src_w4 > bw4:
                do_tr = False
            if match(r - 1, c):
                record(r - 1, c, 0, -1, col_off, 1)
        else:
            i = 0
            while i < min(bw4, fs.mi_cols - c) and \
                    len(samples) < LEAST_SQUARES_SAMPLES_MAX:
                sw = C.BLOCK_W4[int(fs.bsize[r - 1, c + i])]
                if match(r - 1, c + i):
                    record(r - 1, c + i, 0, -1, i, 1)
                i += min(bw4, sw)
    if b.avail_l and len(samples) < LEAST_SQUARES_SAMPLES_MAX:
        src_h4 = C.BLOCK_H4[int(fs.bsize[r, c - 1])]
        if bh4 <= src_h4:
            row_off = -(r % src_h4)
            if row_off < 0:
                do_tl = False
            if match(r, c - 1):
                record(r, c - 1, row_off, 1, 0, -1)
        else:
            i = 0
            while i < min(bh4, fs.mi_rows - r) and \
                    len(samples) < LEAST_SQUARES_SAMPLES_MAX:
                sh = C.BLOCK_H4[int(fs.bsize[r + i, c - 1])]
                if match(r + i, c - 1):
                    record(r + i, c - 1, i, 1, 0, -1)
                i += min(bh4, sh)
    if (do_tl and b.avail_u and b.avail_l and
            len(samples) < LEAST_SQUARES_SAMPLES_MAX):
        if match(r - 1, c - 1):
            record(r - 1, c - 1, 0, -1, 0, -1)
    if do_tr and len(samples) < LEAST_SQUARES_SAMPLES_MAX:
        mr, mc = r - 1, c + bw4
        if (td.r0 <= mr < td.r1 and td.c0 <= mc < td.c1 and
                match(mr, mc)):
            record(mr, mc, 0, -1, bw4, 1)
    return samples


def select_warp_samples(samples, mv, bsize):
    """libaom av1_selectSamples: drop samples whose MV differs from
    the block MV by more than clamp(max(bw,bh), 16, 112) (sum-abs,
    1/8 px); if none survive, keep the first sample anyway.  Applied
    only when more than one sample was found."""
    if len(samples) <= 1:
        return samples
    bw = C.BLOCK_W4[bsize] * 4
    bh = C.BLOCK_H4[bsize] * 4
    thresh = _clip3(16, 112, max(bw, bh))
    keep = [p for p in samples
            if (abs((p[2] - p[0]) - mv[0]) +
                abs((p[3] - p[1]) - mv[1])) <= thresh]
    return keep if keep else samples[:1]
