"""AV1 in-loop filters: deblocking (spec 7.14); CDEF (7.15) and loop
restoration (7.17) live in av1_cdef.py / av1_lr.py.

Staged implementation validated against dav1d's inloop_filters mask
(tools/dav1d_oracle.py): each stage can be compared independently
(mask 1 = deblock, 2 = CDEF, 4 = restoration).  The C reference
(junka/ffpic) has no AV1 decode layer (format/avif.c:382-405 stub).

Correctness-first scalar formulation; the frame-level two-pass
structure (all vertical edges of a plane, then all horizontal) is
already the vectorization-friendly shape for the batched TPU path.

Copied from ``ffpic_tpu/formats/av1_loopfilter.py`` for the PyTorch
port with its imports rewritten to the port's modules and these
changes: an intra frame is always deblocked by the native
``av1_deblock_pass`` (the reference also needs its library loaded and
``FFPIC_AV1_NO_NATIVE`` unset); ``FFPIC_AV1_HOST_DEBLOCK`` pins the
numpy vector pass ``_deblock_pass`` as in the reference, and the
scalar pass ``_deblock_pass_scalar`` stays the oracle of both.  Each
stage is a host span (``utils/trace.stage``): ``av1.deblock``,
``av1.cdef``, ``av1.superres`` and ``av1.lr``.
"""

from __future__ import annotations

import os

import numpy as np

from ffpic_tpu_torch import native
from ffpic_tpu_torch.utils.trace import stage

MAX_LOOP_FILTER = 63
SEG_LVL_ALT_LF_Y_V = 1  # + level-class offset (spec SEG_LVL ids 1-4)
INTRA_FRAME = 0


def apply_loop_filters(fs, planes, stages=7):
    """Apply deblock -> CDEF -> loop restoration in spec order.

    stages: bitmask matching dav1d's inloop_filters enum
    (1 = deblock, 2 = CDEF, 4 = restoration) so differential tests can
    pin each stage independently."""
    if stages & 1:
        with stage("av1.deblock"):
            planes = deblock_frame(fs, planes)
    deblocked = planes    # pre-CDEF frame: LR stripe-boundary source
    if stages & 2:
        from ffpic_tpu_torch.formats.av1_cdef import cdef_frame
        with stage("av1.cdef"):
            planes = cdef_frame(fs, planes)
    # superres horizontal upscale sits between CDEF and restoration
    # (spec 7.16); the LR stripe-boundary source upscales too (dav1d
    # stores its lpf line buffers post-resize)
    if getattr(fs.fh, "use_superres", False):
        from ffpic_tpu_torch.formats.av1_superres import superres_frame
        with stage("av1.superres"):
            planes = superres_frame(fs, planes)
            deblocked = superres_frame(fs, deblocked) \
                if (stages & 4) else deblocked
    if stages & 4:
        from ffpic_tpu_torch.formats.av1_lr import lr_frame
        with stage("av1.lr"):
            planes = lr_frame(fs, planes, deblocked)
    return planes


# ------------------------------------------------------------- deblock
def _filter_level(fs, plane, pass_, r, c):
    """Spec 7.14.4 per-position filter level (intra-frame subset:
    ref frame is always INTRA_FRAME, so no mode deltas apply)."""
    fh = fs.fh
    i = pass_ if plane == 0 else plane + 1
    lvl = fh.loop_filter_level[i]
    if fh.delta_lf_present:
        lvl = fh.loop_filter_level[i] + int(
            fs.delta_lf[r, c, i if fh.delta_lf_multi else 0])
        lvl = max(0, min(MAX_LOOP_FILTER, lvl))
    if fh.segmentation_enabled:
        seg = int(fs.seg[r, c])
        feat = SEG_LVL_ALT_LF_Y_V + i
        if fh.feature_enabled[seg][feat]:
            lvl = max(0, min(MAX_LOOP_FILTER,
                             lvl + fh.feature_data[seg][feat]))
    if fh.loop_filter_delta_enabled:
        if fh.frame_is_intra or not fs.is_inter[r, c]:
            lvl += fh.loop_filter_ref_deltas[INTRA_FRAME] << (lvl >> 5)
        else:
            ref = int(fs.ref_frame[r, c, 0])
            mode = int(fs.y_mode[r, c])
            mt = 0 if mode in (15, 23) else 1   # GLOBALMV/GLOBAL_GLOBAL
            lvl += (fh.loop_filter_ref_deltas[ref] +
                    fh.loop_filter_mode_deltas[mt]) << (lvl >> 5)
        lvl = max(0, min(MAX_LOOP_FILTER, lvl))
    return lvl


def _thresholds(lvl, sharpness, bd):
    shift = 2 if sharpness > 4 else (1 if sharpness > 0 else 0)
    if sharpness > 0:
        limit = max(1, min(9 - sharpness, lvl >> shift))
    else:
        limit = max(1, lvl)
    blimit = 2 * (lvl + 2) + limit
    thresh = lvl >> 4
    sc = 1 << (bd - 8)
    return limit * sc, blimit * sc, thresh * sc


def _clip1(v, bd):
    m = (1 << bd) - 1
    return 0 if v < 0 else (m if v > m else v)


def _filter_edge(seg, limit, blimit, thresh, wd, bd):
    """One edge position: seg = [p_{n-1}..p0, q0..q_{n-1}] with
    n = wd's sample reach (7 for wd16, wd//2 otherwise... callers pass
    exactly the reach).  Returns filtered seg or None if masked off.
    Mirrors the normative filter structure (spec 7.14.6)."""
    n = len(seg) // 2
    ps = seg[:n][::-1]          # ps[0] = p0 (nearest the edge)
    qs = seg[n:]
    p0, p1 = ps[0], ps[1]
    q0, q1 = qs[0], qs[1]
    fm = (abs(p1 - p0) <= limit and abs(q1 - q0) <= limit and
          abs(p0 - q0) * 2 + (abs(p1 - q1) >> 1) <= blimit)
    if wd > 4:
        fm = fm and abs(ps[2] - p1) <= limit and \
            abs(qs[2] - q1) <= limit
        if wd > 6:
            fm = fm and abs(ps[3] - ps[2]) <= limit and \
                abs(qs[3] - qs[2]) <= limit
    if not fm:
        return None
    F = 1 << (bd - 8)
    out_p = list(ps)
    out_q = list(qs)
    flat_in = False
    if wd >= 6:
        flat_in = (abs(p1 - p0) <= F and abs(q1 - q0) <= F and
                   abs(ps[2] - p0) <= F and abs(qs[2] - q0) <= F)
        if wd >= 8:
            flat_in = flat_in and abs(ps[3] - p0) <= F and \
                abs(qs[3] - q0) <= F
    if wd >= 16 and flat_in:
        flat_out = all(abs(ps[j] - p0) <= F and abs(qs[j] - q0) <= F
                       for j in range(4, 7))
        if flat_out:
            p6, p5, p4, p3, p2 = ps[6], ps[5], ps[4], ps[3], ps[2]
            q2, q3, q4, q5, q6 = qs[2], qs[3], qs[4], qs[5], qs[6]
            out_p[5] = (p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 +
                        p0 + q0 + 8) >> 4
            out_p[4] = (p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 +
                        p0 + q0 + q1 + 8) >> 4
            out_p[3] = (p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 +
                        p0 + q0 + q1 + q2 + 8) >> 4
            out_p[2] = (p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 +
                        p0 + q0 + q1 + q2 + q3 + 8) >> 4
            out_p[1] = (p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 +
                        p0 * 2 + q0 + q1 + q2 + q3 + q4 + 8) >> 4
            out_p[0] = (p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 +
                        q0 * 2 + q1 + q2 + q3 + q4 + q5 + 8) >> 4
            out_q[0] = (p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2 +
                        q1 * 2 + q2 + q3 + q4 + q5 + q6 + 8) >> 4
            out_q[1] = (p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2 +
                        q2 * 2 + q3 + q4 + q5 + q6 * 2 + 8) >> 4
            out_q[2] = (p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2 +
                        q3 * 2 + q4 + q5 + q6 * 3 + 8) >> 4
            out_q[3] = (p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2 +
                        q4 * 2 + q5 + q6 * 4 + 8) >> 4
            out_q[4] = (p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2 +
                        q5 * 2 + q6 * 5 + 8) >> 4
            out_q[5] = (p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2 +
                        q6 * 7 + 8) >> 4
            return out_p[::-1] + out_q
    if wd >= 8 and flat_in:
        p3, p2 = ps[3], ps[2]
        q2, q3 = qs[2], qs[3]
        out_p[2] = (p3 * 3 + p2 * 2 + p1 + p0 + q0 + 4) >> 3
        out_p[1] = (p3 * 2 + p2 + p1 * 2 + p0 + q0 + q1 + 4) >> 3
        out_p[0] = (p3 + p2 + p1 + p0 * 2 + q0 + q1 + q2 + 4) >> 3
        out_q[0] = (p2 + p1 + p0 + q0 * 2 + q1 + q2 + q3 + 4) >> 3
        out_q[1] = (p1 + p0 + q0 + q1 * 2 + q2 + q3 * 2 + 4) >> 3
        out_q[2] = (p0 + q0 + q1 + q2 * 2 + q3 * 3 + 4) >> 3
        return out_p[::-1] + out_q
    if wd == 6 and flat_in:
        p2, q2 = ps[2], qs[2]
        out_p[1] = (p2 * 3 + p1 * 2 + p0 * 2 + q0 + 4) >> 3
        out_p[0] = (p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + 4) >> 3
        out_q[0] = (p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + 4) >> 3
        out_q[1] = (p0 + q0 * 2 + q1 * 2 + q2 * 3 + 4) >> 3
        return out_p[::-1] + out_q
    # narrow filter (filter4) with high-edge-variance check
    hev = abs(p1 - p0) > thresh or abs(q1 - q0) > thresh
    lo = -128 * F
    hi = 128 * F - 1

    def cd(x):
        return lo if x < lo else (hi if x > hi else x)
    if hev:
        f = cd(p1 - q1)
        f = cd(f + 3 * (q0 - p0))
        f1 = cd(f + 4) >> 3
        f2 = cd(f + 3) >> 3
        out_p[0] = _clip1(p0 + f2, bd)
        out_q[0] = _clip1(q0 - f1, bd)
    else:
        f = cd(3 * (q0 - p0))
        f1 = cd(f + 4) >> 3
        f2 = cd(f + 3) >> 3
        out_p[0] = _clip1(p0 + f2, bd)
        out_q[0] = _clip1(q0 - f1, bd)
        f3 = (f1 + 1) >> 1
        out_p[1] = _clip1(p1 + f3, bd)
        out_q[1] = _clip1(q1 - f3, bd)
    return out_p[::-1] + out_q


def _deblock_native_prm(fs):
    """prm record for host_av1.c:av1_deblock_pass (layout documented
    there)."""
    fh, seq = fs.fh, fs.seq
    prm = np.zeros(81, np.int32)
    prm[0], prm[1] = fs.mi_rows, fs.mi_cols
    prm[79], prm[80] = fh.width, fh.height
    prm[2], prm[3] = seq.bit_depth, fh.loop_filter_sharpness
    prm[4], prm[5] = seq.subsampling_x, seq.subsampling_y
    prm[6:10] = fh.loop_filter_level
    prm[10] = int(fh.delta_lf_present)
    prm[11] = int(fh.delta_lf_multi)
    prm[12] = int(fh.segmentation_enabled)
    prm[13] = int(fh.loop_filter_delta_enabled)
    prm[14] = fh.loop_filter_ref_deltas[INTRA_FRAME]
    for s in range(8):
        for i in range(4):
            feat = SEG_LVL_ALT_LF_Y_V + i
            prm[15 + (s * 4 + i) * 2] = \
                int(fh.feature_enabled[s][feat])
            prm[15 + (s * 4 + i) * 2 + 1] = \
                int(fh.feature_data[s][feat])
    return prm


def deblock_frame(fs, planes):
    fh, seq = fs.fh, fs.seq
    if fh.coded_lossless or fh.allow_intrabc:
        return planes
    if not any(fh.loop_filter_level):
        return planes
    bd = seq.bit_depth
    sharp = fh.loop_filter_sharpness
    dt = planes[0].dtype
    out = [p.astype(np.int32, copy=True) for p in planes]
    use_native = (fh.frame_is_intra
                  and not os.environ.get("FFPIC_AV1_HOST_DEBLOCK"))
    # inter frames use the numpy path: the C level derivation only
    # knows the INTRA_FRAME ref delta (ref/mode deltas planned with
    # the inter C port)
    prm = _deblock_native_prm(fs) if use_native else None
    for plane in range(len(planes)):
        if plane == 1 and not fh.loop_filter_level[2]:
            continue
        if plane == 2 and not fh.loop_filter_level[3]:
            continue
        if plane == 0 and not (fh.loop_filter_level[0] or
                               fh.loop_filter_level[1]):
            continue
        sx = seq.subsampling_x if plane else 0
        sy = seq.subsampling_y if plane else 0
        # NB: no per-pass luma gate on loop_filter_level[pass]: a zero
        # base level can still yield nonzero edge levels via
        # ref/mode/segment/delta-lf adjustments (spec 7.14.4 — only
        # the both-levels-zero plane gate above is normative).
        for pass_ in (0, 1):
            if use_native:
                arr = out[plane]
                native.av1_deblock_pass(
                    arr, arr.shape[0], arr.shape[1], plane, pass_,
                    prm, fs.tx_w4[0 if plane == 0 else 1],
                    fs.tx_h4[0 if plane == 0 else 1],
                    fs.b_col0, fs.b_row0, fs.skip, fs.seg,
                    fs.delta_lf)
            else:
                _deblock_pass(fs, out[plane], plane, pass_, sx, sy,
                              bd, sharp)
    return [p.astype(dt) for p in out]


def _filter_level_grid(fs, plane, pass_, MR, MC):
    """Vectorized spec 7.14.4 over (n4r, n4c) mi-coordinate grids."""
    fh = fs.fh
    i = pass_ if plane == 0 else plane + 1
    base = fh.loop_filter_level[i]
    lvl = np.full(MR.shape, base, np.int32)
    if fh.delta_lf_present:
        d = fs.delta_lf[MR, MC, i if fh.delta_lf_multi else 0]
        lvl = np.clip(base + d.astype(np.int32), 0, MAX_LOOP_FILTER)
    if fh.segmentation_enabled:
        seg = fs.seg[MR, MC].astype(np.int32)
        feat = SEG_LVL_ALT_LF_Y_V + i
        en = np.asarray([fh.feature_enabled[s][feat]
                         for s in range(len(fh.feature_enabled))],
                        bool)[seg]
        dat = np.asarray([fh.feature_data[s][feat]
                          for s in range(len(fh.feature_data))],
                         np.int32)[seg]
        lvl = np.where(en, np.clip(lvl + dat, 0, MAX_LOOP_FILTER),
                       lvl)
    if fh.loop_filter_delta_enabled:
        if fh.frame_is_intra:
            delta = np.int32(fh.loop_filter_ref_deltas[INTRA_FRAME])
        else:
            # per-position ref/mode deltas (spec 7.14.4: mode delta
            # class 0 = intra/GLOBALMV/GLOBAL_GLOBALMV, 1 = other
            # inter modes)
            refs = fs.ref_frame[MR, MC, 0].astype(np.int32)
            modes = fs.y_mode[MR, MC].astype(np.int32)
            inter = fs.is_inter[MR, MC].astype(bool)
            rdel = np.asarray(fh.loop_filter_ref_deltas,
                              np.int32)[np.where(inter, refs, 0)]
            mt = ((modes != 15) & (modes != 23)).astype(np.int32)
            mdel = np.asarray(fh.loop_filter_mode_deltas,
                              np.int32)[mt]
            delta = np.where(
                inter, rdel + mdel,
                np.int32(fh.loop_filter_ref_deltas[INTRA_FRAME]))
        lvl = np.clip(lvl + (delta << (lvl >> 5)), 0,
                      MAX_LOOP_FILTER)
    return lvl


def _filter_edges_vec(seg, limit, blimit, thresh, wd, bd):
    """Vectorized _filter_edge over N lanes: seg (N, 2*reach) int32,
    limit/blimit/thresh (N,).  Returns (out, changed_mask).  Same
    normative math; lanes whose filter mask fails keep their input."""
    n = seg.shape[1] // 2
    ps = seg[:, :n][:, ::-1]
    qs = seg[:, n:]
    p0, p1 = ps[:, 0], ps[:, 1]
    q0, q1 = qs[:, 0], qs[:, 1]
    ad = lambda a, b: np.abs(a - b)
    fm = ((ad(p1, p0) <= limit) & (ad(q1, q0) <= limit) &
          (ad(p0, q0) * 2 + (ad(p1, q1) >> 1) <= blimit))
    if wd > 4:
        fm &= (ad(ps[:, 2], p1) <= limit) & (ad(qs[:, 2], q1) <= limit)
        if wd > 6:
            fm &= (ad(ps[:, 3], ps[:, 2]) <= limit) & \
                (ad(qs[:, 3], qs[:, 2]) <= limit)
    F = 1 << (bd - 8)
    out_p = ps.copy()
    out_q = qs.copy()
    if wd >= 6:
        flat = ((ad(p1, p0) <= F) & (ad(q1, q0) <= F) &
                (ad(ps[:, 2], p0) <= F) & (ad(qs[:, 2], q0) <= F))
        if wd >= 8:
            flat &= (ad(ps[:, 3], p0) <= F) & (ad(qs[:, 3], q0) <= F)
    else:
        flat = np.zeros(len(seg), bool)

    # narrow filter (filter4) with high-edge-variance check — computed
    # for every lane, selected where not flat
    hev = (ad(p1, p0) > thresh) | (ad(q1, q0) > thresh)
    lo, hi = -128 * F, 128 * F - 1
    cd = lambda x: np.clip(x, lo, hi)
    f_hev = cd(cd(p1 - q1) + 3 * (q0 - p0))
    f_no = cd(3 * (q0 - p0))
    f = np.where(hev, f_hev, f_no)
    f1 = cd(f + 4) >> 3
    f2 = cd(f + 3) >> 3
    pmax = (1 << bd) - 1
    n_p0 = np.clip(p0 + f2, 0, pmax)
    n_q0 = np.clip(q0 - f1, 0, pmax)
    f3 = (f1 + 1) >> 1
    n_p1 = np.where(hev, p1, np.clip(p1 + f3, 0, pmax))
    n_q1 = np.where(hev, q1, np.clip(q1 - f3, 0, pmax))
    sel4 = ~flat
    out_p[:, 0] = np.where(sel4, n_p0, out_p[:, 0])
    out_q[:, 0] = np.where(sel4, n_q0, out_q[:, 0])
    out_p[:, 1] = np.where(sel4, n_p1, out_p[:, 1])
    out_q[:, 1] = np.where(sel4, n_q1, out_q[:, 1])

    if wd == 6:
        p2, q2 = ps[:, 2], qs[:, 2]
        w_p = [(p2 * 3 + p1 * 2 + p0 * 2 + q0 + 4) >> 3,
               (p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + 4) >> 3]
        w_q = [(p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + 4) >> 3,
               (p0 + q0 * 2 + q1 * 2 + q2 * 3 + 4) >> 3]
        out_p[:, 1] = np.where(flat, w_p[0], out_p[:, 1])
        out_p[:, 0] = np.where(flat, w_p[1], out_p[:, 0])
        out_q[:, 0] = np.where(flat, w_q[0], out_q[:, 0])
        out_q[:, 1] = np.where(flat, w_q[1], out_q[:, 1])
    elif wd >= 8:
        if wd >= 16:
            flat_out = flat.copy()
            for j in range(4, 7):
                flat_out &= (ad(ps[:, j], p0) <= F) & \
                    (ad(qs[:, j], q0) <= F)
            flat8 = flat & ~flat_out
        else:
            flat_out = np.zeros(len(seg), bool)
            flat8 = flat
        p3, p2 = ps[:, 3], ps[:, 2]
        q2, q3 = qs[:, 2], qs[:, 3]
        e_p = [(p3 * 3 + p2 * 2 + p1 + p0 + q0 + 4) >> 3,
               (p3 * 2 + p2 + p1 * 2 + p0 + q0 + q1 + 4) >> 3,
               (p3 + p2 + p1 + p0 * 2 + q0 + q1 + q2 + 4) >> 3]
        e_q = [(p2 + p1 + p0 + q0 * 2 + q1 + q2 + q3 + 4) >> 3,
               (p1 + p0 + q0 + q1 * 2 + q2 + q3 * 2 + 4) >> 3,
               (p0 + q0 + q1 + q2 * 2 + q3 * 3 + 4) >> 3]
        for k in range(3):
            out_p[:, 2 - k] = np.where(flat8, e_p[k], out_p[:, 2 - k])
            out_q[:, k] = np.where(flat8, e_q[k], out_q[:, k])
        if wd >= 16:
            p6, p5, p4 = ps[:, 6], ps[:, 5], ps[:, 4]
            q4, q5, q6 = qs[:, 4], qs[:, 5], qs[:, 6]
            g_p = [
                (p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0
                 + 8) >> 4,
                (p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0
                 + q0 + q1 + 8) >> 4,
                (p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0
                 + q0 + q1 + q2 + 8) >> 4,
                (p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0
                 + q0 + q1 + q2 + q3 + 8) >> 4,
                (p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2
                 + q0 + q1 + q2 + q3 + q4 + 8) >> 4,
                (p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2
                 + q1 + q2 + q3 + q4 + q5 + 8) >> 4]
            g_q = [
                (p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2 + q1 * 2
                 + q2 + q3 + q4 + q5 + q6 + 8) >> 4,
                (p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2 + q2 * 2
                 + q3 + q4 + q5 + q6 * 2 + 8) >> 4,
                (p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2 + q3 * 2
                 + q4 + q5 + q6 * 3 + 8) >> 4,
                (p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2 + q4 * 2
                 + q5 + q6 * 4 + 8) >> 4,
                (p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2 + q5 * 2
                 + q6 * 5 + 8) >> 4,
                (p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2 + q6 * 7
                 + 8) >> 4]
            for k in range(6):
                out_p[:, 5 - k] = np.where(flat_out, g_p[k],
                                           out_p[:, 5 - k])
                out_q[:, k] = np.where(flat_out, g_q[k],
                                       out_q[:, k])
    out = np.concatenate([out_p[:, ::-1], out_q], axis=1)
    return out, fm


def _deblock_pass(fs, arr, plane, pass_, sx, sy, bd, sharp):
    """Vectorized deblock pass: all edges of one orientation at once.
    Edge independence within a pass is structural — wd is the min of
    the adjacent tx widths, so a filter's write reach (<=6 of 16px,
    <=3 of 8px, <=2 of 4px) never enters a neighboring edge's read
    span; scatter order is therefore free (libaom SIMD relies on the
    same property)."""
    h, w = arr.shape
    n4c = w >> 2
    n4r = h >> 2
    txw = fs.tx_w4[0 if plane == 0 else 1]
    txh = fs.tx_h4[0 if plane == 0 else 1]
    mi_rows, mi_cols = fs.mi_rows, fs.mi_cols
    r4 = np.arange(n4r)
    c4 = np.arange(n4c)
    mr = np.minimum((r4 << sy) | sy, mi_rows - 1)
    mc = np.minimum((c4 << sx) | sx, mi_cols - 1)
    MR = np.broadcast_to(mr[:, None], (n4r, n4c))
    MC = np.broadcast_to(mc[None, :], (n4r, n4c))
    if pass_ == 0:
        pmc = np.minimum((np.maximum(c4 - 1, 0) << sx) | sx,
                         mi_cols - 1)
        PMR, PMC = MR, np.broadcast_to(pmc[None, :], (n4r, n4c))
        tcur = txw[MR, MC].astype(np.int32)
        tprev = txw[PMR, PMC].astype(np.int32)
        on_edge = (np.broadcast_to(c4[None, :], (n4r, n4c))
                   % np.maximum(tcur, 1) == 0) & (c4 > 0)[None, :]
        is_block_edge = (fs.b_col0[MR, MC] >> sx) == c4[None, :]
    else:
        pmr = np.minimum((np.maximum(r4 - 1, 0) << sy) | sy,
                         mi_rows - 1)
        PMR, PMC = np.broadcast_to(pmr[:, None], (n4r, n4c)), MC
        tcur = txh[MR, MC].astype(np.int32)
        tprev = txh[PMR, PMC].astype(np.int32)
        on_edge = (np.broadcast_to(r4[:, None], (n4r, n4c))
                   % np.maximum(tcur, 1) == 0) & (r4 > 0)[:, None]
        is_block_edge = (fs.b_row0[MR, MC] >> sy) == r4[:, None]
    active = on_edge & (is_block_edge | ~fs.skip[MR, MC].astype(bool)
                        | ~fs.skip[PMR, PMC].astype(bool))
    if not active.any():
        return
    lvl = _filter_level_grid(fs, plane, pass_, MR, MC)
    lvlp = _filter_level_grid(fs, plane, pass_, PMR, PMC)
    lvl = np.where(lvl == 0, lvlp, lvl)
    active &= lvl > 0
    m = np.minimum(tcur, tprev)
    if plane == 0:
        wd = np.where(m >= 4, 16, np.where(m >= 2, 8, 4))
    else:
        wd = np.where(m >= 2, 6, 4)

    # vectorized _thresholds
    shift = 2 if sharp > 4 else (1 if sharp > 0 else 0)
    if sharp > 0:
        limit = np.clip(lvl >> shift, 1, 9 - sharp)
    else:
        limit = np.maximum(1, lvl)
    blimit = 2 * (lvl + 2) + limit
    thresh = lvl >> 4
    sc = 1 << (bd - 8)

    for wdc in ((4, 8, 16) if plane == 0 else (4, 6)):
        sel = active & (wd == wdc)
        rr, cc = np.nonzero(sel)
        if rr.size == 0:
            continue
        reach = 7 if wdc == 16 else (wdc >> 1)
        offs = np.arange(-reach, reach)
        if pass_ == 0:
            ys = (rr[:, None] * 4 + np.arange(4)[None, :]).reshape(-1)
            xs = np.repeat(cc * 4, 4)
            seg = arr[ys[:, None], xs[:, None] + offs[None, :]]
        else:
            ys = np.repeat(rr * 4, 4)
            xs = (cc[:, None] * 4 + np.arange(4)[None, :]).reshape(-1)
            seg = arr[ys[:, None] + offs[None, :], xs[:, None]]
        lim = np.repeat(limit[rr, cc] * sc, 4)
        blim = np.repeat(blimit[rr, cc] * sc, 4)
        thr = np.repeat(thresh[rr, cc] * sc, 4)
        out, changed = _filter_edges_vec(seg, lim, blim, thr, wdc, bd)
        if not changed.any():
            continue
        res = np.where(changed[:, None], out, seg)
        if pass_ == 0:
            arr[ys[:, None], xs[:, None] + offs[None, :]] = res
        else:
            arr[ys[:, None] + offs[None, :], xs[:, None]] = res


def _deblock_pass_scalar(fs, arr, plane, pass_, sx, sy, bd, sharp):
    """pass_ 0: vertical edges (filter across columns);
    pass_ 1: horizontal edges.  Scalar oracle for _deblock_pass
    (kept for differential testing; bit-identical by construction)."""
    h, w = arr.shape
    # edges at x/y >= the FRAME extent are not filtered (the mi grid
    # is 8px-aligned; a fully-padding mi column would otherwise
    # produce a phantom tx edge whose p-taps reach real pixels —
    # dav1d-divergent at e.g. 75px-wide frames)
    pfw = (fs.fh.width + sx) >> sx
    pfh = (fs.fh.height + sy) >> sy
    n4c = min(w >> 2, (pfw + 3) >> 2)
    n4r = min(h >> 2, (pfh + 3) >> 2)
    txw = fs.tx_w4[0 if plane == 0 else 1]
    txh = fs.tx_h4[0 if plane == 0 else 1]
    b_col0, b_row0 = fs.b_col0, fs.b_row0
    skip = fs.skip
    mi_rows, mi_cols = fs.mi_rows, fs.mi_cols
    for r4 in range(n4r):
        for c4 in range(n4c):
            if (c4 == 0 and pass_ == 0) or (r4 == 0 and pass_ == 1):
                continue
            # mi coords of this plane position (chroma reads the
            # bottom-right mi of its pair, spec 7.14.5)
            mr = min((r4 << sy) | sy, mi_rows - 1)
            mc = min((c4 << sx) | sx, mi_cols - 1)
            if pass_ == 0:
                pmr = mr
                pmc = min(((c4 - 1) << sx) | sx, mi_cols - 1)
                tcur = int(txw[mr, mc])
                tprev = int(txw[pmr, pmc])
                if c4 % tcur:
                    continue            # not a tx edge
                is_block_edge = (int(b_col0[mr, mc]) >> sx) == c4
            else:
                pmr = min(((r4 - 1) << sy) | sy, mi_rows - 1)
                pmc = mc
                tcur = int(txh[mr, mc])
                tprev = int(txh[pmr, pmc])
                if r4 % tcur:
                    continue
                is_block_edge = (int(b_row0[mr, mc]) >> sy) == r4
            if not (is_block_edge or not skip[mr, mc] or
                    not skip[pmr, pmc]):
                continue
            lvl = _filter_level(fs, plane, pass_, mr, mc)
            if lvl == 0:
                lvl = _filter_level(fs, plane, pass_, pmr, pmc)
            if lvl == 0:
                continue
            m = min(tcur, tprev)
            if plane == 0:
                wd = 16 if m >= 4 else (8 if m >= 2 else 4)
            else:
                wd = 6 if m >= 2 else 4
            reach = 7 if wd == 16 else (wd >> 1)
            limit, blimit, thresh = _thresholds(lvl, sharp, bd)
            if pass_ == 0:
                x = c4 * 4
                for y in range(r4 * 4, r4 * 4 + 4):
                    seg = [int(arr[y, x - reach + k])
                           for k in range(2 * reach)]
                    res = _filter_edge(seg, limit, blimit, thresh,
                                       wd, bd)
                    if res is not None:
                        for k in range(2 * reach):
                            arr[y, x - reach + k] = res[k]
            else:
                y = r4 * 4
                for x in range(c4 * 4, c4 * 4 + 4):
                    seg = [int(arr[y - reach + k, x])
                           for k in range(2 * reach)]
                    res = _filter_edge(seg, limit, blimit, thresh,
                                       wd, bd)
                    if res is not None:
                        for k in range(2 * reach):
                            arr[y - reach + k, x] = res[k]
