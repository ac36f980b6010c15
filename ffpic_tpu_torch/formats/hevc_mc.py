"""HEVC motion compensation (H.265 8.5.4): fractional sample
interpolation (8-tap luma quarter-pel, 4-tap chroma eighth-pel) and
the weighted sample prediction process.

TPU-first note: inter prediction reads only *reference* pictures, so
every InterOp of a picture is independent — the whole MC pass is a
bounds-clipped gather + two small convolutions per PU and batches per
(w, h, frac) bucket with no wavefront (unlike intra).  The host numpy
path here is the golden implementation; the batched device path can
reuse the same seam (see ops/hevc_kernels.py for the residual
analog).

The C reference has no inter pixel path at all
(its coding/hevc.c:6285-6397 parses and discards);
validated against libde265 (tests/test_hevc_inter_decode.py).

Copied from ``ffpic_tpu/formats/hevc_mc.py`` for the PyTorch port,
unchanged: the original runs its motion compensation on the host with
numpy and has no device program for it, so the port's stays on the host
too, reading the reference pictures' host planes.
"""

from __future__ import annotations

import numpy as np

# 8.5.4.2.2.1 table 8-10: luma 8-tap qpel filters (frac 1..3)
_FL = {
    1: np.array([-1, 4, -10, 58, 17, -5, 1, 0], np.int32),
    2: np.array([-1, 4, -11, 40, 40, -11, 4, -1], np.int32),
    3: np.array([0, 1, -5, 17, 58, -10, 4, -1], np.int32),
}
# 8.5.4.2.2.2 table 8-11: chroma 4-tap eighth-pel filters (frac 1..7)
_FC = {
    1: np.array([-2, 58, 10, -2], np.int32),
    2: np.array([-4, 54, 16, -2], np.int32),
    3: np.array([-6, 46, 28, -4], np.int32),
    4: np.array([-4, 36, 36, -4], np.int32),
    5: np.array([-4, 28, 46, -6], np.int32),
    6: np.array([-2, 16, 54, -4], np.int32),
    7: np.array([-2, 10, 58, -2], np.int32),
}


def _gather(plane: np.ndarray, x0: int, y0: int, w: int, h: int,
            pad_l: int, pad_r: int) -> np.ndarray:
    """Edge-replicating block gather (the spec's reference sample
    clipping, 8.5.4.2.2): rows y0-pad_l .. y0+h+pad_r-1, cols
    likewise."""
    ph, pw = plane.shape
    ys = np.clip(np.arange(y0 - pad_l, y0 + h + pad_r), 0, ph - 1)
    xs = np.clip(np.arange(x0 - pad_l, x0 + w + pad_r), 0, pw - 1)
    return plane[np.ix_(ys, xs)].astype(np.int32)


def _conv_h(block: np.ndarray, f: np.ndarray, w: int) -> np.ndarray:
    t = f[0] * block[:, 0:w]
    for i in range(1, len(f)):
        t = t + f[i] * block[:, i:i + w]
    return t


def _conv_v(block: np.ndarray, f: np.ndarray, h: int) -> np.ndarray:
    t = f[0] * block[0:h, :]
    for i in range(1, len(f)):
        t = t + f[i] * block[i:i + h, :]
    return t


def pred14_luma(plane, x0, y0, w, h, mv, bd) -> np.ndarray:
    """Luma prediction at 14-bit intermediate scale
    (8.5.4.2.2.1)."""
    xi, yi = x0 + (mv[0] >> 2), y0 + (mv[1] >> 2)
    fx, fy = mv[0] & 3, mv[1] & 3
    shift1 = bd - 8
    shift3 = 14 - bd
    if fx == 0 and fy == 0:
        return _gather(plane, xi, yi, w, h, 0, 0) << shift3
    if fy == 0:
        blk = _gather(plane, xi, yi, w, h, 3, 4)[3:3 + h, :]
        return _conv_h(blk, _FL[fx], w) >> shift1
    if fx == 0:
        blk = _gather(plane, xi, yi, w, h, 3, 4)[:, 3:3 + w]
        return _conv_v(blk, _FL[fy], h) >> shift1
    blk = _gather(plane, xi, yi, w, h, 3, 4)
    tmp = _conv_h(blk, _FL[fx], w) >> shift1       # (h+7, w)
    return _conv_v(tmp, _FL[fy], h) >> 6


def pred14_chroma(plane, x0, y0, w, h, mv, bd) -> np.ndarray:
    """Chroma prediction at 14-bit scale (8.5.4.2.2.2).  x0/y0/w/h in
    chroma samples; mv is the luma quarter-pel vector = chroma
    eighth-pel at the halved coordinates (4:2:0)."""
    xi, yi = x0 + (mv[0] >> 3), y0 + (mv[1] >> 3)
    fx, fy = mv[0] & 7, mv[1] & 7
    shift1 = bd - 8
    shift3 = 14 - bd
    if fx == 0 and fy == 0:
        return _gather(plane, xi, yi, w, h, 0, 0) << shift3
    if fy == 0:
        blk = _gather(plane, xi, yi, w, h, 1, 2)[1:1 + h, :]
        return _conv_h(blk, _FC[fx], w) >> shift1
    if fx == 0:
        blk = _gather(plane, xi, yi, w, h, 1, 2)[:, 1:1 + w]
        return _conv_v(blk, _FC[fy], h) >> shift1
    blk = _gather(plane, xi, yi, w, h, 1, 2)
    tmp = _conv_h(blk, _FC[fx], w) >> shift1
    return _conv_v(tmp, _FC[fy], h) >> 6


def combine(p0, p1, bd, wp0=None, wp1=None, log2wd=None):
    """Weighted sample prediction (8.5.4.3): default rounding or
    explicit weights.  wpX = (w, o) with the offset already at 8-bit
    scale (scaled by bd-8 here); log2wd = weight denom log2
    (pre-14-bit adjust)."""
    maxv = (1 << bd) - 1
    if p1 is None and p0 is not None or p0 is None:
        p = p0 if p0 is not None else p1
        wp = wp0 if p0 is not None else wp1
        if wp is None:
            shift = 14 - bd
            off = 1 << (shift - 1)
            return np.clip((p + off) >> shift, 0, maxv)
        w, o = wp
        lwd = log2wd + (14 - bd)
        o = o << (bd - 8)
        if lwd >= 1:
            return np.clip(((p * w + (1 << (lwd - 1))) >> lwd) + o,
                           0, maxv)
        return np.clip(p * w + o, 0, maxv)
    if wp0 is None and wp1 is None:
        shift = 15 - bd
        off = 1 << (shift - 1)
        return np.clip((p0 + p1 + off) >> shift, 0, maxv)
    w0, o0 = wp0 if wp0 is not None else (1 << log2wd, 0)
    w1, o1 = wp1 if wp1 is not None else (1 << log2wd, 0)
    lwd = log2wd + (14 - bd)
    o0 = o0 << (bd - 8)
    o1 = o1 << (bd - 8)
    return np.clip((p0 * w0 + p1 * w1 + ((o0 + o1 + 1) << lwd))
                   >> (lwd + 1), 0, maxv)


def predict_inter(pic, op, ref_pics: dict) -> None:
    """Motion-compensate one InterOp into the current picture's
    planes.  ref_pics maps POC -> reconstructed reference Picture."""
    bd = pic.bd
    x, y, w, h = op.x, op.y, op.w, op.h
    refs = []
    for lx, (mv, poc) in enumerate(((op.mv0, op.poc0),
                                    (op.mv1, op.poc1))):
        refs.append(None if mv is None else ref_pics[poc])
    wp = op.wp        # None | (log2_luma, log2_chroma, e0, e1)
    for plane in range(len(pic.planes)):
        if plane == 0:
            px, py, pw, ph = x, y, w, h
        else:
            px, py, pw, ph = x >> 1, y >> 1, w >> 1, h >> 1
        preds = [None, None]
        wps = [None, None]
        for lx in range(2):
            if refs[lx] is None:
                continue
            mv = op.mv0 if lx == 0 else op.mv1
            rp = refs[lx].planes[plane]
            if plane == 0:
                preds[lx] = pred14_luma(rp, px, py, pw, ph, mv, bd)
            else:
                preds[lx] = pred14_chroma(rp, px, py, pw, ph, mv, bd)
            if wp is not None and wp[2 + lx] is not None:
                e = wp[2 + lx]
                wps[lx] = (e[2 * plane], e[2 * plane + 1])
        lwd = None
        if wp is not None:
            lwd = wp[0] if plane == 0 else wp[1]
        out = combine(preds[0], preds[1], bd, wps[0], wps[1], lwd)
        pic.planes[plane][py:py + ph, px:px + pw] = out
        # availability for subsequent intra prediction (rectangular)
        m = pic.masks[plane]
        m[py // 4:(py + ph + 3) // 4, px // 4:(px + pw + 3) // 4] = True
