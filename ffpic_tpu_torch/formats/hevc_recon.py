"""HEVC reconstruction: intra prediction (8.4.4.2), residual
application, deblocking filter (8.7.2) and SAO (8.7.3).

Design (TPU-first split, SURVEY.md §3.5): the CABAC syntax pass
(coding/hevc_slice.py) emits an ordered list of reconstruction ops;
this module executes them.  Residual inverse transforms have no
feedback dependency, so they are computed up front — batched per TU
size bucket, device-offloadable — while intra prediction runs as a
host wavefront over the op list (each TB needs reconstructed
neighbors).  Deblock + SAO are whole-plane passes at the end; the
reference stubs deblock and force-disables SAO (hevc.c:7173-7192), we
implement both for real.

Reference parity anchors: predict.c:651-792 (planar/DC/angular),
hevc.c:4277-4428 (reference samples), hevc.c:7050-7172 (SAO parse).

Copied from ``ffpic_tpu/formats/hevc_recon.py`` for the PyTorch port,
with its imports rewritten to the port's modules.
``execute_ops`` takes ``device``, where ``FFPIC_HEVC_DEVICE``'s
residuals run (``ops.hevc_kernels.residuals_for_ops``: the
``hevc_residuals`` CUDA kernel, or its plain version on the CPU; None
means CUDA).  As in the original, that launch covers every TU of the
op list, the inter TUs too, while an inter residual add (``mode == -1``)
recomputes its TU on the host (``compute_residual``), with the scaling
lists the kernel leaves out (``ROADMAP.md`` Queue 3).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ffpic_tpu_torch.coding.hevc_consts import (
    INTRA_PRED_ANGLE, INV_ANGLE, BETA_TABLE, TC_TABLE,
    dequant, inverse_transform)

INTRA_PLANAR, INTRA_DC = 0, 1


# ---------------------------------------------------------------------------
# picture state
# ---------------------------------------------------------------------------

@dataclass
class SaoParam:
    """Per-CTB SAO parameters (one per component)."""
    type_idx: tuple = (0, 0, 0)           # 0 off, 1 band, 2 edge
    offsets: tuple = ((0,) * 4,) * 3      # signed, per component
    band_pos: tuple = (0, 0, 0)
    eo_class: tuple = (0, 0, 0)


class Picture:
    """Decoding state for one HEVC picture (4:2:0 or 4:0:0)."""

    def __init__(self, sps):
        self.sps = sps
        self.bd = sps.bit_depth_luma
        self.w = sps.width
        self.h = sps.height
        self.cw = (self.w + 1) >> 1
        self.ch = (self.h + 1) >> 1
        self.planes = [np.zeros((self.h, self.w), np.int32)]
        if sps.chroma_format != 0:
            self.planes += [np.zeros((self.ch, self.cw), np.int32),
                            np.zeros((self.ch, self.cw), np.int32)]
        # decoded masks at 4x4 granularity per plane (availability)
        self.masks = [np.zeros(((p.shape[0] + 3) // 4, (p.shape[1] + 3) // 4),
                               bool) for p in self.planes]
        self.sao_params: dict[tuple, SaoParam] = {}
        # loop-filter barrier masks (4x4 cells): True = the edge at
        # this cell's left (v) / top (h) must not be filtered
        # (slice/tile boundaries with filtering disabled, 8.7.2)
        self.lf_block_v = None
        self.lf_block_h = None
        # per-4x4 luma QP map (for deblocking tC/beta lookups)
        self.qp_map = np.zeros(((self.h + 3) // 4, (self.w + 3) // 4),
                               np.int32)
        # TU/CU edge flags on the 8x8 deblocking grid
        self.v_edges = np.zeros((self.h, (self.w + 7) // 8), bool)
        self.h_edges = np.zeros(((self.h + 7) // 8, self.w), bool)
        self.bypass_map = np.zeros(((self.h + 3) // 4, (self.w + 3) // 4),
                                   bool)
        # inter state: PU edges (8.7.2.4 bS needs the TU/PU
        # distinction), per-segment bS arrays (computed by compute_bs
        # for P/B pictures; None = intra picture, all edges bS 2),
        # and the POC->Picture map for MC
        self.pu_v_edges = np.zeros_like(self.v_edges)
        self.pu_h_edges = np.zeros_like(self.h_edges)
        self.bs_v = None
        self.bs_h = None
        self.ref_pics: dict = {}
        self.motion = None       # MotionField after an inter decode
        self.poc = 0

    def mark_decoded(self, plane: int, x: int, y: int, size: int) -> None:
        m = self.masks[plane]
        m[y // 4:(y + size + 3) // 4, x // 4:(x + size + 3) // 4] = True

    def mark_edges(self, x: int, y: int, size: int) -> None:
        """Record a TU/CU boundary (luma coords) for deblocking."""
        if x % 8 == 0 and x > 0:
            self.v_edges[y:y + size, x // 8] = True
        if y % 8 == 0 and y > 0:
            self.h_edges[y // 8, x:x + size] = True

    def mark_edges_rect(self, x: int, y: int, w: int, h: int) -> None:
        """Record a PU boundary (all four edges — unlike TBs in intra
        pictures, PUs border skip/no-residual CUs that mark nothing,
        so bottom/right edges must be recorded by this block; 8-grid
        aligned only, AMP quarter offsets are never filtered,
        8.7.2.2)."""
        if x % 8 == 0 and x > 0:
            self.pu_v_edges[y:y + h, x // 8] = True
        if y % 8 == 0 and y > 0:
            self.pu_h_edges[y // 8, x:x + w] = True
        xr, yb = x + w, y + h
        if xr % 8 == 0 and xr < self.w:
            self.pu_v_edges[y:y + h, xr // 8] = True
        if yb % 8 == 0 and yb < self.h:
            self.pu_h_edges[yb // 8, x:x + w] = True

    def mark_edges_full(self, x: int, y: int, size: int) -> None:
        """TB edge marking for inter pictures: all four edges (a TB's
        bottom/right edge can border a CU with no transform tree —
        still a TU edge for the bS=1 coefficient rule, 8.7.2.4)."""
        self.mark_edges(x, y, size)
        xr, yb = x + size, y + size
        if xr % 8 == 0 and xr < self.w:
            self.v_edges[y:y + size, xr // 8] = True
        if yb % 8 == 0 and yb < self.h:
            self.h_edges[yb // 8, x:x + size] = True

    def mark_edges_batch(self, xs, ys, ns) -> None:
        """Vectorized mark_edges over TB arrays (one fancy-index write
        per distinct TB size instead of a Python loop per TB)."""
        xs = np.asarray(xs, np.int64)
        ys = np.asarray(ys, np.int64)
        ns = np.asarray(ns, np.int64)
        for n in np.unique(ns):
            sel = ns == n
            x, y = xs[sel], ys[sel]
            v = (x % 8 == 0) & (x > 0)
            if v.any():
                rows = (y[v][:, None] + np.arange(n)).ravel()
                cols = np.repeat(x[v] // 8, n)
                ok = rows < self.v_edges.shape[0]
                self.v_edges[rows[ok], cols[ok]] = True
            hm = (y % 8 == 0) & (y > 0)
            if hm.any():
                cols = (x[hm][:, None] + np.arange(n)).ravel()
                rows = np.repeat(y[hm] // 8, n)
                ok = cols < self.h_edges.shape[1]
                self.h_edges[rows[ok], cols[ok]] = True


# ---------------------------------------------------------------------------
# intra prediction (8.4.4.2)
# ---------------------------------------------------------------------------

def _gather_reference(pic: Picture, plane: int, x: int, y: int,
                      n: int) -> tuple[np.ndarray, np.ndarray, int, bool]:
    """Reference sample gathering + substitution (8.4.4.2.1-2).

    Returns (top, left, corner): top[0..2n-1] = p[x..][-1],
    left[0..2n-1] = p[-1][y..], corner = p[-1][-1].
    """
    pl = pic.planes[plane]
    mask = pic.masks[plane]
    ph, pw = pl.shape
    bd_mid = 1 << (pic.bd - 1)

    total = 4 * n + 1
    vals = np.empty(total, np.int64)     # scan: bottom-left .. top-right
    ok = np.zeros(total, bool)
    # left column bottom-up: p[-1][y+2n-1] .. p[-1][y]
    if x > 0:
        sy = np.arange(y + 2 * n - 1, y - 1, -1)
        valid = sy < ph
        syc = np.minimum(sy, ph - 1)
        ok[:2 * n] = valid & mask[syc // 4, (x - 1) // 4]
        vals[:2 * n] = np.where(ok[:2 * n], pl[syc, x - 1], 0)
    # corner
    if x > 0 and y > 0 and mask[(y - 1) // 4, (x - 1) // 4]:
        vals[2 * n] = pl[y - 1, x - 1]
        ok[2 * n] = True
    # top row left-to-right: p[x][-1] .. p[x+2n-1][-1]
    if y > 0:
        sx = np.arange(x, x + 2 * n)
        valid = sx < pw
        sxc = np.minimum(sx, pw - 1)
        ok[2 * n + 1:] = valid & mask[(y - 1) // 4, sxc // 4]
        vals[2 * n + 1:] = np.where(ok[2 * n + 1:], pl[y - 1, sxc], 0)

    if not ok.any():
        vals[:] = bd_mid
    elif not ok.all():
        # substitution: first entry takes the first available value,
        # then forward-fill (8.4.4.2.2)
        if not ok[0]:
            vals[0] = vals[np.argmax(ok)]
            ok[0] = True
        for i in range(1, total):
            if not ok[i]:
                vals[i] = vals[i - 1]

    left = vals[2 * n - 1::-1]           # p[-1][y] .. p[-1][y+2n-1]
    corner = int(vals[2 * n])
    top = vals[2 * n + 1:]
    return top.copy(), left.copy(), corner


def _filter_reference(top, left, corner, n, mode, bd,
                      strong_smoothing: bool):
    """8.4.4.2.3 reference sample filtering (luma only)."""
    if mode == INTRA_DC or n == 4:
        return top, left, corner
    min_dist = min(abs(mode - 26), abs(mode - 10))
    thres = {8: 7, 16: 1, 32: 0}[n]
    if not (mode == INTRA_PLANAR or min_dist > thres):
        return top, left, corner
    if (n == 32 and strong_smoothing and
            abs(corner + top[2 * n - 1] - 2 * top[n - 1]) < (1 << (bd - 5))
            and abs(corner + left[2 * n - 1] - 2 * left[n - 1])
            < (1 << (bd - 5))):
        i = np.arange(2 * n - 1)
        ft = np.empty_like(top)
        fl = np.empty_like(left)
        ft[:2 * n - 1] = ((63 - i) * corner + (i + 1) * top[2 * n - 1]
                          + 32) >> 6
        ft[2 * n - 1] = top[2 * n - 1]
        fl[:2 * n - 1] = ((63 - i) * corner + (i + 1) * left[2 * n - 1]
                          + 32) >> 6
        fl[2 * n - 1] = left[2 * n - 1]
        return ft, fl, corner
    # [1 2 1] smoothing
    ft = np.empty_like(top)
    fl = np.empty_like(left)
    ft[0] = (corner + 2 * top[0] + top[1] + 2) >> 2
    ft[1:2 * n - 1] = (top[:2 * n - 2] + 2 * top[1:2 * n - 1]
                       + top[2:] + 2) >> 2
    ft[2 * n - 1] = top[2 * n - 1]
    fl[0] = (corner + 2 * left[0] + left[1] + 2) >> 2
    fl[1:2 * n - 1] = (left[:2 * n - 2] + 2 * left[1:2 * n - 1]
                       + left[2:] + 2) >> 2
    fl[2 * n - 1] = left[2 * n - 1]
    fc = (left[0] + 2 * corner + top[0] + 2) >> 2
    return ft, fl, fc


def predict_intra(pic: Picture, plane: int, x: int, y: int, n: int,
                  mode: int) -> np.ndarray:
    """Intra sample prediction (8.4.4.2.4-7) for one nxn TB.

    x/y are plane-local sample coords.  Returns (n, n) int32.
    """
    bd = pic.bd
    maxv = (1 << bd) - 1
    top, left, corner = _gather_reference(pic, plane, x, y, n)
    if plane == 0:
        top, left, corner = _filter_reference(
            top, left, corner, n, mode, bd,
            getattr(pic.sps, "strong_intra_smoothing", False))

    if mode == INTRA_PLANAR:                       # 8.4.4.2.4
        xs = np.arange(n)
        ys = np.arange(n)[:, None]
        pred = ((n - 1 - xs) * left[ys] + (xs + 1) * top[n]
                + (n - 1 - ys) * top[xs] + (ys + 1) * left[n] + n)
        return (pred >> (n.bit_length())).astype(np.int32)

    if mode == INTRA_DC:                           # 8.4.4.2.5
        dc = (int(top[:n].sum() + left[:n].sum()) + n) >> n.bit_length()
        pred = np.full((n, n), dc, np.int64)
        if plane == 0 and n < 32:
            pred[0, 0] = (left[0] + 2 * dc + top[0] + 2) >> 2
            pred[0, 1:] = (top[1:n] + 3 * dc + 2) >> 2
            pred[1:, 0] = (left[1:n] + 3 * dc + 2) >> 2
        return pred.astype(np.int32)

    # angular (8.4.4.2.6)
    angle = INTRA_PRED_ANGLE[mode - 2]
    if mode >= 18:
        main, side, side_corner = top, left, corner
    else:
        main, side, side_corner = left, top, corner
    # build ref[-n .. 2n]: index offset n
    ref = np.zeros(3 * n + 1, np.int64)
    ref[n] = corner
    ref[n + 1:n + 1 + 2 * n] = main
    if angle < 0:
        last = (n * angle) >> 5
        if last < -1:
            inv = INV_ANGLE[mode - 11]
            for i in range(-1, last - 1, -1):
                idx = ((i * inv + 128) >> 8) - 1
                ref[n + i] = side[idx] if idx >= 0 else side_corner
    pos = (np.arange(1, n + 1) * angle)
    i_idx = pos >> 5
    i_fact = pos & 31
    cols = np.arange(n)
    a = ref[n + 1 + i_idx[:, None] + cols]
    # when iFact == 0 the b sample has zero weight; clamp its index so
    # the gather stays in bounds at mode 2/34's extreme (idx would hit
    # 3n+1)
    b_idx = np.minimum(n + 2 + i_idx[:, None] + cols, 3 * n)
    b = ref[b_idx]
    pred = ((32 - i_fact[:, None]) * a + i_fact[:, None] * b + 16) >> 5
    # rows of `pred` are distance-from-edge; orient for mode direction
    if mode >= 18:
        out = pred                                  # pred[y][x]
    else:
        out = pred.T
    out = out.astype(np.int64)
    if plane == 0 and n < 32:
        if mode == 26:
            col = corner
            out = out.copy()
            out[:, 0] = np.clip(top[0] + ((left[:n] - col) >> 1), 0, maxv)
        elif mode == 10:
            out = out.copy()
            out[0, :] = np.clip(left[0] + ((top[:n] - corner) >> 1),
                                0, maxv)
    return out.astype(np.int32)


# ---------------------------------------------------------------------------
# residual computation (batched per TU; 8.6.2-8.6.5)
# ---------------------------------------------------------------------------

def compute_residual(tu, bd: int) -> np.ndarray:
    """Dequant + inverse transform for one TU (numpy golden path).

    tu fields: levels (n,n int32, [y][x]), qp, skip, bypass, dst,
    scaling (ScalingFactor matrix or None for flat 16).
    """
    if tu.bypass:
        return tu.levels.astype(np.int32)
    d = dequant(tu.levels, tu.qp, bd,
                scaling=getattr(tu, "scaling", None))
    if tu.skip:
        shift2 = 20 - bd
        r = (d.astype(np.int64) << 7)
        r = (r + (1 << (shift2 - 1))) >> shift2
        return np.clip(r, -32768, 32767).astype(np.int32)
    return inverse_transform(d, dst=tu.dst, bit_depth=bd)


# ---------------------------------------------------------------------------
# deblocking filter (8.7.2) — real implementation (reference stubs it)
# ---------------------------------------------------------------------------

def _seg_any_rows(edges: np.ndarray) -> np.ndarray:
    """Reduce (h, c) edge marks to 4-row segments -> (ceil(h/4), c)."""
    n = edges.shape[0]
    pad = (-n) % 4
    if pad:
        edges = np.concatenate(
            [edges, np.zeros((pad, edges.shape[1]), bool)])
    return edges.reshape(-1, 4, edges.shape[1]).any(1)


def _seg_any_cols(edges: np.ndarray) -> np.ndarray:
    """Reduce (r, w) edge marks to 4-col segments -> (r, ceil(w/4))."""
    n = edges.shape[1]
    pad = (-n) % 4
    if pad:
        edges = np.concatenate(
            [edges, np.zeros((edges.shape[0], pad), bool)], axis=1)
    return edges.reshape(edges.shape[0], -1, 4).any(2)


def _mv_mismatch(rp_p, mv_p, rp_q, mv_q, no_ref):
    """Vectorized 8.7.2.4 motion comparison: True where bS = 1 by
    reference/MV difference.  rp_X: (2, ...) ref POCs, mv_X:
    (2, ..., 2) quarter-pel MVs."""
    pv = rp_p != no_ref                   # (2, ...) pred flags
    qv = rp_q != no_ref
    cnt_p = pv[0].astype(np.int32) + pv[1]
    cnt_q = qv[0].astype(np.int32) + qv[1]
    out = cnt_p != cnt_q

    def big(a, b):
        return (np.abs(a[..., 0] - b[..., 0]) >= 4) | \
               (np.abs(a[..., 1] - b[..., 1]) >= 4)

    # uni/uni: compare the single used (poc, mv) of each side
    p_poc1 = np.where(pv[0], rp_p[0], rp_p[1])
    q_poc1 = np.where(qv[0], rp_q[0], rp_q[1])
    p_mv1 = np.where(pv[0][..., None], mv_p[0], mv_p[1])
    q_mv1 = np.where(qv[0][..., None], mv_q[0], mv_q[1])
    uni = (cnt_p == 1) & (cnt_q == 1)
    out |= uni & ((p_poc1 != q_poc1) | big(p_mv1, q_mv1))

    # bi/bi
    bi = (cnt_p == 2) & (cnt_q == 2)
    pair_straight = (rp_p[0] == rp_q[0]) & (rp_p[1] == rp_q[1])
    pair_cross = (rp_p[0] == rp_q[1]) & (rp_p[1] == rp_q[0])
    diff_pair = ~(pair_straight | pair_cross)
    straight_big = big(mv_p[0], mv_q[0]) | big(mv_p[1], mv_q[1])
    cross_big = big(mv_p[0], mv_q[1]) | big(mv_p[1], mv_q[0])
    same_ref_both = rp_p[0] == rp_p[1]    # same picture in both lists
    bi_mis = np.where(
        diff_pair, True,
        np.where(same_ref_both, straight_big & cross_big,
                 np.where(pair_straight, straight_big, cross_big)))
    out |= bi & bi_mis
    return out


def compute_bs(pic: Picture, fld, intra_map, nonzero_map) -> None:
    """Boundary-strength arrays for an inter picture (8.7.2.4), at
    4-sample segment granularity: pic.bs_v[(y//4, x//8)] for the
    vertical edge at x, pic.bs_h[(y//8, x//4)] for the horizontal
    edge at y.  fld is the picture's MotionField."""
    from ffpic_tpu_torch.coding.hevc_inter import NO_REF
    mh, mw = intra_map.shape
    im = intra_map.astype(bool)
    nz = nonzero_map.astype(bool)

    # vertical edges
    tu_v = _seg_any_rows(pic.v_edges)        # (h4, W8)
    pu_v = _seg_any_rows(pic.pu_v_edges)
    h4, w8 = tu_v.shape
    cc = np.arange(w8)
    xq = np.clip(2 * cc, 0, mw - 1)
    xp = np.clip(2 * cc - 1, 0, mw - 1)
    rows = np.arange(min(h4, mh))
    edge = (tu_v | pu_v)[:len(rows)]
    edge[:, 0] = False
    i2 = im[np.ix_(rows, xp)] | im[np.ix_(rows, xq)]
    coeff = tu_v[:len(rows)] & (nz[np.ix_(rows, xp)]
                                | nz[np.ix_(rows, xq)])
    rp_p = fld.refpoc[:, rows][:, :, xp]
    rp_q = fld.refpoc[:, rows][:, :, xq]
    mv_p = fld.mv[:, rows][:, :, xp].astype(np.int32)
    mv_q = fld.mv[:, rows][:, :, xq].astype(np.int32)
    mis = _mv_mismatch(rp_p, mv_p, rp_q, mv_q, NO_REF)
    bs = np.zeros((h4, w8), np.int8)
    bs[:len(rows)][edge & i2] = 2
    bs[:len(rows)][edge & ~i2 & (coeff | mis)] = 1
    pic.bs_v = bs

    # horizontal edges
    tu_h = _seg_any_cols(pic.h_edges)        # (H8, w4)
    pu_h = _seg_any_cols(pic.pu_h_edges)
    h8, w4 = tu_h.shape
    rr = np.arange(h8)
    yq = np.clip(2 * rr, 0, mh - 1)
    yp = np.clip(2 * rr - 1, 0, mh - 1)
    cols = np.arange(min(w4, mw))
    edge = (tu_h | pu_h)[:, :len(cols)]
    edge[0, :] = False
    i2 = im[np.ix_(yp, cols)] | im[np.ix_(yq, cols)]
    coeff = tu_h[:, :len(cols)] & (nz[np.ix_(yp, cols)]
                                   | nz[np.ix_(yq, cols)])
    rp_p = fld.refpoc[:, yp][:, :, cols]
    rp_q = fld.refpoc[:, yq][:, :, cols]
    mv_p = fld.mv[:, yp][:, :, cols].astype(np.int32)
    mv_q = fld.mv[:, yq][:, :, cols].astype(np.int32)
    mis = _mv_mismatch(rp_p, mv_p, rp_q, mv_q, NO_REF)
    bs = np.zeros((h8, w4), np.int8)
    bs[:, :len(cols)][edge & i2] = 2
    bs[:, :len(cols)][edge & ~i2 & (coeff | mis)] = 1
    pic.bs_h = bs


def _deblock_luma_edge(pl, qp_map, edges, beta_off, tc_off, vertical,
                       bd=8, bypass_map=None, lf_block=None, bs=None):
    """Filter luma edges in one direction, in 4-line segments along
    each 8-aligned edge.  Without a bS array every marked edge is
    bS=2 (intra pictures); with one (inter pictures) segments filter
    at their computed strength."""
    h, w = pl.shape
    if vertical:
        for ci in range(edges.shape[1]):
            xc = ci * 8
            if xc == 0 or xc >= w:
                continue
            if bs is None and not edges[:, ci].any():
                continue
            if bs is not None and not bs[:, ci].any():
                continue
            for y0 in range(0, h, 4):
                if bs is None:
                    seg_bs = 2
                    if not edges[y0:y0 + 4, ci].any():
                        continue
                else:
                    seg_bs = int(bs[y0 // 4, ci])
                    if not seg_bs:
                        continue
                if lf_block is not None and \
                        lf_block[y0 // 4, xc // 4]:
                    continue
                _filter_luma_segment(pl, xc, y0, qp_map, beta_off,
                                     tc_off, True, bd, bypass_map,
                                     seg_bs)
    else:
        for ri in range(edges.shape[0]):
            yc = ri * 8
            if yc == 0 or yc >= h:
                continue
            if bs is None and not edges[ri].any():
                continue
            if bs is not None and not bs[ri].any():
                continue
            for x0 in range(0, w, 4):
                if bs is None:
                    seg_bs = 2
                    if not edges[ri, x0:x0 + 4].any():
                        continue
                else:
                    seg_bs = int(bs[ri, x0 // 4])
                    if not seg_bs:
                        continue
                if lf_block is not None and \
                        lf_block[yc // 4, x0 // 4]:
                    continue
                _filter_luma_segment(pl, x0, yc, qp_map, beta_off,
                                     tc_off, False, bd, bypass_map,
                                     seg_bs)


def _filter_luma_segment(pl, x, y, qp_map, beta_off, tc_off, vertical,
                         bd=8, bypass_map=None, bs=2):
    """One 4-line luma deblock decision+filter (8.7.2.5.3).
    beta/tc scale by 1 << (bd - 8) per 8.7.2.5.3.  Samples in a
    transquant-bypass CU are never modified (nDp/nDq = 0)."""
    h, w = pl.shape
    p_byp = q_byp = False
    if bypass_map is not None:
        if vertical:
            p_byp = bool(bypass_map[y // 4, (x - 1) // 4])
            q_byp = bool(bypass_map[y // 4, x // 4])
        else:
            p_byp = bool(bypass_map[(y - 1) // 4, x // 4])
            q_byp = bool(bypass_map[y // 4, x // 4])
        if p_byp and q_byp:
            return
    if vertical:
        if x < 4 or x + 3 >= w or y + 3 >= h:
            return
        # copy: p/q must not write through before the bypass-gated
        # writeback below
        blk = pl[y:y + 4, x - 4:x + 4].copy()    # rows = lines
    else:
        if y < 4 or y + 3 >= h or x + 3 >= w:
            return
        blk = pl[y - 4:y + 4, x:x + 4].T.copy()
    p = blk[:, 3::-1]                         # p0..p3 away from edge
    q = blk[:, 4:]
    qp_p = qp_map[(y if vertical else y - 1) // 4,
                  (x - 1 if vertical else x) // 4]
    qp_q = qp_map[y // 4, x // 4]
    qp_l = (int(qp_p) + int(qp_q) + 1) >> 1
    b_idx = min(max(qp_l + (beta_off << 1), 0), 51)
    beta = BETA_TABLE[b_idx] << (bd - 8)
    tc_idx = min(max(qp_l + 2 * (bs - 1) + (tc_off << 1), 0), 53)
    tc = TC_TABLE[tc_idx] << (bd - 8)
    if beta == 0:
        return
    dp0 = abs(int(p[0, 2]) - 2 * int(p[0, 1]) + int(p[0, 0]))
    dp3 = abs(int(p[3, 2]) - 2 * int(p[3, 1]) + int(p[3, 0]))
    dq0 = abs(int(q[0, 2]) - 2 * int(q[0, 1]) + int(q[0, 0]))
    dq3 = abs(int(q[3, 2]) - 2 * int(q[3, 1]) + int(q[3, 0]))
    d = dp0 + dq0 + dp3 + dq3
    if d >= beta:
        return
    # strong/weak decision on lines 0 and 3
    def strong(i):
        return (2 * (dp0 + dq0 if i == 0 else dp3 + dq3) < (beta >> 2)
                and abs(int(p[i, 3]) - int(p[i, 0]))
                + abs(int(q[i, 0]) - int(q[i, 3])) < (beta >> 3)
                and abs(int(p[i, 0]) - int(q[i, 0]))
                < ((5 * tc + 1) >> 1))
    use_strong = strong(0) and strong(3)
    pi = p.astype(np.int64)
    qi = q.astype(np.int64)
    if use_strong:
        np0 = (pi[:, 2] + 2 * pi[:, 1] + 2 * pi[:, 0] + 2 * qi[:, 0]
               + qi[:, 1] + 4) >> 3
        np1 = (pi[:, 2] + pi[:, 1] + pi[:, 0] + qi[:, 0] + 2) >> 2
        np2 = (2 * pi[:, 3] + 3 * pi[:, 2] + pi[:, 1] + pi[:, 0]
               + qi[:, 0] + 4) >> 3
        nq0 = (qi[:, 2] + 2 * qi[:, 1] + 2 * qi[:, 0] + 2 * pi[:, 0]
               + pi[:, 1] + 4) >> 3
        nq1 = (qi[:, 2] + qi[:, 1] + qi[:, 0] + pi[:, 0] + 2) >> 2
        nq2 = (2 * qi[:, 3] + 3 * qi[:, 2] + qi[:, 1] + qi[:, 0]
               + pi[:, 0] + 4) >> 3
        p[:, 0] = np.clip(np0, pi[:, 0] - 2 * tc, pi[:, 0] + 2 * tc)
        p[:, 1] = np.clip(np1, pi[:, 1] - 2 * tc, pi[:, 1] + 2 * tc)
        p[:, 2] = np.clip(np2, pi[:, 2] - 2 * tc, pi[:, 2] + 2 * tc)
        q[:, 0] = np.clip(nq0, qi[:, 0] - 2 * tc, qi[:, 0] + 2 * tc)
        q[:, 1] = np.clip(nq1, qi[:, 1] - 2 * tc, qi[:, 1] + 2 * tc)
        q[:, 2] = np.clip(nq2, qi[:, 2] - 2 * tc, qi[:, 2] + 2 * tc)
    else:
        if tc == 0:
            return
        maxv = (1 << bd) - 1
        delta = (9 * (qi[:, 0] - pi[:, 0])
                 - 3 * (qi[:, 1] - pi[:, 1]) + 8) >> 4
        act = np.abs(delta) < tc * 10
        delta = np.clip(delta, -tc, tc)
        dEp = (dp0 + dp3) < ((beta + (beta >> 1)) >> 3)
        dEq = (dq0 + dq3) < ((beta + (beta >> 1)) >> 3)
        p[:, 0] = np.where(act, np.clip(pi[:, 0] + delta, 0, maxv),
                           p[:, 0])
        q[:, 0] = np.where(act, np.clip(qi[:, 0] - delta, 0, maxv),
                           q[:, 0])
        if dEp:
            dp = np.clip((((pi[:, 2] + pi[:, 0] + 1) >> 1)
                          - pi[:, 1] + delta) >> 1, -(tc >> 1), tc >> 1)
            p[:, 1] = np.where(act, np.clip(pi[:, 1] + dp, 0, maxv),
                               p[:, 1])
        if dEq:
            # spec 8.7.2.5.7: the q-side secondary adjustment uses
            # MINUS delta (q0' = q0 - delta) — found round 5 via the
            # libde265 oracle (the C reference stubs deblock, so no
            # prior oracle covered filtered output)
            dq = np.clip((((qi[:, 2] + qi[:, 0] + 1) >> 1)
                          - qi[:, 1] - delta) >> 1, -(tc >> 1), tc >> 1)
            q[:, 1] = np.where(act, np.clip(qi[:, 1] + dq, 0, maxv),
                               q[:, 1])
    # write back (skip the lossless side, 8.7.2.5.3 nDp/nDq = 0)
    if vertical:
        if not p_byp:
            pl[y:y + 4, x - 4:x] = p[:, ::-1]
        if not q_byp:
            pl[y:y + 4, x:x + 4] = q
    else:
        if not p_byp:
            pl[y - 4:y, x:x + 4] = p[:, ::-1].T
        if not q_byp:
            pl[y:y + 4, x:x + 4] = q.T


def _deblock_chroma(pic, beta_off, tc_off, vertical, cb_off=0,
                    cr_off=0):
    """Chroma deblock (8.7.2.5.5): bS=2 edges on the 16-luma grid.
    With per-segment bS arrays (inter pictures) the 4-chroma-row unit
    splits into 2-row halves, each gated on its own luma segment's
    bS == 2."""
    bs_v, bs_h = pic.bs_v, pic.bs_h
    for c in (1, 2):
        pl = pic.planes[c]
        coff = cb_off if c == 1 else cr_off
        ch, cw = pl.shape
        if vertical:
            for xc in range(8, cw, 8):       # chroma 8 = luma 16
                lx = xc * 2
                if lx % 8 or lx // 8 >= pic.v_edges.shape[1]:
                    continue
                for y0 in range(0, ch, 2):
                    if bs_v is not None:
                        if bs_v[(y0 * 2) // 4, lx // 8] != 2:
                            continue
                    elif y0 % 4 == 0:
                        if not pic.v_edges[y0 * 2:(y0 + 4) * 2,
                                           lx // 8].any():
                            continue
                    else:
                        continue     # intra path: 4-row units only
                    if pic.lf_block_v is not None and \
                            pic.lf_block_v[(y0 * 2) // 4, lx // 4]:
                        continue
                    _filter_chroma_segment(
                        pic, c, pl, xc, y0, tc_off, True, coff,
                        nrows=2 if bs_v is not None else 4)
        else:
            for yc in range(8, ch, 8):
                ly = yc * 2
                if ly % 8 or ly // 8 >= pic.h_edges.shape[0]:
                    continue
                for x0 in range(0, cw, 2):
                    if bs_h is not None:
                        if bs_h[ly // 8, (x0 * 2) // 4] != 2:
                            continue
                    elif x0 % 4 == 0:
                        if not pic.h_edges[ly // 8,
                                           x0 * 2:(x0 + 4) * 2].any():
                            continue
                    else:
                        continue
                    if pic.lf_block_h is not None and \
                            pic.lf_block_h[ly // 4, (x0 * 2) // 4]:
                        continue
                    _filter_chroma_segment(
                        pic, c, pl, x0, yc, tc_off, False, coff,
                        nrows=2 if bs_h is not None else 4)


def _filter_chroma_segment(pic, c_idx, pl, x, y, tc_off, vertical,
                           c_qp_off=0, nrows=4):
    h, w = pl.shape
    from ffpic_tpu_torch.coding.hevc_consts import chroma_qp
    if vertical:
        if x < 2 or x + 1 >= w or y + nrows - 1 >= h:
            return
        p_byp = bool(pic.bypass_map[y // 2, (x - 1) // 2])
        q_byp = bool(pic.bypass_map[y // 2, x // 2])
        if p_byp and q_byp:
            return
        p = pl[y:y + nrows, x - 2:x][:, ::-1]
        q = pl[y:y + nrows, x:x + 2]
        qp_a = pic.qp_map[y // 2, (x - 1) // 2]
        qp_b = pic.qp_map[y // 2, x // 2]
    else:
        if y < 2 or y + 1 >= h or x + nrows - 1 >= w:
            return
        p_byp = bool(pic.bypass_map[(y - 1) // 2, x // 2])
        q_byp = bool(pic.bypass_map[y // 2, x // 2])
        if p_byp and q_byp:
            return
        p = pl[y - 2:y, x:x + nrows][::-1].T.copy()
        q = pl[y:y + 2, x:x + nrows].T.copy()
        qp_a = pic.qp_map[(y - 1) // 2, x // 2]
        qp_b = pic.qp_map[y // 2, x // 2]
    # 8.7.2.5.5: QpC from the average luma QP plus the PPS chroma QP
    # offset (qp_map stores luma QpY)
    qpi = min(max(((int(qp_a) + int(qp_b) + 1) >> 1) + c_qp_off, 0), 57)
    qpc = chroma_qp(qpi)
    tc_idx = min(max(qpc + 2 + (tc_off << 1), 0), 53)
    tc = TC_TABLE[tc_idx] << (pic.bd - 8)
    if tc == 0:
        return
    pi, qi = p.astype(np.int64), q.astype(np.int64)
    delta = np.clip((((qi[:, 0] - pi[:, 0]) * 4) + pi[:, 1] - qi[:, 1]
                     + 4) >> 3, -tc, tc)
    maxv = (1 << pic.bd) - 1
    p0 = np.clip(pi[:, 0] + delta, 0, maxv)
    q0 = np.clip(qi[:, 0] - delta, 0, maxv)
    if vertical:
        if not p_byp:
            pl[y:y + nrows, x - 1] = p0
        if not q_byp:
            pl[y:y + nrows, x] = q0
    else:
        if not p_byp:
            pl[y - 1, x:x + nrows] = p0
        if not q_byp:
            pl[y, x:x + nrows] = q0


def deblock(pic: Picture, beta_off: int = 0, tc_off: int = 0,
            cb_qp_off: int = 0, cr_qp_off: int = 0) -> None:
    """8.7.2: vertical edges picture-wide, then horizontal.
    cb/cr_qp_off are the PPS chroma QP offsets (8.7.2.5.5)."""
    byp = pic.bypass_map if pic.bypass_map.any() else None
    _deblock_luma_edge(pic.planes[0], pic.qp_map, pic.v_edges,
                       beta_off, tc_off, True, pic.bd, byp,
                       pic.lf_block_v, bs=pic.bs_v)
    if len(pic.planes) > 1:
        _deblock_chroma(pic, beta_off, tc_off, vertical=True,
                        cb_off=cb_qp_off, cr_off=cr_qp_off)
    _deblock_luma_edge(pic.planes[0], pic.qp_map, pic.h_edges,
                       beta_off, tc_off, False, pic.bd, byp,
                       pic.lf_block_h, bs=pic.bs_h)
    if len(pic.planes) > 1:
        _deblock_chroma(pic, beta_off, tc_off, vertical=False,
                        cb_off=cb_qp_off, cr_off=cr_qp_off)


# ---------------------------------------------------------------------------
# SAO (8.7.3) — real implementation (reference force-disables it)
# ---------------------------------------------------------------------------

_EO_DIRS = {0: ((0, -1), (0, 1)), 1: ((-1, 0), (1, 0)),
            2: ((-1, -1), (1, 1)), 3: ((-1, 1), (1, -1))}


def apply_sao(pic: Picture) -> None:
    if not pic.sao_params:
        return
    ctb = 1 << pic.sps.ctb_log2
    maxv = (1 << pic.bd) - 1
    src = [p.copy() for p in pic.planes]
    for (cx, cy), prm in pic.sao_params.items():
        for c in range(len(pic.planes)):
            t = prm.type_idx[c]
            if t == 0:
                continue
            sz = ctb if c == 0 else ctb // 2
            x0, y0 = cx * sz, cy * sz
            pl = pic.planes[c]
            s = src[c]
            h, w = pl.shape
            x1, y1 = min(x0 + sz, w), min(y0 + sz, h)
            if x0 >= w or y0 >= h:
                continue
            region = s[y0:y1, x0:x1]
            offs = prm.offsets[c]
            if t == 1:                       # band offset
                shift = pic.bd - 5
                bands = region >> shift
                out = region.copy()
                for k in range(4):
                    b = (prm.band_pos[c] + k) & 31
                    out = np.where(bands == b,
                                   np.clip(region + offs[k], 0, maxv), out)
                pl[y0:y1, x0:x1] = out
            else:                            # edge offset
                (dy0, dx0), (dy1, dx1) = _EO_DIRS[prm.eo_class[c]]
                ya, xa = np.mgrid[y0:y1, x0:x1]
                n0y, n0x = ya + dy0, xa + dx0
                n1y, n1x = ya + dy1, xa + dx1
                valid = ((n0y >= 0) & (n0y < h) & (n0x >= 0) & (n0x < w)
                         & (n1y >= 0) & (n1y < h) & (n1x >= 0)
                         & (n1x < w))
                if pic.lf_block_h is not None or \
                        pic.lf_block_v is not None:
                    # 8.7.3 availability: neighbors across a
                    # slice/tile boundary with filtering disabled
                    # leave the sample unmodified
                    ss = 0 if c == 0 else 1
                    valid &= ~_sao_blocked(pic, ya, xa, dy0, dx0, ss)
                    valid &= ~_sao_blocked(pic, ya, xa, dy1, dx1, ss)
                n0 = s[np.clip(n0y, 0, h - 1), np.clip(n0x, 0, w - 1)]
                n1 = s[np.clip(n1y, 0, h - 1), np.clip(n1x, 0, w - 1)]
                sign = (np.sign(region - n0) + np.sign(region - n1))
                # edgeIdx mapping: -2->0(+off0) -1->1 0->none +1->2 +2->3
                out = region.copy()
                for sgn, k in ((-2, 0), (-1, 1), (1, 2), (2, 3)):
                    out = np.where(valid & (sign == sgn),
                                   np.clip(region + offs[k], 0, maxv),
                                   out)
                pl[y0:y1, x0:x1] = out


def _sao_blocked(pic, ya, xa, dy, dx, ss):
    """True where the (dy, dx) neighbor of luma/chroma sample
    (ya, xa) crosses a loop-filter barrier (4x4-luma-cell masks)."""
    ly = ya << ss
    lx = xa << ss
    blk = np.zeros(ya.shape, bool)
    bh, bv = pic.lf_block_h, pic.lf_block_v
    if bh is not None and dy != 0:
        if dy < 0:
            edge_row = ly            # edge above sample row
        else:
            edge_row = ly + (1 << ss)
        on_edge = (edge_row % 4 == 0)
        r4 = np.clip(edge_row // 4, 0, bh.shape[0] - 1)
        c4 = np.clip(lx // 4, 0, bh.shape[1] - 1)
        blk |= on_edge & bh[r4, c4] & (edge_row // 4 < bh.shape[0]) \
            & (edge_row > 0 if dy < 0 else True)
    if bv is not None and dx != 0:
        if dx < 0:
            edge_col = lx
        else:
            edge_col = lx + (1 << ss)
        on_edge = (edge_col % 4 == 0)
        r4 = np.clip(ly // 4, 0, bv.shape[0] - 1)
        c4 = np.clip(edge_col // 4, 0, bv.shape[1] - 1)
        blk |= on_edge & bv[r4, c4] & (edge_col // 4 < bv.shape[1]) \
            & (edge_col > 0 if dx < 0 else True)
    return blk


# ---------------------------------------------------------------------------
# op-list execution (pass 2)
# ---------------------------------------------------------------------------

def execute_ops(pic: Picture, ops, device=None) -> None:
    """Run the recon op list from the syntax pass: per-TB intra
    prediction (+ residual add).  Residuals are independent of
    prediction, so with FFPIC_HEVC_DEVICE=1 they all go to ``device``
    first, in one launch (ops/hevc_kernels.residuals_for_ops);
    prediction stays a host wavefront.  Default is the host numpy
    path."""
    import os
    maxv = (1 << pic.bd) - 1
    dev_res = None
    if os.environ.get("FFPIC_HEVC_DEVICE"):
        from ffpic_tpu_torch.ops.hevc_kernels import residuals_for_ops
        dev_res = residuals_for_ops(ops, pic.bd, device)
    cur_zone = None
    for op in ops:
        # availability zones (6.4.1): intra prediction may not cross
        # slice or tile boundaries — ops come in decode order, so a
        # zone change resets the decoded-sample masks
        z = getattr(op, "zone", 0)
        if cur_zone is None:
            cur_zone = z
        elif z != cur_zone:
            for m in pic.masks:
                m[:] = False
            cur_zone = z
        if hasattr(op, "mv0"):             # InterOp: MC from refs
            from ffpic_tpu_torch.formats.hevc_mc import predict_inter
            predict_inter(pic, op, pic.ref_pics)
            continue
        if not hasattr(op, "mode"):        # PcmOp: raw samples
            pic.planes[op.plane][op.y:op.y + op.n,
                                 op.x:op.x + op.n] = op.samples
            pic.mark_decoded(op.plane, op.x, op.y, op.n)
            continue
        if op.mode == -1:                  # inter residual add
            res = compute_residual(op.tu, pic.bd)
            region = pic.planes[op.plane][op.y:op.y + op.n,
                                          op.x:op.x + op.n]
            pic.planes[op.plane][op.y:op.y + op.n,
                                 op.x:op.x + op.n] = \
                np.clip(region + res, 0, maxv)
            continue
        pred = predict_intra(pic, op.plane, op.x, op.y, op.n, op.mode)
        if op.tu is not None:
            if dev_res is not None and id(op.tu) in dev_res:
                res = dev_res[id(op.tu)]
            else:
                res = compute_residual(op.tu, pic.bd)
            pred = np.clip(pred + res, 0, maxv)
        pic.planes[op.plane][op.y:op.y + op.n,
                             op.x:op.x + op.n] = pred
        pic.mark_decoded(op.plane, op.x, op.y, op.n)
