"""AV1 loop restoration (spec 7.17): Wiener and self-guided (SGR)
filters over the CDEF output, with the spec's stripe-boundary rule —
rows outside a 64-row (luma) stripe read the *deblocked pre-CDEF*
frame, clamped two rows past the stripe edge (get_source_sample;
dav1d materializes the same rule via saved "lpf" line buffers).

Unit geometry: per plane, units of ``lr_unit_size`` pixels with the
last row/column absorbing sub-half-unit remainders
(count_units_in_frame, spec 5.9.22) and the whole unit grid shifted
UP by 8 luma pixels (RESTORATION_UNIT_OFFSET) so vertical unit
boundaries coincide with stripe boundaries.  Each unit∩stripe block
is filtered independently; parameters come from the tile-parse pass
(FrameState.lr_rtype / lr_wiener / lr_sgr, av1_tile.py:_read_lr_unit).

The C reference (junka/ffpic) has no AV1 decode layer
(format/avif.c:382-405); the oracle is dav1d with inloop_filters
mask 7 (tools/dav1d_oracle.py), bit-exact per test_av1.py.

Correctness-first numpy formulation, vectorized per block: the
Wiener pass is two 7-tap correlations in dav1d's unsigned offset
arithmetic; SGR computes A/B via box sums on (for r==2) the
odd-row-subsampled grid, then the 3/5/6-weight cross combination.

Copied from ``ffpic_tpu/formats/av1_lr.py`` for the PyTorch port with
its imports rewritten to the port's modules.
"""

from __future__ import annotations

import numpy as np

from ffpic_tpu_torch.coding import av1_headers as H
from ffpic_tpu_torch.coding.av1_consts import SGR_PARAMS, count_units_in_frame

RESTORATION_UNIT_OFFSET = 8   # luma pixels; unit grid shifted up


def lr_frame(fs, planes, deblocked):
    """Apply loop restoration.  ``planes`` is the CDEF output,
    ``deblocked`` the post-deblock pre-CDEF frame (stripe-boundary
    source).  Returns new plane list."""
    fh, seq = fs.fh, fs.seq
    if fh.allow_intrabc or not getattr(fh, "uses_lr", False):
        return planes
    out = [p.copy() for p in planes]
    for plane in range(len(planes)):
        if fh.lr_type[plane] == H.RESTORE_NONE:
            continue
        _plane_lr(fs, plane, planes[plane], deblocked[plane],
                  out[plane])
    return out


def _plane_lr(fs, plane, cdef, cur, out):
    seq, fh = fs.seq, fs.fh
    sx = seq.subsampling_x if plane else 0
    sy = seq.subsampling_y if plane else 0
    bd = seq.bit_depth
    ph = (fh.height + sy) >> sy
    pw = (fh.upscaled_width + sx) >> sx   # post-superres width
    unit = fh.lr_unit_size[plane]
    nrows = count_units_in_frame(unit, ph)
    ncols = count_units_in_frame(unit, pw)
    voff = RESTORATION_UNIT_OFFSET >> sy
    cdef = cdef.astype(np.int64, copy=False)
    cur = cur.astype(np.int64, copy=False)
    for ur in range(nrows):
        v0 = max(0, ur * unit - voff)
        v1 = ph if ur == nrows - 1 else (ur + 1) * unit - voff
        for uc in range(ncols):
            rtype = fs.lr_rtype.get((plane, ur, uc), H.RESTORE_NONE)
            if rtype == H.RESTORE_NONE:
                continue
            x0 = uc * unit
            x1 = pw if uc == ncols - 1 else (uc + 1) * unit
            y = v0
            while y < v1:
                snum = ((y << sy) + 8) // 64
                ss = (64 * snum - 8) >> sy
                se = ss + (64 >> sy) - 1
                yb = min(v1, se + 1)
                src = _padded(cdef, cur, y, yb, x0, x1, ss, se,
                              ph, pw)
                if rtype == H.RESTORE_WIENER:
                    taps = fs.lr_wiener[(plane, ur, uc)]
                    blk = _wiener_block(src, taps, bd,
                                        yb - y, x1 - x0)
                else:
                    set_idx, xqd = fs.lr_sgr[(plane, ur, uc)]
                    blk = _sgr_block(src, set_idx, xqd, bd,
                                     yb - y, x1 - x0)
                out[y:yb, x0:x1] = blk
                y = yb


def _padded(cdef, cur, y0, y1, x0, x1, ss, se, ph, pw):
    """(bh+6, bw+6) source window with a 3-px halo per spec
    get_source_sample: x clamps to the frame; y clamps to the frame,
    then to [stripe-2, stripe+2], with out-of-stripe rows read from
    the deblocked (pre-CDEF) frame."""
    ys = np.arange(y0 - 3, y1 + 3)
    yc = np.clip(ys, 0, ph - 1)
    yc = np.clip(yc, ss - 2, se + 2)
    from_cur = (yc < ss) | (yc > se)
    xs = np.clip(np.arange(x0 - 3, x1 + 3), 0, pw - 1)
    rows_cdef = cdef[yc[:, None], xs[None, :]]
    if from_cur.any():
        rows_cur = cur[yc[:, None], xs[None, :]]
        return np.where(from_cur[:, None], rows_cur, rows_cdef)
    return rows_cdef


def _wiener_taps(t):
    t0, t1, t2 = t
    c = 128 - 2 * (t0 + t1 + t2)
    return (t0, t1, t2, c, t2, t1, t0)


def _wiener_block(S, taps, bd, bh, bw):
    """Spec 7.17.4 in dav1d's unsigned-offset arithmetic: horizontal
    7-tap -> clipped intermediate -> vertical 7-tap.  taps[0] is the
    vertical filter, taps[1] the horizontal (syntax order)."""
    vf = _wiener_taps(taps[0])
    hf = _wiener_taps(taps[1])
    rh = 3 + 2 * (bd == 12)
    rv = 11 - 2 * (bd == 12)
    off = 1 << (bd + 6)
    lim = (1 << (bd + 1 + 7 - rh)) - 1
    hor = np.full((bh + 6, bw), off + (1 << (rh - 1)), np.int64)
    for k in range(7):
        hor += hf[k] * S[:, k:k + bw]
    hor >>= rh
    np.clip(hor, 0, lim, out=hor)
    v = np.full((bh, bw),
                (1 << (rv - 1)) - (1 << (bd + rv - 1)), np.int64)
    for k in range(7):
        v += vf[k] * hor[k:k + bh]
    v >>= rv
    return np.clip(v, 0, (1 << bd) - 1)


def _box_sums(S, r, bh, bw, step):
    """Box sums of S and S² of radius r centred on the extended grid
    rows i in [-1, bh] (subsampled by ``step``) and cols j in
    [-1, bw].  S[3+i, 3+j] is sample (i, j)."""
    # direct windowed sums (windows are tiny: 3 or 5 wide)
    w = 2 * r + 1
    cols = np.arange(-1, bw + 1)
    rows = np.arange(-1, bh + 1, step)
    hs1 = np.zeros((S.shape[0], bw + 2), np.int64)
    hs2 = np.zeros_like(hs1)
    for d in range(w):
        sl = S[:, 3 - 1 - r + d: 3 - 1 - r + d + bw + 2]
        hs1 += sl
        hs2 += sl * sl
    b = np.zeros((len(rows), bw + 2), np.int64)
    a = np.zeros_like(b)
    for d in range(w):
        idx = rows + 3 - r + d
        b += hs1[idx]
        a += hs2[idx]
    return a, b, rows, cols


def _round2(x, n):
    if n == 0:
        return x
    return (x + (1 << (n - 1))) >> n


def _box_filter(S, r, s, bd, bh, bw):
    """One SGR pass (spec 7.17.3 box filter): returns F in
    (pixel << SGRPROJ_RST_BITS) scale, shape (bh, bw)."""
    n = (2 * r + 1) * (2 * r + 1)
    step = 2 if r == 2 else 1
    a_raw, b_raw, rows, _ = _box_sums(S, r, bh, bw, step)
    a = _round2(a_raw, 2 * (bd - 8))
    bsh = _round2(b_raw, bd - 8)
    p = np.maximum(a * n - bsh * bsh, 0)
    z = (p * s + (1 << 19)) >> 20
    A = np.where(z >= 255, 256,
                 np.where(z == 0, 1,
                          ((z << 8) + (z >> 1)) // (z + 1)))
    one_n = ((1 << 12) + (n >> 1)) // n
    B = ((256 - A) * b_raw * one_n + (1 << 11)) >> 12
    # cross-shaped combination -> F
    src = S[3:3 + bh, 3:3 + bw]
    F = np.empty((bh, bw), np.int64)
    if r == 2:
        # A/B live on grid rows -1, 1, 3, ... (index g = (i+1)//2)
        for i in range(bh):
            if i & 1:
                g = (i + 1) // 2
                aa = 6 * A[g, 1:bw + 1] + 5 * (A[g, 0:bw] +
                                               A[g, 2:bw + 2])
                bb = 6 * B[g, 1:bw + 1] + 5 * (B[g, 0:bw] +
                                               B[g, 2:bw + 2])
                F[i] = (aa * src[i] + bb + (1 << 7)) >> 8
            else:
                g0 = i // 2
                g1 = g0 + 1
                aa = (6 * (A[g0, 1:bw + 1] + A[g1, 1:bw + 1]) +
                      5 * (A[g0, 0:bw] + A[g0, 2:bw + 2] +
                           A[g1, 0:bw] + A[g1, 2:bw + 2]))
                bb = (6 * (B[g0, 1:bw + 1] + B[g1, 1:bw + 1]) +
                      5 * (B[g0, 0:bw] + B[g0, 2:bw + 2] +
                           B[g1, 0:bw] + B[g1, 2:bw + 2]))
                F[i] = (aa * src[i] + bb + (1 << 8)) >> 9
    else:
        # grid rows -1..bh at index i+1; 3x3 cross: centre+edges 4,
        # corners 3 (total 32)
        for i in range(bh):
            g = i + 1
            aa = (4 * (A[g, 1:bw + 1] + A[g - 1, 1:bw + 1] +
                       A[g + 1, 1:bw + 1] + A[g, 0:bw] +
                       A[g, 2:bw + 2]) +
                  3 * (A[g - 1, 0:bw] + A[g - 1, 2:bw + 2] +
                       A[g + 1, 0:bw] + A[g + 1, 2:bw + 2]))
            bb = (4 * (B[g, 1:bw + 1] + B[g - 1, 1:bw + 1] +
                       B[g + 1, 1:bw + 1] + B[g, 0:bw] +
                       B[g, 2:bw + 2]) +
                  3 * (B[g - 1, 0:bw] + B[g - 1, 2:bw + 2] +
                       B[g + 1, 0:bw] + B[g + 1, 2:bw + 2]))
            F[i] = (aa * src[i] + bb + (1 << 8)) >> 9
    return F


def _sgr_block(S, set_idx, xqd, bd, bh, bw):
    """Self-guided projection (spec 7.17.3 end / libaom
    av1_decode_xq + apply): out = Round2(u*128 + Σ xq_i*(F_i - u),
    11) with u = src << 4."""
    r0, s0, r1, s1 = SGR_PARAMS[set_idx]
    if r0 == 0:
        xq = (0, 128 - xqd[1])
    elif r1 == 0:
        xq = (xqd[0], 0)
    else:
        xq = (xqd[0], 128 - xqd[0] - xqd[1])
    src = S[3:3 + bh, 3:3 + bw]
    u = src << 4
    v = u << 7
    if r0:
        v = v + xq[0] * (_box_filter(S, r0, s0, bd, bh, bw) - u)
    if r1:
        v = v + xq[1] * (_box_filter(S, r1, s1, bd, bh, bw) - u)
    res = (v + (1 << 10)) >> 11
    return np.clip(res, 0, (1 << bd) - 1)
