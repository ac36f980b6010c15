"""AV1 CDEF (Constrained Directional Enhancement Filter, spec 7.15).

Frame is processed in 64x64 luma units; each unit carries a
cdef_idx (read per first non-skip block, av1_tile.py:_read_cdef)
selecting a (pri, sec) strength pair from the frame header.  Per 8x8
luma block: direction search on the post-deblock luma (7.15.2), then
the constrained directional filter (7.15.3) on each plane.  All reads
come from the deblocked frame (CDEF is not in-place); unavailable
taps (outside the mi grid) read CDEF_VERY_LARGE which the constrain
function maps to a zero contribution.

The C reference (junka/ffpic) has no AV1 decode layer
(format/avif.c:382-405); oracle is dav1d with inloop_filters mask 3
(tests/test_av1.py).

Correctness-first numpy formulation: the direction search is fully
vectorized over all 8x8 blocks of the frame; the filter itself is
vectorized per (unit, strength) over the block's pixels.

Copied from ``ffpic_tpu/formats/av1_cdef.py`` for the PyTorch port
unchanged.
"""

from __future__ import annotations

import numpy as np

CDEF_VERY_LARGE = 0x4000

# Cdef_Directions[dir][k] = (dy, dx), spec section 7.15.3
_DIRECTIONS = [
    [(-1, 1), (-2, 2)],
    [(0, 1), (-1, 2)],
    [(0, 1), (0, 2)],
    [(0, 1), (1, 2)],
    [(1, 1), (2, 2)],
    [(1, 0), (2, 1)],
    [(1, 0), (2, 0)],
    [(1, 0), (2, -1)],
]

_DIV_TABLE = np.array([0, 840, 420, 280, 210, 168, 140, 120, 105],
                      np.int64)


def _find_directions(luma: np.ndarray, bd: int):
    """Spec 7.15.2 direction search, vectorized over every 8x8 block.

    Returns (dir, var) int arrays of shape (H//8, W//8)."""
    h8, w8 = luma.shape[0] >> 3, luma.shape[1] >> 3
    px = (luma[:h8 * 8, :w8 * 8].astype(np.int64) >> (bd - 8)) - 128
    blk = px.reshape(h8, 8, w8, 8).transpose(0, 2, 1, 3)  # (h8,w8,8,8)
    i_idx = np.arange(8)[:, None]
    j_idx = np.arange(8)[None, :]
    cost = np.zeros((h8, w8, 8), np.int64)
    partial_idx = [
        i_idx + j_idx,             # d0: 15 bins
        i_idx + (j_idx >> 1),      # d1: 11 bins
        np.broadcast_to(i_idx, (8, 8)),     # d2: 8
        3 + i_idx - (j_idx >> 1),  # d3: 11
        7 + i_idx - j_idx,         # d4: 15
        3 - (i_idx >> 1) + j_idx,  # d5: 11
        np.broadcast_to(j_idx, (8, 8)),     # d6: 8
        (i_idx >> 1) + j_idx,      # d7: 11
    ]
    flat = blk.reshape(h8 * w8, 64)
    for d in range(8):
        idx = partial_idx[d].reshape(64)
        nbin = int(idx.max()) + 1
        part = np.zeros((h8 * w8, nbin), np.int64)
        np.add.at(part.T, idx, flat.T)
        sq = part * part
        if d in (2, 6):
            cost[..., d] = (sq.sum(1) * 105).reshape(h8, w8)
        elif d in (0, 4):
            c = sq[:, 7] * 105
            c += ((sq[:, :7] + sq[:, 14:7:-1]) *
                  _DIV_TABLE[1:8][None, :]).sum(1)
            cost[..., d] = c.reshape(h8, w8)
        else:
            c = sq[:, 3:8].sum(1) * 105
            c += ((sq[:, :3] + sq[:, 10:7:-1]) *
                  _DIV_TABLE[2:8:2][None, :]).sum(1)
            cost[..., d] = c.reshape(h8, w8)
    best = cost.argmax(-1)
    best_cost = np.take_along_axis(cost, best[..., None], -1)[..., 0]
    opp = np.take_along_axis(cost, ((best + 4) & 7)[..., None],
                             -1)[..., 0]
    # spec 7.15.2: Var = (bestCost - cost[(bestDir + 4) & 7]) >> 10
    # (was >> 5 — masked by the i<=12 cap in adjust_strength on
    # high-variance content, caught by the animation key frames)
    var = (best_cost - opp) >> 10
    return best.astype(np.int32), var


def _constrain(diff, threshold, damping):
    if threshold == 0:
        return np.zeros_like(diff)
    shift = max(0, damping - (threshold.bit_length() - 1))
    mag = np.minimum(np.abs(diff),
                     np.maximum(0, threshold - (np.abs(diff) >> shift)))
    return np.sign(diff) * mag


def _filter_plane(src_pad, dst, blocks, dirs, pri, sec, damping, bd,
                  bw, bh):
    """Filter the listed blocks of one plane.

    src_pad: plane padded by 2 with CDEF_VERY_LARGE; dst: writable
    plane (unpadded); blocks: list of (by, bx) block origins in plane
    pixels; dirs: per-block direction; pri/sec: per-block adjusted
    strengths (arrays); bw/bh: block size (8x8 luma, subsampled
    chroma)."""
    coeff_shift = bd - 8
    for (by, bx), d, pri_s, sec_s in zip(blocks, dirs, pri, sec):
        if pri_s == 0 and sec_s == 0:
            continue
        # (bh, bw) window with 2-px halo in src_pad coords
        win = src_pad[by:by + bh + 4, bx:bx + bw + 4].astype(np.int32)
        x = win[2:2 + bh, 2:2 + bw]
        s = np.zeros((bh, bw), np.int32)
        mx = x.copy()
        mn = x.copy()
        if pri_s:
            pri_taps = (4, 2) if (pri_s >> coeff_shift) & 1 == 0 \
                else (3, 3)
            for k in range(2):
                dy, dx = _DIRECTIONS[d][k]
                for sgn in (1, -1):
                    p = win[2 + sgn * dy:2 + sgn * dy + bh,
                            2 + sgn * dx:2 + sgn * dx + bw]
                    s += pri_taps[k] * _constrain(p - x, pri_s, damping)
                    valid = p != CDEF_VERY_LARGE
                    np.maximum(mx, np.where(valid, p, 0), out=mx)
                    np.minimum(mn, p, out=mn)
        if sec_s:
            sec_taps = (2, 1)
            for k in range(2):
                for d2 in ((d + 2) & 7, (d + 6) & 7):
                    dy, dx = _DIRECTIONS[d2][k]
                    for sgn in (1, -1):
                        p = win[2 + sgn * dy:2 + sgn * dy + bh,
                                2 + sgn * dx:2 + sgn * dx + bw]
                        s += sec_taps[k] * _constrain(p - x, sec_s,
                                                      damping)
                        valid = p != CDEF_VERY_LARGE
                        np.maximum(mx, np.where(valid, p, 0), out=mx)
                        np.minimum(mn, p, out=mn)
        y = x + ((8 + s - (s < 0)) >> 4)
        np.clip(y, mn, mx, out=y)
        dst[by:by + bh, bx:bx + bw] = y


def _adjust_strength(strength: int, var: int) -> int:
    """Luma primary strength variance adaptation (spec 7.15.3)."""
    if var == 0:
        return 0
    i = min(12, (var >> 6).bit_length() - 1) if (var >> 6) else 0
    return (strength * (4 + i) + 8) >> 4


def cdef_frame(fs, planes):
    fh, seq = fs.fh, fs.seq
    if (fh.coded_lossless or fh.allow_intrabc or
            not seq.enable_cdef or fh.cdef_bits == 0 and
            fh.cdef_y_pri_strength[0] == 0 and
            fh.cdef_y_sec_strength[0] == 0 and
            fh.cdef_uv_pri_strength[0] == 0 and
            fh.cdef_uv_sec_strength[0] == 0):
        return planes
    bd = seq.bit_depth
    coeff_shift = bd - 8
    dt = planes[0].dtype
    # skip map at 8x8 granularity: filtered iff any covered mi non-skip
    mr, mc = fs.mi_rows, fs.mi_cols
    sk = fs.skip[:mr, :mc] != 0
    pad_r, pad_c = (-mr) % 2, (-mc) % 2
    if pad_r or pad_c:
        sk = np.pad(sk, ((0, pad_r), (0, pad_c)), mode="edge")
    sk8 = sk.reshape(sk.shape[0] // 2, 2, sk.shape[1] // 2, 2)
    filt8 = ~sk8.all((1, 3))           # (mi_rows/2, mi_cols/2)
    dirs, var = _find_directions(
        np.pad(planes[0].astype(np.int64), ((0, (-planes[0].shape[0]) % 8),
                                            (0, (-planes[0].shape[1]) % 8)),
               mode="edge"), bd)
    out = [p.copy() for p in planes]
    srcs = [np.pad(p.astype(np.int32), 2, mode="constant",
                   constant_values=CDEF_VERY_LARGE) for p in planes]
    n64_r = (mr + 15) >> 4
    n64_c = (mc + 15) >> 4
    h8 = filt8.shape[0]
    w8 = filt8.shape[1]
    for ur in range(n64_r):
        for uc in range(n64_c):
            idx = int(fs.cdef_idx[ur, uc])
            if idx < 0:
                continue
            y_pri = fh.cdef_y_pri_strength[idx] << coeff_shift
            y_sec = fh.cdef_y_sec_strength[idx] << coeff_shift
            uv_pri = fh.cdef_uv_pri_strength[idx] << coeff_shift
            uv_sec = fh.cdef_uv_sec_strength[idx] << coeff_shift
            if not (y_pri or y_sec or uv_pri or uv_sec):
                continue
            r0, r1 = ur * 8, min(ur * 8 + 8, h8)
            c0, c1 = uc * 8, min(uc * 8 + 8, w8)
            blks = [(r, c) for r in range(r0, r1)
                    for c in range(c0, c1) if filt8[r, c]]
            if not blks:
                continue
            # the luma direction drives BOTH planes' primary and
            # secondary taps even when y_pri is 0 (e.g. chroma-only
            # primary strengths — caught by inter-frame conformance)
            bdirs = [int(dirs[r, c]) for r, c in blks]
            bvar = [int(var[r, c]) for r, c in blks]
            # luma — the filter's dir input is zeroed per PLANE when
            # that plane's (adjusted) primary strength is 0, so the
            # secondary taps then use direction 0 (libaom
            # cdef_filter_block call: `t ? dir[bi] : 0`)
            if y_pri or y_sec:
                pri_adj = [_adjust_strength(y_pri, v) for v in bvar]
                ydirs = [d if p else 0
                         for d, p in zip(bdirs, pri_adj)]
                _filter_plane(srcs[0], out[0],
                              [(r * 8, c * 8) for r, c in blks],
                              ydirs, pri_adj, [y_sec] * len(blks),
                              fh.cdef_damping + coeff_shift, bd, 8, 8)
            if len(planes) > 1 and (uv_pri or uv_sec):
                sx, sy = seq.subsampling_x, seq.subsampling_y
                cw, ch = 8 >> sx, 8 >> sy
                if sx != sy:
                    conv = ([7, 0, 2, 4, 5, 6, 6, 6] if sx
                            else [1, 2, 2, 2, 3, 4, 6, 0])
                    cdirs = [conv[d] for d in bdirs]
                else:
                    cdirs = bdirs
                if not uv_pri:
                    cdirs = [0] * len(bdirs)
                cblks = [((r * 8) >> sy, (c * 8) >> sx)
                         for r, c in blks]
                damp_uv = fh.cdef_damping + coeff_shift - 1
                for pl in (1, 2):
                    _filter_plane(srcs[pl], out[pl], cblks, cdirs,
                                  [uv_pri] * len(blks),
                                  [uv_sec] * len(blks),
                                  damp_uv, bd, cw, ch)
    return [p.astype(dt) for p in out]
