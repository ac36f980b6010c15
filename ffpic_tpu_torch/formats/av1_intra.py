"""AV1 intra prediction (spec 7.11.2): reference-edge setup with the
spec's padding/limit rules, DC / directional (zones 1-3 with intra
edge filtering + upsampling) / smooth / paeth / filter-intra
predictors, and CfL (7.11.5).

Per-TB entry point is predict(); the recon driver
(ffpic_tpu/formats/av1_recon.py) supplies availability flags derived
from the spec's BlockDecoded superblock bitmaps.  The C reference
(junka/ffpic) has no AV1 decode layer (avif.c:382-405 stub); dav1d is
the conformance oracle.

Copied from ``ffpic_tpu/formats/av1_intra.py`` for the PyTorch port with
its imports rewritten to the port's modules.
"""

from __future__ import annotations

import numpy as np

from ffpic_tpu_torch.coding import av1_consts as C

INTRA_EDGE_KERNEL = [[0, 4, 8, 4, 0], [0, 5, 6, 5, 0], [2, 4, 4, 4, 2]]


def _r2(v: int, n: int) -> int:
    return (v + (1 << (n - 1))) >> n


def _r2s(v: int, n: int) -> int:
    return _r2(v, n) if v >= 0 else -_r2(-v, n)


def _clip1(v: int, bd: int) -> int:
    m = (1 << bd) - 1
    return 0 if v < 0 else (m if v > m else v)


def edge_filter_strength(wh: int, d: int, filter_type: int) -> int:
    d = abs(d)
    strength = 0
    if filter_type == 0:
        if wh <= 8:
            if d >= 56:
                strength = 1
        elif wh <= 12:
            if d >= 40:
                strength = 1
        elif wh <= 16:
            if d >= 40:
                strength = 1
        elif wh <= 24:
            if d >= 8:
                strength = 1
            if d >= 16:
                strength = 2
            if d >= 32:
                strength = 3
        elif wh <= 32:
            strength = 1
            if d >= 4:
                strength = 2
            if d >= 32:
                strength = 3
        else:
            strength = 3
    else:
        if wh <= 8:
            if d >= 40:
                strength = 1
            if d >= 64:
                strength = 2
        elif wh <= 16:
            if d >= 20:
                strength = 1
            if d >= 48:
                strength = 2
        elif wh <= 24:
            if d >= 4:
                strength = 3
        else:
            strength = 3
    return strength


def _use_upsample(wh: int, d: int, filter_type: int) -> bool:
    d = abs(d)
    if d <= 0 or d >= 40:
        return False
    return wh <= 8 if filter_type else wh <= 16


class _Edge:
    """Edge sample array indexed from -2 (post-upsample origin)."""

    __slots__ = ("buf", "off", "upsampled")

    def __init__(self, n: int):
        # 2x headroom: upsampling doubles the occupied extent
        self.buf = [0] * (2 * n + 4)
        self.off = 2
        self.upsampled = False

    def __getitem__(self, i: int) -> int:
        return self.buf[self.off + i]

    def __setitem__(self, i: int, v: int):
        self.buf[self.off + i] = v

    def filter(self, num_px: int, strength: int):
        """Spec 7.11.2.9: smooth samples [-1 .. num_px-2] in place,
        sample -1 (index 0 of the window) unchanged."""
        if not strength:
            return
        k = INTRA_EDGE_KERNEL[strength - 1]
        orig = [self[-1 + i] for i in range(num_px)]
        for i in range(1, num_px):
            s = 0
            for j in range(5):
                idx = min(max(i - 2 + j, 0), num_px - 1)
                s += orig[idx] * k[j]
            self[-1 + i] = (s + 8) >> 4

    def upsample(self, num_px: int, bd: int):
        """Spec 7.11.2.10 / libaom av1_upsample_intra_edge_c: 2x
        upsample samples [0..num_px-1]; output occupies
        [-2 .. 2*num_px-2] with old[i] at new[2*i] and the corner at
        new[-2] (corner sample duplicated at the head of the 4-tap
        window)."""
        dup = [self[-1], self[-1]] + [self[i] for i in range(num_px)]
        dup.append(dup[-1])
        out = [0] * (2 * num_px + 1)
        out[0] = dup[0]  # new[-2] = old[-1]
        for i in range(num_px):
            s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3]
            out[2 * i + 1] = _clip1(_r2(s, 4), bd)   # new[2*i-1]
            out[2 * i + 2] = dup[i + 2]              # new[2*i] = old[i]
        for i, v in enumerate(out):
            self.buf[self.off - 2 + i] = v
        self.upsampled = True


def prepare_edges(plane: np.ndarray, x: int, y: int, w: int, h: int,
                  have_left: bool, have_above: bool,
                  have_above_right: bool, have_below_left: bool,
                  max_x: int, max_y: int, bd: int):
    """Spec 7.11.2 steps 2-8: build AboveRow/LeftCol[-1..w+h-1]."""
    n = w + h
    above = _Edge(n + 1)
    left = _Edge(n + 1)
    base = 1 << (bd - 1)
    if not have_above and have_left:
        v = int(plane[y, x - 1])
        for i in range(-1, n):
            above[i] = v
    elif not have_above:
        for i in range(-1, n):
            above[i] = base - 1
    else:
        limit = min(max_x, x + (2 * w if have_above_right else w) - 1)
        row = plane[y - 1]
        for i in range(n):
            above[i] = int(row[min(limit, x + i)])
    if not have_left and have_above:
        v = int(plane[y - 1, x])
        for i in range(-1, n):
            left[i] = v
    elif not have_left:
        for i in range(-1, n):
            left[i] = base + 1
    else:
        limit = min(max_y, y + (2 * h if have_below_left else h) - 1)
        for i in range(n):
            left[i] = int(plane[min(limit, y + i), x - 1])
    if have_above and have_left:
        corner = int(plane[y - 1, x - 1])
    elif have_above:
        corner = int(plane[y - 1, x])
    elif have_left:
        corner = int(plane[y, x - 1])
    else:
        corner = base
    above[-1] = corner
    left[-1] = corner
    return above, left


def predict(plane: np.ndarray, x: int, y: int, w: int, h: int,
            mode: int, angle_delta: int, filter_intra_mode: int,
            have_left: bool, have_above: bool, have_above_right: bool,
            have_below_left: bool, max_x: int, max_y: int, bd: int,
            enable_edge_filter: bool, filter_type: int) -> np.ndarray:
    """Returns the (h, w) int32 prediction for one transform block."""
    above, left = prepare_edges(
        plane, x, y, w, h, have_left, have_above, have_above_right,
        have_below_left, max_x, max_y, bd)
    if filter_intra_mode >= 0:
        return _filter_intra(above, left, w, h, filter_intra_mode, bd)
    if mode == C.DC_PRED:
        return _dc(above, left, w, h, have_left, have_above, bd)
    if mode in C.MODE_TO_ANGLE:
        p_angle = C.MODE_TO_ANGLE[mode] + angle_delta * C.ANGLE_STEP
        return _directional(above, left, w, h, p_angle,
                            have_left, have_above, max_x, max_y,
                            x, y, bd, enable_edge_filter, filter_type)
    if mode == C.SMOOTH_PRED:
        return _smooth(above, left, w, h)
    if mode == C.SMOOTH_V_PRED:
        return _smooth_v(above, left, w, h)
    if mode == C.SMOOTH_H_PRED:
        return _smooth_h(above, left, w, h)
    if mode == C.PAETH_PRED:
        return _paeth(above, left, w, h)
    raise ValueError(f"mode {mode}")


# ------------------------------------------------------------------ DC
def _dc(above, left, w, h, have_left, have_above, bd):
    if have_above and have_left:
        s = sum(above[i] for i in range(w)) + \
            sum(left[i] for i in range(h))
        avg = (s + ((w + h) >> 1)) // (w + h)
    elif have_above:
        s = sum(above[i] for i in range(w))
        avg = _r2(s, w.bit_length() - 1)
    elif have_left:
        s = sum(left[i] for i in range(h))
        avg = _r2(s, h.bit_length() - 1)
    else:
        avg = 1 << (bd - 1)
    return np.full((h, w), avg, np.int32)


# ---------------------------------------------------------- directional
def _directional(above, left, w, h, p_angle, have_left, have_above,
                 max_x, max_y, x, y, bd, enable_edge_filter,
                 filter_type):
    upsample_above = upsample_left = 0
    if enable_edge_filter:
        if p_angle != 90 and p_angle != 180:
            if 90 < p_angle < 180 and (w + h) >= 24:
                # corner filter (spec filter_corner)
                s = left[0] * 5 + above[-1] * 6 + above[0] * 5
                v = _r2(s, 4)
                above[-1] = v
                left[-1] = v
            if have_above:
                strength = edge_filter_strength(
                    w + h, p_angle - 90, filter_type)
                num_px = min(w, max_x - x + 1) + \
                    (h if p_angle < 90 else 0) + 1
                above.filter(num_px, strength)
            if have_left:
                strength = edge_filter_strength(
                    w + h, p_angle - 180, filter_type)
                num_px = min(h, max_y - y + 1) + \
                    (w if p_angle > 180 else 0) + 1
                left.filter(num_px, strength)
        upsample_above = int(_use_upsample(
            w + h, p_angle - 90, filter_type))
        upsample_left = int(_use_upsample(
            w + h, p_angle - 180, filter_type))
        if upsample_above:
            num_px = w + (h if p_angle < 90 else 0)
            above.upsample(num_px, bd)
        if upsample_left:
            num_px = h + (w if p_angle > 180 else 0)
            left.upsample(num_px, bd)

    out = np.zeros((h, w), np.int32)
    if p_angle == 90:
        for j in range(w):
            out[:, j] = above[j]
        return out
    if p_angle == 180:
        for i in range(h):
            out[i, :] = left[i]
        return out
    D = C.DR_INTRA_DERIVATIVE
    if p_angle < 90:
        dx = D[p_angle]
        max_base = (w + h - 1) << upsample_above
        for i in range(h):
            idx = (i + 1) * dx
            for j in range(w):
                b = (idx >> (6 - upsample_above)) + \
                    (j << upsample_above)
                if b < max_base:
                    shift = ((idx << upsample_above) >> 1) & 0x1F
                    out[i, j] = _r2(above[b] * (32 - shift) +
                                    above[b + 1] * shift, 5)
                else:
                    out[i, j] = above[max_base]
    elif p_angle < 180:
        dx = D[180 - p_angle]
        dy = D[p_angle - 90]
        for i in range(h):
            for j in range(w):
                idx = (j << 6) - (i + 1) * dx
                b = idx >> (6 - upsample_above)
                if b >= -(1 << upsample_above):
                    shift = ((idx << upsample_above) >> 1) & 0x1F
                    out[i, j] = _r2(above[b] * (32 - shift) +
                                    above[b + 1] * shift, 5)
                else:
                    idx2 = (i << 6) - (j + 1) * dy
                    b2 = idx2 >> (6 - upsample_left)
                    shift = ((idx2 << upsample_left) >> 1) & 0x1F
                    out[i, j] = _r2(left[b2] * (32 - shift) +
                                    left[b2 + 1] * shift, 5)
    else:
        dy = D[270 - p_angle]
        max_base = (w + h - 1) << upsample_left
        for i in range(h):
            for j in range(w):
                idx = (j + 1) * dy
                b = (idx >> (6 - upsample_left)) + \
                    (i << upsample_left)
                if b < max_base:
                    shift = ((idx << upsample_left) >> 1) & 0x1F
                    out[i, j] = _r2(left[b] * (32 - shift) +
                                    left[b + 1] * shift, 5)
                else:
                    out[i, j] = left[max_base]
    return out


# -------------------------------------------------------------- smooth
def _smooth(above, left, w, h):
    wv = C.SM_WEIGHTS[h]
    ww = C.SM_WEIGHTS[w]
    br = left[h - 1]
    ar = above[w - 1]
    out = np.zeros((h, w), np.int32)
    for i in range(h):
        for j in range(w):
            s = wv[i] * above[j] + (256 - wv[i]) * br + \
                ww[j] * left[i] + (256 - ww[j]) * ar
            out[i, j] = _r2(s, 9)
    return out


def _smooth_v(above, left, w, h):
    wv = C.SM_WEIGHTS[h]
    br = left[h - 1]
    out = np.zeros((h, w), np.int32)
    for i in range(h):
        for j in range(w):
            out[i, j] = _r2(wv[i] * above[j] + (256 - wv[i]) * br, 8)
    return out


def _smooth_h(above, left, w, h):
    ww = C.SM_WEIGHTS[w]
    ar = above[w - 1]
    out = np.zeros((h, w), np.int32)
    for i in range(h):
        for j in range(w):
            out[i, j] = _r2(ww[j] * left[i] + (256 - ww[j]) * ar, 8)
    return out


def _paeth(above, left, w, h):
    tl = above[-1]
    out = np.zeros((h, w), np.int32)
    for i in range(h):
        l = left[i]
        for j in range(w):
            a = above[j]
            base = a + l - tl
            pa = abs(base - a)
            pl = abs(base - l)
            pt = abs(base - tl)
            if pa <= pl and pa <= pt:
                out[i, j] = a
            elif pl <= pt:
                out[i, j] = l
            else:
                out[i, j] = tl
    return out


# --------------------------------------------------------- filter intra
def _filter_intra(above, left, w, h, fmode, bd):
    taps = C.INTRA_FILTER_TAPS[fmode]
    # working buffer with edge row/col at index 0
    buf = np.zeros((h + 1, w + 1), np.int32)
    buf[0, 0] = above[-1]
    for j in range(w):
        buf[0, j + 1] = above[j]
    for i in range(h):
        buf[i + 1, 0] = left[i]
    for r in range(1, h + 1, 2):
        for c in range(1, w + 1, 4):
            p = [int(buf[r - 1, c - 1]),
                 int(buf[r - 1, c]), int(buf[r - 1, c + 1]),
                 int(buf[r - 1, c + 2]), int(buf[r - 1, c + 3]),
                 int(buf[r, c - 1]), int(buf[r + 1, c - 1])]
            for k in range(8):
                ro, co = k >> 2, k & 3
                s = sum(taps[k][t] * p[t] for t in range(7))
                buf[r + ro, c + co] = _clip1(_r2s(s, 4), bd)
    return buf[1:, 1:].copy()


# ------------------------------------------------------------------ CfL
def cfl_predict(dc_pred: np.ndarray, luma: np.ndarray, x: int, y: int,
                w: int, h: int, alpha: int, sub_x: int, sub_y: int,
                max_luma_w: int, max_luma_h: int, bd: int) -> np.ndarray:
    """Spec 7.11.5: dc_pred + alpha-scaled subsampled-luma AC."""
    lx0 = x << sub_x
    ly0 = y << sub_y
    L = np.zeros((h, w), np.int64)
    for i in range(h):
        ly = min(ly0 + (i << sub_y), max_luma_h - (1 << sub_y))
        for j in range(w):
            lx = min(lx0 + (j << sub_x), max_luma_w - (1 << sub_x))
            if sub_x and sub_y:
                t = (int(luma[ly, lx]) + int(luma[ly, lx + 1]) +
                     int(luma[ly + 1, lx]) + int(luma[ly + 1, lx + 1]))
                t <<= 1
            elif sub_x:
                t = (int(luma[ly, lx]) + int(luma[ly, lx + 1])) << 2
            else:
                t = int(luma[ly, lx]) << 3
            L[i, j] = t
    log2sz = (w.bit_length() - 1) + (h.bit_length() - 1)
    avg = (int(L.sum()) + (1 << (log2sz - 1))) >> log2sz
    out = np.zeros((h, w), np.int32)
    for i in range(h):
        for j in range(w):
            ac = int(L[i, j]) - avg
            out[i, j] = _clip1(int(dc_pred[i, j]) +
                               _r2s(alpha * ac, 6), bd)
    return out
