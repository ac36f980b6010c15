"""AV1 film grain synthesis (spec 5.9.30 film_grain_params + 7.18.3
grain synthesis/blend) — decode-side post-filter applied to OUTPUT
frames only (reference frames store the pre-grain reconstruction).

The C reference has no AV1 at all; dav1d (which synthesizes grain by
default) is the bit-exact oracle (tests/test_av1_grain.py).  The
blend formulation below mirrors the spec's stripe/block structure:
32-luma-row stripes, per-block 8-bit pseudo-random template offsets,
2px (1px on subsampled axes) overlap blending, piecewise scaling
LUTs, and the chroma index combining cb/cr mult/luma_mult/offset.

Copied from ``ffpic_tpu/coding/av1_grain.py`` for the PyTorch port whole
(the parameters' parse, ``generate_templates``, ``scaling_lut`` and
``apply_grain``), with its import rewritten to the port's
``av1_grain_tables``.  As in the reference, only ``av1_recon.Av1Decoder``
applies grain (to shown and show-existing frames, under the
``av1.grain`` span); ``av1_recon.decode_frame``, the still path, never
does, so a still item that signals grain is returned without it.
"""

from __future__ import annotations

import numpy as np

from ffpic_tpu_torch.coding.av1_grain_tables import GAUSSIAN_SEQUENCE


class GrainParams:
    __slots__ = (
        "apply_grain", "grain_seed", "update_grain", "ref_idx",
        "num_y_points", "point_y_value", "point_y_scaling",
        "chroma_scaling_from_luma",
        "num_cb_points", "point_cb_value", "point_cb_scaling",
        "num_cr_points", "point_cr_value", "point_cr_scaling",
        "grain_scaling", "ar_coeff_lag", "ar_coeffs_y",
        "ar_coeffs_cb", "ar_coeffs_cr", "ar_coeff_shift",
        "grain_scale_shift", "cb_mult", "cb_luma_mult", "cb_offset",
        "cr_mult", "cr_luma_mult", "cr_offset", "overlap_flag",
        "clip_to_restricted_range")

    def __init__(self):
        self.apply_grain = False

    def copy_from(self, o, seed):
        for f in self.__slots__:
            setattr(self, f, getattr(o, f))
        self.grain_seed = seed


def parse_film_grain(r, fh, seq, refs) -> GrainParams:
    """Spec 5.9.30 (called with apply_grain already read as 1)."""
    g = GrainParams()
    g.apply_grain = True
    g.grain_seed = r.read_bits(16)
    g.update_grain = True
    if fh.frame_type == 1:                      # INTER_FRAME
        g.update_grain = bool(r.read_bit())
    if not g.update_grain:
        g.ref_idx = r.read_bits(3)
        # spec: load_grain_params(film_grain_params_ref_idx) — the
        # ref slot INDEX is absolute, not through ref_frame_idx
        ref = refs[g.ref_idx]
        if ref is None or getattr(ref, "grain", None) is None:
            raise ValueError("film grain ref params missing")
        seed = g.grain_seed
        g.copy_from(ref.grain, seed)
        g.apply_grain = True
        g.update_grain = False
        return g
    g.num_y_points = r.read_bits(4)
    g.point_y_value = []
    g.point_y_scaling = []
    for _ in range(g.num_y_points):
        g.point_y_value.append(r.read_bits(8))
        g.point_y_scaling.append(r.read_bits(8))
    if seq.mono_chrome:
        g.chroma_scaling_from_luma = False
    else:
        g.chroma_scaling_from_luma = bool(r.read_bit())
    g.num_cb_points = 0
    g.num_cr_points = 0
    g.point_cb_value = []
    g.point_cb_scaling = []
    g.point_cr_value = []
    g.point_cr_scaling = []
    if not (seq.mono_chrome or g.chroma_scaling_from_luma or
            (seq.subsampling_x == 1 and seq.subsampling_y == 1 and
             g.num_y_points == 0)):
        g.num_cb_points = r.read_bits(4)
        for _ in range(g.num_cb_points):
            g.point_cb_value.append(r.read_bits(8))
            g.point_cb_scaling.append(r.read_bits(8))
        g.num_cr_points = r.read_bits(4)
        for _ in range(g.num_cr_points):
            g.point_cr_value.append(r.read_bits(8))
            g.point_cr_scaling.append(r.read_bits(8))
    g.grain_scaling = r.read_bits(2) + 8
    g.ar_coeff_lag = r.read_bits(2)
    num_pos_luma = 2 * g.ar_coeff_lag * (g.ar_coeff_lag + 1)
    g.ar_coeffs_y = []
    if g.num_y_points:
        num_pos_chroma = num_pos_luma + 1
        for _ in range(num_pos_luma):
            g.ar_coeffs_y.append(r.read_bits(8) - 128)
    else:
        num_pos_chroma = num_pos_luma
    g.ar_coeffs_cb = []
    g.ar_coeffs_cr = []
    if g.chroma_scaling_from_luma or g.num_cb_points:
        for _ in range(num_pos_chroma):
            g.ar_coeffs_cb.append(r.read_bits(8) - 128)
    if g.chroma_scaling_from_luma or g.num_cr_points:
        for _ in range(num_pos_chroma):
            g.ar_coeffs_cr.append(r.read_bits(8) - 128)
    g.ar_coeff_shift = r.read_bits(2) + 6
    g.grain_scale_shift = r.read_bits(2)
    if g.num_cb_points:
        g.cb_mult = r.read_bits(8)
        g.cb_luma_mult = r.read_bits(8)
        g.cb_offset = r.read_bits(9)
    else:
        g.cb_mult = g.cb_luma_mult = 128
        g.cb_offset = 256
    if g.num_cr_points:
        g.cr_mult = r.read_bits(8)
        g.cr_luma_mult = r.read_bits(8)
        g.cr_offset = r.read_bits(9)
    else:
        g.cr_mult = g.cr_luma_mult = 128
        g.cr_offset = 256
    g.overlap_flag = bool(r.read_bit())
    g.clip_to_restricted_range = bool(r.read_bit())
    g.ref_idx = -1
    return g


# ------------------------------------------------------ PRNG (7.18.2)
def _rand(state, bits):
    r = state[0]
    bit = ((r >> 0) ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1
    r = (r >> 1) | (bit << 15)
    state[0] = r
    return (r >> (16 - bits)) & ((1 << bits) - 1)


# --------------------------------------------- grain templates (7.18.3.3)
def _round2(v, n):
    if n == 0:
        return v
    return (v + (1 << (n - 1))) >> n


def _ar_positions(lag):
    pos = []
    for dy in range(-lag, 1):
        for dx in range(-lag, lag + 1):
            if dy == 0 and dx == 0:
                break
            pos.append((dy, dx))
    return pos


def generate_templates(g: GrainParams, bd: int, sub_x: int,
                       sub_y: int, mono: bool):
    """(LumaGrain 73x82, CbGrain, CrGrain) int arrays."""
    shift = 12 - bd + g.grain_scale_shift
    ctr = 128 << (bd - 8)
    gmin, gmax = -ctr, ctr - 1
    state = [g.grain_seed]
    luma = np.zeros((73, 82), np.int32)
    if g.num_y_points > 0:
        for y in range(73):
            for x in range(82):
                luma[y, x] = _round2(
                    int(GAUSSIAN_SEQUENCE[_rand(state, 11)]), shift)
        pos = _ar_positions(g.ar_coeff_lag)
        coeffs = g.ar_coeffs_y
        for y in range(3, 73):
            for x in range(3, 82 - 3):
                s = 0
                for (dy, dx), cf in zip(pos, coeffs):
                    s += cf * int(luma[y + dy, x + dx])
                v = int(luma[y, x]) + _round2(s, g.ar_coeff_shift)
                luma[y, x] = min(gmax, max(gmin, v))
    if mono:
        return luma, None, None
    cw = 44 if sub_x else 82
    ch = 38 if sub_y else 73

    def chroma_tpl(seed_xor, coeffs, have_points):
        state = [g.grain_seed ^ seed_xor]
        t = np.zeros((ch, cw), np.int32)
        if not (have_points or g.chroma_scaling_from_luma):
            return t
        for y in range(ch):
            for x in range(cw):
                t[y, x] = _round2(
                    int(GAUSSIAN_SEQUENCE[_rand(state, 11)]), shift)
        pos = _ar_positions(g.ar_coeff_lag)
        for y in range(3, ch):
            for x in range(3, cw - 3):
                s = 0
                for (dy, dx), cf in zip(pos, coeffs):
                    s += cf * int(t[y + dy, x + dx])
                if g.num_y_points > 0:
                    lx = ((x - 3) << sub_x) + 3
                    ly = ((y - 3) << sub_y) + 3
                    lv = 0
                    for i in range(sub_y + 1):
                        for j in range(sub_x + 1):
                            lv += int(luma[ly + i, lx + j])
                    lv = _round2(lv, sub_x + sub_y)
                    s += coeffs[len(pos)] * lv
                v = int(t[y, x]) + _round2(s, g.ar_coeff_shift)
                t[y, x] = min(gmax, max(gmin, v))
        return t

    cb = chroma_tpl(0xb524, g.ar_coeffs_cb, g.num_cb_points > 0)
    cr = chroma_tpl(0x49d8, g.ar_coeffs_cr, g.num_cr_points > 0)
    return luma, cb, cr


# --------------------------------------------- scaling LUTs (7.18.3.5)
def scaling_lut(values, scalings, bd: int) -> np.ndarray:
    """Piecewise-linear LUT over the full pixel range: 256 8-bit
    anchor entries, interpolated on the (bd-8) low bits at lookup
    time — we pre-expand to a (1<<bd)-entry LUT."""
    lut8 = np.zeros(256, np.int32)
    n = len(values)
    if n == 0:
        pass
    else:
        lut8[:values[0] + 1] = scalings[0]
        for i in range(n - 1):
            dx = values[i + 1] - values[i]
            dy = scalings[i + 1] - scalings[i]
            if dx > 0:
                delta = dy * ((65536 + (dx >> 1)) // dx)
                for j in range(dx):
                    lut8[values[i] + j] = scalings[i] + \
                        ((j * delta + 32768) >> 16)
        lut8[values[-1]:] = scalings[-1]
    if bd == 8:
        return lut8
    shift = bd - 8
    idx = np.arange(1 << bd)
    x = idx >> shift
    rem = idx - (x << shift)
    start = lut8[x]
    end = lut8[np.minimum(x + 1, 255)]
    out = start + ((((end - start) * rem) + (1 << (shift - 1)))
                   >> shift)
    out[x == 255] = lut8[255]
    return out.astype(np.int32)


# ------------------------------------------------------ blend (7.18.3.6)
_W2 = ((27, 17), (17, 27))       # 2px overlap weights
_W1 = ((23, 22),)                # 1px overlap (subsampled axis)


def _sample(tpl, offsets, sx, sy, bx, by, h, w):
    """Block-sized grain patch from a template at the 8-bit random
    offset; bx/by select the previous-block / previous-stripe offset
    for overlap blending."""
    randval = offsets[bx][by]
    offx = 3 + (2 >> sx) * (3 + (randval >> 4))
    offy = 3 + (2 >> sy) * (3 + (randval & 0xF))
    y0 = offy + (32 >> sy) * by
    x0 = offx + (32 >> sx) * bx
    return tpl[y0:y0 + h, x0:x0 + w]


def apply_grain(planes, g: GrainParams, bd: int, sub_x: int,
                sub_y: int):
    """Blend synthesized grain into the output planes (in place on
    copies; returns new plane list)."""
    mono = len(planes) == 1
    luma_t, cb_t, cr_t = generate_templates(g, bd, sub_x, sub_y,
                                            mono)
    ctr = 128 << (bd - 8)
    gmin, gmax = -ctr, ctr - 1
    if g.clip_to_restricted_range:
        vmin, vmax_l = 16 << (bd - 8), 235 << (bd - 8)
        vmax_c = 240 << (bd - 8)
    else:
        vmin, vmax_l, vmax_c = 0, (1 << bd) - 1, (1 << bd) - 1
    ssh = g.grain_scaling                     # scaling_shift
    h, w = planes[0].shape
    out = [p.astype(np.int32).copy() for p in planes]
    src = [p.astype(np.int32) for p in planes]

    luts = [None, None, None]
    if g.num_y_points:
        luts[0] = scaling_lut(g.point_y_value, g.point_y_scaling, bd)
    if not mono:
        if g.chroma_scaling_from_luma:
            luts[1] = luts[2] = scaling_lut(
                g.point_y_value, g.point_y_scaling, bd)
        else:
            if g.num_cb_points:
                luts[1] = scaling_lut(g.point_cb_value,
                                      g.point_cb_scaling, bd)
            if g.num_cr_points:
                luts[2] = scaling_lut(g.point_cr_value,
                                      g.point_cr_scaling, bd)

    n_strips = (h + 31) >> 5
    for row_num in range(n_strips):
        rows = 1 + (1 if (g.overlap_flag and row_num > 0) else 0)
        seeds = []
        for i in range(rows):
            s = g.grain_seed
            s ^= (((row_num - i) * 37 + 178) & 0xFF) << 8
            s ^= ((row_num - i) * 173 + 105) & 0xFF
            seeds.append([s])
        y0l = row_num * 32
        bhl = min(32, h - y0l)
        # luma strip geometry; chroma derives by subsampling
        offsets = [[0] * rows, [0] * rows]    # [bx][i]
        for bx_i, x0l in enumerate(range(0, w, 32)):
            bwl = min(32, w - x0l)
            offsets[1] = list(offsets[0])
            offsets[0] = [_rand(seeds[i], 8) for i in range(rows)]
            xov = (g.overlap_flag and bx_i > 0)
            yov = (g.overlap_flag and row_num > 0)

            def blend_plane(pi, tpl, sx, sy, vmax):
                if tpl is None or luts[pi] is None:
                    return
                bw = (bwl + sx) >> sx if x0l + bwl >= w else \
                    (bwl >> sx)
                bh = (bhl + sy) >> sy if y0l + bhl >= h else \
                    (bhl >> sy)
                x0 = x0l >> sx
                y0 = y0l >> sy
                if bw <= 0 or bh <= 0:
                    return
                grain = _sample(tpl, offsets, sx, sy, 0, 0,
                                bh, bw).astype(np.int64).copy()
                xs = min(2 >> sx, bw) if xov else 0
                ys = min(2 >> sy, bh) if yov else 0
                wx = _W2 if sx == 0 else _W1
                wy = _W2 if sy == 0 else _W1
                if xs:
                    old = _sample(tpl, offsets, sx, sy, 1, 0,
                                  bh, xs)
                    for x in range(xs):
                        m = (old[:, x].astype(np.int64) * wx[x][0] +
                             grain[:, x] * wx[x][1] + 16) >> 5
                        grain[:, x] = np.clip(m, gmin, gmax)
                if ys:
                    top = _sample(tpl, offsets, sx, sy, 0, 1,
                                  ys, bw).astype(np.int64).copy()
                    if xs:
                        oldt = _sample(tpl, offsets, sx, sy, 1, 1,
                                       ys, xs)
                        for x in range(xs):
                            m = (oldt[:, x].astype(np.int64) *
                                 wx[x][0] +
                                 top[:, x] * wx[x][1] + 16) >> 5
                            top[:, x] = np.clip(m, gmin, gmax)
                    for y in range(ys):
                        m = (top[y] * wy[y][0] +
                             grain[y] * wy[y][1] + 16) >> 5
                        grain[y] = np.clip(m, gmin, gmax)
                sp = src[pi][y0:y0 + bh, x0:x0 + bw]
                if pi == 0:
                    idx = np.clip(sp, 0, (1 << bd) - 1)
                else:
                    ly = y0 << sy
                    lrow = src[0][ly:ly + (bh << sy):1 << sy,
                                  x0 << sx:(x0 + bw) << sx]
                    if sx:
                        # spec 7.18.3.6 clamps lumaX+1 to the plane
                        # width: replicate the last column when the
                        # luma slice has an odd column count
                        if lrow.shape[1] & 1:
                            lrow = np.concatenate(
                                [lrow, lrow[:, -1:]], axis=1)
                        avg = (lrow[:, 0::2] +
                               lrow[:, 1::2] + 1) >> 1
                    else:
                        avg = lrow
                    avg = avg[:bh, :bw]
                    if g.chroma_scaling_from_luma:
                        idx = np.clip(avg, 0, (1 << bd) - 1)
                    else:
                        mult = g.cb_mult if pi == 1 else g.cr_mult
                        lmult = g.cb_luma_mult if pi == 1 else \
                            g.cr_luma_mult
                        offs = g.cb_offset if pi == 1 else \
                            g.cr_offset
                        combined = (avg * (lmult - 128) +
                                    sp * (mult - 128))
                        idx = np.clip(
                            (combined >> 6) +
                            ((offs - 256) * (1 << (bd - 8))),
                            0, (1 << bd) - 1)
                noise = (luts[pi][idx].astype(np.int64) * grain +
                         (1 << (ssh - 1))) >> ssh
                out[pi][y0:y0 + bh, x0:x0 + bw] = np.clip(
                    sp + noise, vmin, vmax)

            blend_plane(0, luma_t, 0, 0, vmax_l)
            if not mono:
                blend_plane(1, cb_t, sub_x, sub_y, vmax_c)
                blend_plane(2, cr_t, sub_x, sub_y, vmax_c)
    dt = planes[0].dtype
    return [o.astype(dt) for o in out]
