"""AV1 intrabc displacement-vector machinery (spec 5.11.21
read_intrabc_info, 5.11.31/32 mv syntax, 7.10.2 find_mv_stack
restricted to the INTRA_FRAME ref).

Still-picture scope: key frames only ever carry intrabc MVs (DVs), so
the stack scan is the spec's adjacent row/col pass over intrabc
neighbors — the temporal and extended-range scans are gated off for
INTRA_FRAME by construction (no reference frames exist).  The decoded
DV is always whole-pel (force_integer_mv is implied by intrabc).

The C reference has no AV1 layer (format/avif.c:382-405 stub); dav1d
is the conformance oracle (tests/test_av1.py intrabc suite).

Copied from ``ffpic_tpu/coding/av1_mv.py`` for the PyTorch port whole,
with its imports rewritten to the port's modules (intra block copy
vectors, and the ``MvCdfs`` that ``CdfContext`` builds).
"""
from __future__ import annotations

MV_BORDER = 128          # 16 px in 1/8 units
MV_INTRABC_CONTEXT = 1


def _clip3(lo, hi, v):
    return lo if v < lo else (hi if v > hi else v)


class DvCdfs:
    """Per-tile intrabc MV ("dmv") adaptive CDF set: joint + two
    independent per-component copies of the nmv component families
    (the defaults are identical per component; adaptation is not)."""

    def __init__(self, tables):
        def row(name, idx=0):
            return list(tables[name][idx])

        self.joint = row("mv_joint")
        self.sign = [row("mv_sign") for _ in range(2)]
        self.classes = [row("mv_classes") for _ in range(2)]
        self.class0_bit = [row("mv_class0_bit") for _ in range(2)]
        self.bits = [[row("mv_bits", i) for i in range(10)]
                     for _ in range(2)]


def read_mv_component(m, dv, comp):
    """read_mv_component (5.11.32) with force_integer_mv (fr = 3,
    hp = 1 — no fractional symbols exist for intrabc)."""
    sign = m.decode_symbol(dv.sign[comp])
    cls = m.decode_symbol(dv.classes[comp])
    if cls == 0:
        d = m.decode_symbol(dv.class0_bit[comp])
        mag = ((d << 3) | (3 << 1) | 1) + 1
    else:
        d = 0
        for i in range(cls):
            d |= m.decode_symbol(dv.bits[comp][i]) << i
        mag = 2 << (cls + 2)
        mag += ((d << 3) | (3 << 1) | 1) + 1
    return -mag if sign else mag


def read_dv(m, dv, pred):
    """assign_mv/read_mv for an intrabc block: joint + components,
    added to the predicted DV (which the caller derived via
    find_dv_pred)."""
    joint = m.decode_symbol(dv.joint)
    diff_row = read_mv_component(m, dv, 0) if joint in (2, 3) else 0
    diff_col = read_mv_component(m, dv, 1) if joint in (1, 3) else 0
    return pred[0] + diff_row, pred[1] + diff_col


def _scan_candidates(fs, td, r, c, bw4, bh4):
    """Adjacent row/col scans (7.10.2.2/3 scan_row_mbmi /
    scan_col_mbmi) collecting intrabc neighbor DVs into a weighted,
    deduplicated stack."""
    stack = []       # [mv(tuple), weight]

    def add(mr, mc_, weight):
        if not fs.is_ibc[mr, mc_]:
            return
        cand = (int(fs.mvs[mr, mc_, 0]), int(fs.mvs[mr, mc_, 1]))
        for ent in stack:
            if ent[0] == cand:
                ent[1] += weight
                return
        if len(stack) < 8:
            stack.append([cand, weight])

    from ffpic_tpu_torch.coding import av1_consts as C
    mi_cols = fs.mi_cols
    bw4_tbl = C.BLOCK_W4
    bh4_tbl = C.BLOCK_H4
    if r > td.r0:                           # scan_row_mbmi(-1)
        end4 = min(min(bw4, mi_cols - c), 16)
        use_step16 = bw4 >= 16
        i = 0
        while i < end4:
            mv_r, mv_c = r - 1, c + i
            if not (td.c0 <= mv_c < td.c1):
                break
            ln = min(bw4, int(bw4_tbl[fs.bsize[mv_r, mv_c]]))
            if use_step16:
                ln = max(4, ln)
            add(mv_r, mv_c, ln * 2)
            i += ln
    if c > td.c0:                           # scan_col_mbmi(-1)
        end4 = min(min(bh4, fs.mi_rows - r), 16)
        use_step16 = bh4 >= 16
        i = 0
        while i < end4:
            mv_r, mv_c = r + i, c - 1
            if not (td.r0 <= mv_r < td.r1):
                break
            ln = min(bh4, int(bh4_tbl[fs.bsize[mv_r, mv_c]]))
            if use_step16:
                ln = max(4, ln)
            add(mv_r, mv_c, ln * 2)
            i += ln
    # top-right point (scan_point_mbmi) for small blocks
    if max(bw4, bh4) <= 16 and r > td.r0:
        mv_r, mv_c = r - 1, c + bw4
        if td.c0 <= mv_c < min(td.c1, mi_cols) and mv_r >= td.r0:
            add(mv_r, mv_c, 4)
    stack.sort(key=lambda e: -e[1])
    return stack


def find_dv_pred(fs, td, b, sb4):
    """Predicted DV (read_mv intrabc branch): first nonzero of the
    top-2 stack entries, else the spec default — one superblock left
    (plus the 256-px wavefront delay when still in the first SB row
    of the tile), integer-clamped to the frame-relative MV range."""
    r, c = b.mi_row, b.mi_col
    from ffpic_tpu_torch.coding import av1_consts as C
    bw4 = C.BLOCK_W4[b.bsize]
    bh4 = C.BLOCK_H4[b.bsize]
    stack = _scan_candidates(fs, td, r, c, bw4, bh4)
    pred = (0, 0)
    for ent in stack[:2]:
        if ent[0] != (0, 0):
            pred = ent[0]
            break
    if pred == (0, 0):
        sb_size_px = sb4 * 4
        sb_row = (r - td.r0) >> (sb4.bit_length() - 1)
        if sb_row == 0:
            # first SB row of the tile: point one SB plus the
            # 256-px parallel-decode delay to the LEFT
            pred = (0, -((sb_size_px + 256) * 8))
        else:
            pred = (-(sb_size_px * 8), 0)
        return pred
    # clamp + force integer (lower_mv_precision Round2Signed(v,3)*8,
    # then the 7.10.2 frame-relative clamp)
    def r2s8(v):
        return ((abs(v) + 4) >> 3) * (8 if v >= 0 else -8)
    row, col = r2s8(pred[0]), r2s8(pred[1])
    border_r = MV_BORDER + bh4 * 4 * 8
    border_c = MV_BORDER + bw4 * 4 * 8
    mb_top = -(r * 32)
    mb_bottom = (fs.mi_rows - bh4 - r) * 32
    mb_left = -(c * 32)
    mb_right = (fs.mi_cols - bw4 - c) * 32
    row = _clip3(mb_top - border_r, mb_bottom + border_r, row)
    col = _clip3(mb_left - border_c, mb_right + border_c, col)
    return row, col


# ===================================================================
# Full NMV context for inter frames (spec 5.11.31/32 with the
# fractional + high-precision symbol families that intrabc's DV
# variant hardwires away).  Lives inside CdfContext (av1_msac) so the
# adapted state participates in frame-end CDF save / primary-ref
# load across frames.
class MvCdfs:
    """One NMV context: joint + two per-component family sets."""

    __slots__ = ("joint", "sign", "classes", "class0_bit", "bits",
                 "class0_fp", "fp", "class0_hp", "hp")

    def __init__(self, tables):
        def row(name, idx=None):
            src = tables[name][idx] if idx is not None \
                else tables[name][0]
            return list(src)

        self.joint = row("mv_joint")
        self.sign = [row("mv_sign") for _ in range(2)]
        self.classes = [row("mv_classes") for _ in range(2)]
        self.class0_bit = [row("mv_class0_bit") for _ in range(2)]
        self.bits = [[row("mv_bits", i) for i in range(10)]
                     for _ in range(2)]
        self.class0_fp = [[row("mv_class0_fp", i) for i in range(2)]
                          for _ in range(2)]
        self.fp = [row("mv_fp") for _ in range(2)]
        self.class0_hp = [row("mv_class0_hp") for _ in range(2)]
        self.hp = [row("mv_hp") for _ in range(2)]

    def clone(self):
        c = MvCdfs.__new__(MvCdfs)
        c.joint = list(self.joint)
        c.sign = [list(x) for x in self.sign]
        c.classes = [list(x) for x in self.classes]
        c.class0_bit = [list(x) for x in self.class0_bit]
        c.bits = [[list(x) for x in comp] for comp in self.bits]
        c.class0_fp = [[list(x) for x in comp]
                       for comp in self.class0_fp]
        c.fp = [list(x) for x in self.fp]
        c.class0_hp = [list(x) for x in self.class0_hp]
        c.hp = [list(x) for x in self.hp]
        return c

    def reset_counters(self):
        self.joint[-1] = 0
        for comp in range(2):
            self.sign[comp][-1] = 0
            self.classes[comp][-1] = 0
            self.class0_bit[comp][-1] = 0
            for rw in self.bits[comp]:
                rw[-1] = 0
            for rw in self.class0_fp[comp]:
                rw[-1] = 0
            self.fp[comp][-1] = 0
            self.class0_hp[comp][-1] = 0
            self.hp[comp][-1] = 0


def read_mv_component_full(m, mv, comp, force_integer: bool,
                           allow_hp: bool) -> int:
    """read_mv_component (5.11.32), full precision ladder."""
    sign = m.decode_symbol(mv.sign[comp])
    cls = m.decode_symbol(mv.classes[comp])
    if cls == 0:
        int_bit = m.decode_symbol(mv.class0_bit[comp])
        fr = 3 if force_integer else \
            m.decode_symbol(mv.class0_fp[comp][int_bit])
        hp = m.decode_symbol(mv.class0_hp[comp]) if allow_hp else 1
        mag = ((int_bit << 3) | (fr << 1) | hp) + 1
    else:
        d = 0
        for i in range(cls):
            d |= m.decode_symbol(mv.bits[comp][i]) << i
        fr = 3 if force_integer else m.decode_symbol(mv.fp[comp])
        hp = m.decode_symbol(mv.hp[comp]) if allow_hp else 1
        mag = 2 << (cls + 2)
        mag += ((d << 3) | (fr << 1) | hp) + 1
    return -mag if sign else mag


def read_mv_full(m, mv, pred, force_integer: bool, allow_hp: bool):
    """read_mv (5.11.31) for one ref of an inter block."""
    joint = m.decode_symbol(mv.joint)
    dr = read_mv_component_full(m, mv, 0, force_integer, allow_hp) \
        if joint in (2, 3) else 0
    dc = read_mv_component_full(m, mv, 1, force_integer, allow_hp) \
        if joint in (1, 3) else 0
    return [pred[0] + dr, pred[1] + dc]
