"""HEVC slice segment decoding (ITU-T H.265 7.3.6 + 7.3.8 + 9.3):
slice header, CTU loop, coding quadtree, intra CUs, transform tree and
residual coding — the host CABAC pass of the TPU-native HEIF pipeline.

Two-pass architecture (SURVEY.md §3.5 split point): this module is
pass 1 — pure syntax, no pixels.  It emits an ordered op list
(prediction blocks + TU residual references) that
formats/hevc_recon.py executes; residual transforms have no feedback
dependency so they batch per TU-size bucket (device-offloadable),
while prediction runs as a host wavefront.

Scope: Main / Main10 / Main Still Picture intra decoding — 8/10-bit
4:2:0/4:0:0, all CTB/TB sizes, NxN partitions, transform skip,
transquant bypass, sign data hiding, cu_qp_delta, SAO parsing, IPCM,
scaling lists, tiles, WPP entry points, multi-slice pictures and
dependent slice segments (availability zones + context carry).

Reference parity anchors: slice header hevc.c:2660, CTU loop
hevc.c:6934-7047, quadtree hevc.c:6852, CU hevc.c:6467, transform tree
hevc.c:6177, residual coding hevc.c:5636, scans hevc.c:2580-2658.

Copied from ``ffpic_tpu/coding/hevc_slice.py`` for the PyTorch port,
with its imports rewritten to the port's modules.  A ``SliceDecoder``
given inter state derives each PU's motion inline
(``coding.hevc_inter.MotionDeriver``); P/B slices without it run the
original's parse-and-skip and raise ``InterSliceUnsupported``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ffpic_tpu_torch.coding.cabac import CabacDecoder, ContextModel
from ffpic_tpu_torch.coding.cabac_tables import INIT_VALUES
from ffpic_tpu_torch.coding.golomb import read_ue, read_se
from ffpic_tpu_torch.coding.hevc_consts import (SIG_CTX_4X4, chroma_qp,
                                                scan_order)
from ffpic_tpu_torch.utils.bitstream import BitReader

INTRA_PLANAR, INTRA_DC = 0, 1


# ---------------------------------------------------------------------------
# contexts
# ---------------------------------------------------------------------------

# (name, count) in our own layout; initValues come straight from the
# machine-extracted spec tables keyed by syntax-element name.
_CTX_SET = (
    ("sao_merge", 1), ("sao_type_idx", 1), ("split_cu_flag", 3),
    ("cu_transquant_bypass_flag", 1), ("part_mode", 1),
    ("prev_intra_luma_pred_flag", 1), ("intra_chroma_pred_mode", 1),
    ("split_transform_flag", 3), ("cbf_luma", 2), ("cbf_cb_cr", 5),
    ("transform_skip_flag", 2), ("last_sig_coeff_x_prefix", 18),
    ("last_sig_coeff_y_prefix", 18), ("coded_sub_block_flag", 4),
    ("sig_coeff_flag", 44), ("coeff_abs_level_greater1_flag", 24),
    ("coeff_abs_level_greater2_flag", 6), ("cu_qp_delta_abs", 2),
)

# inter-only elements (P/B slices; INIT_VALUES rows are [initType1,
# initType2] for these, [0,1,2] for the shared set above)
_CTX_SET_INTER = (
    ("cu_skip_flag", 3), ("pred_mode_flag", 1), ("merge_flag", 1),
    ("merge_index", 1), ("inter_pred_idc", 5), ("ref_idx", 2),
    ("mvp_flag", 1), ("abs_mvd_greater0_flag", 1),
    ("abs_mvd_greater1_flag", 1), ("rqt_root_cbf", 1),
)


class InterSliceUnsupported(NotImplementedError):
    """A P/B slice was encountered: header parsed to slice_type, no
    pixel decode (the C reference also produces no inter pixels —
    hevc.c:6285-6397 parses PU/MVD then discards)."""


class Contexts:
    """All context models for one slice (initType 0 = I, 1/2 = P/B
    per the cabac_init_flag swap, 9.3.2.2)."""

    def __init__(self, qp: int, init_type: int = 0):
        self.m = {}
        for name, count in _CTX_SET:
            table = INIT_VALUES[name]
            ivs = table[init_type]
            if not isinstance(ivs, list):
                ivs = [ivs]
            if isinstance(ivs[0], list):     # nested one deeper
                ivs = ivs[0]
            if name == "sig_coeff_flag":
                ivs = (INIT_VALUES["sig_coeff_flag"][init_type]
                       + INIT_VALUES["sig_coeff_flag1"][init_type])
            if name == "part_mode":
                # flat [intra(1) | type1(4) | type2(4)] layout
                flat = INIT_VALUES["part_mode"]
                if init_type == 0:
                    ivs = [flat[0]]
                else:
                    ivs = flat[1 + (init_type - 1) * 4:
                               1 + init_type * 4]
                count = len(ivs)
            assert len(ivs) >= count, (name, len(ivs), count)
            self.m[name] = [ContextModel(iv, qp) for iv in ivs[:count]]
        if init_type:
            for name, count in _CTX_SET_INTER:
                tbl = INIT_VALUES[name]
                ivs = tbl[init_type - 1]
                if not isinstance(ivs, list):
                    ivs = [ivs]
                assert len(ivs) >= count, (name, len(ivs), count)
                self.m[name] = [ContextModel(iv, qp)
                                for iv in ivs[:count]]

    def __getitem__(self, key):
        name, idx = key
        return self.m[name][idx]


# ---------------------------------------------------------------------------
# slice header (7.3.6.1, I slices)
# ---------------------------------------------------------------------------

@dataclass
class SliceHeader:
    first_slice: bool = True
    pps_id: int = 0
    segment_address: int = 0
    slice_type: int = 2
    sao_luma: bool = False
    sao_chroma: bool = False
    qp: int = 26
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    deblocking_disabled: bool = False
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    entry_points: tuple = ()
    data_bit_offset: int = 0
    dependent: bool = False
    # inter (P=1 / B=0) slice fields
    num_ref_l0: int = 1
    num_ref_l1: int = 1
    max_merge: int = 5
    lf_across_slices: bool = True
    cabac_init_flag: bool = False
    temporal_mvp: bool = False
    mvd_l1_zero: bool = False
    # retained reference machinery for full inter decode (8.3)
    poc_lsb: int = 0
    rps: tuple = ((), ())          # (s0, s1) per 7.4.8
    has_lt: bool = False
    list_mod: tuple = (None, None)  # per-list list_entry_lX or None
    col_from_l0: bool = True
    col_ref_idx: int = 0
    # pred_weight_table: (luma_log2_denom, chroma_log2_denom,
    #   entries[2][ref] = (wY, oY, wCb, oCb, wCr, oCr))
    wp: tuple | None = None


def parse_slice_header(r: BitReader, nal_unit_type: int, sps,
                       pps, prev: "SliceHeader | None" = None
                       ) -> SliceHeader:
    """7.3.6.1.  For a dependent slice segment (7.3.6.1: everything
    between slice_segment_address and the entry points is absent),
    the non-present fields are inherited from `prev`, the preceding
    independent segment's header."""
    h = SliceHeader()
    h.first_slice = bool(r.read_bit())
    if 16 <= nal_unit_type <= 23:
        r.read_bit()                     # no_output_of_prior_pics
    h.pps_id = read_ue(r)
    if not h.first_slice:
        if pps.dependent_slice_segments:
            h.dependent = bool(r.read_bit())
        ctbs = (((sps.width + (1 << sps.ctb_log2) - 1) >> sps.ctb_log2) *
                ((sps.height + (1 << sps.ctb_log2) - 1) >> sps.ctb_log2))
        h.segment_address = r.read_bits(max(1, (ctbs - 1).bit_length()))
    if h.dependent:
        if prev is None:
            raise ValueError("dependent slice segment without a "
                             "preceding independent segment")
        for f in ("slice_type", "sao_luma", "sao_chroma", "qp",
                  "cb_qp_offset", "cr_qp_offset", "deblocking_disabled",
                  "beta_offset_div2", "tc_offset_div2",
                  "lf_across_slices"):
            setattr(h, f, getattr(prev, f))
        _parse_slice_header_tail(r, h, sps, pps)
        return h
    for _ in range(pps.num_extra_slice_header_bits):
        r.read_bit()
    h.slice_type = read_ue(r)
    if h.slice_type > 2:
        raise ValueError("invalid slice_type")
    if pps.output_flag_present:
        r.read_bit()
    num_pics_total_curr = 0
    if nal_unit_type not in (19, 20):
        # non-IDR: poc lsb + reference picture set signalling
        # (7.3.6.1), fully retained for the 8.3 decode processes
        h.poc_lsb = r.read_bits(sps.log2_max_pic_order_cnt)
        if not r.read_bit():                       # st_rps_sps_flag
            from ffpic_tpu_torch.formats.hevc import parse_st_rps
            nsets = getattr(sps, "num_short_term_rps", 0)
            h.rps = parse_st_rps(r, list(getattr(sps, "st_rps", ())),
                                 nsets, slice_level=True)
        else:
            idx = 0
            if getattr(sps, "num_short_term_rps", 0) > 1:
                idx = r.read_bits(
                    (sps.num_short_term_rps - 1).bit_length())
            sets = getattr(sps, "st_rps", ())
            if idx < len(sets):
                h.rps = sets[idx]
        num_pics_total_curr += sum(u for _, u in h.rps[0])
        num_pics_total_curr += sum(u for _, u in h.rps[1])
        if getattr(sps, "long_term_ref_pics", False):
            num_lt_sps = 0
            if getattr(sps, "num_long_term_sps", 0) > 0:
                num_lt_sps = read_ue(r)
            num_lt_pics = read_ue(r)
            h.has_lt = (num_lt_sps + num_lt_pics) > 0
            for i in range(num_lt_sps + num_lt_pics):
                if i < num_lt_sps:
                    if sps.num_long_term_sps > 1:
                        r.read_bits((sps.num_long_term_sps - 1)
                                    .bit_length())
                else:
                    r.read_bits(sps.log2_max_pic_order_cnt)
                    num_pics_total_curr += r.read_bit()  # used_by_curr
                if r.read_bit():                   # delta_poc_msb
                    read_ue(r)
        if getattr(sps, "temporal_mvp", False):
            h.temporal_mvp = bool(r.read_bit())
    if sps.sample_adaptive_offset:
        h.sao_luma = bool(r.read_bit())
        h.sao_chroma = bool(r.read_bit())
    if h.slice_type != 2:
        # ---- P/B reference machinery (7.3.6.1)
        h.num_ref_l0 = pps.num_ref_idx_l0_default
        h.num_ref_l1 = pps.num_ref_idx_l1_default
        if r.read_bit():          # num_ref_idx_active_override
            h.num_ref_l0 = read_ue(r) + 1
            if h.slice_type == 0:                  # B
                h.num_ref_l1 = read_ue(r) + 1
        if getattr(pps, "lists_modification", False) \
                and num_pics_total_curr > 1:
            nb = (num_pics_total_curr - 1).bit_length()
            mods = [None, None]
            if r.read_bit():      # ref_pic_list_modification_flag_l0
                mods[0] = tuple(r.read_bits(nb)
                                for _ in range(h.num_ref_l0))
            if h.slice_type == 0:
                if r.read_bit():
                    mods[1] = tuple(r.read_bits(nb)
                                    for _ in range(h.num_ref_l1))
            h.list_mod = tuple(mods)
        if h.slice_type == 0:
            h.mvd_l1_zero = bool(r.read_bit())
        if pps.cabac_init_present:
            h.cabac_init_flag = bool(r.read_bit())
        if h.temporal_mvp:
            col_l0 = True
            if h.slice_type == 0:
                col_l0 = bool(r.read_bit())
            h.col_from_l0 = col_l0
            n = h.num_ref_l0 if col_l0 else h.num_ref_l1
            if n > 1:
                h.col_ref_idx = read_ue(r)
        if (getattr(pps, "weighted_pred", False)
                and h.slice_type == 1) or \
           (getattr(pps, "weighted_bipred", False)
                and h.slice_type == 0):
            _parse_pred_weight_table(r, sps, h)
        h.max_merge = 5 - read_ue(r)
        if not (1 <= h.max_merge <= 5):
            raise ValueError("corrupt slice header: MaxNumMergeCand")
    h.qp = 26 + (pps.init_qp - 26) + read_se(r)
    # SliceQpY range is [-QpBdOffsetY, 51] (7.4.7.1): conforming
    # Main10 streams may go as low as -12
    if not (-(6 * (sps.bit_depth_luma - 8)) <= h.qp <= 51):
        raise ValueError("corrupt slice header: QP out of range")
    if pps.slice_chroma_qp_offsets_present:
        h.cb_qp_offset = read_se(r)
        h.cr_qp_offset = read_se(r)
    h.deblocking_disabled = pps.deblocking_disabled
    h.beta_offset_div2 = pps.beta_offset_div2
    h.tc_offset_div2 = pps.tc_offset_div2
    if pps.deblocking_control_present:
        override = (r.read_bit()
                    if pps.deblocking_override_enabled else 0)
        if override:
            h.deblocking_disabled = bool(r.read_bit())
            if not h.deblocking_disabled:
                h.beta_offset_div2 = read_se(r)
                h.tc_offset_div2 = read_se(r)
    h.lf_across_slices = pps.loop_filter_across_slices
    if ((h.sao_luma or h.sao_chroma or not h.deblocking_disabled)
            and pps.loop_filter_across_slices):
        h.lf_across_slices = bool(r.read_bit())
    _parse_slice_header_tail(r, h, sps, pps)
    return h


def _parse_slice_header_tail(r, h, sps, pps) -> None:
    """Entry points + extension + byte alignment (present for both
    independent and dependent slice segments)."""
    if pps.tiles_enabled or pps.entropy_coding_sync:
        n = read_ue(r)
        if n:
            ln = read_ue(r) + 1
            h.entry_points = tuple(r.read_bits(ln) + 1 for _ in range(n))
    if pps.slice_header_extension_present:
        ln = read_ue(r)
        for _ in range(ln):
            r.read_bits(8)
    # byte_alignment(): 1 then zeros
    if r.read_bit() != 1:
        raise ValueError("slice header alignment bit missing")
    while not r.byte_aligned():
        if r.read_bit() != 0:
            raise ValueError("nonzero alignment bit in slice header")
    h.data_bit_offset = r.bitpos


def _parse_pred_weight_table(r, sps, h) -> None:
    """pred_weight_table (7.3.6.3), retained for the explicit
    weighted sample prediction process (8.5.4.3.3).  Absent per-ref
    flags yield the spec default weights (w = 1 << denom, o = 0)."""
    luma_denom = read_ue(r)
    chroma_denom = luma_denom
    if sps.chroma_format:
        chroma_denom = luma_denom + read_se(r)
    if not (0 <= luma_denom <= 7 and 0 <= chroma_denom <= 7):
        raise ValueError("corrupt pred_weight_table: denom")
    entries: list = [[], []]
    for lst, (nref, active) in enumerate(
            ((h.num_ref_l0, True),
             (h.num_ref_l1, h.slice_type == 0))):
        if not active:
            continue
        lw = [r.read_bit() for _ in range(nref)]
        cw = [r.read_bit() for _ in range(nref)] \
            if sps.chroma_format else [0] * nref
        for i in range(nref):
            w_y, o_y = 1 << luma_denom, 0
            w_cb = w_cr = 1 << chroma_denom
            o_cb = o_cr = 0
            if lw[i]:
                w_y = (1 << luma_denom) + read_se(r)
                o_y = read_se(r)
            if cw[i]:
                ws, os_ = [], []
                for _ in range(2):
                    wc = (1 << chroma_denom) + read_se(r)
                    doff = read_se(r)
                    # 7.4.7.3: offset reconstructed around the
                    # weighted midpoint
                    oc = max(-128, min(127, doff
                                       - ((128 * wc) >> chroma_denom)
                                       + 128))
                    ws.append(wc)
                    os_.append(oc)
                w_cb, w_cr = ws
                o_cb, o_cr = os_
            entries[lst].append((w_y, o_y, w_cb, o_cb, w_cr, o_cr))
    h.wp = (luma_denom, chroma_denom, tuple(entries[0]),
            tuple(entries[1]))


# ---------------------------------------------------------------------------
# decoded structures
# ---------------------------------------------------------------------------

@dataclass
class TU:
    x: int                  # plane-local sample coords
    y: int
    n: int                  # block size in samples
    c_idx: int
    levels: np.ndarray      # (n, n) int32, [y][x]
    qp: int = 26
    skip: bool = False
    bypass: bool = False
    dst: bool = False
    scaling: np.ndarray | None = None   # (n, n) ScalingFactor or None


@dataclass
class PcmOp:
    """Raw IPCM samples for one plane region (7.3.9 / 8.4.4.1)."""
    plane: int
    x: int
    y: int
    n: int
    samples: np.ndarray     # (n, n) int32, already scaled to BitDepth
    zone: int = 0


@dataclass
class PredOp:
    plane: int
    x: int
    y: int
    n: int
    mode: int               # intra mode; -1 = residual add onto MC
    tu: TU | None = None    # residual to add, if any
    zone: int = 0           # (slice_idx << 12) | tile_idx availability zone


@dataclass
class InterOp:
    """Motion-compensated prediction of one PU (all planes); executed
    by formats/hevc_mc.predict_inter before the CU's residual ops."""
    x: int
    y: int
    w: int
    h: int
    mv0: tuple | None = None    # quarter-pel (x, y) or None
    poc0: int = 0
    mv1: tuple | None = None
    poc1: int = 0
    wp: tuple | None = None     # (log2WdY, log2WdC, entry0, entry1)
    zone: int = 0


class TileLayout:
    """Tile geometry (6.5.1): CTB column/row bounds, tile-scan order
    and the rs<->ts address maps."""

    def __init__(self, sps, pps):
        ctb_log2 = sps.ctb_log2
        self.ctbs_x = (sps.width + (1 << ctb_log2) - 1) >> ctb_log2
        self.ctbs_y = (sps.height + (1 << ctb_log2) - 1) >> ctb_log2
        cx, cy = self.ctbs_x, self.ctbs_y
        if pps.tiles_enabled:
            nc, nr = pps.num_tile_cols, pps.num_tile_rows
            if pps.uniform_spacing:
                self.col_bd = [(i * cx) // nc for i in range(nc + 1)]
                self.row_bd = [(i * cy) // nr for i in range(nr + 1)]
            else:
                ws = list(pps.tile_col_widths)
                ws.append(cx - sum(ws))
                hs = list(pps.tile_row_heights)
                hs.append(cy - sum(hs))
                if min(ws) <= 0 or min(hs) <= 0:
                    raise ValueError("corrupt PPS: tile geometry")
                self.col_bd = list(np.concatenate([[0], np.cumsum(ws)]))
                self.row_bd = list(np.concatenate([[0], np.cumsum(hs)]))
        else:
            self.col_bd = [0, cx]
            self.row_bd = [0, cy]
        n = cx * cy
        self.n_ctbs = n
        self.tile_of_rs = np.zeros(n, np.int32)
        ts_to_rs = []
        tid = 0
        for tr in range(len(self.row_bd) - 1):
            for tc in range(len(self.col_bd) - 1):
                for y in range(self.row_bd[tr], self.row_bd[tr + 1]):
                    for x in range(self.col_bd[tc],
                                   self.col_bd[tc + 1]):
                        rs = y * cx + x
                        ts_to_rs.append(rs)
                        self.tile_of_rs[rs] = tid
                tid += 1
        self.n_tiles = tid
        self.ts_to_rs = np.array(ts_to_rs, np.int32)
        self.rs_to_ts = np.zeros(n, np.int32)
        self.rs_to_ts[self.ts_to_rs] = np.arange(n, dtype=np.int32)

    def first_ctb_of_tile(self, tid: int) -> bool:
        pass


class SharedPictureState:
    """Per-picture syntax state shared across slice segments: the
    4x4-granularity maps, SAO output, the availability zone map and
    the CABAC context carry for dependent segments / WPP rows."""

    def __init__(self, sps, pps, pic=None):
        mw, mh = (sps.width + 3) // 4, (sps.height + 3) // 4
        self.ct_depth = np.full((mh, mw), -1, np.int8)
        self.luma_mode = np.full((mh, mw), -1, np.int8)
        self.qp_y_map = np.zeros((mh, mw), np.int8)
        self.zone = np.full((mh, mw), -1, np.int32)
        # decode-order CU stamps (6.4.1 z-scan availability for the
        # inter candidate derivations) + luma nonzero-coeff map
        # (deblock bS=1 rule, 8.7.2.4)
        self.decoded_map = np.zeros((mh, mw), np.uint8)
        self.nonzero_map = np.zeros((mh, mw), np.uint8)
        self.sao_out = {}
        self.layout = TileLayout(sps, pps)
        self.dep_ctx = None               # saved Contexts for dependent
        self.wpp_ctx = None               # row-sync snapshot (9.3.1)
        self.wpp_row = -1                 # row the snapshot came from
        self.pic = pic
        self.slice_of_ctb = np.full(self.layout.n_ctbs, -1, np.int32)


def _ctx_snapshot(ctx: Contexts):
    return {name: [(c.state, c.mps) for c in models]
            for name, models in ctx.m.items()}


def _ctx_restore(ctx: Contexts, snap) -> None:
    for name, saved in snap.items():
        for c, (st, mp) in zip(ctx.m[name], saved):
            c.state, c.mps = st, mp


class SliceDecoder:
    """Pass-1 CABAC syntax decode of one I slice segment.

    Single-segment pictures work standalone (shared=None); for
    multi-slice / dependent-segment / tiles / WPP pictures, pass one
    SharedPictureState across all segments (formats/hevc.py
    decode_picture drives that).
    """

    def __init__(self, sps, pps, header: SliceHeader, data: bytes,
                 pic=None, shared: SharedPictureState | None = None,
                 slice_idx: int = 0, inter_ctx=None):
        self.sps, self.pps, self.hdr = sps, pps, header
        self.ctb_log2 = sps.ctb_log2
        self.min_cb = sps.log2_min_cb
        self.max_tb = sps.log2_min_tb + sps.log2_diff_max_min_tb
        self.min_tb = sps.log2_min_tb
        self.w, self.h = sps.width, sps.height
        self.ctbs_x = (self.w + (1 << self.ctb_log2) - 1) >> self.ctb_log2
        self.ctbs_y = (self.h + (1 << self.ctb_log2) - 1) >> self.ctb_log2
        if sps.bit_depth_luma > 10:
            raise NotImplementedError("bit depth > 10")
        self.shared = shared or SharedPictureState(sps, pps, pic)
        self.layout = self.shared.layout
        self.slice_idx = slice_idx
        self.data = data
        if header.slice_type == 2:
            self.init_type = 0
        elif header.slice_type == 1:                 # P
            self.init_type = 2 if header.cabac_init_flag else 1
        else:                                        # B
            self.init_type = 1 if header.cabac_init_flag else 2
        # full inter decode when the sequence layer supplies reference
        # state (coding/hevc_inter.InterSliceCtx); otherwise P/B
        # slices run parse-and-skip (reference parity)
        self.inter_ctx = inter_ctx
        self.full_inter = (header.slice_type != 2
                           and inter_ctx is not None)
        self.deriver = None
        if self.full_inter:
            from ffpic_tpu_torch.coding.hevc_inter import MotionDeriver
            self.deriver = MotionDeriver(self, inter_ctx)
        self.parse_only = (header.slice_type != 2
                           and inter_ctx is None)
        self.stats = {"cus": 0, "skip_cus": 0, "inter_cus": 0,
                      "intra_cus": 0, "pus": 0, "merge_pus": 0,
                      "mvds": 0}
        if header.dependent and self.shared.dep_ctx is not None:
            self.ctx = Contexts(header.qp, self.init_type)
            _ctx_restore(self.ctx, self.shared.dep_ctx)
        else:
            self.ctx = Contexts(header.qp, self.init_type)
        self.dec = None                   # per-substream, set in decode
        # syntax-state maps at 4x4 granularity (picture-shared)
        self.ct_depth = self.shared.ct_depth
        self.luma_mode = self.shared.luma_mode
        if not hasattr(self.shared, "skip_map"):
            import numpy as _np
            self.shared.skip_map = _np.zeros_like(self.shared.ct_depth,
                                                  dtype=_np.uint8)
            self.shared.intra_map = _np.ones_like(self.shared.ct_depth,
                                                  dtype=_np.uint8)
        self.skip_map = self.shared.skip_map
        self.intra_map = self.shared.intra_map
        self.decoded_map = self.shared.decoded_map
        self.nonzero_map = self.shared.nonzero_map
        self.qp_y_map = self.shared.qp_y_map
        self.zone = self.shared.zone
        self.cur_zone = 0
        self.qp_prev = header.qp
        self.cu_qp_delta = 0
        self.qp_coded = False
        self.qg_pos = (0, 0)
        self.cur_qp = header.qp
        self.ops: list[PredOp] = []
        self.cu_is_inter = False
        self.cu_inter_split = False
        self.sao_out = self.shared.sao_out
        self.pic = pic if pic is not None else self.shared.pic
        self._cu_tus: list[TU] = []
        # scaling lists (8.6.3): PPS override > SPS lists > defaults
        self.scaling_factors = None
        if sps.scaling_list_enabled:
            from ffpic_tpu_torch.coding.hevc_scaling import scaling_factors
            lists = pps.scaling_lists if pps.scaling_lists is not None \
                else sps.scaling_lists
            self.scaling_factors = scaling_factors(lists)

    # -- substream plumbing (entry points, 7.4.7.1) ----------------------
    def _substreams(self):
        """Split the de-escaped slice data at the entry point offsets;
        without entry points the whole payload is one substream."""
        if not self.hdr.entry_points:
            return [self.data]
        subs = []
        pos = 0
        for off in self.hdr.entry_points:
            subs.append(self.data[pos:pos + off])
            pos += off
        subs.append(self.data[pos:])
        return subs

    # -- top level -------------------------------------------------------
    def decode_slice_data(self):
        lay = self.layout
        self.log2_qg = self.ctb_log2 - self.pps.diff_cu_qp_delta_depth
        wpp = self.pps.entropy_coding_sync
        subs = self._substreams()
        sub_idx = 0
        self.dec = CabacDecoder(BitReader(subs[0]))
        start_rs = self.hdr.segment_address
        ts = int(lay.rs_to_ts[start_rs])
        first = True
        while ts < lay.n_ctbs:
            rs = int(lay.ts_to_rs[ts])
            cx, cy = rs % self.ctbs_x, rs // self.ctbs_x
            tile = int(lay.tile_of_rs[rs])

            new_tile = (not first and tile != int(
                lay.tile_of_rs[int(lay.ts_to_rs[ts - 1])]))
            new_row = wpp and cx == self._row_start_cx(tile) \
                and not first
            if new_tile or new_row:
                # next substream: entry points give exact byte offsets
                sub_idx += 1
                if sub_idx >= len(subs):
                    raise ValueError("slice data: missing entry point")
                self.dec = CabacDecoder(BitReader(subs[sub_idx]))
                if new_tile:
                    self.ctx = Contexts(self.hdr.qp,
                                        self.init_type)   # 9.3.1 tiles
                elif new_row:
                    # WPP sync (9.3.1): restore the snapshot taken
                    # after the 2nd CTB of the row above if that CTB
                    # is in the same slice; else fresh init
                    up_right_rs = rs - self.ctbs_x + 1
                    self.ctx = Contexts(self.hdr.qp, self.init_type)
                    if (self.shared.wpp_ctx is not None
                            and up_right_rs >= 0
                            and self.shared.wpp_row == cy - 1
                            and self.shared.slice_of_ctb[up_right_rs]
                            == self.slice_idx):
                        _ctx_restore(self.ctx, self.shared.wpp_ctx)
                self.qp_prev = self.hdr.qp                # 7.4.9.* reset
            first = False

            self.cur_zone = (self.slice_idx << 12) | tile
            self.shared.slice_of_ctb[rs] = self.slice_idx
            self._stamp_zone(cx, cy)

            x0, y0 = cx << self.ctb_log2, cy << self.ctb_log2
            if self.hdr.sao_luma or self.hdr.sao_chroma:
                self._parse_sao(cx, cy)
            self._coding_quadtree(x0, y0, self.ctb_log2, 0)

            if wpp and cx == self._row_start_cx(tile) + 1:
                # storage process: snapshot after the 2nd CTB of a row
                self.shared.wpp_ctx = _ctx_snapshot(self.ctx)
                self.shared.wpp_row = cy

            end = self.dec.terminate()
            if end:
                # slice segment ends here; save contexts for a
                # possible dependent continuation (9.3.1 storage)
                if self.pps.dependent_slice_segments:
                    self.shared.dep_ctx = _ctx_snapshot(self.ctx)
                return self.ops
            if ts == lay.n_ctbs - 1:
                raise ValueError("end_of_slice_segment_flag 0 at the "
                                 "last CTB of the picture")
            ts += 1
        return self.ops

    def _row_start_cx(self, tile: int) -> int:
        """CTB column where a WPP row begins.  Main-profile streams
        never combine tiles with entropy_coding_sync (A.4.1), so WPP
        rows always span the picture."""
        return 0

    def _stamp_zone(self, cx: int, cy: int) -> None:
        s = 1 << (self.ctb_log2 - 2)      # CTB size in 4x4 units
        z = self.zone
        z[cy * s:(cy + 1) * s, cx * s:(cx + 1) * s] = self.cur_zone

    def _avail(self, nx: int, ny: int) -> bool:
        """6.4.1 neighbor availability: inside the picture, already
        decoded (zone stamped) and in the same slice+tile zone."""
        if nx < 0 or ny < 0 or nx >= self.w or ny >= self.h:
            return False
        return self.zone[ny // 4, nx // 4] == self.cur_zone

    # -- SAO syntax (7.3.8.3) ---------------------------------------------
    def _parse_sao(self, cx, cy):
        from ffpic_tpu_torch.formats.hevc_recon import SaoParam
        merge_left = merge_up = 0
        cs = 1 << self.ctb_log2
        if cx > 0 and self._avail(cx * cs - 1, cy * cs):
            merge_left = self.dec.decision(self.ctx["sao_merge", 0])
        if cy > 0 and not merge_left \
                and self._avail(cx * cs, cy * cs - 1):
            merge_up = self.dec.decision(self.ctx["sao_merge", 0])
        if merge_left:
            self.sao_out[(cx, cy)] = self.sao_out[(cx - 1, cy)]
            return
        if merge_up:
            self.sao_out[(cx, cy)] = self.sao_out[(cx, cy - 1)]
            return
        types = [0, 0, 0]
        offsets = [[0] * 4 for _ in range(3)]
        band_pos = [0, 0, 0]
        eo_class = [0, 0, 0]
        n_comp = 3 if self.sps.chroma_format else 1
        for c in range(n_comp):
            if c == 0 and not self.hdr.sao_luma:
                continue
            if c == 1 and not self.hdr.sao_chroma:
                break
            if c <= 1:
                # sao_type_idx: bin0 ctx, bin1 bypass
                if self.dec.decision(self.ctx["sao_type_idx", 0]):
                    types[c] = 2 if self.dec.bypass() else 1
                else:
                    types[c] = 0
                if c == 1:
                    types[2] = types[1]
            if types[c] == 0:
                continue
            for k in range(4):
                offsets[c][k] = self.dec.truncated_rice(
                    7, 0, bypass_prefix=True)
            if types[c] == 1:
                for k in range(4):
                    if offsets[c][k] and self.dec.bypass():
                        offsets[c][k] = -offsets[c][k]
                band_pos[c] = self.dec.bypass_n(5)
            else:
                # edge: first two positive, last two negative
                offsets[c][2] = -offsets[c][2]
                offsets[c][3] = -offsets[c][3]
                if c <= 1:
                    eo_class[c] = self.dec.bypass_n(2)
                    if c == 1:
                        eo_class[2] = eo_class[1]
        # spec: offsets for EO are [o0, o1, 0, o2, o3] around edgeIdx 2;
        # we store 4 offsets keyed to edgeIdx {0,1,3,4} -> k 0..3
        prm = SaoParam(type_idx=tuple(types),
                       offsets=tuple(tuple(o) for o in offsets),
                       band_pos=tuple(band_pos),
                       eo_class=tuple(eo_class))
        self.sao_out[(cx, cy)] = prm

    # -- coding quadtree (7.3.8.4) ---------------------------------------
    def _coding_quadtree(self, x0, y0, log2, depth):
        size = 1 << log2
        inside = x0 + size <= self.w and y0 + size <= self.h
        if inside and log2 > self.min_cb:
            ctx_inc = 0
            if self._avail(x0 - 1, y0) \
                    and self.ct_depth[y0 // 4, (x0 - 1) // 4] > depth:
                ctx_inc += 1
            if self._avail(x0, y0 - 1) \
                    and self.ct_depth[(y0 - 1) // 4, x0 // 4] > depth:
                ctx_inc += 1
            split = self.dec.decision(self.ctx["split_cu_flag", ctx_inc])
        elif log2 > self.min_cb:
            split = 1
        else:
            split = 0
        if (self.pps.cu_qp_delta_enabled
                and log2 >= self.log2_qg):
            self.qp_coded = False
            self.cu_qp_delta = 0
            self.qg_pos = (x0, y0)
            self.qg_qp_prev = self.qp_prev
        if split:
            half = size >> 1
            for (dx, dy) in ((0, 0), (half, 0), (0, half), (half, half)):
                x1, y1 = x0 + dx, y0 + dy
                if x1 < self.w and y1 < self.h:
                    self._coding_quadtree(x1, y1, log2 - 1, depth + 1)
        else:
            self._coding_unit(x0, y0, log2, depth)

    # -- QP prediction (8.6.1) --------------------------------------------
    def _derive_qp(self):
        """qPY_PRED from the QG's left/above neighbors (must lie in the
        same CTB and be decoded) with qPY_PREV fallback."""
        xqg, yqg = self.qg_pos
        ctb_mask = ~((1 << self.ctb_log2) - 1)
        qp_a = qp_b = self.qg_qp_prev
        if xqg > 0 and (xqg - 1) & ctb_mask == xqg & ctb_mask \
                and self.ct_depth[yqg // 4, (xqg - 1) // 4] >= 0:
            qp_a = int(self.qp_y_map[yqg // 4, (xqg - 1) // 4])
        if yqg > 0 and (yqg - 1) & ctb_mask == yqg & ctb_mask \
                and self.ct_depth[(yqg - 1) // 4, xqg // 4] >= 0:
            qp_b = int(self.qp_y_map[(yqg - 1) // 4, xqg // 4])
        pred = (qp_a + qp_b + 1) >> 1
        off = 6 * (self.sps.bit_depth_luma - 8)     # QpBdOffsetY
        return ((pred + self.cu_qp_delta + 52 + 2 * off)
                % (52 + off)) - off

    # -- coding unit (7.3.8.5) --------------------------------------------
    def _coding_unit(self, x0, y0, log2, depth):
        size = 1 << log2
        bypass = False
        if self.pps.transquant_bypass:
            bypass = bool(self.dec.decision(
                self.ctx["cu_transquant_bypass_flag", 0]))
        self.stats["cus"] += 1
        if self.hdr.slice_type != 2:
            # P/B slice: cu_skip_flag (ctx from decoded neighbors'
            # skip flags, 9.3.4.2.2) then pred_mode_flag
            ctx_inc = 0
            if self._avail(x0 - 1, y0) \
                    and self.skip_map[y0 // 4, (x0 - 1) // 4]:
                ctx_inc += 1
            if self._avail(x0, y0 - 1) \
                    and self.skip_map[(y0 - 1) // 4, x0 // 4]:
                ctx_inc += 1
            skip = self.dec.decision(self.ctx["cu_skip_flag", ctx_inc])
            self.ct_depth[y0 // 4:(y0 + size) // 4,
                          x0 // 4:(x0 + size) // 4] = depth
            if skip:
                self.stats["skip_cus"] += 1
                self.stats["inter_cus"] += 1
                self.skip_map[y0 // 4:(y0 + size) // 4,
                              x0 // 4:(x0 + size) // 4] = 1
                self.intra_map[y0 // 4:(y0 + size) // 4,
                               x0 // 4:(x0 + size) // 4] = 0
                self._cu_tus = []
                midx = self._merge_data()
                if self.full_inter:
                    m = self.deriver.merge(x0, y0, size, x0, y0,
                                           size, size, 0, 0, midx)
                    self._emit_inter_pu(x0, y0, size, size, m)
                self._finish_inter_cu_qp(x0, y0, size)
                self.decoded_map[y0 // 4:(y0 + size) // 4,
                                 x0 // 4:(x0 + size) // 4] = 1
                return
            self.skip_map[y0 // 4:(y0 + size) // 4,
                          x0 // 4:(x0 + size) // 4] = 0
            intra = bool(self.dec.decision(
                self.ctx["pred_mode_flag", 0]))
            if not intra:
                self.stats["inter_cus"] += 1
                self.intra_map[y0 // 4:(y0 + size) // 4,
                               x0 // 4:(x0 + size) // 4] = 0
                self._coding_unit_inter(x0, y0, log2, depth, bypass)
                return
            self.stats["intra_cus"] += 1
            self.intra_map[y0 // 4:(y0 + size) // 4,
                           x0 // 4:(x0 + size) // 4] = 1
        # I slice (or intra CU in P/B): pred mode INTRA; no palette
        part_nxn = False
        if log2 == self.min_cb:
            if not self.dec.decision(self.ctx["part_mode", 0]):
                part_nxn = True
        # IPCM (7.3.8.5: PartMode 2Nx2N within the PCM size range)
        if (self.sps.pcm_enabled and not part_nxn
                and self.sps.log2_min_pcm_cb <= log2
                <= self.sps.log2_min_pcm_cb
                + self.sps.log2_diff_max_min_pcm_cb):
            if self.dec.terminate():          # pcm_flag
                self._pcm_cu(x0, y0, log2, depth, bypass)
                return

        # luma intra modes (7.3.8.5 two-loop order)
        n_pu = 2 if part_nxn else 1
        pb = size >> (1 if part_nxn else 0)
        prev = [[0] * n_pu for _ in range(n_pu)]
        for j in range(n_pu):
            for i in range(n_pu):
                prev[j][i] = self.dec.decision(
                    self.ctx["prev_intra_luma_pred_flag", 0])
        mpm_or_rem = [[0] * n_pu for _ in range(n_pu)]
        for j in range(n_pu):
            for i in range(n_pu):
                if prev[j][i]:
                    # mpm_idx: TR cMax=2, bypass
                    v = 0
                    if self.dec.bypass():
                        v = 2 if self.dec.bypass() else 1
                    mpm_or_rem[j][i] = v
                else:
                    mpm_or_rem[j][i] = self.dec.bypass_n(5)
        modes = [[0] * n_pu for _ in range(n_pu)]
        for j in range(n_pu):
            for i in range(n_pu):
                xp, yp = x0 + i * pb, y0 + j * pb
                mode = self._derive_luma_mode(xp, yp, prev[j][i],
                                              mpm_or_rem[j][i])
                modes[j][i] = mode
                self.luma_mode[yp // 4:(yp + pb) // 4,
                               xp // 4:(xp + pb) // 4] = mode

        # chroma mode (4:2:0: one per CU)
        chroma_mode = 0
        if self.sps.chroma_format:
            if self.dec.decision(self.ctx["intra_chroma_pred_mode", 0]):
                idx = self.dec.bypass_n(2)
                cand = (INTRA_PLANAR, 26, 10, INTRA_DC)[idx]
                chroma_mode = 34 if cand == modes[0][0] else cand
            else:
                chroma_mode = modes[0][0]

        # bookkeeping for ctx of later CUs
        self.ct_depth[y0 // 4:(y0 + size) // 4,
                      x0 // 4:(x0 + size) // 4] = depth

        # transform tree
        self._cu_tus = []
        self.cu_bypass = bypass
        self.cu_modes = modes
        self.cu_chroma_mode = chroma_mode
        self.cu_x0, self.cu_y0, self.cu_log2 = x0, y0, log2
        self.cu_part_nxn = part_nxn
        max_depth = (self.sps.max_transform_hierarchy_depth_intra
                     + (1 if part_nxn else 0))
        self.cu_max_trafo_depth = max_depth
        self._transform_tree(x0, y0, x0, y0, log2, 0, 0, True, True)

        # finalize CU QP (8.6.1) and stamp TUs + maps
        qp_y = (self._derive_qp()
                if self.pps.cu_qp_delta_enabled else self.hdr.qp)
        self.qp_prev = qp_y
        self.qp_y_map[y0 // 4:(y0 + size) // 4,
                      x0 // 4:(x0 + size) // 4] = qp_y
        if self.pic is not None:
            self.pic.qp_map[y0 // 4:(y0 + size) // 4,
                            x0 // 4:(x0 + size) // 4] = qp_y
            if bypass:
                self.pic.bypass_map[y0 // 4:(y0 + size) // 4,
                                    x0 // 4:(x0 + size) // 4] = True
        # dequant uses Qp' = QpY/QpC + QpBdOffset (8.6.3: qP for luma
        # is Qp'Y); maps/deblock keep QpY
        bd_off = 6 * (self.sps.bit_depth_luma - 8)
        bd_off_c = 6 * (self.sps.bit_depth_chroma - 8)
        for tu in self._cu_tus:
            if tu.c_idx == 0:
                tu.qp = qp_y + bd_off
            else:
                off = (self.pps.cb_qp_offset + self.hdr.cb_qp_offset
                       if tu.c_idx == 1 else
                       self.pps.cr_qp_offset + self.hdr.cr_qp_offset)
                qpi = min(max(qp_y + off, -bd_off_c), 57)
                tu.qp = chroma_qp(qpi) + bd_off_c
        self.decoded_map[y0 // 4:(y0 + size) // 4,
                         x0 // 4:(x0 + size) // 4] = 1

    # -- inter CU parse-and-skip (7.3.8.5/6/9; reference parity with
    # hevc.c:6285-6397 which parses PU/MVD then discards — no motion
    # compensation happens in either implementation) -------------------
    def _merge_data(self):
        """merge_idx when MaxNumMergeCand > 1 (TR: first bin ctx,
        rest bypass)."""
        self.stats["pus"] += 1
        self.stats["merge_pus"] += 1
        cmax = self.hdr.max_merge - 1
        if cmax <= 0:
            return 0
        idx = 0
        if self.dec.decision(self.ctx["merge_index", 0]):
            idx = 1
            while idx < cmax and self.dec.bypass():
                idx += 1
        return idx

    def _part_mode_inter(self, log2):
        """part_mode binarization for inter CUs (9.3.3.7): ctx bins
        0/1, third bin ctx 2 at min size else ctx 3 (AMP), fourth bin
        bypass."""
        if self.dec.decision(self.ctx["part_mode", 0]):
            return 0                                   # 2Nx2N
        at_min = log2 == self.min_cb
        b1 = self.dec.decision(self.ctx["part_mode", 1])
        if at_min:
            if b1:
                return 1                               # 2NxN
            if log2 == 3:
                return 2          # 8x8: "00" = Nx2N (table 9-34)
            return 2 if self.dec.decision(
                self.ctx["part_mode", 2]) else 3       # Nx2N / NxN
        amp = self.sps.amp_enabled
        if b1:                                         # horizontal
            if not amp:
                return 1
            if self.dec.decision(self.ctx["part_mode", 3]):
                return 1                               # 2NxN
            return 5 if self.dec.bypass() else 4       # 2NxnD / 2NxnU
        if not amp:
            return 2
        if self.dec.decision(self.ctx["part_mode", 3]):
            return 2                                   # Nx2N
        return 7 if self.dec.bypass() else 6           # nRx2N / nLx2N

    _PART_GEOM = {
        0: ((0, 0, 4, 4),),
        1: ((0, 0, 4, 2), (0, 2, 4, 2)),
        2: ((0, 0, 2, 4), (2, 0, 2, 4)),
        3: ((0, 0, 2, 2), (2, 0, 2, 2), (0, 2, 2, 2), (2, 2, 2, 2)),
        4: ((0, 0, 4, 1), (0, 1, 4, 3)),               # 2NxnU
        5: ((0, 0, 4, 3), (0, 3, 4, 1)),               # 2NxnD
        6: ((0, 0, 1, 4), (1, 0, 3, 4)),               # nLx2N
        7: ((0, 0, 3, 4), (3, 0, 1, 4)),               # nRx2N
    }

    def _coding_unit_inter(self, x0, y0, log2, depth, bypass):
        size = 1 << log2
        self._cu_tus = []
        part = self._part_mode_inter(log2)
        if part < 0:
            raise ValueError("invalid inter part_mode bin string")
        merged_2nx2n = False
        for part_idx, (qx, qy, qw, qh) in \
                enumerate(self._PART_GEOM[part]):
            px = x0 + (qx * size) // 4
            py = y0 + (qy * size) // 4
            pw = (qw * size) // 4
            ph = (qh * size) // 4
            pu = self._prediction_unit(px, py, pw, ph, depth)
            if part == 0:
                merged_2nx2n = pu["merged"]
            if self.full_inter:
                m = self._derive_pu_motion(x0, y0, size, px, py, pw,
                                           ph, part_idx, part, pu)
                self._emit_inter_pu(px, py, pw, ph, m)
        # rqt_root_cbf (7.3.8.5): absent (inferred 1) for 2Nx2N merge
        root_cbf = True
        if not merged_2nx2n:
            root_cbf = bool(self.dec.decision(
                self.ctx["rqt_root_cbf", 0]))
        if not root_cbf:
            self._finish_inter_cu_qp(x0, y0, size)
            self.decoded_map[y0 // 4:(y0 + size) // 4,
                             x0 // 4:(x0 + size) // 4] = 1
            return
        self._cu_tus = []
        self.cu_bypass = bypass
        self.cu_modes = [[1]]            # DC sentinel (diag scans)
        self.cu_chroma_mode = 1
        self.cu_x0, self.cu_y0, self.cu_log2 = x0, y0, log2
        self.cu_part_nxn = False
        self.cu_is_inter = True
        # interSplitFlag: forced depth-0 split when the inter
        # hierarchy depth is 0 and the CU is partitioned (7.4.9.8)
        self.cu_inter_split = (
            self.sps.max_transform_hierarchy_depth_inter == 0
            and part != 0)
        self.cu_max_trafo_depth = (
            self.sps.max_transform_hierarchy_depth_inter
            + (1 if self.cu_inter_split else 0))
        self._transform_tree(x0, y0, x0, y0, log2, 0, 0, True, True)
        self.cu_is_inter = False
        self.cu_inter_split = False
        self._finish_inter_cu_qp(x0, y0, size)
        self.decoded_map[y0 // 4:(y0 + size) // 4,
                         x0 // 4:(x0 + size) // 4] = 1

    def _finish_inter_cu_qp(self, x0, y0, size):
        """QP bookkeeping for inter/skip CUs (8.6.1): mirrors the
        intra path; deblocking reads pic.qp_map."""
        qp_y = (self._derive_qp()
                if self.pps.cu_qp_delta_enabled else self.hdr.qp)
        self.qp_prev = qp_y
        self.qp_y_map[y0 // 4:(y0 + size) // 4,
                      x0 // 4:(x0 + size) // 4] = qp_y
        if self.pic is not None:
            self.pic.qp_map[y0 // 4:(y0 + size) // 4,
                            x0 // 4:(x0 + size) // 4] = qp_y
        bd_off = 6 * (self.sps.bit_depth_luma - 8)
        bd_off_c = 6 * (self.sps.bit_depth_chroma - 8)
        for tu in self._cu_tus:
            if tu.c_idx == 0:
                tu.qp = qp_y + bd_off
            else:
                off = (self.pps.cb_qp_offset + self.hdr.cb_qp_offset
                       if tu.c_idx == 1 else
                       self.pps.cr_qp_offset + self.hdr.cr_qp_offset)
                qpi = min(max(qp_y + off, -bd_off_c), 57)
                tu.qp = chroma_qp(qpi) + bd_off_c
        self._cu_tus = []

    def _derive_pu_motion(self, xCb, yCb, nCbS, px, py, pw, ph,
                          part_idx, part_mode, pu):
        """Motion derivation for one parsed PU (8.5.3.1)."""
        from ffpic_tpu_torch.coding.hevc_inter import NO_REF, PuMotion
        if pu["merged"]:
            return self.deriver.merge(xCb, yCb, nCbS, px, py, pw, ph,
                                      part_idx, part_mode,
                                      pu["merge_idx"])
        ctx = self.inter_ctx
        m = PuMotion()
        for lx in range(2):
            if not pu["pred"][lx]:
                continue
            ri = pu["ref_idx"][lx]
            mvp = self.deriver.amvp(xCb, yCb, nCbS, px, py, pw, ph,
                                    part_idx, lx, ri,
                                    pu["mvp_flag"][lx])
            dx, dy = pu["mvd"][lx]
            # 16-bit wrap (7.4.9.9 / 8.5.3.1)
            mx = ((mvp[0] + dx + 0x8000) & 0xFFFF) - 0x8000
            my = ((mvp[1] + dy + 0x8000) & 0xFFFF) - 0x8000
            m.pred[lx] = True
            m.mv[lx] = (mx, my)
            m.ref_idx[lx] = ri
            m.poc[lx] = ctx.ref_list[lx][ri][0]
        return m

    def _emit_inter_pu(self, px, py, pw, ph, m):
        """Stamp the motion field and emit the MC op (+ PU deblock
        edges)."""
        ctx = self.inter_ctx
        ctx.field_.stamp(px, py, pw, ph, m)
        wp_op = None
        if ctx.wp is not None:
            d_y, d_c, e0, e1 = ctx.wp
            wp_op = (d_y, d_c,
                     e0[m.ref_idx[0]] if m.pred[0] else None,
                     e1[m.ref_idx[1]] if m.pred[1] else None)
        self.ops.append(InterOp(
            x=px, y=py, w=pw, h=ph,
            mv0=m.mv[0] if m.pred[0] else None,
            poc0=m.poc[0] if m.pred[0] else 0,
            mv1=m.mv[1] if m.pred[1] else None,
            poc1=m.poc[1] if m.pred[1] else 0,
            wp=wp_op, zone=self.cur_zone))
        if self.pic is not None:
            self.pic.mark_edges_rect(px, py, pw, ph)

    def _prediction_unit(self, x0, y0, w, h, depth):
        """prediction_unit (7.3.8.6).  Returns the parsed motion
        syntax as a dict (merged, merge_idx, pred[2], ref_idx[2],
        mvd[2], mvp_flag[2])."""
        self.stats["pus"] += 1
        if self.dec.decision(self.ctx["merge_flag", 0]):
            self.stats["merge_pus"] += 1
            cmax = self.hdr.max_merge - 1
            idx = 0
            if cmax > 0:
                if self.dec.decision(self.ctx["merge_index", 0]):
                    idx = 1
                    while idx < cmax and self.dec.bypass():
                        idx += 1
            return {"merged": True, "merge_idx": idx}
        # inter_pred_idc (9.3.3.9): bi gated by PU size
        pred_idc = 1                                  # PRED_L0
        if self.hdr.slice_type == 0:                  # B
            if w + h != 12:
                if self.dec.decision(
                        self.ctx["inter_pred_idc", depth]):
                    pred_idc = 3                      # PRED_BI
                else:
                    pred_idc = 2 if self.dec.decision(
                        self.ctx["inter_pred_idc", 4]) else 1
            else:
                pred_idc = 2 if self.dec.decision(
                    self.ctx["inter_pred_idc", 4]) else 1
        pred = [pred_idc in (1, 3), pred_idc in (2, 3)]
        ref_idx = [0, 0]
        mvd = [(0, 0), (0, 0)]
        mvp_flag = [0, 0]
        for lst, num_ref in ((0, self.hdr.num_ref_l0),
                             (1, self.hdr.num_ref_l1)):
            if not pred[lst]:
                continue
            if num_ref > 1:                            # ref_idx TR
                if self.dec.decision(self.ctx["ref_idx", 0]):
                    ri = 1
                    if num_ref > 2 and self.dec.decision(
                            self.ctx["ref_idx", 1]):
                        ri = 2
                        while ri < num_ref - 1 and self.dec.bypass():
                            ri += 1
                    ref_idx[lst] = ri
            if lst == 1 and self.hdr.mvd_l1_zero and pred_idc == 3:
                pass                                   # MvdL1 = 0
            else:
                mvd[lst] = self._mvd_coding()
            mvp_flag[lst] = self.dec.decision(self.ctx["mvp_flag", 0])
        return {"merged": False, "merge_idx": 0, "pred": pred,
                "ref_idx": ref_idx, "mvd": mvd, "mvp_flag": mvp_flag}

    def _mvd_coding(self):
        """mvd_coding (7.3.8.9); returns (mvd_x, mvd_y)."""
        self.stats["mvds"] += 1
        g0 = [self.dec.decision(self.ctx["abs_mvd_greater0_flag", 0])
              for _ in range(2)]
        g1 = [0, 0]
        for i in range(2):
            if g0[i]:
                g1[i] = self.dec.decision(
                    self.ctx["abs_mvd_greater1_flag", 0])
        out = [0, 0]
        for i in range(2):
            if g0[i]:
                v = 1
                if g1[i]:
                    v = 2 + self.dec.exp_golomb_k(1)  # abs_mvd_minus2
                out[i] = -v if self.dec.bypass() else v
        return (out[0], out[1])

    def _pcm_cu(self, x0, y0, log2, depth, bypass):
        """pcm_sample (7.3.9): raw fixed-length samples, scaled to
        BitDepth (8.4.4.1); engine pauses then re-initializes."""
        size = 1 << log2
        sps = self.sps
        self.dec.pcm_begin()
        pbd_y = sps.pcm_bit_depth_luma
        sh_y = sps.bit_depth_luma - pbd_y
        luma = np.empty((size, size), np.int32)
        for yy in range(size):
            for xx in range(size):
                luma[yy, xx] = self.dec.read_raw(pbd_y) << sh_y
        self.ops.append(PcmOp(0, x0, y0, size, luma,
                              zone=self.cur_zone))
        if sps.chroma_format:
            pbd_c = sps.pcm_bit_depth_chroma
            sh_c = sps.bit_depth_chroma - pbd_c
            half = size >> 1
            for plane in (1, 2):
                cs = np.empty((half, half), np.int32)
                for yy in range(half):
                    for xx in range(half):
                        cs[yy, xx] = self.dec.read_raw(pbd_c) << sh_c
                self.ops.append(PcmOp(plane, x0 >> 1, y0 >> 1, half,
                                      cs, zone=self.cur_zone))
        self.dec.pcm_end()
        # bookkeeping: neighbors see a PCM CU as INTRA_DC (8.4.2) and
        # the maps get the derived QP for deblocking
        self.ct_depth[y0 // 4:(y0 + size) // 4,
                      x0 // 4:(x0 + size) // 4] = depth
        self.luma_mode[y0 // 4:(y0 + size) // 4,
                       x0 // 4:(x0 + size) // 4] = INTRA_DC
        self.decoded_map[y0 // 4:(y0 + size) // 4,
                         x0 // 4:(x0 + size) // 4] = 1
        qp_y = (self._derive_qp()
                if self.pps.cu_qp_delta_enabled else self.hdr.qp)
        self.qp_prev = qp_y
        self.qp_y_map[y0 // 4:(y0 + size) // 4,
                      x0 // 4:(x0 + size) // 4] = qp_y
        if self.pic is not None:
            self.pic.qp_map[y0 // 4:(y0 + size) // 4,
                            x0 // 4:(x0 + size) // 4] = qp_y
            self.pic.mark_edges(x0, y0, size)
            if bypass or sps.pcm_loop_filter_disabled:
                # pcm_loop_filter_disabled exempts PCM samples from
                # deblock/SAO exactly like lossless CUs (8.7.2.5.3)
                self.pic.bypass_map[y0 // 4:(y0 + size) // 4,
                                    x0 // 4:(x0 + size) // 4] = True

    def _derive_luma_mode(self, xp, yp, prev, val):
        """MPM construction (8.4.2)."""
        def cand(nx, ny, above):
            if not self._avail(nx, ny):
                return INTRA_DC
            if above and (ny >> self.ctb_log2) != (yp >> self.ctb_log2):
                return INTRA_DC
            if not self.intra_map[ny // 4, nx // 4]:
                return INTRA_DC          # inter/skip neighbor (8.4.2)
            m = self.luma_mode[ny // 4, nx // 4]
            return INTRA_DC if m < 0 else int(m)
        cand_a = cand(xp - 1, yp, False)
        cand_b = cand(xp, yp - 1, True)
        if cand_a == cand_b:
            if cand_a < 2:
                mpm = [INTRA_PLANAR, INTRA_DC, 26]
            else:
                mpm = [cand_a, 2 + ((cand_a + 29) % 32),
                       2 + ((cand_a - 2 + 1) % 32)]
        else:
            mpm = [cand_a, cand_b, 0]
            if INTRA_PLANAR not in (cand_a, cand_b):
                mpm[2] = INTRA_PLANAR
            elif INTRA_DC not in (cand_a, cand_b):
                mpm[2] = INTRA_DC
            else:
                mpm[2] = 26
        if prev:
            return mpm[val]
        s = sorted(mpm)
        mode = val
        for m in s:
            if mode >= m:
                mode += 1
        return mode

    # -- transform tree (7.3.8.8) ------------------------------------------
    def _transform_tree(self, x0, y0, xb, yb, log2, depth, blk_idx,
                        cbf_cb_par, cbf_cr_par):
        intra_split = self.cu_part_nxn
        inter_split = self.cu_inter_split and depth == 0
        if (log2 <= self.max_tb and log2 > self.min_tb
                and depth < self.cu_max_trafo_depth
                and not (intra_split and depth == 0)
                and not inter_split):
            split = self.dec.decision(
                self.ctx["split_transform_flag", 5 - log2])
        else:
            split = int(log2 > self.max_tb
                        or ((intra_split or inter_split)
                            and depth == 0
                            and log2 > self.min_tb))
        cbf_cb, cbf_cr = cbf_cb_par, cbf_cr_par
        if self.sps.chroma_format and log2 > 2:
            if depth == 0 or cbf_cb_par:
                cbf_cb = bool(self.dec.decision(
                    self.ctx["cbf_cb_cr", depth]))
            else:
                cbf_cb = False
            if depth == 0 or cbf_cr_par:
                cbf_cr = bool(self.dec.decision(
                    self.ctx["cbf_cb_cr", depth]))
            else:
                cbf_cr = False
        if split:
            half = 1 << (log2 - 1)
            self._transform_tree(x0, y0, x0, y0, log2 - 1, depth + 1, 0,
                                 cbf_cb, cbf_cr)
            self._transform_tree(x0 + half, y0, x0, y0, log2 - 1,
                                 depth + 1, 1, cbf_cb, cbf_cr)
            self._transform_tree(x0, y0 + half, x0, y0, log2 - 1,
                                 depth + 1, 2, cbf_cb, cbf_cr)
            self._transform_tree(x0 + half, y0 + half, x0, y0, log2 - 1,
                                 depth + 1, 3, cbf_cb, cbf_cr)
            return
        if self.cu_is_inter and depth == 0 and not cbf_cb \
                and not cbf_cr:
            cbf_luma = True        # inferred (7.4.9.8 inter leaf)
        else:
            cbf_luma = bool(self.dec.decision(
                self.ctx["cbf_luma", 1 if depth == 0 else 0]))
        self._transform_unit(x0, y0, xb, yb, log2, depth, blk_idx,
                             cbf_luma, cbf_cb, cbf_cr)

    # -- transform unit (7.3.8.10) -----------------------------------------
    def _transform_unit(self, x0, y0, xb, yb, log2, depth, blk_idx,
                        cbf_luma, cbf_cb, cbf_cr):
        has_chroma = self.sps.chroma_format and (
            log2 > 2 or blk_idx == 3)
        if log2 > 2:
            cx, cy, clog2 = x0, y0, log2 - 1
        else:
            cx, cy, clog2 = xb, yb, 2
        cbf_chroma = has_chroma and (cbf_cb or cbf_cr)
        if cbf_luma or cbf_chroma:
            if self.pps.cu_qp_delta_enabled and not self.qp_coded:
                self._parse_cu_qp_delta()
        # luma: prediction op (+ residual)
        size = 1 << log2
        mode = 1 if self.cu_is_inter \
            else int(self.luma_mode[y0 // 4, x0 // 4])
        tu = None
        if cbf_luma:
            tu = self._residual(x0, y0, log2, 0, mode)
            if self.full_inter and np.any(tu.levels):
                # luma nonzero-coeff map for the deblock bS=1 rule
                self.nonzero_map[y0 // 4:(y0 + size) // 4,
                                 x0 // 4:(x0 + size) // 4] = 1
        if self.cu_is_inter:
            # MC already predicted the CU; TUs only add residual
            if tu is not None:
                self.ops.append(PredOp(0, x0, y0, size, -1, tu,
                                       zone=self.cur_zone))
        else:
            self.ops.append(PredOp(0, x0, y0, size, mode, tu,
                                   zone=self.cur_zone))
        if self.pic is not None:
            if self.full_inter:
                self.pic.mark_edges_full(x0, y0, size)
            else:
                self.pic.mark_edges(x0, y0, size)
        # chroma: at this leaf if size > 4, else at blkIdx 3 (covering
        # the parent 8x8)
        if has_chroma:
            csize = 1 << clog2            # chroma samples
            cmode = self.cu_chroma_mode
            tu_cb = tu_cr = None
            if cbf_cb:
                tu_cb = self._residual(cx, cy, clog2, 1, cmode)
            if cbf_cr:
                tu_cr = self._residual(cx, cy, clog2, 2, cmode)
            if self.cu_is_inter:
                if tu_cb is not None:
                    self.ops.append(PredOp(1, cx >> 1, cy >> 1, csize,
                                           -1, tu_cb,
                                           zone=self.cur_zone))
                if tu_cr is not None:
                    self.ops.append(PredOp(2, cx >> 1, cy >> 1, csize,
                                           -1, tu_cr,
                                           zone=self.cur_zone))
            else:
                self.ops.append(PredOp(1, cx >> 1, cy >> 1, csize,
                                       cmode, tu_cb,
                                       zone=self.cur_zone))
                self.ops.append(PredOp(2, cx >> 1, cy >> 1, csize,
                                       cmode, tu_cr,
                                       zone=self.cur_zone))

    def _parse_cu_qp_delta(self):
        # cu_qp_delta_abs: TR cMax=5 ctx-coded (bin0 ctx0, rest ctx1),
        # EG0 bypass suffix when prefix saturates
        prefix = 0
        if self.dec.decision(self.ctx["cu_qp_delta_abs", 0]):
            prefix = 1
            while prefix < 5 and self.dec.decision(
                    self.ctx["cu_qp_delta_abs", 1]):
                prefix += 1
        val = prefix
        if prefix == 5:
            val = 5 + self.dec.exp_golomb_k(0)
        if val:
            if self.dec.bypass():
                val = -val
        self.cu_qp_delta = val
        self.qp_coded = True

    # -- residual coding (7.3.8.11) ------------------------------------------
    def _residual(self, x0, y0, log2, c_idx, pred_mode) -> TU:
        dec, ctx = self.dec, self.ctx
        n = 1 << log2
        levels = np.zeros((n, n), np.int32)
        skip = False
        if (self.pps.transform_skip_enabled and not self.cu_bypass
                and log2 == 2):
            skip = bool(dec.decision(
                ctx["transform_skip_flag", 1 if c_idx else 0]))

        # scan index (7.4.9.11): mode-dependent for small intra TBs
        if log2 == 2 or (log2 == 3 and c_idx == 0):
            if 6 <= pred_mode <= 14:
                scan_idx = 2
            elif 22 <= pred_mode <= 30:
                scan_idx = 1
            else:
                scan_idx = 0
        else:
            scan_idx = 0

        # last significant coefficient position (9.3.4.2.3)
        def last_prefix(which):
            base = ("last_sig_coeff_x_prefix" if which == 0
                    else "last_sig_coeff_y_prefix")
            if c_idx == 0:
                off = 3 * (log2 - 2) + ((log2 - 1) >> 2)
                shift = (log2 + 1) >> 2
            else:
                off = 15
                shift = log2 - 2
            c_max = (log2 << 1) - 1
            v = 0
            while v < c_max and dec.decision(
                    ctx[base, (v >> shift) + off]):
                v += 1
            return v

        px = last_prefix(0)
        py = last_prefix(1)

        def last_val(prefix):
            if prefix <= 3:
                return prefix
            nbits = (prefix >> 1) - 1
            suf = dec.bypass_n(nbits)
            return (2 + (prefix & 1)) * (1 << nbits) + suf

        last_x = last_val(px)
        last_y = last_val(py)
        if scan_idx == 2:
            last_x, last_y = last_y, last_x

        sub_scan = scan_order(log2 - 2, scan_idx)
        coef_scan = scan_order(2, scan_idx)
        n_sub = 1 << (log2 - 2)

        # locate last sub-block + position in scan order
        last_sb = -1
        last_pos = -1
        sx_t, sy_t = last_x >> 2, last_y >> 2
        for i, (sxx, syy) in enumerate(sub_scan):
            if sxx == sx_t and syy == sy_t:
                last_sb = i
                break
        px_t, py_t = last_x & 3, last_y & 3
        for i, (cxx, cyy) in enumerate(coef_scan):
            if cxx == px_t and cyy == py_t:
                last_pos = i
                break

        csbf = np.zeros((n_sub, n_sub), np.int8)
        gt1_continuation = 1              # greater1Ctx of prev sub-block

        for i in range(last_sb, -1, -1):
            sxx, syy = int(sub_scan[i][0]), int(sub_scan[i][1])
            infer_dc = 0
            if i < last_sb and i > 0:
                right = csbf[syy, sxx + 1] if sxx + 1 < n_sub else 0
                below = csbf[syy + 1, sxx] if syy + 1 < n_sub else 0
                ctx_inc = min(int(right) + int(below), 1) + \
                    (2 if c_idx else 0)
                csbf[syy, sxx] = dec.decision(
                    ctx["coded_sub_block_flag", ctx_inc])
                infer_dc = 1
            else:
                csbf[syy, sxx] = 1
            if not csbf[syy, sxx]:
                continue

            sig = np.zeros(16, np.int8)
            start_n = last_pos - 1 if i == last_sb else 15
            if i == last_sb:
                sig[last_pos] = 1
            for nn in range(start_n, -1, -1):
                xp, yp = int(coef_scan[nn][0]), int(coef_scan[nn][1])
                xc, yc = (sxx << 2) + xp, (syy << 2) + yp
                if nn > 0 or not infer_dc:
                    ctx_inc = self._sig_ctx(log2, c_idx, scan_idx, xc,
                                            yc, sxx, syy, csbf, n_sub)
                    sig[nn] = dec.decision(ctx["sig_coeff_flag",
                                               ctx_inc])
                    if sig[nn]:
                        infer_dc = 0
                else:
                    sig[nn] = 1  # inferred DC
            sig_pos = [nn for nn in range(15, -1, -1) if sig[nn]]
            if not sig_pos:
                continue

            # greater1 flags for the first 8 (9.3.4.2.6)
            ctx_set = 0 if (i == 0 or c_idx > 0) else 2
            if gt1_continuation == 0:
                ctx_set += 1
            c1 = 1
            gt1 = {}
            for k, nn in enumerate(sig_pos[:8]):
                ctx_inc = ctx_set * 4 + min(c1, 3)
                if c_idx:
                    ctx_inc += 16
                f = dec.decision(
                    ctx["coeff_abs_level_greater1_flag", ctx_inc])
                gt1[nn] = f
                if f:
                    c1 = 0
                elif 0 < c1 < 3:
                    c1 += 1
            gt1_continuation = c1

            gt2 = {}
            first_gt1 = next((nn for nn in sig_pos[:8] if gt1[nn]), None)
            if first_gt1 is not None:
                ctx_inc = ctx_set + (4 if c_idx else 0)
                gt2[first_gt1] = dec.decision(
                    ctx["coeff_abs_level_greater2_flag", ctx_inc])

            # sign hiding decision
            sign_hidden = (self.pps.sign_data_hiding
                           and not self.cu_bypass
                           and (sig_pos[0] - sig_pos[-1]) > 3)
            signs = {}
            for nn in sig_pos:
                if sign_hidden and nn == sig_pos[-1]:
                    continue
                signs[nn] = dec.bypass()

            # remaining levels (9.3.3.13)
            rice = 0
            total = 0
            lvls = {}
            for k, nn in enumerate(sig_pos):
                base = 1
                if k < 8:
                    base += gt1.get(nn, 0)
                    if nn == first_gt1:
                        base += gt2.get(nn, 0)
                threshold = 3 if (k < 8 and nn == first_gt1) else \
                    (2 if k < 8 else 1)
                lvl = base
                if base == threshold:
                    prefix = 0
                    while prefix < 32 and dec.bypass():
                        prefix += 1
                    if prefix < 3:
                        suf = dec.bypass_n(rice) if rice else 0
                        rem = (prefix << rice) + suf
                    else:
                        nbits = prefix - 3 + rice
                        suf = dec.bypass_n(nbits) if nbits else 0
                        rem = (((1 << (prefix - 3)) + 2) << rice) + suf
                    lvl = base + rem
                    if lvl > (3 << rice):
                        rice = min(rice + 1, 4)
                lvls[nn] = lvl
                total += lvl
            for nn in sig_pos:
                lvl = lvls[nn]
                if sign_hidden and nn == sig_pos[-1]:
                    s = total & 1
                else:
                    s = signs[nn]
                if s:
                    lvl = -lvl
                xp, yp = int(coef_scan[nn][0]), int(coef_scan[nn][1])
                levels[(syy << 2) + yp, (sxx << 2) + xp] = lvl

        # implicit DST applies to INTRA luma 4x4 only (8.6.4); inter
        # 4x4 luma TUs (forced Nx2N/2NxN splits) use the DCT
        dst = (c_idx == 0 and log2 == 2 and not self.cu_is_inter)
        if c_idx:
            x0, y0 = x0 >> 1, y0 >> 1
        scaling = None
        if self.scaling_factors is not None:
            from ffpic_tpu_torch.coding.hevc_scaling import factor_for
            scaling = factor_for(self.scaling_factors, n, c_idx)
        tu = TU(x=x0, y=y0, n=n, c_idx=c_idx, levels=levels,
                skip=skip, bypass=self.cu_bypass, dst=dst,
                scaling=scaling)
        self._cu_tus.append(tu)
        return tu

    @staticmethod
    def _sig_ctx(log2, c_idx, scan_idx, xc, yc, sxx, syy, csbf, n_sub):
        """9.3.4.2.5 sig_coeff_flag ctxInc derivation."""
        if log2 == 2:
            sig = SIG_CTX_4X4[(yc << 2) + xc]
        elif xc == 0 and yc == 0:
            sig = 0
        else:
            right = int(csbf[syy, sxx + 1]) if sxx + 1 < n_sub else 0
            below = int(csbf[syy + 1, sxx]) if syy + 1 < n_sub else 0
            prev = right + 2 * below
            xp, yp = xc & 3, yc & 3
            if prev == 0:
                sig = 2 if xp + yp == 0 else (1 if xp + yp < 3 else 0)
            elif prev == 1:
                sig = 2 if yp == 0 else (1 if yp == 1 else 0)
            elif prev == 2:
                sig = 2 if xp == 0 else (1 if xp == 1 else 0)
            else:
                sig = 2
            if c_idx == 0:
                if sxx or syy:
                    sig += 3
                sig += (9 if scan_idx == 0 else 15) if log2 == 3 else 21
            else:
                sig += 9 if log2 == 3 else 12
        return sig + (27 if c_idx else 0)
