"""AV1 tile symbol decoder: partition walk, intra mode info,
coefficient decode (spec 5.11).

Two-pass design like this repo's HEVC decoder: this module parses one
tile's arithmetic-coded symbols into per-frame mode arrays plus an
ordered transform-block list; ffpic_tpu/formats/av1_recon.py replays
that list to reconstruct pixels.  No parse step depends on
reconstructed samples (palette/intrabc, which would not change that,
are gated NotImplementedError until the corpus needs them).

The C reference (junka/ffpic) stubs AV1 at the frame level
(avif.c:382-405); dav1d is the conformance oracle (tests/test_av1.py).

Copied from ``ffpic_tpu/coding/av1_tile.py`` for the PyTorch port
whole (``FrameState``, ``TileDecoder`` with its intra and inter mode
info, palette, intra block copy and residuals on the Python symbol path
and both C routes), with its imports rewritten to the port's modules
and this change:

* the C routes (``native.av1_sb_parse``, or ``av1_block_mode`` and
  ``av1_block_parse`` a block) always run where the reference would
  take them with its library loaded: the port builds its library or
  raises, and does not honour ``FFPIC_AV1_NO_NATIVE``.  The Python
  symbol path runs for a ``FrameState`` with ``force_python`` set (and,
  as in the reference, for inter frames and frames decoded with a
  loaded CDF template); ``FFPIC_AV1_BLOCK_NATIVE`` pins the per-block C
  route as in the reference.
"""

from __future__ import annotations

import os

import numpy as np

from ffpic_tpu_torch.coding.av1_msac import Msac, CdfContext, fresh_cdf
from ffpic_tpu_torch.coding import av1_consts as C
from ffpic_tpu_torch.coding import av1_headers as H

MAX_ANGLE_DELTA = 3
# square-tx enum -> square BLOCK enum (aom txsize_to_bsize, for the
# txfm_split ctx category)
_TX_TO_BSIZE = [C.BLOCK_4X4, C.BLOCK_8X8, C.BLOCK_16X16,
                C.BLOCK_32X32, C.BLOCK_64X64]
DELTA_Q_SMALL = 3
DELTA_LF_SMALL = 3
NUM_BASE_LEVELS = 2
COEFF_BASE_RANGE = 12
BR_CDF_SIZE = 4

# Max_Tx_Depth[bsize] (spec)
MAX_TX_DEPTH = [0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 4, 4, 4,
                2, 2, 3, 3, 4, 4]


def qctx_for_base_q(base_q_idx: int) -> int:
    if base_q_idx <= 20:
        return 0
    if base_q_idx <= 60:
        return 1
    if base_q_idx <= 120:
        return 2
    return 3


class Block:
    """Per-coding-block mode record referenced by transform blocks."""

    __slots__ = ("mi_row", "mi_col", "bsize", "seg_id", "skip",
                 "y_mode", "uv_mode", "angle_y", "angle_uv",
                 "filter_intra_mode", "cfl_alpha_u", "cfl_alpha_v",
                 "tx_size", "qindex", "has_chroma",
                 "avail_u", "avail_l", "avail_uc", "avail_lc",
                 "tile", "coeff_map",
                 "pal_y", "pal_u", "pal_v", "pal_map_y",
                 "pal_map_uv", "_pal_rec", "use_intrabc", "mv",
                 # inter-frame fields (av1_inter.py)
                 "is_inter", "skip_mode", "refs", "mvs2",
                 "ref_mv_idx", "interp", "motion_mode",
                 "interintra", "ii_mode", "ii_wedge", "wedge_index",
                 "wedge_sign", "mask_type", "comp_group_idx",
                 "compound_idx", "compound_type", "warp_samples",
                 "mv_stack", "warp_params")

    def __init__(self):
        self.use_intrabc = False
        self.mv = (0, 0)
        self.is_inter = False
        self.skip_mode = False
        self.refs = [0, -1]              # (INTRA_FRAME, NONE)
        self.mvs2 = [[0, 0], [0, 0]]
        self.ref_mv_idx = 0
        self.interp = [0, 0]
        self.motion_mode = 0
        self.interintra = False
        self.ii_mode = 0
        self.ii_wedge = False
        self.wedge_index = 0
        self.wedge_sign = 0
        self.mask_type = 0
        self.comp_group_idx = 0
        self.compound_idx = 1
        self.compound_type = -1
        self.warp_samples = None
        self.mv_stack = None
        self.warp_params = None
        self.filter_intra_mode = -1
        self.cfl_alpha_u = 0
        self.cfl_alpha_v = 0
        self.angle_y = 0
        self.angle_uv = 0
        self.uv_mode = C.DC_PRED
        self.has_chroma = False
        self.coeff_map = None
        self.pal_y = ()          # luma palette colors (sorted)
        self.pal_u = ()
        self.pal_v = ()
        self.pal_map_y = None    # (bh, bw) uint8 color-index map
        self.pal_map_uv = None   # chroma-resolution map (shared u/v)


class TransformBlock:
    __slots__ = ("plane", "x", "y", "tx_size", "tx_type", "eob",
                 "coeffs", "block", "residual", "lossless")

    def __init__(self, plane, x, y, tx_size, tx_type, eob, coeffs,
                 block):
        self.plane = plane
        self.x = x          # plane-sample coords
        self.y = y
        self.tx_size = tx_size
        self.tx_type = tx_type
        self.eob = eob
        self.coeffs = coeffs    # dequantized int64 (h, w) adjusted
        self.block = block
        self.residual = None    # filled by the batched inverse
                                # transform pre-pass (av1_recon)
        self.lossless = False   # segment losslessness (transform
                                # grouping key; block may be None on
                                # the whole-SB native path)


class FrameState:
    """Cross-tile output of the parse pass."""

    def __init__(self, seq: H.SequenceHeader, fh: H.FrameHeader):
        self.seq = seq
        self.fh = fh
        mr, mc = fh.mi_rows, fh.mi_cols
        self.mi_rows, self.mi_cols = mr, mc
        u8 = lambda fill=0: np.full((mr, mc), fill, np.uint8)
        self.bsize = u8(255)
        self.y_mode = u8(C.DC_PRED)
        self.uv_mode = u8(C.DC_PRED)
        self.skip = u8()
        self.seg = u8()
        self.tx_w4 = [u8(1), u8(1)]     # per plane class (y, uv)
        self.tx_h4 = [u8(1), u8(1)]
        self.palette_size = u8()
        sb4 = 32 if seq.use_128x128_superblock else 16
        self.cdef_idx = np.full(((mr + 15) >> 4, (mc + 15) >> 4), -1,
                                np.int32)
        self.delta_lf = np.zeros((mr, mc, 4), np.int8)
        # coding-block origin per mi (for deblock block-edge tests)
        self.b_col0 = np.zeros((mr, mc), np.uint16)
        self.b_row0 = np.zeros((mr, mc), np.uint16)
        self.qindex_mi = np.full((mr, mc), fh.base_q_idx, np.uint8)
        self.blocks: list[Block] = []
        self.tbs: list[TransformBlock] = []
        # array-form TB metadata from the whole-SB native parse
        # ((n, 9) int32 chunks + flat coefficient arenas); the
        # object-form tbs list serves the per-block / pure-Python
        # paths.  tb_records() is the canonical view over both.
        self.tbmeta_chunks: list = []
        self.coef_chunks: list = []
        self.coef_count = 0
        # native-recon op arrays, emitted during the parse walk (one
        # row per TB incl. skip blocks); op_of_tb maps each tbs[i]
        # to its global op row so the residual offsets fill in
        # post-transform
        self.recon_ops: list = []          # list of (n, OP_NF) chunks
        self.recon_op_count = 0
        self.op_of_tb: list = []
        # palette payload arena chunks (K_PAL recon ops index these)
        self.pal_chunks: list = []
        self.pal_count = 0
        # intrabc state: DVs in 1/8 luma px + flags for DV
        # prediction, per-mi inter (var-tx) leaf sizes and luma tx
        # types (inter chroma takes the co-located luma tx type)
        self.mvs = np.zeros((mr, mc, 2), np.int32)
        self.is_ibc = u8()
        self.inter_tx = u8()
        self.tx_types = u8()
        # inter-frame per-mi state (av1_inter.py): refs (2, NONE=-1),
        # both mvs, inter flag, interp filters, compound flags, the
        # skip_mode flag and the is-global-mv-block flag used by
        # candidate substitution (7.10.2.7)
        self.ref_frame = np.full((mr, mc, 2), -1, np.int8)
        self.mv2 = np.zeros((mr, mc, 2, 2), np.int32)
        self.is_inter = u8()
        self.interp = np.zeros((mr, mc, 2), np.uint8)
        self.comp_group = u8()
        self.compound_idx = u8()
        self.skip_mode = u8()
        self.gm_flag = u8()
        self.motion_mode_mi = u8()
        # decoder-level inter context, set by the frame driver
        self.motion_field = None     # av1_refs.MotionField
        self.refs = None             # 8-slot RefFrame list
        self.cdf_template = None     # primary-ref loaded CDFs
        self.saved_cdf = None        # frame-end CDF snapshot
        self.force_python = False    # sequence decode: CDF state
                                     # must live in CdfContext
        self.max_luma = [4, 4]    # running MaxLumaW/H (spec)
        # block-origin -> (pal_y, pal_u) for the neighbor palette
        # cache (get_palette_cache); Python path only
        self.pal_colors: dict = {}
        self.sb4 = sb4
        # loop-restoration unit state keyed (plane, unit_row, unit_col)
        self.lr_rtype: dict = {}     # -> RESTORE_* actually used
        self.lr_wiener: dict = {}    # -> [[v0,v1,v2], [h0,h1,h2]]
        self.lr_sgr: dict = {}       # -> (set_idx, [xqd0, xqd1])


def _ceil_log2(x: int) -> int:
    """Spec 4.7 CeilLog2: 0 for x < 2, else smallest i with
    (1 << i) >= x."""
    return 0 if x < 2 else (x - 1).bit_length()


_PAL_CTX_LOOKUP = (-1, -1, 0, -1, -1, 4, 3, 2, 1)
_PAL_WEIGHTS = (2, 1, 2)          # left, above-left, above
_PAL_HASH_MULT = (1, 2, 2)


def _palette_color_context(mp, y, x, n):
    """get_palette_color_context (spec 5.11.50): score the 3 decoded
    neighbors, stable-sort the top 3 colors to the front of the
    order permutation, hash the top scores into one of 5 contexts.
    Returns (ctx, color_order)."""
    pad = max(n, 3)          # top-3 walk reads (zero) scores past n
    scores = [0] * pad
    if x > 0:
        scores[mp[y, x - 1]] += 2
        if y > 0:
            scores[mp[y - 1, x - 1]] += 1
    if y > 0:
        scores[mp[y - 1, x]] += 2
    order = list(range(pad))
    for i in range(3):
        mx_s = scores[i]
        mx_i = i
        for j in range(i + 1, n):
            if scores[j] > mx_s:
                mx_s = scores[j]
                mx_i = j
        if mx_i != i:
            mc = order[mx_i]
            for k in range(mx_i, i, -1):
                scores[k] = scores[k - 1]
                order[k] = order[k - 1]
            scores[i] = mx_s
            order[i] = mc
    ctx = _PAL_CTX_LOOKUP[scores[0] + 2 * scores[1] + 2 * scores[2]]
    assert ctx >= 0
    return ctx, order


def _fs_tb_records(self):
    """Canonical per-TB view over BOTH metadata forms, in decode
    order: yields (plane, x, y, tx_size, tx_type, eob, lossless,
    coeffs (ah, aw) int32).  Differential tests compare parse paths
    through this."""
    for tb in self.tbs:
        yield (tb.plane, tb.x, tb.y, tb.tx_size, tb.tx_type, tb.eob,
               bool(tb.lossless), np.asarray(tb.coeffs))
    if self.tbmeta_chunks:
        coef_all = np.concatenate(self.coef_chunks)
        for chunk in self.tbmeta_chunks:
            for (plane, x, y, tx, off, eob, tt,
                 _op, lossless) in chunk.tolist():
                aw, ah = _TX_W_ADJ[tx], _TX_H_ADJ[tx]
                yield (plane, x, y, tx, tt, eob, bool(lossless),
                       coef_all[off:off + aw * ah].reshape(ah, aw))


FrameState.tb_records = _fs_tb_records

_NATIVE_STATIC = None
_NATIVE_STATIC2 = None


def _native_static2():
    """Static tables for host_av1.c:av1_block_mode (S2_* layout)."""
    global _NATIVE_STATIC2
    if _NATIVE_STATIC2 is not None:
        return _NATIVE_STATIC2
    blob = np.zeros(177, np.int32)
    blob[0:13] = C.INTRA_MODE_CONTEXT
    blob[13:35] = [C.max_tx_size_rect(b) for b in range(22)]
    split = [C.SPLIT_TX_SIZE.get(t, t) for t in range(19)]
    blob[35:54] = split
    blob[54:73] = C.TX_SIZE_SQR_UP[:19]
    blob[73:95] = MAX_TX_DEPTH
    blob[95:114] = C.TX_W[:19]
    blob[114:133] = C.TX_H[:19]
    blob[133:155] = C.BLOCK_W4[:22]
    blob[155:177] = C.BLOCK_H4[:22]
    _NATIVE_STATIC2 = blob
    return _NATIVE_STATIC2


def _native_static():
    """Read-only tables for host_av1.c:av1_block_coeffs, built once
    from the Python single source of truth (layout matches the S_*
    offsets in the C)."""
    global _NATIVE_STATIC
    if _NATIVE_STATIC is not None:
        return _NATIVE_STATIC
    ntx = 19
    blob = np.zeros(303, np.int32)
    scans = []
    scan_off = np.zeros(ntx * 3, np.int32)
    pos = 0
    for tx in range(ntx):
        adj = C.adjusted_tx_size(tx)
        blob[0 + tx] = C.TX_W[tx]
        blob[19 + tx] = C.TX_H[tx]
        blob[38 + tx] = C.TX_W[adj]
        blob[57 + tx] = C.TX_H[adj]
        blob[76 + tx] = C.TX_SIZE_CTX[tx]
        blob[95 + tx] = (C.TX_W[adj].bit_length() - 1) +             (C.TX_H[adj].bit_length() - 1) - 4
        # scans per class kind: 0 default (2D), 1 mrow (VERT),
        # 2 mcol (HORIZ) — representative tx_types 0/V_DCT/H_DCT
        for kind, tt in enumerate((C.DCT_DCT, C.V_DCT, C.H_DCT)):
            sc = np.ascontiguousarray(C.get_scan(tx, tt), np.int32)
            scans.append(sc)
            scan_off[tx * 3 + kind] = pos
            pos += len(sc)
    blob[114:114 + ntx * 3] = scan_off
    off = 171
    for tab in (C.LO_CTX_OFFSETS_SQUARE, C.LO_CTX_OFFSETS_WIDE,
                C.LO_CTX_OFFSETS_TALL):
        blob[off:off + 25] = np.asarray(tab, np.int32).ravel()
        off += 25
    blob[246:246 + 25] = np.asarray(C.SKIP_CONTEXTS, np.int32).ravel()
    blob[271:271 + 16] = [C.tx_type_class(t) for t in range(16)]
    blob[287:287 + 7] = C.TX_TYPE_INTRA_INV_SET1
    blob[295:295 + 5] = C.TX_TYPE_INTRA_INV_SET2
    scan_arena = np.ascontiguousarray(np.concatenate(scans),
                                      np.int32)
    _NATIVE_STATIC = (blob, scan_arena)
    return _NATIVE_STATIC


_NATIVE_STATIC3 = None


def _native_static3():
    """Static tables for host_av1.c:av1_sb_parse (S3_* layout): the
    residual-glue lookups the whole-superblock C driver needs beyond
    the S/S2 blobs, built from the Python single source of truth."""
    global _NATIVE_STATIC3
    if _NATIVE_STATIC3 is not None:
        return _NATIVE_STATIC3
    from ffpic_tpu_torch.formats.av1_recon import (
        _K_SMOOTH, _K_SMOOTH_V, _K_SMOOTH_H, _K_PAETH)
    blob = np.zeros(377, np.int32)
    for b in range(22):
        for sx in (0, 1):
            for sy in (0, 1):
                try:
                    blob[b * 4 + sx * 2 + sy] = \
                        C.max_uv_tx_size(b, sx, sy)
                except KeyError:
                    # combos the Python oracle cannot represent
                    # either (e.g. 64x128 at 4:2:2) stay -1
                    blob[b * 4 + sx * 2 + sy] = -1
    sub = np.full((10, 22), -1, np.int32)
    squares = [C.block_from_dims(w, w) for w in (2, 4, 8, 16, 32)]
    for part in range(10):
        for b in squares:
            try:
                sub[part, b] = C.partition_subsize(part, b)
            except KeyError:
                pass      # illegal pair (e.g. VERT_4 at 128x128):
                          # the partition symbol can never select it
    blob[88:308] = sub.ravel()
    for m, a in C.MODE_TO_ANGLE.items():
        blob[308 + m] = a
    blob[321:326] = C.FIMODE_TO_INTRA_DIR
    blob[326:340] = C.INTRA_MODE_TO_TX_TYPE
    for ts in range(3):
        mask = 0
        for tt in range(16):
            if C.tx_type_in_set(ts, tt):
                mask |= 1 << tt
        blob[340 + ts] = mask
    blob[343:362] = C.TX_SIZE_SQR[:19]
    blob[362 + C.SMOOTH_PRED] = _K_SMOOTH
    blob[362 + C.SMOOTH_V_PRED] = _K_SMOOTH_V
    blob[362 + C.SMOOTH_H_PRED] = _K_SMOOTH_H
    blob[362 + C.PAETH_PRED] = _K_PAETH
    blob[375] = C.BLOCK_8X8
    blob[376] = C.BLOCK_128X128
    # ---- intrabc extensions (S3_NF grows; layout in host_av1.c)
    ext = np.zeros(377 + 64, np.int32)
    ext[:377] = blob
    # inter tx-type inverse sets (377..407)
    ext[377:377 + 16] = C.TX_TYPE_INTER_INV_SET1
    ext[393:393 + 12] = C.TX_TYPE_INTER_INV_SET2
    ext[405:405 + 2] = C.TX_TYPE_INTER_INV_SET3
    # inter tx-type in-set masks per set 0..3 (407..410)
    for ts in range(4):
        mask = 0
        for tt in range(16):
            if C.tx_type_in_set_inter(ts, tt):
                mask |= 1 << tt
        ext[407 + ts] = mask
    # square-tx -> square BLOCK enum (411..415, txfm_split ctx)
    ext[411:416] = _TX_TO_BSIZE
    _NATIVE_STATIC3 = ext
    return _NATIVE_STATIC3


# SBP_* field order (must match the C enum in host_av1.c)
_SBP_NF = 36

# adjusted coefficient dims per tx size (64-pt txs keep 32 coeffs)
_TX_W_ADJ = [C.TX_W[C.adjusted_tx_size(t)] for t in range(19)]
_TX_H_ADJ = [C.TX_H[C.adjusted_tx_size(t)] for t in range(19)]


class TileDecoder:
    def __init__(self, fs: FrameState, data: bytes,
                 mi_row_start, mi_row_end, mi_col_start, mi_col_end):
        self.fs = fs
        self.seq = fs.seq
        self.fh = fs.fh
        self.m = Msac(data,
                      allow_update=not fs.fh.disable_cdf_update)
        if fs.cdf_template is not None:
            # inter sequences: CDFs loaded from the primary ref (or
            # the frame driver's defaults snapshot)
            self.cdf = fs.cdf_template._clone()
        else:
            self.cdf = fresh_cdf(qctx_for_base_q(fs.fh.base_q_idx))
        t = self.cdf.tables
        # expand the shared delta_lf default into independent cdfs
        # (carried on the context so frame-end CDF save sees the
        # adapted state — see save_tile_cdfs)
        if getattr(self.cdf, "delta_lf_single", None) is None:
            self.cdf.delta_lf_single = [list(t["delta_lf"][0])]
            self.cdf.delta_lf_multi = [list(t["delta_lf"][1])
                                       for _ in range(4)]
        self.delta_lf_single = self.cdf.delta_lf_single
        self.delta_lf_multi = self.cdf.delta_lf_multi
        self.r0, self.r1 = mi_row_start, mi_row_end
        self.c0, self.c1 = mi_col_start, mi_col_end
        # above context arrays span the tile columns; left arrays span
        # one superblock and reset per sb row
        mc = fs.mi_cols
        sb4 = fs.sb4
        nplanes = fs.seq.num_planes
        self.a_coef = [np.zeros(mc + 32, np.uint8)
                       for _ in range(nplanes)]
        self.l_coef = [np.zeros(sb4 + 32, np.uint8)
                       for _ in range(nplanes)]
        self.a_txw = np.full(mc + 32, 64, np.int16)
        self.l_txh = np.full(sb4 + 32, 64, np.int16)
        self.current_qindex = fs.fh.base_q_idx
        self.cur_delta_lf = [0, 0, 0, 0]
        self.read_deltas = False
        # loop-restoration prediction refs, reset per tile (spec
        # clear_loop_restoration, 7.4)
        self.lr_ref_wiener = [[list(C.WIENER_TAPS_MID) for _ in range(2)]
                              for _ in range(nplanes)]
        self.lr_ref_sgr = [list(C.SGRPROJ_XQD_MID)
                           for _ in range(nplanes)]
        # native coefficient decode (host_av1.c) shares the CDF
        # arenas; FrameState.force_python pins the pure-Python oracle
        # intrabc is implemented in the whole-SB C driver only; the
        # per-block C path routes allow_intrabc frames to Python
        # inter frames (and any frame decoded with a loaded CDF
        # template, i.e. inside a sequence) run the pure-Python
        # symbol path: the native parser adapts its own CDF arenas
        # which would not survive into the frame-end CDF save
        self._use_native = (fs.fh.frame_is_intra
                            and fs.cdf_template is None
                            and not fs.force_python
                            and not (fs.fh.allow_intrabc and
                                     os.environ.get(
                                         "FFPIC_AV1_BLOCK_NATIVE")))
        self._dv_cdfs = None
        # segmentation temporal-prediction contexts (spec: above
        # cleared per tile, left per superblock row)
        self.above_seg_pred = np.zeros(fs.mi_cols + 32, np.uint8)
        self.left_seg_pred = np.zeros(fs.mi_rows + 32, np.uint8)
        # above/left neighbor palette line buffers for the C parse
        # (counts u8 [n][2] y/u, colors u16 [n][16] = 8 y + 8 u);
        # last-writer-wins per column/row IS the (r-1,c)/(r,c-1)
        # neighbor in decode order — the Python oracle keeps its
        # origin-grid + dict form instead
        self.pal_above_n = np.zeros(2 * mc, np.uint8)
        self.pal_above_c = np.zeros(16 * mc, np.uint16)
        self.pal_left_n = np.zeros(2 * fs.mi_rows, np.uint8)
        self.pal_left_c = np.zeros(16 * fs.mi_rows, np.uint16)
        self._mstate = np.zeros(5, np.int64)
        self._dq_cache: dict = {}
        self._ptrs = None
        self._mode_ptrs = None
        self._cur_sb = None       # superblock tracker (BlockDecoded
        self._pp_scratch = [None] * 3    # bitmaps live in C buffers)
        # whole-superblock C driver (partition walk + mode + residual
        # fused, av1_sb_parse); FFPIC_AV1_BLOCK_NATIVE pins the
        # per-block C path for differential testing
        self._sb_native = (self._use_native and not os.environ.get(
            "FFPIC_AV1_BLOCK_NATIVE"))
        self._x_ptrs = None
        self._sbp = None

    # ---------------------------------------------------------- helpers
    def sym(self, cdf) -> int:
        return self.m.decode_symbol(cdf)

    def boolean(self) -> int:
        return self.m.decode_bool(1 << 14)

    def literal(self, n: int) -> int:
        return self.m.decode_literal(n)

    def _golomb(self) -> int:
        """Spec read_golomb: zero-run prefix then that many bits."""
        length = 0
        while not self.literal(1):
            length += 1
            if length > 31:
                break
        x = 1
        for _ in range(length):
            x = (x << 1) | self.literal(1)
        return x - 1

    # ---------------------------------------------------------- tile loop
    def decode(self):
        fs = self.fs
        sb4 = fs.sb4
        sb_bsize = C.BLOCK_128X128 if sb4 == 32 else C.BLOCK_64X64
        for r in range(self.r0, self.r1, sb4):
            for p in range(len(self.l_coef)):
                self.l_coef[p][:] = 0
            self.l_txh[:] = 64
            self.left_seg_pred[:] = 0
            self.sb_row = r
            for c in range(self.c0, self.c1, sb4):
                self.read_deltas = (self.fh.delta_q_present or
                                    self.fh.delta_lf_present)
                self._read_lr(r, c)
                if self._sb_native:
                    self._decode_sb_native(r, c)
                else:
                    self.decode_partition(r, c, sb_bsize)

    # ----------------------------------------------------- loop restoration
    def _read_lr(self, r, c):
        """Spec 5.11.57 read_lr: per-superblock loop-restoration unit
        syntax.  The reference decoder has no AV1 support at all; the
        analogous HEVC syntax walk lives in hevc_slice.py."""
        fh, fs, seq = self.fh, self.fs, self.seq
        if fh.allow_intrabc or not getattr(fh, "uses_lr", False):
            return
        w4 = h4 = fs.sb4
        for plane in range(seq.num_planes):
            if fh.lr_type[plane] == H.RESTORE_NONE:
                continue
            sx = seq.subsampling_x if plane else 0
            sy = seq.subsampling_y if plane else 0
            unit = fh.lr_unit_size[plane]
            ph = (fh.height + sy) >> sy
            pw = (fh.width + sx) >> sx
            unit_rows = C.count_units_in_frame(unit, ph)
            unit_cols = C.count_units_in_frame(unit, pw)
            ur0 = (r * (4 >> sy) + unit - 1) // unit
            ur1 = min(unit_rows,
                      ((r + h4) * (4 >> sy) + unit - 1) // unit)
            uc0 = (c * (4 >> sx) + unit - 1) // unit
            uc1 = min(unit_cols,
                      ((c + w4) * (4 >> sx) + unit - 1) // unit)
            for ur in range(ur0, ur1):
                for uc in range(uc0, uc1):
                    self._read_lr_unit(plane, ur, uc)

    def _subexp_ref(self, low, high, k, ref):
        """decode_signed_subexp_with_ref_bool (spec 5.11.61-63)."""
        mx = high - low
        r = ref - low
        v = self.m.decode_subexp(mx, k)
        if (r << 1) <= mx:
            x = _inverse_recenter(r, v)
        else:
            x = mx - 1 - _inverse_recenter(mx - 1 - r, v)
        return x + low

    def _read_lr_unit(self, plane, ur, uc):
        """Spec 5.11.58 read_lr_unit."""
        fh, fs = self.fh, self.fs
        t = self.cdf
        ftype = fh.lr_type[plane]
        if ftype == H.RESTORE_WIENER:
            use = self.m.decode_bool_adapt(t["restore_wiener"][0])
            rtype = H.RESTORE_WIENER if use else H.RESTORE_NONE
        elif ftype == H.RESTORE_SGRPROJ:
            use = self.m.decode_bool_adapt(t["restore_sgrproj"][0])
            rtype = H.RESTORE_SGRPROJ if use else H.RESTORE_NONE
        else:
            rtype = (H.RESTORE_NONE, H.RESTORE_WIENER,
                     H.RESTORE_SGRPROJ)[
                self.sym(t["restore_switchable"][0])]
        fs.lr_rtype[(plane, ur, uc)] = rtype
        if rtype == H.RESTORE_WIENER:
            taps = [[0, 0, 0], [0, 0, 0]]
            for p in range(2):
                first = 1 if plane else 0
                for j in range(first, 3):
                    v = self._subexp_ref(
                        C.WIENER_TAPS_MIN[j], C.WIENER_TAPS_MAX[j] + 1,
                        C.WIENER_TAPS_K[j],
                        self.lr_ref_wiener[plane][p][j])
                    taps[p][j] = v
                    self.lr_ref_wiener[plane][p][j] = v
            fs.lr_wiener[(plane, ur, uc)] = taps
        elif rtype == H.RESTORE_SGRPROJ:
            set_idx = self.literal(4)
            xqd = [0, 0]
            for i in range(2):
                radius = C.SGR_PARAMS[set_idx][i * 2]
                lo = C.SGRPROJ_XQD_MIN[i]
                hi = C.SGRPROJ_XQD_MAX[i]
                if radius:
                    v = self._subexp_ref(lo, hi + 1,
                                         C.SGRPROJ_PRJ_SUBEXP_K,
                                         self.lr_ref_sgr[plane][i])
                else:
                    v = 0
                    if i == 1:
                        v = min(hi, max(lo, (1 << C.SGRPROJ_PRJ_BITS) -
                                        self.lr_ref_sgr[plane][0]))
                xqd[i] = v
                self.lr_ref_sgr[plane][i] = v
            fs.lr_sgr[(plane, ur, uc)] = (set_idx, xqd)

    # ---------------------------------------------------------- partitions
    def _partition_ctx(self, r, c, bsize):
        fs = self.fs
        wlog = (C.BLOCK_W4[bsize]).bit_length() - 1
        hlog = (C.BLOCK_H4[bsize]).bit_length() - 1
        above = 0
        if r > self.r0:
            nb = fs.bsize[r - 1, c]
            if nb != 255 and (C.BLOCK_W4[nb]).bit_length() - 1 < wlog:
                above = 1
        left = 0
        if c > self.c0:
            nb = fs.bsize[r, c - 1]
            if nb != 255 and (C.BLOCK_H4[nb]).bit_length() - 1 < hlog:
                left = 1
        return left * 2 + above, wlog

    @staticmethod
    def _gather(cdf, syms):
        """Sum P(sym) over syms from an inverted-cdf list.  Symbols
        past the family's alphabet (the extended-partition kinds on
        an 8x8 node, which only codes NONE/H/V/SPLIT) have zero
        probability and are skipped — 8x8 frame-edge nodes exist for
        odd-mi frames (e.g. 75px wide -> 19 mi cols)."""
        n = len(cdf) - 1
        total = 0
        for s in syms:
            if s >= n:
                continue
            hi = 32768 if s == 0 else cdf[s - 1]
            lo = 0 if s == n - 1 else cdf[s]
            total += hi - lo
        return total

    def decode_partition(self, r, c, bsize):
        fs = self.fs
        if r >= fs.mi_rows or c >= fs.mi_cols:
            return
        w4 = C.BLOCK_W4[bsize]
        half = w4 >> 1
        quarter = w4 >> 2
        has_rows = (r + half) < fs.mi_rows
        has_cols = (c + half) < fs.mi_cols
        P = C
        if bsize < C.BLOCK_8X8:
            part = C.PARTITION_NONE
        else:
            ctx, wlog = self._partition_ctx(r, c, bsize)
            cdf = self.cdf["partition"][wlog - 1][ctx]
            if has_rows and has_cols:
                part = self.sym(cdf)
            elif has_cols:
                syms = [P.PARTITION_VERT, P.PARTITION_SPLIT,
                        P.PARTITION_VERT_A, P.PARTITION_VERT_B,
                        P.PARTITION_HORZ_A]
                if bsize != C.BLOCK_128X128:
                    syms.append(P.PARTITION_VERT_4)
                psplit = self._gather(cdf, syms)
                part = (C.PARTITION_SPLIT
                        if self.m.decode_bool(max(1, psplit))
                        else C.PARTITION_HORZ)
            elif has_rows:
                syms = [P.PARTITION_HORZ, P.PARTITION_SPLIT,
                        P.PARTITION_HORZ_A, P.PARTITION_HORZ_B,
                        P.PARTITION_VERT_A]
                if bsize != C.BLOCK_128X128:
                    syms.append(P.PARTITION_HORZ_4)
                psplit = self._gather(cdf, syms)
                part = (C.PARTITION_SPLIT
                        if self.m.decode_bool(max(1, psplit))
                        else C.PARTITION_VERT)
            else:
                part = C.PARTITION_SPLIT
        blk = self.decode_block
        if part == C.PARTITION_NONE:
            blk(r, c, bsize)
            return
        sub = C.partition_subsize(part, bsize)
        split = C.partition_subsize(C.PARTITION_SPLIT, bsize)
        if part == C.PARTITION_HORZ:
            blk(r, c, sub)
            if has_rows:
                blk(r + half, c, sub)
        elif part == C.PARTITION_VERT:
            blk(r, c, sub)
            if has_cols:
                blk(r, c + half, sub)
        elif part == C.PARTITION_SPLIT:
            self.decode_partition(r, c, sub)
            self.decode_partition(r, c + half, sub)
            self.decode_partition(r + half, c, sub)
            self.decode_partition(r + half, c + half, sub)
        elif part == C.PARTITION_HORZ_A:
            blk(r, c, split)
            blk(r, c + half, split)
            blk(r + half, c, sub)
        elif part == C.PARTITION_HORZ_B:
            blk(r, c, sub)
            blk(r + half, c, split)
            blk(r + half, c + half, split)
        elif part == C.PARTITION_VERT_A:
            blk(r, c, split)
            blk(r + half, c, split)
            blk(r, c + half, sub)
        elif part == C.PARTITION_VERT_B:
            blk(r, c, sub)
            blk(r, c + half, split)
            blk(r + half, c + half, split)
        elif part == C.PARTITION_HORZ_4:
            for i in range(4):
                rr = r + i * quarter
                if i > 0 and rr >= fs.mi_rows:
                    break
                blk(rr, c, sub)
        elif part == C.PARTITION_VERT_4:
            for i in range(4):
                cc = c + i * quarter
                if i > 0 and cc >= fs.mi_cols:
                    break
                blk(r, cc, sub)

    # ---------------------------------------------------------- block
    def decode_block(self, r, c, bsize):
        fs = self.fs
        seq, fh = self.seq, self.fh
        bw4, bh4 = C.BLOCK_W4[bsize], C.BLOCK_H4[bsize]
        b = Block()
        b.mi_row, b.mi_col, b.bsize = r, c, bsize
        avail_u = r > self.r0
        avail_l = c > self.c0
        sx, sy = seq.subsampling_x, seq.subsampling_y
        b.has_chroma = (seq.num_planes > 1 and
                        (bw4 != 1 or sx == 0 or (c & 1)) and
                        (bh4 != 1 or sy == 0 or (r & 1)))
        b.avail_u, b.avail_l = avail_u, avail_l
        b.avail_uc, b.avail_lc = avail_u, avail_l
        if b.has_chroma:
            if sy and bh4 == 1:
                b.avail_uc = (r - 2) >= self.r0
            if sx and bw4 == 1:
                b.avail_lc = (c - 2) >= self.c0
        b.tile = (self.r0, self.r1, self.c0, self.c1)
        b.coeff_map = {}
        re = min(r + bh4, fs.mi_rows)
        ce = min(c + bw4, fs.mi_cols)

        if self._use_native:
            self._decode_block_mode_native(r, c, bsize, b)
            fs.delta_lf[r:re, c:ce] = np.array(self.cur_delta_lf,
                                               np.int8)
            self._record_block(r, c, re, ce, bsize, b)
            self._residual(r, c, b)
            return

        if not fh.frame_is_intra:
            self._decode_block_interframe(r, c, bsize, b, re, ce)
            return

        # --- segment id (pre-skip variant)
        b.seg_id = 0
        if fh.segmentation_enabled and fh.seg_id_pre_skip:
            b.seg_id = self._read_segment_id(r, c, re, ce, False)
        # --- skip
        ctx = 0
        if avail_u and fs.skip[r - 1, c]:
            ctx += 1
        if avail_l and fs.skip[r, c - 1]:
            ctx += 1
        b.skip = self.sym(self.cdf["skip"][ctx])
        # --- segment id (post-skip variant)
        if fh.segmentation_enabled and not fh.seg_id_pre_skip:
            b.seg_id = self._read_segment_id(r, c, re, ce, b.skip)
        # --- cdef
        self._read_cdef(r, c, bsize, b.skip)
        # --- delta q / lf
        self._read_deltas(r, c, bsize, b.skip)
        b.qindex = self.current_qindex
        fs.delta_lf[r:re, c:ce] = np.array(self.cur_delta_lf,
                                           np.int8)
        # --- intrabc (spec 5.11.21 read_intrabc_info): DC modes, a
        # predicted+residual DV, inter-style var-tx and tx types;
        # prediction is a whole-pel block copy from the decoded frame
        if fh.allow_intrabc:
            if self.sym(self.cdf["intrabc"][0]):
                from ffpic_tpu_torch.coding import av1_mv as MV
                b.use_intrabc = True
                b.y_mode = C.DC_PRED
                b.uv_mode = C.DC_PRED
                if self._dv_cdfs is None:
                    self._dv_cdfs = MV.DvCdfs(self.cdf.tables)
                pred = MV.find_dv_pred(fs, self, b, fs.sb4)
                b.mv = MV.read_dv(self.m, self._dv_cdfs, pred)
                self._record_block(r, c, re, ce, bsize, b)
                self._read_block_tx_size_inter(r, c, re, ce, b)
                self._residual(r, c, b)
                return
        self._intra_mode_info(r, c, bsize, b, kf=True)
        # --- record mode info + tx size + residual
        self._record_block(r, c, re, ce, bsize, b)
        self._read_tx_size(r, c, re, ce, b)
        self._residual(r, c, b)

    def _intra_mode_info(self, r, c, bsize, b, kf: bool):
        """Intra mode syntax shared between key/intra frames (kf
        y-mode cdf keyed by neighbor modes) and intra blocks inside
        inter frames (y_mode cdf keyed by Size_Group, spec
        5.11.20)."""
        fs, seq, fh = self.fs, self.seq, self.fh
        avail_u, avail_l = b.avail_u, b.avail_l
        bw4, bh4 = C.BLOCK_W4[bsize], C.BLOCK_H4[bsize]
        sx, sy = seq.subsampling_x, seq.subsampling_y
        # --- y mode
        if kf:
            am = fs.y_mode[r - 1, c] if avail_u else C.DC_PRED
            lm = fs.y_mode[r, c - 1] if avail_l else C.DC_PRED
            am = am if am < 13 else C.DC_PRED   # inter-mode nbrs
            lm = lm if lm < 13 else C.DC_PRED
            cdf = self.cdf["kf_y_mode"][C.INTRA_MODE_CONTEXT[am]][
                C.INTRA_MODE_CONTEXT[lm]]
        else:
            cdf = self.cdf["y_mode"][C.SIZE_GROUP[bsize]]
        b.y_mode = self.sym(cdf)
        if bsize >= C.BLOCK_8X8 and b.y_mode in C.MODE_TO_ANGLE:
            b.angle_y = self.sym(
                self.cdf["angle_delta"][b.y_mode - C.V_PRED]) - \
                MAX_ANGLE_DELTA
        # --- uv mode
        if b.has_chroma:
            # CfL gate: <=32px blocks, EXCEPT lossless where only
            # 4x4 blocks may use CfL (the chroma TB is forced to
            # 4x4, so larger blocks cannot derive CfL from the
            # co-located luma TB) — dav1d cfl_allowed; found via the
            # lossless conformance campaign (aom+dav1d cross-oracle)
            if fh.lossless_segs[b.seg_id]:
                cfl_allowed = (C.BLOCK_W4[bsize] <= (1 << sx) and
                               C.BLOCK_H4[bsize] <= (1 << sy))
            else:
                cfl_allowed = (C.BLOCK_W4[bsize] * 4 <= 32 and
                               C.BLOCK_H4[bsize] * 4 <= 32)
            b.uv_mode = self.sym(
                self.cdf["uv_mode"][1 if cfl_allowed else 0][
                    b.y_mode])
            if b.uv_mode == C.UV_CFL_PRED:
                self._read_cfl(b)
            if bsize >= C.BLOCK_8X8 and b.uv_mode in C.MODE_TO_ANGLE:
                b.angle_uv = self.sym(
                    self.cdf["angle_delta"][b.uv_mode - C.V_PRED]) \
                    - MAX_ANGLE_DELTA
        # --- palette (spec 5.11.42/45/46; validated bit-exact vs
        # dav1d — the C reference has no AV1 layer at all)
        if (fh.allow_screen_content_tools and
                bsize >= C.BLOCK_8X8 and bw4 * 4 <= 64 and
                bh4 * 4 <= 64):
            bctx = (C.BLOCK_W4[bsize] * 4).bit_length() + \
                (C.BLOCK_H4[bsize] * 4).bit_length() - 8
            if b.y_mode == C.DC_PRED:
                pal_ctx = 0
                if avail_u and fs.palette_size[r - 1, c]:
                    pal_ctx += 1
                if avail_l and fs.palette_size[r, c - 1]:
                    pal_ctx += 1
                if self.sym(
                        self.cdf["palette_y_mode"][bctx][pal_ctx]):
                    sz = self.sym(
                        self.cdf["palette_y_size"][bctx]) + 2
                    b.pal_y = self._read_palette_plane(
                        r, c, 0, sz, avail_u, avail_l)
            if b.has_chroma and b.uv_mode == C.DC_PRED:
                uv_ctx = 1 if b.pal_y else 0
                if self.sym(
                        self.cdf["palette_uv_mode"][uv_ctx]):
                    sz = self.sym(
                        self.cdf["palette_uv_size"][bctx]) + 2
                    b.pal_u = self._read_palette_plane(
                        r, c, 1, sz, avail_u, avail_l)
                    b.pal_v = self._read_palette_v(sz)
        # --- filter intra (palette-y excludes it, spec 5.11.42)
        if (seq.enable_filter_intra and b.y_mode == C.DC_PRED and
                not b.pal_y and max(bw4, bh4) * 4 <= 32):
            if self.sym(self.cdf["use_filter_intra"][bsize]):
                b.filter_intra_mode = self.sym(
                    self.cdf["filter_intra_mode"][0])
        # --- palette index maps (spec palette_tokens, after full
        # mode info, before tx size)
        if b.pal_y:
            b.pal_map_y = self._read_palette_map(b, False)
        if b.pal_u:
            b.pal_map_uv = self._read_palette_map(b, True)

    def _decode_block_interframe(self, r, c, bsize, b, re, ce):
        """Spec 5.11.15 inter_frame_mode_info + tx/residual for one
        block of an INTER/INTRA_ONLY/SWITCH frame (Python path)."""
        from ffpic_tpu_torch.coding import av1_inter as I
        fs, fh = self.fs, self.fh
        b.seg_id = 0
        if fh.segmentation_enabled and fh.seg_id_pre_skip:
            I.read_segment_id_inter(self, b, r, c, re, ce, True)
        b.skip_mode = bool(I.read_skip_mode(self, b, r, c))
        if b.skip_mode:
            b.skip = 1
        else:
            ctx = 0
            if b.avail_u and fs.skip[r - 1, c]:
                ctx += 1
            if b.avail_l and fs.skip[r, c - 1]:
                ctx += 1
            b.skip = self.sym(self.cdf["skip"][ctx])
        if fh.segmentation_enabled and not fh.seg_id_pre_skip:
            I.read_segment_id_inter(self, b, r, c, re, ce, False)
        self._read_cdef(r, c, bsize, b.skip)
        self._read_deltas(r, c, bsize, b.skip)
        b.qindex = self.current_qindex
        fs.delta_lf[r:re, c:ce] = np.array(self.cur_delta_lf,
                                           np.int8)
        b.is_inter = bool(I.read_is_inter(self, b, r, c))
        if b.is_inter:
            I.inter_block_mode_info(self, b, r, c)
            self._record_block(r, c, re, ce, bsize, b)
            self._read_block_tx_size_inter(r, c, re, ce, b)
        else:
            b.refs = [C.INTRA_FRAME, C.NONE_FRAME]
            self._intra_mode_info(r, c, bsize, b, kf=False)
            self._record_block(r, c, re, ce, bsize, b)
            self._read_tx_size(r, c, re, ce, b)
        self._residual(r, c, b)

    def _record_block(self, r, c, re, ce, bsize, b):
        fs, seq = self.fs, self.seq
        bw4, bh4 = C.BLOCK_W4[bsize], C.BLOCK_H4[bsize]
        fs.bsize[r:re, c:ce] = bsize
        fs.b_col0[r:re, c:ce] = c
        fs.b_row0[r:re, c:ce] = r
        fs.y_mode[r:re, c:ce] = b.y_mode
        if b.has_chroma:
            # propagate over the full chroma-covering mi extent so
            # chroma-neighbor lookups (e.g. get_filter_type) see the
            # pair's uv mode on 4xN/Nx4 sub-8x8 partners too
            sx, sy = seq.subsampling_x, seq.subsampling_y
            fs.uv_mode[r - (r & (sy & (bh4 == 1))):re,
                       c - (c & (sx & (bw4 == 1))):ce] = b.uv_mode
        fs.skip[r:re, c:ce] = b.skip
        fs.seg[r:re, c:ce] = b.seg_id
        fs.qindex_mi[r:re, c:ce] = self._block_qindex(b)
        fs.palette_size[r:re, c:ce] = len(b.pal_y)
        if b.pal_y or b.pal_u:
            fs.pal_colors[(r, c)] = (b.pal_y, b.pal_u)
        if b.use_intrabc:
            fs.is_ibc[r:re, c:ce] = 1
            fs.mvs[r:re, c:ce, 0] = b.mv[0]
            fs.mvs[r:re, c:ce, 1] = b.mv[1]
        if not self.fh.frame_is_intra:
            fs.ref_frame[r:re, c:ce, 0] = b.refs[0]
            fs.ref_frame[r:re, c:ce, 1] = b.refs[1]
            fs.is_inter[r:re, c:ce] = int(b.is_inter)
            fs.skip_mode[r:re, c:ce] = int(b.skip_mode)
            if b.is_inter:
                fs.mv2[r:re, c:ce, 0] = b.mvs2[0]
                fs.mv2[r:re, c:ce, 1] = b.mvs2[1]
                fs.interp[r:re, c:ce, 0] = b.interp[0]
                fs.interp[r:re, c:ce, 1] = b.interp[1]
                fs.comp_group[r:re, c:ce] = b.comp_group_idx
                fs.compound_idx[r:re, c:ce] = b.compound_idx
                fs.motion_mode_mi[r:re, c:ce] = b.motion_mode
                fs.gm_flag[r:re, c:ce] = int(
                    b.y_mode in (C.GLOBALMV, C.GLOBAL_GLOBALMV) and
                    min(bw4, bh4) * 4 >= 8)
        fs.blocks.append(b)

    def _block_qindex(self, b) -> int:
        fh = self.fh
        q = H.get_qindex(fh, b.seg_id, b.qindex)
        return q

    # ------------------------------------------------------- segment id
    def _read_segment_id(self, r, c, re, ce, skip):
        fs = self.fs
        fh = self.fh
        pu = int(fs.seg[r - 1, c]) if r > self.r0 else -1
        pl = int(fs.seg[r, c - 1]) if c > self.c0 else -1
        pul = int(fs.seg[r - 1, c - 1]) \
            if (r > self.r0 and c > self.c0) else -1
        if pu == -1:
            pred = 0 if pl == -1 else pl
        elif pl == -1:
            pred = pu
        else:
            pred = pu if pul == pu else pl
        if skip:
            return pred
        if pul >= 0 and pul == pu and pul == pl:
            ctx = 2
        elif pul >= 0 and (pul == pu or pul == pl or pu == pl):
            ctx = 1
        else:
            ctx = 0
        diff = self.sym(self.cdf["spatial_seg"][ctx])
        seg = _neg_deinterleave(diff, pred,
                                fh.last_active_seg_id + 1)
        return max(0, min(fh.last_active_seg_id, seg))

    # ------------------------------------------------------------- cdef
    def _read_cdef(self, r, c, bsize, skip):
        """Spec 5.11.56 read_cdef: ONE cdef_idx literal per block,
        anchored at its 64x64-aligned corner and propagated over every
        64x64 unit the block covers — a >64 block (e.g. unpartitioned
        128x128) still reads a single symbol (reading per-unit
        over-consumes 3x cdef_bits and desyncs at the first such
        block)."""
        fh, fs = self.fh, self.fs
        if (skip or fh.coded_lossless or not self.seq.enable_cdef or
                fh.allow_intrabc):
            return
        r1, c1 = r >> 4, c >> 4
        if fs.cdef_idx[r1, c1] < 0:
            v = self.literal(fh.cdef_bits)
            bw4, bh4 = C.BLOCK_W4[bsize], C.BLOCK_H4[bsize]
            re = min(((r & ~15) + bh4 + 15) >> 4, fs.cdef_idx.shape[0])
            ce = min(((c & ~15) + bw4 + 15) >> 4, fs.cdef_idx.shape[1])
            fs.cdef_idx[r1:re, c1:ce] = v

    # ----------------------------------------------------------- deltas
    def _read_deltas(self, r, c, bsize, skip):
        fh = self.fh
        if not self.read_deltas:
            return
        sb_bsize = C.BLOCK_128X128 if self.fs.sb4 == 32 else \
            C.BLOCK_64X64
        if bsize == sb_bsize and skip:
            return
        self.read_deltas = False
        if fh.delta_q_present:
            dq_abs = self.sym(self.cdf["delta_q"][0])
            if dq_abs == DELTA_Q_SMALL:
                rem_bits = self.literal(3) + 1
                dq_abs = self.literal(rem_bits) + \
                    (1 << rem_bits) + 1
            if dq_abs:
                sign = self.boolean()
                delta = -dq_abs if sign else dq_abs
                self.current_qindex = max(1, min(255,
                    self.current_qindex +
                    (delta << fh.delta_q_res)))
        if fh.delta_lf_present:
            n = 4 if self.seq.num_planes > 1 else 2
            count = n if fh.delta_lf_multi else 1
            for i in range(count):
                cdf = (self.delta_lf_multi[i] if fh.delta_lf_multi
                       else self.delta_lf_single[0])
                lf_abs = self.sym(cdf)
                if lf_abs == DELTA_LF_SMALL:
                    rem_bits = self.literal(3) + 1
                    lf_abs = self.literal(rem_bits) + \
                        (1 << rem_bits) + 1
                if lf_abs:
                    sign = self.boolean()
                    delta = -lf_abs if sign else lf_abs
                    v = self.cur_delta_lf[i] + \
                        (delta << fh.delta_lf_res)
                    v = max(-63, min(63, v))
                    if fh.delta_lf_multi:
                        self.cur_delta_lf[i] = v
                    else:
                        self.cur_delta_lf = [v] * 4

    # -------------------------------------------------------------- cfl
    def _read_cfl(self, b):
        joint = self.sym(self.cdf["cfl_sign"][0])
        sign_u = (joint + 1) // 3
        sign_v = (joint + 1) % 3
        if sign_u != 0:
            idx = self.sym(self.cdf["cfl_alpha"][joint - 2])
            b.cfl_alpha_u = (idx + 1) * (1 if sign_u == 2 else -1)
        if sign_v != 0:
            ctx = sign_v * 3 + sign_u - 3
            idx = self.sym(self.cdf["cfl_alpha"][ctx])
            b.cfl_alpha_v = (idx + 1) * (1 if sign_v == 2 else -1)

    # ---------------------------------------------------------- tx size
    def _read_tx_size(self, r, c, re, ce, b):
        fs, fh = self.fs, self.fh
        lossless = fh.lossless_segs[b.seg_id]
        if lossless:
            b.tx_size = C.TX_4X4
        else:
            max_rect = C.max_tx_size_rect(b.bsize)
            b.tx_size = max_rect
            if (fh.tx_mode == H.TX_MODE_SELECT and
                    b.bsize > C.BLOCK_4X4 and not b.skip):
                max_depth = MAX_TX_DEPTH[b.bsize]
                cat = C.TX_SIZE_SQR_UP[max_rect] - 1
                maxw = C.TX_W[max_rect]
                maxh = C.TX_H[max_rect]
                above = int(self.a_txw[c]) >= maxw
                left = int(self.l_txh[r & (fs.sb4 - 1)]) >= maxh
                # libaom get_tx_size_context: an INTER (or intrabc)
                # neighbor contributes its BLOCK dimension, not its
                # stored txfm context (its var-tx sizes are smaller
                # than the block; the ctx still counts it as "max")
                if b.avail_u and (fs.is_inter[r - 1, c] or
                                  fs.is_ibc[r - 1, c]):
                    above = C.BLOCK_W4[fs.bsize[r - 1, c]] * 4 >= maxw
                if b.avail_l and (fs.is_inter[r, c - 1] or
                                  fs.is_ibc[r, c - 1]):
                    left = C.BLOCK_H4[fs.bsize[r, c - 1]] * 4 >= maxh
                if r > self.r0 and c > self.c0:
                    ctx = above + left
                elif r > self.r0:
                    ctx = above
                elif c > self.c0:
                    ctx = left
                else:
                    ctx = 0
                depth = self.sym(self.cdf["tx_depth"][cat][ctx])
                for _ in range(depth):
                    b.tx_size = C.SPLIT_TX_SIZE[b.tx_size]
        self.a_txw[c:ce] = C.TX_W[b.tx_size]
        self.l_txh[(r & (fs.sb4 - 1)):(r & (fs.sb4 - 1)) + (re - r)] \
            = C.TX_H[b.tx_size]
        fs.tx_w4[0][r:re, c:ce] = C.TX_W[b.tx_size] >> 2
        fs.tx_h4[0][r:re, c:ce] = C.TX_H[b.tx_size] >> 2

    # --------------------------------------- inter (intrabc) tx sizes
    def _read_block_tx_size_inter(self, r, c, re, ce, b):
        """read_block_tx_size for is_inter (intrabc) blocks: the
        recursive var-tx tree (txfm_split flags) when TX_MODE_SELECT
        and coded, else the largest rect with block-dim ctx updates
        for skip (aom set_txfm_ctxs skip rule)."""
        fs, fh = self.fs, self.fh
        lossless = fh.lossless_segs[b.seg_id]
        bw4, bh4 = C.BLOCK_W4[b.bsize], C.BLOCK_H4[b.bsize]
        lb = r & (fs.sb4 - 1)
        if (fh.tx_mode == H.TX_MODE_SELECT and
                b.bsize > C.BLOCK_4X4 and not b.skip and
                not lossless):
            max_tx = C.max_tx_size_rect(b.bsize)
            txw4 = C.TX_W[max_tx] >> 2
            txh4 = C.TX_H[max_tx] >> 2
            for rr in range(r, r + bh4, txh4):
                for cc in range(c, c + bw4, txw4):
                    self._read_var_tx_size(rr, cc, max_tx, 0, b)
            b.tx_size = max_tx    # recon walks the leaf grid
        else:
            b.tx_size = C.TX_4X4 if lossless else \
                C.max_tx_size_rect(b.bsize)
            txw, txh = C.TX_W[b.tx_size], C.TX_H[b.tx_size]
            fs.inter_tx[r:re, c:ce] = b.tx_size
            fs.tx_w4[0][r:re, c:ce] = txw >> 2
            fs.tx_h4[0][r:re, c:ce] = txh >> 2
            if b.skip:
                # skip-inter ctx: block dims, not tx dims
                self.a_txw[c:ce] = bw4 * 4
                self.l_txh[lb:lb + (re - r)] = bh4 * 4
            else:
                self.a_txw[c:ce] = txw
                self.l_txh[lb:lb + (re - r)] = txh

    def _txfm_split_ctx(self, r, c, tx, b):
        """aom txfm_partition_context: above/left smaller-than-tx
        flags + a category from the block's square tx ceiling."""
        above = int(self.a_txw[c]) < C.TX_W[tx]
        left = int(self.l_txh[r & (self.fs.sb4 - 1)]) < C.TX_H[tx]
        size = min(64, max(C.BLOCK_W4[b.bsize] * 4,
                           C.BLOCK_H4[b.bsize] * 4))
        max_tx = C.find_tx_size(size, size)
        # aom txfm_partition_context: the first term marks RECURSIVE
        # levels (the current tx no longer squares up to the block's
        # max square tx) — caught by inter var-tx conformance (the
        # old tx==max_tx formulation collapsed child reads onto the
        # parent's category)
        cat = (int(C.TX_SIZE_SQR_UP[tx] != max_tx and
                   max_tx > C.TX_8X8)
               + (4 - max_tx) * 2)
        return cat * 3 + above + left

    def _read_var_tx_size(self, r, c, tx, depth, b):
        """Spec read_var_tx_size: recursive tx split for inter
        blocks, MAX_VARTX_DEPTH = 2; leaves land in the inter_tx
        grid and the tx ctx arrays."""
        fs = self.fs
        if r >= fs.mi_rows or c >= fs.mi_cols:
            return
        w4 = C.TX_W[tx] >> 2
        h4 = C.TX_H[tx] >> 2
        if tx == C.TX_4X4 or depth == 2:
            split = 0
        else:
            ctx = self._txfm_split_ctx(r, c, tx, b)
            split = self.sym(self.cdf["txfm_split"][ctx])
        if split:
            sub = C.SPLIT_TX_SIZE[tx]
            sw4 = C.TX_W[sub] >> 2
            sh4 = C.TX_H[sub] >> 2
            for rr in range(r, r + h4, sh4):
                for cc in range(c, c + w4, sw4):
                    self._read_var_tx_size(rr, cc, sub, depth + 1, b)
        else:
            re = min(r + h4, fs.mi_rows)
            ce = min(c + w4, fs.mi_cols)
            fs.inter_tx[r:re, c:ce] = tx
            fs.tx_w4[0][r:re, c:ce] = w4
            fs.tx_h4[0][r:re, c:ce] = h4
            self.a_txw[c:ce] = C.TX_W[tx]
            lb = r & (fs.sb4 - 1)
            self.l_txh[lb:lb + (re - r)] = C.TX_H[tx]

    # --------------------------------------------------------- residual
    # ------------------------------------------------------- palette
    # Spec 5.11.45/46 + 5.11.49-50 (get_palette_cache /
    # get_palette_color_context); bit-exact vs dav1d
    # (tests/test_av1.py palette suite).  Pure-Python oracle for the
    # C port in host_av1.c (pal_* helpers inside block_mode_core);
    # runs under FrameState.force_python.

    def _nbr_pal(self, rn, cn, plane):
        fs = self.fs
        origin = (int(fs.b_row0[rn, cn]), int(fs.b_col0[rn, cn]))
        ent = fs.pal_colors.get(origin)
        if ent is None:
            return ()
        return ent[0] if plane == 0 else ent[1]

    def _palette_cache(self, r, c, plane, avail_u, avail_l):
        """Merged sorted dedup of the above/left palettes; above is
        only used within the same 64px superblock row (the line
        buffer seam, spec get_palette_cache)."""
        above = self._nbr_pal(r - 1, c, plane) \
            if (avail_u and (r & 15)) else ()
        left = self._nbr_pal(r, c - 1, plane) if avail_l else ()
        out: list = []
        ai = li = 0
        while ai < len(above) and li < len(left):
            va, vl = above[ai], left[li]
            if vl < va:
                if not out or out[-1] != vl:
                    out.append(vl)
                li += 1
            else:
                if not out or out[-1] != va:
                    out.append(va)
                ai += 1
                if vl == va:
                    li += 1
        for v in above[ai:]:
            if not out or out[-1] != v:
                out.append(v)
        for v in left[li:]:
            if not out or out[-1] != v:
                out.append(v)
        return out

    def _read_palette_plane(self, r, c, plane, sz, avail_u, avail_l):
        """Y/U palette colors: cache-reuse bits, then a literal plus
        ascending deltas (Y deltas +1, U +0) with shrinking bit
        widths; final palette is the sorted merge of both runs."""
        m = self.m
        bd = self.seq.bit_depth
        mx = (1 << bd) - 1
        cache = self._palette_cache(r, c, plane, avail_u, avail_l)
        cached: list = []
        for col in cache:
            if len(cached) >= sz:
                break
            if m.decode_bool(1 << 14):
                cached.append(col)
        new: list = []
        if len(cached) < sz:
            prev = m.decode_literal(bd)
            new.append(prev)
            if len(cached) + len(new) < sz:
                bits = bd - 3 + m.decode_literal(2)
                dplus = 1 if plane == 0 else 0
                while len(cached) + len(new) < sz:
                    delta = m.decode_literal(bits) + dplus
                    prev = min(prev + delta, mx)
                    new.append(prev)
                    rng = (1 << bd) - prev - dplus
                    bits = min(bits, _ceil_log2(rng))
        return tuple(sorted(cached + new))

    def _read_palette_v(self, sz):
        """V palette: no cache; either raw literals or
        delta-with-sign coding with wraparound."""
        m = self.m
        bd = self.seq.bit_depth
        mx = (1 << bd) - 1
        if m.decode_bool(1 << 14):       # delta encoded
            bits = bd - 4 + m.decode_literal(2)
            prev = m.decode_literal(bd)
            out = [prev]
            for _ in range(sz - 1):
                delta = m.decode_literal(bits)
                if delta and m.decode_bool(1 << 14):
                    delta = -delta
                prev = (prev + delta) & mx
                out.append(prev)
            return tuple(out)
        return tuple(m.decode_literal(bd) for _ in range(sz))

    def _read_palette_map(self, b, is_uv):
        """Color-index map: first sample NS(n), then the wavefront
        (anti-diagonal) walk with neighbor-scored color reordering;
        offscreen right/bottom padding replicates edges."""
        m, fs, seq = self.m, self.fs, self.seq
        bsize = b.bsize
        bw4 = C.BLOCK_W4[bsize]
        bh4 = C.BLOCK_H4[bsize]
        w4 = min(bw4, fs.mi_cols - b.mi_col)
        h4 = min(bh4, fs.mi_rows - b.mi_row)
        if is_uv:
            sx, sy = seq.subsampling_x, seq.subsampling_y
            bw4 = (bw4 + sx) >> sx
            bh4 = (bh4 + sy) >> sy
            w4 = (w4 + sx) >> sx
            h4 = (h4 + sy) >> sy
        bw, bh = bw4 * 4, bh4 * 4
        w, h = w4 * 4, h4 * 4
        n = len(b.pal_u) if is_uv else len(b.pal_y)
        fam = self.cdf["palette_uv_color" if is_uv
                       else "palette_y_color"][n - 2]
        mp = np.zeros((bh, bw), np.uint8)
        mp[0, 0] = m.decode_ns(n)
        for i in range(1, w + h - 1):
            first = min(i, w - 1)
            last = max(0, i - h + 1)
            for j in range(first, last - 1, -1):
                y, x = i - j, j
                ctx, order = _palette_color_context(mp, y, x, n)
                mp[y, x] = order[self.sym(fam[ctx])]
        if w < bw:
            mp[:h, w:] = mp[:h, w - 1:w]
        if h < bh:
            mp[h:, :] = mp[h - 1:h, :]
        return mp

    def _residual(self, r, c, b):
        if self._use_native:
            return self._residual_native(b)
        for plane, start_x, start_y, tx, plane_bsize in \
                iter_tx_geometry(self.seq, self.fs, b):
            self._transform_block(plane, start_x, start_y, tx, b,
                                  plane_bsize)

    def _native_ptrs(self):
        """Per-tile pointer table for av1_block_coeffs (the arenas it
        indexes are this tile's adaptive CDF copies)."""
        t = self.cdf
        blob, scan_arena = _native_static()
        nplanes = len(self.a_coef)
        a = [self.a_coef[min(p, nplanes - 1)] for p in range(3)]
        l = [self.l_coef[min(p, nplanes - 1)] for p in range(3)]
        fs = self.fs
        seq = self.seq
        sb4 = fs.sb4
        self._dec_maps = []
        for p in range(3):
            pl = min(p, nplanes - 1)
            sx = seq.subsampling_x if pl else 0
            sy = seq.subsampling_y if pl else 0
            self._dec_maps.append(np.zeros(
                ((sb4 >> sy) + 3, (sb4 >> sx) + 3), np.uint8))
        assert fs.tx_w4[1].flags.c_contiguous
        arrs = a + l + [t[f"eob_pt_{16 << e}"] for e in range(7)] + [
            t["txb_skip"], t["eob_extra"], t["coeff_base_eob"],
            t["coeff_base"], t["coeff_br"], t["dc_sign"],
            self.cdf.intra_ext_tx_np, scan_arena, blob] + \
            self._dec_maps + [fs.tx_w4[1], fs.tx_h4[1]]
        ptrs = np.asarray([x.ctypes.data for x in arrs], np.int64)
        self._ptr_refs = arrs          # keep the buffers alive
        return ptrs

    def _native_mode_ptrs(self):
        """Pointer table for av1_block_mode (mode CDF arenas + the
        context grids it reads/updates)."""
        from ffpic_tpu_torch.coding.av1_cdf_tables import TABLES
        fs = self.fs
        mn = self.cdf.mode_np
        self.delta_lf_np = np.zeros((5, 5), np.int32)
        t = self.cdf.tables
        row = t["delta_lf"][0]
        self.delta_lf_np[0, :len(row)] = row
        row = t["delta_lf"][1]
        for i in range(4):
            self.delta_lf_np[1 + i, :len(row)] = row
        # intrabc DV cdfs: per-component adaptive copies of the nmv
        # defaults (dav1d's dmv context), fresh per tile
        def _pad(name, width):
            a = TABLES[name].astype(np.int32)
            if a.shape[-1] < width:
                pad = [(0, 0)] * (a.ndim - 1) + \
                    [(0, width - a.shape[-1])]
                a = np.pad(a, pad)
            return np.ascontiguousarray(a)
        self.dv_joint = _pad("mv_joint", 5).reshape(-1).copy()
        self.dv_sign = np.repeat(_pad("mv_sign", 3), 2, 0).copy()
        self.dv_classes = np.repeat(_pad("mv_classes", 12), 2,
                                    0).copy()
        self.dv_class0 = np.repeat(_pad("mv_class0_bit", 3), 2,
                                   0).copy()
        self.dv_bits = np.ascontiguousarray(
            np.stack([_pad("mv_bits", 3)] * 2))
        self.txfm_split_np = _pad("txfm_split", 3).copy()
        self.ietx_np = [
            _pad("inter_ext_tx1", 17).copy(),
            _pad("inter_ext_tx2", 17).copy(),
            _pad("inter_ext_tx3", 17).copy()]
        arrs = [mn["skip"], mn["spatial_seg"], mn["kf_y_mode"],
                mn["angle_delta"], mn["uv_mode"][0],
                mn["uv_mode"][1], mn["cfl_sign"], mn["cfl_alpha"],
                mn["palette_y_mode"], mn["palette_uv_mode"],
                mn["use_filter_intra"], mn["filter_intra_mode"],
                mn["intrabc"], mn["delta_q"], self.delta_lf_np,
                mn["tx_depth"],
                fs.skip, fs.seg, fs.y_mode, fs.palette_size,
                fs.cdef_idx, fs.tx_w4[0], fs.tx_h4[0],
                self.a_txw, self.l_txh, _native_static2(),
                mn["palette_y_size"], mn["palette_uv_size"],
                mn["palette_y_color"], mn["palette_uv_color"],
                self.pal_above_n, self.pal_above_c,
                self.pal_left_n, self.pal_left_c,
                self.dv_joint, self.dv_sign, self.dv_classes,
                self.dv_class0, self.dv_bits, self.txfm_split_np,
                self.ietx_np[0], self.ietx_np[1], self.ietx_np[2],
                fs.mvs, fs.is_ibc, fs.inter_tx, fs.tx_types,
                fs.bsize]
        ptrs = np.asarray([x.ctypes.data for x in arrs], np.int64)
        self._mode_ptr_refs = arrs
        return ptrs

    def _native_x_ptrs(self):
        """Extra pointer table for av1_sb_parse (X_* layout):
        partition CDF arena, the record grids the whole-SB driver
        writes, dequant tables, per-segment qindex deltas, S3."""
        fs, seq, fh = self.fs, self.seq, self.fh
        from ffpic_tpu_torch.coding.av1_cdf_tables import TABLES
        bd = seq.bit_depth
        qdc = np.ascontiguousarray(
            TABLES[f"q_dc{bd}"].astype(np.int32))
        qac = np.ascontiguousarray(
            TABLES[f"q_ac{bd}"].astype(np.int32))
        segq = np.full(8, -(1 << 30), np.int32)
        if fh.segmentation_enabled:
            for s in range(8):
                if fh.feature_enabled[s][H.SEG_LVL_ALT_Q]:
                    segq[s] = fh.feature_data[s][H.SEG_LVL_ALT_Q]
        arrs = [self.cdf.mode_np["partition"], fs.bsize, fs.uv_mode,
                fs.b_col0, fs.b_row0, fs.qindex_mi, fs.delta_lf,
                qdc, qac, segq, _native_static3()]
        for a in arrs:
            assert a.flags.c_contiguous
        ptrs = np.asarray([x.ctypes.data for x in arrs], np.int64)
        self._x_refs = arrs
        return ptrs

    def _native_sbp(self):
        """Per-tile frame/tile params for av1_sb_parse (SBP_*
        layout; slots 0/1 = current superblock r/c, set per call)."""
        fs, seq, fh = self.fs, self.seq, self.fh
        sb_bsize = C.BLOCK_128X128 if fs.sb4 == 32 else \
            C.BLOCK_64X64
        cdef_gate = (not fh.coded_lossless and seq.enable_cdef
                     and not fh.allow_intrabc)
        lossless_mask = 0
        for i, ls in enumerate(fh.lossless_segs):
            if ls:
                lossless_mask |= 1 << i
        return np.asarray((
            0, 0, fs.sb4, sb_bsize,
            self.r0, self.r1, self.c0, self.c1,
            fs.mi_rows, fs.mi_cols,
            int(fh.segmentation_enabled), int(fh.seg_id_pre_skip),
            fh.last_active_seg_id,
            int(cdef_gate), fh.cdef_bits,
            int(fh.delta_q_present), fh.delta_q_res,
            int(fh.delta_lf_present), int(fh.delta_lf_multi),
            fh.delta_lf_res,
            seq.num_planes, int(fh.allow_intrabc),
            int(fh.allow_screen_content_tools),
            int(seq.enable_filter_intra),
            int(fh.tx_mode == H.TX_MODE_SELECT), lossless_mask,
            seq.subsampling_x, seq.subsampling_y,
            int(fh.reduced_tx_set),
            fh.delta_q_y_dc, fh.delta_q_u_dc, fh.delta_q_u_ac,
            fh.delta_q_v_dc, fh.delta_q_v_ac,
            int(seq.enable_intra_edge_filter), seq.bit_depth),
            np.int32)

    def _decode_sb_native(self, r, c):
        """Whole-superblock decode in C (host_av1.c:av1_sb_parse):
        partition walk, mode-info, grid records and residual parse
        fused into one call; Python converts the returned TB metadata
        into TransformBlocks and appends the recon op chunk."""
        from ffpic_tpu_torch import native
        from ffpic_tpu_torch.formats.av1_recon import _OP_NF
        fs = self.fs
        if self._ptrs is None:
            self._ptrs = self._native_ptrs()
        if self._mode_ptrs is None:
            self._mode_ptrs = self._native_mode_ptrs()
        if self._x_ptrs is None:
            self._x_ptrs = self._native_x_ptrs()
            self._sbp = self._native_sbp()
        sbp = self._sbp
        sbp[0] = r
        sbp[1] = c
        sb4 = fs.sb4
        nmax = 3 * sb4 * sb4 + 64
        ops = np.empty((nmax, _OP_NF), np.int32)
        coef = np.zeros(3 * (sb4 * 4) * (sb4 * 4) + 4096, np.int32)
        tbmeta = np.empty((nmax, 9), np.int32)
        # palette payload arena: y maps cover <= the SB luma area,
        # uv maps <= the (444 worst case) same, + 36-int headers
        pal = np.empty(2 * (sb4 * 4) * (sb4 * 4) + 16384, np.int32)
        io = np.zeros(13, np.int32)
        io[0], io[1] = fs.max_luma
        io[5] = self.current_qindex
        io[6:10] = self.cur_delta_lf
        io[10] = 1 if (self.fh.delta_q_present or
                       self.fh.delta_lf_present) else 0
        m = self.m
        st = self._mstate
        st[0] = m.dif
        st[1] = m.rng
        st[2] = m.cnt
        st[3] = m.bitpos
        st[4] = 1 if m.allow_update else 0
        native.av1_sb_parse(m.data, st, self._ptrs,
                            self._mode_ptrs, self._x_ptrs, sbp,
                            ops, coef, tbmeta, pal, io)
        m.dif = int(st[0])
        m.rng = int(st[1])
        m.cnt = int(st[2])
        m.bitpos = int(st[3])
        if io[11]:
            raise NotImplementedError(
                "intrabc block copy" if int(io[11]) == 1
                else "unsupported tool")
        fs.max_luma[0] = int(io[0])
        fs.max_luma[1] = int(io[1])
        self.current_qindex = int(io[5])
        self.cur_delta_lf = [int(v) for v in io[6:10]]
        n_ops, n_tbs = int(io[2]), int(io[3])
        op_base = fs.recon_op_count
        # palette payloads: rebase K_PAL ops' P1 to the frame-global
        # pal arena (map offsets inside each record are
        # record-relative, so only P1 moves)
        n_pal = int(io[12])
        if n_pal:
            from ffpic_tpu_torch.formats.av1_recon import _K_PAL, \
                _OP_KIND, _OP_P1
            sel = ops[:n_ops, _OP_KIND] == _K_PAL
            ops[:n_ops, _OP_P1][sel] += fs.pal_count
            fs.pal_chunks.append(pal[:n_pal].copy())
            fs.pal_count += n_pal
        fs.recon_ops.append(ops[:n_ops])
        fs.recon_op_count = op_base + n_ops
        # array-form TB metadata: no per-TB Python objects — the
        # recon groups/gathers these vectorized (was ~25% of decode
        # as TransformBlock construction).  Columns per host_av1.c:
        # (plane, x, y, tx, off, eob, tt, op_row, lossless); off and
        # op_row rebase to frame-global here.
        meta = tbmeta[:n_tbs].copy()
        n_coef = int(io[4])
        meta[:, 4] += fs.coef_count
        meta[:, 7] += op_base
        fs.tbmeta_chunks.append(meta)
        fs.coef_chunks.append(coef[:n_coef].copy())
        fs.coef_count += n_coef

    def _decode_block_mode_native(self, r, c, bsize, b):
        """Mode-info symbols in C (av1_block_mode); returns False on
        an unsupported-tool gate (palette/intrabc) so the caller can
        raise the documented NotImplementedError."""
        from ffpic_tpu_torch import native
        fs, seq, fh = self.fs, self.seq, self.fh
        if self._mode_ptrs is None:
            self._mode_ptrs = self._native_mode_ptrs()
        sb_bsize = C.BLOCK_128X128 if fs.sb4 == 32 else             C.BLOCK_64X64
        cdef_gate = (not fh.coded_lossless and seq.enable_cdef
                     and not fh.allow_intrabc)
        lossless_mask = 0
        for i, ls in enumerate(fh.lossless_segs):
            if ls:
                lossless_mask |= 1 << i
        blk = np.asarray((
            r, c, bsize, int(b.avail_u), int(b.avail_l),
            int(b.has_chroma), int(fh.segmentation_enabled),
            int(fh.seg_id_pre_skip), fh.last_active_seg_id,
            self.r0, self.c0, fs.sb4 - 1,
            int(cdef_gate), fh.cdef_bits, 0,
            int(self.read_deltas), int(fh.delta_q_present),
            fh.delta_q_res, int(fh.delta_lf_present),
            int(fh.delta_lf_multi), fh.delta_lf_res,
            seq.num_planes, sb_bsize, int(fh.allow_intrabc),
            int(fh.allow_screen_content_tools),
            int(seq.enable_filter_intra),
            int(fh.tx_mode == H.TX_MODE_SELECT), lossless_mask,
            fs.mi_rows, fs.mi_cols,
            seq.subsampling_x, seq.subsampling_y, seq.bit_depth),
            np.int32)
        out = np.zeros(23, np.int32)
        out[11] = self.current_qindex
        out[12:16] = self.cur_delta_lf
        pal = np.empty(36 + 2 * 64 * 64, np.int32)
        m = self.m
        st = self._mstate
        st[0] = m.dif
        st[1] = m.rng
        st[2] = m.cnt
        st[3] = m.bitpos
        st[4] = 1 if m.allow_update else 0
        native.av1_block_mode(m.data, st, self._mode_ptrs, blk, out,
                              pal)
        m.dif = int(st[0])
        m.rng = int(st[1])
        m.cnt = int(st[2])
        m.bitpos = int(st[3])
        self.current_qindex = int(out[11])
        self.cur_delta_lf = [int(v) for v in out[12:16]]
        self.read_deltas = bool(out[16])
        if out[0]:
            raise NotImplementedError(
                "intrabc block copy" if int(out[0]) == 1
                else "unsupported tool")
        b.seg_id = int(out[1])
        b.skip = int(out[2])
        b.y_mode = int(out[3])
        b.angle_y = int(out[4])
        b.uv_mode = int(out[5]) if b.has_chroma else C.DC_PRED
        b.angle_uv = int(out[6])
        b.cfl_alpha_u = int(out[7])
        b.cfl_alpha_v = int(out[8])
        b.filter_intra_mode = int(out[9])
        b.tx_size = int(out[10])
        b.qindex = self.current_qindex
        # palette payload -> Block fields (PALH_* record layout,
        # host_av1.c) so the object-form record/recon paths work
        # unchanged; the raw record is kept for K_PAL op emission
        ny, nu, plen = int(out[17]), int(out[18]), int(out[19])
        if plen:
            rec = pal[:plen].copy()
            b._pal_rec = rec
            if ny:
                b.pal_y = tuple(int(v) for v in rec[12:12 + ny])
                bw, bh = int(rec[2]), int(rec[3])
                b.pal_map_y = rec[rec[10]:rec[10] + bw * bh] \
                    .astype(np.uint8).reshape(bh, bw)
            if nu:
                b.pal_u = tuple(int(v) for v in rec[20:20 + nu])
                b.pal_v = tuple(int(v) for v in rec[28:28 + nu])
                bw, bh = int(rec[4]), int(rec[5])
                b.pal_map_uv = rec[rec[11]:rec[11] + bw * bh] \
                    .astype(np.uint8).reshape(bh, bw)
        return True

    def _residual_native(self, b):
        """Whole-block residual parse in C (host_av1.c:
        av1_block_parse): C iterates the spec residual() TB geometry
        itself, decoding coefficients AND emitting the recon op list
        while maintaining the BlockDecoded bitmaps, a/l contexts,
        chroma tx-dim grids and MaxLuma.  Python supplies one compact
        per-block + per-plane record (mode symbols were already
        decoded; every field here is symbol-free)."""
        from ffpic_tpu_torch import native
        from ffpic_tpu_torch.formats.av1_recon import (
            _filter_type, _K_DC, _K_DIR, _K_FILTER, _K_PAL,
            _KIND_OF_MODE, _OP_NF)
        fs, seq, fh = self.fs, self.seq, self.fh
        pal_base = None
        if self._ptrs is None:
            self._ptrs = self._native_ptrs()
        sb4 = fs.sb4
        sb_log2 = sb4.bit_length() - 1
        sb_r = (b.mi_row >> sb_log2) << sb_log2
        sb_c = (b.mi_col >> sb_log2) << sb_log2
        new_sb = 0
        if (sb_r, sb_c) != self._cur_sb:
            new_sb = 1
            self._cur_sb = (sb_r, sb_c)
        lossless = fh.lossless_segs[b.seg_id]
        qidx = H.get_qindex(fh, b.seg_id, b.qindex)
        bw4, bh4 = C.BLOCK_W4[b.bsize], C.BLOCK_H4[b.bsize]
        w_chunks = max(1, bw4 >> 4)
        h_chunks = max(1, bh4 >> 4)
        chunk_bsize = C.block_from_dims(min(bw4, 16), min(bh4, 16))
        nplanes = min(3 if b.has_chroma else 1, seq.num_planes)
        pp = self._pp_scratch
        max_tb = 0
        max_coef = 0
        for plane in range(nplanes):
            sx = seq.subsampling_x if plane else 0
            sy = seq.subsampling_y if plane else 0
            if lossless:
                tx = C.TX_4X4
            elif plane == 0:
                tx = b.tx_size
            else:
                tx = C.max_uv_tx_size(b.bsize, sx, sy)
            pbs = C.plane_block_size(chunk_bsize, sx, sy)
            num4w = C.BLOCK_W4[pbs]
            num4h = C.BLOCK_H4[pbs]
            step_x = C.TX_W[tx] >> 2
            step_y = C.TX_H[tx] >> 2
            ntb = (w_chunks * h_chunks
                   * (-(-num4w // step_x)) * (-(-num4h // step_y)))
            max_tb += ntb
            adj = C.adjusted_tx_size(tx)
            max_coef += ntb * C.TX_W[adj] * C.TX_H[adj]
            if plane == 0:
                mode, angle, fim = b.y_mode, b.angle_y, \
                    b.filter_intra_mode
                alpha = 0
            else:
                mode, angle, fim = b.uv_mode, b.angle_uv, -1
                alpha = 0
                if mode == C.UV_CFL_PRED:
                    alpha = b.cfl_alpha_u if plane == 1 else \
                        b.cfl_alpha_v
            is_cfl = plane > 0 and mode == C.UV_CFL_PRED
            pred_mode = C.DC_PRED if is_cfl else mode
            if (b.pal_y if plane == 0 else b.pal_u):
                # palette prediction op: P1 = pal arena record base
                if pal_base is None:
                    pal_base = fs.pal_count
                    fs.pal_chunks.append(b._pal_rec)
                    fs.pal_count += len(b._pal_rec)
                kind, p1 = _K_PAL, pal_base
            elif fim >= 0:
                kind, p1 = _K_FILTER, fim
            elif pred_mode == C.DC_PRED:
                kind, p1 = _K_DC, 0
            elif pred_mode in C.MODE_TO_ANGLE:
                kind = _K_DIR
                p1 = C.MODE_TO_ANGLE[pred_mode] + \
                    angle * C.ANGLE_STEP
            else:
                kind, p1 = _KIND_OF_MODE[pred_mode], 0
            if plane > 0:
                ett = (-1, 0, 0,
                       C.DCT_DCT if lossless else
                       self._chroma_tx_type(tx, b))
            elif lossless:
                ett = (-1, 0, 0, C.DCT_DCT)
            else:
                tset = C.get_tx_set_intra(tx, fh.reduced_tx_set)
                if tset == C.TX_SET_DCTONLY or qidx <= 0:
                    ett = (-1, 0, 0, C.DCT_DCT)
                else:
                    ett = (tset - 1,
                           (C.FIMODE_TO_INTRA_DIR[fim] if fim >= 0
                            else b.y_mode),
                           C.TX_SIZE_SQR[tx], 0)
            key = (plane, b.seg_id, b.qindex, tx)
            dq = self._dq_cache.get(key)
            if dq is None:
                dq = self._dequant_params(plane, b, tx)
                self._dq_cache[key] = dq
            dmh = (sb4 >> sy) + 3
            dmw = (sb4 >> sx) + 3
            # PBW/PBH: the FULL block's plane dims (all_zero ctx per
            # spec get_txb_skip_ctx), while num4w/h stay chunk-based
            fpbs = C.plane_block_size(b.bsize, sx, sy)
            pp[plane] = (tx, num4w, num4h, sx, sy,
                         int(b.avail_uc if plane else b.avail_u),
                         int(b.avail_lc if plane else b.avail_l),
                         ett[0], ett[1], ett[2], ett[3],
                         dq[0], dq[1], dq[2],
                         kind, p1, alpha,
                         _filter_type(fs, b, plane),
                         C.BLOCK_W4[fpbs] * 4, C.BLOCK_H4[fpbs] * 4,
                         dmh, dmw)
        # reset rows must exist for EVERY frame plane (a chroma-less
        # sub-8x8 partner can be the first block of a superblock)
        for plane in range(nplanes, seq.num_planes):
            sx, sy = seq.subsampling_x, seq.subsampling_y
            pp[plane] = (0,) * 3 + (sx, sy) + (0,) * 15 + \
                ((sb4 >> sy) + 3, (sb4 >> sx) + 3)
        blk = (b.mi_row, b.mi_col, w_chunks, h_chunks, int(b.skip),
               new_sb, sb_r, sb_c, self.sb_row, fs.mi_rows,
               fs.mi_cols, self.r1, self.c1,
               int(seq.enable_intra_edge_filter), seq.num_planes,
               0, qidx, int(fh.reduced_tx_set))
        blk_arr = np.asarray(blk, np.int32)
        pp_arr = np.asarray(pp[:max(nplanes, seq.num_planes)],
                            np.int32)
        ops = np.empty((max_tb, _OP_NF), np.int32)
        coef = np.zeros(max_coef, np.int32)
        tbmeta = np.empty((max_tb, 9), np.int32)
        inout = np.asarray([fs.max_luma[0], fs.max_luma[1], 0, 0, 0],
                           np.int32)
        m = self.m
        st = self._mstate
        st[0] = m.dif
        st[1] = m.rng
        st[2] = m.cnt
        st[3] = m.bitpos
        st[4] = 1 if m.allow_update else 0
        native.av1_block_parse(m.data, st, self._ptrs, blk_arr,
                               pp_arr, nplanes, ops, coef,
                               tbmeta, 1 << (seq.bit_depth + 7),
                               inout)
        m.dif = int(st[0])
        m.rng = int(st[1])
        m.cnt = int(st[2])
        m.bitpos = int(st[3])
        fs.max_luma[0] = int(inout[0])
        fs.max_luma[1] = int(inout[1])
        n_ops, n_tbs = int(inout[2]), int(inout[3])
        op_base = fs.recon_op_count
        fs.recon_ops.append(ops[:n_ops])
        fs.recon_op_count = op_base + n_ops
        for i in range(n_tbs):
            plane, x, y, tx, off, eob, tt, op_row = (
                int(v) for v in tbmeta[i, :8])
            adj = C.adjusted_tx_size(tx)
            aw, ah = C.TX_W[adj], C.TX_H[adj]
            tb = TransformBlock(plane, x, y, tx, tt, eob,
                                coef[off:off + aw * ah].reshape(
                                    ah, aw), b)
            tb.lossless = lossless
            fs.tbs.append(tb)
            fs.op_of_tb.append(op_base + op_row)
            b.coeff_map[(plane, x, y)] = tb

    def _transform_block(self, plane, x, y, tx, b, plane_bsize):
        fs = self.fs
        x4 = x >> 2
        y4 = y >> 2
        w4 = C.TX_W[tx] >> 2
        h4 = C.TX_H[tx] >> 2
        a = self.a_coef[plane]
        l = self.l_coef[plane]
        # left array indexed by plane 4-sample row within the sb row
        sy = self.seq.subsampling_y if plane else 0
        l_base = y4 - (self.sb_row >> sy)
        if plane > 0:
            # record chroma tx dims (chroma 4-px units) for deblock
            sx = self.seq.subsampling_x
            r0 = y4 << sy
            c0 = x4 << sx
            re = min(r0 + (h4 << sy), fs.mi_rows)
            ce = min(c0 + (w4 << sx), fs.mi_cols)
            fs.tx_w4[1][r0:re, c0:ce] = w4
            fs.tx_h4[1][r0:re, c0:ce] = h4
        if b.skip:
            a[x4:x4 + w4] = 0
            l[l_base:l_base + h4] = 0
            return
        eob, coeffs, tx_type = self._coeffs(
            plane, x4, y4, tx, b, plane_bsize, a, l, l_base)
        if eob > 0:
            tb = TransformBlock(plane, x, y, tx, tx_type, eob,
                                coeffs, b)
            tb.lossless = bool(self.fh.lossless_segs[b.seg_id])
            fs.tbs.append(tb)
            b.coeff_map[(plane, x, y)] = tb

    # ------------------------------------------------- coefficients
    def _luma_tx_type(self, tx, b):
        fh = self.fh
        if b.use_intrabc or b.is_inter:
            # inter tx sets (spec 5.11.47 transform_type, is_inter)
            tset = C.get_tx_set_inter(tx, fh.reduced_tx_set)
            qidx = H.get_qindex(fh, b.seg_id)
            if tset == C.TX_SET_DCTONLY or qidx <= 0:
                return C.DCT_DCT
            cdf = self.cdf[f"inter_ext_tx{tset}"][C.TX_SIZE_SQR[tx]]
            sym = self.sym(cdf)
            inv = (C.TX_TYPE_INTER_INV_SET1,
                   C.TX_TYPE_INTER_INV_SET2,
                   C.TX_TYPE_INTER_INV_SET3)[tset - 1]
            return inv[sym]
        tset = C.get_tx_set_intra(tx, fh.reduced_tx_set)
        qidx = H.get_qindex(fh, b.seg_id)
        if tset == C.TX_SET_DCTONLY or qidx <= 0:
            return C.DCT_DCT
        if b.filter_intra_mode >= 0:
            intra_dir = C.FIMODE_TO_INTRA_DIR[b.filter_intra_mode]
        else:
            intra_dir = b.y_mode
        cdf = self.cdf["intra_ext_tx"][tset - 1][
            C.TX_SIZE_SQR[tx]][intra_dir]
        sym = self.sym(cdf)
        inv = (C.TX_TYPE_INTRA_INV_SET1 if tset == C.TX_SET_INTRA_1
               else C.TX_TYPE_INTRA_INV_SET2)
        return inv[sym]

    def _chroma_tx_type(self, tx, b, x4=0, y4=0):
        if C.TX_SIZE_SQR_UP[tx] > C.TX_32X32:
            return C.DCT_DCT
        if b.use_intrabc or b.is_inter:
            # inter chroma: co-located luma tx type (block origin +
            # chroma-TB offset scaled up, dav1d txtp_map addressing)
            fs, seq = self.fs, self.seq
            sx, sy = seq.subsampling_x, seq.subsampling_y
            ly = b.mi_row + ((y4 - (b.mi_row >> sy)) << sy)
            lx = b.mi_col + ((x4 - (b.mi_col >> sx)) << sx)
            tt = int(fs.tx_types[min(ly, fs.mi_rows - 1),
                                 min(lx, fs.mi_cols - 1)])
            tset = C.get_tx_set_inter(tx, self.fh.reduced_tx_set)
            if not C.tx_type_in_set_inter(tset, tt):
                return C.DCT_DCT
            return tt
        tt = C.INTRA_MODE_TO_TX_TYPE[b.uv_mode]
        tset = C.get_tx_set_intra(tx, self.fh.reduced_tx_set)
        if not C.tx_type_in_set(tset, tt):
            return C.DCT_DCT
        return tt

    def _coeffs(self, plane, x4, y4, tx, b, plane_bsize, a, l,
                l_base):
        t = self.cdf
        seq, fh = self.seq, self.fh
        ptype = 1 if plane else 0
        txs_ctx = C.TX_SIZE_CTX[tx]
        adj = C.adjusted_tx_size(tx)
        w, h = C.TX_W[adj], C.TX_H[adj]
        w4 = C.TX_W[tx] >> 2
        h4 = C.TX_H[tx] >> 2
        tw, th = C.TX_W[tx], C.TX_H[tx]
        # level-context reads/writes are clipped to the frame's mi
        # extent for TBs overhanging the right/bottom edge (dav1d
        # bounds its coef ctx loops by the frame, and the adapted-CDF
        # stream depends on it — found via the 4:4:4 200x136 overhang
        # divergence)
        sx = seq.subsampling_x if plane else 0
        sy = seq.subsampling_y if plane else 0
        cw4 = min(w4, (self.fs.mi_cols >> sx) - x4)
        ch4 = min(h4, (self.fs.mi_rows >> sy) - y4)
        # ---- all_zero
        if plane == 0:
            pbw = C.BLOCK_W4[plane_bsize] * 4
            pbh = C.BLOCK_H4[plane_bsize] * 4
            if pbw == tw and pbh == th:
                ctx = 0
            else:
                top = 0
                for k in range(cw4):
                    top |= int(a[x4 + k])
                left = 0
                for k in range(ch4):
                    left |= int(l[l_base + k])
                top &= 63
                left &= 63
                mx = min(top | left, 4)
                mn = min(top, left, 4)
                ctx = C.SKIP_CONTEXTS[mn][mx]
        else:
            above_nz = any(a[x4 + k] & 63 for k in range(cw4))
            left_nz = any(l[l_base + k] & 63 for k in range(ch4))
            pbw = C.BLOCK_W4[plane_bsize] * 4
            pbh = C.BLOCK_H4[plane_bsize] * 4
            off = 10 if pbw * pbh > tw * th else 7
            ctx = int(above_nz) + int(left_nz) + off
        all_zero = self.sym(t["txb_skip"][txs_ctx][ctx])
        if all_zero:
            a[x4:x4 + cw4] = 0
            l[l_base:l_base + ch4] = 0
            return 0, None, C.DCT_DCT
        # ---- tx type + scan
        if plane == 0:
            tx_type = self._luma_tx_type(tx, b)
            if b.use_intrabc or b.is_inter:
                fs = self.fs
                fs.tx_types[y4:min(y4 + h4, fs.mi_rows),
                            x4:min(x4 + w4, fs.mi_cols)] = tx_type
        else:
            tx_type = self._chroma_tx_type(tx, b, x4, y4)
        if fh.lossless_segs[b.seg_id]:
            tx_type = C.DCT_DCT
        scan = C.get_scan(tx, tx_type)
        cls = C.tx_type_class(tx_type)
        # ---- eob
        area = w * h
        emul = (w.bit_length() - 1) + (h.bit_length() - 1) - 4
        eob_cdf = t[f"eob_pt_{16 << emul}"][ptype][
            0 if cls == C.TX_CLASS_2D else 1]
        eob_pt = self.sym(eob_cdf) + 1
        if eob_pt < 2:
            eob = eob_pt
        else:
            eob = (1 << (eob_pt - 2)) + 1
            if eob_pt >= 3:
                extra = self.sym(
                    t["eob_extra"][txs_ctx][ptype][eob_pt - 3])
                if extra:
                    eob += 1 << (eob_pt - 3)
                for i in range(1, eob_pt - 2):
                    shift = eob_pt - 2 - 1 - i
                    if self.boolean():
                        eob += 1 << shift
        # ---- base levels (reverse scan)
        levels = np.zeros((h + 5, w + 5), np.int32)
        quant = np.zeros(area, np.int64)
        base_eob_cdf = t["coeff_base_eob"][txs_ctx][ptype]
        base_cdf = t["coeff_base"][txs_ctx][ptype]
        br_cdf = t["coeff_br"][min(txs_ctx, 3)][ptype]
        # square/wide/tall picked by the TRUE tx shape, not the
        # adjusted <=32x32 coded area: TX_32X64/TX_64X32 adjust to a
        # square but use the tall/wide tables (dav1d lo_ctx_offsets
        # index 1 + (tx & 1) over its rect-tx enum)
        offtab = C.lo_ctx_offset_table(tw, th)
        lv = levels
        for c_i in range(eob - 1, -1, -1):
            pos = int(scan[c_i])
            row = pos // w
            col = pos - row * w
            if c_i == eob - 1:
                if c_i == 0:
                    bctx = 0
                elif c_i <= area // 8:
                    bctx = 1
                elif c_i <= area // 4:
                    bctx = 2
                else:
                    bctx = 3
                level = self.sym(base_eob_cdf[bctx]) + 1
            else:
                if cls == C.TX_CLASS_2D:
                    if pos == 0:
                        bctx = 0
                    else:
                        mag = (min(int(lv[row, col + 1]), 3) +
                               min(int(lv[row + 1, col]), 3) +
                               min(int(lv[row + 1, col + 1]), 3) +
                               min(int(lv[row, col + 2]), 3) +
                               min(int(lv[row + 2, col]), 3))
                        bctx = min((mag + 1) >> 1, 4) + \
                            offtab[min(row, 4)][min(col, 4)]
                else:
                    mag = min(int(lv[row, col + 1]), 3) + \
                        min(int(lv[row + 1, col]), 3)
                    if cls == C.TX_CLASS_HORIZ:
                        mag += min(int(lv[row, col + 2]), 3)
                        mag += min(int(lv[row, col + 3]), 3)
                        mag += min(int(lv[row, col + 4]), 3)
                        idx = col
                    else:
                        mag += min(int(lv[row + 2, col]), 3)
                        mag += min(int(lv[row + 3, col]), 3)
                        mag += min(int(lv[row + 4, col]), 3)
                        idx = row
                    bctx = min((mag + 1) >> 1, 4) + \
                        C.LO_CTX_OFFSETS_1D[min(idx, 2)]
                level = self.sym(base_cdf[bctx])
            if level > NUM_BASE_LEVELS:
                # coeff_br extension, up to +12
                if cls == C.TX_CLASS_2D:
                    mag = int(lv[row, col + 1]) + \
                        int(lv[row + 1, col]) + \
                        int(lv[row + 1, col + 1])
                elif cls == C.TX_CLASS_HORIZ:
                    mag = int(lv[row, col + 1]) + \
                        int(lv[row + 1, col]) + \
                        int(lv[row, col + 2])
                else:
                    mag = int(lv[row, col + 1]) + \
                        int(lv[row + 1, col]) + \
                        int(lv[row + 2, col])
                bmag = min((mag + 1) >> 1, 6)
                if pos == 0:
                    brctx = bmag
                elif cls == C.TX_CLASS_2D:
                    brctx = bmag + (7 if (row < 2 and col < 2)
                                    else 14)
                elif cls == C.TX_CLASS_HORIZ:
                    brctx = bmag + (7 if col == 0 else 14)
                else:
                    brctx = bmag + (7 if row == 0 else 14)
                for _ in range(COEFF_BASE_RANGE //
                               (BR_CDF_SIZE - 1)):
                    br = self.sym(br_cdf[brctx])
                    level += br
                    if br < BR_CDF_SIZE - 1:
                        break
            quant[pos] = level
            lv[row, col] = min(level, 127)
        # ---- signs + golomb tail (forward scan)
        cul = 0
        dc_cat = 0
        signs = np.zeros(area, np.int8)
        for c_i in range(eob):
            pos = int(scan[c_i])
            level = int(quant[pos])
            sign = 0
            if level:
                if c_i == 0:
                    dcs = 0
                    for k in range(cw4):
                        v = int(a[x4 + k]) >> 6
                        dcs += 1 if v == 2 else (-1 if v == 1
                                                 else 0)
                    for k in range(ch4):
                        v = int(l[l_base + k]) >> 6
                        dcs += 1 if v == 2 else (-1 if v == 1
                                                 else 0)
                    sctx = 0 if dcs == 0 else (1 if dcs < 0 else 2)
                    sign = self.sym(t["dc_sign"][ptype][sctx])
                else:
                    sign = self.boolean()
            if level > NUM_BASE_LEVELS + COEFF_BASE_RANGE:
                level += self._golomb()
                quant[pos] = level
            if c_i == 0:
                dc_cat = 0 if level == 0 else (1 if sign else 2)
            cul += level
            signs[pos] = sign
        cul = min(cul, 63)
        a[x4:x4 + cw4] = cul | (dc_cat << 6)
        l[l_base:l_base + ch4] = cul | (dc_cat << 6)
        # ---- dequant
        dc_q, ac_q, shift, clip = self._dequant_params(plane, b,
                                                       tx)
        bd = self.seq.bit_depth
        out = np.zeros((h, w), np.int64)
        flat = out.reshape(-1)
        for c_i in range(eob):
            pos = int(scan[c_i])
            level = int(quant[pos])
            if not level:
                continue
            dqv = dc_q if pos == 0 else ac_q
            dq = (level * dqv) & 0xFFFFFF
            dq >>= shift
            if signs[pos]:
                dq = -dq
            flat[pos] = max(-clip, min(clip - 1, dq))
        return eob, out, tx_type

    def _dequant_params(self, plane, b, tx):
        seq, fh = self.seq, self.fh
        qidx = H.get_qindex(fh, b.seg_id, b.qindex)
        if plane == 0:
            dc_delta, ac_delta = fh.delta_q_y_dc, 0
        elif plane == 1:
            dc_delta, ac_delta = fh.delta_q_u_dc, fh.delta_q_u_ac
        else:
            dc_delta, ac_delta = fh.delta_q_v_dc, fh.delta_q_v_ac
        if fh.using_qmatrix:
            raise NotImplementedError("quantizer matrices")
        from ffpic_tpu_torch.coding.av1_cdf_tables import TABLES
        sfx = str(seq.bit_depth)
        dc_q = int(TABLES["q_dc" + sfx][
            max(0, min(255, qidx + dc_delta))])
        ac_q = int(TABLES["q_ac" + sfx][
            max(0, min(255, qidx + ac_delta))])
        # dequant scale (spec dqDenom / libaom av1_get_tx_scale): by
        # FULL tx area, not sqr-up size — 8x32 (256 pels) shifts 0,
        # 16x64 (1024 pels) shifts 1
        pels = C.TX_W[tx] * C.TX_H[tx]
        shift = (1 if pels > 256 else 0) + (1 if pels > 1024 else 0)
        clip = 1 << (seq.bit_depth + 7)
        return dc_q, ac_q, shift, clip


def iter_tx_geometry(seq, fs, b):
    """Yield (plane, start_x, start_y, tx_size, plane_bsize) in the
    exact spec residual() order for block b.  Shared between the parse
    pass (coefficient decode) and the recon replay so both walk the
    same transform blocks."""
    fh = fs.fh
    r, c = b.mi_row, b.mi_col
    bw4, bh4 = C.BLOCK_W4[b.bsize], C.BLOCK_H4[b.bsize]
    lossless = fh.lossless_segs[b.seg_id]
    w_chunks = max(1, bw4 >> 4)
    h_chunks = max(1, bh4 >> 4)
    chunk_bsize = C.block_from_dims(min(bw4, 16), min(bh4, 16))
    nplanes = 3 if b.has_chroma else 1
    for cy in range(h_chunks):
        for cx in range(w_chunks):
            for plane in range(min(nplanes, seq.num_planes)):
                sx = seq.subsampling_x if plane else 0
                sy = seq.subsampling_y if plane else 0
                # iteration bounds follow the 64x64 CHUNK; the
                # yielded plane_bsize is the FULL block's (the
                # all_zero ctx compares block dims vs tx dims, spec
                # get_txb_skip_ctx — a 128-wide block is never
                # "equal to" its 64px tx even though the chunk is)
                chunk_pbsize = C.plane_block_size(chunk_bsize, sx, sy)
                plane_bsize = C.plane_block_size(b.bsize, sx, sy)
                if lossless:
                    tx = C.TX_4X4
                elif plane == 0:
                    tx = b.tx_size
                else:
                    tx = C.max_uv_tx_size(b.bsize, sx, sy)
                num4w = C.BLOCK_W4[chunk_pbsize]
                num4h = C.BLOCK_H4[chunk_pbsize]
                step_x = C.TX_W[tx] >> 2
                step_y = C.TX_H[tx] >> 2
                base_x = ((c >> sx) + (cx << (4 - sx))) * 4
                base_y = ((r >> sy) + (cy << (4 - sy))) * 4
                max_x = (fs.mi_cols * 4) >> sx
                max_y = (fs.mi_rows * 4) >> sy
                if plane == 0 and (b.use_intrabc or b.is_inter) \
                        and not lossless:
                    # inter residual: transform_tree over the chunk
                    # follows the var-tx leaf grid (spec 5.11.36)
                    yield from _transform_tree(
                        fs, base_x, base_y, num4w * 4, num4h * 4,
                        plane_bsize, max_x, max_y)
                    continue
                for yy in range(0, num4h, step_y):
                    for xx in range(0, num4w, step_x):
                        start_x = base_x + 4 * xx
                        start_y = base_y + 4 * yy
                        if start_x >= max_x or start_y >= max_y:
                            continue
                        yield plane, start_x, start_y, tx, plane_bsize


def _transform_tree(fs, x, y, w, h, plane_bsize, max_x, max_y):
    """Spec transform_tree: recursively tile the luma area with the
    InterTxSizes leaves recorded by read_var_tx_size."""
    if x >= max_x or y >= max_y:
        return
    ltx = int(fs.inter_tx[y >> 2, x >> 2])
    lw, lh = C.TX_W[ltx], C.TX_H[ltx]
    if w <= lw and h <= lh:
        yield 0, x, y, C.find_tx_size(w, h), plane_bsize
    elif w > h:
        yield from _transform_tree(fs, x, y, w // 2, h,
                                   plane_bsize, max_x, max_y)
        yield from _transform_tree(fs, x + w // 2, y, w // 2, h,
                                   plane_bsize, max_x, max_y)
    elif w < h:
        yield from _transform_tree(fs, x, y, w, h // 2,
                                   plane_bsize, max_x, max_y)
        yield from _transform_tree(fs, x, y + h // 2, w, h // 2,
                                   plane_bsize, max_x, max_y)
    else:
        hw, hh = w // 2, h // 2
        yield from _transform_tree(fs, x, y, hw, hh,
                                   plane_bsize, max_x, max_y)
        yield from _transform_tree(fs, x + hw, y, hw, hh,
                                   plane_bsize, max_x, max_y)
        yield from _transform_tree(fs, x, y + hh, hw, hh,
                                   plane_bsize, max_x, max_y)
        yield from _transform_tree(fs, x + hw, y + hh, hw, hh,
                                   plane_bsize, max_x, max_y)


def _inverse_recenter(r, v):
    """Spec 5.9.27 inverse_recenter (libaom inv_recenter_nonneg):
    even v maps above the reference, odd v below.  The parity matters
    but is invisible to entropy-sync tests (bit consumption is
    identical either way) — pinned by the Wiener-exact LR tests."""
    if v > 2 * r:
        return v
    if v & 1:
        return r - ((v + 1) >> 1)
    return r + (v >> 1)


def _neg_deinterleave(diff, ref, max_val):
    if not ref:
        return diff
    if ref >= max_val - 1:
        return max_val - diff - 1
    if 2 * ref < max_val:
        if diff <= 2 * ref:
            if diff & 1:
                return ref + ((diff + 1) >> 1)
            return ref - (diff >> 1)
        return diff
    if diff <= 2 * (max_val - ref - 1):
        if diff & 1:
            return ref + ((diff + 1) >> 1)
        return ref - (diff >> 1)
    return max_val - (diff + 1)
