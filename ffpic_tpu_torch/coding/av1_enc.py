"""Minimal conforming AV1 still-picture ENCODER.

The C reference (junka/ffpic) has neither an AV1 decoder nor encoder
(format/avif.c is a frame stub); this encoder closes the write side:
`transcode -c avif`, and — critically — it manufactures conformance
streams this image has no other encoder for (10-bit in particular),
giving the decoder's 10-bit paths a dav1d cross-check
(tests/test_av1_enc.py).

Stream shape (chosen for correctness, not compression):
- reduced_still_picture_header sequence, one tile, KEY frame
- disable_cdf_update = 1 (static CDFs: encoder and decoder trivially
  stay in lockstep)
- uniform DC_PRED blocks: 64/32 superblock levels always SPLIT,
  16x16 leaves PARTITION_NONE (frame edges split further, mirroring
  the decoder's forced-split geometry)
- TX_MODE_LARGEST (no tx symbols); qindex 0 = lossless (4x4 WHT,
  exact roundtrip), else quantized DCT with a calibrated float
  forward transform
- 8-bit or 10-bit, 4:2:0 / 4:4:4 / monochrome

Symbol emission mirrors av1_tile.py's decoder (same ctx derivations
over the same FrameState grids); the arithmetic layer is
av1_msac_enc.MsacEnc, validated symbol-exact against the decoder.

Copied from ``ffpic_tpu/coding/av1_enc.py`` for the PyTorch port whole,
with its imports rewritten to the port's modules (the lazy imports of
``av1_itx`` and ``av1_intra`` too).  It runs on the host, as in the
reference; ``formats/avif.encode`` wraps it.
"""
from __future__ import annotations

import numpy as np

from ffpic_tpu_torch.coding import av1_consts as C
from ffpic_tpu_torch.coding import av1_headers as H
from ffpic_tpu_torch.coding.av1_msac import fresh_cdf
from ffpic_tpu_torch.coding.av1_msac_enc import MsacEnc
from ffpic_tpu_torch.coding.av1_tile import (FrameState, Block,
                                       iter_tx_geometry,
                                       qctx_for_base_q)
from ffpic_tpu_torch.coding.av1_cdf_tables import TABLES


class BitWriter:
    def __init__(self):
        self.bits = []

    def write(self, v: int, n: int):
        for i in range(n - 1, -1, -1):
            self.bits.append((v >> i) & 1)

    def byte_align(self):
        while len(self.bits) % 8:
            self.bits.append(0)

    def tobytes(self) -> bytes:
        self.byte_align()
        out = bytearray(len(self.bits) // 8)
        for i, b in enumerate(self.bits):
            if b:
                out[i >> 3] |= 0x80 >> (i & 7)
        return bytes(out)


def _leb128(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _obu(obu_type: int, payload: bytes) -> bytes:
    # header: forbidden(0) type(4) ext(0) has_size(1) reserved(0)
    return bytes([(obu_type << 3) | 0x02]) + _leb128(len(payload)) \
        + payload


# ------------------------------------------------------------ headers
def _seq_header(w, h, bd, mono, subx, suby) -> bytes:
    bw = BitWriter()
    profile = 0 if (mono or (subx == 1 and suby == 1)) else 1
    bw.write(profile, 3)
    bw.write(1, 1)                  # still_picture
    bw.write(1, 1)                  # reduced_still_picture_header
    bw.write(0, 5)                  # seq_level_idx[0]
    nb = max(w.bit_length(), 1)
    mb = max(h.bit_length(), 1)
    bw.write(nb - 1, 4)             # frame_width_bits_minus_1
    bw.write(mb - 1, 4)
    bw.write(w - 1, nb)
    bw.write(h - 1, mb)
    bw.write(0, 1)                  # use_128x128_superblock
    bw.write(0, 1)                  # enable_filter_intra
    bw.write(1, 1)                  # enable_intra_edge_filter
    bw.write(0, 1)                  # enable_superres
    bw.write(0, 1)                  # enable_cdef
    bw.write(0, 1)                  # enable_restoration
    # color_config
    bw.write(1 if bd == 10 else 0, 1)   # high_bitdepth
    if profile != 1:
        bw.write(1 if mono else 0, 1)   # mono_chrome
    bw.write(0, 1)                  # color_description_present
    if mono:
        bw.write(1, 1)              # color_range (full)
    else:
        bw.write(1, 1)              # color_range (full)
        if profile == 0:
            bw.write(0, 2)          # chroma_sample_position
        bw.write(0, 1)              # separate_uv_delta_q
    bw.write(0, 1)                  # film_grain_params_present
    bw.write(1, 1)                  # trailing_bits: stop bit
    return bw.tobytes()


def _frame_header_bits(bw: BitWriter, qindex: int, mono: bool,
                       mi_rows: int, mi_cols: int):
    """Frame header fields for a reduced-still KEY frame (frame_type,
    show_frame etc. are implied)."""
    bw.write(1, 1)                  # disable_cdf_update
    bw.write(0, 1)                  # allow_screen_content_tools
    # frame_size/render: implied by reduced still (no override bit);
    # render_and_frame_size_different:
    bw.write(0, 1)
    # tile_info (5.9.15): uniform spacing, stay at the minimum
    # cols/rows log2 (single tile for any frame this encoder makes)
    bw.write(1, 1)                  # uniform_tile_spacing
    sb_cols = (mi_cols + 15) >> 4
    sb_rows = (mi_rows + 15) >> 4
    min_cols = H.tile_log2(H.MAX_TILE_WIDTH >> 6, sb_cols)
    max_cols = H.tile_log2(1, min(sb_cols, H.MAX_TILE_COLS))
    max_rows = H.tile_log2(1, min(sb_rows, H.MAX_TILE_ROWS))
    if min_cols != 0:
        raise ValueError("frame too wide for single-tile encode")
    if max_cols > 0:
        bw.write(0, 1)              # stop tile_cols increment
    if max_rows > 0:
        bw.write(0, 1)              # stop tile_rows increment
    # quantization_params
    bw.write(qindex, 8)             # base_q_idx
    bw.write(0, 1)                  # DeltaQYDc coded
    if not mono:
        bw.write(0, 1)              # diff_uv_delta? no: u dc
        bw.write(0, 1)              # u ac
    bw.write(0, 1)                  # using_qmatrix
    # segmentation
    bw.write(0, 1)                  # segmentation_enabled
    # delta_q_params (base_q_idx > 0)
    if qindex > 0:
        bw.write(0, 1)              # delta_q_present
    # loop filter: skipped when CodedLossless; else levels
    if qindex > 0:
        bw.write(0, 6)              # level[0]
        bw.write(0, 6)              # level[1]
        bw.write(0, 3)              # sharpness
        bw.write(0, 1)              # delta_enabled
    # cdef: enable_cdef=0 -> skipped; lr: enable_restoration=0
    # tx mode
    if qindex > 0:
        bw.write(0, 1)              # tx_mode_select = 0 (LARGEST)
    # frame_reference_mode / skip_mode / global motion: intra-only
    bw.write(0, 1)                  # reduced_tx_set


# ----------------------------------------------------- forward DCT
_FWD_CACHE: dict = {}


def _fwd_basis(n: int) -> np.ndarray:
    B = _FWD_CACHE.get(n)
    if B is None:
        k = np.arange(n)[:, None]
        x = np.arange(n)[None, :]
        B = np.cos((2 * x + 1) * k * np.pi / (2 * n))
        B[0] *= np.sqrt(0.5)
        B *= np.sqrt(2.0 / n)
        _FWD_CACHE[n] = B
    return B


_GAIN_CACHE: dict = {}


def _inv_gain(tx: int, bd: int) -> float:
    """Scalar alpha with inverse_transform(c) ~ alpha * idct2(c):
    calibrated once per (tx, bd) against the real decoder inverse."""
    key = (tx, bd)
    g = _GAIN_CACHE.get(key)
    if g is None:
        from ffpic_tpu_torch.coding.av1_itx import inverse_transform
        adj = C.adjusted_tx_size(tx)
        aw, ah = C.TX_W[adj], C.TX_H[adj]
        rng = np.random.default_rng(0)
        c = rng.integers(-2000, 2000, (ah, aw)).astype(np.int64)
        r = inverse_transform(c, tx, C.DCT_DCT, bd, False)
        Bh = _fwd_basis(r.shape[0])
        Bw = _fwd_basis(r.shape[1])
        c_back = Bh @ r.astype(np.float64) @ Bw.T
        # c_back ~ alpha * upsampled(c); compare on the coded area
        num = float((c_back[:ah, :aw] * c).sum())
        den = float((c * c).sum())
        g = _GAIN_CACHE[key] = num / den
    return g


def _fwht4x4(res: np.ndarray) -> np.ndarray:
    """Exact forward 4x4 WHT (inverse of av1_itx.inv_wht4x4 without
    the unit-quant factor — the x4 dequant and the iwht's >>2
    pre-shift cancel)."""
    x = res.astype(np.int64)
    out = np.zeros((4, 4), np.int64)
    for cix in range(4):
        a, b, c, d = (int(x[0, cix]), int(x[1, cix]),
                      int(x[2, cix]), int(x[3, cix]))
        a += b
        d -= c
        e = (a - d) >> 1
        b = e - b
        c = e - c
        a -= c
        d += b
        out[0, cix], out[1, cix] = a, c
        out[2, cix], out[3, cix] = d, b
    fin = np.zeros((4, 4), np.int64)
    for r in range(4):
        a, b, c, d = (int(out[r, 0]), int(out[r, 1]),
                      int(out[r, 2]), int(out[r, 3]))
        a += b
        d -= c
        e = (a - d) >> 1
        b = e - b
        c = e - c
        a -= c
        d += b
        fin[r] = (a, c, d, b)
    return fin


# -------------------------------------------------------- tile encode
class TileEncoder:
    """Mirror of av1_tile.TileDecoder for the emitted feature set:
    same FrameState grids, same ctx derivations, encode instead of
    decode."""

    def __init__(self, fs: FrameState, planes, qindex: int):
        self.fs = fs
        self.seq = fs.seq
        self.fh = fs.fh
        self.enc = MsacEnc(allow_update=False)
        self.cdf = fresh_cdf(qctx_for_base_q(qindex))
        self.qindex = qindex
        self.src = planes              # list of int32 (H, W)
        sb4 = fs.sb4
        bd = fs.seq.bit_depth
        # reconstruction buffers, SB-padded like the decoder's
        w = fs.mi_cols * 4
        h = fs.mi_rows * 4
        aw = -(-w // (sb4 * 4)) * sb4 * 4
        ah = -(-h // (sb4 * 4)) * sb4 * 4
        self.rec = [np.zeros((ah, aw), np.int32)]
        if fs.seq.num_planes > 1:
            cw = aw >> fs.seq.subsampling_x
            ch = ah >> fs.seq.subsampling_y
            self.rec += [np.zeros((ch, cw), np.int32),
                         np.zeros((ch, cw), np.int32)]
        self.r0, self.r1 = 0, fs.mi_rows
        self.c0, self.c1 = 0, fs.mi_cols
        mc = fs.mi_cols
        np_ = fs.seq.num_planes
        self.a_coef = [np.zeros(mc + 32, np.uint8) for _ in range(np_)]
        self.l_coef = [np.zeros(sb4 + 32, np.uint8) for _ in range(np_)]
        self.sb_row = 0
        qdc = TABLES[f"q_dc{bd}"].astype(np.int64)
        qac = TABLES[f"q_ac{bd}"].astype(np.int64)
        self.q_dc = int(qdc[qindex])
        self.q_ac = int(qac[qindex])
        self.clip = 1 << (bd + 7)
        self.pix_max = (1 << bd) - 1

    # --------------------------------------------------------- walk
    def encode(self):
        fs = self.fs
        sb4 = fs.sb4
        for r in range(self.r0, self.r1, sb4):
            for p in range(len(self.l_coef)):
                self.l_coef[p][:] = 0
            self.sb_row = r
            for c in range(self.c0, self.c1, sb4):
                self._partition(r, c, C.BLOCK_64X64)

    def _partition(self, r, c, bsize):
        fs = self.fs
        if r >= fs.mi_rows or c >= fs.mi_cols:
            return
        w4 = C.BLOCK_W4[bsize]
        half = w4 >> 1
        has_rows = (r + half) < fs.mi_rows
        has_cols = (c + half) < fs.mi_cols
        if bsize < C.BLOCK_8X8:
            self._block(r, c, bsize)
            return
        full = has_rows and has_cols
        ctx, wlog = self._partition_ctx(r, c, bsize)
        cdf = self.cdf.mode_np["partition"][wlog - 1][ctx]
        if full:
            part = (C.PARTITION_NONE
                    if bsize <= C.BLOCK_16X16
                    else C.PARTITION_SPLIT)
            n = (4 if bsize == C.BLOCK_8X8 else
                 8 if bsize == C.BLOCK_128X128 else 10)
            self.enc.encode_symbol(_row(cdf, n), part)
        elif has_cols or has_rows:
            # split_or_horz / split_or_vert bool.  At a partial
            # 16x16 node choose the NON-split half (a 16x8/8x16
            # block overhanging the frame) — descending to a
            # PARTIAL 8x8 node would need a split bool whose spec
            # probability references partition kinds the 4-symbol
            # 8x8 family lacks (libaom asserts bsize > BLOCK_8X8
            # there and never emits such nodes; dav1d/libaom
            # gather different values for them)
            syms = ([C.PARTITION_VERT, C.PARTITION_SPLIT,
                     C.PARTITION_VERT_A, C.PARTITION_VERT_B,
                     C.PARTITION_HORZ_A, C.PARTITION_VERT_4]
                    if has_cols else
                    [C.PARTITION_HORZ, C.PARTITION_SPLIT,
                     C.PARTITION_HORZ_A, C.PARTITION_HORZ_B,
                     C.PARTITION_VERT_A, C.PARTITION_HORZ_4])
            n = (4 if bsize == C.BLOCK_8X8 else 10)
            psplit = _gather(_row(cdf, n), syms, n)
            leaf = bsize == C.BLOCK_16X16
            self.enc.encode_bool(0 if leaf else 1,
                                 max(1, psplit))
            if leaf:
                part = (C.PARTITION_HORZ if has_cols
                        else C.PARTITION_VERT)
            else:
                part = C.PARTITION_SPLIT
        else:
            part = C.PARTITION_SPLIT
        if part == C.PARTITION_NONE:
            self._block(r, c, bsize)
            return
        if part in (C.PARTITION_HORZ, C.PARTITION_VERT):
            sub = C.partition_subsize(part, bsize)
            self._block(r, c, sub)
            if part == C.PARTITION_HORZ and has_rows:
                self._block(r + half, c, sub)
            elif part == C.PARTITION_VERT and has_cols:
                self._block(r, c + half, sub)
            return
        sub = C.partition_subsize(C.PARTITION_SPLIT, bsize)
        self._partition(r, c, sub)
        self._partition(r, c + half, sub)
        self._partition(r + half, c, sub)
        self._partition(r + half, c + half, sub)

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

    # -------------------------------------------------------- block
    def _block(self, r, c, bsize):
        fs, seq, fh = self.fs, self.seq, self.fh
        bw4, bh4 = C.BLOCK_W4[bsize], C.BLOCK_H4[bsize]
        b = Block()
        b.mi_row, b.mi_col, b.bsize = r, c, bsize
        sx, sy = seq.subsampling_x, seq.subsampling_y
        b.has_chroma = (seq.num_planes > 1 and
                        (bw4 != 1 or sx == 0 or (c & 1)) and
                        (bh4 != 1 or sy == 0 or (r & 1)))
        avail_u = r > self.r0
        avail_l = c > self.c0
        b.avail_u, b.avail_l = avail_u, avail_l
        b.avail_uc, b.avail_lc = avail_u, avail_l
        b.tile = (self.r0, self.r1, self.c0, self.c1)
        re = min(r + bh4, fs.mi_rows)
        ce = min(c + bw4, fs.mi_cols)
        b.seg_id = 0
        b.skip = 0
        b.qindex = self.qindex
        # skip symbol (ctx from recorded skip grid)
        ctx = 0
        if avail_u and fs.skip[r - 1, c]:
            ctx += 1
        if avail_l and fs.skip[r, c - 1]:
            ctx += 1
        self.enc.encode_symbol(
            _row(self.cdf.mode_np["skip"][ctx], 2), 0)
        # y mode: DC
        am = fs.y_mode[r - 1, c] if avail_u else C.DC_PRED
        lm = fs.y_mode[r, c - 1] if avail_l else C.DC_PRED
        kcdf = self.cdf.mode_np["kf_y_mode"][
            C.INTRA_MODE_CONTEXT[am]][C.INTRA_MODE_CONTEXT[lm]]
        self.enc.encode_symbol(_row(kcdf, 13), C.DC_PRED)
        b.y_mode = C.DC_PRED
        # uv mode: DC
        if b.has_chroma:
            if fh.lossless_segs[0]:
                # lossless: CfL only when the block's chroma is a
                # single forced-4x4 TB (dav1d cfl_allowed)
                cfl_ok = (bw4 <= (1 << seq.subsampling_x) and
                          bh4 <= (1 << seq.subsampling_y))
            else:
                cfl_ok = bw4 * 4 <= 32 and bh4 * 4 <= 32
            ucdf = self.cdf.mode_np["uv_mode"][1 if cfl_ok else 0][
                C.DC_PRED]
            self.enc.encode_symbol(_row(ucdf, 14 if cfl_ok else 13),
                                   0)
            b.uv_mode = C.DC_PRED
        # record grids (subset the ctxs need)
        fs.bsize[r:re, c:ce] = bsize
        fs.y_mode[r:re, c:ce] = C.DC_PRED
        fs.skip[r:re, c:ce] = 0
        # tx: LARGEST -> no symbol
        lossless = fh.lossless_segs[0]
        b.tx_size = C.TX_4X4 if lossless else \
            C.max_tx_size_rect(bsize)
        # residual
        for plane, x, y, tx, plane_bsize in iter_tx_geometry(
                seq, fs, b):
            self._tb(plane, x, y, tx, b, plane_bsize)

    # ----------------------------------------------------------- TB
    def _tb(self, plane, x, y, tx, b, plane_bsize):
        from ffpic_tpu_torch.coding.av1_itx import inverse_transform
        fs, seq, fh = self.fs, self.seq, self.fh
        from ffpic_tpu_torch.formats import av1_intra as intra
        bd = seq.bit_depth
        sx = seq.subsampling_x if plane else 0
        sy = seq.subsampling_y if plane else 0
        rec = self.rec[plane]
        src = self.src[plane]
        w, h = C.TX_W[tx], C.TX_H[tx]
        x4, y4 = x >> 2, y >> 2
        blk_px = (b.mi_col >> sx) << 2
        blk_py = (b.mi_row >> sy) << 2
        avail_u = b.avail_uc if plane else b.avail_u
        avail_l = b.avail_lc if plane else b.avail_l
        have_above = bool(avail_u) or y > blk_py
        have_left = bool(avail_l) or x > blk_px
        max_x = ((self.c1 * 4) >> sx) - 1
        max_y = ((self.r1 * 4) >> sy) - 1
        pred = intra.predict(
            rec, x, y, w, h, C.DC_PRED, 0, -1, have_left,
            have_above, False, False, max_x, max_y, bd,
            bool(seq.enable_intra_edge_filter), 0)
        # source rect (clamped at plane edge; overhang repeats edge)
        sh, sw = src.shape
        ys = np.minimum(np.arange(y, y + h), sh - 1)
        xs = np.minimum(np.arange(x, x + w), sw - 1)
        tgt = src[np.ix_(ys, xs)].astype(np.int64)
        res = tgt - pred
        lossless = fh.lossless_segs[0]
        adj = C.adjusted_tx_size(tx)
        aw, ah = C.TX_W[adj], C.TX_H[adj]
        if lossless:
            lv = _fwht4x4(res)
            mags = np.abs(lv).astype(np.int64)
            signs = (lv < 0).astype(np.int8)
            q = np.full((4, 4), 4, np.int64)
            shift = 0
        else:
            Bh = _fwd_basis(h)
            Bw = _fwd_basis(w)
            cf = Bh @ res.astype(np.float64) @ Bw.T
            cf = cf[:ah, :aw] / _inv_gain(tx, bd)
            pels = w * h
            shift = (1 if pels > 256 else 0) + \
                (1 if pels > 1024 else 0)
            q = np.full((ah, aw), self.q_ac, np.int64)
            q[0, 0] = self.q_dc
            mags = np.minimum(
                np.round(np.abs(cf) * (1 << shift) / q), 4000
            ).astype(np.int64)
            signs = (cf < 0).astype(np.int8)
        # dequant exactly like the decoder
        deq = ((mags * q) & 0xFFFFFF) >> shift
        deq = np.where(signs, -deq, deq)
        deq = np.clip(deq, -self.clip, self.clip - 1)
        # eob in scan order
        scan = C.get_scan(tx, C.DCT_DCT)
        flat = mags.reshape(-1)
        nz = np.nonzero(flat[scan])[0]
        eob = int(nz[-1]) + 1 if len(nz) else 0
        if eob == 0:
            deq[:] = 0
        self._encode_coeffs(plane, x4, y4, tx, b, plane_bsize,
                            mags, signs, eob)
        # reconstruct (decoder-identical)
        if eob:
            r_ = inverse_transform(deq, tx, C.DCT_DCT, bd, lossless)
            blk = pred + r_
        else:
            blk = pred
        we = min(w, rec.shape[1] - x)
        he = min(h, rec.shape[0] - y)
        np.clip(blk[:he, :we], 0, self.pix_max, out=blk[:he, :we])
        rec[y:y + he, x:x + we] = blk[:he, :we]

    def _encode_coeffs(self, plane, x4, y4, tx, b, plane_bsize,
                       mags, signs, eob):
        """Mirror of av1_tile._coeffs on the encode side (DCT_DCT
        only; static CDFs)."""
        t = self.cdf
        enc = self.enc
        seq, fh = self.seq, self.fh
        ptype = 1 if plane else 0
        txs_ctx = C.TX_SIZE_CTX[tx]
        adj = C.adjusted_tx_size(tx)
        w, h = C.TX_W[adj], C.TX_H[adj]
        w4 = C.TX_W[tx] >> 2
        h4 = C.TX_H[tx] >> 2
        tw, th = C.TX_W[tx], C.TX_H[tx]
        sx = seq.subsampling_x if plane else 0
        sy = seq.subsampling_y if plane else 0
        a = self.a_coef[plane]
        l = self.l_coef[plane]
        l_base = y4 - (self.sb_row >> sy)
        cw4 = min(w4, (self.fs.mi_cols >> sx) - x4)
        ch4 = min(h4, (self.fs.mi_rows >> sy) - y4)
        # all_zero ctx
        if plane == 0:
            pbw = C.BLOCK_W4[plane_bsize] * 4
            pbh = C.BLOCK_H4[plane_bsize] * 4
            if pbw == tw and pbh == th:
                ctx = 0
            else:
                top = 0
                left = 0
                for k in range(cw4):
                    top |= int(a[x4 + k])
                for k in range(ch4):
                    left |= int(l[l_base + k])
                top &= 63
                left &= 63
                mx = min(top | left, 4)
                mn = min(min(top, left), 4)
                ctx = C.SKIP_CONTEXTS[mn][mx]
        else:
            anz = any((int(a[x4 + k]) & 63) for k in range(cw4))
            lnz = any((int(l[l_base + k]) & 63) for k in range(ch4))
            pbw = C.BLOCK_W4[plane_bsize] * 4
            pbh = C.BLOCK_H4[plane_bsize] * 4
            off = 10 if pbw * pbh > tw * th else 7
            ctx = int(anz) + int(lnz) + off
        enc.encode_symbol(t["txb_skip"][txs_ctx][ctx],
                          1 if eob == 0 else 0)
        if eob == 0:
            a[x4:x4 + cw4] = 0
            l[l_base:l_base + ch4] = 0
            return
        # tx type symbol (DCT_DCT) when the set allows choice
        if not fh.lossless_segs[0]:
            if plane == 0:
                tset = C.get_tx_set_intra(tx, fh.reduced_tx_set)
                qidx = H.get_qindex(fh, 0)
                if not (tset == C.TX_SET_DCTONLY or qidx <= 0):
                    inv = (C.TX_TYPE_INTRA_INV_SET1
                           if tset == C.TX_SET_INTRA_1
                           else C.TX_TYPE_INTRA_INV_SET2)
                    sym = inv.index(C.DCT_DCT)
                    row = self.cdf.intra_ext_tx_np[
                        tset - 1][C.TX_SIZE_SQR[tx]][C.DC_PRED]
                    n = 7 if tset == C.TX_SET_INTRA_1 else 5
                    enc.encode_symbol(_row(row, n), sym)
            # chroma: INTRA_MODE_TO_TX_TYPE[DC] = DCT -> no symbol
        # eob position
        scan = C.get_scan(tx, C.DCT_DCT)
        area = w * h
        emul = (w.bit_length() - 1) + (h.bit_length() - 1) - 4
        eob_cdf = t[f"eob_pt_{16 << emul}"][ptype][0]
        eob_pt = (eob - 1).bit_length() + 1 if eob > 1 else eob
        # eob_pt: 1 -> eob 1; k -> eob in ((1<<(k-2))+1 .. 1<<(k-1))
        enc.encode_symbol(eob_cdf, eob_pt - 1)
        if eob_pt >= 3:
            base = (1 << (eob_pt - 2)) + 1
            rest = eob - base
            xr = t["eob_extra"][txs_ctx][ptype][eob_pt - 3]
            hi = 1 << (eob_pt - 3)
            enc.encode_symbol(xr, 1 if rest >= hi else 0)
            if rest >= hi:
                rest -= hi
            for i in range(1, eob_pt - 2):
                sh = eob_pt - 2 - 1 - i
                enc.encode_bool((rest >> sh) & 1)
        # base levels, reverse scan
        flat_m = mags.reshape(-1)
        lv = np.zeros((h + 5, w + 5), np.int32)
        base_eob_cdf = t["coeff_base_eob"][txs_ctx][ptype]
        base_cdf = t["coeff_base"][txs_ctx][ptype]
        br_cdf = t["coeff_br"][min(txs_ctx, 3)][ptype]
        offtab = C.lo_ctx_offset_table(tw, th)
        for ci in range(eob - 1, -1, -1):
            pos = int(scan[ci])
            row = pos // w
            col = pos - row * w
            mag = int(flat_m[pos])
            if ci == eob - 1:
                if ci == 0:
                    bctx = 0
                elif ci <= area // 8:
                    bctx = 1
                elif ci <= area // 4:
                    bctx = 2
                else:
                    bctx = 3
                enc.encode_symbol(base_eob_cdf[bctx],
                                  min(mag, 3) - 1)
            else:
                if pos == 0:
                    bctx = 0
                else:
                    s = (min(int(lv[row, col + 1]), 3)
                         + min(int(lv[row + 1, col]), 3)
                         + min(int(lv[row + 1, col + 1]), 3)
                         + min(int(lv[row, col + 2]), 3)
                         + min(int(lv[row + 2, col]), 3))
                    bctx = min((s + 1) >> 1, 4) + \
                        offtab[min(row, 4)][min(col, 4)]
                enc.encode_symbol(base_cdf[bctx], min(mag, 3))
            if mag > 2:
                m2 = (int(lv[row, col + 1]) + int(lv[row + 1, col])
                      + int(lv[row + 1, col + 1]))
                bmag = min((m2 + 1) >> 1, 6)
                if pos == 0:
                    brctx = bmag
                else:
                    brctx = bmag + (7 if (row < 2 and col < 2)
                                    else 14)
                left_br = min(mag, 15) - 3
                for k in range(4):
                    v = min(left_br, 3)
                    enc.encode_symbol(br_cdf[brctx], v)
                    left_br -= v
                    if v < 3:
                        break
            lv[row, col] = min(mag, 15)
        # signs + golomb, forward scan
        cul = 0
        dc_cat = 0
        for ci in range(eob):
            pos = int(scan[ci])
            mag = int(flat_m[pos])
            sign = int(signs.reshape(-1)[pos]) if mag else 0
            if mag:
                if ci == 0:
                    dcs = 0
                    for k in range(cw4):
                        v = int(a[x4 + k]) >> 6
                        dcs += 1 if v == 2 else (-1 if v == 1 else 0)
                    for k in range(ch4):
                        v = int(l[l_base + k]) >> 6
                        dcs += 1 if v == 2 else (-1 if v == 1 else 0)
                    sctx = 0 if dcs == 0 else (1 if dcs < 0 else 2)
                    enc.encode_symbol(t["dc_sign"][ptype][sctx],
                                      sign)
                else:
                    enc.encode_bool(sign)
            if mag > 14:
                enc.encode_golomb(mag - 15)
            if ci == 0:
                dc_cat = 0 if mag == 0 else (1 if sign else 2)
            cul += mag
        cul = min(cul, 63)
        av = cul | (dc_cat << 6)
        a[x4:x4 + cw4] = av
        l[l_base:l_base + ch4] = av


def _row(arr, n):
    """numpy mode arena row -> mutable list [p0..pn-2, 0, counter]
    (static CDFs: no adaptation, so a throwaway list is fine)."""
    return [int(v) for v in arr[:n - 1]] + [0, 0]


def _gather(cdf, syms, n):
    total = 0
    for s in syms:
        if s >= n:
            continue
        hi = 32768 if s == 0 else cdf[s - 1]
        lo = 0 if s == n - 1 else cdf[s]
        total += hi - lo
    return total


# --------------------------------------------------------- top level
def encode_av1(planes, bit_depth=8, subsampling=(1, 1),
               qindex=40, monochrome=False) -> bytes:
    """Encode YUV planes (list of (H, W) arrays; full-size luma +
    subsampled chroma, or one plane for monochrome) into a
    still-picture AV1 OBU sequence.  qindex 0 = lossless."""
    y = np.asarray(planes[0])
    h, w = y.shape
    sx, sy = (0, 0) if monochrome else subsampling
    seq = H.SequenceHeader()
    seq.profile = 0 if (monochrome or (sx and sy)) else 1
    seq.still_picture = True
    seq.reduced_still_picture_header = True
    seq.bit_depth = bit_depth
    seq.mono_chrome = monochrome
    seq.num_planes = 1 if monochrome else 3
    seq.subsampling_x, seq.subsampling_y = sx, sy
    seq.use_128x128_superblock = False
    seq.enable_filter_intra = False
    seq.enable_intra_edge_filter = True
    seq.enable_cdef = False
    seq.enable_restoration = False
    fh = H.FrameHeader()
    fh.width, fh.height = w, h
    # spec compute_image_size: mi dims are 8px-aligned (always even)
    fh.mi_cols = 2 * ((w + 7) >> 3)
    fh.mi_rows = 2 * ((h + 7) >> 3)
    fh.base_q_idx = qindex
    fh.frame_is_intra = True
    fh.allow_screen_content_tools = False
    fh.allow_intrabc = False
    fh.segmentation_enabled = False
    fh.seg_id_pre_skip = False
    fh.last_active_seg_id = 0
    fh.delta_q_present = False
    fh.delta_lf_present = False
    fh.delta_lf_multi = False
    fh.disable_cdf_update = True
    fh.tx_mode = H.TX_MODE_LARGEST
    fh.reduced_tx_set = False
    fh.coded_lossless = qindex == 0
    fh.all_lossless = qindex == 0
    fh.lossless_segs = [qindex == 0] * 8
    fh.delta_q_y_dc = 0
    fh.delta_q_u_dc = 0
    fh.delta_q_u_ac = 0
    fh.delta_q_v_dc = 0
    fh.delta_q_v_ac = 0
    fs = FrameState(seq, fh)
    src = [np.asarray(p).astype(np.int32) for p in planes]
    te = TileEncoder(fs, src, qindex)
    te.encode()
    tile = te.enc.done()
    # frame OBU: header bits + byte alignment, then the tile data
    bw = BitWriter()
    _frame_header_bits(bw, qindex, monochrome, fh.mi_rows,
                       fh.mi_cols)
    frame_payload = bw.tobytes() + tile
    out = _obu(H.OBU_TEMPORAL_DELIMITER, b"")
    out += _obu(H.OBU_SEQUENCE_HEADER,
                _seq_header(w, h, bit_depth, monochrome, sx, sy))
    out += _obu(H.OBU_FRAME, frame_payload)
    return out
