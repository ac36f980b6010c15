"""AV1 intra-frame reconstruction: frame driver, per-TB intra
prediction replay, inverse transforms, CfL (spec 7.11-7.13); in-loop
filters (deblock/CDEF/restoration, spec 7.14-7.17) staged in
av1_loopfilter.py.

Drives ffpic_tpu/coding/av1_tile.py's parse pass, then replays the
transform-block geometry in decode order: prediction from
reconstructed neighbors (availability via the spec's per-superblock
BlockDecoded bitmaps), residual add, clip.  The C reference
(junka/ffpic) decodes no AV1 pixels (avif.c:382-405 stub);
conformance oracle is dav1d (tests/test_av1.py), staged per in-loop
filter via its inloop_filters mask.

Copied from ``ffpic_tpu/formats/av1_recon.py`` for the PyTorch port
whole (``decode_frame``, ``_decode_tile_group``, ``_SbDecoded``,
``_precompute_residuals``, ``_reconstruct_native``, ``_reconstruct``,
``_recon_block``, ``_recon_inter_block``, ``_ibc_predict`` and
``Av1Decoder``), with its imports rewritten to the port's modules and
these changes:

* ``_reconstruct`` always takes the native ``av1_recon`` for an intra
  frame parsed on a C route (the reference also needs its library
  loaded and ``FFPIC_AV1_NO_NATIVE`` unset); a ``FrameState`` with
  ``force_python`` set, or ``FFPIC_AV1_BLOCK_NATIVE`` on a frame with
  intra block copy, takes the Python ``_recon_block`` as in the
  reference;
* host spans (``utils/trace.stage``), in ``decode_frame`` and
  ``Av1Decoder`` alike: ``av1.headers`` (the OBUs, the sequence and
  frame headers), ``av1.parse`` (a tile group's symbols), ``av1.recon``
  (prediction, transforms and the residual add), ``av1.mc`` (an inter
  block's motion-compensated prediction, ``av1_mc``; inside
  ``av1.recon``), ``av1.grain`` (film grain synthesis and blend of a
  shown frame) and the in-loop filters' in ``av1_loopfilter``.
"""

from __future__ import annotations

import os

import numpy as np

from ffpic_tpu_torch.coding import av1_headers as H
from ffpic_tpu_torch.coding import av1_consts as C
from ffpic_tpu_torch.coding.av1_tile import (FrameState, TileDecoder,
                                             iter_tx_geometry)
from ffpic_tpu_torch.coding.av1_itx import inverse_transform
from ffpic_tpu_torch.formats import av1_intra as intra
from ffpic_tpu_torch.utils.trace import stage


def decode_frame(obus_data: bytes, apply_filters: bool = True,
                 filter_stages: int = 7):
    """Decode the first frame of a raw OBU stream.

    Returns (planes, meta): [Y] or [Y, U, V] uint8/uint16 numpy
    arrays plus header info.  filter_stages is a bitmask (1 = deblock,
    2 = CDEF, 4 = loop restoration) matching dav1d's inloop_filters
    enum, for stage-by-stage differential testing.
    """
    seq = None
    fs = None
    with stage("av1.headers"):
        obus = H.parse_obus(obus_data)
    for obu in obus:
        ot = obu["type"]
        if ot == H.OBU_SEQUENCE_HEADER:
            with stage("av1.headers"):
                seq = H.parse_sequence_header(obu["payload"])
        elif ot in (H.OBU_FRAME, H.OBU_FRAME_HEADER):
            if seq is None:
                raise ValueError("frame before sequence header")
            payload = obu["payload"]
            with stage("av1.headers"):
                fh, bitpos = H.parse_frame_header(payload, seq)
            fs = FrameState(seq, fh)
            if ot == H.OBU_FRAME:
                # frame_obu = frame_header + byte_alignment +
                # tile_group (spec 5.10) — the tail is one whole
                # tile_group_obu payload
                tile_data = payload[(bitpos + 7) >> 3:]
                with stage("av1.parse"):
                    _decode_tile_group(fs, tile_data)
                break
            # separate OBU_FRAME_HEADER: tiles follow in one or more
            # OBU_TILE_GROUPs
        elif ot == H.OBU_TILE_GROUP:
            if fs is None:
                raise ValueError("tile group before frame header")
            ntiles = fs.fh.tile_cols * fs.fh.tile_rows
            with stage("av1.parse"):
                done = _decode_tile_group(fs, obu["payload"])
            if done >= ntiles:
                break
    if fs is None:
        raise ValueError("no frame in OBU stream")
    with stage("av1.recon"):
        planes = _reconstruct(fs)
    if apply_filters:
        from ffpic_tpu_torch.formats.av1_loopfilter import apply_loop_filters
        planes = apply_loop_filters(fs, planes, filter_stages)
    meta = dict(width=fs.fh.width, height=fs.fh.height,
                bit_depth=seq.bit_depth,
                mono=seq.mono_chrome,
                subsampling=(seq.subsampling_x, seq.subsampling_y),
                color_primaries=seq.color_primaries,
                transfer_characteristics=seq.transfer_characteristics,
                matrix_coefficients=seq.matrix_coefficients,
                color_range=seq.color_range)
    w, h = fs.fh.width, fs.fh.height
    out = [planes[0][:h, :w]]
    if len(planes) > 1:
        cw = (w + seq.subsampling_x) >> seq.subsampling_x
        ch = (h + seq.subsampling_y) >> seq.subsampling_y
        out += [p[:ch, :cw] for p in planes[1:]]
    return out, meta


def _decode_tile_group(fs: FrameState, data: bytes):
    """Decode one tile_group_obu payload.  A frame's tiles may arrive
    split across SEVERAL tile-group OBUs (tile_start_and_end_present,
    spec 5.11.1) — each call decodes its [tg_start, tg_end] range and
    returns the next expected tile number."""
    from ffpic_tpu_torch.utils.bitstream import BitReader
    fh = fs.fh
    num_tiles = fh.tile_cols * fh.tile_rows
    r = BitReader(data)
    tg_start, tg_end = 0, num_tiles - 1
    if num_tiles > 1:
        flag = r.read_bit()
        if flag:
            bits = fh.tile_cols_log2 + fh.tile_rows_log2
            tg_start = r.read_bits(bits)
            tg_end = r.read_bits(bits)
    r.align_byte()
    pos = r.byte_offset
    for tn in range(tg_start, tg_end + 1):
        last = tn == tg_end
        if last:
            size = len(data) - pos
        else:
            size = int.from_bytes(
                data[pos:pos + fh.tile_size_bytes], "little") + 1
            pos += fh.tile_size_bytes
        tile = data[pos:pos + size]
        pos += size
        trow, tcol = divmod(tn, fh.tile_cols)
        td = TileDecoder(
            fs, tile,
            fh.mi_row_starts[trow], fh.mi_row_starts[trow + 1],
            fh.mi_col_starts[tcol], fh.mi_col_starts[tcol + 1])
        td.decode()
        if tn == fh.context_update_tile_id and \
                not fh.disable_frame_end_update_cdf:
            # frame-end CDF snapshot (spec: the state after the
            # context-update tile, counters zeroed)
            fs.saved_cdf = td.cdf
    return tg_end + 1


# ------------------------------------------------------------------ recon
class _SbDecoded:
    """Spec BlockDecoded bitmaps for one superblock (per plane),
    with the -1 halo row/column (spec 5.11.30)."""

    def __init__(self, seq, sb4):
        self.sb4 = sb4
        self.maps = []
        for plane in range(seq.num_planes):
            sx = seq.subsampling_x if plane else 0
            sy = seq.subsampling_y if plane else 0
            h = (sb4 >> sy) + 2
            w = (sb4 >> sx) + 2
            self.maps.append(np.zeros((h + 1, w + 1), np.uint8))
        self.seq = seq

    def reset(self, sb_r, sb_c, tile):
        r0, r1, c0, c1 = tile
        for plane, m in enumerate(self.maps):
            sx = self.seq.subsampling_x if plane else 0
            sy = self.seq.subsampling_y if plane else 0
            m[:] = 0
            sb_w4 = ((c1 - sb_c) + sx) >> sx
            sb_h4 = ((r1 - sb_r) + sy) >> sy
            # above halo: available up to the tile's right edge
            m[0, 1:1 + min(sb_w4, m.shape[1] - 1)] = 1
            m[0, 0] = 1
            # left halo
            m[1:1 + min(sb_h4, m.shape[0] - 1), 0] = 1
            m[0, 0] = 1
            # bottom-left corner past the SB is never available
            m[min((self.sb4 >> sy) + 1, m.shape[0] - 1), 0] = 0

    def get(self, plane, rel_y4, rel_x4) -> bool:
        m = self.maps[plane]
        y, x = rel_y4 + 1, rel_x4 + 1
        if y < 0 or x < 0 or y >= m.shape[0] or x >= m.shape[1]:
            return False
        return bool(m[y, x])

    def mark(self, plane, rel_y4, rel_x4, h4, w4):
        m = self.maps[plane]
        m[rel_y4 + 1:rel_y4 + 1 + h4,
          rel_x4 + 1:rel_x4 + 1 + w4] = 1


def _is_smooth(mode: int) -> bool:
    return mode in (C.SMOOTH_PRED, C.SMOOTH_V_PRED, C.SMOOTH_H_PRED)


def _filter_type(fs, b, plane) -> int:
    """Spec 7.11.2.8 get_filter_type: 1 if an above/left neighbor
    block uses smooth prediction.  For chroma the neighbors are those
    of the CHROMA block (whose origin is the sub-8x8 pair's first mi),
    checked against the uv-mode array (propagated over the pair)."""
    r, c = b.mi_row, b.mi_col
    if plane == 0:
        above_ok, left_ok = b.avail_u, b.avail_l
        modes = fs.y_mode
    else:
        above_ok, left_ok = b.avail_uc, b.avail_lc
        modes = fs.uv_mode
        sy = fs.seq.subsampling_y
        sx = fs.seq.subsampling_x
        if sy and C.BLOCK_H4[b.bsize] == 1:
            r -= r & 1
        if sx and C.BLOCK_W4[b.bsize] == 1:
            c -= c & 1
    above = left = 0
    if above_ok:
        above = _is_smooth(int(modes[r - 1, c]))
    if left_ok:
        left = _is_smooth(int(modes[r, c - 1]))
    return int(above or left)


def _precompute_residuals(fs: FrameState):
    """Residuals depend only on coefficients, never on prediction, so
    every TU's inverse transform runs BEFORE the sequential intra
    wavefront — grouped by (tx_size, tx_type, lossless) into one
    lane-vectorized network application each
    (av1_itx.inverse_transform_batch)."""
    from ffpic_tpu_torch.coding.av1_itx import inverse_transform_batch
    bd = fs.seq.bit_depth
    groups = {}
    for tb in fs.tbs:
        groups.setdefault((tb.tx_size, tb.tx_type, tb.lossless),
                          []).append(tb)
    for (tx, tt, lossless), tbs in groups.items():
        res = inverse_transform_batch(
            np.stack([tb.coeffs for tb in tbs]), tx, tt, bd, lossless)
        for i, tb in enumerate(tbs):
            tb.residual = res[i]


_OP_NF = 21
(_OP_PLANE, _OP_X, _OP_Y, _OP_W, _OP_H, _OP_KIND, _OP_P1, _OP_HL,
 _OP_HA, _OP_HAR, _OP_HBL, _OP_MAXX, _OP_MAXY, _OP_CFL_ALPHA,
 _OP_FT, _OP_EEF, _OP_RES, _OP_MLW, _OP_MLH, _OP_SUBX,
 _OP_SUBY) = range(_OP_NF)
_K_DC, _K_DIR, _K_SMOOTH, _K_SMOOTH_V, _K_SMOOTH_H, _K_PAETH, \
    _K_FILTER, _K_PAL = range(8)

_KIND_OF_MODE = {C.SMOOTH_PRED: _K_SMOOTH, C.SMOOTH_V_PRED:
                 _K_SMOOTH_V, C.SMOOTH_H_PRED: _K_SMOOTH_H,
                 C.PAETH_PRED: _K_PAETH}

_RECON_TABLES = None


def _recon_tables():
    """Prediction tables for the C executor, built once from the
    Python single source of truth (av1_consts)."""
    global _RECON_TABLES
    if _RECON_TABLES is None:
        dr = np.zeros(91, np.int32)
        for k, v in C.DR_INTRA_DERIVATIVE.items():
            dr[k] = v
        smw = np.zeros(124, np.int32)
        off = {4: 0, 8: 4, 16: 12, 32: 28, 64: 60}
        for s, o in off.items():
            smw[o:o + s] = C.SM_WEIGHTS[s]
        taps = np.ascontiguousarray(
            np.asarray(C.INTRA_FILTER_TAPS, np.int32))
        _RECON_TABLES = (dr, smw, taps)
    return _RECON_TABLES


def _reconstruct_native(fs: FrameState, planes):
    """Run the sequential prediction+residual wavefront in C
    (native/host_av1.c:av1_recon), mirroring the host_hevc
    execute_ops design.  The op list was emitted DURING the parse
    walk (av1_tile._residual_native — every control decision is
    symbol- and pixel-independent).  The batched inverse transforms
    run here fused with the offset fill-in: each (tx, type, lossless)
    group's batch output IS the residual storage, so the per-TB
    residual views/copies of the two-pass form are gone."""
    from ffpic_tpu_torch.coding.av1_itx import inverse_transform_batch
    from ffpic_tpu_torch import native
    seq = fs.seq
    if not fs.recon_ops:
        return
    op_arr = np.ascontiguousarray(np.concatenate(fs.recon_ops))
    bd = seq.bit_depth
    chunks = []
    res_total = 0
    # object-form TBs (per-block native / mixed fallback paths)
    if fs.tbs:
        groups: dict = {}
        tbs = fs.tbs
        for i, tb in enumerate(tbs):
            groups.setdefault((tb.tx_size, tb.tx_type, tb.lossless),
                              []).append(i)
        op_of = fs.op_of_tb
        for (tx, tt, lossless), idxs in groups.items():
            batch = np.stack([tbs[i].coeffs for i in idxs])
            res = inverse_transform_batch(batch, tx, tt, bd, lossless)
            sz = res.shape[1] * res.shape[2]
            for j, i in enumerate(idxs):
                op_arr[op_of[i], _OP_RES] = res_total + j * sz
            res_total += res.shape[0] * sz
            chunks.append(res.reshape(-1))
    # array-form TB metadata (whole-SB native parse): group + gather
    # vectorized — columns (plane,x,y,tx,off,eob,tt,op_row,lossless)
    if fs.tbmeta_chunks:
        meta = np.concatenate(fs.tbmeta_chunks)
        coef_all = np.concatenate(fs.coef_chunks)
        key = (meta[:, 3].astype(np.int64) * 64
               + meta[:, 6] * 2 + meta[:, 8])
        order = np.argsort(key, kind="stable")
        ks, starts = np.unique(key[order], return_index=True)
        bounds = list(starts) + [len(order)]
        for gi in range(len(ks)):
            idxs = order[bounds[gi]:bounds[gi + 1]]
            tx = int(meta[idxs[0], 3])
            tt = int(meta[idxs[0], 6])
            lossless = bool(meta[idxs[0], 8])
            adj = C.adjusted_tx_size(tx)
            aw, ah = C.TX_W[adj], C.TX_H[adj]
            batch = coef_all[meta[idxs, 4, None]
                             + np.arange(aw * ah)].reshape(-1, ah, aw)
            res = inverse_transform_batch(batch, tx, tt, bd, lossless)
            sz = res.shape[1] * res.shape[2]
            op_arr[meta[idxs, 7], _OP_RES] = \
                res_total + np.arange(len(idxs)) * sz
            res_total += res.shape[0] * sz
            chunks.append(res.reshape(-1))
    res_buf = (np.concatenate(chunks) if chunks
               else np.zeros(1, np.int32))
    pal_buf = (np.ascontiguousarray(np.concatenate(fs.pal_chunks))
               if fs.pal_chunks else np.zeros(1, np.int32))
    dr, smw, taps = _recon_tables()
    pw = np.asarray([p.shape[1] for p in planes] + [0, 0],
                    np.int32)[:3]
    ph = np.asarray([p.shape[0] for p in planes] + [0, 0],
                    np.int32)[:3]
    native.av1_recon(op_arr, planes, pw, ph, res_buf, dr, smw, taps,
                     pal_buf, seq.bit_depth)


def _reconstruct(fs: FrameState):
    seq = fs.seq
    bd = seq.bit_depth
    dt = np.uint8 if bd == 8 else np.uint16
    w = fs.mi_cols * 4
    h = fs.mi_rows * 4
    sb4 = fs.sb4
    sb_log2 = sb4.bit_length() - 1
    # superblock-aligned working extent: TBs may overhang the mi grid
    # and CfL legally reads those reconstructed overhang pixels
    # (spec MaxLumaW/H clamp); crop to the mi grid on return.
    aw = -(-w // (sb4 * 4)) * sb4 * 4
    ah = -(-h // (sb4 * 4)) * sb4 * 4
    planes = [np.zeros((ah, aw), np.int32)]
    if seq.num_planes > 1:
        cw = aw >> seq.subsampling_x
        ch = ah >> seq.subsampling_y
        planes += [np.zeros((ch, cw), np.int32),
                   np.zeros((ch, cw), np.int32)]
    if (fs.fh.frame_is_intra and not fs.force_python
            and not (fs.fh.allow_intrabc and
                     os.environ.get("FFPIC_AV1_BLOCK_NATIVE"))):
        _reconstruct_native(fs, planes)
    else:
        _precompute_residuals(fs)
        dec = _SbDecoded(seq, sb4)
        cur_sb = None
        max_luma = [4, 4]     # MaxLumaW, MaxLumaH (spec, running)
        pix_max = (1 << bd) - 1
        for b in fs.blocks:
            sb_r = (b.mi_row >> sb_log2) << sb_log2
            sb_c = (b.mi_col >> sb_log2) << sb_log2
            if (sb_r, sb_c) != cur_sb:
                dec.reset(sb_r, sb_c, b.tile)
                cur_sb = (sb_r, sb_c)
            if b.is_inter:
                _recon_inter_block(fs, planes, dec, sb_r, sb_c, b,
                                   max_luma, pix_max)
            else:
                _recon_block(fs, planes, dec, sb_r, sb_c, b,
                             max_luma, pix_max)
    out = [planes[0][:h, :w]]
    if seq.num_planes > 1:
        out += [p[:h >> seq.subsampling_y, :w >> seq.subsampling_x]
                for p in planes[1:]]
    return [p.astype(dt) for p in out]


def _recon_inter_block(fs, planes, dec, sb_r, sb_c, b, max_luma,
                       pix_max):
    """Inter block recon: whole-block motion-compensated prediction
    (av1_mc), then per-TB residual add in decode order."""
    from ffpic_tpu_torch.formats.av1_mc import predict_inter_block
    seq = fs.seq
    bd = seq.bit_depth
    lossless = fs.fh.lossless_segs[b.seg_id]
    with stage("av1.mc"):
        predict_inter_block(fs, planes, b)
    for plane, x, y, tx, plane_bsize in iter_tx_geometry(seq, fs, b):
        sx = seq.subsampling_x if plane else 0
        sy = seq.subsampling_y if plane else 0
        w, h = C.TX_W[tx], C.TX_H[tx]
        arr = planes[plane]
        tb = b.coeff_map.get((plane, x, y)) if b.coeff_map else None
        if tb is not None:
            res = tb.residual if tb.residual is not None else \
                inverse_transform(tb.coeffs, tx, tb.tx_type, bd,
                                  lossless)
            we = min(w, arr.shape[1] - x)
            he = min(h, arr.shape[0] - y)
            blk = arr[y:y + he, x:x + we] + res[:he, :we]
            np.clip(blk, 0, pix_max, out=blk)
            arr[y:y + he, x:x + we] = blk
        rel_x4 = (x >> 2) - ((sb_c >> sx) if sx else sb_c)
        rel_y4 = (y >> 2) - ((sb_r >> sy) if sy else sb_r)
        dec.mark(plane, rel_y4, rel_x4, h >> 2, w >> 2)
        if plane == 0:
            max_luma[0] = x + w
            max_luma[1] = y + h


def _ibc_predict(arr, x, y, w, h, mv, sx, sy, bd):
    """Intrabc prediction for one TB rect: whole-pel copy on luma;
    chroma scales the DV to 1/16-pel plane units and runs the spec
    two-stage convolve with the BILINEAR filter (only 0/8 fractions
    can occur for whole-pel luma DVs)."""
    mvy16 = mv[0] << (1 - sy)
    mvx16 = mv[1] << (1 - sx)
    by = y + (mvy16 >> 4)
    bx = x + (mvx16 >> 4)
    fy, fx = mvy16 & 15, mvx16 & 15
    gh = h + (1 if fy else 0)
    gw = w + (1 if fx else 0)
    if by < 0 or bx < 0 or by + gh > arr.shape[0] \
            or bx + gw > arr.shape[1]:
        raise ValueError("intrabc DV outside decoded area")
    if fx == 0 and fy == 0:
        return arr[by:by + h, bx:bx + w].copy()
    src = arr[by:by + gh, bx:bx + gw].astype(np.int64)
    r0 = 5 if bd == 12 else 3
    r1 = 14 - r0
    if fx:
        hbuf = (128 - 8 * fx) * src[:, :w] + (8 * fx) * src[:, 1:]
    else:
        hbuf = 128 * src
    hbuf = (hbuf + (1 << (r0 - 1))) >> r0
    if fy:
        vout = (128 - 8 * fy) * hbuf[:h] + (8 * fy) * hbuf[1:]
    else:
        vout = 128 * hbuf
    return ((vout + (1 << (r1 - 1))) >> r1).astype(np.int32)


def _recon_block(fs, planes, dec, sb_r, sb_c, b, max_luma, pix_max):
    seq, fh = fs.seq, fs.fh
    bd = seq.bit_depth
    lossless = fh.lossless_segs[b.seg_id]
    r0, r1, c0, c1 = b.tile
    for plane, x, y, tx, plane_bsize in iter_tx_geometry(seq, fs, b):
        sx = seq.subsampling_x if plane else 0
        sy = seq.subsampling_y if plane else 0
        w, h = C.TX_W[tx], C.TX_H[tx]
        w4, h4 = w >> 2, h >> 2
        x4, y4 = x >> 2, y >> 2
        arr = planes[plane]
        # block origin in plane pixels
        blk_px = (b.mi_col >> sx) << 2
        blk_py = (b.mi_row >> sy) << 2
        avail_u = b.avail_uc if plane else b.avail_u
        avail_l = b.avail_lc if plane else b.avail_l
        have_above = bool(avail_u) or y > blk_py
        have_left = bool(avail_l) or x > blk_px
        rel_x4 = x4 - ((sb_c >> sx) if sx else sb_c)
        rel_y4 = y4 - ((sb_r >> sy) if sy else sb_r)
        har = dec.get(plane, rel_y4 - 1, rel_x4 + w4)
        hbl = dec.get(plane, rel_y4 + h4, rel_x4 - 1)
        # tile-clamped plane bounds for edge reads
        max_x = ((c1 * 4) >> sx) - 1
        max_y = ((r1 * 4) >> sy) - 1
        if plane == 0:
            mode = b.y_mode
            angle = b.angle_y
            fim = b.filter_intra_mode
        else:
            mode = b.uv_mode
            angle = b.angle_uv
            fim = -1
        is_cfl = plane > 0 and mode == C.UV_CFL_PRED
        pred_mode = C.DC_PRED if is_cfl else mode
        pal = b.pal_y if plane == 0 else \
            (b.pal_u if plane == 1 else b.pal_v)
        if b.use_intrabc:
            # intrabc: whole-pel block copy from the decoded frame
            # (the DV validity rules keep the source strictly behind
            # the wavefront, so per-TB copies in decode order are
            # whole-block-equivalent); chroma may land on half-pel —
            # 2-tap BILINEAR with the spec InterRound0/1 rounding
            pred = _ibc_predict(arr, x, y, w, h, b.mv, sx, sy, bd)
        elif pal:
            # palette prediction: map indices -> colors (the index
            # map covers the whole block at plane resolution)
            mp = b.pal_map_y if plane == 0 else b.pal_map_uv
            colors = np.asarray(pal, np.int32)
            pred = colors[mp[y - blk_py:y - blk_py + h,
                             x - blk_px:x - blk_px + w]]
        else:
            ft = _filter_type(fs, b, plane)
            pred = intra.predict(
                arr, x, y, w, h, pred_mode, angle, fim,
                have_left, have_above, har, hbl, max_x, max_y, bd,
                seq.enable_intra_edge_filter, ft)
        if is_cfl:
            alpha = b.cfl_alpha_u if plane == 1 else b.cfl_alpha_v
            if alpha:
                pred = intra.cfl_predict(
                    pred, planes[0], x, y, w, h, alpha, sx, sy,
                    max_luma[0], max_luma[1], bd)
        tb = b.coeff_map.get((plane, x, y))
        if tb is not None:
            res = tb.residual if tb.residual is not None else \
                inverse_transform(tb.coeffs, tx, tb.tx_type, bd,
                                  lossless)
            blk = pred + res
        else:
            blk = pred
        # clamped write (TB may overhang the mi grid edge)
        we = min(w, arr.shape[1] - x)
        he = min(h, arr.shape[0] - y)
        np.clip(blk[:he, :we], 0, pix_max, out=blk[:he, :we])
        arr[y:y + he, x:x + we] = blk[:he, :we]
        dec.mark(plane, rel_y4, rel_x4, h4, w4)
        if plane == 0:
            max_luma[0] = x + w
            max_luma[1] = y + h


# ----------------------------------------------------------- video decoder
class Av1Decoder:
    """Stateful multi-frame AV1 decoder (animated AVIF / raw OBU
    sequences): 8-slot reference management (7.20), primary-ref CDF
    carryover with frame-end snapshots, motion-field projection
    (7.9), show_existing_frame (7.21).

    The C reference has no AV1 layer at all; dav1d is the bit-exact
    per-frame oracle (tests/test_av1_inter.py)."""

    def __init__(self):
        from ffpic_tpu_torch.coding import av1_refs as R
        self.R = R
        self.seq = None
        self.refs = [None] * 8

    def decode_obus(self, data: bytes, apply_filters: bool = True):
        """Decode a temporal-unit byte stream; returns the list of
        SHOWN frames as (planes, meta)."""
        out = []
        fh = None
        fs = None
        tiles_done = 0
        with stage("av1.headers"):
            obus = H.parse_obus(data)
        for obu in obus:
            ot = obu["type"]
            if ot == H.OBU_SEQUENCE_HEADER:
                with stage("av1.headers"):
                    self.seq = H.parse_sequence_header(obu["payload"])
            elif ot in (H.OBU_FRAME, H.OBU_FRAME_HEADER):
                if self.seq is None:
                    raise ValueError("frame before sequence header")
                payload = obu["payload"]
                with stage("av1.headers"):
                    fh, bitpos = H.parse_frame_header(
                        payload, self.seq, self.refs)
                if fh.show_existing_frame:
                    frame = self._show_existing(fh)
                    if frame is not None:
                        out.append(frame)
                    fh = None
                    continue
                fs = self._new_frame_state(fh)
                tiles_done = 0
                if ot == H.OBU_FRAME:
                    tile_data = payload[(bitpos + 7) >> 3:]
                    with stage("av1.parse"):
                        _decode_tile_group(fs, tile_data)
                    frame = self._finish_frame(fs, apply_filters)
                    if frame is not None:
                        out.append(frame)
                    fh = None
                    fs = None
            elif ot == H.OBU_TILE_GROUP:
                if fs is None:
                    raise ValueError("tile group without header")
                ntiles = fs.fh.tile_cols * fs.fh.tile_rows
                with stage("av1.parse"):
                    tiles_done = _decode_tile_group(fs, obu["payload"])
                if tiles_done >= ntiles:
                    frame = self._finish_frame(fs, apply_filters)
                    if frame is not None:
                        out.append(frame)
                    fh = None
                    fs = None
        return out

    def _new_frame_state(self, fh) -> FrameState:
        fs = FrameState(self.seq, fh)
        fs.refs = self.refs
        fs.force_python = True
        if fh.primary_ref_frame != 7:      # PRIMARY_REF_NONE
            prev = self.refs[fh.ref_frame_idx[fh.primary_ref_frame]]
            if prev is None or prev.cdfs is None:
                raise ValueError("primary ref slot empty")
            fs.cdf_template = prev.cdfs
        if not fh.frame_is_intra:
            fs.motion_field = self.R.MotionField(self.seq, fh,
                                                 self.refs)
        return fs

    def _finish_frame(self, fs, apply_filters):
        seq, fh = self.seq, fs.fh
        with stage("av1.recon"):
            planes = _reconstruct(fs)
        if apply_filters:
            from ffpic_tpu_torch.formats.av1_loopfilter import \
                apply_loop_filters
            planes = apply_loop_filters(fs, planes, 7)
        w, h = fh.upscaled_width, fh.height
        cropped = [planes[0][:h, :w]]
        if len(planes) > 1:
            cw = (w + seq.subsampling_x) >> seq.subsampling_x
            ch = (h + seq.subsampling_y) >> seq.subsampling_y
            cropped += [p[:ch, :cw] for p in planes[1:]]
        # frame-end CDF selection (counters zeroed per spec)
        if not fh.disable_frame_end_update_cdf and \
                fs.saved_cdf is not None:
            cdfs = fs.saved_cdf._clone()
        elif fs.cdf_template is not None:
            cdfs = fs.cdf_template._clone()
        else:
            from ffpic_tpu_torch.coding.av1_msac import fresh_cdf
            from ffpic_tpu_torch.coding.av1_tile import qctx_for_base_q
            cdfs = fresh_cdf(qctx_for_base_q(fh.base_q_idx))
        cdfs.reset_counters()
        rf = self.R.save_frame_state(seq, fh, fs, cropped, cdfs)
        self.R.update_ref_slots(self.refs, fh, rf)
        if not fh.show_frame:
            return None
        shown = cropped
        grain = getattr(fh, "grain", None)
        if grain is not None and grain.apply_grain:
            from ffpic_tpu_torch.coding.av1_grain import apply_grain
            with stage("av1.grain"):
                shown = apply_grain(shown, grain, seq.bit_depth,
                                    seq.subsampling_x,
                                    seq.subsampling_y)
        return shown, self._meta(fh)

    def _show_existing(self, fh):
        rf = self.refs[fh.frame_to_show]
        if rf is None:
            raise ValueError("show_existing_frame: empty slot")
        if rf.frame_type == 0:             # KEY: reference loading
            for i in range(8):
                self.refs[i] = rf
        w, h = rf.upscaled_width, rf.height
        planes = [rf.planes[0][:h, :w]]
        if len(rf.planes) > 1:
            sx, sy = rf.subsampling
            planes += [p[:(h + sy) >> sy, :(w + sx) >> sx]
                       for p in rf.planes[1:]]
        grain = getattr(rf, "grain", None)
        if grain is not None and grain.apply_grain:
            from ffpic_tpu_torch.coding.av1_grain import apply_grain
            sx, sy = rf.subsampling
            with stage("av1.grain"):
                planes = apply_grain(planes, grain, rf.bit_depth,
                                     sx, sy)
        meta = self._meta(None, rf)
        return planes, meta

    def _meta(self, fh, rf=None):
        seq = self.seq
        if rf is not None:
            w, h = rf.upscaled_width, rf.height
        else:
            w, h = fh.width, fh.height
        return dict(width=w, height=h, bit_depth=seq.bit_depth,
                    mono=seq.mono_chrome,
                    subsampling=(seq.subsampling_x,
                                 seq.subsampling_y),
                    color_primaries=seq.color_primaries,
                    transfer_characteristics=
                    seq.transfer_characteristics,
                    matrix_coefficients=seq.matrix_coefficients,
                    color_range=seq.color_range)
