"""HEVC Main Still Picture *encoder* — parameter set writers, slice
syntax writer and CABAC encoding (mirror of coding/hevc_slice.py).

The reference cannot encode HEVC at all; this exists (a) as a real
feature (HEIF/HEIC encode, wired via formats/heif.py) and (b) as the
conformance-stream generator for the slice decoder's differential
tests: encoded streams are decoded by our decoder (must equal the
encoder's own reconstruction sample-exactly) and by the compiled C
reference (must match its BGRA output when deblock/SAO are off, since
the reference stubs those filters).

Encoder policy is deliberately simple (fixed QP, SAD mode decision,
pluggable split policy) — correctness and syntax coverage over rate.

Copied from ``ffpic_tpu/coding/hevc_enc.py`` for the PyTorch port, with
its imports rewritten to the port's modules.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ffpic_tpu_torch.coding.cabac_enc import BitSink, CabacEncoder
from ffpic_tpu_torch.coding.hevc_consts import (SIG_CTX_4X4, chroma_qp,
                                                forward_transform, quantize,
                                                scan_order)
from ffpic_tpu_torch.coding.hevc_slice import (_CTX_SET, Contexts, INTRA_DC,
                                               INTRA_PLANAR, TU)
from ffpic_tpu_torch.formats import hevc_recon
from ffpic_tpu_torch.utils.bitstream import BitWriter

# ---------------------------------------------------------------------------
# RBSP / NALU plumbing
# ---------------------------------------------------------------------------


def write_ue(w: BitWriter, v: int) -> None:
    v += 1
    n = v.bit_length()
    w.write_bits(0, n - 1)
    w.write_bits(v, n)


def write_se(w: BitWriter, v: int) -> None:
    write_ue(w, 2 * v - 1 if v > 0 else -2 * v)


def escape_rbsp(rbsp: bytes) -> bytes:
    """Insert emulation-prevention bytes (00 00 0x -> 00 00 03 0x)."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def make_nalu(nal_type: int, rbsp: bytes) -> bytes:
    return bytes((nal_type << 1, 1)) + escape_rbsp(rbsp)


# ---------------------------------------------------------------------------
# parameter set writers (7.3.2)
# ---------------------------------------------------------------------------

def _write_ptl(w: BitWriter) -> None:
    w.write_bits(0, 2)          # profile_space
    w.write_bit(0)              # tier
    w.write_bits(1, 5)          # profile_idc: Main
    w.write_bits(0b0110 << 28, 32)  # compat flags: Main + Main10? bits 1,2
    w.write_bit(1)              # progressive_source
    w.write_bit(0)              # interlaced
    w.write_bit(1)              # non_packed
    w.write_bit(1)              # frame_only
    w.write_bits(0, 43)         # reserved
    w.write_bit(0)              # inbld / reserved
    w.write_bits(90, 8)         # level 3.0


def write_vps() -> bytes:
    w = BitWriter()
    w.write_bits(0, 4)          # vps_id
    w.write_bits(3, 2)          # base_layer_internal/available (reserved=3)
    w.write_bits(0, 6)          # max_layers_minus1
    w.write_bits(0, 3)          # max_sub_layers_minus1
    w.write_bit(1)              # temporal_id_nesting
    w.write_bits(0xFFFF, 16)    # reserved_0xffff
    _write_ptl(w)
    w.write_bit(0)              # sub_layer_ordering_info_present
    write_ue(w, 0)              # max_dec_pic_buffering_minus1
    write_ue(w, 0)              # num_reorder_pics
    write_ue(w, 0)              # max_latency_increase
    w.write_bits(0, 6)          # max_layer_id
    write_ue(w, 0)              # num_layer_sets_minus1
    w.write_bit(0)              # timing_info_present
    w.write_bit(0)              # extension
    _trail(w)
    return w.getvalue()


def _trail(w: BitWriter) -> None:
    w.write_bit(1)
    w.align_byte(0)


def write_sps(width: int, height: int, ctb_log2: int = 5,
              min_cb_log2: int = 3, min_tb_log2: int = 2,
              max_tb_log2: int = 5, max_trafo_depth: int = 2,
              sao: bool = False, strong_smoothing: bool = True,
              chroma_format: int = 1, bit_depth: int = 8,
              conf_win: tuple = (0, 0, 0, 0),
              rps_sets: int = 0, scaling_lists=None,
              pcm: dict | None = None) -> bytes:
    w = BitWriter()
    w.write_bits(0, 4)          # vps_id
    w.write_bits(0, 3)          # max_sub_layers_minus1
    w.write_bit(1)              # temporal_id_nesting
    _write_ptl(w)
    write_ue(w, 0)              # sps_id
    write_ue(w, chroma_format)
    write_ue(w, width)
    write_ue(w, height)
    if any(conf_win):
        w.write_bit(1)
        for v in conf_win:      # left, right, top, bottom (chroma units)
            write_ue(w, v)
    else:
        w.write_bit(0)
    write_ue(w, bit_depth - 8)  # bit_depth_luma_minus8
    write_ue(w, bit_depth - 8)  # bit_depth_chroma_minus8
    write_ue(w, 0)              # log2_max_poc_lsb_minus4
    w.write_bit(0)              # sub_layer_ordering_info_present
    write_ue(w, 0)
    write_ue(w, 0)
    write_ue(w, 0)
    write_ue(w, min_cb_log2 - 3)
    write_ue(w, ctb_log2 - min_cb_log2)
    write_ue(w, min_tb_log2 - 2)
    write_ue(w, max_tb_log2 - min_tb_log2)
    write_ue(w, 0)              # max_transform_hierarchy_depth_inter
    write_ue(w, max_trafo_depth)
    # scaling lists: None=off, "default"=enabled w/o data (decoder uses
    # Table 7-5/7-6 defaults), dict=explicit scaling_list_data
    if scaling_lists is None:
        w.write_bit(0)          # scaling_list_enabled
    else:
        w.write_bit(1)
        if scaling_lists == "default":
            w.write_bit(0)      # sps_scaling_list_data_present
        else:
            w.write_bit(1)
            from ffpic_tpu_torch.coding.hevc_scaling import \
                write_scaling_list_data
            write_scaling_list_data(w, scaling_lists)
    w.write_bit(0)              # amp_enabled
    w.write_bit(1 if sao else 0)
    # pcm: dict(bd_luma=, bd_chroma=, log2_min=, log2_diff=, lf_disable=)
    if pcm is None:
        w.write_bit(0)          # pcm_enabled
    else:
        w.write_bit(1)
        w.write_bits(pcm.get("bd_luma", bit_depth) - 1, 4)
        w.write_bits(pcm.get("bd_chroma", bit_depth) - 1, 4)
        write_ue(w, pcm.get("log2_min", 3) - 3)
        write_ue(w, pcm.get("log2_diff", 0))
        w.write_bit(1 if pcm.get("lf_disable", True) else 0)
    # stills normally carry 0 RPS sets, but sequence-track SPSes from
    # real encoders have them; rps_sets>0 emits simple explicit sets
    # (used by the parser test — the decoder must still reach the
    # trailing strong_intra_smoothing flag)
    write_ue(w, rps_sets)       # num_short_term_ref_pic_sets
    for idx in range(rps_sets):
        if idx != 0:
            w.write_bit(0)      # inter_ref_pic_set_prediction_flag
        write_ue(w, 1)          # num_negative_pics
        write_ue(w, 0)          # num_positive_pics
        write_ue(w, idx)        # delta_poc_s0_minus1
        w.write_bit(1)          # used_by_curr_pic_s0_flag
    w.write_bit(0)              # long_term_ref_pics_present
    w.write_bit(0)              # temporal_mvp
    w.write_bit(1 if strong_smoothing else 0)
    w.write_bit(0)              # vui
    w.write_bit(0)              # extension
    _trail(w)
    return w.getvalue()


def write_pps(init_qp: int = 26, sign_hiding: bool = False,
              transform_skip: bool = False, cu_qp_delta_depth=None,
              transquant_bypass: bool = False,
              deblocking_disabled: bool = True,
              cb_qp_offset: int = 0, cr_qp_offset: int = 0,
              dependent_slices: bool = False,
              tiles: tuple | None = None,
              wpp: bool = False) -> bytes:
    w = BitWriter()
    write_ue(w, 0)              # pps_id
    write_ue(w, 0)              # sps_id
    w.write_bit(1 if dependent_slices else 0)  # dependent_slice_segments
    w.write_bit(0)              # output_flag_present
    w.write_bits(0, 3)          # num_extra_slice_header_bits
    w.write_bit(1 if sign_hiding else 0)
    w.write_bit(0)              # cabac_init_present
    write_ue(w, 0)
    write_ue(w, 0)
    write_se(w, init_qp - 26)
    w.write_bit(0)              # constrained_intra_pred
    w.write_bit(1 if transform_skip else 0)
    w.write_bit(1 if cu_qp_delta_depth is not None else 0)
    if cu_qp_delta_depth is not None:
        write_ue(w, cu_qp_delta_depth)
    write_se(w, cb_qp_offset)
    write_se(w, cr_qp_offset)
    w.write_bit(0)              # slice_chroma_qp_offsets_present
    w.write_bit(0)              # weighted_pred
    w.write_bit(0)              # weighted_bipred
    w.write_bit(1 if transquant_bypass else 0)
    # 7.3.2.3 order: tiles_enabled, entropy_coding_sync, THEN the
    # tile geometry fields
    w.write_bit(0 if tiles is None else 1)   # tiles_enabled
    w.write_bit(1 if wpp else 0)             # entropy_coding_sync
    if tiles is not None:                    # (cols, rows) uniform
        write_ue(w, tiles[0] - 1)
        write_ue(w, tiles[1] - 1)
        w.write_bit(1)          # uniform_spacing
        w.write_bit(1)          # loop_filter_across_tiles
    w.write_bit(1)              # loop_filter_across_slices
    w.write_bit(1)              # deblocking_filter_control_present
    w.write_bit(0)              # deblocking_override_enabled
    w.write_bit(1 if deblocking_disabled else 0)
    if not deblocking_disabled:
        write_se(w, 0)
        write_se(w, 0)
    w.write_bit(0)              # scaling_list_data_present
    w.write_bit(0)              # lists_modification
    write_ue(w, 0)              # log2_parallel_merge_level_minus2
    w.write_bit(0)              # slice_header_extension
    w.write_bit(0)              # extension
    _trail(w)
    return w.getvalue()


# ---------------------------------------------------------------------------
# slice encoder
# ---------------------------------------------------------------------------

@dataclass
class EncPolicy:
    """Test-oriented coding decisions (deterministic via seed)."""
    seed: int = 0
    split_prob: float = 0.4          # CU quadtree split probability
    tt_split_prob: float = 0.25      # transform-tree split probability
    nxn_prob: float = 0.3            # NxN at min CB
    mode_candidates: tuple = (0, 1, 10, 26, 2, 18, 34, 6, 14, 22, 30)
    transform_skip_prob: float = 0.0
    bypass_prob: float = 0.0
    pcm_prob: float = 0.0            # IPCM CU probability (in-range CUs)


class SliceEncoder:
    """Encode one I slice from YUV planes, mirroring SliceDecoder."""

    def __init__(self, sps_params: dict, pps_params: dict, qp: int,
                 planes, policy: EncPolicy = None):
        from ffpic_tpu_torch.formats.hevc import parse_sps, parse_pps
        self.sps_rbsp = write_sps(**sps_params)
        self.pps_rbsp = write_pps(init_qp=qp, **pps_params)
        self.sps = parse_sps(make_nalu(33, self.sps_rbsp))
        self.pps = parse_pps(make_nalu(34, self.pps_rbsp))
        self.qp = qp
        self.src = [p.astype(np.int32) for p in planes]
        self.policy = policy or EncPolicy()
        self.rng = np.random.default_rng(self.policy.seed)
        self.pic = hevc_recon.Picture(self.sps)
        self.ctb_log2 = self.sps.ctb_log2
        self.min_cb = self.sps.log2_min_cb
        self.max_tb = self.sps.log2_min_tb + self.sps.log2_diff_max_min_tb
        self.min_tb = self.sps.log2_min_tb
        self.w, self.h = self.sps.width, self.sps.height
        self.ctbs_x = (self.w + (1 << self.ctb_log2) - 1) >> self.ctb_log2
        self.ctbs_y = (self.h + (1 << self.ctb_log2) - 1) >> self.ctb_log2
        mw, mh = (self.w + 3) // 4, (self.h + 3) // 4
        self.ct_depth = np.full((mh, mw), -1, np.int8)
        self.luma_mode = np.full((mh, mw), -1, np.int8)
        # availability zones (6.4.1): (slice_idx << 12) | tile_idx;
        # single-slice encodes stay in zone 0
        self.zone = np.full((mh, mw), -1, np.int32)
        self.cur_zone = 0
        self.ctx = Contexts(qp)
        self.enc = CabacEncoder()
        # scaling factors mirror the decoder's derivation from the
        # (just-written) SPS so the recon matches sample-exactly
        self.scaling_factors = None
        if self.sps.scaling_list_enabled:
            from ffpic_tpu_torch.coding.hevc_scaling import scaling_factors
            self.scaling_factors = scaling_factors(
                self.sps.scaling_lists)

    # -- top level ---------------------------------------------------------
    def encode(self) -> bytes:
        """Returns the complete IDR_W_RADL NALU bytes (single-segment
        picture)."""
        nalus = self.encode_picture()
        assert len(nalus) == 1
        return nalus[0]

    def encode_picture(self, n_slices: int = 1,
                       dependent_splits: int = 0) -> list:
        """Encode the picture as one NALU per slice segment, in tile
        scan order, mirroring SliceDecoder: independent slices reset
        contexts and availability zones; dependent segments carry
        contexts (9.3.1); tiles/WPP rows become substreams with entry
        points; WPP syncs contexts from the row above."""
        from ffpic_tpu_torch.coding.hevc_slice import (TileLayout,
                                                       _ctx_restore,
                                                       _ctx_snapshot)
        lay = TileLayout(self.sps, self.pps)
        wpp = self.pps.entropy_coding_sync
        n = lay.n_ctbs
        starts = [(i * n) // n_slices for i in range(n_slices)] + [n]
        segments = []
        for si in range(n_slices):
            s0, s1 = starts[si], starts[si + 1]
            k = 1 + dependent_splits
            bd = [s0 + (j * (s1 - s0)) // k for j in range(k)] + [s1]
            emitted = False      # a slice's FIRST emitted segment must
            for j in range(k):   # be independent even if earlier sub-
                if bd[j] < bd[j + 1]:   # ranges collapsed to empty
                    segments.append((bd[j], bd[j + 1], emitted, si))
                    emitted = True

        nalus = []
        self._wpp_snap = None
        self._wpp_row = -1
        self._last_zone = None
        slice_of_ctb = np.full(n, -1, np.int32)
        s4 = 1 << (self.ctb_log2 - 2)     # CTB size in 4x4 units
        for (ts0, ts1, dependent, si) in segments:
            if not dependent:
                self.ctx = Contexts(self.qp)
            subs = []
            self.enc = CabacEncoder()
            for ts in range(ts0, ts1):
                rs = int(lay.ts_to_rs[ts])
                cx, cy = rs % self.ctbs_x, rs // self.ctbs_x
                tile = int(lay.tile_of_rs[rs])
                new_tile = (ts > ts0 and tile != int(lay.tile_of_rs[
                    int(lay.ts_to_rs[ts - 1])]))
                new_row = wpp and cx == 0 and ts > ts0
                if new_tile or new_row:
                    # close substream: end_of_subset_one_bit + align
                    self.enc.terminate(1)
                    self.enc.sink.byte_align()
                    subs.append(self.enc.sink.bytes())
                    self.enc = CabacEncoder()
                    self.ctx = Contexts(self.qp)
                    if new_row:
                        ur = rs - self.ctbs_x + 1
                        if (self._wpp_snap is not None
                                and self._wpp_row == cy - 1 and ur >= 0
                                and slice_of_ctb[ur] == si):
                            _ctx_restore(self.ctx, self._wpp_snap)
                self.cur_zone = (si << 12) | tile
                slice_of_ctb[rs] = si
                if self._last_zone is not None \
                        and self.cur_zone != self._last_zone:
                    # prediction may not cross slice/tile boundaries:
                    # reset the decoded-sample masks like the decoder
                    for m in self.pic.masks:
                        m[:] = False
                self._last_zone = self.cur_zone
                self.zone[cy * s4:(cy + 1) * s4,
                          cx * s4:(cx + 1) * s4] = self.cur_zone

                x0, y0 = cx << self.ctb_log2, cy << self.ctb_log2
                self._quadtree(x0, y0, self.ctb_log2, 0)
                if wpp and cx == 1:
                    self._wpp_snap = _ctx_snapshot(self.ctx)
                    self._wpp_row = cy
                self.enc.terminate(1 if ts == ts1 - 1 else 0)
            self.enc.sink.byte_align()
            subs.append(self.enc.sink.bytes())
            w = BitWriter()
            self._write_slice_header(
                w, first=(ts0 == 0), address=int(lay.ts_to_rs[ts0]),
                dependent=dependent,
                entry_points=[len(b) for b in subs[:-1]])
            nalus.append(make_nalu(19, w.getvalue() + b"".join(subs)))
        return nalus

    def _write_slice_header(self, w: BitWriter, first: bool = True,
                            address: int = 0, dependent: bool = False,
                            entry_points=()) -> None:
        w.write_bit(1 if first else 0)      # first_slice_segment_in_pic
        w.write_bit(0)                      # no_output_of_prior_pics
        write_ue(w, 0)                      # pps_id
        if not first:
            if self.pps.dependent_slice_segments:
                w.write_bit(1 if dependent else 0)
            nbits = max(1, (self.ctbs_x * self.ctbs_y - 1).bit_length())
            w.write_bits(address, nbits)
        if not dependent:
            write_ue(w, 2)                  # slice_type I
            if self.sps.sample_adaptive_offset:
                w.write_bit(0)              # slice_sao_luma (enc: off)
                w.write_bit(0)
            write_se(w, 0)                  # slice_qp_delta
            # pps: deblocking_control_present=1, override_enabled=0 ->
            # no per-slice deblock fields
            if ((not self.pps.deblocking_disabled)
                    and self.pps.loop_filter_across_slices):
                w.write_bit(1)              # loop_filter_across_slices
        if self.pps.tiles_enabled or self.pps.entropy_coding_sync:
            write_ue(w, len(entry_points))
            if entry_points:
                ln = max(max(o - 1 for o in entry_points).bit_length(),
                         1)
                write_ue(w, ln - 1)
                for off in entry_points:
                    w.write_bits(off - 1, ln)
        w.write_bit(1)                      # byte_alignment start
        w.align_byte(0)

    def _avail(self, nx, ny):
        if nx < 0 or ny < 0 or nx >= self.w or ny >= self.h:
            return False
        return self.zone[ny // 4, nx // 4] == self.cur_zone

    # -- quadtree -----------------------------------------------------------
    def _quadtree(self, x0, y0, log2, depth):
        size = 1 << log2
        if (self.pps.cu_qp_delta_enabled and
                log2 >= self.ctb_log2 - self.pps.diff_cu_qp_delta_depth):
            self.qp_written_qg = False
        inside = x0 + size <= self.w and y0 + size <= self.h
        if inside and log2 > self.min_cb:
            split = int(self.rng.random() < self.policy.split_prob)
            ctx_inc = 0
            if self._avail(x0 - 1, y0) \
                    and self.ct_depth[y0 // 4, (x0 - 1) // 4] > depth:
                ctx_inc += 1
            if self._avail(x0, y0 - 1) \
                    and self.ct_depth[(y0 - 1) // 4, x0 // 4] > depth:
                ctx_inc += 1
            self.enc.decision(self.ctx["split_cu_flag", ctx_inc], split)
        elif log2 > self.min_cb:
            split = 1
        else:
            split = 0
        if split:
            half = size >> 1
            for (dx, dy) in ((0, 0), (half, 0), (0, half), (half, half)):
                x1, y1 = x0 + dx, y0 + dy
                if x1 < self.w and y1 < self.h:
                    self._quadtree(x1, y1, log2 - 1, depth + 1)
        else:
            self._coding_unit(x0, y0, log2, depth)

    def _pcm_cu(self, x0, y0, log2, depth):
        """Write pcm_sample (7.3.9) from the source planes; recon is
        the bit-depth-truncated source (8.4.4.1)."""
        size = 1 << log2
        sps = self.sps
        self.enc.pcm_begin()
        sh_y = sps.bit_depth_luma - sps.pcm_bit_depth_luma
        src = self.src[0][y0:y0 + size, x0:x0 + size]
        q = np.clip(src >> sh_y, 0, (1 << sps.pcm_bit_depth_luma) - 1)
        for yy in range(size):
            for xx in range(size):
                self.enc.write_raw(int(q[yy, xx]),
                                   sps.pcm_bit_depth_luma)
        self.pic.planes[0][y0:y0 + size, x0:x0 + size] = q << sh_y
        self.pic.mark_decoded(0, x0, y0, size)
        if sps.chroma_format:
            sh_c = sps.bit_depth_chroma - sps.pcm_bit_depth_chroma
            half = size >> 1
            cx, cy = x0 >> 1, y0 >> 1
            for plane in (1, 2):
                csrc = self.src[plane][cy:cy + half, cx:cx + half]
                cq = np.clip(csrc >> sh_c, 0,
                             (1 << sps.pcm_bit_depth_chroma) - 1)
                for yy in range(half):
                    for xx in range(half):
                        self.enc.write_raw(int(cq[yy, xx]),
                                           sps.pcm_bit_depth_chroma)
                self.pic.planes[plane][cy:cy + half,
                                       cx:cx + half] = cq << sh_c
                self.pic.mark_decoded(plane, cx, cy, half)
        self.enc.pcm_end()
        self.ct_depth[y0 // 4:(y0 + size) // 4,
                      x0 // 4:(x0 + size) // 4] = depth
        self.luma_mode[y0 // 4:(y0 + size) // 4,
                       x0 // 4:(x0 + size) // 4] = INTRA_DC

    # -- mode decision helpers ----------------------------------------------
    def _best_mode(self, plane, x, y, n, candidates):
        # mode decision probe only — prediction runs at TB granularity
        # (max 32), so evaluate large PUs on their top-left 32x32
        n = min(n, 32)
        src = self.src[plane][y:y + n, x:x + n]
        best, best_cost = candidates[0], None
        for m in candidates:
            pred = hevc_recon.predict_intra(self.pic, plane, x, y, n, m)
            cost = int(np.abs(src - pred).sum())
            if best_cost is None or cost < best_cost:
                best, best_cost = m, cost
        return best

    # -- coding unit ----------------------------------------------------------
    def _coding_unit(self, x0, y0, log2, depth):
        size = 1 << log2
        pol = self.policy
        bypass = bool(self.pps.transquant_bypass
                      and self.rng.random() < pol.bypass_prob)
        if self.pps.transquant_bypass:
            self.enc.decision(
                self.ctx["cu_transquant_bypass_flag", 0], int(bypass))
        # NxN needs TUs at half the CB size; illegal when that would
        # undershoot the minimum TB size (A.1 also requires
        # minTb < minCb, enforced in write_sps callers)
        part_nxn = bool(log2 == self.min_cb
                        and log2 - 1 >= self.min_tb
                        and self.rng.random() < pol.nxn_prob)
        if log2 == self.min_cb:
            self.enc.decision(self.ctx["part_mode", 0],
                              0 if part_nxn else 1)

        # IPCM (7.3.8.5): PartMode 2Nx2N within the PCM size range
        if (self.sps.pcm_enabled and not part_nxn
                and self.sps.log2_min_pcm_cb <= log2
                <= self.sps.log2_min_pcm_cb
                + self.sps.log2_diff_max_min_pcm_cb):
            do_pcm = self.rng.random() < pol.pcm_prob
            self.enc.terminate(1 if do_pcm else 0)   # pcm_flag
            if do_pcm:
                self._pcm_cu(x0, y0, log2, depth)
                return

        n_pu = 2 if part_nxn else 1
        pb = size >> (1 if part_nxn else 0)

        # phase A: walk TBs in z-order computing modes, residuals, recon
        self.cu_bypass = bypass
        self.cu_part_nxn = part_nxn
        self.cu_log2 = log2
        self.cu_max_trafo_depth = (
            self.sps.max_transform_hierarchy_depth_intra
            + (1 if part_nxn else 0))
        self.cu_modes = [[0] * n_pu for _ in range(n_pu)]
        # choose + record luma modes lazily per PU as its first TB is hit
        self.pu_done = [[False] * n_pu for _ in range(n_pu)]
        # build the transform tree structure first (decisions recorded)
        tree = self._build_tree(x0, y0, x0, y0, log2, 0, 0)
        # luma first (fixes PU modes), then chroma mode choice (DM/34
        # substitution needs luma PU0), then chroma blocks
        self._process_luma(tree)
        cmode_idx, cmode = self._choose_chroma(x0, y0, size)
        self.cu_chroma_mode = cmode
        self._process_chroma(tree)

        # phase B: write syntax.  MPM choices must be computed
        # progressively (PU k's candidates depend on PU 0..k-1 modes),
        # updating the mode map as we go, exactly like the decoder's
        # derivation order — the *writes* still group all prev flags
        # first per 7.3.8.5.
        vals = []
        for j in range(n_pu):
            for i in range(n_pu):
                xp, yp = x0 + i * pb, y0 + j * pb
                prev, val = self._encode_mode_choice(
                    xp, yp, self.cu_modes[j][i])
                vals.append((prev, val))
                self.luma_mode[yp // 4:(yp + pb) // 4,
                               xp // 4:(xp + pb) // 4] = \
                    self.cu_modes[j][i]
        for prev, _ in vals:
            self.enc.decision(
                self.ctx["prev_intra_luma_pred_flag", 0], prev)
        for prev, val in vals:
            if prev:
                # mpm_idx TR cMax=2 bypass
                if val == 0:
                    self.enc.bypass(0)
                elif val == 1:
                    self.enc.bypass(1)
                    self.enc.bypass(0)
                else:
                    self.enc.bypass(1)
                    self.enc.bypass(1)
            else:
                self.enc.bypass_n(val, 5)
        if self.sps.chroma_format:
            if cmode_idx == 4:
                self.enc.decision(
                    self.ctx["intra_chroma_pred_mode", 0], 0)
            else:
                self.enc.decision(
                    self.ctx["intra_chroma_pred_mode", 0], 1)
                self.enc.bypass_n(cmode_idx, 2)
        self.ct_depth[y0 // 4:(y0 + size) // 4,
                      x0 // 4:(x0 + size) // 4] = depth
        self._write_tree(tree, depth0=True)

    def _choose_chroma(self, x0, y0, size):
        """Pick chroma mode among the 5 encodable candidates."""
        if not self.sps.chroma_format:
            return 4, 0
        luma0 = self.cu_modes[0][0]
        cands = []
        for idx, cand in ((0, INTRA_PLANAR), (1, 26), (2, 10),
                          (3, INTRA_DC)):
            cands.append((idx, 34 if cand == luma0 else cand))
        cands.append((4, luma0))
        cx, cy, cn = x0 >> 1, y0 >> 1, size >> 1
        # evaluate on source chroma (prediction uses current recon)
        best = None
        for idx, mode in cands:
            cost = 0
            for pl in (1, 2):
                pred = hevc_recon.predict_intra(
                    self.pic, pl, cx, cy, cn, mode)
                src = self.src[pl][cy:cy + cn, cx:cx + cn]
                cost += int(np.abs(src - pred).sum())
            if best is None or cost < best[0]:
                best = (cost, idx, mode)
        return best[1], best[2]

    def _encode_mode_choice(self, xp, yp, mode):
        """Mirror of SliceDecoder._derive_luma_mode: returns
        (prev_flag, mpm_idx or rem value)."""
        def cand(nx, ny, above):
            if not self._avail(nx, ny):
                return INTRA_DC
            if above and (ny >> self.ctb_log2) != (yp >> self.ctb_log2):
                return INTRA_DC
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
        if mode in mpm:
            return 1, mpm.index(mode)
        rem = mode
        for m in sorted(mpm, reverse=True):
            if rem > m:
                rem -= 1
        return 0, rem

    # -- transform tree (two-phase) -------------------------------------------
    def _build_tree(self, x0, y0, xb, yb, log2, depth, blk_idx):
        node = {"x0": x0, "y0": y0, "xb": xb, "yb": yb, "log2": log2,
                "depth": depth, "blk_idx": blk_idx}
        explicit = (log2 <= self.max_tb and log2 > self.min_tb
                    and depth < self.cu_max_trafo_depth
                    and not (self.cu_part_nxn and depth == 0))
        if explicit:
            split = int(self.rng.random() < self.policy.tt_split_prob)
        else:
            split = int(log2 > self.max_tb
                        or (self.cu_part_nxn and depth == 0
                            and log2 > self.min_tb))
        node["split"] = split
        node["explicit_split"] = explicit
        if split:
            half = 1 << (log2 - 1)
            node["children"] = [
                self._build_tree(x0, y0, x0, y0, log2 - 1, depth + 1, 0),
                self._build_tree(x0 + half, y0, x0, y0, log2 - 1,
                                 depth + 1, 1),
                self._build_tree(x0, y0 + half, x0, y0, log2 - 1,
                                 depth + 1, 2),
                self._build_tree(x0 + half, y0 + half, x0, y0, log2 - 1,
                                 depth + 1, 3)]
        return node

    def _leaves(self, node, out):
        if node["split"]:
            for c in node["children"]:
                self._leaves(c, out)
        else:
            out.append(node)
        return out

    def _process_luma(self, tree):
        """Phase A-luma: per TB leaf in z-order — choose PU mode on
        first touch, predict from recon, transform+quant, recon."""
        pol = self.policy
        n_pu = 2 if self.cu_part_nxn else 1
        pb = (1 << self.cu_log2) >> (1 if self.cu_part_nxn else 0)
        for leaf in self._leaves(tree, []):
            x, y, log2 = leaf["x0"], leaf["y0"], leaf["log2"]
            cu_x, cu_y = tree["x0"], tree["y0"]
            pi = min((x - cu_x) // pb, n_pu - 1)
            pj = min((y - cu_y) // pb, n_pu - 1)
            if not self.pu_done[pj][pi]:
                self.pu_done[pj][pi] = True
                self.cu_modes[pj][pi] = self._best_mode(
                    0, cu_x + pi * pb, cu_y + pj * pb, pb,
                    self.policy.mode_candidates)
            mode = self.cu_modes[pj][pi]
            skip = bool(self.pps.transform_skip_enabled
                        and not self.cu_bypass and log2 == 2
                        and self.rng.random() < pol.transform_skip_prob)
            leaf["luma"] = self._code_block(0, x, y, log2, mode, skip)

    def _process_chroma(self, tree):
        """Phase A-chroma: chroma TBs in z-order (after the CU's
        chroma mode is fixed)."""
        pol = self.policy
        for leaf in self._leaves(tree, []):
            log2 = leaf["log2"]
            has_chroma = self.sps.chroma_format and (
                log2 > 2 or leaf["blk_idx"] == 3)
            if not has_chroma:
                continue
            if log2 > 2:
                cx, cy, clog2 = leaf["x0"] >> 1, leaf["y0"] >> 1, log2 - 1
            else:
                cx, cy, clog2 = leaf["xb"] >> 1, leaf["yb"] >> 1, 2
            cmode = self.cu_chroma_mode
            skc = bool(self.pps.transform_skip_enabled
                       and not self.cu_bypass and clog2 == 2
                       and self.rng.random() < pol.transform_skip_prob)
            leaf["cb"] = self._code_block(1, cx, cy, clog2, cmode, skc)
            leaf["cr"] = self._code_block(2, cx, cy, clog2, cmode, skc)

    def _code_block(self, plane, x, y, log2, mode, skip):
        """Predict/transform/quant/recon one TB; returns dict with
        levels + metadata (cbf inferred from levels)."""
        n = 1 << log2
        bd = self.pic.bd
        pred = hevc_recon.predict_intra(self.pic, plane, x, y, n, mode)
        src = self.src[plane][y:y + n, x:x + n]
        res = (src - pred).astype(np.int32)
        # quantize with Qp' (= QpY/QpC + QpBdOffset, 8.6.3) so streams
        # are spec-conforming for any decoder, not just roundtrip
        bd_off = 6 * (self.pic.bd - 8)
        if plane == 0:
            qp = self.qp + bd_off
        else:
            qpi = min(max(self.qp + (self.pps.cb_qp_offset if plane == 1
                                     else self.pps.cr_qp_offset),
                          -bd_off), 57)
            qp = chroma_qp(qpi) + bd_off
        dst = (plane == 0 and log2 == 2)
        scaling = None
        if self.scaling_factors is not None:
            from ffpic_tpu_torch.coding.hevc_scaling import factor_for
            scaling = factor_for(self.scaling_factors, n, plane)

        def _quant(coef):
            if scaling is not None:
                # fold the scaling matrix into the coefficients before
                # the flat quantizer; exactness comes from the shared
                # dequant in the recon, not quantizer precision
                sgn = np.sign(coef)
                coef = sgn * ((np.abs(coef.astype(np.int64)) * 16
                               + scaling // 2) // scaling)
                coef = np.clip(coef, -32768, 32767).astype(np.int32)
            return quantize(coef, qp, bit_depth=bd)

        if self.cu_bypass:
            levels = res.copy()
        elif skip:
            # forward mirror of the decoder's skip path: coefficient
            # domain = residual << (13 - bd)
            coef = np.clip(res.astype(np.int64) << (13 - bd), -32768,
                           32767).astype(np.int32)
            levels = _quant(coef)
        else:
            coef = forward_transform(res, dst=dst, bit_depth=bd)
            levels = _quant(coef)
        # sign-data-hiding parity fix per 4x4 sub-block
        if (self.pps.sign_data_hiding and not self.cu_bypass
                and levels.any()):
            _fix_sign_hiding(levels, log2, plane, mode)
        tu = TU(x=x, y=y, n=n, c_idx=plane, levels=levels, qp=qp,
                skip=skip, bypass=self.cu_bypass, dst=dst,
                scaling=scaling)
        resid = hevc_recon.compute_residual(tu, bd) if levels.any() \
            else None
        out = pred if resid is None else np.clip(pred + resid, 0,
                                                  (1 << bd) - 1)
        self.pic.planes[plane][y:y + n, x:x + n] = out
        self.pic.mark_decoded(plane, x, y, n)
        return {"levels": levels, "skip": skip, "mode": mode,
                "cbf": bool(levels.any())}

    # -- phase B: write the tree -------------------------------------------
    def _write_tree(self, node, depth0=False, cbf_cb_par=True,
                    cbf_cr_par=True):
        log2, depth = node["log2"], node["depth"]
        if node["explicit_split"]:
            self.enc.decision(self.ctx["split_transform_flag", 5 - log2],
                              node["split"])
        # chroma cbfs at this node
        cbf_cb, cbf_cr = cbf_cb_par, cbf_cr_par
        if self.sps.chroma_format and log2 > 2:
            cbf_cb = self._subtree_cbf(node, "cb")
            cbf_cr = self._subtree_cbf(node, "cr")
            if depth == 0 or cbf_cb_par:
                self.enc.decision(self.ctx["cbf_cb_cr", depth],
                                  int(cbf_cb))
            if depth == 0 or cbf_cr_par:
                self.enc.decision(self.ctx["cbf_cb_cr", depth],
                                  int(cbf_cr))
        if node["split"]:
            for c in node["children"]:
                self._write_tree(c, False, cbf_cb, cbf_cr)
            return
        cbf_luma = node["luma"]["cbf"]
        self.enc.decision(self.ctx["cbf_luma", 1 if depth == 0 else 0],
                          int(cbf_luma))
        # transform unit
        has_chroma = "cb" in node
        any_cbf = cbf_luma or (has_chroma and (node["cb"]["cbf"]
                                               or node["cr"]["cbf"]))
        if (any_cbf and self.pps.cu_qp_delta_enabled
                and not self.qp_written_qg):
            # cu_qp_delta_abs = 0 (fixed-QP encoder): single 0 bin
            self.enc.decision(self.ctx["cu_qp_delta_abs", 0], 0)
            self.qp_written_qg = True
        if cbf_luma:
            self._write_residual(node["x0"], node["y0"], log2, 0,
                                 node["luma"])
        if has_chroma:
            clog2 = log2 - 1 if log2 > 2 else 2
            cx = node["x0"] if log2 > 2 else node["xb"]
            cy = node["y0"] if log2 > 2 else node["yb"]
            if node["cb"]["cbf"]:
                self._write_residual(cx, cy, clog2, 1, node["cb"])
            if node["cr"]["cbf"]:
                self._write_residual(cx, cy, clog2, 2, node["cr"])

    def _subtree_cbf(self, node, key):
        if node["split"]:
            return any(self._subtree_cbf(c, key)
                       for c in node["children"])
        return node.get(key, {"cbf": False})["cbf"]

    # -- residual writer (mirror of SliceDecoder._residual) -----------------
    def _write_residual(self, x0, y0, log2, c_idx, blk):
        enc, ctx = self.enc, self.ctx
        levels = blk["levels"]
        n = 1 << log2
        mode = blk["mode"]
        if (self.pps.transform_skip_enabled and not self.cu_bypass
                and log2 == 2):
            enc.decision(ctx["transform_skip_flag", 1 if c_idx else 0],
                         int(blk["skip"]))
        if log2 == 2 or (log2 == 3 and c_idx == 0):
            if 6 <= mode <= 14:
                scan_idx = 2
            elif 22 <= mode <= 30:
                scan_idx = 1
            else:
                scan_idx = 0
        else:
            scan_idx = 0
        sub_scan = scan_order(log2 - 2, scan_idx)
        coef_scan = scan_order(2, scan_idx)
        n_sub = 1 << (log2 - 2)

        # last significant coefficient = highest scan index nonzero
        last_sb = last_pos = -1
        for i in range(len(sub_scan) - 1, -1, -1):
            sxx, syy = int(sub_scan[i][0]), int(sub_scan[i][1])
            blk16 = levels[syy * 4:syy * 4 + 4, sxx * 4:sxx * 4 + 4]
            if not blk16.any():
                continue
            for nn in range(15, -1, -1):
                xp, yp = int(coef_scan[nn][0]), int(coef_scan[nn][1])
                if blk16[yp, xp]:
                    last_sb, last_pos = i, nn
                    break
            break
        assert last_sb >= 0
        sxx, syy = int(sub_scan[last_sb][0]), int(sub_scan[last_sb][1])
        last_x = (sxx << 2) + int(coef_scan[last_pos][0])
        last_y = (syy << 2) + int(coef_scan[last_pos][1])
        wx, wy = (last_y, last_x) if scan_idx == 2 else (last_x, last_y)

        def last_prefix_of(val):
            prefix = 0
            while True:
                if prefix <= 3:
                    lo = hi = prefix
                else:
                    nb = (prefix >> 1) - 1
                    lo = (2 + (prefix & 1)) << nb
                    hi = lo + (1 << nb) - 1
                if lo <= val <= hi:
                    return prefix
                prefix += 1

        def write_last_prefix(which, prefix):
            base = ("last_sig_coeff_x_prefix" if which == 0
                    else "last_sig_coeff_y_prefix")
            if c_idx == 0:
                off = 3 * (log2 - 2) + ((log2 - 1) >> 2)
                shift = (log2 + 1) >> 2
            else:
                off = 15
                shift = log2 - 2
            c_max = (log2 << 1) - 1
            for b in range(prefix):
                enc.decision(ctx[base, (b >> shift) + off], 1)
            if prefix < c_max:
                enc.decision(ctx[base, (prefix >> shift) + off], 0)

        # spec order (7.3.8.11): both prefixes, then both suffixes
        pfx, pfy = last_prefix_of(wx), last_prefix_of(wy)
        write_last_prefix(0, pfx)
        write_last_prefix(1, pfy)
        for prefix, val in ((pfx, wx), (pfy, wy)):
            if prefix > 3:
                nb = (prefix >> 1) - 1
                enc.bypass_n(val - ((2 + (prefix & 1)) << nb), nb)

        # sub-block loop
        csbf = np.zeros((n_sub, n_sub), np.int8)
        for i in range(last_sb, -1, -1):
            sxx, syy = int(sub_scan[i][0]), int(sub_scan[i][1])
            blk16 = levels[syy * 4:syy * 4 + 4, sxx * 4:sxx * 4 + 4]
            csbf[syy, sxx] = 1 if blk16.any() else 0
        gt1_continuation = 1
        from ffpic_tpu_torch.coding.hevc_slice import SliceDecoder
        for i in range(last_sb, -1, -1):
            sxx, syy = int(sub_scan[i][0]), int(sub_scan[i][1])
            blk16 = levels[syy * 4:syy * 4 + 4, sxx * 4:sxx * 4 + 4]
            infer_dc = 0
            if i < last_sb and i > 0:
                right = csbf[syy, sxx + 1] if sxx + 1 < n_sub else 0
                below = csbf[syy + 1, sxx] if syy + 1 < n_sub else 0
                ctx_inc = min(int(right) + int(below), 1) + \
                    (2 if c_idx else 0)
                enc.decision(ctx["coded_sub_block_flag", ctx_inc],
                             int(csbf[syy, sxx]))
                infer_dc = 1
            else:
                csbf[syy, sxx] = 1
            if not csbf[syy, sxx]:
                continue
            sig = np.zeros(16, np.int8)
            for nn in range(16):
                xp, yp = int(coef_scan[nn][0]), int(coef_scan[nn][1])
                sig[nn] = 1 if blk16[yp, xp] else 0
            start_n = last_pos - 1 if i == last_sb else 15
            for nn in range(start_n, -1, -1):
                xp, yp = int(coef_scan[nn][0]), int(coef_scan[nn][1])
                xc, yc = (sxx << 2) + xp, (syy << 2) + yp
                if nn > 0 or not infer_dc:
                    ctx_inc = SliceDecoder._sig_ctx(
                        log2, c_idx, scan_idx, xc, yc, sxx, syy, csbf,
                        n_sub)
                    enc.decision(ctx["sig_coeff_flag", ctx_inc],
                                 int(sig[nn]))
                    if sig[nn]:
                        infer_dc = 0
                # inferred positions need no bits; the parity fix below
                # guarantees the inferred DC sig is consistent
            sig_pos = [nn for nn in range(15, -1, -1) if sig[nn]]
            if not sig_pos:
                # inferred-csbf sub-block (i == 0) with no coefficients:
                # all sig bins written as 0, nothing else follows
                continue
            # greater1 flags
            ctx_set = 0 if (i == 0 or c_idx > 0) else 2
            if gt1_continuation == 0:
                ctx_set += 1
            c1 = 1
            gt1 = {}
            for k, nn in enumerate(sig_pos[:8]):
                xp, yp = int(coef_scan[nn][0]), int(coef_scan[nn][1])
                f = 1 if abs(int(blk16[yp, xp])) > 1 else 0
                ctx_inc = ctx_set * 4 + min(c1, 3)
                if c_idx:
                    ctx_inc += 16
                enc.decision(ctx["coeff_abs_level_greater1_flag",
                                 ctx_inc], f)
                gt1[nn] = f
                if f:
                    c1 = 0
                elif 0 < c1 < 3:
                    c1 += 1
            gt1_continuation = c1
            first_gt1 = next((nn for nn in sig_pos[:8] if gt1[nn]),
                             None)
            gt2 = {}
            if first_gt1 is not None:
                xp = int(coef_scan[first_gt1][0])
                yp = int(coef_scan[first_gt1][1])
                f = 1 if abs(int(blk16[yp, xp])) > 2 else 0
                gt2[first_gt1] = f
                enc.decision(ctx["coeff_abs_level_greater2_flag",
                                 ctx_set + (4 if c_idx else 0)], f)
            sign_hidden = (self.pps.sign_data_hiding
                           and not self.cu_bypass
                           and (sig_pos[0] - sig_pos[-1]) > 3)
            for nn in sig_pos:
                if sign_hidden and nn == sig_pos[-1]:
                    continue
                xp, yp = int(coef_scan[nn][0]), int(coef_scan[nn][1])
                enc.bypass(1 if blk16[yp, xp] < 0 else 0)
            rice = 0
            for k, nn in enumerate(sig_pos):
                xp, yp = int(coef_scan[nn][0]), int(coef_scan[nn][1])
                lvl = abs(int(blk16[yp, xp]))
                base = 1
                if k < 8:
                    base += gt1.get(nn, 0)
                    if nn == first_gt1:
                        base += gt2.get(nn, 0)
                threshold = 3 if (k < 8 and nn == first_gt1) else \
                    (2 if k < 8 else 1)
                if base == threshold:
                    rem = lvl - base
                    # Golomb-Rice + EGk escape (9.3.3.13)
                    if (rem >> rice) < 3:
                        prefix = rem >> rice
                        for _ in range(prefix):
                            enc.bypass(1)
                        enc.bypass(0)
                        if rice:
                            enc.bypass_n(rem & ((1 << rice) - 1), rice)
                    else:
                        val = rem - (3 << rice)
                        pre = 3
                        while val >= (1 << (pre - 3 + rice)):
                            val -= (1 << (pre - 3 + rice))
                            pre += 1
                        for _ in range(pre):
                            enc.bypass(1)
                        if pre < 32:
                            enc.bypass(0)
                        enc.bypass_n(val, pre - 3 + rice)
                    if lvl > (3 << rice):
                        rice = min(rice + 1, 4)

    # (parity fixing happens pre-recon in _code_block via fix below)


def _scan_idx_for(log2: int, c_idx: int, mode: int) -> int:
    """7.4.9.11 scan selection (mirrors decoder/writer)."""
    if log2 == 2 or (log2 == 3 and c_idx == 0):
        if 6 <= mode <= 14:
            return 2
        if 22 <= mode <= 30:
            return 1
    return 0


def _fix_sign_hiding(levels: np.ndarray, log2: int, c_idx: int,
                     mode: int) -> None:
    """Adjust levels in-place so the hidden-sign parity rule holds per
    4x4 sub-block: when the sig span > 3, (sum of abs levels) & 1 must
    equal the sign bit of the first (lowest-scan) coefficient.  Fix by
    bumping that coefficient's magnitude by one (stays nonzero, sign
    unchanged, parity flips)."""
    scan_idx = _scan_idx_for(log2, c_idx, mode)
    coef_scan = scan_order(2, scan_idx)
    n_sub = 1 << (log2 - 2)
    for sy in range(n_sub):
        for sx in range(n_sub):
            blk = levels[sy * 4:sy * 4 + 4, sx * 4:sx * 4 + 4]
            sig = [nn for nn in range(16)
                   if blk[int(coef_scan[nn][1]), int(coef_scan[nn][0])]]
            if not sig or (sig[-1] - sig[0]) <= 3:
                continue
            total = int(np.abs(blk).sum())
            first = sig[0]
            fy, fx = int(coef_scan[first][1]), int(coef_scan[first][0])
            neg = 1 if blk[fy, fx] < 0 else 0
            if (total & 1) != neg:
                blk[fy, fx] += 1 if blk[fy, fx] > 0 else -1
