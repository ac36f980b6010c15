"""HEVC (H.265) bitstream layer — parameter sets and NALU handling.

NALU handling + parameter sets (reference coding/hevc.c:7300-7376
dispatch, profile-tier-level :312, SPS/PPS :744-1165) and the
``decode_idr_slice`` entry that runs the full pixel path: CABAC
slice syntax (native/host_hevc.c with coding/hevc_slice.py as the
Python oracle) -> reconstruction (native or formats/hevc_recon.py) ->
real deblocking + SAO (the reference stubs/disables those,
hevc.c:7173-7192).  8- and 10-bit (Main/Main Still/Main10).

Copied from ``ffpic_tpu/formats/hevc.py`` for the PyTorch port,
with its imports rewritten to the port's modules.  What differs:

* ``decode_picture`` and ``decode_idr_slice`` take ``device``, where
  ``FFPIC_HEVC_DEVICE``'s residual transform runs (None means CUDA):
  on the native routes through ``ops.hevc_kernels.residuals_packed``
  (one launch of the ``hevc_residuals`` CUDA kernel over the picture's
  TUs, its plain version on the CPU; span ``hevc.residuals_device``),
  on the Python route through ``hevc_recon.execute_ops``.  The
  original's native multi-segment route (tiles, WPP, several slices)
  runs every transform on the host whatever the switch says; the
  port's launches there too, so that each picture takes one launch.
  The native routes leave out streams with scaling lists, so no byte
  changes.  With ``defer_residuals=True`` the native single-slice route
  stops before the transform and returns a ``PendingPicture``, so that
  a HEIF grid runs every tile's TUs in one launch (``formats.heif``);
* a slice's entry points are cut out of its de-escaped data with the
  emulation prevention bytes taken off (``rbsp_entry_points``), where
  the original cuts at the raw offsets (``ROADMAP.md`` Queue 3);
* the native routes are taken whatever ``FFPIC_NO_NATIVE`` says: the
  port's native build raises on failure (``ROADMAP.md`` Queue 1
  item 3);
* the full inter decode (``_decode_picture_inter``, reached from
  ``SequenceDecoder``) takes ``device`` too: under
  ``FFPIC_HEVC_DEVICE`` a P/B picture's TUs go to it in one launch
  (``hevc_recon.execute_ops``), as an intra picture's do; the motion
  compensation and the decoded picture buffer stay on the host, as in
  the original;
* the syntax and recon passes are timed as the spans ``hevc.syntax``
  and ``hevc.recon``, the deblocking and SAO as ``hevc.loop_filter``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ffpic_tpu_torch.utils import trace
from ffpic_tpu_torch.utils.bitstream import BitReader
from ffpic_tpu_torch.coding.golomb import read_ue, read_se

NAL_VPS, NAL_SPS, NAL_PPS = 32, 33, 34
NAL_IDR_W_RADL, NAL_IDR_N_LP, NAL_CRA = 19, 20, 21


def unescape(data: bytes) -> bytes:
    """Remove emulation-prevention bytes 00 00 03 -> 00 00
    (hevc.c NALU unescape).

    Vectorized: a position i is an escape iff data[i]==3 preceded by
    exactly the bytes 00 00.  This matches the sequential scanner
    (zero-run resets after a removed 03 or any nonzero byte cannot
    create or destroy a candidate: a removed 03 means data[i-1]==3,
    never 0), so candidate positions are independent.
    """
    if b"\x00\x00\x03" not in data:
        return data
    b = np.frombuffer(data, np.uint8)
    esc = np.flatnonzero((b[2:] == 3) & (b[1:-1] == 0)
                         & (b[:-2] == 0)) + 2
    if esc.size == 0:
        return data
    return np.delete(b, esc).tobytes()


def split_nalus_length_prefixed(data: bytes, length_size: int = 4):
    """HEIF mdat convention: length-prefixed NALUs (heif.c:244-256)."""
    pos = 0
    out = []
    while pos + length_size <= len(data):
        ln = int.from_bytes(data[pos:pos + length_size], "big")
        pos += length_size
        out.append(data[pos:pos + ln])
        pos += ln
    return out


@dataclass
class ProfileTierLevel:
    profile_idc: int = 0
    tier: int = 0
    level_idc: int = 0


@dataclass
class SPS:
    sps_id: int = 0
    chroma_format: int = 1
    width: int = 0
    height: int = 0
    conf_win: tuple = (0, 0, 0, 0)
    bit_depth_luma: int = 8
    bit_depth_chroma: int = 8
    log2_max_pic_order_cnt: int = 4
    log2_min_cb: int = 3
    log2_diff_max_min_cb: int = 0
    log2_min_tb: int = 2
    log2_diff_max_min_tb: int = 0
    max_transform_hierarchy_depth_inter: int = 0
    max_transform_hierarchy_depth_intra: int = 0
    scaling_list_enabled: bool = False
    scaling_lists: dict | None = None   # parsed 7.3.4 lists (None=default)
    amp_enabled: bool = False
    sample_adaptive_offset: bool = False
    temporal_mvp: bool = False
    long_term_ref_pics: bool = False
    num_long_term_sps: int = 0
    num_short_term_rps: int = 0
    # per short-term set: (num_delta_pocs, num_used) for the slice
    # header's RPS-index / NumPicsTotalCurr derivations
    st_rps_info: tuple = ()
    # full derived sets (7.4.8): ((s0, s1), ...) with sX =
    # ((delta_poc, used_by_curr), ...) — s0 negative deltas closest
    # first, s1 positive deltas closest first
    st_rps: tuple = ()
    pcm_enabled: bool = False
    pcm_bit_depth_luma: int = 8
    pcm_bit_depth_chroma: int = 8
    log2_min_pcm_cb: int = 3
    log2_diff_max_min_pcm_cb: int = 0
    pcm_loop_filter_disabled: bool = False
    strong_intra_smoothing: bool = False
    ptl: ProfileTierLevel = field(default_factory=ProfileTierLevel)

    @property
    def ctb_log2(self) -> int:
        return self.log2_min_cb + self.log2_diff_max_min_cb

    @property
    def pic_width_cropped(self) -> int:
        l, r, _, _ = self.conf_win
        sub = 2 if self.chroma_format in (1, 2) else 1
        return self.width - sub * (l + r)

    @property
    def pic_height_cropped(self) -> int:
        _, _, t, b = self.conf_win
        sub = 2 if self.chroma_format == 1 else 1
        return self.height - sub * (t + b)


@dataclass
class PPS:
    pps_id: int = 0
    sps_id: int = 0
    sign_data_hiding: bool = False
    cabac_init_present: bool = False
    weighted_pred: bool = False
    weighted_bipred: bool = False
    lists_modification: bool = False
    num_ref_idx_l0_default: int = 1
    num_ref_idx_l1_default: int = 1
    init_qp: int = 26
    constrained_intra_pred: bool = False
    transform_skip_enabled: bool = False
    cu_qp_delta_enabled: bool = False
    diff_cu_qp_delta_depth: int = 0
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    tiles_enabled: bool = False
    entropy_coding_sync: bool = False
    transquant_bypass: bool = False
    slice_chroma_qp_offsets_present: bool = False
    dependent_slice_segments: bool = False
    output_flag_present: bool = False
    num_extra_slice_header_bits: int = 0
    # tiles geometry (uniform or explicit, 7.3.2.3.1)
    num_tile_cols: int = 1
    num_tile_rows: int = 1
    uniform_spacing: bool = True
    tile_col_widths: tuple = ()
    tile_row_heights: tuple = ()
    loop_filter_across_tiles: bool = True
    loop_filter_across_slices: bool = False
    deblocking_control_present: bool = False
    deblocking_override_enabled: bool = False
    deblocking_disabled: bool = False
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    slice_header_extension_present: bool = False
    scaling_lists: dict | None = None   # PPS override of SPS lists
    par_mrg_level: int = 2              # Log2ParMrgLevel


def parse_st_rps(r: BitReader, sets: list, idx: int,
                 slice_level: bool):
    """st_ref_pic_set (7.3.7) with the full 7.4.8 derivation.

    `sets` holds the previously-derived sets (for inter-RPS
    prediction).  Returns (s0, s1): s0 = ((negative delta, used), ...)
    closest-first (decreasing delta), s1 = ((positive delta, used),
    ...) closest-first (increasing delta).
    """
    inter_pred = False
    if idx != 0 and r.read_bit():        # inter_ref_pic_set_prediction
        inter_pred = True
    if inter_pred:
        delta_idx = 1
        if slice_level:
            delta_idx = read_ue(r) + 1   # delta_idx_minus1
        sign = r.read_bit()
        abs_delta = read_ue(r) + 1
        delta_rps = (1 - 2 * sign) * abs_delta
        ref_idx = idx - delta_idx
        if not (0 <= ref_idx < len(sets)):
            raise ValueError("corrupt RPS: reference index")
        r0, r1 = sets[ref_idx]
        ndp_ref = len(r0) + len(r1)
        used = []
        use_delta = []
        for _ in range(ndp_ref + 1):
            u = r.read_bit()
            used.append(u)
            use_delta.append(r.read_bit() if not u else 1)
        n_neg = len(r0)
        s0 = []
        for j in range(len(r1) - 1, -1, -1):
            d = r1[j][0] + delta_rps
            if d < 0 and use_delta[n_neg + j]:
                s0.append((d, bool(used[n_neg + j])))
        if delta_rps < 0 and use_delta[ndp_ref]:
            s0.append((delta_rps, bool(used[ndp_ref])))
        for j in range(n_neg):
            d = r0[j][0] + delta_rps
            if d < 0 and use_delta[j]:
                s0.append((d, bool(used[j])))
        s1 = []
        for j in range(n_neg - 1, -1, -1):
            d = r0[j][0] + delta_rps
            if d > 0 and use_delta[j]:
                s1.append((d, bool(used[j])))
        if delta_rps > 0 and use_delta[ndp_ref]:
            s1.append((delta_rps, bool(used[ndp_ref])))
        for j in range(len(r1)):
            d = r1[j][0] + delta_rps
            if d > 0 and use_delta[n_neg + j]:
                s1.append((d, bool(used[n_neg + j])))
        return tuple(s0), tuple(s1)
    neg = read_ue(r)
    pos = read_ue(r)
    if neg + pos > 16:
        raise ValueError("corrupt RPS: too many delta POCs")
    s0 = []
    d = 0
    for _ in range(neg):
        d -= read_ue(r) + 1              # delta_poc_s0_minus1
        s0.append((d, bool(r.read_bit())))
    s1 = []
    d = 0
    for _ in range(pos):
        d += read_ue(r) + 1
        s1.append((d, bool(r.read_bit())))
    return tuple(s0), tuple(s1)


def _parse_ptl(r: BitReader) -> ProfileTierLevel:
    ptl = ProfileTierLevel()
    r.read_bits(2)                      # profile_space
    ptl.tier = r.read_bit()
    ptl.profile_idc = r.read_bits(5)
    r.read_bits(32)                     # compat flags
    r.read_bits(4)                      # progressive/interlaced/nonpacked/frameonly
    r.skip_bits(43)                     # reserved
    r.read_bit()
    ptl.level_idc = r.read_bits(8)
    return ptl


def parse_sps(nalu: bytes) -> SPS:
    r = BitReader(unescape(nalu))
    r.skip_bits(16)                     # NALU header
    s = SPS()
    r.read_bits(4)                      # vps id
    max_sub_layers = r.read_bits(3) + 1
    r.read_bit()                        # temporal id nesting
    s.ptl = _parse_ptl(r)
    if max_sub_layers > 1:              # sub-layer ptl flags
        flags = [(r.read_bit(), r.read_bit())
                 for _ in range(max_sub_layers - 1)]
        if max_sub_layers - 1 < 8:
            r.skip_bits(2 * (8 - (max_sub_layers - 1)))
        for pf, lf in flags:
            if pf:
                r.skip_bits(88)
            if lf:
                r.skip_bits(8)
    s.sps_id = read_ue(r)
    s.chroma_format = read_ue(r)
    if s.chroma_format == 3:
        r.read_bit()
    s.width = read_ue(r)
    s.height = read_ue(r)
    if r.read_bit():                    # conformance window
        s.conf_win = (read_ue(r), read_ue(r), read_ue(r), read_ue(r))
    s.bit_depth_luma = read_ue(r) + 8
    s.bit_depth_chroma = read_ue(r) + 8
    s.log2_max_pic_order_cnt = read_ue(r) + 4
    sub_layer_ordering = r.read_bit()
    for _ in range(max_sub_layers if sub_layer_ordering else 1):
        read_ue(r)
        read_ue(r)
        read_ue(r)
    s.log2_min_cb = read_ue(r) + 3
    s.log2_diff_max_min_cb = read_ue(r)
    s.log2_min_tb = read_ue(r) + 2
    s.log2_diff_max_min_tb = read_ue(r)
    s.max_transform_hierarchy_depth_inter = read_ue(r)
    s.max_transform_hierarchy_depth_intra = read_ue(r)
    s.scaling_list_enabled = bool(r.read_bit())
    if s.scaling_list_enabled and r.read_bit():
        from ffpic_tpu_torch.coding.hevc_scaling import parse_scaling_list_data
        s.scaling_lists = parse_scaling_list_data(r)
    s.amp_enabled = bool(r.read_bit())
    s.sample_adaptive_offset = bool(r.read_bit())
    s.pcm_enabled = bool(r.read_bit())
    if s.pcm_enabled:
        s.pcm_bit_depth_luma = r.read_bits(4) + 1
        s.pcm_bit_depth_chroma = r.read_bits(4) + 1
        s.log2_min_pcm_cb = read_ue(r) + 3
        s.log2_diff_max_min_pcm_cb = read_ue(r)
        s.pcm_loop_filter_disabled = bool(r.read_bit())
    num_short_term_rps = read_ue(r)
    s.num_short_term_rps = num_short_term_rps
    # parse st_ref_pic_set entries (7.3.7) retaining the FULL derived
    # sets (7.4.8 DeltaPocS0/S1 + UsedByCurrPicS0/S1) — the slice
    # header's reference picture set process (8.3.2) and the inter
    # decode path need them; the (count, used) summary stays for the
    # header's NumPicsTotalCurr derivation
    sets: list = []
    for idx in range(num_short_term_rps):
        sets.append(parse_st_rps(r, sets, idx, slice_level=False))
    s.st_rps = tuple(sets)
    s.st_rps_info = tuple((len(s0) + len(s1),
                           sum(u for _, u in s0) + sum(u for _, u in s1))
                          for s0, s1 in sets)
    s.long_term_ref_pics = bool(r.read_bit())
    if s.long_term_ref_pics:
        n = read_ue(r)
        s.num_long_term_sps = n
        for _ in range(n):
            r.read_bits(s.log2_max_pic_order_cnt)
            r.read_bit()
    s.temporal_mvp = bool(r.read_bit())
    s.strong_intra_smoothing = bool(r.read_bit())
    return s


def _skip_scaling_list(r: BitReader) -> None:
    for size_id in range(4):
        for matrix_id in range(2 if size_id == 3 else 6):
            if not r.read_bit():        # pred mode flag
                read_ue(r)
            else:
                coefs = min(64, 1 << (4 + (size_id << 1)))
                if size_id > 1:
                    read_se(r)
                for _ in range(coefs):
                    read_se(r)


def parse_pps(nalu: bytes) -> PPS:
    r = BitReader(unescape(nalu))
    r.skip_bits(16)
    p = PPS()
    p.pps_id = read_ue(r)
    p.sps_id = read_ue(r)
    p.dependent_slice_segments = bool(r.read_bit())
    p.output_flag_present = bool(r.read_bit())
    p.num_extra_slice_header_bits = r.read_bits(3)
    p.sign_data_hiding = bool(r.read_bit())
    p.cabac_init_present = bool(r.read_bit())
    p.num_ref_idx_l0_default = read_ue(r) + 1
    p.num_ref_idx_l1_default = read_ue(r) + 1
    p.init_qp = 26 + read_se(r)
    p.constrained_intra_pred = bool(r.read_bit())
    p.transform_skip_enabled = bool(r.read_bit())
    p.cu_qp_delta_enabled = bool(r.read_bit())
    if p.cu_qp_delta_enabled:
        p.diff_cu_qp_delta_depth = read_ue(r)
    p.cb_qp_offset = read_se(r)
    p.cr_qp_offset = read_se(r)
    p.slice_chroma_qp_offsets_present = bool(r.read_bit())
    p.weighted_pred = bool(r.read_bit())
    p.weighted_bipred = bool(r.read_bit())
    p.transquant_bypass = bool(r.read_bit())
    p.tiles_enabled = bool(r.read_bit())
    p.entropy_coding_sync = bool(r.read_bit())
    if p.tiles_enabled:
        p.num_tile_cols = read_ue(r) + 1
        p.num_tile_rows = read_ue(r) + 1
        p.uniform_spacing = bool(r.read_bit())
        if not p.uniform_spacing:
            p.tile_col_widths = tuple(read_ue(r) + 1
                                      for _ in range(p.num_tile_cols - 1))
            p.tile_row_heights = tuple(read_ue(r) + 1
                                       for _ in range(p.num_tile_rows - 1))
        p.loop_filter_across_tiles = bool(r.read_bit())
    p.loop_filter_across_slices = bool(r.read_bit())
    p.deblocking_control_present = bool(r.read_bit())
    if p.deblocking_control_present:
        p.deblocking_override_enabled = bool(r.read_bit())
        p.deblocking_disabled = bool(r.read_bit())
        if not p.deblocking_disabled:
            p.beta_offset_div2 = read_se(r)
            p.tc_offset_div2 = read_se(r)
    if r.read_bit():                    # pps_scaling_list_data_present
        from ffpic_tpu_torch.coding.hevc_scaling import parse_scaling_list_data
        p.scaling_lists = parse_scaling_list_data(r)
    p.lists_modification = bool(r.read_bit())
    p.par_mrg_level = read_ue(r) + 2    # Log2ParMrgLevel (7.4.3.3.1)
    p.slice_header_extension_present = bool(r.read_bit())
    return p


def nal_type(nalu: bytes) -> int:
    return (nalu[0] >> 1) & 0x3F if nalu else -1


def decode_idr_slice(sps: SPS, pps: PPS, nalu: bytes, device=None):
    """Decode a single-segment IRAP picture (compat wrapper over
    decode_picture)."""
    return decode_picture(sps, pps, [nalu], device=device)


def rbsp_entry_points(nalu: bytes, hdr) -> tuple:
    """The slice's substream sizes in its de-escaped data.  Each
    entry_point_offset_minus1 + 1 counts the slice data's bytes as the
    NAL unit carries them, emulation prevention bytes included
    (7.4.7.1), while the decode reads the data with them removed, so an
    offset shrinks by the emulation prevention bytes in its substream.
    The original splits the de-escaped data at the offsets as they are
    (``ROADMAP.md`` Queue 3)."""
    if not hdr.entry_points or b"\x00\x00\x03" not in nalu:
        return hdr.entry_points
    b = np.frombuffer(nalu, np.uint8)
    esc = np.flatnonzero((b[2:] == 3) & (b[1:-1] == 0) & (b[:-2] == 0)) + 2
    # escaped position of the first slice-data byte: its de-escaped
    # position plus the emulation prevention bytes of the header
    start = hdr.data_bit_offset // 8
    k = 0
    while k < len(esc) and esc[k] <= start + k:
        k += 1
    ends = start + k + np.cumsum(hdr.entry_points)
    ends = ends - np.searchsorted(esc, ends)
    return tuple(int(v) for v in np.diff(ends, prepend=start))


def decode_picture(sps: SPS, pps: PPS, slice_nalus: list,
                   inter_env: dict | None = None, device=None,
                   defer_residuals: bool = False):
    """Decode all slice segment NALUs of one picture to a
    reconstructed Picture (CABAC syntax -> recon -> deblock -> SAO).

    Handles multi-slice pictures, dependent slice segments (CABAC
    context carry, 9.3.1), tiles and WPP entry points — all of which
    the reference parses in its CTU loop (hevc.c:6981-7005, 2660,
    cabac.c:708-733).  Single-segment intra pictures take the native
    C fast path.

    P/B pictures decode fully (merge/AMVP motion derivation + MC +
    bS-aware deblock) when `inter_env` supplies the sequence state:
    {"poc": int, "refpics": {poc: Picture}} from a SequenceDecoder.
    Without it they parse-and-skip with a typed raise (reference
    parity, hevc.c:6285-6397).  ``device`` is where
    ``FFPIC_HEVC_DEVICE``'s residuals run (None: CUDA).  With
    ``defer_residuals`` a picture whose residuals would go to the device
    in one launch of its own (the native single-slice route under
    ``FFPIC_HEVC_DEVICE``) comes back as a ``PendingPicture`` after its
    syntax pass; any other comes back decoded.
    """
    from ffpic_tpu_torch.coding.hevc_slice import (SharedPictureState,
                                                   SliceDecoder,
                                                   parse_slice_header)
    from ffpic_tpu_torch.formats import hevc_recon

    _validate_params(sps, pps)
    pic = hevc_recon.Picture(sps)

    parsed = []
    prev_hdr = None
    for nalu in slice_nalus:
        rbsp = unescape(nalu)
        r = BitReader(rbsp)
        nut = (rbsp[0] >> 1) & 0x3F
        r.skip_bits(16)
        hdr = parse_slice_header(r, nut, sps, pps, prev=prev_hdr)
        hdr.entry_points = rbsp_entry_points(nalu, hdr)
        if not hdr.dependent:
            prev_hdr = hdr
        parsed.append((hdr, rbsp[hdr.data_bit_offset // 8:]))

    hdr0 = parsed[0][0]
    _attach_lf_barriers(pic, sps, pps, parsed)
    if any(h.slice_type != 2 for h, _ in parsed):
        if inter_env is not None:
            return _decode_picture_inter(sps, pps, parsed, pic,
                                         inter_env, device)
        # P/B picture without sequence state: full parse-and-skip
        # through the Python slice decoder (CABAC stays bit-synced
        # through every CU/PU/MVD and residual; reference parity with
        # hevc.c:6285-6397 which parses inter syntax but never
        # motion-compensates), then a typed raise so track walks keep
        # the intra frames.
        from ffpic_tpu_torch.coding.hevc_slice import InterSliceUnsupported
        shared = SharedPictureState(sps, pps, pic)
        stats = {"cus": 0, "skip_cus": 0, "inter_cus": 0,
                 "intra_cus": 0, "pus": 0, "merge_pus": 0, "mvds": 0}
        slice_idx = -1
        for hdr, data in parsed:
            if not hdr.dependent:
                slice_idx += 1
            sd = SliceDecoder(sps, pps, hdr, data, pic,
                              shared=shared, slice_idx=slice_idx)
            sd.decode_slice_data()
            for k in stats:
                stats[k] += sd.stats[k]
        exc = InterSliceUnsupported(
            f"slice_type {hdr0.slice_type} (P/B) parsed "
            f"(parse-and-skip): {stats['cus']} CUs "
            f"({stats['inter_cus']} inter / {stats['skip_cus']} skip "
            f"/ {stats['intra_cus']} intra), {stats['pus']} PUs, "
            f"{stats['merge_pus']} merge, {stats['mvds']} MVDs — "
            f"no motion compensation (reference parity "
            f"hevc.c:6285-6397); frame skipped")
        exc.parse_stats = stats
        raise exc
    native_ok = (sps.bit_depth_luma in (8, 9, 10)
                 and not sps.pcm_enabled
                 and not sps.scaling_list_enabled)
    simple = (len(parsed) == 1 and hdr0.first_slice
              and not pps.tiles_enabled and not pps.entropy_coding_sync)
    if native_ok:
        if simple and defer_residuals and device_residuals():
            ops_a, tu_a, levels = _slice_syntax_native(
                sps, pps, hdr0, parsed[0][1], pic)
            # copies: the syntax pass's scratch buffers (about 4 MB for a
            # 512x512 tile) are freed now, not after the launch that
            # waits for every tile of a grid
            need = int((tu_a[:, 2].astype(np.int64) ** 2).sum())
            return PendingPicture(pic, sps, pps, hdr0, ops_a.copy(),
                                  tu_a.copy(), levels[:need].copy())
        if simple:
            ops = _decode_slice_native(sps, pps, hdr0, parsed[0][1], pic,
                                       device)
            with trace.stage("hevc.recon"):
                hevc_recon.execute_ops(pic, ops, device)
        else:
            _decode_picture_native(sps, pps, parsed, pic, device)
        return _finish_picture(pic, hdr0, pps)

    shared = SharedPictureState(sps, pps, pic)
    all_ops = []
    slice_idx = -1
    with trace.stage("hevc.syntax"):
        for hdr, data in parsed:
            if not hdr.dependent:
                slice_idx += 1
            sd = SliceDecoder(sps, pps, hdr, data, pic, shared=shared,
                              slice_idx=slice_idx)
            all_ops.extend(sd.decode_slice_data())
    pic.sao_params = shared.sao_out
    with trace.stage("hevc.recon"):
        hevc_recon.execute_ops(pic, all_ops, device)
    return _finish_picture(pic, hdr0, pps)


def _attach_lf_barriers(pic, sps, pps, parsed) -> None:
    """Loop-filter barrier masks at 4x4 granularity (8.7.2
    filterEdgeFlag / 8.7.3 SAO availability): an edge whose two sides
    lie in different slices is not filtered when the LATER (decode
    order) slice's slice_loop_filter_across_slices_enabled_flag is 0;
    tile boundaries block when pps loop_filter_across_tiles is 0.
    Runs for BOTH the native and Python decode paths (slice
    membership from the segment addresses in tile-scan order).  The C
    reference stubs deblocking entirely, so this surface is
    validated against libde265 (tests/test_hevc_de265.py)."""
    import numpy as np
    from ffpic_tpu_torch.coding.hevc_slice import TileLayout
    slice_flags = [h.lf_across_slices for h, _ in parsed
                   if not h.dependent]
    n_slices = len(slice_flags)
    multi_tile = getattr(pps, "tiles_enabled", False) and \
        not getattr(pps, "loop_filter_across_tiles", True)
    if (n_slices <= 1 or all(slice_flags)) and not multi_tile:
        return
    lay = TileLayout(sps, pps)
    ctb_l2 = sps.ctb_log2
    ctbs_x = (sps.width + (1 << ctb_l2) - 1) >> ctb_l2
    # slice-of-CTB from segment addresses (tile-scan order, 7.4.7.1)
    addrs = [h.segment_address for h, _ in parsed if not h.dependent]
    slice_of_ctb = np.zeros(lay.n_ctbs, np.int32)
    for i, a in enumerate(addrs):
        ts0 = int(lay.rs_to_ts[a])
        slice_of_ctb[np.asarray(lay.ts_to_rs[ts0:])] = i
    mh = (sps.height + 3) // 4
    mw = (sps.width + 3) // 4
    y4 = np.arange(mh)
    x4 = np.arange(mw)
    cy = (y4 * 4) >> ctb_l2
    cx = (x4 * 4) >> ctb_l2
    rs = cy[:, None] * ctbs_x + cx[None, :]
    sl = slice_of_ctb[rs]
    tl = np.asarray(lay.tile_of_rs)[rs]
    flags = np.asarray([bool(f) for f in slice_flags], bool) \
        if slice_flags else np.ones(1, bool)

    lf_v = np.zeros((mh, mw), bool)
    lf_h = np.zeros((mh, mw), bool)
    if n_slices > 1 and not all(slice_flags):
        later_v = np.maximum(sl[:, 1:], sl[:, :-1])
        lf_v[:, 1:] |= (sl[:, 1:] != sl[:, :-1]) & \
            ~flags[np.clip(later_v, 0, n_slices - 1)]
        later_h = np.maximum(sl[1:], sl[:-1])
        lf_h[1:] |= (sl[1:] != sl[:-1]) & \
            ~flags[np.clip(later_h, 0, n_slices - 1)]
    if multi_tile:
        lf_v[:, 1:] |= tl[:, 1:] != tl[:, :-1]
        lf_h[1:] |= tl[1:] != tl[:-1]
    pic.lf_block_v = lf_v
    pic.lf_block_h = lf_h


def _finish_picture(pic, hdr, pps):
    from ffpic_tpu_torch.formats import hevc_recon
    with trace.stage("hevc.loop_filter"):
        if not hdr.deblocking_disabled:
            hevc_recon.deblock(pic, hdr.beta_offset_div2,
                               hdr.tc_offset_div2,
                               cb_qp_off=pps.cb_qp_offset,
                               cr_qp_off=pps.cr_qp_offset)
        if hdr.sao_luma or hdr.sao_chroma:
            hevc_recon.apply_sao(pic)
    return pic


def _validate_params(sps: SPS, pps: PPS) -> None:
    """Reject corrupt parameter sets before they reach the decoders
    (spec constraints: A.1 ranges + dimension alignment)."""
    min_cb = 1 << sps.log2_min_cb
    if not (3 <= sps.log2_min_cb <= sps.ctb_log2 <= 6):
        raise ValueError("corrupt SPS: CTB/CB geometry out of range")
    if not (2 <= sps.log2_min_tb < sps.log2_min_cb):
        raise ValueError("corrupt SPS: TB geometry out of range")
    if not (sps.log2_min_tb + sps.log2_diff_max_min_tb <= 5):
        raise ValueError("corrupt SPS: max TB size out of range")
    if sps.max_transform_hierarchy_depth_intra > 4:
        raise ValueError("corrupt SPS: transform hierarchy depth")
    if not (0 < sps.width < 65536 and 0 < sps.height < 65536):
        raise ValueError("corrupt SPS: picture dimensions")
    if sps.width % min_cb or sps.height % min_cb:
        raise ValueError("corrupt SPS: dimensions not multiples of "
                         "the minimum CB size")
    if sps.chroma_format > 3:
        raise ValueError("corrupt SPS: chroma format")
    if not (-12 <= pps.init_qp <= 51):   # init_qp >= -QpBdOffsetY (A.1)
        raise ValueError("corrupt PPS: init QP out of range")
    if pps.diff_cu_qp_delta_depth > sps.ctb_log2 - sps.log2_min_cb:
        raise ValueError("corrupt PPS: cu_qp_delta depth")
    if abs(pps.cb_qp_offset) > 12 or abs(pps.cr_qp_offset) > 12:
        raise ValueError("corrupt PPS: chroma QP offsets")


def _params_for_native(sps, pps, hdr):
    return [
        sps.width, sps.height, sps.ctb_log2, sps.log2_min_cb,
        sps.log2_min_tb, sps.log2_min_tb + sps.log2_diff_max_min_tb,
        sps.max_transform_hierarchy_depth_intra, sps.chroma_format,
        int(pps.transquant_bypass), int(pps.transform_skip_enabled),
        int(pps.sign_data_hiding), int(pps.cu_qp_delta_enabled),
        pps.diff_cu_qp_delta_depth, pps.cb_qp_offset, pps.cr_qp_offset,
        hdr.qp, int(hdr.sao_luma), int(hdr.sao_chroma),
        hdr.cb_qp_offset, hdr.cr_qp_offset,
        6 * (sps.bit_depth_luma - 8),
    ]


def _fresh_sm(qp: int):
    import numpy as np
    from ffpic_tpu_torch.coding.hevc_slice import _CTX_SET, Contexts
    ctx = Contexts(qp)
    sm = []
    for name, count in _CTX_SET:
        for cm in ctx.m[name][:count]:
            sm.append((cm.state << 1) | cm.mps)
    return np.array(sm, np.uint8)


def _decode_picture_native(sps, pps, parsed, pic, device=None) -> None:
    """Native multi-segment decode (tiles / WPP / multi-slice /
    dependent segments): per-segment C syntax with shared picture
    state, then per-availability-zone C recon (fresh masks per zone
    implement the 6.4.1 prediction boundaries)."""
    import numpy as np
    from ffpic_tpu_torch import native
    from ffpic_tpu_torch.coding.hevc_slice import TileLayout
    from ffpic_tpu_torch.formats.hevc_recon import SaoParam

    layout = TileLayout(sps, pps)
    state = native.hevc_picture_state(sps.width, sps.height,
                                      sps.ctb_log2, layout)
    all_ops, all_tu, all_lv = [], [], []
    tu_base = 0
    lv_base = 0
    slice_idx = -1
    sm_io = None
    wpp = int(pps.entropy_coding_sync)
    with trace.stage("hevc.syntax"):
        for hdr, data in parsed:
            if not hdr.dependent:
                slice_idx += 1
                sm_io = _fresh_sm(hdr.qp)
            bounds = [0]
            for off in hdr.entry_points:
                bounds.append(bounds[-1] + off)
            bounds.append(len(data))
            segp = [hdr.segment_address, slice_idx, wpp, len(bounds) - 1]
            ops_a, tu_a, lv = native.hevc_decode_segment(
                data, _params_for_native(sps, pps, hdr), segp, bounds,
                state, _fresh_sm(hdr.qp), sm_io)
            if len(ops_a):
                sel = ops_a[:, 5] >= 0
                ops_a[sel, 5] += tu_base
            all_ops.append(ops_a)
            all_tu.append(tu_a)
            all_lv.append(lv)
            tu_base += len(tu_a)
            lv_base += len(lv)
    ops = (np.concatenate(all_ops) if all_ops
           else np.zeros((0, 6), np.int32))
    tu = (np.concatenate(all_tu) if all_tu
          else np.zeros((0, 8), np.int32))
    levels = (np.concatenate(all_lv) if all_lv
              else np.zeros(0, np.int16))

    mh, mw = state["mh"], state["mw"]
    pic.qp_map[:] = state["qp_map"].reshape(mh, mw)
    pic.bypass_map[:] = state["bypass_map"].reshape(mh, mw) \
        .astype(bool)
    ctbs_x = (sps.width + (1 << sps.ctb_log2) - 1) >> sps.ctb_log2
    sao = state["sao"]
    for idx in np.nonzero(sao[:, :3].any(axis=1))[0]:
        row = sao[idx]
        pic.sao_params[(idx % ctbs_x, idx // ctbs_x)] = SaoParam(
            type_idx=tuple(int(v) for v in row[:3]),
            offsets=tuple(tuple(int(v) for v in row[3 + 4 * k:7 + 4 * k])
                          for k in range(3)),
            band_pos=tuple(int(v) for v in row[15:18]),
            eo_class=tuple(int(v) for v in row[18:21]))
    if not hdr.deblocking_disabled:
        luma = ops[ops[:, 0] == 0]
        pic.mark_edges_batch(luma[:, 1], luma[:, 2], luma[:, 3])

    # per-zone recon: zone of each op from the stamped 4x4 map
    # (chroma op coords are plane-local -> x2 to luma)
    if len(ops) == 0:
        return
    zone_map = state["zone"].reshape(mh, mw)
    is_luma = ops[:, 0] == 0
    oy = np.where(is_luma, ops[:, 2], ops[:, 2] * 2) // 4
    ox = np.where(is_luma, ops[:, 1], ops[:, 1] * 2) // 4
    opz = zone_map[oy, ox]
    cut = np.flatnonzero(np.diff(opz)) + 1
    starts = np.concatenate([[0], cut, [len(ops)]])
    resid = None
    if device_residuals():
        # every TU of the picture, all segments, in one launch
        from ffpic_tpu_torch.ops.hevc_kernels import residuals_packed
        with trace.stage("hevc.residuals_device"):
            resid = residuals_packed(tu, levels, sps.bit_depth_luma, device)
    with trace.stage("hevc.recon"):
        for k in range(len(starts) - 1):
            native.hevc_recon(pic.planes, sps.bit_depth_luma,
                              getattr(sps, "strong_intra_smoothing",
                                      False),
                              ops[starts[k]:starts[k + 1]], tu, levels,
                              residuals=resid)
    for p in range(len(pic.planes)):
        pic.masks[p][:] = True


_CTX_INIT_CACHE: dict = {}


def _ctx_init_arrays(qp: int):
    """Flattened CABAC context-init (state, mps) arrays for the
    native slice decoder, memoized per QP — rebuilding the 137
    ContextModel objects per slice was ~6% of a 48-tile grid decode."""
    import numpy as np
    hit = _CTX_INIT_CACHE.get(qp)
    if hit is None:
        from ffpic_tpu_torch.coding.hevc_slice import _CTX_SET, Contexts
        ctx = Contexts(qp)
        states, mps = [], []
        for name, count in _CTX_SET:
            for cm in ctx.m[name][:count]:
                states.append(cm.state)
                mps.append(cm.mps)
        hit = (np.array(states, np.uint8), np.array(mps, np.uint8))
        _CTX_INIT_CACHE[qp] = hit
    return hit


@dataclass
class PendingPicture:
    """A picture decoded up to its residual transform
    (``decode_picture(..., defer_residuals=True)``): the native syntax
    pass's TU list ``tu_meta`` and ``levels`` wait for a launch over
    several pictures' TUs (``ops.hevc_kernels.residuals_grid``);
    ``finish(residuals)`` then runs the native recon with them,
    deblocking and SAO, and returns the Picture."""
    pic: object
    sps: SPS
    pps: PPS
    hdr: object
    ops: np.ndarray
    tu_meta: np.ndarray
    levels: np.ndarray

    @property
    def bit_depth(self) -> int:
        return self.sps.bit_depth_luma

    def finish(self, residuals: np.ndarray):
        _recon_native(self.sps, self.pic, self.ops, self.tu_meta,
                      self.levels, residuals)
        return _finish_picture(self.pic, self.hdr, self.pps)


def device_residuals() -> bool:
    """``FFPIC_HEVC_DEVICE`` on the native recon: the residual transform
    of a single-slice picture runs on the device, ahead of the recon."""
    return bool(os.environ.get("FFPIC_HEVC_DEVICE")) \
        and not os.environ.get("FFPIC_NO_NATIVE_RECON")


def _slice_syntax_native(sps, pps, hdr, data: bytes, pic):
    """The native slice-syntax decoder (native/host_hevc.c) on one slice:
    fills ``pic``'s QP, bypass, SAO and deblocking-edge state and
    returns its flat outputs, (ops, tu_meta, levels)."""
    from ffpic_tpu_torch import native
    from ffpic_tpu_torch.formats.hevc_recon import SaoParam

    states, mps = _ctx_init_arrays(hdr.qp)
    params = [
        sps.width, sps.height, sps.ctb_log2, sps.log2_min_cb,
        sps.log2_min_tb, sps.log2_min_tb + sps.log2_diff_max_min_tb,
        sps.max_transform_hierarchy_depth_intra, sps.chroma_format,
        int(pps.transquant_bypass), int(pps.transform_skip_enabled),
        int(pps.sign_data_hiding), int(pps.cu_qp_delta_enabled),
        pps.diff_cu_qp_delta_depth, pps.cb_qp_offset, pps.cr_qp_offset,
        hdr.qp, int(hdr.sao_luma), int(hdr.sao_chroma),
        hdr.cb_qp_offset, hdr.cr_qp_offset,
        6 * (sps.bit_depth_luma - 8),           # QpBdOffsetY
    ]
    with trace.stage("hevc.syntax"):
        (ops_a, tu_a, levels, sao, _ctd, _lm, qp_map,
         bypass_map) = native.hevc_decode_slice(
            data, params, np.array(states, np.uint8),
            np.array(mps, np.uint8))

    pic.qp_map[:qp_map.shape[0], :qp_map.shape[1]] = qp_map
    pic.bypass_map[:bypass_map.shape[0], :bypass_map.shape[1]] = \
        bypass_map.astype(bool)
    ctbs_x = (sps.width + (1 << sps.ctb_log2) - 1) >> sps.ctb_log2
    for idx in np.nonzero(sao[:, :3].any(axis=1))[0]:
        row = sao[idx]
        pic.sao_params[(idx % ctbs_x, idx // ctbs_x)] = SaoParam(
            type_idx=tuple(int(v) for v in row[:3]),
            offsets=tuple(tuple(int(v) for v in row[3 + 4 * k:7 + 4 * k])
                          for k in range(3)),
            band_pos=tuple(int(v) for v in row[15:18]),
            eo_class=tuple(int(v) for v in row[18:21]))
    # deblocking edge flags from the luma TB list (vectorized);
    # skipped when the PPS/slice disables deblock (_finish_picture
    # never reads them then)
    if not hdr.deblocking_disabled:
        luma = ops_a[ops_a[:, 0] == 0]
        pic.mark_edges_batch(luma[:, 1], luma[:, 2], luma[:, 3])
    return ops_a, tu_a, levels


def _recon_native(sps, pic, ops_a, tu_a, levels, residuals=None) -> None:
    """Native recon end-to-end (prediction + residual add in C), adding
    the device's ``residuals`` where given."""
    from ffpic_tpu_torch import native
    with trace.stage("hevc.recon"):
        native.hevc_recon(pic.planes, sps.bit_depth_luma,
                          getattr(sps, "strong_intra_smoothing", False),
                          ops_a, tu_a, levels, residuals=residuals)
    for p in range(len(pic.planes)):
        pic.masks[p][:] = True


def _decode_slice_native(sps, pps, hdr, data: bytes, pic, device=None):
    """Drive the native slice-syntax decoder (native/host_hevc.c) and
    convert its flat outputs to the recon op list (empty when the
    native recon ran).  ``device``: where ``FFPIC_HEVC_DEVICE``'s
    residuals run."""
    from ffpic_tpu_torch.coding.hevc_slice import PredOp, TU

    ops_a, tu_a, levels = _slice_syntax_native(sps, pps, hdr, data, pic)
    # native recon end-to-end; FFPIC_HEVC_DEVICE=1 computes ALL residual
    # transforms on the device first (one launch over the picture's TUs,
    # ops/hevc_kernels) and C only adds them to the prediction wavefront
    if not os.environ.get("FFPIC_NO_NATIVE_RECON"):
        resid = None
        if device_residuals():
            from ffpic_tpu_torch.ops.hevc_kernels import residuals_packed
            with trace.stage("hevc.residuals_device"):
                resid = residuals_packed(tu_a, levels,
                                         sps.bit_depth_luma, device)
        _recon_native(sps, pic, ops_a, tu_a, levels, resid)
        return []

    tus = []
    off = 0
    for x, y, n, c_idx, skip, bypass, qp, dst in tu_a:
        lv = levels[off:off + n * n].astype(np.int32).reshape(n, n)
        off += n * n
        tus.append(TU(x=int(x), y=int(y), n=int(n), c_idx=int(c_idx),
                      levels=lv, qp=int(qp), skip=bool(skip),
                      bypass=bool(bypass), dst=bool(dst)))
    ops = []
    for plane, x, y, n, mode, tu in ops_a:
        ops.append(PredOp(int(plane), int(x), int(y), int(n), int(mode),
                          tus[tu] if tu >= 0 else None))
    return ops


# ---------------------------------------------------------------------------
# full inter decode (8.3 + 8.5; beyond the reference's parse-and-skip)
# ---------------------------------------------------------------------------

def _ref_lists(sps, pps, hdr, poc: int, refpics: dict):
    """RefPicList0/1 construction (8.3.4) from the slice's RPS."""
    if hdr.has_lt:
        raise NotImplementedError("long-term reference pictures")
    before = [poc + d for d, u in hdr.rps[0] if u]
    after = [poc + d for d, u in hdr.rps[1] if u]
    nptc = len(before) + len(after)
    if nptc == 0:
        raise ValueError("P/B slice with an empty reference "
                         "picture set")
    for p in before + after:
        if p not in refpics:
            raise ValueError(f"missing reference picture POC {p}")
    lists = []
    for lx in range(2):
        order = (before + after) if lx == 0 else (after + before)
        nref = hdr.num_ref_l0 if lx == 0 else hdr.num_ref_l1
        tmp = []
        while len(tmp) < max(nref, nptc):
            tmp.extend(order)
        mod = hdr.list_mod[lx]
        if mod is not None:
            sel = [tmp[i] for i in mod[:nref]]
        else:
            sel = tmp[:nref]
        lists.append([(p, refpics[p], False) for p in sel])
    return lists


def _build_inter_ctx(sps, pps, hdr, poc, refpics, fld):
    from ffpic_tpu_torch.coding.hevc_inter import InterSliceCtx
    ref_list = _ref_lists(sps, pps, hdr, poc, refpics)
    ctx = InterSliceCtx(poc=poc, ref_list=ref_list, field_=fld)
    ctx.slice_type = hdr.slice_type
    ctx.max_merge = hdr.max_merge
    ctx.par_mrg_level = getattr(pps, "par_mrg_level", 2)
    ctx.mvd_l1_zero = hdr.mvd_l1_zero
    ctx.ctb_log2 = sps.ctb_log2
    ctx.pic_w, ctx.pic_h = sps.width, sps.height
    if hdr.temporal_mvp:
        col_list = ref_list[0] if hdr.col_from_l0 else ref_list[1]
        if hdr.col_ref_idx < len(col_list):
            col_poc, col_pic, _lt = col_list[hdr.col_ref_idx]
            if getattr(col_pic, "motion", None) is not None:
                ctx.temporal_mvp = True
                ctx.col_field = col_pic.motion
                ctx.col_poc = col_poc
                ctx.col_from_l0 = hdr.col_from_l0
    if (pps.weighted_pred and hdr.slice_type == 1) or \
            (pps.weighted_bipred and hdr.slice_type == 0):
        if hdr.wp is None:
            raise ValueError("weighted prediction enabled but no "
                             "pred_weight_table in the slice header")
        ctx.wp = hdr.wp
    return ctx


def _decode_picture_inter(sps, pps, parsed, pic, inter_env, device=None):
    """Full P/B picture decode: per-slice reference lists, inline
    motion derivation during the CABAC pass, MC + residual execution
    (``FFPIC_HEVC_DEVICE``'s residuals on ``device``), bS-aware
    deblock + SAO."""
    from ffpic_tpu_torch.coding.hevc_inter import MotionField
    from ffpic_tpu_torch.coding.hevc_slice import (SharedPictureState,
                                             SliceDecoder)
    from ffpic_tpu_torch.formats import hevc_recon

    if pps.constrained_intra_pred:
        raise NotImplementedError("constrained_intra_pred")
    poc = inter_env["poc"]
    refpics = inter_env["refpics"]
    fld = MotionField(sps.width, sps.height)
    shared = SharedPictureState(sps, pps, pic)
    pic.ref_pics = refpics
    all_ops = []
    slice_idx = -1
    hdr0 = parsed[0][0]
    with trace.stage("hevc.syntax"):
        for hdr, data in parsed:
            if not hdr.dependent:
                slice_idx += 1
            ictx = None
            if hdr.slice_type != 2:
                ictx = _build_inter_ctx(sps, pps, hdr, poc, refpics, fld)
            sd = SliceDecoder(sps, pps, hdr, data, pic, shared=shared,
                              slice_idx=slice_idx, inter_ctx=ictx)
            all_ops.extend(sd.decode_slice_data())
    pic.sao_params = shared.sao_out
    with trace.stage("hevc.recon"):
        hevc_recon.execute_ops(pic, all_ops, device)
        hevc_recon.compute_bs(pic, fld, shared.intra_map,
                              shared.nonzero_map)
    pic.motion = fld
    return _finish_picture(pic, hdr0, pps)


class SequenceDecoder:
    """Stateful HEVC NALU-stream decoder with a decoded picture
    buffer: POC derivation (8.3.1), reference picture set
    application (8.3.2) and per-picture dispatch into
    decode_picture.  Feed NAL units in decode order via push();
    completed pictures come back in decode order (reorder by .poc
    for output order).  ``device`` is where ``FFPIC_HEVC_DEVICE``'s
    residuals run (None: CUDA); the DPB's planes stay on the host,
    where the motion compensation reads them.

    Like the original it treats every CRA/BLA as a random-access point
    (NoRaslOutputFlag 1: the POC MSB resets and RASL pictures are
    decoded), and takes every picture as prevTid0Pic (``ROADMAP.md``
    Queue 3)."""

    def __init__(self, device=None):
        self.device = device
        self.sps: dict = {}
        self.pps: dict = {}
        self.dpb: dict = {}          # poc -> Picture (with .motion)
        self.prev_tid0_poc = 0
        self._au: list = []

    def push(self, nalu: bytes):
        """Feed one NAL unit; returns a decoded Picture when this
        NALU completes the *previous* access unit, else None."""
        if len(nalu) < 3:
            return None            # corrupt/truncated NAL: skip
        t = nal_type(nalu)
        out = None
        if t >= 32 or (t < 32 and ((nalu[2] >> 7) & 1)):
            # parameter set / non-slice, or a first-slice segment:
            # both close any pending AU
            if self._au:
                out = self._decode_au()
        if t == NAL_SPS:
            s = parse_sps(nalu)
            self.sps[s.sps_id] = s
        elif t == NAL_PPS:
            p = parse_pps(nalu)
            self.pps[p.pps_id] = p
        elif t < 32:
            self._au.append(nalu)
        return out

    def flush(self):
        """Decode any pending access unit."""
        if self._au:
            return self._decode_au()
        return None

    def decode_annexb(self, stream: bytes):
        """Decode a whole Annex-B stream; returns the pictures in
        decode order."""
        out = []
        for nalu in split_annexb(stream):
            pic = self.push(nalu)
            if pic is not None:
                out.append(pic)
        pic = self.flush()
        if pic is not None:
            out.append(pic)
        return out

    def _decode_au(self):
        from ffpic_tpu_torch.coding.hevc_slice import parse_slice_header
        from ffpic_tpu_torch.coding.hevc_inter import MotionField

        nalus, self._au = self._au, []
        rbsp = unescape(nalus[0])
        nut = (rbsp[0] >> 1) & 0x3F
        r = BitReader(rbsp)
        r.skip_bits(16)
        # probe pps_id cheaply (first_slice flag is set on AU starts)
        r.read_bit()
        if 16 <= nut <= 23:
            r.read_bit()
        try:
            pps = self.pps[read_ue(r)]
            sps = self.sps[pps.sps_id]
        except KeyError as e:
            raise ValueError(f"slice references unknown parameter "
                             f"set {e}") from None
        r2 = BitReader(rbsp)
        r2.skip_bits(16)
        hdr0 = parse_slice_header(r2, nut, sps, pps)

        # POC (8.3.1)
        if nut in (NAL_IDR_W_RADL, NAL_IDR_N_LP):
            poc = 0
            self.dpb = {}
        else:
            max_lsb = 1 << sps.log2_max_pic_order_cnt
            if 16 <= nut <= 23:
                # IRAP with NoRaslOutputFlag: MSB resets (treating
                # every CRA/BLA as a random-access point)
                poc = hdr0.poc_lsb
            else:
                prev = self.prev_tid0_poc
                prev_lsb = prev & (max_lsb - 1)
                prev_msb = prev - prev_lsb
                lsb = hdr0.poc_lsb
                if lsb < prev_lsb and prev_lsb - lsb >= max_lsb // 2:
                    msb = prev_msb + max_lsb
                elif lsb > prev_lsb and lsb - prev_lsb > max_lsb // 2:
                    msb = prev_msb - max_lsb
                else:
                    msb = prev_msb
                poc = msb + lsb
            # RPS application (8.3.2): drop DPB entries the current
            # RPS no longer references
            keep = {poc + d for d, _u in hdr0.rps[0]} \
                | {poc + d for d, _u in hdr0.rps[1]}
            self.dpb = {p: v for p, v in self.dpb.items()
                        if p in keep}
        self.prev_tid0_poc = poc

        env = {"poc": poc, "refpics": self.dpb}
        pic = decode_picture(sps, pps, nalus, inter_env=env,
                             device=self.device)
        pic.poc = poc
        if pic.motion is None:
            pic.motion = MotionField(sps.width, sps.height)
        self.dpb[poc] = pic
        return pic


def display_order(pics) -> list:
    """Decoded pictures (decode order) in presentation order: by POC
    within each group that a POC 0 (an IDR) starts, as the original's
    ``hevc_raw.load`` and ``heif._decode_sequence`` order them."""
    groups: list = []
    for p in pics:
        if p.poc == 0 or not groups:
            groups.append([])
        groups[-1].append(p)
    return [p for g in groups for p in sorted(g, key=lambda q: q.poc)]


def split_annexb(data: bytes):
    """Split an Annex-B byte stream into NAL units (start codes
    00 00 01 / 00 00 00 01)."""
    out = []
    i = data.find(b"\x00\x00\x01")
    while i >= 0:
        j = data.find(b"\x00\x00\x01", i + 3)
        end = len(data) if j < 0 else (j - (1 if j > 0
                                            and data[j - 1] == 0
                                            else 0))
        nal = data[i + 3:end]
        if nal:
            out.append(nal)
        if j < 0:
            break
        i = j
    return out
