"""AV1 OBU / sequence-header / frame-header parsing (spec 5.5-5.9).

Covers the still-picture (intra frame) subset completely: full
sequence header, uncompressed frame header for KEY/INTRA_ONLY frames
(quantization, segmentation, delta-q/lf, loop filter, CDEF, loop
restoration, tx mode, film grain), and tile info.  Inter-frame-only
paths raise NotImplementedError.

The C reference (junka/ffpic) parses only the sequence header
(avif.c:124-257) and stubs the frame level (avif.c:382-405); this
module is the entry to our full AV1 intra decoder (av1_tile.py /
av1_recon.py), validated against dav1d (tests/test_av1.py).

Copied from ``ffpic_tpu/coding/av1_headers.py`` for the PyTorch port
with its imports rewritten to the port's modules: ``BitReader`` is the
port's ``utils/bitstream.py``, ``parse_frame_header`` imports the
port's ``av1_refs`` for every frame, and the film grain parameters
come from the port's ``av1_grain``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ffpic_tpu_torch.utils.bitstream import BitReader

# OBU types (spec 6.2.2)
OBU_SEQUENCE_HEADER = 1
OBU_TEMPORAL_DELIMITER = 2
OBU_FRAME_HEADER = 3
OBU_TILE_GROUP = 4
OBU_METADATA = 5
OBU_FRAME = 6
OBU_REDUNDANT_FRAME_HEADER = 7
OBU_TILE_LIST = 8
OBU_PADDING = 15

KEY_FRAME, INTER_FRAME, INTRA_ONLY_FRAME, SWITCH_FRAME = range(4)

PRIMARY_REF_NONE = 7
NUM_REF_FRAMES = 8
SELECT_SCREEN_CONTENT_TOOLS = 2
SELECT_INTEGER_MV = 2
MAX_TILE_WIDTH = 4096
MAX_TILE_AREA = 4096 * 2304
MAX_TILE_COLS = 64
MAX_TILE_ROWS = 64
RESTORATION_TILESIZE_MAX = 256
SEG_LVL_ALT_Q = 0
SEG_LVL_MAX = 8
RESTORE_NONE, RESTORE_SWITCHABLE, RESTORE_WIENER, RESTORE_SGRPROJ = range(4)
TX_MODE_ONLY_4X4, TX_MODE_LARGEST, TX_MODE_SELECT = range(3)
SWITCHABLE = 4                   # interp_filter sentinel
SEG_LVL_REF_FRAME = 5

# segmentation feature metadata (spec 5.9.14)
_SEG_BITS = [8, 6, 6, 6, 6, 3, 0, 0]
_SEG_SIGNED = [1, 1, 1, 1, 1, 0, 0, 0]
_SEG_MAX = [255, 63, 63, 63, 63, 7, 0, 0]


def parse_obus(data: bytes) -> list[dict]:
    """Split a low-overhead OBU stream into typed payloads (5.3.2)."""
    obus = []
    pos = 0
    n = len(data)
    while pos < n:
        b0 = data[pos]
        if b0 & 0x81:
            raise ValueError("OBU forbidden/reserved bit set")
        otype = (b0 >> 3) & 0xF
        has_ext = b0 & 4
        has_size = b0 & 2
        pos += 1
        ext = None
        if has_ext:
            ext = data[pos]
            pos += 1
        if has_size:
            size = 0
            shift = 0
            while True:
                c = data[pos]
                pos += 1
                size |= (c & 0x7F) << shift
                shift += 7
                if not (c & 0x80):
                    break
                if shift > 56:
                    raise ValueError("leb128 overflow")
        else:
            size = n - pos
        if pos + size > n:
            raise ValueError("OBU payload past end of stream")
        obus.append(dict(type=otype, ext=ext,
                         payload=data[pos:pos + size]))
        pos += size
    return obus


@dataclass
class SequenceHeader:
    profile: int = 0
    still_picture: bool = False
    reduced_still_picture_header: bool = False
    frame_width_bits: int = 0
    frame_height_bits: int = 0
    max_frame_width: int = 0
    max_frame_height: int = 0
    frame_id_numbers_present: bool = False
    delta_frame_id_length: int = 0
    additional_frame_id_length: int = 0
    use_128x128_superblock: bool = False
    enable_filter_intra: bool = False
    enable_intra_edge_filter: bool = False
    enable_interintra_compound: bool = False
    enable_masked_compound: bool = False
    enable_warped_motion: bool = False
    enable_dual_filter: bool = False
    enable_order_hint: bool = False
    enable_jnt_comp: bool = False
    enable_ref_frame_mvs: bool = False
    seq_force_screen_content_tools: int = SELECT_SCREEN_CONTENT_TOOLS
    seq_force_integer_mv: int = SELECT_INTEGER_MV
    order_hint_bits: int = 0
    enable_superres: bool = False
    enable_cdef: bool = False
    enable_restoration: bool = False
    # color_config
    bit_depth: int = 8
    mono_chrome: bool = False
    num_planes: int = 3
    color_primaries: int = 2
    transfer_characteristics: int = 2
    matrix_coefficients: int = 2
    color_range: int = 0
    subsampling_x: int = 1
    subsampling_y: int = 1
    chroma_sample_position: int = 0
    separate_uv_delta_q: bool = False
    film_grain_params_present: bool = False
    decoder_model_info_present: bool = False
    # decoder model (needed only to skip bits correctly)
    buffer_delay_length: int = 0
    equal_picture_interval: bool = False
    frame_presentation_time_length: int = 0
    operating_point_idc: list = field(default_factory=list)


def parse_sequence_header(payload: bytes) -> SequenceHeader:
    """Spec 5.5.1 sequence_header_obu."""
    r = BitReader(payload)
    s = SequenceHeader()
    s.profile = r.read_bits(3)
    if s.profile > 2:
        raise ValueError(f"bad seq_profile {s.profile}")
    s.still_picture = bool(r.read_bit())
    s.reduced_still_picture_header = bool(r.read_bit())
    if s.reduced_still_picture_header:
        r.read_bits(5)              # seq_level_idx[0]
        s.operating_point_idc = [0]
    else:
        timing_info_present = r.read_bit()
        if timing_info_present:
            # timing_info(): num_units_in_display_tick u32,
            # time_scale u32, equal_picture_interval f(1),
            # num_ticks_per_picture uvlc
            r.read_bits(32)
            r.read_bits(32)
            s.equal_picture_interval = bool(r.read_bit())
            if s.equal_picture_interval:
                _read_uvlc(r)
            s.decoder_model_info_present = bool(r.read_bit())
            if s.decoder_model_info_present:
                s.buffer_delay_length = r.read_bits(5) + 1
                r.read_bits(32)     # num_units_in_decoding_tick
                r.read_bits(5)      # buffer_removal_time_length_minus_1
                s.frame_presentation_time_length = r.read_bits(5) + 1
        initial_display_delay_present = r.read_bit()
        n_op = r.read_bits(5) + 1
        for _ in range(n_op):
            s.operating_point_idc.append(r.read_bits(12))
            lvl = r.read_bits(5)
            if lvl > 7:
                r.read_bit()        # seq_tier
            if s.decoder_model_info_present:
                if r.read_bit():    # decoder_model_present_for_op
                    n = s.buffer_delay_length
                    r.read_bits(n)  # decoder_buffer_delay
                    r.read_bits(n)  # encoder_buffer_delay
                    r.read_bit()    # low_delay_mode_flag
            if initial_display_delay_present:
                if r.read_bit():
                    r.read_bits(4)
    s.frame_width_bits = r.read_bits(4) + 1
    s.frame_height_bits = r.read_bits(4) + 1
    s.max_frame_width = r.read_bits(s.frame_width_bits) + 1
    s.max_frame_height = r.read_bits(s.frame_height_bits) + 1
    if not s.reduced_still_picture_header:
        s.frame_id_numbers_present = bool(r.read_bit())
    if s.frame_id_numbers_present:
        s.delta_frame_id_length = r.read_bits(4) + 2
        s.additional_frame_id_length = r.read_bits(3) + 1
    s.use_128x128_superblock = bool(r.read_bit())
    s.enable_filter_intra = bool(r.read_bit())
    s.enable_intra_edge_filter = bool(r.read_bit())
    if not s.reduced_still_picture_header:
        s.enable_interintra_compound = bool(r.read_bit())
        s.enable_masked_compound = bool(r.read_bit())
        s.enable_warped_motion = bool(r.read_bit())
        s.enable_dual_filter = bool(r.read_bit())
        s.enable_order_hint = bool(r.read_bit())
        if s.enable_order_hint:
            s.enable_jnt_comp = bool(r.read_bit())
            s.enable_ref_frame_mvs = bool(r.read_bit())
        if r.read_bit():            # seq_choose_screen_content_tools
            s.seq_force_screen_content_tools = \
                SELECT_SCREEN_CONTENT_TOOLS
        else:
            s.seq_force_screen_content_tools = r.read_bit()
        if s.seq_force_screen_content_tools > 0:
            if r.read_bit():        # seq_choose_integer_mv
                s.seq_force_integer_mv = SELECT_INTEGER_MV
            else:
                s.seq_force_integer_mv = r.read_bit()
        else:
            s.seq_force_integer_mv = SELECT_INTEGER_MV
        if s.enable_order_hint:
            s.order_hint_bits = r.read_bits(3) + 1
    s.enable_superres = bool(r.read_bit())
    s.enable_cdef = bool(r.read_bit())
    s.enable_restoration = bool(r.read_bit())
    _parse_color_config(r, s)
    s.film_grain_params_present = bool(r.read_bit())
    return s


def _read_uvlc(r: BitReader) -> int:
    zeros = 0
    while not r.read_bit():
        zeros += 1
        if zeros > 32:
            raise ValueError("uvlc overflow")
    if zeros == 32:
        return (1 << 32) - 1
    return (1 << zeros) - 1 + (r.read_bits(zeros) if zeros else 0)


def _parse_color_config(r: BitReader, s: SequenceHeader) -> None:
    """Spec 5.5.2."""
    high_bitdepth = r.read_bit()
    if s.profile == 2 and high_bitdepth:
        s.bit_depth = 12 if r.read_bit() else 10
    else:
        s.bit_depth = 10 if high_bitdepth else 8
    if s.profile == 1:
        s.mono_chrome = False
    else:
        s.mono_chrome = bool(r.read_bit())
    s.num_planes = 1 if s.mono_chrome else 3
    if r.read_bit():                # color_description_present
        s.color_primaries = r.read_bits(8)
        s.transfer_characteristics = r.read_bits(8)
        s.matrix_coefficients = r.read_bits(8)
    if s.mono_chrome:
        s.color_range = r.read_bit()
        s.subsampling_x = s.subsampling_y = 1
        s.separate_uv_delta_q = False
        return
    if (s.color_primaries == 1 and s.transfer_characteristics == 13
            and s.matrix_coefficients == 0):
        s.color_range = 1
        s.subsampling_x = s.subsampling_y = 0
    else:
        s.color_range = r.read_bit()
        if s.profile == 0:
            s.subsampling_x = s.subsampling_y = 1
        elif s.profile == 1:
            s.subsampling_x = s.subsampling_y = 0
        else:
            if s.bit_depth == 12:
                s.subsampling_x = r.read_bit()
                s.subsampling_y = r.read_bit() if s.subsampling_x \
                    else 0
            else:
                s.subsampling_x, s.subsampling_y = 1, 0
        if s.subsampling_x and s.subsampling_y:
            s.chroma_sample_position = r.read_bits(2)
    s.separate_uv_delta_q = bool(r.read_bit())


@dataclass
class FrameHeader:
    frame_type: int = KEY_FRAME
    show_frame: bool = True
    frame_is_intra: bool = True
    disable_cdf_update: bool = False
    allow_screen_content_tools: bool = False
    force_integer_mv: bool = True
    allow_intrabc: bool = False
    width: int = 0                  # FrameWidth (post-superres)
    height: int = 0
    upscaled_width: int = 0
    render_width: int = 0
    render_height: int = 0
    superres_denom: int = 8
    use_superres: bool = False
    mi_cols: int = 0
    mi_rows: int = 0
    disable_frame_end_update_cdf: bool = True
    # tiles
    tile_cols_log2: int = 0
    tile_rows_log2: int = 0
    tile_cols: int = 1
    tile_rows: int = 1
    mi_col_starts: list = field(default_factory=list)
    mi_row_starts: list = field(default_factory=list)
    context_update_tile_id: int = 0
    tile_size_bytes: int = 1
    # quantization
    base_q_idx: int = 0
    delta_q_y_dc: int = 0
    delta_q_u_dc: int = 0
    delta_q_u_ac: int = 0
    delta_q_v_dc: int = 0
    delta_q_v_ac: int = 0
    using_qmatrix: bool = False
    qm_y: int = 0
    qm_u: int = 0
    qm_v: int = 0
    # segmentation
    segmentation_enabled: bool = False
    segmentation_update_map: bool = False
    segmentation_temporal_update: bool = False
    feature_enabled: list = field(default_factory=list)   # [8][8]
    feature_data: list = field(default_factory=list)      # [8][8]
    seg_id_pre_skip: bool = False
    last_active_seg_id: int = 0
    # delta q / lf
    delta_q_present: bool = False
    delta_q_res: int = 0
    delta_lf_present: bool = False
    delta_lf_res: int = 0
    delta_lf_multi: bool = False
    # loop filter
    loop_filter_level: list = field(default_factory=lambda: [0, 0, 0, 0])
    loop_filter_sharpness: int = 0
    loop_filter_delta_enabled: bool = False
    loop_filter_ref_deltas: list = field(
        default_factory=lambda: [1, 0, 0, 0, -1, 0, -1, -1])
    loop_filter_mode_deltas: list = field(default_factory=lambda: [0, 0])
    # cdef
    cdef_damping: int = 3
    cdef_bits: int = 0
    cdef_y_pri_strength: list = field(default_factory=lambda: [0])
    cdef_y_sec_strength: list = field(default_factory=lambda: [0])
    cdef_uv_pri_strength: list = field(default_factory=lambda: [0])
    cdef_uv_sec_strength: list = field(default_factory=lambda: [0])
    # loop restoration
    lr_type: list = field(default_factory=lambda: [0, 0, 0])
    lr_unit_size: list = field(default_factory=lambda: [256, 256, 256])
    uses_lr: bool = False
    # tx / misc
    tx_mode: int = TX_MODE_LARGEST
    reduced_tx_set: bool = False
    coded_lossless: bool = False
    all_lossless: bool = False
    lossless_segs: list = field(default_factory=lambda: [False] * 8)
    qindex_segs: list = field(default_factory=lambda: [0] * 8)
    apply_grain: bool = False
    # inter (spec 5.9: reference signaling, motion tools)
    show_existing_frame: bool = False
    frame_to_show: int = 0
    showable_frame: bool = False
    error_resilient_mode: bool = False
    order_hint: int = 0
    primary_ref_frame: int = 7          # PRIMARY_REF_NONE
    refresh_frame_flags: int = 0xFF
    ref_frame_idx: list = field(default_factory=lambda: [0] * 7)
    order_hints: list = field(default_factory=lambda: [0] * 8)
    ref_sign_bias: list = field(default_factory=lambda: [0] * 8)
    allow_high_precision_mv: bool = False
    interp_filter: int = 0              # EIGHTTAP
    is_filter_switchable: bool = False
    is_motion_mode_switchable: bool = False
    use_ref_frame_mvs: bool = False
    reference_select: bool = False      # frame_reference_mode
    skip_mode_present: bool = False
    skip_mode_frame: list = field(default_factory=lambda: [0, 0])
    allow_warped_motion: bool = False
    gm_type: list = field(default_factory=lambda: [0] * 8)
    gm_params: list = field(default_factory=lambda: [
        [0, 0, 1 << 16, 0, 0, 1 << 16] for _ in range(8)])
    gm_invalid: list = field(default_factory=lambda: [False] * 8)
    prev_seg_ids: object = None         # primary ref's segment map
    segmentation_update_data: bool = True


def _su(r: BitReader, n: int) -> int:
    v = r.read_bits(n)
    sign = r.read_bit()
    return -v if sign else v


def _read_delta_q(r: BitReader) -> int:
    return _su(r, 6) if r.read_bit() else 0


def tile_log2(blk_size: int, target: int) -> int:
    k = 0
    while (blk_size << k) < target:
        k += 1
    return k


def parse_frame_header(payload: bytes, seq: SequenceHeader,
                       refs: list | None = None) -> \
        tuple[FrameHeader, int]:
    """Spec 5.9 uncompressed_header (intra + inter).

    Returns (header, bit_position_after_header) — the caller slices
    tile-group data from an OBU_FRAME payload at the byte-aligned
    position.  `refs` is the decoder's 8-slot reference state
    (av1_refs.RefFrame | None per slot); required for inter frames
    (ref signaling, frame_size_with_refs, skip-mode derivation,
    primary-ref parameter loading).
    """
    from ffpic_tpu_torch.coding import av1_refs as R
    r = BitReader(payload)
    f = FrameHeader()
    if seq.reduced_still_picture_header:
        f.frame_type = KEY_FRAME
        f.show_frame = True
        error_resilient_mode = False
    else:
        if r.read_bit():            # show_existing_frame
            f.show_existing_frame = True
            f.frame_to_show = r.read_bits(3)
            if seq.decoder_model_info_present and \
                    not seq.equal_picture_interval:
                r.read_bits(seq.frame_presentation_time_length)
            if seq.frame_id_numbers_present:
                r.read_bits(seq.delta_frame_id_length)
            return f, r.bitpos
        f.frame_type = r.read_bits(2)
        f.frame_is_intra = f.frame_type in (KEY_FRAME,
                                            INTRA_ONLY_FRAME)
        f.show_frame = bool(r.read_bit())
        if f.show_frame and seq.decoder_model_info_present and \
                not seq.equal_picture_interval:
            r.read_bits(seq.frame_presentation_time_length)
        if f.show_frame:
            f.showable_frame = f.frame_type != KEY_FRAME
        else:
            f.showable_frame = bool(r.read_bit())
        if f.frame_type == SWITCH_FRAME or \
                (f.frame_type == KEY_FRAME and f.show_frame):
            error_resilient_mode = True
        else:
            error_resilient_mode = bool(r.read_bit())
    f.error_resilient_mode = error_resilient_mode
    f.disable_cdf_update = bool(r.read_bit())
    if seq.seq_force_screen_content_tools == \
            SELECT_SCREEN_CONTENT_TOOLS:
        f.allow_screen_content_tools = bool(r.read_bit())
    else:
        f.allow_screen_content_tools = \
            bool(seq.seq_force_screen_content_tools)
    if f.allow_screen_content_tools:
        if seq.seq_force_integer_mv == SELECT_INTEGER_MV:
            f.force_integer_mv = bool(r.read_bit())
        else:
            f.force_integer_mv = bool(seq.seq_force_integer_mv)
    else:
        f.force_integer_mv = False
    if f.frame_is_intra:
        f.force_integer_mv = True
    if seq.frame_id_numbers_present:
        id_len = seq.additional_frame_id_length + \
            seq.delta_frame_id_length
        r.read_bits(id_len)         # current_frame_id
    if f.frame_type == SWITCH_FRAME:
        frame_size_override = True
    elif seq.reduced_still_picture_header:
        frame_size_override = False
    else:
        frame_size_override = bool(r.read_bit())
    f.order_hint = r.read_bits(seq.order_hint_bits)
    # intra => primary_ref_frame = PRIMARY_REF_NONE (no bits)
    if not (f.frame_is_intra or error_resilient_mode):
        f.primary_ref_frame = r.read_bits(3)
    if seq.decoder_model_info_present:
        if r.read_bit():            # buffer_removal_time_present
            raise NotImplementedError(
                "buffer_removal_time (decoder model op loop)")
    if f.frame_type == SWITCH_FRAME or \
            (f.frame_type == KEY_FRAME and f.show_frame):
        refresh_frame_flags = (1 << NUM_REF_FRAMES) - 1
    else:
        refresh_frame_flags = r.read_bits(8)
    f.refresh_frame_flags = refresh_frame_flags
    ref_order_hint = [rf.order_hint if rf is not None else 0
                      for rf in (refs or [None] * 8)]
    if not f.frame_is_intra or \
            refresh_frame_flags != (1 << NUM_REF_FRAMES) - 1:
        if error_resilient_mode and seq.enable_order_hint:
            for i in range(NUM_REF_FRAMES):
                ref_order_hint[i] = r.read_bits(seq.order_hint_bits)

    def frame_size():
        if frame_size_override:
            f.width = r.read_bits(seq.frame_width_bits) + 1
            f.height = r.read_bits(seq.frame_height_bits) + 1
        else:
            f.width = seq.max_frame_width
            f.height = seq.max_frame_height
        superres_and_compute()
        render_size()

    def superres_and_compute():
        if seq.enable_superres:
            f.use_superres = bool(r.read_bit())
        if f.use_superres:
            f.superres_denom = r.read_bits(3) + 9
        f.upscaled_width = f.width
        f.width = (f.upscaled_width * 8 + (f.superres_denom // 2)) \
            // f.superres_denom
        f.mi_cols = 2 * ((f.width + 7) >> 3)
        f.mi_rows = 2 * ((f.height + 7) >> 3)

    def render_size():
        if r.read_bit():            # render_and_frame_size_different
            f.render_width = r.read_bits(16) + 1
            f.render_height = r.read_bits(16) + 1
        else:
            f.render_width = f.upscaled_width
            f.render_height = f.height

    if f.frame_is_intra:
        frame_size()
        if f.allow_screen_content_tools and \
                f.upscaled_width == f.width:
            f.allow_intrabc = bool(r.read_bit())
    else:
        # ---- reference signaling (spec 5.9.2 inter branch)
        frame_refs_short_signaling = False
        if seq.enable_order_hint:
            frame_refs_short_signaling = bool(r.read_bit())
            if frame_refs_short_signaling:
                last_frame_idx = r.read_bits(3)
                gold_frame_idx = r.read_bits(3)
                f.ref_frame_idx = _set_frame_refs(
                    seq, f, ref_order_hint, last_frame_idx,
                    gold_frame_idx)
        for i in range(7):
            if not frame_refs_short_signaling:
                f.ref_frame_idx[i] = r.read_bits(3)
            if seq.frame_id_numbers_present:
                r.read_bits(seq.delta_frame_id_length)
        if frame_size_override and not error_resilient_mode:
            # frame_size_with_refs (5.9.7)
            found = False
            for i in range(7):
                if r.read_bit():
                    rf = refs[f.ref_frame_idx[i]]
                    f.upscaled_width = rf.upscaled_width
                    f.width = f.upscaled_width
                    f.height = rf.height
                    f.render_width = rf.render_width
                    f.render_height = rf.render_height
                    found = True
                    break
            if found:
                superres_and_compute()
            else:
                frame_size()
        else:
            frame_size()
        if f.force_integer_mv:
            f.allow_high_precision_mv = False
        else:
            f.allow_high_precision_mv = bool(r.read_bit())
        # read_interpolation_filter (5.9.10)
        f.is_filter_switchable = bool(r.read_bit())
        if f.is_filter_switchable:
            f.interp_filter = SWITCHABLE
        else:
            f.interp_filter = r.read_bits(2)
        f.is_motion_mode_switchable = bool(r.read_bit())
        if error_resilient_mode or not seq.enable_ref_frame_mvs or \
                not seq.enable_order_hint:
            f.use_ref_frame_mvs = False
        else:
            f.use_ref_frame_mvs = bool(r.read_bit())
        # OrderHints / RefFrameSignBias (by ref enum LAST..ALTREF)
        for i in range(7):
            hint = ref_order_hint[f.ref_frame_idx[i]]
            f.order_hints[1 + i] = hint
            f.ref_sign_bias[1 + i] = 1 if R.get_relative_dist(
                seq, hint, f.order_hint) > 0 else 0
    if seq.reduced_still_picture_header or f.disable_cdf_update:
        f.disable_frame_end_update_cdf = True
    else:
        f.disable_frame_end_update_cdf = bool(r.read_bit())
    # primary-ref parameter loading (spec load_previous): gm params,
    # loop-filter deltas, segmentation feature data, segment map
    prev = None
    if f.primary_ref_frame != PRIMARY_REF_NONE and refs is not None:
        prev = refs[f.ref_frame_idx[f.primary_ref_frame]]
    if prev is not None:
        f.loop_filter_ref_deltas = list(prev.lf_ref_deltas)
        f.loop_filter_mode_deltas = list(prev.lf_mode_deltas)
        f.prev_seg_ids = prev.seg_ids
    _parse_tile_info(r, f, seq)
    _parse_quantization_params(r, f, seq)
    _parse_segmentation_params(r, f, prev)
    # delta_q_params
    if f.base_q_idx > 0:
        f.delta_q_present = bool(r.read_bit())
    if f.delta_q_present:
        f.delta_q_res = r.read_bits(2)
    # delta_lf_params
    if f.delta_q_present:
        if not f.allow_intrabc:
            f.delta_lf_present = bool(r.read_bit())
        if f.delta_lf_present:
            f.delta_lf_res = r.read_bits(2)
            f.delta_lf_multi = bool(r.read_bit())
    _derive_lossless(f, seq)
    _parse_loop_filter_params(r, f, seq)
    _parse_cdef_params(r, f, seq)
    _parse_lr_params(r, f, seq)
    # read_tx_mode
    if f.coded_lossless:
        f.tx_mode = TX_MODE_ONLY_4X4
    else:
        f.tx_mode = TX_MODE_SELECT if r.read_bit() else \
            TX_MODE_LARGEST
    # frame_reference_mode (5.9.23)
    if not f.frame_is_intra:
        f.reference_select = bool(r.read_bit())
    # skip_mode_params (5.9.22)
    _skip_mode_params(r, f, seq)
    # allow_warped_motion
    if f.frame_is_intra or error_resilient_mode or \
            not seq.enable_warped_motion:
        f.allow_warped_motion = False
    else:
        f.allow_warped_motion = bool(r.read_bit())
    f.reduced_tx_set = bool(r.read_bit())
    # global_motion_params (5.9.24)
    _global_motion_params(r, f, prev if not f.frame_is_intra
                          else None)
    # film_grain_params (5.9.30) -> synthesized at OUTPUT time
    # (coding/av1_grain.py); references keep pre-grain pixels
    f.grain = None
    if seq.film_grain_params_present and \
            (f.show_frame or f.showable_frame):
        f.apply_grain = bool(r.read_bit())
        if f.apply_grain:
            from ffpic_tpu_torch.coding.av1_grain import parse_film_grain
            f.grain = parse_film_grain(r, f, seq, refs or [None] * 8)
    return f, r.bitpos


def _skip_mode_params(r: BitReader, f: FrameHeader,
                      seq: SequenceHeader) -> None:
    """Spec 5.9.22: derive SkipModeFrame from order hints, read
    skip_mode_present."""
    from ffpic_tpu_torch.coding.av1_refs import get_relative_dist
    skip_mode_allowed = False
    if not f.frame_is_intra and f.reference_select and \
            seq.enable_order_hint:
        forward_idx = backward_idx = -1
        forward_hint = backward_hint = 0
        for i in range(7):
            hint = f.order_hints[1 + i]
            d = get_relative_dist(seq, hint, f.order_hint)
            if d < 0:
                if forward_idx < 0 or get_relative_dist(
                        seq, hint, forward_hint) > 0:
                    forward_idx, forward_hint = i, hint
            elif d > 0:
                if backward_idx < 0 or get_relative_dist(
                        seq, hint, backward_hint) < 0:
                    backward_idx, backward_hint = i, hint
        if forward_idx < 0:
            skip_mode_allowed = False
        elif backward_idx >= 0:
            skip_mode_allowed = True
            f.skip_mode_frame = [
                1 + min(forward_idx, backward_idx),
                1 + max(forward_idx, backward_idx)]
        else:
            second_idx = -1
            second_hint = 0
            for i in range(7):
                hint = f.order_hints[1 + i]
                if get_relative_dist(seq, hint, forward_hint) < 0:
                    if second_idx < 0 or get_relative_dist(
                            seq, hint, second_hint) > 0:
                        second_idx, second_hint = i, hint
            if second_idx >= 0:
                skip_mode_allowed = True
                f.skip_mode_frame = [1 + min(forward_idx, second_idx),
                                     1 + max(forward_idx, second_idx)]
    if skip_mode_allowed:
        f.skip_mode_present = bool(r.read_bit())
    else:
        f.skip_mode_present = False


def _set_frame_refs(seq: SequenceHeader, f: FrameHeader,
                    ref_order_hint: list, last_frame_idx: int,
                    gold_frame_idx: int) -> list:
    """Spec 7.8 set_frame_refs (frame_refs_short_signaling)."""
    from ffpic_tpu_torch.coding.av1_refs import get_relative_dist
    ref_frame_idx = [-1] * 7
    ref_frame_idx[0] = last_frame_idx              # LAST
    ref_frame_idx[3] = gold_frame_idx              # GOLDEN
    used = [False] * 8
    used[last_frame_idx] = used[gold_frame_idx] = True
    cur_hint = 1 << (seq.order_hint_bits - 1)
    shifted = [cur_hint + get_relative_dist(seq, ref_order_hint[i],
                                            f.order_hint)
               for i in range(8)]

    def find_latest_backward():
        ref, latest = -1, -1
        for i in range(8):
            if not used[i] and shifted[i] >= cur_hint and \
                    (ref < 0 or shifted[i] >= latest):
                ref, latest = i, shifted[i]
        return ref

    def find_earliest_backward():
        ref, earliest = -1, -1
        for i in range(8):
            if not used[i] and shifted[i] >= cur_hint and \
                    (ref < 0 or shifted[i] < earliest):
                ref, earliest = i, shifted[i]
        return ref

    def find_latest_forward():
        ref, latest = -1, -1
        for i in range(8):
            if not used[i] and shifted[i] < cur_hint and \
                    (ref < 0 or shifted[i] >= latest):
                ref, latest = i, shifted[i]
        return ref

    ref = find_latest_backward()
    if ref >= 0:
        ref_frame_idx[6] = ref                     # ALTREF
        used[ref] = True
    ref = find_earliest_backward()
    if ref >= 0:
        ref_frame_idx[4] = ref                     # BWDREF
        used[ref] = True
    ref = find_earliest_backward()
    if ref >= 0:
        ref_frame_idx[5] = ref                     # ALTREF2
        used[ref] = True
    # remaining forward refs in Ref_Frame_List order
    for slot in (1, 2, 4, 5, 6):                   # LAST2, LAST3,
        if ref_frame_idx[slot] < 0:                # BWD, ALT2, ALT
            ref = find_latest_forward()
            if ref >= 0:
                ref_frame_idx[slot] = ref
                used[ref] = True
    # fill leftovers with the overall earliest frame
    ref, earliest = -1, -1
    for i in range(8):
        if ref < 0 or shifted[i] < earliest:
            ref, earliest = i, shifted[i]
    for i in range(7):
        if ref_frame_idx[i] < 0:
            ref_frame_idx[i] = ref
    return ref_frame_idx


def _global_motion_params(r: BitReader, f: FrameHeader,
                          prev) -> None:
    """Spec 5.9.24/25: per-ref global motion with subexp-coded
    deltas against the primary ref's saved params."""
    IDENTITY, TRANSLATION, ROTZOOM, AFFINE = range(4)
    WARPEDMODEL_PREC_BITS = 16
    default = [0, 0, 1 << WARPEDMODEL_PREC_BITS, 0, 0,
               1 << WARPEDMODEL_PREC_BITS]
    f.gm_type = [IDENTITY] * 8
    f.gm_params = [list(default) for _ in range(8)]
    if f.frame_is_intra:
        return
    prev_gm = prev.gm_params if prev is not None else \
        [list(default) for _ in range(8)]

    def read_param(gtype: int, ref: int, idx: int) -> None:
        abs_bits = 12                  # GM_ABS_ALPHA_BITS
        prec_bits = 15                 # GM_ALPHA_PREC_BITS
        if idx < 2:
            if gtype == TRANSLATION:
                hp = 1 if f.allow_high_precision_mv else 0
                abs_bits = 9 - (1 - hp)    # GM_ABS_TRANS_ONLY_BITS
                prec_bits = 3 - (1 - hp)   # GM_TRANS_ONLY_PREC_BITS
            else:
                abs_bits = 12              # GM_ABS_TRANS_BITS
                prec_bits = 6              # GM_TRANS_PREC_BITS
        prec_diff = WARPEDMODEL_PREC_BITS - prec_bits
        rnd = (1 << WARPEDMODEL_PREC_BITS) if idx % 3 == 2 else 0
        sub = (1 << prec_bits) if idx % 3 == 2 else 0
        mx = 1 << abs_bits
        ref_v = (prev_gm[ref][idx] >> prec_diff) - sub
        v = _decode_signed_subexp_with_ref(r, -mx, mx + 1, ref_v)
        f.gm_params[ref][idx] = (v << prec_diff) + rnd

    for ref in range(1, 8):
        if r.read_bit():               # is_global
            if r.read_bit():           # is_rot_zoom
                gtype = ROTZOOM
            else:
                gtype = TRANSLATION if r.read_bit() else AFFINE
        else:
            gtype = IDENTITY
        f.gm_type[ref] = gtype
        if gtype >= ROTZOOM:
            read_param(gtype, ref, 2)
            read_param(gtype, ref, 3)
            if gtype == AFFINE:
                read_param(gtype, ref, 4)
                read_param(gtype, ref, 5)
            else:
                f.gm_params[ref][4] = -f.gm_params[ref][3]
                f.gm_params[ref][5] = f.gm_params[ref][2]
        if gtype >= TRANSLATION:
            read_param(gtype, ref, 0)
            read_param(gtype, ref, 1)


def _decode_signed_subexp_with_ref(r: BitReader, low: int,
                                   high: int, ref: int) -> int:
    x = _decode_unsigned_subexp_with_ref(r, high - low, ref - low)
    return x + low


def _decode_unsigned_subexp_with_ref(r: BitReader, mx: int,
                                     ref: int) -> int:
    v = _decode_subexp(r, mx)
    if (ref << 1) <= mx:
        return _inverse_recenter_h(ref, v)
    return mx - 1 - _inverse_recenter_h(mx - 1 - ref, v)


def _inverse_recenter_h(ref: int, v: int) -> int:
    if v > 2 * ref:
        return v
    if v & 1:
        return ref + ((v + 1) >> 1)
    return ref - (v >> 1)


def _decode_subexp(r: BitReader, num_syms: int) -> int:
    """Spec 5.9.27 decode_subexp (header-bitstream variant)."""
    i = 0
    mk = 0
    k = 3
    while True:
        b2 = k + i - 1 if i else k
        a = 1 << b2
        if num_syms <= mk + 3 * a:
            return _read_ns(r, num_syms - mk) + mk
        if r.read_bit():
            i += 1
            mk += a
        else:
            return r.read_bits(b2) + mk


def _parse_tile_info(r: BitReader, f: FrameHeader,
                     seq: SequenceHeader) -> None:
    """Spec 5.9.15."""
    sb_shift = 5 if seq.use_128x128_superblock else 4
    sb_cols = (f.mi_cols + (1 << sb_shift) - 1) >> sb_shift
    sb_rows = (f.mi_rows + (1 << sb_shift) - 1) >> sb_shift
    sb_size = sb_shift + 2
    max_tile_width_sb = MAX_TILE_WIDTH >> sb_size
    max_tile_area_sb = MAX_TILE_AREA >> (2 * sb_size)
    min_log2_tile_cols = tile_log2(max_tile_width_sb, sb_cols)
    max_log2_tile_cols = tile_log2(1, min(sb_cols, MAX_TILE_COLS))
    max_log2_tile_rows = tile_log2(1, min(sb_rows, MAX_TILE_ROWS))
    min_log2_tiles = max(
        min_log2_tile_cols,
        tile_log2(max_tile_area_sb, sb_rows * sb_cols))
    if r.read_bit():                # uniform_tile_spacing
        f.tile_cols_log2 = min_log2_tile_cols
        while f.tile_cols_log2 < max_log2_tile_cols:
            if r.read_bit():
                f.tile_cols_log2 += 1
            else:
                break
        tile_width_sb = (sb_cols + (1 << f.tile_cols_log2) - 1) >> \
            f.tile_cols_log2
        f.mi_col_starts = []
        i = 0
        start_sb = 0
        while start_sb < sb_cols:
            f.mi_col_starts.append(start_sb << sb_shift)
            i += 1
            start_sb += tile_width_sb
        f.mi_col_starts.append(f.mi_cols)
        f.tile_cols = i
        min_log2_tile_rows = max(min_log2_tiles - f.tile_cols_log2, 0)
        f.tile_rows_log2 = min_log2_tile_rows
        while f.tile_rows_log2 < max_log2_tile_rows:
            if r.read_bit():
                f.tile_rows_log2 += 1
            else:
                break
        tile_height_sb = (sb_rows + (1 << f.tile_rows_log2) - 1) >> \
            f.tile_rows_log2
        f.mi_row_starts = []
        i = 0
        start_sb = 0
        while start_sb < sb_rows:
            f.mi_row_starts.append(start_sb << sb_shift)
            i += 1
            start_sb += tile_height_sb
        f.mi_row_starts.append(f.mi_rows)
        f.tile_rows = i
    else:
        widest_tile_sb = 0
        start_sb = 0
        f.mi_col_starts = []
        i = 0
        while start_sb < sb_cols:
            f.mi_col_starts.append(start_sb << sb_shift)
            max_width = min(sb_cols - start_sb, max_tile_width_sb)
            width_in_sbs = _read_ns(r, max_width) + 1
            widest_tile_sb = max(width_in_sbs, widest_tile_sb)
            start_sb += width_in_sbs
            i += 1
        f.mi_col_starts.append(f.mi_cols)
        f.tile_cols = i
        f.tile_cols_log2 = tile_log2(1, f.tile_cols)
        if min_log2_tiles > 0:
            max_tile_area_sb = (sb_rows * sb_cols) >> \
                (min_log2_tiles + 1)
        else:
            max_tile_area_sb = sb_rows * sb_cols
        max_tile_height_sb = max(
            max_tile_area_sb // widest_tile_sb, 1)
        start_sb = 0
        f.mi_row_starts = []
        i = 0
        while start_sb < sb_rows:
            f.mi_row_starts.append(start_sb << sb_shift)
            max_height = min(sb_rows - start_sb, max_tile_height_sb)
            height_in_sbs = _read_ns(r, max_height) + 1
            start_sb += height_in_sbs
            i += 1
        f.mi_row_starts.append(f.mi_rows)
        f.tile_rows = i
        f.tile_rows_log2 = tile_log2(1, f.tile_rows)
    if f.tile_cols_log2 > 0 or f.tile_rows_log2 > 0:
        f.context_update_tile_id = r.read_bits(
            f.tile_rows_log2 + f.tile_cols_log2)
        f.tile_size_bytes = r.read_bits(2) + 1
    else:
        f.context_update_tile_id = 0


def _read_ns(r: BitReader, n: int) -> int:
    """ns(n), spec 4.10.7."""
    w = n.bit_length()
    m = (1 << w) - n
    v = r.read_bits(w - 1) if w > 1 else 0
    if v < m:
        return v
    return (v << 1) - m + r.read_bit()


def _parse_quantization_params(r: BitReader, f: FrameHeader,
                               seq: SequenceHeader) -> None:
    """Spec 5.9.12."""
    f.base_q_idx = r.read_bits(8)
    f.delta_q_y_dc = _read_delta_q(r)
    if seq.num_planes > 1:
        if seq.separate_uv_delta_q:
            diff_uv_delta = r.read_bit()
        else:
            diff_uv_delta = 0
        f.delta_q_u_dc = _read_delta_q(r)
        f.delta_q_u_ac = _read_delta_q(r)
        if diff_uv_delta:
            f.delta_q_v_dc = _read_delta_q(r)
            f.delta_q_v_ac = _read_delta_q(r)
        else:
            f.delta_q_v_dc = f.delta_q_u_dc
            f.delta_q_v_ac = f.delta_q_u_ac
    f.using_qmatrix = bool(r.read_bit())
    if f.using_qmatrix:
        f.qm_y = r.read_bits(4)
        f.qm_u = r.read_bits(4)
        if not seq.separate_uv_delta_q:
            f.qm_v = f.qm_u
        else:
            f.qm_v = r.read_bits(4)


def _parse_segmentation_params(r: BitReader, f: FrameHeader,
                               prev=None) -> None:
    """Spec 5.9.13.  With a primary ref, update flags are read and
    un-updated feature data carries over from the previous frame."""
    f.feature_enabled = [[0] * SEG_LVL_MAX for _ in range(8)]
    f.feature_data = [[0] * SEG_LVL_MAX for _ in range(8)]
    f.segmentation_enabled = bool(r.read_bit())
    if f.segmentation_enabled:
        if f.primary_ref_frame == PRIMARY_REF_NONE:
            f.segmentation_update_map = True
            f.segmentation_temporal_update = False
            segmentation_update_data = True
        else:
            f.segmentation_update_map = bool(r.read_bit())
            f.segmentation_temporal_update = bool(
                r.read_bit()) if f.segmentation_update_map else False
            segmentation_update_data = bool(r.read_bit())
            if prev is not None:
                f.feature_enabled = [list(row) for row in
                                     prev.feature_enabled]
                f.feature_data = [list(row) for row in
                                  prev.feature_data]
        f.segmentation_update_data = segmentation_update_data
        if segmentation_update_data:
            f.feature_enabled = [[0] * SEG_LVL_MAX for _ in range(8)]
            f.feature_data = [[0] * SEG_LVL_MAX for _ in range(8)]
            for i in range(8):
                for j in range(SEG_LVL_MAX):
                    if r.read_bit():
                        f.feature_enabled[i][j] = 1
                        bits = _SEG_BITS[j]
                        limit = _SEG_MAX[j]
                        if _SEG_SIGNED[j]:
                            v = _su(r, bits)
                            v = max(-limit, min(limit, v))
                        elif bits:
                            v = min(r.read_bits(bits), limit)
                        else:
                            v = 0
                        f.feature_data[i][j] = v
    last = 0
    pre_skip = False
    for i in range(8):
        for j in range(SEG_LVL_MAX):
            if f.feature_enabled[i][j]:
                last = i
                if j >= 5:          # SEG_LVL_REF_FRAME..SEG_LVL_SKIP
                    pre_skip = True
    f.seg_id_pre_skip = pre_skip
    f.last_active_seg_id = last


def get_qindex(f: FrameHeader, seg_id: int,
               current_q: int | None = None) -> int:
    base = f.base_q_idx if current_q is None else current_q
    if f.segmentation_enabled and \
            f.feature_enabled[seg_id][SEG_LVL_ALT_Q]:
        data = f.feature_data[seg_id][SEG_LVL_ALT_Q]
        return max(0, min(255, base + data))
    return max(0, min(255, base))


def _derive_lossless(f: FrameHeader, seq: SequenceHeader) -> None:
    f.coded_lossless = True
    for sid in range(8):
        q = get_qindex(f, sid)
        f.qindex_segs[sid] = q
        lossless = (q == 0 and f.delta_q_y_dc == 0 and
                    f.delta_q_u_ac == 0 and f.delta_q_u_dc == 0 and
                    f.delta_q_v_ac == 0 and f.delta_q_v_dc == 0)
        f.lossless_segs[sid] = lossless
        if not lossless:
            f.coded_lossless = False
    f.all_lossless = f.coded_lossless and \
        (f.width == f.upscaled_width)


def _parse_loop_filter_params(r: BitReader, f: FrameHeader,
                              seq: SequenceHeader) -> None:
    """Spec 5.9.11."""
    if f.coded_lossless or f.allow_intrabc:
        f.loop_filter_level = [0, 0, 0, 0]
        f.loop_filter_ref_deltas = [1, 0, 0, 0, -1, 0, -1, -1]
        f.loop_filter_mode_deltas = [0, 0]
        return
    f.loop_filter_level = [r.read_bits(6), r.read_bits(6), 0, 0]
    if seq.num_planes > 1:
        if f.loop_filter_level[0] or f.loop_filter_level[1]:
            f.loop_filter_level[2] = r.read_bits(6)
            f.loop_filter_level[3] = r.read_bits(6)
    f.loop_filter_sharpness = r.read_bits(3)
    f.loop_filter_delta_enabled = bool(r.read_bit())
    if f.loop_filter_delta_enabled:
        if r.read_bit():            # loop_filter_delta_update
            for i in range(NUM_REF_FRAMES):
                if r.read_bit():
                    f.loop_filter_ref_deltas[i] = _su(r, 6)
            for i in range(2):
                if r.read_bit():
                    f.loop_filter_mode_deltas[i] = _su(r, 6)


def _parse_cdef_params(r: BitReader, f: FrameHeader,
                       seq: SequenceHeader) -> None:
    """Spec 5.9.19."""
    if f.coded_lossless or f.allow_intrabc or not seq.enable_cdef:
        f.cdef_bits = 0
        f.cdef_y_pri_strength = [0]
        f.cdef_y_sec_strength = [0]
        f.cdef_uv_pri_strength = [0]
        f.cdef_uv_sec_strength = [0]
        f.cdef_damping = 3
        return
    f.cdef_damping = r.read_bits(2) + 3
    f.cdef_bits = r.read_bits(2)
    n = 1 << f.cdef_bits
    f.cdef_y_pri_strength = []
    f.cdef_y_sec_strength = []
    f.cdef_uv_pri_strength = []
    f.cdef_uv_sec_strength = []
    for _ in range(n):
        f.cdef_y_pri_strength.append(r.read_bits(4))
        v = r.read_bits(2)
        f.cdef_y_sec_strength.append(v + 1 if v == 3 else v)
        if seq.num_planes > 1:
            f.cdef_uv_pri_strength.append(r.read_bits(4))
            v = r.read_bits(2)
            f.cdef_uv_sec_strength.append(v + 1 if v == 3 else v)
        else:
            f.cdef_uv_pri_strength.append(0)
            f.cdef_uv_sec_strength.append(0)


_REMAP_LR_TYPE = [RESTORE_NONE, RESTORE_SWITCHABLE, RESTORE_WIENER,
                  RESTORE_SGRPROJ]


def _parse_lr_params(r: BitReader, f: FrameHeader,
                     seq: SequenceHeader) -> None:
    """Spec 5.9.20."""
    if f.all_lossless or f.allow_intrabc or \
            not seq.enable_restoration:
        f.lr_type = [RESTORE_NONE] * 3
        f.uses_lr = False
        return
    uses_lr = False
    uses_chroma_lr = False
    f.lr_type = []
    for i in range(seq.num_planes):
        t = _REMAP_LR_TYPE[r.read_bits(2)]
        f.lr_type.append(t)
        if t != RESTORE_NONE:
            uses_lr = True
            if i > 0:
                uses_chroma_lr = True
    while len(f.lr_type) < 3:
        f.lr_type.append(RESTORE_NONE)
    f.uses_lr = uses_lr
    if uses_lr:
        if seq.use_128x128_superblock:
            lr_unit_shift = r.read_bit() + 1
        else:
            lr_unit_shift = r.read_bit()
            if lr_unit_shift:
                lr_unit_shift += r.read_bit()
        f.lr_unit_size = [RESTORATION_TILESIZE_MAX >>
                          (2 - lr_unit_shift)] * 3
        if seq.subsampling_x and seq.subsampling_y and \
                uses_chroma_lr:
            lr_uv_shift = r.read_bit()
        else:
            lr_uv_shift = 0
        f.lr_unit_size[1] >>= lr_uv_shift
        f.lr_unit_size[2] >>= lr_uv_shift
