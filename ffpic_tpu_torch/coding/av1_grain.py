"""AV1 film grain parameters (spec 5.9.30 film_grain_params), which
the frame header parses for every shown frame that carries them.

Copied from ``ffpic_tpu/coding/av1_grain.py:20-127`` (``GrainParams``,
``parse_film_grain``) for the PyTorch port.  The synthesis and blend
(``generate_templates``, ``scaling_lut``, ``apply_grain``, with
``av1_grain_tables``) are not copied: in the reference only
``Av1Decoder`` applies grain, and ``av1_recon.decode_frame``, the still
path, never does.  They wait for ``ROADMAP.md`` Queue 1 item 19.
"""

from __future__ import annotations


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
