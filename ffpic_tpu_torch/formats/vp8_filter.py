"""VP8 in-loop deblocking filter (RFC 6386 section 15) of the port.

Copied from ``ffpic_tpu/formats/vp8_filter.py`` (``_filter_levels``,
``loop_filter_frame``): the per-macroblock filter level (segment and
mode deltas) and the whole-frame filter through the native C kernel
(``native.vp8_loop_filter``, ``native/host_vp8.c``), which the
original runs by default.  Its numpy edge filters, the original's
``FFPIC_NO_NATIVE`` fallback, are left out: the port's native build
raises on failure, so nothing would run them.
"""

from __future__ import annotations

import numpy as np

from ffpic_tpu_torch import native

B_PRED = 4


def _filter_levels(dec):
    """Per-MB loop-filter level (RFC 6386 15.3), vectorized."""
    h = dec.hdr
    if h.seg_enabled:
        seg_lf = np.asarray(h.seg_lf, np.int32)[dec.seg]
        lvl = seg_lf if h.seg_abs else h.filter_level + seg_lf
    else:
        lvl = np.full((dec.mbh, dec.mbw), h.filter_level, np.int32)
    lvl = np.clip(lvl, 0, 63)
    if h.lf_delta_enabled:
        lvl = lvl + h.ref_lf_deltas[0]             # intra frame
        lvl = np.where(dec.ymode == B_PRED,
                       lvl + h.mode_lf_deltas[0], lvl)
        lvl = np.clip(lvl, 0, 63)
    return lvl.astype(np.int32)


def loop_filter_frame(dec) -> None:
    """Filter ``dec``'s Y, U and V planes in place; inner edges only
    where a macroblock has coefficients or is B_PRED (RFC 15.2)."""
    h = dec.hdr
    if h.filter_level == 0:
        return
    levels = _filter_levels(dec)
    inner = (dec.mb_has_coeffs.astype(bool)
             | (dec.ymode == B_PRED)).astype(np.uint8)
    native.vp8_loop_filter(dec.Y, dec.U, dec.V, levels, inner,
                           h.filter_type == 1, h.sharpness)
