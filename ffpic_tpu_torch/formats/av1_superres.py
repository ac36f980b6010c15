"""AV1 superres horizontal upscale (spec 7.16), applied between CDEF
and loop restoration: each plane row is upscaled from the coded
(downscaled) width to upscaled_width with the normative 64-phase
8-tap filters at 1/16384 step precision.

The C reference has no AV1 decode layer; dav1d is the bit-exact
oracle (tests/test_av1_grain.py superres cases).

Copied from ``ffpic_tpu/formats/av1_superres.py`` for the PyTorch port
with its imports rewritten to the port's modules.
"""

from __future__ import annotations

import numpy as np

from ffpic_tpu_torch.coding.av1_superres_tables import UPSCALE_FILTER

SCALE_BITS = 14                  # RS_SCALE_SUBPEL_BITS
SCALE_MASK = (1 << SCALE_BITS) - 1
EXTRA_BITS = SCALE_BITS - 6      # RS_SCALE_EXTRA_BITS (filter 1/64)
EXTRA_OFF = 1 << (EXTRA_BITS - 1)
FILTER_BITS = 7


def upscale_plane(plane: np.ndarray, down_w: int, up_w: int,
                  bd: int) -> np.ndarray:
    """Upscale one plane's rows from down_w to up_w pixels
    (av1_upscale_normative_row)."""
    if down_w == up_w:
        return plane
    h = plane.shape[0]

    def cdiv(a, b):
        # C integer division truncates toward zero
        q = abs(a) // abs(b)
        return -q if (a < 0) != (b < 0) else q

    step = ((down_w << SCALE_BITS) + (up_w >> 1)) // up_w
    err = up_w * step - (down_w << SCALE_BITS)
    x0 = (cdiv(-((up_w - down_w) << (SCALE_BITS - 1)) + (up_w >> 1),
               up_w) + EXTRA_OFF - cdiv(err, 2)) & SCALE_MASK
    xs = x0 + step * np.arange(up_w)
    # source base: one LEFT of the integer position (dav1d resize
    # starts src_x at -1; taps then read src_x - 3 .. +4) — pinned
    # empirically against dav1d output rows
    src_x = (xs >> SCALE_BITS) - 1
    phase = ((xs & SCALE_MASK) >> EXTRA_BITS) & 0x3F
    taps = UPSCALE_FILTER[phase].astype(np.int32)     # (up_w, 8)
    src = plane.astype(np.int32)
    acc = np.zeros((h, up_w), np.int64)
    # positioning (step/x0) uses the CROP width; the tap reads clamp
    # at the mi-aligned padded extent — dav1d reads the decoded
    # padding columns there, and the right-edge taps do reference
    # them (pinned vs dav1d on odd-width streams)
    clamp_w = plane.shape[1]
    for t in range(8):
        cols = np.clip(src_x + (t - 3), 0, clamp_w - 1)
        acc += taps[:, t][None, :].astype(np.int64) * src[:, cols]
    out = (acc + (1 << (FILTER_BITS - 1))) >> FILTER_BITS
    return np.clip(out, 0, (1 << bd) - 1).astype(plane.dtype)


def superres_frame(fs, planes):
    """Upscale all planes per the frame's superres geometry."""
    fh, seq = fs.fh, fs.seq
    if not fh.use_superres or fh.width == fh.upscaled_width:
        return planes
    out = []
    for pi, p in enumerate(planes):
        sx = seq.subsampling_x if pi else 0
        dw = (fh.width + sx) >> sx
        uw = (fh.upscaled_width + sx) >> sx
        out.append(upscale_plane(p, dw, uw, seq.bit_depth))
    return out
