"""Pixel-space color utilities: RGBA->HSV and alpha blending.

Parity targets: the reference's BGRA32_TO_HSV (colorspace.c:999-1026,
integer hue math with C truncating division) and
blend_BGRA32_8bit_alpha (colorspace.c:1028-1038, float blend of a
foreground over an alpha-carrying background plane).  Both are
caller-less utilities in the reference; here they are vectorized
numpy ops on host arrays.

Copied from ``ffpic_tpu/ops/color_utils.py`` (``rgba_to_hsv``,
``alpha_blend``) for the PyTorch port; numpy only, as the original.
"""

from __future__ import annotations

import numpy as np


def _trunc_div(num, den):
    """C-style integer division (truncate toward zero) on arrays."""
    num = num.astype(np.int64)
    den = den.astype(np.int64)
    q = np.abs(num) // np.where(den == 0, 1, den)
    return np.where(num < 0, -q, q)


def rgba_to_hsv(rgba: np.ndarray):
    """(..., 4) uint8 RGBA -> (h, s, v) arrays.

    Integer formulation matching colorspace.c:999-1026: h in [0, 360]
    uint16 (0 for grays; truncating division like the reference's C
    int math — exactly 360 can occur when r is max with g just below
    b), s = 255 - 255*cmin/cmax uint8, v = cmax uint8.  Branch
    priority on max-channel ties is r, then g, then b.
    """
    a = np.asarray(rgba)
    if a.shape[-1] < 3:
        raise ValueError("rgba_to_hsv needs (..., 3|4) input")
    r = a[..., 0].astype(np.int64)
    g = a[..., 1].astype(np.int64)
    b = a[..., 2].astype(np.int64)
    cmax = np.maximum(np.maximum(r, g), b)
    cmin = np.minimum(np.minimum(r, g), b)
    d = cmax - cmin
    h_r = np.where(g >= b, _trunc_div(60 * (g - b), d),
                   _trunc_div(60 * (g - b), d) + 360)
    h_g = _trunc_div(60 * (b - r), d) + 120
    h_b = _trunc_div(60 * (r - g), d) + 240
    h = np.select([d == 0, cmax == r, cmax == g],
                  [np.zeros_like(h_r), h_r, h_g], default=h_b)
    s = np.where(cmax == 0, 0, 255 - _trunc_div(255 * cmin, cmax))
    return (h.astype(np.uint16), s.astype(np.uint8),
            cmax.astype(np.uint8))


def alpha_blend(fg: np.ndarray, bg: np.ndarray) -> np.ndarray:
    """Blend fg over bg where bg's first channel carries alpha,
    colorspace.c:1028-1038 style: out_c = fg_c*a + (1-a)*bg_c with
    a = bg[...,0]/255, out alpha = a*255.  Returns uint8 RGBA."""
    f = np.asarray(fg).astype(np.float32)
    gnd = np.asarray(bg).astype(np.float32)
    if f.shape != gnd.shape or f.shape[-1] != 4:
        raise ValueError("alpha_blend needs matching (..., 4) arrays")
    a = gnd[..., 0:1] / 255.0
    out = f * a + (1.0 - a) * gnd
    out[..., 3] = a[..., 0] * 255.0
    return out.astype(np.uint8)
