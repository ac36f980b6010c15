"""VP8L (lossless WebP) decoder of the port.

Copied from ``ffpic_tpu/formats/vp8l.py`` (``CLCL_ORDER``,
``DIST_MAP``, ``LsbReader``, ``_decode_entropy_image``'s native route,
the inverse transforms, ``decode_vp8l``, ``decode_alpha_stream``,
``decode_stream``): canonical-Huffman-coded ARGB with LZ77 backward
references, colour cache and meta Huffman groups, decoded by the native
entropy decoder (``native.vp8l_entropy``, ``native/host_vp8l.c``), then
all four inverse transforms on the host (predictor x14, colour,
subtract-green, colour indexing with sub-byte pixel packing), as in the
original.  The original's Python entropy decoder (``HTree``,
``HuffmanGroup``, its ``FFPIC_NO_NATIVE`` fallback) is left out: the
port's native build raises on failure, so nothing would run it.  The
predictor transform keeps the original's per-pixel loop.
"""

from __future__ import annotations

import numpy as np

from ffpic_tpu_torch import native
from ffpic_tpu_torch.utils.vlog import get_logger

log = get_logger("vp8l")

# code length code order (spec 6.2.2.1)
CLCL_ORDER = [17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13,
              14, 15]

# distance mapping neighborhood (spec 6.2.3): (dx, dy) codes 1..120
DIST_MAP = [
    (0, 1), (1, 0), (1, 1), (-1, 1), (0, 2), (2, 0), (1, 2), (-1, 2),
    (2, 1), (-2, 1), (2, 2), (-2, 2), (0, 3), (3, 0), (1, 3), (-1, 3),
    (3, 1), (-3, 1), (2, 3), (-2, 3), (3, 2), (-3, 2), (0, 4), (4, 0),
    (1, 4), (-1, 4), (4, 1), (-4, 1), (3, 3), (-3, 3), (2, 4), (-2, 4),
    (4, 2), (-4, 2), (0, 5), (3, 4), (-3, 4), (4, 3), (-4, 3), (5, 0),
    (1, 5), (-1, 5), (5, 1), (-5, 1), (2, 5), (-2, 5), (5, 2), (-5, 2),
    (4, 4), (-4, 4), (3, 5), (-3, 5), (5, 3), (-5, 3), (0, 6), (6, 0),
    (1, 6), (-1, 6), (6, 1), (-6, 1), (2, 6), (-2, 6), (6, 2), (-6, 2),
    (4, 5), (-4, 5), (5, 4), (-5, 4), (3, 6), (-3, 6), (6, 3), (-6, 3),
    (0, 7), (7, 0), (1, 7), (-1, 7), (5, 5), (-5, 5), (7, 1), (-7, 1),
    (4, 6), (-4, 6), (6, 4), (-6, 4), (2, 7), (-2, 7), (7, 2), (-7, 2),
    (3, 7), (-3, 7), (7, 3), (-7, 3), (5, 6), (-5, 6), (6, 5), (-6, 5),
    (8, 0), (4, 7), (-4, 7), (7, 4), (-7, 4), (8, 1), (8, 2), (6, 6),
    (-6, 6), (8, 3), (5, 7), (-5, 7), (7, 5), (-7, 5), (8, 4), (6, 7),
    (-6, 7), (7, 6), (-7, 6), (8, 5), (7, 7), (-7, 7), (8, 6), (8, 7),
]


class LsbReader:
    """LSB-first bit reader over bytes (VP8L convention)."""

    __slots__ = ("data", "pos", "bit", "n")

    def __init__(self, data: bytes):
        self.data = data
        self.n = len(data)
        self.pos = 0
        self.bit = 0

    def read(self, nbits: int) -> int:
        v = 0
        got = 0
        while got < nbits:
            byte = self.data[self.pos] if self.pos < self.n else 0
            take = min(8 - self.bit, nbits - got)
            v |= ((byte >> self.bit) & ((1 << take) - 1)) << got
            got += take
            self.bit += take
            if self.bit == 8:
                self.bit = 0
                self.pos += 1
        return v


def _decode_entropy_image(r: LsbReader, w: int, h: int,
                          allow_meta: bool) -> np.ndarray:
    """Decode a (sub-)image of ARGB pixels (spec 6.2.4) with the native
    entropy decoder, advancing ``r``.  Returns (h, w, 4) uint8
    [A, R, G, B]."""
    out, pos, bit = native.vp8l_entropy(
        bytes(r.data), r.pos, r.bit, w, h, allow_meta,
        np.asarray(CLCL_ORDER, np.uint8), np.asarray(DIST_MAP, np.int16))
    r.pos, r.bit = pos, bit
    return out


# ---------------------------------------------------------------------------
# inverse transforms (spec section 4); pixel layout here is (h, w, 4) ARGB

def _inv_subtract_green(img):
    g = img[..., 2].astype(np.int32)
    img[..., 1] = ((img[..., 1] + g) & 255).astype(np.uint8)
    img[..., 3] = ((img[..., 3] + g) & 255).astype(np.uint8)


def _inv_color_transform(img, sub, bits):
    """spec 4.3 / libwebp VP8LTransformColorInverse: deltas are
    (int8 multiplier * int8 channel) >> 5, channels updated in order
    red (from green) then blue (from green and the NEW red)."""
    h, w = img.shape[:2]

    def to_s8(v):
        v = v.astype(np.int32)
        return np.where(v > 127, v - 256, v)

    by = np.arange(h) >> bits
    bx = np.arange(w) >> bits
    # cte stored as ARGB pixel: green_to_red in blue, green_to_blue in
    # green, red_to_blue in red
    g2r = to_s8(sub[by][:, bx, 3])
    g2b = to_s8(sub[by][:, bx, 2])
    r2b = to_s8(sub[by][:, bx, 1])

    gs = to_s8(img[..., 2])
    r = (img[..., 1].astype(np.int32) + ((g2r * gs) >> 5)) & 255
    rs = np.where(r > 127, r - 256, r)
    b = (img[..., 3].astype(np.int32) + ((g2b * gs) >> 5)) & 255
    b = (b + ((r2b * rs) >> 5)) & 255
    img[..., 1] = r.astype(np.uint8)
    img[..., 3] = b.astype(np.uint8)


def _inv_predictor(img, sub, bits):
    """14 spatial predictors, row-sequential (spec 4.2)."""
    h, w = img.shape[:2]
    x32 = img.astype(np.int32)
    out = np.zeros_like(x32)

    def avg2(a, b):
        return (a + b) >> 1

    modes = (sub[..., 2]).astype(np.int32)  # green channel holds mode

    for y in range(h):
        my = modes[y >> bits]
        for x in range(w):
            if x == 0 and y == 0:
                pred = np.array([255, 0, 0, 0], np.int32)
            elif y == 0:
                pred = out[0, x - 1]
            elif x == 0:
                pred = out[y - 1, 0]
            else:
                m = my[x >> bits]
                L = out[y, x - 1]
                T = out[y - 1, x]
                TL = out[y - 1, x - 1]
                # TR of the last column wraps to the first pixel of the
                # current row (libwebp's contiguous-buffer behavior)
                TR = out[y - 1, x + 1] if x + 1 < w else out[y, 0]
                if m == 0:
                    pred = np.array([255, 0, 0, 0], np.int32)
                elif m == 1:
                    pred = L
                elif m == 2:
                    pred = T
                elif m == 3:
                    pred = TR
                elif m == 4:
                    pred = TL
                elif m == 5:
                    pred = avg2(avg2(L, TR), T)
                elif m == 6:
                    pred = avg2(L, TL)
                elif m == 7:
                    pred = avg2(L, T)
                elif m == 8:
                    pred = avg2(TL, T)
                elif m == 9:
                    pred = avg2(T, TR)
                elif m == 10:
                    pred = avg2(avg2(L, TL), avg2(T, TR))
                elif m == 11:  # Select
                    p = L + T - TL
                    pl = np.abs(p - L).sum()
                    pt = np.abs(p - T).sum()
                    pred = L if pl < pt else T
                elif m == 12:  # ClampAddSubtractFull
                    pred = np.clip(L + T - TL, 0, 255)
                else:          # ClampAddSubtractHalf: (a-b)/2 with C
                    # truncation toward zero (libwebp int division)
                    a = avg2(L, T)
                    d = a - TL
                    pred = np.clip(a + ((d + (d < 0)) >> 1), 0, 255)
            out[y, x] = (x32[y, x] + pred) & 255
    img[:] = out.astype(np.uint8)


def decode_vp8l(data: bytes) -> np.ndarray:
    """data: VP8L chunk payload. Returns (H, W, 4) uint8 RGBA."""
    if data[0] != 0x2F:
        raise ValueError("bad VP8L signature")
    bits = int.from_bytes(data[1:5], "little")
    w = (bits & 0x3FFF) + 1
    h = ((bits >> 14) & 0x3FFF) + 1
    # the 32 header bits (w, h, alpha hint, version) fill bytes 1..4
    # exactly; the entropy stream starts byte-aligned at offset 5
    argb = decode_stream(LsbReader(data[5:]), w, h)
    return np.ascontiguousarray(argb[..., [1, 2, 3, 0]])


def decode_alpha_stream(data: bytes, w: int, h: int) -> np.ndarray:
    """Headerless VP8L stream carrying alpha in the green channel
    (WebP ALPH chunk, compression method 1). Returns (h, w) uint8."""
    argb = decode_stream(LsbReader(data), w, h)
    return np.ascontiguousarray(argb[..., 2])


def decode_stream(r: LsbReader, w: int, h: int) -> np.ndarray:
    """Decode a (possibly transformed) VP8L image stream; returns
    (h, w, 4) uint8 in internal ARGB channel order."""
    transforms = []
    xsize = w
    while r.read(1):
        ttype = r.read(2)
        if ttype in (0, 1):  # predictor / color transform
            tbits = r.read(3) + 2
            sw = (xsize + (1 << tbits) - 1) >> tbits
            sh = (h + (1 << tbits) - 1) >> tbits
            sub = _decode_entropy_image(r, sw, sh, False)
            transforms.append((ttype, tbits, sub))
        elif ttype == 2:     # subtract green
            transforms.append((2, 0, None))
        else:                # color indexing
            n_colors = r.read(8) + 1
            pal = _decode_entropy_image(r, n_colors, 1, False)[0]
            # palette is delta-coded
            pal = np.cumsum(pal.astype(np.int32), axis=0) & 255
            pal = pal.astype(np.uint8)
            if n_colors <= 2:
                pbits = 3
            elif n_colors <= 4:
                pbits = 2
            elif n_colors <= 16:
                pbits = 1
            else:
                pbits = 0
            transforms.append((3, pbits, pal))
            if pbits:
                xsize = (xsize + (1 << pbits) - 1) >> pbits

    img = _decode_entropy_image(r, xsize, h, True)

    for ttype, tbits, sub in reversed(transforms):
        if ttype == 0:
            _inv_predictor(img, sub, tbits)
        elif ttype == 1:
            _inv_color_transform(img, sub, tbits)
        elif ttype == 2:
            _inv_subtract_green(img)
        else:
            pal = sub
            if tbits:
                # unpack sub-byte indices from the green channel
                per = 1 << tbits
                ibits = 8 >> tbits
                idx = img[..., 2]
                cols = []
                for k in range(per):
                    cols.append((idx >> (k * ibits)) & ((1 << ibits) - 1))
                wide = np.stack(cols, axis=2).reshape(h, -1)[:, :w]
            else:
                wide = img[..., 2][:, :w]
            # out-of-range indices resolve to 0x00000000: libwebp
            # expands the color map to the full index range with a
            # zero tail (vp8l_dec.c ExpandColorMap), it does NOT clamp
            ibits = 8 >> tbits
            full = np.zeros((1 << ibits, 4), pal.dtype)
            full[:len(pal)] = pal[:1 << ibits]
            img = full[wide]

    return img[:h, :w]
