"""JPEG 2000 (ISO/IEC 15444-1) codestream decoder: MQ arithmetic
coder (Annex C), EBCOT tier-1 coefficient-bit modeling (Annex D),
tier-2 packet decoding with tag trees (Annex B), inverse 5/3 and 9/7
wavelets (Annex F), dequantization (Annex E) and the RCT/ICT
multi-component transforms (Annex G).

The reference parses JP2 boxes and codestream markers but has no
entropy decode and produces no pixels (jp2.c:424-447 stops at packet
headers) — this is a beat-the-reference component.  Differentially
tested against openjpeg via PIL (tests/test_jp2_decode.py).

Scope: component subsampling 1, one precinct per resolution (the
openjpeg/PIL defaults) or explicit precinct grids (scod&1, incl.
multi-tile with absolute-anchored grids), all five progression
orders (LRCP/RLCP/RPCL/PCRL/CPRL), any layer count,
reversible (5/3 + RCT) and irreversible (9/7 + ICT), multi-tile
codestreams (power-of-two tile sizes), up to 16-bit components.
Tier-1 runs in C (native/host_jp2.c, ~100x the Python oracle).

Copied from ``ffpic_tpu/coding/jpeg2000.py`` for the PyTorch port, with
one change: tier-1 always takes the native ``jp2_block``
(``ffpic_tpu_torch/native/host_jp2.c``, built with the port's other host
sources; a failed build raises).  The original falls back to the Python
``BlockDecoder`` under ``FFPIC_NO_NATIVE`` or without its library
(``ffpic_tpu/coding/jpeg2000.py:888-905``); here ``MQDecoder`` and
``BlockDecoder`` stay only as the oracle the tests hold the C against,
as PNG's Python unfilter does (``formats/png.py``; ``ROADMAP.md`` Queue 1
item 3).
"""

from __future__ import annotations

import math
import struct

import numpy as np

from ffpic_tpu_torch import native
from ffpic_tpu_torch.utils.trace import stage

# ---------------------------------------------------------------------------
# MQ arithmetic decoder (Annex C; same coder as JBIG2)
# ---------------------------------------------------------------------------

# (Qe, NMPS, NLPS, SWITCH)
QE = (
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0),
    (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0), (0x0221, 38, 33, 0),
    (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0),
    (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0),
    (0x3801, 19, 17, 0), (0x3401, 20, 18, 0), (0x3001, 21, 19, 0),
    (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0),
    (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0),
    (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0),
    (0x0085, 40, 37, 0), (0x0049, 41, 38, 0), (0x0025, 42, 39, 0),
    (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0), (0x5601, 46, 46, 0),
)

N_CTX = 19
CTX_UNI = 18
CTX_RL = 17


class MQDecoder:
    """C.3 decoding procedure.  Context state: (index, mps) pairs."""

    __slots__ = ("data", "bp", "c", "a", "ct", "idx", "mps")

    def __init__(self, data: bytes):
        self.data = data
        # INITDEC (C.3.5)
        self.bp = 0
        b0 = data[0] if data else 0xFF
        self.c = b0 << 16
        self.ct = 0
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000
        # context states: D.2 initial indices
        self.idx = [0] * N_CTX
        self.mps = [0] * N_CTX
        self.idx[CTX_UNI] = 46
        self.idx[CTX_RL] = 3
        self.idx[0] = 4                # first ZC context

    def _bytein(self):
        data, bp = self.data, self.bp
        b = data[bp] if bp < len(data) else 0xFF
        if b == 0xFF:
            b1 = data[bp + 1] if bp + 1 < len(data) else 0xFF
            if b1 > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp = bp + 1
                self.c += b1 << 9
                self.ct = 7
        else:
            self.bp = bp + 1
            b1 = data[bp + 1] if bp + 1 < len(data) else 0xFF
            self.c += b1 << 8
            self.ct = 8

    def decode(self, cx: int) -> int:
        i = self.idx[cx]
        qe, nmps, nlps, switch = QE[i]
        self.a -= qe
        if ((self.c >> 16) & 0xFFFF) < qe:
            # LPS exchange path
            if self.a < qe:
                d = self.mps[cx]
                self.idx[cx] = nmps
            else:
                d = 1 - self.mps[cx]
                if switch:
                    self.mps[cx] ^= 1
                self.idx[cx] = nlps
            self.a = qe
        else:
            self.c -= qe << 16
            if self.a & 0x8000:
                return self.mps[cx]
            if self.a < qe:
                d = 1 - self.mps[cx]
                if switch:
                    self.mps[cx] ^= 1
                self.idx[cx] = nlps
            else:
                d = self.mps[cx]
                self.idx[cx] = nmps
        # RENORMD
        while True:
            if self.ct == 0:
                self._bytein()
            self.a = (self.a << 1) & 0xFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.a & 0x8000:
                break
        return d


# ---------------------------------------------------------------------------
# tier-1: EBCOT coefficient-bit modeling (Annex D)
# ---------------------------------------------------------------------------

def _zc_tables():
    """ctx index per (orientation, h, v, d) — Table D.1."""
    lut = np.zeros((3, 3, 3, 5), np.int8)   # [kind][h][v][d]
    # kind 0: LL & LH (and HL via swapped h/v); kind 2: HH
    for h in range(3):
        for v in range(3):
            for d in range(5):
                if h == 2:
                    c = 8
                elif h == 1:
                    c = 7 if v >= 1 else (6 if d >= 1 else 5)
                else:
                    if v == 2:
                        c = 4
                    elif v == 1:
                        c = 3
                    elif d >= 2:
                        c = 2
                    else:
                        c = d
                lut[0, h, v, d] = c
                lut[1, v, h, d] = c          # HL: swap h/v
                hv = h + v
                if d >= 3:
                    c2 = 8
                elif d == 2:
                    c2 = 7 if hv >= 1 else 6
                elif d == 1:
                    c2 = 5 if hv >= 2 else (4 if hv == 1 else 3)
                else:
                    c2 = 2 if hv >= 2 else hv
                lut[2, h, v, d] = c2
    return lut


_ZC = _zc_tables()

# sign-coding Table D.3: (hc+1, vc+1) -> (ctx, xorbit)
_SC = {(2, 2): (13, 0), (2, 1): (12, 0), (2, 0): (11, 0),
       (1, 2): (10, 0), (1, 1): (9, 0), (1, 0): (10, 1),
       (0, 2): (11, 1), (0, 1): (12, 1), (0, 0): (13, 1)}


class BlockDecoder:
    """Decode one code-block's coefficient magnitudes + signs."""

    def __init__(self, w: int, h: int, orient: int):
        self.w, self.h = w, h
        self.orient = orient               # 0 LL/LH kind, 1 HL, 2 HH
        # padded state arrays (1-cell border simplifies neighbors)
        self.sig = np.zeros((h + 2, w + 2), np.uint8)
        self.sgn = np.zeros((h + 2, w + 2), np.uint8)   # 1 = negative
        self.vis = np.zeros((h + 2, w + 2), np.uint8)
        self.refined = np.zeros((h + 2, w + 2), np.uint8)
        self.mag = np.zeros((h, w), np.int32)

    # neighbor helpers (y/x are 1-based into padded arrays)
    def _hvd(self, y, x):
        s = self.sig
        hn = int(s[y, x - 1]) + int(s[y, x + 1])
        vn = int(s[y - 1, x]) + int(s[y + 1, x])
        dn = (int(s[y - 1, x - 1]) + int(s[y - 1, x + 1])
              + int(s[y + 1, x - 1]) + int(s[y + 1, x + 1]))
        return hn, vn, dn

    def _zc_ctx(self, y, x):
        hn, vn, dn = self._hvd(y, x)
        return int(_ZC[self.orient, min(hn, 2), min(vn, 2), min(dn, 4)])

    def _decode_sign(self, mq, y, x):
        s, g = self.sig, self.sgn

        def contrib(sig_a, sgn_a, sig_b, sgn_b):
            c = 0
            if sig_a:
                c += -1 if sgn_a else 1
            if sig_b:
                c += -1 if sgn_b else 1
            return max(-1, min(1, c))
        hc = contrib(s[y, x - 1], g[y, x - 1], s[y, x + 1], g[y, x + 1])
        vc = contrib(s[y - 1, x], g[y - 1, x], s[y + 1, x], g[y + 1, x])
        ctx, xorbit = _SC[(hc + 1, vc + 1)]
        return mq.decode(ctx) ^ xorbit

    def decode(self, data: bytes, n_passes: int, mb: int,
               zbp: int) -> np.ndarray:
        """Run n_passes starting at bit-plane mb-1-zbp.  Returns
        signed int32 coefficients (mag with sign applied)."""
        if n_passes <= 0 or not data:
            return self.mag
        mq = MQDecoder(data)
        w, h = self.w, self.h
        plane = mb - 1 - zbp
        # first plane: cleanup only
        pass_kind = 2
        for _ in range(n_passes):
            if plane < 0:
                break
            bit = 1 << plane
            if pass_kind == 0:
                self._spp(mq, bit)
            elif pass_kind == 1:
                self._mrp(mq, bit)
            else:
                self._cup(mq, bit)
                self.vis[:] = 0
                plane -= 1
            pass_kind = (pass_kind + 1) % 3
        out = self.mag.copy()
        neg = self.sgn[1:h + 1, 1:w + 1] == 1
        out[neg] = -out[neg]
        return out

    def _spp(self, mq, bit):
        sig, vis = self.sig, self.vis
        for y0 in range(1, self.h + 1, 4):
            for x in range(1, self.w + 1):
                for y in range(y0, min(y0 + 4, self.h + 1)):
                    if sig[y, x]:
                        continue
                    hn, vn, dn = self._hvd(y, x)
                    if hn + vn + dn == 0:
                        continue
                    vis[y, x] = 1
                    ctx = int(_ZC[self.orient, min(hn, 2), min(vn, 2),
                                  min(dn, 4)])
                    if mq.decode(ctx):
                        self.sgn[y, x] = self._decode_sign(mq, y, x)
                        sig[y, x] = 1
                        self.mag[y - 1, x - 1] = bit

    def _mrp(self, mq, bit):
        sig, vis, ref = self.sig, self.vis, self.refined
        for y0 in range(1, self.h + 1, 4):
            for x in range(1, self.w + 1):
                for y in range(y0, min(y0 + 4, self.h + 1)):
                    if not sig[y, x] or vis[y, x]:
                        continue
                    if ref[y, x]:
                        ctx = 16
                    else:
                        hn, vn, dn = self._hvd(y, x)
                        ctx = 15 if hn + vn + dn else 14
                        ref[y, x] = 1
                    if mq.decode(ctx):
                        self.mag[y - 1, x - 1] |= bit
                    vis[y, x] = 1

    def _cup(self, mq, bit):
        sig, vis = self.sig, self.vis
        h, w = self.h, self.w
        for y0 in range(1, h + 1, 4):
            full = y0 + 3 <= h
            for x in range(1, w + 1):
                y = y0
                if full and not vis[y0:y0 + 4, x].any() \
                        and not sig[y0:y0 + 4, x].any():
                    # run-length mode: all 4 with zero context?
                    clean = True
                    for yy in range(y0, y0 + 4):
                        hn, vn, dn = self._hvd(yy, x)
                        if hn + vn + dn:
                            clean = False
                            break
                    if clean:
                        if not mq.decode(CTX_RL):
                            continue
                        r = (mq.decode(CTX_UNI) << 1) | mq.decode(
                            CTX_UNI)
                        y = y0 + r
                        # that sample becomes significant directly
                        self.sgn[y, x] = self._decode_sign(mq, y, x)
                        sig[y, x] = 1
                        self.mag[y - 1, x - 1] = bit
                        y += 1
                while y < min(y0 + 4, h + 1):
                    if not sig[y, x] and not vis[y, x]:
                        ctx = self._zc_ctx(y, x)
                        if mq.decode(ctx):
                            self.sgn[y, x] = self._decode_sign(mq, y,
                                                               x)
                            sig[y, x] = 1
                            self.mag[y - 1, x - 1] = bit
                    y += 1


# ---------------------------------------------------------------------------
# tier-2: packet headers (Annex B)
# ---------------------------------------------------------------------------

class PktBits:
    """Packet-header bit reader with 0xFF stuffing (B.10.1)."""

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self.byte = 0
        self.ct = 0

    def bit(self) -> int:
        if self.ct == 0:
            prev = self.byte
            self.byte = self.data[self.pos]
            self.pos += 1
            self.ct = 7 if prev == 0xFF else 8
        self.ct -= 1
        return (self.byte >> self.ct) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self) -> int:
        """End of packet header: byte-align (+ stuffing byte after a
        trailing 0xFF); returns the body start position."""
        if self.ct == 0 and self.byte == 0xFF:
            self.pos += 1                 # stuffing byte
        self.ct = 0
        self.byte = 0
        return self.pos


class TagTree:
    """B.10.2 tag tree over a w x h leaf grid.  Each node carries a
    lower bound (`low`) and a resolved flag (`known`, meaning value ==
    low); queries refine nodes root-to-leaf up to a threshold."""

    def __init__(self, w: int, h: int):
        self.dims = []
        while True:
            self.dims.append((w, h))
            if w == 1 and h == 1:
                break
            w, h = (w + 1) // 2, (h + 1) // 2
        self.low = [np.zeros((h_, w_), np.int32)
                    for (w_, h_) in self.dims]
        self.known = [np.zeros((h_, w_), bool)
                      for (w_, h_) in self.dims]

    def decode(self, br: PktBits, x: int, y: int,
               threshold: int) -> int:
        """Returns the leaf value if it resolves < threshold, else
        `threshold` (meaning value >= threshold)."""
        low = 0
        for lvl in range(len(self.dims) - 1, -1, -1):
            nx, ny = x >> lvl, y >> lvl
            lo = self.low[lvl]
            kn = self.known[lvl]
            if lo[ny, nx] < low:
                lo[ny, nx] = low
            while not kn[ny, nx] and lo[ny, nx] < threshold:
                if br.bit():
                    kn[ny, nx] = True
                else:
                    lo[ny, nx] += 1
            low = int(lo[ny, nx])
            if not kn[ny, nx]:
                return threshold          # >= threshold, unresolved
        return low

    def decode_full(self, br: PktBits, x: int, y: int) -> int:
        """Fully resolve a leaf value (used for zero bit-planes)."""
        t = 1
        while True:
            v = self.decode(br, x, y, t)
            if v < t:
                return v
            t += 1


def _decode_npasses(br: PktBits) -> int:
    if not br.bit():
        return 1
    if not br.bit():
        return 2
    v = br.bits(2)
    if v < 3:
        return 3 + v
    v = br.bits(5)
    if v < 31:
        return 6 + v
    return 37 + br.bits(7)


# ---------------------------------------------------------------------------
# inverse wavelets (Annex F; openjpeg-compatible lifting)
# ---------------------------------------------------------------------------

def _idwt53_1d(L: np.ndarray, H: np.ndarray) -> np.ndarray:
    """Inverse reversible 5/3 along axis 0 (vectorized over axis 1).
    Even output samples come from L, odd from H (even-anchored)."""
    nl, nh = L.shape[0], H.shape[0]
    n = nl + nh
    if n == 1:
        return L if nl else (H // 2)
    Lp = L.astype(np.int64)
    Hp = H.astype(np.int64)

    def Hc(i):                       # clamped highpass access
        return Hp[min(max(i, 0), nh - 1)]
    # even: x[2i] = L[i] - floor((H[i-1] + H[i] + 2) / 4)
    hm1 = Hp[np.maximum(np.arange(nl) - 1, 0)]
    h0 = Hp[np.minimum(np.arange(nl), nh - 1)]
    ev = Lp - ((hm1 + h0 + 2) >> 2)
    # odd: x[2i+1] = H[i] + floor((x[2i] + x[2i+2]) / 2)
    e0 = ev[np.minimum(np.arange(nh), nl - 1)]
    e1 = ev[np.minimum(np.arange(nh) + 1, nl - 1)]
    od = Hp + ((e0 + e1) >> 1)
    out = np.empty((n,) + L.shape[1:], np.int64)
    out[0::2] = ev
    out[1::2] = od
    return out


_K97 = 1.230174104914
_IK97 = 1.0 / _K97
_A97 = 1.586134342059924
_B97 = 0.052980118572961
_G97 = 0.882911075530934
_D97 = 0.443506852043971


def _idwt97_1d(L: np.ndarray, H: np.ndarray) -> np.ndarray:
    """Inverse irreversible 9/7 along axis 0 (float64)."""
    nl, nh = L.shape[0], H.shape[0]
    n = nl + nh
    if n == 1:
        return (L * 1.0) if nl else (H * 0.5)
    s = L.astype(np.float64) * _K97
    d = H.astype(np.float64) * _IK97

    def cl(a, i):
        return a[np.clip(i, 0, a.shape[0] - 1)]
    i_l = np.arange(nl)
    i_h = np.arange(nh)
    # spec F.4.8.2 lifting with alpha/beta NEGATIVE (T.800):
    # undo delta, gamma (positive), then beta, alpha (negative)
    s = s - _D97 * (cl(d, i_l - 1) + cl(d, i_l))
    d = d - _G97 * (cl(s, i_h) + cl(s, i_h + 1))
    s = s + _B97 * (cl(d, i_l - 1) + cl(d, i_l))
    d = d + _A97 * (cl(s, i_h) + cl(s, i_h + 1))
    out = np.empty((n,) + L.shape[1:], np.float64)
    out[0::2] = s
    out[1::2] = d
    return out


def _idwt_2d(ll, hl, lh, hh, reversible: bool):
    """One synthesis level: LL+HL (columns-of-rows) then vertical."""
    f = _idwt53_1d if reversible else _idwt97_1d
    # horizontal: rows — combine LL|HL and LH|HH along x
    top = f(ll.T, hl.T).T       # (h_ll, w_ll + w_hl)
    bot = f(lh.T, hh.T).T
    return f(top, bot)


# ---------------------------------------------------------------------------
# codestream decode
# ---------------------------------------------------------------------------

class _Band:
    __slots__ = ("orient", "w", "h", "x0", "y0", "coefs", "eps", "mu",
                 "gain", "cbs", "precincts")

    def __init__(self, orient, w, h, x0=0, y0=0):
        self.orient = orient             # 0 LL, 1 HL, 2 LH, 3 HH
        self.w, self.h = w, h
        self.x0, self.y0 = x0, y0        # absolute band-coord origin
        self.coefs = np.zeros((max(h, 0), max(w, 0)), np.float64)
        self.cbs = []                    # per code-block state dicts
        self.precincts = []              # per-precinct trees + cbs


def _band_dims(w, h, n, xob, yob):
    """Band size for level n with band origin (xob, yob) (B-15,
    image origin 0)."""
    bw = -(-(w - (1 << (n - 1)) * xob) // (1 << n))
    bh = -(-(h - (1 << (n - 1)) * yob) // (1 << n))
    return max(bw, 0), max(bh, 0)


def decode_codestream(data: bytes, pos: int = 0) -> tuple:
    """Decode a JPEG 2000 codestream to component sample arrays.

    Returns (list of (H, W) int32/float arrays, meta dict).  Scope:
    subsampling 1, default or explicit precinct grids (explicit only
    single-tile), all five progression orders; multiple tiles for
    power-of-two tile sizes divisible by 2^levels (the standard
    shapes — keeps every band origin even and code-blocks grid-
    aligned)."""
    n = len(data)
    siz = cod = qcd = None
    tile_parts = []
    while pos + 4 <= n:
        marker = struct.unpack_from(">H", data, pos)[0]
        if marker == 0xFF4F:             # SOC
            pos += 2
            continue
        if marker == 0xFFD9:             # EOC
            break
        if marker == 0xFF93:             # SOD
            body0 = pos + 2
            psot = tile_parts[-1]["psot"]
            end = (tile_parts[-1]["sot_pos"] + psot if psot
                   else n - 2)
            tile_parts[-1]["body"] = data[body0:end]
            pos = end
            continue
        ln = struct.unpack_from(">H", data, pos + 2)[0]
        seg = data[pos + 4:pos + 2 + ln]
        if marker == 0xFF51:             # SIZ
            (_cap, xs, ys, x0, y0, xt, yt, xt0, yt0,
             nc) = struct.unpack_from(">HIIIIIIIIH", seg, 0)
            comps = []
            for c in range(nc):
                ssiz, xr, yr = struct.unpack_from(">BBB", seg,
                                                  36 + 3 * c)
                comps.append(dict(depth=(ssiz & 0x7F) + 1,
                                  signed=bool(ssiz & 0x80),
                                  dx=xr, dy=yr))
            siz = dict(w=xs - x0, h=ys - y0, comps=comps,
                       tiles=(xt, yt, xt0, yt0))
        elif marker == 0xFF52:           # COD
            scod = seg[0]
            prog, layers, mct = struct.unpack_from(">BHB", seg, 1)
            levels = seg[5]
            xcb = (seg[6] & 0xF) + 2
            ycb = (seg[7] & 0xF) + 2
            cstyle = seg[8]
            transform = seg[9]           # 0 = 9/7, 1 = 5/3
            prec = None
            if scod & 1:                 # explicit precinct sizes
                # one byte per resolution: PPx low nibble, PPy high
                # (A.6.1 Table A.21)
                prec = [(b & 0xF, b >> 4)
                        for b in seg[10:10 + levels + 1]]
            cod = dict(prog=prog, layers=layers, mct=mct,
                       levels=levels, xcb=xcb, ycb=ycb,
                       cstyle=cstyle, reversible=transform == 1,
                       prec=prec,
                       sop=bool(scod & 2), eph=bool(scod & 4))
        elif marker == 0xFF5C:           # QCD
            sq = seg[0]
            style = sq & 0x1F
            guard = sq >> 5
            vals = []
            if style == 0:
                vals = [(b >> 3, 0) for b in seg[1:]]
            else:
                for i in range(1, len(seg) - 1, 2):
                    v = struct.unpack_from(">H", seg, i)[0]
                    vals.append((v >> 11, v & 0x7FF))
            qcd = dict(style=style, guard=guard, vals=vals)
        elif marker == 0xFF90:           # SOT
            isot, psot, tpsot, tnsot = struct.unpack_from(
                ">HIBB", seg, 0)
            tile_parts.append(dict(isot=isot, psot=psot,
                                   sot_pos=pos, body=b""))
        pos += 2 + ln

    if siz is None or cod is None or qcd is None:
        raise ValueError("JPEG 2000: missing SIZ/COD/QCD")
    W, H = siz["w"], siz["h"]
    # SIZ sanity: dims come from untrusted u32 fields (Xsiz - X0siz);
    # bound BEFORE the full-picture allocation below or a fuzzed
    # header drives np.zeros into terabyte territory (found by the
    # ASAN allocation-size check in tools/fuzz_native_asan.py).
    ncomp_raw = len(siz["comps"])
    if not (0 < W < 65536 and 0 < H < 65536):
        raise ValueError("JPEG 2000: corrupt SIZ picture dimensions")
    if not (1 <= ncomp_raw <= 16):
        raise ValueError("JPEG 2000: corrupt SIZ component count")
    if W * H * ncomp_raw > (1 << 28):
        raise ValueError("JPEG 2000: image exceeds sample budget")
    xt, yt = siz["tiles"][0], siz["tiles"][1]
    if not (0 < xt and 0 < yt):
        raise ValueError("JPEG 2000: corrupt SIZ tile dimensions")
    for c in siz["comps"]:
        if c["dx"] != 1 or c["dy"] != 1:
            raise NotImplementedError("JPEG 2000: subsampled "
                                      "components")
    if cod["cstyle"] & 0x3F not in (0,):
        raise NotImplementedError("JPEG 2000: code-block style "
                                  f"{cod['cstyle']:#x}")
    levels = cod["levels"]
    # A.6.1: 0..32 decomposition levels; xcb,ycb in 2..10, xcb+ycb<=12
    if levels > 32:
        raise ValueError("JPEG 2000: corrupt COD decomposition levels")
    if cod["xcb"] > 10 or cod["ycb"] > 10 or cod["xcb"] + cod["ycb"] > 12:
        raise ValueError("JPEG 2000: corrupt COD code-block size")
    multi_tile = xt < W or yt < H
    if multi_tile and ((xt & (xt - 1)) or (yt & (yt - 1))
                       or xt % (1 << levels) or yt % (1 << levels)):
        raise NotImplementedError(
            "JPEG 2000: tile size must be a power of two divisible "
            "by 2^levels")

    ncomp = len(siz["comps"])
    reversible = cod["reversible"]
    # group tile-part bodies by tile index
    ntx = -(-W // xt)
    nty = -(-H // yt)
    bodies = [b"" for _ in range(ntx * nty)]
    for tp in tile_parts:
        if tp["isot"] < len(bodies):
            bodies[tp["isot"]] += tp["body"]

    # reversible tiles produce exact integers — keep them int64 so the
    # RCT inverse in decode_to_planes can shift (G-6 needs >> 2)
    plane_dt = np.int64 if reversible else np.float64
    out = [np.zeros((H, W), plane_dt) for _ in range(ncomp)]
    for ti in range(ntx * nty):
        tx0 = (ti % ntx) * xt
        ty0 = (ti // ntx) * yt
        tx1 = min(tx0 + xt, W)
        ty1 = min(ty0 + yt, H)
        tiles_out = _decode_tile(bodies[ti], tx0, ty0, tx1, ty1,
                                 cod, qcd, siz)
        for ci in range(ncomp):
            out[ci][ty0:ty1, tx0:tx1] = tiles_out[ci]

    meta = dict(width=W, height=H, components=ncomp,
                depths=[c["depth"] for c in siz["comps"]],
                reversible=reversible, levels=levels,
                layers=cod["layers"], mct=cod["mct"])
    return out, meta


def _decode_tile(body: bytes, tx0: int, ty0: int, tx1: int, ty1: int,
                 cod: dict, qcd: dict, siz: dict) -> list:
    """Decode one tile's packets + tier-1 + synthesis.  Band origins
    are even at every level (caller-enforced tile geometry), so the
    wavelet stays even-anchored."""
    levels = cod["levels"]
    reversible = cod["reversible"]
    ncomp = len(siz["comps"])
    tw, th = tx1 - tx0, ty1 - ty0

    def ce(a, b):
        return -(-a // b)

    # band structure per component, with ABSOLUTE band-coordinate
    # origins (B-15): precinct and code-block grids anchor at 0 on the
    # reference grid, so a tile at (tx0, ty0) may start mid-precinct
    with stage("jp2.tier2"):
        comps_bands = []
        for ci in range(ncomp):
            res = []
            b = _Band(0, ce(tx1, 1 << levels) - ce(tx0, 1 << levels),
                      ce(ty1, 1 << levels) - ce(ty0, 1 << levels),
                      ce(tx0, 1 << levels), ce(ty0, 1 << levels))
            res.append([b])
            for r in range(1, levels + 1):
                nlev = levels - r + 1
                half = 1 << (nlev - 1)
                full = 1 << nlev

                def b0(a0, ob):
                    return ce(a0 - half * ob, full)

                def bdim(a0, a1, ob):
                    return ce(a1 - half * ob, full) - ce(a0 - half * ob,
                                                         full)
                hl = _Band(1, bdim(tx0, tx1, 1), bdim(ty0, ty1, 0),
                           b0(tx0, 1), b0(ty0, 0))
                lh = _Band(2, bdim(tx0, tx1, 0), bdim(ty0, ty1, 1),
                           b0(tx0, 0), b0(ty0, 1))
                hh = _Band(3, bdim(tx0, tx1, 1), bdim(ty0, ty1, 1),
                           b0(tx0, 1), b0(ty0, 1))
                res.append([hl, lh, hh])
            comps_bands.append(res)

        def band_quant(ci, r, orient):
            idx = 0 if r == 0 else 1 + 3 * (r - 1) + (orient - 1)
            gain = (0, 1, 1, 2)[orient]
            if qcd["style"] == 1:            # scalar derived (E-5)
                e0, m0 = qcd["vals"][0]
                eps = e0 if r == 0 else e0 - r + 1
                return eps, m0, gain
            e, m = qcd["vals"][min(idx, len(qcd["vals"]) - 1)]
            return e, m, gain

        xcb, ycb = cod["xcb"], cod["ycb"]
        prec = cod["prec"]

        def prec_exp(r):
            if prec is None:
                return 15, 15                # default precinct 2^15 (A.6.1)
            return prec[min(r, len(prec) - 1)]

        # precinct grid per resolution, anchored at 0 on the resolution
        # grid in ABSOLUTE coordinates (B-16): a tile whose origin is not
        # precinct-aligned starts mid-precinct, so counts come from the
        # tile's absolute span, not its size
        res_pgrid = []
        for r in range(levels + 1):
            ppx, ppy = prec_exp(r)
            step = 1 << (levels - r)
            trx0, trx1 = ce(tx0, step), ce(tx1, step)
            try0, try1 = ce(ty0, step), ce(ty1, step)
            npx = (max(ce(trx1, 1 << ppx) - (trx0 >> ppx), 1)
                   if trx1 > trx0 else 1)
            npy = (max(ce(try1, 1 << ppy) - (try0 >> ppy), 1)
                   if try1 > try0 else 1)
            res_pgrid.append((npx, npy, ppx, ppy,
                              trx0 >> ppx, try0 >> ppy))

        for ci in range(ncomp):
            for r, bands in enumerate(comps_bands[ci]):
                npx, npy, ppx, ppy, pxa0, pya0 = res_pgrid[r]
                # bands at r>0 live on the half grid (B.6): precinct and
                # code-block sizes halve in band coordinates, and the
                # code-block never exceeds the precinct
                ppx_b = ppx if r == 0 else max(ppx - 1, 0)
                ppy_b = ppy if r == 0 else max(ppy - 1, 0)
                xcb_e = min(xcb, ppx_b)
                ycb_e = min(ycb, ppy_b)
                for band in bands:
                    eps, mu, gain = band_quant(ci, r, band.orient)
                    band.eps, band.mu, band.gain = eps, mu, gain
                    bw, bh = band.w, band.h
                    bx0, by0 = band.x0, band.y0
                    bx1, by1 = bx0 + max(bw, 0), by0 + max(bh, 0)
                    for pi in range(npx * npy):
                        pxa = pxa0 + pi % npx
                        pya = pya0 + pi // npx
                        # precinct rect in absolute band coords, clipped
                        # to the band's span within this tile
                        x0p = max(pxa << ppx_b, bx0)
                        y0p = max(pya << ppy_b, by0)
                        x1p = min((pxa + 1) << ppx_b, bx1)
                        y1p = min((pya + 1) << ppy_b, by1)
                        if x1p <= x0p or y1p <= y0p:
                            band.precincts.append(dict(inc=None, zbp=None,
                                                       cbs=[]))
                            continue
                        # code-blocks anchor at absolute 0 too (2^xcb_e
                        # divides 2^ppx_b, so the grid aligns with
                        # precinct boundaries; tile edges clip)
                        cxa0, cya0 = x0p >> xcb_e, y0p >> ycb_e
                        ncx = ce(x1p, 1 << xcb_e) - cxa0
                        ncy = ce(y1p, 1 << ycb_e) - cya0
                        pr = dict(inc=TagTree(ncx, ncy),
                                  zbp=TagTree(ncx, ncy), cbs=[])
                        for cy in range(ncy):
                            for cx in range(ncx):
                                x0c = max((cxa0 + cx) << xcb_e, x0p)
                                y0c = max((cya0 + cy) << ycb_e, y0p)
                                x1c = min((cxa0 + cx + 1) << xcb_e, x1p)
                                y1c = min((cya0 + cy + 1) << ycb_e, y1p)
                                cb = dict(
                                    x=x0c - bx0, y=y0c - by0,
                                    w=x1c - x0c, h=y1c - y0c,
                                    cx=cx, cy=cy,
                                    included=False, lblock=3,
                                    npasses=0, zbp=0, data=[])
                                pr["cbs"].append(cb)
                                band.cbs.append(cb)
                        band.precincts.append(pr)

        # ---- packet iteration -------------------------------------------
        pos = 0
        prog = cod["prog"]
        if prog > 4:
            raise NotImplementedError(
                f"JPEG 2000: progression order {prog}")

        # explicit packet list sorted by the progression's key (B.12);
        # "position" is the precinct origin projected onto the tile grid
        packets = []
        for r in range(levels + 1):
            npx, npy, ppx, ppy, pxa0, pya0 = res_pgrid[r]
            step = 1 << (levels - r)
            for p in range(npx * npy):
                x = ((pxa0 + p % npx) << ppx) * step
                y = ((pya0 + p // npx) << ppy) * step
                for c in range(ncomp):
                    for l in range(cod["layers"]):
                        packets.append((l, r, c, p, x, y))
        key = {
            0: lambda t: (t[0], t[1], t[2], t[3]),        # LRCP
            1: lambda t: (t[1], t[0], t[2], t[3]),        # RLCP
            2: lambda t: (t[1], t[5], t[4], t[2], t[0]),  # RPCL
            3: lambda t: (t[5], t[4], t[2], t[1], t[0]),  # PCRL
            4: lambda t: (t[2], t[5], t[4], t[1], t[0]),  # CPRL
        }[prog]
        packets.sort(key=key)

        for (layer, r, ci, p, _px, _py) in packets:
            if pos >= len(body):
                break
            if cod["sop"] and body[pos:pos + 2] == b"\xff\x91":
                pos += 6
            br = PktBits(body, pos)
            bands = comps_bands[ci][r]
            contribs = []
            if not br.bit():                 # empty packet
                pos = br.align()
                if cod["eph"] and body[pos:pos + 2] == b"\xff\x92":
                    pos += 2
                continue
            for band in bands:
                pr = band.precincts[p]
                if pr["inc"] is None:
                    continue
                for cb in pr["cbs"]:
                    if not cb["included"]:
                        inc = pr["inc"].decode(br, cb["cx"], cb["cy"],
                                               layer + 1)
                        included = inc <= layer
                    else:
                        included = bool(br.bit())
                    if not included:
                        continue
                    if not cb["included"]:
                        cb["zbp"] = pr["zbp"].decode_full(
                            br, cb["cx"], cb["cy"])
                        cb["included"] = True
                    np_ = _decode_npasses(br)
                    while br.bit():
                        cb["lblock"] += 1
                    nbits = cb["lblock"] + int(math.floor(
                        math.log2(np_))) if np_ > 1 else cb["lblock"]
                    length = br.bits(nbits)
                    contribs.append((cb, np_, length))
            pos = br.align()
            if cod["eph"] and body[pos:pos + 2] == b"\xff\x92":
                pos += 2
            for cb, np_, length in contribs:
                cb["data"].append(body[pos:pos + length])
                cb["npasses"] += np_
                pos += length

    # ---- tier-1 + dequant + synthesis per component -------------------
    out = []
    guard = qcd["guard"]
    for ci in range(ncomp):
        depth = siz["comps"][ci]["depth"]
        res = comps_bands[ci]
        with stage("jp2.tier1"):
            for r, bands in enumerate(res):
                for band in bands:
                    if band.w <= 0 or band.h <= 0:
                        continue
                    eps, mu, gain = band.eps, band.mu, band.gain
                    mb = eps + guard - 1     # E-2: M_b = G + eps_b - 1
                    kind = (0, 1, 0, 2)[band.orient]
                    for cb in band.cbs:
                        if not cb["npasses"]:
                            continue
                        coeffs = native.jp2_block(
                            b"".join(cb["data"]), cb["npasses"], mb,
                            cb["zbp"], cb["w"], cb["h"], kind)
                        band.coefs[cb["y"]:cb["y"] + cb["h"],
                                   cb["x"]:cb["x"] + cb["w"]] = coeffs
                    if not reversible:
                        rb = depth + gain
                        delta = (2.0 ** (rb - eps)) * (1.0 + mu / 2048.0)
                        band.coefs = (band.coefs
                                      + 0.5 * np.sign(band.coefs)) * delta
        # synthesis
        with stage("jp2.synthesis"):
            ll = res[0][0].coefs
            if reversible:
                ll = ll.astype(np.int64)
            for r in range(1, levels + 1):
                hl, lh, hh = res[r]
                a = (hl.coefs, lh.coefs, hh.coefs)
                if reversible:
                    a = tuple(x.astype(np.int64) for x in a)
                ll = _idwt_2d(ll, a[0], a[1], a[2], reversible)
        out.append(ll[:th, :tw])
    return out


def decode_to_planes(data: bytes, pos: int = 0):
    """Full pixel path: codestream -> MCT inverse -> DC shift.
    Returns (list of (H, W) int32 planes, meta)."""
    comps, meta = decode_codestream(data, pos)
    depths = meta["depths"]
    if meta["mct"] and len(comps) >= 3:
        c0, c1, c2 = comps[0], comps[1], comps[2]
        if meta["reversible"]:           # RCT (G-6)
            c0 = c0.astype(np.int64)
            g = c0 - ((c1.astype(np.int64) + c2) >> 2)
            r = c2 + g
            b = c1 + g
            comps[0], comps[1], comps[2] = r, g, b
        else:                            # ICT (G-2)
            y, cb, cr = c0, c1, c2
            comps[0] = y + 1.402 * cr
            comps[1] = y - 0.344136 * cb - 0.714136 * cr
            comps[2] = y + 1.772 * cb
    out = []
    for i, c in enumerate(comps):
        d = depths[i]
        if not meta["reversible"]:
            c = np.floor(c + 0.5)
        c = c + (1 << (d - 1))           # DC level shift
        out.append(np.clip(c, 0, (1 << d) - 1).astype(np.int32))
    return out, meta
