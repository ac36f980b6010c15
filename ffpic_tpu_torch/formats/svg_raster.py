"""SVG rasterizer (beyond reference: format/svg.c:56-512 parses the
DOM and never rasterizes).

Design: every shape is flattened to polygons in user space, pushed
through the CTM, and filled by one vectorized scanline pass:

  * y is supersampled SS× (sub-row sample centers),
  * x is antialiased analytically — each edge crossing deposits a
    fractionally-split winding delta into an accumulator row, and a
    cumulative sum along x yields the exact winding number at every
    pixel center (nonzero rule) or a triangle-wave fold of it
    (evenodd),
  * strokes become consistently-oriented quads + join/cap disks, so
    clip(winding, 0, 1) is their union coverage.

Everything is numpy; no per-pixel Python. Paint sources are solid
colors or linear/radial gradients (pad spread), composited premultiplied
front-to-back in document order.

Copied from ``ffpic_tpu/formats/svg_raster.py`` unchanged for the
PyTorch port: a host rasterizer, numpy only.
"""

from __future__ import annotations

import math
import re

import numpy as np

SS = 4                      # y supersampling factor
MAX_DIM = 8192              # canvas safety bound (fuzzed dimensions)

# --------------------------------------------------------------------------
# colors


def _css_colors():
    # CSS Color 4 named colors (subset covering the full SVG 1.1 set).
    return {
        "aliceblue": (240, 248, 255), "antiquewhite": (250, 235, 215),
        "aqua": (0, 255, 255), "aquamarine": (127, 255, 212),
        "azure": (240, 255, 255), "beige": (245, 245, 220),
        "bisque": (255, 228, 196), "black": (0, 0, 0),
        "blanchedalmond": (255, 235, 205), "blue": (0, 0, 255),
        "blueviolet": (138, 43, 226), "brown": (165, 42, 42),
        "burlywood": (222, 184, 135), "cadetblue": (95, 158, 160),
        "chartreuse": (127, 255, 0), "chocolate": (210, 105, 30),
        "coral": (255, 127, 80), "cornflowerblue": (100, 149, 237),
        "cornsilk": (255, 248, 220), "crimson": (220, 20, 60),
        "cyan": (0, 255, 255), "darkblue": (0, 0, 139),
        "darkcyan": (0, 139, 139), "darkgoldenrod": (184, 134, 11),
        "darkgray": (169, 169, 169), "darkgreen": (0, 100, 0),
        "darkgrey": (169, 169, 169), "darkkhaki": (189, 183, 107),
        "darkmagenta": (139, 0, 139), "darkolivegreen": (85, 107, 47),
        "darkorange": (255, 140, 0), "darkorchid": (153, 50, 204),
        "darkred": (139, 0, 0), "darksalmon": (233, 150, 122),
        "darkseagreen": (143, 188, 143), "darkslateblue": (72, 61, 139),
        "darkslategray": (47, 79, 79), "darkslategrey": (47, 79, 79),
        "darkturquoise": (0, 206, 209), "darkviolet": (148, 0, 211),
        "deeppink": (255, 20, 147), "deepskyblue": (0, 191, 255),
        "dimgray": (105, 105, 105), "dimgrey": (105, 105, 105),
        "dodgerblue": (30, 144, 255), "firebrick": (178, 34, 34),
        "floralwhite": (255, 250, 240), "forestgreen": (34, 139, 34),
        "fuchsia": (255, 0, 255), "gainsboro": (220, 220, 220),
        "ghostwhite": (248, 248, 255), "gold": (255, 215, 0),
        "goldenrod": (218, 165, 32), "gray": (128, 128, 128),
        "green": (0, 128, 0), "greenyellow": (173, 255, 47),
        "grey": (128, 128, 128), "honeydew": (240, 255, 240),
        "hotpink": (255, 105, 180), "indianred": (205, 92, 92),
        "indigo": (75, 0, 130), "ivory": (255, 255, 240),
        "khaki": (240, 230, 140), "lavender": (230, 230, 250),
        "lavenderblush": (255, 240, 245), "lawngreen": (124, 252, 0),
        "lemonchiffon": (255, 250, 205), "lightblue": (173, 216, 230),
        "lightcoral": (240, 128, 128), "lightcyan": (224, 255, 255),
        "lightgoldenrodyellow": (250, 250, 210),
        "lightgray": (211, 211, 211), "lightgreen": (144, 238, 144),
        "lightgrey": (211, 211, 211), "lightpink": (255, 182, 193),
        "lightsalmon": (255, 160, 122), "lightseagreen": (32, 178, 170),
        "lightskyblue": (135, 206, 250), "lightslategray": (119, 136, 153),
        "lightslategrey": (119, 136, 153), "lightsteelblue": (176, 196, 222),
        "lightyellow": (255, 255, 224), "lime": (0, 255, 0),
        "limegreen": (50, 205, 50), "linen": (250, 240, 230),
        "magenta": (255, 0, 255), "maroon": (128, 0, 0),
        "mediumaquamarine": (102, 205, 170), "mediumblue": (0, 0, 205),
        "mediumorchid": (186, 85, 211), "mediumpurple": (147, 112, 219),
        "mediumseagreen": (60, 179, 113), "mediumslateblue": (123, 104, 238),
        "mediumspringgreen": (0, 250, 154), "mediumturquoise": (72, 209, 204),
        "mediumvioletred": (199, 21, 133), "midnightblue": (25, 25, 112),
        "mintcream": (245, 255, 250), "mistyrose": (255, 228, 225),
        "moccasin": (255, 228, 181), "navajowhite": (255, 222, 173),
        "navy": (0, 0, 128), "oldlace": (253, 245, 230),
        "olive": (128, 128, 0), "olivedrab": (107, 142, 35),
        "orange": (255, 165, 0), "orangered": (255, 69, 0),
        "orchid": (218, 112, 214), "palegoldenrod": (238, 232, 170),
        "palegreen": (152, 251, 152), "paleturquoise": (175, 238, 238),
        "palevioletred": (219, 112, 147), "papayawhip": (255, 239, 213),
        "peachpuff": (255, 218, 185), "peru": (205, 133, 63),
        "pink": (255, 192, 203), "plum": (221, 160, 221),
        "powderblue": (176, 224, 230), "purple": (128, 0, 128),
        "rebeccapurple": (102, 51, 153), "red": (255, 0, 0),
        "rosybrown": (188, 143, 143), "royalblue": (65, 105, 225),
        "saddlebrown": (139, 69, 19), "salmon": (250, 128, 114),
        "sandybrown": (244, 164, 96), "seagreen": (46, 139, 87),
        "seashell": (255, 245, 238), "sienna": (160, 82, 45),
        "silver": (192, 192, 192), "skyblue": (135, 206, 235),
        "slateblue": (106, 90, 205), "slategray": (112, 128, 144),
        "slategrey": (112, 128, 144), "snow": (255, 250, 250),
        "springgreen": (0, 255, 127), "steelblue": (70, 130, 180),
        "tan": (210, 180, 140), "teal": (0, 128, 128),
        "thistle": (216, 191, 216), "tomato": (255, 99, 71),
        "turquoise": (64, 224, 208), "violet": (238, 130, 238),
        "wheat": (245, 222, 179), "white": (255, 255, 255),
        "whitesmoke": (245, 245, 245), "yellow": (255, 255, 0),
        "yellowgreen": (154, 205, 50),
    }


_NAMED = _css_colors()

_NUM_RE = re.compile(
    r"[-+]?(?:\d*\.\d+|\d+\.?)(?:[eE][-+]?\d+)?")


def parse_color(s, fallback=(0, 0, 0, 1.0)):
    """CSS color string -> (r, g, b, a) floats (rgb 0-255, a 0-1), or
    ("url", id) for paint-server references, or None for 'none'."""
    if s is None:
        return fallback
    s = s.strip()
    low = s.lower()
    if low in ("none", "transparent"):
        return None if low == "none" else (0, 0, 0, 0.0)
    if low.startswith("url("):
        ref = s[4:s.find(")")].strip().strip("'\"")
        if ref.startswith("#"):
            return ("url", ref[1:])
        return fallback
    if low == "currentcolor":
        return fallback
    if s.startswith("#"):
        h = s[1:]
        try:
            if len(h) == 3:
                return (int(h[0] * 2, 16), int(h[1] * 2, 16),
                        int(h[2] * 2, 16), 1.0)
            if len(h) == 4:
                return (int(h[0] * 2, 16), int(h[1] * 2, 16),
                        int(h[2] * 2, 16), int(h[3] * 2, 16) / 255.0)
            if len(h) == 6:
                return (int(h[0:2], 16), int(h[2:4], 16),
                        int(h[4:6], 16), 1.0)
            if len(h) == 8:
                return (int(h[0:2], 16), int(h[2:4], 16),
                        int(h[4:6], 16), int(h[6:8], 16) / 255.0)
        except ValueError:
            return fallback
        return fallback
    if low.startswith(("rgb(", "rgba(")):
        body = s[s.find("(") + 1:s.rfind(")") if ")" in s else len(s)]
        parts = [p.strip() for p in re.split(r"[,\s/]+", body) if p.strip()]
        if len(parts) >= 3:
            vals = []
            for p in parts[:3]:
                m = _NUM_RE.match(p)
                if not m:
                    return fallback
                v = float(m.group(0))
                if p.endswith("%"):
                    v = v * 255.0 / 100.0
                vals.append(v)
            a = 1.0
            if len(parts) > 3:
                m = _NUM_RE.match(parts[3])
                if m:
                    a = float(m.group(0))
                    if parts[3].endswith("%"):
                        a /= 100.0
            return (vals[0], vals[1], vals[2], min(max(a, 0.0), 1.0))
        return fallback
    if low in _NAMED:
        r, g, b = _NAMED[low]
        return (float(r), float(g), float(b), 1.0)
    return fallback


# --------------------------------------------------------------------------
# geometry: transforms and path flattening

def mat_identity():
    return np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])


def mat_mul(a, b):
    """Apply a after... a∘b: point -> a(b(point)). 2x3 affine."""
    m = np.empty((2, 3))
    m[:, :2] = a[:, :2] @ b[:, :2]
    m[:, 2] = a[:, :2] @ b[:, 2] + a[:, 2]
    return m


def mat_apply(m, pts):
    if len(pts) == 0:
        return pts
    return pts @ m[:, :2].T + m[:, 2]


def parse_transform(s):
    """Parse an SVG transform list into one 2x3 matrix."""
    m = mat_identity()
    if not s:
        return m
    for name, args in re.findall(r"(\w+)\s*\(([^)]*)\)", s):
        v = [float(x) for x in _NUM_RE.findall(args)]
        t = mat_identity()
        if name == "translate":
            t[0, 2] = v[0] if v else 0.0
            t[1, 2] = v[1] if len(v) > 1 else 0.0
        elif name == "scale":
            if v:
                t[0, 0] = v[0]
                t[1, 1] = v[1] if len(v) > 1 else v[0]
        elif name == "rotate":
            a = math.radians(v[0]) if v else 0.0
            c, s_ = math.cos(a), math.sin(a)
            t = np.array([[c, -s_, 0.0], [s_, c, 0.0]])
            if len(v) >= 3:
                cx, cy = v[1], v[2]
                pre = mat_identity()
                pre[:, 2] = (cx, cy)
                post = mat_identity()
                post[:, 2] = (-cx, -cy)
                t = mat_mul(mat_mul(pre, t), post)
        elif name == "skewX":
            t[0, 1] = math.tan(math.radians(v[0])) if v else 0.0
        elif name == "skewY":
            t[1, 0] = math.tan(math.radians(v[0])) if v else 0.0
        elif name == "matrix" and len(v) >= 6:
            t = np.array([[v[0], v[2], v[4]], [v[1], v[3], v[5]]])
        m = mat_mul(m, t)
    return m


def _n_segs(r, scale):
    """Segments for a radius-r full turn: inscribed-polygon area error
    ~ pi*r^2 * 2*pi^2/(3*n^2) stays well under 0.5% of the disk."""
    r = abs(r) * max(scale, 1e-6)
    return int(min(max(9.0 * math.sqrt(r + 1.0), 12), 320))


def _flatten_cubic(p0, p1, p2, p3, scale):
    d = (abs(p1[0] - p0[0]) + abs(p1[1] - p0[1])
         + abs(p2[0] - p1[0]) + abs(p2[1] - p1[1])
         + abs(p3[0] - p2[0]) + abs(p3[1] - p2[1])) * scale
    n = int(min(max(math.sqrt(d * 2.0), 4), 160))
    t = np.linspace(0.0, 1.0, n + 1)[1:]
    mt = 1.0 - t
    xs = (mt ** 3 * p0[0] + 3 * mt ** 2 * t * p1[0]
          + 3 * mt * t ** 2 * p2[0] + t ** 3 * p3[0])
    ys = (mt ** 3 * p0[1] + 3 * mt ** 2 * t * p1[1]
          + 3 * mt * t ** 2 * p2[1] + t ** 3 * p3[1])
    return list(zip(xs, ys))


def _flatten_quad(p0, p1, p2, scale):
    d = (abs(p1[0] - p0[0]) + abs(p1[1] - p0[1])
         + abs(p2[0] - p1[0]) + abs(p2[1] - p1[1])) * scale
    n = int(min(max(math.sqrt(d * 2.0), 4), 120))
    t = np.linspace(0.0, 1.0, n + 1)[1:]
    mt = 1.0 - t
    xs = mt ** 2 * p0[0] + 2 * mt * t * p1[0] + t ** 2 * p2[0]
    ys = mt ** 2 * p0[1] + 2 * mt * t * p1[1] + t ** 2 * p2[1]
    return list(zip(xs, ys))


def _flatten_arc(p0, rx, ry, phi_deg, large, sweep, p1, scale):
    """SVG elliptical arc -> polyline (endpoint parameterization,
    spec F.6.5/F.6.6)."""
    x1, y1 = p0
    x2, y2 = p1
    rx, ry = abs(rx), abs(ry)
    if rx < 1e-12 or ry < 1e-12 or (x1 == x2 and y1 == y2):
        return [p1]
    phi = math.radians(phi_deg % 360.0)
    cosp, sinp = math.cos(phi), math.sin(phi)
    dx, dy = (x1 - x2) / 2.0, (y1 - y2) / 2.0
    x1p = cosp * dx + sinp * dy
    y1p = -sinp * dx + cosp * dy
    lam = (x1p / rx) ** 2 + (y1p / ry) ** 2
    if lam > 1.0:
        s = math.sqrt(lam)
        rx *= s
        ry *= s
    num = rx * rx * ry * ry - rx * rx * y1p * y1p - ry * ry * x1p * x1p
    den = rx * rx * y1p * y1p + ry * ry * x1p * x1p
    co = math.sqrt(max(num, 0.0) / den) if den else 0.0
    if large == sweep:
        co = -co
    cxp = co * rx * y1p / ry
    cyp = -co * ry * x1p / rx
    cx = cosp * cxp - sinp * cyp + (x1 + x2) / 2.0
    cy = sinp * cxp + cosp * cyp + (y1 + y2) / 2.0

    def ang(ux, uy, vx, vy):
        d = math.hypot(ux, uy) * math.hypot(vx, vy)
        if d == 0:
            return 0.0
        c = min(max((ux * vx + uy * vy) / d, -1.0), 1.0)
        a = math.acos(c)
        return -a if ux * vy - uy * vx < 0 else a

    th1 = ang(1.0, 0.0, (x1p - cxp) / rx, (y1p - cyp) / ry)
    dth = ang((x1p - cxp) / rx, (y1p - cyp) / ry,
              (-x1p - cxp) / rx, (-y1p - cyp) / ry)
    if not sweep and dth > 0:
        dth -= 2 * math.pi
    elif sweep and dth < 0:
        dth += 2 * math.pi
    n = max(2, int(_n_segs(max(rx, ry), scale) * abs(dth) / (2 * math.pi)))
    th = th1 + dth * np.linspace(0.0, 1.0, n + 1)[1:]
    xs = cx + rx * np.cos(th) * cosp - ry * np.sin(th) * sinp
    ys = cy + rx * np.cos(th) * sinp + ry * np.sin(th) * cosp
    pts = list(zip(xs, ys))
    pts[-1] = p1              # land exactly on the endpoint
    return pts


class _PathReader:
    """Char-level reader: SVG path arc flags are single characters, so
    '01' is two flags — a plain number tokenizer would mis-lex it."""

    def __init__(self, d):
        self.s = d
        self.i = 0

    def _skip(self):
        while (self.i < len(self.s)
               and (self.s[self.i].isspace() or self.s[self.i] == ",")):
            self.i += 1

    def cmd(self):
        self._skip()
        if self.i < len(self.s) and self.s[self.i].isalpha():
            c = self.s[self.i]
            self.i += 1
            return c
        return None

    def number(self):
        self._skip()
        m = _NUM_RE.match(self.s, self.i)
        if not m:
            return None
        self.i = m.end()
        return float(m.group(0))

    def flag(self):
        self._skip()
        if self.i < len(self.s) and self.s[self.i] in "01":
            v = self.s[self.i] == "1"
            self.i += 1
            return v
        return None

    def has_number(self):
        self._skip()
        return bool(_NUM_RE.match(self.s, self.i))

    def done(self):
        self._skip()
        return self.i >= len(self.s)


def parse_path(d, scale=1.0):
    """Parse + flatten a path `d` string.

    Returns (subpaths, closed_flags): each subpath a list of (x, y)
    points; closed True when ended with Z (affects stroking only —
    fills treat every subpath as closed).
    """
    r = _PathReader(d or "")
    subs, closed = [], []
    cur = []
    pos = (0.0, 0.0)
    start = (0.0, 0.0)
    last_cmd = None
    last_ctrl = None
    cmd = None
    while not r.done():
        c = r.cmd()
        if c is not None:
            cmd = c
        elif cmd is None:
            break
        elif cmd == "M":
            cmd = "L"
        elif cmd == "m":
            cmd = "l"
        if cmd is None:
            break
        rel = cmd.islower()
        op = cmd.upper()
        if op in "LHVCSQTA" and not cur:
            cur = [pos]          # implicit subpath restart after Z

        def pt(relative=rel):
            x = r.number()
            y = r.number()
            if x is None or y is None:
                return None
            if relative:
                return (pos[0] + x, pos[1] + y)
            return (x, y)

        if op == "M":
            p = pt()
            if p is None:
                break
            if cur:
                subs.append(cur)
                closed.append(False)
            cur = [p]
            pos = start = p
            last_ctrl = None
        elif op == "L":
            p = pt()
            if p is None:
                break
            cur.append(p)
            pos = p
            last_ctrl = None
        elif op == "H":
            x = r.number()
            if x is None:
                break
            p = (pos[0] + x if rel else x, pos[1])
            cur.append(p)
            pos = p
            last_ctrl = None
        elif op == "V":
            y = r.number()
            if y is None:
                break
            p = (pos[0], pos[1] + y if rel else y)
            cur.append(p)
            pos = p
            last_ctrl = None
        elif op == "C":
            p1 = pt()
            p2 = pt()
            p3 = pt()
            if p3 is None:
                break
            cur.extend(_flatten_cubic(pos, p1, p2, p3, scale))
            last_ctrl = p2
            pos = p3
        elif op == "S":
            p2 = pt()
            p3 = pt()
            if p3 is None:
                break
            if last_cmd in "CcSs" and last_ctrl is not None:
                p1 = (2 * pos[0] - last_ctrl[0], 2 * pos[1] - last_ctrl[1])
            else:
                p1 = pos
            cur.extend(_flatten_cubic(pos, p1, p2, p3, scale))
            last_ctrl = p2
            pos = p3
        elif op == "Q":
            p1 = pt()
            p2 = pt()
            if p2 is None:
                break
            cur.extend(_flatten_quad(pos, p1, p2, scale))
            last_ctrl = p1
            pos = p2
        elif op == "T":
            p2 = pt()
            if p2 is None:
                break
            if last_cmd in "QqTt" and last_ctrl is not None:
                p1 = (2 * pos[0] - last_ctrl[0], 2 * pos[1] - last_ctrl[1])
            else:
                p1 = pos
            cur.extend(_flatten_quad(pos, p1, p2, scale))
            last_ctrl = p1
            pos = p2
        elif op == "A":
            rx = r.number()
            ry = r.number()
            rot = r.number()
            laf = r.flag()
            swf = r.flag()
            p1 = pt()
            if p1 is None or laf is None or swf is None:
                break
            cur.extend(_flatten_arc(pos, rx, ry, rot or 0.0,
                                    laf, swf, p1, scale))
            pos = p1
            last_ctrl = None
        elif op == "Z":
            if cur:
                cur.append(start)
                subs.append(cur)
                closed.append(True)
            cur = []
            pos = start
            last_ctrl = None
        else:
            break
        last_cmd = cmd
    if cur:
        subs.append(cur)
        closed.append(False)
    return subs, closed


# --------------------------------------------------------------------------
# scanline fill

def _edges_of(polys):
    """Polygon list -> (N, 4) edge array (x0, y0, x1, y1), closing each."""
    segs = []
    for p in polys:
        a = np.asarray(p, np.float64)
        if len(a) < 2:
            continue
        b = np.roll(a, -1, axis=0)
        segs.append(np.concatenate([a, b], axis=1))
    if not segs:
        return np.zeros((0, 4))
    return np.concatenate(segs, axis=0)


def fill_coverage(polys, w, h, evenodd=False, union=False):
    """Rasterize closed polygons -> float32 coverage (h, w) in [0, 1].

    union=True treats the polygons as a union of positively-oriented
    shapes (stroke geometry): coverage = clip(winding, 0, 1).
    """
    e = _edges_of(polys)
    hs = h * SS
    if len(e) == 0:
        return np.zeros((h, w), np.float32)
    e = e[np.isfinite(e).all(axis=1)]
    if len(e) == 0:
        return np.zeros((h, w), np.float32)
    x0, y0, x1, y1 = e[:, 0], e[:, 1] * SS, e[:, 2], e[:, 3] * SS
    keep = y0 != y1
    x0, y0, x1, y1 = x0[keep], y0[keep], x1[keep], y1[keep]
    if len(x0) == 0:
        return np.zeros((h, w), np.float32)
    wind = np.where(y1 > y0, 1.0, -1.0)
    ymin = np.minimum(y0, y1)
    ymax = np.maximum(y0, y1)
    j0 = np.maximum(np.ceil(ymin - 0.5), 0.0).astype(np.int64)
    j1 = np.minimum(np.ceil(ymax - 0.5), float(hs)).astype(np.int64)
    cnt = np.maximum(j1 - j0, 0)
    tot = int(cnt.sum())
    if tot == 0:
        return np.zeros((h, w), np.float32)
    eidx = np.repeat(np.arange(len(cnt)), cnt)
    off = np.arange(tot) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    j = j0[eidx] + off
    yc = j + 0.5
    t = (yc - y0[eidx]) / (y1[eidx] - y0[eidx])
    x = x0[eidx] + t * (x1[eidx] - x0[eidx])
    wv = wind[eidx]
    x = np.clip(x, -2.0, w + 2.0)   # clip BEFORE the int cast: huge
    c = np.floor(x).astype(np.int64)  # transforms would overflow int64
    u = (c + 1.0 - x)             # fraction of cell c right of x
    c = np.clip(c, -1, w)
    u = np.clip(u, 0.0, 1.0)
    acc = np.zeros((hs, w + 2), np.float64)
    np.add.at(acc, (j, c + 1), wv * u)
    np.add.at(acc, (j, np.minimum(c + 2, w + 1)), wv * (1.0 - u))
    windim = np.cumsum(acc, axis=1)[:, 1:w + 1]
    if evenodd:
        m = np.abs(windim) % 2.0
        cov = np.clip(np.minimum(m, 2.0 - m), 0.0, 1.0)
    else:
        # nonzero; also the union rule for consistently-oriented
        # stroke geometry (same-sign windings accumulate, never cancel)
        cov = np.clip(np.abs(windim), 0.0, 1.0)
    return cov.reshape(h, SS, w).mean(axis=1).astype(np.float32)


def _disk(cx, cy, r, n=16):
    th = np.linspace(0.0, 2 * math.pi, n, endpoint=False)
    return np.stack([cx + r * np.cos(th), cy + r * np.sin(th)], axis=1)


def _orient_ccw(poly):
    """Ensure positive (y-down screen) orientation for union filling."""
    a = np.asarray(poly)
    if len(a) < 3:
        return a
    x, y = a[:, 0], a[:, 1]
    area = np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)
    return a if area >= 0 else a[::-1]


def stroke_polys(subpaths, closed, width, linecap="butt",
                 linejoin="miter"):
    """Stroke geometry as a union set of positively-oriented polygons:
    one quad per segment, disks at interior joints (round-join
    approximation of miter/round; bevel-ish for sharp angles), caps
    per `linecap`."""
    hw = max(width, 0.0) / 2.0
    if hw <= 0:
        return []
    out = []
    for pts, cl in zip(subpaths, closed):
        a = np.asarray(pts, np.float64)
        if len(a) < 2:
            if len(a) == 1 and linecap == "round":
                out.append(_disk(a[0, 0], a[0, 1], hw))
            continue
        if cl and (a[0] != a[-1]).any():
            a = np.vstack([a, a[:1]])    # closing segment
        d = np.diff(a, axis=0)
        ln = np.hypot(d[:, 0], d[:, 1])
        keep = ln > 1e-12
        d, ln = d[keep], ln[keep]
        p0 = a[:-1][keep]
        p1 = a[1:][keep]
        if len(d) == 0:
            continue
        nx = -d[:, 1] / ln * hw
        ny = d[:, 0] / ln * hw
        for k in range(len(d)):
            quad = np.array([
                [p0[k, 0] + nx[k], p0[k, 1] + ny[k]],
                [p1[k, 0] + nx[k], p1[k, 1] + ny[k]],
                [p1[k, 0] - nx[k], p1[k, 1] - ny[k]],
                [p0[k, 0] - nx[k], p0[k, 1] - ny[k]],
            ])
            out.append(_orient_ccw(quad))
        # joints (interior vertices; plus the closing vertex if closed)
        joints = p1[:-1]
        if cl and len(p0):
            joints = np.concatenate([joints, p0[:1]], axis=0)
        for jx, jy in joints:
            out.append(_disk(jx, jy, hw))
        if not cl:
            s0, e0 = p0[0], p1[-1]
            if linecap == "round":
                out.append(_disk(s0[0], s0[1], hw))
                out.append(_disk(e0[0], e0[1], hw))
            elif linecap == "square":
                for k, pt_ in ((0, s0), (len(d) - 1, e0)):
                    ux = d[k, 0] / ln[k] * hw
                    uy = d[k, 1] / ln[k] * hw
                    sgn = -1.0 if pt_ is s0 else 1.0
                    quad = np.array([
                        [pt_[0] + nx[k], pt_[1] + ny[k]],
                        [pt_[0] + nx[k] + sgn * ux,
                         pt_[1] + ny[k] + sgn * uy],
                        [pt_[0] - nx[k] + sgn * ux,
                         pt_[1] - ny[k] + sgn * uy],
                        [pt_[0] - nx[k], pt_[1] - ny[k]],
                    ])
                    out.append(_orient_ccw(quad))
    return out


# --------------------------------------------------------------------------
# gradients

def _grad_stops(el, idmap):
    stops = []
    src = el
    seen = set()
    while src is not None and id(src) not in seen:
        seen.add(id(src))
        for ch in src:
            if ch.tag.split("}")[-1] == "stop":
                off = ch.get("offset", "0")
                off = (float(off[:-1]) / 100.0 if off.endswith("%")
                       else float(off or 0))
                style = _style_of(ch)
                col = parse_color(style.get("stop-color", "black"))
                if col is None or len(col) != 4:
                    col = (0.0, 0.0, 0.0, 1.0)
                op = float(style.get("stop-opacity", 1.0))
                stops.append((min(max(off, 0.0), 1.0),
                              (col[0], col[1], col[2], col[3] * op)))
        if stops:
            break
        href = (src.get("href")
                or src.get("{http://www.w3.org/1999/xlink}href") or "")
        src = idmap.get(href[1:]) if href.startswith("#") else None
    stops.sort(key=lambda s: s[0])
    return stops


def _grad_attr(el, idmap, name, default):
    seen = set()
    src = el
    while src is not None and id(src) not in seen:
        seen.add(id(src))
        v = src.get(name)
        if v is not None:
            return v
        href = (src.get("href")
                or src.get("{http://www.w3.org/1999/xlink}href") or "")
        src = idmap.get(href[1:]) if href.startswith("#") else None
    return default


def _pct(v, default):
    if v is None:
        return default
    v = v.strip()
    if v.endswith("%"):
        return float(v[:-1]) / 100.0
    return float(v)


def gradient_rgba(el, idmap, ctm, w, h, bbox):
    """Per-pixel RGBA (h, w, 4 floats; rgb 0-255, a 0-1) for a linear or
    radial gradient element, pad spread."""
    stops = _grad_stops(el, idmap)
    if not stops:
        return np.zeros((h, w, 4), np.float32)
    tag = el.tag.split("}")[-1]
    units = _grad_attr(el, idmap, "gradientUnits", "objectBoundingBox")
    gt = parse_transform(_grad_attr(el, idmap, "gradientTransform", ""))
    if units == "userSpaceOnUse":
        to_px = mat_mul(ctm, gt)
        unit = 1.0
    else:
        bx, by, bw, bh = bbox
        bb = np.array([[bw, 0.0, bx], [0.0, bh, by]])
        to_px = mat_mul(ctm, mat_mul(bb, gt))
        unit = 1.0
    # invert to_px: pixel -> gradient space
    det = to_px[0, 0] * to_px[1, 1] - to_px[0, 1] * to_px[1, 0]
    if abs(det) < 1e-12:
        det = 1e-12
    inv = np.array([
        [to_px[1, 1] / det, -to_px[0, 1] / det, 0.0],
        [-to_px[1, 0] / det, to_px[0, 0] / det, 0.0]])
    inv[0, 2] = -(inv[0, 0] * to_px[0, 2] + inv[0, 1] * to_px[1, 2])
    inv[1, 2] = -(inv[1, 0] * to_px[0, 2] + inv[1, 1] * to_px[1, 2])
    yy, xx = np.mgrid[0:h, 0:w]
    px = xx + 0.5
    py = yy + 0.5
    gx = inv[0, 0] * px + inv[0, 1] * py + inv[0, 2]
    gy = inv[1, 0] * px + inv[1, 1] * py + inv[1, 2]
    if tag == "linearGradient":
        x1 = _pct(_grad_attr(el, idmap, "x1", None), 0.0) * unit
        y1 = _pct(_grad_attr(el, idmap, "y1", None), 0.0) * unit
        x2 = _pct(_grad_attr(el, idmap, "x2", None), 1.0) * unit
        y2 = _pct(_grad_attr(el, idmap, "y2", None), 0.0) * unit
        dx, dy = x2 - x1, y2 - y1
        dd = dx * dx + dy * dy
        if dd < 1e-12:
            t = np.zeros((h, w))
        else:
            t = ((gx - x1) * dx + (gy - y1) * dy) / dd
    else:
        cx = _pct(_grad_attr(el, idmap, "cx", None), 0.5) * unit
        cy = _pct(_grad_attr(el, idmap, "cy", None), 0.5) * unit
        r = _pct(_grad_attr(el, idmap, "r", None), 0.5) * unit
        if r <= 1e-12:
            r = 1e-12
        t = np.hypot(gx - cx, gy - cy) / r
    t = np.clip(t, 0.0, 1.0)
    offs = np.array([s[0] for s in stops])
    cols = np.array([s[1] for s in stops])
    out = np.empty((h, w, 4), np.float32)
    for ch in range(4):
        out[:, :, ch] = np.interp(t, offs, cols[:, ch])
    return out


# --------------------------------------------------------------------------
# element walk

_INHERITED = ("fill", "stroke", "stroke-width", "fill-rule",
              "fill-opacity", "stroke-opacity", "stroke-linecap",
              "stroke-linejoin", "color")


def _style_of(el):
    st = {}
    for k in (*_INHERITED, "opacity", "stop-color", "stop-opacity",
              "transform", "display", "visibility"):
        v = el.get(k)
        if v is not None:
            st[k] = v
    for part in (el.get("style") or "").split(";"):
        if ":" in part:
            k, v = part.split(":", 1)
            st[k.strip()] = v.strip()
    return st


class Rasterizer:
    def __init__(self, root, width, height, viewbox=None):
        if not (0 < width <= MAX_DIM and 0 < height <= MAX_DIM):
            raise ValueError("svg raster dimensions out of range")
        self.w, self.h = int(width), int(height)
        self.root = root
        self.img = np.zeros((self.h, self.w, 4), np.float32)  # premult
        self.idmap = {}
        for el in root.iter():
            i = el.get("id")
            if i is not None and i not in self.idmap:
                self.idmap[i] = el
        base = mat_identity()
        if viewbox:
            vx, vy, vw, vh = viewbox
            if vw > 0 and vh > 0:
                par = (root.get("preserveAspectRatio") or "").strip()
                sx = self.w / vw
                sy = self.h / vh
                if par != "none":
                    s = min(sx, sy)       # xMidYMid meet default
                    tx = (self.w - vw * s) / 2.0 - vx * s
                    ty = (self.h - vh * s) / 2.0 - vy * s
                    base = np.array([[s, 0.0, tx], [0.0, s, ty]])
                else:
                    base = np.array([[sx, 0.0, -vx * sx],
                                     [0.0, sy, -vy * sy]])
        self.base = base

    def run(self):
        state = {
            "fill": "black", "stroke": "none", "stroke-width": "1",
            "fill-rule": "nonzero", "fill-opacity": "1",
            "stroke-opacity": "1", "stroke-linecap": "butt",
            "stroke-linejoin": "miter", "color": "black",
        }
        for ch in self.root:
            self._walk(ch, self.base, state, 1.0, 0)
        out = np.empty((self.h, self.w, 4), np.uint8)
        a = self.img[:, :, 3:4]
        rgb = np.where(a > 1e-6, self.img[:, :, :3] / np.maximum(a, 1e-6),
                       0.0)
        out[:, :, :3] = np.clip(rgb + 0.5, 0, 255).astype(np.uint8)
        out[:, :, 3] = np.clip(a[:, :, 0] * 255.0 + 0.5,
                               0, 255).astype(np.uint8)
        return out

    # -- painting ----------------------------------------------------------

    def _paint(self, cov, paint, opacity, ctm, bbox):
        if paint is None or opacity <= 0:
            return
        if isinstance(paint, tuple) and paint and paint[0] == "url":
            el = self.idmap.get(paint[1])
            if el is None or el.tag.split("}")[-1] not in (
                    "linearGradient", "radialGradient"):
                return
            src = gradient_rgba(el, self.idmap, ctm, self.w, self.h, bbox)
            a = src[:, :, 3] * cov * opacity
            rgbp = src[:, :, :3] * a[:, :, None]
        else:
            r, g, b, pa = paint
            a = cov * (pa * opacity)
            rgbp = np.empty((self.h, self.w, 3), np.float32)
            rgbp[:, :, 0] = r * a
            rgbp[:, :, 1] = g * a
            rgbp[:, :, 2] = b * a
        keep = (1.0 - a)[:, :, None]
        self.img[:, :, :3] = rgbp + self.img[:, :, :3] * keep
        self.img[:, :, 3] = a + self.img[:, :, 3] * keep[:, :, 0]

    def _draw(self, subpaths, closed, st, ctm, opacity):
        if not subpaths:
            return
        polys = [mat_apply(ctm, np.asarray(p, np.float64))
                 for p in subpaths if len(p) >= 2]
        if not polys:
            return
        # user-space bbox for objectBoundingBox gradients
        upts = np.concatenate([np.asarray(p) for p in subpaths], axis=0)
        bbox = (float(upts[:, 0].min()), float(upts[:, 1].min()),
                float(max(upts[:, 0].max() - upts[:, 0].min(), 1e-6)),
                float(max(upts[:, 1].max() - upts[:, 1].min(), 1e-6)))
        fill = parse_color(st["fill"],
                           parse_color(st.get("color", "black")))
        if fill is not None:
            cov = fill_coverage(polys, self.w, self.h,
                                evenodd=(st["fill-rule"] == "evenodd"))
            self._paint(cov, fill,
                        float(st.get("fill-opacity", 1.0)) * opacity,
                        ctm, bbox)
        stroke = parse_color(st["stroke"], None)
        swidth = _len_value(st.get("stroke-width", "1"))
        if stroke is not None and swidth > 0:
            spolys = stroke_polys(
                [np.asarray(p, np.float64) for p in subpaths], closed,
                swidth, st.get("stroke-linecap", "butt"),
                st.get("stroke-linejoin", "miter"))
            spolys = [mat_apply(ctm, p) for p in spolys]
            cov = fill_coverage(spolys, self.w, self.h, union=True)
            self._paint(cov, stroke,
                        float(st.get("stroke-opacity", 1.0)) * opacity,
                        ctm, bbox)

    # -- traversal ---------------------------------------------------------

    def _walk(self, el, ctm, pstate, opacity, depth):
        if depth > 64:
            return
        tag = el.tag.split("}")[-1]
        if tag in ("defs", "symbol", "linearGradient", "radialGradient",
                   "clipPath", "mask", "marker", "pattern", "style",
                   "metadata", "title", "desc", "script"):
            return
        st = dict(pstate)
        own = _style_of(el)
        for k in _INHERITED:
            if k in own:
                st[k] = own[k]
        if own.get("display") == "none" or \
                own.get("visibility") in ("hidden", "collapse"):
            return
        opacity *= float(own.get("opacity", 1.0))
        tr = el.get("transform")
        if tr:
            ctm = mat_mul(ctm, parse_transform(tr))
        scale = math.sqrt(abs(ctm[0, 0] * ctm[1, 1]
                              - ctm[0, 1] * ctm[1, 0]) + 1e-12)

        if tag in ("g", "svg", "a", "switch"):
            for ch in el:
                self._walk(ch, ctm, st, opacity, depth + 1)
            return
        if tag == "use":
            href = (el.get("href")
                    or el.get("{http://www.w3.org/1999/xlink}href") or "")
            ref = self.idmap.get(href[1:]) if href.startswith("#") else None
            if ref is not None and ref is not el:
                sh = mat_identity()
                sh[:, 2] = (_len_value(el.get("x", "0")),
                            _len_value(el.get("y", "0")))
                self._walk(ref, mat_mul(ctm, sh), st, opacity, depth + 1)
            return

        subs, closed = self._shape(el, tag, scale)
        if subs:
            self._draw(subs, closed, st, ctm, opacity)

    def _shape(self, el, tag, scale):
        g = _len_value
        if tag == "rect":
            x, y = g(el.get("x", "0")), g(el.get("y", "0"))
            w, h = g(el.get("width", "0")), g(el.get("height", "0"))
            if w <= 0 or h <= 0:
                return [], []
            rx = el.get("rx")
            ry = el.get("ry")
            rx = g(rx) if rx is not None else (g(ry) if ry is not None
                                               else 0.0)
            ry = g(ry) if ry is not None else rx
            rx = min(max(rx, 0.0), w / 2)
            ry = min(max(ry, 0.0), h / 2)
            if rx < 1e-9 or ry < 1e-9:
                p = [(x, y), (x + w, y), (x + w, y + h), (x, y + h)]
                return [p], [True]
            n = max(_n_segs(max(rx, ry), scale) // 4, 3)
            th = np.linspace(0.0, math.pi / 2, n + 1)
            cs, sn = np.cos(th), np.sin(th)
            pts = []
            pts += [(x + w - rx + rx * sn[i], y + ry - ry * cs[i])
                    for i in range(n + 1)]
            pts += [(x + w - rx + rx * cs[i], y + h - ry + ry * sn[i])
                    for i in range(n + 1)]
            pts += [(x + rx - rx * sn[i], y + h - ry + ry * cs[i])
                    for i in range(n + 1)]
            pts += [(x + rx - rx * cs[i], y + ry - ry * sn[i])
                    for i in range(n + 1)]
            return [pts], [True]
        if tag == "circle":
            cx, cy = g(el.get("cx", "0")), g(el.get("cy", "0"))
            r = g(el.get("r", "0"))
            if r <= 0:
                return [], []
            return [_disk(cx, cy, r, _n_segs(r, scale))], [True]
        if tag == "ellipse":
            cx, cy = g(el.get("cx", "0")), g(el.get("cy", "0"))
            rx, ry = g(el.get("rx", "0")), g(el.get("ry", "0"))
            if rx <= 0 or ry <= 0:
                return [], []
            n = _n_segs(max(rx, ry), scale)
            th = np.linspace(0.0, 2 * math.pi, n, endpoint=False)
            pts = np.stack([cx + rx * np.cos(th), cy + ry * np.sin(th)],
                           axis=1)
            return [pts], [True]
        if tag == "line":
            p = [(g(el.get("x1", "0")), g(el.get("y1", "0"))),
                 (g(el.get("x2", "0")), g(el.get("y2", "0")))]
            return [p], [False]
        if tag in ("polyline", "polygon"):
            nums = _NUM_RE.findall(el.get("points", ""))
            if len(nums) < 4:
                return [], []
            v = [float(x) for x in nums]
            pts = list(zip(v[0::2], v[1::2]))
            return [pts], [tag == "polygon"]
        if tag == "path":
            return parse_path(el.get("d", ""), scale)
        return [], []


def _len_value(v):
    """Parse a length (px assumed; %, units stripped numerically)."""
    if v is None:
        return 0.0
    if isinstance(v, (int, float)):
        return float(v)
    m = _NUM_RE.search(v)
    return float(m.group(0)) if m else 0.0


def rasterize(root, width, height, viewbox=None):
    """Render an ElementTree SVG root -> (H, W, 4) uint8 RGBA."""
    return Rasterizer(root, width, height, viewbox).run()
