"""SVG codec.  Structure parse at parity with format/svg.c (which
builds an XML node tree and stops, svg.c:56-512) **plus a full
rasterizer** (`svg_raster.py`): shapes/paths/transforms/gradients to
RGBA pixels via a vectorized scanline fill — a capability the
reference does not have.

Copied from ``ffpic_tpu/formats/svg.py`` (``probe``, ``_parse_len``,
``load``, ``info``) for the PyTorch port.  The host decode is
``decode``; the registry's ``load`` stages its pixels to the device,
and ``decode_batch`` stages a batch's at once.  The rasterizer runs
under the span ``svg.raster``."""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET

from ffpic_tpu_torch.formats.pic import Pic
from ffpic_tpu_torch.formats.registry import Codec, register
from ffpic_tpu_torch.utils.trace import stage


def probe(data: bytes) -> bool:
    head = data[:512].lstrip()
    return head.startswith(b"<?xml") and b"<svg" in data[:2048] or \
        head.startswith(b"<svg")


def _parse_len(v: str | None) -> int:
    if not v:
        return 0
    m = re.match(r"([0-9.]+)", v)
    return int(float(m.group(1))) if m else 0


def decode(data: bytes, skip_decode: bool = False, *,
           device) -> list[Pic]:
    """The file's picture with its pixels on the host (``device`` is
    not used: no nested decode)."""
    try:
        root = ET.fromstring(data.decode("utf8", "replace"))
    except ET.ParseError as e:
        raise ValueError(f"corrupt SVG: {e}") from e
    tag = root.tag.split("}")[-1]
    if tag != "svg":
        raise ValueError("not an svg root element")
    w = _parse_len(root.get("width"))
    h = _parse_len(root.get("height"))
    viewbox = root.get("viewBox", "")
    if (not w or not h) and viewbox:
        parts = viewbox.replace(",", " ").split()
        if len(parts) == 4:
            w = w or int(float(parts[2]))
            h = h or int(float(parts[3]))

    counts: dict[str, int] = {}
    for el in root.iter():
        t = el.tag.split("}")[-1]
        counts[t] = counts.get(t, 0) + 1

    vb = None
    if viewbox:
        parts = viewbox.replace(",", " ").split()
        if len(parts) == 4:
            try:
                vb = tuple(float(p) for p in parts)
            except ValueError:
                vb = None
    if (not w or not h) and not vb:
        w, h = w or 300, h or 150          # CSS default viewport

    meta = dict(width=w, height=h, viewbox=viewbox, elements=counts,
                total_elements=sum(counts.values()))
    pic = Pic(width=w, height=h, depth=32, pitch=w * 4, codec="SVG",
              meta=meta)
    if skip_decode:
        return [pic]
    from ffpic_tpu_torch.formats.svg_raster import rasterize
    with stage("svg.raster"):
        pic.pixels = rasterize(root, w, h, vb)
    return [pic]


def info(pic: Pic) -> str:
    m = pic.meta
    els = ", ".join(f"{k}:{v}" for k, v in sorted(m["elements"].items()))
    return ("SVG file format\n"
            f"\twidth {m['width']}, height {m['height']} "
            f"viewBox '{m['viewbox']}'\n"
            f"\t{m['total_elements']} elements ({els})")


register(Codec(name="SVG", probe=probe, decode=decode, info=info))
