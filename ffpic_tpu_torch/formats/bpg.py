"""BPG codec (header level — parity with format/bpg.c:1-104, which is
itself a header-only stub: magic, pixel format, bit depth, ue7 dims,
extension tags).

Copied from ``ffpic_tpu/formats/bpg.py`` for the PyTorch port.  Its host
``decode`` gives the header under ``skip_decode`` and otherwise raises
``NotImplementedError``, as the original's ``load`` does (``:60-63``):
so do the registry's ``load`` and ``decode_batch``, which call it."""

from __future__ import annotations

from ffpic_tpu_torch.formats.pic import Pic
from ffpic_tpu_torch.formats.registry import Codec, register

MAGIC = b"BPG\xfb"


def probe(data: bytes) -> bool:
    return data[:4] == MAGIC


def _ue7(data: bytes, pos: int) -> tuple[int, int]:
    v = 0
    while True:
        c = data[pos]
        pos += 1
        v = (v << 7) | (c & 0x7F)
        if not (c & 0x80):
            return v, pos


def decode(data: bytes, skip_decode: bool = False, *,
           device) -> list[Pic]:
    """The header as a picture without pixels (``device`` is not
    used)."""
    b4 = data[4]
    pixel_format = b4 >> 5
    alpha1 = (b4 >> 4) & 1
    bit_depth = (b4 & 0xF) + 8
    b5 = data[5]
    color_space = b5 >> 4
    extension = (b5 >> 3) & 1
    alpha2 = (b5 >> 2) & 1
    limited = (b5 >> 1) & 1
    animation = b5 & 1
    pos = 6
    w, pos = _ue7(data, pos)
    h, pos = _ue7(data, pos)
    picture_data_len, pos = _ue7(data, pos)
    meta = dict(width=w, height=h, pixel_format=pixel_format,
                bit_depth=bit_depth, color_space=color_space,
                alpha=bool(alpha1 or alpha2), limited_range=bool(limited),
                animation=bool(animation), extension=bool(extension))
    if extension:
        ext_len, pos = _ue7(data, pos)
        end = pos + ext_len
        exts = []
        while pos < end:
            tag, pos = _ue7(data, pos)
            ln, pos = _ue7(data, pos)
            exts.append((tag, ln))
            pos += ln
        meta["extensions"] = exts
    pic = Pic(width=w, height=h, depth=32, pitch=w * 4, codec="BPG",
              meta=meta)
    if skip_decode:
        return [pic]
    raise NotImplementedError(
        "BPG pixel decode (HEVC-derived) not implemented; header "
        "metadata via skip_decode — matches the reference's stub "
        "(bpg.c:58-68)")


def info(pic: Pic) -> str:
    m = pic.meta
    fmts = {0: "grayscale", 1: "4:2:0", 2: "4:2:2", 3: "4:4:4",
            4: "4:2:0v", 5: "4:2:2v"}
    return ("BPG file format\n"
            f"\twidth {m['width']}, height {m['height']}\n"
            f"\t{fmts.get(m['pixel_format'])} {m['bit_depth']}-bit, "
            f"alpha {m['alpha']}, animation {m['animation']}")


register(Codec(name="BPG", probe=probe, decode=decode, info=info))
