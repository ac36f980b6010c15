"""The TIFF tag walker, shared by the TIFF codec (``formats.tiff``) and
the EXIF segment of a JPEG, which is a TIFF structure
(``formats.jpg._parse_exif``).

Copied from ``ffpic_tpu/formats/tiff.py:22-23`` (``TYPE_SIZES``) and
``:47-88`` (``_read_ifd``, ``_first``), with one deliberate difference:
``_read_ifd`` raises ``ValueError`` when an entry's count of integer
values does not fit in the bytes left after its offset, before it
builds a ``struct`` format from that count.  The original builds
``bo + fmt * n`` first, so a corrupt count makes a format string of
gigabytes before ``struct`` finds the data too short.  On every file
whose counts fit, the tags are the original's.
"""

from __future__ import annotations

import struct

TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
              10: 8, 11: 4, 12: 8}


def _read_ifd(data: bytes, pos: int, bo: str):
    """The tags of the IFD at ``pos`` in byte order ``bo`` ("<" or
    ">") as {tag: values}, and the offset of the next IFD."""
    count = struct.unpack_from(bo + "H", data, pos)[0]
    tags = {}
    for i in range(count):
        off = pos + 2 + 12 * i
        tag, typ, n = struct.unpack_from(bo + "HHI", data, off)
        size = TYPE_SIZES.get(typ, 1) * n
        if size <= 4:
            voff = off + 8
        else:
            voff = struct.unpack_from(bo + "I", data, off + 8)[0]
        fmt = {1: "B", 3: "H", 4: "I", 2: "s"}.get(typ)
        if typ == 2:
            vals = data[voff:voff + n].split(b"\0")[0].decode("latin1",
                                                              "replace")
        elif typ == 5:  # rational
            vals = [struct.unpack_from(bo + "II", data, voff + 8 * k)
                    for k in range(n)]
        elif fmt:
            if voff + struct.calcsize(bo + fmt) * n > len(data):
                raise ValueError(f"TIFF: tag {tag} claims {n} values past "
                                 "the end of the file")
            vals = list(struct.unpack_from(bo + fmt * n, data, voff))
        else:
            vals = data[voff:voff + size]
        tags[tag] = vals
    nxt = struct.unpack_from(bo + "I", data, pos + 2 + 12 * count)[0]
    return tags, nxt


def _first(tags, tag, default=None):
    v = tags.get(tag, default)
    if isinstance(v, list):
        return v[0] if v else default
    return v
