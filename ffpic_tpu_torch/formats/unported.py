"""The codecs of ``ffpic_tpu`` that the port does not decode yet,
registered by their probes alone.

TGA has no magic and is probed last: without these probes, an AVIF,
BPG, JPEG 2000, SVG or EXR file that TGA's loose header check takes
would decode as TGA garbage.  Each probe is a copy of its original
(``ffpic_tpu/formats/avif.py:30``, ``bpg.py:13``, ``jp2.py:21``,
``svg.py:16``, ``exr.py:41``), and the registry keeps each codec at the
original's place in the probe order under the original's name.  Their
``load`` raises ``NotImplementedError``: the decoders wait for
``ROADMAP.md`` Queue 1 item 1.
"""

from __future__ import annotations

from ffpic_tpu_torch.formats.registry import Codec, register

JP2_SIG = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
EXR_MAGIC = b"\x76\x2f\x31\x01"
BPG_MAGIC = b"BPG\xfb"


def probe_avif(data: bytes) -> bool:
    return (len(data) > 12 and data[4:8] == b"ftyp" and
            data[8:12] in (b"avif", b"avis"))


def probe_bpg(data: bytes) -> bool:
    return data[:4] == BPG_MAGIC


def probe_jp2(data: bytes) -> bool:
    return data.startswith(JP2_SIG) or data[:2] == b"\xff\x4f"


def probe_svg(data: bytes) -> bool:
    head = data[:512].lstrip()
    return head.startswith(b"<?xml") and b"<svg" in data[:2048] or \
        head.startswith(b"<svg")


def probe_exr(data: bytes) -> bool:
    return data[:4] == EXR_MAGIC


def _unported(name: str, item: str):
    def load(data: bytes, skip_decode: bool = False, *, device=None,
             **options):
        raise NotImplementedError(
            f"the port does not decode {name} yet (ROADMAP.md Queue 1 "
            f"{item})")
    return load


for _name, _alias, _probe, _item in (
        ("AVIF", "", probe_avif, "item 1"),
        ("BPG", "", probe_bpg, "item 1"),
        ("JP2", "JPEG2000", probe_jp2, "item 1"),
        ("SVG", "", probe_svg, "item 1"),
        ("EXR", "OPENEXR", probe_exr, "item 1")):
    register(Codec(name=_name, alias=_alias, probe=_probe,
                   load=_unported(_name, _item)))
