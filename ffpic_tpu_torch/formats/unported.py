"""The codec of ``ffpic_tpu`` that the port does not decode yet, AVIF,
registered by its probe alone.

TGA has no magic and is probed last: without this probe, an AVIF file
that TGA's loose header check takes would decode as TGA garbage.  The
probe is a copy of its original (``ffpic_tpu/formats/avif.py:30``), and
the registry keeps the codec at the original's place in the probe order
under the original's name.  Its ``load`` raises ``NotImplementedError``:
the decoder waits for ``ROADMAP.md`` Queue 1 item 1's third group.
"""

from __future__ import annotations

from ffpic_tpu_torch.formats.registry import Codec, register

UNPORTED_ITEM = "item 1, third group (AVIF)"


def probe_avif(data: bytes) -> bool:
    return (len(data) > 12 and data[4:8] == b"ftyp" and
            data[8:12] in (b"avif", b"avis"))


def load(data: bytes, skip_decode: bool = False, *, device=None,
         **options):
    raise NotImplementedError(
        f"the port does not decode AVIF yet (ROADMAP.md Queue 1 "
        f"{UNPORTED_ITEM})")


register(Codec(name="AVIF", probe=probe_avif, load=load))
