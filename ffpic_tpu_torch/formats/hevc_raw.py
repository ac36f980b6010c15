"""Raw HEVC Annex-B elementary streams (.265/.hevc): probe + full
sequence decode through the DPB-backed SequenceDecoder.

Copied from ``ffpic_tpu/formats/hevc_raw.py`` for the PyTorch port
(``probe``, ``_stream_meta``, ``info``; its ``load`` as ``decode``).
The stream decodes on the host (``formats.hevc.SequenceDecoder``: the
CABAC syntax, the motion compensation and the recon; under
``FFPIC_HEVC_DEVICE`` each picture's residual transform in one launch
on ``device``).  Each picture is then coloured with the original's
literal "bt601": on the host, or under ``FFPIC_HEIF_DEVICE_COLOR`` in
one launch of the ``hevc_yuv_to_rgba`` kernel on ``device``
(``formats.heif.frame_pixels``).  The codec registers ``decode`` as the
host codecs do: the registry's ``load`` stages what is still on the
host, and ``decode_batch`` takes the first picture.
"""

from __future__ import annotations

import os

from ffpic_tpu_torch.formats.pic import Pic
from ffpic_tpu_torch.formats.registry import Codec, register
from ffpic_tpu_torch.utils.device import resolve_device


def probe(data: bytes) -> bool:
    """Annex-B start code followed by a VPS/SPS/IRAP NAL header
    (forbidden_zero_bit 0, nuh_layer_id 0)."""
    for sc in (b"\x00\x00\x00\x01", b"\x00\x00\x01"):
        if data.startswith(sc):
            off = len(sc)
            if len(data) < off + 2:
                return False
            b0, b1 = data[off], data[off + 1]
            if b0 & 0x81 or (b1 >> 3) != 0 or (b1 & 7) == 0:
                return False
            t = (b0 >> 1) & 0x3F
            return t in (32, 33) or 16 <= t <= 23
    return False


def decode(data: bytes, skip_decode: bool = False, *, device=None):
    """Every picture of the stream in presentation order (POC within
    each IDR group), ``delay_ms`` 40: pixels on the host, or on
    ``device`` where ``FFPIC_HEIF_DEVICE_COLOR`` coloured them there.
    ``device`` is also where ``FFPIC_HEVC_DEVICE``'s residuals run."""
    from ffpic_tpu_torch.formats import heif, hevc

    if skip_decode:
        meta = _stream_meta(data)
        return [Pic(width=meta.get("width", 0),
                    height=meta.get("height", 0), codec="HEVC",
                    meta=meta)]
    on_device = bool(os.environ.get("FFPIC_HEIF_DEVICE_COLOR"))
    if on_device:
        device = resolve_device(device, "hevc")
    dec = hevc.SequenceDecoder(device)
    decoded = dec.decode_annexb(data)
    if not decoded:
        raise ValueError("no decodable HEVC access units")
    ordered = hevc.display_order(decoded)
    meta = dict(_stream_meta(data), n_pictures=len(ordered))
    pics = []
    for p in ordered:
        rgba = heif.frame(p, "bt601", on_device)
        if on_device:
            rgba = heif.frame_pixels(rgba, "bt601", device)
        pics.append(Pic(pixels=rgba, width=rgba.shape[1],
                        height=rgba.shape[0], codec="HEVC",
                        meta=meta, delay_ms=40))
    return pics


def _stream_meta(data: bytes) -> dict:
    from ffpic_tpu_torch.formats import hevc
    n_au = 0
    types = set()
    sps = None
    for nalu in hevc.split_annexb(data):
        t = hevc.nal_type(nalu)
        if t == hevc.NAL_SPS:
            sps = hevc.parse_sps(nalu)
        elif t < 32 and len(nalu) >= 3 and (nalu[2] >> 7) & 1:
            n_au += 1
            types.add(t)
    out = dict(access_units=n_au, nal_types=sorted(types))
    if sps is not None:
        out.update(width=sps.pic_width_cropped,
                   height=sps.pic_height_cropped,
                   bit_depth=sps.bit_depth_luma,
                   profile=sps.ptl.profile_idc,
                   chroma_format=sps.chroma_format)
    return out


def info(pic) -> str:
    m = pic.meta
    return ("HEVC Annex-B elementary stream\n"
            f"\twidth {m.get('width', pic.width)}, "
            f"height {m.get('height', pic.height)}, "
            f"bit depth {m.get('bit_depth', 8)}\n"
            f"\taccess units {m.get('access_units', '?')}, "
            f"pictures decoded {m.get('n_pictures', 0)}, "
            f"NAL types {m.get('nal_types', [])}")


register(Codec(name="HEVC", alias="H265", probe=probe, decode=decode,
               info=info))
