"""The port's codec registry: probe-by-content dispatch.

Copied from ``ffpic_tpu/formats/registry.py:24-136`` (``Codec``,
``register``, ``registered_codecs``, ``find_codec``, ``probe``,
``load_all``, ``load``, ``info``, ``encode``) with its own codec list,
so that importing ``ffpic_tpu`` (which registers the JAX package's
codecs in its registry) never touches it.  Three changes:

* ``load``, ``load_all`` and ``encode`` take ``device``: None means
  CUDA and raises without it (except for a header-only ``load``, which
  needs no device), "cpu" runs the plain PyTorch versions.  The codec
  gets the resolved ``torch.device``;
* they pass further keyword options to the codec (for JPEG: ``quirks``,
  ``order``, ``mode``, ``upsample``; for PNG: ``verify_crc``), which the
  original's ``load`` has no way to reach;
* the codec list is filled under a lock (``_ensure_init``), and kept
  in the original's probe order (``ORDER``) whatever order the modules
  are imported in: the pipeline imports some codecs before the others;
* a codec that decodes on the host to RGBA (BMP, GIF, TGA, PNM, PSD,
  TIFF, ICO, JP2, SVG, EXR, AVIF; BPG, whose ``decode`` gives the header
  alone) registers its host ``decode`` in place of ``load``;
  ``load_all`` stages the pixels it returns to the device
  (``staging.to_device_pics``), and ``decode_batch`` calls ``decode``
  in its pool and stages a batch's pixels at once.

Malformed files that pass the probe keep the original's contract: they
raise ``ValueError``, not the parser's own exception
(``corrupt_as_value_error``, which ``decode_batch`` shares).  That also
covers ``StopIteration``, which a truncated PNM header raises and the
original lets through.
"""

from __future__ import annotations

import contextlib
import os
import struct
import threading
import zlib
from dataclasses import dataclass
from typing import Callable, Optional

from ffpic_tpu_torch.formats.pic import Pic
from ffpic_tpu_torch.formats.staging import to_device_pics
from ffpic_tpu_torch.utils.device import resolve_device


@dataclass
class Codec:
    name: str
    alias: str = ""
    # probe(data: bytes) -> bool
    probe: Callable[[bytes], bool] = None
    # load(data: bytes, skip_decode: bool, device=..., **options) -> list[Pic]
    load: Callable[..., list] = None
    # info(pic) -> str  (structured metadata dump)
    info: Callable[[Pic], str] = None
    # encode(pic, device=..., **options) -> bytes
    encode: Optional[Callable] = None
    # decode(data: bytes, skip_decode: bool, *, device) -> list[Pic]: a
    # host codec's decode, pixels as host (H, W, 4) uint8 arrays (or
    # tensors on ``device`` where a nested codec decoded them); set in
    # place of ``load``
    decode: Optional[Callable[..., list]] = None


# the probe order of ffpic_tpu/formats/all_formats.py (TGA has no
# magic and goes last)
ORDER = ("JPG", "PNG", "GIF", "WEBP", "BMP", "HEIF", "AVIF", "BPG", "JP2",
         "SVG", "PNM", "TIFF", "EXR", "PSD", "ICO", "HEVC", "TGA")

_codecs: list[Codec] = []
_initialized = False
_init_lock = threading.RLock()


def register(codec: Codec) -> None:
    """Add a codec at its place in ``ORDER`` (one not listed goes last).
    The list is replaced, not changed in place, so that a probe walking
    the old one is not disturbed."""
    global _codecs
    _codecs = sorted([*_codecs, codec], key=lambda c: (
        ORDER.index(c.name) if c.name in ORDER else len(ORDER)))


def _ensure_init() -> None:
    """Import the port's format modules once; each registers itself.
    Under a lock, and marked done only after the imports, so that a
    thread that asks while another imports waits for a full list (the
    original marks it first, and a second thread can find no codec)."""
    global _initialized
    with _init_lock:
        if _initialized:
            return
        from ffpic_tpu_torch.formats import all_formats  # noqa: F401
        _initialized = True


def registered_codecs() -> list[str]:
    _ensure_init()
    return [c.name for c in _codecs]


def find_codec(name: str) -> Codec:
    """Lookup by name or alias, case-insensitive."""
    _ensure_init()
    name_l = name.lower()
    for c in _codecs:
        if c.name.lower() == name_l or (c.alias and c.alias.lower() == name_l):
            return c
    raise KeyError(f"no codec named {name!r}; have {registered_codecs()}")


def _read_input(src) -> bytes:
    if isinstance(src, (bytes, bytearray, memoryview)):
        return bytes(src)
    if isinstance(src, (str, os.PathLike)):
        with open(src, "rb") as f:
            return f.read()
    raise TypeError(f"unsupported input type {type(src)}")


def probe(src) -> Codec:
    """Identify the codec for a file path or bytes by content."""
    data = _read_input(src)
    _ensure_init()
    for c in _codecs:
        try:
            if c.probe is not None and c.probe(data):
                return c
        except Exception:   # a codec's probe must never break the walk
            continue
    raise ValueError("unrecognized image format")


@contextlib.contextmanager
def corrupt_as_value_error(codec_name: str):
    """Re-raise what a parser raises on a malformed file as
    ``ValueError``; ``ValueError``, ``NotImplementedError`` and
    ``OSError`` pass as they are."""
    try:
        yield
    except (struct.error, KeyError, IndexError, EOFError, StopIteration,
            OverflowError, ZeroDivisionError, zlib.error) as e:
        raise ValueError(f"corrupt {codec_name} file: "
                         f"{type(e).__name__}: {e}") from e


def load_all(src, skip_decode: bool = False, device=None,
             **options) -> list[Pic]:
    """Decode every picture in the input; the first carries the others
    on ``frames``.  A header-only parse (``skip_decode``) with
    ``device=None`` needs no CUDA: the device is resolved only to decode
    pixels."""
    dev = (None if skip_decode and device is None
           else resolve_device(device, "load"))
    data = _read_input(src)
    codec = probe(data)
    with corrupt_as_value_error(codec.name):
        if codec.decode is not None:
            pics = to_device_pics(codec.decode(data, skip_decode, device=dev,
                                               **options), dev)
        else:
            pics = codec.load(data, skip_decode, device=dev, **options)
    for p in pics:
        p.codec = codec.name
    if pics and len(pics) > 1:
        pics[0].frames = pics[1:]
    return pics


def load(src, skip_decode: bool = False, device=None, **options) -> Pic:
    """Decode the primary picture; extra pictures hang off ``pic.frames``."""
    pics = load_all(src, skip_decode, device=device, **options)
    if not pics:
        raise ValueError("decode produced no pictures")
    return pics[0]


def info(pic: Pic) -> str:
    codec = find_codec(pic.codec)
    if codec.info is not None:
        return codec.info(pic)
    return repr(pic)


def encode(pic: Pic, codec_name: str, device=None, **options) -> bytes:
    codec = find_codec(codec_name)
    if codec.encode is None:
        raise NotImplementedError(f"codec {codec.name} has no encoder")
    return codec.encode(pic, device=resolve_device(device, "encode"),
                        **options)
