"""Codecs of the port: the registry, ``Pic`` and each format's copy of
``ffpic_tpu``'s host code.

Exports the names of ``ffpic_tpu/formats/__init__.py:1-17``.  The codec
modules register themselves when the registry first needs its list
(``registry._ensure_init``, under its lock), not on this import.
"""

from ffpic_tpu_torch.formats.pic import Pic, PixelFormat
from ffpic_tpu_torch.formats.registry import (
    Codec,
    encode,
    find_codec,
    info,
    load,
    load_all,
    probe,
    register,
    registered_codecs,
)

__all__ = [
    "Pic", "PixelFormat", "Codec", "register", "probe", "load", "load_all",
    "info", "encode", "find_codec", "registered_codecs",
]
