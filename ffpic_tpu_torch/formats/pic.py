"""The decoded-picture container of the port.

Copied from ``ffpic_tpu/formats/pic.py:19-109`` (``PixelFormat``,
``Pic``).  ``pixels`` is an ``(H, W, 4)`` uint8 array in ``format``'s
byte order and may be a CUDA tensor, so that a decode feeds a model
with no host round trip.  ``np_pixels`` copies a tensor to the host
(``np.asarray`` of a CUDA tensor raises); ``to_rgba32``, ``to_bgra32``
and ``exif_transpose`` work on top of it, as in the original.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch


class PixelFormat:
    """Pixel formats, the granularity of the original's enum."""

    RGBA32 = "RGBA32"
    BGRA32 = "BGRA32"
    GRAY = "GRAY"
    GRAY16 = "GRAY16"
    RGB24 = "RGB24"
    INDEXED8 = "INDEXED8"
    FLOAT_RGBA = "FLOAT_RGBA"


@dataclass
class Pic:
    pixels: Any = None            # (H, W, 4) uint8; numpy or a torch tensor
    width: int = 0
    height: int = 0
    depth: int = 32               # bits per pixel of the canonical surface
    pitch: int = 0                # bytes per row of the canonical surface
    format: str = PixelFormat.RGBA32
    left: int = 0
    top: int = 0
    codec: str = ""
    meta: dict = field(default_factory=dict)   # format-specific info() data
    frames: list = field(default_factory=list)  # extra pictures
    delay_ms: int = 0             # animation frame delay, if any

    # -- conversions -------------------------------------------------------
    def np_pixels(self) -> np.ndarray:
        """Pixels as a host numpy array (device-to-host copy if needed)."""
        if isinstance(self.pixels, torch.Tensor):
            return self.pixels.cpu().numpy()
        return np.asarray(self.pixels)

    def exif_transpose(self) -> "Pic":
        """A Pic with the EXIF orientation applied to the pixels, as host
        numpy (meta orientation reset to 1).  No-op without pixels or
        when the orientation is absent or 1.  Decoders never rotate on
        their own."""
        o = (self.meta or {}).get("exif", {}).get("orientation", 1)
        if self.pixels is None or o in (0, 1):
            return self
        px = self.np_pixels()
        if o == 2:
            px = px[:, ::-1]
        elif o == 3:
            px = px[::-1, ::-1]
        elif o == 4:
            px = px[::-1]
        elif o == 5:
            px = np.rot90(px, 3)[:, ::-1]
        elif o == 6:
            px = np.rot90(px, 3)
        elif o == 7:
            px = np.rot90(px, 1)[:, ::-1]
        elif o == 8:
            px = np.rot90(px, 1)
        px = np.ascontiguousarray(px)
        h, w = px.shape[:2]
        meta = dict(self.meta or {})
        meta["exif"] = dict(meta.get("exif", {}), orientation=1)
        return dataclasses.replace(self, pixels=px, width=w, height=h,
                                   pitch=w * (self.depth // 8), meta=meta)

    def to_rgba32(self) -> np.ndarray:
        px = self.np_pixels()
        if self.format == PixelFormat.BGRA32:
            return px[..., [2, 1, 0, 3]]
        if px.ndim == 2:
            return np.stack([px, px, px, np.full_like(px, 255)], axis=-1)
        return px

    def to_bgra32(self) -> np.ndarray:
        """The byte order of the C reference's pictures."""
        px = self.np_pixels()
        if self.format == PixelFormat.BGRA32:
            return px
        if px.ndim == 2:
            return np.stack([px, px, px, np.full_like(px, 255)], axis=-1)
        return px[..., [2, 1, 0, 3]]

    @property
    def n_frames(self) -> int:
        return 1 + len(self.frames)

    def __repr__(self) -> str:  # keep terse; meta can be huge
        dev = type(self.pixels).__name__ if self.pixels is not None else "none"
        return (f"Pic({self.codec} {self.width}x{self.height} depth={self.depth} "
                f"format={self.format} pixels={dev} frames={self.n_frames})")
