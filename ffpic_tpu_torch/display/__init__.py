"""Display sinks of the port: a named registry of ways to show a
picture.

Copied from ``ffpic_tpu/display/__init__.py`` (``register_sink``,
``get_sink``, ``show`` and the ``bmp``, ``png`` and ``window`` sinks)
over the port's codecs.  ``bmp`` writes the 32 bpp top-down BMP of the
reference's bmpwriter as ``"<title> (W * H).bmp"``, ``png`` writes
``"<title>.png"``, ``window`` opens the platform viewer through PIL,
which it imports when called (without PIL it raises ``ImportError``).
The encoders run on the host, whatever device the pixels are on.
"""

from __future__ import annotations

from typing import Callable

import torch

_sinks: dict[str, Callable] = {}
_HOST = torch.device("cpu")


def register_sink(name: str):
    def deco(fn):
        _sinks[name] = fn
        return fn
    return deco


def get_sink(name: str) -> Callable:
    if name not in _sinks:
        raise KeyError(f"no display sink {name!r}; have {sorted(_sinks)}")
    return _sinks[name]


def show(pic, sink: str = "bmp", title: str = "out", **kw) -> str | None:
    """Show ``pic`` through the sink named ``sink``; returns the path a
    file sink wrote, else None."""
    return get_sink(sink)(pic, title=title, **kw)


@register_sink("bmp")
def _bmp_sink(pic, title="out", **kw):
    from ffpic_tpu_torch.formats import bmp
    path = f"{title} ({pic.width} * {pic.height}).bmp"
    with open(path, "wb") as f:
        f.write(bmp.encode(pic, device=_HOST))
    return path


@register_sink("png")
def _png_sink(pic, title="out", **kw):
    from ffpic_tpu_torch.formats import png
    path = f"{title}.png"
    with open(path, "wb") as f:
        f.write(png.encode(pic, device=_HOST))
    return path


@register_sink("window")
def _window_sink(pic, title="out", **kw):
    from PIL import Image
    img = Image.fromarray(pic.to_rgba32())
    img.show(title=title)
    return None
