"""Side-effect import of every codec the port has, in the probe order of
``ffpic_tpu/formats/all_formats.py``.

JPEG and PNG are ported.  The JAX package's other codecs, in its order,
wait for ``ROADMAP.md`` Queue 1 items 8-9 (WebP, HEIF/HEVC with their
device stages) and for copies of the host-only codecs (item 1): gif,
webp, bmp, heif, avif, bpg, jp2, svg, pnm, tiff, exr, psd, ico,
hevc_raw, tga (no magic; probed last).
"""

from ffpic_tpu_torch.formats import jpg  # noqa: F401
from ffpic_tpu_torch.formats import png  # noqa: F401
