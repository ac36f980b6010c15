"""Side-effect import of every codec the port has, in the probe order of
``ffpic_tpu/formats/all_formats.py``.

JPEG, PNG and WebP are ported.  The JAX package's other codecs, in its
order, wait for ``ROADMAP.md`` Queue 1 item 9 (HEIF/HEVC with its
device stage) and for copies of the host-only codecs (item 1): gif
(probed before webp in the original), bmp, heif, avif, bpg, jp2, svg,
pnm, tiff, exr, psd, ico, hevc_raw, tga (no magic; probed last).
"""

from ffpic_tpu_torch.formats import jpg  # noqa: F401
from ffpic_tpu_torch.formats import png  # noqa: F401
from ffpic_tpu_torch.formats import webp  # noqa: F401
