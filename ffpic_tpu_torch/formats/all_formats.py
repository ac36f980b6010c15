"""Side-effect import of every codec the port has, in the probe order of
``ffpic_tpu/formats/all_formats.py``.

JPEG, PNG, WebP and HEIF are ported.  The JAX package's other codecs,
in its order, wait for copies of the host-only codecs (``ROADMAP.md``
Queue 1 item 1): gif (probed before webp in the original), bmp (probed
before heif), avif, bpg, jp2, svg, pnm, tiff, exr, psd, ico, tga (no
magic; probed last); and hevc_raw (raw ``.265``, probed after ico)
for the HEVC inter slice (item 16).
"""

from ffpic_tpu_torch.formats import jpg  # noqa: F401
from ffpic_tpu_torch.formats import png  # noqa: F401
from ffpic_tpu_torch.formats import webp  # noqa: F401
from ffpic_tpu_torch.formats import heif  # noqa: F401
