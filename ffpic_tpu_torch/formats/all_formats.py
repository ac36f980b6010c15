"""Side-effect import of every codec the port has.  The registry keeps
them in the probe order of ``ffpic_tpu/formats/all_formats.py``
(``registry.ORDER``): jpg, png, gif, webp, bmp, heif, avif, bpg, jp2,
svg, pnm, tiff, exr, psd, ico, hevc_raw, tga (no magic; probed last).
"""

from ffpic_tpu_torch.formats import jpg  # noqa: F401
from ffpic_tpu_torch.formats import png  # noqa: F401
from ffpic_tpu_torch.formats import gif  # noqa: F401
from ffpic_tpu_torch.formats import webp  # noqa: F401
from ffpic_tpu_torch.formats import bmp  # noqa: F401
from ffpic_tpu_torch.formats import heif  # noqa: F401
from ffpic_tpu_torch.formats import avif  # noqa: F401
from ffpic_tpu_torch.formats import bpg  # noqa: F401
from ffpic_tpu_torch.formats import jp2  # noqa: F401
from ffpic_tpu_torch.formats import svg  # noqa: F401
from ffpic_tpu_torch.formats import pnm  # noqa: F401
from ffpic_tpu_torch.formats import tiff  # noqa: F401
from ffpic_tpu_torch.formats import exr  # noqa: F401
from ffpic_tpu_torch.formats import psd  # noqa: F401
from ffpic_tpu_torch.formats import ico  # noqa: F401
from ffpic_tpu_torch.formats import hevc_raw  # noqa: F401
from ffpic_tpu_torch.formats import tga  # noqa: F401
