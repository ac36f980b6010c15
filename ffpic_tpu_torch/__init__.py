"""ffpic_tpu_torch — the PyTorch/CUDA port of ffpic_tpu.

The public API mirrors ``ffpic_tpu``'s: ``probe``, ``load``,
``load_all``, ``info``, ``encode``, ``find_codec`` and
``registered_codecs`` over the port's own codec registry (JPEG, PNG,
WebP, HEIF and the host-only BMP, GIF, TGA, PNM, PSD, TIFF, ICO, JPEG
2000, SVG, OpenEXR, AVIF (stills, grids and animations, and its
encoder) and raw HEVC streams, in the reference's probe order; BPG
gives its header alone, as in the reference), the ``Pic`` container,
and
``decode_batch``, which decodes a batch of them into one ``(N, H, W,
4)`` uint8 tensor on an NVIDIA GPU, restart-interval JPEGs with their
Huffman decode on the card.  ``load``, ``load_all``, ``encode`` and ``decode_batch`` take
``device``: None means CUDA and raises without it (a header-only
``load`` needs none), "cpu" runs the plain PyTorch versions of the
kernels.  Host parsing and host Huffman decoding are the package's own
copy of ``ffpic_tpu``'s host layer (``formats.jpg``, ``formats.png``,
``formats.webp``, ``formats.heif`` with ``formats.hevc``, the host
codecs with ``coding.lzw``, and ``native/``'s C sources, built with cc
at first use); the apps (``python -m ffpic_tpu_torch.apps.picinfo``,
``transbmp``, ``transcode``, ``show``) and the display sinks
(``display``) run over the same registry; the device stages
are hand-written CUDA kernels (``csrc/``) built with nvcc at first use,
each with a plain PyTorch version that CPU tensors take.  A resized
batch goes on into a model through ``ops.resize.normalize_for_model``
and ``models.vit.ViT`` (BASELINE config 5); ``models.vit`` and
``models.moe`` also train (``make_train_step``), on one device or on
a ``torch.distributed`` DeviceMesh (``parallel``: ``make_mesh``,
``shard_batch``, ``sharded_decode_420``; ``decode_batch(mesh=)``),
and ``graft_entry`` is the port's copy of ``__graft_entry__.py``.
``start_profiler`` and ``stop_profiler`` write a ``torch.profiler``
Chrome trace.
This package imports
neither jax nor ``ffpic_tpu``, which stays the reference it is tested
against.
"""

from ffpic_tpu_torch.formats.pic import Pic
from ffpic_tpu_torch.formats.registry import (
    encode,
    find_codec,
    info,
    load,
    load_all,
    probe,
    registered_codecs,
)
from ffpic_tpu_torch.pipeline import decode_batch
from ffpic_tpu_torch.utils.trace import start_profiler, stop_profiler

__version__ = "0.1.0"

__all__ = [
    "Pic",
    "probe",
    "load",
    "load_all",
    "info",
    "encode",
    "find_codec",
    "registered_codecs",
    "decode_batch",
    "start_profiler",
    "stop_profiler",
    "__version__",
]
