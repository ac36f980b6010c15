"""ffpic_tpu_torch — the PyTorch/CUDA port of ffpic_tpu.

``decode_batch`` decodes a batch of 4:2:0 JPEGs into one ``(N, H, W, 4)``
uint8 tensor on an NVIDIA GPU.  Host parsing and Huffman decoding are
the package's own copy of ``ffpic_tpu``'s host layer (``formats.jpg``
and ``native/host_jpeg.c``, built with cc at first use); the device
stages are hand-written CUDA kernels (``csrc/``) built with nvcc at first
use, each with a plain PyTorch version that CPU tensors take.  This
package imports neither jax nor ``ffpic_tpu``, which stays the
reference it is tested against.
"""

from ffpic_tpu_torch.pipeline import decode_batch

__version__ = "0.1.0"

__all__ = ["decode_batch", "__version__"]
