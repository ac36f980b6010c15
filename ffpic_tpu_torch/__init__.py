"""ffpic_tpu_torch — the PyTorch/CUDA port of ffpic_tpu.

``decode_batch`` decodes a batch of 4:2:0 JPEGs into one ``(N, H, W, 4)``
uint8 tensor on an NVIDIA GPU.  Host parsing and Huffman decoding are
``ffpic_tpu``'s framework-free host layer, used read-only; the device
stages are hand-written CUDA kernels (``csrc/``) built with nvcc at first
use, each with a plain PyTorch version that CPU tensors take.  This
package never imports jax; ``ffpic_tpu`` stays the reference it is
tested against.
"""

from ffpic_tpu_torch.pipeline import decode_batch

__version__ = "0.1.0"

__all__ = ["decode_batch", "__version__"]
