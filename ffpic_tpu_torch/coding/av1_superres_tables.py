"""AV1 superres upscale filters (GENERATED by
tools/extract_av1_superres_table.py - do not edit).

Normative spec 7.16 constants (Upscale_Filter[64][8]), machine-
extracted from the system libaom binary.

Copied from ``ffpic_tpu/coding/av1_superres_tables.py`` for the PyTorch
port unchanged.
"""

import base64
import zlib

import numpy as np

_BLOB = (
    "eNpV0/1HNFEYxvHv7k5TJJFEJBGJRCQSkUgkEkkkSZIkJZXed//g3nue3tu765yZOTMzP4z97Jlz"
    "X3PMfYO7GhQvswZV3RNV+LU6EU2rpP6RY/2buMqX3dJW8Kfd0K6nKr5WlQ+5g2/9cq7xbtd0alfm"
    "N7uiy9vM+b9d0q0qNe+If3ZBj6pkfrVzelUl84ud0Vfws53Sr6qRdwtPdsKAquY+ZlBVMz/aEUMF"
    "P9ghw0ppCT5gRCmJY+5tn9GS9xhTau5dxpWS+c52mJDj4G0mlZp7i6mSN5lWqnPTWuUNZrybqdeZ"
    "VUq+vsZcyavMl7zCgu6tYf8yi97Z+hJL6bp5L7Jcen6BlbDuzjfPaslzrJU8y3rYH+vNZ9gorD/Y"
    "NJtydt5Hm2Kr5Em2C36yCXaC3fcbZzc9n/OzjbFX8IuNsl/yCAdKzb7nqw1zGOz6a4gjpeYe5Dh8"
    "v0idM8BJwW/Wz6lSo7Rf362PM6Xk7uVcKZk/rIeL0F81dXY3l6qa9Kubny6uVLXmZ865k+u0n52/"
    "rYMbVUlm0s1fu/zp5yeZzzZu03lKHFNP58+5qeR6mM9kJhvpfP8BP+/nLA=="
)

UPSCALE_FILTER = np.frombuffer(
    zlib.decompress(base64.decodebytes(_BLOB.encode())),
    dtype="<i2").reshape(64, 8).copy()
