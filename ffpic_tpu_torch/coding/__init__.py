"""Entropy coding of the port: the copies of ``ffpic_tpu/coding/``'s
coders that its host layer reaches (Huffman, DEFLATE, LZW, the VP8
boolean decoder, Exp-Golomb, CABAC, the AV1 multi-symbol decoder and
encoder, the JPEG 2000 and OpenEXR block codecs).

Exports the names of ``ffpic_tpu/coding/__init__.py:11-13``.
"""

from ffpic_tpu_torch.coding.huffman import (HuffmanDecoder, HuffmanEncoder,
                                            HuffmanTable)

__all__ = ["HuffmanTable", "HuffmanDecoder", "HuffmanEncoder"]
