"""Synthetic baseline 4:2:0 JPEGs made from a seed, without jax or PIL.

``encode_420`` writes what ``ffpic_tpu.formats.jpg_encode.encode_baseline``
writes (same colour transform, 13-bit forward DCT, quantisation, ITU-T81
K.3-K.6 Huffman tables and container), with ``golden.fdct8x8`` in place
of the jax ``fdct_blocks``; the two agree bit for bit.  ``chip_smoke.py``
and the tests use it to make inputs on machines that have neither jax
nor PIL.  The entropy coder is Python: about 4 s for one 1080p image.
"""

from __future__ import annotations

import struct

import numpy as np

from ffpic_tpu.coding.huffman import HuffmanTable
from ffpic_tpu.formats.jpg_encode import (
    UV_AC_COUNT, UV_AC_SYM, UV_DC_COUNT, UV_DC_SYM, UV_QUANT, Y_AC_COUNT,
    Y_AC_SYM, Y_DC_COUNT, Y_DC_SYM, Y_QUANT, _encode_blocks_entropy,
    _rgb_to_yuv420, _scale_quant, _to_blocks)
from ffpic_tpu.ops.golden import ZIGZAG, fdct8x8
from ffpic_tpu.utils.bitstream import MSB, BitWriter


def synth_rgb(h: int, w: int, seed: int) -> np.ndarray:
    """(h, w, 3) uint8 photo-like content: a few random smooth waves
    per channel plus mild noise, so most DCT energy sits low."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32) / max(h, w)
    img = np.empty((h, w, 3), np.float32)
    for c in range(3):
        acc = np.zeros((h, w), np.float32)
        for _ in range(4):
            fy, fx = rng.uniform(0.5, 12.0, 2)
            acc += rng.uniform(20, 50) * np.sin(
                2 * np.pi * (fy * yy + fx * xx) + rng.uniform(0, 2 * np.pi))
        img[..., c] = 128 + acc + rng.normal(0, 4, (h, w))
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def encode_420(rgb: np.ndarray, quality: int | None = None) -> bytes:
    """(h, w, 3 or 4) uint8 -> baseline 4:2:0 JPEG bytes."""
    h, wd = rgb.shape[:2]
    y, u, v, _H, _W = _rgb_to_yuv420(rgb)
    yq = _scale_quant(Y_QUANT, quality).reshape(8, 8)
    cq = _scale_quant(UV_QUANT, quality).reshape(8, 8)
    planes_zz = []
    nbx = 0
    for plane, q in ((y, yq), (u, cq), (v, cq)):
        blocks = _to_blocks(plane)
        nbx = nbx or blocks.shape[1]
        f = fdct8x8(blocks.reshape(-1, 8, 8)).astype(np.int32)
        qz = np.clip(np.round(f / q).astype(np.int32), -32768, 32767)
        planes_zz.append(qz.reshape(-1, 64)[:, ZIGZAG])
    mcus_y, mcus_x = y.shape[0] // 16, y.shape[1] // 16
    # MCU interleave order: 4 Y blocks, then Cb, then Cr
    order = []
    for my in range(mcus_y):
        for mx in range(mcus_x):
            for vi in range(2):
                for hi in range(2):
                    order.append((0, (my * 2 + vi) * nbx + mx * 2 + hi))
            order.append((1, my * (nbx // 2) + mx))
            order.append((2, my * (nbx // 2) + mx))
    ymaps = (HuffmanTable(Y_DC_COUNT, Y_DC_SYM).encode_map(),
             HuffmanTable(Y_AC_COUNT, Y_AC_SYM).encode_map())
    cmaps = (HuffmanTable(UV_DC_COUNT, UV_DC_SYM).encode_map(),
             HuffmanTable(UV_AC_COUNT, UV_AC_SYM).encode_map())
    w = BitWriter(MSB, stuff_jpeg=True)
    _encode_blocks_entropy(w, planes_zz, order, [ymaps, cmaps, cmaps])
    w.align_byte(fill=1)

    out = bytearray(b"\xff\xd8")                                  # SOI
    out += b"\xff\xe0" + struct.pack(">H", 16) + b"JFIF\x00" + \
        bytes([1, 1, 0]) + struct.pack(">HH", 1, 1) + bytes([0, 0])
    for tid, q in ((0, yq), (1, cq)):
        out += b"\xff\xdb" + struct.pack(">HB", 67, tid) + \
            bytes(int(x) for x in q.reshape(-1)[ZIGZAG])
    out += b"\xff\xc0" + struct.pack(">HBHHB", 17, 8, h, wd, 3)
    out += bytes([1, 0x22, 0]) + bytes([2, 0x11, 1]) + bytes([3, 0x11, 1])
    for tc, tid, cnt, sym in ((0, 0, Y_DC_COUNT, Y_DC_SYM),
                              (1, 0, Y_AC_COUNT, Y_AC_SYM),
                              (0, 1, UV_DC_COUNT, UV_DC_SYM),
                              (1, 1, UV_AC_COUNT, UV_AC_SYM)):
        out += b"\xff\xc4" + struct.pack(">HB", 19 + len(sym), (tc << 4) | tid)
        out += bytes(cnt) + bytes(sym)
    out += b"\xff\xda" + struct.pack(">HB", 12, 3)
    out += bytes([1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    out += bytes(w.buf)
    out += b"\xff\xd9"                                            # EOI
    return bytes(out)


def synth_jpeg_420(h: int, w: int, quality: int, seed: int) -> bytes:
    """Baseline 4:2:0 JPEG of ``synth_rgb(h, w, seed)`` at ``quality``."""
    return encode_420(synth_rgb(h, w, seed), quality)
