"""Tables and host helpers of the baseline 4:2:0 JPEG encoder.

Copied from ``ffpic_tpu/formats/jpg_encode.py:25-150`` (the ITU-T81
K.1-K.6 quant and Huffman tables, ``_vlc_size``, ``_scale_quant``,
``_rgb_to_yuv420``, ``_to_blocks``, ``_encode_blocks_entropy``), with
``HuffmanTable.encode_map`` (``ffpic_tpu/coding/huffman.py``) as
``encode_map`` and the MSB-first ``BitWriter``
(``ffpic_tpu/utils/bitstream.py``), so that ``ffpic_tpu_torch.testing``
can write JPEGs without the JAX package.  The forward DCT is
``ops.golden.fdct8x8``.
"""

from __future__ import annotations

import numpy as np


def encode_map(counts, symbols) -> dict[int, tuple[int, int]]:
    """Canonical Huffman code (ITU-T81 Annex C) of DHT-style counts per
    length 1..16 and symbols: symbol -> (code, bitlen)."""
    if len(counts) != 16 or sum(counts) != len(symbols):
        raise ValueError("need 16 length counts that sum to the symbols")
    out = {}
    code = 0
    k = 0
    for bitlen in range(1, 17):
        for _ in range(counts[bitlen - 1]):
            out[symbols[k]] = (code, bitlen)
            code += 1
            k += 1
        code <<= 1
    return out


class BitWriter:
    """Growable MSB-first bit writer that inserts a 0x00 after every
    emitted 0xFF byte (JPEG entropy-stream stuffing)."""

    __slots__ = ("buf", "cur", "curbits")

    def __init__(self):
        self.buf = bytearray()
        self.cur = 0
        self.curbits = 0

    def write_bits(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.cur = (self.cur << 1) | ((value >> i) & 1)
            self.curbits += 1
            if self.curbits == 8:
                self.buf.append(self.cur)
                if self.cur == 0xFF:
                    self.buf.append(0x00)
                self.cur = 0
                self.curbits = 0

    def align_byte(self, fill: int = 1) -> None:
        """Pad to a byte boundary. JPEG pads with 1-bits."""
        while self.curbits:
            self.write_bits(fill, 1)


# ITU-T81 K.1 / K.2 (jpg.c:988-998)
Y_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], np.int32)
UV_QUANT = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
], np.int32)

# ITU-T81 K.3-K.6 (jpg.c:155-198)
Y_DC_COUNT = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
Y_DC_SYM = list(range(12))
Y_AC_COUNT = [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125]
Y_AC_SYM = [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa]
UV_DC_COUNT = [0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]
UV_DC_SYM = list(range(12))
UV_AC_COUNT = [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119]
UV_AC_SYM = [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa]


def _vlc_size(v: int) -> int:
    """encode_vlc (jpg.c:231-245): bit length of |v|."""
    return int(abs(v)).bit_length()


def _scale_quant(tbl: np.ndarray, quality: int | None) -> np.ndarray:
    if quality is None:
        return tbl.copy()
    quality = min(max(quality, 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((tbl * scale + 50) // 100, 1, 255).astype(np.int32)


def _rgb_to_yuv420(rgba: np.ndarray):
    """RGB -> level-shifted YUV with 2x2-averaged chroma; pads to 16."""
    h, w = rgba.shape[:2]
    H = (h + 15) & ~15
    W = (w + 15) & ~15
    img = np.pad(rgba[..., :3].astype(np.float32),
                 ((0, H - h), (0, W - w), (0, 0)), mode="edge")
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b - 128.0
    u = -0.16874 * r - 0.33126 * g + 0.5 * b
    v = 0.5 * r - 0.41869 * g - 0.08131 * b
    u = u.reshape(H // 2, 2, W // 2, 2).mean(axis=(1, 3))
    v = v.reshape(H // 2, 2, W // 2, 2).mean(axis=(1, 3))
    toi = lambda x: np.round(x).astype(np.int16)
    return toi(y), toi(u), toi(v), H, W


def _to_blocks(plane: np.ndarray) -> np.ndarray:
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _encode_blocks_entropy(w: BitWriter, blocks_zz: np.ndarray,
                           order: list[tuple[int, int]],
                           enc_maps: list) -> None:
    """order: sequence of (plane_idx, block_idx); blocks_zz: list of
    per-plane (n, 64) zigzag-quantized int arrays."""
    pred = [0] * len(blocks_zz)
    for pi, bi in order:
        blk = blocks_zz[pi][bi]
        dc_map, ac_map = enc_maps[pi]
        diff = int(blk[0]) - pred[pi]
        pred[pi] = int(blk[0])
        s = _vlc_size(diff)
        code, ln = dc_map[s]
        w.write_bits(code, ln)
        if s:
            w.write_bits(diff if diff >= 0 else (1 << s) + diff - 1, s)
        nz = np.nonzero(blk[1:])[0]
        last_nz = nz[-1] + 1 if len(nz) else 0
        k = 1
        while k <= last_nz:
            run = 0
            while blk[k] == 0:
                run += 1
                k += 1
            while run >= 16:
                code, ln = ac_map[0xF0]
                w.write_bits(code, ln)
                run -= 16
            v = int(blk[k])
            s = _vlc_size(v)
            code, ln = ac_map[(run << 4) | s]
            w.write_bits(code, ln)
            w.write_bits(v if v >= 0 else (1 << s) + v - 1, s)
            k += 1
        if last_nz != 63:
            code, ln = ac_map[0x00]
            w.write_bits(code, ln)
