"""The baseline 4:2:0 JPEG encoder of the port.

Copied from ``ffpic_tpu/formats/jpg_encode.py`` (the ITU-T81 K.1-K.6
quant and Huffman tables, ``_vlc_size``, ``_scale_quant``,
``_rgb_to_yuv420``, ``_to_blocks``, ``_encode_blocks_entropy`` at
``:25-150``, and ``encode_baseline`` at ``:153-224``), with
``HuffmanTable.encode_map`` (``ffpic_tpu/coding/huffman.py``) as
``encode_map`` and the MSB-first JPEG ``BitWriter``
(``ffpic_tpu/utils/bitstream.py``).  The bytes are the original's; the
bit writer and the block loop are rewritten to take whole codes and
plain lists rather than a bit and a numpy scalar at a time.

``encode_baseline`` keeps the colour transform on the host (numpy f32)
and hands the three planes' blocks to ``encode_blocks``, which stages
them to the device in one copy, runs the forward DCT there (K5 on the
card, ``ops.jpeg_kernels.forward_dct`` on the CPU) in one launch over
all of them, and brings the coefficients back for numpy's rounding of
``f / q``, the Huffman coder and the container.  ``encode_blocks``
takes any sampling, per-component tables and a restart interval, so
``testing.encode_jpeg`` writes its other samplings through it too.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ffpic_tpu_torch.formats.pic import Pic
from ffpic_tpu_torch.ops.golden import ZIGZAG
from ffpic_tpu_torch.ops.jpeg_kernels import fdct_blocks
from ffpic_tpu_torch.utils.device import resolve_device, to_device
from ffpic_tpu_torch.utils.trace import stage


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
        self.cur = 0          # the pending bits, fewer than 8
        self.curbits = 0

    def write_bits(self, value: int, n: int) -> None:
        """Append the low ``n`` bits of ``value``, most significant first."""
        cur = (self.cur << n) | (value & ((1 << n) - 1))
        nbits = self.curbits + n
        while nbits >= 8:
            nbits -= 8
            byte = (cur >> nbits) & 0xFF
            self.buf.append(byte)
            if byte == 0xFF:
                self.buf.append(0x00)
        self.cur = cur & ((1 << nbits) - 1)
        self.curbits = nbits

    def align_byte(self, fill: int = 1) -> None:
        """Pad to a byte boundary. JPEG pads with 1-bits."""
        if self.curbits:
            k = 8 - self.curbits
            self.write_bits((1 << k) - 1 if fill else 0, k)


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


def _encode_blocks_entropy(w: BitWriter, blocks_zz: list,
                           order: list[tuple[int, int]],
                           enc_maps: list) -> None:
    """order: sequence of (plane_idx, block_idx); blocks_zz: list of
    per-plane (n, 64) zigzag-quantized int arrays.  DC predictions start
    at 0."""
    pred = [0] * len(blocks_zz)
    for pi, bi in order:
        blk = blocks_zz[pi][bi].tolist()
        dc_map, ac_map = enc_maps[pi]
        diff = blk[0] - pred[pi]
        pred[pi] = blk[0]
        s = _vlc_size(diff)
        code, ln = dc_map[s]
        w.write_bits(code, ln)
        if s:
            w.write_bits(diff if diff >= 0 else (1 << s) + diff - 1, s)
        last_nz = 63
        while last_nz and not blk[last_nz]:
            last_nz -= 1
        run = 0
        for k in range(1, last_nz + 1):
            v = blk[k]
            if not v:
                run += 1
                continue
            while run >= 16:
                code, ln = ac_map[0xF0]
                w.write_bits(code, ln)
                run -= 16
            s = _vlc_size(v)
            code, ln = ac_map[(run << 4) | s]
            w.write_bits(code, ln)
            w.write_bits(v if v >= 0 else (1 << s) + v - 1, s)
            run = 0
        if last_nz != 63:
            code, ln = ac_map[0x00]
            w.write_bits(code, ln)


def _huffman_maps():
    """(DC, AC) encode maps of the luma and the chroma tables."""
    return ((encode_map(Y_DC_COUNT, Y_DC_SYM),
             encode_map(Y_AC_COUNT, Y_AC_SYM)),
            (encode_map(UV_DC_COUNT, UV_DC_SYM),
             encode_map(UV_AC_COUNT, UV_AC_SYM)))


def _mcu_order(sampling, mcus_x: int, mcus_y: int) -> list[list]:
    """Per MCU, its blocks in interleave order as (component, block
    index): each component's v x h blocks raster within the MCU, for
    components with (h, v) sampling factors ``sampling``."""
    mcus = []
    for my in range(mcus_y):
        for mx in range(mcus_x):
            mcu = []
            for c, (h, v) in enumerate(sampling):
                nbx = mcus_x * h
                for vi in range(v):
                    for hi in range(h):
                        mcu.append((c, (my * v + vi) * nbx + mx * h + hi))
            mcus.append(mcu)
    return mcus


def _container(height: int, width: int, sampling, tables: dict, tq,
               scan: bytes, restart_interval: int = 0) -> bytes:
    """A baseline JPEG around one interleaved ``scan``: SOI, JFIF APP0,
    a DQT per table id of ``tables`` ((8, 8) raster each), SOF0 with
    the components' (h, v) ``sampling`` and table ids ``tq``, the K.3-K.6
    Huffman tables (luma ones only for one component), DRI when
    ``restart_interval``, SOS (luma on tables 0, chroma on 1), EOI."""
    ncomp = len(sampling)
    out = bytearray(b"\xff\xd8")                                  # SOI
    out += b"\xff\xe0" + struct.pack(">H", 16) + b"JFIF\x00" + \
        bytes([1, 1, 0]) + struct.pack(">HH", 1, 1) + bytes([0, 0])
    for tid, q in tables.items():
        out += b"\xff\xdb" + struct.pack(">HB", 67, tid) + \
            bytes(int(x) for x in q.reshape(-1)[ZIGZAG])
    out += b"\xff\xc0" + struct.pack(">HBHHB", 8 + 3 * ncomp, 8, height,
                                     width, ncomp)
    for c, (h, v) in enumerate(sampling):
        out += bytes([c + 1, (h << 4) | v, tq[c]])
    dht = [(0, 0, Y_DC_COUNT, Y_DC_SYM), (1, 0, Y_AC_COUNT, Y_AC_SYM)]
    if ncomp > 1:
        dht += [(0, 1, UV_DC_COUNT, UV_DC_SYM), (1, 1, UV_AC_COUNT, UV_AC_SYM)]
    for tc, tid, cnt, sym in dht:
        out += b"\xff\xc4" + struct.pack(">HB", 19 + len(sym), (tc << 4) | tid)
        out += bytes(cnt) + bytes(sym)
    if restart_interval:
        out += b"\xff\xdd" + struct.pack(">HH", 4, restart_interval)
    out += b"\xff\xda" + struct.pack(">HB", 6 + 2 * ncomp, ncomp)
    for c in range(ncomp):
        out += bytes([c + 1, 0x00 if c == 0 else 0x11])
    out += bytes([0, 63, 0]) + bytes(scan) + b"\xff\xd9"          # EOI
    return bytes(out)


def encode_blocks(blocks, height: int, width: int, sampling, tables: dict,
                  tq, device: torch.device,
                  restart_interval: int = 0) -> bytes:
    """Baseline JPEG of level-shifted int16 samples: ``blocks`` holds
    each component's MCU-padded (nby, nbx, 8, 8) grid for its (h, v)
    ``sampling``.  One staged copy and one forward DCT on ``device``
    over all of them, numpy's rounding of ``f / q`` with component c's
    table ``tables[tq[c]]``, zigzag, one interleaved Huffman scan (luma
    tables for component 0, chroma ones for the others) with an RSTn
    every ``restart_interval`` MCUs, and ``_container``."""
    with stage("torch.jpg_encode.fdct"):
        staged = to_device(np.concatenate(
            [b.reshape(-1, 8, 8) for b in blocks]), device)
        f = fdct_blocks(staged).cpu().numpy().astype(np.int32)
    planes_zz, off = [], 0
    for b, t in zip(blocks, tq):
        n = b.shape[0] * b.shape[1]
        qz = np.round(f[off:off + n] / tables[t])     # round-half-even ok
        qz = np.clip(qz.astype(np.int32), -32768, 32767)
        # raster -> zigzag ordering: zz[k] = raster[ZIGZAG[k]]
        planes_zz.append(qz.reshape(-1, 64)[:, ZIGZAG])
        off += n

    mcus = _mcu_order(sampling, blocks[0].shape[1] // sampling[0][0],
                      blocks[0].shape[0] // sampling[0][1])
    ymaps, cmaps = _huffman_maps()
    maps = [ymaps] + [cmaps] * (len(blocks) - 1)
    step = restart_interval or len(mcus)
    with stage("torch.jpg_encode.entropy"):
        w = BitWriter()
        for k, first in enumerate(range(0, len(mcus), step)):
            if k:                               # RSTn, DC predictions reset
                w.align_byte(fill=1)
                w.buf += bytes([0xFF, 0xD0 + (k - 1) % 8])
            _encode_blocks_entropy(w, planes_zz,
                                   [blk for m in mcus[first:first + step]
                                    for blk in m], maps)
        w.align_byte(fill=1)
    return _container(height, width, sampling, tables, tq, w.buf,
                      restart_interval)


def encode_baseline(pic: Pic, quality: int | None = None,
                    device=None) -> bytes:
    """Baseline 4:2:0 JPEG of ``pic`` at ``quality`` (None: the K.1/K.2
    tables as they are), the forward DCT on ``device`` (None: CUDA)."""
    dev = resolve_device(device, "encode")
    rgba = pic.to_rgba32()
    h, wd = rgba.shape[:2]
    with stage("torch.jpg_encode.color"):
        planes = _rgb_to_yuv420(rgba)[:3]
    tables = {0: _scale_quant(Y_QUANT, quality).reshape(8, 8),
              1: _scale_quant(UV_QUANT, quality).reshape(8, 8)}
    return encode_blocks([_to_blocks(p) for p in planes], h, wd,
                         ((2, 2), (1, 1), (1, 1)), tables, (0, 1, 1), dev)
