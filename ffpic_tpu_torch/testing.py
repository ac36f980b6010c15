"""Synthetic baseline 4:2:0 JPEGs made from a seed, without jax or PIL.

``encode_420`` writes what ``ffpic_tpu.formats.jpg_encode.encode_baseline``
writes (same colour transform, 13-bit forward DCT, quantisation, ITU-T81
K.3-K.6 Huffman tables and container), with the port's own copies of
the encoder's tables and helpers (``formats.jpg_encode``) and
``golden.fdct8x8`` in place of the jax ``fdct_blocks``; the two agree
bit for bit.  ``chip_smoke.py`` and the tests use it to make inputs on
machines that have neither jax nor PIL.  The entropy coder is Python:
about 4 s for one 1080p image.

``scan_cases``, ``unpack_cases``, ``idct_cases`` and ``assemble_cases``
make the inputs at the edges of the ``count_scan``, ``unpack``,
``dequant_idct`` and ``assemble_color`` kernels' tiling that the tests
(plain versions) and ``chip_smoke.py`` (kernels) both run.
``idct_evenodd`` is a model of the ``dequant_idct`` kernel's arithmetic.
"""

from __future__ import annotations

import struct

import numpy as np

from ffpic_tpu_torch.formats.jpg_encode import (
    UV_AC_COUNT, UV_AC_SYM, UV_DC_COUNT, UV_DC_SYM, UV_QUANT, Y_AC_COUNT,
    Y_AC_SYM, Y_DC_COUNT, Y_DC_SYM, Y_QUANT, BitWriter,
    _encode_blocks_entropy, _rgb_to_yuv420, _scale_quant, _to_blocks,
    encode_map)
from ffpic_tpu_torch.ops.golden import ZIGZAG, fdct8x8


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
    ymaps = (encode_map(Y_DC_COUNT, Y_DC_SYM),
             encode_map(Y_AC_COUNT, Y_AC_SYM))
    cmaps = (encode_map(UV_DC_COUNT, UV_DC_SYM),
             encode_map(UV_AC_COUNT, UV_AC_SYM))
    w = BitWriter()
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


def scan_cases(seed: int = 0) -> dict[str, tuple]:
    """Counts at the edges of K1a's cut (each image's 16-byte words in 8
    runs, one per CTA of a cluster, 512 words a CTA pass), as name ->
    (counts u8 of n*g bytes, n, g):

    * ``g6_n1``/``g6_n3``: a 16x16 image (g=6), fewer words than CTAs;
      with N=3 three rows share one 16-byte word;
    * ``unaligned_n3``: g=4998, not a multiple of 16, so rows start
      inside words;
    * ``all255_n3`` and ``all0_n1``: every count 255, every count 0;
    * ``loop_n1``: a 4000x3000 image (g=282000), 35,250 counts a CTA,
      so each CTA loops 5 passes with a running carry;
    * ``loop255_n3``: g=70002 of 255s, two passes a CTA."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, n, g, hi in (("g6_n1", 1, 6, 65), ("g6_n3", 3, 6, 65),
                           ("unaligned_n3", 3, 4998, 65),
                           ("all255_n3", 3, 1002, None),
                           ("all0_n1", 1, 1200, 0),
                           ("loop_n1", 1, 282000, 41),
                           ("loop255_n3", 3, 70002, None)):
        if hi is None:
            counts = np.full(n * g, 255, np.uint8)
        elif hi == 0:
            counts = np.zeros(n * g, np.uint8)
        else:
            counts = rng.integers(0, hi, n * g).astype(np.uint8)
        out[name] = (counts, n, g)
    return out


def unpack_cases(seed: int = 0) -> dict[str, tuple]:
    """Packed buffers at the edges of K1b's tiling (tiles of 64 packed
    blocks), as name -> (buf u8, n, g, e, block_map i32):

    * ``mcu_n1``/``mcu_n3``: a 4:2:0 MCU walk of 70 MCUs (g=420), so
      tile boundaries fall inside MCUs and the last tile holds 36 blocks;
    * ``full_block``: one block with all 64 positions, the last tile 2
      blocks;
    * ``one_block``: each image's nonzeros all in one block (the first
      of a tile, the last of a tile, the last block);
    * ``hostile``: an odd vals offset (n*(g+e) odd), counts up to 255
      that run past E, zigzag positions past 63, nonzero padding past
      the counts' total, a shuffled block map;
    * ``dense``: 200 nonzeros a block, so each tile stages 12800
      entries in several passes."""
    from ffpic_tpu_torch.formats.jpg import mcu_block_map
    from ffpic_tpu_torch.ops.jpeg_kernels import stack_packed_fused
    rng = np.random.default_rng(seed)
    out = {}

    def case(name, counts, bmap, ks=None):
        totals = counts.astype(np.int64).sum(1)
        packed = []
        for c, nnz in zip(counts, totals):
            k = ks if ks is not None else rng.integers(0, 64, nnz)
            v = rng.integers(-32768, 32768, nnz)
            packed.append((c, k.astype(np.uint8), v.astype(np.int16), nnz))
        buf, g, e = stack_packed_fused(packed)
        out[name] = (buf, len(counts), g, e, bmap)

    mcu_map = mcu_block_map(((2, 2), (1, 1), (1, 1)), 14, 5)
    for n in (1, 3):
        case(f"mcu_n{n}", rng.integers(0, 20, (n, 420)).astype(np.uint8),
             mcu_map)
    counts = rng.integers(0, 6, (1, 130)).astype(np.uint8)
    counts[0, 70] = 64
    ks = rng.integers(0, 64, int(counts.astype(np.int64).sum()))
    s70 = int(counts[0, :70].astype(np.int64).sum())
    ks[s70:s70 + 64] = rng.permutation(64)
    case("full_block", counts, rng.permutation(130).astype(np.int32), ks)
    counts = np.zeros((3, 200), np.uint8)
    counts[[0, 1, 2], [64, 127, 199]] = 255
    case("one_block", counts, np.arange(200, dtype=np.int32))
    n, g, e = 3, 1001, 2048
    junk = rng.integers(0, 256, n * (g + 3 * e)).astype(np.uint8)
    junk[:n * g] = rng.integers(0, 5, n * g)
    junk[[7, 500, 1500]] = 255
    out["hostile"] = (junk, n, g, e, rng.permutation(g).astype(np.int32))
    case("dense", np.full((1, 300), 200, np.uint8),
         rng.permutation(300).astype(np.int32))
    return out


def assemble_cases(seed: int = 0) -> dict[str, tuple]:
    """int16 sample grids at the edges of K3's tiling (4 luma blocks a
    warp, 16 a CTA along a block row), as name -> (samples (n, nblocks,
    8, 8) i16, nby, nbx, (h, w)): N=1 and N=3, a grid whose width is
    not a whole number of CTAs, crops that end inside a block, rows of
    a width that is not a multiple of 4 pixels (not 16-byte aligned),
    and a 1x1 image."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, n, nby, nbx, hw in (("n1_full", 1, 4, 6, (32, 48)),
                                  ("n3_crop_unaligned", 3, 6, 36, (41, 283)),
                                  ("n1_crop_aligned", 1, 2, 34, (9, 268)),
                                  ("n3_one_pixel", 3, 2, 2, (1, 1))):
        nblocks = nby * nbx + 2 * (nby // 2) * (nbx // 2)
        samples = rng.integers(-32768, 32768, (n, nblocks, 8, 8))
        samples[:, :, ::2] %= 300            # half the rows near [0, 255]
        out[name] = (samples.astype(np.int16), nby, nbx, hw)
    return out


def idct_cases(seed: int = 0) -> dict[str, tuple]:
    """Coefficients at the edges of K2's tiles (32 blocks of one image a
    CTA), as name -> (coeffs (n, nblocks, 8, 8) i16, yquant (n, 64) i32,
    cquant (n, 64) i32, n_luma): nblocks not a multiple of 32 (6, 33,
    4099), the luma/chroma boundary at 0, at nblocks and at 32k +- 1,
    N=1 and N=3 with a distinct pair of tables per image.  Coefficients
    span all of int16 and tables 1..65535, so products and sums wrap."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, n, nb, n_luma in (("b6_n1", 1, 6, 4), ("b33_l0_n3", 3, 33, 0),
                                ("b33_lall_n3", 3, 33, 33),
                                ("b33_l31_n1", 1, 33, 31),
                                ("b4099_l4095_n3", 3, 4099, 4095),
                                ("b4099_l4097_n1", 1, 4099, 4097)):
        coeffs = rng.integers(-32768, 32768, (n, nb, 8, 8)).astype(np.int16)
        yq, cq = rng.integers(1, 65536, (2, n, 64)).astype(np.int32)
        out[name] = (coeffs, yq, cq, n_luma)
    return out


def idct_evenodd(coeffs, yquant, cquant, n_luma: int):
    """Dequant + IDCT in the grouping of the ``dequant_idct`` kernel:
    the even/odd split of each 8-point pass, every sum wrapped to 32
    bits as the kernel's uint32 arithmetic wraps it.  Same arguments and
    result as ``ops.jpeg_kernels.dequant_idct_blocks``; torch, int64."""
    import torch
    from ffpic_tpu_torch.ops.jpeg_kernels import _wrap

    def m(v):                                   # uint32 wrap
        return v & 0xFFFFFFFF

    def idct8(x):
        a, b = m((x[0] + x[4]) * 8192), m((x[0] - x[4]) * 8192)
        p = m(10703 * x[2] + 4433 * x[6])
        q = m(4433 * x[2] - 10704 * x[6])
        e = (m(a + p), m(b + q), m(b - q), m(a - p))
        o = (m(11363 * x[1] + 9633 * x[3] + 6437 * x[5] + 2260 * x[7]),
             m(9633 * x[1] - 2259 * x[3] - 11362 * x[5] - 6436 * x[7]),
             m(6437 * x[1] - 11362 * x[3] + 2261 * x[5] + 9633 * x[7]),
             m(2260 * x[1] - 6436 * x[3] + 9633 * x[5] - 11363 * x[7]))
        y = [None] * 8
        for i in range(4):
            y[i], y[7 - i] = m(e[i] + o[i]), m(e[i] - o[i])
        return y

    n, nb = coeffs.shape[:2]
    luma = (torch.arange(nb, device=coeffs.device) < n_luma)[None, :, None,
                                                             None]
    q = torch.where(luma, yquant.view(n, 1, 8, 8), cquant.view(n, 1, 8, 8))
    x = _wrap(coeffs.to(torch.int64) * q.to(torch.int64), 16)
    col = idct8([x[..., u, :] for u in range(8)])            # over rows
    col = torch.stack([_wrap(_wrap(c + (1 << 10), 32) >> 11, 16)
                       for c in col], dim=-2)
    row = idct8([col[..., u] for u in range(8)])             # over columns
    out = torch.stack([(_wrap(r + (257 << 17), 32) >> 18).clamp(0, 65535)
                       for r in row], dim=-1)
    return _wrap(out, 16).to(torch.int16)
