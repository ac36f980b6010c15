"""Synthetic JPEGs and PNGs made from a seed, without jax or PIL,
committed WebP fixtures, and the kernel edge cases that the tests and
``chip_smoke.py`` share.

* ``synth_rgb`` makes photo-like content; ``synth_jpeg_420`` encodes it
  with the port's ``encode_baseline`` (the bytes of
  ``ffpic_tpu.encode``), the forward DCT on the CPU;
* ``encode_jpeg`` is a general baseline writer: per-component (h, v)
  sampling factors, 1 or 3 components, a separate Cr quant table and
  an optional restart interval, so that machines without PIL can make
  4:4:4, 4:2:2, 4:4:0, 4:1:1, gray and DRI files.  It builds the
  planes and hands them to ``formats.jpg_encode.encode_blocks``, the
  step ``encode_baseline`` ends with, on the CPU;
* ``encode_png`` is a general PNG writer: every colour type and bit
  depth, chosen filters per row, Adam7, palette, tRNS and extra chunks;
* ``encode_tiff`` (none, PackBits, deflate, LZW with or without
  predictor 2, JPEG strips or tiles with shared JPEGTables; strips or
  tiles, pages, both byte orders), ``encode_bmp`` (24, 32 and 16 bpp,
  bitfields, either row order), ``encode_bmp_palette`` (1, 4, 8 bpp,
  RLE8, RLE4), ``encode_tga`` (RLE or raw), ``encode_psd`` (RLE or raw)
  and ``encode_ico`` (BMP and PNG entries) write the host codecs' files
  that the port's encoders do not, with ``packbits``,
  ``lzw_encode_tiff`` and ``quantize_332``;
* ``entropy_cases`` makes JPEG batches at the edges of the device
  Huffman decode (K9-K11), and ``entropy_stages`` runs one through
  the kernels or the plain versions;
* ``webp_fixture`` reads the committed WebP files of ``testdata/``
  (``make_webp_fixtures`` wrote them with PIL); ``vp8_cases`` makes the
  inputs at the edges of the ``vp8_residuals`` and ``vp8_yuv_to_rgba``
  kernels (K12, K13), with ``vp8_dq`` a segment's dequant factors;
* ``avif_fixture`` and ``avif_manifest`` read the committed AVIF files
  and their hashes (``make_avif_fixtures``);
* ``still_fixture`` reads the committed JPEG 2000 and OpenEXR files
  (``make_still_fixtures``); ``svg_still`` writes an SVG with paths,
  curves, gradients and opacity at any size, ``bpg_header`` a BPG
  file's header;
* ``heif_fixture`` reads the committed 12 MP grid HEIC
  (``make_heif_fixtures``); ``hevc_stream`` writes an HEVC intra
  picture of any of ``HEVC_STREAMS`` with the port's encoder,
  ``heif_item`` wraps one in a HEIC, ``heif_cases`` makes the small
  HEICs the card's run decodes; ``hevc_cases``, ``heif_color_cases``
  and ``heif_tile_layouts`` make the inputs at the edges of the
  ``hevc_residuals`` and ``hevc_yuv_to_rgba`` kernels (K14, K15: a
  tile's planes, and a canvas's tiles);
* ``scan_cases``, ``unpack_cases``, ``idct_cases``, ``assemble_cases``,
  ``mcu_cases``, ``scatter_cases``, ``unfilter_cases`` and
  ``rgba_cases`` make the inputs at the edges of the ``count_scan``,
  ``unpack``, ``dequant_idct``, ``assemble_color``, ``assemble_mcu``,
  ``scatter_plane``, ``unfilter_subup`` and ``assemble_rgba`` kernels;
* ``idct_evenodd`` and ``assemble_mcu_gather`` model the arithmetic and
  indexing of the ``dequant_idct`` and ``assemble_mcu`` kernels;
* ``unfused_colour`` and ``assert_equal_up_to_contraction`` hold a
  colour result to JAX's up to XLA's choice of contracting the colour
  products into FMAs;
* ``resize_cases`` and ``normalize_cases`` make the inputs at the edges
  of the ``resize_rgba`` and ``normalize_resize`` kernels (K16, K17);
  ``config5_members`` the mixed JPEG, PNG and WebP batch of BASELINE
  config 5.
"""

from __future__ import annotations

import contextlib
import json
import struct
import zlib

import numpy as np
import torch

from ffpic_tpu_torch.formats import png
from ffpic_tpu_torch.formats.jpg_encode import (
    UV_QUANT, Y_QUANT, _scale_quant, _to_blocks, encode_baseline,
    encode_blocks)
from ffpic_tpu_torch.formats.pic import Pic
from ffpic_tpu_torch.ops import jpeg_kernels
from ffpic_tpu_torch.ops.jpeg_kernels import _wrap


def _unfused(a: float, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``c + a*x`` in f32 with two roundings: the product, then the sum."""
    return c.to(torch.float32) + x.to(torch.float32) * float(np.float32(a))


@contextlib.contextmanager
def unfused_colour():
    """Within the block, the plain ``color_convert`` rounds each product
    to f32 before adding it, instead of one fused multiply-add: the
    colour of eager JAX, and of the jits in which XLA does not contract
    (``decode_batch_420`` and ``decode_mcu_planes`` on some machines).
    It swaps the module's ``_fma`` for the whole process; the kernels
    keep the fused form."""
    fused = jpeg_kernels._fma
    jpeg_kernels._fma = _unfused
    try:
        yield
    finally:
        jpeg_kernels._fma = fused


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_equal_up_to_contraction(run, want) -> None:
    """Call ``run()`` (which returns an array or tensor of colour
    results) once as it is, with fused colour, and once under
    ``unfused_colour()``; assert that each element of ``want`` equals
    the same element of one of the two.  Where the two roundings agree
    this is an exact comparison; where they differ, JAX's value under
    either is accepted, and nothing else."""
    want = _host(want)
    fused = _host(run())
    with unfused_colour():
        unfused = _host(run())
    if fused.shape != want.shape or unfused.shape != want.shape:
        raise AssertionError(f"shape {fused.shape} / {unfused.shape} != "
                             f"{want.shape}")
    bad = (want != fused) & (want != unfused)
    if bad.any():
        at = tuple(int(i[0]) for i in np.nonzero(bad))
        raise AssertionError(
            f"{int(bad.sum())} of {bad.size} elements equal neither "
            f"rounding; first at {at}: want {want[at]}, fused {fused[at]}, "
            f"unfused {unfused[at]}")


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


def psnr(got, want) -> float:
    """PSNR in dB of two uint8 arrays (numpy or tensors) of one shape."""
    got = np.asarray(got.cpu() if hasattr(got, "cpu") else got, np.float64)
    want = np.asarray(want.cpu() if hasattr(want, "cpu") else want,
                      np.float64)
    if got.shape != want.shape:
        raise ValueError(f"shape {got.shape} != {want.shape}")
    mse = float(np.mean((got - want) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255 ** 2 / mse)


def synth_jpeg_420(h: int, w: int, quality: int, seed: int) -> bytes:
    """Baseline 4:2:0 JPEG of ``synth_rgb(h, w, seed)`` at ``quality``,
    as ``ffpic_tpu.encode`` writes it."""
    return encode_baseline(Pic(pixels=synth_rgb(h, w, seed), width=w,
                               height=h), quality, device="cpu")


def encode_jpeg(pixels: np.ndarray, quality: int | None = None,
                sampling=((2, 2), (1, 1), (1, 1)),
                cr_quality: int | None = None,
                restart_interval: int = 0) -> bytes:
    """Baseline JPEG of ``pixels``: (h, w, 3 or 4) uint8 RGB(A), or (h,
    w) uint8 gray.  ``sampling`` is each component's (h, v) factor pair
    (one pair for gray, which must be (1, 1)); the factors must divide
    the largest.  Chroma is the mean over each component's sampling
    cell of the full-resolution YCbCr (the colour transform of
    ``_rgb_to_yuv420``), the image padded by edge replication to whole
    MCUs.  ``cr_quality`` gives Cr a quant table of its own (id 2);
    ``restart_interval`` > 0 writes DRI and an RSTn marker every that
    many MCUs.  For 4:2:0 without them, the bytes are
    ``encode_baseline``'s."""
    gray = pixels.ndim == 2
    sampling = tuple(tuple(s) for s in sampling)
    if len(sampling) != (1 if gray else 3) or (gray and sampling != ((1, 1),)):
        raise ValueError(f"sampling {sampling} for "
                         f"{'gray' if gray else 'colour'} pixels")
    h, w = pixels.shape[:2]
    hmax = max(a for a, _ in sampling)
    vmax = max(b for _, b in sampling)
    if any(hmax % a or vmax % b for a, b in sampling):
        raise ValueError(f"sampling {sampling}: factors must divide the "
                         "largest")
    mcus_x, mcus_y = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    ph, pw = mcus_y * 8 * vmax, mcus_x * 8 * hmax
    img = np.pad(pixels.astype(np.float32),
                 ((0, ph - h), (0, pw - w)) + ((0, 0),) * (pixels.ndim - 2),
                 mode="edge")
    if gray:
        full = [img - 128.0]
    else:
        r, g, b = img[..., 0], img[..., 1], img[..., 2]
        full = [0.299 * r + 0.587 * g + 0.114 * b - 128.0,
                -0.16874 * r - 0.33126 * g + 0.5 * b,
                0.5 * r - 0.41869 * g - 0.08131 * b]
    blocks = []
    for plane, (a, b) in zip(full, sampling):
        fy, fx = vmax // b, hmax // a
        plane = plane.reshape(ph // fy, fy, pw // fx, fx).mean(axis=(1, 3))
        blocks.append(_to_blocks(np.round(plane).astype(np.int16)))
    tables = {0: _scale_quant(Y_QUANT, quality).reshape(8, 8)}
    tq = [0]
    if not gray:
        tables[1] = _scale_quant(UV_QUANT, quality).reshape(8, 8)
        tq += [1, 1]
        if cr_quality is not None:
            tables[2] = _scale_quant(UV_QUANT, cr_quality).reshape(8, 8)
            tq[2] = 2
    return encode_blocks(blocks, h, w, sampling, tables, tq,
                         torch.device("cpu"), restart_interval)


def _png_filter(x: np.ndarray, prev: np.ndarray, ft: int,
                bpp: int) -> np.ndarray:
    """One row's bytes (int32) filtered with type ``ft`` against the row
    above ``prev``: the inverse of each filter of the decoder."""
    a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])[:len(x)]
    c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])[:len(x)]
    if ft == 0:
        pred = 0
    elif ft == 1:
        pred = a
    elif ft == 2:
        pred = prev
    elif ft == 3:
        pred = (a + prev) >> 1
    elif ft == 4:
        p = a + prev - c
        pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a,
                        np.where(pb <= pc, prev, c))
    else:
        raise ValueError(f"filter {ft}")
    return (x - pred) & 255


def _png_rows(samples: np.ndarray, bitdepth: int) -> np.ndarray:
    """(h, n) samples -> (h, stride) packed bytes: 16-bit big-endian,
    1/2/4-bit MSB first with each row padded to a byte."""
    h, n = samples.shape
    s = samples.astype(np.int64)
    if bitdepth == 16:
        return np.stack([s >> 8, s & 255], -1).reshape(h, 2 * n) \
            .astype(np.uint8)
    if bitdepth == 8:
        return s.astype(np.uint8)
    per = 8 // bitdepth
    s = np.pad(s, ((0, 0), (0, -n % per))).reshape(h, -1, per)
    shifts = 8 - bitdepth * np.arange(1, per + 1)
    return (s << shifts).sum(-1).astype(np.uint8)


def encode_png(pixels: np.ndarray, color_type: int = 6, bitdepth: int = 8,
               filters=0, interlace: int = 0, palette=None, trns=None,
               chunks=(), idat_size: int | None = None,
               level: int = 6) -> bytes:
    """A PNG of ``pixels``, the samples of each pixel: (h, w) for colour
    types 0 (gray) and 3 (palette index), (h, w, c) with c = 3, 2, 4 for
    types 2, 4 and 6; each below 2**bitdepth.  ``filters`` is a filter
    type for every row, or a sequence of them cycled over the rows of
    each pass; ``interlace=1`` writes Adam7.  ``palette`` (n, 3) uint8
    writes PLTE; ``trns`` writes tRNS: per-index alpha bytes (type 3), a
    gray value (0) or an (r, g, b) key (2).  ``chunks`` are extra (name,
    payload) pairs written before the image data, which ``idat_size``
    splits into IDAT chunks of that many bytes."""
    nch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    h, w = pixels.shape[:2]
    samples = np.asarray(pixels).reshape(h, w, nch)
    bpp = max(1, bitdepth * nch // 8)
    cycle = [filters] if isinstance(filters, int) else list(filters)
    passes = [(0, 0, 1, 1)] if not interlace else \
        [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)]
    out = []
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.shape[0] == 0 or sub.shape[1] == 0:
            continue
        rows = _png_rows(sub.reshape(sub.shape[0], -1), bitdepth) \
            .astype(np.int32)
        prev = np.zeros(rows.shape[1], np.int32)
        for y, x in enumerate(rows):
            ft = cycle[y % len(cycle)]
            out += [bytes([ft]), _png_filter(x, prev, ft, bpp)
                    .astype(np.uint8).tobytes()]
            prev = x
    data = zlib.compress(b"".join(out), level)
    parts = [png.chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bitdepth,
                                            color_type, 0, 0, interlace))]
    parts += [png.chunk(n.encode() if isinstance(n, str) else n, p)
              for n, p in chunks]
    if palette is not None:
        parts.append(png.chunk(b"PLTE",
                               np.asarray(palette, np.uint8).tobytes()))
    if trns is not None:
        if color_type == 3:
            payload = np.asarray(trns, np.uint8).tobytes()
        else:
            payload = struct.pack(f">{np.size(trns)}H",
                                  *np.atleast_1d(trns).tolist())
        parts.append(png.chunk(b"tRNS", payload))
    step = idat_size or max(len(data), 1)
    parts += [png.chunk(b"IDAT", data[k:k + step])
              for k in range(0, max(len(data), 1), step)]
    parts.append(png.chunk(b"IEND", b""))
    return png.SIGNATURE + b"".join(parts)


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


# JPEG sampling factors (h, v) per component of the geometries K4 takes
SAMPLINGS = {
    "444": ((1, 1), (1, 1), (1, 1)),
    "422": ((2, 1), (1, 1), (1, 1)),
    "440": ((1, 2), (1, 1), (1, 1)),
    "420": ((2, 2), (1, 1), (1, 1)),
    "411": ((4, 1), (1, 1), (1, 1)),
    "luma_up": ((1, 1), (2, 1), (2, 1)),     # chroma carries the largest h
    "mixed": ((2, 1), (1, 2), (1, 1)),       # every component upsampled
    "gray": ((1, 1),),
}


def mcu_geometry(height: int, width: int, sampling):
    """The block grids, luma-relative factors and output size that
    ``formats.jpg.to_pic`` gives a frame of this size and sampling:
    (shapes, samplings, out_h, out_w), the width 8-aligned."""
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mcus_x, mcus_y = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    shapes = tuple((mcus_y * v, mcus_x * h) for h, v in sampling)
    samplings = tuple((vmax // v, hmax // h) for h, v in sampling)
    return shapes, samplings, height, (width + 7) & ~7


def fancy_ok(samplings) -> bool:
    """Fancy upsampling takes luma-relative factors 1 and 2 only."""
    return all(v in (1, 2) and h in (1, 2) for v, h in samplings)


def mcu_cases(seed: int = 0) -> dict[str, tuple]:
    """int16 sample buffers for K4, as name -> (samples (nblocks, 8, 8)
    i16, shapes, samplings, out_h, out_w): every geometry of
    ``SAMPLINGS`` at 67x101 (so the cropped planes end inside blocks and
    fancy upsampling replicates their last row and column, not the MCU
    padding's), plus 4:2:0 and 4:2:2 at 1x3 and 4:4:0 at 9x17.  Half the
    rows are near [0, 255], the rest any int16, so colour clips both
    ways."""
    rng = np.random.default_rng(seed)
    out = {}
    sizes = [(name, 67, 101) for name in SAMPLINGS]
    sizes += [("420", 1, 3), ("422", 1, 3), ("440", 9, 17)]
    for name, h, w in sizes:
        shapes, samplings, oh, ow = mcu_geometry(h, w, SAMPLINGS[name])
        nblocks = sum(a * b for a, b in shapes)
        samples = rng.integers(-32768, 32768, (nblocks, 8, 8))
        samples[:, ::2] %= 300
        out[f"{name}_{h}x{w}"] = (samples.astype(np.int16), shapes,
                                  samplings, oh, ow)
    return out


def assemble_mcu_gather(samples, shapes, samplings, out_h: int, out_w: int,
                        gray_chroma: int = 128, upsample: str = "nearest"):
    """The component planes the ``assemble_mcu`` kernel computes, by its
    own per-pixel index arithmetic: (3, out_h, out_w) int64, read
    straight from block layout.  Nearest reads sample (y // v, x // h);
    fancy (factors 1 and 2) blends rows r = y // 2 and r -+ 1, clamped
    to the cropped plane's [0, ph - 1], then columns c = x // 2 and c -+
    1, clamped to [0, pw - 1].  Same arguments as
    ``ops.jpeg_kernels.assemble_mcu``, before colour; torch, int64."""
    ys = torch.arange(out_h)[:, None]
    xs = torch.arange(out_w)[None, :]
    planes, off = [], 0
    for (nby, nbx), (v, h) in zip(shapes, samplings):
        flat = samples[off:off + nby * nbx].reshape(-1).to(torch.int64)
        off += nby * nbx
        ph, pw = -(-out_h // v), -(-out_w // h)

        def s(py, px):
            return flat[((py >> 3) * nbx + (px >> 3)) * 64 + (py & 7) * 8
                        + (px & 7)]

        if upsample == "nearest" or (v == 1 and h == 1):
            planes.append(s(ys // v, xs // h))
            continue
        if v == 2:
            r0 = ys >> 1
            r1 = torch.where(ys % 2 == 1, (r0 + 1).clamp(max=ph - 1),
                             (r0 - 1).clamp(min=0))
            eb, ob = 8, 7
        else:
            r0 = r1 = ys
            eb, ob = 4, 8

        def vert(col):
            return 3 * s(r0, col) + s(r1, col)

        if h == 1:
            planes.append((vert(xs) + 2) >> 2)
            continue
        c = xs >> 1
        odd = xs % 2 == 1
        n = torch.where(odd, (c + 1).clamp(max=pw - 1), (c - 1).clamp(min=0))
        planes.append((3 * vert(c) + vert(n) + torch.where(odd, ob, eb)) >> 4)
    if len(planes) == 1:
        planes += [torch.full((out_h, out_w), gray_chroma,
                              dtype=torch.int64)] * 2
    return torch.stack(planes)


def fdct_evenodd(samples):
    """The forward DCT in the grouping of the ``fdct`` kernel: the
    even/odd split of each 8-point pass, every sum wrapped to 32 bits
    as the kernel's uint32 arithmetic wraps it.  Same argument and
    result as ``ops.jpeg_kernels.forward_dct``; torch, int64."""
    def m(v):                                   # uint32 wrap
        return v & 0xFFFFFFFF

    def fdct8(x):
        s = [m(x[u] + x[7 - u]) for u in range(4)]
        d = [m(x[u] - x[7 - u]) for u in range(4)]
        e0, e1 = m(s[0] - s[3]), m(s[1] - s[2])
        return [m(5792 * (s[0] + s[1] + s[2] + s[3])),
                m(8034 * d[0] + 6811 * d[1] + 4551 * d[2] + 1598 * d[3]),
                m(7568 * e0 + 3134 * e1),
                m(6811 * d[0] - 1598 * d[1] - 8034 * d[2] - 4551 * d[3]),
                m(5792 * (s[0] - s[1] - s[2] + s[3])),
                m(4551 * d[0] - 8034 * d[1] + 1598 * d[2] + 6811 * d[3]),
                m(3134 * e0 - 7568 * e1),
                m(1598 * d[0] - 4551 * d[1] + 6811 * d[2] - 8034 * d[3])]

    def rnd(v):
        return _wrap(((_wrap(v, 32) >> 1) + (1 << 12)) >> 13, 16)

    x = samples.to(torch.int64)
    row = torch.stack([rnd(r) for r in fdct8([x[..., u] for u in range(8)])],
                      dim=-1)                                 # rows first
    col = fdct8([row[..., u, :] for u in range(8)])           # then columns
    return torch.stack([rnd(c) for c in col], dim=-2).to(torch.int16)


def scatter_cases(seed: int = 0) -> dict[str, tuple]:
    """Packed pairs for K8, as name -> (planes, n, sizes): ``planes`` a
    list of (idx i32, val i16) for the planes, of ``sizes`` blocks each
    an image, laid one after the other in n images:

    * ``packed``: a plane's nonzeros as ``pack_coeffs`` gives them, in
      index order with (0, 0) padding, N=3;
    * ``duplicates``: every index 5 times, values that overflow int16;
    * ``hostile``: indices in [-2 total, 2 total), so negatives wrap once
      and the rest of the out-of-range ones are dropped, and the int32
      extremes; N=1;
    * ``odd``: an odd count of pairs and a plane of one block;
    * ``straddle``: three planes in key order (repeated indices, indices
      in [-total, 0) at their keys' places, zero values among them),
      crowded at the edges of the images, of K8's units of 4,096
      coefficients (one a CTA here) and of the planes, (0, 0) padding;
    * ``unsorted_1080p``: three planes of the 8 x 1080p batch's sizes,
      a fifth of the coefficients nonzero, padded as the host pads, the
      pairs shuffled."""
    from ffpic_tpu_torch.ops.jpeg_kernels import _bucket, pack_coeffs
    rng = np.random.default_rng(seed)
    out = {}
    plane = rng.integers(-300, 300, (3, 40, 64)).astype(np.int16)
    plane[rng.random(plane.shape) < 0.8] = 0
    out["packed"] = ([pack_coeffs(plane)], 3, [40])
    total = 2 * 33 * 64
    idx = np.repeat(rng.permutation(total), 5).astype(np.int32)
    val = rng.integers(-32768, 32768, idx.size).astype(np.int16)
    out["duplicates"] = ([(idx, val)], 2, [33])
    total = 17 * 64
    idx = rng.integers(-2 * total, 2 * total, 5000).astype(np.int32)
    idx[:4] = [-2 ** 31, 2 ** 31 - 1, -total, total]
    val = rng.integers(-32768, 32768, idx.size).astype(np.int16)
    out["hostile"] = ([(idx, val)], 1, [17])
    idx = rng.integers(0, 64, 101).astype(np.int32)
    out["odd"] = ([(idx, rng.integers(-99, 99, 101).astype(np.int16))], 1,
                  [1])

    def padded(keys, total):
        keys = np.sort(keys)
        val = rng.integers(-32768, 32768, keys.size).astype(np.int16)
        idx = keys.astype(np.int64)
        neg = rng.random(keys.size) < 0.1          # the same key, wrapped
        idx[neg] -= total
        n = _bucket(keys.size)
        pidx, pval = np.zeros(n, np.int32), np.zeros(n, np.int16)
        pidx[:keys.size], pval[:keys.size] = idx, val
        return pidx, pval

    n, sizes, planes = 3, [70, 17, 17], []
    for nb in sizes:
        total = n * nb * 64
        edges = np.concatenate([np.arange(0, total, 4096),
                                np.arange(0, total + 1, nb * 64)])
        near = (edges[:, None] + np.arange(-3, 4)).ravel()
        keys = np.concatenate([near, near[::5], rng.integers(0, total, 300)])
        planes.append(padded(keys[(keys >= 0) & (keys < total)], total))
    out["straddle"] = (planes, n, sizes)
    n, sizes, planes = 8, [32400, 8100, 8100], []
    for nb in sizes:
        total = n * nb * 64
        idx, val = padded(np.flatnonzero(rng.random(total) < 0.2), total)
        p = rng.permutation(idx.size)
        planes.append((idx[p], val[p]))
    out["unsorted_1080p"] = (planes, n, sizes)
    return out


def unfilter_cases(seed: int = 0) -> dict[str, tuple]:
    """Filtered rows for K6, as name -> (rows (h, stride + 1) u8 with
    the filter type in column 0, in {0, 1, 2}, bpp): every bpp PNG has
    (1, 2, 3, 4, 6, 8) over strides that are not multiples of 4 or of
    32 or bpp's; a first row of Up; one row; a stride of one pixel; runs
    of Up rows of 37 and 4,129 rows; one row of each kind in turn;
    restarts on the first and on the last row of K6's bands (Up
    elsewhere, so that bands without one look back over those with one);
    one Sub row above 4,000 Up rows (every band looks back across all
    the bands above it); and 20,000 px of 16-bit RGBA (a stride of
    160,000 bytes, 21 of K6's chunks)."""
    from ffpic_tpu_torch.ops.cuda_png import unfilter_bands
    rng = np.random.default_rng(seed)
    out = {}
    for name, bpp, h, stride, kinds in (
            ("bpp1", 1, 9, 37, None), ("bpp2", 2, 11, 70, None),
            ("bpp3", 3, 7, 3 * 67, None), ("bpp4_up_first", 4, 13, 4 * 45,
                                          "up_first"),
            ("bpp6", 6, 5, 6 * 31, None), ("bpp8", 8, 6, 8 * 29, None),
            ("one_row", 4, 1, 4 * 33, None),
            ("one_pixel", 3, 12, 3, None),
            ("long_up", 1, 40, 1031, "long_up"),
            ("past_tag_chunk", 1, 4133, 7, "long_up"),
            ("in_turn", 2, 9, 2 * 300 + 1, "in_turn")):
        rows = rng.integers(0, 256, (h, stride + 1)).astype(np.uint8)
        rows[:, 0] = rng.integers(0, 3, h)
        if kinds == "up_first":
            rows[0, 0] = 2
        elif kinds == "long_up":
            rows[:, 0] = 2
            rows[3, 0] = 1
        elif kinds == "in_turn":
            rows[:, 0] = np.arange(h) % 3
        out[name] = (rows, bpp)
    for name, bpp, h, stride in (("band_first_row", 4, 1027, 4 * 1920),
                                 ("band_last_row", 3, 3331, 3 * 700 + 1)):
        band = unfilter_bands(h, stride)[0]
        rows = rng.integers(0, 256, (h, stride + 1)).astype(np.uint8)
        rows[:, 0] = 2
        at = np.arange(0, h, band) + (0 if name == "band_first_row"
                                      else band - 1)
        at = at[(at < h) & (np.arange(at.size) % 3 != 1)]
        rows[at, 0] = rng.integers(0, 2, at.size)
        out[name] = (rows, bpp)
    rows = rng.integers(0, 256, (4001, 1201)).astype(np.uint8)
    rows[:, 0] = 2
    rows[0, 0] = 1
    out["sub_above_4000_up"] = (rows, 4)
    rows = rng.integers(0, 256, (5, 160_001)).astype(np.uint8)
    rows[:, 0] = [1, 2, 2, 1, 2]
    out["rgba16_20000px"] = (rows, 8)
    return out


def rgba_cases(seed: int = 0) -> dict[str, tuple]:
    """Reconstructed rows for K7, as name -> (recon (h, stride) u8,
    palette (256, 4) u8, trns (256,) i32, colour type, bit depth, w, h):
    every (colour type, bit depth) PNG allows, at an odd width, with and
    without tRNS (the key set to a sample that occurs, so some pixels
    turn transparent)."""
    from ffpic_tpu_torch.ops.png_kernels import LEGAL, NCH
    rng = np.random.default_rng(seed)
    out = {}
    h, w = 7, 37
    for ct, depths in LEGAL.items():
        for bd in depths:
            for with_trns in (False, True):
                stride = (w * NCH[ct] * bd + 7) // 8
                recon = rng.integers(0, 256, (h, stride)).astype(np.uint8)
                if bd == 16:
                    recon[:, ::4] = recon[0, 0]     # keys that occur
                palette = np.zeros((256, 4), np.uint8)
                palette[:, 3] = 255
                palette[:200, :3] = rng.integers(0, 256, (200, 3))
                trns = np.full(256, -1, np.int32)
                if with_trns:
                    if ct == 3:
                        trns[:150] = rng.integers(0, 256, 150)
                    elif ct in (0, 2):
                        from ffpic_tpu_torch.ops.png_kernels import \
                            unpack_samples
                        first = unpack_samples(torch.from_numpy(recon[:1]),
                                               bd, NCH[ct])[0]
                        trns[:NCH[ct]] = first.numpy()
                name = f"ct{ct}_bd{bd}" + ("_trns" if with_trns else "")
                out[name] = (recon, palette, trns, ct, bd, w, h)
    return out


def _scan_span(data: bytes) -> tuple[int, int]:
    """[start, end) of the entropy-coded bytes of a JPEG's first scan."""
    from ffpic_tpu_torch.ops.jpeg_entropy_device import extract_scan
    scan = extract_scan(data)
    start = data.index(scan)
    return start, start + len(scan)


def luma_on_chroma_tables(data: bytes) -> bytes:
    """``data``, a baseline ``encode_jpeg`` file, with its scan coded
    again on the chroma Huffman tables for every component and those
    tables written as tables 0 too: the same coefficients under a second
    table set."""
    from ffpic_tpu_torch.formats import jpg
    from ffpic_tpu_torch.formats import jpg_encode as E
    from ffpic_tpu_torch.ops.golden import ZIGZAG
    j, _ = jpg.parse_and_decode(data)
    zz = [c.reshape(-1, 64)[:, ZIGZAG] for c in j.coeffs]
    mcus = E._mcu_order([(c.h, c.v) for c in j.comps], j.mcus_x, j.mcus_y)
    cmaps = E._huffman_maps()[1]
    step = j.restart_interval or len(mcus)
    w = E.BitWriter()
    for k, first in enumerate(range(0, len(mcus), step)):
        if k:                                   # RSTn, as encode_blocks
            w.align_byte(fill=1)
            w.buf += bytes([0xFF, 0xD0 + (k - 1) % 8])
        E._encode_blocks_entropy(w, zz, [b for m in mcus[first:first + step]
                                         for b in m], [cmaps] * len(zz))
    w.align_byte(fill=1)

    def dht(tc, counts, syms):
        return b"\xff\xc4" + struct.pack(">HB", 19 + len(syms), tc << 4) + \
            bytes(counts) + bytes(syms)
    a, b = _scan_span(data)
    head = data[:a]
    for tc, (yc, ys), (uc, us) in (
            (0, (E.Y_DC_COUNT, E.Y_DC_SYM), (E.UV_DC_COUNT, E.UV_DC_SYM)),
            (1, (E.Y_AC_COUNT, E.Y_AC_SYM), (E.UV_AC_COUNT, E.UV_AC_SYM))):
        head = head.replace(dht(tc, yc, ys), dht(tc, uc, us))
    return head + bytes(w.buf) + data[b:]


def _spill_pixels(h: int, w: int, seed: int) -> np.ndarray:
    """Content whose quality-100 coefficients need long codes: a
    checkerboard of black and white 12x12 cells, whose edges fall inside
    blocks (AC values of size 10) and between them (DC differences of
    size 11), under mild noise (zigzag runs of 16 zeros and more, blocks
    whose last nonzero is at 62 or 63)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.where(((yy // 12) + (xx // 12)) % 2, 255, 0).astype(np.float64)
    img = img[..., None] + rng.normal(0, 1.5, (h, w, 3))
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def entropy_cases(seed: int = 0) -> dict[str, dict]:
    """JPEG batches at the edges of the device Huffman decode (K9
    ``entropy_decode``, K10 ``spec_scan``, K11 ``spec_merge``), made
    with ``encode_jpeg`` from a seed, as name -> {"kind": "dri" (one
    launch over ``decode_coeffs_device_mixed``) or "spec"
    (``spec_stages``), "datas": [bytes], "chunk_bytes": for "spec"}:

    * ``dri_spill``: quality 100 over ``_spill_pixels``, DRI 2: magnitude
      spills (code and magnitude over 16 bits, the ``RUN_CODE`` entries)
      for DC and AC, blocks that end at k = 63 with and without an EOB
      there, runs of 16 zeros (ZRL);
    * ``dri_zero_lanes``: an extra restart segment after the last MCU,
      so its lane starts at blk0 >= blk_end and decodes nothing;
    * ``dri_invalid``: six 0xFF bytes (stuffed) inside a segment, a
      48-bit run of ones in which every code is invalid (e == 0);
    * ``dri_cut``: the scan cut inside its last segment, so that lane
      reads past the bytes (window indices clamped to the last byte);
    * ``dri_mixed``: two geometries and two Huffman table sets
      (``luma_on_chroma_tables``) in one launch;
    * ``spec_mid_mcu``: DRI-less, 512-byte chunks, whose emission lanes
      start mid-MCU (nonzero k0, sub0 and DC predictors, with bit_stop);
    * ``spec_fail``: 64-byte chunks at quality 95, too short to
      self-synchronise: chunks that do not merge, ok False;
    * ``spec_invalid``: DRI-less with invalid codes inside a chunk."""
    out = {}

    def jpeg(h, w, q, s, ri=0, **kw):
        return encode_jpeg(synth_rgb(h, w, seed + s), q, restart_interval=ri,
                           **kw)

    def insert_ff(data, frac, count=6):
        a, b = _scan_span(data)
        at = a + int((b - a) * frac)
        while data[at - 1] == 0xFF:        # not inside a stuffed pair
            at += 1
        return data[:at] + b"\xff\x00" * count + data[at:]

    spill = encode_jpeg(_spill_pixels(64, 96, seed), 100, restart_interval=2)
    out["dri_spill"] = {"kind": "dri", "datas": [spill, spill]}
    base = jpeg(48, 80, 85, 1, ri=3)
    a, b = _scan_span(base)
    extra = base[:b] + b"\xff\xd7\x12\x34\x56" + base[b:]
    out["dri_zero_lanes"] = {"kind": "dri", "datas": [extra, base]}
    out["dri_invalid"] = {"kind": "dri",
                          "datas": [insert_ff(base, 0.4), base]}
    cut = base[:a + (b - a) * 9 // 10] + b"\xff\xd9"
    out["dri_cut"] = {"kind": "dri", "datas": [base, cut]}
    out["dri_mixed"] = {"kind": "dri", "datas": [
        jpeg(64, 96, 80, 2, ri=3),
        luma_on_chroma_tables(jpeg(48, 48, 70, 3, ri=2)),
        luma_on_chroma_tables(jpeg(64, 96, 90, 4, ri=5)),
        jpeg(48, 48, 95, 5, ri=1)]}
    plain = jpeg(128, 160, 75, 6)
    out["spec_mid_mcu"] = {"kind": "spec", "datas": [plain, plain],
                           "chunk_bytes": 512}
    out["spec_fail"] = {"kind": "spec", "datas": [jpeg(96, 128, 95, 7)],
                        "chunk_bytes": 64}
    out["spec_invalid"] = {"kind": "spec",
                           "datas": [insert_ff(plain, 0.5), plain],
                           "chunk_bytes": 512}
    return out


def entropy_stages(case: dict, device) -> dict[str, torch.Tensor]:
    """What each stage of the device Huffman decode makes for an
    ``entropy_cases`` case on ``device`` (the kernels on CUDA, the plain
    versions on the CPU), as CPU tensors: "flat" and
    "steps" (K9), and for "spec" cases "exits", "snap" (K10), "merged"
    (K11), the emission's "lanes" and "ok"."""
    from ffpic_tpu_torch.formats import jpg
    from ffpic_tpu_torch.ops import jpeg_entropy_device as jed
    if case["kind"] == "dri":
        js = [jpg.parse_and_decode(d, skip_decode=True)[0]
              for d in case["datas"]]
        flat, _off, steps = jed.decode_coeffs_device_mixed(
            case["datas"], js, device=device)
        return {"flat": flat.cpu(), "steps": steps.cpu()}
    r = jed.spec_stages(case["datas"], case["chunk_bytes"], device=device)
    return {k: r[k].cpu() for k in ("exits", "snap", "merged", "lanes",
                                    "flat", "steps", "ok")}


def merge_work(st, r, lut_bytes: int) -> dict:
    """What K11 did in the ``spec_stages`` run ``r``: each lane's walk
    from its true entry to the snapshot it met, replayed with the plain
    step (``jed._advance``) where ``r``'s tensors lie.  Its bytes, each
    read once: the scan bytes the walks cover (their bits, and a 4-byte
    window past each), a table entry a symbol (at most the LUT stack), the
    bit column of every used snapshot slot and one past, k and sub of the
    matched slot, the entries and the merged rows."""
    from ffpic_tpu_torch.ops import jpeg_entropy_device as jed
    ent, snap, merged = (r[k].to(torch.int64)
                         for k in ("ent", "snap", "merged"))
    if not bool(merged[:, 0].all()):
        raise AssertionError("spec_merge: a lane did not meet a snapshot")
    rows = torch.arange(ent.shape[0], device=ent.device)
    target = snap[rows, merged[:, 1], 0]
    tabs = jed._spec_tables(st.u32win, st.luts, st.comp_of_sub,
                            st.tclass_of_sub)
    bit, k, sub = ent[:, 0].clone(), ent[:, 1].clone(), ent[:, 2].clone()
    blk = torch.zeros_like(bit)
    dcs = torch.zeros((bit.shape[0], 3), dtype=torch.int64,
                      device=bit.device)
    steps = torch.zeros_like(bit)
    while bool((bit < target).any()):
        active = bit < target
        bit, k, sub, blk, dcs = jed._advance(tabs, st.bpm, active, bit, k,
                                             sub, blk, dcs)
        steps += active
    if not torch.equal(bit, target):
        raise AssertionError("spec_merge: a replayed walk passed its match")
    symbols = int(steps.sum())
    scan_bytes = int(((target - ent[:, 0] + 7) // 8 + 4).sum())
    used = (snap[..., 0] != -1).sum(dim=1)
    snap_bytes = int((4 * torch.clamp(used + 1, max=jed.SNAP) + 8).sum())
    nbytes = scan_bytes + min(4 * symbols, lut_bytes) + snap_bytes \
        + 12 * ent.shape[0] + 24 * ent.shape[0]
    return {"symbols": symbols, "longest": int(steps.max()),
            "scan_bytes": scan_bytes, "snap_bytes": snap_bytes,
            "bytes": nbytes}


def webp_fixture(name: str) -> bytes:
    """The bytes of a committed WebP fixture of ``ffpic_tpu_torch/
    testdata`` (``make_webp_fixtures`` lists them), e.g.
    ``"lossy_1080p.webp"``; machines without PIL read these."""
    return _testdata(name)


def heif_fixture(name: str = "heic_12mp_grid.heic") -> bytes:
    """The bytes of the committed HEIF fixture of ``ffpic_tpu_torch/
    testdata`` (``make_heif_fixtures`` wrote it with the port's
    encoder)."""
    return _testdata(name)


def still_fixture(name: str) -> bytes:
    """The bytes of a committed JPEG 2000 or OpenEXR fixture of
    ``ffpic_tpu_torch/testdata`` (``make_still_fixtures`` lists them),
    e.g. ``"jp2_1080p_53.jp2"``; machines without PIL or OpenEXR read
    these."""
    return _testdata(name)


def avif_fixture(name: str) -> bytes:
    """The bytes of a committed AVIF fixture of ``ffpic_tpu_torch/
    testdata`` (``make_avif_fixtures`` lists them), e.g.
    ``"avif_1080p_420.avif"``; machines without PIL read these."""
    return _testdata(name)


def avif_manifest() -> dict:
    """``testdata/avif_fixtures.json``: each AVIF fixture's sha256 and,
    for the stills, the shape and sha256 of their ``load`` pixels."""
    return json.loads(_testdata("avif_fixtures.json"))


def svg_still(w: int, h: int, variant: int = 0) -> bytes:
    """An SVG document of ``w`` x ``h`` pixels: a linear-gradient sky, a
    radial-gradient sun, a hill of cubic and quadratic curves, a
    half-transparent group of rotated rectangles, an even-odd ring, a
    stroked polyline with round joins and an elliptical arc.  ``variant``
    1 uses a viewBox of another scale and moves and recolours the
    shapes."""
    s = 1.0 if variant == 0 else 0.5
    vw, vh = w * s, h * s
    hue = ("#1e5aa8", "#f2b134", "#2f8f4e", "#c0392b") if variant == 0 \
        else ("#402060", "#f0e68c", "#556b2f", "#008b8b")

    def f(v):
        return f"{v:.2f}"
    body = (
        f'<defs><linearGradient id="sky" x1="0" y1="0" x2="0" y2="1">'
        f'<stop offset="0" stop-color="{hue[0]}"/>'
        f'<stop offset="1" stop-color="white"/></linearGradient>'
        f'<radialGradient id="sun"><stop offset="0" stop-color="white"/>'
        f'<stop offset="1" stop-color="{hue[1]}"/></radialGradient>'
        f'</defs>'
        f'<rect width="{f(vw)}" height="{f(vh)}" fill="url(#sky)"/>'
        f'<circle cx="{f(vw * (0.75 - 0.4 * variant))}" '
        f'cy="{f(vh * 0.25)}" r="{f(vh * 0.12)}" fill="url(#sun)"/>'
        f'<path d="M0 {f(vh * 0.7)} C {f(vw * 0.25)} {f(vh * 0.45)} '
        f'{f(vw * 0.5)} {f(vh * 0.95)} {f(vw * 0.75)} {f(vh * 0.6)} '
        f'Q {f(vw * 0.9)} {f(vh * 0.5)} {f(vw)} {f(vh * 0.65)} '
        f'L {f(vw)} {f(vh)} L 0 {f(vh)} Z" fill="{hue[2]}"/>'
        f'<g opacity="0.6" transform="rotate({15 + 20 * variant} '
        f'{f(vw / 2)} {f(vh / 2)})">'
        f'<rect x="{f(vw * 0.3)}" y="{f(vh * 0.3)}" width="{f(vw * 0.2)}" '
        f'height="{f(vh * 0.15)}" fill="{hue[3]}"/>'
        f'<rect x="{f(vw * 0.4)}" y="{f(vh * 0.4)}" width="{f(vw * 0.15)}" '
        f'height="{f(vh * 0.2)}" rx="{f(vh * 0.03)}" fill="{hue[0]}"/></g>'
        f'<path fill-rule="evenodd" fill="{hue[1]}" fill-opacity="0.8" '
        f'd="M {f(vw * 0.1)} {f(vh * 0.2)} a {f(vh * 0.1)} {f(vh * 0.1)} '
        f'0 1 0 {f(vh * 0.2)} 0 a {f(vh * 0.1)} {f(vh * 0.1)} 0 1 0 '
        f'{f(-vh * 0.2)} 0 Z M {f(vw * 0.1 + vh * 0.05)} {f(vh * 0.2)} '
        f'a {f(vh * 0.05)} {f(vh * 0.05)} 0 1 0 {f(vh * 0.1)} 0 '
        f'a {f(vh * 0.05)} {f(vh * 0.05)} 0 1 0 {f(-vh * 0.1)} 0 Z"/>'
        f'<polyline points="{f(vw * 0.05)},{f(vh * 0.9)} '
        f'{f(vw * 0.2)},{f(vh * 0.75)} {f(vw * 0.35)},{f(vh * 0.88)} '
        f'{f(vw * 0.5)},{f(vh * 0.72)}" fill="none" stroke="white" '
        f'stroke-width="{f(vh * 0.015)}" stroke-linejoin="round" '
        f'stroke-linecap="round" stroke-opacity="0.9"/>'
        f'<ellipse cx="{f(vw * 0.6)}" cy="{f(vh * 0.85)}" '
        f'rx="{f(vw * 0.08)}" ry="{f(vh * 0.04)}" fill="{hue[3]}" '
        f'stroke="black" stroke-width="{f(vh * 0.004)}"/>')
    return (f'<?xml version="1.0" encoding="UTF-8"?>\n'
            f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" '
            f'height="{h}" viewBox="0 0 {f(vw)} {f(vh)}">{body}</svg>'
            ).encode()


def _ue7(v: int) -> bytes:
    out = [v & 0x7F]
    v >>= 7
    while v:
        out.append(0x80 | (v & 0x7F))
        v >>= 7
    return bytes(reversed(out))


def bpg_header(w: int, h: int, pixel_format: int = 1, alpha: bool = False,
               depth: int = 8, ext=()) -> bytes:
    """A BPG file's header (``ffpic_tpu/formats/bpg.py`` reads it): the
    magic, pixel format, alpha, bit depth, colour space 1, limited
    range, the ue7 width, height and a picture length, the extension
    tags (tag, payload) of ``ext``, then 16 zero bytes in place of the
    picture."""
    b4 = (pixel_format << 5) | (int(alpha) << 4) | (depth - 8)
    b5 = (1 << 4) | (int(bool(ext)) << 3) | (int(alpha) << 2) | 2
    out = b"BPG\xfb" + bytes([b4, b5]) + _ue7(w) + _ue7(h) + _ue7(16)
    if ext:
        tags = b"".join(_ue7(t) + _ue7(len(p)) + p for t, p in ext)
        out += _ue7(len(tags)) + tags
    return out + bytes(16)


def _testdata(name: str) -> bytes:
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "testdata", name)
    with open(path, "rb") as f:
        return f.read()


def vp8_dq(q: int, deltas=(0, 0, 0, 0, 0)) -> tuple:
    """One segment's dequant factors (y1dc, y1ac, y2dc, y2ac, uvdc,
    uvac) at quantizer index ``q`` with the five deltas of RFC 6386 9.6
    (y1 DC, y2 DC, y2 AC, uv DC, uv AC), as
    ``formats.vp8.VP8Decoder._dequant_tables`` computes them."""
    from types import SimpleNamespace

    from ffpic_tpu_torch.formats.vp8 import FrameHeader, VP8Decoder
    d = SimpleNamespace(hdr=FrameHeader(q_yac=q, **dict(zip(
        ("q_ydc_delta", "q_y2dc_delta", "q_y2ac_delta", "q_uvdc_delta",
         "q_uvac_delta"), deltas))))
    VP8Decoder._dequant_tables(d)
    return d.dq[0]


def vp8_cases(seed: int = 0) -> dict[str, dict]:
    """Inputs at the edges of K12 ``vp8_residuals`` and K13
    ``vp8_yuv_to_rgba``: {"residuals": name -> (levels (mbh, mbw, 25, 16)
    i32, dq_per_mb (mbh, mbw, 6) i32, has_y2 (mbh, mbw) bool), "color":
    name -> (Y, U, V, h, w, alpha (h, w) u8 or None)}.

    Residuals: 1x1 and 1xN macroblock grids; levels a token can code
    (|level| <= 2048 + 67) at the quantizers' extremes, so products
    overflow int16 after dequant; levels over the whole int32 range, so
    products wrap int32; mixed has_y2; four segments of their own
    factors; an all-zero grid.  Colour: MB-padded planes of random bytes
    at h, w of 1, 2, odd and not MB multiples, a 1xN and Nx1 strip, with
    and without alpha."""
    rng = np.random.default_rng(seed)
    res = {}

    def levels(mbh, mbw, lim=2048 + 67):
        lv = rng.integers(-lim, lim + 1, (mbh, mbw, 25, 16))
        lv[rng.random((mbh, mbw, 25, 16)) < 0.6] = 0   # mostly zeros
        return lv.astype(np.int32)

    def dq_of(seg, rows):
        return np.array(rows, np.int32)[seg]

    one = dq_of(np.zeros((1, 1), int), [vp8_dq(40)])
    res["mb1x1_y2"] = (levels(1, 1), one, np.ones((1, 1), bool))
    res["mb1x1_bpred"] = (levels(1, 1), one, np.zeros((1, 1), bool))
    seg = rng.integers(0, 4, (1, 37))
    res["mb1x37_mixed"] = (levels(1, 37), dq_of(seg, [
        vp8_dq(q) for q in (0, 30, 90, 127)]), rng.random((1, 37)) < 0.5)
    seg = rng.integers(0, 4, (5, 7))
    rows = [vp8_dq(127, (15, 15, 15, 15, 15)), vp8_dq(0, (-15,) * 5),
            vp8_dq(64, (3, -4, 5, -6, 7)), vp8_dq(100)]
    res["wrap_int16_4seg"] = (levels(5, 7), dq_of(seg, rows),
                              rng.random((5, 7)) < 0.5)
    res["wrap_int32"] = (
        rng.integers(-2 ** 31, 2 ** 31, (3, 4, 25, 16)).astype(np.int32),
        rng.integers(-2 ** 31, 2 ** 31, (3, 4, 6)).astype(np.int32),
        rng.random((3, 4)) < 0.5)
    res["zeros"] = (np.zeros((2, 3, 25, 16), np.int32),
                    dq_of(np.zeros((2, 3), int), [vp8_dq(90)]),
                    np.ones((2, 3), bool))

    col = {}
    for name, h, w, with_alpha in (
            ("1x1", 1, 1, False), ("2x2_alpha", 2, 2, True),
            ("15x17", 15, 17, False), ("17x33_alpha", 17, 33, True),
            ("33x40", 33, 40, False), ("40x15", 40, 15, True),
            ("1x301", 1, 301, False), ("301x1_alpha", 301, 1, True),
            ("199x333_alpha", 199, 333, True)):
        ph, pw = -(-h // 16) * 16, -(-w // 16) * 16
        planes = [rng.integers(0, 256, s).astype(np.uint8)
                  for s in ((ph, pw), (ph // 2, pw // 2), (ph // 2, pw // 2))]
        alpha = (rng.integers(0, 256, (h, w)).astype(np.uint8)
                 if with_alpha else None)
        col[name] = (*planes, h, w, alpha)
    return {"residuals": res, "color": col}



def vp8_bitstreams(data: bytes) -> list[bytes]:
    """The VP8 key frames of a WebP file: its ``VP8 `` chunk, or that of
    each ``ANMF`` frame (after the frame's 16-byte header)."""
    from ffpic_tpu_torch.formats.webp import chunks_of
    out = []
    for tag, body in chunks_of(data, 12, "WEBP"):
        if tag == "VP8 ":
            out.append(body)
        elif tag == "ANMF":
            out += [b for t, b in chunks_of(body, 16, "ANMF subchunk")
                    if t == "VP8 "]
    return out


WAVEFRONT_FIXTURES = ("lossy_512.webp", "odd_333x199.webp",
                      "lossy_1080p.webp", "alpha_1080p.webp",
                      "animated_96x64.webp")


def wavefront_inputs(name: str, frame: int = 0) -> dict:
    """The inputs of B12 (``ops.vp8_wavefront``) for VP8 frame ``frame`` of
    the committed WebP fixture ``name``, through the port's
    ``VP8Decoder`` up to its residuals (the host transform, or K12's plain
    version under ``FFPIC_VP8_DEVICE``), as ``tests/test_vp8_wavefront.py``
    captures them: {"residual": (mbh, mbw, 16, 4, 4) int32 (the luma
    blocks), "ymode": (mbh, mbw) int32, "bmodes": (mbh, mbw, 16) int32,
    "Y": the host reconstruction ``native.vp8_recon``'s luma before the
    loop filter, (16 mbh, 16 mbw) uint8, "mb": (mbh, mbw), "levels",
    "dq_per_mb" and "has_y2" (K12's inputs), and "residual24" (all 24
    blocks, int16) and "uvmode" (``vp8_recon``'s other inputs)}."""
    from ffpic_tpu_torch.formats.vp8 import VP8Decoder
    dec = VP8Decoder(vp8_bitstreams(webp_fixture(name))[frame],
                     device=torch.device("cpu"))
    dec._parse_control_partition()
    dec._dequant_tables()
    dec._parse_mb_headers()
    dec._parse_tokens()
    dec._residuals()
    dec._reconstruct()
    mbh, mbw = dec.mbh, dec.mbw
    seg = (dec.seg if dec.hdr.seg_enabled
           else np.zeros((mbh, mbw), np.int32))
    return {"residual": np.ascontiguousarray(dec.residual[:, :, :16],
                                             np.int32),
            "ymode": np.asarray(dec.ymode, np.int32).copy(),
            "bmodes": np.asarray(dec.bmodes, np.int32)
            .reshape(mbh, mbw, 16).copy(),
            "Y": dec.Y.copy(), "mb": (mbh, mbw), "levels": dec.levels,
            "residual24": dec.residual, "uvmode": dec.uvmode,
            "dq_per_mb": np.array(dec.dq, np.int32)[seg],
            "has_y2": np.asarray(dec.has_y2, bool)}


def wavefront_cases(seed: int = 0) -> dict[str, tuple]:
    """Random inputs of B12: name -> (residual (mbh, mbw, 16, 4, 4) int32
    in +-300, ymode (mbh, mbw) int32, bmodes (mbh, mbw, 16) int32) at the
    grids 1x1 (B_PRED, every B-mode), 1x7, 7x1, 3x4 (all B_PRED) and 5x9;
    together they hold every ymode 0-4 and every B-mode 0-9 at the
    frame's edges and inside it."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (mbh, mbw), p_bpred in (("mb1x1_bpred", (1, 1), 1.0),
                                      ("mb1x7", (1, 7), 0.5),
                                      ("mb7x1", (7, 1), 0.5),
                                      ("mb3x4_bpred", (3, 4), 1.0),
                                      ("mb5x9", (5, 9), 0.4)):
        res = rng.integers(-300, 301, (mbh, mbw, 16, 4, 4))
        ymode = np.where(rng.random((mbh, mbw)) < p_bpred, 4,
                         rng.integers(0, 4, (mbh, mbw)))
        bmodes = rng.integers(0, 10, (mbh, mbw, 16))
        if name == "mb1x1_bpred":
            bmodes[0, 0] = np.concatenate([rng.permutation(10),
                                           rng.integers(0, 10, 6)])
        out[name] = (res.astype(np.int32), ymode.astype(np.int32),
                     bmodes.astype(np.int32))
    ym = np.concatenate([c[1].ravel() for c in out.values()])
    bm = np.concatenate([c[2][c[1] == 4].ravel() for c in out.values()])
    assert set(ym) == set(range(5)) and set(bm) == set(range(10))
    return out

# --- HEVC / HEIF ------------------------------------------------------------

def hevc_planes(w: int, h: int, seed: int, bd: int = 8):
    """(y, u, v) int32 4:2:0 planes of ``bd``-bit samples: 8x8 blocks of
    random levels plus noise, so that the encoder takes every TU size."""
    rng = np.random.default_rng(seed)
    mx = (1 << bd) - 1
    k = 1 << (bd - 8)

    def plane(ph, pw, lo, hi, noise):
        blocks = rng.integers(lo * k, hi * k, (-(-ph // 8), -(-pw // 8)))
        p = np.kron(blocks, np.ones((8, 8)))[:ph, :pw]
        return (p + rng.integers(-noise * k, noise * k, (ph, pw))) \
            .clip(0, mx).astype(np.int32)
    return (plane(h, w, 0, 256, 20), plane(h // 2, w // 2, 64, 192, 10),
            plane(h // 2, w // 2, 64, 192, 10))


def hevc_policy(**kw):
    """The encoder policy that takes every intra mode, CU and TU split
    and NxN partition (``tests/test_hevc_slice.py``'s full policy)."""
    from ffpic_tpu_torch.coding.hevc_enc import EncPolicy
    d = dict(seed=2, split_prob=0.5, tt_split_prob=0.4, nxn_prob=0.5,
             mode_candidates=tuple(range(35)))
    d.update(kw)
    return EncPolicy(**d)


def _custom_lists(seed: int) -> dict:
    from ffpic_tpu_torch.coding.hevc_scaling import matrix_ids
    rng = np.random.default_rng(seed)
    sl = {}
    for size_id in range(4):
        for matrix_id in matrix_ids(size_id):
            n = 16 if size_id == 0 else 64
            sl[(size_id, matrix_id)] = (
                rng.integers(8, 100, n).astype(np.int32),
                int(rng.integers(8, 60)))
    return sl


# stream kind -> (sps extras, pps extras, policy extras, encode_picture
# arguments)
HEVC_STREAMS = {
    "single": ({}, {"sign_hiding": True}, {}, {}),
    "multislice": ({}, {}, {}, {"n_slices": 3}),
    "tiles": ({}, {"tiles": (2, 2)}, {}, {}),
    "wpp": ({}, {"wpp": True}, {}, {}),
    "dependent": ({}, {"dependent_slices": True}, {},
                  {"dependent_splits": 2}),
    "pcm": ({"pcm": dict(bd_luma=8, bd_chroma=8, log2_min=3, log2_diff=2)},
            {}, {"pcm_prob": 0.5}, {}),
    "scaling_default": ({"scaling_lists": "default"}, {}, {}, {}),
    "scaling_custom": ({"scaling_lists": "custom"}, {}, {}, {}),
    "skip": ({}, {"transform_skip": True},
             {"tt_split_prob": 0.5, "nxn_prob": 0.6,
              "transform_skip_prob": 0.6}, {}),
    "bypass": ({}, {"transquant_bypass": True}, {"bypass_prob": 0.5}, {}),
    "10bit": ({"bit_depth": 10}, {"sign_hiding": True}, {}, {}),
    "deblock": ({}, {"deblocking_disabled": False, "cu_qp_delta_depth": 1},
                {}, {}),
}


def hevc_stream(kind: str, w: int = 64, h: int = 64, seed: int = 5,
                qp: int = 30):
    """An HEVC intra picture of ``kind`` (a key of ``HEVC_STREAMS``)
    written by the port's encoder: returns the ``SliceEncoder`` (its
    ``sps``, ``pps``, ``sps_rbsp``, ``pps_rbsp`` and ``pic``, the
    encoder's reconstruction before the loop filters) and the slice
    NALUs."""
    from ffpic_tpu_torch.coding.hevc_enc import SliceEncoder
    sps_x, pps_x, pol_x, pic_x = HEVC_STREAMS[kind]
    sp = dict(width=w, height=h, ctb_log2=5, **sps_x)
    if sp.get("scaling_lists") == "custom":
        sp["scaling_lists"] = _custom_lists(seed)
    enc = SliceEncoder(sp, dict(pps_x), qp,
                       hevc_planes(w, h, seed, sp.get("bit_depth", 8)),
                       hevc_policy(**pol_x))
    return enc, enc.encode_picture(**pic_x)


def heif_item(enc, nalus, w: int, h: int) -> bytes:
    """A HEIC whose primary item is the hvc1 picture ``nalus`` of
    encoder ``enc`` (its parameter sets in the hvcC), ``w`` x ``h``."""
    from ffpic_tpu_torch.formats import heif_enc
    payload = b"".join(struct.pack(">I", len(n)) + n for n in nalus)
    items = [(1, b"hvc1", payload, [
        (heif_enc._box("hvcC", heif_enc._hvcc(enc.sps_rbsp, enc.pps_rbsp)),
         True), (heif_enc._ispe(w, h), False)])]
    return heif_enc._assemble(items, [], 1)


def heif_pic(w: int, h: int, seed: int, alpha: bool = False) -> Pic:
    """An RGBA picture of 16x16 blocks (and 32x32 alpha blocks) to
    encode (``tests/test_heif.py``'s ``_pic``)."""
    rng = np.random.default_rng(seed)
    base = np.kron(rng.integers(0, 256, (-(-h // 16), -(-w // 16), 3)),
                   np.ones((16, 16, 1)))[:h, :w]
    a = (np.kron(rng.integers(0, 256, (-(-h // 32), -(-w // 32))),
                 np.ones((32, 32)))[:h, :w] if alpha
         else np.full((h, w), 255))
    rgba = np.concatenate([base, a[:, :, None]], axis=-1).astype(np.uint8)
    return Pic(width=w, height=h, depth=32, pitch=w * 4, codec="raw",
               pixels=rgba)


def heif_cases(seed: int = 0) -> dict[str, bytes]:
    """Small HEICs (about 128x128) written by the port's encoder at the
    edges of the HEIF path: a 10-bit item, transform skip, transquant
    bypass, deblocking on (with cu_qp_delta), a 2x2 grid with an alpha
    item, and an odd 333x199 single item."""
    from ffpic_tpu_torch.formats.heif_enc import encode_heif
    out = {}
    for kind in ("10bit", "skip", "bypass", "deblock"):
        enc, nalus = hevc_stream(kind, 128, 128, seed + 5)
        out[kind] = heif_item(enc, nalus, 128, 128)
    out["grid_alpha"] = encode_heif(heif_pic(128, 120, seed + 2, True),
                                    qp=24, tile=64)
    out["odd_333x199"] = encode_heif(heif_pic(333, 199, seed + 4), qp=30)
    return out


def hevc_cases(seed: int = 0) -> dict[str, tuple]:
    """Inputs at the edges of K14 ``hevc_residuals``: name -> (tu_meta
    (m, 8) int32, levels int16 packed per TU, bit depth).  Every size
    and kind (4x4 DCT and DST, 8x8, 16x16, 32x32, transform skip,
    bypass) mixed in one list at bit depths 8 and 10, QPs over 0..63,
    levels sparse or dense, at +-32767 and -32768; a list of one TU of
    each size; a single 32x32 TU."""
    rng = np.random.default_rng(seed)

    def tus(kinds, bd, qmax=63):
        rows, lvs = [], []
        for n, dst, skip, byp in kinds:
            lv = rng.integers(-40, 41, n * n)
            r = rng.random()
            if r < 0.3:
                lv[rng.random(n * n) < 0.7] = 0
            elif r < 0.4:
                lv = rng.integers(-32768, 32768, n * n)
            elif r < 0.45:
                lv[:] = 32767
            elif r < 0.5:
                lv[:] = -32768
            rows.append((0, 0, n, int(rng.integers(0, 3)), skip, byp,
                         int(rng.integers(0, qmax + 1)), dst))
            lvs.append(lv)
        return (np.array(rows, np.int32),
                np.concatenate(lvs).astype(np.int16), bd)

    kinds = ([(4, 0, 0, 0)] * 70 + [(4, 1, 0, 0)] * 40 + [(8, 0, 0, 0)] * 30
             + [(16, 0, 0, 0)] * 9 + [(32, 0, 0, 0)] * 3
             + [(4, 0, 1, 0)] * 20 + [(8, 0, 1, 0)] * 3
             + [(4, 0, 0, 1)] * 10 + [(16, 0, 0, 1)] * 2)
    out = {}
    for bd in (8, 10):
        order = rng.permutation(len(kinds))
        out[f"mixed_bd{bd}"] = tus([kinds[i] for i in order], bd)
    out["one_each"] = tus([(4, 0, 0, 0), (4, 1, 0, 0), (8, 0, 0, 0),
                           (16, 0, 0, 0), (32, 0, 0, 0), (4, 0, 1, 0),
                           (4, 0, 0, 1)], 8)
    out["one_32"] = tus([(32, 0, 0, 0)], 10)
    return out


def heif_color_cases(seed: int = 0) -> dict[str, tuple]:
    """Inputs at the edges of K15 ``hevc_yuv_to_rgba``: name -> (Y, U, V
    int16 planes, U = V = None for 4:0:0; out_h, out_w; mode).  Samples
    over -300..555, so that every clip is taken; crops of odd sizes;
    4:0:0; all three modes."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, h, w, oh, ow, mono, mode in (
            ("64_bt601", 64, 64, 64, 64, False, "bt601"),
            ("64_reference", 64, 64, 64, 64, False, "reference"),
            ("crop_61x37", 64, 48, 61, 37, False, "bt601"),
            ("crop_1x1", 8, 8, 1, 1, False, "reference"),
            ("gray_40x24", 40, 24, 33, 24, True, "bt601"),
            ("rgb_16x32", 16, 32, 16, 32, False, "rgb")):
        y = rng.integers(-300, 556, (h, w)).astype(np.int16)
        u = None if mono else rng.integers(-300, 556, (h // 2, w // 2)) \
            .astype(np.int16)
        v = None if mono else rng.integers(-300, 556, (h // 2, w // 2)) \
            .astype(np.int16)
        out[name] = (y, u, v, oh, ow, mode)
    return out


def heif_tile_layouts(seed: int = 0) -> dict[str, tuple]:
    """Canvases of tiles at the edges of K15 ``hevc_yuv_to_rgba``'s one
    launch: name -> (planes, spans, height, width, mode), ``planes`` each
    tile's int16 [Y] or [Y, U, V] (samples over -300..555), ``spans`` its
    (y0, x0, out_h, out_w) in paste order.  A grid of one tile size whose
    edge tiles the canvas crops; tiles that leave part of the canvas
    uncovered (and one outside it); overlapping tiles of unequal sizes
    placed as ``heif._decode_grid`` places them (row r at r * th, column
    c at c * tw of each tile's own size, the later one winning); a 4:0:0
    tile among 4:2:0 ones; tiles at odd offsets and of odd widths, planes
    wider than the tile; a single item."""
    rng = np.random.default_rng(seed)

    def tile(h, w, mono=False, pad=(0, 0)):
        ph, pw = h + pad[0], w + pad[1]
        y = rng.integers(-300, 556, (ph, pw)).astype(np.int16)
        if mono:
            return [y]
        return [y] + [rng.integers(-300, 556, ((ph + 1) // 2, (pw + 1) // 2))
                      .astype(np.int16) for _ in range(2)]

    grid = [(r * 24, c * 32, 24, 32) for r in range(3) for c in range(4)]
    sizes = [(40, 36), (28, 52), (33, 20), (45, 45)]
    unequal = [(r * h, c * w, h, w) for k, (h, w) in enumerate(sizes)
               for r, c in [divmod(k, 2)]]
    odd = [(1, 3, 21, 17), (0, 20, 25, 13), (22, 1, 9, 31)]
    return {
        "grid_cropped": ([tile(24, 32) for _ in grid], grid, 70, 120,
                         "bt601"),
        "uncovered": ([tile(20, 24), tile(16, 40), tile(8, 8)],
                      [(4, 8, 20, 24), (30, 40, 16, 40), (90, 0, 8, 8)],
                      60, 96, "reference"),
        "overlap_unequal": ([tile(h, w) for h, w in sizes], unequal, 80, 96,
                            "bt601"),
        "mono_mix": ([tile(16, 24), tile(16, 24, True), tile(16, 24)],
                     [(0, 0, 16, 24), (0, 24, 16, 24), (16, 0, 16, 24)], 32,
                     48, "rgb"),
        "odd_offsets": ([tile(h, w, pad=(3, 5)) for _, _, h, w in odd], odd,
                        31, 36, "reference"),
        "single": ([tile(61, 37, pad=(3, 11))], [(0, 0, 61, 37)], 61, 37,
                   "bt601"),
    }


# |transMatrix| entries by folded angle, as csrc/hevc_decode.cu's
# trans_coef holds them
_TRANS_A = (64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73, 70, 67,
            64, 61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22, 18, 13, 9, 4, 0)
_DST4_KI = ((29, 55, 74, 84), (74, 74, 0, -74), (84, -29, -74, 55),
            (55, -84, 74, -29))


def trans_coef(k: int, i: int) -> int:
    """K14's entry of the 32-point transMatrix, row k, column i, as
    ``hevc_decode.cu``'s ``trans_coef`` computes it: the angle (2i + 1) k
    mod 128 folded into 0..32 and signed."""
    u = ((2 * i + 1) * k) & 127
    if u > 64:
        u = 128 - u
    return -_TRANS_A[64 - u] if u > 32 else _TRANS_A[u]


def inverse_butterfly(c: np.ndarray, n: int, dst: bool = False
                      ) -> np.ndarray:
    """K14's 1-D inverse transform along the last axis of ``c`` (..., n),
    in int64, as its kernel computes it: the even/odd recursion of
    ``inv_dct`` (the N/2-point transform of the even coefficients, the
    odd part's sums O[i], then E[i] + O[i] and E[i] - O[i]), or the
    direct 4-point DST of ``inv_dst``.  Raises if a sum leaves int32,
    where the kernel keeps them."""
    c = np.asarray(c, np.int64)
    if dst:
        out = sum(np.multiply.outer(c[..., k], _DST4_KI[k])
                  for k in range(4))
    else:
        out = _inv_dct(c, n, 1)
    return out


def _inv_dct(c: np.ndarray, n: int, s: int) -> np.ndarray:
    if n == 1:
        return 64 * c[..., :1]
    e = _inv_dct(c, n // 2, 2 * s)
    out = np.empty(c.shape[:-1] + (n,), np.int64)
    for i in range(n // 2):
        o = sum(trans_coef(k * (32 // n), i) * c[..., k * s]
                for k in range(1, n, 2))
        out[..., i] = e[..., i] + o
        out[..., n - 1 - i] = e[..., i] - o
    if np.abs(out).max(initial=0) >= 2 ** 31 or \
            np.abs(e).max(initial=0) >= 2 ** 31:
        raise OverflowError("a butterfly sum leaves int32")
    return out


def residuals_by_plan(tu_meta: np.ndarray, levels: np.ndarray,
                      bd: int) -> np.ndarray:
    """K14's walk over its launch plan, in numpy: for each CTA row of
    ``hevc_kernels.plan_residuals``, its TUs' descriptors (level offset,
    QP and flags), their levels, the dequant, the column pass and the
    row pass as ``inverse_butterfly`` (the kernel's even/odd butterflies,
    int32 sums), and the skip and bypass cases with the kernel's integer
    arithmetic (int64 dequant product).  The CPU tests hold it against
    the plain version, which checks the plan, the butterflies and the
    kernel's indexing where the kernel cannot run."""
    from ffpic_tpu_torch.coding.hevc_consts import LEVEL_SCALE
    from ffpic_tpu_torch.ops import hevc_kernels as hk
    desc, ctas = hk.plan_residuals(tu_meta)
    out = np.full(int((tu_meta[:, 2].astype(np.int64) ** 2).sum()), -12345,
                  np.int64)
    for start, cnt, l2, _ in ctas:
        n = 1 << l2
        assert 1 <= cnt <= hk.CTA_THREADS // n
        bs = bd + l2 - 5
        sh = 20 - bd
        for off, info in desc[start:start + cnt]:
            qp = int(info) & 255
            lv = levels[off:off + n * n].astype(np.int64).reshape(n, n)
            if info & hk.BYPASS:
                r = lv
            else:
                scale = (16 * LEVEL_SCALE[qp % 6]) << (qp // 6)
                d = np.clip((lv * scale + (1 << (bs - 1))) >> bs, -32768,
                            32767)
                if info & hk.SKIP:
                    r = (d * 128 + (1 << (sh - 1))) >> sh
                else:
                    dst = n == 4 and bool(info & hk.DST)
                    e = np.clip((inverse_butterfly(d.T, n, dst).T + 64)
                                >> 7, -32768, 32767)
                    r = (inverse_butterfly(e, n, dst) + (1 << (sh - 1))) \
                        >> sh
            out[off:off + n * n] = np.clip(r, -32768, 32767).ravel()
    assert (out != -12345).all()
    return out.astype(np.int16)


def heif_tile_tus(data: bytes, item_id: int, structure: dict | None = None):
    """The TU list K14 takes for one single-slice hvc1 item of a HEIC:
    the native syntax pass's (tu_meta (m, 8) int32, levels int16 (the
    TUs' n² sum), bit depth), as ``formats.hevc`` hands them to
    ``ops.hevc_kernels.residuals_packed``."""
    from ffpic_tpu_torch import native
    from ffpic_tpu_torch.coding.hevc_slice import parse_slice_header
    from ffpic_tpu_torch.formats import heif, hevc
    from ffpic_tpu_torch.utils.bitstream import BitReader
    s = structure or heif.parse_structure(data)
    hvcc = s["items"][item_id]["properties"]["hvcC"]
    sps = hevc.parse_sps(hvcc["nalus"]["sps"][0])
    pps = hevc.parse_pps(hvcc["nalus"]["pps"][0])
    blob = heif.read_item(data, s, item_id)
    (nalu,) = [n for n in hevc.split_nalus_length_prefixed(
        blob, hvcc["length_size"]) if hevc.nal_type(n) < 32]
    rbsp = hevc.unescape(nalu)
    r = BitReader(rbsp)
    r.skip_bits(16)
    hdr = parse_slice_header(r, hevc.nal_type(nalu), sps, pps)
    states, mps = hevc._ctx_init_arrays(hdr.qp)
    _ops, tu, levels, *_ = native.hevc_decode_slice(
        rbsp[hdr.data_bit_offset // 8:], hevc._params_for_native(sps, pps,
                                                                 hdr),
        states, mps)
    need = int((tu[:, 2].astype(np.int64) ** 2).sum())
    return np.ascontiguousarray(tu), levels[:need].copy(), \
        sps.bit_depth_luma


def resize_cases(seed: int = 0) -> dict[str, tuple]:
    """Inputs at the edges of K16 ``resize_rgba``: name -> (uint8 image
    (..., H, W, C) as numpy, (h, w)).  A 1080p shrink to 224 x 224 (about
    10 vertical and 18 horizontal taps), a grow from 160 (2 taps), one
    axis kept (skipped) in either place, both kept, odd sizes, 3 and 4
    channels, a batch dimension, and sizes where a tap run starts or ends
    at the image's edge."""
    rng = np.random.default_rng(seed)

    def img(*shape):
        return rng.integers(0, 256, shape, dtype=np.uint8)

    return {
        "shrink_1080p": (img(1, 1080, 1920, 4), (224, 224)),
        "grow_160": (img(2, 160, 160, 4), (224, 224)),
        "keep_h": (img(512, 400, 4), (512, 224)),
        "keep_w_c3": (img(400, 512, 3), (224, 512)),
        "keep_both": (img(64, 48, 4), (64, 48)),
        "odd_333x199_c3": (img(199, 333, 3), (224, 224)),
        "odd_down": (img(2, 199, 333, 4), (97, 61)),
        "odd_up_c3": (img(7, 5, 3), (11, 13)),
        "to_one": (img(37, 29, 4), (1, 1)),
        "from_one": (img(1, 1, 4), (5, 3)),
    }


MEAN_IMAGENET = (0.485, 0.456, 0.406)
STD_IMAGENET = (0.229, 0.224, 0.225)


def normalize_cases(seed: int = 0) -> dict[str, tuple]:
    """Inputs of K17 ``normalize_resize``: name -> (uint8 batch (N, H, W,
    C>=3) as numpy, size or None, mean, std): no resize (the config-5
    path's call), a shrink, a grow, one axis kept, odd sizes, 3 channels,
    the reference's default mean and std and ImageNet's."""
    rng = np.random.default_rng(seed)
    half = ((0.5,) * 3, (0.5,) * 3)
    imagenet = (MEAN_IMAGENET, STD_IMAGENET)

    def batch(*shape):
        return rng.integers(0, 256, shape, dtype=np.uint8)

    return {
        "none_224": (batch(8, 224, 224, 4), None, *half),
        "none_odd_c3": (batch(2, 37, 53, 3), None, *imagenet),
        "shrink_1080p": (batch(1, 1080, 1920, 4), (224, 224), *imagenet),
        "grow_160": (batch(2, 160, 160, 4), (224, 224), *half),
        "keep_w": (batch(2, 96, 128, 4), (64, 128), *imagenet),
        "odd_333x199": (batch(1, 199, 333, 4), (97, 61), *half),
        "same_size": (batch(1, 64, 48, 4), (64, 48), *imagenet),
    }


def config5_members(h: int = 1080, w: int = 1920,
                    webps=("lossy_1080p.webp", "alpha_1080p.webp")) -> list:
    """The mixed batch of BASELINE config 5 (images of several formats
    batched into a model): 4 baseline 4:2:0 JPEGs (q85 and q95 of two
    ``synth_rgb`` images), 2 RGBA PNGs (one with the port's encoder's
    adaptive filters, one with Sub and Up rows only) and 2 committed WebP
    fixtures, interleaved as ``[jpeg, webp, jpeg, png, jpeg, webp, png,
    jpeg]``.  At 1080p these are the members ``chip_smoke.py``'s JPEG,
    PNG and WebP phases make."""
    jpegs = [synth_jpeg_420(h, w, 85, 1), synth_jpeg_420(h, w, 95, 2)]
    px = np.concatenate([synth_rgb(h, w, 31), synth_rgb(h, w, 32)[..., :1]],
                        -1)
    pngs = [png.encode(Pic(pixels=px, width=w, height=h),
                       device=torch.device("cpu")),
            encode_png(px, 6, 8, filters=(1, 2))]
    wp = [webp_fixture(n) for n in webps]
    return [jpegs[0], wp[0], jpegs[1], pngs[0], jpegs[0], wp[1], pngs[1],
            jpegs[1]]


# --- writers of the host codecs' files (BMP, TGA, PSD, TIFF, ICO) ----------
# The card's machine has no PIL: these write, without it, what the port's
# encoders do not (the port's BMP encoder writes 32 bpp top-down only, its
# TGA encoder uncompressed 32 bpp, and there is no PSD, TIFF or ICO
# encoder), each held against PIL or ffpic_tpu.load in the CPU tests.

def packbits(row) -> bytes:
    """PackBits of one row: runs of 3 or more equal bytes as replicate
    runs (header 257 - k, k <= 128), the bytes between them as literal
    runs (header k - 1, k <= 128)."""
    row = np.frombuffer(bytes(row), np.uint8)
    n = len(row)
    if n == 0:
        return b""
    starts = np.flatnonzero(np.r_[True, row[1:] != row[:-1]])
    lens = np.diff(np.r_[starts, n])
    out = bytearray()

    def literal(a, b):
        for k in range(a, b, 128):
            chunk = row[k:min(k + 128, b)]
            out.append(len(chunk) - 1)
            out.extend(chunk.tobytes())

    at = 0
    for s, k in zip(starts[lens >= 3].tolist(), lens[lens >= 3].tolist()):
        literal(at, s)
        left = k
        while left >= 2:
            m = min(left, 128)
            out += bytes([257 - m, row[s]])
            left -= m
        if left:                         # one byte left over: a literal
            out += bytes([0, row[s]])
        at = s + k
    literal(at, n)
    return bytes(out)


def lzw_encode_tiff(data: bytes) -> bytes:
    """TIFF LZW: 8-bit symbols, codes packed MSB first, the code size
    grown one code early (the decoder of ``coding.lzw.lzw_decode_tiff``
    grows it when its next entry is (1 << size) - 1; it adds each entry
    one code after the encoder does), CLEAR when the table is full."""
    clear, eoi = 256, 257
    out = bytearray()
    acc = 0
    bits = 0

    def emit(code, size):
        nonlocal acc, bits
        acc = (acc << size) | code
        bits += size
        while bits >= 8:
            bits -= 8
            out.append((acc >> bits) & 255)
        acc &= (1 << bits) - 1

    size = 9
    table: dict[int, int] = {}
    next_code = 258
    emit(clear, size)
    if data:
        prev = data[0]
        for k in data[1:]:
            key = (prev << 8) | k
            got = table.get(key)
            if got is not None:
                prev = got
                continue
            emit(prev, size)
            if next_code < 4096:
                table[key] = next_code
                next_code += 1
                if next_code == (1 << size) and size < 12:
                    size += 1
            else:
                emit(clear, size)
                table.clear()
                size = 9
                next_code = 258
            prev = k
        emit(prev, size)
        # the decoder adds one more entry on reading that code
        if next_code > 258 and next_code == (1 << size) - 1 and size < 12:
            size += 1
    emit(eoi, size)
    if bits:
        out.append((acc << (8 - bits)) & 255)
    return bytes(out)


def _jpeg_split(data: bytes) -> tuple[bytes, bytes]:
    """A baseline JPEG -> (its DQT and DHT segments between SOI and EOI,
    the JPEGTables of JPEG-in-TIFF; the file without them or APP0)."""
    tables, rest = bytearray(b"\xff\xd8"), bytearray(b"\xff\xd8")
    pos = 2
    while pos < len(data):
        m = data[pos + 1]
        if m == 0xDA:                                 # SOS: scan to EOI
            rest += data[pos:]
            break
        seg = data[pos:pos + 2 + struct.unpack_from(">H", data,
                                                    pos + 2)[0]]
        if m in (0xDB, 0xC4):
            tables += seg
        elif m != 0xE0:
            rest += seg
        pos += len(seg)
    return bytes(tables + b"\xff\xd9"), bytes(rest)


_TIFF_COMPRESSION = {"none": 1, "lzw": 5, "jpeg": 7, "deflate": 8,
                     "packbits": 32773}


def _tiff_page(px: np.ndarray, compression: str, predictor: int,
               rows_per_strip: int | None, tile: tuple | None,
               quality: int) -> tuple[list, list]:
    """One picture's (entries, blobs): its tags as (tag, type, values)
    and its strips' or tiles' compressed bytes."""
    bilevel = px.dtype == bool
    gray = px.ndim == 2
    h, w = px.shape[:2]
    spp = 1 if gray else px.shape[2]
    bps = 1 if bilevel else 8
    if bilevel:
        samples = np.packbits(px.astype(np.uint8), axis=1)   # 1 = white
    else:
        samples = px.reshape(h, w * spp)
        if predictor == 2:
            s = px.reshape(h, w, spp).astype(np.int16)
            s[:, 1:] -= s[:, :-1].copy()
            samples = (s & 255).astype(np.uint8).reshape(h, w * spp)
    jpeg_tables = None

    def pack(block: np.ndarray, pixels: np.ndarray) -> bytes:
        nonlocal jpeg_tables
        if compression == "none":
            return block.tobytes()
        if compression == "packbits":
            return b"".join(packbits(r) for r in block)
        if compression == "deflate":
            return zlib.compress(block.tobytes())
        if compression == "lzw":
            return lzw_encode_tiff(block.tobytes())
        tables, body = _jpeg_split(encode_jpeg(
            pixels, quality, ((1, 1),) if gray else ((2, 2), (1, 1), (1, 1))))
        jpeg_tables = tables
        return body

    blobs = []
    if tile is not None:
        tw, th = tile
        for y in range(0, h, th):
            for x in range(0, w, tw):
                cut = np.zeros((th, tw) + px.shape[2:], px.dtype)
                part = px[y:y + th, x:x + tw]
                cut[:part.shape[0], :part.shape[1]] = part
                blk = np.zeros((th, tw * spp), np.uint8)
                sp = samples[y:y + th, x * spp:(x + tw) * spp]
                blk[:sp.shape[0], :sp.shape[1]] = sp
                blobs.append(pack(blk, cut))
    else:
        rps = rows_per_strip or h
        for y in range(0, h, rps):
            blobs.append(pack(samples[y:y + rps], px[y:y + rps]))
    photometric = (6 if compression == "jpeg" and not gray else
                   1 if gray else 2)
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bps] * spp),
               (259, 3, [_TIFF_COMPRESSION[compression]]),
               (262, 3, [photometric]), (277, 3, [spp])]
    if tile is None:
        entries += [(273, 4, None), (278, 4, [rows_per_strip or h]),
                    (279, 4, [len(b) for b in blobs])]
    else:
        entries += [(322, 3, [tile[0]]), (323, 3, [tile[1]]),
                    (324, 4, None), (325, 4, [len(b) for b in blobs])]
    if predictor != 1:
        entries.append((317, 3, [predictor]))
    if jpeg_tables is not None:
        entries.append((347, 7, jpeg_tables))
        if not gray:
            entries.append((530, 3, [2, 2]))
    return sorted(entries, key=lambda e: e[0]), blobs


def encode_tiff(pages, compression: str = "none", predictor: int = 1,
                rows_per_strip: int | None = None, tile: tuple | None = None,
                quality: int = 90, byteorder: str = "<") -> bytes:
    """A TIFF of one picture or a list of them (one IFD each): (h, w, 3
    or 4) uint8 RGB(A), (h, w) uint8 gray or (h, w) bool bilevel (True
    is white, photometric BlackIsZero).  ``compression``: "none",
    "packbits" (each row on its own), "deflate", "lzw"
    (``lzw_encode_tiff``) or "jpeg": each strip or tile a baseline JPEG
    of ``encode_jpeg`` (4:2:0, YCbCr photometric; gray 1x1) without its
    tables, which go once into the JPEGTables tag.  ``predictor=2``
    writes horizontal differences.  Strips of ``rows_per_strip`` rows,
    or ``tile=(w, h)`` tiles."""
    if isinstance(pages, np.ndarray):
        pages = [pages]
    bo = byteorder
    out = bytearray((b"II*\x00" if bo == "<" else b"MM\x00*")
                    + struct.pack(bo + "I", 0))
    link = 4                                # where the next IFD's offset goes
    sizes = {3: 2, 4: 4, 7: 1}
    for px in pages:
        entries, blobs = _tiff_page(px, compression, predictor,
                                    rows_per_strip, tile, quality)
        offsets = []
        for b in blobs:
            offsets.append(len(out))
            out += b + b"\0" * (len(b) & 1)
        packed = []
        for tag, typ, vals in entries:
            if vals is None:
                vals = offsets
            n = len(vals)
            raw = bytes(vals) if typ == 7 else struct.pack(
                bo + {3: "H", 4: "I"}[typ] * n, *vals)
            if sizes[typ] * n > 4:
                at = len(out)
                out += raw + b"\0" * (len(raw) & 1)
                raw = struct.pack(bo + "I", at)
            packed.append(struct.pack(bo + "HHI", tag, typ, n)
                          + raw.ljust(4, b"\0"))
        ifd = len(out)
        struct.pack_into(bo + "I", out, link, ifd)
        out += struct.pack(bo + "H", len(packed)) + b"".join(packed)
        link = len(out)
        out += struct.pack(bo + "I", 0)
    return bytes(out)


def encode_bmp(pixels: np.ndarray, bpp: int = 24, top_down: bool = False,
               masks: tuple | None = None) -> bytes:
    """A BMP of (h, w, 3 or 4) uint8 RGB(A): 24 bpp (BGR), 32 bpp (BGRA,
    or with ``masks`` = (r, g, b, a) BI_BITFIELDS masks) or 16 bpp
    (``masks`` = (r, g, b), default 5-5-5); bottom-up unless
    ``top_down``; a 40-byte info header, masks after it."""
    h, w = pixels.shape[:2]
    rgba = pixels if pixels.shape[2] == 4 else np.dstack(
        [pixels, np.full((h, w), 255, np.uint8)])
    comp = 0
    extra = b""
    if bpp == 24:
        rows = rgba[..., [2, 1, 0]].reshape(h, w * 3)
    elif bpp in (16, 32) and (masks is not None or bpp == 16):
        masks = masks or (0x7C00, 0x03E0, 0x001F)
        comp = 3
        word = np.zeros((h, w), np.uint64)
        for c, m in enumerate(masks):
            if not m:
                continue
            shift = (m & -m).bit_length() - 1
            width = (m >> shift).bit_length()
            v = rgba[..., c].astype(np.uint64) * ((1 << width) - 1) // 255
            word |= v << np.uint64(shift)
        extra = struct.pack("<III", *masks[:3])
        dt = "<u2" if bpp == 16 else "<u4"
        rows = word.astype(dt).view(np.uint8).reshape(h, w * bpp // 8)
    elif bpp == 32:
        rows = rgba[..., [2, 1, 0, 3]].reshape(h, w * 4)
    else:
        raise ValueError(f"bpp {bpp}")
    pitch = -(-rows.shape[1] // 4) * 4
    img = np.zeros((h, pitch), np.uint8)
    img[:, :rows.shape[1]] = rows
    if not top_down:
        img = img[::-1]
    off = 14 + 40 + len(extra)
    body = img.tobytes()
    return (struct.pack("<2sIHHI", b"BM", off + len(body), 0, 0, off)
            + struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1,
                          bpp, comp, len(body), 2835, 2835, 0, 0)
            + extra + body)


def _bmp_rle_row(row: np.ndarray, bpp4: bool) -> bytes:
    """One row of palette indices as RLE8/RLE4 pairs: runs of 3 or more
    equal indices (up to 255) in encoded mode, the indices between them
    in absolute mode (3 to 255 of them, word-padded) or as runs of 1 or
    2; then end of line."""
    out = bytearray()
    n = len(row)
    starts = np.flatnonzero(np.r_[True, row[1:] != row[:-1]]) if n else \
        np.zeros(0, np.int64)
    lens = np.diff(np.r_[starts, n]).astype(int)

    def encoded(v, k):
        while k:
            m = min(k, 255)
            out.extend((m, (v << 4) | v if bpp4 else v))
            k -= m

    def absolute(a, b):
        for k in range(a, b, 255):
            seg = row[k:min(k + 255, b)]
            if len(seg) < 3:
                for v in seg.tolist():
                    encoded(v, 1)
                continue
            out.extend((0, len(seg)))
            if bpp4:
                s = np.r_[seg, 0] if len(seg) & 1 else seg
                data = ((s[0::2] << 4) | s[1::2]).astype(np.uint8).tobytes()
            else:
                data = seg.astype(np.uint8).tobytes()
            out.extend(data + b"\0" * (len(data) & 1))

    at = 0
    for s, k in zip(starts[lens >= 3].tolist(), lens[lens >= 3].tolist()):
        absolute(at, s)
        encoded(int(row[s]), k)
        at = s + k
    absolute(at, n)
    out.extend((0, 0))
    return bytes(out)


def encode_bmp_palette(indices: np.ndarray, palette: np.ndarray,
                       bpp: int = 8, rle: bool = False) -> bytes:
    """A palette BMP of (h, w) indices into ``palette`` ((n, 3) uint8
    RGB, n <= 2**bpp), bottom-up: 1, 4 or 8 bpp rows, or with ``rle``
    RLE8 (8 bpp) or RLE4 (4 bpp) ending in end of bitmap."""
    h, w = indices.shape
    idx = indices.astype(np.uint8)[::-1]
    if rle:
        comp = {8: 1, 4: 2}[bpp]
        body = b"".join(_bmp_rle_row(r, bpp == 4) for r in idx) + b"\0\1"
    else:
        comp = 0
        bits = np.unpackbits(idx[..., None], axis=-1)[..., 8 - bpp:]
        rows = np.packbits(bits.reshape(h, w * bpp), axis=1)
        pitch = -(-rows.shape[1] // 4) * 4
        img = np.zeros((h, pitch), np.uint8)
        img[:, :rows.shape[1]] = rows
        body = img.tobytes()
    pal = np.zeros((len(palette), 4), np.uint8)
    pal[:, :3] = np.asarray(palette, np.uint8)[:, [2, 1, 0]]
    off = 14 + 40 + pal.nbytes
    return (struct.pack("<2sIHHI", b"BM", off + len(body), 0, 0, off)
            + struct.pack("<IiiHHIIiiII", 40, w, h, 1, bpp, comp, len(body),
                          2835, 2835, len(palette), 0)
            + pal.tobytes() + body)


def quantize_332(rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(h, w, 3) uint8 -> (indices, palette): the 256-colour 3-3-2 cube,
    index r >> 5 << 5 | g >> 5 << 2 | b >> 6."""
    idx = ((rgb[..., 0] >> 5) << 5) | ((rgb[..., 1] >> 5) << 2) | (
        rgb[..., 2] >> 6)
    k = np.arange(256)
    palette = np.stack([(k >> 5) * 255 // 7, ((k >> 2) & 7) * 255 // 7,
                        (k & 3) * 255 // 3], -1).astype(np.uint8)
    return idx.astype(np.uint8), palette


def encode_tga(pixels: np.ndarray, rle: bool = True,
               top_origin: bool = False) -> bytes:
    """A truecolor TGA of (h, w, 3 or 4) uint8 RGB(A): 24 or 32 bpp, RLE
    packets (runs of 2 or more equal pixels, up to 128) or raw, bottom
    origin unless ``top_origin``."""
    h, w, nch = pixels.shape
    px = pixels[..., [2, 1, 0, 3][:nch]]
    if not top_origin:
        px = px[::-1]
    hdr = bytearray(18)
    hdr[2] = 10 if rle else 2
    struct.pack_into("<HH", hdr, 12, w, h)
    hdr[16] = 8 * nch
    hdr[17] = (0x20 if top_origin else 0) | (8 if nch == 4 else 0)
    if not rle:
        return bytes(hdr) + px.tobytes()
    flat = px.reshape(-1, nch)
    word = flat.astype(np.uint32) @ (256 ** np.arange(nch, dtype=np.uint32))
    n = len(word)
    out = bytearray(hdr)
    starts = np.flatnonzero(np.r_[True, word[1:] != word[:-1]])
    lens = np.diff(np.r_[starts, n])
    at = 0

    def raw(a, b):
        for k in range(a, b, 128):
            m = min(128, b - k)
            out.append(m - 1)
            out.extend(flat[k:k + m].tobytes())

    for s, k in zip(starts[lens >= 2].tolist(), lens[lens >= 2].tolist()):
        raw(at, s)
        for q in range(s, s + k, 128):
            m = min(128, s + k - q)
            out.append(0x80 | (m - 1))
            out.extend(flat[q].tobytes())
        at = s + k
    raw(at, n)
    return bytes(out)


def encode_psd(pixels: np.ndarray, rle: bool = True) -> bytes:
    """A PSD (version 1, 8 bits) of (h, w, 3 or 4) uint8 RGB(A), or (h, w)
    grey: the composite image's planes raw or, with ``rle``, as
    PackBits rows behind their table of 2-byte row counts."""
    gray = pixels.ndim == 2
    h, w = pixels.shape[:2]
    planes = [pixels] if gray else [pixels[..., c]
                                    for c in range(pixels.shape[2])]
    hdr = struct.pack(">4sH6sHIIHH", b"8BPS", 1, b"\0" * 6, len(planes),
                      h, w, 8, 1 if gray else 3)
    body = struct.pack(">III", 0, 0, 0)   # colour mode, resources, layers
    if not rle:
        return hdr + body + struct.pack(">H", 0) + b"".join(
            np.ascontiguousarray(p).tobytes() for p in planes)
    rows = [packbits(p[y].tobytes()) for p in planes for y in range(h)]
    return (hdr + body + struct.pack(">H", 1)
            + struct.pack(f">{len(rows)}H", *map(len, rows))
            + b"".join(rows))


def encode_ico(entries) -> bytes:
    """An ICO of ``entries``, each (h, w, 4) uint8 RGBA (up to 256 x 256)
    written as a 32 bpp BMP payload with its AND mask (1 where alpha is
    0), or the bytes of a PNG, stored as they are."""
    dir_, blobs = [], []
    for e in entries:
        if isinstance(e, (bytes, bytearray)):
            w, h = struct.unpack_from(">II", e, 16)
            blob = bytes(e)
        else:
            h, w = e.shape[:2]
            xor = e[::-1, :, [2, 1, 0, 3]].tobytes()
            mask = np.packbits((e[::-1, :, 3] == 0).astype(np.uint8), axis=1)
            mpitch = -(-mask.shape[1] // 4) * 4
            mrows = np.zeros((h, mpitch), np.uint8)
            mrows[:, :mask.shape[1]] = mask
            blob = (struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, 32, 0,
                                len(xor) + mrows.nbytes, 0, 0, 0, 0)
                    + xor + mrows.tobytes())
        dir_.append((w & 255, h & 255, len(blob)))
        blobs.append(blob)
    off = 6 + 16 * len(entries)
    out = bytearray(struct.pack("<HHH", 0, 1, len(entries)))
    for (w8, h8, size), blob in zip(dir_, blobs):
        out += struct.pack("<BBBBHHII", w8, h8, 0, 0, 1, 32, size, off)
        off += size
    return bytes(out) + b"".join(blobs)
