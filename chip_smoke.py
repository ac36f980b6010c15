#!/usr/bin/env python3
"""Smoke run of ffpic_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``ffpic_tpu_torch/csrc`` (nvcc, one
process per source) and the host library ``ffpic_tpu_torch/native/``
``host_jpeg.c``, ``host_png.c``, ``host_vp8.c``, ``host_vp8l.c``,
``host_hevc.c``, ``host_lzw.c``, ``host_jp2.c``, ``host_av1.c``,
``host_av1_itx.c`` (cc, one process a source),
holds each kernel against its plain PyTorch version on the card
(bit-exact) at its paths' shapes and at the edges of its tiling
(``testing.scan_cases``, ``unpack_cases``, ``idct_cases``,
``assemble_cases``, ``mcu_cases``, ``scatter_cases``,
``unfilter_cases``, ``rgba_cases``, ``vp8_cases``, ``hevc_cases``,
``heif_color_cases``), and drives
these paths, each with the launch counts set to 0 just before it and
read just after:

* ``decode_batch`` over 8 baseline 4:2:0 1920x1080 JPEGs made from a
  seed (K1a count_scan, K1b unpack, K2 dequant_idct, K3 assemble_color),
  with the dense route checked against the plain route;
* ``load`` of one 4000x3000 baseline 4:2:2 JPEG with restart markers
  (``mode="bt601", upsample="fancy"``: K2, K4 assemble_mcu), checked
  against the CPU route and its source; other samplings (4:4:4, 4:2:0
  fancy, 4:4:0, 4:1:1, gray, a Cr table of its own) and a
  ``decode_batch`` mixing 4:2:0 and 4:4:4 members (also under a side
  stream while the default stream is busy) are checked too;
* ``encode`` of a 1920x1080 image at q90 (K5 fdct), whose bytes must
  be the CPU route's and decode back within 30 dB;
* ``load`` of two 1920x1080 RGBA PNGs, one written by the port's
  ``png.encode`` (adaptive filters, all five types: host C unfilter,
  then K7 assemble_rgba) and one by ``testing.encode_png`` with Sub and
  Up rows only (K6 unfilter_subup, then K7), each equal to its source
  pixels; smaller palette, 16-bit, gray and Adam7 files against the CPU
  route; K7 is held to its plain version on all fifteen (colour type,
  bit depth) instances at widths 37 and 64, with contiguous rows and at
  pitches aligned to 16, 8 and 4 bytes and at an odd address;
* ``decode_batch`` over 4 baseline 4:2:0 1080p JPEGs and 4 1080p RGBA
  PNGs (K1a-K3, K6, K7), against the CPU route;
* the sparse route of dense 4:2:0 members, reached through the
  pipeline's dense-member staging (``pipeline.member_pairs`` in a pool,
  then ``pipeline.decode_dense_members``) with the 8 x 1080p batch's
  dense planes (K8 scatter_planes once over the three, then K2 and K3), against
  the plain route; the dense route (``pipeline.decode_planes``) timed
  beside it;
* the device Huffman decode (K9 entropy_decode, K10 spec_scan, K11
  spec_merge; ``testing.entropy_cases`` and the path shapes against
  their plain versions and the host decoder): ``dri batch``, the batch's
  pixels and qualities as baseline 4:2:0 JPEGs with a restart marker
  every MCU row, through ``decode_batch`` with every member on the card
  (``FFPIC_HYBRID=0``: K9 once), with the default hybrid split (K9 once
  for 4 members, the host route for 4) and with
  ``FFPIC_DEVICE_ENTROPY=0`` (the host route), all three equal; ``dri
  mixed``, 1080p, 720p and 512x512 DRI members at three qualities in
  one K9 launch, equal to the host route; ``spec batch``, the batch's
  DRI-less files under ``FFPIC_SPEC_ENTROPY=1`` (K10, K11, K9 once each,
  no fallback), equal to the host route.  The end-to-end medians are
  printed under the JAX bench's names (``device_entropy_dri_mps``,
  ``hybrid_pipeline_mps``, ``device_entropy_spec_mps``) beside the host
  route and the host spans; ``[time entropy kernels]`` gives K9's CTAs,
  each kernel's ns a symbol on its longest lane (K10: chunk; K11: walk,
  replayed by ``testing.merge_work``) and the share of symbols the fast
  table answers (``fast_walks`` replays K9's
  lanes and K10's chunks with the plain step on the card);
* WebP (K12 vp8_residuals, K13 vp8_yuv_to_rgba; ``testing.vp8_cases``
  and the 1080p fixture's parse state and planes against their plain
  versions, and against the host transform and colour; K13's batch
  entry on lists of ``k13_cases``, each in one launch: mixed sizes and
  alpha, staged, MB-padded and pitched planes, outputs off 16 bytes,
  frames that end inside tiles, 70 frames in two launches, and the
  webp batch's 8 frames): ``load`` of
  each committed fixture of ``ffpic_tpu_torch/testdata`` (1080p lossy,
  512x512, 1080p with alpha, 333x199, VP8L, animated) under the four
  combinations of ``FFPIC_VP8_DEVICE`` (K12 once a VP8 picture) and
  ``FFPIC_VP8_DEVICE_COLOR`` (K13 once a still), each equal to the CPU
  route; ``decode_batch`` of 8 x 1080p WebPs under the colour switch
  (K13 once over the 8) and of 4 JPEGs, 2 PNGs and 2 WebPs under both
  (K12 twice, K13 once), each equal to the CPU route.  The load medians
  are printed under the JAX bench's names (``webp_512_mps`` for the
  default route, ``webp_device_mps`` for ``FFPIC_VP8_DEVICE``) beside
  the colour route and the host spans;
* the VP8 luma wavefront (K18 vp8_wavefront, B12; ``testing.
  wavefront_cases`` and every committed lossy fixture's frames against
  the plain version, each launched twice, and against the host
  ``native.vp8_recon``'s luma, as are tall grids of 1200 x 2 and 9000 x
  2 macroblocks): ``ops.vp8_wavefront.make_wavefront`` on
  the 1080p fixture (K18 once a frame), and the chain on the card, the
  frame's levels through K12 into K18, both equal to the host's luma;
  ``[time wavefront]`` gives K18 at 1080p and 512x512 beside its chain
  of 2 (mbh - 1) + mbw macroblock steps, the cost c of one macroblock
  step from one-row frames of 120 B_PRED or 16x16 macroblocks, the row
  hand-off L that T = (2 (mbh - 1) + mbw) c + (mbh - 1) L then implies,
  and the host ``vp8_recon`` (Y, U and V, host clock, median of 5);
* HEIF (K14 hevc_residuals, K15 hevc_yuv_to_rgba; ``testing.hevc_cases``
  each in a launch of its own, the TU lists of the committed 12 MP
  grid's 48 tiles in one launch; K15's one launch over a canvas's tiles
  on ``heif_color_cases`` as single items and at an offset of a larger
  canvas, on ``heif_tile_layouts`` (cropped edge tiles, an uncovered
  canvas, overlapping tiles of unequal sizes, 4:0:0) and on the
  fixture's 48 tiles in three modes, against their plain versions):
  ``load`` of
  ``ffpic_tpu_torch/testdata/heic_12mp_grid.heic`` and of the small
  HEICs of ``testing.heif_cases`` (10-bit, transform skip, bypass,
  deblocking on, a 2x2 grid with alpha, 333x199) under the four
  combinations of ``FFPIC_HEVC_DEVICE`` (K14 once a grid or single
  item) and ``FFPIC_HEIF_DEVICE_COLOR`` (K15 once a picture), each equal to
  the CPU route, the fixture also against its source content;
  ``decode_batch`` of two HEICs beside a JPEG under each combination.
  The load medians are printed under the JAX bench's names
  (``heic_12mp_mps``, ``heic_device_mps``) and as
  ``heic_device_color_mps``, with the host spans (``hevc.
  residuals_device`` apart, and beside it the sum over a load's tiles
  of ``hevc.residuals_part``, each tile's share of the plan made in the
  syntax phase's workers) and the grid pool's worker count; K14 is
  timed a launch (the median tile alone) and a load (one launch over
  the 48 tiles, with the 48 launches of a launch a tile beside it),
  against its bound by bytes and the operations it runs (``hevc_ops``)
  and, under its own name, the direct product's 4 n^3 a TU; K15 a
  load (one launch over the 48 tiles that also fills the canvas);
* BASELINE config 5 (``config5_paths``): a mixed 1080p batch through
  ``decode_batch(size=(224, 224))`` (K16 once), ``normalize_for_model``
  (K17) and ViT-B/16 (``vit_pair``: published widths, seeded weights),
  the card's logits against the CPU forward's; K16 once by each of
  ``jax.image.resize``'s methods (``RESIZE_METHODS``) over the batch's 8
  slots, each against its plain version and timed beside its bound and,
  where one exists, ``F.interpolate`` (``nearest-exact``, ``bicubic``
  with antialiasing);
* the host-only codecs (``host_codec_paths``): BMP (24 bpp, 8 bpp RLE),
  GIF, TGA RLE, PNM, PSD RLE and TIFF (LZW with predictor, PackBits,
  deflate, JPEG strips) files of 1920x1080 ``synth_rgb`` content and a
  256x256 ICO of a PNG and a BMP entry, each ``load`` on the card equal
  to the CPU's (TIFF's JPEG strips: K2, K4; ICO's PNG entry: K6, K7);
  ``decode_batch`` of 8 of them at size=(224, 224) (K16 once) equal to
  the CPU route, ``normalize_for_model`` (K17 once) and ViT-B/16 within
  config 5's tolerance; each ``load``'s MP/s and the batch's wall time
  with its spans;
* the HEVC inter slice (``hevc_inter_paths``), under
  ``FFPIC_HEVC_DEVICE=1`` and ``FFPIC_HEIF_DEVICE_COLOR=1``:
  ``load_all`` of ``testdata/inter_1080p.265`` (5 pictures of 1920x1080,
  I/P/B) and of ``testdata/sequence_1080p.heic`` (a still primary and a
  3-frame I/P/B image sequence), then one ``decode_batch`` of both, each
  decoded once; every picture's Y/U/V planes against libde265's digests
  (``testdata/hevc_fixtures.json``), every K14 launch (once a picture)
  and K15 launch (once a frame) against its plain version on the same
  inputs; each run's host clock, frames/s and spans, and K14 timed on
  the largest P/B picture's TUs, K15 on a 1080p frame;
* the model-consumer and multi-device layers (``train_paths``):
  one ``vit.make_train_step`` step of ViT-B/16 on config 5's normalised
  batch and one ``moe.make_train_step`` step of ``MOE_TINY``, each
  against the same step on the CPU (the loss and every tensor's
  update), the ViT step timed (CUDA events, median of 5, TFLOP/s of 3 x
  its forward's products); on a world of one over NCCL,
  ``parallel.sharded_decode_420`` of the batch's dense coefficients and
  ``decode_batch(mesh=)`` of its files (K2 x 1, K3 x 1 each), both
  bit-equal to ``decode_batch(mesh=None)``, with their MP/s; and
  ``graft_entry.entry()`` (K2 + K3) against the plain route;
* the still codecs (``still_codec_paths``): JPEG 2000 (5/3 with
  the RCT; 9/7 with the ICT, 512 x 512 tiles and 3 layers), OpenEXR
  (none, ZIP, PXR24, B44, PIZ, DWAA, DWAB) and SVG files at 1920x1080
  and a BPG header, all decoded on the host as in the reference: each
  ``load`` on the card equal to the CPU's (pixels, meta and
  ``exr_planes``) with no launch, the BPG's header equal and its pixel
  decode ``NotImplementedError``; ``decode_batch`` of 8 of them at
  size=(224, 224) (K16 once) against the plain resize of the CPU loads'
  pixels, ``normalize_for_model`` (K17 once) and ViT-B/16 within config
  5's tolerance; each load's MP/s with its decoder spans
  (``jp2.tier2``, ``jp2.tier1``, ``jp2.synthesis``, ``exr.decompress``,
  ``exr.piz_huffman``, ``svg.raster``) and the batch's wall time with
  its spans; ``start_profiler``/``stop_profiler`` trace K17 with CUDA
  activity;
* AVIF (``avif_paths``, last): the committed 1920x1080 fixtures of
  ``testdata/`` (4:2:0; 4:4:4 with an alpha item; a 2x2 grid of 960x540
  tiles; 128x128 superblocks with loop restoration; an animation of 3
  frames with film grain, ``avis_1080p_grain.avif``) and the 64x48
  animation, decoded on the host by the AV1 decoder (intra: its native
  C; inter frames, motion compensation and film grain: Python and
  numpy), as in the reference: each ``load`` (``load_all`` for an
  animation) on the card equal to the CPU's (pixels, meta,
  ``delay_ms``) with no launch, and its pixels' sha256 the one recorded
  with the JAX package (``testdata/avif_fixtures.json``); the 1080p
  animation's loads and the encoder run in four worker processes
  (``avif_worker``) beside the rest; ``decode_batch`` of 8 of them,
  the animation in place of one still, at size=(224, 224) (K16 once)
  against the plain resize of the CPU loads' pixels,
  ``normalize_for_model`` (K17 once) and ViT-B/16 within config 5's
  tolerance; ``encode(pic, "AVIF")`` of the 1080p 4:2:0 still's pixels
  at quality 75 and of a 320x240 crop at 100, bytes and decodes equal
  to the CPU's; each load's MP/s with its spans (``av1.headers``,
  ``av1.parse``, ``av1.recon``, ``av1.mc``, ``av1.deblock``,
  ``av1.cdef``, ``av1.lr``, ``av1.superres``, ``av1.grain``,
  ``avif.color``), the batch's and each encode's wall time.

It times each kernel, warm and with L2 flushed, beside its bound, its
plain version, one PyTorch call of the same function where there is
one (``torch.cumsum`` for ``count_scan``, ``torch.zeros`` +
``index_add_`` for ``scatter_plane``, a device copy of the rows for
``assemble_rgba`` on 8-bit RGBA, warm and L2-flushed; both warm over
eight copies of the rows in turn, 66 MB that L2 cannot hold, so that
the bound by device memory applies, and beside that with the rows
resident in L2) and the launch
floor (the fastest
empty launch in the same loop), and each path end to end with its host
spans.  One line per phase; then the kernel table as
one JSON line, and last ``{"ok": true, "device": {...}}``.  Any failure
raises and exits non-zero; without CUDA it exits 1 at once.
"""

from __future__ import annotations

import contextlib
import hashlib
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

H, W, N = 1080, 1920, 8
BIG_H, BIG_W = 3000, 4000           # the load path: a 12 MP phone photo
CU = "ffpic_tpu_torch/csrc/jpeg_decode.cu"
CODEC_CU = "ffpic_tpu_torch/csrc/jpeg_codec.cu"
PNG_CU = "ffpic_tpu_torch/csrc/png_decode.cu"
ENTROPY_CU = "ffpic_tpu_torch/csrc/jpeg_entropy.cu"
VP8_CU = "ffpic_tpu_torch/csrc/vp8_decode.cu"
HEVC_CU = "ffpic_tpu_torch/csrc/hevc_decode.cu"
RESIZE_CU = "ffpic_tpu_torch/csrc/resize.cu"
REPLACES = {
    "count_scan": "ffpic_tpu/ops/jpeg_kernels.py:313",
    "unpack": "ffpic_tpu/ops/jpeg_kernels.py:323",
    "dequant_idct": "ffpic_tpu/ops/pallas_jpeg.py:32",
    "assemble_color": "ffpic_tpu/ops/jpeg_kernels.py:144",
    "assemble_mcu": "ffpic_tpu/ops/jpeg_kernels.py:196",
    "fdct": "ffpic_tpu/ops/jpeg_kernels.py:83",
    "unfilter_subup": "ffpic_tpu/ops/png_kernels.py:89",
    "assemble_rgba": "ffpic_tpu/ops/png_kernels.py:40",
    "scatter_plane": "ffpic_tpu/ops/jpeg_kernels.py:463",
    "entropy_decode": "ffpic_tpu/ops/jpeg_entropy_device.py:139",
    "spec_scan": "ffpic_tpu/ops/jpeg_entropy_device.py:374",
    "spec_merge": "ffpic_tpu/ops/jpeg_entropy_device.py:490",
    "vp8_residuals": "ffpic_tpu/ops/vp8_kernels.py:69",
    "vp8_yuv_to_rgba": "ffpic_tpu/ops/vp8_kernels.py:107",
    "hevc_residuals": "ffpic_tpu/ops/hevc_kernels.py:80",
    "hevc_yuv_to_rgba": "ffpic_tpu/formats/heif.py:356",
    "resize_rgba": "ffpic_tpu/ops/resize.py:13",
    "normalize_resize": "ffpic_tpu/ops/resize.py:27",
    "vp8_wavefront": "ffpic_tpu/ops/vp8_wavefront.py:171 make_wavefront",
}
SOURCES = {"assemble_mcu": CODEC_CU, "fdct": CODEC_CU,
           "unfilter_subup": PNG_CU, "assemble_rgba": PNG_CU,
           "entropy_decode": ENTROPY_CU, "spec_scan": ENTROPY_CU,
           "spec_merge": ENTROPY_CU, "vp8_residuals": VP8_CU,
           "vp8_yuv_to_rgba": VP8_CU, "hevc_residuals": HEVC_CU,
           "hevc_yuv_to_rgba": HEVC_CU, "resize_rgba": RESIZE_CU,
           "normalize_resize": RESIZE_CU, "vp8_wavefront": VP8_CU}
PATH_420 = ("count_scan", "unpack", "dequant_idct", "assemble_color")


def log(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def max_abs_err(a, b) -> int:
    import torch
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) \
        if a.numel() else 0


def exact(name: str, got, want, errs: dict) -> None:
    err = max_abs_err(got, want)
    errs[name] = max(errs.get(name, 0), err)
    if err:
        raise AssertionError(f"{name}: kernel differs from its plain version "
                             f"by up to {err}")


def ptxas_report(text: str) -> dict:
    """``nvcc -Xptxas -v`` output -> {kernel: {registers, smem_bytes,
    stack_bytes, spill_bytes}}, a template instance named with its
    arguments, e.g. ``assemble_color<1,0>`` (mode, order),
    ``assemble_mcu<1,0,1>`` (mode, order, fancy), ``unfilter_subup<4>``
    (bytes a pixel) or ``assemble_rgba<6,8>`` (colour type, bit
    depth), ``hevc_yuv_to_rgba<1>`` (mode), ``resize<0,2>`` (K16) and
    ``resize<1,2>`` (K17) at two output rows a CTA (``<.,1>`` at one),
    ``resize_gather<1>`` (K16 by nearest, 32-bit loads); K9-K15 and
    ``resize_band`` (K16 by cubic and Lanczos) have no template
    arguments."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"(count_scan|unpack|dequant_idct|assemble_color|"
                          r"assemble_mcu|fdct|scatter_planes|"
                          r"unfilter_subup|assemble_rgba|entropy_decode|"
                          r"spec_scan|spec_merge|vp8_residuals|"
                          r"vp8_yuv_to_rgba|hevc_residuals|"
                          r"hevc_yuv_to_rgba|resize_gather|resize_band|"
                          r"resize|vp8_wavefront)_kernel"
                          r"((?:L[ib]\d+E)*)",
                          m.group(1).replace("_kernelI", "_kernel"))
            args = re.findall(r"L[ib](\d+)E", k.group(2))
            name = k.group(1) + (f"<{','.join(args)}>" if args else "")
            out[name] = {}
        elif name and "stack frame" in line:
            stack, st, ld = map(int, re.findall(r"(\d+) bytes", line))
            out[name].update(stack_bytes=stack, spill_bytes=st + ld)
        elif name and "registers" in line:
            out[name]["registers"] = int(re.search(r"(\d+) registers",
                                                   line).group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[name]["smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def codec_paths(dev, jpegs, floor_ms: float, errs: dict) -> dict:
    """The JPEG codec on the card: K4 and K5 (and K2 on per-component
    views) against their plain versions, the ``load`` and ``encode``
    paths each driven with fresh launch counts and checked, a
    ``decode_batch`` with a 4:4:4 member, and the timings.  Returns
    {kernel: timing entry} and the launches of each path."""
    import numpy as np
    import torch
    import ffpic_tpu_torch
    from ffpic_tpu_torch import Pic, testing
    from ffpic_tpu_torch.formats import jpg
    from ffpic_tpu_torch.formats.jpg_encode import _rgb_to_yuv420, _to_blocks
    from ffpic_tpu_torch.ops import cuda_jpeg
    from ffpic_tpu_torch.ops import jpeg_kernels as jk
    from ffpic_tpu_torch.ops.resize import resize_rgba
    from ffpic_tpu_torch.utils.timing import (F32_OPS_PER_S, INT32_OPS_PER_S,
                                              bound, gpu_ms, gpu_ms_cold)

    modes, orders = ("reference", "bt601", "rgb"), ("rgba", "bgra")

    def ups(samplings):
        return ("nearest", "fancy") if testing.fancy_ok(samplings) \
            else ("nearest",)

    # --- inputs ------------------------------------------------------------
    t0 = time.perf_counter()
    big_rgb = testing.synth_rgb(BIG_H, BIG_W, 21)
    t1 = time.perf_counter()
    big = testing.encode_jpeg(big_rgb, 90, testing.SAMPLINGS["422"],
                              restart_interval=64)
    t2 = time.perf_counter()
    log("inputs codec", load_jpeg=f"{BIG_W}x{BIG_H} 4:2:2 q90 DRI 64",
        bytes=len(big), synth_rgb_seconds=f"{t1 - t0:.3f}",
        encode_seconds=f"{t2 - t1:.3f}",
        synthesis_seconds=f"{t2 - t0:.3f}")
    j, _ = jpg.parse_and_decode(big)
    shapes = tuple((c.nby, c.nbx) for c in j.comps)
    hmax, vmax = max(c.h for c in j.comps), max(c.v for c in j.comps)
    samplings = tuple((vmax // c.v, hmax // c.h) for c in j.comps)
    nblocks = sum(a * b for a, b in shapes)
    ow = (BIG_W + 7) & ~7
    coeffs = torch.from_numpy(np.concatenate(
        [c.reshape(-1, 64) for c in j.coeffs]).reshape(-1, 8, 8)).to(dev)
    quants = np.stack([j.dqt[c.tq] for c in j.comps])
    qd = torch.from_numpy(quants).to(dev)
    if not np.array_equal(quants[1], quants[2]):
        raise AssertionError("the load file's chroma must share a table")

    # --- K2 on the load path's layouts ---------------------------------------
    c4 = coeffs.view(1, -1, 8, 8)
    ny = shapes[0][0] * shapes[0][1]
    samples4 = cuda_jpeg.dequant_idct(c4, qd[0:1], qd[1:2], ny)
    exact("dequant_idct", samples4,
          jk.dequant_idct_blocks(c4, qd[0:1], qd[1:2], ny), errs)
    rng = np.random.default_rng(5)
    rq = torch.from_numpy(rng.integers(1, 65536, (3, 64),
                                       dtype=np.int32)).to(dev)
    views = torch.empty_like(c4)
    bounds = [0, ny, ny + shapes[1][0] * shapes[1][1], nblocks]
    for c in range(3):
        a, b = bounds[c], bounds[c + 1]
        cuda_jpeg.dequant_idct(c4[:, a:b], rq[c:c + 1], rq[c:c + 1], b - a,
                               out=views[:, a:b])
        exact("dequant_idct", views[:, a:b], jk.dequant_idct_blocks(
            c4[:, a:b], rq[c:c + 1], rq[c:c + 1], b - a), errs)
    log("check K2 views", shapes=shapes, tables="distinct Cb/Cr, full "
        "range", per_component="exact", shared_tables_12mp="exact")
    samples = samples4[0]

    # --- K4 against its plain version ---------------------------------------
    n = 0
    for name, (smp, sh, sa, oh, cw) in testing.mcu_cases().items():
        smp = torch.from_numpy(smp).to(dev)
        for up in ups(sa):
            for mode in modes:
                for order in orders:
                    for gray in ((128, 0) if len(sh) == 1 else (128,)):
                        exact("assemble_mcu", cuda_jpeg.assemble_mcu(
                            smp, sh, sa, oh, cw, order, mode, gray, up),
                            jk.assemble_mcu(smp, sh, sa, oh, cw, order,
                                            mode, gray, up), errs)
                        n += 1
    for up in ("nearest", "fancy"):
        for mode in modes:
            for order in orders:
                exact("assemble_mcu", cuda_jpeg.assemble_mcu(
                    samples, shapes, samplings, BIG_H, ow, order, mode, 128,
                    up), jk.assemble_mcu(samples, shapes, samplings, BIG_H,
                                         ow, order, mode, 128, up), errs)
                n += 1
    log("check K4", assemble_mcu="exact", launches=n,
        cases=",".join(testing.mcu_cases()) + f",{BIG_W}x{BIG_H}_422",
        modes="x".join(modes), orders="x".join(orders),
        upsample="nearest,fancy(factors<=2)", gray_chroma="128,0")

    # --- K5 against its plain version ---------------------------------------
    enc_rgb = testing.synth_rgb(H, W, 22)
    enc_blocks = torch.from_numpy(np.concatenate(
        [_to_blocks(p).reshape(-1, 8, 8)
         for p in _rgb_to_yuv420(enc_rgb)[:3]])).to(dev)
    for blk in (torch.from_numpy(rng.integers(-128, 128, (5000, 8, 8),
                                              dtype=np.int16)).to(dev),
                torch.from_numpy(rng.integers(-32768, 32768, (5000, 8, 8),
                                              dtype=np.int16)).to(dev),
                enc_blocks, enc_blocks[:33]):
        exact("fdct", cuda_jpeg.fdct(blk), jk.forward_dct(blk), errs)
    log("check K5", fdct="exact", cases="level-shifted,full-int16,"
        f"encode-{enc_blocks.shape[0]}-blocks,33-blocks")

    # --- the load path -------------------------------------------------------
    torch.cuda.synchronize()
    cuda_jpeg.reset_launches()
    pic = ffpic_tpu_torch.load(big, mode="bt601", upsample="fancy")
    torch.cuda.synchronize()
    launches_load = dict(cuda_jpeg.launches)
    px = pic.pixels
    if (tuple(px.shape) != (BIG_H, ow, 4) or px.dtype != torch.uint8
            or px.device.type != dev.type):
        raise AssertionError(f"load gave {tuple(px.shape)} {px.dtype} on "
                             f"{px.device}")
    if launches_load["dequant_idct"] < 1 or launches_load["assemble_mcu"] < 1:
        raise AssertionError(f"load did not run K2 and K4: {launches_load}")
    cpu_pic = ffpic_tpu_torch.load(big, device="cpu", mode="bt601",
                                   upsample="fancy")
    if not torch.equal(px.cpu(), cpu_pic.pixels):
        raise AssertionError("load on the card differs from the CPU route")
    psnr_load = testing.psnr(px[:, :BIG_W, :3], big_rgb)
    if psnr_load < 30 or not torch.all(px[..., 3] == 255):
        raise AssertionError(f"load: PSNR {psnr_load:.2f} dB")
    log("load path", shape=tuple(px.shape), launches=launches_load,
        cpu_route="exact", psnr_db=f"{psnr_load:.2f}")

    # the other samplings, each file through load on the card and the CPU
    gray = testing.encode_jpeg(testing.synth_rgb(H, W, 26)[..., 0], 85,
                               ((1, 1),))
    checks = {
        "1080p_444": (testing.encode_jpeg(testing.synth_rgb(H, W, 23), 85,
                                          testing.SAMPLINGS["444"]),
                      {"mode": "bt601"}),
        "420_fancy": (jpegs[0], {"upsample": "fancy"}),
        "440": (testing.encode_jpeg(testing.synth_rgb(H, W, 24), 85,
                                    testing.SAMPLINGS["440"]),
                {"upsample": "fancy", "order": "bgra"}),
        "411_nearest": (testing.encode_jpeg(testing.synth_rgb(H, W, 25), 85,
                                            testing.SAMPLINGS["411"],
                                            restart_interval=16), {}),
        "gray": (gray, {}),
        "gray_quirks": (gray, {"quirks": True}),
        "cr_table": (testing.encode_jpeg(testing.synth_rgb(H, W, 27), 85,
                                         cr_quality=40), {"mode": "rgb"}),
    }
    for name, (data, kw) in checks.items():
        cuda_jpeg.reset_launches()
        got = ffpic_tpu_torch.load(data, **kw).pixels
        torch.cuda.synchronize()
        k2 = cuda_jpeg.launches["dequant_idct"]
        want = ffpic_tpu_torch.load(data, device="cpu", **kw).pixels
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"load {name}: the card differs from the "
                                 "CPU route")
        if name == "cr_table" and k2 != 3:
            raise AssertionError(f"a distinct Cr table takes 3 K2 launches, "
                                 f"got {k2}")
    log("check load", cases=",".join(checks), cpu_route="exact",
        cr_table_k2_launches=3)

    # decode_batch with 4:4:4 members beside 4:2:0 ones
    mixed = [jpegs[0], checks["1080p_444"][0], jpegs[1], gray]
    got = ffpic_tpu_torch.decode_batch(mixed, device=dev)
    decode_plain = ffpic_tpu_torch.decode_batch(mixed, device="cpu")
    if not torch.equal(got.cpu(), decode_plain):
        raise AssertionError("mixed decode_batch: the card differs from the "
                             "CPU route")
    sized = ffpic_tpu_torch.decode_batch(mixed, size=(224, 224),
                                         device=dev)
    want = torch.stack([resize_rgba(p.to(dev), (224, 224))
                        for p in decode_plain])
    sized_cpu = ffpic_tpu_torch.decode_batch(mixed, size=(224, 224),
                                             device="cpu")
    diff_cpu = max_abs_err(sized.cpu(), sized_cpu)
    if not torch.equal(sized, want) or diff_cpu > 1:
        raise AssertionError("mixed decode_batch size=(224, 224) differs")
    # the same batch under a side stream, read there at once, while the
    # default stream spins: a copy or launch of decode_batch that is not
    # on the caller's stream would be read before it ran
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)             # ~0.2 s on the default stream
    with torch.cuda.stream(side):
        on_side = ffpic_tpu_torch.decode_batch(mixed, device=dev).clone()
    torch.cuda.synchronize()
    if not torch.equal(on_side.cpu(), decode_plain):
        raise AssertionError("mixed decode_batch under a side stream differs "
                             "from the CPU route")
    log("check decode_batch mixed", members="420,444,420,gray",
        shape=tuple(sized.shape), cpu_route_unsized="exact",
        sized_vs_card_resize_of_cpu_route="exact",
        sized_vs_cpu_route_max_abs=diff_cpu, side_stream="exact")

    # --- the encode path -----------------------------------------------------
    enc_pic = Pic(pixels=torch.from_numpy(enc_rgb).to(dev), width=W, height=H)
    torch.cuda.synchronize()
    cuda_jpeg.reset_launches()
    data = ffpic_tpu_torch.encode(enc_pic, "JPG", quality=90)
    launches_enc = dict(cuda_jpeg.launches)
    if launches_enc["fdct"] != 1:
        raise AssertionError(f"encode: K5 launches {launches_enc}")
    if data != ffpic_tpu_torch.encode(enc_pic, "JPG", quality=90,
                                      device="cpu"):
        raise AssertionError("encode on the card differs from the CPU route")
    back = ffpic_tpu_torch.load(data, mode="bt601").pixels
    psnr_enc = testing.psnr(back[:, :W, :3], enc_rgb)
    if psnr_enc < 30:
        raise AssertionError(f"encode round trip: PSNR {psnr_enc:.2f} dB")
    log("encode path", bytes=len(data), launches=launches_enc,
        cpu_route="same bytes", round_trip_psnr_db=f"{psnr_enc:.2f}")

    # --- timing --------------------------------------------------------------
    flush = torch.empty(100 * 2 ** 20, dtype=torch.uint8, device=dev)
    npx = BIG_H * ow
    work = {   # name: (kernel, plain, bytes, ops, type of the ops)
        "assemble_mcu": (
            lambda: cuda_jpeg.assemble_mcu(samples, shapes, samplings, BIG_H,
                                           ow, "rgba", "bt601", 128, "fancy"),
            lambda: jk.assemble_mcu(samples, shapes, samplings, BIG_H, ow,
                                    "rgba", "bt601", 128, "fancy"),
            128 * nblocks + 4 * npx, 30 * npx, "f32"),
        "dequant_idct": (
            lambda: cuda_jpeg.dequant_idct(c4, qd[0:1], qd[1:2], ny),
            lambda: jk.dequant_idct_blocks(c4, qd[0:1], qd[1:2], ny),
            256 * nblocks + 512, (64 + 2 * 1024) * nblocks, "int32"),
        "fdct": (lambda: cuda_jpeg.fdct(enc_blocks),
                 lambda: jk.forward_dct(enc_blocks),
                 256 * enc_blocks.shape[0], 2048 * enc_blocks.shape[0],
                 "int32"),
    }
    rates = {"int32": INT32_OPS_PER_S, "f32": F32_OPS_PER_S}
    timed = {}
    for name, (kern, pl, nbytes, ops, ops_type) in work.items():
        b_ms, b_by = bound(nbytes, ops, rates[ops_type])
        t = timed[name] = {
            "ms": gpu_ms(kern, 50), "ms_cold": gpu_ms_cold(kern, 20, flush),
            "plain_ms": gpu_ms(pl, 3), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "launch_floor_ms": floor_ms,
            "ops_type": ops_type, "bytes": nbytes, "ops": ops}
        t["share"] = b_ms / t["ms"]
        t["share_cold"] = b_ms / t["ms_cold"]
        log("time kernel", name=name, at=("encode" if name == "fdct"
                                          else "load"),
            ms=f"{t['ms']:.4f}", ms_cold=f"{t['ms_cold']:.4f}",
            plain_ms=f"{t['plain_ms']:.4f}", bound_ms=f"{b_ms:.4f}",
            bound_by=b_by, ops_ms=f"{ops / rates[ops_type] * 1e3:.4f}",
            ops_type=ops_type, share_warm=f"{t['share']:.3f}",
            share_cold=f"{t['share_cold']:.3f}", bytes=nbytes,
            launch_floor_ms=f"{floor_ms:.4f}", library_ms="null")
    del flush
    dev_ms = gpu_ms(lambda: jk.decode_mcu_planes(
        coeffs, shapes, quants, samplings, BIG_H, ow, "rgba", "bt601", 128,
        "fancy"), 20)

    wall, walls, stages = spans(lambda: ffpic_tpu_torch.load(
        big, mode="bt601", upsample="fancy"), 5)
    mp = BIG_H * BIG_W / 1e6
    log("time load", megapixels=mp, device_ms=f"{dev_ms:.4f}",
        device_busy_share=f"{dev_ms / (wall * 1e3):.4f}",
        end_to_end_ms=f"{wall * 1e3:.3f}",
        end_to_end_ms_runs=json.dumps([round(w * 1e3, 3)
                                       for w in walls]).replace(" ", ""),
        jpeg_12mp_422_load_mps=f"{mp / wall:.2f}",
        stage_ms=json.dumps(stages).replace(" ", ""))
    wall, walls, stages = spans(lambda: ffpic_tpu_torch.encode(
        enc_pic, "JPG", quality=90), 3)
    log("time encode", megapixels=H * W / 1e6,
        device_ms=f"{timed['fdct']['ms']:.4f}",
        end_to_end_ms=f"{wall * 1e3:.3f}",
        end_to_end_ms_runs=json.dumps([round(w * 1e3, 3)
                                       for w in walls]).replace(" ", ""),
        jpeg_1080p_encode_mps=f"{H * W / 1e6 / wall:.3f}",
        stage_ms=json.dumps(stages).replace(" ", ""))
    return timed, {"load": launches_load, "encode": launches_enc}


def spans(fn, runs: int):
    """Run ``fn`` ``runs`` times, each to a synchronised card, with the
    host spans on: (median wall seconds, the walls, mean ms per span)."""
    import torch
    from ffpic_tpu_torch.utils import trace
    trace.reset()
    trace.enable()
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    trace.enable(False)
    stages = {k: round(v["mean"] * 1e3, 3) for k, v in trace.report().items()}
    return sorted(walls)[len(walls) // 2], walls, stages


def in_turn(fn, inputs):
    """``fn`` as a call of no arguments that takes ``inputs`` in turn,
    one each call."""
    it = itertools.cycle(inputs)
    return lambda: fn(next(it))


def time_entry(name: str, kern, plain, nbytes: int, ops: int, ops_type: str,
               floor_ms: float, flush, at: str, library=None,
               plain_iters: int = 3, plain_warmup: int = 2,
               warm_iters: int = 50) -> dict:
    """One kernel's timing entry: warm (``warm_iters`` calls behind
    ``gpu_ms``'s spin kernel, which must outlast their enqueue) and
    L2-flushed ms, its plain version's and (where one exists) one
    PyTorch call's ms, its bound."""
    from ffpic_tpu_torch.utils.timing import (F32_OPS_PER_S, F64_OPS_PER_S,
                                              F64_TC_OPS_PER_S,
                                              INT32_OPS_PER_S, bound, gpu_ms,
                                              gpu_ms_cold)
    rate = {"int32": INT32_OPS_PER_S, "f32": F32_OPS_PER_S,
            "f64": F64_OPS_PER_S, "f64_tc": F64_TC_OPS_PER_S}[ops_type]
    b_ms, b_by = bound(nbytes, ops, rate)
    t = {"ms": gpu_ms(kern, warm_iters),
         "ms_cold": gpu_ms_cold(kern, 20, flush),
         "plain_ms": gpu_ms(plain, plain_iters, plain_warmup),
         "bound_ms": b_ms,
         "bound_by": b_by,
         "library_ms": gpu_ms(library, 50) if library else None,
         "library_ms_cold": gpu_ms_cold(library, 20, flush) if library
         else None,
         "launch_floor_ms": floor_ms, "ops_type": ops_type, "bytes": nbytes,
         "ops": ops}
    t["share"] = b_ms / t["ms"]
    t["share_cold"] = b_ms / t["ms_cold"]
    log("time kernel", name=name, at=at, ms=f"{t['ms']:.4f}",
        ms_cold=f"{t['ms_cold']:.4f}", plain_ms=f"{t['plain_ms']:.4f}",
        bound_ms=f"{b_ms:.4f}", bound_by=b_by,
        ops_ms=f"{ops / rate * 1e3:.4f}", ops_type=ops_type,
        share_warm=f"{t['share']:.3f}", share_cold=f"{t['share_cold']:.3f}",
        bytes=nbytes, launch_floor_ms=f"{floor_ms:.4f}",
        library_ms=("null" if t["library_ms"] is None
                    else f"{t['library_ms']:.4f}"),
        library_ms_cold=("null" if t["library_ms_cold"] is None
                         else f"{t['library_ms_cold']:.4f}"))
    return t


def png_paths(dev, jpegs, floor_ms: float, errs: dict):
    """The PNG codec on the card: K6 and K7 against their plain versions
    (edge cases and the 1080p shapes), ``load`` of the two 1080p RGBA
    files and of smaller ones, the mixed JPEG + PNG ``decode_batch``,
    each path with fresh launch counts; the timings.  Returns {kernel:
    timing entry}, the launches of each path and the two 1080p files."""
    import numpy as np
    import torch
    import ffpic_tpu_torch
    from ffpic_tpu_torch import Pic, testing
    from ffpic_tpu_torch.formats import png
    from ffpic_tpu_torch.ops import cuda_jpeg, cuda_png
    from ffpic_tpu_torch.ops import png_kernels as pk
    from ffpic_tpu_torch.utils.timing import gpu_ms

    def reset():
        torch.cuda.synchronize()
        cuda_jpeg.reset_launches()
        cuda_png.reset_launches()

    def counts():
        torch.cuda.synchronize()
        return {**{k: v for k, v in cuda_jpeg.launches.items() if v},
                **cuda_png.launches}

    # --- inputs ------------------------------------------------------------
    t0 = time.perf_counter()
    px = np.concatenate([testing.synth_rgb(H, W, 31),
                         testing.synth_rgb(H, W, 32)[..., :1]], -1)
    t1 = time.perf_counter()
    adaptive = png.encode(Pic(pixels=px, width=W, height=H),
                          device=torch.device("cpu"))
    t2 = time.perf_counter()
    subup = testing.encode_png(px, 6, 8, filters=(1, 2))
    t3 = time.perf_counter()
    kinds = np.bincount(png._filter_rows(px.reshape(H, -1))[:, 0],
                        minlength=5).tolist()
    fa, fs = png.parse(adaptive), png.parse(subup)
    if fa.passes[0].recon is None or fs.passes[0].rows is None:
        raise AssertionError("the 1080p PNGs do not take their two routes")
    log("inputs png", pixels=f"{W}x{H} RGBA 8-bit", adaptive_bytes=len(adaptive),
        adaptive_rows_by_filter=json.dumps(kinds).replace(" ", ""),
        subup_bytes=len(subup), subup_filters="Sub,Up in turn",
        synth_seconds=f"{t1 - t0:.3f}", encode_seconds=f"{t2 - t1:.3f}",
        encode_png_seconds=f"{t3 - t2:.3f}")

    # --- K6 against its plain version ----------------------------------------
    # every case twice (the second launch reuses the status words of the
    # first under a new epoch), and on a side stream (its own words); one
    # kernel a call
    side = torch.cuda.Stream()
    for rows, bpp in testing.unfilter_cases().values():
        t = torch.from_numpy(rows).to(dev)
        want = pk.unfilter_subup(t, bpp)
        for _ in range(2):
            exact("unfilter_subup", cuda_png.unfilter_subup(t, bpp), want,
                  errs)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            got = cuda_png.unfilter_subup(t, bpp)
        torch.cuda.current_stream().wait_stream(side)
        exact("unfilter_subup", got, want, errs)
        reset()
        cuda_png.unfilter_subup(t, bpp)
        if counts()["unfilter_subup"] != 1:
            raise AssertionError("K6 took more than one launch a call")
    rng = np.random.default_rng(33)
    noise = rng.integers(0, 256, (H, 4 * W + 1)).astype(np.uint8)
    noise[:, 0] = rng.integers(0, 3, H)
    for tagged in (np.array(fs.passes[0].rows), noise):
        t = torch.from_numpy(tagged).to(dev)
        exact("unfilter_subup", cuda_png.unfilter_subup(t, 4),
              pk.unfilter_subup(t, 4), errs)
    rows_d = torch.from_numpy(np.array(fs.passes[0].rows)).to(dev)
    recon = cuda_png.unfilter_subup(rows_d, 4)
    log("check K6", unfilter_subup="exact", launches_a_call=1,
        cases=",".join(testing.unfilter_cases()) + " (each twice and on a "
        "side stream),1080p_subup,1080p_random_filters")

    # --- K7 against its plain version ----------------------------------------
    # every (colour type, bit depth) at an odd width and at one a multiple
    # of 4, each as contiguous rows (K7's flat run) and at row pitches
    # aligned to 16, 8 and 4 bytes and from an odd address at an odd pitch
    # (its four load widths)
    def rgba_layouts(rec):
        h, stride = rec.shape
        flat = torch.from_numpy(rec).to(dev)
        out = {"flat": flat}
        wide = -(-stride // 16) * 16 + 16
        for name, pitch, at in (("pitch16", wide, 0), ("pitch8", wide + 8, 0),
                                ("pitch4", wide + 4, 0),
                                ("unaligned", stride + 7, 1)):
            buf = torch.zeros((h, pitch + at), dtype=torch.uint8, device=dev)
            buf[:, at:at + stride] = flat
            out[name] = buf[:, at:at + stride]
        return out

    n_rgba = 0
    for rec, pal, key, ct, bd, w, h in testing.rgba_cases().values():
        for width in (w, 64):
            stride = (width * pk.NCH[ct] * bd + 7) // 8
            r_np = np.tile(rec, (1, -(-stride // rec.shape[1])))[:, :stride]
            for r in rgba_layouts(np.ascontiguousarray(r_np)).values():
                exact("assemble_rgba",
                      cuda_png.assemble_rgba(r, pal, key, ct, bd, width, h),
                      pk.expand_rgba(r, pal, key, ct, bd, width, h), errs)
                n_rgba += 1
    pal, key = fs.palette, fs.trns.astype(np.int32)
    host_recon = torch.from_numpy(fa.passes[0].recon).to(dev)
    for r in (recon, host_recon, host_recon[:, 1:1 + 4 * W - 4]):
        w = r.shape[1] // 4
        exact("assemble_rgba", cuda_png.assemble_rgba(r, pal, key, 6, 8, w, H),
              pk.expand_rgba(r, pal, key, 6, 8, w, H), errs)
    log("check K7", assemble_rgba="exact", launches_checked=n_rgba,
        cases=",".join(testing.rgba_cases()) + " at widths 37 and 64, each "
        "flat, pitch16, pitch8, pitch4, unaligned; 1080p_k6_recon,"
        "1080p_host_recon,1080p_unaligned")

    # --- the load paths ------------------------------------------------------
    want = torch.from_numpy(px).to(dev)
    loads = {}
    for name, data in (("subup", subup), ("adaptive", adaptive)):
        reset()
        pic = ffpic_tpu_torch.load(data)
        loads[name] = counts()
        got = pic.pixels
        if (tuple(got.shape) != (H, W, 4) or got.dtype != torch.uint8
                or got.device.type != dev.type):
            raise AssertionError(f"png load {name} gave {tuple(got.shape)} "
                                 f"{got.dtype} on {got.device}")
        k6 = 1 if name == "subup" else 0
        if (loads[name]["assemble_rgba"] != 1
                or loads[name]["unfilter_subup"] != k6
                or len(loads[name]) != 2):
            raise AssertionError(f"png load {name}: launches {loads[name]}")
        if not torch.equal(got, want):
            raise AssertionError(f"png load {name}: pixels differ from the "
                                 f"source by up to {max_abs_err(got, want)}")
        log("png load path", file=name, shape=tuple(got.shape),
            launches=loads[name], source_pixels="exact")
    small = {
        "palette4_trns_adam7": testing.encode_png(
            rng.integers(0, 13, (67, 101)), 3, 4, filters=(1, 2, 0),
            interlace=1, palette=rng.integers(0, 256, (13, 3)),
            trns=rng.integers(0, 256, 9)),
        "palette1_paeth": testing.encode_png(
            rng.integers(0, 2, (33, 45)), 3, 1, filters=4,
            palette=rng.integers(0, 256, (2, 3))),
        "gray16_key": testing.encode_png(
            np.repeat(rng.integers(0, 65536, (67, 1)), 101, 1), 0, 16,
            filters=(2, 1), trns=int(rng.integers(0, 65536))),
        "gray_alpha_adam7": testing.encode_png(
            rng.integers(0, 256, (67, 101, 2)), 4, 8, filters=(0, 1, 2, 3, 4),
            interlace=1),
        "rgb16_subup": testing.encode_png(
            rng.integers(0, 65536, (67, 101, 3)), 2, 16, filters=(1, 2)),
        "gray2": testing.encode_png(rng.integers(0, 4, (9, 1001)), 0, 2,
                                    filters=(1, 2)),
    }
    for name, data in small.items():
        got = ffpic_tpu_torch.load(data).pixels
        if not torch.equal(got.cpu(), ffpic_tpu_torch.load(
                data, device="cpu").pixels):
            raise AssertionError(f"png load {name}: the card differs from "
                                 "the CPU route")
    log("check png load", cases=",".join(small), cpu_route="exact")

    # --- the mixed decode_batch ----------------------------------------------
    pngs = [subup, adaptive, subup, adaptive]
    mixed = [m for pair in zip([jpegs[k % 2] for k in range(4)], pngs)
             for m in pair]
    reset()
    out = ffpic_tpu_torch.decode_batch(mixed, device=dev)
    launches_mixed = counts()
    if (tuple(out.shape) != (N, H, W, 4) or out.dtype != torch.uint8
            or out.device.type != dev.type):
        raise AssertionError(f"mixed decode_batch gave {tuple(out.shape)}")
    if min(launches_mixed.get(k, 0) for k in (*PATH_420, "unfilter_subup",
                                              "assemble_rgba")) < 1:
        raise AssertionError(f"a kernel of the mixed batch never ran: "
                             f"{launches_mixed}")
    t0 = time.perf_counter()
    cpu = ffpic_tpu_torch.decode_batch(mixed, device="cpu")
    cpu_s = time.perf_counter() - t0
    if not torch.equal(out.cpu(), cpu):
        raise AssertionError("mixed decode_batch: the card differs from the "
                             f"CPU route by up to {max_abs_err(out.cpu(), cpu)}")
    if not all(torch.equal(out[k], want) for k in (1, 3, 5, 7)):
        raise AssertionError("mixed decode_batch: a PNG member differs from "
                             "its source")
    log("png mixed decode_batch", members="jpeg,png x 4", shape=tuple(out.shape),
        launches=launches_mixed, cpu_route="exact", png_members="source",
        cpu_route_seconds=f"{cpu_s:.3f}")
    del out, cpu

    # --- timing --------------------------------------------------------------
    flush = torch.empty(100 * 2 ** 20, dtype=torch.uint8, device=dev)
    stride = 4 * W
    # 8-bit RGBA pixels are the reconstructed bytes as they are: one
    # device copy computes K7's function on this input
    if not torch.equal(recon.clone().view(H, W, 4), cuda_png.assemble_rgba(
            recon, pal, key, 6, 8, W, H)):
        raise AssertionError("K7's library yardstick computes another "
                             "function")
    # K7's 16.6 MB fit in the 50 MB L2, so back-to-back launches on one
    # input read it from L2 and beat the bound by device memory: its warm
    # time (and the copy's) takes the rows from eight copies in turn,
    # 66 MB; the L2-resident times are logged beside, with no share
    rows8 = [recon.clone() for _ in range(8)]
    timed = {
        "unfilter_subup": time_entry(
            "unfilter_subup",
            lambda: cuda_png.unfilter_subup(rows_d, 4),
            lambda: pk.unfilter_subup(rows_d, 4),
            H * (stride + 1) + H * stride, H * stride, "int32", floor_ms,
            flush, "png load 1080p Sub/Up"),
        "assemble_rgba": time_entry(
            "assemble_rgba",
            in_turn(lambda r: cuda_png.assemble_rgba(r, pal, key, 6, 8, W, H),
                    rows8),
            lambda: pk.expand_rgba(recon, pal, key, 6, 8, W, H),
            H * stride + 4 * H * W, 4 * H * W, "int32", floor_ms, flush,
            "png load 1080p, rows from 8 copies in turn",
            library=in_turn(lambda r: r.clone().view(H, W, 4), rows8)),
    }
    t = timed["assemble_rgba"]
    t["ms_l2"] = gpu_ms(
        lambda: cuda_png.assemble_rgba(recon, pal, key, 6, 8, W, H), 50)
    t["library_ms_l2"] = gpu_ms(lambda: recon.clone().view(H, W, 4), 50)
    log("time K7 against the device copy", instance="assemble_rgba<6,8>",
        at="png load 1080p", ms=f"{t['ms']:.4f}",
        copy_ms=f"{t['library_ms']:.4f}", ms_cold=f"{t['ms_cold']:.4f}",
        copy_ms_cold=f"{t['library_ms_cold']:.4f}",
        ms_l2=f"{t['ms_l2']:.4f}", copy_ms_l2=f"{t['library_ms_l2']:.4f}",
        warm_ratio=f"{t['ms'] / t['library_ms']:.3f}",
        cold_ratio=f"{t['ms_cold'] / t['library_ms_cold']:.3f}",
        l2_ratio=f"{t['ms_l2'] / t['library_ms_l2']:.3f}",
        copy_share_warm=f"{t['bound_ms'] / t['library_ms']:.3f}",
        copy_share_cold=f"{t['bound_ms'] / t['library_ms_cold']:.3f}")
    del flush, rows8
    walls = {}
    for name, data in (("subup", subup), ("adaptive", adaptive)):
        wall, runs, stages = spans(lambda d=data: ffpic_tpu_torch.load(d), 5)
        walls[name] = wall
        log("time png load", file=name, megapixels=H * W / 1e6,
            end_to_end_ms=f"{wall * 1e3:.3f}",
            end_to_end_ms_runs=json.dumps([round(w * 1e3, 3)
                                           for w in runs]).replace(" ", ""),
            png_1080p_load_mps=f"{H * W / 1e6 / wall:.2f}",
            stage_ms=json.dumps(stages).replace(" ", ""))
    dev_ms = gpu_ms(lambda: cuda_png.assemble_rgba(cuda_png.unfilter_subup(
        rows_d, 4), pal, key, 6, 8, W, H), 20)
    log("time png device", file="subup", device_ms=f"{dev_ms:.4f}",
        device_busy_share=f"{dev_ms / (walls['subup'] * 1e3):.4f}")
    wall, runs, stages = spans(lambda: ffpic_tpu_torch.decode_batch(
        mixed, device=dev), 5)
    mp = N * H * W / 1e6
    log("time png mixed decode_batch", megapixels=mp,
        end_to_end_ms=f"{wall * 1e3:.3f}",
        end_to_end_ms_runs=json.dumps([round(w * 1e3, 3)
                                       for w in runs]).replace(" ", ""),
        mixed_1080p_decode_mps=f"{mp / wall:.2f}",
        stage_ms=json.dumps(stages).replace(" ", ""))
    return timed, {"load": loads["subup"], "load_adaptive":
                   loads["adaptive"], "mixed": launches_mixed}, \
        [subup, adaptive]


def sparse_path(dev, srcs, plain, floor_ms: float, errs: dict):
    """K8 against its plain version (edge cases and the route's planes),
    the sparse route of dense 4:2:0 members through the pipeline's
    dense-member staging with the 8 x 1080p batch's planes, with fresh
    launch counts, against the plain route; the timings.  Returns K8's
    timing entry and the route's launches."""
    import numpy as np
    import torch
    from ffpic_tpu_torch import pipeline, testing
    from ffpic_tpu_torch.formats import jpg
    from ffpic_tpu_torch.ops import cuda_jpeg
    from ffpic_tpu_torch.ops import jpeg_kernels as jk
    from ffpic_tpu_torch.utils.timing import gpu_ms

    # each case's planes in one launch into slots with a sentinel before,
    # between none and after them, and each plane alone
    for planes, n, sizes in testing.scatter_cases().values():
        pd = [(torch.from_numpy(i).to(dev), torch.from_numpy(v).to(dev))
              for i, v in planes]
        want = jk.scatter_planes(pd, n, sizes)
        nb = sum(sizes)
        slot = torch.full((n, nb + 5, 8, 8), 7, dtype=torch.int16,
                          device=dev)
        cuda_jpeg.scatter_planes(pd, slot[:, 2:2 + nb], sizes)
        exact("scatter_plane", slot[:, 2:2 + nb], want, errs)
        if not (bool((slot[:, :2] == 7).all())
                and bool((slot[:, 2 + nb:] == 7).all())):
            raise AssertionError("scatter_planes wrote outside its slots")
        exact("scatter_plane", cuda_jpeg.scatter_planes(
            pd, torch.empty_like(want), sizes), want, errs)
        off = 0
        for (it, vt), b in zip(pd, sizes):
            exact("scatter_plane", cuda_jpeg.scatter_plane(
                it, vt, torch.empty((n, b, 8, 8), dtype=torch.int16,
                                    device=dev)), want[:, off:off + b], errs)
            off += b
        del pd, want, slot
    t0 = time.perf_counter()
    js = [jpg.parse_and_decode(d)[0] for d in srcs]
    parse_s = time.perf_counter() - t0
    shapes = tuple((c.nby, c.nbx) for c in js[0].comps)
    sizes = [a * b for a, b in shapes]
    planes = [np.stack([j.coeffs[c].reshape(-1) for j in js])
              for c in range(3)]
    # decode_batch's worker pool packs each dense member's planes
    workers = max(1, min(os.cpu_count() or 1, N))

    def pool():
        with ThreadPoolExecutor(workers) as ex:
            return list(ex.map(pipeline.member_pairs, js))

    pairs = pool()
    packed = pipeline.sparse_pairs(pairs, [c.size for c in js[0].coeffs])
    if packed is None:
        raise AssertionError("the 1080p planes do not take the sparse route")
    idx_all, val_all, lens = packed
    cut = np.cumsum([0, *lens]).tolist()
    for (a, b), p in zip(zip(cut[:-1], cut[1:]), planes):
        ri, rv = jk.pack_coeffs(p)
        if not (np.array_equal(ri, idx_all[a:b])
                and np.array_equal(rv, val_all[a:b])):
            raise AssertionError("the pool's pairs, joined, differ from "
                                 "pack_coeffs of the stacked plane")
    pairs_d = [(torch.from_numpy(idx_all[a:b]).to(dev),
                torch.from_numpy(val_all[a:b]).to(dev))
               for a, b in zip(cut[:-1], cut[1:])]
    coeffs = torch.empty((N, sum(sizes), 8, 8), dtype=torch.int16,
                         device=dev)
    exact("scatter_plane", cuda_jpeg.scatter_planes(pairs_d, coeffs, sizes),
          jk.scatter_planes(pairs_d, N, sizes), errs)
    dense_bytes = sum(p.nbytes for p in planes)
    pair_bytes = idx_all.nbytes + val_all.nbytes
    log("check K8", scatter_planes="exact",
        cases=",".join(testing.scatter_cases()) + " (slots, whole, each "
        "plane),8x1080p_planes",
        pairs=lens, pair_bytes=pair_bytes, dense_bytes=dense_bytes,
        share=f"{pair_bytes / dense_bytes:.4f}", pool_pairs="pack_coeffs",
        dense_parse_seconds=f"{parse_s:.3f}")

    torch.cuda.synchronize()
    cuda_jpeg.reset_launches()
    out = pipeline.decode_dense_members(js, pairs, "bt601", dev)
    torch.cuda.synchronize()
    launches = {k: v for k, v in cuda_jpeg.launches.items() if v}
    if launches != {"scatter_plane": 1, "dequant_idct": 1,
                    "assemble_color": 1}:
        raise AssertionError(f"the sparse route ran {launches}")
    if not torch.equal(out, plain):
        raise AssertionError("the sparse route differs from the plain route "
                             f"by up to {max_abs_err(out, plain)}")
    log("sparse route", shape=tuple(out.shape), launches=launches,
        plain_route="exact")
    del out

    flush = torch.empty(100 * 2 ** 20, dtype=torch.uint8, device=dev)
    longs = [(it.to(torch.int64), vt) for it, vt in pairs_d]

    def k8():
        cuda_jpeg.scatter_planes(pairs_d, coeffs, sizes)

    def library():
        for (il, vt), nb in zip(longs, sizes):
            torch.zeros(N * nb * 64, dtype=torch.int16,
                        device=dev).index_add_(0, il, vt)

    entries = sum(lens)
    timed = time_entry(
        "scatter_plane", k8, lambda: jk.scatter_planes(pairs_d, N, sizes),
        6 * entries + 2 * N * sum(sizes) * 64, entries, "int32", floor_ms,
        flush, "sparse route 8x1080p, 3 planes in one launch", library)
    del flush
    # the launches one timed call of k8 makes
    torch.cuda.synchronize()
    cuda_jpeg.reset_launches()
    k8()
    torch.cuda.synchronize()
    timed["launches_per_run"] = cuda_jpeg.launches["scatter_plane"]
    yq, cq = (torch.from_numpy(np.stack([j.dqt[j.comps[c].tq] for j in js])
                               .astype(np.int32)).to(dev) for c in (0, 1))
    dense = coeffs.clone()
    route_ms = {
        "sparse": gpu_ms(lambda: jk.decode_batch_420_sparse(
            pairs_d, N, shapes, yq, cq, "rgba", "bt601", (H, W)), 20),
        "dense": gpu_ms(lambda: jk.decode_batch_420_dense(
            dense, yq, cq, shapes, "rgba", "bt601", (H, W)), 20)}
    # from parsed planes to pixels: the pool's packing, which decode_batch
    # does for every dense member, then the route the rule takes
    # (sparse here), or the dense route alone, which is all that ran
    # before the rule
    pool_wall, pool_runs, _ = spans(pool, 5)
    log("time dense members pool packing", workers=workers,
        wall_ms=f"{pool_wall * 1e3:.3f}",
        wall_ms_runs=json.dumps([round(w * 1e3, 3)
                                 for w in pool_runs]).replace(" ", ""))
    routes = {
        "sparse": lambda: pipeline.decode_dense_members(js, pairs, "bt601",
                                                        dev),
        "dense": lambda: pipeline.decode_planes(js, "bt601", dev)}
    for route, fn in routes.items():
        wall, runs, stages = spans(fn, 5)
        log("time dense members", route=route,
            device_ms=f"{route_ms[route]:.4f}",
            end_to_end_ms=f"{wall * 1e3:.3f}",
            with_pool_packing_ms=f"{(wall + pool_wall) * 1e3:.3f}",
            end_to_end_ms_runs=json.dumps([round(w * 1e3, 3)
                                           for w in runs]).replace(" ", ""),
            staged_bytes=(pair_bytes if route == "sparse" else dense_bytes),
            stage_ms=json.dumps(stages).replace(" ", ""))
    return timed, launches


@contextlib.contextmanager
def environ(**env):
    """Set (a value) or unset (None) environment variables for the block."""
    old = {k: os.environ.get(k) for k in env}
    try:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


ENTROPY_ENV = ("FFPIC_DEVICE_ENTROPY", "FFPIC_SPEC_ENTROPY", "FFPIC_HYBRID",
               "FFPIC_HYBRID_FRAC")


def fast_walks(st, bit0, steps=None, bit_end=None) -> dict:
    """The symbols of each lane's walk from (bit0, k = 0, sub = 0), for
    ``steps`` symbols (K9's lanes) or to the first boundary at or past
    ``bit_end`` (K10's chunks), replayed with the plain step
    (``jed._advance``) on the card, and how many of them the fast table
    (``st.fast``, one table group) answers: each symbol's 16-bit window
    and table, as the kernels form them.  Returns {"symbols", "longest",
    "hits", "hit_share", "exit_bit"}."""
    import torch
    from ffpic_tpu_torch.ops import jpeg_entropy_device as jed
    if st.luts.shape[0] != 4:
        raise AssertionError("fast_walks replays one table group")
    tabs = jed._spec_tables(st.u32win, st.luts, st.comp_of_sub,
                            st.tclass_of_sub)
    u32, _lut, _cos, tos = tabs
    fast = jed._u32(st.fast.reshape(-1))
    bit = bit0.to(torch.int64)
    k, sub, blk = (torch.zeros_like(bit) for _ in range(3))
    dcs = torch.zeros((bit.shape[0], 3), dtype=torch.int64, device=bit.device)
    n = torch.zeros_like(bit)
    hits = torch.zeros_like(bit)
    shift = 16 - jed.FAST_BITS

    def active_now():
        return n < steps.to(torch.int64) if steps is not None \
            else bit < bit_end.to(torch.int64)

    active = active_now()
    while bool(active.any()):
        w32 = jed._gather(u32, bit >> 3)
        win16 = (w32 >> (16 - (bit & 7))) & 0xFFFF
        tbl = tos[sub.clamp(0, st.bpm - 1)] * 2 + (k != 0).to(torch.int64)
        hit = fast[(tbl << jed.FAST_BITS) + (win16 >> shift)] \
            != jed.FAST_MISS
        hits += hit & active
        bit, k, sub, blk, dcs = jed._advance(tabs, st.bpm, active, bit, k,
                                             sub, blk, dcs)
        n += active
        active = active_now()
    symbols = int(n.sum())
    return {"symbols": symbols, "longest": int(n.max()),
            "hits": int(hits.sum()), "hit_share": int(hits.sum()) / symbols,
            "exit_bit": bit}


PLAN_TRAP = """
import sys
import numpy as np
import torch
from ffpic_tpu_torch import testing
from ffpic_tpu_torch.formats import jpg
from ffpic_tpu_torch.ops import jpeg_entropy_device as jed
datas = testing.entropy_cases()["dri_mixed"]["datas"]
js = [jpg.parse_and_decode(d, skip_decode=True)[0] for d in datas]
st, lanes, plan, n, _off = jed.stage_dri(datas, js, torch.device("cuda"))
groups = sorted(set(lanes[:, 4].tolist()))
wrong = jed.to_device(jed.cta_plan(np.zeros(lanes.shape[0])), st.device)
if groups != [0, 1]:
    sys.exit(f"dri_mixed's table groups: {groups}")
try:
    jed.decode_lanes(st, lanes, wrong, n)
    torch.cuda.synchronize()
except RuntimeError as e:     # the launch's or the stream's error
    print("refused", type(e).__name__, str(e).splitlines()[0])
    sys.exit(0)
print("decoded")
sys.exit(1)
"""


def plan_trap_check() -> str:
    """K9 with a CTA plan that does not match its lanes (``dri_mixed``'s
    two table groups, a plan of group 0 only), in a process of its own,
    since a trap loses the CUDA context: the launch must fail.  Returns
    the child's report."""
    root = os.path.dirname(os.path.abspath(__file__))
    r = subprocess.run([sys.executable, "-c", PLAN_TRAP], cwd=root,
                       capture_output=True, text=True, timeout=600,
                       env={**os.environ, "PYTHONPATH": root})
    out = r.stdout.strip().splitlines()
    if r.returncode != 0 or not out or not out[-1].startswith("refused"):
        raise AssertionError("K9 took a plan that does not match its "
                             f"lanes: rc {r.returncode}, {r.stdout}"
                             f"{r.stderr[-2000:]}")
    return out[-1]


def entropy_paths(dev, jpegs, plain_out, floor_ms: float, errs: dict):
    """The device Huffman decode: K9, K10 and K11 against their plain
    versions on the card (``testing.entropy_cases`` and the path shapes)
    and against the native host decoder; the ``dri batch``, ``dri
    mixed`` and ``spec batch`` phases through ``decode_batch``, each with
    fresh launch counts; the timings.  Returns {kernel: timing entry} and
    the launches of each path."""
    import numpy as np
    import torch
    from ffpic_tpu_torch import decode_batch, testing
    from ffpic_tpu_torch.formats import jpg
    from ffpic_tpu_torch.ops import cuda_entropy, cuda_jpeg
    from ffpic_tpu_torch.ops import jpeg_entropy_device as jed
    from ffpic_tpu_torch.utils.timing import gpu_ms

    def reset():
        torch.cuda.synchronize()
        cuda_jpeg.reset_launches()
        cuda_entropy.reset_launches()

    def counts():
        torch.cuda.synchronize()
        return {**{k: v for k, v in cuda_jpeg.launches.items() if v},
                **cuda_entropy.launches}

    def host_coeffs(data):
        j, _ = jpg.parse_and_decode(data)
        return torch.from_numpy(np.concatenate(
            [c.reshape(-1) for c in j.coeffs])).to(dev)

    clear = {k: None for k in ENTROPY_ENV}

    # --- inputs ------------------------------------------------------------
    t0 = time.perf_counter()
    dri = [testing.encode_jpeg(testing.synth_rgb(H, W, k + 1), q,
                               restart_interval=W // 16)
           for k, q in ((0, 85), (1, 95))]
    t1 = time.perf_counter()
    mixed = [dri[0],
             testing.encode_jpeg(testing.synth_rgb(720, 1280, 41), 75,
                                 restart_interval=80),
             testing.encode_jpeg(testing.synth_rgb(512, 512, 42), 95,
                                 restart_interval=32),
             testing.encode_jpeg(testing.synth_rgb(720, 1280, 43), 95,
                                 restart_interval=80),
             testing.encode_jpeg(testing.synth_rgb(512, 512, 44), 85,
                                 restart_interval=32)]
    t2 = time.perf_counter()
    dri_srcs = [dri[k % 2] for k in range(N)]
    spec_srcs = [jpegs[k % 2] for k in range(N)]
    log("inputs entropy", dri=f"2x{W}x{H} q85/q95 DRI {W // 16} (one MCU "
        "row a segment)", dri_bytes=[len(d) for d in dri],
        mixed="1080p q85, 720p q75, 512 q95, 720p q95, 512 q85",
        spec="the batch's DRI-less files",
        encode_seconds=f"{t1 - t0:.3f}", mixed_seconds=f"{t2 - t1:.3f}")

    # --- K9-K11 against their plain versions on the card: edge cases -------
    def hold_dri(datas):
        """K9 over a DRI batch against ``decode_lanes_plain`` on the same
        staged tensors; its symbol counts."""
        js = [jpg.parse_and_decode(d, skip_decode=True)[0] for d in datas]
        st, lanes, plan, out_size, _off = jed.stage_dri(datas, js, dev)
        flat, steps = jed.decode_lanes(st, lanes, plan, out_size)
        pflat, psteps = jed.decode_lanes_plain(st, lanes, out_size)
        exact("entropy_decode", flat, pflat, errs)
        exact("entropy_decode", steps, psteps, errs)
        return steps

    def hold_spec(r):
        """K10, K11 and K9 of a ``spec_stages`` run, each against its
        plain version on the same inputs on the card."""
        st = r["staged"]
        exits, snap = jed.spec_scan_plain(st, r["chunks"])
        exact("spec_scan", r["exits"], exits, errs)
        exact("spec_scan", r["snap"], snap, errs)
        exact("spec_merge", r["merged"],
              jed.spec_merge_plain(st, r["ent"], r["snap"]), errs)
        flat, steps = jed.decode_lanes_plain(st, r["lanes"],
                                             r["flat"].numel())
        exact("entropy_decode", r["flat"], flat, errs)
        exact("entropy_decode", r["steps"], steps, errs)

    stage_kernel = {"flat": "entropy_decode", "steps": "entropy_decode",
                    "exits": "spec_scan", "snap": "spec_scan",
                    "merged": "spec_merge", "lanes": "spec_merge",
                    "ok": "spec_merge"}
    cases = testing.entropy_cases()
    for case in cases.values():
        if case["kind"] == "dri":
            hold_dri(case["datas"])
        else:
            hold_spec(jed.spec_stages(case["datas"], case["chunk_bytes"],
                                      device=dev))
        # the whole decode, stitch and ok included, against the CPU's
        got = testing.entropy_stages(case, dev)
        want = testing.entropy_stages(case, "cpu")
        for key, kernel in stage_kernel.items():
            if key in want:
                exact(kernel, got[key], want[key], errs)
    log("check K9-K11 cases", entropy_decode="exact", spec_scan="exact",
        spec_merge="exact", cpu="exact", cases=",".join(cases))
    log("check K9 plan", mismatched_plan=plan_trap_check())

    # --- the path shapes: all 8 against the host decoder, 2 against the
    # plain versions -------------------------------------------------------
    want = [host_coeffs(d) for d in dri]
    reset()
    flat, _js, consts, steps = jed.decode_coeffs_device(dri_srcs, device=dev)
    if counts()["entropy_decode"] != 1:
        raise AssertionError("decode_coeffs_device: K9 launches "
                             f"{counts()}")
    size = consts["comp_space"] * 64
    for i in range(N):
        exact("entropy_decode", flat[i * size:(i + 1) * size], want[i % 2],
              errs)
    hold_dri(dri)
    spec_want = [host_coeffs(d) for d in jpegs]
    r8 = jed.spec_stages(spec_srcs, 4096, device=dev)
    if not bool(r8["ok"]):
        raise AssertionError("the 8 DRI-less files do not self-synchronise")
    for i in range(N):
        exact("entropy_decode", r8["flat"][i * size:(i + 1) * size],
              spec_want[i % 2], errs)
    hold_spec(jed.spec_stages(jpegs, 4096, device=dev))
    log("check K9-K11 path", lanes=int(steps.numel()),
        longest_lane_symbols=int(steps.max()),
        symbols=int(steps.sum()), host_decoder_8="exact",
        plain_2="exact", spec_lanes=r8["L"], spec_host_decoder_8="exact",
        spec_plain_2="exact")

    # --- dri batch -----------------------------------------------------------
    taken = []
    real_route = jed.decode_batch_dri_mixed

    def spy(datas, js, **kw):
        taken.append(len(datas))
        return real_route(datas, js, **kw)

    outs, launches = {}, {}
    jed.decode_batch_dri_mixed = spy
    try:
        for label, env in (("all_device", {"FFPIC_HYBRID": "0"}),
                           ("hybrid", {}),
                           ("host", {"FFPIC_DEVICE_ENTROPY": "0"})):
            with environ(**{**clear, **env}):
                taken.clear()
                reset()
                outs[label] = decode_batch(dri_srcs, device=dev)
                launches[label] = {**counts(), "members": sum(taken)}
    finally:
        jed.decode_batch_dri_mixed = real_route
    expect = {"all_device": (1, N, 0), "hybrid": (1, 4, 1),
              "host": (0, 0, 1)}
    for label, (k9, members, k1a) in expect.items():
        got = launches[label]
        if (got["entropy_decode"], got["members"],
                got.get("count_scan", 0)) != (k9, members, k1a):
            raise AssertionError(f"dri batch {label}: launches {got}")
        if not torch.equal(outs[label], outs["host"]):
            raise AssertionError(f"dri batch {label} differs from the host "
                                 "route by up to "
                                 f"{max_abs_err(outs[label], outs['host'])}")
    psnr = testing.psnr(outs["all_device"][0, ..., :3],
                        testing.synth_rgb(H, W, 1))
    if psnr < 30 or tuple(outs["host"].shape) != (N, H, W, 4):
        raise AssertionError(f"dri batch: PSNR {psnr:.2f} dB")
    log("dri batch", shape=tuple(outs["host"].shape),
        launches=json.dumps(launches).replace(" ", ""),
        equal="all_device=hybrid=host", psnr_db=f"{psnr:.2f}")
    del outs

    # --- dri mixed -----------------------------------------------------------
    with environ(**clear):
        reset()
        got = decode_batch(mixed, size=(224, 224), device=dev)
        mixed_launches = counts()
        js = [jpg.parse_and_decode(d, skip_decode=True)[0] for d in mixed]
        per = jed.decode_batch_dri_mixed(mixed, js, device=dev)
    with environ(**{**clear, "FFPIC_DEVICE_ENTROPY": "0"}):
        host = decode_batch(mixed, size=(224, 224), device=dev)
        for i, (d, j) in enumerate(zip(mixed, js)):
            one = decode_batch([d], device=dev)[0]
            if not torch.equal(per[i][:j.height, :j.width], one):
                raise AssertionError(f"dri mixed member {i} differs from "
                                     "the host route")
    if mixed_launches["entropy_decode"] != 1 or \
            mixed_launches.get("count_scan", 0):
        raise AssertionError(f"dri mixed: launches {mixed_launches}")
    if not torch.equal(got, host):
        raise AssertionError("dri mixed differs from the host route")
    log("dri mixed", members=len(mixed), geometries=3, qualities="75,85,95",
        launches=json.dumps(mixed_launches).replace(" ", ""),
        host_route="exact", members_unresized="exact",
        custom_tables="CPU tests only (the card has no PIL)")

    # --- spec batch ----------------------------------------------------------
    with environ(**{**clear, "FFPIC_SPEC_ENTROPY": "1"}):
        reset()
        spec_out = decode_batch(spec_srcs, device=dev)
        spec_launches = counts()
    if (spec_launches["spec_scan"], spec_launches["spec_merge"],
            spec_launches["entropy_decode"],
            spec_launches.get("count_scan", 0)) != (1, 1, 1, 0):
        raise AssertionError(f"spec batch fell back or ran other kernels: "
                             f"{spec_launches}")
    if not torch.equal(spec_out, plain_out):
        raise AssertionError("spec batch differs from the host route")
    log("spec batch", shape=tuple(spec_out.shape),
        launches=json.dumps(spec_launches).replace(" ", ""), ok=True,
        host_route="exact")
    del spec_out

    # --- timing --------------------------------------------------------------
    mp = N * H * W / 1e6
    walls = {}
    for name, env, fn in (
            ("device_entropy_dri", clear,
             lambda: jed.decode_batch_device_entropy(dri_srcs, device=dev)),
            ("hybrid_pipeline", clear,
             lambda: decode_batch(dri_srcs, device=dev)),
            ("host_route", {**clear, "FFPIC_DEVICE_ENTROPY": "0"},
             lambda: decode_batch(dri_srcs, device=dev)),
            ("device_entropy_spec", clear,
             lambda: jed.decode_batch_device_entropy_spec(
                 spec_srcs, chunk_bytes=4096, device=dev))):
        with environ(**env):
            wall, runs, stages = spans(fn, 5)
        walls[name] = wall
        log("time entropy path", path=name, megapixels=mp,
            end_to_end_ms=f"{wall * 1e3:.3f}",
            end_to_end_ms_runs=json.dumps([round(w * 1e3, 3)
                                           for w in runs]).replace(" ", ""),
            **{f"{name}_mps": f"{mp / wall:.2f}"},
            stage_ms=json.dumps(stages).replace(" ", ""))

    flush = torch.empty(100 * 2 ** 20, dtype=torch.uint8, device=dev)
    js8 = [jpg.parse_and_decode(d, skip_decode=True)[0] for d in dri_srcs]
    st, lanes, plan, out_size, _off = jed.stage_dri(dri_srcs, js8, dev)
    _f, steps8 = jed.decode_lanes(st, lanes, plan, out_size)
    lut_bytes = 4 * st.luts.numel()
    rs = jed.spec_stages(spec_srcs, 4096, device=dev)
    ss = rs["staged"]
    nl = rs["L"]
    spec_symbols = int(rs["steps"].sum())
    merge = testing.merge_work(ss, rs, lut_bytes)
    # the fast table's hits on the walks K9 and K10 make, replayed with
    # the plain step: K9's lanes their symbol counts from (bit0, k = 0,
    # sub = 0), K10's chunks to their exits
    k9_walk = fast_walks(st, lanes[:, 0], steps=steps8)
    k10_walk = fast_walks(ss, rs["chunks"][:, 0],
                          bit_end=rs["chunks"][:, 1])
    if not torch.equal(k10_walk["exit_bit"],
                       rs["exits"][:, 0].to(torch.int64)):
        raise AssertionError("fast_walks: the replay missed K10's exits")
    timed = {
        "entropy_decode": time_entry(
            "entropy_decode",
            lambda: jed.decode_lanes(st, lanes, plan, out_size),
            lambda: jed.decode_lanes_plain(st, lanes, out_size),
            st.n + lut_bytes + 4 * st.fast.numel() + 2 * out_size
            + 4 * lanes.numel() + 4 * plan.numel() + 4 * st.bmap.numel(),
            int(steps8.sum()), "int32", floor_ms,
            flush, f"dri batch 8x1080p, {lanes.shape[0]} lanes",
            plain_iters=1, plain_warmup=0),
        "spec_scan": time_entry(
            "spec_scan", lambda: jed.spec_scan(ss, rs["chunks"]),
            lambda: jed.spec_scan_plain(ss, rs["chunks"]),
            ss.n + 4 * ss.luts.numel() + 4 * ss.fast.numel() + 8 * nl
            + 28 * nl + 4 * rs["snap"].numel(), spec_symbols, "int32",
            floor_ms,
            flush, f"spec batch 8x1080p, {nl} chunks", plain_iters=1,
            plain_warmup=0),
        "spec_merge": time_entry(
            "spec_merge", lambda: jed.spec_merge(ss, rs["ent"], rs["snap"]),
            lambda: jed.spec_merge_plain(ss, rs["ent"], rs["snap"]),
            merge["bytes"], merge["symbols"], "int32", floor_ms, flush,
            f"spec batch 8x1080p, {nl} chunks", plain_iters=1,
            plain_warmup=0),
    }
    del flush
    timed["entropy_decode"].update(
        lanes=int(lanes.shape[0]), ctas=int(plan.shape[0]),
        longest_lane_symbols=int(steps8.max()), symbols=int(steps8.sum()),
        fast_hit_share=k9_walk["hit_share"],
        spec_emit_ms=gpu_ms(lambda: jed.decode_lanes(
            ss, rs["lanes"], rs["plan"], rs["flat"].numel()), 10))
    for name in ("spec_scan", "spec_merge"):
        timed[name]["lanes"] = nl
    timed["spec_scan"].update(symbols=k10_walk["symbols"],
                              longest_lane_symbols=k10_walk["longest"],
                              fast_hit_share=k10_walk["hit_share"])
    timed["spec_merge"].update(symbols=merge["symbols"],
                               longest_lane_symbols=merge["longest"])
    for name in ("entropy_decode", "spec_scan"):
        t = timed[name]
        t["ns_per_symbol_longest_lane"] = \
            t["ms"] * 1e6 / t["longest_lane_symbols"]
        t["ns_per_symbol_longest_lane_cold"] = \
            t["ms_cold"] * 1e6 / t["longest_lane_symbols"]
    k9, k10 = timed["entropy_decode"], timed["spec_scan"]
    log("time entropy kernels", k9_lanes=int(lanes.shape[0]),
        k9_ctas=int(plan.shape[0]),
        k9_longest_lane_symbols=int(steps8.max()),
        k9_symbols=int(steps8.sum()),
        k9_ns_per_symbol_longest_lane=
        f"{k9['ns_per_symbol_longest_lane']:.1f}",
        k9_fast_hit_share=f"{k9_walk['hit_share']:.4f}",
        k9_spec_emit_ms=f"{timed['entropy_decode']['spec_emit_ms']:.4f}",
        spec_chunks=nl, spec_symbols=spec_symbols,
        k10_longest_chunk_symbols=k10_walk["longest"],
        k10_ns_per_symbol_longest_chunk=
        f"{k10['ns_per_symbol_longest_lane']:.1f}",
        k10_fast_hit_share=f"{k10_walk['hit_share']:.4f}",
        fast_bits=jed.FAST_BITS,
        fast_table_smem_bytes_requested=4 * (4 << jed.FAST_BITS),
        merge_symbols=merge["symbols"],
        merge_longest_lane_symbols=merge["longest"],
        k11_ns_per_symbol_longest_walk=
        f"{timed['spec_merge']['ms'] * 1e6 / merge['longest']:.1f}",
        merge_scan_bytes=merge["scan_bytes"],
        merge_snapshot_bytes=merge["snap_bytes"],
        merge_bytes=merge["bytes"])
    return timed, {"dri_batch": launches["all_device"],
                   "dri_hybrid": launches["hybrid"],
                   "dri_mixed": mixed_launches, "spec_batch": spec_launches}


def riff_chunks(data: bytes) -> dict:
    """A WebP file's top-level chunks, {tag: payload}."""
    import struct
    pos, out = 12, {}
    while pos + 8 <= len(data):
        tag = data[pos:pos + 4].decode("latin1")
        size = struct.unpack_from("<I", data, pos + 4)[0]
        out[tag] = data[pos + 8:pos + 8 + size]
        pos += 8 + size + (size & 1)
    return out


WEBP_ENV = ("FFPIC_VP8_DEVICE", "FFPIC_VP8_DEVICE_COLOR", "FFPIC_HOST_COLOR")
WEBP_SWITCHES = {"neither": {}, "vp8_device": {"FFPIC_VP8_DEVICE": "1"},
                 "device_color": {"FFPIC_VP8_DEVICE_COLOR": "1"},
                 "both": {"FFPIC_VP8_DEVICE": "1",
                          "FFPIC_VP8_DEVICE_COLOR": "1"}}
WEBP_FIXTURES = ("lossy_1080p.webp", "lossy_512.webp", "alpha_1080p.webp",
                 "odd_333x199.webp", "lossless_160x120.webp",
                 "animated_96x64.webp")


def k13_bytes(h: int, w: int, alpha: bool) -> int:
    """What K13 must move for an h x w frame: Y, U, V (and alpha) read
    once, the RGBA written once."""
    return (5 + alpha) * h * w + 2 * ((h + 1) // 2) * ((w + 1) // 2)


def k13_cases(dev) -> dict:
    """K13's lists for one launch each: name -> (frames, outputs or None).
    ``testing.vp8_cases``'s frames (sizes 1x1 to 199x333, mixed alpha)
    as MB-padded planes, staged by ``vp8_kernels.stage_frames`` (every
    row 16-byte aligned), and as views at odd offsets into wider rows
    (pitched, byte loads) written to RGBA 4 bytes off a 16-byte boundary;
    frames that end inside tiles (1081x1919, 65x257, 1x4097, 4097x1,
    w % 4 of 0 to 3); and 70 small frames, past one launch's
    ``MAX_FRAMES``."""
    import numpy as np
    import torch
    from ffpic_tpu_torch import testing
    from ffpic_tpu_torch.ops import vp8_kernels as vk
    rng = np.random.default_rng(13)

    def frame(h, w, alpha):
        ph, pw = -(-h // 16) * 16, -(-w // 16) * 16
        return (*[rng.integers(0, 256, s, dtype=np.uint8) for s in
                  ((ph, pw), (ph // 2, pw // 2), (ph // 2, pw // 2))], h, w,
                rng.integers(0, 256, (h, w), dtype=np.uint8) if alpha
                else None)

    def on_card(frames, at=0):
        out = []
        for f in frames:
            planes = []
            for p in (*f[:3], f[5]):
                if p is None:
                    planes.append(None)
                    continue
                t = torch.from_numpy(np.ascontiguousarray(p)).to(dev)
                if at:
                    wide = torch.zeros((t.shape[0], t.shape[1] + at + 5),
                                       dtype=torch.uint8, device=dev)
                    wide[:, at:at + t.shape[1]] = t
                    t = wide[:, at:at + t.shape[1]]
                planes.append(t)
            out.append((*planes[:3], f[3], f[4], planes[3]))
        return out

    def off_16(frames):
        # each output 4 bytes past a 16-byte boundary
        outs = []
        for f in frames:
            buf = torch.empty(4 * f[3] * f[4] + 4, dtype=torch.uint8,
                              device=dev)
            outs.append(buf[4:].view(f[3], f[4], 4))
        return outs

    cases = list(testing.vp8_cases()["color"].values())
    edges = [frame(*s) for s in ((1081, 1919, True), (65, 257, False),
                                 (1, 4097, True), (4097, 1, False),
                                 (64, 256, True), (33, 130, False))]
    many = [frame(1 + k % 5, 1 + (7 * k) % 11, k % 3 == 0) for k in range(70)]
    pitched = on_card(cases, 3)
    return {"vp8_cases_staged": (vk.stage_frames(cases, dev), None),
            "vp8_cases_padded": (on_card(cases), None),
            "vp8_cases_pitched_off16": (pitched, off_16(pitched)),
            "edge_tiles_staged": (vk.stage_frames(edges, dev), None),
            "edge_tiles_pitched": (on_card(edges, 1), None),
            "70_frames": (vk.stage_frames(many, dev), None)}


def webp_paths(dev, jpegs, pngs, floor_ms: float, errs: dict):
    """The WebP codec on the card: K12 and K13 against their plain
    versions (``testing.vp8_cases`` and the 1080p path shapes, K12 also
    against the native host transform; K13's batch entry on
    ``k13_cases``' lists and the webp batch's 8 frames), ``load`` of
    every committed fixture under the four combinations of
    ``FFPIC_VP8_DEVICE`` and ``FFPIC_VP8_DEVICE_COLOR`` (each equal to
    the CPU route, with fresh launch counts), ``decode_batch`` of 8 x
    1080p WebPs under the colour switch (K13 once) and a mixed JPEG +
    PNG + WebP batch under both (K13 once for its 2 WebPs); the
    timings: K13 over the webp batch's 8 frames into the batch tensor,
    and on one 1080p frame without and with alpha.  Returns {kernel:
    timing entry} and the launches of each path."""
    import numpy as np
    import torch
    import ffpic_tpu_torch
    from ffpic_tpu_torch import native, testing
    from ffpic_tpu_torch.formats import vp8, webp
    from ffpic_tpu_torch.ops import cuda_jpeg, cuda_png, cuda_vp8
    from ffpic_tpu_torch.ops import vp8_kernels as vk
    from ffpic_tpu_torch.utils.timing import (INT32_OPS_PER_S, bound, gpu_ms,
                                              gpu_ms_cold)

    def reset():
        torch.cuda.synchronize()
        cuda_jpeg.reset_launches()
        cuda_png.reset_launches()
        cuda_vp8.reset_launches()

    def counts():
        torch.cuda.synchronize()
        return {**{k: v for k, v in cuda_jpeg.launches.items() if v},
                **{k: v for k, v in cuda_png.launches.items() if v},
                **{k: v for k, v in cuda_vp8.launches.items()
                   if v or k != "vp8_wavefront"}}

    clear = {k: None for k in WEBP_ENV}
    files = {n: testing.webp_fixture(n) for n in WEBP_FIXTURES}
    log("inputs webp", fixtures=",".join(f"{n}:{len(d)}"
                                         for n, d in files.items()))

    # --- K12 and K13 against their plain versions on the card ---------------
    def to(*arrays):
        return [None if a is None else torch.from_numpy(np.ascontiguousarray(
            a)).to(dev) for a in arrays]

    for levels, dq, has_y2 in testing.vp8_cases()["residuals"].values():
        t = to(levels, dq, has_y2)
        exact("vp8_residuals", cuda_vp8.vp8_residuals(*t),
              vk.vp8_residuals_plain(*t), errs)
    k13_lists = k13_cases(dev)
    for name, (frames, outs) in k13_lists.items():
        before = cuda_vp8.launches["vp8_yuv_to_rgba"]
        got = cuda_vp8.vp8_yuv_to_rgba_batch(frames, outs)
        torch.cuda.synchronize()
        want = vk.vp8_yuv_to_rgba_batch_plain(frames)
        for g, w_ in zip(got, want):
            exact("vp8_yuv_to_rgba", g, w_, errs)
        n = cuda_vp8.launches["vp8_yuv_to_rgba"] - before
        if n != -(-len(frames) // cuda_vp8.MAX_FRAMES):
            raise AssertionError(f"K13 list {name}: {n} launches for "
                                 f"{len(frames)} frames")
    # the path shapes: the 1080p fixtures' parse state and planes
    chunks = {n: riff_chunks(files[n]) for n in
              ("lossy_1080p.webp", "alpha_1080p.webp")}
    dec = vp8.VP8Decoder(chunks["lossy_1080p.webp"]["VP8 "], device=dev)
    dec._parse_control_partition()
    dec._dequant_tables()
    dec._parse_mb_headers()
    dec._parse_tokens()
    seg = (dec.seg if dec.hdr.seg_enabled
           else np.zeros((dec.mbh, dec.mbw), np.int32))
    lv_d, dq_d, hy_d = to(dec.levels, np.array(dec.dq, np.int32)[seg],
                          dec.has_y2)
    res = cuda_vp8.vp8_residuals(lv_d, dq_d, hy_d)
    exact("vp8_residuals", res, vk.vp8_residuals_plain(lv_d, dq_d, hy_d), errs)
    host_res = native.vp8_residuals(
        dec.levels, dec.nnz_total, np.array(dec.dq, np.int32),
        dec.seg if dec.hdr.seg_enabled else None,
        dec.has_y2.astype(np.uint8), dec.mbh, dec.mbw)
    exact("vp8_residuals", res.cpu(), torch.from_numpy(host_res), errs)
    Y, U, V = vp8.VP8Decoder(chunks["lossy_1080p.webp"]["VP8 "]).decode()
    alpha = webp._decode_alpha(chunks["alpha_1080p.webp"]["ALPH"], H, W)
    ty, tu, tv, ta = to(Y, U, V, alpha)
    rgba = cuda_vp8.vp8_yuv_to_rgba(ty, tu, tv, H, W)
    exact("vp8_yuv_to_rgba", rgba, vk.vp8_yuv_to_rgba_plain(ty, tu, tv, H, W),
          errs)
    exact("vp8_yuv_to_rgba", rgba.cpu(), torch.from_numpy(
        native.vp8_color_libwebp(np.ascontiguousarray(Y[:H, :W]), U, V, H, W)),
          errs)
    exact("vp8_yuv_to_rgba", cuda_vp8.vp8_yuv_to_rgba(ty, tu, tv, H, W, ta),
          vk.vp8_yuv_to_rgba_plain(ty, tu, tv, H, W, ta), errs)
    # the path's shapes: the webp batch's 8 frames staged as decode_batch
    # stages them, in one launch into the batch tensor
    path_frames = vk.stage_frames([(Y, U, V, H, W, a) for a in (None, alpha)]
                                  * (N // 2), dev)
    path_out = cuda_vp8.vp8_yuv_to_rgba_batch(path_frames)
    exact("vp8_yuv_to_rgba", path_out,
          vk.vp8_yuv_to_rgba_batch_plain(path_frames), errs)
    log("check K12 K13", vp8_residuals="exact", vp8_yuv_to_rgba="exact",
        cases=",".join([*testing.vp8_cases()["residuals"], *k13_lists]) +
        ",1080p_parse,1080p_planes,1080p_alpha,webp_batch_8",
        host_residuals="exact", host_color="exact",
        macroblocks=f"{dec.mbw}x{dec.mbh}",
        segments=int(dec.hdr.seg_enabled),
        bpred_mbs=int((dec.ymode == vp8.B_PRED).sum()))

    # --- load of every fixture under the four switch combinations -----------
    loads = {}
    for name, data in files.items():
        with environ(**clear):
            want = [p.pixels for p in ffpic_tpu_torch.load_all(
                data, device="cpu")]
        vp8_still = "VP8 " in riff_chunks(data)
        n_vp8 = (len(want) if name.startswith("animated")
                 else int(vp8_still))
        for sw, env in WEBP_SWITCHES.items():
            with environ(**{**clear, **env}):
                reset()
                got = ffpic_tpu_torch.load_all(data)
                n = counts()
            loads[(name, sw)] = n
            k12 = n_vp8 if "FFPIC_VP8_DEVICE" in env else 0
            k13 = int(vp8_still) if "FFPIC_VP8_DEVICE_COLOR" in env else 0
            if (n["vp8_residuals"], n["vp8_yuv_to_rgba"]) != (k12, k13) \
                    or len(n) != 2:
                raise AssertionError(f"webp load {name} {sw}: launches {n}, "
                                     f"expected K12 {k12}, K13 {k13}")
            if len(got) != len(want):
                raise AssertionError(f"webp load {name} {sw}: {len(got)} "
                                     f"pictures, the CPU route {len(want)}")
            for g, w_ in zip(got, want):
                if g.pixels.device.type != dev.type or g.pixels.dtype != \
                        torch.uint8 or not torch.equal(g.pixels.cpu(), w_):
                    raise AssertionError(
                        f"webp load {name} {sw}: differs from the CPU route")
        shape = tuple(want[0].shape)
        if shape[2] != 4 or (name.endswith("1080p.webp")
                             and shape[:2] != (H, W)):
            raise AssertionError(f"webp load {name}: shape {shape}")
        log("webp load path", file=name, shape=shape, pictures=len(want),
            launches=json.dumps({sw: [loads[(name, sw)]["vp8_residuals"],
                                      loads[(name, sw)]["vp8_yuv_to_rgba"]]
                                 for sw in WEBP_SWITCHES}).replace(" ", ""),
            switches="4", cpu_route="exact")

    # --- decode_batch: 8 x 1080p WebPs, and a mixed batch -------------------
    batch = [files["lossy_1080p.webp"], files["alpha_1080p.webp"]] * (N // 2)
    with environ(**clear):
        cpu = ffpic_tpu_torch.decode_batch(batch, device="cpu")
    with environ(**{**clear, "FFPIC_VP8_DEVICE_COLOR": "1"}):
        reset()
        out = ffpic_tpu_torch.decode_batch(batch, device=dev)
        launches_batch = counts()
    if (launches_batch["vp8_yuv_to_rgba"] != 1
            or launches_batch["vp8_residuals"] != 0
            or len(launches_batch) != 2):
        raise AssertionError(f"webp decode_batch: launches {launches_batch}")
    if tuple(out.shape) != (N, H, W, 4) or not torch.equal(out.cpu(), cpu):
        raise AssertionError("webp decode_batch: the card differs from the "
                             "CPU route by up to "
                             f"{max_abs_err(out.cpu(), cpu)}")
    log("webp decode_batch", members="lossy,alpha x 4 at 1080p",
        switch="FFPIC_VP8_DEVICE_COLOR", shape=tuple(out.shape),
        launches=launches_batch, cpu_route="exact")
    del out, cpu
    mixed = [jpegs[0], files["lossy_1080p.webp"], jpegs[1], pngs[0],
             jpegs[0], files["alpha_1080p.webp"], pngs[1], jpegs[1]]
    with environ(**clear):
        cpu = ffpic_tpu_torch.decode_batch(mixed, device="cpu")
    with environ(**{**clear, "FFPIC_VP8_DEVICE": "1",
                    "FFPIC_VP8_DEVICE_COLOR": "1"}):
        reset()
        out = ffpic_tpu_torch.decode_batch(mixed, device=dev)
        launches_mixed = counts()
    if (launches_mixed["vp8_residuals"], launches_mixed["vp8_yuv_to_rgba"]) \
            != (2, 1) or min(launches_mixed.get(k, 0) for k in (
                *PATH_420, "assemble_rgba")) < 1:
        raise AssertionError(f"mixed webp decode_batch: launches "
                             f"{launches_mixed}")
    if tuple(out.shape) != (N, H, W, 4) or not torch.equal(out.cpu(), cpu):
        raise AssertionError("mixed webp decode_batch: the card differs from "
                             f"the CPU route by up to "
                             f"{max_abs_err(out.cpu(), cpu)}")
    log("webp mixed decode_batch", members="4 jpeg, 2 png, 2 webp at 1080p",
        switches="FFPIC_VP8_DEVICE,FFPIC_VP8_DEVICE_COLOR",
        shape=tuple(out.shape), launches=launches_mixed, cpu_route="exact")
    del out, cpu

    # --- timing --------------------------------------------------------------
    flush = torch.empty(100 * 2 ** 20, dtype=torch.uint8, device=dev)
    nmb = dec.mbh * dec.mbw
    # ops, a multiply-add as 2: 16 dequant products a block, the two
    # passes of the 4x4 IDCT (about 176 integer ops a block) and the Y2
    # block's dequant and IWHT (about 80 a macroblock); K13 about 40 a
    # pixel (two chroma mixes of 7, the colour matrix and the clips)
    timed = {
        "vp8_residuals": time_entry(
            "vp8_residuals", lambda: cuda_vp8.vp8_residuals(lv_d, dq_d, hy_d),
            lambda: vk.vp8_residuals_plain(lv_d, dq_d, hy_d),
            nmb * (1600 + 24 + 1 + 768), nmb * (24 * 192 + 80), "int32",
            floor_ms, flush, "webp load 1080p FFPIC_VP8_DEVICE"),
        # the webp batch: 8 frames, 4 with alpha, in one launch
        "vp8_yuv_to_rgba": time_entry(
            "vp8_yuv_to_rgba",
            lambda: cuda_vp8.vp8_yuv_to_rgba_batch(path_frames, path_out),
            lambda: vk.vp8_yuv_to_rgba_batch_plain(path_frames),
            sum(k13_bytes(f[3], f[4], f[5] is not None)
                for f in path_frames),
            40 * N * H * W, "int32", floor_ms, flush,
            "webp decode_batch 8 x 1080p FFPIC_VP8_DEVICE_COLOR",
            # the wrapper checks 8 frames and packs their descriptors,
            # about 0.1 ms of host time a call: 20 stay inside the spin
            plain_iters=1, plain_warmup=1, warm_iters=20),
    }
    for key, frame in (("one_frame", (ty, tu, tv, H, W, None)),
                       ("one_frame_alpha", (ty, tu, tv, H, W, ta))):
        one = cuda_vp8.vp8_yuv_to_rgba(*frame)
        timed["vp8_yuv_to_rgba"][f"{key}_ms"] = gpu_ms(
            lambda: cuda_vp8.vp8_yuv_to_rgba_batch([frame], [one]), 50)
        timed["vp8_yuv_to_rgba"][f"{key}_ms_cold"] = gpu_ms_cold(
            lambda: cuda_vp8.vp8_yuv_to_rgba_batch([frame], [one]), 20,
            flush)
        timed["vp8_yuv_to_rgba"][f"{key}_bound_ms"] = bound(
            k13_bytes(H, W, frame[5] is not None), 40 * H * W,
            INT32_OPS_PER_S)[0]
    log("time K13 one frame", **{k: f"{v:.4f}" for k, v in
                                 timed["vp8_yuv_to_rgba"].items()
                                 if k.startswith("one_frame")})
    del flush
    def per_load(data, n=5):
        # the JAX bench's webp_512 trial: 5 loads back to back
        def run():
            for _ in range(n):
                ffpic_tpu_torch.load(data)
        return run

    for name, mp in (("lossy_512.webp", 512 * 512 / 1e6),
                     ("lossy_1080p.webp", H * W / 1e6)):
        for sw, env in (("neither", {}), *[(k, WEBP_SWITCHES[k]) for k in (
                "vp8_device", "device_color")]):
            with environ(**{**clear, **env}):
                ffpic_tpu_torch.load(files[name])
                wall, runs, stages = spans(per_load(files[name]), 5)
            metric = {("lossy_512.webp", "neither"): "webp_512_mps",
                      ("lossy_512.webp", "vp8_device"): "webp_device_mps",
                      ("lossy_512.webp", "device_color"):
                          "webp_device_color_mps"}.get(
                (name, sw), f"webp_1080p_{sw}_mps")
            log("time webp load", file=name, route=sw, metric=metric,
                value=f"{mp * 5 / wall:.2f}",
                ms_per_load=f"{wall / 5 * 1e3:.3f}",
                runs_ms=json.dumps([round(r / 5 * 1e3, 3)
                                    for r in runs]).replace(" ", ""),
                stage_ms=json.dumps(stages).replace(" ", ""))
    with environ(**{**clear, "FFPIC_VP8_DEVICE_COLOR": "1"}):
        wall, runs, stages = spans(lambda: ffpic_tpu_torch.decode_batch(
            batch, device=dev), 5)
    mp = N * H * W / 1e6
    log("time webp decode_batch", megapixels=mp, route="device_color",
        end_to_end_ms=f"{wall * 1e3:.3f}",
        end_to_end_ms_runs=json.dumps([round(w_ * 1e3, 3)
                                       for w_ in runs]).replace(" ", ""),
        webp_1080p_batch_mps=f"{mp / wall:.2f}",
        stage_ms=json.dumps(stages).replace(" ", ""))
    return timed, {"load_vp8_device": loads[("lossy_1080p.webp",
                                             "vp8_device")],
                   "load_device_color": loads[("lossy_1080p.webp",
                                               "device_color")],
                   "batch": launches_batch, "mixed": launches_mixed}


def wavefront_paths(dev, floor_ms: float, errs: dict):
    """B12 on the card: K18 ``vp8_wavefront`` against its plain version
    (``testing.wavefront_cases`` and every committed lossy fixture's VP8
    frames, each launched twice: fresh scratch) and against the host
    ``native.vp8_recon``'s luma; the path with fresh launch counts,
    ``ops.vp8_wavefront.make_wavefront`` on the 1080p fixture (K18 once a
    frame); the chain on the card, the 1080p levels through K12
    ``vp8_residuals`` into K18, against the host's luma.  The timings:
    K18 warm and L2 flushed beside its bound and its chain of macroblock
    steps, its plain version once, the host ``vp8_recon`` on the same
    frame.  Returns {kernel: timing entry} and the path's launches."""
    import numpy as np
    import torch
    from ffpic_tpu_torch import native, testing
    from ffpic_tpu_torch.ops import cuda_vp8
    from ffpic_tpu_torch.ops import vp8_kernels as vk
    from ffpic_tpu_torch.ops import vp8_wavefront as wf
    from ffpic_tpu_torch.utils.timing import gpu_ms

    def to(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrays]

    def k18_twice(res, ym, bm, want_plain):
        first = cuda_vp8.vp8_wavefront(res, ym, bm)
        exact("vp8_wavefront", first, want_plain, errs)
        exact("vp8_wavefront", cuda_vp8.vp8_wavefront(res, ym, bm), first,
              errs)

    t0 = time.perf_counter()
    cases = testing.wavefront_cases()
    for arrays in cases.values():
        t = to(*arrays)
        k18_twice(*t, wf.vp8_wavefront_plain(*t))
    frames = {}
    for name in testing.WAVEFRONT_FIXTURES:
        for k in range(len(testing.vp8_bitstreams(
                testing.webp_fixture(name)))):
            frames[f"{name}:{k}"] = inp = testing.wavefront_inputs(name, k)
            t = to(inp["residual"], inp["ymode"], inp["bmodes"])
            k18_twice(*t, wf.vp8_wavefront_plain(*t))
            exact("vp8_wavefront", cuda_vp8.vp8_wavefront(*t).cpu(),
                  torch.from_numpy(inp["Y"]), errs)
    # tall grids against the host luma (the plain version would walk
    # thousands of diagonals): 1200 x 2, and 9000 x 2, more row groups
    # than the card holds CTAs at once (132 SMs x at most 16 CTAs of 128
    # threads), so later rows start only when earlier CTAs take a second
    # ticket or finish
    rng = np.random.default_rng(7)
    talls = ((1200, 2), (9000, 2))
    for tall in talls:
        t_res = rng.integers(-300, 301, (*tall, 16, 4, 4)).astype(np.int32)
        t_ym = rng.integers(0, 5, tall).astype(np.int32)
        t_bm = rng.integers(0, 10, (*tall, 16)).astype(np.int32)
        r24 = np.zeros((*tall, 24, 4, 4), np.int16)
        r24[:, :, :16] = t_res
        t_y = np.zeros((16 * tall[0], 16 * tall[1]), np.uint8)
        t_uv = [np.zeros((8 * tall[0], 8 * tall[1]), np.uint8) for _ in "uv"]
        native.vp8_recon(t_y, *t_uv, r24, t_ym, t_bm,
                         np.zeros(tall, np.int32), *tall)
        exact("vp8_wavefront", cuda_vp8.vp8_wavefront(
            *to(t_res, t_ym, t_bm)).cpu(), torch.from_numpy(t_y), errs)
    log("check K18", vp8_wavefront="exact", cases=",".join(cases),
        tall=",".join(f"{w}x{h}" for h, w in talls) + " against the host "
        "luma",
        fixtures=",".join(frames), launched_twice="exact",
        host_vp8_recon="exact",
        bpred_mbs=json.dumps({k: int((f["ymode"] == 4).sum())
                              for k, f in frames.items()}).replace(" ", ""),
        seconds=f"{time.perf_counter() - t0:.3f}")

    # --- the path: make_wavefront on the 1080p frame -------------------------
    inp = frames["lossy_1080p.webp:0"]
    mbh, mbw = inp["mb"]
    res, ym, bm = to(inp["residual"], inp["ymode"], inp["bmodes"])
    run = wf.make_wavefront(mbh, mbw)
    torch.cuda.synchronize()
    cuda_vp8.reset_launches()
    y = run(res, ym, bm)
    torch.cuda.synchronize()
    launches = dict(cuda_vp8.launches)
    if launches != {"vp8_residuals": 0, "vp8_yuv_to_rgba": 0,
                    "vp8_wavefront": 1}:
        raise AssertionError(f"wavefront path: launches {launches}")
    if tuple(y.shape) != (16 * mbh, 16 * mbw) or y.dtype != torch.uint8 \
            or not torch.equal(y.cpu(), torch.from_numpy(inp["Y"])):
        raise AssertionError("wavefront path: differs from the host luma")
    # the chain on the card: the levels through K12, its luma blocks into
    # K18, no host step between
    lv, dq, hy = to(inp["levels"], inp["dq_per_mb"], inp["has_y2"])
    cuda_vp8.reset_launches()
    y_chain = run(vk.vp8_residuals(lv, dq, hy)[:, :, :16].to(torch.int32)
                  .contiguous(), ym, bm)
    torch.cuda.synchronize()
    chain_launches = dict(cuda_vp8.launches)
    if chain_launches != {"vp8_residuals": 1, "vp8_yuv_to_rgba": 0,
                          "vp8_wavefront": 1}:
        raise AssertionError(f"wavefront chain: launches {chain_launches}")
    if not torch.equal(y_chain.cpu(), torch.from_numpy(inp["Y"])):
        raise AssertionError("K12 -> K18 differs from the host luma")
    steps = 2 * (mbh - 1) + mbw
    log("wavefront path", file="lossy_1080p.webp", macroblocks=f"{mbw}x{mbh}",
        bpred_mbs=int((inp["ymode"] == 4).sum()), launches=launches,
        host_luma="exact", chain="K12 vp8_residuals -> K18",
        chain_launches=chain_launches, chain_host_luma="exact")

    # --- timing --------------------------------------------------------------
    flush = torch.empty(100 * 2 ** 20, dtype=torch.uint8, device=dev)
    nmb = mbh * mbw
    # bytes: the residuals (1 KB an MB), ymode and bmodes read once, the
    # luma written once; ops about 8 integer ops a pixel (prediction,
    # residual add, clip); the chain: 2 (mbh - 1) + mbw MB steps in turn
    timed = {"vp8_wavefront": time_entry(
        "vp8_wavefront", lambda: cuda_vp8.vp8_wavefront(res, ym, bm),
        lambda: wf.vp8_wavefront_plain(res, ym, bm),
        nmb * (256 * 4 + 4 + 16 * 4) + nmb * 256, 8 * nmb * 256, "int32",
        floor_ms, flush, "wavefront 1080p", plain_iters=1, plain_warmup=1)}
    del flush
    e = timed["vp8_wavefront"]
    small = frames["lossy_512.webp:0"]
    r5, y5, b5 = to(small["residual"], small["ymode"], small["bmodes"])
    e["ms_512"] = gpu_ms(lambda: cuda_vp8.vp8_wavefront(r5, y5, b5), 50)
    # the chain: T = S c + R L over S = 2 (mbh - 1) + mbw MB steps, R = mbh
    # - 1 of them row hand-offs; c an MB step's cost, from one-row frames
    # (no row waits on another) of 120 MBs, all B_PRED or all 16x16, mixed
    # by the frame's share of B_PRED MBs; L what the rest implies
    # (the log line's alone: derived, not measured, so not in the entry)
    rng = np.random.default_rng(18)
    chain = {}
    for kind in ("bpred", "16x16"):
        ym1 = (np.full((1, 120), 4) if kind == "bpred"
               else rng.integers(0, 4, (1, 120))).astype(np.int32)
        one = to(rng.integers(-300, 301, (1, 120, 16, 4, 4)).astype(np.int32),
                 ym1, rng.integers(0, 10, (1, 120, 16)).astype(np.int32))
        exact("vp8_wavefront", cuda_vp8.vp8_wavefront(*one),
              wf.vp8_wavefront_plain(*one), errs)
        chain[f"c_{kind}_us"] = gpu_ms(
            lambda: cuda_vp8.vp8_wavefront(*one), 50) * 1e3 / 120
    for tag, f, ms in (("1080p", inp, e["ms"]), ("512", small, e["ms_512"])):
        fh, fw = f["mb"]
        share = float((f["ymode"] == 4).mean())
        c = share * chain["c_bpred_us"] + (1 - share) * chain["c_16x16_us"]
        chain[f"bpred_share_{tag}"] = share
        chain[f"ms_per_chain_step_{tag}"] = ms / (2 * (fh - 1) + fw)
        chain[f"L_us_{tag}"] = (ms * 1e3 - (2 * (fh - 1) + fw) * c) / (fh - 1)

    def host():
        Y = np.zeros((16 * mbh, 16 * mbw), np.uint8)
        U = np.zeros((8 * mbh, 8 * mbw), np.uint8)
        V = np.zeros((8 * mbh, 8 * mbw), np.uint8)
        native.vp8_recon(Y, U, V, inp["residual24"], inp["ymode"],
                         inp["bmodes"], inp["uvmode"], mbh, mbw)
    host()
    walls = []
    for _ in range(5):
        t1 = time.perf_counter()
        host()
        walls.append((time.perf_counter() - t1) * 1e3)
    e["host_vp8_recon_ms"] = sorted(walls)[2]
    log("time wavefront", ms=f"{e['ms']:.4f}", ms_cold=f"{e['ms_cold']:.4f}",
        ms_512=f"{e['ms_512']:.4f}", chain_steps=steps,
        chain_steps_512=2 * (small["mb"][0] - 1) + small["mb"][1],
        ms_per_chain_step=f"{e['ms'] / steps:.5f}",
        ms_per_chain_step_512=f"{chain['ms_per_chain_step_512']:.5f}",
        c_bpred_us=f"{chain['c_bpred_us']:.4f}",
        c_16x16_us=f"{chain['c_16x16_us']:.4f}",
        bpred_share=f"{chain['bpred_share_1080p']:.4f}",
        bpred_share_512=f"{chain['bpred_share_512']:.4f}",
        L_us=f"{chain['L_us_1080p']:.4f}",
        L_us_512=f"{chain['L_us_512']:.4f}",
        bound_ms=f"{e['bound_ms']:.4f}", plain_ms=f"{e['plain_ms']:.1f}",
        host_vp8_recon_ms=f"{e['host_vp8_recon_ms']:.4f}",
        host_vp8_recon_ms_runs=json.dumps([round(w, 4) for w in walls])
        .replace(" ", ""), host_planes="Y,U,V (host clock, median of 5)")
    return timed, {"path": launches, "chain": chain_launches}


HEIF_ENV = ("FFPIC_HEVC_DEVICE", "FFPIC_HEIF_DEVICE_COLOR",
            "FFPIC_NO_NATIVE_RECON")
HEIF_SWITCHES = {"neither": {}, "hevc_device": {"FFPIC_HEVC_DEVICE": "1"},
                 "device_color": {"FFPIC_HEIF_DEVICE_COLOR": "1"},
                 "both": {"FFPIC_HEVC_DEVICE": "1",
                          "FFPIC_HEIF_DEVICE_COLOR": "1"}}


def butterfly_ops(n: int) -> int:
    """int32 operations of one n-point 1-D inverse DCT as K14 runs it, a
    multiply-add as 2: the (n/2)^2 multiply-adds and n sums of each level
    of the even/odd recursion, 64 * c at its root."""
    return 1 if n == 1 else butterfly_ops(n // 2) + 2 * (n // 2) ** 2 + n


def hevc_ops(metas) -> int:
    """The int32 operations K14 runs over the TUs of ``metas`` (tu_meta
    arrays): each transform TU's 2n 1-D passes (butterflies; the 4x4
    DST's direct 16 multiply-adds, 32), 4 a level of dequant (product,
    rounding add, shift, clip) and 3 a level of each pass's rounding;
    skip TUs the dequant and one rounding; bypass TUs nothing."""
    import numpy as np
    total = 0
    for meta in metas:
        n = meta[:, 2].astype(np.int64)
        skip, byp, dst = meta[:, 4] != 0, meta[:, 5] != 0, meta[:, 7] != 0
        one_d = np.select([dst & (n == 4)], [32],
                          np.vectorize(butterfly_ops)(n))
        tr = ~skip & ~byp
        total += int((tr * (2 * n * one_d + 10 * n * n)).sum()
                     + (skip & ~byp).astype(np.int64) @ (7 * n * n))
    return total


def heif_paths(dev, jpegs, floor_ms: float, errs: dict):
    """HEIF on the card: K14 and K15 against their plain versions
    (``testing.hevc_cases``, ``heif_color_cases`` and the 12 MP fixture's
    48 tiles), ``load`` of the fixture and of ``testing.heif_cases``'
    small HEICs under the four combinations of ``FFPIC_HEVC_DEVICE`` and
    ``FFPIC_HEIF_DEVICE_COLOR`` (each equal to the CPU route, with fresh
    launch counts), a ``decode_batch`` of two HEICs beside a JPEG; the
    timings.  Returns {kernel: timing entry} and the launches of each
    path."""
    import numpy as np
    import torch
    import ffpic_tpu_torch
    from ffpic_tpu_torch import testing
    from ffpic_tpu_torch.formats import heif
    from ffpic_tpu_torch.make_heif_fixtures import synth_rgb
    from ffpic_tpu_torch.ops import cuda_hevc, cuda_jpeg
    from ffpic_tpu_torch.ops import hevc_kernels as hk
    from ffpic_tpu_torch.utils import trace
    from ffpic_tpu_torch.utils.timing import (INT32_OPS_PER_S, bound, gpu_ms,
                                              gpu_ms_cold)

    def reset():
        torch.cuda.synchronize()
        cuda_jpeg.reset_launches()
        cuda_hevc.reset_launches()

    def counts():
        torch.cuda.synchronize()
        return {**{k: v for k, v in cuda_jpeg.launches.items() if v},
                **cuda_hevc.launches}

    clear = {k: None for k in HEIF_ENV}
    t0 = time.perf_counter()
    data = testing.heif_fixture()
    s = heif.parse_structure(data)
    tiles = [t for r, f, tos in s["refs"] if r == "dimg" for t in tos]
    tus = [testing.heif_tile_tus(data, t, s) for t in tiles]
    sizes = np.concatenate([tu[:, 2] for tu, _, _ in tus])
    dst = int(sum(int(((tu[:, 2] == 4) & (tu[:, 7] != 0)).sum())
                  for tu, _, _ in tus))
    log("inputs heif", file="heic_12mp_grid.heic", bytes=len(data),
        tiles=len(tiles), tus=len(sizes),
        levels=sum(lv.size for _, lv, _ in tus),
        buckets=json.dumps({"4dct": int((sizes == 4).sum()) - dst,
                            "4dst": dst, **{str(n): int((sizes == n).sum())
                                            for n in (8, 16, 32)}})
        .replace(" ", ""),
        skip=int(sum(tu[:, 4].sum() for tu, _, _ in tus)),
        bypass=int(sum(tu[:, 5].sum() for tu, _, _ in tus)),
        seconds=f"{time.perf_counter() - t0:.3f}")

    # --- K14 and K15 against their plain versions on the card ---------------
    # each edge case in a launch of its own; the 48 tiles' TUs in one
    # launch, as a grid load under FFPIC_HEVC_DEVICE runs them
    grid_tus = [*testing.hevc_cases().values(),
                (np.concatenate([tu for tu, _, _ in tus]),
                 np.concatenate([lv for _, lv, _ in tus]), tus[0][2])]
    for meta, lv, bd in grid_tus:
        lv_d, plan, _ = hk.stage_residuals([(meta, lv)], dev)
        exact("hevc_residuals", cuda_hevc.hevc_residuals(lv_d, bd, *plan),
              hk.hevc_residuals_plain(torch.from_numpy(meta).to(dev), lv_d,
                                      bd), errs)

    # K15: each colour case as a single item, and at an offset of a larger
    # canvas that it leaves partly uncovered and that crops it; the tile
    # layouts; the fixture's 48 tiles in one launch, in every mode
    def k15(planes, boxes, ch, cw, mode):
        st = hk.stage_tiles(planes, boxes, ch, cw, dev)
        exact("hevc_yuv_to_rgba", hk.hevc_tiles_to_rgba(st, mode),
              hk.hevc_tiles_to_rgba_plain(st, mode), errs)

    for y, u, v, oh, ow, mode in testing.heif_color_cases().values():
        planes = [p for p in (y, u, v) if p is not None]
        k15([planes], [(0, 0, oh, ow)], oh, ow, mode)
        k15([planes], [(3, 5, oh, ow)], oh + 3, ow - ow // 3 + 5, mode)
    for layout in testing.heif_tile_layouts().values():
        k15(*layout)
    with environ(**clear):
        items = heif._map_tiles(
            lambda t: heif._decode_item_planes(data, s, t), tiles, None)
    grid = heif._grid_layout(heif.read_item(data, s, s["primary"]))
    gh, gw = grid["height"], grid["width"]
    for k, t in enumerate(items):
        r, c = divmod(k, grid["cols"])
        t.y0, t.x0 = r * t.out_h, c * t.out_w
    fixture = heif.HeifFile(pic=None, tiles=items, grid=(gh, gw))
    staged = heif._stage_tiles(fixture, dev)
    for mode in ("bt601", "reference", "rgb"):
        exact("hevc_yuv_to_rgba", hk.hevc_tiles_to_rgba(staged, mode),
              hk.hevc_tiles_to_rgba_plain(staged, mode), errs)
    log("check K14 K15", hevc_residuals="exact", hevc_yuv_to_rgba="exact",
        cases=",".join([*testing.hevc_cases(), *testing.heif_color_cases(),
                        *testing.heif_tile_layouts()])
        + f",{len(tiles)}_fixture_tiles_tus_in_one_launch,{len(tiles)}_"
        "fixture_tiles_colour_in_one_launch_bt601_reference_rgb",
        colour_cases="single_item,offset_in_a_larger_canvas")

    # --- load of the fixture and the small HEICs under the switches ---------
    small = testing.heif_cases()
    loads = {}
    psnr = None
    for name, d in (("heic_12mp_grid", data), *small.items()):
        for sw, env in HEIF_SWITCHES.items():
            with environ(**{**clear, **env}):
                want = ffpic_tpu_torch.load(d, device="cpu")
                reset()
                got = ffpic_tpu_torch.load(d)
                n = counts()
            loads[(name, sw)] = n
            if got.pixels.device.type != dev.type or not torch.equal(
                    got.pixels.cpu(), want.pixels):
                raise AssertionError(f"heif load {name} {sw}: differs from "
                                     "the CPU route by up to "
                                     f"{max_abs_err(got.pixels.cpu(), want.pixels)}")
            if (got.width, got.height) != (want.width, want.height):
                raise AssertionError(f"heif load {name} {sw}: size")
            if name == "heic_12mp_grid":
                # K14 and K15 once a grid load each
                k14 = 1 if "FFPIC_HEVC_DEVICE" in env else 0
                k15 = 1 if "FFPIC_HEIF_DEVICE_COLOR" in env else 0
                if (n["hevc_residuals"], n["hevc_yuv_to_rgba"]) != \
                        (k14, k15) or len(n) != 2:
                    raise AssertionError(f"heif load {name} {sw}: launches "
                                         f"{n}, expected K14 {k14}, K15 "
                                         f"{k15}")
            elif ("FFPIC_HEVC_DEVICE" in env) != (n["hevc_residuals"] > 0) \
                    or ("FFPIC_HEIF_DEVICE_COLOR" in env) != (
                        n["hevc_yuv_to_rgba"] > 0) or len(n) != 2:
                raise AssertionError(f"heif load {name} {sw}: launches {n}")
        if name == "heic_12mp_grid":
            # the decode against the content the fixture was made from
            # (27.14 dB on the CPU: the q50 encode drops the noise)
            px = want.pixels
            ref = torch.from_numpy(synth_rgb(gh, gw, 11))
            mse = (px[..., :3].double() - ref.double()).pow(2).mean().item()
            psnr = round(float(10 * np.log10(255 ** 2 / mse)), 2)
            if tuple(px.shape) != (gh, gw, 4) or psnr < 25 \
                    or not bool((px[..., 3] == 255).all()):
                raise AssertionError(f"heif fixture: shape {tuple(px.shape)}"
                                     f", PSNR {psnr} dB against its source")
            del px, ref
        log("heif load path", file=name, shape=(got.height, got.width),
            launches=json.dumps({sw: [loads[(name, sw)]["hevc_residuals"],
                                      loads[(name, sw)]["hevc_yuv_to_rgba"]]
                                 for sw in HEIF_SWITCHES}).replace(" ", ""),
            switches="4", cpu_route="exact",
            **({"psnr_db": psnr} if name == "heic_12mp_grid" else {}))
    del got, want

    # --- decode_batch: two HEICs beside a JPEG ------------------------------
    jpeg = testing.synth_jpeg_420(128, 128, 85, 3)
    batch = [small["skip"], jpeg, small["deblock"]]
    mixed = {}
    for sw, env in HEIF_SWITCHES.items():
        with environ(**{**clear, **env}):
            cpu = ffpic_tpu_torch.decode_batch(batch, device="cpu")
            reset()
            out = ffpic_tpu_torch.decode_batch(batch, device=dev)
            n = counts()
        mixed[sw] = n
        want_n = (2 * ("FFPIC_HEVC_DEVICE" in env),
                  2 * ("FFPIC_HEIF_DEVICE_COLOR" in env))
        if (n["hevc_residuals"], n["hevc_yuv_to_rgba"]) != want_n or \
                min(n.get(k, 0) for k in PATH_420) < 1:
            raise AssertionError(f"heif decode_batch {sw}: launches {n}")
        if tuple(out.shape) != (3, 128, 128, 4) or not torch.equal(
                out.cpu(), cpu):
            raise AssertionError(f"heif decode_batch {sw}: differs from the "
                                 "CPU route")
    log("heif decode_batch", members="heic skip, jpeg, heic deblock at 128",
        launches=json.dumps({k: [v["hevc_residuals"], v["hevc_yuv_to_rgba"]]
                             for k, v in mixed.items()}).replace(" ", ""),
        cpu_route="exact")

    # --- timing --------------------------------------------------------------
    flush = torch.empty(100 * 2 ** 20, dtype=torch.uint8, device=dev)
    # K14 as the grid load runs it, one launch over all 48 tiles' TUs;
    # beside it the 48 launches of a launch a tile and the median tile
    # alone. Bytes: levels in and residuals out at 2 each, a TU's
    # descriptor (8), a CTA row (16); ops: those K14 runs (hevc_ops:
    # butterflies, dequant, roundings), and beside them the direct
    # product of both passes, 4 n^3 a TU (a multiply-add as 2)
    staged_tus = [hk.stage_residuals([(meta, lv)], dev)
                  for meta, lv, _ in tus]
    lv_all, plan_all, _ = hk.stage_residuals(
        [(meta, lv) for meta, lv, _ in tus], dev)
    metas = [m for m, _, _ in tus]
    meta_all = torch.from_numpy(np.concatenate(metas)).to(dev)
    bd = tus[0][2]

    def k14_bytes(metas, lvs, nctas):
        return 4 * sum(lv.size for lv in lvs) + 8 * sum(map(len, metas)) \
            + 16 * nctas

    def k14_direct(metas):
        return sum(int((4 * m[:, 2].astype(np.int64) ** 3).sum())
                   for m in metas)

    load_bytes = k14_bytes(metas, [lv for _, lv, _ in tus], len(plan_all[1]))
    timed = {"hevc_residuals": time_entry(
        "hevc_residuals",
        lambda: cuda_hevc.hevc_residuals(lv_all, bd, *plan_all),
        lambda: hk.hevc_residuals_plain(meta_all, lv_all, bd), load_bytes,
        hevc_ops(metas), "int32", floor_ms, flush,
        f"heif load FFPIC_HEVC_DEVICE, the {len(tiles)} tiles' "
        f"{len(meta_all)} TUs in one launch")}

    def per_tile():
        for l_, p_, _ in staged_tus:
            cuda_hevc.hevc_residuals(l_, bd, *p_)
    per = sorted(range(len(tus)), key=lambda k: len(tus[k][0]))
    mid = per[len(per) // 2]
    lv_d, plan, _ = staged_tus[mid]
    a_tile = {
        "tile": tiles[mid], "tus": len(tus[mid][0]),
        "ms": gpu_ms(lambda: cuda_hevc.hevc_residuals(lv_d, bd, *plan), 50),
        "ms_cold": gpu_ms_cold(
            lambda: cuda_hevc.hevc_residuals(lv_d, bd, *plan), 20, flush),
        "bytes": k14_bytes([tus[mid][0]], [tus[mid][1]], len(plan[1])),
        "ops": hevc_ops([tus[mid][0]])}
    a_tile["bound_ms"], a_tile["bound_by"] = bound(
        a_tile["bytes"], a_tile["ops"], INT32_OPS_PER_S)
    t = timed["hevc_residuals"]
    # 2 loads a timing of the 48 launches: 96 launches take the host about
    # 3 ms to enqueue, well inside the spin kernel that gpu_ms queues them
    # behind. The kernels line takes the measured times; the counts
    # worked out from the TU lists stay on the detail line
    t.update(launches_48_ms=gpu_ms(per_tile, 2),
             launches_48_ms_cold=gpu_ms_cold(per_tile, 5, flush))
    ops_direct = k14_direct(metas)
    log("time kernel hevc_residuals detail", ctas=len(plan_all[1]),
        ops_direct=ops_direct,
        bound_direct_ms=f"{ops_direct / INT32_OPS_PER_S * 1e3:.4f}",
        launch_a_tile_ms=f"{t['launches_48_ms']:.4f}",
        launch_a_tile_ms_cold=f"{t['launches_48_ms_cold']:.4f}",
        a_tile=f"tile {a_tile['tile']} ({a_tile['tus']} TUs) alone",
        a_tile_ms=f"{a_tile['ms']:.4f}",
        a_tile_ms_cold=f"{a_tile['ms_cold']:.4f}",
        a_tile_bytes=a_tile["bytes"], a_tile_ops=a_tile["ops"],
        a_tile_bound_ms=f"{a_tile['bound_ms']:.4f}")
    # K15 as a load under FFPIC_HEIF_DEVICE_COLOR runs it: one launch over
    # the fixture's 48 staged tiles, which writes every canvas pixel (no
    # fill before it). Bytes: 2 of luma and 1 of chroma read a pixel, 4
    # written, and the index (descriptors and cells); about 13 f32 ops a
    # pixel (K3's count)
    index_bytes = 4 * (staged.desc.numel() + gh + gw
                       + staged.cell_map.numel())
    timed["hevc_yuv_to_rgba"] = time_entry(
        "hevc_yuv_to_rgba",
        lambda: hk.hevc_tiles_to_rgba(staged, "bt601"),
        lambda: hk.hevc_tiles_to_rgba_plain(staged, "bt601"),
        7 * gh * gw + index_bytes, 13 * gh * gw, "f32", floor_ms, flush,
        f"heif load FFPIC_HEIF_DEVICE_COLOR, the {len(tiles)} tiles and "
        "the canvas in one launch")
    del flush, staged, staged_tus, lv_all, plan_all, meta_all

    mp = gh * gw / 1e6
    # the kernels' device time a load (the staging copies aside)
    kernel_ms = {"neither": 0.0,
                 "hevc_device": timed["hevc_residuals"]["ms"],
                 "device_color": timed["hevc_yuv_to_rgba"]["ms"]}
    for sw, metric in (("neither", "heic_12mp_mps"),
                       ("hevc_device", "heic_device_mps"),
                       ("device_color", "heic_device_color_mps")):
        with environ(**{**clear, **HEIF_SWITCHES[sw]}):
            ffpic_tpu_torch.load(data)
            wall, runs, stages = spans(lambda: ffpic_tpu_torch.load(data), 5)
        # each tile's share of the plan and its pinned levels, made in
        # the syntax phase's workers: the sum over a load's tiles (CPU
        # time of 8 threads, not wall), beside the one staging, launch
        # and read-back of hevc.residuals_device
        part = trace.report().get("hevc.residuals_part")
        part_ms = part["total"] / len(runs) * 1e3 if part else 0.0
        res_ms = stages.get("hevc.residuals_device", 0.0)
        log("time heif load", file="heic_12mp_grid.heic", route=sw,
            metric=metric, value=f"{mp / wall:.3f}",
            ms_per_load=f"{wall * 1e3:.3f}",
            residuals_device_ms=res_ms,
            residuals_part_ms_sum=f"{part_ms:.3f}",
            residuals_device_and_part_ms=f"{res_ms + part_ms:.3f}",
            kernel_ms=f"{kernel_ms[sw]:.4f}",
            kernel_busy_share=f"{kernel_ms[sw] / (wall * 1e3):.4f}",
            runs_ms=json.dumps([round(r * 1e3, 3) for r in runs])
            .replace(" ", ""), grid_workers=heif._grid_workers(len(tiles)),
            stage_ms=json.dumps(stages).replace(" ", ""))
    return timed, {"load_hevc_device": loads[("heic_12mp_grid",
                                              "hevc_device")],
                   "load_device_color": loads[("heic_12mp_grid",
                                               "device_color")],
                   "load_both": loads[("heic_12mp_grid", "both")],
                   "decode_batch_both": mixed["both"]}


CONFIG5_SIZE = (224, 224)
# jax.image.resize's methods (one name each), which K16 takes
RESIZE_METHODS = ("nearest", "bilinear", "bicubic", "lanczos3", "lanczos5")
VIT_REL_TOL = 1e-2      # card logits against the CPU forward, of max |logit|


def dense_resize(img, size):
    """The resize the port ran before K16 (two float64 einsums over
    ``_weight_mat``'s dense matrices, rounded to f32 after each axis),
    kept here only as the yardstick the banded kernel replaced."""
    import torch
    from ffpic_tpu_torch.ops.resize import _weight_mat
    h, w = size
    x = img.to(torch.float64)
    if x.shape[-3] != h:
        wh = _weight_mat(x.shape[-3], h, x.device).to(torch.float64)
        x = torch.einsum("...hwc,hH->...Hwc", x, wh).to(torch.float32) \
            .to(torch.float64)
    if x.shape[-2] != w:
        ww = _weight_mat(x.shape[-2], w, x.device).to(torch.float64)
        x = torch.einsum("...hwc,wW->...hWc", x, ww).to(torch.float32)
    return torch.round(x).clamp(0, 255).to(torch.uint8)


def exact_f32(name: str, got, want, errs: dict) -> None:
    """A float kernel's output against its plain version: bit-equal."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype} != "
                             f"{tuple(want.shape)} {want.dtype}")
    err = float((got.double() - want.double()).abs().max()) \
        if got.numel() else 0.0
    errs[name] = max(errs.get(name, 0), err)
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel differs from its plain version "
                             f"by up to {err}")


def taps_read(n_in: int, n_out: int, method: str = "bilinear") -> int:
    """The input indices of one axis that some tap of ``method`` reads
    (all of them but for ``nearest``, which reads one an output)."""
    import numpy as np
    import torch
    from ffpic_tpu_torch.ops.resize import taps
    if n_in == n_out:
        return n_in
    start, count, _ = taps(n_in, n_out, torch.device("cpu"), method)
    hit = np.zeros(n_in, bool)
    for s, c in zip(start.tolist(), count.tolist()):
        hit[s:s + c] = True
    return int(hit.sum())


def resize_bytes(n: int, size_in, size_out, ch: int,
                 method: str = "bilinear") -> int:
    """Bytes the resize by ``method`` must move: each input pixel that
    taps of both axes read, once, and the output, once."""
    (hi, wi), (h, w) = size_in, size_out
    return n * ch * (taps_read(hi, h, method) * taps_read(wi, w, method)
                     + h * w)


def tap_ops(n: int, size_in, size_out, ch: int,
            method: str = "bilinear") -> int:
    """f64 operations of the banded resize by ``method``, a multiply and
    an add a tap: the H pass over every input column a W tap reads, then
    the W pass."""
    import torch
    from ffpic_tpu_torch.ops.resize import taps
    (hi, wi), (h, w) = size_in, size_out
    cpu = torch.device("cpu")
    ops = 0
    if hi != h:
        ops += (2 * n * taps_read(wi, w, method) * ch
                * int(taps(hi, h, cpu, method)[1].sum()))
    if wi != w:
        ops += 2 * n * h * ch * int(taps(wi, w, cpu, method)[1].sum())
    return ops


_VIT: dict = {}


def vit_pair(dev):
    """(config, card model, CPU model): ViT-B/16 at its published widths,
    weights from ``torch.Generator`` seed 0 (not pretrained), built once
    a run for the paths that end in it."""
    if not _VIT:
        import torch
        from ffpic_tpu_torch.models import vit
        cfg = vit.VIT_B16
        state = vit.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        _VIT.update(cfg=cfg, card=vit.ViT(cfg, state, device=dev),
                    cpu=vit.ViT(cfg, state, device="cpu"))
    return _VIT["cfg"], _VIT["card"], _VIT["cpu"]


def logits_against_cpu(name: str, got, want, n_classes: int):
    """The card's logits of a batch of N against the CPU forward's, within
    ``VIT_REL_TOL`` of the largest |logit|: (max abs error, max |logit|,
    share of equal argmaxes)."""
    if tuple(got.shape) != (N, n_classes) or not bool(got.isfinite().all()):
        raise AssertionError(f"{name}: logits {tuple(got.shape)}, finite: "
                             + str(bool(got.isfinite().all())))
    err = float((got.cpu().double() - want.double()).abs().max())
    scale = float(want.abs().max())
    agree = float((got.cpu().argmax(1) == want.argmax(1)).double().mean())
    if err > VIT_REL_TOL * scale:
        raise AssertionError(f"{name}: card logits differ from the CPU "
                             f"forward by {err} (max |logit| {scale})")
    return err, scale, agree


def resize_methods(dev, slots, full, floor_ms: float, flush, errs: dict,
                   reset, counts) -> dict:
    """K16 by each of ``RESIZE_METHODS`` on ``testing.resize_cases`` and
    once over config 5's 8 slots (1920x1080 RGBA to 224 x 224), with
    fresh counts: one launch each (nearest's gather, the band kernel by
    cubic and Lanczos, the banded kernel by bilinear; the instance its
    launcher took and its rows a CTA, ``cuda_resize.instance``),
    bit-equal to its plain version (nearest
    too: the float64 tap sum, not the gather's model).  Then each timed
    (``time_entry``: warm and L2-flushed, the plain version, the bound
    from this run's taps, ``resize_bytes`` and ``tap_ops``, the same
    work whatever kernel runs it: ``nearest`` needs only the pixels it
    keeps; its operations at the rate of the unit that runs them, the
    f64 tensor cores for ``resize_band``, with the FP64 pipe's share
    beside it as ``share_f64_pipe``, else the FP64 pipe) beside one
    PyTorch call where there is one: for ``nearest`` the same function,
    ``full[:, rv[:, None], rh[None, :]]`` by the ``start`` tables (one
    advanced-indexing call, max |delta| 0), with ``F.interpolate``
    ``nearest-exact`` beside it (its index rule is not XLA's folded
    one); ``bicubic`` with ``antialias=True`` (its own
    weights and order of sums), each with its max |delta| from the
    plain version.  Returns {method: timing entry with its launches}."""
    import torch
    import torch.nn.functional as F
    from ffpic_tpu_torch.ops import resize as rs
    from ffpic_tpu_torch.utils.timing import (F64_OPS_PER_S, bound, gpu_ms,
                                              gpu_ms_cold)
    size = CONFIG5_SIZE
    nchw = full.permute(0, 3, 1, 2).contiguous()
    rv, rh = (rs.taps(n, k, dev, "nearest")[0].long()
              for n, k in ((H, size[0]), (W, size[1])))

    def interp(mode, **kw):
        return lambda: F.interpolate(nchw.float() if kw else nchw, size=size,
                                     mode=mode, **kw)

    def nhwc(fn):
        return lambda: fn().float().round().clamp(0, 255).to(
            torch.uint8).permute(0, 2, 3, 1)
    def index():
        return full[:, rv[:, None], rh[None, :]]
    library = {
        "nearest": (index, index),
        "bilinear": (interp("bilinear", antialias=True, align_corners=False),
                     None),
        "bicubic": (interp("bicubic", antialias=True, align_corners=False),
                    None)}
    from ffpic_tpu_torch import testing
    from ffpic_tpu_torch.ops import cuda_resize
    # the edges of K16's tiling by every method
    for method in RESIZE_METHODS:
        for img, sz in testing.resize_cases().values():
            x = torch.from_numpy(img).to(dev)
            exact("resize_rgba", cuda_resize.resize_rgba(x, sz, method),
                  rs.resize_rgba_plain(x, sz, method), errs)
    out = {}
    for method in RESIZE_METHODS:
        reset()
        got = rs.resize_batch(slots, size, method)
        launched = counts()
        kernel = cuda_resize.instance["resize_rgba"]
        if launched != {"resize_rgba": 1}:
            raise AssertionError(f"K16 {method}: launches {launched}")
        plain = rs.resize_batch_plain(slots, size, method)
        exact("resize_rgba", got, plain, errs)
        lib, lib_out = library.get(method, (None, None))
        # resize_band's products run on the f64 tensor cores, the banded
        # and gather kernels' on the FP64 pipe
        ops_type = "f64_tc" if kernel == "resize_band" else "f64"
        nbytes = resize_bytes(N, (H, W), size, 4, method)
        ops = tap_ops(N, (H, W), size, 4, method)
        e = time_entry(
            "resize_rgba", lambda m=method: rs.resize_batch(slots, size, m),
            lambda m=method: rs.resize_batch_plain(slots, size, m),
            nbytes, ops, ops_type, floor_ms, flush,
            f"config 5: {N} x {W}x{H} RGBA to 224 x 224, {method}",
            library=lib)
        if ops_type == "f64_tc":
            # the same work's share of the FP64 pipe's bound, for the
            # comparison with the kernels that run there
            e["share_f64_pipe"] = (bound(nbytes, ops, F64_OPS_PER_S)[0]
                                   / e["ms"])
        e["launches"] = launched["resize_rgba"]
        e["kernel"] = kernel
        e["rows_a_cta"] = cuda_resize.instance["rows"]
        e["taps_a_row_element"] = int(rs.taps(H, size[0], torch.device("cpu"),
                                              method)[2].shape[1])
        if lib is not None:
            e["library_max_abs_vs_plain"] = max_abs_err(
                (lib_out or nhwc(lib))(), plain)
        if method == "nearest":
            near = interp("nearest-exact")
            e.update(interpolate_ms=gpu_ms(near, 50),
                     interpolate_ms_cold=gpu_ms_cold(near, 20, flush),
                     interpolate_max_abs_vs_plain=max_abs_err(
                         nhwc(near)(), plain))
            log("time resize_rgba nearest interpolate", **{
                k: (f"{v:.4f}" if isinstance(v, float) else v)
                for k, v in e.items() if k.startswith("interpolate")})
        out[method] = e
    log("check K16 methods", methods=",".join(RESIZE_METHODS),
        at=f"{N}x{W}x{H}->224 and testing.resize_cases", launches="1 each",
        kernels=",".join(out[m]["kernel"] for m in RESIZE_METHODS),
        plain="exact")
    return out


def config5_paths(dev, jpeg_batch, srcs, floor_ms: float, errs: dict):
    """BASELINE config 5 on the card: a mixed batch of images into a
    ViT.  K16 and K17 against their plain versions (``testing.
    resize_cases`` and ``normalize_cases``, and the path's shapes), then
    the path with fresh launch counts: ``decode_batch`` of the 8 x 1080p
    mixed batch at ``size=(224, 224)`` (K16 once), ``normalize_for_
    model`` (K17), ViT-B/16's forward with seeded weights; the card's
    batch, input and logits against the CPU's.  Also the 8 x 1080p JPEG
    batch through ``normalize_for_model(size=(224, 224))`` (K17 with its
    resize) into the ViT.  The timings: each kernel warm and L2 flushed
    beside its bound, the launch floor, the float64 matmul it replaced
    and ``F.interpolate(antialias=True)``; the ViT's forward at batch 8
    and 64; each chain end to end with its spans.  Returns {kernel:
    timing entry} and the path's launches."""
    import torch
    import torch.nn.functional as F
    import ffpic_tpu_torch
    from ffpic_tpu_torch import testing
    from ffpic_tpu_torch.models import vit
    from ffpic_tpu_torch.ops import cuda_jpeg, cuda_png, cuda_resize, cuda_vp8
    from ffpic_tpu_torch.ops import resize as rs
    from ffpic_tpu_torch.utils.timing import (BF16_OPS_PER_S, F32_OPS_PER_S,
                                              F64_OPS_PER_S, bound, gpu_ms,
                                              gpu_ms_cold)
    mods = (cuda_jpeg, cuda_png, cuda_vp8, cuda_resize)

    def reset():
        torch.cuda.synchronize()
        for m in mods:
            m.reset_launches()

    def counts():
        torch.cuda.synchronize()
        return {k: v for m in mods for k, v in m.launches.items() if v}

    size = CONFIG5_SIZE
    t0 = time.perf_counter()
    members = testing.config5_members(H, W)
    log("inputs config 5", members="jpeg,webp,jpeg,png,jpeg,webp,png,jpeg",
        size=f"{W}x{H}", bytes=[len(m) for m in members],
        seconds=f"{time.perf_counter() - t0:.3f}")

    # --- K16 and K17 against their plain versions on the card --------------
    for img, sz in testing.resize_cases().values():
        t = torch.from_numpy(img).to(dev)
        exact("resize_rgba", cuda_resize.resize_rgba(t, sz),
              rs.resize_rgba_plain(t, sz), errs)
    for b, sz, mean, std in testing.normalize_cases().values():
        t = torch.from_numpy(b).to(dev)
        exact_f32("normalize_resize", cuda_resize.normalize_resize(
            t, sz, mean, std), rs.normalize_plain(t, sz, mean, std), errs)
    full = ffpic_tpu_torch.decode_batch(members, device=dev)
    if tuple(full.shape) != (N, H, W, 4):
        raise AssertionError(f"config 5 unsized: {tuple(full.shape)}")
    crop = full[:, 3:H - 5, 7:W - 1]            # strided rows, as slots are
    # the same pixels one byte off a 4-byte boundary: byte loads, not one
    # 32-bit load a pixel
    unaligned = torch.empty(full.numel() + 1, dtype=torch.uint8,
                            device=dev)[1:].view(full.shape)
    unaligned.copy_(full)
    for t in (full, crop, full[2], unaligned):
        exact("resize_rgba", cuda_resize.resize_rgba(t, size),
              rs.resize_rgba_plain(t, size), errs)
    # the path's one launch over the slots: config 5's, and slots of mixed
    # sources (1080p, 720x1280, a cropped slot, one off a 4-byte boundary)
    g = torch.Generator(device=dev).manual_seed(5)
    hd = torch.randint(0, 256, (720, 1280, 4), dtype=torch.uint8,
                       device=dev, generator=g)
    mixed_slots = [full[0], hd, crop[1], unaligned[2], hd[7:701, 5:1203]]
    # 30 slots of distinct sizes (crops of one image): more tap tables
    # than ops.resize.taps caches, so the launch must hold its own
    big = torch.randint(0, 256, (1000, 1300, 4), dtype=torch.uint8,
                        device=dev, generator=g)
    sized_slots = [big[:300 + 23 * k, :400 + 29 * k] for k in range(30)]
    # a 48 MP photo (8064 wide) and a 12000-wide strip: too wide for two
    # output rows' lines a CTA, so their launches take one row a CTA
    wide = torch.randint(0, 256, (6048, 8064, 4), dtype=torch.uint8,
                         device=dev, generator=g)
    strip = big[:, :1200].repeat(1, 10, 1)
    # 1 and 3 channels, and a 5000-row band to 2 rows (a CTA's band the
    # whole image) at both
    gray = [torch.randint(0, 256, (1080, 1920, 1), dtype=torch.uint8,
                          device=dev, generator=g), big[:333, :517, :1]
            .contiguous()]
    rgb = [full[0, :, :, :3].contiguous(), big[3:202, 5:338, :3]]
    tall = [torch.randint(0, 256, (5000, 300, c), dtype=torch.uint8,
                          device=dev, generator=g) for c in (1, 3)]
    launches = {"mixed": (mixed_slots, size), "sized30": (sized_slots, size),
                "wide8064": ([full[0], wide], size),
                "strip12000": ([strip], size), "c1": (gray, size),
                "c3": (rgb, (97, 61)), "tall5000_c1": (tall[:1], (2, 40)),
                "tall5000_c3": (tall[1:], (2, 40))}
    # every method through each of K16's instances: bilinear's two rows a
    # CTA, cubic and Lanczos's band rows a CTA, and one row a CTA for the
    # 8064 and 12000 wide slots; the instance each launch took, as its
    # launcher reported it
    took = {}
    for method in RESIZE_METHODS:
        for name, (slots_, sz) in launches.items():
            exact("resize_rgba", rs.resize_batch(slots_, sz, method),
                  rs.resize_batch_plain(slots_, sz, method), errs)
            inst = cuda_resize.instance
            took[f"{method}:{name}"] = (f"{inst['resize_rgba']}x"
                                        f"{inst['rows']}")
            if rs.kernel_of(method) in cuda_resize.BAND_KERNELS:
                want = "resize<0,1>" if name in ("wide8064", "strip12000") \
                    else "resize_band"
                if inst["resize_rgba"] != want:
                    raise AssertionError(f"K16 {method} {name}: took "
                                         f"{inst['resize_rgba']}, not {want}")
    exact("resize_rgba", rs.resize_batch(list(full), size),
          rs.resize_batch_plain(list(full), size), errs)
    for img in (wide, strip):
        exact_f32("normalize_resize", cuda_resize.normalize_resize(
            img, size), rs.normalize_plain(img, size), errs)
    sized_plain = rs.resize_rgba_plain(full, size)
    for img, sz in ((full, None), (sized_plain, None), (jpeg_batch, size),
                    (crop, size), (unaligned, size)):
        exact_f32("normalize_resize", cuda_resize.normalize_resize(img, sz),
                  rs.normalize_plain(img, sz), errs)
    x_jpeg_plain = rs.normalize_plain(jpeg_batch, size, testing.MEAN_IMAGENET,
                                      testing.STD_IMAGENET)
    exact_f32("normalize_resize", cuda_resize.normalize_resize(
        jpeg_batch, size, testing.MEAN_IMAGENET, testing.STD_IMAGENET),
        x_jpeg_plain, errs)
    if not torch.equal(x_jpeg_plain.cpu(), rs.normalize_plain(
            jpeg_batch.cpu(), size, testing.MEAN_IMAGENET,
            testing.STD_IMAGENET)):
        raise AssertionError("normalize_plain differs between the card and "
                             "the CPU")
    log("check K16 K17", resize_rgba="exact", normalize_resize="exact",
        cases=",".join([*testing.resize_cases(), *testing.normalize_cases()]),
        path_shapes=f"{N}x{W}x{H}->224 batch,crop,slot,unaligned; "
        f"one launch over the {N} slots, over 1080p,720x1280,crop,"
        "unaligned,crop of 720x1280, over 30 slots of distinct sizes, "
        "over 1080p,8064x6048 and over 12000x1000 (K17 too), 1 and 3 "
        "channels, a 5000-row band to 2 rows at 1 and 3 channels, these "
        f"by {','.join(RESIZE_METHODS)}; "
        f"{N}x224 norm; "
        f"{N}x{W}x{H} jpeg norm+resize", plain_cpu_vs_card="exact",
        instances=",".join(f"{k}={v}" for k, v in took.items()))

    # --- the path: decode_batch(size=) -> normalize_for_model -> ViT-B/16 ---
    cfg, model, model_cpu = vit_pair(dev)
    reset()
    batch = ffpic_tpu_torch.decode_batch(members, size=size, device=dev)
    x = rs.normalize_for_model(batch)
    logits = model(x)
    path_launches = counts()
    if (path_launches.get("resize_rgba"), path_launches.get(
            "normalize_resize")) != (1, 1):
        raise AssertionError(f"config 5 path: launches {path_launches}")
    if min(path_launches.get(k, 0) for k in (*PATH_420,
                                             "assemble_rgba")) < 1:
        raise AssertionError(f"config 5 path: a decode kernel never ran: "
                             f"{path_launches}")
    batch_cpu = ffpic_tpu_torch.decode_batch(members, size=size,
                                             device="cpu")
    if tuple(batch.shape) != (N, *size, 4) or not torch.equal(batch.cpu(),
                                                              batch_cpu):
        raise AssertionError("config 5 batch: the card differs from the CPU "
                             "route")
    x_cpu = rs.normalize_for_model(batch_cpu)
    if x.dtype != torch.float32 or not torch.equal(x.cpu(), x_cpu):
        raise AssertionError("config 5 input: the card differs from the CPU")
    t0 = time.perf_counter()
    logits_cpu = model_cpu(x_cpu)
    cpu_forward_s = time.perf_counter() - t0

    err, scale, agree = logits_against_cpu("config 5", logits, logits_cpu,
                                           cfg.n_classes)
    log("config 5", members=N, size=size, shape=tuple(logits.shape),
        launches=json.dumps(path_launches).replace(" ", ""),
        batch_cpu_route="exact", input_cpu="exact",
        logits_max_abs_vs_cpu=f"{err:.6g}", logits_max_abs=f"{scale:.6g}",
        tolerance=f"{VIT_REL_TOL:g}*max|logit|", argmax_equal_share=agree,
        cpu_forward_seconds=f"{cpu_forward_s:.3f}")
    # the JPEG batch resized by normalize_for_model itself
    reset()
    x2 = rs.normalize_for_model(jpeg_batch, size)
    logits2 = model(x2)
    jpeg_launches = counts()
    if jpeg_launches != {"normalize_resize": 1}:
        raise AssertionError(f"normalize(size=) path: launches "
                             f"{jpeg_launches}")
    x2_plain = rs.normalize_plain(jpeg_batch.cpu(), size)
    if not torch.equal(x2.cpu(), x2_plain):
        raise AssertionError("normalize(size=): the card differs from the CPU")
    err2, scale2, agree2 = logits_against_cpu(
        "normalize(size=)", logits2, model_cpu(x2_plain), cfg.n_classes)
    log("config 5 jpeg normalize(size=)", batch=f"{N}x{W}x{H} jpeg",
        launches=jpeg_launches, input_cpu="exact",
        logits_max_abs_vs_cpu=f"{err2:.6g}", logits_max_abs=f"{scale2:.6g}",
        argmax_equal_share=agree2)

    # --- timing -------------------------------------------------------------
    flush = torch.empty(100 * 2 ** 20, dtype=torch.uint8, device=dev)
    at = f"config 5: {N} x {W}x{H} RGBA to 224 x 224"
    nchw = full.permute(0, 3, 1, 2).contiguous()

    def interp(t=nchw):
        return F.interpolate(t.float(), size=size, mode="bilinear",
                             antialias=True, align_corners=False)

    # K16 as the path launches it: once over the 8 slots, each a 1080p
    # image of its own; beside it one slot alone and the slots off a 4-byte
    # boundary (byte loads)
    slots = [s_.clone() for s_ in full]
    k16 = time_entry(
        "resize_rgba", lambda: rs.resize_batch(slots, size),
        lambda: rs.resize_batch_plain(slots, size),
        full.numel() + N * size[0] * size[1] * 4,
        tap_ops(N, (H, W), size, 4), "f64", floor_ms, flush,
        f"{at}, one launch over the slots", library=interp)
    k16.update(
        one_slot_ms=gpu_ms(lambda: cuda_resize.resize_rgba(slots[0], size),
                           50),
        one_slot_ms_cold=gpu_ms_cold(
            lambda: cuda_resize.resize_rgba(slots[0], size), 20, flush),
        byte_loads_ms=gpu_ms(
            lambda: cuda_resize.resize_rgba(unaligned, size), 50),
        library_max_abs_vs_plain=max_abs_err(
            interp().round().clamp(0, 255).to(torch.uint8)
            .permute(0, 2, 3, 1), sized_plain),
        dense_f64_ms=gpu_ms(lambda: dense_resize(full, size), 5),
        dense_f64_ms_cold=gpu_ms_cold(lambda: dense_resize(full, size), 3,
                                      flush),
        launches_per_path=path_launches["resize_rgba"])
    if not torch.equal(dense_resize(full, size), sized_plain):
        k16["dense_f64_max_abs_vs_plain"] = max_abs_err(
            dense_resize(full, size), sized_plain)
    log("time resize_rgba extra", at=at,
        **{k: (f"{v:.4f}" if isinstance(v, float) else v)
           for k, v in k16.items() if k.startswith(
               ("one_slot", "byte_loads", "library_max", "dense_f64"))})
    k16["methods"] = resize_methods(dev, slots, full, floor_ms, flush, errs,
                                    reset, counts)
    nb = batch.numel()
    k17 = time_entry(
        "normalize_resize", lambda: cuda_resize.normalize_resize(batch),
        lambda: rs.normalize_plain(batch), nb + nb // 4 * 3 * 4,
        3 * nb // 4 * 3, "f32", floor_ms, flush,
        f"config 5: {N} x 224 x 224, size=None")
    k17["launches_per_path"] = path_launches["normalize_resize"]
    sized_in = jpeg_batch.numel()
    k17["with_resize"] = w = {
        "at": f"{N} x {W}x{H} jpeg to 224 x 224",
        "ms": gpu_ms(lambda: cuda_resize.normalize_resize(jpeg_batch, size),
                     50),
        "ms_cold": gpu_ms_cold(lambda: cuda_resize.normalize_resize(
            jpeg_batch, size), 20, flush),
        "plain_ms": gpu_ms(lambda: rs.normalize_plain(jpeg_batch, size), 3),
        "bytes": sized_in + N * size[0] * size[1] * 12,
        "ops": tap_ops(N, (H, W), size, 3), "ops_type": "f64"}
    w["bound_ms"], w["bound_by"] = bound(w["bytes"], w["ops"], F64_OPS_PER_S)
    log("time normalize_resize with resize", **{
        k: (f"{v:.4f}" if isinstance(v, float) else v) for k, v in w.items()})
    del flush

    # the ViT's forward, CUDA events, at batch 8 and 64
    vit_ms = {}
    for n in (N, 64):
        xin = x if n == N else x.repeat(n // N, 1, 1, 1)
        ms = gpu_ms(lambda: model(xin), 10 if n == N else 3)
        flops = vit.forward_flops(cfg, n)
        vit_ms[n] = ms
        log("time vit", config="ViT-B/16", batch=n, ms=f"{ms:.4f}",
            flops=flops, tflops=f"{flops / ms / 1e9:.2f}",
            bf16_peak_share=f"{flops / (ms / 1e3) / BF16_OPS_PER_S:.4f}",
            f32_peak_share=f"{flops / (ms / 1e3) / F32_OPS_PER_S:.4f}",
            weights="seeded (torch.Generator seed 0), not pretrained")
        del xin

    # end to end, host clock, bytes to synchronised logits, with spans
    from ffpic_tpu_torch.utils import trace

    def chain(decode, norm):
        def run():
            t0 = time.perf_counter()
            b = decode()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            xx = norm(b)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            model(xx)
            torch.cuda.synchronize()
            return t1 - t0, t2 - t1, time.perf_counter() - t2
        return run

    for name, run in (
            ("mixed", chain(lambda: ffpic_tpu_torch.decode_batch(
                members, size=size, device=dev), rs.normalize_for_model)),
            ("jpeg", chain(lambda: ffpic_tpu_torch.decode_batch(
                srcs, device=dev), lambda b: rs.normalize_for_model(
                    b, size)))):
        run()
        trace.reset()
        trace.enable()
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            parts = run()
            runs.append((time.perf_counter() - t0, *parts))
        trace.enable(False)
        stages = {k: round(v["mean"] * 1e3, 3)
                  for k, v in trace.report().items()}
        runs.sort()
        wall = runs[len(runs) // 2]
        mp = N * H * W / 1e6
        log("time config 5", chain=name, megapixels=mp,
            end_to_end_ms=f"{wall[0] * 1e3:.3f}",
            end_to_end_ms_runs=json.dumps([round(r[0] * 1e3, 3)
                                           for r in runs]).replace(" ", ""),
            images_per_s=f"{N / wall[0]:.2f}", mps=f"{mp / wall[0]:.2f}",
            span_decode_ms=f"{wall[1] * 1e3:.3f}",
            span_normalize_ms=f"{wall[2] * 1e3:.3f}",
            span_vit_ms=f"{wall[3] * 1e3:.3f}",
            vit_event_ms=f"{vit_ms[N]:.4f}",
            stage_ms=json.dumps(stages).replace(" ", ""))
    return {"resize_rgba": k16, "normalize_resize": k17}, path_launches, x



HOST_BATCH = ("bmp_24", "bmp_rle8", "gif", "tga_rle_32", "pnm_p6", "psd_rle",
              "tiff_lzw_predictor", "tiff_deflate")


def host_codec_files(h: int, w: int) -> dict:
    """The host codecs' files of ``testing.synth_rgb(h, w, 0)`` (alpha
    its green channel where a format keeps alpha), written by the port's
    encoders (GIF, PNM) and ``testing``'s writers: BMP 24 bpp bottom-up
    and 8 bpp RLE of the 3-3-2 palette, GIF, TGA RLE 32 bpp, PNM P6, PSD
    RLE, and TIFF as LZW with predictor 2, PackBits, deflate and JPEG
    strips (64 rows a strip); and an ICO at 256 x 256 whose first entry
    is a PNG of Sub and Up rows and second a 32 bpp BMP."""
    import numpy as np
    import ffpic_tpu_torch
    from ffpic_tpu_torch import testing
    from ffpic_tpu_torch.formats.pic import Pic
    rgb = testing.synth_rgb(h, w, 0)
    rgba = np.dstack([rgb, rgb[..., 1]])
    opaque = Pic(pixels=np.dstack([rgb, np.full((h, w), 255, np.uint8)]),
                 width=w, height=h)
    idx, pal = testing.quantize_332(rgb)
    writers = {
        "bmp_24": lambda: testing.encode_bmp(rgb),
        "bmp_rle8": lambda: testing.encode_bmp_palette(idx, pal, rle=True),
        "gif": lambda: ffpic_tpu_torch.encode(opaque, "GIF", device="cpu"),
        "tga_rle_32": lambda: testing.encode_tga(rgba),
        "pnm_p6": lambda: ffpic_tpu_torch.encode(opaque, "PNM",
                                                 device="cpu"),
        "psd_rle": lambda: testing.encode_psd(rgba),
        "tiff_lzw_predictor": lambda: testing.encode_tiff(
            rgb, "lzw", predictor=2, rows_per_strip=64),
        "tiff_packbits": lambda: testing.encode_tiff(rgb, "packbits",
                                                     rows_per_strip=64),
        "tiff_deflate": lambda: testing.encode_tiff(rgb, "deflate",
                                                    rows_per_strip=64),
        "tiff_jpeg": lambda: testing.encode_tiff(rgb, "jpeg",
                                                 rows_per_strip=64),
        "ico_png_bmp": lambda: testing.encode_ico([
            testing.encode_png(rgba[:256, :256], 6, 8, filters=(1, 2)),
            rgba[256:512, :256]]),
    }
    files, seconds = {}, {}
    for name, write in writers.items():
        t0 = time.perf_counter()
        files[name] = write()
        seconds[name] = round(time.perf_counter() - t0, 3)
    return files, seconds


def host_codec_paths(dev, card: str, errs: dict) -> dict:
    """The host-only codecs (BMP, GIF, TGA, PNM, PSD, TIFF, ICO) on the
    card, at 1920x1080 (``host_codec_files``).  Each file's ``load`` on
    the card equals its ``load`` on the CPU byte for byte, every frame;
    the TIFF's JPEG strips run K2 and K4 and the ICO's PNG entry K6 and
    K7 there (each load with fresh counts), so those kernels are held
    exact against their plain versions on the path's shapes.  Then the
    path, with fresh counts: ``decode_batch`` of the 8 1080p members of
    ``HOST_BATCH`` at size=(224, 224) (K16 once), equal to the CPU
    route's, ``normalize_for_model`` (K17 once) and ViT-B/16
    (``vit_pair``) within config 5's tolerance of the CPU forward.
    Timings on the host clock: each file's ``load`` (median of 5, MP/s)
    and the batch's wall time with its spans, each beside ``card``, the
    card's name and power limit.  Returns the launches {path: {kernel:
    n}}."""
    import torch
    import ffpic_tpu_torch
    from ffpic_tpu_torch.ops import cuda_jpeg, cuda_png, cuda_resize
    from ffpic_tpu_torch.ops import resize as rs
    from ffpic_tpu_torch.utils import trace
    mods = (cuda_jpeg, cuda_png, cuda_resize)

    def reset():
        torch.cuda.synchronize()
        for m in mods:
            m.reset_launches()

    def counts():
        torch.cuda.synchronize()
        return {k: v for m in mods for k, v in m.launches.items() if v}

    files, seconds = host_codec_files(H, W)
    log("inputs host codecs", size=f"{W}x{H}", ico="256x256 png+bmp",
        bytes=json.dumps({k: len(v) for k, v in files.items()})
        .replace(" ", ""), write_seconds=json.dumps(seconds)
        .replace(" ", ""))

    launches = {}
    for name, data in files.items():
        reset()
        got = ffpic_tpu_torch.load_all(data, device=dev)
        launches[name] = counts()
        want = ffpic_tpu_torch.load_all(data, device="cpu")
        if len(got) != len(want) or not got:
            raise AssertionError(f"{name}: {len(got)} pictures on the card, "
                                 f"{len(want)} on the CPU")
        # the kernels whose plain versions the CPU route ran
        kernels = {"tiff_jpeg": ("dequant_idct", "assemble_mcu"),
                   "ico_png_bmp": ("unfilter_subup", "assemble_rgba")}.get(
                       name, ())
        for g, w_ in zip(got, want):
            if g.pixels.device.type != dev.type:
                raise AssertionError(f"{name}: pixels on {g.pixels.device}")
            for kernel in kernels:
                exact(kernel, g.pixels.cpu(), w_.pixels, errs)
            if not torch.equal(g.pixels.cpu(), w_.pixels):
                raise AssertionError(f"{name}: the card's load differs from "
                                     "the CPU's")
    if min(launches["tiff_jpeg"].get(k, 0)
           for k in ("dequant_idct", "assemble_mcu")) < 1:
        raise AssertionError(f"TIFF JPEG strips: {launches['tiff_jpeg']}")
    if min(launches["ico_png_bmp"].get(k, 0)
           for k in ("unfilter_subup", "assemble_rgba")) < 1:
        raise AssertionError(f"ICO PNG entry: {launches['ico_png_bmp']}")
    log("host codecs load", files=len(files), cpu_route="exact",
        launches=json.dumps({k: v for k, v in launches.items() if v})
        .replace(" ", ""))
    # the members whose decode launches kernels in decode_batch's pool,
    # on the caller's stream: the ICO's PNG entry and a TIFF's JPEG strips
    from ffpic_tpu_torch import testing
    pooled = [files["ico_png_bmp"], testing.encode_tiff(
        testing.synth_rgb(256, 256, 0), "jpeg", rows_per_strip=64)]
    reset()
    got = ffpic_tpu_torch.decode_batch(pooled, device=dev)
    launches["pooled"] = counts()
    if min(launches["pooled"].get(k, 0) for k in (
            "unfilter_subup", "assemble_rgba", "dequant_idct",
            "assemble_mcu")) < 1:
        raise AssertionError(f"pooled members: {launches['pooled']}")
    exact("assemble_mcu", got.cpu(), ffpic_tpu_torch.decode_batch(
        pooled, device="cpu"), errs)
    log("host codecs pooled", members="ico_png_bmp,tiff_jpeg 256x256",
        launches=json.dumps(launches["pooled"]).replace(" ", ""),
        cpu_route="exact")

    # the path: decode_batch(size=) -> normalize_for_model -> ViT-B/16
    members = [files[k] for k in HOST_BATCH]
    size = CONFIG5_SIZE
    cfg, model, model_cpu = vit_pair(dev)
    reset()
    batch = ffpic_tpu_torch.decode_batch(members, size=size, device=dev)
    x = rs.normalize_for_model(batch)
    logits = model(x)
    path = counts()
    if (path.get("resize_rgba"), path.get("normalize_resize")) != (1, 1):
        raise AssertionError(f"host codec batch: launches {path}")
    batch_cpu = ffpic_tpu_torch.decode_batch(members, size=size,
                                             device="cpu")
    if tuple(batch.shape) != (N, *size, 4):
        raise AssertionError(f"host codec batch: {tuple(batch.shape)}")
    exact("resize_rgba", batch.cpu(), batch_cpu, errs)
    x_cpu = rs.normalize_for_model(batch_cpu)
    exact_f32("normalize_resize", x.cpu(), x_cpu, errs)
    err, scale, agree = logits_against_cpu("host codec batch", logits,
                                           model_cpu(x_cpu), cfg.n_classes)
    launches["batch"] = path
    log("host codec batch", members=",".join(HOST_BATCH), size=size,
        launches=json.dumps(path).replace(" ", ""), batch_cpu_route="exact",
        input_cpu="exact", logits_max_abs_vs_cpu=f"{err:.6g}",
        logits_max_abs=f"{scale:.6g}",
        tolerance=f"{VIT_REL_TOL:g}*max|logit|", argmax_equal_share=agree)

    # timings, host clock: each load to a synchronised tensor, median of 5
    for name, data in files.items():
        runs = []
        for _ in range(6):
            t0 = time.perf_counter()
            pics = ffpic_tpu_torch.load_all(data, device=dev)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        runs = sorted(runs[1:])
        mp = sum(p.width * p.height for p in pics) / 1e6
        log("time host codec load", card=card, codec=name, megapixels=mp,
            load_ms=f"{runs[2] * 1e3:.3f}", mps=f"{mp / runs[2]:.2f}",
            runs_ms=json.dumps([round(r * 1e3, 3) for r in runs])
            .replace(" ", ""))
    trace.reset()
    trace.enable()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        ffpic_tpu_torch.decode_batch(members, size=size, device=dev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    trace.enable(False)
    stages = {k: round(v["mean"] * 1e3, 3) for k, v in trace.report().items()}
    walls.sort()
    mp = N * H * W / 1e6
    log("time host codec batch", card=card, megapixels=mp, size=size,
        end_to_end_ms=f"{walls[2] * 1e3:.3f}", mps=f"{mp / walls[2]:.2f}",
        images_per_s=f"{N / walls[2]:.2f}",
        runs_ms=json.dumps([round(r * 1e3, 3) for r in walls])
        .replace(" ", ""), stage_ms=json.dumps(stages).replace(" ", ""))
    return launches


STILL_BATCH = ("jp2_53", "jp2_97", "exr_piz", "exr_zip", "exr_b44",
               "exr_dwab", "svg_0", "svg_1")
SLOW_LOAD_S = 5.0     # a load this slow is timed once, not 3 times


def still_codec_files(h: int, w: int) -> tuple:
    """The still codecs' files at ``w`` x ``h``: the committed JPEG 2000
    (5/3 + RCT; 9/7 + ICT, 512 x 512 tiles, 3 layers) and OpenEXR
    (PIZ, DWAA, DWAB) fixtures of ``testing.still_fixture``; EXR none,
    ZIP, PXR24 and B44 written here by the port's ``encode`` from the
    fixtures' content (``make_still_fixtures.still_rgb`` with
    ``still_alpha``); two SVGs of ``testing.svg_still``; and a BPG
    header.  Returns ({name: bytes}, {name: seconds to make})."""
    import numpy as np
    import ffpic_tpu_torch
    from ffpic_tpu_torch import testing
    from ffpic_tpu_torch.formats.pic import Pic
    from ffpic_tpu_torch.make_still_fixtures import still_alpha, still_rgb
    rgba = np.dstack([still_rgb(h, w, 0), still_alpha(h, w)])
    pic = Pic(pixels=rgba, width=w, height=h)
    fixtures = {"jp2_53": "jp2_1080p_53.jp2", "jp2_97": "jp2_1080p_97.jp2",
                "exr_piz": "exr_1080p_piz.exr",
                "exr_dwaa": "exr_1080p_dwaa.exr",
                "exr_dwab": "exr_1080p_dwab.exr"}
    writers = {name: (lambda f=f: testing.still_fixture(f))
               for name, f in fixtures.items()}
    for comp in ("none", "zip", "pxr24", "b44"):
        writers[f"exr_{comp}"] = (lambda c=comp: ffpic_tpu_torch.encode(
            pic, "EXR", compression=c, device="cpu"))
    writers["svg_0"] = lambda: testing.svg_still(w, h, 0)
    writers["svg_1"] = lambda: testing.svg_still(w, h, 1)
    writers["bpg"] = lambda: testing.bpg_header(w, h)
    files, seconds = {}, {}
    for name, write in writers.items():
        t0 = time.perf_counter()
        files[name] = write()
        seconds[name] = round(time.perf_counter() - t0, 3)
    return files, seconds


def same_meta(name: str, got: dict, want: dict) -> None:
    """Two pictures' meta equal, arrays (``exr_planes``) bit for bit."""
    import numpy as np
    if got.keys() != want.keys():
        raise AssertionError(f"{name}: meta keys {sorted(got)} != "
                             f"{sorted(want)}")
    for k, v in got.items():
        if isinstance(v, dict) and k == "exr_planes":
            if v.keys() != want[k].keys() or any(
                    a.dtype != want[k][c].dtype
                    or a.tobytes() != want[k][c].tobytes()
                    for c, a in v.items()):
                raise AssertionError(f"{name}: exr_planes differ")
        elif isinstance(v, np.ndarray) or v != want[k]:
            raise AssertionError(f"{name}: meta[{k!r}] differs")


def still_codec_paths(dev, card: str, errs: dict) -> dict:
    """The still codecs (JPEG 2000, OpenEXR, SVG, BPG) on the card, at
    1920x1080 (``still_codec_files``).  They decode on the host, as in
    the reference, and no kernel runs in their ``load``: each file's
    ``load`` on the card equals its ``load`` on the CPU byte for byte
    (pixels, meta and EXR's ``exr_planes``), with no launch; a BPG gives
    the CPU's header and raises ``NotImplementedError`` for pixels.  Then
    the path, with fresh counts: ``decode_batch`` of the 8 members of
    ``STILL_BATCH`` at size=(224, 224) (K16 once), equal to the plain
    resize of the CPU loads' pixels (the CPU route), then
    ``normalize_for_model`` (K17 once) against its plain version and
    ViT-B/16 (``vit_pair``) within config 5's tolerance of the CPU
    forward.  ``start_profiler``/``stop_profiler`` trace K17 on the
    batch, and the trace must hold its kernel.  Timings on the host
    clock, beside ``card``: each load (median of 3; one run where a
    load takes over ``SLOW_LOAD_S``) in MP/s with its decoder spans,
    and the batch's wall time with its spans.  Returns the launches
    {path: {kernel: n}}."""
    import torch
    import ffpic_tpu_torch
    from ffpic_tpu_torch.ops import cuda_jpeg, cuda_png, cuda_resize
    from ffpic_tpu_torch.ops import resize as rs
    from ffpic_tpu_torch.utils import trace
    mods = (cuda_jpeg, cuda_png, cuda_resize)

    def reset():
        torch.cuda.synchronize()
        for m in mods:
            m.reset_launches()

    def counts():
        torch.cuda.synchronize()
        return {k: v for m in mods for k, v in m.launches.items() if v}

    t_phase = time.perf_counter()
    files, seconds = still_codec_files(H, W)
    log("inputs still codecs", size=f"{W}x{H}",
        bytes=json.dumps({k: len(v) for k, v in files.items()})
        .replace(" ", ""), write_seconds=json.dumps(seconds)
        .replace(" ", ""))

    bpg = files.pop("bpg")
    head = ffpic_tpu_torch.load(bpg, skip_decode=True)
    same_meta("bpg", head.meta, ffpic_tpu_torch.load(
        bpg, skip_decode=True, device="cpu").meta)
    try:
        ffpic_tpu_torch.load(bpg, device=dev)
    except NotImplementedError:
        pass
    else:
        raise AssertionError("bpg: a pixel decode did not raise")

    cpu, launches = {}, {}
    for name, data in files.items():
        runs = []
        trace.reset()
        trace.enable()
        while len(runs) < 3:
            reset()
            t0 = time.perf_counter()
            got = ffpic_tpu_torch.load_all(data, device=dev)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
            launches[name] = counts()
            if runs[0] > SLOW_LOAD_S:
                break
        trace.enable(False)
        spans = {k: round(v["total"] / len(runs) * 1e3, 3)
                 for k, v in trace.report().items()}
        if launches[name]:
            raise AssertionError(f"{name}: launches {launches[name]}")
        want = ffpic_tpu_torch.load_all(data, device="cpu")
        if len(got) != len(want) or not got:
            raise AssertionError(f"{name}: {len(got)} pictures on the card, "
                                 f"{len(want)} on the CPU")
        for g, w_ in zip(got, want):
            if g.pixels.device.type != dev.type:
                raise AssertionError(f"{name}: pixels on {g.pixels.device}")
            if not torch.equal(g.pixels.cpu(), w_.pixels):
                raise AssertionError(f"{name}: the card's load differs from "
                                     "the CPU's")
            same_meta(name, g.meta, w_.meta)
        cpu[name] = want[0].pixels
        mp = sum(p.width * p.height for p in got) / 1e6
        med = sorted(runs)[len(runs) // 2]
        log("time still codec load", card=card, codec=name, megapixels=mp,
            load_ms=f"{med * 1e3:.3f}", mps=f"{mp / med:.3f}",
            runs_ms=json.dumps([round(r * 1e3, 3) for r in runs])
            .replace(" ", ""), span_ms=json.dumps(spans).replace(" ", ""))
    log("still codecs load", files=len(files), cpu_route="exact",
        exr_planes="exact", launches="none", bpg_header="exact",
        bpg_pixels="NotImplementedError")

    # the path: decode_batch(size=) -> normalize_for_model -> ViT-B/16
    members = [files[k] for k in STILL_BATCH]
    size = CONFIG5_SIZE
    cfg, model, model_cpu = vit_pair(dev)
    reset()
    trace.reset()
    trace.enable()
    t0 = time.perf_counter()
    batch = ffpic_tpu_torch.decode_batch(members, size=size, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    trace.enable(False)
    stages = {k: round(v["total"] * 1e3, 3) for k, v in trace.report().items()}
    x = rs.normalize_for_model(batch)
    logits = model(x)
    path = counts()
    if (path.get("resize_rgba"), path.get("normalize_resize")) != (1, 1):
        raise AssertionError(f"still codec batch: launches {path}")
    if tuple(batch.shape) != (N, *size, 4):
        raise AssertionError(f"still codec batch: {tuple(batch.shape)}")
    batch_cpu = rs.resize_batch([cpu[k] for k in STILL_BATCH], size)
    exact("resize_rgba", batch.cpu(), batch_cpu, errs)
    x_cpu = rs.normalize_for_model(batch_cpu)
    exact_f32("normalize_resize", x.cpu(), x_cpu, errs)
    err, scale, agree = logits_against_cpu("still codec batch", logits,
                                           model_cpu(x_cpu), cfg.n_classes)
    launches["batch"] = path
    log("still codec batch", members=",".join(STILL_BATCH), size=size,
        launches=json.dumps(path).replace(" ", ""), batch_cpu_route="exact",
        input_cpu="exact", logits_max_abs_vs_cpu=f"{err:.6g}",
        logits_max_abs=f"{scale:.6g}",
        tolerance=f"{VIT_REL_TOL:g}*max|logit|", argmax_equal_share=agree)
    # the profiler hooks with CUDA activity: K17 on the batch, traced
    with tempfile.TemporaryDirectory() as logdir:
        ffpic_tpu_torch.start_profiler(logdir)
        rs.normalize_for_model(batch)
        torch.cuda.synchronize()
        with open(ffpic_tpu_torch.stop_profiler()) as f:
            events = json.load(f)["traceEvents"]
    traced = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
    if not any("resize" in k for k in traced):
        raise AssertionError(f"profiler: no K17 in the trace: {traced}")
    log("still codec profiler", events=len(events),
        kernels=json.dumps(traced).replace(" ", ""))
    mp = N * H * W / 1e6
    log("time still codec batch", card=card, megapixels=mp, size=size,
        end_to_end_ms=f"{wall * 1e3:.3f}", mps=f"{mp / wall:.3f}",
        images_per_s=f"{N / wall:.3f}", runs=1,
        stage_total_ms=json.dumps(stages).replace(" ", ""),
        phase_seconds=f"{time.perf_counter() - t_phase:.1f}")
    return launches


AVIF_FILES = {"avif_420": "avif_1080p_420.avif",
              "avif_444_alpha": "avif_1080p_444_alpha.avif",
              "avif_grid": "avif_1080p_grid.avif",
              "avif_sb128": "avif_1080p_sb128.avif"}
AVIF_BATCH = ("avif_420", "avif_444_alpha", "avif_grid", "avif_sb128") * 2


AVIS_1080P = "avis_1080p_grain.avif"
AVIF_ENCODE_SOURCE = "avif_1080p_420.avif"      # the encoder's 1080p picture
# the AVIF batch with the animation in place of its first still
AVIS_BATCH = ("avis_grain",) + AVIF_BATCH[1:]
AVIF_SPANS = ("av1.headers", "av1.parse", "av1.recon", "av1.mc",
              "av1.deblock", "av1.cdef", "av1.lr", "av1.superres",
              "av1.grain", "avif.color")


def avif_pic(pixels):
    """A ``Pic`` of (h, w, 4) RGBA pixels (a tensor on any device)."""
    from ffpic_tpu_torch.formats.pic import Pic
    h, w = pixels.shape[:2]
    return Pic(width=w, height=h, depth=32, pitch=w * 4, pixels=pixels)


def avif_encode_cases(pixels) -> tuple:
    """(name, pixels, quality) of the encoder checks on a 1920x1080
    picture (``AVIF_ENCODE_SOURCE``'s): the whole at quality 75 and its
    top-left 320x240 crop at 100 (lossless)."""
    return (("q75_1920x1080", pixels, 75),
            ("q100_320x240", pixels[:240, :320], 100))


def avif_frame(pic) -> tuple:
    """(device type, host pixels, meta, delay_ms) of a decoded picture."""
    return (pic.pixels.device.type, pic.np_pixels(), pic.meta, pic.delay_ms)


def avif_worker(task: str, device: str) -> dict:
    """One of ``avif_paths``' worker processes, which run beside its own
    card work, since each Python decode or encode holds its process's
    GIL: ``task`` "load_all" of ``AVIS_1080P``, or "encode" of
    ``avif_encode_cases`` on ``AVIF_ENCODE_SOURCE``'s pixels, each
    encoded picture loaded back; on ``device``, "cuda" for the card's
    side and "cpu" for the CPU's.  The launch counts are set to 0 just
    before the task and read just after (the work is the host's and
    launches nothing); one run on the host clock to a synchronised
    device, with the spans.  Two torch threads, so that the workers
    leave the host's other cores to each other."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    import ffpic_tpu_torch
    from ffpic_tpu_torch import testing
    from ffpic_tpu_torch.ops import cuda_jpeg, cuda_png, cuda_resize
    from ffpic_tpu_torch.utils import trace
    torch.set_num_threads(2)
    dev = torch.device(device)
    mods = (cuda_jpeg, cuda_png, cuda_resize)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    torch.zeros(1, device=dev)
    sync()
    for m in mods:
        m.reset_launches()
    trace.reset()
    trace.enable()
    t0 = time.perf_counter()
    out = {}
    if task == "load_all":
        pics = ffpic_tpu_torch.load_all(testing.avif_fixture(AVIS_1080P),
                                        device=dev)
        sync()
        out["frames"] = [avif_frame(p) for p in pics]
    else:
        src = ffpic_tpu_torch.load(testing.avif_fixture(AVIF_ENCODE_SOURCE),
                                   device=dev)
        out["encoded"] = {}
        for name, px, q in avif_encode_cases(src.pixels):
            t1 = time.perf_counter()
            blob = ffpic_tpu_torch.encode(avif_pic(px), "AVIF", quality=q,
                                          device=dev)
            enc_s = time.perf_counter() - t1
            back = ffpic_tpu_torch.load(blob, device=dev)
            sync()
            out["encoded"][name] = (blob, avif_frame(back), enc_s)
    out["seconds"] = time.perf_counter() - t0
    trace.enable(False)
    sync()
    out["launches"] = {k: v for m in mods for k, v in m.launches.items()
                       if v}
    out["spans"] = {k: round(v["total"] * 1e3, 3)
                    for k, v in trace.report().items()}
    return out


def avif_paths(dev, card: str, errs: dict) -> dict:
    """AVIF on the card (``AVIF_FILES``, the committed 1080p stills, and
    ``AVIS_1080P``, three 1920x1080 frames with film grain).  They decode
    on the host, as in the reference, and no kernel runs in their
    ``load``: each still's ``load`` on the card equals its ``load`` on
    the CPU byte for byte (pixels and meta), with no launch, and the
    pixels' sha256 is the one recorded with the JAX package's ``load``
    (``testing.avif_manifest``); the 64x48 animation's ``load_all`` and
    ``decode_batch`` on the card equal the CPU's.  Four worker processes
    (``avif_worker``) run beside that, one run each on the host clock
    with its spans: the 1080p animation's ``load_all`` on the card and on
    the CPU, each frame equal to the CPU's (pixels, meta, ``delay_ms``)
    and to the recorded hashes, and ``encode(pic, "AVIF")`` of
    ``avif_encode_cases`` on the card and on the CPU, bytes equal and
    their ``load`` equal; no launch in any of them.  Then the path, with
    fresh counts: ``decode_batch`` of ``AVIS_BATCH`` at size=(224, 224)
    (K16 once), equal to the plain resize of the CPU loads' pixels (the
    animation's first frame), then ``normalize_for_model`` (K17 once)
    against its plain version and ViT-B/16 (``vit_pair``) within config
    5's tolerance of the CPU forward.  Timings on the host clock, beside
    ``card``: each still's load (median of 3) in MP/s with its spans,
    the animation's load, the batch's wall time with its spans, each
    encode.  Returns the launches {path: {kernel: n}}."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    import numpy as np
    import torch
    from ffpic_tpu_torch import testing
    from ffpic_tpu_torch.ops import cuda_jpeg, cuda_png, cuda_resize
    from ffpic_tpu_torch.utils import trace
    mods = (cuda_jpeg, cuda_png, cuda_resize)

    def reset():
        torch.cuda.synchronize()
        for m in mods:
            m.reset_launches()

    def counts():
        torch.cuda.synchronize()
        return {k: v for m in mods for k, v in m.launches.items() if v}

    def span_ms(runs=1):
        return json.dumps({k: round(v["total"] / runs * 1e3, 3)
                           for k, v in trace.report().items()}) \
            .replace(" ", "")

    def same_frame(name, got, want, ent):
        """``got`` (the card's) and ``want`` (the CPU's) frames, each
        (device type, pixels, meta, delay_ms), equal, and the pixels'
        hash the recorded ``ent``."""
        if got[0] != dev.type or want[0] != "cpu":
            raise AssertionError(f"{name}: pixels on {got[0]}, {want[0]}")
        px = np.ascontiguousarray(got[1])
        if not np.array_equal(px, want[1]) or got[3] != want[3]:
            raise AssertionError(f"{name}: the card's frame differs from the "
                                 "CPU's")
        same_meta(name, got[2], want[2])
        if list(px.shape) != ent["shape"] or hashlib.sha256(
                px).hexdigest() != ent["pixels_sha256"]:
            raise AssertionError(f"{name}: pixels differ from the JAX "
                                 "package's recorded hash")

    t_phase = time.perf_counter()
    manifest = testing.avif_manifest()
    files = {k: testing.avif_fixture(f) for k, f in AVIF_FILES.items()}
    avis = testing.avif_fixture(AVIS_1080P)
    log("inputs avif", bytes=json.dumps({**{k: len(v) for k, v in
                                            files.items()},
                                         "avis_grain": len(avis)})
        .replace(" ", ""))
    pool = ProcessPoolExecutor(4, mp_context=multiprocessing.get_context(
        "spawn"))
    try:
        workers = {(task, where): pool.submit(avif_worker, task, where)
                   for task in ("load_all", "encode")
                   for where in (dev.type, "cpu")}
        launches = avif_card_side(dev, card, errs, files, avis, manifest,
                                  workers, reset, counts, span_ms,
                                  same_frame)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    log("time avif phase", card=card,
        phase_seconds=f"{time.perf_counter() - t_phase:.1f}")
    return launches


def avif_card_side(dev, card, errs, files, avis, manifest, workers, reset,
                   counts, span_ms, same_frame) -> dict:
    """``avif_paths``' own card work while its ``workers`` ({(task,
    device type): future of ``avif_worker``}) run."""
    import numpy as np
    import torch
    import ffpic_tpu_torch
    from ffpic_tpu_torch import testing
    from ffpic_tpu_torch.ops import resize as rs
    from ffpic_tpu_torch.utils import trace

    # the 64x48 animation: load_all and decode_batch on the card
    track = testing.avif_fixture("avis_track_64x48.avif")
    reset()
    got = ffpic_tpu_torch.load_all(track, device=dev)
    first = ffpic_tpu_torch.decode_batch([track], device=dev)
    small = counts()
    want = ffpic_tpu_torch.load_all(track, device="cpu")
    if small or not len(got) == len(want) == 3:
        raise AssertionError(f"avis 64x48: launches {small}, "
                             f"{len(got)} frames")
    for k, (g, w) in enumerate(zip(got, want)):
        same_frame(f"avis 64x48 frame {k}", avif_frame(g), avif_frame(w),
                   manifest["avis_track_64x48.avif"]["frames"][k])
    if not torch.equal(first[0].cpu(), want[0].pixels):
        raise AssertionError("avis 64x48: decode_batch differs from its "
                             "first frame")

    cpu, launches = {}, {}
    for name, data in files.items():
        runs = []
        trace.reset()
        trace.enable()
        for _ in range(3):
            reset()
            t0 = time.perf_counter()
            got = ffpic_tpu_torch.load(data, device=dev)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
            launches[name] = counts()
        trace.enable(False)
        spans = span_ms(len(runs))
        if launches[name]:
            raise AssertionError(f"{name}: launches {launches[name]}")
        want = ffpic_tpu_torch.load(data, device="cpu")
        same_frame(name, avif_frame(got), avif_frame(want),
                   manifest[AVIF_FILES[name]])
        cpu[name] = want.pixels
        mp = got.width * got.height / 1e6
        med = sorted(runs)[1]
        log("time avif load", card=card, file=name, megapixels=mp,
            load_ms=f"{med * 1e3:.3f}", mps=f"{mp / med:.3f}",
            runs_ms=json.dumps([round(r * 1e3, 3) for r in runs])
            .replace(" ", ""), span_ms=spans)

    # the path: decode_batch(size=) -> normalize_for_model -> ViT-B/16
    members = [avis] + [files[k] for k in AVIS_BATCH[1:]]
    size = CONFIG5_SIZE
    cfg, model, model_cpu = vit_pair(dev)
    reset()
    trace.reset()
    trace.enable()
    t0 = time.perf_counter()
    batch = ffpic_tpu_torch.decode_batch(members, size=size, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    trace.enable(False)
    stages = span_ms()
    x = rs.normalize_for_model(batch)
    logits = model(x)
    path = counts()
    if (path.get("resize_rgba"), path.get("normalize_resize")) != (1, 1) \
            or len(path) != 2:
        raise AssertionError(f"avif batch: launches {path}")
    if tuple(batch.shape) != (len(members), *size, 4):
        raise AssertionError(f"avif batch: {tuple(batch.shape)}")

    # the workers' results: the animation's load_all, then the encoder
    t0 = time.perf_counter()
    done = {k: f.result() for k, f in workers.items()}
    waited = time.perf_counter() - t0
    for (task, where), r in done.items():
        if r["launches"]:
            raise AssertionError(f"avif {task} on {where}: launches "
                                 f"{r['launches']}")
    on_card, on_cpu = done["load_all", dev.type], done["load_all", "cpu"]
    frames, ent = on_card["frames"], manifest[AVIS_1080P]["frames"]
    if not len(frames) == len(on_cpu["frames"]) == len(ent) == 3:
        raise AssertionError(f"avis 1080p: {len(frames)} frames on the card, "
                             f"{len(on_cpu['frames'])} on the CPU")
    for k, (g, w) in enumerate(zip(frames, on_cpu["frames"])):
        same_frame(f"avis 1080p frame {k}", g, w, ent[k])
    log("avif load", files=len(files) + 1, cpu_route="exact",
        jax_sha256="equal", launches="none",
        avis=f"{len(frames)} frames, film grain, delay_ms "
        f"{[f[3] for f in frames]}".replace(" ", ""),
        avis_64x48="3 frames exact")
    mp = sum(f[1].shape[0] * f[1].shape[1] for f in frames) / 1e6
    log("time avis load", card=card, file=AVIS_1080P, frames=len(frames),
        megapixels=mp, load_s=f"{on_card['seconds']:.3f}",
        mps=f"{mp / on_card['seconds']:.4f}",
        frames_per_s=f"{len(frames) / on_card['seconds']:.4f}",
        span_ms=json.dumps(on_card["spans"]).replace(" ", ""),
        spans=",".join(AVIF_SPANS), runs=1,
        cpu_load_s=f"{on_cpu['seconds']:.3f}",
        beside="the batch and three other workers")

    batch_cpu = rs.resize_batch(
        [torch.from_numpy(on_cpu["frames"][0][1])] +
        [cpu[k] for k in AVIS_BATCH[1:]], size)
    exact("resize_rgba", batch.cpu(), batch_cpu, errs)
    x_cpu = rs.normalize_for_model(batch_cpu)
    exact_f32("normalize_resize", x.cpu(), x_cpu, errs)
    err, scale, agree = logits_against_cpu("avif batch", logits,
                                           model_cpu(x_cpu), cfg.n_classes)
    launches["batch"] = path
    log("avif batch", members=",".join(AVIS_BATCH), size=size,
        launches=json.dumps(path).replace(" ", ""), batch_cpu_route="exact",
        input_cpu="exact", logits_max_abs_vs_cpu=f"{err:.6g}",
        logits_max_abs=f"{scale:.6g}",
        tolerance=f"{VIT_REL_TOL:g}*max|logit|", argmax_equal_share=agree)
    mp = len(members) * H * W / 1e6
    log("time avif batch", card=card, megapixels=mp, size=size,
        end_to_end_ms=f"{wall * 1e3:.3f}", mps=f"{mp / wall:.3f}",
        images_per_s=f"{len(members) / wall:.3f}", runs=1,
        stage_total_ms=stages)

    enc_card, enc_cpu = done["encode", dev.type], done["encode", "cpu"]
    for name, (blob, back, enc_s) in enc_card["encoded"].items():
        want_blob, want_back, cpu_s = enc_cpu["encoded"][name]
        if blob != want_blob:
            raise AssertionError(f"avif encode {name}: the card's bytes "
                                 "differ from the CPU's")
        if back[0] != dev.type or not np.array_equal(back[1], want_back[1]):
            raise AssertionError(f"avif encode {name}: the card's decode "
                                 "differs from the CPU's")
        mp = back[1].shape[0] * back[1].shape[1] / 1e6
        log("time avif encode", card=card, case=name,
            source=AVIF_ENCODE_SOURCE, bytes=len(blob), megapixels=mp,
            encode_s=f"{enc_s:.3f}", mps=f"{mp / enc_s:.4f}",
            cpu_encode_s=f"{cpu_s:.3f}", bytes_vs_cpu="equal",
            decode_vs_cpu="exact")
    log("avif workers", card=card, waited_s=f"{waited:.3f}",
        seconds=json.dumps({f"{k[0]}_{k[1]}": round(r["seconds"], 3)
                            for k, r in done.items()}).replace(" ", ""))
    return launches


def hevc_inter_paths(dev, card: str, floor_ms: float, errs: dict):
    """The HEVC inter slice on the card, under ``FFPIC_HEVC_DEVICE=1`` and
    ``FFPIC_HEIF_DEVICE_COLOR=1``: ``load_all`` of the committed 1920x1080
    raw stream (5 pictures, I/P/B) and of the 1080p HEIF image sequence
    (a still primary, then 3 frames of an I/P/B stream), then one
    ``decode_batch`` of both, each decoded once, with fresh launch counts.
    Every decoded picture's Y, U and V planes are held against libde265's
    digests (``testdata/hevc_fixtures.json``, ``make_hevc_fixtures``);
    every K14 launch against ``hevc_residuals_plain`` on the card on the
    same TUs and every K15 launch against ``hevc_tiles_to_rgba_plain`` on
    the same staged planes, bit for bit; K14 runs once a picture and K15
    once a frame.  Logged: the launches, each run's host clock, frames/s
    and spans (``hevc.syntax``, ``hevc.recon``, ``heif.color``) beside
    ``card``.  K14 is timed on the largest P/B picture's TUs and K15 on a
    1080p frame.  Returns {kernel: timing entry} and the launches {run:
    {kernel: n}}."""
    import numpy as np
    import torch
    import ffpic_tpu_torch
    from ffpic_tpu_torch import make_hevc_fixtures as mf
    from ffpic_tpu_torch.formats import heif, hevc
    from ffpic_tpu_torch.ops import cuda_hevc
    from ffpic_tpu_torch.ops import hevc_kernels as hk
    from ffpic_tpu_torch.utils import trace

    d = os.path.join(os.path.dirname(mf.__file__), "testdata")
    with open(os.path.join(d, mf.DIGESTS)) as f:
        digests = json.load(f)
    blobs = {}
    for name in (mf.STREAM, mf.SEQUENCE):
        with open(os.path.join(d, name), "rb") as f:
            blobs[name] = f.read()
        if hashlib.sha256(blobs[name]).hexdigest() != digests[name]["sha256"]:
            raise AssertionError(f"{name}: not the file of {mf.DIGESTS}")
    log("inputs hevc inter", card=card, **{k.split(".")[1]: len(v)
                                           for k, v in blobs.items()},
        pictures=json.dumps({k.split(".")[1]: len(v["pictures"])
                             for k, v in digests.items()}).replace(" ", ""))

    # what each run decodes and launches: the pictures of each sequence
    # decoder (in decode order) and each primary item, every K14 call's
    # TUs and result, every K15 call's staged planes and result
    seen = {"seqs": {}, "items": [], "k14": [], "k15": []}
    real = (hevc.SequenceDecoder._decode_au, heif._decode_item_yuv,
            hk.residuals_packed, hk.hevc_tiles_to_rgba)

    def decode_au(self):
        pic = real[0](self)
        seen["seqs"].setdefault(id(self), []).append(pic)
        return pic

    def item_yuv(*a, **kw):
        out = real[1](*a, **kw)
        seen["items"].append(out[0])
        return out

    def residuals(tu_meta, levels, bit_depth, device=None):
        out = real[2](tu_meta, levels, bit_depth, device)
        need = int((tu_meta[:, 2].astype(np.int64) ** 2).sum())
        seen["k14"].append((tu_meta.copy(), levels[:need].copy(), bit_depth,
                            out.copy()))
        return out

    def colour(st, mode="bt601"):
        out = real[3](st, mode)
        seen["k15"].append((st, mode, out))
        return out

    def check_planes(what, pics, want):
        got = [mf.picture_digests(p.planes, [w["shape"] for w in ws])
               for p, ws in zip(pics, want)]
        if len(pics) != len(want) or got != want:
            bad = [k for k, (g, w) in enumerate(zip(got, want)) if g != w]
            raise AssertionError(f"hevc inter {what}: {len(pics)} pictures "
                                 f"for {len(want)}, differing from libde265 "
                                 f"at {bad}")

    def run(name, fn, frames):
        for v in seen.values():
            v.clear()
        torch.cuda.synchronize()
        cuda_hevc.reset_launches()
        trace.reset()
        trace.enable()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        trace.enable(False)
        n = dict(cuda_hevc.launches)
        stages = {k: round(v["total"] * 1e3, 3)
                  for k, v in trace.report().items()}
        seqs = list(map(hevc.display_order, seen["seqs"].values()))
        n_pics = sum(map(len, seqs)) + len(seen["items"])
        if (n["hevc_residuals"], n["hevc_yuv_to_rgba"]) != (
                n_pics, frames) or len(seen["k14"]) != n_pics \
                or len(seen["k15"]) != frames:
            raise AssertionError(f"hevc inter {name}: launches {n}, "
                                 f"{n_pics} pictures, {frames} frames")
        for meta, lv, bd, res in seen["k14"]:
            exact("hevc_residuals", torch.from_numpy(res).to(dev),
                  hk.hevc_residuals_plain(torch.from_numpy(meta).to(dev),
                                          torch.from_numpy(lv).to(dev), bd),
                  errs)
        for st, mode, res in seen["k15"]:
            exact("hevc_yuv_to_rgba", res,
                  hk.hevc_tiles_to_rgba_plain(st, mode), errs)
        log("hevc inter path", run=name, card=card,
            launches=json.dumps(n).replace(" ", ""), pictures=n_pics,
            coloured_frames=frames, k14_k15_plain="exact",
            libde265="exact", host_s=f"{wall:.3f}",
            **{k: stages.get(k, 0.0) for k in (
                "hevc.syntax", "hevc.recon", "hevc.loop_filter",
                "heif.color")},
            stage_ms_total=json.dumps(stages).replace(" ", ""))
        return out, seqs, n, wall, stages

    env = {"FFPIC_HEVC_DEVICE": "1", "FFPIC_HEIF_DEVICE_COLOR": "1",
           "FFPIC_NO_NATIVE_RECON": None}
    launches, timed_runs, inputs = {}, {}, {}
    (hevc.SequenceDecoder._decode_au, heif._decode_item_yuv,
     hk.residuals_packed, hk.hevc_tiles_to_rgba) = (decode_au, item_yuv,
                                                    residuals, colour)
    try:
        with environ(**env):
            # the raw stream: K14 and K15 once a picture
            pics, seqs, launches["load_265"], wall, stages = run(
                "load inter_1080p.265",
                lambda: ffpic_tpu_torch.load_all(blobs[mf.STREAM],
                                                 device=dev), 5)
            check_planes("load .265", seqs[0],
                         digests[mf.STREAM]["pictures"])
            # the largest P/B picture's TUs (the first is the I picture)
            inputs["k14"] = max(seen["k14"][1:], key=lambda k: k[1].size)
            inputs["k15"] = seen["k15"][-1][0]
            first = pics[0].pixels
            if len(pics) != 5 or any(
                    tuple(p.pixels.shape) != (H, W, 4) or p.delay_ms != 40
                    or p.pixels.device.type != dev.type for p in pics):
                raise AssertionError("load .265: pictures")
            timed_runs["load_265"] = (wall, 5, stages)
            # the HEIF sequence: K14 once a picture (primary and 3
            # frames), K15 once a frame
            pics, seqs, launches["load_heic"], wall, stages = run(
                "load sequence_1080p.heic",
                lambda: ffpic_tpu_torch.load_all(blobs[mf.SEQUENCE],
                                                 device=dev), 4)
            check_planes("heic primary", seen["items"],
                         digests[mf.SEQUENCE]["primary"])
            check_planes("heic sequence", seqs[0],
                         digests[mf.SEQUENCE]["pictures"])
            if len(pics) != 4 or any(tuple(p.pixels.shape) != (H, W, 4)
                                     for p in pics):
                raise AssertionError("load heic: pictures")
            primary = pics[0].pixels
            timed_runs["load_heic"] = (wall, 4, stages)
            # decode_batch of both: the stream whole (its first picture
            # kept) and the HEIC's primary
            out, seqs, launches["decode_batch"], wall, stages = run(
                "decode_batch [.265, .heic]", lambda: ffpic_tpu_torch
                .decode_batch([blobs[mf.STREAM], blobs[mf.SEQUENCE]],
                              device=dev), 6)
            check_planes("decode_batch .265", seqs[0],
                         digests[mf.STREAM]["pictures"])
            check_planes("decode_batch heic", seen["items"],
                         digests[mf.SEQUENCE]["primary"])
            if tuple(out.shape) != (2, H, W, 4) or not (
                    torch.equal(out[0], first) and torch.equal(out[1],
                                                               primary)):
                raise AssertionError("decode_batch differs from load")
            timed_runs["decode_batch"] = (wall, 2, stages)
    finally:
        (hevc.SequenceDecoder._decode_au, heif._decode_item_yuv,
         hk.residuals_packed, hk.hevc_tiles_to_rgba) = real
    del first, primary, out, pics

    # K14 on the largest P/B picture's TUs in one launch, K15 on a 1080p
    # frame; bytes and ops counted as heif_paths counts them
    flush = torch.empty(100 * 2 ** 20, dtype=torch.uint8, device=dev)
    meta, lv, bd, _res = inputs["k14"]
    lv_d, plan, _ = hk.stage_residuals([(meta, lv)], dev)
    meta_d = torch.from_numpy(meta).to(dev)
    timed = {"hevc_residuals": time_entry(
        "hevc_residuals", lambda: cuda_hevc.hevc_residuals(lv_d, bd, *plan),
        lambda: hk.hevc_residuals_plain(meta_d, lv_d, bd),
        4 * lv.size + 8 * len(meta) + 16 * len(plan[1]), hevc_ops([meta]),
        "int32", floor_ms, flush,
        f"hevc inter path, a 1080p P/B picture's {len(meta)} TUs")}
    st = inputs["k15"]
    timed["hevc_yuv_to_rgba"] = time_entry(
        "hevc_yuv_to_rgba", lambda: hk.hevc_tiles_to_rgba(st, "bt601"),
        lambda: hk.hevc_tiles_to_rgba_plain(st, "bt601"),
        7 * H * W + 4 * (st.desc.numel() + H + W + st.cell_map.numel()),
        13 * H * W, "f32", floor_ms, flush,
        "hevc inter path, a 1080p frame as its one tile")
    # frames/s: the pictures each run returns (decode_batch: 2 images)
    for name, (wall, frames, stages) in timed_runs.items():
        log("time hevc inter", run=name, card=card, host_s=f"{wall:.3f}",
            outputs=frames, frames_per_s=f"{frames / wall:.4f}",
            k14_ms=f"{timed['hevc_residuals']['ms']:.4f}",
            k15_ms=f"{timed['hevc_yuv_to_rgba']['ms']:.4f}",
            stage_ms_total=json.dumps(stages).replace(" ", ""))
    del flush, lv_d, meta_d, st, inputs
    return timed, launches


TRAIN_REL_TOL = 2.0 ** -5    # card updates against the CPU's, of max |update|
TRAIN_LOSS_TOL = VIT_REL_TOL  # card loss against the CPU's, of |loss|
MOE_REL_TOL = 1e-5           # the f32 MoE, card against the CPU
F32_STEP = 2.0 ** -22        # two f32 steps of the largest |p|, relative


def event_ms(fn, runs: int = 5) -> tuple[float, list]:
    """Median of ``runs`` CUDA-event timings of ``fn()``, each alone
    (after one warm call), and the runs."""
    import torch
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2], times


def updates_against_cpu(name: str, old, new, new_cpu, lr: float,
                        rel: float) -> float:
    """Each tensor's update ``(old - new) / lr`` on the card against the
    CPU's, within ``rel`` of the CPU update's largest element plus two
    f32 steps of the largest |old| over ``lr`` (the rounding of ``p - lr
    * g``).  Returns the worst error over that scale."""
    worst = 0.0
    for k, p in old.items():
        p64 = p.detach().cpu().double()
        u = (p64 - new[k].detach().cpu().double()) / lr
        u_cpu = (p64 - new_cpu[k].double()) / lr
        if not bool(u.isfinite().all()):
            raise AssertionError(f"{name} {k}: update not finite")
        err = float((u - u_cpu).abs().max())
        scale = float(u_cpu.abs().max())
        slack = F32_STEP * float(p64.abs().max()) / lr
        if err > rel * scale + slack:
            raise AssertionError(f"{name} {k}: card update differs from the "
                                 f"CPU's by {err} (max |update| {scale})")
        worst = max(worst, err / max(scale, 1e-30))
    return worst


def train_paths(dev, card: str, x_config5, jpeg) -> dict:
    """The model-consumer and multi-device layers on the card.

    * ViT-B/16 at its published widths and depth (weights from
      ``torch.Generator`` seed 0, as config 5's), one
      ``vit.make_train_step`` SGD step on config 5's normalised batch of
      8 (``x_config5``; labels 0..7): the loss and each tensor's update
      ``(old - new) / lr`` against the same step on the CPU route
      (``TRAIN_LOSS_TOL``, ``TRAIN_REL_TOL``), then the step timed with
      CUDA events, median of 5, against 3 x ``vit.forward_flops``.
    * ``moe.make_train_step`` on ``MOE_TINY`` (seed 1; x from
      ``default_rng(2)``, 2 x 16 x 32) against the CPU (``MOE_REL_TOL``).
    * A world of one over NCCL (``FileStore`` in a temporary directory),
      ``parallel.make_mesh()``: ``sharded_decode_420`` of the 8 x 1080p
      headline batch's dense coefficients (``jpeg``: the main path's
      planes, per-image quant tables) and ``decode_batch(mesh=)`` of its
      files, each bit-equal to ``decode_batch(mesh=None)``, with fresh
      launch counts: K2 x 1 and K3 x 1 (one bucket), no K1a, K1b, K8 or
      K9; their MP/s (host clock, median of 5).
    * ``graft_entry.entry()`` on the card (K2 + K3) equal to the plain
      route's.

    Every number beside ``card``.  Returns the launches {path: {kernel:
    n}}; the process group is taken down whatever happens."""
    import datetime
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from ffpic_tpu_torch import decode_batch, graft_entry
    from ffpic_tpu_torch.models import moe, vit
    from ffpic_tpu_torch.ops import cuda_entropy, cuda_jpeg
    from ffpic_tpu_torch.parallel import make_mesh, sharded_decode_420
    from ffpic_tpu_torch.utils.timing import BF16_OPS_PER_S, F32_OPS_PER_S
    mods = (cuda_jpeg, cuda_entropy)

    def reset():
        torch.cuda.synchronize()
        for m in mods:
            m.reset_launches()

    def counts():
        torch.cuda.synchronize()
        return {k: v for m in mods for k, v in m.launches.items() if v}

    launches = {}
    # --- ViT-B/16: one SGD step on the card against the CPU --------------
    cfg = vit.VIT_B16
    state = vit.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    n = x_config5.shape[0]
    labels = torch.arange(n) % cfg.n_classes
    lr = 1e-3
    step = vit.make_train_step(cfg, lr)
    params = {k: v.to(dev) for k, v in state.items()}
    x_card, y_card = x_config5.to(dev), labels.to(dev)
    new, loss = step(params, x_card, y_card)
    t0 = time.perf_counter()
    new_cpu, loss_cpu = step(state, x_config5.cpu(), labels)
    cpu_s = time.perf_counter() - t0
    loss, loss_cpu = float(loss), float(loss_cpu)
    if not np.isfinite(loss) or abs(loss - loss_cpu) > TRAIN_LOSS_TOL * abs(
            loss_cpu):
        raise AssertionError(f"vit step: card loss {loss}, CPU {loss_cpu}")
    worst = updates_against_cpu("vit step", params, new, new_cpu, lr,
                                TRAIN_REL_TOL)
    if any(v.device.type != "cuda" or v.dtype != torch.float32
           for v in new.values()):
        raise AssertionError("vit step: new parameters off the card")
    del new, new_cpu
    ms, runs = event_ms(lambda: step(params, x_card, y_card))
    flops = 3 * vit.forward_flops(cfg, n)
    log("train vit", config="ViT-B/16", batch=n, lr=lr, loss=f"{loss:.6f}",
        loss_cpu=f"{loss_cpu:.6f}", loss_tolerance=f"{TRAIN_LOSS_TOL:g}*|loss|",
        worst_update_err_of_max=f"{worst:.6g}",
        update_tolerance=f"2**-5*max|update|+2 f32 steps",
        tensors=len(params), cpu_step_seconds=f"{cpu_s:.3f}")
    log("time train vit", config="ViT-B/16", batch=n, ms=f"{ms:.4f}",
        runs=json.dumps([round(t, 4) for t in runs]).replace(" ", ""),
        flops=flops, tflops=f"{flops / ms / 1e9:.2f}",
        bf16_peak_share=f"{flops / (ms / 1e3) / BF16_OPS_PER_S:.4f}",
        f32_peak_share=f"{flops / (ms / 1e3) / F32_OPS_PER_S:.4f}",
        card=card, weights="seeded (torch.Generator seed 0), not pretrained")
    del params, x_card

    # --- MoE: one SGD step on the card against the CPU --------------------
    mcfg = moe.MOE_TINY
    mstate = moe.init_params(mcfg, torch.Generator().manual_seed(1), "cpu")
    mx = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, mcfg.seq_len, mcfg.d_model)).astype(np.float32))
    my = torch.arange(2) % mcfg.n_classes
    mstep = moe.make_train_step(mcfg)
    mparams = {k: v.to(dev) for k, v in mstate.items()}
    mnew, mloss = mstep(mparams, mx.to(dev), my.to(dev))
    mnew_cpu, mloss_cpu = mstep(mstate, mx, my)
    mloss, mloss_cpu = float(mloss), float(mloss_cpu)
    if abs(mloss - mloss_cpu) > MOE_REL_TOL * abs(mloss_cpu):
        raise AssertionError(f"moe step: card loss {mloss}, CPU {mloss_cpu}")
    mworst = 0.0
    for k in mstate:
        want = mnew_cpu[k].double()
        err = float((mnew[k].cpu().double() - want).abs().max())
        if err > MOE_REL_TOL * float(want.abs().max()):
            raise AssertionError(f"moe step {k}: card differs from the CPU "
                                 f"by {err}")
        mworst = max(mworst, err / float(want.abs().max()))
    mms, mruns = event_ms(lambda: mstep(mparams, mx.to(dev), my.to(dev)))
    log("train moe", config="MOE_TINY", batch=2, loss=f"{mloss:.6f}",
        loss_cpu=f"{mloss_cpu:.6f}", worst_param_err_of_max=f"{mworst:.3g}",
        tolerance=f"{MOE_REL_TOL:g}*max|p|", step_ms=f"{mms:.4f}",
        runs=json.dumps([round(t, 4) for t in mruns]).replace(" ", ""),
        card=card)

    # --- the mesh: a world of one over NCCL -------------------------------
    want = decode_batch(jpeg["srcs"], device=dev)
    coeffs, yq, cq = jpeg["coeffs"], jpeg["yq"], jpeg["cq"]
    (nby, nbx), _, _ = jpeg["shapes"]
    ny, nc = nby * nbx, nby * nbx // 4
    planes = (coeffs[:, :ny].reshape(N, nby, nbx, 8, 8),
              coeffs[:, ny:ny + nc].reshape(N, nby // 2, nbx // 2, 8, 8),
              coeffs[:, ny + nc:].reshape(N, nby // 2, nbx // 2, 8, 8))
    quant = tuple(q.reshape(N, 1, 1, 8, 8) for q in (yq, cq))
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=300))
        try:
            mesh = make_mesh()
            reset()
            sh = sharded_decode_420(mesh, *planes, *quant, order="rgba",
                                    mode="bt601")
            full = sh.full_tensor()
            launches["mesh_sharded_decode"] = counts()
            if (tuple(full.shape) != (N, 8 * nby, 8 * nbx, 4)
                    or not torch.equal(full[:, :H, :W], want)):
                raise AssertionError("sharded_decode_420 differs from "
                                     "decode_batch(mesh=None)")
            reset()
            got = decode_batch(jpeg["srcs"], mesh=mesh)
            got_full = got.full_tensor()
            launches["mesh_decode_batch"] = counts()
            if not torch.equal(got_full, want):
                raise AssertionError("decode_batch(mesh=) differs from "
                                     "decode_batch(mesh=None)")
            for path, c in launches.items():
                if not path.startswith("mesh"):
                    continue
                if (c.get("dequant_idct"), c.get("assemble_color")) != (1, 1) \
                        or any(c.get(k) for k in (
                            "count_scan", "unpack", "scatter_plane",
                            "entropy_decode")):
                    raise AssertionError(f"{path}: launches {c}")
            mp = N * H * W / 1e6
            walls = {}
            for name, fn in (
                    ("sharded_decode_420", lambda: sharded_decode_420(
                        mesh, *planes, *quant, order="rgba", mode="bt601")),
                    ("decode_batch_mesh", lambda: decode_batch(
                        jpeg["srcs"], mesh=mesh)),
                    ("decode_batch_no_mesh", lambda: decode_batch(
                        jpeg["srcs"], device=dev))):
                fn()
                w = []
                for _ in range(5):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    w.append(time.perf_counter() - t0)
                walls[name] = sorted(w)[2]
            log("mesh decode", world=1, backend="nccl",
                mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
                batch=f"{N}x{W}x{H} 4:2:0",
                placements=[str(p) for p in got.placements],
                sharded_decode_420="exact", decode_batch_mesh="exact",
                launches=json.dumps({k: v for k, v in launches.items()
                                     if k.startswith("mesh")})
                .replace(" ", ""),
                **{f"{k}_ms": f"{v * 1e3:.3f}" for k, v in walls.items()},
                **{f"{k}_mps": f"{mp / v:.2f}" for k, v in walls.items()},
                card=card)
        finally:
            dist.destroy_process_group()

    # --- graft_entry.entry(): K2 + K3 against the plain route ------------
    reset()
    fn, args = graft_entry.entry()
    got = fn(*args)
    launches["graft_entry"] = counts()
    fn_cpu, args_cpu = graft_entry.entry(device="cpu")
    if not torch.equal(got.cpu(), fn_cpu(*args_cpu)):
        raise AssertionError("graft entry: K2 + K3 differ from the plain "
                             "route")
    if tuple(got.shape) != (2, 128, 128, 4) or launches["graft_entry"] != {
            "dequant_idct": 1, "assemble_color": 1}:
        raise AssertionError(f"graft entry: {tuple(got.shape)}, launches "
                             f"{launches['graft_entry']}")
    log("graft entry", shape=tuple(got.shape), plain_route="exact",
        launches=launches["graft_entry"])
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    from ffpic_tpu_torch import compare_kernels, decode_batch, native, testing
    from ffpic_tpu_torch.formats.jpg import packed_block_map
    from ffpic_tpu_torch.ops import _build, cuda_jpeg
    from ffpic_tpu_torch.ops import jpeg_kernels as jk
    from ffpic_tpu_torch.ops.resize import resize_rgba
    from ffpic_tpu_torch.pipeline import _prep
    from ffpic_tpu_torch.utils import trace
    from ffpic_tpu_torch.utils.timing import (F32_OPS_PER_S, INT32_OPS_PER_S,
                                              bound, gpu_ms, gpu_ms_cold)

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    log("env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count())

    # nvcc (the CUDA kernels, and the FP64 probe), and cc (the host
    # decoder) side by side
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as ex:
        host = ex.submit(native.available)
        probe = ex.submit(compare_kernels.fp64_probe)
        so = _build.library_path()
        _build.load()
        host.result()
        probe_lib, _ = probe.result()
    log("build", seconds=f"{time.perf_counter() - t0:.3f}",
        lib=os.path.basename(so), host_lib=os.path.basename(native._build()))
    with open(so[:-3] + ".log") as f:
        ptxas = ptxas_report(f.read())
    for name, info in ptxas.items():
        log("ptxas", kernel=name, **info)
    # resize_band (K16 by cubic and Lanczos) is bit-exact only while
    # mma.m16n8k16 .f64 rounds as the forward chain of FMAs over k, which
    # the PTX manual does not promise: hold this card and driver to it
    shares = compare_kernels.mma16_forward_shares(probe_lib, dev)
    log("check fp64 mma chain", form="m16n8k16", tiles=1024,
        **{k: f"{v:.6f}" for k, v in shares.items()})
    if any(v != 1.0 for v in shares.values()):
        raise AssertionError("mma.m16n8k16 .f64 does not round as the "
                             f"forward chain of FMAs: {shares}")

    t0 = time.perf_counter()
    jpegs = [testing.synth_jpeg_420(H, W, 85, 1),
             testing.synth_jpeg_420(H, W, 95, 2)]
    srcs = [jpegs[k % 2] for k in range(N)]
    log("inputs", jpegs=f"2x{W}x{H} q85/q95", batch=N,
        bytes=[len(b) for b in jpegs],
        seconds=f"{time.perf_counter() - t0:.3f}")

    # --- kernels against their plain versions, on the card ---------------
    plans = [_prep(d)[0] for d in srcs]
    j0 = plans[0]
    shapes = tuple((c.nby, c.nbx) for c in j0.comps)
    (nby, nbx), _, _ = shapes
    nblocks = sum(a * b for a, b in shapes)
    buf_np, g, e = jk.stack_packed_fused([j.packed for j in plans])
    buf = torch.from_numpy(buf_np).to(dev)
    bmap = packed_block_map(j0, dev)
    yq = torch.from_numpy(np.stack([j.dqt[j.comps[0].tq] for j in plans])
                          .astype(np.int32)).to(dev)
    cq = torch.from_numpy(np.stack([j.dqt[j.comps[1].tq] for j in plans])
                          .astype(np.int32)).to(dev)
    if torch.equal(yq[0], yq[1]):
        raise AssertionError("the two qualities must give different tables")
    errs: dict = {}

    counts, ks, vals = jk.split_packed(buf, N, g, e)
    starts = cuda_jpeg.count_scan(buf, N, g)
    exact("count_scan", starts, jk.count_starts(counts), errs)
    coeffs = cuda_jpeg.unpack(buf, starts, bmap, N, g, e, nblocks)
    coeffs_p = jk.unpack_coeffs(counts, ks, vals, bmap, nblocks)
    exact("unpack", coeffs, coeffs_p, errs)
    rng = np.random.default_rng(0)
    # the edges of K1b's tiling: tiles cut inside MCUs, a part-full last
    # tile, a block with 64 nonzeros, all nonzeros in one block, N=1 and
    # N=3, tiles staged in several passes, and the hostile buffer (counts
    # up to 255 running past E, zigzag positions past 63, nonzero
    # padding, an odd vals offset, a shuffled block map)
    for case in testing.unpack_cases().values():
        cbuf, cn, cg, ce, cmap = case
        cbuf = torch.from_numpy(cbuf).to(dev)
        cmap = torch.from_numpy(cmap).to(dev)
        cc, cks, cv = jk.split_packed(cbuf, cn, cg, ce)
        cstarts = cuda_jpeg.count_scan(cbuf, cn, cg)
        exact("count_scan", cstarts, jk.count_starts(cc), errs)
        exact("unpack", cuda_jpeg.unpack(cbuf, cstarts, cmap, cn, cg, ce, cg),
              jk.unpack_coeffs(cc, cks, cv, cmap, cg), errs)
    # the edges of K1a's cluster cut: fewer words than CTAs, rows that
    # share a word, unaligned rows, all 255 and all 0, CTAs that loop;
    # each buffer exactly n*g bytes
    for cnt, cn, cg in testing.scan_cases().values():
        cnt = torch.from_numpy(cnt).to(dev)
        exact("count_scan", cuda_jpeg.count_scan(cnt, cn, cg),
              jk.count_starts(cnt.view(cn, cg)), errs)
    log("check K1", count_scan="exact", unpack="exact",
        nonzeros=[j.packed[3] for j in plans[:2]], e=e,
        edge_cases=",".join([*testing.unpack_cases(), *testing.scan_cases()]))

    samples = cuda_jpeg.dequant_idct(coeffs_p, yq, cq, nby * nbx)
    samples_p = jk.dequant_idct_blocks(coeffs_p, yq, cq, nby * nbx)
    exact("dequant_idct", samples, samples_p, errs)
    ext = np.full((4, 8, 8), 32767, np.int16)       # tests/test_idct.py:50
    ext[1] = -32768
    ext[2, :, ::2] = -32768
    ext[3, ::2, :] = 12345
    ext = torch.from_numpy(ext[None]).to(dev)
    q255 = torch.full((1, 64), 255, dtype=torch.int32, device=dev)
    exact("dequant_idct", cuda_jpeg.dequant_idct(ext, q255, q255, 4),
          jk.dequant_idct_blocks(ext, q255, q255, 4), errs)
    rblk = torch.from_numpy(rng.integers(-32768, 32768, (4, 4096, 8, 8),
                                         dtype=np.int16)).to(dev)
    rq = torch.from_numpy(rng.integers(1, 65536, (2, 4, 64),
                                       dtype=np.int32)).to(dev)
    exact("dequant_idct", cuda_jpeg.dequant_idct(rblk, rq[0], rq[1], 3000),
          jk.dequant_idct_blocks(rblk, rq[0], rq[1], 3000), errs)
    # the edges of K2's tiles: part-full last tiles, the luma/chroma
    # boundary at 0, at nblocks and at 32k +- 1, N=1 and N=3
    for cco, cyq, ccq, cnl in testing.idct_cases().values():
        cco, cyq, ccq = (torch.from_numpy(a).to(dev) for a in (cco, cyq, ccq))
        exact("dequant_idct", cuda_jpeg.dequant_idct(cco, cyq, ccq, cnl),
              jk.dequant_idct_blocks(cco, cyq, ccq, cnl), errs)
    log("check K2", dequant_idct="exact", cases="8x1080p,extreme,random," +
        ",".join(testing.idct_cases()))
    # the dense route (progressive members): K2 + K3 on the main path's
    # coefficients against the plain route
    dense = jk.decode_batch_420_dense(coeffs_p, yq, cq, shapes, "rgba",
                                      "bt601", (H, W))
    if not torch.equal(dense, jk.decode_batch_420(coeffs_p, yq, cq, shapes,
                                                  "rgba", "bt601", (H, W))):
        raise AssertionError("the dense route differs from the plain route")
    log("check dense route", shape=tuple(dense.shape), plain_route="exact")
    del dense

    exact("assemble_color", cuda_jpeg.assemble_color(
        samples_p, nby, nbx, "rgba", "bt601", (H, W)),
        jk.assemble_color(samples_p, shapes, "rgba", "bt601", (H, W)), errs)
    # every (y, u, v) in [0, 255]^3: a 4096x4096 4:2:0 image whose 2048^2
    # chroma samples take each (u, v) 64 times, with the 4 luma pixels
    # under each chroma sample covering 4 of y's 256 values
    s = torch.arange(2048 * 2048, device=dev).view(2048, 2048)
    u = ((s % 65536) // 256).to(torch.int16)
    v = (s % 256).to(torch.int16)
    quad = torch.arange(4, device=dev).view(2, 2)
    y = ((s // 65536)[:, None, :, None] * 4 + quad[None, :, None, :]) \
        .reshape(4096, 4096).to(torch.int16)

    def blocks(p):
        hb, wb = p.shape[0] // 8, p.shape[1] // 8
        return p.view(hb, 8, wb, 8).permute(0, 2, 1, 3).reshape(-1, 8, 8)

    full = torch.cat([blocks(y), blocks(u), blocks(v)])[None].contiguous()
    rnd = torch.from_numpy(rng.integers(-32768, 32768, (2, 96, 8, 8),
                                        dtype=np.int16)).to(dev)
    for mode in ("reference", "bt601", "rgb"):
        for order in ("rgba", "bgra"):
            for smp, gy, gx in ((full, 512, 512), (rnd, 8, 8)):
                exact("assemble_color",
                      cuda_jpeg.assemble_color(smp, gy, gx, order, mode),
                      jk.assemble_color(
                          smp, ((gy, gx), (gy // 2, gx // 2)) + (
                              (gy // 2, gx // 2),), order, mode), errs)
    del full, s, u, v, y
    for smp, gy, gx, hw in testing.assemble_cases().values():
        smp = torch.from_numpy(smp).to(dev)
        shp = ((gy, gx), (gy // 2, gx // 2), (gy // 2, gx // 2))
        for mode in ("reference", "bt601", "rgb"):
            for order in ("rgba", "bgra"):
                exact("assemble_color",
                      cuda_jpeg.assemble_color(smp, gy, gx, order, mode, hw),
                      jk.assemble_color(smp, shp, order, mode, hw), errs)
    log("check K3", assemble_color="exact", cases="256^3 x 3 modes x 2 "
        "orders + random int16 + " + ",".join(testing.assemble_cases()))

    # --- the main path ----------------------------------------------------
    torch.cuda.synchronize()
    cuda_jpeg.reset_launches()
    out = decode_batch(srcs, device="cuda")
    torch.cuda.synchronize()
    launches = dict(cuda_jpeg.launches)
    if (tuple(out.shape) != (N, H, W, 4) or out.dtype != torch.uint8
            or out.device.type != "cuda"):
        raise AssertionError(f"decode_batch gave {tuple(out.shape)} "
                             f"{out.dtype} on {out.device}")
    if min(launches[k] for k in PATH_420) < 1:
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    plain = jk.decode_batch_420(coeffs_p, yq, cq, shapes, "rgba",
                                "bt601", hw=(H, W))
    if not torch.equal(out, plain):
        raise AssertionError("decode_batch differs from the plain route, by "
                             f"up to {max_abs_err(out, plain)}")
    psnr = []
    for k in range(2):
        src = torch.from_numpy(testing.synth_rgb(H, W, k + 1)).to(dev)
        mse = (out[k, ..., :3].double() - src.double()).pow(2).mean().item()
        psnr.append(round(float(10 * np.log10(255 ** 2 / mse)), 2))
    if min(psnr) < 30 or not torch.all(out[..., 3] == 255):
        raise AssertionError(f"decoded pixels do not match their source: "
                             f"PSNR {psnr} dB")
    small = [testing.synth_jpeg_420(160, 224, q, 7 + q) for q in (50, 75, 95)]
    if not torch.equal(decode_batch(small, device="cuda").cpu(),
                       decode_batch(small, device="cpu")):
        raise AssertionError("small batch: CUDA differs from the CPU route")
    log("main path", shape=tuple(out.shape), launches=launches,
        plain_route="exact", psnr_db=psnr, small_cpu_vs_cuda="exact")
    sized = decode_batch(srcs, size=(224, 224), device="cuda")
    want = torch.stack([resize_rgba(p, (224, 224)) for p in plain])
    if tuple(sized.shape) != (N, 224, 224, 4) or not torch.equal(sized, want):
        raise AssertionError("size=(224, 224) differs from the plain route")
    log("main path size=(224,224)", shape=tuple(sized.shape),
        plain_route="exact")

    # --- timing -----------------------------------------------------------
    # each kernel at the main path's shapes: warm, and with L2 flushed;
    # its bound from the bytes it must move and the ops it must do
    flush = torch.empty(100 * 2 ** 20, dtype=torch.uint8, device=dev)
    entries = int((cuda_jpeg.unpack_entry_ranges(starts, counts, e)
                   .diff(dim=-1)).sum())
    ng, nb_all = N * g, N * nblocks
    npx, nch = N * H * W, N * ((H + 1) // 2) * ((W + 1) // 2)
    # ops are the work of each kernel's function, whatever implements
    # it: K2 is charged the direct 8x8 product, (64 + 2*1024) per block,
    # though its even/odd passes do less; a multiply-add is 2 ops
    work = {    # name: (kernel, plain, bytes, ops, type of the ops)
        "count_scan": (lambda: cuda_jpeg.count_scan(buf, N, g),
                       lambda: jk.count_starts(counts), 5 * ng, ng,
                       "int32"),
        "unpack": (lambda: cuda_jpeg.unpack(buf, starts, bmap, N, g, e,
                                            nblocks),
                   lambda: jk.unpack_coeffs(counts, ks, vals, bmap, nblocks),
                   5 * ng + 4 * g + 3 * entries + 128 * nb_all, entries,
                   "int32"),
        "dequant_idct": (lambda: cuda_jpeg.dequant_idct(coeffs, yq, cq,
                                                        nby * nbx),
                         lambda: jk.dequant_idct_blocks(coeffs, yq, cq,
                                                        nby * nbx),
                         256 * nb_all + 512 * N, (64 + 2 * 1024) * nb_all,
                         "int32"),
        "assemble_color": (lambda: cuda_jpeg.assemble_color(
            samples, nby, nbx, "rgba", "bt601", (H, W)),
            lambda: jk.assemble_color(samples, shapes, "rgba", "bt601",
                                      (H, W)),
            2 * npx + 4 * nch + 4 * npx, 13 * npx, "f32"),
    }
    rates = {"int32": INT32_OPS_PER_S, "f32": F32_OPS_PER_S}
    library = {"count_scan": lambda: torch.cumsum(counts, dim=1,
                                                  dtype=torch.int32)}
    # the launch floor: the fastest launch the card takes in the same
    # loop, the least any kernel here can read
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    floors = {"sleep1": gpu_ms(lambda: torch.cuda._sleep(1), 50),
              "add1": gpu_ms(lambda: one.add_(1), 50)}
    floor_ms = min(floors.values())
    log("time launch floor", ms=f"{floor_ms:.4f}",
        **{k: f"{v:.4f}" for k, v in floors.items()})
    # what the card's memory gives a plain stream: a device copy of the
    # main path's coefficients, the bytes K2 moves
    copy_dst = torch.empty_like(coeffs)

    def copy():
        copy_dst.copy_(coeffs)

    log("time copy yardstick", bytes=4 * coeffs.numel(),
        ms=f"{gpu_ms(copy, 50):.4f}",
        ms_cold=f"{gpu_ms_cold(copy, 20, flush):.4f}")
    del copy_dst
    timed = {}
    for name, (kern, pl, nbytes, ops, ops_type) in work.items():
        rate = rates[ops_type]
        b_ms, b_by = bound(nbytes, ops, rate)
        timed[name] = {
            "ms": gpu_ms(kern, 50), "ms_cold": gpu_ms_cold(kern, 20, flush),
            "plain_ms": gpu_ms(pl, 5 if name != "count_scan" else 20),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": (gpu_ms(library[name], 50) if name in library
                           else None),
            "launch_floor_ms": floor_ms,
            "ops_type": ops_type,
            "bytes": nbytes, "ops": ops}
        t = timed[name]
        t["share"] = b_ms / t["ms"]
        t["share_cold"] = b_ms / t["ms_cold"]
        log("time kernel", name=name, ms=f"{t['ms']:.4f}",
            ms_cold=f"{t['ms_cold']:.4f}", plain_ms=f"{t['plain_ms']:.4f}",
            bound_ms=f"{b_ms:.4f}", bound_by=b_by,
            ops_ms=f"{ops / rate * 1e3:.4f}", ops_type=ops_type,
            share_warm=f"{t['share']:.3f}",
            share_cold=f"{t['share_cold']:.3f}", bytes=nbytes,
            launch_floor_ms=f"{floor_ms:.4f}",
            library_ms=("null" if t["library_ms"] is None
                        else f"{t['library_ms']:.4f}"))
    del flush
    dev_ms = gpu_ms(lambda: jk.decode_batch_420_packed_fused(
        buf, bmap, yq, cq, N, g, e, shapes, "rgba", "bt601", (H, W)), 20)
    plain_dev_ms = gpu_ms(lambda: jk.decode_batch_420(
        jk.unpack_coeffs(counts, ks, vals, bmap, nblocks), yq, cq, shapes,
        "rgba", "bt601", (H, W)), 3)
    mp = N * H * W / 1e6
    trace.reset()
    trace.enable()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        decode_batch(srcs, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    trace.enable(False)
    stages = {k: round(v["mean"] * 1e3, 3) for k, v in trace.report().items()}
    wall = sorted(walls)[len(walls) // 2]
    log("time path", megapixels=mp, device_ms=f"{dev_ms:.4f}",
        device_busy_share=f"{dev_ms / (wall * 1e3):.4f}",
        device_pipeline_mps=f"{mp / dev_ms * 1e3:.1f}",
        plain_device_ms=f"{plain_dev_ms:.4f}",
        end_to_end_ms=f"{wall * 1e3:.3f}",
        end_to_end_ms_runs=json.dumps([round(w * 1e3, 3) for w in walls]).replace(" ", ""),
        jpeg_1080p_420_decode_end_to_end_mps=f"{mp / wall:.2f}",
        host_entropy_packed_mps=f"{mp / (stages['torch.host_parse'] / 1e3):.2f}",
        stage_ms=json.dumps(stages).replace(" ", ""))

    codec_timed, path_launches = codec_paths(dev, jpegs, floor_ms, errs)
    png_timed, png_launches, pngs = png_paths(dev, jpegs, floor_ms, errs)
    timed["scatter_plane"], sparse_launches = sparse_path(
        dev, srcs, plain, floor_ms, errs)
    timed.update(png_timed)
    entropy_timed, entropy_launches = entropy_paths(dev, jpegs, plain,
                                                    floor_ms, errs)
    timed.update(entropy_timed)
    webp_timed, webp_launches = webp_paths(dev, jpegs, pngs, floor_ms, errs)
    timed.update(webp_timed)
    wave_timed, wave_launches = wavefront_paths(dev, floor_ms, errs)
    timed.update(wave_timed)
    heif_timed, heif_launches = heif_paths(dev, jpegs, floor_ms, errs)
    timed.update(heif_timed)
    config5_timed, config5_launches, x_config5 = config5_paths(
        dev, out, srcs, floor_ms, errs)
    timed.update(config5_timed)
    host_launches = host_codec_paths(dev, f'"{smi}"', errs)
    inter_timed, inter_launches = hevc_inter_paths(dev, f'"{smi}"', floor_ms,
                                                   errs)
    train_launches = train_paths(
        dev, f'"{smi}"', x_config5, {"srcs": srcs, "coeffs": coeffs_p,
                                    "yq": yq, "cq": cq, "shapes": shapes})
    del x_config5
    still_launches = still_codec_paths(dev, f'"{smi}"', errs)
    avif_launches = avif_paths(dev, f'"{smi}"', errs)

    # the instances the paths run: bt601, rgba (and fancy for K4), K6 at 4
    # bytes a pixel, K7 for 8-bit RGBA
    built = {"assemble_color": "assemble_color<1,0>",
             "unfilter_subup": "unfilter_subup<4>",
             "scatter_plane": "scatter_planes",
             "assemble_mcu": "assemble_mcu<1,0,1>",
             "assemble_rgba": "assemble_rgba<6,8>",
             "hevc_yuv_to_rgba": "hevc_yuv_to_rgba<1>",
             "resize_rgba": "resize<0,2>",
             "normalize_resize": "resize<1,2>"}
    # each kernel's launches on the path it serves: decode_batch for
    # K1a-K3, load for K4, encode for K5, PNG load (Sub/Up file) for K6
    # and K7, the sparse route for K8; K2's on load beside them
    launches["assemble_mcu"] = path_launches["load"]["assemble_mcu"]
    launches["fdct"] = path_launches["encode"]["fdct"]
    launches["unfilter_subup"] = png_launches["load"]["unfilter_subup"]
    launches["assemble_rgba"] = png_launches["load"]["assemble_rgba"]
    launches["scatter_plane"] = sparse_launches["scatter_plane"]
    # K9 on the dri batch with every member on the card, K10 and K11 on
    # the spec batch; K9's hybrid, mixed and spec launches beside them
    launches["entropy_decode"] = \
        entropy_launches["dri_batch"]["entropy_decode"]
    launches["spec_scan"] = entropy_launches["spec_batch"]["spec_scan"]
    launches["spec_merge"] = entropy_launches["spec_batch"]["spec_merge"]
    timed["entropy_decode"]["launches_per_path"] = {
        k: v["entropy_decode"] for k, v in entropy_launches.items()}
    # K12 on the 1080p load under FFPIC_VP8_DEVICE, K13 on the 8 x 1080p
    # WebP batch under FFPIC_VP8_DEVICE_COLOR (one launch over the 8);
    # their other paths beside
    launches["vp8_residuals"] = \
        webp_launches["load_vp8_device"]["vp8_residuals"]
    launches["vp8_yuv_to_rgba"] = webp_launches["batch"]["vp8_yuv_to_rgba"]
    for name in ("vp8_residuals", "vp8_yuv_to_rgba"):
        timed[name]["launches_per_path"] = {
            k: v[name] for k, v in webp_launches.items()}
    # K14 on the 12 MP fixture's load under FFPIC_HEVC_DEVICE, K15 on its
    # load under FFPIC_HEIF_DEVICE_COLOR (each one launch over the grid's
    # tiles); their other paths beside
    launches["hevc_residuals"] = \
        heif_launches["load_hevc_device"]["hevc_residuals"]
    launches["hevc_yuv_to_rgba"] = \
        heif_launches["load_device_color"]["hevc_yuv_to_rgba"]
    for name in ("hevc_residuals", "hevc_yuv_to_rgba"):
        timed[name]["launches_per_path"] = {
            k: v[name] for k, v in heif_launches.items()}
        # the inter slice's runs: K14 once a picture, K15 once a frame
        timed[name]["launches_inter"] = {
            k: v[name] for k, v in inter_launches.items()}
        timed[name]["at_inter_1080p"] = inter_timed[name]
    # K16 and K17 on config 5's path: decode_batch(size=) (one launch over
    # the slots), then normalize_for_model
    # K18 on make_wavefront of the 1080p frame, and in the K12 -> K18 chain
    launches["vp8_wavefront"] = wave_launches["path"]["vp8_wavefront"]
    timed["vp8_wavefront"]["launches_chain"] = \
        wave_launches["chain"]["vp8_wavefront"]
    launches["resize_rgba"] = config5_launches["resize_rgba"]
    launches["normalize_resize"] = config5_launches["normalize_resize"]
    for name in ("unfilter_subup", "assemble_rgba"):
        timed[name]["launches_mixed_decode_batch"] = \
            png_launches["mixed"][name]
    timed["dequant_idct"]["at_load_12mp"] = codec_timed.pop("dequant_idct")
    timed["dequant_idct"]["at_load_12mp"]["launches"] = \
        path_launches["load"]["dequant_idct"]
    timed.update(codec_timed)
    # the host codecs' phase: K2 and K4 on the TIFF's JPEG strips, K6 and
    # K7 on the ICO's PNG entry, K16 and K17 on the 8 x 1080p batch
    for name, path in (("dequant_idct", "tiff_jpeg"),
                       ("assemble_mcu", "tiff_jpeg"),
                       ("unfilter_subup", "ico_png_bmp"),
                       ("assemble_rgba", "ico_png_bmp"),
                       ("resize_rgba", "batch"),
                       ("normalize_resize", "batch")):
        timed[name]["launches_host_codecs"] = host_launches[path][name]
    # the still codecs' phase: K16 and K17 on the 8 x 1080p batch
    for name in ("resize_rgba", "normalize_resize"):
        timed[name]["launches_still_codecs"] = \
            still_launches["batch"][name]
    # the AVIF phase: K16 and K17 on the 8 x 1080p batch
    for name in ("resize_rgba", "normalize_resize"):
        timed[name]["launches_avif"] = avif_launches["batch"][name]
    # the mesh paths (a world of one over NCCL) and the graft entry: K2
    # and K3 once each
    for name in ("dequant_idct", "assemble_color"):
        timed[name]["launches_mesh"] = {
            k: v[name] for k, v in train_launches.items()}
    # the instance each K16 method's launcher took at config 5
    for info in timed["resize_rgba"]["methods"].values():
        info["ptxas"] = ptxas[info["kernel"]]
    kernels = [{"name": name, "route": "cuda",
                "source": SOURCES.get(name, CU),
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": errs[name], **timed[name],
                "ptxas": ptxas[built.get(name, name)]}
               for name in REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
