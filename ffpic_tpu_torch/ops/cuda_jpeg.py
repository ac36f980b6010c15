"""ctypes wrappers of the CUDA kernels in ``csrc/jpeg_decode.cu`` (K1a
``count_scan``, K1b ``unpack``, K2 ``dequant_idct``, K3 ``assemble_color``,
K8 ``scatter_planes``) and ``csrc/jpeg_codec.cu`` (K4 ``assemble_mcu``, K5
``fdct``).

Each wrapper takes CUDA tensors only: it checks device, dtype, shape
and contiguity, raises on anything else, allocates its output with
``torch.empty``, launches on the current stream and raises if the
launch reports an error.  It does not synchronise.  ``launches`` counts
the launches of each kernel, so a run can show which kernels its path
went through.  The plain PyTorch version of each kernel lives in
``ops.jpeg_kernels``; the kernels never run on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from ffpic_tpu_torch.ops import _build

launches = {"count_scan": 0, "unpack": 0, "dequant_idct": 0,
            "assemble_color": 0, "assemble_mcu": 0, "fdct": 0,
            "scatter_plane": 0}

MODES = {"reference": 0, "bt601": 1, "rgb": 2}
ORDERS = {"rgba": 0, "bgra": 1}

_vp = ctypes.c_void_p
_int = ctypes.c_int
_i64 = ctypes.c_longlong
_SIGNATURES = {
    "ffpic_count_scan": [_vp, _vp, _int, _int, _int, _vp],
    "ffpic_unpack": [_vp, _vp, _vp, _vp, _int, _int, _int, _int, _int,
                     _vp],
    "ffpic_dequant_idct": [_vp, _vp, _vp, _vp, _int, _int, _int, _int, _vp],
    "ffpic_assemble_color": [_vp, _vp, _int, _int, _int, _int, _int, _int,
                             _int, _vp],
    "ffpic_assemble_mcu": [ctypes.POINTER(_i64), _int, _int, _vp, _int, _int,
                           _int, _int, _int, _vp],
    "ffpic_fdct": [_vp, _vp, _i64, _int, _vp],
    "ffpic_scatter_planes": [ctypes.POINTER(_i64), _int, _vp, _int, _i64, _vp,
                             _int, _vp],
}
_launch = _build.launcher(_SIGNATURES, launches)
_INT_MAX = 2 ** 31 - 1
_GRID_MAX = 65535           # an image index is a grid y or z coordinate

# The kernels' tilings, which the C entries of csrc/ check against their
# own constants and refuse when they differ: K1a spreads each image over
# a cluster of SCAN_CLUSTER CTAs (kScanCluster), K1b gives a CTA
# UNPACK_TILE consecutive packed blocks of an image (kUnpackTile), K2
# IDCT_TILE blocks (kIdctTile), K5 FDCT_TILE blocks (kFdctTile)
SCAN_CLUSTER = 8
UNPACK_TILE = 64
IDCT_TILE = 32
FDCT_TILE = 32
# K8's cooperative grid: at most 2048 threads an SM, 256 a CTA
SCATTER_CTAS_PER_SM = 8


def count_scan_ranges(n: int, g: int) -> torch.Tensor:
    """(n, SCAN_CLUSTER, 2) int64: the [lo, hi) range of an image's
    counts (indices within its row) that each CTA of K1a's cluster
    scans, as the kernel cuts it -- the 16-byte words that cover the
    row ``[i*g, i*g + g)`` of the flat counts, in SCAN_CLUSTER runs of
    ``ceil(words / SCAN_CLUSTER)``, each clipped to the row.  A rank
    past the last word gets an empty range at g."""
    s = torch.arange(n, dtype=torch.int64) * g
    t = s + g
    w0, w1 = s // 16, (t + 15) // 16
    run = (w1 - w0 + SCAN_CLUSTER - 1) // SCAN_CLUSTER
    rank = torch.arange(SCAN_CLUSTER, dtype=torch.int64)
    wa = torch.minimum(w0[:, None] + rank * run[:, None], w1[:, None])
    wb = torch.minimum(wa + run[:, None], w1[:, None])
    lo = torch.clamp(torch.maximum(16 * wa, s[:, None]), max=t[:, None])
    hi = torch.minimum(16 * wb, t[:, None])
    return torch.stack([lo, torch.maximum(hi, lo)], dim=-1) - s[:, None, None]


def unpack_entry_ranges(starts: torch.Tensor, counts: torch.Tensor,
                        e: int) -> torch.Tensor:
    """(n, ceil(g / UNPACK_TILE), 2) int64: the [lo, hi) range of
    packed entries that each CTA of K1b stages and scatters, as the
    kernel computes it -- from the start of the tile's first block to
    the end of its last (a part-full last tile when UNPACK_TILE does not
    divide g), clipped to [0, e).  On any device."""
    g = starts.shape[1]
    first = torch.arange(0, g, UNPACK_TILE, device=starts.device)
    last = torch.clamp(first + UNPACK_TILE, max=g) - 1
    s = starts.to(torch.int64)
    lo = s[:, first].clamp(max=e)
    hi = (s[:, last] + counts[:, last].to(torch.int64)).clamp(max=e)
    return torch.stack([lo, hi], dim=-1)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check(t: torch.Tensor, name: str, dtype: torch.dtype,
           shape: tuple | None = None) -> None:
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got "
                         f"{getattr(t, 'device', type(t))}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def count_scan(buf: torch.Tensor, n: int, g: int) -> torch.Tensor:
    """K1a: exclusive scan of the (n, g) uint8 counts at the head of the
    fused packed buffer -> (n, g) int32 block starts, one cluster of
    SCAN_CLUSTER CTAs per image (``count_scan_ranges``)."""
    if not (0 < n <= _GRID_MAX and 0 < g and n * g <= _INT_MAX):
        raise ValueError(f"{n}x{g} counts: one launch takes 1..{_GRID_MAX} "
                         "images of g > 0 counts")
    _check(buf, "buf", torch.uint8)
    if buf.numel() < n * g:
        raise ValueError(f"buf of {buf.numel()} bytes cannot hold {n}x{g} "
                         "counts")
    starts = torch.empty((n, g), dtype=torch.int32, device=buf.device)
    _launch("ffpic_count_scan", "count_scan", _vp(buf.data_ptr()),
            _vp(starts.data_ptr()), n, g, SCAN_CLUSTER)
    return starts


def unpack(buf: torch.Tensor, starts: torch.Tensor, block_map: torch.Tensor,
           n: int, g: int, e: int, nblocks: int) -> torch.Tensor:
    """K1b: fused packed buffer (n*(g + 3e) bytes) -> dense de-zigzagged
    coefficients (n, nblocks, 8, 8) int16, one CTA per tile of
    UNPACK_TILE packed blocks (``unpack_entry_ranges``).  ``block_map``
    (g,) int32 must be a permutation of range(nblocks), as
    ``formats.jpg.packed_block_map`` gives for an interleaved scan."""
    _check(buf, "buf", torch.uint8, (n * (g + 3 * e),))
    _check(starts, "starts", torch.int32, (n, g))
    _check(block_map, "block_map", torch.int32, (g,))
    if g != nblocks or buf.numel() > _INT_MAX:
        raise ValueError(f"block_map covers {g} blocks, the image {nblocks}")
    if not 0 < n <= _GRID_MAX:
        raise ValueError(f"n={n} images: one launch takes 1..{_GRID_MAX}")
    out = torch.empty((n, nblocks, 8, 8), dtype=torch.int16,
                      device=buf.device)
    _launch("ffpic_unpack", "unpack", _vp(buf.data_ptr()),
            _vp(starts.data_ptr()), _vp(block_map.data_ptr()),
            _vp(out.data_ptr()), n, g, e, nblocks, UNPACK_TILE)
    return out


def dequant_idct(coeffs: torch.Tensor, yquant: torch.Tensor,
                 cquant: torch.Tensor, n_luma: int,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """K2: (n, nblocks, 8, 8) int16 coefficients -> int16 samples, one
    CTA per IDCT_TILE blocks of an image.  Blocks below ``n_luma`` in
    each image take that image's row of ``yquant`` (n, 64) int32, the
    rest its row of ``cquant``.  ``out``, when given, is a contiguous
    int16 tensor of the coefficients' shape that receives the samples
    (a view of a larger buffer, so that per-component launches fill one
    image)."""
    if coeffs.dim() != 4 or tuple(coeffs.shape[2:]) != (8, 8):
        raise ValueError(f"coeffs: expected (n, nblocks, 8, 8), got "
                         f"{tuple(coeffs.shape)}")
    n, nblocks = coeffs.shape[:2]
    if n > _GRID_MAX:
        raise ValueError(f"n={n} images: one launch takes 1..{_GRID_MAX}")
    _check(coeffs, "coeffs", torch.int16)
    _check(yquant, "yquant", torch.int32, (n, 64))
    _check(cquant, "cquant", torch.int32, (n, 64))
    if not 0 <= n_luma <= nblocks or n * nblocks > _INT_MAX // 64:
        raise ValueError(f"n_luma {n_luma} outside [0, {nblocks}]")
    if out is None:
        out = torch.empty_like(coeffs)
    else:
        _check(out, "out", torch.int16, tuple(coeffs.shape))
    if out.numel():
        _launch("ffpic_dequant_idct", "dequant_idct", _vp(coeffs.data_ptr()),
                _vp(yquant.data_ptr()), _vp(cquant.data_ptr()),
                _vp(out.data_ptr()), n, nblocks, n_luma, IDCT_TILE)
    return out


def assemble_color(samples: torch.Tensor, nby: int, nbx: int,
                   order: str = "rgba", mode: str = "reference",
                   hw: tuple[int, int] | None = None) -> torch.Tensor:
    """K3: (n, nblocks, 8, 8) int16 samples of a 4:2:0 block grid with
    nby x nbx luma blocks -> (n, h, w, 4) uint8, cropped to ``hw`` =
    (h, w), at most and by default (8 nby, 8 nbx)."""
    if order not in ORDERS or mode not in MODES:
        raise ValueError(f"order {order!r} / mode {mode!r}")
    if nby % 2 or nbx % 2 or nby <= 0 or nbx <= 0:
        raise ValueError(f"4:2:0 needs an even luma block grid, got "
                         f"{nby}x{nbx}")
    h, w = hw or (8 * nby, 8 * nbx)
    if not (0 < h <= 8 * nby and 0 < w <= 8 * nbx):
        raise ValueError(f"crop {h}x{w} outside the {8 * nby}x{8 * nbx} grid")
    n = samples.shape[0] if samples.dim() == 4 else -1
    nblocks = nby * nbx + 2 * (nby // 2) * (nbx // 2)
    _check(samples, "samples", torch.int16, (n, nblocks, 8, 8))
    if n > _GRID_MAX or nby > _GRID_MAX:
        raise ValueError("batch too large for one launch")
    out = torch.empty((n, h, w, 4), dtype=torch.uint8, device=samples.device)
    if n:
        _launch("ffpic_assemble_color", "assemble_color",
                _vp(samples.data_ptr()), _vp(out.data_ptr()), n, nby, nbx,
                h, w, MODES[mode], ORDERS[order])
    return out


def assemble_mcu(samples: torch.Tensor, shapes, samplings, out_h: int,
                 out_w: int, order: str = "bgra", mode: str = "reference",
                 gray_chroma: int = 128,
                 upsample: str = "nearest") -> torch.Tensor:
    """K4: one image's int16 samples (nblocks, 8, 8), 1 or 3 components
    in frame order with block grids ``shapes`` ((nby, nbx) each) and
    luma-relative factors ``samplings`` ((v, h) each) -> (out_h, out_w,
    4) uint8, as ``jpeg_kernels.assemble_mcu``.  ``out_w`` must be a
    multiple of 8 (a JPEG's 8-aligned width); fancy upsampling takes
    factors 1 and 2 only."""
    ncomp = len(shapes)
    if ncomp not in (1, 3) or len(samplings) != ncomp:
        raise ValueError(f"unsupported component count {ncomp} (want 1 or "
                         "3, with a sampling each)")
    if order not in ORDERS or mode not in MODES:
        raise ValueError(f"order {order!r} / mode {mode!r}")
    if upsample not in ("nearest", "fancy"):
        raise ValueError(f"upsample {upsample!r}")
    fancy = upsample == "fancy"
    if not (0 < out_h <= 8 * _GRID_MAX and 0 < out_w and out_w % 8 == 0):
        raise ValueError(f"output {out_h}x{out_w}: the width must be a "
                         "positive multiple of 8")
    if not -32768 <= gray_chroma <= 32767:
        raise ValueError(f"gray_chroma {gray_chroma} outside int16")
    geometry = []
    for (nby, nbx), (v, h) in zip(shapes, samplings):
        if v < 1 or h < 1 or (fancy and (v > 2 or h > 2)):
            raise ValueError(f"factor {v}x{h}: fancy upsampling takes 1 "
                             "and 2, nearest any positive integer")
        ph, pw = -(-out_h // v), -(-out_w // h)
        if ph > 8 * nby or pw > 8 * nbx:
            raise ValueError(f"a {nby}x{nbx}-block plane does not cover "
                             f"{out_h}x{out_w} at factor {v}x{h}")
        geometry.append((nby * nbx, nbx, v, h, ph, pw))
    _check(samples, "samples", torch.int16,
           (sum(g[0] for g in geometry), 8, 8))
    rows, off = [], 0
    for nblocks, *rest in geometry:
        rows += [samples.data_ptr() + 128 * off, *rest]
        off += nblocks
    out = torch.empty((out_h, out_w, 4), dtype=torch.uint8,
                      device=samples.device)
    _launch("ffpic_assemble_mcu", "assemble_mcu", (_i64 * len(rows))(*rows),
            ncomp, gray_chroma, _vp(out.data_ptr()), out_h, out_w,
            MODES[mode], ORDERS[order], int(fancy))
    return out


def fdct(samples: torch.Tensor) -> torch.Tensor:
    """K5: (..., 8, 8) int16 level-shifted samples -> int16 forward-DCT
    coefficients, one CTA per FDCT_TILE blocks."""
    if samples.dim() < 2 or tuple(samples.shape[-2:]) != (8, 8):
        raise ValueError(f"samples: expected (..., 8, 8), got "
                         f"{tuple(samples.shape)}")
    _check(samples, "samples", torch.int16)
    out = torch.empty_like(samples)
    if out.numel():
        _launch("ffpic_fdct", "fdct", _vp(samples.data_ptr()),
                _vp(out.data_ptr()), out.numel() // 64, FDCT_TILE)
    return out


def scatter_planes(packed, out: torch.Tensor, sizes) -> torch.Tensor:
    """K8: rebuild 1 to 3 planes of ``out``, an (n, B, 8, 8) int16 CUDA
    tensor (each image's blocks contiguous, 16-byte aligned, the image
    stride a multiple of 8), in one launch: plane c takes the ``sizes[c]``
    blocks after the planes before it, set to the sum of its packed
    pairs ``packed[c]`` = (idx int32, val int16, 1-D of one length) at
    their flat indices into its n * sizes[c] * 64 coefficients, as
    ``jpeg_kernels.scatter_plane``; blocks past the planes are left as
    they are.  Returns ``out``."""
    if out.dim() != 4 or tuple(out.shape[2:]) != (8, 8):
        raise ValueError(f"out: expected (n, B, 8, 8), got "
                         f"{tuple(out.shape)}")
    n, nbt = out.shape[:2]
    sizes = [int(nb) for nb in sizes]
    if not 1 <= len(packed) <= 3 or len(sizes) != len(packed) or \
            min(sizes) <= 0 or sum(sizes) > nbt:
        raise ValueError(f"{len(packed)} planes of {sizes} blocks: expected "
                         f"1 to 3 planes, of a size each, within {nbt} blocks")
    tensors = [(out, "out", torch.int16)]
    for c, (idx, val) in enumerate(packed):
        tensors += [(idx, f"idx[{c}]", torch.int32),
                    (val, f"val[{c}]", torch.int16)]
    for t, name, dtype in tensors:
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor, got "
                             f"{getattr(t, 'device', type(t))}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
        if t.device != out.device:
            raise ValueError(f"{name}: on {t.device}, out on {out.device}")
    for c, (idx, val) in enumerate(packed):
        if idx.dim() != 1 or tuple(val.shape) != tuple(idx.shape) or \
                not (idx.is_contiguous() and val.is_contiguous()):
            raise ValueError(f"idx[{c}] {tuple(idx.shape)} / val[{c}] "
                             f"{tuple(val.shape)}: expected contiguous 1-D "
                             "pairs of one length")
    pitch = out.stride(0) if n > 1 else nbt * 64
    if out.stride()[1:] != (64, 8, 1) or out.data_ptr() % 16 or pitch % 8 \
            or pitch < nbt * 64:
        raise ValueError("out: each image's blocks must be contiguous, the "
                         "tensor 16-byte aligned and its image stride a "
                         "multiple of 8")
    if not 0 < n <= _GRID_MAX:
        raise ValueError(f"n={n} images: one launch takes 1..{_GRID_MAX}")
    words, first = [], 0
    for (idx, val), nb in zip(packed, sizes):
        words += [idx.data_ptr(), val.data_ptr(), idx.numel(), nb, first]
        first += nb
    dev = out.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # a flag a CTA of the cooperative grid, at most SCATTER_CTAS_PER_SM
    # an SM; the kernel needs them unzeroed
    flags = torch.empty(sms * SCATTER_CTAS_PER_SM, dtype=torch.int32,
                        device=dev)
    _launch("ffpic_scatter_planes", "scatter_plane",
            (_i64 * len(words))(*words), len(packed), _vp(out.data_ptr()), n,
            pitch, _vp(flags.data_ptr()), flags.numel())
    return out


def scatter_plane(idx: torch.Tensor, val: torch.Tensor,
                  out: torch.Tensor) -> torch.Tensor:
    """K8 on one plane: ``out``, an (n, nb, 8, 8) int16 CUDA tensor
    (contiguous, or the slot of one plane in a larger (n, B, 8, 8)
    buffer, 16-byte aligned), set to the sum of the packed pairs at
    their flat indices into its n * nb * 64 coefficients, as
    ``jpeg_kernels.scatter_plane``; returns ``out``.  ``idx`` int32 and
    ``val`` int16 are 1-D, of one length."""
    if out.dim() != 4:
        raise ValueError(f"out: expected (n, nb, 8, 8), got "
                         f"{tuple(out.shape)}")
    return scatter_planes([(idx, val)], out, [out.shape[1]])
