"""HEVC device stages: the residual transform of every TU of a picture
(8.6.3 dequant, then the 2-D inverse DCT of 4 to 32 points or the
4-point DST, or the transform-skip scaling, or the bypass copy) and the
HEIF colour (nearest 2x chroma, crop, YCbCr -> RGBA).

The PyTorch counterpart of ``ffpic_tpu/ops/hevc_kernels.py``.  It holds

* the plain PyTorch version of each stage: ``dequant_itransform_batch``
  and ``dequant_skip_batch`` (the reference's functions of the same
  names, one TU-size bucket each), ``hevc_residuals_plain`` (K14's
  function: every TU of the native flat layout at once),
  ``hevc_yuv_to_rgba_plain`` (a tile's colour: the branch of
  ``ffpic_tpu/formats/heif.py:356-371``) and ``hevc_tiles_to_rgba_plain``
  (K15's: the canvas built as ``heif._decode_grid`` builds it, every
  tile pasted in order through ``hevc_yuv_to_rgba_plain``).  They run on
  any device and are the reference the CUDA kernels are held against;
* ``plan_residuals``, the host side of K14's launch: each TU's level
  offset and flags in launch order (largest TUs first) and the work of
  each CTA, all from vectorised index arrays (no Python loop over TUs);
  ``stage_residuals`` packs it with the levels of one picture or of
  several (a HEIF grid's tiles) into one host-to-device copy;
* ``stage_tiles``, the host side of K15's launch: every tile's planes,
  a descriptor a tile and the canvas cut into cells at every tile edge
  (``tile_cells``), in one host-to-device copy;
* the entries the codec calls: ``residuals_packed`` and
  ``residuals_for_ops`` (named as the reference's), ``residuals_grid``
  (several pictures' TUs in one launch), ``hevc_residuals`` and
  ``hevc_tiles_to_rgba``.  They dispatch on the tensor's device: a
  CPU tensor takes the plain version, a CUDA tensor the kernel of
  ``ops.cuda_hevc`` (which raises rather than falls back).

Every stage of the residual transform is integer and bit-exact with
the JAX package, whose hi/lo float split (``_exact_matmul_i16``) is
exact integer arithmetic: the plain version takes its products in
float64, exact at these magnitudes (at most 32768 * 90 * 32 a sum), so
that it runs on CUDA too, where integer matmul is not implemented.
Dequant keeps the reference's pre-clip and floor semantics of ``%``,
``//`` and ``>>``.  Like the reference, the device route takes flat
scaling (m = 16) whatever the TU's scaling list: a stream with scaling
lists decodes differently under ``FFPIC_HEVC_DEVICE`` than on the host
route, in both packages (``ROADMAP.md`` Queue 3).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ffpic_tpu_torch.coding.hevc_consts import DST4, LEVEL_SCALE, dct_matrix
from ffpic_tpu_torch.ops.jpeg_kernels import _on_cuda, color_convert
from ffpic_tpu_torch.utils import trace
from ffpic_tpu_torch.utils.device import resolve_device

# TU sizes as log2: 4, 8, 16 and 32 points
_LOG2 = {4: 2, 8: 3, 16: 4, 32: 5}
# K14's CTAs have 128 threads, n of them a TU of n points: 32 TUs of
# 4x4, 16 of 8x8, 8 of 16x16 or 4 of 32x32
CTA_THREADS = 128
# the flags of a TU's descriptor word, above its QP (bits 0-7)
SKIP, BYPASS, DST = 1 << 8, 1 << 9, 1 << 10
# the largest QP a TU carries: 51 + QpBdOffset at 14 bits (at 16 bits
# the reference's int32 dequant bound overflows)
MAX_QP = 51 + 6 * (14 - 8)
BIT_DEPTHS = range(8, 15)


# --- plain versions --------------------------------------------------------

def _dequant(levels: torch.Tensor, qps: torch.Tensor, n: int,
             bit_depth: int) -> torch.Tensor:
    """8.6.3 with flat scaling, batched (``hevc_kernels.py:65``):
    levels (B, n, n), qps (B,) -> int64 (B, n, n) clipped to 16 bits.
    The pre-clip keeps each product where the reference's int32 holds
    it, without changing the saturated result."""
    bd_shift = bit_depth + _LOG2[n] - 5
    ls = torch.tensor(LEVEL_SCALE, dtype=torch.int64, device=levels.device)
    qp = qps.to(torch.int64)
    scale = (16 * ls[torch.remainder(qp, 6)]) << torch.div(
        qp, 6, rounding_mode="floor")
    scale = scale[:, None, None]
    bound = torch.div(32768 << bd_shift, scale, rounding_mode="floor") + 1
    lv = torch.maximum(torch.minimum(levels.to(torch.int64), bound), -bound)
    d = (lv * scale + (1 << (bd_shift - 1))) >> bd_shift
    return d.clamp(-32768, 32767)


def _matrix(n: int, dst: bool, device) -> torch.Tensor:
    m = DST4 if dst else dct_matrix(n)
    return torch.tensor(np.asarray(m, np.float64), device=device)


def _transform(d: torch.Tensor, n: int, dst: bool,
               bit_depth: int) -> torch.Tensor:
    """2-D inverse transform of int64 (B, n, n) dequantised blocks: the
    column pass e[y][x] = sum_j M[j][y] d[j][x], (e + 64) >> 7 clipped,
    then the row pass r[y][x] = sum_j M[j][x] e[y][j] at 20 - bd."""
    m = _matrix(n, dst, d.device)
    e = torch.einsum("jy,bjx->byx", m, d.to(torch.float64)).to(torch.int64)
    e = ((e + 64) >> 7).clamp(-32768, 32767)
    shift2 = 20 - bit_depth
    r = torch.einsum("byj,jx->byx", e.to(torch.float64), m).to(torch.int64)
    return ((r + (1 << (shift2 - 1))) >> shift2).clamp(-32768, 32767)


def _skip(d: torch.Tensor, bit_depth: int) -> torch.Tensor:
    shift2 = 20 - bit_depth
    return (((d << 7) + (1 << (shift2 - 1))) >> shift2).clamp(-32768, 32767)


def dequant_itransform_batch(levels: torch.Tensor, qps: torch.Tensor, n: int,
                             bit_depth: int = 8,
                             dst: bool = False) -> torch.Tensor:
    """Batched dequant + 2-D inverse transform (8.6.3 + 8.6.4.1,
    ``hevc_kernels.py:80``): levels (B, n, n) TransCoeffLevel [y][x],
    qps (B,) -> (B, n, n) int32 residuals."""
    d = _dequant(levels, qps, n, bit_depth)
    return _transform(d, n, dst, bit_depth).to(torch.int32)


def dequant_skip_batch(levels: torch.Tensor, qps: torch.Tensor, n: int,
                       bit_depth: int = 8) -> torch.Tensor:
    """Batched dequant + transform-skip scaling (``hevc_kernels.py:104``):
    r = ((d << 7) + round) >> (20 - bd), clipped; int32."""
    return _skip(_dequant(levels, qps, n, bit_depth), bit_depth) \
        .to(torch.int32)


def hevc_residuals_plain(tu_meta: torch.Tensor, levels: torch.Tensor,
                         bit_depth: int) -> torch.Tensor:
    """K14's function over the native flat layout: ``tu_meta`` (m, 8)
    int32 rows (x, y, n, cidx, skip, bypass, qp, dst), ``levels`` int16
    packed per TU in row order (exactly the TUs' n² sum) -> int16
    residuals in the same layout, one per level of the TUs.  A bypass TU's
    residual is its levels; a skip TU takes ``dequant_skip_batch``,
    any other ``dequant_itransform_batch`` (the DST where ``dst``)."""
    meta = tu_meta.to(torch.int64)
    n2 = meta[:, 2] ** 2
    offs = torch.cumsum(n2, 0) - n2          # where each TU's levels start
    need = int(n2.sum())
    if levels.numel() != need:
        raise ValueError(f"{levels.numel()} levels for TUs of {need}")
    out = torch.empty(need, dtype=torch.int16, device=levels.device)
    for n in (4, 8, 16, 32):
        idx = torch.nonzero(meta[:, 2] == n).flatten()
        if idx.numel() == 0:
            continue
        pos = offs[idx][:, None] + torch.arange(n * n, device=levels.device)
        lv = levels[pos].to(torch.int64).view(-1, n, n)
        row = meta[idx]
        d = _dequant(lv, row[:, 6], n, bit_depth)
        res = _transform(d, n, False, bit_depth)
        if n == 4:
            is_dst = (row[:, 7] != 0)[:, None, None]
            res = torch.where(is_dst, _transform(d, 4, True, bit_depth), res)
        res = torch.where((row[:, 4] != 0)[:, None, None],
                          _skip(d, bit_depth), res)
        res = torch.where((row[:, 5] != 0)[:, None, None], lv, res)
        out[pos.flatten()] = res.flatten().to(torch.int16)
    return out


def hevc_yuv_to_rgba_plain(Y: torch.Tensor, U: torch.Tensor | None,
                           V: torch.Tensor | None, out_h: int, out_w: int,
                           mode: str = "bt601", out: torch.Tensor | None = None,
                           y0: int = 0, x0: int = 0) -> torch.Tensor:
    """K15's function (``ffpic_tpu/formats/heif.py:356-371``): int16 luma
    Y (H, W) and chroma U, V (at least ((H + 1) // 2, (W + 1) // 2)), or
    U = V = None for 4:0:0 (chroma 128) -> RGBA uint8 of the top-left
    (out_h, out_w), chroma by nearest 2x lookup (y >> 1, x >> 1), colour
    by ``jpeg_kernels.color_convert`` in ``mode`` ("reference", "bt601"
    or "rgb"), alpha 255.  Returns a new (out_h, out_w, 4) tensor, or,
    with ``out``, writes the part that fits into ``out`` (CH, CW, 4) at
    row ``y0``, column ``x0`` and returns ``out``."""
    if out is not None:
        out_h = min(out_h, out.shape[0] - y0)
        out_w = min(out_w, out.shape[1] - x0)
    y = Y[:out_h, :out_w]
    if U is None:
        u = v = torch.full_like(y, 128)
    else:
        ry = torch.arange(out_h, device=Y.device) >> 1
        rx = torch.arange(out_w, device=Y.device) >> 1
        u = U[ry][:, rx]
        v = V[ry][:, rx]
    rgba = color_convert(y, u, v, order="rgba", mode=mode)
    if out is None:
        return rgba
    out[y0:y0 + out_h, x0:x0 + out_w] = rgba
    return out


# --- K15: every tile of a picture in one launch ------------------------------

TILE_DESC = 8        # int32 a tile: Y, U, V offsets, pitches, y0, x0, 0
_ALIGN = 8           # int16 elements: each staged plane starts 16-byte aligned


@dataclass
class StagedTiles:
    """A picture's tiles staged for K15 in one host-to-device copy.
    ``planes``: the int16 buffer on the device, every tile's Y, U and V
    (each at a multiple of 8 elements, 16 bytes) then the index, whose
    int32 views are ``desc`` (T, 8): each tile's Y, U and V offsets in
    ``planes`` (U = V = -1 for 4:0:0), its luma and chroma row pitches,
    y0, x0 and 0; ``row_cell`` (H,), ``col_cell`` (W,) and ``cell_map``
    (R, C) of ``tile_cells``.  ``tiles``: each tile's ((Y, U, V) views,
    out_h, out_w, y0, x0) in paste order, for the plain version."""
    planes: torch.Tensor
    desc: torch.Tensor
    row_cell: torch.Tensor
    col_cell: torch.Tensor
    cell_map: torch.Tensor
    tiles: list


def tile_cells(spans, height: int, width: int):
    """The (height, width) canvas cut at every edge of the tiles
    ``spans`` ((y0, x0, out_h, out_w) each, in paste order, each cropped
    to the canvas; one that starts outside it covers nothing):
    ``row_cell`` (height,) and ``col_cell`` (width,) int32, the cell row
    and column of each pixel row and column, and ``cell_map`` (R, C)
    int32, the last tile that covers each cell, -1 where none does.  A
    cell lies wholly inside or outside each tile, so a pixel (y, x) has
    the colour of ``cell_map[row_cell[y], col_cell[x]]``, as
    ``heif._decode_grid``'s pastes in order leave it."""
    boxes = [(y0, x0, min(y0 + h, height), min(x0 + w, width))
             for y0, x0, h, w in spans]
    boxes = [(k, b) for k, b in enumerate(boxes)
             if b[0] < height and b[1] < width]
    yb = np.unique([0, height, *(v for _, b in boxes for v in b[0::2])])
    xb = np.unique([0, width, *(v for _, b in boxes for v in b[1::2])])
    row_cell = np.searchsorted(yb, np.arange(height), "right") - 1
    col_cell = np.searchsorted(xb, np.arange(width), "right") - 1
    cell_map = np.full((len(yb) - 1, len(xb) - 1), -1, np.int32)
    for k, (y0, x0, y1, x1) in boxes:
        r0, r1 = np.searchsorted(yb, (y0, y1))
        c0, c1 = np.searchsorted(xb, (x0, x1))
        cell_map[r0:r1, c0:c1] = k
    return row_cell.astype(np.int32), col_cell.astype(np.int32), cell_map


def _check_tile(ps, span, height: int, width: int) -> None:
    """A tile's planes hold the part of it that lands on the canvas."""
    y0, x0, oh, ow = span
    if min(y0, x0) < 0 or min(oh, ow) <= 0 or len(ps) not in (1, 3):
        raise ValueError(f"tile at ({y0}, {x0}) of {oh}x{ow} with "
                         f"{len(ps)} planes")
    h, w = min(oh, height - y0), min(ow, width - x0)
    if h <= 0 or w <= 0:
        return
    need = [(h, w)] + [((h + 1) // 2, (w + 1) // 2)] * (len(ps) - 1)
    for p, (r, c) in zip(ps, need):
        if p.ndim != 2 or p.shape[0] < r or p.shape[1] < c:
            raise ValueError(f"plane {p.shape}: the tile needs {r}x{c}")


def stage_tiles(planes, spans, height: int, width: int,
                device) -> StagedTiles:
    """The host side of a K15 launch: ``planes`` each tile's int16
    numpy planes ([Y] for 4:0:0, else [Y, U, V]), ``spans`` each tile's
    (y0, x0, out_h, out_w) on the (height, width) canvas, in paste
    order.  The planes (each padded to 16 bytes), the descriptors and
    the cells go to ``device`` in one copy, through pinned memory on
    CUDA."""
    if len(planes) != len(spans) or not planes or height <= 0 or width <= 0:
        raise ValueError(f"{len(planes)} tiles, {len(spans)} spans, canvas "
                         f"{height}x{width}")
    for ps, span in zip(planes, spans):
        _check_tile(ps, span, height, width)
    offsets, pos = [], 0
    for ps in planes:
        offsets.append([])
        for p in ps:
            offsets[-1].append(pos)
            pos += -(-p.size // _ALIGN) * _ALIGN
    row_cell, col_cell, cell_map = tile_cells(spans, height, width)
    t = len(planes)
    cuts = np.cumsum([0, t * TILE_DESC, height, width, cell_map.size])
    if pos + 2 * cuts[-1] >= 2 ** 31:
        raise ValueError("the tiles take more than 2**31 elements")
    host = torch.empty(pos + 2 * int(cuts[-1]), dtype=torch.int16,
                       pin_memory=device.type == "cuda")
    flat = host.numpy()
    for ps, offs in zip(planes, offsets):
        for p, at in zip(ps, offs):
            flat[at:at + p.size] = p.reshape(-1)
    index = flat[pos:].view(np.int32)
    desc = index[:cuts[1]].reshape(t, TILE_DESC)
    for k, (ps, offs, (y0, x0, _h, _w)) in enumerate(zip(planes, offsets,
                                                         spans)):
        u, v = (offs[1], offs[2]) if len(ps) == 3 else (-1, -1)
        desc[k] = (offs[0], u, v, ps[0].shape[1],
                   ps[1].shape[1] if len(ps) == 3 else 0, y0, x0, 0)
    index[cuts[1]:cuts[2]] = row_cell
    index[cuts[2]:cuts[3]] = col_cell
    index[cuts[3]:] = cell_map.reshape(-1)
    dev = host.to(device, non_blocking=True)
    dev_index = dev[pos:].view(torch.int32)
    tiles = []
    for ps, offs, (y0, x0, oh, ow) in zip(planes, offsets, spans):
        views = [dev[at:at + p.size].view(p.shape) for p, at in zip(ps, offs)]
        tiles.append(((*views, None, None)[:3], oh, ow, y0, x0))
    return StagedTiles(
        planes=dev, desc=dev_index[:cuts[1]].view(t, TILE_DESC),
        row_cell=dev_index[cuts[1]:cuts[2]],
        col_cell=dev_index[cuts[2]:cuts[3]],
        cell_map=dev_index[cuts[3]:].view(cell_map.shape), tiles=tiles)


def hevc_tiles_to_rgba_plain(st: StagedTiles, mode: str = "bt601"
                             ) -> torch.Tensor:
    """K15's function: the RGBA uint8 canvas (H, W, 4) as
    ``heif._decode_grid`` builds it (``ffpic_tpu/formats/heif.py:459-
    487``): (0, 0, 0, 255) everywhere, then each tile of ``st`` pasted in
    order (``hevc_yuv_to_rgba_plain``), cropped at the canvas's edge."""
    h, w = len(st.row_cell), len(st.col_cell)
    canvas = torch.zeros((h, w, 4), dtype=torch.uint8,
                         device=st.planes.device)
    canvas[:, :, 3] = 255
    for (y, u, v), oh, ow, y0, x0 in st.tiles:
        if y0 < h and x0 < w:
            hevc_yuv_to_rgba_plain(y, u, v, oh, ow, mode, canvas, y0, x0)
    return canvas


# --- K14's launch plan ------------------------------------------------------

def plan_residuals(tu_meta: np.ndarray):
    """The host side of a K14 launch over ``tu_meta`` (m, 8) int32, whose
    levels lie packed in row order: ``desc`` (m, 2) int32, one row a TU
    in launch order, largest TUs first (stable within a size): (where
    its levels start, QP | ``SKIP`` | ``BYPASS`` | ``DST``); ``ctas``
    (k, 4) int32, one row a CTA: (first row of ``desc``, TU count, log2
    n, 0), each CTA taking ``CTA_THREADS`` // n TUs of one size.
    Vectorised over the TUs; raises ``ValueError`` on a size other than
    4, 8, 16 or 32 or on more levels than int32 offsets reach."""
    desc, counts, need = _part_desc(tu_meta)
    if need >= 2 ** 31:
        raise ValueError("too many levels for one launch")
    return desc.astype(np.int32), _ctas(counts)


# log2 n of a TU size, 0 for a size K14 does not take
_LG = np.zeros(64, np.int8)
_LG[[4, 8, 16, 32]] = [2, 3, 4, 5]
_SIZES = np.array([5, 4, 3, 2])          # log2 n in launch order


def _part_desc(tu_meta: np.ndarray):
    """One picture's part of the plan: its ``desc`` rows (level offsets
    from its own first level, int64), its TU counts by size in launch
    order (32, 16, 8, 4) and its level count."""
    meta = np.asarray(tu_meta)
    ns = meta[:, 2]
    lg = np.take(_LG, ns, mode="clip")
    if not lg.all():
        bad = sorted(set(ns[lg == 0].tolist()))
        raise ValueError(f"TU sizes {bad}: only 4, 8, 16 and 32 are taken")
    n2 = ns.astype(np.int64) ** 2
    offs = np.cumsum(n2) - n2
    perm = np.argsort(5 - lg, kind="stable")
    info = meta[:, 6].astype(np.int32)
    info |= (meta[:, 4] != 0) * SKIP
    info |= (meta[:, 5] != 0) * BYPASS
    info |= (meta[:, 7] != 0) * DST
    desc = np.empty((len(ns), 2), np.int64)
    desc[:, 0] = offs[perm]
    desc[:, 1] = info[perm]
    return desc, np.bincount(lg, minlength=6)[_SIZES], int(n2.sum())


def _ctas(counts: np.ndarray) -> np.ndarray:
    """The CTA rows over ``desc`` rows ordered by size, ``counts`` TUs of
    each size in launch order."""
    per = CTA_THREADS >> _SIZES                        # TUs a CTA
    nctas = -(-counts // per)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    l2s = np.repeat(_SIZES, nctas)
    per_cta = np.repeat(per, nctas)
    k = np.arange(int(nctas.sum())) - np.repeat(
        np.concatenate([[0], np.cumsum(nctas)[:-1]]), nctas)
    start = np.repeat(first, nctas) + k * per_cta
    end = np.repeat(first + counts, nctas)
    ctas = np.stack([start, np.minimum(end - start, per_cta), l2s,
                     np.zeros_like(l2s)], axis=1)
    return np.ascontiguousarray(ctas, np.int32)


def check_tus(tu_meta: np.ndarray, n_levels: int,
              bit_depth: int | None = None) -> None:
    """The route's checks on the host, before staging: (m, 8) rows,
    levels for every TU, QPs in 0..MAX_QP and a bit depth of 8 to 14
    (the kernel's dequant takes the reference's arithmetic only there;
    None leaves it to the launch)."""
    if tu_meta.ndim != 2 or tu_meta.shape[1] != 8:
        raise ValueError(f"tu_meta {tu_meta.shape}: expected (m, 8)")
    if bit_depth is not None and bit_depth not in BIT_DEPTHS:
        raise ValueError(f"bit depth {bit_depth}: the device residuals "
                         "take 8 to 14")
    qp = tu_meta[:, 6]
    if len(qp) and (qp.min() < 0 or qp.max() > MAX_QP):
        raise ValueError(f"TU QPs {qp.min()}..{qp.max()} outside "
                         f"0..{MAX_QP}")
    need = int((tu_meta[:, 2].astype(np.int64) ** 2).sum())
    if n_levels < need:
        raise ValueError(f"{n_levels} levels for TUs of {need}")


# --- entries the codec calls -------------------------------------------------

def hevc_residuals(tu_meta: torch.Tensor, levels: torch.Tensor,
                   bit_depth: int, plan=None) -> torch.Tensor:
    """Every TU's residual over the flat layout: K14 on CUDA tensors
    (``plan``: ``plan_residuals``' arrays as CUDA tensors, which the
    kernel reads in place of ``tu_meta``), the plain
    ``hevc_residuals_plain`` on CPU ones."""
    if not _on_cuda(levels):
        return hevc_residuals_plain(tu_meta, levels, bit_depth)
    from ffpic_tpu_torch.ops import cuda_hevc
    if plan is None:
        raise ValueError("hevc_residuals on CUDA needs the launch plan "
                         "(plan_residuals, staged)")
    return cuda_hevc.hevc_residuals(levels, bit_depth, *plan)


@dataclass
class StagedPart:
    """One picture's share of a K14 launch (``stage_part``): its TU list,
    its ``desc`` rows (level offsets from its own first level, launch
    order) and TU counts by size in launch order, and its levels, pinned
    on CUDA."""
    tu_meta: np.ndarray
    desc: np.ndarray
    counts: np.ndarray
    levels: torch.Tensor


def stage_part(tu_meta: np.ndarray, levels: np.ndarray,
               device=None) -> StagedPart:
    """The host work of one picture's share of a launch, done where the
    picture was decoded (a grid tile's worker): the route's checks, its
    part of the plan and a pinned copy of its levels (the TUs' n² sum
    of them)."""
    dev = resolve_device(device, "stage_part")
    meta = np.ascontiguousarray(tu_meta, np.int32)
    lv = np.asarray(levels).reshape(-1)
    check_tus(meta, lv.size)
    desc, counts, need = _part_desc(meta)
    host = torch.empty(need, dtype=torch.int16,
                       pin_memory=dev.type == "cuda")
    host.numpy()[:] = lv[:need]
    return StagedPart(meta, desc, counts, host)


def stage_residuals(parts, device: torch.device):
    """A launch's inputs on ``device``: ``parts``, a list of
    ``StagedPart``s or of (tu_meta (m, 8), levels) pairs, of one picture
    or of several (a grid's tiles), whose levels are laid one after
    another.  The plan of ``plan_residuals`` over all their TUs goes in
    one pinned buffer and one copy; each part's pinned levels are copied
    into one device buffer, all without waiting.  Returns (levels, (desc,
    ctas)) on ``device``, each 16-byte aligned, and the level count of
    each part."""
    parts = [p if isinstance(p, StagedPart) else stage_part(*p, device)
             for p in parts]
    counts = np.array([p.counts for p in parts]).reshape(-1, 4)
    needs = [p.levels.numel() for p in parts]
    if sum(needs) >= 2 ** 31:
        raise ValueError("too many levels for one launch")
    ctas = _ctas(counts.sum(0))
    m, k = int(counts.sum()), len(ctas)
    # where each part's TUs of each size go: sizes in launch order, parts
    # in order within a size
    at = (np.cumsum(counts.sum(0)) - counts.sum(0))[None, :] + \
        np.cumsum(counts, 0) - counts
    base = np.cumsum([0, *needs])
    # desc | ctas, each on 16 bytes
    at_ctas = 2 * m + (-2 * m) % 4
    host = torch.empty(at_ctas + 4 * k, dtype=torch.int32,
                       pin_memory=device.type == "cuda")
    buf = host.numpy()
    desc = buf[:2 * m].reshape(m, 2)
    buf[at_ctas:] = ctas.reshape(-1)
    for p, part in enumerate(parts):
        first = 0
        for pos, c in zip(at[p], counts[p]):
            d = desc[pos:pos + c]
            d[:] = part.desc[first:first + c]
            d[:, 0] += base[p]
            first += c
    on_card = device.type == "cuda"
    plan = host.to(device, non_blocking=True) if on_card else host
    lv_d = torch.empty(int(base[-1]), dtype=torch.int16, device=device)
    for p, part in enumerate(parts):
        lv_d[base[p]:base[p + 1]].copy_(part.levels, non_blocking=on_card)
    return lv_d, (plan[:2 * m].view(m, 2), plan[at_ctas:].view(k, 4)), \
        needs


def residuals_grid(parts, bit_depth: int, device=None) -> list:
    """Device residuals of several pictures' TUs in one launch (a HEIF
    grid's tiles): ``parts`` a list of (tu_meta, levels), as
    ``residuals_packed`` takes each, or of their ``stage_part``s.  One
    staging of them all, one launch of K14 over every TU (the plain
    version on the CPU) and one read-back into pinned memory, which
    synchronises with the current stream.  Returns each part's int16
    residuals, views of one buffer.  ``device`` None means CUDA.  Spans
    ``hevc.residuals_stage`` (the plan's assembly and the copies'
    enqueue) and ``hevc.residuals_readback`` (the launch and the
    read-back, which waits for the copies)."""
    dev = resolve_device(device, "residuals_grid")
    if bit_depth not in BIT_DEPTHS:
        raise ValueError(f"bit depth {bit_depth}: the device residuals "
                         "take 8 to 14")
    parts = [p if isinstance(p, StagedPart) else stage_part(*p, dev)
             for p in parts]
    if not any(len(p.tu_meta) for p in parts):
        return [np.zeros(0, np.int16) for _ in parts]
    with trace.stage("hevc.residuals_stage"):
        lv_d, plan, needs = stage_residuals(parts, dev)
    on_card = dev.type == "cuda"
    meta = None if on_card else torch.from_numpy(
        np.concatenate([p.tu_meta for p in parts]))   # the plain version's
    with trace.stage("hevc.residuals_readback"):
        res = hevc_residuals(meta, lv_d, bit_depth, plan)
        if on_card:
            host = torch.empty(res.shape, dtype=res.dtype, pin_memory=True)
            host.copy_(res, non_blocking=True)
            torch.cuda.current_stream(dev).synchronize()
            res = host
    flat = res.numpy()
    cut = np.cumsum([0, *needs])
    return [flat[a:b] for a, b in zip(cut[:-1], cut[1:])]


def residuals_packed(tu_meta: np.ndarray, levels: np.ndarray,
                     bit_depth: int, device=None) -> np.ndarray:
    """Device residuals over the NATIVE flat layout (tu_meta rows:
    x,y,n,cidx,skip,bypass,qp,dst; levels int16 packed per TU), as
    ``hevc_kernels.py:143``: returns int16 packed residuals in the same
    layout (one per level of the TUs), to feed
    ``native.hevc_recon(..., residuals=...)``.  ``residuals_grid`` of
    the one picture: one staged copy, one launch of K14 over every TU
    of the picture (the plain version on the CPU) and one read-back,
    which synchronises with the current stream.  ``device`` None means
    CUDA."""
    return residuals_grid([(tu_meta, levels)], bit_depth, device)[0]


def residuals_for_ops(ops, bit_depth: int, device=None) -> dict:
    """All residuals of a recon op list (``hevc_kernels.py:113``):
    {id(tu): (n, n) int32 numpy residual} for the TUs of the ops that
    carry one and are not bypass (those stay host-side, as in the
    reference).  The TUs go through ``residuals_packed`` in one launch;
    like the reference, ``tu.scaling`` is not applied.  Levels outside
    the 16 bits the specification allows raise ``ValueError``."""
    tus = [t for t in (getattr(op, "tu", None) for op in ops)
           if t is not None and not t.bypass]
    if not tus:
        return {}
    meta = np.array([(0, 0, t.n, 0, int(bool(t.skip)), 0, t.qp,
                      int(bool(t.dst))) for t in tus], np.int32)
    lv = np.concatenate([np.asarray(t.levels).reshape(-1) for t in tus])
    if lv.size and (lv.min() < -32768 or lv.max() > 32767):
        raise ValueError("TransCoeffLevel outside 16 bits")
    res = residuals_packed(meta, lv.astype(np.int16), bit_depth, device)
    out = {}
    off = 0
    for t in tus:
        out[id(t)] = res[off:off + t.n * t.n].astype(np.int32) \
            .reshape(t.n, t.n)
        off += t.n * t.n
    return out


def hevc_tiles_to_rgba(st: StagedTiles, mode: str = "bt601") -> torch.Tensor:
    """A picture's colour and canvas: K15 (one launch over every tile of
    ``st``, each canvas pixel written once) on CUDA, the plain
    ``hevc_tiles_to_rgba_plain`` on the CPU."""
    if not _on_cuda(st.planes):
        return hevc_tiles_to_rgba_plain(st, mode)
    from ffpic_tpu_torch.ops import cuda_hevc
    return cuda_hevc.hevc_yuv_to_rgba(st, mode)
