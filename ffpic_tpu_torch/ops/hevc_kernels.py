"""HEVC device stages: the residual transform of every TU of a picture
(8.6.3 dequant, then the 2-D inverse DCT of 4 to 32 points or the
4-point DST, or the transform-skip scaling, or the bypass copy) and the
HEIF colour (nearest 2x chroma, crop, YCbCr -> RGBA).

The PyTorch counterpart of ``ffpic_tpu/ops/hevc_kernels.py``.  It holds

* the plain PyTorch version of each stage: ``dequant_itransform_batch``
  and ``dequant_skip_batch`` (the reference's functions of the same
  names, one TU-size bucket each), ``hevc_residuals_plain`` (K14's
  function: every TU of the native flat layout at once) and
  ``hevc_yuv_to_rgba_plain`` (K15's: the branch of
  ``ffpic_tpu/formats/heif.py:356-371``).  They run on any device and
  are the reference the CUDA kernels are held against;
* ``plan_residuals``, the host side of K14's launch: the TUs' level
  offsets, their order by size, and the work of each CTA, all from
  vectorised index arrays (no Python loop over TUs);
* the entries the codec calls: ``residuals_packed`` and
  ``residuals_for_ops`` (named as the reference's), ``hevc_residuals``
  and ``hevc_yuv_to_rgba``.  They dispatch on the tensor's device: a
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

import numpy as np
import torch

from ffpic_tpu_torch.coding.hevc_consts import DST4, LEVEL_SCALE, dct_matrix
from ffpic_tpu_torch.ops.jpeg_kernels import _on_cuda, color_convert
from ffpic_tpu_torch.utils.device import resolve_device, to_device

# TU sizes as log2: 4, 8, 16 and 32 points
_LOG2 = {4: 2, 8: 3, 16: 4, 32: 5}
# K14 works on 1024 samples a CTA: 64 TUs of 4x4, 16 of 8x8, 4 of 16x16
# or one of 32x32
CTA_SAMPLES = 1024
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


# --- K14's launch plan ------------------------------------------------------

def plan_residuals(tu_meta: np.ndarray):
    """The host side of a K14 launch over ``tu_meta`` (m, 8) int32:
    ``offs`` (m,) int32, where each TU's levels start; ``perm`` (m,)
    int32, the TUs ordered by size (stable); ``ctas`` (k, 4) int32, one
    row a CTA: (first entry of ``perm``, TU count, log2 n, 0), each CTA
    taking ``CTA_SAMPLES`` // n² TUs of one size.  Vectorised over the
    TUs; raises ``ValueError`` on a size other than 4, 8, 16 or 32 or on
    more levels than int32 offsets reach."""
    meta = np.asarray(tu_meta)
    ns = meta[:, 2].astype(np.int64)
    lg = np.zeros(len(ns), np.int64)
    for n, l2 in _LOG2.items():
        lg[ns == n] = l2
    if (lg == 0).any():
        raise ValueError(f"TU sizes {sorted(set(ns[lg == 0].tolist()))}: "
                         "only 4, 8, 16 and 32 are taken")
    n2 = ns * ns
    offs = np.cumsum(n2) - n2
    if len(ns) and offs[-1] + n2[-1] >= 2 ** 31:
        raise ValueError("too many levels for one launch")
    perm = np.argsort(lg, kind="stable")
    counts = np.bincount(lg, minlength=6)[2:]
    per = CTA_SAMPLES >> (2 * np.arange(2, 6))        # TUs a CTA, by size
    nctas = -(-counts // per)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    l2s = np.repeat(np.arange(2, 6), nctas)
    k = np.arange(int(nctas.sum())) - np.repeat(
        np.concatenate([[0], np.cumsum(nctas)[:-1]]), nctas)
    start = np.repeat(first, nctas) + k * per[l2s - 2]
    end = np.repeat(first + counts, nctas)
    ctas = np.stack([start, np.minimum(end - start, per[l2s - 2]), l2s,
                     np.zeros_like(l2s)], axis=1)
    return (offs.astype(np.int32), perm.astype(np.int32),
            np.ascontiguousarray(ctas, np.int32))


def check_tus(tu_meta: np.ndarray, n_levels: int, bit_depth: int) -> None:
    """The route's checks on the host, before staging: (m, 8) rows,
    levels for every TU, QPs in 0..MAX_QP and a bit depth of 8 to 14
    (the kernel's dequant takes the reference's arithmetic only there)."""
    if tu_meta.ndim != 2 or tu_meta.shape[1] != 8:
        raise ValueError(f"tu_meta {tu_meta.shape}: expected (m, 8)")
    if bit_depth not in BIT_DEPTHS:
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
    (``plan``: ``plan_residuals``' arrays as CUDA tensors), the plain
    ``hevc_residuals_plain`` on CPU ones."""
    if not _on_cuda(levels):
        return hevc_residuals_plain(tu_meta, levels, bit_depth)
    from ffpic_tpu_torch.ops import cuda_hevc
    if plan is None:
        raise ValueError("hevc_residuals on CUDA needs the launch plan "
                         "(plan_residuals, staged)")
    return cuda_hevc.hevc_residuals(tu_meta, levels, bit_depth, *plan)


def stage_residuals(tu_meta: np.ndarray, levels: np.ndarray,
                    device: torch.device):
    """One host-to-device copy of a launch's inputs: ``tu_meta``, its
    plan (``plan_residuals``) and the levels, packed into one int32
    buffer.  Returns (tu_meta, levels, plan) on ``device``."""
    meta = np.ascontiguousarray(tu_meta, np.int32)
    lv = np.ascontiguousarray(levels, np.int16).reshape(-1)
    offs, perm, ctas = plan_residuals(meta)
    m, k = len(meta), len(ctas)
    # meta | offs | perm | ctas | levels, ctas and levels on 16 bytes
    at_ctas = 10 * m + (-10 * m) % 4
    head = at_ctas + 4 * k
    buf = np.zeros(head + (lv.size + 1) // 2, np.int32)
    buf[:8 * m] = meta.reshape(-1)
    buf[8 * m:9 * m] = offs
    buf[9 * m:10 * m] = perm
    buf[at_ctas:head] = ctas.reshape(-1)
    buf[head:].view(np.int16)[:lv.size] = lv
    dev = to_device(buf, device)
    meta_d = dev[:8 * m].view(m, 8)
    offs_d = dev[8 * m:9 * m]
    perm_d = dev[9 * m:10 * m]
    ctas_d = dev[at_ctas:head].view(k, 4)
    lv_d = dev[head:].view(torch.int16)[:lv.size]
    return meta_d, lv_d, (offs_d, perm_d, ctas_d)


def residuals_packed(tu_meta: np.ndarray, levels: np.ndarray,
                     bit_depth: int, device=None) -> np.ndarray:
    """Device residuals over the NATIVE flat layout (tu_meta rows:
    x,y,n,cidx,skip,bypass,qp,dst; levels int16 packed per TU), as
    ``hevc_kernels.py:143``: returns int16 packed residuals in the same
    layout (one per level of the TUs), to feed
    ``native.hevc_recon(..., residuals=...)``.  One staged copy, one
    launch of K14 over every TU of the picture (the plain version on
    the CPU) and one read-back, which synchronises with the current
    stream.  ``device`` None means CUDA."""
    dev = resolve_device(device, "residuals_packed")
    meta = np.ascontiguousarray(tu_meta, np.int32)
    check_tus(meta, np.asarray(levels).size, bit_depth)
    if len(meta) == 0:
        return np.zeros(0, np.int16)
    need = int((meta[:, 2].astype(np.int64) ** 2).sum())
    m_d, lv_d, plan = stage_residuals(meta, np.asarray(levels)[:need], dev)
    return hevc_residuals(m_d, lv_d, bit_depth, plan).cpu().numpy()


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


def hevc_yuv_to_rgba(Y: torch.Tensor, U: torch.Tensor | None,
                     V: torch.Tensor | None, out_h: int, out_w: int,
                     mode: str = "bt601", out: torch.Tensor | None = None,
                     y0: int = 0, x0: int = 0) -> torch.Tensor:
    """A tile's colour: K15 on CUDA tensors, the plain
    ``hevc_yuv_to_rgba_plain`` on CPU ones (same arguments)."""
    if not _on_cuda(Y):
        return hevc_yuv_to_rgba_plain(Y, U, V, out_h, out_w, mode, out,
                                      y0, x0)
    from ffpic_tpu_torch.ops import cuda_hevc
    return cuda_hevc.hevc_yuv_to_rgba(Y, U, V, out_h, out_w, mode, out,
                                      y0, x0)
