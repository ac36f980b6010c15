"""JPEG device pipelines: the batched 4:2:0 decode (packed coefficients
-> dense blocks -> dequant + 8x8 integer IDCT -> planes, 2x chroma,
YCbCr->RGBA), the general single-image decode of any sampling, and the
encoder's forward DCT.

The PyTorch counterpart of ``ffpic_tpu/ops/jpeg_kernels.py``.  It holds

* the host helpers ``stack_packed_fused``, ``_bucket`` and
  ``pack_coeffs`` (numpy, the last over ``native.pack_nonzero``);
* the plain PyTorch version of every device stage: ``count_starts`` and
  ``unpack_coeffs`` (K1a/K1b), ``scatter_plane`` (K8),
  ``dequant_idct_blocks`` (K2),
  ``color_convert`` and ``assemble_color`` (K3), ``decode_batch_420``
  (K2 then K3), ``assemble_mcu`` (K4: ``mcu_planes`` with
  ``blocks_to_plane`` and ``upsample_nearest`` or ``upsample_fancy``,
  then colour) and
  ``forward_dct`` (K5).  They run on any device and are the reference
  the CUDA kernels are held against;
* the entries the pipeline and the codec call:
  ``decode_batch_420_packed_fused``, ``decode_batch_420_dense``,
  ``decode_batch_420_sparse`` (K8 per plane, then K2 and K3),
  ``decode_mcu_planes`` (K2 then K4) and ``fdct_blocks`` (K5).  They
  dispatch on the tensor's device: a CPU tensor takes the plain
  versions, a CUDA tensor the kernels of ``ops.cuda_jpeg`` (which raise
  rather than fall back).

Every stage is bit-exact with the JAX package.  Integer stages compute
in int64 and wrap explicitly to int32/int16 where the reference wraps,
instead of relying on torch's int32 overflow.  The float colour stage
fuses each product with its sum into one f32 FMA, as XLA compiles the
reference.

Coefficient layout: one image's blocks over all three components,
``(N, nblocks, 8, 8)`` int16 with nblocks = nY + 2 nC and the components
``[Y (nby, nbx) | Cb (nby/2, nbx/2) | Cr]`` each in block raster order;
``shapes`` is ``((nby, nbx), (nby/2, nbx/2), (nby/2, nbx/2))``.
Quant tables are ``(N, 64)`` int32 per image, raster order.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ffpic_tpu_torch.ops.golden import FDCT_P13, IDCT_P13, ZIGZAG
from ffpic_tpu_torch.utils.device import to_device


def _wrap(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Two's-complement wrap of an int64 tensor to ``bits`` bits."""
    half = 1 << (bits - 1)
    return ((x + half) & ((1 << bits) - 1)) - half


def _bucket(n: int, minimum: int = 2048) -> int:
    """Round nnz up to the next power of two (min 2048): few distinct
    buffer sizes, padding bounded at 2x."""
    b = minimum
    while b < n:
        b <<= 1
    return b


def stack_packed_fused(packed_list, minimum: int = 2048):
    """Stack N frames' packed emissions (counts u8[G], ks u8[E_i], vals
    i16[E_i], nnz) into ONE uint8 buffer, counts (N, G) | ks (N, E) |
    vals (N, E) int16 little-endian, with E the batch's nnz bucket and
    the padding zero.  Returns (buf, G, E)."""
    n = len(packed_list)
    emax = _bucket(max(int(p[3]) for p in packed_list), minimum)
    g = np.asarray(packed_list[0][0]).shape[0]
    buf = np.zeros(n * (g + 3 * emax), np.uint8)
    cb = buf[:n * g].reshape(n, g)
    kb = buf[n * g:n * (g + emax)].reshape(n, emax)
    vb = buf[n * (g + emax):].reshape(n, 2 * emax)
    for i, (c, k, v, nnz) in enumerate(packed_list):
        cb[i] = np.asarray(c)
        kb[i, :nnz] = np.asarray(k)[:nnz]
        vb[i, :2 * nnz] = np.asarray(v, np.int16)[:nnz].view(np.uint8)
    return buf, g, emax


def pack_coeffs(plane: np.ndarray, minimum: int = 2048):
    """Host side of the sparse staging route: the nonzeros of an int16
    array as (flat index int32, value int16) pairs in index order
    (``native.pack_nonzero``), zero-padded to a ``_bucket`` length.
    Copied from ``ffpic_tpu/ops/jpeg_kernels.py:472``."""
    from ffpic_tpu_torch import native
    idx, val = native.pack_nonzero(plane)
    n = _bucket(len(idx), minimum)
    pidx = np.zeros(n, np.int32)
    pval = np.zeros(n, np.int16)
    pidx[:len(idx)] = idx
    pval[:len(val)] = val
    return pidx, pval


def from_jax_inputs(buf, block_map, yquant, cquant, device):
    """The arrays the JAX ``decode_batch_420_packed_fused`` is fed
    (numpy buffer, int32 block map, ``(N, 1, 1, 8, 8)`` quant stacks) as
    this package's tensors: (buf u8, block_map i32, yquant (N, 64) i32,
    cquant (N, 64) i32) on ``device``."""
    def q(a):
        a = np.asarray(a, np.int32)
        return torch.from_numpy(np.ascontiguousarray(
            a.reshape(-1, 64))).to(device)
    return (torch.from_numpy(np.array(buf, np.uint8)).to(device),
            torch.from_numpy(np.array(block_map, np.int32)).to(device),
            q(yquant), q(cquant))


# --- plain versions -------------------------------------------------------

def split_packed(buf: torch.Tensor, n: int, g: int, e: int):
    """Fused buffer -> counts (n, g) u8, ks (n, e) u8, vals (n, e) i16."""
    counts = buf[:n * g].view(n, g)
    ks = buf[n * g:n * (g + e)].view(n, e)
    b = buf[n * (g + e):n * (g + 3 * e)].view(n, e, 2).to(torch.int64)
    vals = _wrap(b[..., 0] | (b[..., 1] << 8), 16).to(torch.int16)
    return counts, ks, vals


def count_starts(counts: torch.Tensor) -> torch.Tensor:
    """(n, g) u8 counts -> exclusive prefix sums, (n, g) int32 (K1a)."""
    c = counts.to(torch.int64)
    return (torch.cumsum(c, dim=1) - c).to(torch.int32)


def unpack_coeffs(counts, ks, vals, block_map, nblocks: int):
    """Packed emission -> dense (n, nblocks, 8, 8) int16 coefficients
    (K1a + K1b).  Entry j of an image belongs to the last block whose
    start is <= j, as the reference's marks+cumsum assign it; zigzag
    positions past 63 clamp to 63 like a JAX gather, sums wrap to int16,
    and indices outside the coefficient space are dropped.  Entries past
    the counts' total are padding and are ignored (the reference adds
    them to the last block; ``stack_packed_fused`` makes them zero)."""
    n, e = ks.shape
    starts = count_starts(counts).to(torch.int64)
    j = torch.arange(e, device=ks.device).expand(n, e).contiguous()
    ids = torch.searchsorted(starts, j, right=True) - 1
    zz = torch.as_tensor(ZIGZAG, dtype=torch.int64, device=ks.device)
    pos = zz[ks.to(torch.int64).clamp(max=63)]
    flat = block_map.to(torch.int64)[ids] * 64 + pos
    keep = ((flat >= 0) & (flat < nblocks * 64)
            & (j < (starts[:, -1] + counts[:, -1])[:, None]))
    flat = flat + torch.arange(n, device=ks.device)[:, None] * (nblocks * 64)
    acc = torch.zeros(n * nblocks * 64, dtype=torch.int64, device=ks.device)
    acc.index_add_(0, flat[keep], vals.to(torch.int64)[keep])
    return _wrap(acc, 16).to(torch.int16).view(n, nblocks, 8, 8)


def scatter_plane(idx: torch.Tensor, val: torch.Tensor,
                  shape) -> torch.Tensor:
    """Packed (idx, val) pairs -> dense ``(*shape, 8, 8)`` int16 (K8):
    zeros, then each value added at its flat index, sums wrapping to
    int16, as the reference's ``_scatter_plane`` (``.at[idx].add``).
    That scatter, run on JAX, takes an index in [-n, 0) as idx + n (n
    the plane's size) and drops any other index outside [0, n), so
    duplicates add, the (0, 0) padding adds nothing, and e.g. -1 lands
    on the last coefficient while -n-1 and n are dropped; this version
    does the same, masking before ``index_add_``, which would raise."""
    n = int(np.prod(shape)) * 64
    i = idx.to(torch.int64)
    i = torch.where(i < 0, i + n, i)
    keep = (i >= 0) & (i < n)
    acc = torch.zeros(n, dtype=torch.int64, device=idx.device)
    acc.index_add_(0, i[keep], val.to(torch.int64)[keep])
    return _wrap(acc, 16).to(torch.int16).view(*shape, 8, 8)


def scatter_planes(packed, n: int, sizes) -> torch.Tensor:
    """Planes' packed pairs -> (n, sum(sizes), 8, 8) int16 (K8 over all
    planes): plane c is ``scatter_plane(*packed[c], (n, sizes[c]))``, the
    planes one after the other in each image's blocks, as the
    reference's ``decode_batch_420_sparse`` stacks its three
    ``_scatter_plane`` results."""
    return torch.cat([scatter_plane(idx, val, (n, nb))
                      for (idx, val), nb in zip(packed, sizes)], dim=1)


def dequant_idct_blocks(coeffs: torch.Tensor, yquant: torch.Tensor,
                        cquant: torch.Tensor, n_luma: int) -> torch.Tensor:
    """(n, nblocks, 8, 8) int16 -> int16 samples in [0, 65535]-clamped
    int16 storage (K2): dequant wrapped to int16, column pass with
    (+1<<10)>>11 into int16, row pass with (+257<<17)>>18, int32 sums
    wrapping like the reference."""
    n, nb = coeffs.shape[:2]
    luma = (torch.arange(nb, device=coeffs.device) < n_luma)[None, :, None, None]
    q = torch.where(luma, yquant.view(n, 1, 8, 8), cquant.view(n, 1, 8, 8))
    x = _wrap(coeffs.to(torch.int64) * q.to(torch.int64), 16)
    t = torch.from_numpy(IDCT_P13).to(x.device)
    # column pass: col[..., i, c] = sum_u T[i, u] * x[..., u, c]
    col = sum(t[:, u, None] * x[..., u:u + 1, :] for u in range(8))
    col = _wrap(_wrap(col + (1 << 10), 32) >> 11, 16)
    # row pass: out[..., y, i] = sum_u T[i, u] * col[..., y, u]
    row = sum(t[:, u] * col[..., u:u + 1] for u in range(8))
    out = (_wrap(row + (257 << 17), 32) >> 18).clamp(0, 65535)
    return _wrap(out, 16).to(torch.int16)


def _fma(a: float, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 fma(a, x, c) with one rounding: the f32 constant times an f32
    of at most 17 significant bits, plus an f32 on the same 2^-26 grid,
    is exact in float64, so only the final cast rounds."""
    return (x.to(torch.float64) * float(np.float32(a))
            + c.to(torch.float64)).to(torch.float32)


def color_convert(yp, up, vp, order: str = "bgra", mode: str = "reference"):
    """int16 planes -> (..., 4) uint8: reference r=y+1.280v,
    g=y-0.215u-0.381v, b=y+2.128u truncated; bt601 floor(. + 0.5) with
    the JFIF coefficients; rgb: the planes are R, G, B, clipped.

    Each product is fused with its sum into one f32 FMA, g as
    fma(-0.381, v, fma(-0.215, u, y)): that is how XLA compiles the
    reference's ``y - 0.215*u - 0.381*v`` inside the jit of every JAX
    caller, and unfused rounding differs from it on 1085 of the 256^3
    in-range inputs in reference mode."""
    if order not in ("rgba", "bgra"):
        raise ValueError(order)
    if mode == "rgb":
        r, g, b = (p.clamp(0, 255).to(torch.uint8) for p in (yp, up, vp))
    else:
        yy = yp.to(torch.float32)
        uu = up.to(torch.float32) - 128.0
        vv = vp.to(torch.float32) - 128.0
        if mode == "reference":
            r = torch.trunc(_fma(1.280, vv, yy))
            g = torch.trunc(_fma(-0.381, vv, _fma(-0.215, uu, yy)))
            b = torch.trunc(_fma(2.128, uu, yy))
        elif mode == "bt601":
            r = torch.floor(_fma(1.402, vv, yy) + 0.5)
            g = torch.floor(_fma(-0.714136, vv, _fma(-0.344136, uu, yy))
                            + 0.5)
            b = torch.floor(_fma(1.772, uu, yy) + 0.5)
        else:
            raise ValueError(mode)
        r, g, b = (p.clamp(0, 255).to(torch.uint8) for p in (r, g, b))
    a = torch.full_like(r, 255)
    return torch.stack([r, g, b, a] if order == "rgba" else [b, g, r, a],
                       dim=-1)


def _planes(blocks: torch.Tensor, nby: int, nbx: int) -> torch.Tensor:
    n = blocks.shape[0]
    return (blocks.reshape(n, nby, nbx, 8, 8).permute(0, 1, 3, 2, 4)
            .reshape(n, nby * 8, nbx * 8))


def assemble_color(samples: torch.Tensor, shapes, order: str = "rgba",
                   mode: str = "reference", hw=None) -> torch.Tensor:
    """(n, nblocks, 8, 8) int16 samples -> (n, h, w, 4) uint8: block
    grid to planes, nearest 2x chroma repeat, colour (K3).  ``hw`` is
    the output (h, w), at most the grid's (8 nby, 8 nbx), which is the
    default: the image is cropped to it."""
    (nby, nbx), (cy, cx), _ = shapes
    h, w = hw or (8 * nby, 8 * nbx)
    ny, nc = nby * nbx, cy * cx
    yp = _planes(samples[:, :ny], nby, nbx)[:, :h, :w]

    def chroma(s):
        p = _planes(s, cy, cx)[:, :(h + 1) // 2, :(w + 1) // 2]
        return p.repeat_interleave(2, 1).repeat_interleave(2, 2)[:, :h, :w]

    return color_convert(yp, chroma(samples[:, ny:ny + nc]),
                         chroma(samples[:, ny + nc:ny + 2 * nc]),
                         order=order, mode=mode)


def decode_batch_420(coeffs, yquant, cquant, shapes, order: str = "rgba",
                     mode: str = "reference", hw=None):
    """Dense 4:2:0 batch -> (n, h, w, 4) uint8 through the plain
    versions: dequant + IDCT, then assembly and colour."""
    samples = dequant_idct_blocks(coeffs, yquant, cquant,
                                  shapes[0][0] * shapes[0][1])
    return assemble_color(samples, shapes, order=order, mode=mode, hw=hw)


def forward_dct(samples: torch.Tensor) -> torch.Tensor:
    """(..., 8, 8) int16 level-shifted samples (y - 128) -> int16
    coefficients (K5): the 13-bit forward DCT of the reference's
    ``fdct_blocks``, the row pass first, then the column pass, each
    ((sum >> 1) + (1 << 12)) >> 13 wrapped to int16, int32 sums
    wrapping."""
    x = samples.to(torch.int64)
    d = torch.from_numpy(FDCT_P13).to(x.device)
    # row pass: row[..., y, i] = sum_u D[i, u] * x[..., y, u]
    row = sum(d[:, u] * x[..., u:u + 1] for u in range(8))
    row = _wrap(((_wrap(row, 32) >> 1) + (1 << 12)) >> 13, 16)
    # column pass: col[..., i, x] = sum_u D[i, u] * row[..., u, x]
    col = sum(d[:, u, None] * row[..., u:u + 1, :] for u in range(8))
    return _wrap(((_wrap(col, 32) >> 1) + (1 << 12)) >> 13,
                 16).to(torch.int16)


def blocks_to_plane(blocks: torch.Tensor) -> torch.Tensor:
    """(nby, nbx, 8, 8) -> (nby*8, nbx*8)"""
    nby, nbx = blocks.shape[0], blocks.shape[1]
    return blocks.permute(0, 2, 1, 3).reshape(nby * 8, nbx * 8)


def plane_to_blocks(plane: torch.Tensor) -> torch.Tensor:
    """(h, w) with h and w multiples of 8 -> (h/8, w/8, 8, 8)"""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).permute(0, 2, 1, 3)


def upsample_nearest(plane, v: int, h: int, out_h: int, out_w: int):
    """Nearest-neighbour upsample by integer factors (v, h): sample
    (y // v, x // h), then the crop to (out_h, out_w)."""
    if v != 1:
        plane = plane.repeat_interleave(v, dim=0)
    if h != 1:
        plane = plane.repeat_interleave(h, dim=1)
    return plane[:out_h, :out_w]


def upsample_fancy(plane, v: int, h: int, out_h: int, out_w: int):
    """libjpeg's "fancy" (triangle-filter) upsampling (jdsample.c
    h2v2/h2v1): a 3:1 blend toward the nearer sample with the 8/7 (v=2)
    or 4/8 (v=1) alternating bias, borders replicated at the plane's
    last row and column.  Factors 1 and 2 only: the reference's shapes
    do not fit any other."""
    if v not in (1, 2) or h not in (1, 2):
        raise ValueError(f"fancy upsampling takes factors 1 and 2, got "
                         f"{v}x{h}")
    x = plane.to(torch.int32)
    if v == 2:
        up = torch.cat([x[:1], x[:-1]], dim=0)
        dn = torch.cat([x[1:], x[-1:]], dim=0)
        rows = torch.stack([3 * x + up, 3 * x + dn], dim=1) \
            .reshape(-1, x.shape[1])
        ebias, obias = 8, 7
    else:
        rows = x * 4
        ebias, obias = 4, 8
    if h == 2:
        lf = torch.cat([rows[:, :1], rows[:, :-1]], dim=1)
        rt = torch.cat([rows[:, 1:], rows[:, -1:]], dim=1)
        even = (3 * rows + lf + ebias) >> 4
        odd = (3 * rows + rt + obias) >> 4
        out = torch.stack([even, odd], dim=2).reshape(rows.shape[0], -1)
    else:
        out = (rows + 2) >> 2
    return out[:out_h, :out_w].to(torch.int16)


def mcu_planes(samples: torch.Tensor, shapes, samplings, out_h: int,
               out_w: int, gray_chroma: int = 128,
               upsample: str = "nearest") -> list[torch.Tensor]:
    """The three (out_h, out_w) int16 planes K4 colours: each
    component's plane from one image's samples (nblocks, 8, 8), 1 or 3
    components in frame order with block grids ``shapes`` and
    luma-relative factors ``samplings`` ((v, h) each), cropped to its
    valid samples (ceil(out_h / v), ceil(out_w / h)) and upsampled; a
    gray image's chroma is ``gray_chroma``."""
    if len(shapes) not in (1, 3):
        raise ValueError(f"unsupported component count {len(shapes)} "
                         "(want 1 or 3)")
    if upsample not in ("nearest", "fancy"):
        raise ValueError(f"upsample {upsample!r}")
    up_fn = upsample_fancy if upsample == "fancy" else upsample_nearest
    planes = []
    off = 0
    for (nby, nbx), (v, h) in zip(shapes, samplings):
        plane = blocks_to_plane(samples[off:off + nby * nbx]
                                .view(nby, nbx, 8, 8))
        off += nby * nbx
        if v == 1 and h == 1:
            plane = plane[:out_h, :out_w]
        else:
            plane = up_fn(plane[:-(-out_h // v), :-(-out_w // h)], v, h,
                          out_h, out_w)
        if tuple(plane.shape) != (out_h, out_w):
            raise ValueError(f"a {nby}x{nbx}-block plane does not cover "
                             f"{out_h}x{out_w} at factor {v}x{h}")
        planes.append(plane)
    if len(planes) == 1:
        fill = torch.full((out_h, out_w), gray_chroma, dtype=torch.int16,
                          device=samples.device)
        planes += [fill, fill]
    return planes


def assemble_mcu(samples: torch.Tensor, shapes, samplings, out_h: int,
                 out_w: int, order: str = "bgra", mode: str = "reference",
                 gray_chroma: int = 128,
                 upsample: str = "nearest") -> torch.Tensor:
    """One image's int16 samples -> (out_h, out_w, 4) uint8 (K4):
    ``mcu_planes``, then colour.  The part of the reference's
    ``decode_mcu_planes`` after the IDCT."""
    return color_convert(*mcu_planes(samples, shapes, samplings, out_h,
                                     out_w, gray_chroma, upsample),
                         order=order, mode=mode)


# --- entries the pipeline calls --------------------------------------------

def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def decode_batch_420_dense(coeffs, yquant, cquant, shapes,
                           order: str = "rgba", mode: str = "reference",
                           hw=None):
    """Dense coefficients (n, nblocks, 8, 8) int16 -> (n, h, w, 4) uint8
    (``hw`` as in ``assemble_color``): K2 + K3 on a CUDA tensor, the
    plain versions on a CPU tensor."""
    if not _on_cuda(coeffs):
        return decode_batch_420(coeffs, yquant, cquant, shapes, order, mode,
                                hw)
    from ffpic_tpu_torch.ops import cuda_jpeg
    (nby, nbx), _, _ = shapes
    samples = cuda_jpeg.dequant_idct(coeffs, yquant, cquant, nby * nbx)
    return cuda_jpeg.assemble_color(samples, nby, nbx, order, mode, hw)


def decode_batch_420_planes(ycoef, ucoef, vcoef, yquant, cquant,
                            order: str = "rgba", mode: str = "reference"):
    """The reference's ``decode_batch_420`` (``ffpic_tpu/ops/
    jpeg_kernels.py:239``) on its layouts: (n, nby, nbx, 8, 8) int16
    luma and (n, nby/2, nbx/2, 8, 8) chroma tensors, quant tables (8, 8)
    shared or (n, 1, 1, 8, 8) per image -> (n, 8 nby, 8 nbx, 4) uint8:
    the planes concatenated an image at a time, then
    ``decode_batch_420_dense`` (K2 + K3 on CUDA)."""
    n, nby, nbx = ycoef.shape[:3]
    if (tuple(ucoef.shape) != (n, nby // 2, nbx // 2, 8, 8)
            or tuple(vcoef.shape) != tuple(ucoef.shape)):
        raise ValueError(f"chroma {tuple(ucoef.shape)}/{tuple(vcoef.shape)}"
                         f" is not the 4:2:0 half of luma "
                         f"{tuple(ycoef.shape)}")
    coeffs = torch.cat([c.reshape(n, -1, 8, 8)
                        for c in (ycoef, ucoef, vcoef)], 1)

    def tables(q):
        return q.to(torch.int32).reshape(-1, 64).expand(n, 64).contiguous()

    half = (nby // 2, nbx // 2)
    return decode_batch_420_dense(coeffs, tables(yquant), tables(cquant),
                                  ((nby, nbx), half, half), order, mode)


def decode_batch_420_packed_fused(buf, block_map, yquant, cquant, n: int,
                                  g: int, e: int, shapes, order: str = "rgba",
                                  mode: str = "reference", hw=None):
    """A ``stack_packed_fused`` buffer of n frames -> (n, h, w, 4) uint8:
    K1a, K1b, K2, K3 on a CUDA buffer, the plain versions on a CPU one."""
    nblocks = sum(a * b for a, b in shapes)
    if _on_cuda(buf):
        from ffpic_tpu_torch.ops import cuda_jpeg
        starts = cuda_jpeg.count_scan(buf, n, g)
        coeffs = cuda_jpeg.unpack(buf, starts, block_map, n, g, e, nblocks)
    else:
        counts, ks, vals = split_packed(buf, n, g, e)
        coeffs = unpack_coeffs(counts, ks, vals, block_map, nblocks)
    return decode_batch_420_dense(coeffs, yquant, cquant, shapes, order, mode,
                                  hw)


def decode_batch_420_sparse(packed, n: int, shapes, yquant, cquant,
                            order: str = "rgba", mode: str = "reference",
                            hw=None):
    """Sparse-staged 4:2:0 batch -> (n, h, w, 4) uint8, the reference's
    ``decode_batch_420_sparse`` (``jpeg_kernels.py:485``).  ``packed`` is
    ((yidx, yval), (uidx, uval), (vidx, vval)) from ``pack_coeffs`` on
    the device, each covering the (n, nby, nbx, 8, 8) plane of ``shapes``
    flattened.  On a CUDA tensor one K8 launch rebuilds the three planes
    into their slots of one (n, nblocks, 8, 8) buffer, then K2 and K3 run
    as on the dense route; on a CPU tensor the plain versions."""
    sizes = [a * b for a, b in shapes]
    if _on_cuda(packed[0][0]):
        from ffpic_tpu_torch.ops import cuda_jpeg
        coeffs = torch.empty((n, sum(sizes), 8, 8), dtype=torch.int16,
                             device=packed[0][0].device)
        cuda_jpeg.scatter_planes(packed, coeffs, sizes)
    else:
        coeffs = scatter_planes(packed, n, sizes)
    return decode_batch_420_dense(coeffs, yquant, cquant, shapes, order, mode,
                                  hw)


def decode_mcu_planes(coeffs: torch.Tensor, shapes, quants, samplings,
                      out_h: int, out_w: int, order: str = "bgra",
                      mode: str = "reference", gray_chroma: int = 128,
                      upsample: str = "nearest") -> torch.Tensor:
    """One image's dense coefficients -> (out_h, out_w, 4) uint8: the
    reference's ``decode_mcu_planes`` over a single staged buffer.

    ``coeffs`` is (nblocks, 8, 8) int16, the components' blocks in frame
    order, each (nby, nbx) of ``shapes`` in raster order; ``quants`` the
    (ncomp, 64) int32 tables, raster order, on the host; ``samplings``
    each component's luma-relative factor (v, h).  Each component is
    dequantised against its own table.  On a CUDA tensor K2 runs once
    when components 1 and 2 have the same table (luma's below the luma
    block count, theirs above), else once per component on its
    contiguous view, then K4; on a CPU tensor the plain versions."""
    if len(shapes) not in (1, 3):
        raise ValueError(f"unsupported component count {len(shapes)} "
                         "(want 1 or 3)")
    sizes = [a * b for a, b in shapes]
    if tuple(coeffs.shape) != (sum(sizes), 8, 8):
        raise ValueError(f"coeffs: expected ({sum(sizes)}, 8, 8), got "
                         f"{tuple(coeffs.shape)}")
    q = np.ascontiguousarray(np.asarray(quants, np.int32)
                             .reshape(len(shapes), 64))
    bounds = [0, *itertools.accumulate(sizes)]
    coeffs4 = coeffs.view(1, -1, 8, 8)
    if not _on_cuda(coeffs):
        qt = torch.from_numpy(q)
        samples = torch.cat([
            dequant_idct_blocks(coeffs4[:, a:b], qt[c:c + 1], qt[c:c + 1],
                                b - a)
            for c, (a, b) in enumerate(zip(bounds[:-1], bounds[1:]))], dim=1)
        return assemble_mcu(samples[0], shapes, samplings, out_h, out_w,
                            order, mode, gray_chroma, upsample)
    from ffpic_tpu_torch.ops import cuda_jpeg
    qd = to_device(q, coeffs.device)
    samples = torch.empty_like(coeffs4)
    if len(shapes) == 3 and np.array_equal(q[1], q[2]):
        cuda_jpeg.dequant_idct(coeffs4, qd[0:1], qd[1:2], sizes[0],
                               out=samples)
    else:
        for c, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
            cuda_jpeg.dequant_idct(coeffs4[:, a:b], qd[c:c + 1], qd[c:c + 1],
                                   b - a, out=samples[:, a:b])
    return cuda_jpeg.assemble_mcu(samples[0], shapes, samplings, out_h,
                                  out_w, order, mode, gray_chroma, upsample)


def fdct_blocks(samples: torch.Tensor) -> torch.Tensor:
    """(..., 8, 8) int16 level-shifted samples -> int16 forward-DCT
    coefficients: K5 on a CUDA tensor, ``forward_dct`` on a CPU one."""
    if not _on_cuda(samples):
        return forward_dct(samples)
    from ffpic_tpu_torch.ops import cuda_jpeg
    return cuda_jpeg.fdct(samples)
