"""VP8 device stages: the residual transform (dequant, Y2 inverse WHT, DC
scatter, 4x4 inverse DCT over the whole macroblock grid) and libwebp's
fixed-point YUV to RGBA conversion with fancy chroma upsampling.

The PyTorch counterpart of ``ffpic_tpu/ops/vp8_kernels.py``.  It holds

* the plain PyTorch version of each stage: ``vp8_idct4x4``,
  ``vp8_iwht4x4``, ``vp8_residuals_plain`` (K12's function) and
  ``vp8_yuv_to_rgba_plain`` (K13's).  They run on any device and are
  the reference the CUDA kernels are held against;
* the entries the codec calls, named as the reference's:
  ``vp8_residuals`` and ``vp8_yuv_to_rgba``.  They dispatch on the
  tensor's device: a CPU tensor takes the plain version, a CUDA tensor
  the kernel of ``ops.cuda_vp8`` (which raises rather than falls back).

Every stage is integer and bit-exact with the JAX package: inputs are
wrapped to int16 where VP8's in-place int16 semantics wrap them, so
each product fits int32.  The plain versions compute in int64 and wrap
explicitly (``_wrap``).
"""

from __future__ import annotations

import torch

from ffpic_tpu_torch.ops.jpeg_kernels import _on_cuda, _wrap

_C1, _C2 = 20091, 35468


def _i16(x: torch.Tensor) -> torch.Tensor:
    """int16 wrap of an int64 tensor, kept in int64."""
    return _wrap(x, 16)


# --- plain versions -------------------------------------------------------

def vp8_idct4x4(blocks: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) int16 dequantised coefficients -> int16 residuals; the
    first pass combines rows for each column, the second the columns of
    each row (``ffpic_tpu/ops/vp8_kernels.py:28``)."""
    inp = blocks.to(torch.int64)
    i0, i1, i2, i3 = (inp[..., k, :] for k in range(4))
    a0 = i0 + i2
    a1 = i0 - i2
    a2 = ((i1 * _C2) >> 16) - i3 - ((i3 * _C1) >> 16)
    a3 = i1 + ((i1 * _C1) >> 16) + ((i3 * _C2) >> 16)
    t = torch.stack([_i16(a0 + a3), _i16(a1 + a2), _i16(a1 - a2),
                     _i16(a0 - a3)], dim=-2)
    j0, j1, j2, j3 = (t[..., :, k] for k in range(4))
    a0 = j0 + j2
    a1 = j0 - j2
    a2 = ((j1 * _C2) >> 16) - j3 - ((j3 * _C1) >> 16)
    a3 = j1 + ((j1 * _C1) >> 16) + ((j3 * _C2) >> 16)
    return torch.stack([_i16((a0 + a3 + 4) >> 3), _i16((a1 + a2 + 4) >> 3),
                        _i16((a1 - a2 + 4) >> 3), _i16((a0 - a3 + 4) >> 3)],
                       dim=-1).to(torch.int16)


def vp8_iwht4x4(blocks: torch.Tensor) -> torch.Tensor:
    """Y2 inverse WHT, (..., 4, 4) int16 -> int16
    (``ffpic_tpu/ops/vp8_kernels.py:52``)."""
    inp = blocks.to(torch.int64)
    i0, i1, i2, i3 = (inp[..., k, :] for k in range(4))
    a1, b1 = i0 + i3, i1 + i2
    c1, d1 = i1 - i2, i0 - i3
    t = torch.stack([a1 + b1, c1 + d1, a1 - b1, d1 - c1], dim=-2)
    j0, j1, j2, j3 = (t[..., :, k] for k in range(4))
    a1, b1 = j0 + j3, j1 + j2
    c1, d1 = j1 - j2, j0 - j3
    return _i16(torch.stack([(a1 + b1 + 3) >> 3, (c1 + d1 + 3) >> 3,
                             (a1 - b1 + 3) >> 3, (d1 - c1 + 3) >> 3],
                            dim=-1)).to(torch.int16)


def vp8_residuals_plain(levels: torch.Tensor, dq_per_mb: torch.Tensor,
                        has_y2: torch.Tensor) -> torch.Tensor:
    """K12's function (``ffpic_tpu/ops/vp8_kernels.py:69``): levels
    (mbh, mbw, 25, 16) int32 raw token levels, dq_per_mb (mbh, mbw, 6)
    int32 [y1dc, y1ac, y2dc, y2ac, uvdc, uvac], has_y2 (mbh, mbw) bool ->
    residuals (mbh, mbw, 24, 4, 4) int16.  Products wrap to int32 as
    the reference's do; the Y2 block wraps to int16 before its IWHT,
    a macroblock without one keeps its unwrapped int32 DC, and every
    block wraps to int16 before the IDCT."""
    lv = levels.to(torch.int64)
    dq = dq_per_mb.to(torch.int64)

    def deq(blocks, dc, ac):
        # (..., n, 16) levels times the AC factor, index 0 the DC one
        f = ac[..., None, None].expand(*blocks.shape).clone()
        f[..., 0] = dc[..., None]
        return _wrap(blocks * f, 32)

    yblk = deq(lv[..., :16, :], dq[..., 0], dq[..., 1])
    uvblk = deq(lv[..., 16:24, :], dq[..., 4], dq[..., 5])
    y2 = deq(lv[..., 24:25, :], dq[..., 2], dq[..., 3])[..., 0, :]
    wht = vp8_iwht4x4(_i16(y2).reshape(*y2.shape[:-1], 4, 4)) \
        .reshape(*y2.shape[:-1], 16).to(torch.int64)
    yblk[..., 0] = torch.where(has_y2[..., None], wht, yblk[..., 0])
    blocks = torch.cat([yblk, uvblk], dim=-2)
    return vp8_idct4x4(_i16(blocks).reshape(*blocks.shape[:-1], 4, 4))


def _fancy(c: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """libwebp's 2x fancy upsampling of a cropped (ch, cw) chroma plane
    (int64), edges replicated -> (h, w)."""
    cN = torch.cat([c[:1], c[:-1]], dim=0)
    cS = torch.cat([c[1:], c[-1:]], dim=0)

    def row_mix(a, b):
        aW = torch.cat([a[:, :1], a[:, :-1]], dim=1)
        aE = torch.cat([a[:, 1:], a[:, -1:]], dim=1)
        bW = torch.cat([b[:, :1], b[:, :-1]], dim=1)
        bE = torch.cat([b[:, 1:], b[:, -1:]], dim=1)
        left = (9 * a + 3 * (b + aW) + bW + 8) >> 4
        right = (9 * a + 3 * (b + aE) + bE + 8) >> 4
        return torch.stack([left, right], dim=2).reshape(a.shape[0], -1)

    top = row_mix(c, cN)
    bot = row_mix(c, cS)
    out = torch.stack([top, bot], dim=1).reshape(2 * c.shape[0],
                                                 2 * c.shape[1])
    return out[:h, :w]


def vp8_yuv_to_rgba_plain(Y: torch.Tensor, U: torch.Tensor, V: torch.Tensor,
                          h: int, w: int,
                          alpha: torch.Tensor | None = None) -> torch.Tensor:
    """K13's function (``ffpic_tpu/ops/vp8_kernels.py:107``, then the
    alpha write of ``ffpic_tpu/formats/webp.py:311-313``): MB-padded Y
    (>= h, >= w) and U, V uint8 planes -> (h, w, 4) uint8 RGBA.  Chroma
    is cropped to ((h + 1) // 2, (w + 1) // 2) before its edges are
    replicated; each ``_mult_hi`` term is floored on its own, then the
    sum >> 6 is clipped to 0..255.  Alpha is 255, or ``alpha`` (h, w)."""
    ch, cw = (h + 1) // 2, (w + 1) // 2
    y = Y[:h, :w].to(torch.int64)
    u = _fancy(U[:ch, :cw].to(torch.int64), h, w)
    v = _fancy(V[:ch, :cw].to(torch.int64), h, w)
    yv = (y * 19077) >> 8
    r = yv + ((v * 26149) >> 8) - 14234
    g = yv - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708
    b = yv + ((u * 33050) >> 8) - 17685
    a = (torch.full((h, w), 255, dtype=torch.uint8, device=Y.device)
         if alpha is None else alpha.to(torch.uint8))
    return torch.stack([(x >> 6).clamp(0, 255).to(torch.uint8)
                        for x in (r, g, b)] + [a], dim=-1)


# --- entries the codec calls -----------------------------------------------

def vp8_residuals(levels: torch.Tensor, dq_per_mb: torch.Tensor,
                  has_y2: torch.Tensor) -> torch.Tensor:
    """The whole frame's residuals: K12 on CUDA tensors, the plain
    ``vp8_residuals_plain`` on CPU ones."""
    if not _on_cuda(levels):
        return vp8_residuals_plain(levels, dq_per_mb, has_y2)
    from ffpic_tpu_torch.ops import cuda_vp8
    return cuda_vp8.vp8_residuals(levels, dq_per_mb, has_y2)


def vp8_yuv_to_rgba(Y: torch.Tensor, U: torch.Tensor, V: torch.Tensor,
                    h: int, w: int,
                    alpha: torch.Tensor | None = None) -> torch.Tensor:
    """MB-padded planes -> (h, w, 4) uint8 RGBA: K13 on CUDA tensors, the
    plain ``vp8_yuv_to_rgba_plain`` on CPU ones."""
    if not _on_cuda(Y):
        return vp8_yuv_to_rgba_plain(Y, U, V, h, w, alpha)
    from ffpic_tpu_torch.ops import cuda_vp8
    return cuda_vp8.vp8_yuv_to_rgba(Y, U, V, h, w, alpha)
