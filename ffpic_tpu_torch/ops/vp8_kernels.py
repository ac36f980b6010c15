"""VP8 device stages: the residual transform (dequant, Y2 inverse WHT, DC
scatter, 4x4 inverse DCT over the whole macroblock grid) and libwebp's
fixed-point YUV to RGBA conversion with fancy chroma upsampling.

The PyTorch counterpart of ``ffpic_tpu/ops/vp8_kernels.py``.  It holds

* the plain PyTorch version of each stage: ``vp8_idct4x4``,
  ``vp8_iwht4x4``, ``vp8_residuals_plain`` (K12's function) and
  ``vp8_yuv_to_rgba_plain`` (K13's, a frame;
  ``vp8_yuv_to_rgba_batch_plain`` over a list).  They run on any device
  and are the reference the CUDA kernels are held against;
* ``stage_frames``, which copies a list of frames' planes to the device
  in one buffer, each plane at a 16-byte-aligned offset and pitch;
* the entries the codec calls: ``vp8_residuals``, and
  ``vp8_yuv_to_rgba_batch`` (a batch's WebP stills) with
  ``vp8_yuv_to_rgba`` (one still, the reference's name).  They dispatch
  on the tensors' device: CPU tensors take the plain version, CUDA
  tensors the kernel of ``ops.cuda_vp8`` (which raises rather than
  falls back), one launch over the list.

Every stage is integer and bit-exact with the JAX package: inputs are
wrapped to int16 where VP8's in-place int16 semantics wrap them, so
each product fits int32.  The plain versions compute in int64 and wrap
explicitly (``_wrap``).
"""

from __future__ import annotations

import numpy as np
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
    sum >> 6 is clipped to 0..255.  Alpha is 255, or ``alpha`` (>= h,
    >= w)."""
    ch, cw = (h + 1) // 2, (w + 1) // 2
    y = Y[:h, :w].to(torch.int64)
    u = _fancy(U[:ch, :cw].to(torch.int64), h, w)
    v = _fancy(V[:ch, :cw].to(torch.int64), h, w)
    yv = (y * 19077) >> 8
    r = yv + ((v * 26149) >> 8) - 14234
    g = yv - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708
    b = yv + ((u * 33050) >> 8) - 17685
    a = (torch.full((h, w), 255, dtype=torch.uint8, device=Y.device)
         if alpha is None else alpha[:h, :w].to(torch.uint8))
    return torch.stack([(x >> 6).clamp(0, 255).to(torch.uint8)
                        for x in (r, g, b)] + [a], dim=-1)


def batch_outputs(frames, out=None) -> tuple:
    """The outputs of a K13 list of ``frames`` ((Y, U, V, h, w, alpha)
    each): ``out`` as given, a (k, h, w, 4) uint8 tensor or a sequence of
    (h_k, w_k, 4) ones, checked against the frames' sizes; or, when None,
    allocated on the first frame's device: one (k, h, w, 4) tensor where
    every frame has one size, else one tensor a frame.  Returns (out, its
    (h, w, 4) views in frame order)."""
    if not frames:
        raise ValueError("vp8_yuv_to_rgba: no frames")
    sizes = [(int(f[3]), int(f[4])) for f in frames]
    if out is None:
        dev = frames[0][0].device
        out = (torch.empty((len(sizes), *sizes[0], 4), dtype=torch.uint8,
                           device=dev) if len(set(sizes)) == 1 else
               [torch.empty((h, w, 4), dtype=torch.uint8, device=dev)
                for h, w in sizes])
    views = list(out)
    if len(views) != len(sizes) or any(
            not isinstance(v, torch.Tensor) or v.dtype != torch.uint8
            or tuple(v.shape) != (h, w, 4) or not v.is_contiguous()
            for v, (h, w) in zip(views, sizes)):
        raise ValueError("out: expected a contiguous (h, w, 4) uint8 tensor "
                         f"a frame, sizes {sizes}")
    return out, views


def vp8_yuv_to_rgba_batch_plain(frames, out=None):
    """K13's function over a list of ``frames`` (Y, U, V, h, w, alpha):
    ``vp8_yuv_to_rgba_plain`` a frame, into ``batch_outputs``."""
    out, views = batch_outputs(frames, out)
    for (Y, U, V, h, w, alpha), v in zip(frames, views):
        v.copy_(vp8_yuv_to_rgba_plain(Y, U, V, int(h), int(w), alpha))
    return out


# --- staging ---------------------------------------------------------------

ALIGN = 16


def stage_frames(yuvas, device) -> list:
    """The host side of a K13 launch: ``yuvas`` each frame's (Y, U, V,
    h, w, alpha) as numpy uint8 planes, Y MB-padded (>= h, >= w), U and
    V (>= (h + 1) // 2, >= (w + 1) // 2), alpha (h, w) or None.  Only
    each plane's cropped part is copied, so the MB padding is never read,
    into one buffer: every plane at an offset of a multiple of ``ALIGN``
    bytes, its rows at a pitch of a multiple of ``ALIGN``; through pinned
    memory in one copy on CUDA.  Returns the frames as (Y, U, V, h, w,
    alpha) views of the buffer on ``device``."""
    layout, pos = [], 0
    for Y, U, V, h, w, alpha in yuvas:
        h, w = int(h), int(w)
        ch, cw = (h + 1) // 2, (w + 1) // 2
        planes = [(Y, h, w), (U, ch, cw), (V, ch, cw)]
        if alpha is not None:
            planes.append((alpha, h, w))
        entry = []
        for p, rows, cols in planes:
            if p.dtype != np.uint8 or p.ndim != 2 or p.shape[0] < rows \
                    or p.shape[1] < cols or rows <= 0 or cols <= 0:
                raise ValueError(f"plane {p.dtype} {p.shape}: a {w}x{h} "
                                 f"frame needs {rows}x{cols} uint8")
            pitch = -(-cols // ALIGN) * ALIGN
            entry.append((p, pos, rows, cols, pitch))
            pos += rows * pitch
        layout.append((h, w, entry))
    host = torch.empty(pos, dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    for _h, _w, entry in layout:
        for p, at, rows, cols, pitch in entry:
            # torch's copy runs on its intra-op threads, numpy's on one
            src = torch.from_numpy(p if p.flags.writeable else p.copy())
            host[at:at + rows * pitch].view(rows, pitch)[:, :cols].copy_(
                src[:rows, :cols])
    dev = host.to(device, non_blocking=True)
    frames = []
    for h, w, entry in layout:
        views = [dev[at:at + rows * pitch].view(rows, pitch)[:, :cols]
                 for _p, at, rows, cols, pitch in entry]
        frames.append((*views[:3], h, w, views[3] if len(views) == 4
                       else None))
    return frames


# --- entries the codec calls -----------------------------------------------

def vp8_residuals(levels: torch.Tensor, dq_per_mb: torch.Tensor,
                  has_y2: torch.Tensor) -> torch.Tensor:
    """The whole frame's residuals: K12 on CUDA tensors, the plain
    ``vp8_residuals_plain`` on CPU ones."""
    if not _on_cuda(levels):
        return vp8_residuals_plain(levels, dq_per_mb, has_y2)
    from ffpic_tpu_torch.ops import cuda_vp8
    return cuda_vp8.vp8_residuals(levels, dq_per_mb, has_y2)


def vp8_yuv_to_rgba_batch(frames, out=None):
    """K13 over a list of frames (Y, U, V, h, w, alpha), into
    ``batch_outputs``: one launch of the kernel of ``ops.cuda_vp8`` on
    CUDA tensors, ``vp8_yuv_to_rgba_batch_plain`` on CPU ones."""
    frames = list(frames)
    if not frames:
        raise ValueError("vp8_yuv_to_rgba: no frames")
    cuda = {_on_cuda(f[0]) for f in frames}
    if len(cuda) != 1:
        raise ValueError("vp8_yuv_to_rgba: frames on the CPU and on CUDA")
    if not cuda.pop():
        return vp8_yuv_to_rgba_batch_plain(frames, out)
    from ffpic_tpu_torch.ops import cuda_vp8
    return cuda_vp8.vp8_yuv_to_rgba_batch(frames, out)


def vp8_yuv_to_rgba(Y: torch.Tensor, U: torch.Tensor, V: torch.Tensor,
                    h: int, w: int,
                    alpha: torch.Tensor | None = None) -> torch.Tensor:
    """MB-padded planes -> (h, w, 4) uint8 RGBA: ``vp8_yuv_to_rgba_batch``
    with one frame."""
    return vp8_yuv_to_rgba_batch([(Y, U, V, h, w, alpha)])[0]
