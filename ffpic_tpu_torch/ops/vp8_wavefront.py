"""VP8 luma intra reconstruction of a whole frame (B12): the PyTorch
counterpart of ``ffpic_tpu/ops/vp8_wavefront.py``.

``make_wavefront(mbh, mbw)`` returns, as the original's (``:171``) does,
``fn(residual (mbh, mbw, 16, 4, 4) int32, ymode (mbh, mbw) int32,
bmodes (mbh, mbw, 16) int32) -> Y (16 mbh, 16 mbw) uint8``: each
macroblock (MB) predicted from its reconstructed neighbours, plus its
residual, clipped.  The function dispatches on the inputs' device: a CPU
tensor takes ``vp8_wavefront_plain``, a CUDA tensor the hand-written
kernel K18 of ``ops.cuda_vp8`` (which raises rather than falls back), and
numpy arrays go to ``resolve_device(None)``, CUDA, which raises without
a card.

``vp8_wavefront_plain`` walks the MB anti-diagonals ``d = 2 my + mx``,
vectorised over the MBs of one diagonal: an MB needs its left, upper and
upper-right neighbours, which lie on diagonals d - 1 and d - 2
(``:6-9``).  Each MB reads a 17 x 21 patch of the padded plane: the row
above (the corner, 16 pixels, 4 above-right), then the left column and
the MB.  The rules, all the original's:

* DC, V, H and TM at 16 x 16 (``_mb16_pred``, ``:152``): DC averages the
  edges that exist (``:160-163``), 128 without either; ``ymode`` other
  than B_PRED is clipped to 0..3 (``:199``).
* B_PRED (``ymode == 4``, ``:224``): the 16 4 x 4 subblocks in raster
  order, each from the nine pixels above it (corner, 4, 4 above-right)
  and the four to its left, over the ten B-modes in bitstream order, RD
  and VR before LD (``_pred4``, ``:55``; ``:38-39``); a B-mode indexes
  the ten predictions as JAX indexes, negative values from the end and
  the rest clamped into 0..9.
* The virtual row above the frame is 127, its corner too, and the
  virtual column left of it 129 (``:247-248``).
* The above-right pixels past the frame's last column repeat the row
  above at column W - 1 (``:189``).
* Subblocks of the right column take, at every row, the above-right
  pixels of the MB's row above, ``bp[0, 17:21]`` (``:217``), not the
  pixels of the subblock up and to the right.
* The residual is added to the prediction in int32 (two's complement),
  then clipped to 0..255.

The padded plane keeps the virtual row and column; the original's dump
column for lanes off the diagonal has no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from ffpic_tpu_torch.ops.jpeg_kernels import _on_cuda
from ffpic_tpu_torch.utils.device import resolve_device

B_PRED = 4
B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU = range(10)

# the edges of a subblock, as _pred4 names them: the corner X, the four
# above A..D, the four above-right E..H, the four to the left I..L
X, A, B, C, D, E, F, G, H, I, J, K, L = range(13)


def _avg2(a, b):
    return (a, a, b, b)           # (2a + 2b + 2) >> 2 == (a + b + 1) >> 1


def _avg3(a, b, c):
    return (a, b, b, c)


def _b4_taps() -> torch.Tensor:
    """(10, 16, 4): for each B-mode other than DC and TM (zeros there) and
    each pixel r * 4 + c of the subblock, four edges whose sum + 2, >> 2,
    is the prediction; transcribed from ``_pred4`` (``:55-148``)."""
    t = np.zeros((10, 4, 4, 4), np.int64)
    for r in range(4):
        for c in range(4):
            t[B_VE, r, c] = _avg3(X + c, A + c, B + c)    # X,A,B .. C,D,E
    hcol = [_avg3(X, I, J), _avg3(I, J, K), _avg3(J, K, L), _avg3(K, L, L)]
    for r in range(4):
        t[B_HE, r, :] = hcol[r]
    ld = [_avg3(A + k, B + k, C + k) for k in range(6)] + [_avg3(G, H, H)]
    rd = [_avg3(J, K, L), _avg3(I, J, K), _avg3(X, I, J), _avg3(A, X, I),
          _avg3(B, A, X), _avg3(C, B, A), _avg3(D, C, B)]
    for r in range(4):
        for c in range(4):
            t[B_LD, r, c] = ld[r + c]
            t[B_RD, r, c] = rd[3 - r + c]

    def put(mode, value, *at):
        for r, c in at:
            t[mode, r, c] = value

    put(B_VR, _avg2(X, A), (0, 0), (2, 1))
    put(B_VR, _avg2(A, B), (0, 1), (2, 2))
    put(B_VR, _avg2(B, C), (0, 2), (2, 3))
    put(B_VR, _avg2(C, D), (0, 3))
    put(B_VR, _avg3(I, X, A), (1, 0), (3, 1))
    put(B_VR, _avg3(X, A, B), (1, 1), (3, 2))
    put(B_VR, _avg3(A, B, C), (1, 2), (3, 3))
    put(B_VR, _avg3(B, C, D), (1, 3))
    put(B_VR, _avg3(J, I, X), (2, 0))
    put(B_VR, _avg3(K, J, I), (3, 0))
    put(B_VL, _avg2(A, B), (0, 0))
    put(B_VL, _avg2(B, C), (0, 1), (2, 0))
    put(B_VL, _avg2(C, D), (0, 2), (2, 1))
    put(B_VL, _avg2(D, E), (0, 3), (2, 2))
    put(B_VL, _avg3(E, F, G), (2, 3))
    put(B_VL, _avg3(A, B, C), (1, 0))
    put(B_VL, _avg3(B, C, D), (1, 1), (3, 0))
    put(B_VL, _avg3(C, D, E), (1, 2), (3, 1))
    put(B_VL, _avg3(D, E, F), (1, 3), (3, 2))
    put(B_VL, _avg3(F, G, H), (3, 3))
    put(B_HD, _avg2(X, I), (0, 0), (1, 2))
    put(B_HD, _avg3(I, X, A), (0, 1), (1, 3))
    put(B_HD, _avg3(X, A, B), (0, 2))
    put(B_HD, _avg3(A, B, C), (0, 3))
    put(B_HD, _avg2(I, J), (1, 0), (2, 2))
    put(B_HD, _avg3(X, I, J), (1, 1), (2, 3))
    put(B_HD, _avg2(J, K), (2, 0), (3, 2))
    put(B_HD, _avg3(I, J, K), (2, 1), (3, 3))
    put(B_HD, _avg2(K, L), (3, 0))
    put(B_HD, _avg3(J, K, L), (3, 1))
    put(B_HU, _avg2(I, J), (0, 0))
    put(B_HU, _avg3(I, J, K), (0, 1))
    put(B_HU, _avg2(J, K), (0, 2), (1, 0))
    put(B_HU, _avg3(J, K, L), (0, 3), (1, 1))
    put(B_HU, _avg2(K, L), (1, 2), (2, 0))
    put(B_HU, _avg3(K, L, L), (1, 3), (2, 1))
    put(B_HU, (L, L, L, L), (2, 2), (2, 3), (3, 0), (3, 1), (3, 2), (3, 3))
    return torch.from_numpy(t.reshape(10, 16, 4))


B4_TAPS = _b4_taps()


def b_modes(bmodes: torch.Tensor) -> torch.Tensor:
    """B-modes as the original's ``stacked[mode]`` (``:149``) takes them:
    a negative one from the end, then clamped into 0..9 (int64)."""
    m = bmodes.to(torch.int64)
    return torch.where(m < 0, m + 10, m).clamp(0, 9)


def _clip(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(0, 255)


def _add(pred: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
    """clip(pred + res), the sum wrapped to int32 as the original's."""
    return _clip((pred.to(torch.int64) + res.to(torch.int64)).to(
        torch.int32))


def _pred4(mode: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """(m,) B-modes in 0..9 and (m, 13) int32 edges -> (m, 16) int32."""
    m = e.shape[0]
    taps = B4_TAPS.to(e.device)[mode]                        # (m, 16, 4)
    avg = (e.gather(1, taps.view(m, 64)).view(m, 16, 4).sum(-1) + 2) >> 2
    dc = ((e[:, A:E].sum(1) + e[:, I:].sum(1) + 4) >> 3)[:, None]
    tm = _clip(e[:, I:, None] + e[:, None, A:E] - e[:, X, None, None])
    return torch.where(mode[:, None] == B_DC, dc.expand(m, 16),
                       torch.where(mode[:, None] == B_TM, tm.reshape(m, 16),
                                   avg)).to(torch.int32)


def _mb16(patch: torch.Tensor, has_top, has_left, mode) -> torch.Tensor:
    """(n, 17, 21) patches -> (n, 16, 16) 16 x 16 predictions, modes 0..3
    (``_mb16_pred``)."""
    top, left, corner = patch[:, 0, 1:17], patch[:, 1:17, 0], patch[:, 0, 0]
    s_top, s_left = top.sum(1), left.sum(1)
    dc = torch.where(has_top & has_left, (s_top + s_left + 16) >> 5,
                     torch.where(has_top, (s_top + 8) >> 4,
                                 torch.where(has_left, (s_left + 8) >> 4,
                                             128)))
    n = patch.shape[0]
    preds = torch.stack([
        dc[:, None, None].expand(n, 16, 16),
        top[:, None, :].expand(n, 16, 16),
        left[:, :, None].expand(n, 16, 16),
        _clip(left[:, :, None] + top[:, None, :] - corner[:, None, None])], 1)
    return preds[torch.arange(n, device=patch.device), mode]


def vp8_wavefront_plain(residual: torch.Tensor, ymode: torch.Tensor,
                        bmodes: torch.Tensor) -> torch.Tensor:
    """K18's function: residual (mbh, mbw, 16, 4, 4), ymode (mbh, mbw) and
    bmodes (mbh, mbw, 16), integer tensors on any one device -> Y (16 mbh,
    16 mbw) uint8 there (``ffpic_tpu/ops/vp8_wavefront.py:171``)."""
    mbh, mbw = ymode.shape
    hh, ww = 16 * mbh, 16 * mbw
    dev = residual.device
    i32 = torch.int32
    # row 0 the virtual 127 row (corner included), column 0 the virtual 129
    yp = torch.full((hh + 1, ww + 1), 127, dtype=i32, device=dev)
    yp[1:, 0] = 129
    res = residual.to(i32).reshape(mbh, mbw, 16, 16)
    # (sy, sx, r, c) -> (4 sy + r, 4 sx + c)
    res16 = res.view(mbh, mbw, 4, 4, 4, 4).permute(0, 1, 2, 4, 3, 5) \
        .reshape(mbh, mbw, 16, 16)
    ym = ymode.to(torch.int64)
    bm = b_modes(bmodes)
    ar16 = torch.arange(16, device=dev)
    ar17 = torch.arange(17, device=dev)
    ar21 = torch.arange(21, device=dev)
    for d in range(2 * (mbh - 1) + mbw):
        my = torch.arange(max(0, (d - mbw + 2) // 2), min(mbh - 1, d // 2) + 1,
                          device=dev)
        mx = d - 2 * my
        rows = my[:, None] * 16 + ar17
        cols = (mx[:, None] * 16 + ar21).clamp(max=ww)
        patch = yp[rows[:, :, None], cols[:, None, :]]            # (n, 17, 21)
        mode = ym[my, mx]
        tile = _add(_mb16(patch, my > 0, mx > 0, mode.clamp(0, 3)),
                    res16[my, mx])
        bsel = (mode == B_PRED).nonzero()[:, 0]
        if bsel.numel():
            bp = patch[bsel].clone()
            bres = res[my[bsel], mx[bsel]]                          # (m, 16, 16)
            bmode = bm[my[bsel], mx[bsel]]                          # (m, 16)
            for sb in range(16):
                sy, sx = divmod(sb, 4)
                py, px = 1 + 4 * sy, 1 + 4 * sx
                above = (bp[:, py - 1, px - 1:px + 8] if sx < 3 else
                         torch.cat([bp[:, py - 1, px - 1:px + 4],
                                    bp[:, 0, 17:21]], 1))
                e = torch.cat([above, bp[:, py:py + 4, px - 1]], 1)
                rec = _add(_pred4(bmode[:, sb], e), bres[:, sb])
                bp[:, py:py + 4, px:px + 4] = rec.view(-1, 4, 4)
            tile[bsel] = bp[:, 1:17, 1:17]
        yp[(1 + 16 * my)[:, None, None] + ar16[:, None],
           (1 + 16 * mx)[:, None, None] + ar16] = tile
    return yp[1:, 1:].to(torch.uint8)


def _check(residual, bmodes, mbh: int, mbw: int) -> None:
    for name, t, shape in (("residual", residual, (mbh, mbw, 16, 4, 4)),
                           ("bmodes", bmodes, (mbh, mbw, 16))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")


def make_wavefront(mbh: int, mbw: int):
    """The reconstructor of an ``mbh`` x ``mbw`` MB frame: ``fn(residual,
    ymode, bmodes) -> Y (16 mbh, 16 mbw) uint8`` on the inputs' device,
    K18 on CUDA, the plain version on the CPU; numpy inputs go to CUDA."""
    if mbh <= 0 or mbw <= 0:
        raise ValueError(f"{mbh}x{mbw} macroblocks: both must be positive")

    def run(residual, ymode, bmodes):
        if not isinstance(residual, torch.Tensor):
            dev = resolve_device(None, "vp8_wavefront")
            residual, ymode, bmodes = (
                torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
                for a in (residual, ymode, bmodes))
        if tuple(ymode.shape) != (mbh, mbw):
            raise ValueError(f"ymode: expected shape {(mbh, mbw)}, got "
                             f"{tuple(ymode.shape)}")
        if _on_cuda(residual):      # the wrapper checks the rest
            from ffpic_tpu_torch.ops import cuda_vp8
            return cuda_vp8.vp8_wavefront(residual, ymode, bmodes)
        _check(residual, bmodes, mbh, mbw)
        return vp8_wavefront_plain(residual, ymode, bmodes)

    return run
