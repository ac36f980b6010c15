"""PNG device stages: the None/Sub/Up scanline reconstruction and the
per-pixel conversion of reconstructed rows to RGBA.

The PyTorch counterpart of ``ffpic_tpu/ops/png_kernels.py``.  It holds

* the plain PyTorch version of each device stage: ``unfilter_subup``
  (K6) and ``expand_rgba`` (K7) with its sample unpack
  ``unpack_samples``, which K7 computes inside.  They run on any device
  and are the reference the CUDA kernels are held against;
* the entries the codec calls, named as the reference's:
  ``unfilter_device_subup`` and ``assemble_rgba``.  They dispatch on the
  tensor's device: a CPU tensor takes the plain version, a CUDA tensor
  the kernel of ``ops.cuda_png`` (which raises rather than falls back).

Both stages are integer and bit-exact with the JAX package.  The
palette (256, 4) uint8 and the tRNS table (256,) int32 (per-index alpha,
or the colour key in entries 0-2, -1 where absent) are host numpy
arrays, as the codec's parse makes them.
"""

from __future__ import annotations

import numpy as np
import torch

from ffpic_tpu_torch.ops.jpeg_kernels import _on_cuda

# the (colour type, bit depths) the PNG specification allows
LEGAL = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
         6: (8, 16)}
NCH = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def check_format(color_type: int, bitdepth: int) -> None:
    if bitdepth not in LEGAL.get(color_type, ()):
        raise ValueError(f"unsupported PNG colour type {color_type} at bit "
                         f"depth {bitdepth}")


# --- plain versions -------------------------------------------------------

def unpack_samples(rows: torch.Tensor, bitdepth: int,
                   width: int) -> torch.Tensor:
    """(H, stride) uint8 packed rows -> (H, width) int64 samples: 8-bit
    as they are, 16-bit big-endian, 1/2/4-bit MSB-first with each row's
    padding bits dropped (``png_kernels.py:21``)."""
    if bitdepth == 8:
        return rows[:, :width].to(torch.int64)
    if bitdepth == 16:
        hi = rows[:, 0:2 * width:2].to(torch.int64)
        lo = rows[:, 1:2 * width:2].to(torch.int64)
        return (hi << 8) | lo
    per = 8 // bitdepth
    shifts = torch.arange(per - 1, -1, -1, device=rows.device) * bitdepth
    vals = (rows[:, :, None].to(torch.int64) >> shifts) & ((1 << bitdepth) - 1)
    return vals.reshape(rows.shape[0], -1)[:, :width]


def expand_rgba(recon: torch.Tensor, palette: np.ndarray, trns: np.ndarray,
                color_type: int, bitdepth: int, width: int,
                height: int) -> torch.Tensor:
    """(H, stride) uint8 reconstructed rows -> (H, W, 4) uint8 RGBA (K7),
    ``png_kernels.py:40``: palette gather with per-index tRNS alpha; gray
    and truecolour with the tRNS colour key compared on the samples
    before scaling; 16-bit scaled by >> 8, 1/2/4-bit by v * 255 // max."""
    check_format(color_type, bitdepth)
    dev = recon.device
    if width == 0 or height == 0:
        return torch.zeros((height, width, 4), dtype=torch.uint8, device=dev)
    pal = torch.from_numpy(np.asarray(palette, np.uint8)).to(dev)
    key = torch.from_numpy(np.asarray(trns, np.int32)).to(dev)

    def scale(v):
        if bitdepth == 16:
            return (v >> 8).to(torch.uint8)
        if bitdepth == 8:
            return v.to(torch.uint8)
        return (v * 255 // ((1 << bitdepth) - 1)).to(torch.uint8)

    def opaque_unless(hit):
        return torch.where(hit, 0, 255).to(torch.uint8)

    if color_type == 3:
        idx = unpack_samples(recon, bitdepth, width).clamp(0, 255)
        alpha = key[idx]
        rgba = pal[idx].clone()
        rgba[..., 3] = torch.where(alpha >= 0, alpha, 255).to(torch.uint8)
        return rgba
    nch = NCH[color_type]
    s = unpack_samples(recon, bitdepth, width * nch).reshape(height, width,
                                                             nch)
    if color_type == 0:
        g = scale(s[..., 0])
        a = opaque_unless((key[0] >= 0) & (s[..., 0] == key[0]))
        return torch.stack([g, g, g, a], dim=-1)
    if color_type == 4:
        g = scale(s[..., 0])
        return torch.stack([g, g, g, scale(s[..., 1])], dim=-1)
    if color_type == 2:
        hit = ((key[0] >= 0) & (s[..., 0] == key[0]) & (s[..., 1] == key[1])
               & (s[..., 2] == key[2]))
        return torch.stack([scale(s[..., c]) for c in range(3)]
                           + [opaque_unless(hit)], dim=-1)
    return torch.stack([scale(s[..., c]) for c in range(4)], dim=-1)


def unfilter_subup(tagged: torch.Tensor, bpp: int) -> torch.Tensor:
    """(H, stride + 1) uint8 filtered rows as the file has them, each its
    filter type in {0, 1, 2} and then its bytes -> (H, stride) uint8
    reconstructed rows (K6), ``png_kernels.py:89``: a Sub row is a
    cumulative sum mod 256 over its bpp-strided lanes; an Up row adds the
    row above, so each column is a cumulative sum mod 256 in segments
    that restart at every row whose filter is not Up (a first row of Up
    adds zeros)."""
    rows = tagged[:, 1:]
    h, stride = rows.shape
    x = rows.to(torch.int64)
    if h == 0 or stride == 0:
        return rows.new_zeros((h, stride))
    pad = (-stride) % bpp
    lanes = torch.nn.functional.pad(x, (0, pad)).view(h, -1, bpp)
    sub = (torch.cumsum(lanes, dim=1) & 255).view(h, -1)[:, :stride]
    f = tagged[:, 0].to(torch.int64)
    subbed = torch.where((f == 1)[:, None], sub, x)
    idx = torch.arange(h, device=rows.device)
    last_reset = torch.cummax(torch.where(f != 2, idx, -1), dim=0).values
    last_reset = last_reset.clamp(min=0)
    total = torch.cumsum(subbed, dim=0)
    out = (total - total[last_reset] + subbed[last_reset]) & 255
    return out.to(torch.uint8)


def unfilter_subup_bands(tagged: torch.Tensor, bpp: int, rows: int,
                         chunk: int, block: int = 32) -> torch.Tensor:
    """``unfilter_subup`` computed as K6 decomposes it: bands of ``rows``
    rows, each walked in column chunks of ``chunk`` bytes (a multiple of
    lcm(4, bpp)) with each Sub row's last bpp bytes carried into its next
    chunk; within a band the column scan starts from zero, and the band
    publishes its last row as INC (final: it has a restart, or is the
    first band) or AGG (its column sums); a block of ``block`` bands
    none of which has a restart also publishes the sum of its AGGs.
    Every band publishes first; then the bands look back last to first,
    as late as they can: a band whose first row is Up adds the nearest
    INC among the bands above it in its block and the AGGs below that,
    or all of their AGGs and then, block by block, each block's last
    band's INC or the block's sum (resolving that band first when it has
    neither yet, as the kernel waits for it); it adds that carry to its
    rows above its first restart, and a band without one turns INC."""
    h, stride = tagged.shape[0], tagged.shape[1] - 1
    if h == 0 or stride == 0:
        return tagged.new_zeros((h, stride))
    tags = tagged[:, 0].tolist()
    x = tagged[:, 1:].to(torch.int64)
    out = torch.zeros((h, stride), dtype=torch.int64, device=tagged.device)
    nb = -(-h // rows)
    state, payload, first = [None] * nb, [None] * nb, [0] * nb
    for b in range(nb):
        y0, y1 = b * rows, min(h, b * rows + rows)
        carry = torch.zeros((y1 - y0, bpp), dtype=torch.int64,
                            device=tagged.device)
        for x0 in range(0, stride, chunk):
            t = x[y0:y1, x0:x0 + chunk]
            cw = t.shape[1]
            lanes = torch.nn.functional.pad(t, (0, (-cw) % bpp)).view(
                y1 - y0, -1, bpp)
            sub = (torch.cumsum(lanes, 1) + carry[:, None]) & 255
            carry = sub[:, -1]
            sub = sub.view(y1 - y0, -1)[:, :cw]
            v = torch.zeros(cw, dtype=torch.int64, device=tagged.device)
            for r in range(y1 - y0):
                row = sub[r] if tags[y0 + r] == 1 else t[r]
                v = (v + row) & 255 if tags[y0 + r] == 2 else row
                out[y0 + r, x0:x0 + cw] = v
        first[b] = next((r for r in range(y1 - y0) if tags[y0 + r] != 2),
                        y1 - y0)
        state[b] = "inc" if b == 0 or first[b] < y1 - y0 else "agg"
        payload[b] = out[y1 - 1].clone()
    # the sums of the blocks whose bands all publish AGG
    block_sum = {k: sum(payload[k * block:k * block + block]) & 255
                 for k in range(1, nb // block)
                 if all(state[p] == "agg"
                        for p in range(k * block, k * block + block))}

    def carry(b):
        """(the carry into band b, None), or (None, the band whose INC it
        waits for)."""
        k = b // block
        near = [p for p in range(b - 1, k * block - 1, -1)
                if state[p] == "inc"]
        c = sum(payload[p] for p in range(near[0] if near else k * block, b))
        if near:
            return c & 255, None
        for kk in range(k - 1, -1, -1):
            end = kk * block + block - 1
            if state[end] == "inc":
                return (c + payload[end]) & 255, None
            if kk not in block_sum:
                return None, end
            c = c + block_sum[kk]
        return c & 255, None

    done = set()

    def resolve(b):
        todo = [b]
        while todo:
            b = todo[-1]
            if b == 0 or first[b] == 0 or b in done:
                todo.pop()
                continue
            c, wait = carry(b)
            if wait is not None:
                todo.append(wait)
                continue
            y0, y1 = b * rows, min(h, b * rows + rows)
            out[y0:y0 + first[b]] = (out[y0:y0 + first[b]] + c) & 255
            if state[b] == "agg":
                state[b], payload[b] = "inc", out[y1 - 1].clone()
            done.add(b)
            todo.pop()

    for b in range(nb - 1, -1, -1):
        resolve(b)
    return out.to(torch.uint8)


# --- entries the codec calls -----------------------------------------------

def unfilter_device_subup(tagged: torch.Tensor, bpp: int) -> torch.Tensor:
    """Reconstruct filter-tagged rows, (H, stride + 1) uint8, whose
    filters are all None, Sub or Up: K6 on a CUDA tensor (any row pitch),
    the plain ``unfilter_subup`` on a CPU one.  The reference takes the
    tags as an array of their own; here each row's first byte is its
    tag.  Returns (H, stride) uint8, on CUDA a view of a buffer whose
    rows are 16-byte aligned."""
    if not _on_cuda(tagged):
        return unfilter_subup(tagged, bpp)
    from ffpic_tpu_torch.ops import cuda_png
    return cuda_png.unfilter_subup(tagged, bpp)


def assemble_rgba(recon: torch.Tensor, palette: np.ndarray, trns: np.ndarray,
                  color_type: int, bitdepth: int, width: int,
                  height: int) -> torch.Tensor:
    """Reconstructed rows -> (H, W, 4) uint8 RGBA: K7 on a CUDA tensor,
    the plain ``expand_rgba`` on a CPU one."""
    if not _on_cuda(recon):
        return expand_rgba(recon, palette, trns, color_type, bitdepth, width,
                           height)
    from ffpic_tpu_torch.ops import cuda_png
    return cuda_png.assemble_rgba(recon, palette, trns, color_type, bitdepth,
                                  width, height)
