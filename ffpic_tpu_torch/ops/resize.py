"""Resize and normalisation of decoded RGBA images for a model
(BASELINE config 5): the PyTorch counterpart of ``ffpic_tpu/ops/resize.py``.

It holds

* ``resize_rgba_plain`` (K16's function), ``resize_batch_plain`` (K16's
  over a batch of slots of any sizes: each slot resized alone, stacked)
  and ``normalize_plain`` (K17's), the plain PyTorch versions.  They run
  on any device and are the reference the CUDA kernels are held against;
* the entries named as the reference's, ``resize_rgba``,
  ``resize_batch_rgba`` and ``normalize_for_model``, and
  ``resize_batch``, ``decode_batch``'s resize of its slots.  They
  dispatch on the tensor's device: a CPU tensor takes the plain
  version, a CUDA tensor the kernel of ``ops.cuda_resize`` (which
  raises rather than falls back; one launch over all the images).

The resize is ``jax.image.resize(x, ..., method)``, for every method
JAX takes (``METHODS``): ``"bilinear"`` (also ``"linear"``,
``"trilinear"``, ``"triangle"``), ``"cubic"`` (``"bicubic"``,
``"tricubic"``; Keys' cubic), ``"lanczos3"``, ``"lanczos5"`` and
``"nearest"``.  Per axis, H first and then W, the result rounded to
float32 after each axis, as JAX rounds its f32 products; an axis whose
size does not change is skipped, as JAX skips it.  The kernels other
than nearest are widened by 1/scale when shrinking (JAX antialiases by
default; ``F.interpolate`` does not).  Each output index reads a run of
inputs (its taps: the first input index and the run's nonzero f32
weights, ``taps``).  The bilinear weights are the ones XLA's CPU backend
computes inside the jitted original (``_weight_mat``); the cubic and
Lanczos weights follow ``jax._src.image.scale.compute_weight_mat`` in
float32 (``_kernel_weight_mat``), without XLA's FMA choices; nearest
is one tap of weight 1 at ``floor((j + 0.5) * in / out)`` as XLA's CPU
backend computes JAX's ``_resize_nearest`` (``_nearest_mat``).
Both the plain versions and the kernels sum a run in float64, in
ascending input order, so they agree bit for bit: the plain versions
round a product and then a sum to float64, the kernels take one fused
multiply-add, which rounds the same since every product is exact in
float64 (at most 24 + 24 bits).  On the first axis
of ``resize_rgba`` the products (uint8 x f32) and their sums are exact
in float64.  The sums run in another order and width than XLA's f32
dot, so a value can land on the other side of .5 before
``resize_rgba`` rounds it: outputs agree with the JAX package to 1 LSB,
and ``normalize_for_model``'s to a few float32 ulps (bit for bit
without a resize).  The cubic and Lanczos outputs agree with the JAX
package's to 1 LSB too (their weights differ from XLA's by an ulp or so,
its ``sin`` from PyTorch's among them), nearest's exactly.
``normalize_for_model`` is bilinear, as in the reference.  Nothing here
reads or changes a global matmul precision setting.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ffpic_tpu_torch.ops.jpeg_kernels import _on_cuda
from ffpic_tpu_torch.utils.device import resolve_device, to_device

F32, F64 = torch.float32, torch.float64
MEAN = STD = (0.5, 0.5, 0.5)          # the reference's defaults

# jax.image.ResizeMethod.from_string's names -> the kernel each takes
METHODS = {"nearest": "nearest", "linear": "linear", "bilinear": "linear",
           "trilinear": "linear", "triangle": "linear", "cubic": "cubic",
           "bicubic": "cubic", "tricubic": "cubic", "lanczos3": "lanczos3",
           "lanczos5": "lanczos5"}


def kernel_of(method: str) -> str:
    """The kernel of a ``jax.image.resize`` method name (``METHODS``);
    ``ValueError`` on any other name, as JAX raises."""
    try:
        return METHODS[method]
    except (KeyError, TypeError):
        raise ValueError(f'Unknown resize method "{method}"') from None


def _fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` of float32 values rounded once to float32, as the
    fused multiply-add that XLA's CPU backend emits: the product is exact
    in float64, the sum is rounded to odd there (its TwoSum error breaks
    an even result toward the exact value), so the one rounding to
    float32 that follows is correct."""
    p = a.to(F64) * torch.as_tensor(b, dtype=F64, device=a.device)
    c = torch.as_tensor(c, dtype=F64, device=a.device)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    s = torch.where(even & (err != 0), torch.nextafter(s, s + err), s)
    return s.to(F32)


def _xla_column_sum(w: torch.Tensor) -> torch.Tensor:
    """Column sums of (n, m) float32 as XLA's CPU backend takes them
    (its tree-reduction rewrite of ``jnp.sum(axis=0)``): while more than
    32 rows are left, pad with zero rows, pad // 2 above and the rest
    below, to a multiple of 32, and sum each window of 32 rows in order;
    then sum the rows left in order.  Every add rounds to float32."""
    while w.shape[0] > 32:
        pad = -w.shape[0] % 32
        w = torch.nn.functional.pad(w, (0, 0, pad // 2, pad - pad // 2))
        w = w.view(-1, 32, w.shape[1])
        acc = w[:, 0]
        for k in range(1, 32):
            acc = acc + w[:, k]
        w = acc
    acc = w[0]
    for k in range(1, w.shape[0]):
        acc = acc + w[k]
    return acc


def _triangle(sample_f: torch.Tensor, in_size: int, recip, fused: bool):
    """(in_size, out) f32 triangle weights ``max(0, 1 - |s - i| * recip)``
    of the sample positions; ``recip`` None when the kernel is not
    widened (XLA drops the division by 1); ``fused``: the product and
    the subtraction as one FMA."""
    d = (sample_f[None, :] - torch.arange(in_size, dtype=F32)[:, None]).abs()
    if recip is None:
        w = 1 - d
    elif fused:
        w = _fma32(-d, recip, 1.0)
    else:
        w = 1 - d * recip
    return torch.clamp(w, min=0)


@functools.lru_cache(maxsize=64)
def _weight_mat(in_size: int, out_size: int, device) -> torch.Tensor:
    """(in_size, out_size) float32 weights of
    ``jax._src.image.scale.compute_weight_mat`` (triangle kernel,
    antialias on, no translation) as XLA's CPU backend computes them
    inside the jitted resize of ``ffpic_tpu/ops/resize.py``.  The
    optimised HLO holds two fusions that each recompute the weights from
    iotas: one feeds the column total (a tree of 32-row reduce-windows,
    ``_xla_column_sum``), the other divides by it and applies the masks.

    * Sample positions ``(j + 0.5) * f32(1/scale) - 0.5``: in the total's
      fusion LLVM folds them to constants, a product and a difference
      each rounded; in the other they are one FMA.
    * ``|s - i| / kernel_scale`` becomes a product by the f32 reciprocal
      of the f32 ``kernel_scale`` (XLA's divide-by-constant rewrite), and
      goes away when ``kernel_scale`` is 1 (growing).  ``1 - that`` is
      one FMA in the total's fusion and two roundings in the other.
    * The weights are divided by the total (an f32 division) where
      ``|total| > 1000 eps`` and zeroed where the sample lies outside.

    Those FMA choices are LLVM's at the output sizes of config 5 (224)
    and when growing.  At some other sizes it makes other ones (at 97
    -> 61 it unrolls the second fusion's loop, folds the positions and
    fuses ``1 - ...`` there too), and a few weights differ, by up to
    1.5e-6 (ROADMAP Queue 3, ``tests/test_torch_resize.py``)."""
    # JAX takes 1/scale of a Python float, then rounds it to f32 in use
    inv_scale = 1.0 / (out_size / in_size)
    inv32 = float(torch.tensor(inv_scale, dtype=F32))
    kernel_scale = torch.tensor(max(inv_scale, 1.0), dtype=F32)
    recip = (None if kernel_scale == 1 else
             float(torch.reciprocal(kernel_scale)))
    half = torch.arange(out_size, dtype=F32) + 0.5
    folded = half * inv32 - 0.5
    sample_f = _fma32(half, inv32, -0.5)
    total = _xla_column_sum(_triangle(folded, in_size, recip, True))[None]
    weights = _triangle(sample_f, in_size, recip, False)
    eps = torch.finfo(F32).eps
    weights = torch.where(total.abs() > 1000.0 * eps,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0).to(device)


def _cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic (``scale.py``'s ``_fill_keys_cubic_kernel``) in f32."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros((), dtype=F32), out)


def _lanczos(radius: float, x: torch.Tensor) -> torch.Tensor:
    """Lanczos (``scale.py``'s ``_fill_lanczos_kernel``) in f32, with
    pi as the f32 constant JAX's weak-typed product takes."""
    pi = torch.tensor(np.pi, dtype=F32)
    pi2 = torch.tensor(np.pi ** 2, dtype=F32)
    y = radius * torch.sin(pi * x) * torch.sin(pi * x / radius)
    out = torch.where(x > 1e-3,
                      y / torch.where(x != 0, pi2 * x ** 2, 1.0), 1.0)
    return torch.where(x > radius, torch.zeros((), dtype=F32), out)


_KERNELS = {"cubic": _cubic, "lanczos3": functools.partial(_lanczos, 3.0),
            "lanczos5": functools.partial(_lanczos, 5.0)}


@functools.lru_cache(maxsize=64)
def _kernel_weight_mat(in_size: int, out_size: int,
                       kernel: str) -> torch.Tensor:
    """(in_size, out_size) float32 weights of
    ``jax._src.image.scale.compute_weight_mat`` for the cubic and
    Lanczos kernels (antialias on, no translation), step by step in f32
    as JAX writes it: the sample positions, ``|s - i| / kernel_scale``,
    the kernel, the column total (summed as XLA's CPU backend sums it,
    ``_xla_column_sum``), the division where ``|total| > 1000 eps``, and
    the mask of samples outside.  XLA fuses some of these into FMAs and
    computes its own ``sin``, so a weight can differ from the jitted
    one's by an ulp or so."""
    inv_scale = 1.0 / (out_size / in_size)
    inv32 = torch.tensor(inv_scale, dtype=F32)
    kernel_scale = torch.maximum(inv32, torch.tensor(1.0, dtype=F32))
    sample_f = (torch.arange(out_size, dtype=F32) + 0.5) * inv32 - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=F32)[:, None]) \
        .abs() / kernel_scale
    weights = _KERNELS[kernel](x)
    total = _xla_column_sum(weights)[None]
    eps = torch.finfo(F32).eps
    weights = torch.where(total.abs() > 1000.0 * eps,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def _nearest_mat(in_size: int, out_size: int) -> torch.Tensor:
    """(in_size, out_size) float32 one-hot columns of JAX's
    ``_resize_nearest``: output j reads input ``floor((j + 0.5) * in /
    out)`` as XLA's CPU backend folds it, ``(j + 0.5) * c`` in f32 with
    ``c = f32(in) * f32(1 / out)`` rounded to f32."""
    c = torch.tensor(float(in_size), dtype=F32) * \
        torch.reciprocal(torch.tensor(float(out_size), dtype=F32))
    pos = (torch.arange(out_size, dtype=F32) + 0.5) * c
    src = torch.floor(pos).long().clamp(0, in_size - 1)
    wm = torch.zeros((in_size, out_size), dtype=F32)
    wm[src, torch.arange(out_size)] = 1.0
    return wm


def weight_mat(in_size: int, out_size: int,
               method: str = "bilinear") -> torch.Tensor:
    """(in_size, out_size) float32 weights of one axis's resize by
    ``method`` on the CPU: ``_weight_mat`` for bilinear,
    ``_kernel_weight_mat`` for cubic and Lanczos, ``_nearest_mat`` for
    nearest."""
    kernel = kernel_of(method)
    if kernel == "linear":
        return _weight_mat(in_size, out_size, torch.device("cpu"))
    if kernel == "nearest":
        return _nearest_mat(in_size, out_size)
    return _kernel_weight_mat(in_size, out_size, kernel)


@functools.lru_cache(maxsize=64)
def taps(in_size: int, out_size: int, device=torch.device("cpu"),
         method: str = "bilinear"):
    """The banded form of ``weight_mat``: for each output index its
    first input index ``start`` (out,) int32, the length ``count``
    (out,) int32 of its run of weights from the first nonzero to the
    last (0 where all are zero), and the run's f32 weights (out, K),
    zero past ``count``, K the longest run, held as float64 (exactly),
    the width the sums take them in."""
    wm = weight_mat(in_size, out_size, method).T
    nz = wm != 0
    count = torch.zeros(out_size, dtype=torch.int32)
    start = torch.zeros(out_size, dtype=torch.int32)
    any_nz = nz.any(dim=1)
    idx = torch.arange(in_size)
    first = torch.where(nz, idx, in_size).amin(dim=1)
    last = torch.where(nz, idx, -1).amax(dim=1)
    start[any_nz] = first[any_nz].to(torch.int32)
    count[any_nz] = (last - first + 1)[any_nz].to(torch.int32)
    k = max(int(count.max()), 1)
    pos = (start[:, None].long() + torch.arange(k)).clamp(max=in_size - 1)
    wts = torch.where(torch.arange(k) < count[:, None],
                      wm.gather(1, pos), torch.zeros((), dtype=F32))
    return start.to(device), count.to(device), wts.to(device, F64)


def _resize_axis(x: torch.Tensor, dim: int, out_size: int,
                 method: str = "bilinear") -> torch.Tensor:
    """One axis of the resize: ``x`` (any dtype) along ``dim`` to
    ``out_size``, each run summed in float64 in ascending input order,
    then rounded to float32."""
    in_size = x.shape[dim]
    start, _count, wts = taps(in_size, out_size, x.device, method)
    k = wts.shape[1]
    pos = (start[:, None].long() + torch.arange(k, device=x.device)) \
        .clamp(max=in_size - 1)
    bshape = [1] * (x.dim() - dim % x.dim())
    bshape[0] = out_size
    acc = None
    for t in range(k):
        prod = x.index_select(dim, pos[:, t]).to(F64) \
            * wts[:, t].view(bshape)
        acc = prod if acc is None else acc + prod
    return acc.to(F32)


def _resize_f32(x: torch.Tensor, size,
                method: str = "bilinear") -> torch.Tensor:
    """``(..., H, W, C)`` -> ``(..., h, w, C)`` float32, H first."""
    h, w = size
    if x.shape[-3] != h:
        x = _resize_axis(x, -3, h, method)
    if x.shape[-2] != w:
        x = _resize_axis(x, -2, w, method)
    return x.to(F32)


def gather_nearest(img: torch.Tensor, size) -> torch.Tensor:
    """The resize by ``nearest`` as a gather: every changed axis of
    ``img`` (..., H, W, C) indexed by its taps' ``start`` table (one tap
    of weight 1 an output), an axis that keeps its size left as it is.
    The float64 sum of one product by 1 is the byte and rounding keeps
    it, so this is the tap sum's result exactly, with no arithmetic: the
    plain version of K16's gather kernel, which the entries run on the
    CPU for ``nearest``."""
    h, w = size
    for dim, n_out in ((-3, h), (-2, w)):
        if img.shape[dim] != n_out:
            start = taps(img.shape[dim], n_out, img.device, "nearest")[0]
            img = img.index_select(dim, start.long())
    return img


def resize_rgba_plain(img: torch.Tensor, size,
                      method: str = "bilinear") -> torch.Tensor:
    """K16's function: ``(..., H, W, C)`` uint8 -> ``(..., h, w, C)``
    uint8 by ``method`` (antialiased when shrinking), rounded half to
    even and clipped (``ffpic_tpu/ops/resize.py:13``)."""
    return torch.round(_resize_f32(img, size, method)).clamp(0, 255) \
        .to(torch.uint8)


def resize_batch_plain(slots, size, method: str = "bilinear") -> torch.Tensor:
    """K16's function over a batch: the (H_n, W_n, C) uint8 slots, each
    of its own size, each resized alone by ``resize_rgba_plain``, then
    stacked: (N, h, w, C) uint8."""
    return torch.stack([resize_rgba_plain(s, tuple(size), method)
                        for s in slots])


def _consts(values, device) -> torch.Tensor:
    # a tensor on the data's device, never a CPU scalar: PyTorch's CUDA
    # division by a CPU scalar multiplies by its reciprocal instead
    return torch.tensor(values, dtype=F32, device=device)


INV255 = float(torch.tensor(1 / 255, dtype=F32))   # XLA's f32(1/255)


def normalize_plain(batch: torch.Tensor, size=None, mean=MEAN,
                    std=STD) -> torch.Tensor:
    """K17's function: ``(..., H, W, C>=3)`` uint8 RGBA -> ``(..., h, w,
    3)`` float32 (``ffpic_tpu/ops/resize.py:27``), as XLA's CPU backend
    compiles the jitted original: ``/ 255.0`` becomes a product by
    ``f32(1/255)``.  When ``size`` changes an axis, that product is
    rounded to f32, the resize follows (in f32, no uint8 rounding), then
    ``(x - mean) / std`` (f32 subtract and divide).  Otherwise product
    and subtraction are one FMA, ``fma(rgb, f32(1/255), -mean) / std``."""
    rgb = batch[..., :3].to(F32)
    mean = _consts(mean, batch.device)
    std = _consts(std, batch.device)
    if size is None or tuple(size) == tuple(rgb.shape[-3:-1]):
        return _fma32(rgb, INV255, -mean) / std
    x = _resize_f32(rgb * _consts(INV255, batch.device), tuple(size))
    return (x - mean) / std


def _resize_cpu(img: torch.Tensor, size, method: str) -> torch.Tensor:
    """K16 on the CPU: the plain version of the kernel ``method`` takes
    on CUDA (``gather_nearest`` for ``nearest``, else the tap sum)."""
    if kernel_of(method) == "nearest":
        return gather_nearest(img, size)
    return resize_rgba_plain(img, size, method)


def resize_rgba(img: torch.Tensor, size,
                method: str = "bilinear") -> torch.Tensor:
    """(..., H, W, C) uint8 -> (..., h, w, C) uint8 on the tensor's
    device: K16 on CUDA, the plain version on the CPU.  ``method`` is the
    reference's ``jax.image.resize`` method, any of ``METHODS``; another
    name raises ``ValueError``, as JAX does."""
    if not _on_cuda(img):
        return _resize_cpu(img, tuple(size), method)
    from ffpic_tpu_torch.ops import cuda_resize
    return cuda_resize.resize_rgba(img, tuple(size), method)


def resize_batch(slots, size, method: str = "bilinear") -> torch.Tensor:
    """``decode_batch``'s resize of its slots ((H_n, W_n, C) uint8 on one
    device, of any sizes and pitches) -> (N, h, w, C) uint8: K16 in one
    launch on CUDA, the plain version on the CPU."""
    kernel_of(method)
    if not slots:
        raise ValueError("resize_batch: no slots")
    if not _on_cuda(slots[0]):
        return torch.stack([_resize_cpu(s, tuple(size), method)
                            for s in slots])
    from ffpic_tpu_torch.ops import cuda_resize
    return cuda_resize.resize_batch(slots, tuple(size), method)


def resize_batch_rgba(imgs, size, method: str = "bilinear", *,
                      device=None) -> torch.Tensor:
    """List of (H_i, W_i, 4) uint8 images -> (N, h, w, 4) uint8, the
    reference's entry (``ffpic_tpu/ops/resize.py:20``) over
    ``resize_batch``: K16 in one launch on CUDA, the plain version on
    the CPU.  Tensors stay on their device; numpy images go to
    ``device`` (None means CUDA, and raises without it).  ``method`` as
    in ``resize_rgba``."""
    kernel_of(method)
    slots = list(imgs)
    if any(not isinstance(im, torch.Tensor) for im in slots):
        dev = resolve_device(device, "resize_batch_rgba")
        slots = [im if isinstance(im, torch.Tensor)
                 else to_device(np.ascontiguousarray(im), dev)
                 for im in slots]
    return resize_batch(slots, size, method)


def normalize_for_model(batch: torch.Tensor, size=None, mean=MEAN,
                        std=STD) -> torch.Tensor:
    """uint8 RGBA batch (N, H, W, 4) -> float32 RGB normalised (N, h, w,
    3) on the batch's device, resized to ``size`` when given: K17 on
    CUDA, the plain version on the CPU."""
    size = None if size is None else tuple(size)
    if not _on_cuda(batch):
        return normalize_plain(batch, size, mean, std)
    from ffpic_tpu_torch.ops import cuda_resize
    return cuda_resize.normalize_resize(batch, size, mean, std)
