"""Resize of decoded RGBA images on the device.

``resize_rgba`` gives what ``jax.image.resize(img.astype(f32), (h, w, 4),
"bilinear")`` gives, rounded half to even and clipped to uint8: per axis
a triangle-kernel weight matrix, widened by 1/scale when shrinking
(JAX antialiases by default; ``F.interpolate`` does not), applied as a
float64 matrix product and rounded to float32 after each axis, as JAX
rounds its f32 products.  The weights are f32 values, which float64
holds exactly, and float64 ignores the TF32 setting, so no global
precision setting is read or changed.  The sums run in another order
and width than XLA's, so a sum can land on the other side of .5:
outputs agree with the JAX package to 1 LSB.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=64)
def _weight_mat(in_size: int, out_size: int, device) -> torch.Tensor:
    """(in_size, out_size) float32 weights, step for step as
    ``jax._src.image.scale.compute_weight_mat`` with the triangle kernel,
    antialias on and no translation."""
    f32 = torch.float32
    # JAX takes 1/scale of a Python float, then rounds it to f32 in use
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(out_size, dtype=f32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=f32)[:, None]) \
        .abs() / kernel_scale
    weights = torch.clamp(1 - x.abs(), min=0)
    total = weights.sum(dim=0, keepdim=True)
    eps = torch.finfo(torch.float32).eps
    weights = torch.where(total.abs() > 1000.0 * eps,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0).to(device)


def resize_rgba(img: torch.Tensor, size) -> torch.Tensor:
    """(..., H, W, C) uint8 -> (..., h, w, C) uint8, bilinear with
    antialiasing, on the tensor's device.  An axis whose size does not
    change is left as it is, as JAX skips it."""
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
