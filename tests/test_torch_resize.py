"""ffpic_tpu_torch.ops.resize against ffpic_tpu.ops.resize (JAX's
``jax.image.resize``, bilinear, antialiased when shrinking) on the same
random uint8 images.

Tolerance: 1 LSB.  The weights are the same to a few float32 ulps (the
column sums that normalise them run in another order), and the two
matrix products sum in another order than XLA's, so a value can land on
the other side of .5 before rounding.  Observed on these inputs: 0 to
0.011 % of the outputs are off by 1 (5.0e-6 for 512->224, none for
160->224, 1.5e-5 for 300x512->224, 1.0e-4 for 512x400->512x224).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image import scale as jax_scale

from ffpic_tpu.ops.resize import resize_rgba as jax_resize_rgba
from ffpic_tpu_torch.ops.resize import _weight_mat, resize_rgba


@pytest.mark.parametrize("n_in,n_out", [(512, 224), (160, 224), (1080, 224),
                                        (1920, 224), (7, 5)])
def test_weight_mat_matches_jax(n_in, n_out):
    want = np.asarray(jax_scale.compute_weight_mat(
        n_in, n_out, n_out / n_in, 0.0, jax_scale._fill_triangle_kernel,
        True))
    got = _weight_mat(n_in, n_out, torch.device("cpu")).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -22)


@pytest.mark.parametrize("src,dst", [
    ((512, 512), (224, 224)),      # shrink: antialiased
    ((160, 160), (224, 224)),      # grow
    ((300, 512), (224, 224)),      # grow one axis, shrink the other
    ((512, 400), (512, 224)),      # an unchanged axis is skipped
])
def test_resize_rgba_matches_jax(src, dst):
    rng = np.random.default_rng(sum(src) + sum(dst))
    img = rng.integers(0, 256, (*src, 4), dtype=np.uint8)
    want = np.asarray(jax_resize_rgba(jnp.asarray(img), dst)).astype(int)
    got = resize_rgba(torch.from_numpy(img), dst)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (*dst, 4)
    diff = np.abs(got.numpy().astype(int) - want)
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-3


def test_resize_rgba_batched_equals_per_image():
    rng = np.random.default_rng(9)
    imgs = torch.from_numpy(rng.integers(0, 256, (3, 96, 128, 4),
                                         dtype=np.uint8))
    batched = resize_rgba(imgs, (64, 64))
    assert torch.equal(batched,
                       torch.stack([resize_rgba(i, (64, 64)) for i in imgs]))


def test_resize_ignores_and_keeps_the_callers_matmul_precision(monkeypatch):
    """With the caller's float32 matmul precision at "medium" (TF32 or
    bf16 products where a backend has them), resize_rgba gives the same
    result as at "highest", and leaves the caller's setting as it was:
    it computes in float64 and never sets the global, which another
    thread may be reading, even for the length of the call."""
    rng = np.random.default_rng(9)
    img = torch.from_numpy(rng.integers(0, 256, (2, 96, 128, 4),
                                        dtype=np.uint8))
    prev = torch.get_float32_matmul_precision()
    real_set = torch.set_float32_matmul_precision
    try:
        real_set("highest")
        want = resize_rgba(img, (80, 64))
        real_set("medium")
        sets = []
        monkeypatch.setattr(torch, "set_float32_matmul_precision",
                            lambda p: sets.append(p) or real_set(p))
        got = resize_rgba(img, (80, 64))
        assert sets == []
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        real_set(prev)
    assert torch.equal(got, want)
    jax_want = np.stack([np.asarray(jax_resize_rgba(jnp.asarray(x.numpy()),
                                                    (80, 64), "bilinear"))
                         for x in img])
    assert np.abs(got.numpy().astype(int) - jax_want).max() <= 1
