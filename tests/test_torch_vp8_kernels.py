"""The VP8 device stages of ffpic_tpu_torch (CPU, plain versions) held
against ffpic_tpu's on the same arrays, exactly: ``vp8_idct4x4`` and
``vp8_iwht4x4`` (and the port's numpy models of them in ``ops.golden``)
on asymmetric int16 blocks over the whole int16 range;
``vp8_residuals_plain`` (K12's function) on ``testing.vp8_cases``
(``test_torch_webp.py`` feeds it a real file's parse);
``vp8_yuv_to_rgba_plain`` (K13's)
at small odd sizes, with and without alpha.  Every stage is integer, so
the tolerance is zero.  The CUDA kernels run only on a GPU
(``chip_smoke.py``); here their wrappers are checked to refuse CPU
tensors and the entries to take the plain versions for CPU tensors.
"""

import numpy as np
import pytest
import torch

from ffpic_tpu.formats.webp import _yuv_to_rgb_libwebp
from ffpic_tpu.ops import golden as jax_golden
from ffpic_tpu.ops import vp8_kernels as jax_vk
from ffpic_tpu_torch import testing
from ffpic_tpu_torch.ops import cuda_vp8, golden
from ffpic_tpu_torch.ops import vp8_kernels as vk
import reference_native  # noqa: F401  (readies ffpic_tpu first)

SIZES = [1, 2, 15, 17, 33, 40]


def _blocks(seed: int, shape) -> np.ndarray:
    """Random int16 blocks over the whole range, with the int16 extremes
    planted, none of them symmetric (a transposed transform would pass
    a symmetric block)."""
    rng = np.random.default_rng(seed)
    b = rng.integers(-32768, 32768, (*shape, 4, 4)).astype(np.int16)
    b.reshape(-1, 16)[:, 1] = 32767
    b.reshape(-1, 16)[:, 4] = -32768
    assert not np.array_equal(b, np.swapaxes(b, -1, -2))
    return b


@pytest.mark.parametrize("seed,shape", [(0, (7,)), (1, (3, 5, 24)),
                                        (2, (2, 2, 2, 9))])
def test_idct4x4_matches_jax(seed, shape):
    b = _blocks(seed, shape)
    got = vk.vp8_idct4x4(torch.from_numpy(b))
    assert got.dtype == torch.int16
    want = np.asarray(jax_vk.vp8_idct4x4(b))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(golden.vp8_idct4x4(b), want)
    np.testing.assert_array_equal(golden.vp8_idct4x4(b),
                                  jax_golden.vp8_idct4x4(b))


@pytest.mark.parametrize("seed,shape", [(3, (7,)), (4, (3, 5)),
                                        (5, (2, 2, 11))])
def test_iwht4x4_matches_jax(seed, shape):
    b = _blocks(seed, shape)
    got = vk.vp8_iwht4x4(torch.from_numpy(b))
    assert got.dtype == torch.int16
    want = np.asarray(jax_vk.vp8_iwht4x4(b))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(golden.vp8_iwht4x4(b), want)
    np.testing.assert_array_equal(golden.vp8_iwht4x4(b),
                                  jax_golden.vp8_iwht4x4(b))


def test_idct4x4_is_not_symmetric_in_its_passes():
    """One coefficient in row 0, column 1 and its transpose give
    transposed residuals: the passes keep their orientation."""
    a = np.zeros((4, 4), np.int16)
    a[0, 1] = 1000
    got = vk.vp8_idct4x4(torch.from_numpy(a)).numpy()
    got_t = vk.vp8_idct4x4(torch.from_numpy(a.T.copy())).numpy()
    np.testing.assert_array_equal(got_t, got.T)
    assert not np.array_equal(got, got.T)
    np.testing.assert_array_equal(got, np.asarray(jax_vk.vp8_idct4x4(a)))


@pytest.mark.parametrize("name", sorted(testing.vp8_cases()["residuals"]))
def test_residuals_match_jax(name):
    levels, dq, has_y2 = testing.vp8_cases()["residuals"][name]
    got = vk.vp8_residuals_plain(torch.from_numpy(levels),
                                 torch.from_numpy(dq),
                                 torch.from_numpy(has_y2))
    assert got.dtype == torch.int16 and tuple(got.shape) == (
        *levels.shape[:2], 24, 4, 4)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_vk.vp8_residuals(levels, dq, has_y2)))


def test_residual_cases_cover_their_edges():
    """The cases hold what they claim: products that overflow int16 and
    int32, both has_y2 values, four segments' factors, a 1x1 and a 1xN
    grid."""
    res = testing.vp8_cases()["residuals"]
    lv, dq, hy = res["wrap_int16_4seg"]
    prod = lv[..., :16, 1:].astype(np.int64) * dq[..., 1, None, None]
    assert np.abs(prod).max() > 32767
    assert len({tuple(r) for r in dq.reshape(-1, 6)}) == 4
    assert hy.any() and not hy.all()
    lv, dq, _ = res["wrap_int32"]
    assert np.abs(lv[..., 0].astype(np.int64) * dq[..., :1]).max() > 2 ** 31
    assert res["mb1x1_y2"][0].shape[:2] == (1, 1)
    assert res["mb1x37_mixed"][0].shape[:2] == (1, 37)


def test_residuals_entry_takes_the_plain_version_on_the_cpu():
    levels, dq, has_y2 = testing.vp8_cases()["residuals"]["mb1x37_mixed"]
    args = [torch.from_numpy(a) for a in (levels, dq, has_y2)]
    assert torch.equal(vk.vp8_residuals(*args),
                       vk.vp8_residuals_plain(*args))


@pytest.mark.parametrize("h", SIZES)
@pytest.mark.parametrize("w", SIZES)
def test_yuv_to_rgba_matches_jax(h, w):
    rng = np.random.default_rng(100 * h + w)
    ph, pw = -(-h // 16) * 16, -(-w // 16) * 16
    Y = rng.integers(0, 256, (ph, pw)).astype(np.uint8)
    U = rng.integers(0, 256, (ph // 2, pw // 2)).astype(np.uint8)
    V = rng.integers(0, 256, (ph // 2, pw // 2)).astype(np.uint8)
    want = np.array(jax_vk.vp8_yuv_to_rgba(Y, U, V, h, w))
    t = [torch.from_numpy(p) for p in (Y, U, V)]
    got = vk.vp8_yuv_to_rgba_plain(*t, h, w)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (h, w, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    # with an alpha plane: the JAX path's alpha write that follows it
    alpha = rng.integers(0, 256, (h, w)).astype(np.uint8)
    want[..., 3] = alpha
    np.testing.assert_array_equal(
        vk.vp8_yuv_to_rgba_plain(*t, h, w, torch.from_numpy(alpha)).numpy(),
        want)
    # and the reference's host numpy colour
    r, g, b = _yuv_to_rgb_libwebp(Y, U, V, h, w)
    np.testing.assert_array_equal(want[..., :3], np.dstack([r, g, b]))


@pytest.mark.parametrize("name", sorted(testing.vp8_cases()["color"]))
def test_yuv_to_rgba_cases_match_jax(name):
    Y, U, V, h, w, alpha = testing.vp8_cases()["color"][name]
    want = np.array(jax_vk.vp8_yuv_to_rgba(Y, U, V, h, w))
    if alpha is not None:
        want[..., 3] = alpha
    got = vk.vp8_yuv_to_rgba(
        *[torch.from_numpy(p) for p in (Y, U, V)], h, w,
        None if alpha is None else torch.from_numpy(alpha))
    np.testing.assert_array_equal(got.numpy(), want)


def test_yuv_to_rgba_never_reads_the_padding():
    """Chroma is cropped before its edges are replicated: the MB padding
    of U and V (and of Y) can hold anything."""
    Y, U, V, h, w, _ = testing.vp8_cases()["color"]["17x33_alpha"]
    ch, cw = (h + 1) // 2, (w + 1) // 2
    base = vk.vp8_yuv_to_rgba_plain(
        *[torch.from_numpy(p) for p in (Y, U, V)], h, w)
    Y2, U2, V2 = Y.copy(), U.copy(), V.copy()
    Y2[h:], Y2[:, w:] = 0, 255
    U2[ch:], U2[:, cw:] = 255, 0
    V2[ch:], V2[:, cw:] = 0, 255
    assert torch.equal(base, vk.vp8_yuv_to_rgba_plain(
        *[torch.from_numpy(p) for p in (Y2, U2, V2)], h, w))


@pytest.mark.parametrize("call", [
    lambda t: cuda_vp8.vp8_residuals(
        torch.zeros((1, 1, 25, 16), dtype=torch.int32),
        torch.zeros((1, 1, 6), dtype=torch.int32),
        torch.zeros((1, 1), dtype=torch.bool)),
    lambda t: cuda_vp8.vp8_yuv_to_rgba(t, t[:8, :8], t[:8, :8], 16, 16),
])
def test_cuda_vp8_wrappers_refuse_cpu_tensors(call):
    t = torch.zeros((16, 16), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        call(t)
