"""The JPEG codec's device stages of ffpic_tpu_torch (plain PyTorch
versions, CPU) held against ffpic_tpu.ops.jpeg_kernels on the same numpy
inputs: ``decode_mcu_planes`` over every sampling (K2 per component,
then K4 ``assemble_mcu``), the upsamplers, the block/plane reshapes and
``fdct_blocks`` (K5), all bit for bit (the colour up to XLA's choice of
contracting its products into FMAs, ``testing.
assert_equal_up_to_contraction``).  The models of the K4 and K5
kernels' own arithmetic (``testing.assemble_mcu_gather``,
``testing.fdct_evenodd``) are held against the plain versions; the
kernels themselves run only on a GPU (``chip_smoke.py``).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffpic_tpu.ops import jpeg_kernels as jax_jk
from ffpic_tpu_torch import testing
from ffpic_tpu_torch.ops import cuda_jpeg
from ffpic_tpu_torch.ops import jpeg_kernels as jk
import reference_native  # noqa: F401  (readies ffpic_tpu first)

MODES = ("reference", "bt601", "rgb")
ORDERS = ("rgba", "bgra")
CASES = testing.mcu_cases()


def _coeff_case(name: str, seed: int = 3):
    """Coefficients and a table per component for the geometry of
    ``CASES[name]``: mostly small AC, DC anywhere in int16's range
    after dequantisation, and distinct tables per component (Cr's too)."""
    _s, shapes, samplings, oh, ow = CASES[name]
    rng = np.random.default_rng(seed)
    coeffs = [rng.integers(-600, 600, (a, b, 8, 8)).astype(np.int16)
              * (rng.random((a, b, 8, 8)) < 0.4) for a, b in shapes]
    quants = [rng.integers(1, 40, (8, 8)).astype(np.int32) for _ in shapes]
    return ([c.astype(np.int16) for c in coeffs], quants, shapes, samplings,
            oh, ow)


def _both(name, upsample, mode, order, gray_chroma=128):
    """The port's plain ``decode_mcu_planes`` against JAX's on
    ``CASES[name]``, asserted equal with the colour up to XLA's
    contraction choice; returns (port, JAX)."""
    coeffs, quants, shapes, samplings, oh, ow = _coeff_case(name)
    want = np.asarray(jax_jk.decode_mcu_planes(
        tuple(map(jnp.asarray, coeffs)), tuple(map(jnp.asarray, quants)),
        samplings, oh, ow, order=order, mode=mode, gray_chroma=gray_chroma,
        upsample=upsample))
    def run():
        return jk.decode_mcu_planes(
            torch.from_numpy(np.concatenate([c.reshape(-1, 8, 8)
                                             for c in coeffs])),
            shapes, np.stack(quants), samplings, oh, ow, order=order,
            mode=mode, gray_chroma=gray_chroma, upsample=upsample)

    got = run()
    assert got.dtype == torch.uint8 and tuple(got.shape) == (oh, ow, 4)
    testing.assert_equal_up_to_contraction(run, want)
    return got.numpy(), want


def _geometries():
    """Every case with every upsampler it takes; mode and order rotate."""
    out = []
    for k, name in enumerate(sorted(CASES)):
        for up in ("nearest", "fancy"):
            if up == "fancy" and not testing.fancy_ok(CASES[name][2]):
                continue
            out.append(pytest.param(name, up, MODES[k % 3],
                                    ORDERS[(k // 3) % 2],
                                    id=f"{name}-{up}"))
    return out


@pytest.mark.parametrize("name,upsample,mode,order", _geometries())
def test_decode_mcu_planes_matches_jax(name, upsample, mode, order):
    """Every sampling (luma at the largest factor or not, odd sizes so
    that fancy upsampling replicates the cropped plane's last row and
    column), each component against its own table."""
    _both(name, upsample, mode, order)


@pytest.mark.parametrize("upsample", ["nearest", "fancy"])
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("mode", MODES)
def test_decode_mcu_planes_modes_match_jax(mode, order, upsample):
    _both("422_67x101", upsample, mode, order)


@pytest.mark.parametrize("gray_chroma", [128, 0])
def test_decode_mcu_planes_gray_matches_jax(gray_chroma):
    """Gray: chroma 128 is neutral; 0 (``quirks``) goes through the
    colour matrix and tints the image, as the reference does."""
    got, _want = _both("gray_67x101", "nearest", "reference", "rgba",
                       gray_chroma)
    tint = np.abs(got[..., 0].astype(int) - got[..., 2].astype(int)).max()
    assert (tint > 0) == (gray_chroma == 0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_assemble_mcu_gather_matches_plain(name):
    """The K4 kernel's per-pixel index arithmetic (nearest by division,
    fancy with its clamps at ph-1 and pw-1) gives the plain version's
    planes, for every upsampler the geometry takes."""
    samples, shapes, samplings, oh, ow = CASES[name]
    t = torch.from_numpy(samples)
    for up in ("nearest", "fancy"):
        if up == "fancy" and not testing.fancy_ok(samplings):
            continue
        for gray in (128, 0):
            want = torch.stack(jk.mcu_planes(t, shapes, samplings, oh, ow,
                                             gray, up)).to(torch.int64)
            got = testing.assemble_mcu_gather(t, shapes, samplings, oh, ow,
                                              gray, up)
            assert torch.equal(got, want)


@pytest.mark.parametrize("v,h", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_upsample_fancy_matches_jax(v, h):
    rng = np.random.default_rng(v * 4 + h)
    plane = rng.integers(-32768, 32768, (13, 21)).astype(np.int16)
    oh, ow = 13 * v - 1, 21 * h - 1
    want = np.asarray(jax_jk.upsample_fancy(jnp.asarray(plane), v, h, oh,
                                            ow))
    got = jk.upsample_fancy(torch.from_numpy(plane), v, h, oh, ow)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("v,h", [(1, 1), (2, 1), (1, 2), (2, 2), (1, 4),
                                 (3, 2)])
def test_upsample_nearest_matches_jax(v, h):
    rng = np.random.default_rng(v * 8 + h)
    plane = rng.integers(-32768, 32768, (11, 9)).astype(np.int16)
    oh, ow = 11 * v - 2, 9 * h - 1
    want = np.asarray(jax_jk.upsample_nearest(jnp.asarray(plane), v, h, oh,
                                              ow))
    got = jk.upsample_nearest(torch.from_numpy(plane), v, h, oh, ow)
    np.testing.assert_array_equal(got.numpy(), want)


def test_blocks_and_planes_match_jax():
    rng = np.random.default_rng(4)
    blocks = rng.integers(-32768, 32768, (3, 5, 8, 8)).astype(np.int16)
    plane = np.asarray(jax_jk.blocks_to_plane(jnp.asarray(blocks)))
    got = jk.blocks_to_plane(torch.from_numpy(blocks))
    np.testing.assert_array_equal(got.numpy(), plane)
    np.testing.assert_array_equal(
        jk.plane_to_blocks(got).numpy(),
        np.asarray(jax_jk.plane_to_blocks(jnp.asarray(plane))))


def test_fancy_refuses_factors_beyond_two():
    """4:1:1 (h = 4) with fancy upsampling: the reference's shapes do
    not fit; the plain version and the kernel's wrapper raise
    ValueError rather than invent an output."""
    samples, shapes, samplings, oh, ow = CASES["411_67x101"]
    coeffs, quants, *_ = _coeff_case("411_67x101")
    with pytest.raises(Exception):
        jax_jk.decode_mcu_planes(tuple(map(jnp.asarray, coeffs)),
                                 tuple(map(jnp.asarray, quants)), samplings,
                                 oh, ow, upsample="fancy")
    t = torch.from_numpy(samples)
    with pytest.raises(ValueError, match="fancy upsampling takes"):
        jk.assemble_mcu(t, shapes, samplings, oh, ow, upsample="fancy")
    with pytest.raises(ValueError, match="fancy upsampling takes"):
        cuda_jpeg.assemble_mcu(t, shapes, samplings, oh, ow,
                               upsample="fancy")


@pytest.mark.parametrize("ncomp", [2, 4])
def test_component_counts_other_than_1_or_3_raise(ncomp):
    shapes = ((2, 2),) * ncomp
    coeffs = torch.zeros(4 * ncomp, 8, 8, dtype=torch.int16)
    quants = np.ones((ncomp, 64), np.int32)
    with pytest.raises(ValueError, match="want 1 or 3"):
        jk.decode_mcu_planes(coeffs, shapes, quants, ((1, 1),) * ncomp, 16,
                             16)
    with pytest.raises(ValueError, match="want 1 or 3"):
        jax_jk.decode_mcu_planes((jnp.zeros((2, 2, 8, 8), jnp.int16),) * ncomp,
                                 (jnp.ones((8, 8), jnp.int32),) * ncomp,
                                 ((1, 1),) * ncomp, 16, 16)
    with pytest.raises(ValueError, match="want 1 or 3"):
        cuda_jpeg.assemble_mcu(coeffs, shapes, ((1, 1),) * ncomp, 16, 16)


def test_assemble_mcu_wrapper_refuses_uncovered_planes():
    """A plane smaller than its factor needs: both versions raise."""
    t = torch.zeros(3, 8, 8, dtype=torch.int16)
    args = (((1, 1), (1, 1), (1, 1)), ((1, 1), (1, 2), (1, 1)), 8, 24)
    with pytest.raises(ValueError, match="does not cover"):
        jk.assemble_mcu(t, *args)
    with pytest.raises(ValueError, match="does not cover"):
        cuda_jpeg.assemble_mcu(t, *args)


@functools.lru_cache(maxsize=None)
def _fdct_input(case: str) -> np.ndarray:
    rng = np.random.default_rng(12)
    if case == "level_shifted":             # what the encoder feeds it
        b = rng.integers(-128, 128, (2000, 8, 8))
        b[:4] = np.array([-128, 127, 0, 1])[:, None, None]
        return b.astype(np.int16)
    if case == "full_int16":                # int32 sums wrap
        b = rng.integers(-32768, 32768, (2000, 8, 8))
        b[0] = 32767
        b[1] = -32768
        b[2, :, ::2], b[2, :, 1::2] = 32767, -32768
        return b.astype(np.int16)
    raise KeyError(case)


@pytest.mark.parametrize("case", ["level_shifted", "full_int16"])
def test_fdct_blocks_matches_jax(case):
    blocks = _fdct_input(case)
    want = np.asarray(jax_jk.fdct_blocks(jnp.asarray(blocks)))
    got = jk.fdct_blocks(torch.from_numpy(blocks))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        testing.fdct_evenodd(torch.from_numpy(blocks)).numpy(), want)


def test_fdct_full_range_wraps():
    """On full-range int16 the row pass's results leave int16 and wrap
    before the column pass; without that wrap the coefficients differ.
    The wrapped ones are JAX's (above)."""
    x = torch.from_numpy(_fdct_input("full_int16")).to(torch.int64)
    d = torch.from_numpy(jk.FDCT_P13)
    row = ((((x[..., None, :] * d).sum(-1)) >> 1) + (1 << 12)) >> 13
    assert (row.abs() > 32767).any()
    col = (d[:, :, None] * row[..., None, :, :]).sum(-2)
    unwrapped = jk._wrap(((col >> 1) + (1 << 12)) >> 13, 16)
    assert not torch.equal(unwrapped.to(torch.int16),
                           jk.forward_dct(x.to(torch.int16)))


def test_fdct_rows_before_columns():
    """The rounding between the passes makes their order observable:
    columns first gives other coefficients."""
    x = torch.from_numpy(_fdct_input("level_shifted"))
    rows_first = jk.forward_dct(x)
    cols_first = jk.forward_dct(x.transpose(1, 2)).transpose(1, 2)
    assert not torch.equal(rows_first, cols_first)
