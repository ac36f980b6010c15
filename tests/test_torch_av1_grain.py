"""The port's film grain synthesis (``coding/av1_grain.py``:
``generate_templates``, ``scaling_lut``, ``apply_grain``, with
``av1_grain_tables.GAUSSIAN_SEQUENCE``) held against ffpic_tpu's on
seeded parameters and planes, on the CPU, with tolerance 0: both run the
same Python and numpy.

The parameters are drawn from a seed within the ranges the spec's syntax
allows (5.9.30): every auto-regressive lag, luma and chroma points,
chroma scaling from luma, overlap on and off, the restricted range, at
8, 10 and 12 bits, in 4:2:0, 4:2:2, 4:4:4 and monochrome, on planes of
odd sizes.  A still item whose frame header signals grain is decoded
without it in both packages (only ``Av1Decoder`` applies grain).
"""

import io

import numpy as np
import pytest
from PIL import Image

import ffpic_tpu
import ffpic_tpu_torch
from ffpic_tpu import native as jax_native
from ffpic_tpu.coding import av1_grain as jax_grain
from ffpic_tpu_torch.coding import av1_grain, av1_grain_tables
from ffpic_tpu_torch.formats import av1_recon, heif
import reference_native  # noqa: F401  (readies ffpic_tpu first)


@pytest.fixture(autouse=True)
def _native_first():
    jax_native.available()


def _points(rng, n_max: int) -> tuple:
    n = int(rng.integers(0, n_max + 1))
    values = np.sort(rng.choice(256, n, replace=False)).tolist()
    return values, rng.integers(0, 256, n).tolist()


def _params(seed: int, mono: bool = False, from_luma: bool | None = None):
    """A pair of equal ``GrainParams`` (the port's, the reference's) drawn
    from ``seed``."""
    rng = np.random.default_rng(seed)
    fields = {"apply_grain": True,
              "grain_seed": int(rng.integers(0, 1 << 16))}
    yv, ys = _points(rng, 14)
    if not yv:
        yv, ys = [0, 255], [40, 90]
    fields.update(num_y_points=len(yv), point_y_value=yv, point_y_scaling=ys)
    from_luma = bool(rng.integers(0, 2)) if from_luma is None else from_luma
    fields["chroma_scaling_from_luma"] = False if mono else from_luma
    for c in ("cb", "cr"):
        v, s = ([], []) if mono or from_luma else _points(rng, 10)
        fields.update({f"num_{c}_points": len(v), f"point_{c}_value": v,
                       f"point_{c}_scaling": s})
    lag = int(rng.integers(0, 4))
    n = 2 * lag * (lag + 1)
    fields.update(
        grain_scaling=int(rng.integers(8, 12)), ar_coeff_lag=lag,
        ar_coeffs_y=rng.integers(-128, 128, n).tolist(),
        ar_coeffs_cb=rng.integers(-128, 128, n + 1).tolist(),
        ar_coeffs_cr=rng.integers(-128, 128, n + 1).tolist(),
        ar_coeff_shift=int(rng.integers(6, 10)),
        grain_scale_shift=int(rng.integers(0, 4)),
        cb_mult=int(rng.integers(0, 256)),
        cb_luma_mult=int(rng.integers(0, 256)),
        cb_offset=int(rng.integers(0, 512)),
        cr_mult=int(rng.integers(0, 256)),
        cr_luma_mult=int(rng.integers(0, 256)),
        cr_offset=int(rng.integers(0, 512)),
        overlap_flag=bool(rng.integers(0, 2)),
        clip_to_restricted_range=bool(rng.integers(0, 2)), ref_idx=-1)
    pair = (av1_grain.GrainParams(), jax_grain.GrainParams())
    for g in pair:
        for k, v in fields.items():
            setattr(g, k, v)
    return pair


def test_gaussian_sequence_is_the_references():
    from ffpic_tpu.coding.av1_grain_tables import GAUSSIAN_SEQUENCE
    np.testing.assert_array_equal(av1_grain_tables.GAUSSIAN_SEQUENCE,
                                  GAUSSIAN_SEQUENCE)
    assert len(GAUSSIAN_SEQUENCE) == 2048


@pytest.mark.parametrize("seed", range(6))
def test_scaling_lut_matches_jax(seed):
    rng = np.random.default_rng(100 + seed)
    values, scalings = _points(rng, 14)
    for bd in (8, 10, 12):
        got = av1_grain.scaling_lut(values, scalings, bd)
        np.testing.assert_array_equal(
            got, jax_grain.scaling_lut(values, scalings, bd))
        assert got.shape == (1 << bd,)


@pytest.mark.parametrize("seed,bd,sub,mono", [
    (0, 8, (1, 1), False), (1, 10, (1, 1), False), (2, 8, (0, 0), False),
    (3, 12, (1, 0), False), (4, 8, (1, 1), True)])
def test_generate_templates_match_jax(seed, bd, sub, mono):
    ours, ref = _params(seed, mono)
    got = av1_grain.generate_templates(ours, bd, *sub, mono)
    want = jax_grain.generate_templates(ref, bd, *sub, mono)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,bd,sub,mono,hw", [
    (10, 8, (1, 1), False, (70, 101)), (11, 10, (1, 1), False, (64, 96)),
    (12, 8, (0, 0), False, (45, 33)), (13, 12, (1, 0), False, (40, 57)),
    (14, 8, (1, 1), True, (37, 70)), (15, 10, (0, 0), False, (33, 65))])
def test_apply_grain_matches_jax(seed, bd, sub, mono, hw):
    ours, ref = _params(seed, mono)
    rng = np.random.default_rng(seed)
    h, w = hw
    dt = np.uint8 if bd == 8 else np.uint16
    planes = [rng.integers(0, 1 << bd, (h, w)).astype(dt)]
    if not mono:
        ch, cw = (h + sub[1]) >> sub[1], (w + sub[0]) >> sub[0]
        planes += [rng.integers(0, 1 << bd, (ch, cw)).astype(dt)
                   for _ in range(2)]
    got = av1_grain.apply_grain([p.copy() for p in planes], ours, bd, *sub)
    want = jax_grain.apply_grain([p.copy() for p in planes], ref, bd, *sub)
    for a, b, p in zip(got, want, planes):
        assert a.dtype == b.dtype == p.dtype
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(got[0], planes[0])


def test_still_item_with_grain_decodes_without_it():
    """A still AVIF whose frame header carries film grain parameters:
    ``decode_frame`` (the still path) applies none in either package,
    so ``load`` equals the reference's, and equals the frame's
    reconstruction with the grain applied nowhere."""
    rng = np.random.default_rng(7)
    rgb = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    b = io.BytesIO()
    Image.fromarray(rgb).save(b, "AVIF", quality=60, speed=6,
                              advanced=(("film-grain-test", "1"),))
    data = b.getvalue()
    from ffpic_tpu_torch.coding import av1_headers as H
    s = heif.parse_structure(data)
    obus = heif.read_item(data, s, s["primary"])
    seq = fh = None
    for obu in H.parse_obus(obus):
        if obu["type"] == H.OBU_SEQUENCE_HEADER:
            seq = H.parse_sequence_header(obu["payload"])
        elif obu["type"] in (H.OBU_FRAME, H.OBU_FRAME_HEADER):
            fh, _ = H.parse_frame_header(obu["payload"], seq)
            break
    assert seq.film_grain_params_present and fh.grain.apply_grain
    got = ffpic_tpu_torch.load(data, device="cpu").pixels.numpy()
    np.testing.assert_array_equal(got, ffpic_tpu.load(data).np_pixels())
    planes, _ = av1_recon.decode_frame(obus)
    grained = av1_grain.apply_grain(planes, fh.grain, 8, 1, 1)
    assert not np.array_equal(grained[0], planes[0])
