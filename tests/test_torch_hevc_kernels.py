"""The HEVC device stages of ffpic_tpu_torch (CPU, plain versions) held
against ffpic_tpu's on the same arrays: ``dequant_itransform_batch`` and
``dequant_skip_batch`` against the JAX functions of the same names and
the golden numpy pass (``coding/hevc_consts``) over every size, the
DST, bit depths 8 and 10, QPs 0..63 and the level extremes;
``hevc_residuals_plain`` (K14's function) and the route entries
``residuals_packed`` and ``residuals_for_ops`` against JAX's on flat
layouts with skip and bypass TUs, from ``testing.hevc_cases`` and from
real streams; ``testing.residuals_by_plan`` (K14's walk over its launch
plan) against the plain version; ``hevc_yuv_to_rgba_plain`` (K15's
function) against the JAX branch of ``heif._yuv_pic_to_rgba``
(``jnp.repeat`` + ``color_convert``).  The residual stages are integer:
the tolerance is zero.  Colour is held up to XLA's choice of contracting
the colour products (``testing.assert_equal_up_to_contraction``).  The
CUDA kernels run only on a GPU (``chip_smoke.py``); here their wrappers
are checked to refuse CPU tensors and the entries to take the plain
versions for CPU tensors.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ffpic_tpu import native as jax_native
from ffpic_tpu.coding import hevc_consts as jax_hc
from ffpic_tpu.coding.hevc_slice import SliceDecoder as JaxSliceDecoder
from ffpic_tpu.formats import hevc as jax_hevc
from ffpic_tpu.ops import hevc_kernels as jax_hk
from ffpic_tpu.ops.jpeg_kernels import color_convert as jax_color_convert
from ffpic_tpu_torch import native, testing
from ffpic_tpu_torch.coding import hevc_consts as hc
from ffpic_tpu_torch.ops import cuda_hevc
from ffpic_tpu_torch.ops import hevc_kernels as hk
import reference_native  # noqa: F401  (readies ffpic_tpu first)

CASES = list(testing.hevc_cases(0))
COLOR_CASES = list(testing.heif_color_cases(0))


def _levels(rng, B: int, n: int) -> np.ndarray:
    """Sparse and dense levels with the int16 extremes planted."""
    lv = rng.integers(-40, 41, (B, n, n)).astype(np.int32)
    lv[: B // 3] *= rng.integers(0, 2, (B // 3, n, n)).astype(np.int32)
    lv[-4] = rng.integers(-32768, 32768, (n, n))
    lv[-3, 0, 0], lv[-3, -1, -1] = 32767, -32768
    lv[-2] = 32767
    lv[-1] = -32768
    return lv


@pytest.mark.parametrize("n,dst", [(4, False), (4, True), (8, False),
                                   (16, False), (32, False)])
@pytest.mark.parametrize("bd", [8, 10])
def test_dequant_itransform_batch_matches_jax(n, dst, bd):
    rng = np.random.default_rng(100 * n + bd + dst)
    lv = _levels(rng, 24, n)
    qps = np.arange(24, dtype=np.int32) * 63 // 23      # 0..63
    got = hk.dequant_itransform_batch(torch.from_numpy(lv),
                                      torch.from_numpy(qps), n, bd, dst)
    assert got.dtype == torch.int32
    want = np.asarray(jax_hk.dequant_itransform_batch(lv, qps, n,
                                                      bit_depth=bd, dst=dst))
    np.testing.assert_array_equal(got.numpy(), want)
    for i in range(len(lv)):
        d = hc.dequant(lv[i], int(qps[i]), bd)
        np.testing.assert_array_equal(d, jax_hc.dequant(lv[i], int(qps[i]),
                                                        bd))
        np.testing.assert_array_equal(
            got[i].numpy(), hc.inverse_transform(d, dst=dst, bit_depth=bd))


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("n", [4, 8])
def test_dequant_skip_batch_matches_jax(bd, n):
    rng = np.random.default_rng(7 * bd + n)
    lv = _levels(rng, 16, n)
    qps = rng.integers(0, 64, 16).astype(np.int32)
    got = hk.dequant_skip_batch(torch.from_numpy(lv), torch.from_numpy(qps),
                                n, bd)
    want = np.asarray(jax_hk.dequant_skip_batch(lv, qps, n, bit_depth=bd))
    np.testing.assert_array_equal(got.numpy(), want)


def test_tables_match_jax():
    for n in (4, 8, 16, 32):
        np.testing.assert_array_equal(hc.dct_matrix(n), jax_hc.dct_matrix(n))
    np.testing.assert_array_equal(hc.DST4, jax_hc.DST4)
    assert hc.LEVEL_SCALE == jax_hc.LEVEL_SCALE
    for ls in range(2, 6):
        for idx in range(3):
            np.testing.assert_array_equal(hc.scan_order(ls, idx),
                                          jax_hc.scan_order(ls, idx))
    rng = np.random.default_rng(3)
    res = rng.integers(-255, 256, (8, 8))
    np.testing.assert_array_equal(hc.forward_transform(res),
                                  jax_hc.forward_transform(res))
    c = rng.integers(-3000, 3000, (8, 8))
    np.testing.assert_array_equal(hc.quantize(c, 30), jax_hc.quantize(c, 30))


@pytest.mark.parametrize("case", CASES)
def test_hevc_residuals_plain_matches_jax(case):
    meta, lv, bd = testing.hevc_cases(0)[case]
    got = hk.hevc_residuals_plain(torch.from_numpy(meta),
                                  torch.from_numpy(lv), bd)
    assert got.dtype == torch.int16 and got.numel() == lv.size
    want = jax_hk.residuals_packed(meta, lv, bd)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        hk.residuals_packed(meta, lv, bd, device="cpu"), want)


@pytest.mark.parametrize("case", CASES)
def test_kernel_walk_over_its_plan_matches_plain(case):
    meta, lv, bd = testing.hevc_cases(0)[case]
    want = hk.hevc_residuals_plain(torch.from_numpy(meta),
                                   torch.from_numpy(lv), bd).numpy()
    np.testing.assert_array_equal(testing.residuals_by_plan(meta, lv, bd),
                                  want)


def test_plan_residuals_layout():
    """The plan covers every TU once, CTAs of one size each, at most
    1024 samples a CTA, sizes in ascending order, and offsets the
    cumulative n² sum."""
    meta, lv, _ = testing.hevc_cases(0)["mixed_bd8"]
    offs, perm, ctas = hk.plan_residuals(meta)
    n = meta[:, 2].astype(np.int64)
    np.testing.assert_array_equal(offs, np.cumsum(n * n) - n * n)
    assert sorted(perm.tolist()) == list(range(len(meta)))
    assert (np.diff(n[perm]) >= 0).all()
    covered = []
    for start, cnt, l2, pad in ctas:
        assert pad == 0 and 1 <= cnt and cnt << (2 * l2) <= hk.CTA_SAMPLES
        assert (n[perm[start:start + cnt]] == 1 << l2).all()
        covered += perm[start:start + cnt].tolist()
    assert sorted(covered) == list(range(len(meta)))
    assert ctas.dtype == np.int32 and ctas.flags["C_CONTIGUOUS"]
    with pytest.raises(ValueError, match="only 4, 8, 16 and 32"):
        hk.plan_residuals(np.array([[0, 0, 2, 0, 0, 0, 20, 0]], np.int32))


@pytest.mark.parametrize("case", ["one_each", "one_32", "mixed_bd8"])
def test_stage_residuals_packs_one_buffer(case):
    """One buffer holds the TU rows, the plan and the levels; the CTA
    rows and the levels start on 16 bytes, as the kernel loads them."""
    meta, lv, _ = testing.hevc_cases(0)[case]
    m_d, lv_d, (offs, perm, ctas) = hk.stage_residuals(meta, lv,
                                                      torch.device("cpu"))
    np.testing.assert_array_equal(m_d.numpy(), meta)
    np.testing.assert_array_equal(lv_d.numpy(), lv)
    for got, want in zip((offs, perm, ctas), hk.plan_residuals(meta)):
        np.testing.assert_array_equal(got.numpy(), want)
    base = m_d.data_ptr()
    assert all(t.data_ptr() - base >= 0 for t in (offs, perm, ctas, lv_d))
    assert (ctas.data_ptr() - base) % 16 == 0
    assert (lv_d.data_ptr() - base) % 16 == 0


@pytest.mark.parametrize("kind", ["single", "skip", "bypass", "10bit"])
def test_residuals_packed_on_a_stream_matches_jax(kind):
    """The native syntax pass's flat layout of a real picture through
    the port's route and JAX's."""
    enc, nalus = testing.hevc_stream(kind, 64, 64)
    hdr, data = _slice(enc, nalus[0])
    params = jax_hevc._params_for_native(enc.sps, enc.pps, hdr)
    states, mps = jax_hevc._ctx_init_arrays(hdr.qp)
    jax_native.available()
    _ops, tu, lv, *_ = jax_native.hevc_decode_slice(data, params, states, mps)
    _ops2, tu2, lv2, *_ = native.hevc_decode_slice(data, params, states, mps)
    np.testing.assert_array_equal(tu, tu2)
    assert (tu[:, 4].any() if kind == "skip" else True)
    assert (tu[:, 5].any() if kind == "bypass" else True)
    bd = enc.sps.bit_depth_luma
    need = int((tu[:, 2].astype(np.int64) ** 2).sum())
    want = jax_hk.residuals_packed(tu, lv, bd)[:need]
    np.testing.assert_array_equal(hk.residuals_packed(tu2, lv2, bd, "cpu"),
                                  want)


def _slice(enc, nalu):
    from ffpic_tpu.coding.hevc_slice import parse_slice_header
    from ffpic_tpu.utils.bitstream import BitReader
    rbsp = jax_hevc.unescape(nalu)
    r = BitReader(rbsp)
    r.skip_bits(16)
    hdr = parse_slice_header(r, (rbsp[0] >> 1) & 0x3F, enc.sps, enc.pps)
    return hdr, rbsp[hdr.data_bit_offset // 8:]


@pytest.mark.parametrize("kind", ["skip", "bypass", "scaling_custom"])
def test_residuals_for_ops_matches_jax(kind):
    """The Python syntax pass's op list: one dict entry per non-bypass
    TU, equal to JAX's; ``tu.scaling`` is ignored by both."""
    from ffpic_tpu.formats.hevc_recon import Picture
    enc, nalus = testing.hevc_stream(kind, 64, 64)
    hdr, data = _slice(enc, nalus[0])
    pic = Picture(enc.sps)
    ops = JaxSliceDecoder(enc.sps, enc.pps, hdr, data, pic) \
        .decode_slice_data()
    bd = enc.sps.bit_depth_luma
    want = jax_hk.residuals_for_ops(ops, bd)
    got = hk.residuals_for_ops(ops, bd, "cpu")
    assert set(got) == set(want) and want
    for k in want:
        assert got[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    if kind == "bypass":
        assert any(op.tu.bypass for op in ops if getattr(op, "tu", None))


def test_route_checks():
    meta, lv, _ = testing.hevc_cases(0)["one_each"]
    with pytest.raises(ValueError, match="bit depth"):
        hk.residuals_packed(meta, lv, 16, "cpu")
    bad = meta.copy()
    bad[0, 6] = -1
    with pytest.raises(ValueError, match="QPs"):
        hk.residuals_packed(bad, lv, 8, "cpu")
    with pytest.raises(ValueError, match="levels"):
        hk.residuals_packed(meta, lv[:-1], 8, "cpu")
    with pytest.raises(ValueError, match=r"\(m, 8\)"):
        hk.residuals_packed(meta[:, :7], lv, 8, "cpu")
    assert hk.residuals_packed(meta[:0], lv[:0], 8, "cpu").size == 0
    with pytest.raises(ValueError, match="levels"):
        hk.hevc_residuals_plain(torch.from_numpy(meta),
                                torch.from_numpy(lv[:-3]), 8)


def _jax_colour(y, u, v, out_h, out_w, mode):
    """The device branch of ``ffpic_tpu/formats/heif.py:356-371``."""
    yp = jnp.asarray(y)
    if u is not None:
        up = jnp.repeat(jnp.repeat(jnp.asarray(u), 2, 0), 2, 1)[
            :yp.shape[0], :yp.shape[1]]
        vp = jnp.repeat(jnp.repeat(jnp.asarray(v), 2, 0), 2, 1)[
            :yp.shape[0], :yp.shape[1]]
    else:
        up = vp = jnp.full_like(yp, 128)
    rgba = jax_color_convert(yp, up, vp, order="rgba", mode=mode)
    return np.asarray(rgba)[:out_h, :out_w]


@pytest.mark.parametrize("case", COLOR_CASES)
def test_hevc_yuv_to_rgba_plain_matches_jax(case):
    y, u, v, oh, ow, mode = testing.heif_color_cases(0)[case]
    t = [None if a is None else torch.from_numpy(a) for a in (y, u, v)]
    want = _jax_colour(y, u, v, oh, ow, mode)
    testing.assert_equal_up_to_contraction(
        lambda: hk.hevc_yuv_to_rgba(*t, oh, ow, mode), want)

    def into_canvas():
        canvas = torch.zeros((oh + 3, ow + 5, 4), dtype=torch.uint8)
        hk.hevc_yuv_to_rgba(*t, oh, ow, mode, out=canvas, y0=2, x0=4)
        return canvas
    big = np.zeros((oh + 3, ow + 5, 4), np.uint8)
    big[2:2 + oh, 4:4 + ow] = want
    big[2:2 + oh, 4:4 + ow, 3] = 255
    testing.assert_equal_up_to_contraction(into_canvas, big)


def test_hevc_yuv_to_rgba_crops_at_the_canvas_edge():
    y, u, v, oh, ow, mode = testing.heif_color_cases(0)["crop_61x37"]
    t = [torch.from_numpy(a) for a in (y, u, v)]
    canvas = torch.full((40, 30, 4), 7, dtype=torch.uint8)
    hk.hevc_yuv_to_rgba(*t, oh, ow, mode, out=canvas, y0=30, x0=20)
    want = hk.hevc_yuv_to_rgba(*t, oh, ow, mode)
    assert torch.equal(canvas[30:, 20:], want[:10, :10])
    assert (canvas[:30] == 7).all() and (canvas[:, :20] == 7).all()


def test_cuda_wrappers_refuse_cpu_tensors():
    meta, lv, bd = testing.hevc_cases(0)["one_each"]
    offs, perm, ctas = (torch.from_numpy(a) for a in hk.plan_residuals(meta))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_hevc.hevc_residuals(torch.from_numpy(meta), torch.from_numpy(lv),
                                 bd, offs, perm, ctas)
    y = torch.zeros((8, 8), dtype=torch.int16)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_hevc.hevc_yuv_to_rgba(y, None, None, 8, 8)
    with pytest.raises(ValueError, match="mode"):
        cuda_hevc.hevc_yuv_to_rgba(y, None, None, 8, 8, mode="nclx")
    with pytest.raises(ValueError, match="both planes or neither"):
        cuda_hevc.hevc_yuv_to_rgba(y, y, None, 8, 8)
