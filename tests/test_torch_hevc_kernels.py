"""The HEVC device stages of ffpic_tpu_torch (CPU, plain versions) held
against ffpic_tpu's on the same arrays: ``dequant_itransform_batch`` and
``dequant_skip_batch`` against the JAX functions of the same names and
the golden numpy pass (``coding/hevc_consts``) over every size, the
DST, bit depths 8 and 10, QPs 0..63 and the level extremes;
``hevc_residuals_plain`` (K14's function) and the route entries
``residuals_packed`` and ``residuals_for_ops`` against JAX's on flat
layouts with skip and bypass TUs, from ``testing.hevc_cases`` and from
real streams; ``testing.residuals_by_plan`` (K14's walk over its launch
plan with its even/odd butterflies) against the plain version, the
butterflies (``testing.inverse_butterfly``) against the direct product
of ``dct_matrix(n)`` and the DST, and the plan over several tiles' TUs
(largest first) with ``residuals_grid``'s one launch against a launch a
tile; ``hevc_yuv_to_rgba_plain`` (a tile's colour) against the JAX
branch of ``heif._yuv_pic_to_rgba`` (``jnp.repeat`` + ``color_convert``),
and ``hevc_tiles_to_rgba_plain`` (K15's function: a canvas's tiles)
against that branch pasted as ``heif._decode_grid`` pastes it, on
``testing.heif_tile_layouts``; ``stage_tiles``' descriptors and cells,
read as K15 reads them, against the tiles pasted one by one.  The
residual stages are integer: the tolerance is zero.  Colour is held up
to XLA's choice of contracting the colour products
(``testing.assert_equal_up_to_contraction``).  The
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
TILE_LAYOUTS = list(testing.heif_tile_layouts(0))


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


def _check_plan(meta: np.ndarray) -> None:
    """The plan covers every TU once, CTAs of one size each, at most
    128 / n TUs a CTA, sizes in descending order (stable within a
    size), each TU's descriptor its level offset (the cumulative n² sum)
    and its QP and flags."""
    desc, ctas = hk.plan_residuals(meta)
    n = meta[:, 2].astype(np.int64)
    offs = np.cumsum(n * n) - n * n
    assert desc.shape == (len(meta), 2) and desc.dtype == np.int32
    assert ctas.dtype == np.int32 and ctas.flags["C_CONTIGUOUS"]
    # each descriptor names one TU by its offset
    row = {int(o): k for k, o in enumerate(offs)}
    order = np.array([row[int(o)] for o in desc[:, 0]])
    assert sorted(order.tolist()) == list(range(len(meta)))
    assert (np.diff(n[order]) <= 0).all()
    for size in (32, 16, 8, 4):
        same = order[n[order] == size]
        assert (np.diff(same) > 0).all()
    want = (meta[order, 6] | (meta[order, 4] != 0) * hk.SKIP
            | (meta[order, 5] != 0) * hk.BYPASS
            | (meta[order, 7] != 0) * hk.DST)
    np.testing.assert_array_equal(desc[:, 1], want)
    covered = []
    for start, cnt, l2, pad in ctas:
        assert pad == 0 and 1 <= cnt <= hk.CTA_THREADS >> l2
        assert (n[order[start:start + cnt]] == 1 << l2).all()
        covered += list(range(start, start + cnt))
    assert covered == list(range(len(meta)))


def test_plan_residuals_layout():
    """The plan of ``mixed_bd8`` (``_check_plan``); a size K14 does not
    take raises."""
    meta, lv, _ = testing.hevc_cases(0)["mixed_bd8"]
    _check_plan(meta)
    with pytest.raises(ValueError, match="only 4, 8, 16 and 32"):
        hk.plan_residuals(np.array([[0, 0, 2, 0, 0, 0, 20, 0]], np.int32))


def test_plan_over_several_tiles_covers_each_tu_once_largest_first():
    """The plan over the concatenated TUs of three fixture tiles, as a
    grid's one launch takes them."""
    data = testing.heif_fixture()
    tus = [testing.heif_tile_tus(data, t) for t in (2, 25, 49)]
    _check_plan(np.concatenate([tu for tu, _, _ in tus]))


@pytest.mark.parametrize("case", ["one_each", "one_32", "mixed_bd8"])
def test_stage_residuals_packs_one_buffer(case):
    """One buffer holds the plan (the descriptors, then the CTA rows), one
    the levels; each starts on 16 bytes, as the kernel loads them; the
    pair and its ``stage_part`` stage alike."""
    meta, lv, _ = testing.hevc_cases(0)[case]
    cpu = torch.device("cpu")
    for part in ((meta, lv), hk.stage_part(meta, lv, cpu)):
        lv_d, (desc, ctas), needs = hk.stage_residuals([part], cpu)
        np.testing.assert_array_equal(lv_d.numpy(), lv)
        assert needs == [lv.size]
        for got, want in zip((desc, ctas), hk.plan_residuals(meta)):
            np.testing.assert_array_equal(got.numpy(), want)
        assert ctas.data_ptr() - desc.data_ptr() == 4 * (
            2 * len(meta) + (-2 * len(meta)) % 4)
        assert all(t.data_ptr() % 16 == 0 for t in (desc, ctas, lv_d))


def test_stage_residuals_of_several_tiles_is_the_plan_of_all():
    """Three fixture tiles staged apart (``stage_part``, as a grid's
    workers do) and assembled: the plan of their concatenated TUs and
    their levels one after another."""
    data = testing.heif_fixture()
    tus = [testing.heif_tile_tus(data, t) for t in (2, 25, 49)]
    cpu = torch.device("cpu")
    lv_d, (desc, ctas), needs = hk.stage_residuals(
        [hk.stage_part(tu, lv, cpu) for tu, lv, _ in tus], cpu)
    want = hk.plan_residuals(np.concatenate([tu for tu, _, _ in tus]))
    np.testing.assert_array_equal(desc.numpy(), want[0])
    np.testing.assert_array_equal(ctas.numpy(), want[1])
    np.testing.assert_array_equal(
        lv_d.numpy(), np.concatenate([lv for _, lv, _ in tus]))
    assert needs == [lv.size for _, lv, _ in tus]


@pytest.mark.parametrize("n,dst", [(4, False), (4, True), (8, False),
                                   (16, False), (32, False)])
def test_butterfly_equals_the_direct_product(n, dst):
    """The kernel's even/odd butterflies (and its direct DST), modelled in
    numpy, against the direct product with ``dct_matrix(n)`` (``DST4``)
    on random int16 inputs with the extremes +-32768 planted: equal
    exactly, every sum inside int32."""
    rng = np.random.default_rng(40 + n + dst)
    c = rng.integers(-32768, 32768, (64, n)).astype(np.int64)
    c[0] = 32768
    c[1] = -32768
    c[2, ::2], c[2, 1::2] = 32768, -32768
    c[3] = 0
    c[4, 0] = -32768
    m = np.asarray(hc.DST4 if dst else hc.dct_matrix(n), np.int64)
    np.testing.assert_array_equal(testing.inverse_butterfly(c, n, dst),
                                  c @ m)
    for k in range(n):
        for i in range(n):
            assert dst or testing.trans_coef(k * 32 // n, i) == m[k, i]


def test_kernel_source_holds_the_models_constants():
    """``csrc/hevc_decode.cu``'s table of ``trans_coef``, its folding of
    the angle and its DST matrix are the numpy model's, so the butterfly
    test above speaks for the kernel's immediates."""
    import re
    from ffpic_tpu_torch.ops import _build
    with open(f"{_build.CSRC}/hevc_decode.cu") as f:
        src = f.read()

    def ints(pattern):
        return [int(v) for v in re.findall(
            r"-?\d+", re.search(pattern, src, re.S).group(1))]
    assert tuple(ints(r"const int a\[33\] = \{(.*?)\};")) == \
        testing._TRANS_A
    assert ints(r"constexpr int D\[4\]\[4\] = \{(.*?)\};") == \
        [v for row in testing._DST4_KI for v in row]
    fold = re.search(r"trans_coef\(int k, int i\) \{.*?\n\}", src, re.S)
    assert "int u = ((2 * i + 1) * k) & 127;" in fold.group(0)
    assert "if (u > 64) u = 128 - u;" in fold.group(0)
    assert "return u > 32 ? -a[64 - u] : a[u];" in fold.group(0)


def test_residuals_grid_is_one_launch_of_every_tile():
    """``residuals_grid`` over three fixture tiles: each tile's slice
    equals ``residuals_packed`` of that tile alone, and the plain version
    runs once."""
    data = testing.heif_fixture()
    tus = [testing.heif_tile_tus(data, t) for t in (2, 25, 49)]
    calls = []
    real = hk.hevc_residuals_plain

    def spy(*a):
        calls.append(a[1].numel())
        return real(*a)
    bd = tus[0][2]
    try:
        hk.hevc_residuals_plain = spy
        got = hk.residuals_grid([(tu, lv) for tu, lv, _ in tus], bd, "cpu")
    finally:
        hk.hevc_residuals_plain = real
    assert calls == [sum(lv.size for _, lv, _ in tus)]
    for g, (tu, lv, _) in zip(got, tus):
        np.testing.assert_array_equal(g, hk.residuals_packed(tu, lv, bd,
                                                             "cpu"))


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
        lambda: hk.hevc_yuv_to_rgba_plain(*t, oh, ow, mode), want)

    def into_canvas():
        canvas = torch.zeros((oh + 3, ow + 5, 4), dtype=torch.uint8)
        hk.hevc_yuv_to_rgba_plain(*t, oh, ow, mode, out=canvas, y0=2, x0=4)
        return canvas
    big = np.zeros((oh + 3, ow + 5, 4), np.uint8)
    big[2:2 + oh, 4:4 + ow] = want
    big[2:2 + oh, 4:4 + ow, 3] = 255
    testing.assert_equal_up_to_contraction(into_canvas, big)


def test_hevc_yuv_to_rgba_crops_at_the_canvas_edge():
    y, u, v, oh, ow, mode = testing.heif_color_cases(0)["crop_61x37"]
    t = [torch.from_numpy(a) for a in (y, u, v)]
    canvas = torch.full((40, 30, 4), 7, dtype=torch.uint8)
    hk.hevc_yuv_to_rgba_plain(*t, oh, ow, mode, out=canvas, y0=30, x0=20)
    want = hk.hevc_yuv_to_rgba_plain(*t, oh, ow, mode)
    assert torch.equal(canvas[30:, 20:], want[:10, :10])
    assert (canvas[:30] == 7).all() and (canvas[:, :20] == 7).all()


def test_cuda_wrappers_refuse_cpu_tensors():
    meta, lv, bd = testing.hevc_cases(0)["one_each"]
    desc, ctas = (torch.from_numpy(a) for a in hk.plan_residuals(meta))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_hevc.hevc_residuals(torch.from_numpy(lv), bd, desc, ctas)
    y = np.zeros((8, 8), np.int16)
    st = hk.stage_tiles([[y]], [(0, 0, 8, 8)], 8, 8, torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_hevc.hevc_yuv_to_rgba(st)
    with pytest.raises(ValueError, match="mode"):
        cuda_hevc.hevc_yuv_to_rgba(st, mode="nclx")
    with pytest.raises(ValueError, match="StagedTiles"):  # loose pieces
        cuda_hevc.hevc_yuv_to_rgba(st.planes)
    with pytest.raises(ValueError, match="planes"):      # U without V
        hk.stage_tiles([[y, y[:4, :4]]], [(0, 0, 8, 8)], 8, 8,
                       torch.device("cpu"))
    with pytest.raises(ValueError, match="needs"):       # chroma too small
        hk.stage_tiles([[y, y[:3, :4], y[:3, :4]]], [(0, 0, 8, 8)], 8, 8,
                       torch.device("cpu"))


def _jax_paste(planes, spans, height: int, width: int, mode: str):
    """``ffpic_tpu/formats/heif.py:_decode_grid``'s canvas of the tiles'
    device colour (``_jax_colour``): (0, 0, 0, 255), then each tile pasted
    in order, cropped at the canvas's edge."""
    canvas = np.zeros((height, width, 4), np.uint8)
    canvas[:, :, 3] = 255
    for ps, (y0, x0, oh, ow) in zip(planes, spans):
        if y0 < height and x0 < width:
            y, u, v = (*ps, None, None)[:3]
            canvas[y0:y0 + oh, x0:x0 + ow] = _jax_colour(
                y, u, v, oh, ow, mode)[:height - y0, :width - x0]
    return canvas


@pytest.mark.parametrize("layout", TILE_LAYOUTS)
def test_tiles_plain_matches_jax_paste(layout):
    """K15's plain counterpart (a canvas's tiles staged in one buffer,
    pasted in order) equals the reference's canvas: a grid with cropped
    edge tiles, an uncovered canvas, overlapping tiles of unequal sizes,
    4:0:0 beside 4:2:0, odd offsets, a single item."""
    planes, spans, h, w, mode = testing.heif_tile_layouts(0)[layout]
    st = hk.stage_tiles(planes, spans, h, w, torch.device("cpu"))
    testing.assert_equal_up_to_contraction(
        lambda: hk.hevc_tiles_to_rgba(st, mode),
        _jax_paste(planes, spans, h, w, mode))


@pytest.mark.parametrize("layout", TILE_LAYOUTS)
def test_stage_tiles_model_matches_the_paste(layout):
    """``stage_tiles``' index read as K15 reads it: each pixel's cell
    (``row_cell``, ``col_cell``) names the tile a paste in order leaves
    there (``cell_map``), whose descriptor's offsets, pitches and place
    find its Y, U and V in the staged buffer; coloured, that is the plain
    counterpart's canvas bit for bit.  Every plane starts 16-byte
    aligned."""
    planes, spans, h, w, mode = testing.heif_tile_layouts(0)[layout]
    st = hk.stage_tiles(planes, spans, h, w, torch.device("cpu"))
    flat, desc = st.planes.numpy(), st.desc.numpy()
    assert st.desc.shape == (len(spans), hk.TILE_DESC)
    assert not (desc[:, :3][desc[:, :3] >= 0] % 8).any()
    last = np.full((h, w), -1)
    for k, (y0, x0, oh, ow) in enumerate(spans):
        last[y0:y0 + oh, x0:x0 + ow] = k
    cell = st.cell_map.numpy()[st.row_cell.numpy()][:, st.col_cell.numpy()]
    np.testing.assert_array_equal(cell, last)
    yy, xx = np.mgrid[0:h, 0:w]
    covered = cell >= 0
    d = desc[np.where(covered, cell, 0)].astype(np.int64)
    yl, xl = yy - d[..., 5], xx - d[..., 6]
    y = flat[np.where(covered, d[..., 0] + yl * d[..., 3] + xl, 0)]
    chroma = covered & (d[..., 1] >= 0)
    at = (yl >> 1) * d[..., 4] + (xl >> 1)
    u = np.where(chroma, flat[np.where(chroma, d[..., 1] + at, 0)], 128)
    v = np.where(chroma, flat[np.where(chroma, d[..., 2] + at, 0)], 128)
    rgba = hk.color_convert(*(torch.from_numpy(a.astype(np.int16))
                              for a in (y, u, v)), order="rgba", mode=mode)
    rgba[torch.from_numpy(~covered)] = torch.tensor([0, 0, 0, 255],
                                                    dtype=torch.uint8)
    assert torch.equal(rgba, hk.hevc_tiles_to_rgba_plain(st, mode))
