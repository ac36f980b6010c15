"""HEIF/HEIC in ffpic_tpu_torch held against ffpic_tpu on the same bytes,
on the CPU: a counterpart of each test of ``tests/test_heif.py`` (single
items, grids with alpha, ``skip_decode``, quality, odd sizes, truncation,
``irot``, image sequences, colr/nclx, CRA items, EXIF items, the native
colour, multi-slice/tiles/WPP/dependent items) and of
``tests/test_hevc_kernels.py:48-91`` (the device residual routes); the
encoder's bytes; the committed 12 MP fixture, byte-equal with the JAX
bench's and decoded byte-equal by both packages; the small HEICs of
``testing.heif_cases`` under the four combinations of
``FFPIC_HEVC_DEVICE`` and ``FFPIC_HEIF_DEVICE_COLOR``; a grid's
three-phase route under ``FFPIC_HEVC_DEVICE`` (every tile's syntax, one
residual launch over all tiles, every tile's recon); and the two
reference faults the port mirrors (scaling lists under
``FFPIC_HEVC_DEVICE``, 10-bit items under ``FFPIC_HEIF_DEVICE_COLOR``).
Pixels are exact; the device colour is held up to XLA's choice of
contracting its products (``testing.assert_equal_up_to_contraction``),
since the reference runs it eagerly, unfused.
"""

import functools
import hashlib
import struct

import numpy as np
import pytest

import ffpic_tpu
import ffpic_tpu_torch as ft
from ffpic_tpu import native as jax_native
from ffpic_tpu.formats import heif as jax_heif
from ffpic_tpu.formats import heif_enc as jax_heif_enc
from ffpic_tpu.formats.pic import Pic as JaxPic
from ffpic_tpu_torch import make_heif_fixtures, testing
from ffpic_tpu_torch.formats import heif, heif_enc
from ffpic_tpu_torch.formats.pic import Pic
import reference_native  # noqa: F401  (readies ffpic_tpu first)

SWITCHES = {"host": {}, "hevc_device": {"FFPIC_HEVC_DEVICE": "1"},
            "device_color": {"FFPIC_HEIF_DEVICE_COLOR": "1"},
            "both": {"FFPIC_HEVC_DEVICE": "1",
                     "FFPIC_HEIF_DEVICE_COLOR": "1"}}
CASES = ["10bit", "skip", "bypass", "deblock", "grid_alpha", "odd_333x199"]


@functools.cache
def _heif_cases() -> dict:
    """``testing.heif_cases(0)``, written once a process."""
    return testing.heif_cases(0)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    jax_native.available()
    for k in ("FFPIC_HEVC_DEVICE", "FFPIC_HEIF_DEVICE_COLOR",
              "FFPIC_NO_NATIVE_RECON", "FFPIC_NO_NATIVE"):
        monkeypatch.delenv(k, raising=False)


def _pic(w, h, seed=1, alpha=False):
    p = testing.heif_pic(w, h, seed, alpha)
    return p, JaxPic(width=w, height=h, depth=32, pitch=w * 4, codec="raw",
                     pixels=p.pixels)


def _load_both(data, **kw):
    got = ft.load(data, device="cpu", **kw)
    want = ffpic_tpu.load(data, **kw)
    return got, want


def _same(got, want):
    assert (got.width, got.height, got.codec) == \
        (want.width, want.height, want.codec)
    np.testing.assert_array_equal(got.np_pixels(), want.np_pixels())
    assert repr(got.meta) == repr(want.meta)
    assert ft.info(got) == ffpic_tpu.info(want)


@pytest.mark.parametrize("w,h,kw", [
    (96, 80, dict(qp=22)), (150, 120, dict(qp=20, tile=64)),
    (50, 34, dict(qp=20)), (64, 64, dict(quality=90)),
    (64, 64, dict(qp=45))])
def test_encode_and_load_match_jax(w, h, kw):
    """encode gives encode_heif's bytes (single items, a grid with an
    alpha item, odd sizes, the quality and QP ladders); load gives the
    reference's pixels, meta and info."""
    p, jp = _pic(w, h, seed=w + h, alpha="tile" in kw)
    data = ft.encode(p, "heif", device="cpu", **kw)
    assert data == jax_heif_enc.encode_heif(jp, **kw)
    assert data == heif_enc.encode_heif(p, **kw)
    got, want = _load_both(data)
    _same(got, want)
    assert got.codec == "HEIF"
    if "tile" in kw:
        assert got.meta["grid"] == dict(rows=2, cols=3, width=150,
                                        height=120)
        assert got.meta.get("alpha") is True
    for mode in ("reference", "bt601"):
        np.testing.assert_array_equal(
            ft.load(data, device="cpu", mode=mode).np_pixels(),
            jax_heif.load(data, mode=mode)[0].pixels)


def test_skip_decode_matches_jax():
    p, _ = _pic(64, 64)
    data = ft.encode(p, "heif", device="cpu", qp=30)
    got = ft.load(data, skip_decode=True)
    want = ffpic_tpu.load(data, skip_decode=True)
    assert got.pixels is None and got.width == 64
    assert repr(got.meta) == repr(want.meta)
    assert ft.info(got) == ffpic_tpu.info(want)
    assert ft.probe(data).name == "HEIF"


def test_truncated_raises():
    p, _ = _pic(64, 64)
    data = ft.encode(p, "heif", device="cpu", qp=30)
    with pytest.raises((ValueError, NotImplementedError)):
        ft.load(data[:len(data) // 2], device="cpu")


def _item(enc_planes, qp, w, h, extra=()):
    """A single hvc1 item written with the port's encoder, and extra
    property boxes."""
    y, u, v = enc_planes
    policy = heif_enc.EncPolicy(seed=0, split_prob=0.3, tt_split_prob=0.2,
                                nxn_prob=0.1, mode_candidates=(0, 1, 10, 26))
    idr, sps_r, pps_r = heif_enc._encode_tile((y, u, v), qp, policy)
    return idr, sps_r, pps_r, [
        (heif_enc._box("hvcC", heif_enc._hvcc(sps_r, pps_r)), True),
        (heif_enc._ispe(w, h), False), *extra]


def test_irot_rotation_matches_jax(monkeypatch):
    p, _ = _pic(64, 32, seed=6)
    y, u, v = heif_enc.rgb_to_yuv420(p.pixels)
    planes = heif_enc._pad_planes(y, u, v)[:3]
    for rot in (1, 2, 3):
        idr, _s, _p, props = _item(planes, 20, 64, 32,
                                   [(heif_enc._box("irot", bytes((rot,))),
                                     False)])
        blob = heif_enc._assemble(
            [(1, b"hvc1", struct.pack(">I", len(idr)) + idr, props)], [], 1)
        got, want = _load_both(blob)
        _same(got, want)
        assert got.meta.get("rotation") == 90 * rot
        monkeypatch.setenv("FFPIC_HEIF_DEVICE_COLOR", "1")
        dev = ft.load(blob, device="cpu")
        monkeypatch.delenv("FFPIC_HEIF_DEVICE_COLOR")
        assert (dev.width, dev.height) == (got.width, got.height)
        testing.assert_equal_up_to_contraction(
            lambda: _device_colour(blob), ffpic_tpu.load(blob).np_pixels())


def _device_colour(data, **kw):
    """The port's load of ``data`` under ``FFPIC_HEIF_DEVICE_COLOR``
    (set around the call, so that ``assert_equal_up_to_contraction`` can
    run it twice)."""
    import os
    os.environ["FFPIC_HEIF_DEVICE_COLOR"] = "1"
    try:
        return ft.load(data, device="cpu", **kw).np_pixels()
    finally:
        del os.environ["FFPIC_HEIF_DEVICE_COLOR"]


def test_image_sequence_matches_jax():
    """An image sequence (moov/trak): the encoder's bytes, then the
    primary and every frame through the sequence decoder, the
    header-only parse, and ``decode_batch`` (the primary), as the
    reference gives them."""
    pics = [_pic(48, 32, seed=10 + k) for k in range(3)]
    data = jax_heif_enc.encode_heif_sequence([j for _p, j in pics], qp=22)
    assert heif_enc.encode_heif_sequence([p for p, _j in pics], qp=22) == data
    got, want = _load_both(data)
    _same(got, want)
    assert len(got.frames) == len(want.frames) == 3
    for g, w in zip(got.frames, want.frames):
        assert (g.width, g.height) == (w.width, w.height)
        np.testing.assert_array_equal(g.np_pixels(), w.np_pixels())
    head = ft.load(data, skip_decode=True)
    assert head.meta["sequence"] is True
    assert repr(head.meta) == repr(ffpic_tpu.load(data, skip_decode=True).meta)
    np.testing.assert_array_equal(
        ft.decode_batch([data], device="cpu").numpy(),
        np.asarray(ffpic_tpu.decode_batch([data])))


def test_colr_nclx_written_parsed_and_applied():
    p, _ = _pic(48, 32, seed=10)
    data = ft.encode(p, "heif", device="cpu", qp=20)
    s = heif.parse_structure(data)
    assert s["items"][s["primary"]]["properties"]["nclx"] == dict(
        primaries=1, transfer=13, matrix=5, full_range=True)
    assert repr(s) == repr(jax_heif.parse_structure(data))
    old = b"nclx" + struct.pack(">HHHB", 1, 13, 5, 0x80)
    for new in (struct.pack(">HHHB", 1, 1, 1, 0x00),
                struct.pack(">HHHB", 9, 16, 9, 0x80)):
        patched = data.replace(old, b"nclx" + new)
        got, want = _load_both(patched)
        _same(got, want)
        assert np.abs(got.np_pixels()[..., :3].astype(int) - ft.load(
            data, device="cpu").np_pixels()[..., :3].astype(int)).max() > 4


def test_cra_item_matches_jax():
    """A CRA slice (the wild-iPhone norm) decodes like the IDR."""
    from ffpic_tpu.coding.hevc_enc import write_se, write_ue
    from ffpic_tpu_torch.coding.hevc_enc import make_nalu
    from ffpic_tpu_torch.coding.hevc_slice import parse_slice_header
    from ffpic_tpu_torch.formats import hevc
    from ffpic_tpu_torch.utils.bitstream import BitReader, BitWriter
    _, rgba = _pic(64, 64, seed=11)[0], testing.heif_pic(64, 64, 11).pixels
    y, u, v = heif_enc.rgb_to_yuv420(rgba)
    idr, sps_r, pps_r, props = _item(heif_enc._pad_planes(y, u, v)[:3], 22,
                                     64, 64)
    sps = hevc.parse_sps(make_nalu(33, sps_r))
    pps = hevc.parse_pps(make_nalu(34, pps_r))
    rbsp = hevc.unescape(idr)
    r = BitReader(rbsp)
    r.skip_bits(16)
    hdr = parse_slice_header(r, 19, sps, pps)
    w = BitWriter()
    w.write_bit(1)
    w.write_bit(0)
    write_ue(w, 0)
    write_ue(w, 2)
    w.write_bits(0, sps.log2_max_pic_order_cnt)
    w.write_bit(0)
    write_ue(w, 0)
    write_ue(w, 0)
    write_se(w, hdr.qp - pps.init_qp)
    w.write_bit(1)
    w.align_byte(0)
    cra = make_nalu(21, w.getvalue() + rbsp[hdr.data_bit_offset // 8:])
    blobs = [heif_enc._assemble([(1, b"hvc1", struct.pack(">I", len(n)) + n,
                                  props)], [], 1) for n in (cra, idr)]
    got, want = _load_both(blobs[0])
    _same(got, want)
    np.testing.assert_array_equal(got.np_pixels(),
                                  ft.load(blobs[1], device="cpu").np_pixels())


def test_exif_item_matches_jax():
    from test_containers import _exif_app1
    rgba = testing.heif_pic(48, 32, 12).pixels
    y, u, v = heif_enc.rgb_to_yuv420(rgba)
    idr, _s, _p, props = _item(heif_enc._pad_planes(y, u, v)[:3], 24, 48, 32)
    items = [(1, b"hvc1", struct.pack(">I", len(idr)) + idr, props),
             (2, b"Exif", struct.pack(">I", 0) + _exif_app1(8)[4:], [])]
    data = heif_enc._assemble(items, [("cdsc", 2, [1])], 1)
    got, want = _load_both(data)
    _same(got, want)
    assert got.meta["exif"]["orientation"] == 8
    assert got.exif_transpose().np_pixels().shape[:2] == (48, 32)


@pytest.mark.parametrize("bd,mono", [(8, False), (10, False), (8, True),
                                     (10, True)])
def test_native_colour_matches_jax_numpy(bd, mono, monkeypatch):
    """The port's colour (``native.hevc_color``) against the reference's
    numpy float32 path, in every mode, 4:2:0 and 4:0:0, 8 and 10 bits."""
    from ffpic_tpu.formats.hevc_recon import Picture as JaxPicture
    from ffpic_tpu_torch.formats.hevc_recon import Picture

    class SPS:
        width, height, bit_depth_luma = 77, 53, bd
        chroma_format = 0 if mono else 1
        pic_width_cropped, pic_height_cropped, ctb_log2 = 77, 53, 5

    rng = np.random.default_rng(bd + mono)
    pic, jpic = Picture(SPS()), JaxPicture(SPS())
    for p, jp in zip(pic.planes, jpic.planes):
        p[:] = jp[:] = rng.integers(0, 1 << bd, p.shape)
    for mode in ("bt601", "reference", {"matrix": 1, "full_range": False},
                 {"matrix": 9, "full_range": True},
                 {"matrix": 5, "full_range": False}):
        got = heif._yuv_pic_to_rgba(pic, SPS(), 77, 53, mode)
        monkeypatch.setenv("FFPIC_NO_NATIVE", "1")
        want = jax_heif._yuv_pic_to_rgba(jpic, SPS(), 77, 53, mode)
        monkeypatch.delenv("FFPIC_NO_NATIVE")
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["multislice", "tiles", "wpp", "dependent",
                                  "pcm", "scaling_custom"])
def test_multislice_tiles_wpp_items_match_jax(kind):
    enc, nalus = testing.hevc_stream(kind, 128, 128, seed=21)
    data = testing.heif_item(enc, nalus, 128, 128)
    got, want = _load_both(data)
    _same(got, want)
    if not kind.startswith("scaling"):
        np.testing.assert_array_equal(
            got.np_pixels(),
            heif._yuv_pic_to_rgba(enc.pic, enc.sps, 128, 128, "bt601"))


@pytest.mark.parametrize("switch", list(SWITCHES))
@pytest.mark.parametrize("case", CASES)
def test_heif_cases_under_the_switches_match_jax(case, switch, monkeypatch):
    """The small HEICs the card's run decodes, under every combination
    of the two switches: the reference's pixels (the device colour up to
    contraction).  The reference's device residuals give its host
    route's pixels on these streams (no scaling lists;
    ``test_torch_hevc.py`` holds the port's device residuals to JAX's on
    every stream kind), so the reference runs its host residuals here,
    which spares it a jit a TU-size bucket."""
    data = _heif_cases()[case]
    env = SWITCHES[switch]
    if "FFPIC_HEIF_DEVICE_COLOR" in env:
        monkeypatch.setenv("FFPIC_HEIF_DEVICE_COLOR", "1")
    want = ffpic_tpu.load(data)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = ft.load(data, device="cpu")
    assert (got.width, got.height) == (want.width, want.height)
    assert repr(got.meta) == repr(want.meta)
    if "FFPIC_HEIF_DEVICE_COLOR" in env:
        testing.assert_equal_up_to_contraction(
            lambda: ft.load(data, device="cpu").np_pixels(),
            want.np_pixels())
    else:
        np.testing.assert_array_equal(got.np_pixels(), want.np_pixels())


def _spy_residuals(monkeypatch) -> dict:
    """Counts the residual entries' calls (and the parts of each grid
    call) while they run as they would."""
    from ffpic_tpu_torch.ops import hevc_kernels as hk
    calls = {"grid": [], "packed": 0}
    grid, packed = hk.residuals_grid, hk.residuals_packed

    def spy_grid(parts, *a, **k):
        calls["grid"].append(len(parts))
        return grid(parts, *a, **k)

    def spy_packed(*a, **k):
        calls["packed"] += 1
        return packed(*a, **k)
    monkeypatch.setattr(hk, "residuals_grid", spy_grid)
    monkeypatch.setattr(hk, "residuals_packed", spy_packed)
    return calls


@pytest.mark.parametrize("colour", ["host", "device_color"])
def test_grid_under_hevc_device_is_one_residual_launch(colour, monkeypatch):
    """Under ``FFPIC_HEVC_DEVICE`` on the CPU a 3x2 grid HEIC decodes in
    three phases: the residual entry runs once for the grid, over its six
    tiles (no launch a tile), and the bytes are the host route's and the
    reference's (its device colour up to contraction)."""
    data = heif_enc.encode_heif(testing.heif_pic(150, 120, 3), qp=24,
                                tile=64)
    if colour == "device_color":
        monkeypatch.setenv("FFPIC_HEIF_DEVICE_COLOR", "1")
    host = ft.load(data, device="cpu").np_pixels()
    want = ffpic_tpu.load(data).np_pixels()
    calls = _spy_residuals(monkeypatch)
    monkeypatch.setenv("FFPIC_HEVC_DEVICE", "1")
    got = ft.load(data, device="cpu")
    assert got.meta["grid"]["rows"] * got.meta["grid"]["cols"] == 6
    assert calls == {"grid": [6], "packed": 0}
    np.testing.assert_array_equal(got.np_pixels(), host)
    if colour == "device_color":
        testing.assert_equal_up_to_contraction(
            lambda: ft.load(data, device="cpu").np_pixels(), want)
    else:
        np.testing.assert_array_equal(got.np_pixels(), want)


def test_fixture_under_hevc_device_is_one_residual_launch(monkeypatch):
    """The 12 MP fixture under ``FFPIC_HEVC_DEVICE`` on the CPU: one
    residual call over its 48 tiles, and the host route's bytes."""
    data = testing.heif_fixture()
    host = ft.load(data, device="cpu").np_pixels()
    calls = _spy_residuals(monkeypatch)
    monkeypatch.setenv("FFPIC_HEVC_DEVICE", "1")
    np.testing.assert_array_equal(ft.load(data, device="cpu").np_pixels(),
                                  host)
    assert calls == {"grid": [48], "packed": 0}


def test_grid_under_python_recon_keeps_one_pool(monkeypatch):
    """With ``FFPIC_NO_NATIVE_RECON`` beside ``FFPIC_HEVC_DEVICE`` no
    tile defers its residuals (``hevc.device_residuals``): the grid
    decodes in one pool pass (span ``heif.grid_tiles``, not the three
    phases), each tile's Python recon calling the residual entry itself,
    and gives the host route's bytes."""
    from ffpic_tpu_torch.utils import trace
    data = heif_enc.encode_heif(testing.heif_pic(150, 120, 3), qp=24,
                                tile=64)
    host = ft.load(data, device="cpu").np_pixels()
    calls = _spy_residuals(monkeypatch)
    monkeypatch.setenv("FFPIC_HEVC_DEVICE", "1")
    monkeypatch.setenv("FFPIC_NO_NATIVE_RECON", "1")
    trace.reset()
    trace.enable()
    try:
        got = ft.load(data, device="cpu").np_pixels()
        spans = trace.report()
    finally:
        trace.enable(False)
        trace.reset()
    assert "heif.grid_tiles" in spans
    assert not {"heif.grid_syntax", "hevc.residuals_part",
                "heif.grid_recon"} & spans.keys()
    assert calls["packed"] == 6 and calls["grid"] == [1] * 6
    np.testing.assert_array_equal(got, host)


def test_execute_ops_device_path_matches_host(monkeypatch):
    """``tests/test_hevc_kernels.py:48``: the Python recon route with
    the device residuals (``residuals_for_ops``) equals the host
    decode, and JAX's."""
    rng = np.random.default_rng(1234)
    arr = np.kron(rng.integers(0, 256, (16, 16, 3)),
                  np.ones((8, 8, 1))).astype(np.uint8)
    arr = np.dstack([arr, np.full(arr.shape[:2], 255, np.uint8)])
    blob = heif_enc.encode_heif(Pic(pixels=arr, width=128, height=128),
                                quality=55)
    host = ft.load(blob, device="cpu").np_pixels()
    monkeypatch.setenv("FFPIC_HEVC_DEVICE", "1")
    monkeypatch.setenv("FFPIC_NO_NATIVE_RECON", "1")
    dev = ft.load(blob, device="cpu").np_pixels()
    np.testing.assert_array_equal(host, dev)
    np.testing.assert_array_equal(dev, ffpic_tpu.load(blob).np_pixels())


def test_native_recon_with_device_residuals(monkeypatch):
    """``tests/test_hevc_kernels.py:73``: the native recon adding the
    device residuals (``residuals_packed``) equals the all-host decode."""
    rng = np.random.default_rng(99)
    arr = np.kron(rng.integers(0, 256, (8, 8, 3)),
                  np.ones((8, 8, 1))).astype(np.uint8)
    arr = np.dstack([arr, np.full(arr.shape[:2], 255, np.uint8)])
    blob = heif_enc.encode_heif(Pic(pixels=arr, width=64, height=64),
                                quality=60)
    host = ft.load(blob, device="cpu").np_pixels()
    monkeypatch.setenv("FFPIC_HEVC_DEVICE", "1")
    np.testing.assert_array_equal(host,
                                  ft.load(blob, device="cpu").np_pixels())


def test_fixture_is_the_jax_benchs_file():
    """The committed fixture is what ``make_heif_fixtures --seed 0``
    writes (its recorded sha256), made from the JAX bench's content:
    ``synth_rgb`` is ``tools/make_corpus.py``'s, and the grid is
    4032x3024 in 48 tiles of 512 at QP 26, CTB 32, 8-bit."""
    data = testing.heif_fixture()
    assert len(data) == 2613899
    assert hashlib.sha256(data).hexdigest() == make_heif_fixtures.SHA256
    pytest.importorskip("PIL")
    import sys
    sys.path.insert(0, str(__import__("pathlib").Path(__file__)
                           .resolve().parent.parent / "tools"))
    import make_corpus
    np.testing.assert_array_equal(make_heif_fixtures.synth_rgb(48, 64, 11),
                                  make_corpus.synth_rgb(48, 64, seed=11))
    pic = ft.load(data, skip_decode=True)
    assert pic.meta["grid"] == dict(rows=6, cols=8, width=4032, height=3024)
    assert pic.meta["hevc"]["bit_depth"] == 8 and pic.meta["hevc"]["ctb"] == 32
    s = heif.parse_structure(data)
    tile = s["items"][2]["properties"]["hvcC"]["nalus"]
    from ffpic_tpu_torch.formats import hevc
    assert hevc.parse_pps(tile["pps"][0]).init_qp == 26


def test_fixture_decodes_as_jax_does():
    """The default route over all 48 tiles: the reference's bytes."""
    data = testing.heif_fixture()
    got, want = _load_both(data)
    _same(got, want)
    assert got.np_pixels().shape == (3024, 4032, 4)


def test_fixture_tile_tus_through_the_device_route_match_jax():
    """``testing.heif_tile_tus`` (the TU list the card's run holds K14 to)
    of a fixture tile through the port's route and the reference's."""
    from ffpic_tpu_torch.ops import hevc_kernels as hk
    from ffpic_tpu.ops import hevc_kernels as jax_hk
    data = testing.heif_fixture()
    tu, lv, bd = testing.heif_tile_tus(data, 25)
    assert len(tu) > 1000 and lv.size == int((tu[:, 2].astype(int) ** 2)
                                              .sum())
    np.testing.assert_array_equal(hk.residuals_packed(tu, lv, bd, "cpu"),
                                  jax_hk.residuals_packed(tu, lv, bd))
    np.testing.assert_array_equal(testing.residuals_by_plan(tu, lv, bd),
                                  hk.residuals_packed(tu, lv, bd, "cpu"))


@pytest.mark.parametrize("tile", [2, 49])
def test_fixture_tiles_under_hevc_device_match_jax(tile, monkeypatch):
    """``FFPIC_HEVC_DEVICE`` on two fixture tiles through
    ``_decode_item_yuv`` (the reference's Python loop over every TU of
    all 48 tiles is too slow here)."""
    data = testing.heif_fixture()
    s = heif.parse_structure(data)
    host, _sps, _p = heif._decode_item_yuv(data, s, tile, "cpu")
    monkeypatch.setenv("FFPIC_HEVC_DEVICE", "1")
    got, _sps, _p = heif._decode_item_yuv(data, s, tile, "cpu")
    want, _sps, _p = jax_heif._decode_item_yuv(data, jax_heif
                                               .parse_structure(data), tile)
    for a, b, c in zip(got.planes, want.planes, host.planes):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_scaling_lists_under_hevc_device_mirror_jax(monkeypatch):
    """Recorded reference fault (ROADMAP Queue 3): a scaling-list item
    decodes differently under FFPIC_HEVC_DEVICE than on the host route;
    the port gives the reference's pixels on both."""
    enc, nalus = testing.hevc_stream("scaling_default", 64, 64)
    data = testing.heif_item(enc, nalus, 64, 64)
    host = ft.load(data, device="cpu").np_pixels()
    monkeypatch.setenv("FFPIC_HEVC_DEVICE", "1")
    got, want = _load_both(data)
    np.testing.assert_array_equal(got.np_pixels(), want.np_pixels())
    assert (got.np_pixels() != host).any()


def test_10bit_under_device_colour_mirrors_jax(monkeypatch):
    """Recorded reference fault (ROADMAP Queue 3): the device colour
    takes 10-bit samples as 8-bit ones (the host scales by 255/1023), in
    both packages."""
    data = _heif_cases()["10bit"]
    host = ft.load(data, device="cpu").np_pixels()
    monkeypatch.setenv("FFPIC_HEIF_DEVICE_COLOR", "1")
    want = ffpic_tpu.load(data).np_pixels()
    got = ft.load(data, device="cpu").np_pixels()
    testing.assert_equal_up_to_contraction(
        lambda: ft.load(data, device="cpu").np_pixels(), want)
    assert np.abs(got.astype(int) - host.astype(int)).max() > 100


@pytest.mark.parametrize("kind", ["grid", "single"])
def test_device_colour_is_one_call_a_picture(kind, monkeypatch):
    """Under ``FFPIC_HEIF_DEVICE_COLOR`` a picture's colour is one call of
    the K15 entry over every tile, a 3x2 grid's six or a single item's
    one, and it gives the bytes the reference's device colour gives (up
    to contraction)."""
    from ffpic_tpu_torch.ops import hevc_kernels as hk
    data = heif_enc.encode_heif(testing.heif_pic(150, 120, 3), qp=24,
                                tile=64 if kind == "grid" else None)
    monkeypatch.setenv("FFPIC_HEIF_DEVICE_COLOR", "1")
    want = ffpic_tpu.load(data).np_pixels()
    calls = []
    entry = hk.hevc_tiles_to_rgba
    monkeypatch.setattr(hk, "hevc_tiles_to_rgba",
                        lambda st, mode: calls.append(len(st.tiles))
                        or entry(st, mode))
    testing.assert_equal_up_to_contraction(
        lambda: ft.load(data, device="cpu").np_pixels(), want)
    calls.clear()
    ft.load(data, device="cpu")
    assert calls == [6 if kind == "grid" else 1]
