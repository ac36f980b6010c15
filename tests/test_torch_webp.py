"""The WebP codec of ffpic_tpu_torch (CPU, plain versions) held against
ffpic_tpu's on the same bytes, exactly: the boolean decoder, the VP8
tables, the logger registry; ``VP8Decoder``'s parse state, residuals and
planes on files PIL (libwebp) writes, after the recipes of
``tests/test_webp.py`` (flat, noise, gradient, odd size with alpha,
photo-like, a quality sweep); the VP8L decoder and the ALPH stream with
each of its filters; ``load`` (pixels, ``meta``, ``info()``, animation
frames) of every committed fixture under the four combinations of
``FFPIC_VP8_DEVICE`` and ``FFPIC_VP8_DEVICE_COLOR`` (and where PIL has
WebP, against libwebp); ``encode``'s bytes, lossless and animated; a
header-only load without CUDA; and ``decode_batch`` mixing JPEG, PNG and
WebP members.  Every stage is integer, so the tolerance is zero.
"""

import functools
import io
import logging
import struct

import numpy as np
import pytest
import torch

import ffpic_tpu
import ffpic_tpu_torch
from ffpic_tpu import native as jax_native
from ffpic_tpu.coding.booldec import BoolDecoder as JaxBoolDecoder
from ffpic_tpu.formats import vp8 as jax_vp8
from ffpic_tpu.formats import vp8_tables as jax_tables
from ffpic_tpu.formats import vp8l as jax_vp8l
from ffpic_tpu.formats import webp as jax_webp
from ffpic_tpu.formats.pic import Pic as JaxPic
from ffpic_tpu.ops import vp8_kernels as jax_vk
from ffpic_tpu.utils import vlog as jax_vlog
from ffpic_tpu_torch import native, testing
from ffpic_tpu_torch.coding.booldec import BoolDecoder
from ffpic_tpu_torch.formats import vp8, vp8_tables, vp8l, webp
from ffpic_tpu_torch.formats.pic import Pic
from ffpic_tpu_torch.ops import vp8_kernels as vk
from ffpic_tpu_torch.utils import vlog
import reference_native  # noqa: F401  (readies ffpic_tpu first)

FIXTURE_SIZES = {"lossy_1080p.webp": (1920, 1080),
                 "lossy_512.webp": (512, 512),
                 "alpha_1080p.webp": (1920, 1080),
                 "odd_333x199.webp": (333, 199),
                 "lossless_160x120.webp": (160, 120),
                 "animated_96x64.webp": (96, 64)}
FIXTURES = list(FIXTURE_SIZES)
SWITCHES = {"host": {}, "vp8_device": {"FFPIC_VP8_DEVICE": "1"},
            "device_color": {"FFPIC_VP8_DEVICE_COLOR": "1"},
            "both": {"FFPIC_VP8_DEVICE": "1", "FFPIC_VP8_DEVICE_COLOR": "1"}}


@pytest.fixture(autouse=True)
def _native_first(monkeypatch):
    jax_native.available()
    for k in ("FFPIC_VP8_DEVICE", "FFPIC_VP8_DEVICE_COLOR",
              "FFPIC_HOST_COLOR"):
        monkeypatch.delenv(k, raising=False)


def _pil():
    """PIL with WebP support, or a skip."""
    pil = pytest.importorskip("PIL.Image")
    from PIL import features
    if not features.check("webp"):
        pytest.skip("PIL has no WebP support")
    return pil


def _lossy(arr, q=75, **kw) -> bytes:
    buf = io.BytesIO()
    _pil().fromarray(arr).save(buf, "WEBP", lossless=False, quality=q,
                               method=4, **kw)
    return buf.getvalue()


def _lossless(arr, **kw) -> bytes:
    buf = io.BytesIO()
    _pil().fromarray(arr).save(buf, "WEBP", lossless=True, **kw)
    return buf.getvalue()


def _chunks(data: bytes) -> dict:
    pos, out = 12, {}
    while pos + 8 <= len(data):
        tag = data[pos:pos + 4].decode("latin1")
        size = struct.unpack_from("<I", data, pos + 4)[0]
        out[tag] = data[pos + 8:pos + 8 + size]
        pos += 8 + size + (size & 1)
    return out


@functools.lru_cache(maxsize=None)
def _recipe(name: str) -> bytes:
    """The files of ``tests/test_webp.py``'s recipes, made by PIL."""
    rng = np.random.default_rng(1234)
    if name == "flat":
        return _lossy(np.full((32, 32, 3), 137, np.uint8))
    if name == "noise":
        return _lossy(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
    if name == "gradient":
        yy, xx = np.mgrid[0:48, 0:64]
        return _lossy(np.stack([(xx * 4) % 256, (yy * 5) % 256,
                                ((xx + yy) * 3) % 256], -1).astype(np.uint8))
    if name.startswith("alpha_odd_q"):
        return _lossy(rng.integers(0, 256, (37, 53, 4), dtype=np.uint8),
                      q=int(name[11:]))
    if name == "photo":
        yy, xx = np.mgrid[0:96, 0:112].astype(np.float32)
        arr = np.stack([128 + 100 * np.sin(xx / 17.0) * np.cos(yy / 13.0),
                        128 + 80 * np.cos(xx / 7.0 + yy / 21.0),
                        128 + 110 * np.sin((xx + yy) / 23.0)], axis=-1)
        arr = np.clip(arr + rng.normal(0, 8, arr.shape), 0, 255)
        return _lossy(arr.astype(np.uint8), q=60)
    if name.startswith("photo_q"):
        return _lossy(testing.synth_rgb(40, 72, 3), q=int(name[7:]))
    if name == "odd_30x20":
        return _lossy(rng.integers(0, 256, (30, 20, 3), dtype=np.uint8))
    raise KeyError(name)


RECIPES = ["flat", "noise", "gradient", "alpha_odd_q20", "alpha_odd_q92",
           "photo", "odd_30x20", "photo_q0", "photo_q5", "photo_q30",
           "photo_q90", "photo_q100"]


# --- boolean decoder, tables, logger -----------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_booldec_matches_jax(seed):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, 300).astype(np.uint8).tobytes()
    ours, theirs = BoolDecoder(data), JaxBoolDecoder(data)
    tree = jax_tables.KF_YMODE_TREE
    for step in range(400):
        kind = step % 5
        if kind == 0:
            p = int(rng.integers(0, 256))
            assert ours.get_bool(p) == theirs.get_bool(p)
        elif kind == 1:
            n = int(rng.integers(1, 9))
            assert ours.get_literal(n) == theirs.get_literal(n)
        elif kind == 2:
            assert ours.get_signed(6) == theirs.get_signed(6)
        elif kind == 3:
            assert ours.maybe_get_signed(4) == theirs.maybe_get_signed(4)
        else:
            assert ours.get_tree(tree, jax_tables.KF_YMODE_PROBS) == \
                theirs.get_tree(tree, jax_tables.KF_YMODE_PROBS)
        assert (ours.pos, ours.value, ours.range, ours.bit_count) == \
            (theirs.pos, theirs.value, theirs.range, theirs.bit_count)


def test_booldec_reads_zeros_past_the_end():
    ours, theirs = BoolDecoder(b"\x81"), JaxBoolDecoder(b"\x81")
    assert [ours.get_bit() for _ in range(40)] == \
        [theirs.get_bit() for _ in range(40)]


def test_vp8_tables_match_jax():
    names = [n for n in dir(jax_tables) if n.isupper()]
    assert len(names) > 10
    for n in names:
        ours, theirs = getattr(vp8_tables, n), getattr(jax_tables, n)
        if isinstance(theirs, np.ndarray):
            np.testing.assert_array_equal(ours, theirs, err_msg=n)
            assert ours.dtype == theirs.dtype
        else:
            assert ours == theirs, n


def test_vlog_matches_jax(monkeypatch):
    monkeypatch.setenv("FFPIC_LOG", "warn,vp8test:debug")
    for name in ("vp8test", "webptest"):
        monkeypatch.delitem(vlog._registry, name, raising=False)
        monkeypatch.delitem(jax_vlog._registry, name, raising=False)
        assert vlog._parse_env() == jax_vlog._parse_env()
        ours = vlog.get_logger(name)
        assert ours.name == f"ffpic.{name}"
        assert ours.level == jax_vlog.get_logger(name).level
    assert vlog.get_logger("vp8test").level == logging.DEBUG
    vlog.set_level("webptest", "error")
    assert vlog.get_logger("webptest").level == logging.ERROR


# --- VP8Decoder ------------------------------------------------------------

def _parsed(mod, data: bytes, **kw):
    d = mod.VP8Decoder(_chunks(data)["VP8 "], **kw)
    d._parse_control_partition()
    d._dequant_tables()
    d._parse_mb_headers()
    d._parse_tokens()
    return d


@pytest.mark.parametrize("name", RECIPES)
def test_vp8_decoder_matches_jax(name):
    """Parse state, residuals (native, and the FFPIC_VP8_DEVICE route's
    plain version on the parse state) and the loop-filtered planes."""
    data = _recipe(name)
    ours = _parsed(vp8, data, device="cpu")
    theirs = _parsed(jax_vp8, data)
    assert vars(ours.hdr) == vars(theirs.hdr)
    assert ours.dq == theirs.dq
    for attr in ("coeff_probs", "seg", "skip", "ymode", "uvmode", "bmodes",
                 "levels", "nnz_total", "has_y2", "mb_has_coeffs"):
        np.testing.assert_array_equal(getattr(ours, attr),
                                      getattr(theirs, attr), err_msg=attr)
    ours._residuals()
    theirs._residuals()
    np.testing.assert_array_equal(ours.residual, theirs.residual)
    seg = (ours.seg if ours.hdr.seg_enabled
           else np.zeros((ours.mbh, ours.mbw), np.int32))
    dq_mb = np.array(ours.dq, np.int32)[seg]
    plain = vk.vp8_residuals_plain(torch.from_numpy(ours.levels),
                                   torch.from_numpy(dq_mb),
                                   torch.from_numpy(ours.has_y2))
    np.testing.assert_array_equal(plain.numpy(), theirs.residual)
    np.testing.assert_array_equal(
        plain.numpy(), np.asarray(jax_vk.vp8_residuals(ours.levels, dq_mb,
                                                      ours.has_y2)))
    for y, t in zip(vp8.VP8Decoder(_chunks(data)["VP8 "]).decode(),
                    jax_vp8.VP8Decoder(_chunks(data)["VP8 "]).decode()):
        np.testing.assert_array_equal(y, t)


def test_recipes_cover_segments_and_bpred():
    ds = [_parsed(vp8, _recipe(n), device="cpu") for n in RECIPES]
    assert any(d.hdr.seg_enabled for d in ds)
    assert any((d.ymode == vp8.B_PRED).any() for d in ds)
    assert any((d.ymode != vp8.B_PRED).any() for d in ds)
    assert any(d.hdr.width % 16 for d in ds)


@pytest.mark.parametrize("name", ["photo", "alpha_odd_q92"])
def test_vp8_device_route_on_the_cpu(name, monkeypatch):
    """FFPIC_VP8_DEVICE on a CPU decoder runs the plain
    vp8_residuals_plain, then the native reconstruction: the planes of
    the fused host route."""
    data = _chunks(_recipe(name))["VP8 "]
    want = vp8.VP8Decoder(data).decode()
    monkeypatch.setenv("FFPIC_VP8_DEVICE", "1")
    calls = []
    plain = vk.vp8_residuals_plain
    monkeypatch.setattr(vk, "vp8_residuals_plain",
                        lambda *a: calls.append(a) or plain(*a))
    got = vp8.VP8Decoder(data, device="cpu").decode()
    assert len(calls) == 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_vp8_device_route_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("FFPIC_VP8_DEVICE", "1")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        vp8.VP8Decoder(_chunks(_recipe("flat"))["VP8 "]).decode()


def test_native_vp8_wrappers_refuse_bad_planes():
    d = _parsed(vp8, _recipe("flat"), device="cpu")
    d._residuals()
    Y = np.zeros((32, 32), np.uint8)
    U = np.zeros((16, 16), np.uint8)
    with pytest.raises(ValueError, match="residual"):
        native.vp8_recon(Y, U, U.copy(), d.residual[:, :1], d.ymode,
                         d.bmodes, d.uvmode, d.mbh, d.mbw)
    with pytest.raises(ValueError, match="uint8"):
        native.vp8_recon(Y.astype(np.int16), U, U.copy(), d.residual,
                         d.ymode, d.bmodes, d.uvmode, d.mbh, d.mbw)
    with pytest.raises(ValueError, match="cannot hold"):
        native.vp8_color_libwebp(Y, U, U, 40, 32)
    with pytest.raises(ValueError, match="alpha"):
        native.vp8_color_libwebp(Y, U, U, 32, 32, np.zeros((3, 3), np.uint8))


# --- VP8L and alpha ---------------------------------------------------------

def _vp8l_cases():
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:120, 0:160].astype(np.float32)
    photo = np.stack([128 + 90 * np.sin(xx / 19) * np.cos(yy / 13),
                      128 + 70 * np.cos(xx / 9 + yy / 23),
                      128 + 100 * np.sin((xx + yy) / 29)], axis=-1)
    photo = np.clip(photo + rng.normal(0, 6, photo.shape), 0, 255)
    idx = rng.integers(0, 14, (25, 37)) * 18
    return {
        "rgb": (rng.integers(0, 256, (20, 30, 3), dtype=np.uint8), {}),
        "rgba": (rng.integers(0, 256, (33, 47, 4), dtype=np.uint8),
                 dict(exact=True)),
        "palette2": ((np.stack([rng.integers(0, 2, (25, 37)) * 255] * 3,
                               -1)).astype(np.uint8), {}),
        "palette14": (np.stack([idx, 255 - idx, idx // 2],
                               -1).astype(np.uint8), {}),
        "photo_m6": (photo.astype(np.uint8), dict(method=6, quality=100)),
    }


@pytest.mark.parametrize("name", sorted(_vp8l_cases()))
def test_vp8l_decode_matches_jax(name):
    arr, kw = _vp8l_cases()[name]
    payload = _chunks(_lossless(arr, **kw))["VP8L"]
    got = vp8l.decode_vp8l(payload)
    np.testing.assert_array_equal(got, jax_vp8l.decode_vp8l(payload))
    np.testing.assert_array_equal(got[..., :arr.shape[-1]], arr)


@pytest.mark.parametrize("name", ["alpha_1080p.webp", "animated_96x64.webp"])
def test_alpha_stream_matches_jax(name):
    data = testing.webp_fixture(name)
    k = data.index(b"ALPH")
    alph = data[k + 8:k + 8 + struct.unpack_from("<I", data, k + 4)[0]]
    assert alph[0] & 3 == 1            # VP8L-compressed
    if name == "alpha_1080p.webp":
        h, w = 1080, 1920
    else:                              # the first frame's own size
        h, w = (int.from_bytes(data[k - 16 + s:k - 16 + s + 3], "little") + 1
                for s in (9, 6))
    np.testing.assert_array_equal(
        vp8l.decode_alpha_stream(alph[1:], w, h),
        jax_vp8l.decode_alpha_stream(alph[1:], w, h))


@pytest.mark.parametrize("filt", [0, 1, 2, 3])
@pytest.mark.parametrize("method", [0, 1])
def test_decode_alpha_filters_match_jax(filt, method):
    """Each ALPH filter (none, horizontal, vertical, gradient), raw or
    VP8L-compressed, as the reference undoes it."""
    rng = np.random.default_rng(10 * filt + method)
    h, w = 13, 21
    plane = rng.integers(0, 256, (h, w), dtype=np.uint8)
    if method == 0:
        payload = plane.tobytes()
    else:
        # a VP8L stream whose green channel carries the plane
        rgba = np.stack([plane * 0, plane, plane * 0,
                         np.full_like(plane, 255)], -1)
        payload = _chunks(_lossless(rgba, exact=True))["VP8L"][5:]
    alph = bytes([method | (filt << 2)]) + payload
    got = webp._decode_alpha(alph, h, w)
    want = jax_webp._decode_alpha(alph, h, w)
    np.testing.assert_array_equal(got, want)
    if filt == 0:
        np.testing.assert_array_equal(got, plane)


# --- load, info, encode -----------------------------------------------------

def _same_pic(got, want):
    assert isinstance(got, Pic) and isinstance(got.pixels, torch.Tensor)
    assert got.pixels.device.type == "cpu"
    assert (got.width, got.height, got.depth, got.pitch, got.format,
            got.codec, got.delay_ms) == (
        want.width, want.height, want.depth, want.pitch, want.format,
        want.codec, want.delay_ms)
    assert got.meta == want.meta
    np.testing.assert_array_equal(got.np_pixels(), want.np_pixels())


@pytest.mark.parametrize("switch", sorted(SWITCHES))
@pytest.mark.parametrize("name", FIXTURES)
def test_load_fixtures_match_jax(name, switch, monkeypatch):
    for k, v in SWITCHES[switch].items():
        monkeypatch.setenv(k, v)
    data = testing.webp_fixture(name)
    got = ffpic_tpu_torch.load_all(data, device="cpu")
    want = ffpic_tpu.load_all(data)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same_pic(g, w)
    assert ffpic_tpu_torch.info(got[0]) == ffpic_tpu.info(want[0])
    assert len(got[0].frames) == len(want[0].frames)


def _as_the_reference_unfilters(alpha: np.ndarray, filt: int) -> np.ndarray:
    """libwebp's alpha plane as the reference's ``_decode_alpha`` gives
    it for the same ALPH stream: the horizontal filter leaves each
    row's first residual as it is where libwebp predicts it from the
    pixel above, and the vertical filter leaves the first row's
    residuals as they are where libwebp predicts them from the left
    (libwebp's ``HorizontalUnfilter``/``VerticalUnfilter``)."""
    a = alpha.astype(np.int64)
    if filt == 1:
        first = np.diff(a[:, 0], prepend=0)          # the coded residuals
        return ((a - a[:, :1] + first[:, None]) & 255).astype(np.uint8)
    if filt == 2:
        first = np.diff(a[0], prepend=0)
        return ((a - a[:1] + first[None]) & 255).astype(np.uint8)
    return alpha


@pytest.mark.parametrize("name", FIXTURES)
def test_load_fixtures_match_libwebp(name):
    """Exact, but for the alpha of a still whose ALPH uses the horizontal
    or vertical filter: there both packages keep the reference's rule
    for the first column or row (ROADMAP Queue 3), which the test
    applies to libwebp's plane."""
    pil = _pil()
    data = testing.webp_fixture(name)
    im = pil.open(io.BytesIO(data))
    got = ffpic_tpu_torch.load(data, device="cpu")
    frames = [got, *got.frames]
    assert len(frames) == getattr(im, "n_frames", 1)
    alph = _chunks(data).get("ALPH", b"\0")
    for i, f in enumerate(frames):
        im.seek(i)
        want = np.array(im.convert("RGBA"))
        want[..., 3] = _as_the_reference_unfilters(want[..., 3],
                                                   alph[0] >> 2 & 3)
        np.testing.assert_array_equal(f.np_pixels(), want,
                                      err_msg=f"frame {i}")


def test_reference_alpha_rule_differs_from_libwebp():
    """The vertically filtered fixture does show the reference's rule:
    its alpha differs from libwebp's in every row."""
    pil = _pil()
    data = testing.webp_fixture("alpha_1080p.webp")
    lib = np.array(pil.open(io.BytesIO(data)).convert("RGBA"))[..., 3]
    ours = ffpic_tpu_torch.load(data, device="cpu").np_pixels()[..., 3]
    assert (ours != lib).any(axis=1).mean() > 0.9
    np.testing.assert_array_equal(ours[0], np.diff(
        lib[0].astype(np.int64), prepend=0).astype(np.uint8))


def test_fixtures_are_what_they_say():
    """The committed files hold the chunks, sizes and filters the card's
    checks rely on."""
    total = 0
    for name, wh in FIXTURE_SIZES.items():
        data = testing.webp_fixture(name)
        total += len(data)
        pic = ffpic_tpu_torch.load(data, skip_decode=True)
        assert (pic.width, pic.height) == wh
    assert total < 2 ** 20
    c = _chunks(testing.webp_fixture("alpha_1080p.webp"))
    assert set(c) == {"VP8X", "ALPH", "VP8 "} and c["ALPH"][0] >> 2 & 3 == 2
    assert "VP8L" in _chunks(testing.webp_fixture("lossless_160x120.webp"))
    pic = ffpic_tpu_torch.load(testing.webp_fixture("animated_96x64.webp"),
                               device="cpu")
    assert pic.n_frames == 3 and pic.meta["format"] == "animation"


@pytest.mark.parametrize("host_color", [False, True])
@pytest.mark.parametrize("name", ["alpha_odd_q20", "photo", "odd_30x20"])
def test_load_colour_routes_match_jax(name, host_color, monkeypatch):
    """FFPIC_HOST_COLOR (the numpy libwebp colour) and mode="reference"
    keep their meaning."""
    if host_color:
        monkeypatch.setenv("FFPIC_HOST_COLOR", "1")
    data = _recipe(name)
    _same_pic(ffpic_tpu_torch.load(data, device="cpu"), ffpic_tpu.load(data))
    got = webp.load(data, device=torch.device("cpu"), mode="reference")[0]
    want = jax_webp.load(data, mode="reference")[0]
    np.testing.assert_array_equal(got.np_pixels(), want.np_pixels())


def test_skip_decode_needs_no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in FIXTURES:
        data = testing.webp_fixture(name)
        got = ffpic_tpu_torch.load(data, skip_decode=True)
        want = ffpic_tpu.load(data, skip_decode=True)
        assert got.pixels is None
        assert (got.width, got.height, got.meta) == (want.width, want.height,
                                                     want.meta)
        assert ffpic_tpu_torch.info(got) == ffpic_tpu.info(want)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ffpic_tpu_torch.load(testing.webp_fixture("odd_333x199.webp"))


def test_info_strings_match_jax():
    for data in (testing.webp_fixture("lossy_512.webp"),
                 testing.webp_fixture("lossless_160x120.webp"),
                 _recipe("alpha_odd_q20")):
        got = ffpic_tpu_torch.info(ffpic_tpu_torch.load(data, device="cpu"))
        assert got == ffpic_tpu.info(ffpic_tpu.load(data))
        assert got.startswith("WEBP file format")


def test_truncated_file_raises_value_error():
    data = testing.webp_fixture("lossy_512.webp")
    for cut in (data[:40], data[:-100], data[:30] + bytes(20)):
        with pytest.raises(ValueError):
            ffpic_tpu_torch.load(cut, device="cpu")


@pytest.mark.parametrize("name", ["flat", "noise", "photo"])
def test_encode_matches_jax(name):
    data = _recipe(name)
    pic = ffpic_tpu_torch.load(data, device="cpu")
    got = ffpic_tpu_torch.encode(pic, "WEBP", device="cpu")
    assert got == ffpic_tpu.encode(ffpic_tpu.load(data), "WEBP")
    np.testing.assert_array_equal(
        ffpic_tpu_torch.load(got, device="cpu").np_pixels(), pic.np_pixels())


def test_encode_animation_matches_jax():
    rng = np.random.default_rng(5)
    frames = []
    for i in range(3):
        f = np.kron(rng.integers(0, 256, (8, 8, 4)),
                    np.ones((8, 8, 1))).astype(np.uint8)
        f[..., 3] = np.where(f[..., 3] > 100, 255, f[..., 3])
        frames.append(f)

    def pics(cls):
        ps = [cls(pixels=f, width=64, height=64, depth=32, pitch=256,
                  codec="X", delay_ms=40 + 10 * i)
              for i, f in enumerate(frames)]
        ps[0].frames = ps[1:]
        return ps[0]

    got = ffpic_tpu_torch.encode(pics(Pic), "WEBP", device="cpu", loops=3)
    assert got == ffpic_tpu.encode(pics(JaxPic), "WEBP", loops=3)
    back = ffpic_tpu_torch.load(got, device="cpu")
    assert [back.delay_ms] + [f.delay_ms for f in back.frames] == [40, 50, 60]
    assert back.meta["loop"] == 3
    for f, want in zip([back, *back.frames], frames):
        np.testing.assert_array_equal(f.np_pixels(), want)
    # the animated fixture round-trips through the encoder too
    anim = ffpic_tpu_torch.load(testing.webp_fixture("animated_96x64.webp"),
                                device="cpu")
    assert ffpic_tpu_torch.encode(anim, "WEBP", device="cpu") == \
        ffpic_tpu.encode(ffpic_tpu.load(testing.webp_fixture(
            "animated_96x64.webp")), "WEBP")


def test_encode_animation_size_mismatch():
    p0 = Pic(pixels=np.zeros((32, 32, 4), np.uint8), width=32, height=32)
    p0.frames = [Pic(pixels=np.zeros((16, 16, 4), np.uint8), width=16,
                     height=16)]
    with pytest.raises(ValueError, match="canvas"):
        ffpic_tpu_torch.encode(p0, "WEBP", device="cpu")


def test_webp_is_registered_after_png():
    codec = ffpic_tpu_torch.find_codec("webp")
    assert codec.load.__module__ == "ffpic_tpu_torch.formats.webp"
    assert ffpic_tpu_torch.probe(testing.webp_fixture("lossy_512.webp")) \
        is codec
    names = ffpic_tpu_torch.registered_codecs()
    assert names.index("PNG") < names.index("WEBP") < names.index("HEIF")
    assert sorted(names) == sorted(ffpic_tpu.registered_codecs())


# --- decode_batch -----------------------------------------------------------

@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_decode_batch_mixes_jpeg_png_webp(switch, monkeypatch):
    """JPEG (4:2:0, through the batch's route), PNG and WebP members
    (lossy, with alpha, lossless) in one batch, against
    ffpic_tpu.decode_batch; the JPEG colour up to XLA's choice of FMA
    contraction."""
    for k, v in SWITCHES[switch].items():
        monkeypatch.setenv(k, v)
    ffpic_tpu.registered_codecs()
    h, w = 40, 72
    rgb = testing.synth_rgb(h, w, 3)
    rng = np.random.default_rng(4)
    rgba = np.dstack([rgb, rng.integers(0, 256, (h, w), dtype=np.uint8)])
    srcs = [testing.synth_jpeg_420(h, w, 80, 1), _lossy(rgb, q=70),
            testing.encode_png(rgba, filters=(1, 2)), _lossy(rgba, q=40),
            _lossless(rgba), testing.synth_jpeg_420(h, w, 60, 2)]
    got = ffpic_tpu_torch.decode_batch(srcs, device="cpu")
    assert tuple(got.shape) == (6, h, w, 4) and got.dtype == torch.uint8
    want = np.asarray(ffpic_tpu.decode_batch(srcs))
    np.testing.assert_array_equal(got[1:5].numpy(), want[1:5])
    testing.assert_equal_up_to_contraction(
        lambda: ffpic_tpu_torch.decode_batch([srcs[0], srcs[5]],
                                             device="cpu"),
        want[[0, 5]])


def test_decode_batch_webp_members_alone():
    srcs = [testing.webp_fixture("lossy_512.webp")] * 2
    got = ffpic_tpu_torch.decode_batch(srcs, size=(64, 64), device="cpu")
    assert tuple(got.shape) == (2, 64, 64, 4)
    one = ffpic_tpu_torch.load(srcs[0], device="cpu").pixels
    assert torch.equal(ffpic_tpu_torch.decode_batch(srcs[:1], device="cpu")[0],
                       one)
    anim = testing.webp_fixture("animated_96x64.webp")
    first = ffpic_tpu_torch.load(anim, device="cpu").pixels
    assert torch.equal(ffpic_tpu_torch.decode_batch([anim], device="cpu")[0],
                       first)


def test_decode_batch_corrupt_webp_raises_value_error():
    bad = testing.webp_fixture("lossy_512.webp")[:60]
    with pytest.raises(ValueError):
        ffpic_tpu_torch.decode_batch([bad], device="cpu")


def _count_batch_calls(monkeypatch) -> list:
    """Record each call of the pipeline's K13 batch entry: (frames, the
    output it returned)."""
    from ffpic_tpu_torch import pipeline
    calls = []
    entry = pipeline.vp8_yuv_to_rgba_batch

    def counted(frames, out=None):
        got = entry(frames, out)
        calls.append((len(frames), got))
        return got
    monkeypatch.setattr(pipeline, "vp8_yuv_to_rgba_batch", counted)
    return calls


@pytest.mark.parametrize("members", ["fixtures", "alpha_recipes"])
def test_decode_batch_webp_stills_one_launch(members, monkeypatch):
    """Under FFPIC_VP8_DEVICE_COLOR a batch of WebP stills goes through
    one staging and one K13 call, whose (N, H, W, 4) output is the batch
    itself (no stack), in input order; equal to ffpic_tpu.decode_batch
    and to the port's host route."""
    if members == "fixtures":
        srcs = [testing.webp_fixture("lossy_512.webp")] * 2
    else:
        srcs = [_recipe("alpha_odd_q20"), _recipe("alpha_odd_q92"),
                _recipe("alpha_odd_q20")]
    host = ffpic_tpu_torch.decode_batch(srcs, device="cpu")
    monkeypatch.setenv("FFPIC_VP8_DEVICE_COLOR", "1")
    calls = _count_batch_calls(monkeypatch)
    got = ffpic_tpu_torch.decode_batch(srcs, device="cpu")
    assert [n for n, _ in calls] == [len(srcs)] and got is calls[0][1]
    assert torch.equal(got, host)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ffpic_tpu.decode_batch(srcs)))


def test_decode_batch_mixed_webps_share_one_launch(monkeypatch):
    """A JPEG + PNG + lossy WebP (with and without alpha) + lossless WebP
    batch: the two lossy stills in one K13 call; every member equal to
    ffpic_tpu.decode_batch's; with ``size`` the stills of two sizes
    come out a tensor each and resize as the host route's do."""
    monkeypatch.setenv("FFPIC_VP8_DEVICE_COLOR", "1")
    ffpic_tpu.registered_codecs()
    h, w = 37, 53
    rng = np.random.default_rng(7)
    rgb = testing.synth_rgb(h, w, 3)
    rgba = np.dstack([rgb, rng.integers(0, 256, (h, w), dtype=np.uint8)])
    srcs = [testing.encode_png(rgba, filters=(1, 2)), _lossy(rgb, q=70),
            _lossless(rgba), _recipe("alpha_odd_q20")]
    calls = _count_batch_calls(monkeypatch)
    got = ffpic_tpu_torch.decode_batch(srcs, device="cpu")
    assert [n for n, _ in calls] == [2]
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ffpic_tpu.decode_batch(srcs)))
    calls.clear()
    sized = [testing.webp_fixture("odd_333x199.webp"), srcs[1],
             testing.synth_jpeg_420(48, 64, 80, 1), srcs[3]]
    got = ffpic_tpu_torch.decode_batch(sized, size=(32, 48), device="cpu")
    assert len(calls) == 1 and calls[0][0] == 3
    assert isinstance(calls[0][1], list)
    monkeypatch.delenv("FFPIC_VP8_DEVICE_COLOR")
    assert torch.equal(got, ffpic_tpu_torch.decode_batch(
        sized, size=(32, 48), device="cpu"))
