"""The public API of ffpic_tpu_torch (``load``, ``load_all``, ``probe``,
``info``, ``encode``, ``find_codec``, ``registered_codecs``, ``Pic``)
held against ffpic_tpu's on the same bytes, on the CPU: pixels, size,
format, ``meta`` and ``info()`` of every corpus JPEG, the decode options
(``quirks``, ``mode``, ``upsample``, ``order``), restart intervals,
EXIF, multi-picture files, ``skip_decode`` and the ``ValueError`` of a
corrupt file; and the encoder's bytes.
"""

import io
import pathlib

import numpy as np
import pytest
import torch

import ffpic_tpu
import ffpic_tpu_torch
from ffpic_tpu import native as jax_native
from ffpic_tpu.formats import jpg as jax_jpg
from ffpic_tpu.formats.pic import Pic as JaxPic
from ffpic_tpu_torch import testing
from ffpic_tpu_torch.formats import registry
from ffpic_tpu_torch.formats.pic import Pic, PixelFormat
import reference_native  # noqa: F401  (readies ffpic_tpu first)

REPO = pathlib.Path(__file__).resolve().parent.parent
CORPUS = REPO / "corpus"
CORPUS_JPEGS = ["jpeg_160_420.jpg", "jpeg_160_444.jpg", "jpeg_512_420.jpg",
                "jpeg_512_422.jpg", "jpeg_512_444.jpg", "jpeg_gray_512.jpg",
                "jpeg_prog_512_420.jpg", "jpeg_prog_512_444.jpg",
                "jpeg_q30_512_420.jpg", "jpeg_q95_512_420.jpg",
                "jpeg_1088p_420.jpg", "jpeg_1080p_420.jpg"]


def _corpus(name: str) -> bytes:
    path = CORPUS / name
    if not path.exists():
        pytest.skip(f"{path} missing (tools/make_corpus.py makes it)")
    return path.read_bytes()


def _same_pic(load, want):
    """``load()``, the port's decode, gives ``want``'s picture: fields,
    ``meta``, ``info()`` and pixels, the colour up to XLA's contraction
    choice (``testing.assert_equal_up_to_contraction``)."""
    got = load()
    assert isinstance(got, Pic)
    assert (got.width, got.height, got.depth, got.pitch, got.format,
            got.codec) == (want.width, want.height, want.depth, want.pitch,
                           want.format, want.codec)
    assert got.meta == want.meta
    assert ffpic_tpu_torch.info(got) == ffpic_tpu.info(want)
    if want.pixels is None:
        assert got.pixels is None
    else:
        assert isinstance(got.pixels, torch.Tensor)
        assert got.pixels.dtype == torch.uint8
        testing.assert_equal_up_to_contraction(
            lambda: load().np_pixels(), want.np_pixels())


@pytest.fixture(autouse=True)
def _native_first():
    # load the reference's native decoder before calling it (ROADMAP
    # Queue 3: its loader races)
    jax_native.available()


@pytest.mark.parametrize("name", CORPUS_JPEGS)
def test_load_matches_jax_on_corpus(name):
    data = _corpus(name)
    _same_pic(lambda: ffpic_tpu_torch.load(data, device="cpu"),
              ffpic_tpu.load(data))


@pytest.mark.parametrize("option", [
    {"quirks": True}, {"upsample": "fancy"}, {"mode": "bt601"},
    {"order": "bgra"}])
@pytest.mark.parametrize("name", ["jpeg_512_422.jpg", "jpeg_gray_512.jpg"])
def test_load_options_match_jax(name, option):
    """The codec's options, which the reference reaches through
    ``formats.jpg.load`` and the port through ``load(**options)``."""
    data = _corpus(name)
    want = jax_jpg.load(data, **option)[0]
    want.codec = "JPG"
    _same_pic(lambda: ffpic_tpu_torch.load(data, device="cpu", **option),
              want)


@pytest.mark.parametrize("sampling,kw", [
    (((2, 1), (1, 1), (1, 1)), {"restart_interval": 3}),
    (((1, 2), (1, 1), (1, 1)), {"cr_quality": 40}),
    (((4, 1), (1, 1), (1, 1)), {"restart_interval": 1}),
    (((1, 1), (2, 1), (2, 1)), {}),
], ids=["422_dri", "440_cr_table", "411_dri1", "luma_up"])
def test_load_written_files_match_jax(sampling, kw):
    """Files of ``testing.encode_jpeg``: restart intervals, a Cr table of
    its own, 4:1:1, luma upsampled; odd sizes.  The content is a crop of
    a larger synthetic image, smooth at this size, so that the decode
    (bt601) is within 30 dB of it."""
    rgb = np.ascontiguousarray(testing.synth_rgb(512, 640, 5)[:67, :101])
    data = testing.encode_jpeg(rgb, 85, sampling, **kw)
    if kw.get("restart_interval"):
        assert b"\xff\xdd" in data and b"\xff\xd0" in data
    pic = ffpic_tpu_torch.load(data, device="cpu")
    _same_pic(lambda: ffpic_tpu_torch.load(data, device="cpu"),
              ffpic_tpu.load(data))
    assert pic.width == 104 and pic.height == 67
    exact = ffpic_tpu_torch.load(data, device="cpu", mode="bt601")
    psnr = testing.psnr(exact.np_pixels()[:, :101, :3], rgb)
    assert psnr > 30, psnr


def test_encode_jpeg_420_is_encode_baseline():
    """The general writer's 4:2:0 is the encoder's own bytes."""
    rgb = testing.synth_rgb(40, 56, 2)
    assert testing.encode_jpeg(rgb, 70) == ffpic_tpu_torch.encode(
        Pic(pixels=rgb, width=56, height=40), "JPG", quality=70,
        device="cpu")


def test_load_exif_matches_jax():
    from PIL import Image
    exif = Image.Exif()
    exif[0x0112] = 6                         # orientation: rotate 90
    exif[0x010F] = "ffpic"
    exif[0x0110] = "synthetic"
    buf = io.BytesIO()
    Image.fromarray(testing.synth_rgb(48, 80, 6)).save(
        buf, "JPEG", quality=80, exif=exif.tobytes())
    data = buf.getvalue()
    got, want = ffpic_tpu_torch.load(data, device="cpu"), ffpic_tpu.load(data)
    _same_pic(lambda: ffpic_tpu_torch.load(data, device="cpu"), want)
    assert got.meta["exif"]["orientation"] == 6
    assert got.meta["exif"]["make"] == "ffpic"
    rot, wrot = got.exif_transpose(), want.exif_transpose()
    assert (rot.width, rot.height) == (wrot.width, wrot.height) == (48, 80)
    testing.assert_equal_up_to_contraction(
        lambda: ffpic_tpu_torch.load(data, device="cpu").exif_transpose()
        .np_pixels(), wrot.np_pixels())


def test_load_all_multi_picture_matches_jax():
    """Two JPEGs back to back, with garbage between: two pictures, the
    second on the first's ``frames``."""
    a = testing.synth_jpeg_420(40, 56, 80, 1)
    b = testing.encode_jpeg(testing.synth_rgb(24, 30, 2), 60,
                            ((1, 1), (1, 1), (1, 1)))
    data = a + b"junk\x00\xff" + b
    got = ffpic_tpu_torch.load_all(data, device="cpu")
    want = ffpic_tpu.load_all(data)
    assert len(got) == len(want) == 2
    for k, w in enumerate(want):
        _same_pic(lambda k=k: ffpic_tpu_torch.load_all(data, device="cpu")[k],
                  w)
    first = ffpic_tpu_torch.load(data, device="cpu")
    assert first.n_frames == 2 and first.frames[0].width == 32


def test_load_skip_decode_matches_jax():
    data = _corpus("jpeg_512_422.jpg")
    got = ffpic_tpu_torch.load(data, skip_decode=True, device="cpu")
    _same_pic(lambda: got, ffpic_tpu.load(data, skip_decode=True))
    assert got.pixels is None and got.meta["scans"]


def test_header_only_load_needs_no_cuda(monkeypatch):
    """A header-only load or info with device=None runs where CUDA is
    absent (it decodes no pixels) and gives ffpic_tpu's metadata; a
    decoding load still raises there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = _corpus("jpeg_512_422.jpg")
    _same_pic(lambda: ffpic_tpu_torch.load(data, skip_decode=True),
              ffpic_tpu.load(data, skip_decode=True))
    pics = ffpic_tpu_torch.load_all(data, skip_decode=True)
    assert [p.meta for p in pics] == [
        p.meta for p in ffpic_tpu.load_all(data, skip_decode=True)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ffpic_tpu_torch.load(data)


@pytest.mark.parametrize("corrupt", ["missing_table", "not_an_image"])
def test_corrupt_file_raises_value_error(corrupt):
    data = bytearray(testing.synth_jpeg_420(32, 48, 80, 3))
    if corrupt == "missing_table":
        sof = data.index(b"\xff\xc0")
        data[sof + 12] = 7                   # Y's quant table id: none
    else:
        data = bytearray(b"GIF89a" + bytes(64))
    for load in (ffpic_tpu.load,
                 lambda d: ffpic_tpu_torch.load(d, device="cpu")):
        with pytest.raises(ValueError):
            load(bytes(data))


@pytest.mark.parametrize("hw", [(72, 104), (67, 101)])
@pytest.mark.parametrize("quality", [None, 30, 90])
def test_encode_matches_jax(quality, hw):
    h, w = hw
    rgb = testing.synth_rgb(h, w, 8)
    rgba = np.concatenate([rgb, np.full((h, w, 1), 255, np.uint8)], -1)
    want = ffpic_tpu.encode(JaxPic(pixels=rgba, width=w, height=h), "JPG",
                            quality=quality)
    pic = Pic(pixels=torch.from_numpy(rgba), width=w, height=h)
    assert ffpic_tpu_torch.encode(pic, "JPG", quality=quality,
                                  device="cpu") == want


def test_encode_takes_bgra():
    rgb = testing.synth_rgb(32, 40, 9)
    rgba = np.concatenate([rgb, np.full((32, 40, 1), 255, np.uint8)], -1)
    bgra = np.ascontiguousarray(rgba[..., [2, 1, 0, 3]])
    pic = Pic(pixels=bgra, width=40, height=32, format=PixelFormat.BGRA32)
    want = ffpic_tpu.encode(JaxPic(pixels=bgra, width=40, height=32,
                                   format=PixelFormat.BGRA32), "JPG")
    assert ffpic_tpu_torch.encode(pic, "JPG", device="cpu") == want


def test_registry_is_the_ports_own():
    """The port registers every codec of the JAX package, under its
    names and aliases, in the order of its probe table (``ffpic_tpu/
    formats/all_formats.py``) whatever order the modules were imported
    in (the JAX package's live list follows its import order: a test
    that imports ``ffpic_tpu.formats.heif`` before the list fills puts
    HEIF first); each codec is the port's own module (AVIF's
    ``formats.avif``), and importing ffpic_tpu registers nothing in it."""
    import re
    mine, theirs = (ffpic_tpu_torch.registered_codecs(),
                    ffpic_tpu.registered_codecs())
    assert mine == list(registry.ORDER)
    assert sorted(mine) == sorted(theirs)
    table = re.findall(r"^from ffpic_tpu\.formats import (\w+)", (
        REPO / "ffpic_tpu" / "formats" / "all_formats.py").read_text(), re.M)
    names = [ffpic_tpu.find_codec(m.upper()).name if m != "hevc_raw"
             else "HEVC" for m in table]
    assert names == mine
    for c in mine:
        codec = ffpic_tpu_torch.find_codec(c)
        assert codec.alias == ffpic_tpu.find_codec(c).alias
        assert (codec.decode or codec.load).__module__.startswith(
            "ffpic_tpu_torch.formats.")
    codec = ffpic_tpu_torch.find_codec("jpeg")
    assert codec is ffpic_tpu_torch.find_codec("JPG")
    assert codec.load.__module__ == "ffpic_tpu_torch.formats.jpg"
    assert ffpic_tpu_torch.probe(_corpus("jpeg_160_420.jpg")) is codec
    assert ffpic_tpu_torch.find_codec("GIF").decode.__module__ == \
        "ffpic_tpu_torch.formats.gif"
    with pytest.raises(KeyError):
        ffpic_tpu_torch.find_codec("RAW")
    with pytest.raises(ValueError, match="unrecognized"):
        ffpic_tpu_torch.probe(b"not an image" + bytes(64))


def test_registry_fills_once_under_threads(monkeypatch):
    """Eight threads ask for the codec list of an empty registry at once:
    each waits for the one import that fills it and sees every codec
    (the reference's registry marks itself filled first, and a second
    thread can find no codec)."""
    import sys
    import threading
    registry.registered_codecs()      # the real list, restored afterwards
    monkeypatch.setattr(registry, "_codecs", [])
    monkeypatch.setattr(registry, "_initialized", False)
    import ffpic_tpu_torch.formats as formats
    for mod in ("all_formats", "jpg", "png", "webp"):  # imported afresh:
        monkeypatch.delitem(sys.modules,         # they register as they load
                            f"ffpic_tpu_torch.formats.{mod}")
        monkeypatch.delattr(formats, mod)
    barrier = threading.Barrier(8)
    seen, errors = [], []

    def worker():
        try:
            barrier.wait(timeout=60)
            seen.append(registry.registered_codecs())
        except Exception as e:          # noqa: BLE001 - reported below
            errors.append(e)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert seen == [["JPG", "PNG", "WEBP"]] * 8


def test_load_and_encode_read_paths(tmp_path):
    path = tmp_path / "a.jpg"
    path.write_bytes(testing.synth_jpeg_420(32, 48, 80, 4))
    got = ffpic_tpu_torch.load(str(path), device="cpu")
    assert torch.equal(got.pixels, ffpic_tpu_torch.load(
        path.read_bytes(), device="cpu").pixels)
    with pytest.raises(TypeError):
        ffpic_tpu_torch.load(12345, device="cpu")


@pytest.mark.parametrize("call", ["load", "encode"])
def test_device_none_raises_without_cuda(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = testing.synth_jpeg_420(16, 16, 80, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if call == "load":
            ffpic_tpu_torch.load(data)
        else:
            ffpic_tpu_torch.encode(Pic(pixels=np.zeros((16, 16, 4),
                                                       np.uint8)), "JPG")


def test_device_other_than_cuda_or_cpu_raises():
    with pytest.raises(ValueError, match="unsupported device"):
        registry.load(testing.synth_jpeg_420(16, 16, 80, 1), device="meta")


def test_pic_conversions_match_jax():
    """``Pic`` holding a tensor converts as the original holding the
    same numpy array."""
    rng = np.random.default_rng(3)
    px = rng.integers(0, 256, (5, 7, 4)).astype(np.uint8)
    meta = {"exif": {"orientation": 5}}
    for fmt in (PixelFormat.RGBA32, PixelFormat.BGRA32):
        got = Pic(pixels=torch.from_numpy(px), width=7, height=5, pitch=28,
                  format=fmt, meta=meta)
        want = JaxPic(pixels=px, width=7, height=5, pitch=28, format=fmt,
                      meta=meta)
        np.testing.assert_array_equal(got.to_rgba32(), want.to_rgba32())
        np.testing.assert_array_equal(got.to_bgra32(), want.to_bgra32())
        rot, wrot = got.exif_transpose(), want.exif_transpose()
        np.testing.assert_array_equal(rot.np_pixels(), wrot.np_pixels())
        assert (rot.width, rot.height, rot.pitch, rot.meta) == \
            (wrot.width, wrot.height, wrot.pitch, wrot.meta)
    assert "pixels=Tensor" in repr(got)
