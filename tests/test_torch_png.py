"""The PNG codec of ffpic_tpu_torch (CPU, plain versions) held against
ffpic_tpu's on the same bytes and arrays, exactly: the device stages
``unfilter_subup`` (K6) and ``expand_rgba`` (K7, with
``unpack_samples``) against ``ffpic_tpu.ops.png_kernels`` and the
Python oracle ``_unfilter_py``; the native unfilter against the
reference's; ``load`` (pixels, ``meta``, ``info()``) on the corpus PNGs
and on ``testing.encode_png`` files of every colour type and bit depth,
palette, tRNS, Adam7, split IDAT and extra chunks; ``skip_decode``, CRC
checks and ``encode``'s bytes.  The CUDA kernels run only on a GPU
(``chip_smoke.py``); here their wrappers are checked to refuse CPU
tensors.
"""

import functools
import io
import pathlib
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ffpic_tpu
import ffpic_tpu_torch
from ffpic_tpu import native as jax_native
from ffpic_tpu.formats import png as jax_png
from ffpic_tpu.formats.pic import Pic as JaxPic
from ffpic_tpu.ops import png_kernels as jax_pk
from ffpic_tpu.utils import checksum as jax_checksum
from ffpic_tpu_torch import native, testing
from ffpic_tpu_torch.formats import png
from ffpic_tpu_torch.formats.pic import Pic, PixelFormat
from ffpic_tpu_torch.ops import cuda_png
from ffpic_tpu_torch.ops import png_kernels as pk
from ffpic_tpu_torch.utils import checksum
import reference_native  # noqa: F401  (readies ffpic_tpu first)

REPO = pathlib.Path(__file__).resolve().parent.parent
CORPUS_PNGS = ["png_512_rgb.png", "png_512_rgba.png", "png_1080p_rgba.png"]


@pytest.fixture(autouse=True)
def _native_first():
    jax_native.available()


def _corpus(name: str) -> bytes:
    path = REPO / "corpus" / name
    if not path.exists():
        pytest.skip(f"{path} missing (tools/make_corpus.py makes it)")
    return path.read_bytes()


def _same_pic(got, want):
    assert isinstance(got, Pic) and isinstance(got.pixels, torch.Tensor)
    assert (got.width, got.height, got.depth, got.pitch, got.format,
            got.codec) == (want.width, want.height, want.depth, want.pitch,
                           want.format, want.codec)
    assert got.meta == want.meta
    assert ffpic_tpu_torch.info(got) == ffpic_tpu.info(want)
    assert got.pixels.dtype == torch.uint8
    np.testing.assert_array_equal(got.np_pixels(), want.np_pixels())


# --- device stages ----------------------------------------------------------

@pytest.mark.parametrize("name", sorted(testing.unfilter_cases()))
def test_unfilter_subup_matches_jax(name):
    """K6's plain version against the reference's device version and the
    Python oracle: every bpp, a first row of Up, one row, one pixel, long
    Up runs, the filters in turn, restarts on K6's band edges, one Sub
    row above 4,000 Up rows, a row of 20,000 16-bit RGBA pixels."""
    rows, bpp = _unfilter_cases()[name]
    h, stride = rows.shape[0], rows.shape[1] - 1
    got = pk.unfilter_subup(torch.from_numpy(rows), bpp).numpy()
    want = np.asarray(jax_pk.unfilter_device_subup(
        jnp.asarray(rows[:, 1:]), jnp.asarray(rows[:, 0].astype(np.int32)),
        bpp=bpp))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_png._unfilter_py(rows, h, stride,
                                                            bpp))
    np.testing.assert_array_equal(got, png._unfilter_py(rows, h, stride, bpp))


@functools.lru_cache(maxsize=1)
def _unfilter_cases():
    return testing.unfilter_cases()


@pytest.mark.parametrize("name", sorted(testing.unfilter_cases()))
@pytest.mark.parametrize("band", ["kernel", "one_row", "three_rows"])
def test_unfilter_subup_bands_match_jax(name, band):
    """K6's decomposition (``unfilter_subup_bands``: bands of rows walked
    in chunks, each band's last row published as INC or AGG, the
    look-back within a block of bands and then block by block) against
    the reference's
    device version: at the kernel's band and chunk for the stride
    (``cuda_png.unfilter_bands``), at bands of one row, and at bands of
    three rows in chunks of 768 bytes in blocks of 4 bands."""
    rows, bpp = _unfilter_cases()[name]
    r, chunk = cuda_png.unfilter_bands(rows.shape[0], rows.shape[1] - 1)
    r, chunk, block = {"kernel": (r, chunk, 32), "one_row": (1, chunk, 32),
                       "three_rows": (3, 768, 4)}[band]
    got = pk.unfilter_subup_bands(torch.from_numpy(rows), bpp, r, chunk,
                                  block).numpy()
    want = np.asarray(jax_pk.unfilter_device_subup(
        jnp.asarray(rows[:, 1:]), jnp.asarray(rows[:, 0].astype(np.int32)),
        bpp=bpp))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stride", [1, 7, 767, 768, 769, 7680, 7681,
                                    160_000, 2 ** 31 - 1])
def test_unfilter_bands_fit_the_kernel(stride):
    """K6's bands for any stride and height: a chunk of a multiple of 768
    bytes (so a lane's run of it is a multiple of lcm(4, bpp) for every
    bpp), at most 7,680, covering the stride in as few chunks; rows x
    chunk within its 30,720 bytes of shared memory, 1 to 64 rows, and
    256 bands or more where the height allows (4 rows at 1080p)."""
    for h in (1, 64, 1080, 4001, 2 ** 31 - 1):
        rows, chunk = cuda_png.unfilter_bands(h, stride)
        assert chunk % 768 == 0 and 768 <= chunk <= 7680
        assert chunk >= stride or chunk == 7680
        assert 1 <= rows <= 64 and rows * chunk <= 30720
        assert (chunk // 32) % 24 == 0
        assert rows == 1 or -(-h // rows) >= 256
    assert cuda_png.unfilter_bands(1080, 7680) == (4, 7680)


def test_unfilter_device_subup_dispatches_on_the_cpu():
    rows, bpp = testing.unfilter_cases()["bpp3"]
    t = torch.from_numpy(rows)
    assert torch.equal(pk.unfilter_device_subup(t, bpp),
                       pk.unfilter_subup(t, bpp))


@pytest.mark.parametrize("ft", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("bpp", [1, 3, 4, 8])
def test_native_png_unfilter_matches_jax(ft, bpp):
    rng = np.random.default_rng(bpp)
    h, stride = 9, bpp * 23 + (1 if bpp == 1 else 0)
    raw = rng.integers(0, 256, (h, stride + 1)).astype(np.uint8)
    raw[:, 0] = rng.integers(0, 5, h) if ft == "mixed" else ft
    got = native.png_unfilter(raw, h, stride, bpp)
    np.testing.assert_array_equal(
        got, jax_native.png_unfilter(raw, h, stride, bpp))
    np.testing.assert_array_equal(got, png._unfilter_py(raw, h, stride, bpp))


def test_native_png_unfilter_refuses_bad_input():
    raw = np.zeros((3, 5), np.uint8)
    with pytest.raises(ValueError, match="cannot hold"):
        native.png_unfilter(raw[:2], 3, 4, 1)
    raw[1, 0] = 7
    with pytest.raises(ValueError, match="filter"):
        native.png_unfilter(raw, 3, 4, 1)


@pytest.mark.parametrize("name", sorted(testing.rgba_cases()))
def test_expand_rgba_matches_jax(name):
    """K7's plain version against the reference's ``assemble_rgba`` for
    every legal (colour type, bit depth), with and without tRNS, at an
    odd width."""
    recon, pal, trns, ct, bd, w, h = testing.rgba_cases()[name]
    got = pk.expand_rgba(torch.from_numpy(recon), pal, trns, ct, bd, w, h)
    want = np.asarray(jax_pk.assemble_rgba(jnp.asarray(recon),
                                           jnp.asarray(pal),
                                           jnp.asarray(trns), ct, bd, w, h))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(pk.assemble_rgba(torch.from_numpy(recon), pal, trns,
                                        ct, bd, w, h), got)


@pytest.mark.parametrize("bitdepth", [1, 2, 4, 8, 16])
def test_unpack_samples_matches_jax(bitdepth):
    rng = np.random.default_rng(bitdepth)
    rows = rng.integers(0, 256, (5, 23)).astype(np.uint8)
    width = 23 * 8 // bitdepth - 3
    got = pk.unpack_samples(torch.from_numpy(rows), bitdepth, width)
    want = np.asarray(jax_pk.unpack_samples(jnp.asarray(rows), bitdepth,
                                            width))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ct,bd", [(2, 4), (3, 16), (6, 4), (5, 8)])
def test_illegal_formats_raise(ct, bd):
    with pytest.raises(ValueError, match="unsupported PNG"):
        pk.expand_rgba(torch.zeros(2, 64, dtype=torch.uint8),
                       np.zeros((256, 4), np.uint8),
                       np.full(256, -1, np.int32), ct, bd, 4, 2)


@pytest.mark.parametrize("call", [
    lambda t: cuda_png.unfilter_subup(t, 1),
    lambda t: cuda_png.assemble_rgba(t, np.zeros((256, 4), np.uint8),
                                     np.full(256, -1, np.int32), 0, 8, 4, 4),
], ids=["unfilter_subup", "assemble_rgba"])
def test_cuda_png_wrappers_refuse_cpu_tensors(call):
    with pytest.raises(ValueError, match="CUDA tensor"):
        call(torch.zeros(4, 8, dtype=torch.uint8))


# --- the codec --------------------------------------------------------------

@pytest.mark.parametrize("name", CORPUS_PNGS)
def test_load_matches_jax_on_corpus(name):
    data = _corpus(name)
    got = ffpic_tpu_torch.load(data, device="cpu")
    want = ffpic_tpu.load(data)
    _same_pic(got, want)
    assert ffpic_tpu_torch.encode(got, "PNG", device="cpu") == \
        ffpic_tpu.encode(want, "PNG")


def _rng_samples(rng, ct, bd, h, w, hi=None):
    nch = png._NCH[ct]
    hi = hi or (1 << bd)
    return rng.integers(0, hi, (h, w, nch) if nch > 1 else (h, w))


def _written_cases():
    rng = np.random.default_rng(11)
    cases = {}
    for ct, depths in pk.LEGAL.items():
        for bd in depths:
            for interlace in (0, 1):
                px = _rng_samples(rng, ct, bd, 19, 23,
                                  hi=min(1 << bd, 9) if ct == 3 else None)
                kw = {}
                if ct == 3:
                    kw = dict(palette=rng.integers(0, 256, (9, 3)),
                              trns=rng.integers(0, 256, 6))
                elif ct == 0:
                    kw = dict(trns=int(px[2, 3]))
                elif ct == 2:
                    kw = dict(trns=tuple(int(v) for v in px[4, 5]))
                name = f"ct{ct}_bd{bd}" + ("_adam7" if interlace else "")
                cases[name] = (px, ct, bd,
                               dict(filters=(0, 1, 2, 3, 4, 2),
                                    interlace=interlace, **kw))
    px = _rng_samples(rng, 6, 8, 33, 41)
    cases["subup_only"] = (px, 6, 8, dict(filters=(1, 2, 2, 0)))
    cases["up_first_row"] = (px, 6, 8, dict(filters=(2, 1)))
    cases["split_idat"] = (px, 6, 8, dict(filters=4, idat_size=100))
    cases["chunks"] = (px[..., :3], 2, 8, dict(chunks=[
        ("gAMA", struct.pack(">I", 45455)),
        ("pHYs", struct.pack(">IIB", 2835, 2835, 1)),
        ("tEXt", b"Comment\x00made from a seed"),
        ("tIME", struct.pack(">HBBBBB", 2026, 1, 2, 3, 4, 5)),
        ("sRGB", b"\x00"), ("bKGD", b"\x00\x10\x00\x20\x00\x30")]))
    cases["one_pixel"] = (px[:1, :1], 6, 8, dict(filters=1))
    cases["gray1_width9"] = (_rng_samples(rng, 0, 1, 5, 9), 0, 1,
                             dict(filters=(1, 2)))
    return cases


WRITTEN = _written_cases()


@pytest.mark.parametrize("name", sorted(WRITTEN))
def test_load_written_files_match_jax(name):
    """``testing.encode_png`` files: every legal (colour type, bit depth)
    plain and Adam7, all five filters, palette and tRNS; Sub/Up-only
    rows (the device route), split IDAT, extra chunks, one pixel."""
    px, ct, bd, kw = WRITTEN[name]
    if ct == 3:
        px = px.astype(np.uint8)
    data = testing.encode_png(px, ct, bd, **kw)
    _same_pic(ffpic_tpu_torch.load(data, device="cpu"), ffpic_tpu.load(data))


@pytest.mark.parametrize("name", ["ct6_bd8", "ct3_bd4", "ct0_bd16",
                                  "ct2_bd8_adam7", "ct4_bd8"])
def test_encode_png_decodes_in_pil(name):
    """The writer's files are PNGs to an independent decoder: PIL reads
    the same samples back (8-bit types as they are, 16-bit and palette
    modes in its own conventions)."""
    from PIL import Image
    px, ct, bd, kw = WRITTEN[name]
    im = Image.open(io.BytesIO(testing.encode_png(px, ct, bd, **kw)))
    im.load()
    got = np.asarray(im)
    if ct == 3:
        np.testing.assert_array_equal(got, px)
    elif bd == 16:
        np.testing.assert_array_equal(got.astype(np.int64), px)
    else:
        np.testing.assert_array_equal(got, px.astype(np.uint8))


def test_device_route_is_taken_for_sub_and_up_rows(monkeypatch):
    """A pass whose filters are all None/Sub/Up reaches K6's entry with
    its tagged rows; one with Average or Paeth rows is unfiltered on the
    host by the native C and never reaches K6, as the reference routes
    them (``png.py:93-103``)."""
    seen = []
    real = pk.unfilter_device_subup

    def spy(tagged, bpp):
        seen.append(tuple(tagged.shape))
        return real(tagged, bpp)

    monkeypatch.setattr(pk, "unfilter_device_subup", spy)
    px, ct, bd, kw = WRITTEN["subup_only"]
    f = png.parse(testing.encode_png(px, ct, bd, **kw))
    assert f.passes[0].rows is not None and f.passes[0].recon is None
    png.to_pic(f, torch.device("cpu"))
    assert seen == [(33, 41 * 4 + 1)]
    px, ct, bd, kw = WRITTEN["split_idat"]
    f = png.parse(testing.encode_png(px, ct, bd, **kw))
    assert f.passes[0].rows is None and f.passes[0].recon is not None
    png.to_pic(f, torch.device("cpu"))
    assert len(seen) == 1


def test_skip_decode_matches_jax():
    px, ct, bd, kw = WRITTEN["chunks"]
    data = testing.encode_png(px, ct, bd, **kw)
    got = ffpic_tpu_torch.load(data, skip_decode=True, device="cpu")
    want = ffpic_tpu.load(data, skip_decode=True)
    assert got.pixels is None and want.pixels is None
    assert (got.width, got.height, got.pitch, got.codec, got.meta) == \
        (want.width, want.height, want.pitch, want.codec, want.meta)
    assert ffpic_tpu_torch.info(got) == ffpic_tpu.info(want)
    assert "tEXt Comment" in ffpic_tpu_torch.info(got)


def test_crc_mismatch_raises():
    px, ct, bd, kw = WRITTEN["ct6_bd8"]
    data = bytearray(testing.encode_png(px, ct, bd, **kw))
    data[data.index(b"IDAT") + 10] ^= 0xFF
    for load in (ffpic_tpu.load,
                 lambda d: ffpic_tpu_torch.load(d, device="cpu")):
        with pytest.raises(ValueError, match="CRC mismatch"):
            load(bytes(data))
    data = bytearray(testing.encode_png(px, ct, bd, **kw))
    data[data.index(b"IEND") - 8] ^= 0xFF       # the IDAT chunk's CRC
    got = png.load(bytes(data), device=torch.device("cpu"),
                   verify_crc=False)[0]
    want = jax_png.load(bytes(data), verify_crc=False)[0]
    np.testing.assert_array_equal(got.np_pixels(), want.np_pixels())


def test_truncated_file_raises_value_error():
    px, ct, bd, kw = WRITTEN["ct6_bd8"]
    data = testing.encode_png(px, ct, bd, **kw)
    with pytest.raises(ValueError):
        ffpic_tpu_torch.load(data[:60], device="cpu")


@pytest.mark.parametrize("fmt", [PixelFormat.RGBA32, PixelFormat.BGRA32])
def test_encode_matches_jax(fmt):
    rng = np.random.default_rng(4)
    px = rng.integers(0, 256, (21, 17, 4)).astype(np.uint8)
    px[5:] = testing.synth_rgb(16, 17, 3)[..., [0, 1, 2, 0]]
    got = ffpic_tpu_torch.encode(Pic(pixels=torch.from_numpy(px), width=17,
                                     height=21, format=fmt), "PNG",
                                 device="cpu")
    want = ffpic_tpu.encode(JaxPic(pixels=px, width=17, height=21,
                                   format=fmt), "PNG")
    assert got == want
    back = ffpic_tpu_torch.load(got, device="cpu").np_pixels()
    np.testing.assert_array_equal(
        back, px if fmt == PixelFormat.RGBA32 else px[..., [2, 1, 0, 3]])


def test_filter_rows_matches_jax():
    px = testing.synth_rgb(24, 40, 5)
    rows = np.concatenate([px, px[..., :1]], -1).reshape(24, -1)
    np.testing.assert_array_equal(png._filter_rows(rows),
                                  jax_png._filter_rows(rows))


def test_checksum_matches_jax():
    data = bytes(range(256)) * 3
    for v in (0, 1, 12345):
        assert checksum.crc32(data, v) == jax_checksum.crc32(data, v)
        assert checksum.adler32(data, v) == jax_checksum.adler32(data, v)


def test_png_is_registered_after_jpg():
    codec = ffpic_tpu_torch.find_codec("apng")
    assert codec is ffpic_tpu_torch.find_codec("PNG")
    assert codec.load.__module__ == "ffpic_tpu_torch.formats.png"
    assert ffpic_tpu_torch.probe(png.SIGNATURE + bytes(16)) is codec
    assert ffpic_tpu_torch.registered_codecs()[:2] == ["JPG", "PNG"]


@functools.lru_cache(maxsize=None)
def _big_rgba():
    rgb = testing.synth_rgb(120, 200, 9)
    return np.concatenate([rgb, testing.synth_rgb(120, 200, 10)[..., :1]], -1)


@pytest.mark.parametrize("filters", [(1, 2), 0, (0, 1, 2, 3, 4)])
def test_load_is_lossless(filters):
    px = _big_rgba()
    data = testing.encode_png(px, 6, 8, filters=filters)
    np.testing.assert_array_equal(
        ffpic_tpu_torch.load(data, device="cpu").np_pixels(), px)
