"""The port's OpenEXR codec (``formats/exr.py``, ``coding/exr_codec.py``)
held against ffpic_tpu's on the same files, on the CPU, with tolerance 0:
both run the same numpy.

Files come from the reference's writer (every compression it writes,
half, float and uint channels, scanline and tiled, multipart) and from
the committed DWAA and DWAB fixtures (OpenEXR's writer,
``make_still_fixtures``).  For each: ``load_all``'s pictures (pixels,
``meta["exr_planes"]`` bit for bit, the rest of ``meta``), ``info()``
and the header-only parse equal the JAX package's; the writers and
``encode`` give the reference's bytes for every compression and pixel
type.  A corrupt PIZ chunk and a DWA chunk whose AC stream is short
raise ``ValueError`` in both packages (the DWA read is the reference's,
without a bounds check: ``IndexError``, turned into ``ValueError`` by
the registries).
"""

import struct

import numpy as np
import pytest
import torch

import ffpic_tpu
import ffpic_tpu_torch
from ffpic_tpu.formats import exr as jax_exr
from ffpic_tpu.formats.pic import Pic as JaxPic
from ffpic_tpu_torch import testing
from ffpic_tpu_torch.coding import exr_codec
from ffpic_tpu_torch.formats import exr
from ffpic_tpu_torch.formats.pic import Pic
import reference_native  # noqa: F401  (readies ffpic_tpu first)

COMPS = {"none": 0, "rle": 1, "zips": 2, "zip": 3, "piz": 4, "pxr24": 5,
         "b44": 6, "b44a": 7}


def _planes(h=45, w=37, seed=0):
    """Half, float and uint planes of smooth content and mild noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = (1.2 + np.sin(xx / 9.0) * np.cos(yy / 7.0)).astype(np.float32)
    smooth += rng.random((h, w), np.float32) * 0.05
    return {"half": smooth.astype(np.float16),
            "float": (smooth * 3).astype(np.float32),
            "uint": (smooth * 1000).astype(np.uint32)}


def _equal(a, b) -> None:
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()      # NaNs and signed zeros too
    else:
        assert a == b


def assert_same(data: bytes) -> list:
    """``load_all`` of the port on the CPU equals the reference's."""
    want = ffpic_tpu.load_all(data)
    got = ffpic_tpu_torch.load_all(data, device="cpu")
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert g.codec == w.codec == "EXR"
        assert (g.width, g.height, g.pitch, g.format) == \
            (w.width, w.height, w.pitch, w.format)
        assert isinstance(g.pixels, torch.Tensor)
        np.testing.assert_array_equal(g.pixels.numpy(), w.np_pixels())
        _equal(g.meta, w.meta)
        assert ffpic_tpu_torch.info(g) == ffpic_tpu.info(w)
    heads = ffpic_tpu_torch.load_all(data, skip_decode=True)
    jheads = ffpic_tpu.load_all(data, skip_decode=True)
    assert len(heads) == len(jheads)
    for g, w in zip(heads, jheads):
        assert g.pixels is None
        _equal(g.meta, w.meta)
    return got


@pytest.mark.parametrize("ptype", ["half", "float", "uint"])
@pytest.mark.parametrize("comp", sorted(COMPS))
def test_scanline_file_matches_jax(comp, ptype):
    """The reference's writer and the port's give the same bytes; both
    loads agree."""
    p = _planes(seed=COMPS[comp])
    chans = [("R", p[ptype]), ("G", p["half"]), ("B", p["half"][::-1].copy()),
             ("Z", p["float"])]
    data = exr.write_exr(chans, COMPS[comp])
    assert data == jax_exr.write_exr(chans, COMPS[comp])
    assert_same(data)


@pytest.mark.parametrize("comp", ["none", "zip", "piz", "pxr24", "b44"])
@pytest.mark.parametrize("tile", [(16, 16), (32, 8)])
def test_tiled_file_matches_jax(comp, tile):
    p = _planes(50, 41, seed=7)
    chans = [("R", p["half"]), ("G", p["float"]), ("A", p["half"])]
    data = exr.write_exr(chans, COMPS[comp], tiled=True, tile_size=tile)
    assert data == jax_exr.write_exr(chans, COMPS[comp], tiled=True,
                                     tile_size=tile)
    got = assert_same(data)
    assert got[0].meta["tiled"] and got[0].meta["tile_size"] == tile


def test_multipart_file_matches_jax():
    """Two parts, one scanline and one tiled: ``load_all`` gives both,
    the first carrying the second on ``frames``."""
    p = _planes(seed=3)
    parts = [("beauty", [("R", p["half"]), ("G", p["half"]),
                         ("B", p["float"])], 3),
             ("depth", [("Z", p["float"]), ("Y", p["uint"])], 4, True,
              (16, 16))]
    data = exr.write_exr_multipart(parts)
    assert data == jax_exr.write_exr_multipart(parts)
    got = assert_same(data)
    assert [g.meta["part_name"] for g in got] == ["beauty", "depth"]
    assert ffpic_tpu_torch.load(data, device="cpu").frames[0].meta[
        "part_name"] == "depth"


@pytest.mark.parametrize("name", ["exr_dwaa_64x48.exr",
                                  "exr_dwab_40x272.exr"])
def test_dwa_fixture_matches_jax(name):
    """OpenEXR's DWAA and DWAB: the lossy DCT (B, G, R), RLE (A) and zlib
    (Q) channel classes, and DWAB's 256-line blocks."""
    got = assert_same(testing.still_fixture(name))
    assert set(got[0].meta["exr_planes"]) == set("ABGQR")
    assert got[0].meta["compression"] == (8 if "dwaa" in name else 9)


@pytest.mark.parametrize("ptype", ["half", "float"])
@pytest.mark.parametrize("comp", sorted(COMPS))
def test_encode_gives_the_references_bytes(comp, ptype):
    """``encode`` of an RGBA picture (sRGB to linear light, alpha kept
    where not opaque) gives the reference's bytes, from host pixels and
    from a tensor; its load equals the reference's."""
    rng = np.random.default_rng(COMPS[comp])
    h, w = 21, 26
    rgba = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    want = ffpic_tpu.encode(JaxPic(pixels=rgba, width=w, height=h), "EXR",
                            compression=comp, pixel_type=ptype)
    for px in (rgba, torch.from_numpy(rgba)):
        got = ffpic_tpu_torch.encode(Pic(pixels=px, width=w, height=h),
                                     "EXR", compression=comp,
                                     pixel_type=ptype, device="cpu")
        assert got == want
    assert_same(want)


def test_encode_tiled_and_opaque_give_the_references_bytes():
    rgb = testing.synth_rgb(40, 52, 1)
    rgba = np.dstack([rgb, np.full((40, 52), 255, np.uint8)])
    for kw in (dict(compression="piz", tiled=True, tile_size=(16, 32)),
               dict(compression=3)):
        got = ffpic_tpu_torch.encode(Pic(pixels=rgba, width=52, height=40),
                                     "EXR", device="cpu", **kw)
        assert got == ffpic_tpu.encode(JaxPic(pixels=rgba, width=52,
                                              height=40), "EXR", **kw)
        assert ffpic_tpu_torch.load(got, skip_decode=True).meta[
            "channels"] == ["B", "G", "R"]


def test_corrupt_piz_raises_value_error_as_jax():
    """A PIZ chunk cut short raises ``ValueError`` in both packages; one
    whose tail is zeroed or scrambled decodes to the reference's
    pixels."""
    p = _planes(seed=4)
    data = exr.write_exr([("R", p["half"])], compression=4)
    for cut in (data[:-10], data[:-100]):
        for load in (ffpic_tpu.load,
                     lambda d: ffpic_tpu_torch.load(d, device="cpu")):
            with pytest.raises(ValueError, match="PIZ"):
                load(cut)
    assert_same(data[:-40] + bytes(40))
    assert_same(data[:-60] + bytes(b ^ 0x5A for b in data[-60:]))


def _first_chunk(data: bytes) -> int:
    """The offset of a single-part scanline file's first chunk's
    payload."""
    _attrs, pos = exr._parse_header(data, 8)
    return struct.unpack_from("<Q", data, pos)[0] + 8


@pytest.mark.parametrize("ac_count", [0, 5])
def test_short_dwa_ac_stream_raises_value_error_in_both(ac_count):
    """A DWA chunk whose AC token count is cut: the reference's
    ``unRleAc`` reads past the stream's end (``IndexError``), which both
    registries report as ``ValueError``; the codec module itself raises
    ``IndexError`` in both."""
    data = bytearray(testing.still_fixture("exr_dwaa_64x48.exr"))
    at = _first_chunk(bytes(data))
    struct.pack_into("<Q", data, at + 64, ac_count)  # total AC count
    bad = bytes(data)
    for load in (ffpic_tpu.load,
                 lambda d: ffpic_tpu_torch.load(d, device="cpu")):
        with pytest.raises(ValueError, match="IndexError"):
            load(bad)
    for decode in (jax_exr.load, lambda d: exr.decode(d, device=None)):
        with pytest.raises(IndexError):
            decode(bad)


def test_exr_codec_pieces_match_jax():
    """PIZ's Huffman coder and wavelet, B44's block packing and PXR24's
    float24 on seeded data: the port's copy gives the reference's
    values."""
    from ffpic_tpu.coding import exr_codec as jax_codec
    rng = np.random.default_rng(8)
    vals = rng.integers(0, 300, 4000).astype(np.uint16)
    vals[:500] = 7
    blob = exr_codec.huf_compress(vals)
    assert blob == jax_codec.huf_compress(vals)
    np.testing.assert_array_equal(exr_codec.huf_decompress(blob, len(vals)),
                                  jax_codec.huf_decompress(blob, len(vals)))
    plane = rng.integers(0, 16384, (13, 17)).astype(np.uint16)
    a, b = plane.copy(), plane.copy()
    exr_codec.wav2_encode(a, 16383)
    jax_codec.wav2_encode(b, 16383)
    np.testing.assert_array_equal(a, b)
    exr_codec.wav2_decode(a, 16383)
    np.testing.assert_array_equal(a, plane)
    f = (rng.standard_normal(64) * 100).astype(np.float32)
    np.testing.assert_array_equal(exr_codec.float_to_float24(f),
                                  jax_codec.float_to_float24(f))
