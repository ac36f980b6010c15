"""The port's JPEG 2000 codec (``formats/jp2.py``, ``coding/jpeg2000.py``
and the native ``host_jp2.c``) held against ffpic_tpu's on the same
files, on the CPU, with tolerance 0: both run the same numpy and C.

Files are written by PIL (openjpeg) in the test, after the cases of
``tests/test_jp2_decode.py``: reversible gray and RGB, 9/7 with the
ICT, the RCT, explicit precincts, multi-tile codestreams, the five
progression orders, several quality layers, the raw codestream, a 16-bit
plane through ``decode_to_planes`` and a corrupt SIZ.  For each:
``load``'s pixels, size and meta, ``info()`` and the header-only parse
equal the JAX package's.  The port's native tier-1 (``jp2_block``) is
held against the reference's Python ``BlockDecoder`` on code-blocks
taken from such files; and ``decode_batch`` of JPEG 2000, OpenEXR and
SVG members equals ``ffpic_tpu.decode_batch``.
"""

import io
import types

import numpy as np
import pytest
import torch
from PIL import Image

import ffpic_tpu
import ffpic_tpu_torch
from ffpic_tpu import native as jax_native
from ffpic_tpu.coding import jpeg2000 as jax_j2k
from ffpic_tpu_torch import native, testing
from ffpic_tpu_torch.coding import jpeg2000
import reference_native  # noqa: F401  (readies ffpic_tpu first)


@pytest.fixture(autouse=True)
def _native_first():
    jax_native.available()


def _content(h, w, seed=2):
    rng = np.random.default_rng(seed)
    return np.clip(np.add.outer(np.arange(h), np.arange(w)) % 256
                   + rng.integers(-9, 9, (h, w)), 0, 255).astype(np.uint8)


def _rgb(h, w, seed=2):
    g = _content(h, w, seed)
    return np.stack([g, np.roll(g, 7, 0), np.roll(g, 3, 1)], -1)


def _jp2(arr, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(arr).save(b, "JPEG2000", **kw)
    return b.getvalue()


def assert_same(data: bytes) -> torch.Tensor:
    """``load`` of the port on the CPU equals the reference's: pixels,
    size, meta, ``info()`` and the header-only parse."""
    want = ffpic_tpu.load(data)
    got = ffpic_tpu_torch.load(data, device="cpu")
    assert got.codec == want.codec == "JP2"
    assert (got.width, got.height, got.pitch) == \
        (want.width, want.height, want.pitch)
    assert isinstance(got.pixels, torch.Tensor)
    np.testing.assert_array_equal(got.pixels.numpy(), want.np_pixels())
    assert got.meta == want.meta
    assert ffpic_tpu_torch.info(got) == ffpic_tpu.info(want)
    head = ffpic_tpu_torch.load(data, skip_decode=True)
    assert head.pixels is None
    assert head.meta == ffpic_tpu.load(data, skip_decode=True).meta
    return got.pixels


CASES = {
    "gray_75x93": lambda: _jp2(_content(75, 93), irreversible=False),
    "gray_33x128": lambda: _jp2(_content(33, 128), irreversible=False),
    "rgb_reversible": lambda: _jp2(_rgb(120, 90), irreversible=False),
    "gray_97": lambda: _jp2(_content(96, 144), irreversible=True),
    "rgb_97": lambda: _jp2(_rgb(96, 144), irreversible=True),
    "rct": lambda: _jp2(_rgb(88, 104), irreversible=False, mct=1),
    "ict": lambda: _jp2(_rgb(96, 80), irreversible=True, mct=1),
    "precincts": lambda: _jp2(_rgb(150, 170), irreversible=False,
                              precinct_size=(64, 64)),
    "precincts_rpcl_layers": lambda: _jp2(
        _rgb(150, 170), irreversible=False, precinct_size=(32, 64),
        progression="RPCL", quality_layers=[50, 20, 0]),
    "precincts_cprl_rct": lambda: _jp2(
        _rgb(150, 170), irreversible=False, precinct_size=(64, 64),
        progression="CPRL", mct=1),
    "precincts_97": lambda: _jp2(_rgb(150, 170), irreversible=True,
                                 precinct_size=(128, 128)),
    "multitile_precincts": lambda: _jp2(
        _rgb(150, 140), irreversible=False, tile_size=(64, 64),
        precinct_size=(32, 32)),
    "multitile_pcrl_rct": lambda: _jp2(
        _rgb(150, 140), irreversible=False, tile_size=(64, 64),
        precinct_size=(32, 32), progression="PCRL", mct=1),
    "multitile_97": lambda: _jp2(_rgb(150, 140), irreversible=True,
                                 tile_size=(64, 64), precinct_size=(32, 32)),
    "multitile_odd": lambda: _jp2(
        np.random.default_rng(1).integers(0, 256, (200, 130, 3),
                                          dtype=np.uint8),
        irreversible=False, tile_size=(64, 64)),
    "multi_layer": lambda: _jp2(_content(80, 80), irreversible=False,
                                quality_layers=[40, 0]),
    "rates_layers_97": lambda: _jp2(_rgb(64, 96), irreversible=True,
                                    mct=1, quality_mode="rates",
                                    quality_layers=[40, 20, 10]),
    "noise": lambda: _jp2(np.random.default_rng(5).integers(
        0, 256, (100, 67), dtype=np.uint8), irreversible=False),
}
CASES.update({
    f"progression_{p}": (lambda p=p: _jp2(
        np.random.default_rng(2).integers(0, 256, (80, 96), dtype=np.uint8),
        irreversible=False, progression=p, quality_layers=[60, 30, 0]))
    for p in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")})


@pytest.mark.parametrize("name", sorted(CASES))
def test_load_matches_jax(name):
    assert_same(CASES[name]())


def test_raw_codestream_matches_jax():
    """A raw codestream (no JP2 boxes) decodes as the reference's, and
    as the boxed file's pixels."""
    data = _jp2(_rgb(64, 72), irreversible=False, mct=1)
    raw = data[data.find(b"\xff\x4f\xff\x51"):]
    px = assert_same(raw)
    assert torch.equal(px, ffpic_tpu_torch.load(data, device="cpu").pixels)
    assert ffpic_tpu_torch.load(raw, skip_decode=True).meta["boxes"] == []


def test_16bit_plane_through_decode_to_planes():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 65536, (40, 50)).astype(np.uint16)
    data = _jp2(a, irreversible=False)
    pos = data.find(b"\xff\x4f\xff\x51")
    planes, meta = jpeg2000.decode_to_planes(data, pos)
    want, wmeta = jax_j2k.decode_to_planes(data, pos)
    assert meta == wmeta and meta["depths"] == [16]
    assert len(planes) == len(want) == 1
    assert planes[0].dtype == want[0].dtype
    np.testing.assert_array_equal(planes[0], want[0])
    assert_same(data)                 # 16 bits scaled to 8 in load


def test_corrupt_siz_raises_value_error_as_jax():
    """Fuzzed SIZ dimensions raise ``ValueError`` in both packages, as
    does a JP2 box file without its codestream; a codestream cut short
    decodes to the reference's pixels."""
    data = bytearray(_jp2(_content(64, 64), irreversible=False))
    i = data.find(b"\xff\x51")
    data[i + 6:i + 10] = (3_000_000_000).to_bytes(4, "big")      # Xsiz
    good = _jp2(_content(48, 40), irreversible=False)
    jp2c = good.find(b"jp2c")
    no_jp2c = good[:jp2c] + b"junk" + good[jp2c + 4:]
    for bad in (bytes(data), no_jp2c):
        for load in (ffpic_tpu.load,
                     lambda d: ffpic_tpu_torch.load(d, device="cpu")):
            with pytest.raises(ValueError):
                load(bad)
    assert_same(good[:len(good) * 2 // 3])


def _blocks(data: bytes) -> list:
    """The (data, passes, mb, zbp, w, h, kind) of every code-block the
    port's tier-1 decodes in ``data``."""
    seen = []

    def record(*args):
        seen.append(args)
        return native.jp2_block(*args)
    orig = jpeg2000.native
    jpeg2000.native = types.SimpleNamespace(jp2_block=record)
    try:
        jpeg2000.decode_to_planes(data, data.find(b"\xff\x4f\xff\x51"))
    finally:
        jpeg2000.native = orig
    return seen


@pytest.mark.parametrize("name", ["rgb_97", "multitile_precincts",
                                  "rates_layers_97"])
def test_native_tier1_matches_the_references_python_oracle(name):
    """Every code-block of the file: the port's C ``jp2_block`` equals
    the reference's Python ``BlockDecoder`` (the original's fallback
    under ``FFPIC_NO_NATIVE``) and the port's copy of it, and the
    reference's C; all three orientations are met."""
    blocks = _blocks(CASES[name]())
    assert {b[6] for b in blocks} == {0, 1, 2}
    for k, (data, npasses, mb, zbp, w, h, kind) in enumerate(blocks):
        if k % 5:                      # every fifth block: Python is slow
            continue
        got = native.jp2_block(data, npasses, mb, zbp, w, h, kind)
        want = jax_j2k.BlockDecoder(w, h, kind).decode(data, npasses, mb,
                                                       zbp)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            jpeg2000.BlockDecoder(w, h, kind).decode(data, npasses, mb, zbp),
            want)
        np.testing.assert_array_equal(
            jax_native.jp2_block(data, npasses, mb, zbp, w, h, kind), got)


def test_jp2_block_edges():
    """No passes or no bytes give zeros; a corrupt QCD exponent is
    clamped as in the reference's C."""
    z = native.jp2_block(b"", 3, 9, 0, 5, 7, 0)
    assert z.shape == (7, 5) and not z.any()
    assert not native.jp2_block(b"\x12\x34", 0, 9, 0, 4, 4, 1).any()
    data = bytes(np.random.default_rng(9).integers(0, 256, 64,
                                                   dtype=np.uint8))
    np.testing.assert_array_equal(
        native.jp2_block(data, 7, 40, 0, 8, 8, 2),
        jax_native.jp2_block(data, 7, 40, 0, 8, 8, 2))


# --- decode_batch of the still codecs ----------------------------------------

def _members() -> list:
    """JPEG 2000 (5/3 + RCT, 9/7 + ICT), OpenEXR (ZIP, PIZ, B44) and SVG
    members of one size, 48 x 64."""
    from ffpic_tpu_torch.formats.pic import Pic
    h, w = 48, 64
    rgb = _rgb(h, w, 4)
    rgba = np.dstack([rgb, _content(h, w, 5)])
    pic = Pic(pixels=rgba, width=w, height=h)
    return [_jp2(rgb, irreversible=False, mct=1),
            ffpic_tpu_torch.encode(pic, "EXR", compression="zip",
                                   device="cpu"),
            testing.svg_still(w, h, 0),
            _jp2(rgb, irreversible=True, mct=1, quality_layers=[30, 0]),
            ffpic_tpu_torch.encode(pic, "EXR", compression="piz",
                                   device="cpu"),
            testing.svg_still(w, h, 1),
            ffpic_tpu_torch.encode(pic, "EXR", compression="b44",
                                   pixel_type="float", device="cpu")]


def test_decode_batch_of_still_codecs_matches_jax():
    """``decode_batch`` of JPEG 2000, OpenEXR and SVG members equals the
    reference's: exactly at ``size=None`` (and each row the member's
    ``load``), within the resize's recorded 1 LSB at (224, 224)."""
    members = _members()
    got = ffpic_tpu_torch.decode_batch(members, device="cpu")
    want = np.asarray(ffpic_tpu.decode_batch(members))
    assert tuple(got.shape) == want.shape == (len(members), 48, 64, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    for row, data in zip(got, members):
        assert torch.equal(row, ffpic_tpu_torch.load(data,
                                                     device="cpu").pixels)
    got = ffpic_tpu_torch.decode_batch(members, size=(224, 224),
                                       device="cpu")
    want = np.asarray(ffpic_tpu.decode_batch(members, size=(224, 224)))
    assert tuple(got.shape) == want.shape == (len(members), 224, 224, 4)
    assert np.abs(got.numpy().astype(int) - want).max() <= 1
