"""The port's AVIF codec (``formats/avif.py`` over its AV1 intra decoder)
held against ffpic_tpu's on the same files, on the CPU, with tolerance
0: both run the same numpy and C.

Files are written by Pillow (libavif with libaom) after the cases of
``tests/test_avif.py`` and ``tests/test_av1.py`` (4:2:0, 4:4:4, 4:2:2
and monochrome, odd sizes, several tiles, 128x128 superblocks, palette
screen content, lossless, an alpha item), or assembled with the port's
``heif_enc`` around an OBU stream (a grid of ``av01`` tiles, a 10-bit
item from ``tools/aom_oracle``, an item with ``irot`` and ``imir``).
For each: ``load``'s pixels, size and meta, ``info()``, the header-only
parse and ``picinfo`` equal the JAX package's, and ``decode_batch`` of
them equals ``ffpic_tpu.decode_batch``.  The native colour is held
against the numpy oracle ``_yuv_to_rgba_np``; cut and garbage files give
the reference's pixels or its kind of error; an animated AVIF decodes
to the reference's frames (pixels, ``delay_ms``, meta, orientation) in
``load``, ``load_all`` and ``decode_batch``; ``encode(..., "AVIF")``
gives the reference's bytes; the committed fixtures hash as recorded
with both packages (the 1080p animation's file alone: ``chip_smoke.py``
decodes it).
"""

import functools
import hashlib
import io
import os
import struct
import sys

import numpy as np
import pytest
import torch
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import ffpic_tpu  # noqa: E402
import ffpic_tpu_torch  # noqa: E402
from ffpic_tpu import native as jax_native  # noqa: E402
from ffpic_tpu.apps import picinfo as jax_picinfo  # noqa: E402
from ffpic_tpu.formats import avif as jax_avif  # noqa: E402
from ffpic_tpu.formats.pic import Pic as JaxPic  # noqa: E402
from ffpic_tpu_torch import native, testing  # noqa: E402
from ffpic_tpu_torch.apps import picinfo  # noqa: E402
from ffpic_tpu_torch.formats import avif, heif  # noqa: E402
from ffpic_tpu_torch.formats import heif_enc as he  # noqa: E402
from ffpic_tpu_torch.formats.pic import Pic  # noqa: E402
import reference_native  # noqa: E402,F401  (readies ffpic_tpu first)

@pytest.fixture(autouse=True)
def _native_first():
    jax_native.available()


def _img(w, h, seed=1):
    """``tests/test_avif.py:_test_img``."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 255, w)
    y = np.linspace(0, 255, h)
    g = (x[None, :] + y[:, None]) / 2
    img = np.stack([g, g[::-1], np.abs(g - 128) * 2], -1).astype(np.uint8)
    return img + rng.integers(0, 20, img.shape, dtype=np.uint8)


def _screen(w, h, seed):
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.uint8)
    cols = rng.integers(0, 256, (4, 3))
    for i in range(4):
        img[:, i * w // 4:(i + 1) * w // 4] = cols[i]
    img[h // 4:h // 3, w // 12:w - w // 4] = 255
    return img


def _pil(arr, mode=None, **kw) -> bytes:
    b = io.BytesIO()
    (Image.fromarray(arr, mode) if mode else Image.fromarray(arr)).save(
        b, "AVIF", **kw)
    return b.getvalue()


def _alpha_rgba(w, h):
    a = np.linspace(0, 255, h).astype(np.uint8)
    return np.dstack([_img(w, h), np.broadcast_to(a[:, None], (h, w))])


def _item(obus: bytes, w: int, h: int, bd: int = 8, extra=()) -> bytes:
    """A one-item AVIF around an OBU stream (av1C, ispe, nclx colr and
    any ``extra`` property boxes)."""
    flags = (0x40 if bd > 8 else 0) | (1 << 3) | (1 << 2)
    av1c = he._box("av1C", bytes([0x81, 0, flags, 0]))
    colr = he._box("colr", b"nclx" + struct.pack(">HHHB", 1, 13, 6, 0x80))
    props = [(av1c, True), (he._ispe(w, h), False), (colr, False),
             *[(b, True) for b in extra]]
    return he._assemble([(1, b"av01", obus, props)], [], 1, brand=b"avif",
                        compat=b"avifmif1miaf")


def _obus(data: bytes) -> bytes:
    s = heif.parse_structure(data)
    return heif.read_item(data, s, s["primary"])


def _grid(rows, cols, th, tw) -> bytes:
    """``tests/test_avif.py:_make_avif_grid`` with the port's
    ``heif_enc``."""
    img = _img(cols * tw, rows * th, seed=5)
    W, H = cols * tw, rows * th
    grid = bytes((0, 1, rows - 1, cols - 1)) + struct.pack(">II", W, H)
    colr = he._box("colr", b"nclx" + struct.pack(">HHHB", 1, 13, 6, 0x80))
    items = [(1, b"grid", grid, [(he._ispe(W, H), False)])]
    for k in range(rows * cols):
        r, c = divmod(k, cols)
        data = _pil(np.ascontiguousarray(
            img[r * th:(r + 1) * th, c * tw:(c + 1) * tw]), quality=70)
        s = heif.parse_structure(data)
        items.append((2 + k, b"av01", heif.read_item(data, s, s["primary"]),
                      [(he._box("av1C", s["items"][s["primary"]]
                                ["properties"]["av1C"]), True),
                       (he._ispe(tw, th), False), (colr, False)]))
    return he._assemble(items, [("dimg", 1, list(range(2, 2 + rows * cols)))],
                        1, brand=b"avif", compat=b"avifmif1miaf")


def _ten_bit() -> bytes:
    import aom_oracle
    rng = np.random.default_rng(6)
    h, w = 48, 64
    y = np.clip(np.linspace(0, 1023, w)[None, :] + rng.integers(0, 120, (h, w)),
                0, 1023).astype(np.uint16)
    u = rng.integers(0, 1023, (h // 2, w // 2)).astype(np.uint16)
    v = np.full((h // 2, w // 2), 700, np.uint16)
    return _item(aom_oracle.encode_frames([[y, u, v]], bit_depth=10,
                                          speed=6, q=40), w, h, bd=10)


def _rotated(angle: int, axis=None) -> bytes:
    obus = _obus(_pil(_img(72, 40, 9), quality=60))
    extra = [he._box("irot", bytes([angle // 90]))]
    if axis is not None:
        extra.append(he._box("imir", bytes([axis])))
    return _item(obus, 72, 40, extra=extra)


FILES = {
    "420": lambda: _pil(_img(120, 80), quality=60, subsampling="4:2:0"),
    "444": lambda: _pil(_img(120, 80), quality=85, subsampling="4:4:4"),
    "422": lambda: _pil(_img(120, 80), quality=70, subsampling="4:2:2"),
    "mono": lambda: _pil(_img(120, 80), quality=70, subsampling="4:0:0"),
    "odd_75x53": lambda: _pil(_img(75, 53, 3), quality=50),
    "tiles_128": lambda: _pil(_img(128, 128, 13), quality=60, tile_rows=1,
                              tile_cols=1),
    "sb128_128": lambda: _pil(_img(128, 128, 4), quality=60, speed=0),
    "palette_96x64": lambda: _pil(_screen(96, 64, 4), quality=60, speed=6),
    "lossless_32": lambda: _pil(
        np.random.default_rng(5).integers(0, 256, (32, 32, 3), np.uint8),
        quality=100, subsampling="4:4:4"),
    "alpha_96x64": lambda: _pil(_alpha_rgba(96, 64), "RGBA", quality=80),
    "alpha_444_odd": lambda: _pil(_alpha_rgba(57, 41), "RGBA", quality=70,
                                  subsampling="4:4:4"),
    "grid_2x2": lambda: _grid(2, 2, 48, 64),
    "grid_1x3_odd": lambda: _grid(1, 3, 40, 40),
    "10bit": _ten_bit,
    "irot_90": lambda: _rotated(90),
    "irot_270_imir_0": lambda: _rotated(270, 0),
    "irot_180_imir_1": lambda: _rotated(180, 1),
}


@functools.cache
def avif_file(name: str) -> bytes:
    return FILES[name]()


def _assert_same(data: bytes) -> np.ndarray:
    """``load`` of the port on the CPU equals the reference's: pixels,
    size, meta, ``info()`` and the header-only parse."""
    want = ffpic_tpu.load(data)
    got = ffpic_tpu_torch.load(data, device="cpu")
    assert got.codec == want.codec == "AVIF"
    assert (got.width, got.height, got.pitch) == \
        (want.width, want.height, want.pitch)
    assert isinstance(got.pixels, torch.Tensor)
    np.testing.assert_array_equal(got.pixels.numpy(), want.np_pixels())
    assert got.meta == want.meta
    assert ffpic_tpu_torch.info(got) == ffpic_tpu.info(want)
    head = ffpic_tpu_torch.load(data, skip_decode=True)
    assert head.pixels is None
    assert head.meta == ffpic_tpu.load(data, skip_decode=True).meta
    return got.pixels.numpy()


@pytest.mark.parametrize("name", sorted(FILES))
def test_load_matches_jax(name):
    px = _assert_same(avif_file(name))
    meta = ffpic_tpu_torch.load(avif_file(name), skip_decode=True).meta
    if name.startswith("alpha"):
        assert ffpic_tpu_torch.load(avif_file(name),
                                    device="cpu").meta["alpha"]
        assert (px[..., 3] < 255).any()
    if name.startswith("grid"):
        assert meta["grid"]["rows"] * meta["grid"]["cols"] in (3, 4)
    if name == "10bit":
        assert meta["sequence_header"]["bit_depth"] == 10
    if name.startswith("irot"):
        full = ffpic_tpu_torch.load(avif_file(name), device="cpu").meta
        assert full["rotation"] == int(name.split("_")[1])
        assert px.shape[:2] == ((72, 40) if full["rotation"] in (90, 270)
                                else (40, 72))


def test_decode_batch_matches_jax():
    """AVIF members, with and without a resize, among other formats:
    the port's batch equals ``ffpic_tpu.decode_batch``'s."""
    same = [avif_file(n) for n in ("420", "444", "422", "mono")]
    got = ffpic_tpu_torch.decode_batch(same, device="cpu")
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ffpic_tpu.decode_batch(same)))
    mixed = [avif_file(n) for n in ("alpha_96x64", "grid_2x2", "10bit",
                                    "irot_90")] + [testing.encode_png(
                                        _img(40, 30), 2, 8)]
    got = ffpic_tpu_torch.decode_batch(mixed, size=(32, 48), device="cpu")
    want = np.asarray(ffpic_tpu.decode_batch(mixed, size=(32, 48)))
    assert got.shape == want.shape == (5, 32, 48, 4)
    assert int(np.abs(got.numpy().astype(int) - want.astype(int)).max()) <= 1


@pytest.mark.parametrize("skip", [False, True])
def test_picinfo_prints_what_the_reference_prints(skip, tmp_path, capsys):
    paths = []
    for name in ("420", "alpha_96x64", "grid_2x2"):
        p = tmp_path / f"{name}.avif"
        p.write_bytes(avif_file(name))
        paths.append(str(p))
    flag = ["-s"] if skip else []
    rc = jax_picinfo.main(flag + paths)
    want = (rc, *capsys.readouterr())
    rc = picinfo.main(flag + ["--device", "cpu"] + paths)
    got = (rc, *capsys.readouterr())
    assert got == want and rc == 0
    assert "AVIF file format" in got[1]


def test_color_native_matches_numpy_oracle():
    """``av1_color_cicp`` equals ``_yuv_to_rgba_np`` across bit depths,
    matrices, ranges, subsamplings, monochrome and identity, odd sizes
    and cropped views (``tests/test_avif.py:
    test_avif_color_native_vs_numpy_oracle``); the port's ``_yuv_to_rgba``
    equals the JAX package's."""
    rng = np.random.default_rng(7)
    for bd in (8, 10, 12):
        dt = np.uint8 if bd == 8 else np.uint16
        mx = (1 << bd) - 1
        for sx, sy in ((0, 0), (1, 0), (1, 1)):
            for limited in (False, True):
                for mc in (1, 6, 9, 2):
                    h, w = 37, 53
                    ch, cw = (h + sy) >> sy, (w + sx) >> sx
                    planes = [rng.integers(0, mx + 1, s).astype(dt)
                              for s in ((h, w), (ch, cw), (ch, cw))]
                    meta = dict(bit_depth=bd, mono=False, subsampling=(sx, sy),
                                matrix_coefficients=mc,
                                color_range=0 if limited else 1)
                    a = avif._yuv_to_rgba_np(planes, meta, None)
                    kr, kb = avif._CICP_KR_KB.get(mc, (0.299, 0.114))
                    b = native.av1_color_cicp(planes, h, w, sx, sy, bd,
                                              limited, mode=0, kr=kr, kb=kb)
                    np.testing.assert_array_equal(a, b, err_msg=str(
                        (bd, sx, sy, limited, mc)))
                    np.testing.assert_array_equal(
                        avif._yuv_to_rgba(planes, meta, None),
                        jax_avif._yuv_to_rgba(planes, meta, None))
        y = rng.integers(0, mx + 1, (64, 64)).astype(dt)[:41, :29]
        for limited in (False, True):
            meta = dict(bit_depth=bd, mono=True, subsampling=(0, 0),
                        matrix_coefficients=6, color_range=0 if limited else 1)
            np.testing.assert_array_equal(
                avif._yuv_to_rgba_np([y], meta, None),
                native.av1_color_cicp([y], 41, 29, 0, 0, bd, limited, mode=2))
        gbr = [rng.integers(0, mx + 1, (41, 29)).astype(dt) for _ in range(3)]
        meta = dict(bit_depth=bd, mono=False, subsampling=(0, 0),
                    matrix_coefficients=0, color_range=1)
        np.testing.assert_array_equal(
            avif._yuv_to_rgba_np(gbr, meta, None),
            native.av1_color_cicp(gbr, 41, 29, 0, 0, bd, False, mode=1))


def _outcome(fn):
    try:
        return fn()
    except Exception as e:          # the kind of error is compared
        return type(e)


@pytest.mark.parametrize("cut", [0.25, 0.5, 0.75, 0.97])
def test_truncated_file_gives_the_references_result(cut):
    """A file cut short: the reference's pixels, or its kind of error,
    through ``load`` and ``decode_batch``
    (``tests/test_avif.py:test_avif_truncated``)."""
    full = avif_file("alpha_96x64")
    data = full[:int(len(full) * cut)]
    want = _outcome(lambda: ffpic_tpu.load(data).np_pixels())
    got = _outcome(lambda: ffpic_tpu_torch.load(data, device="cpu")
                   .pixels.numpy())
    if isinstance(want, type):
        assert got is want
        assert _outcome(lambda: ffpic_tpu_torch.decode_batch(
            [data], device="cpu")) is _outcome(
                lambda: ffpic_tpu.decode_batch([data]))
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tail", [b"\x00" * 64, bytes(range(256)) * 2])
def test_garbage_gives_the_references_error(tail):
    """``tests/test_avif.py:test_avif_garbage``: ftyp avif and nothing
    decodable."""
    data = b"\x00" * 11 + b"ftypavif" + tail
    want = _outcome(lambda: jax_avif.load(data))
    got = _outcome(lambda: avif.decode(data, device=None))
    assert isinstance(want, type) and got is want
    assert _outcome(lambda: ffpic_tpu_torch.load(data, device="cpu")) is \
        _outcome(lambda: ffpic_tpu.load(data))


def test_corrupt_tile_data_gives_the_references_result():
    """Flipped bytes inside the coded tiles: the same pixels or the same
    kind of error as the reference."""
    data = bytearray(avif_file("420"))
    rng = np.random.default_rng(3)
    for _ in range(4):
        k = int(rng.integers(len(data) // 2, len(data)))
        data[k] ^= 0x5A
    data = bytes(data)
    want = _outcome(lambda: ffpic_tpu.load(data).np_pixels())
    got = _outcome(lambda: ffpic_tpu_torch.load(data, device="cpu")
                   .pixels.numpy())
    if isinstance(want, type):
        assert got is want
    else:
        np.testing.assert_array_equal(got, want)


def test_animated_avif_raises_naming_the_item():
    """An ``av01`` track: the port decodes its frames in place of the
    cover, as the reference does, in ``load`` (the first frame, the
    others on ``frames``), ``load_all`` and ``decode_batch`` (the first
    frame), equal to the reference's; its header-only parse is the
    reference's."""
    data = testing.avif_fixture("avis_track_64x48.avif")
    want = ffpic_tpu.load_all(data)
    got = ffpic_tpu_torch.load_all(data, device="cpu")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.pixels.numpy(), w.np_pixels())
        assert (g.delay_ms, g.meta) == (w.delay_ms, w.meta)
    one = ffpic_tpu_torch.load(data, device="cpu")
    assert len(one.frames) == 2 and one.meta["frames"] == 3
    for size in (None, (8, 8)):
        np.testing.assert_array_equal(
            ffpic_tpu_torch.decode_batch([data], size=size,
                                         device="cpu").numpy(),
            np.asarray(ffpic_tpu.decode_batch([data], size=size)))
    assert ffpic_tpu_torch.load(data, skip_decode=True).meta == \
        ffpic_tpu.load(data, skip_decode=True).meta


def test_encode_raises_naming_the_item():
    """``encode(pic, "AVIF")`` (the registry's entry and ``avif.encode``)
    gives the reference's bytes, lossless (q100) and lossy (q75)."""
    pic = ffpic_tpu_torch.load(avif_file("420"), device="cpu")
    want = ffpic_tpu.encode(ffpic_tpu.load(avif_file("420")), "AVIF")
    assert ffpic_tpu_torch.encode(pic, "AVIF", device="cpu") == want
    zeros = np.zeros((8, 8, 4), np.uint8)
    assert avif.encode(Pic(pixels=zeros, width=8, height=8),
                       quality=100) == \
        ffpic_tpu.encode(JaxPic(pixels=zeros, width=8, height=8), "AVIF",
                         quality=100)
    assert want[4:12] == b"ftypavif"


def test_grid_tiles_decode_side_by_side(monkeypatch):
    """A grid's tiles go through ``heif._grid_workers`` threads (the C
    runs with the GIL released); one worker gives the same pixels."""
    data = avif_file("grid_2x2")
    many = ffpic_tpu_torch.load(data, device="cpu").pixels.numpy()
    monkeypatch.setenv("FFPIC_THREADS", "1")
    np.testing.assert_array_equal(
        ffpic_tpu_torch.load(data, device="cpu").pixels.numpy(), many)


@pytest.mark.parametrize("name", [n for n in testing.avif_manifest()
                                  if n.endswith(".avif")])
def test_fixture_hashes(name):
    """The committed fixtures (``make_avif_fixtures``): the file's
    sha256, and the pixels' sha256 from both packages, as recorded: for
    the stills from ``load``, for the animations each frame's from
    ``load_all`` with its ``delay_ms``.  The 1080p animation is not
    decoded here (about a minute a package): ``chip_smoke.py`` holds the
    port's frames to its hashes; here its header-only parse."""
    ent = testing.avif_manifest()[name]
    data = testing.avif_fixture(name)
    assert hashlib.sha256(data).hexdigest() == ent["sha256"]
    if "frames" in ent:
        if name == "avis_1080p_grain.avif":
            assert [f["shape"] for f in ent["frames"]] == [[1080, 1920, 4]] * 3
            assert ffpic_tpu_torch.load(data, skip_decode=True).meta == \
                ffpic_tpu.load(data, skip_decode=True).meta
            return
        for pics in (ffpic_tpu_torch.load_all(data, device="cpu"),
                     ffpic_tpu.load_all(data)):
            got = [dict(shape=list(p.np_pixels().shape),
                        pixels_sha256=hashlib.sha256(np.ascontiguousarray(
                            p.np_pixels())).hexdigest(),
                        delay_ms=p.delay_ms) for p in pics]
            assert got == ent["frames"]
        return
    for px in (ffpic_tpu_torch.load(data, device="cpu").pixels.numpy(),
               ffpic_tpu.load(data).np_pixels()):
        assert list(px.shape) == ent["shape"]
        assert hashlib.sha256(np.ascontiguousarray(px)).hexdigest() == \
            ent["pixels_sha256"]
