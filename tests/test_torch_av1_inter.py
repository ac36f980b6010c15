"""The port's AV1 inter slice (``coding/av1_inter.py``, ``formats/av1_mc.py``,
``TileDecoder._decode_block_interframe``, ``av1_recon._recon_inter_block``
and ``Av1Decoder``) and its animated AVIF held against ffpic_tpu's on the
same streams, on the CPU, with tolerance 0: both run the same Python and
numpy.

Streams are the committed fixtures of ``make_avif_fixtures``: PIL/libaom
animations of 64x48 to 176x128 (film grain on two, 4:4:4 on one; libaom
picks OBMC and local warp in them and turns CDEF on) and two raw libaom
streams at its default lag (hidden frames, ``show_existing_frame``,
compound blocks), one of them 10-bit.  For each: every shown frame's
planes and meta from ``Av1Decoder.decode_obus`` fed sample by sample,
and ``load_all``'s frames (pixels, ``delay_ms``, meta, orientation) equal
the JAX package's, and the raw streams' planes hash as recorded.  Also:
the motion-compensation building blocks on seeded inputs (the subpel
filters, the masks, warp estimation and the affine warp), the filters
off, and the spans the inter path adds (``av1.mc``, ``av1.grain``).
"""

import functools
import hashlib

import numpy as np
import pytest

import ffpic_tpu
import ffpic_tpu_torch
from ffpic_tpu import native as jax_native
from ffpic_tpu.formats import av1_mc as jax_mc
from ffpic_tpu.formats import av1_recon as jax_recon
from ffpic_tpu.formats import basemedia as jax_bm
from ffpic_tpu_torch import testing
from ffpic_tpu_torch.formats import av1_mc, av1_recon
from ffpic_tpu_torch.make_avif_fixtures import SMALL_TRACKS, STREAMS, TRACK
from ffpic_tpu_torch.utils import trace
import reference_native  # noqa: F401  (readies ffpic_tpu first)

TRACKS = (TRACK,) + SMALL_TRACKS


@pytest.fixture(autouse=True)
def _native_first():
    jax_native.available()


def _samples(data: bytes) -> list:
    """The ``av01`` track's av1C config OBUs and each sample's bytes,
    from the JAX package's container walk."""
    boxes = jax_bm.parse_boxes(data, 0, len(data))
    tr = jax_bm.track_samples(data, boxes, "av01")
    es = tr["entry_start"]
    av1c = jax_bm.find_box(jax_bm.parse_boxes(data, es + 86,
                                              es + tr["entry_size"]), "av1C")
    cfg = data[av1c.start + 4:av1c.start + av1c.size]
    return [cfg] + [data[o:o + n] for o, n in tr["samples"]]


def _assert_frames(got: list, want: list) -> None:
    assert len(got) == len(want) > 0
    for (gp, gm), (wp, wm) in zip(got, want):
        assert gm == wm
        assert len(gp) == len(wp)
        for a, b in zip(gp, wp):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@functools.cache
def _decoded(name: str):
    """Both packages' shown frames of a committed stream, fed sample by
    sample (an animation) or whole (a raw stream)."""
    data = testing.avif_fixture(name)
    parts = [data] if name in STREAMS else _samples(data)
    out = []
    for dec in (av1_recon.Av1Decoder(), jax_recon.Av1Decoder()):
        out.append([f for p in parts for f in dec.decode_obus(p)])
    return out


@pytest.mark.parametrize("name", TRACKS + STREAMS)
def test_decoder_matches_jax_sample_by_sample(name):
    got, want = _decoded(name)
    _assert_frames(got, want)
    if name in STREAMS:
        ent = testing.avif_manifest()[name]
        assert [{"planes_sha256": hashlib.sha256(b"".join(
            np.ascontiguousarray(p).tobytes() for p in planes)).hexdigest()}
            for planes, _ in got] == ent["frames"]


def test_raw_streams_cover_the_inter_tools():
    """The 10-bit stream decodes to 16-bit planes of six frames, one of
    them shown from a reference slot (``show_existing_frame``)."""
    got, _ = _decoded("av1_10bit_64x48.obu")
    assert len(got) == 6
    assert all(p.dtype == np.uint16 for planes, _ in got for p in planes)
    assert all(m["bit_depth"] == 10 for _, m in got)


@pytest.mark.parametrize("name", TRACKS)
def test_load_all_matches_jax(name):
    """``load_all``: the track's frames replace the cover, with the
    reference's pixels, ``delay_ms`` and meta (``frames`` on the first)."""
    data = testing.avif_fixture(name)
    want = ffpic_tpu.load_all(data)
    got = ffpic_tpu_torch.load_all(data, device="cpu")
    assert len(got) == len(want) == got[0].meta["frames"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.pixels.numpy(), w.np_pixels())
        assert (g.width, g.height, g.delay_ms, g.meta) == \
            (w.width, w.height, w.delay_ms, w.meta)
    assert got[0].frames == got[1:]


def _oriented(name: str, angle: int, axis=None) -> bytes:
    """The committed animation ``name`` with ``irot`` (and ``imir``) on
    its cover item: the cover (its ``av01`` item, ``av1C``, ``ispe`` and
    the transforms) assembled by the port's ``heif_enc``, then the
    animation's ``moov`` with every chunk offset moved past the new
    prefix, then an ``mdat`` that holds the animation's bytes."""
    import struct
    from ffpic_tpu_torch.formats import basemedia as bm
    from ffpic_tpu_torch.formats import heif
    from ffpic_tpu_torch.formats import heif_enc as he
    data = testing.avif_fixture(name)
    s = heif.parse_structure(data)
    pid = s["primary"]
    props = s["items"][pid]["properties"]
    extra = [he._box("irot", bytes([angle // 90]))]
    if axis is not None:
        extra.append(he._box("imir", bytes([axis])))
    cover = he._assemble(
        [(1, b"av01", heif.read_item(data, s, pid),
          [(he._box("av1C", props["av1C"]), True),
           (he._ispe(props["width"], props["height"]), False),
           *[(b, True) for b in extra]])], [], 1, brand=b"avis",
        compat=b"avifavismif1miaf")
    moov = bm.find_box(bm.parse_boxes(data, 0, len(data)), "moov")
    box = bytearray(data[moov.start - 8:moov.start + moov.size])
    shift = len(cover) + len(box) + 8
    stco = bm.find_box(moov.children, "trak/mdia/minf/stbl/stco")
    at = stco.start - (moov.start - 8) + 4
    for k in range(struct.unpack_from(">I", box, at)[0]):
        off = at + 4 + 4 * k
        struct.pack_into(">I", box, off,
                         struct.unpack_from(">I", box, off)[0] + shift)
    return cover + bytes(box) + struct.pack(">I", len(data) + 8) + b"mdat" \
        + data


@functools.cache
def _unturned(name: str) -> list:
    return [p.pixels.numpy() for p in ffpic_tpu_torch.load_all(
        testing.avif_fixture(name), device="cpu")]


@pytest.mark.parametrize("angle,axis", [(90, None), (270, 0), (180, 1)])
def test_orientation_applies_to_every_frame(angle, axis):
    """The cover item's ``irot``/``imir`` turn every track frame, as in
    the reference: the frames' pixels, sizes and meta equal the JAX
    package's, and each is its unturned frame turned."""
    data = _oriented("avis_96x64_grain.avif", angle, axis)
    want = ffpic_tpu.load_all(data)
    got = ffpic_tpu_torch.load_all(data, device="cpu")
    plain = _unturned("avis_96x64_grain.avif")
    assert len(got) == len(want) == len(plain) == 3
    assert got[0].meta["rotation"] == angle
    assert got[0].meta.get("mirror") == axis
    for g, w, p in zip(got, want, plain):
        np.testing.assert_array_equal(g.pixels.numpy(), w.np_pixels())
        assert (g.width, g.height, g.delay_ms, g.meta) == \
            (w.width, w.height, w.delay_ms, w.meta)
        turned = np.rot90(p, angle // 90)
        if axis is not None:
            turned = np.fliplr(turned) if axis == 0 else np.flipud(turned)
        np.testing.assert_array_equal(g.pixels.numpy(), turned)


def test_filters_off_match_jax():
    """``decode_obus(apply_filters=False)``: the reconstruction before
    deblocking, CDEF and restoration."""
    data = testing.avif_fixture("avis_176x128.avif")
    got, want = [], []
    for dec, out in ((av1_recon.Av1Decoder(), got),
                     (jax_recon.Av1Decoder(), want)):
        for p in _samples(data):
            out += dec.decode_obus(p, apply_filters=False)
    _assert_frames(got, want)
    filtered, _ = _decoded("avis_176x128.avif")
    assert any(not np.array_equal(a[0], b[0])
               for (a, _), (b, _) in zip(got, filtered))


def test_spans_of_the_inter_path():
    """``av1.mc`` (inside ``av1.recon``) and ``av1.grain`` are spans of an
    animated load with film grain, beside the decoder's others."""
    data = testing.avif_fixture("avis_96x64_grain.avif")
    trace.reset()
    trace.enable()
    try:
        ffpic_tpu_torch.load_all(data, device="cpu")
    finally:
        trace.enable(False)
    rep = trace.report()
    trace.reset()
    for name in ("av1.headers", "av1.parse", "av1.recon", "av1.mc",
                 "av1.deblock", "av1.cdef", "av1.grain", "avif.color"):
        assert rep.get(name, {}).get("count", 0) > 0, name
    assert rep["av1.grain"]["count"] == 3
    assert rep["av1.mc"]["total"] <= rep["av1.recon"]["total"]


# --- the motion-compensation building blocks on seeded inputs ---------------

@pytest.mark.parametrize("bd,compound", [(8, False), (8, True), (10, False),
                                         (12, True)])
def test_mc_translation_matches_jax(bd, compound):
    rng = np.random.default_rng(bd + compound)
    ref = rng.integers(0, 1 << bd, (40, 56)).astype(np.int32)
    for interp in range(4):
        for mv in ((0, 0), (5, -3), (-13, 22), (31, 31)):
            args = (ref, 9, 7, 16, 8, mv, 0, 0, (interp, interp), bd,
                    compound)
            np.testing.assert_array_equal(av1_mc.mc_translation(*args),
                                          jax_mc.mc_translation(*args))


@pytest.mark.parametrize("bsize", [3, 6, 9, 12])
def test_masks_match_jax(bsize):
    """Wedge masks of every index and sign, difference-weighted masks
    of both types, and the interintra masks of every mode."""
    from ffpic_tpu_torch.coding import av1_consts as C
    rng = np.random.default_rng(bsize)
    w, h = C.BLOCK_W4[bsize] * 4, C.BLOCK_H4[bsize] * 4
    for idx in range(16):
        for sign in (0, 1):
            np.testing.assert_array_equal(
                av1_mc.wedge_mask(bsize, idx, sign),
                jax_mc.wedge_mask(bsize, idx, sign))
    p0 = rng.integers(0, 1 << 14, (h, w)).astype(np.int32)
    p1 = rng.integers(0, 1 << 14, (h, w)).astype(np.int32)
    for mask_type in (0, 1):
        for bd in (8, 10):
            np.testing.assert_array_equal(
                av1_mc.diffwtd_mask(p0, p1, mask_type, bd),
                jax_mc.diffwtd_mask(p0, p1, mask_type, bd))
    for mode in range(4):
        np.testing.assert_array_equal(av1_mc.interintra_mask(w, h, mode),
                                      jax_mc.interintra_mask(w, h, mode))


def test_warp_matches_jax():
    """Least-squares warp estimation of seeded sample sets, the shear
    setup and the affine warp of a block at 8 and 10 bits."""
    rng = np.random.default_rng(3)
    fits = 0
    for _ in range(40):
        mi_row, mi_col = rng.integers(2, 12, 2).tolist()
        bsize = int(rng.choice([3, 6, 9]))
        mv = tuple(rng.integers(-40, 40, 2).tolist())
        samples = []
        for _ in range(int(rng.integers(1, 8))):
            sy, sx = rng.integers(0, 200, 2).tolist()
            dy, dx = rng.integers(-12, 12, 2).tolist()
            samples.append((sy, sx, sy + mv[0] + dy, sx + mv[1] + dx))
        got = av1_mc.warp_estimation(samples, mi_row, mi_col, bsize, mv)
        assert got == jax_mc.warp_estimation(samples, mi_row, mi_col,
                                             bsize, mv)
        ok, mat = got
        if not ok:
            continue
        shear = av1_mc.setup_shear(mat)
        assert shear == jax_mc.setup_shear(mat)
        if not shear[0]:
            continue
        fits += 1
        for bd in (8, 10):
            ref = rng.integers(0, 1 << bd, (64, 80)).astype(np.int32)
            for sx, sy in ((0, 0), (1, 1)):
                args = (ref, mat, shear, 16, 8, 16, 16, sx, sy, bd, False)
                np.testing.assert_array_equal(av1_mc.warp_affine(*args),
                                              jax_mc.warp_affine(*args))
    assert fits > 0
