"""The HEVC inter slice of ffpic_tpu_torch held against ffpic_tpu, and
against libde265, on the CPU: ``SequenceDecoder`` on the ten x265
configurations of ``tests/test_hevc_inter_decode.py:84-117`` (planes,
POC order and motion fields), under ``FFPIC_HEVC_DEVICE`` too (the
plain version of the ``hevc_residuals`` kernel, once a picture; one
stream with scaling lists, which both packages' device route leaves
out), ``hevc_mc``'s interpolation and weighted prediction and
``compute_bs`` on seeded inputs, raw ``.265`` streams through the
registry (``probe``, ``load``, ``skip_decode``, ``info``,
``decode_batch``, ``picinfo``), HEIF image sequences (the encoder's
bytes, an x265 P/B stream in a ``moov/trak``, under the four
combinations of ``FFPIC_HEVC_DEVICE`` and ``FFPIC_HEIF_DEVICE_COLOR``),
the reference faults the port mirrors (ROADMAP Queue 3), and the
committed 1080p fixtures' digests.  Streams come from libx265 through
``make_hevc_fixtures`` at 176x144 or less.
"""

import functools
import hashlib
import json
import os
import types

import numpy as np
import pytest

import ffpic_tpu
import ffpic_tpu_torch as ft
from ffpic_tpu import native as jax_native
from ffpic_tpu import pipeline as jax_pipeline
from ffpic_tpu.apps import picinfo as jax_picinfo
from ffpic_tpu.coding import hevc_inter as jax_inter
from ffpic_tpu.formats import heif_enc as jax_heif_enc
from ffpic_tpu.formats import hevc as jax_hevc
from ffpic_tpu.formats import hevc_mc as jax_mc
from ffpic_tpu.formats import hevc_recon as jax_recon
from ffpic_tpu.formats import registry as jax_registry
from ffpic_tpu.formats.pic import Pic as JaxPic
from ffpic_tpu_torch import make_hevc_fixtures as fx
from ffpic_tpu_torch import testing
from ffpic_tpu_torch.apps import picinfo
from ffpic_tpu_torch.coding import hevc_inter
from ffpic_tpu_torch.formats import heif_enc, hevc, hevc_mc, hevc_raw
from ffpic_tpu_torch.formats import hevc_recon
from ffpic_tpu_torch.ops import hevc_kernels
import reference_native  # noqa: F401  (readies ffpic_tpu first)

needs_x265 = pytest.mark.skipif(not fx.have_libraries(),
                                reason="libx265/libde265 unavailable")
BASE, ALL = fx.BASE, fx.ALL
# tests/test_hevc_inter_decode.py:84-117
CONFIGS = {
    "p-minimal": (4, 64, 64, dict(gop=8, bframes=0, qp=32, extra=BASE)),
    "p-all-tools": (6, 96, 96, dict(gop=8, bframes=0, qp=30, extra=ALL)),
    "b-pyramid-all": (8, 96, 96, dict(gop=8, bframes=3, qp=30, extra=ALL)),
    "weighted-bipred": (6, 96, 96, dict(gop=8, bframes=2, qp=32, extra={
        **ALL, "weightp": 1, "weightb": 1})),
    "rect-amp": (6, 96, 96, dict(gop=8, bframes=2, qp=28, extra={
        **ALL, "rect": 1, "amp": 1})),
    "multi-gop-idr": (12, 96, 96, dict(gop=4, bframes=2, qp=32, extra=ALL)),
    "odd-dims": (5, 68, 100, dict(gop=8, bframes=2, qp=30, extra=ALL)),
    "ctu16-aq-deltaqp": (5, 96, 96, dict(gop=8, bframes=2, qp=30, extra={
        **ALL, "ctu": 16, "crf": 28, "aq-mode": 2})),
    "tskip-lossless": (5, 96, 96, dict(gop=8, bframes=2, qp=30, extra={
        **ALL, "tskip": 1, "cu-lossless": 1})),
    "two-slices": (4, 144, 176, dict(gop=8, bframes=2, qp=32, extra={
        **BASE, "temporal-mvp": 1, "max-merge": 5, "ref": 3, "slices": 2,
        "no-deblock": 0})),
    # beyond the JAX test's matrix: scaling lists, which the device
    # route leaves out in both packages
    "scaling-lists": (4, 64, 64, dict(gop=8, bframes=2, qp=30, extra={
        **ALL, "scaling-list": "default"})),
    # an open GOP: a CRA every 4 pictures with RASL pictures before it
    "open-gop": (9, 64, 64, dict(gop=4, bframes=2, qp=32, extra={
        **ALL, "open-gop": 1})),
}
JAX_TEN = list(CONFIGS)[:10]
ENV = ("FFPIC_HEVC_DEVICE", "FFPIC_HEIF_DEVICE_COLOR",
       "FFPIC_NO_NATIVE_RECON", "FFPIC_NO_NATIVE")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    jax_native.available()
    for k in ENV:
        monkeypatch.delenv(k, raising=False)


@functools.cache
def _stream(label: str) -> bytes:
    n, h, w, kw = CONFIGS[label]
    return fx.x265_encode(fx.frames(n, h, w), **kw)


def _display_order(pics):
    groups = []
    for p in pics:
        if p.poc == 0 or not groups:
            groups.append([])
        groups[-1].append(p)
    return [p for g in groups for p in sorted(g, key=lambda q: q.poc)]


@functools.cache
def _jax_pictures(label: str, device: bool = False):
    """The JAX package's pictures of a stream in display order (with
    ``FFPIC_HEVC_DEVICE`` set around the decode when ``device``)."""
    old = os.environ.pop("FFPIC_HEVC_DEVICE", None)
    if device:
        os.environ["FFPIC_HEVC_DEVICE"] = "1"
    try:
        return _display_order(jax_hevc.SequenceDecoder().decode_annexb(
            _stream(label)))
    finally:
        os.environ.pop("FFPIC_HEVC_DEVICE", None)
        if old is not None:
            os.environ["FFPIC_HEVC_DEVICE"] = old


def _assert_same_pictures(got, want):
    assert [p.poc for p in got] == [p.poc for p in want]
    for g, w in zip(got, want):
        for a, b in zip(g.planes, w.planes):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(g.motion.mv, w.motion.mv)
        np.testing.assert_array_equal(g.motion.refpoc, w.motion.refpoc)


def _assert_de265(pics, stream):
    ref = fx.de265_decode(stream)
    assert len(pics) == len(ref)
    for p, rp in zip(pics, ref):
        for c, plane in enumerate(rp):
            h, w = plane.shape
            np.testing.assert_array_equal(p.planes[c][:h, :w],
                                          plane.astype(np.int64))


@needs_x265
@pytest.mark.parametrize("label", JAX_TEN)
def test_sequence_decoder_matches_jax_and_de265(label):
    stream = _stream(label)
    got = _display_order(hevc.SequenceDecoder("cpu").decode_annexb(stream))
    _assert_same_pictures(got, _jax_pictures(label))
    _assert_de265(got, stream)
    n = CONFIGS[label][0]
    assert len(got) == n and sum(p.poc != 0 for p in got) >= n // 2
    inter = [p for p in got if p.poc != 0]
    assert any((p.motion.refpoc[0] != hevc_inter.NO_REF).any()
               for p in inter)


@needs_x265
@pytest.mark.parametrize("label", ["p-all-tools", "weighted-bipred",
                                   "two-slices", "scaling-lists"])
def test_device_residuals_match_jax(label, monkeypatch):
    """``FFPIC_HEVC_DEVICE``: every picture's TUs through the plain
    version of K14 in one call (``residuals_packed``, reached from the
    native intra routes and from ``execute_ops``; none for a picture
    without a TU), the inter residual
    adds still on the host; both packages give the same bytes, which
    differ from the host route's where the stream has scaling lists."""
    calls, tus = [], []          # K14 calls and TUs of each picture
    real = (hevc_kernels.residuals_packed, hevc_recon.execute_ops,
            hevc.decode_picture)

    def spy(*a, **kw):
        calls[-1] += 1
        return real[0](*a, **kw)

    def ops_spy(pic, ops, device=None):
        tus[-1] += sum(getattr(op, "tu", None) is not None for op in ops)
        return real[1](pic, ops, device)

    def picture(*a, **kw):
        calls.append(0)
        tus.append(0)
        return real[2](*a, **kw)
    monkeypatch.setattr(hevc_kernels, "residuals_packed", spy)
    monkeypatch.setattr(hevc_recon, "execute_ops", ops_spy)
    monkeypatch.setattr(hevc, "decode_picture", picture)
    monkeypatch.setenv("FFPIC_HEVC_DEVICE", "1")
    got = _display_order(hevc.SequenceDecoder("cpu").decode_annexb(
        _stream(label)))
    _assert_same_pictures(got, _jax_pictures(label, device=True))
    # one call a picture; none where a P/B picture has no TU at all
    assert len(calls) == len(got) and sum(calls) >= len(got) - 1
    assert all(c == 1 or (c == 0 and t == 0) for c, t in zip(calls, tus))
    host = _jax_pictures(label)
    differs = sum(int((a != b).sum()) for g, w in zip(got, host)
                  for a, b in zip(g.planes, w.planes))
    assert (differs > 0) == (label == "scaling-lists")


def test_device_route_needs_cuda_without_a_device(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("FFPIC_HEVC_DEVICE", "1")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hevc.SequenceDecoder().decode_annexb(_stream("p-minimal"))


# --- motion compensation and boundary strengths ------------------------------

@pytest.mark.parametrize("bd", [8, 10])
def test_interpolation_matches_jax(bd):
    rng = np.random.default_rng(bd)
    plane = rng.integers(0, 1 << bd, (40, 56)).astype(np.int64)
    for _ in range(60):
        w, h = (int(v) for v in rng.choice([4, 8, 12, 16], 2))
        x0, y0 = int(rng.integers(-8, 56)), int(rng.integers(-8, 40))
        mv = (int(rng.integers(-80, 80)), int(rng.integers(-80, 80)))
        a = hevc_mc.pred14_luma(plane, x0, y0, w, h, mv, bd)
        np.testing.assert_array_equal(
            a, jax_mc.pred14_luma(plane, x0, y0, w, h, mv, bd))
        c = hevc_mc.pred14_chroma(plane, x0 // 2, y0 // 2, w // 2, h // 2,
                                  mv, bd)
        np.testing.assert_array_equal(c, jax_mc.pred14_chroma(
            plane, x0 // 2, y0 // 2, w // 2, h // 2, mv, bd))
    # every fractional phase of both filters
    for fx_, fy_ in np.ndindex(8, 8):
        mv = (16 + fx_, -8 + fy_)
        np.testing.assert_array_equal(
            hevc_mc.pred14_chroma(plane, 5, 3, 4, 4, mv, bd),
            jax_mc.pred14_chroma(plane, 5, 3, 4, 4, mv, bd))
        if fx_ < 4 and fy_ < 4:
            np.testing.assert_array_equal(
                hevc_mc.pred14_luma(plane, 5, 3, 8, 8, mv, bd),
                jax_mc.pred14_luma(plane, 5, 3, 8, 8, mv, bd))


@pytest.mark.parametrize("bd", [8, 10])
def test_weighted_prediction_matches_jax(bd):
    rng = np.random.default_rng(100 + bd)
    p0, p1 = (rng.integers(-(1 << 13), 1 << 14, (8, 8)) for _ in range(2))
    cases = [(p0, None, None, None, None), (None, p1, None, None, None),
             (p0, p1, None, None, None)]
    for log2wd in range(0, 8):
        for _ in range(4):
            wp0 = (int(rng.integers(-128, 128)), int(rng.integers(-128, 128)))
            wp1 = (int(rng.integers(-128, 128)), int(rng.integers(-128, 128)))
            cases += [(p0, None, wp0, None, log2wd),
                      (None, p1, None, wp1, log2wd),
                      (p0, p1, wp0, wp1, log2wd), (p0, p1, wp0, None, log2wd),
                      (p0, p1, None, wp1, log2wd)]
    for a, b, w0, w1, lwd in cases:
        np.testing.assert_array_equal(
            hevc_mc.combine(a, b, bd, w0, w1, lwd),
            jax_mc.combine(a, b, bd, w0, w1, lwd))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compute_bs_matches_jax(seed):
    """Boundary strengths from random edges, intra and nonzero maps and a
    motion field whose POCs and vectors collide often (uni/uni, bi/bi,
    the same picture in both lists, vectors a quarter-sample apart)."""
    rng = np.random.default_rng(seed)
    h, w = 36 + 4 * seed, 52 - 4 * seed

    def pic():
        return types.SimpleNamespace(
            v_edges=rng.random((h, (w + 7) // 8)) < 0.4,
            h_edges=rng.random(((h + 7) // 8, w)) < 0.4,
            pu_v_edges=rng.random((h, (w + 7) // 8)) < 0.4,
            pu_h_edges=rng.random(((h + 7) // 8, w)) < 0.4)
    a = pic()
    b = types.SimpleNamespace(**vars(a))
    mh, mw = (h + 3) // 4, (w + 3) // 4
    intra = rng.random((mh, mw)) < 0.2
    nonzero = rng.random((mh, mw)) < 0.3
    fld = hevc_inter.MotionField(w, h)
    fld.refpoc[:] = rng.choice([hevc_inter.NO_REF, 0, 4, 8], (2, mh, mw),
                               p=[0.3, 0.3, 0.2, 0.2])
    fld.mv[:] = rng.integers(-6, 7, (2, mh, mw, 2))
    jfld = jax_inter.MotionField(w, h)
    jfld.refpoc[:], jfld.mv[:] = fld.refpoc, fld.mv
    hevc_recon.compute_bs(a, fld, intra, nonzero)
    jax_recon.compute_bs(b, jfld, intra, nonzero)
    np.testing.assert_array_equal(a.bs_v, b.bs_v)
    np.testing.assert_array_equal(a.bs_h, b.bs_h)
    assert {0, 1, 2} <= set(np.unique(a.bs_v)) | set(np.unique(a.bs_h))


# --- raw .265 streams ---------------------------------------------------------

@needs_x265
def test_raw_stream_through_the_registry(tmp_path):
    stream = _stream("rect-amp")
    path = tmp_path / "a.265"
    path.write_bytes(stream)
    assert ft.probe(stream).name == ffpic_tpu.probe(stream).name == "HEVC"
    assert hevc_raw.probe(stream) and not hevc_raw.probe(b"\0\0\1" + bytes(4))
    pics = ft.load_all(str(path), device="cpu")
    want = jax_registry.load_all(str(path))
    assert len(pics) == len(want) == 6
    for g, w in zip(pics, want):
        assert (g.width, g.height, g.codec, g.delay_ms) == \
            (w.width, w.height, w.codec, w.delay_ms) == (96, 96, "HEVC", 40)
        np.testing.assert_array_equal(g.np_pixels(), np.asarray(w.pixels))
        assert repr(g.meta) == repr(w.meta)
    assert ft.info(pics[0]) == ffpic_tpu.info(want[0])
    head = ft.load(str(path), skip_decode=True)
    jhead = ffpic_tpu.load(str(path), skip_decode=True)
    assert repr(head.meta) == repr(jhead.meta)
    assert head.meta["access_units"] == 6 and head.pixels is None
    assert ft.info(head) == ffpic_tpu.info(jhead)


@needs_x265
def test_raw_stream_in_decode_batch(monkeypatch):
    """A ``.265`` member gives its first picture in display order, as the
    reference's decode_batch does; beside a HEIF sequence, and under ``FFPIC_HEIF_DEVICE_COLOR`` (K15's plain version a picture)."""
    seq = fx.heif_sequence(_primary(96, 96), _stream("p-all-tools"))
    batch = [_stream("rect-amp"), seq, _stream("p-all-tools")]
    want = np.asarray(jax_pipeline.decode_batch(batch))
    got = ft.decode_batch(batch, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ft.decode_batch([_stream("rect-amp")], device="cpu")[0].numpy(),
        np.asarray(ffpic_tpu.load(_stream("rect-amp")).pixels))
    monkeypatch.setenv("FFPIC_HEIF_DEVICE_COLOR", "1")
    calls = []
    real = hevc_kernels.hevc_tiles_to_rgba

    def spy(st, mode="bt601"):
        calls.append(mode)
        return real(st, mode)
    monkeypatch.setattr(hevc_kernels, "hevc_tiles_to_rgba", spy)
    testing.assert_equal_up_to_contraction(
        lambda: ft.decode_batch([_stream("rect-amp")], device="cpu")[0],
        np.asarray(ffpic_tpu.load(_stream("rect-amp")).pixels))
    assert calls[:6] == ["bt601"] * 6


@needs_x265
def test_picinfo_on_a_raw_stream(tmp_path, capsys):
    path = tmp_path / "b.265"
    path.write_bytes(_stream("p-minimal"))
    outs = []
    for main, argv in ((jax_picinfo.main, [str(path)]),
                       (picinfo.main, ["--device", "cpu", str(path)]),
                       (jax_picinfo.main, ["-s", str(path)]),
                       (picinfo.main, ["-s", str(path)])):
        rc = main(argv)
        cap = capsys.readouterr()
        outs.append((rc, cap.out, cap.err))
    assert outs[0] == outs[1] and outs[2] == outs[3]
    assert outs[0][0] == 0 and "HEVC Annex-B" in outs[0][1]
    assert "pictures decoded 4" in outs[0][1]


# --- HEIF image sequences -----------------------------------------------------

@functools.cache
def _primary(w: int, h: int) -> bytes:
    return heif_enc.encode_heif(testing.heif_pic(w, h, 7), qp=24)


@needs_x265
def test_encode_heif_sequence_matches_jax():
    pics = [testing.heif_pic(48, 32, 20 + k) for k in range(3)]
    jpics = [JaxPic(width=48, height=32, depth=32, pitch=192, codec="raw",
                    pixels=p.pixels) for p in pics]
    data = heif_enc.encode_heif_sequence(pics, qp=24)
    assert data == jax_heif_enc.encode_heif_sequence(jpics, qp=24)
    got, want = ft.load_all(data, device="cpu"), jax_registry.load_all(
        data)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert (g.width, g.height) == (w.width, w.height)
        np.testing.assert_array_equal(g.np_pixels(), np.asarray(w.pixels))


@needs_x265
@pytest.mark.parametrize("switch", ["host", "hevc_device", "device_color",
                                    "both"])
def test_x265_stream_as_a_heif_sequence(switch, monkeypatch):
    """An x265 P/B stream in a moov/trak: the primary, then every frame in
    presentation order, as the reference decodes them, under each switch
    (K14's plain version once a picture, K15's once a frame)."""
    data = fx.heif_sequence(_primary(96, 96), _stream("b-pyramid-all"))
    env = {"hevc_device": ["FFPIC_HEVC_DEVICE"],
           "device_color": ["FFPIC_HEIF_DEVICE_COLOR"],
           "both": ["FFPIC_HEVC_DEVICE", "FFPIC_HEIF_DEVICE_COLOR"]}.get(
        switch, [])
    for k in env:
        monkeypatch.setenv(k, "1")
    launches = {"k14": 0, "k15": 0}
    for name, key in (("residuals_packed", "k14"),
                      ("hevc_tiles_to_rgba", "k15")):
        real = getattr(hevc_kernels, name)

        def spy(*a, _real=real, _key=key, **kw):
            launches[_key] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(hevc_kernels, name, spy)
    want = jax_registry.load_all(data)
    got = ft.load_all(data, device="cpu")
    assert len(got) == len(want) == 9
    assert launches == {"k14": 9 * ("FFPIC_HEVC_DEVICE" in env),
                        "k15": 9 * ("FFPIC_HEIF_DEVICE_COLOR" in env)}
    for g, w in zip(got, want):
        assert (g.width, g.height) == (w.width, w.height)
        if "FFPIC_HEIF_DEVICE_COLOR" in env:
            testing.assert_equal_up_to_contraction(
                lambda g=g: g.pixels, np.asarray(w.pixels))
        else:
            np.testing.assert_array_equal(g.np_pixels(),
                                          np.asarray(w.pixels))
    jframes = _jax_pictures("b-pyramid-all")
    for g, p in zip(got[1:], jframes):
        assert g.height == p.sps.pic_height_cropped


@needs_x265
def test_sequence_sample_that_fails_is_skipped():
    """A sample whose decode raises ValueError is skipped, in both
    packages: here a B picture whose reference sample was cut."""
    stream = _stream("p-minimal")
    params, aus = fx.access_units(stream)
    cut = b"".join(b"\0\0\0\1" + n for n in (
        params[32], params[33], params[34], *aus[0], *aus[2], *aus[3]))
    data = fx.heif_sequence(_primary(64, 64), cut)
    got, want = ft.load_all(data, device="cpu"), jax_registry.load_all(
        data)
    assert len(got) == len(want) < 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.np_pixels(), np.asarray(w.pixels))


# --- reference faults the port mirrors (ROADMAP Queue 3) ----------------------

def _outcome(decode):
    try:
        pics = _display_order(decode())
    except Exception as e:     # the comparison is of both packages' errors
        return type(e).__name__, str(e)
    return [(p.poc, [hashlib.sha256(np.ascontiguousarray(c)).hexdigest()
                     for c in p.planes]) for p in pics]


@needs_x265
def test_open_gop_cra_as_a_random_access_point():
    """Mirrored: every CRA resets the POC MSB and its RASL pictures are
    decoded (``hevc.py:997`` of the reference, NoRaslOutputFlag 1 for
    every CRA).  An open-GOP stream comes out the same from both
    packages, pictures or error."""
    stream = _stream("open-gop")
    assert any(hevc.nal_type(n) == 21 for n in hevc.split_annexb(stream))
    got = _outcome(lambda: hevc.SequenceDecoder("cpu").decode_annexb(stream))
    want = _outcome(lambda: jax_hevc.SequenceDecoder().decode_annexb(stream))
    assert got == want


@needs_x265
def test_prev_tid0_poc_takes_every_picture(monkeypatch):
    """Mirrored: ``prev_tid0_poc`` is set from every decoded picture,
    TemporalId > 0 ones too (``hevc.py:1016`` of the reference).  With
    the pixel decode stubbed out, both packages follow the same POCs,
    and after a sub-layer picture hold its POC."""
    stream = fx.x265_encode(fx.frames(6, 64, 64), gop=8, bframes=3, qp=34,
                            extra={**BASE, "temporal-layers": 1})
    params, aus = fx.access_units(stream)

    def run(mod):
        def stub(sps, pps, nalus, inter_env=None, **kw):
            return types.SimpleNamespace(motion=None)
        monkeypatch.setattr(mod, "decode_picture", stub)
        dec = mod.SequenceDecoder()
        for t in (32, 33, 34):
            dec.push(params[t])
        out = []
        for au in aus:
            for n in au:
                dec.push(n)
            pic = dec.flush()
            out.append((au[0][1] & 7, pic.poc, dec.prev_tid0_poc))
        return out
    got = run(hevc)
    assert got == run(jax_hevc)
    sub = [(poc, prev) for tid1, poc, prev in got if tid1 > 1]
    assert sub and all(poc == prev for poc, prev in sub)


def test_ridx_takes_the_first_index_of_a_repeated_poc():
    """Mirrored: the motion field keeps POCs, and ``_ridx`` maps a POC
    back to its first index in the list (``hevc_inter.py:177`` of the
    reference), also where the list holds that POC twice."""
    outs = []
    for mod in (hevc_inter, jax_inter):
        ctx = mod.InterSliceCtx(poc=8, ref_list=[
            [(4, None, False), (0, None, False), (4, None, False)],
            [(16, None, False), (16, None, False)]],
            field_=mod.MotionField(16, 16))
        d = mod.MotionDeriver.__new__(mod.MotionDeriver)
        d.ctx, d.fld = ctx, ctx.field_
        ctx.field_.stamp(0, 0, 8, 8, mod.PuMotion(
            pred=[True, True], mv=[(3, -2), (0, 5)], ref_idx=[2, 1],
            poc=[4, 16]))
        m = d._nb_motion(4, 4)
        outs.append((d._ridx(0, 4), d._ridx(0, 0), d._ridx(1, 16),
                     d._ridx(1, 99), m.ref_idx, m.poc, m.mv))
    # the neighbour stamped with refIdx (2, 1) reads back as (0, 0)
    assert outs[0] == outs[1]
    assert outs[0] == (0, 1, 0, 0, [0, 0], [4, 16], [(3, -2), (0, 5)])


# --- a reference fault the port repairs (ROADMAP Queue 3) --------------------

@needs_x265
def test_entry_points_count_emulation_prevention_bytes():
    """Deliberate difference: entry_point_offset_minus1 counts the
    emulation prevention bytes of its substream (7.4.7.1).  This WPP
    stream's I slice has one in its first substream: the port cuts the
    de-escaped data one byte earlier (``hevc.rbsp_entry_points``) and
    decodes what libde265 decodes; the reference cuts at the raw offset
    and fails."""
    stream = fx.x265_encode(fx.frames(5, 96, 160, noise=30, seed=25), gop=8,
                            bframes=2, qp=30, extra=ALL)
    params, aus = fx.access_units(stream)
    sps, pps = hevc.parse_sps(params[33]), hevc.parse_pps(params[34])
    assert pps.entropy_coding_sync
    nalu = aus[0][0]
    from ffpic_tpu_torch.coding.hevc_slice import parse_slice_header
    from ffpic_tpu_torch.utils.bitstream import BitReader
    r = BitReader(hevc.unescape(nalu))
    r.skip_bits(16)
    hdr = parse_slice_header(r, hevc.nal_type(nalu), sps, pps)
    sizes = hevc.rbsp_entry_points(nalu, hdr)
    assert sorted(a - b for a, b in zip(hdr.entry_points, sizes)) \
        == [0] * (len(sizes) - 1) + [1]
    got = _display_order(hevc.SequenceDecoder("cpu").decode_annexb(stream))
    _assert_de265(got, stream)
    want = _outcome(lambda: jax_hevc.SequenceDecoder().decode_annexb(stream))
    assert want != _outcome(lambda: got)


# --- the committed 1080p fixtures ---------------------------------------------

def test_fixtures_match_their_digests():
    """The committed files are the ones ``hevc_fixtures.json`` describes,
    and, where libde265 loads, libde265 decodes them to its digests (the
    1080p decodes of the port run on the card, ``chip_smoke.py``)."""
    d = os.path.join(os.path.dirname(fx.__file__), "testdata")
    with open(os.path.join(d, fx.DIGESTS)) as f:
        digests = json.load(f)
    blobs = {}
    for name in (fx.STREAM, fx.SEQUENCE):
        with open(os.path.join(d, name), "rb") as f:
            blobs[name] = f.read()
        assert hashlib.sha256(blobs[name]).hexdigest() == \
            digests[name]["sha256"]
    assert len(digests[fx.STREAM]["pictures"]) == 5
    assert len(digests[fx.SEQUENCE]["pictures"]) == 3
    assert ft.probe(blobs[fx.STREAM]).name == "HEVC"
    head = ft.load(blobs[fx.SEQUENCE], skip_decode=True)
    assert head.meta["sequence"] and (head.width, head.height) == (1920,
                                                                   1080)
    if not fx.have_libraries():
        return
    assert [fx.picture_digests(p) for p in fx.de265_decode(
        blobs[fx.STREAM])] == digests[fx.STREAM]["pictures"]
    assert [fx.picture_digests(p) for p in fx.de265_decode(
        fx.item_annexb(blobs[fx.SEQUENCE]))] == \
        digests[fx.SEQUENCE]["primary"]
