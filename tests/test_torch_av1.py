"""The port's AV1 intra decoder (``coding/av1_*.py``, ``formats/av1_*.py``
and the native ``host_av1.c``, ``host_av1_itx.c``) held against
ffpic_tpu's on the same streams, on the CPU, with tolerance 0: both run
the same numpy and C.

Streams come from Pillow's libavif/libaom (``quality``, ``speed``,
``subsampling``, ``advanced``) and, for 10-bit and superres keyframes,
from ``tools/aom_oracle.encode_frames``, after the recipes of
``tests/test_av1.py``, ``tests/test_av1_grain.py`` and
``tests/test_av1_sweep_quick.py``, with numpy seeds.  Each is made once
a process (``stream``).  For each: ``decode_frame``'s planes and meta
equal the JAX package's, with every ``filter_stages`` mask on a stream
that uses deblocking, CDEF and loop restoration.  Each C route is held
against the port's own Python or numpy route: the whole-superblock
parse against the per-block C parse and the Python symbol path
(``FrameState.force_python``), the native deblock against the numpy
vector pass and the scalar pass, the native transforms against the
numpy lanes.  The wrappers refuse malformed arrays, and an inter frame
and its inter blocks decode to the reference's planes
(``tests/test_torch_av1_inter.py`` holds the inter slice whole).
"""

import functools
import io
import os
import sys

import numpy as np
import pytest
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

from ffpic_tpu import native as jax_native  # noqa: E402
from ffpic_tpu.coding import av1_itx as jax_itx  # noqa: E402
from ffpic_tpu.formats import av1_recon as jax_recon  # noqa: E402
from ffpic_tpu_torch import native  # noqa: E402
from ffpic_tpu_torch.coding import av1_headers as H  # noqa: E402
from ffpic_tpu_torch.coding import av1_itx as itx  # noqa: E402
from ffpic_tpu_torch.coding import av1_tile  # noqa: E402
from ffpic_tpu_torch.coding.av1_consts import (TX_H, TX_W,  # noqa: E402
                                               adjusted_tx_size)
from ffpic_tpu_torch.formats import av1_loopfilter as lf  # noqa: E402
from ffpic_tpu_torch.formats import av1_recon, heif  # noqa: E402
import reference_native  # noqa: E402,F401  (readies ffpic_tpu first)

@pytest.fixture(autouse=True)
def _native_first():
    jax_native.available()


# --- streams -----------------------------------------------------------------

def _gradient(w, h, seed, noise=20):
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 255, w)
    y = np.linspace(0, 255, h)
    g = (x[None, :] + y[:, None]) / 2
    img = np.stack([g, g[::-1], np.abs(g - 128) * 2], -1).astype(np.uint8)
    return img + rng.integers(0, noise, img.shape, dtype=np.uint8)


def _screen(w, h, seed, ncols=6):
    """Flat colour bars and a white band: libaom turns on its screen
    content tools (palette; intra block copy from about 320 pixels)."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.uint8)
    cols = rng.integers(0, 256, (ncols, 3))
    sw = w // ncols
    for i in range(ncols):
        img[:, i * sw:(i + 1) * sw] = cols[i]
    img[h // 4:h // 3, w // 12:w - w // 4] = [255, 255, 255]
    img[-4:, :] = [0, 0, 0]
    return img


def _pil_obus(img, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(img).save(b, "AVIF", **kw)
    data = b.getvalue()
    s = heif.parse_structure(data)
    return heif.read_item(data, s, s["primary"])


def _aom_yuv(h, w, bd, seed):
    """One 4:2:0 frame for ``aom_oracle.encode_frames``
    (``tests/test_av1_sweep_quick.py:_yuv``)."""
    rng = np.random.default_rng(seed)
    mx = (1 << bd) - 1
    base = np.clip(np.linspace(0, mx, w)[None, :]
                   + np.linspace(0, mx // 2, h)[:, None]
                   + rng.integers(0, max(2, mx // 8), (h, w)),
                   0, mx).astype(np.uint16)
    ch, cw = (h + 1) // 2, (w + 1) // 2
    return [[base, np.full((ch, cw), mx // 2, np.uint16),
             rng.integers(0, mx, (ch, cw)).astype(np.uint16)]]


def _superres(h, w, den, bd, seed):
    """A superres keyframe (``tests/test_av1_grain.py:_encode``)."""
    from test_av1_grain import _encode, _frames
    return _encode(_frames(1, h, w, bd, seed=seed), bd=bd, sr_den=den)


def _aom10(h, w, seed):
    import aom_oracle
    return aom_oracle.encode_frames(_aom_yuv(h, w, 10, seed), bit_depth=10,
                                    speed=6, q=40)


STREAMS = {
    "420_q30_64": lambda: _pil_obus(_gradient(64, 64, 30), quality=30,
                                    speed=6),
    "420_q60_64": lambda: _pil_obus(_gradient(64, 64, 60), quality=60,
                                    speed=6),
    "420_q85_s4_64": lambda: _pil_obus(_gradient(64, 64, 85), quality=85,
                                       speed=4),
    "444_96": lambda: _pil_obus(_gradient(96, 96, 7), quality=70, speed=6,
                                subsampling="4:4:4"),
    "422_96": lambda: _pil_obus(_gradient(96, 96, 7), quality=70, speed=6,
                                subsampling="4:2:2"),
    "mono_96": lambda: _pil_obus(_gradient(96, 96, 7), quality=70, speed=6,
                                 subsampling="4:0:0"),
    "odd_75x53": lambda: _pil_obus(
        np.random.default_rng(6).integers(0, 256, (53, 75, 3), np.uint8),
        quality=50, speed=6),
    "odd_33x17_lossless": lambda: _pil_obus(
        np.random.default_rng(6).integers(0, 256, (17, 33, 3), np.uint8),
        quality=100, speed=6),
    "tiles_128": lambda: _pil_obus(_gradient(128, 128, 13), quality=60,
                                   speed=6, tile_rows=1, tile_cols=1),
    "sb128_sgr_128": lambda: _pil_obus(_gradient(128, 128, 1), quality=60,
                                       speed=0),
    "wiener_128": lambda: _pil_obus(_gradient(128, 128, 7, noise=40),
                                    quality=40, speed=2),
    "cdef_128": lambda: _pil_obus(_gradient(128, 128, 9), quality=40,
                                  speed=6, advanced={"enable-cdef": "1"}),
    "all_filters_128": lambda: _pil_obus(
        _gradient(128, 128, 7, noise=40), quality=40, speed=2,
        advanced={"enable-cdef": "1"}),
    "no_cdf_update_96": lambda: _pil_obus(
        _gradient(96, 96, 17), quality=80, speed=5,
        advanced={"cdf-update-mode": "0"}),
    "palette_128": lambda: _pil_obus(_screen(128, 96, 1), quality=30,
                                     speed=2),
    "palette_64": lambda: _pil_obus(_screen(64, 64, 1, 4), quality=45,
                                    speed=4),
    "intrabc_320x256": lambda: _pil_obus(_screen(320, 256, 5), quality=60,
                                         speed=6),
    "lossless_32_444": lambda: _pil_obus(
        np.random.default_rng(5).integers(0, 256, (32, 32, 3), np.uint8),
        quality=100, speed=6, subsampling="4:4:4"),
    "lossless_48_422": lambda: _pil_obus(
        np.random.default_rng(5).integers(0, 256, (48, 48, 3), np.uint8),
        quality=100, speed=6, subsampling="4:2:2"),
    "superres_64x128": lambda: _superres(64, 128, 16, 8, 2),
    "superres_62x90": lambda: _superres(62, 90, 14, 8, 3),
    "10bit_64": lambda: _aom10(64, 64, 6),
}


@functools.cache
def stream(name: str) -> bytes:
    return STREAMS[name]()


def _headers(obus):
    seq = None
    for obu in H.parse_obus(obus):
        if obu["type"] == H.OBU_SEQUENCE_HEADER:
            seq = H.parse_sequence_header(obu["payload"])
        elif obu["type"] in (H.OBU_FRAME, H.OBU_FRAME_HEADER):
            fh, bitpos = H.parse_frame_header(obu["payload"], seq)
            return seq, fh, obu, bitpos
    raise AssertionError("no frame")


def _parsed(obus, force_python=False):
    """The ``FrameState`` of the stream's first frame after its tile
    group's parse."""
    seq, fh, obu, bitpos = _headers(obus)
    fs = av1_tile.FrameState(seq, fh)
    fs.force_python = force_python
    av1_recon._decode_tile_group(fs, obu["payload"][(bitpos + 7) >> 3:])
    return fs


def _decode(obus, force_python=False, **kw):
    """``decode_frame`` with ``FrameState.force_python`` set or not."""
    if not force_python:
        return av1_recon.decode_frame(obus, **kw)

    class Python(av1_tile.FrameState):
        def __init__(self, *a):
            super().__init__(*a)
            self.force_python = True
    orig = av1_recon.FrameState
    av1_recon.FrameState = Python
    try:
        return av1_recon.decode_frame(obus, **kw)
    finally:
        av1_recon.FrameState = orig


def _assert_planes(got, want, label=""):
    assert len(got) == len(want), label
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, (label, i)
        np.testing.assert_array_equal(a, b, err_msg=f"{label} plane {i}")


# --- the port against the JAX package ----------------------------------------

TOOLS = {
    "odd_33x17_lossless": lambda seq, fh: fh.coded_lossless,
    "lossless_32_444": lambda seq, fh: fh.coded_lossless,
    "lossless_48_422": lambda seq, fh: fh.coded_lossless,
    "tiles_128": lambda seq, fh: fh.tile_cols * fh.tile_rows == 4,
    "sb128_sgr_128": lambda seq, fh: (seq.use_128x128_superblock
                                      and fh.uses_lr),
    "wiener_128": lambda seq, fh: fh.uses_lr,
    "cdef_128": lambda seq, fh: seq.enable_cdef,
    "all_filters_128": lambda seq, fh: (seq.enable_cdef and fh.uses_lr
                                        and any(fh.loop_filter_level)),
    "palette_128": lambda seq, fh: fh.allow_screen_content_tools,
    "palette_64": lambda seq, fh: fh.allow_screen_content_tools,
    "intrabc_320x256": lambda seq, fh: fh.allow_intrabc,
    "superres_64x128": lambda seq, fh: fh.use_superres,
    "superres_62x90": lambda seq, fh: fh.use_superres,
    "10bit_64": lambda seq, fh: seq.bit_depth == 10,
    "mono_96": lambda seq, fh: seq.mono_chrome,
    "422_96": lambda seq, fh: (seq.subsampling_x, seq.subsampling_y)
    == (1, 0),
    "444_96": lambda seq, fh: (seq.subsampling_x, seq.subsampling_y)
    == (0, 0),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_decode_frame_matches_jax(name):
    """Planes and meta of ``decode_frame`` with every in-loop filter
    equal the JAX package's; the stream uses the tool its name says."""
    obus = stream(name)
    seq, fh, _, _ = _headers(obus)
    if name in TOOLS:
        assert TOOLS[name](seq, fh), name
    got, gmeta = av1_recon.decode_frame(obus)
    want, wmeta = jax_recon.decode_frame(obus)
    _assert_planes(got, want, name)
    assert gmeta == wmeta


@pytest.mark.parametrize("stages", range(8))
def test_filter_stages_match_jax(stages):
    """Each ``filter_stages`` mask (1 deblock, 2 CDEF, 4 loop
    restoration) on a stream that uses all three, and on the superres
    stream (its upscale sits between CDEF and restoration)."""
    for name in ("all_filters_128", "superres_64x128"):
        obus = stream(name)
        got, _ = av1_recon.decode_frame(obus, filter_stages=stages)
        want, _ = jax_recon.decode_frame(obus, filter_stages=stages)
        _assert_planes(got, want, f"{name} stages {stages}")
    got, _ = av1_recon.decode_frame(stream("all_filters_128"),
                                    apply_filters=False)
    want, _ = jax_recon.decode_frame(stream("all_filters_128"),
                                     apply_filters=False)
    _assert_planes(got, want, "no filters")


def _obu(t, payload):
    n, size = len(payload), b""
    while True:
        byte, n = n & 0x7F, n >> 7
        size += bytes([byte | (0x80 if n else 0)])
        if not n:
            return bytes([(t << 3) | 2]) + size + payload


def test_split_obu_forms_match_jax():
    """OBU_FRAME_HEADER + one OBU_TILE_GROUP, and a tile group OBU a
    tile with explicit ranges (``tests/test_av1.py:
    test_av1_split_obu_forms``), decode as the JAX package does."""
    obus = stream("tiles_128")
    split = multi = b""
    for obu in H.parse_obus(obus):
        if obu["type"] == H.OBU_SEQUENCE_HEADER:
            seq = H.parse_sequence_header(obu["payload"])
            split += _obu(1, obu["payload"])
            multi += _obu(1, obu["payload"])
        elif obu["type"] == H.OBU_FRAME:
            payload = obu["payload"]
            fh, bitpos = H.parse_frame_header(payload, seq)
            nb = (bitpos + 7) >> 3
            hdr, tg = payload[:nb], payload[nb:]
            split += _obu(H.OBU_FRAME_HEADER, hdr) + _obu(H.OBU_TILE_GROUP,
                                                          tg)
            pos, tiles = 1, []
            for tn in range(4):
                if tn == 3:
                    tiles.append(tg[pos:])
                    continue
                size = int.from_bytes(tg[pos:pos + fh.tile_size_bytes],
                                      "little") + 1
                pos += fh.tile_size_bytes
                tiles.append(tg[pos:pos + size])
                pos += size
            multi += _obu(H.OBU_FRAME_HEADER, hdr)
            for tn, tile in enumerate(tiles):
                multi += _obu(H.OBU_TILE_GROUP,
                              bytes([0x80 | (tn << 5) | (tn << 3)]) + tile)
    whole, _ = av1_recon.decode_frame(obus)
    for form in (split, multi):
        got, _ = av1_recon.decode_frame(form)
        want, _ = jax_recon.decode_frame(form)
        _assert_planes(got, want)
        _assert_planes(got, whole)


# --- each C route against the port's Python or numpy route --------------------

GRIDS = ("bsize", "y_mode", "uv_mode", "skip", "seg", "qindex_mi", "b_col0",
         "b_row0", "delta_lf", "palette_size", "tx_w4", "tx_h4")


def _records(fs):
    return [(r[:7], r[7]) for r in fs.tb_records()]


@pytest.mark.parametrize("name", ["420_q60_64", "palette_64"])
def test_sb_native_block_native_and_python_agree(name, monkeypatch):
    """The whole-superblock C parse, the per-block C parse
    (``FFPIC_AV1_BLOCK_NATIVE``) and the Python symbol path
    (``FrameState.force_python``) give the same planes, mode grids and
    transform blocks; the planes equal the JAX package's."""
    obus = stream(name)
    runs = {}
    for route in ("sb", "block", "python"):
        if route == "block":
            monkeypatch.setenv("FFPIC_AV1_BLOCK_NATIVE", "1")
        planes, _ = _decode(obus, force_python=route == "python")
        fs = _parsed(obus, force_python=route == "python")
        monkeypatch.delenv("FFPIC_AV1_BLOCK_NATIVE", raising=False)
        runs[route] = planes, fs
    want, _ = jax_recon.decode_frame(obus)
    p_sb, fs_sb = runs["sb"]
    _assert_planes(p_sb, want)
    # each run took its route: array-form records from the superblock
    # parse, op lists from the per-block one, neither from Python
    assert fs_sb.tbmeta_chunks and not fs_sb.tbs
    assert runs["block"][1].recon_ops and not runs["block"][1].tbmeta_chunks
    assert runs["python"][1].tbs and not runs["python"][1].recon_ops
    if name == "palette_64":
        assert fs_sb.pal_count > 0 and runs["python"][1].pal_colors
    for route in ("block", "python"):
        planes, fs = runs[route]
        _assert_planes(planes, p_sb, route)
        for g in GRIDS:
            np.testing.assert_array_equal(getattr(fs, g), getattr(fs_sb, g),
                                          err_msg=f"{route} {g}")
        recs, recs_sb = _records(fs), _records(fs_sb)
        assert len(recs) == len(recs_sb)
        for (ma, ca), (mb, cb) in zip(recs, recs_sb):
            assert ma == mb
            np.testing.assert_array_equal(ca, cb)


def test_intrabc_grids_match_jax():
    """Intra block copy on the whole-superblock C parse: the vector,
    block-copy and transform grids equal the JAX package's parse."""
    obus = stream("intrabc_320x256")
    fs = _parsed(obus)
    seq, fh, obu, bitpos = _headers(obus)
    from ffpic_tpu.coding import av1_headers as jax_h
    from ffpic_tpu.coding.av1_tile import FrameState as JaxFrameState
    jseq = jax_h.parse_sequence_header(
        [o for o in jax_h.parse_obus(obus) if o["type"] == 1][0]["payload"])
    jfh, _ = jax_h.parse_frame_header(obu["payload"], jseq)
    jfs = JaxFrameState(jseq, jfh)
    jax_recon._decode_tile_group(jfs, obu["payload"][(bitpos + 7) >> 3:])
    assert fs.is_ibc.any()
    for g in ("is_ibc", "mvs", "bsize", "skip", "inter_tx", "tx_types"):
        np.testing.assert_array_equal(getattr(fs, g), getattr(jfs, g),
                                      err_msg=g)


def test_deblock_native_numpy_and_scalar_agree(monkeypatch):
    """``av1_deblock_pass`` against the numpy vector pass
    (``FFPIC_AV1_HOST_DEBLOCK``) and the scalar pass, pass by pass."""
    obus = stream("420_q30_64")
    fs = _parsed(obus)
    assert any(fs.fh.loop_filter_level)
    planes = av1_recon._reconstruct(fs)
    nat = lf.deblock_frame(fs, planes)
    monkeypatch.setenv("FFPIC_AV1_HOST_DEBLOCK", "1")
    vec = lf.deblock_frame(fs, planes)
    _assert_planes(nat, vec)
    assert any((a != b).any() for a, b in zip(nat, planes))
    seq, fh = fs.seq, fs.fh
    for plane, p in enumerate(planes):
        sx = seq.subsampling_x if plane else 0
        sy = seq.subsampling_y if plane else 0
        a = p.astype(np.int32)
        b = a.copy()
        for pass_ in (0, 1):
            lf._deblock_pass(fs, a, plane, pass_, sx, sy, seq.bit_depth,
                             fh.loop_filter_sharpness)
            lf._deblock_pass_scalar(fs, b, plane, pass_, sx, sy,
                                    seq.bit_depth, fh.loop_filter_sharpness)
            np.testing.assert_array_equal(a, b, err_msg=f"{plane} {pass_}")


def _legal_combos():
    for tx in range(19):
        w, h = TX_W[tx], TX_H[tx]
        for tt in range(16):
            vk, hk = itx._TYPE_1D[tt]
            if (vk in (1, 2) and h > 16) or (hk in (1, 2) and w > 16):
                continue
            yield tx, tt


def _itx_both(c, tx, tt, bd, lossless, monkeypatch):
    monkeypatch.setenv("FFPIC_AV1_HOST_ITX", "0")
    want = itx.inverse_transform_batch(c, tx, tt, bd, lossless)
    monkeypatch.setenv("FFPIC_AV1_HOST_ITX", "1")
    got = itx.inverse_transform_batch(c, tx, tt, bd, lossless)
    return got, want


def test_native_itx_matches_numpy_lanes(monkeypatch):
    """``av1_itx_batch`` against the numpy lanes for every legal
    (tx size, tx type) at 8 and 10 bits, and against the JAX package's
    batch route."""
    rng = np.random.default_rng(0)
    for tx, tt in _legal_combos():
        adj = adjusted_tx_size(tx)
        for bd in (8, 10):
            lim = 1 << (bd + 7)
            c = rng.integers(-lim, lim, (2, TX_H[adj], TX_W[adj])
                             ).astype(np.int32)
            got, want = _itx_both(c, tx, tt, bd, False, monkeypatch)
            np.testing.assert_array_equal(got, want, err_msg=f"{tx} {tt}")
            np.testing.assert_array_equal(
                got, jax_itx.inverse_transform_batch(c, tx, tt, bd, False))


def test_native_itx_wraps_as_numpy(monkeypatch):
    """Full-range int32 coefficients (a corrupt stream's) wrap the same
    way in C and in the numpy lanes; the lossless WHT agrees too."""
    rng = np.random.default_rng(7)
    for tx in (0, 3, 5, 9, 13, 16, 18):
        adj = adjusted_tx_size(tx)
        c = rng.integers(-2**31, 2**31 - 1, (3, TX_H[adj], TX_W[adj]),
                         dtype=np.int64).astype(np.int32)
        got, want = _itx_both(c, tx, 0, 8, False, monkeypatch)
        np.testing.assert_array_equal(got, want, err_msg=f"tx={tx}")
    c = rng.integers(-(1 << 15), 1 << 15, (33, 4, 4)).astype(np.int32)
    got, want = _itx_both(c, 0, 0, 8, True, monkeypatch)
    np.testing.assert_array_equal(got, want)


def test_wrappers_refuse_malformed_arrays():
    """Where the reference asserts or passes a wrong array on to C, the
    port's wrappers raise ``ValueError``."""
    i32 = np.zeros((4, 4, 4), np.int32)
    with pytest.raises(ValueError, match="int32"):
        native.av1_wht_batch(i32.astype(np.int64))
    with pytest.raises(ValueError, match="expected"):
        native.av1_wht_batch(np.zeros((4, 8, 8), np.int32))
    with pytest.raises(ValueError, match="C-contiguous"):
        native.av1_itx_batch(np.zeros((2, 8, 16), np.int32)[:, :, ::2], 8,
                             8, 8, 8, 0, 0, False, 1, -1, 1, -1, 1,
                             itx._COS_I32)
    with pytest.raises(ValueError, match="cos_tab"):
        native.av1_itx_batch(np.zeros((2, 8, 8), np.int32), 8, 8, 8, 8,
                             0, 0, False, 1, -1, 1, -1, 1,
                             itx._COS_I32[:10])
    y = np.zeros((8, 8), np.uint8)
    with pytest.raises(ValueError, match="cover"):
        native.av1_color_cicp([y, y[:2, :2], y[:2, :2]], 8, 8, 1, 1, 8,
                              False, 0)
    with pytest.raises(ValueError, match="2-D"):
        native.av1_color_cicp([np.zeros(8, np.uint8)], 1, 8, 0, 0, 8,
                              False, 2)
    fs = _parsed(stream("420_q30_64"))
    prm = lf._deblock_native_prm(fs)
    arr = np.zeros((64, 64), np.int32)
    args = (fs.tx_w4[0], fs.tx_h4[0], fs.b_col0, fs.b_row0, fs.skip,
            fs.seg, fs.delta_lf)
    with pytest.raises(ValueError, match="expected"):
        native.av1_deblock_pass(arr, 64, 32, 0, 0, prm, *args)
    with pytest.raises(ValueError, match="delta_lf|dlf"):
        native.av1_deblock_pass(arr, 64, 64, 0, 0, prm, *args[:-1],
                                fs.delta_lf[:, :, :2].copy())
    with pytest.raises(ValueError, match="prm"):
        native.av1_deblock_pass(arr, 64, 64, 0, 0, prm[:80].copy(), *args)
    st = np.zeros(4, np.int64)
    with pytest.raises(ValueError, match="msac state"):
        native.av1_block_mode(b"\0", st, np.zeros(1, np.int64),
                              np.zeros(33, np.int32), np.zeros(23, np.int32),
                              np.zeros(36 + 2 * 64 * 64, np.int32))
    sbp = np.zeros(36, np.int32)
    sbp[2] = 16
    with pytest.raises(ValueError, match="ops"):
        native.av1_sb_parse(b"\0", np.zeros(5, np.int64),
                            np.zeros(1, np.int64), np.zeros(1, np.int64),
                            np.zeros(11, np.int64), sbp,
                            np.zeros((10, 21), np.int32),
                            np.zeros(1, np.int32), np.zeros((10, 9), np.int32),
                            np.zeros(1, np.int32), np.zeros(13, np.int32))
    ops = np.zeros((2, 21), np.int32)
    with pytest.raises(ValueError, match="pw/ph"):
        native.av1_recon(ops, [arr], np.array([32, 0, 0], np.int32),
                         np.array([64, 0, 0], np.int32),
                         np.zeros(1, np.int32), *av1_recon._recon_tables()[:1],
                         *av1_recon._recon_tables()[1:],
                         np.zeros(1, np.int32), 8)


def test_inter_frames_and_blocks_raise(monkeypatch):
    """An inter frame reaches ``_decode_block_interframe`` and an inter
    block ``_reconstruct``'s ``_recon_inter_block``: both now decode, and
    the frames of a libaom stream equal the reference's planes."""
    from ffpic_tpu_torch import testing
    calls = {"mode": 0, "recon": 0}
    real_mode = av1_tile.TileDecoder._decode_block_interframe
    real_recon = av1_recon._recon_inter_block

    def mode(self, *a):
        calls["mode"] += 1
        return real_mode(self, *a)

    def recon(*a):
        calls["recon"] += 1
        return real_recon(*a)

    monkeypatch.setattr(av1_tile.TileDecoder, "_decode_block_interframe",
                        mode)
    monkeypatch.setattr(av1_recon, "_recon_inter_block", recon)
    obus = testing.avif_fixture("av1_gop_96x64.obu")
    got = av1_recon.Av1Decoder().decode_obus(obus)
    want = jax_recon.Av1Decoder().decode_obus(obus)
    assert len(got) == len(want) == 6
    for (gp, gm), (wp, wm) in zip(got, want):
        assert gm == wm
        for a, b in zip(gp, wp):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert calls["mode"] > 0 and calls["recon"] > 0


def test_frame_header_tables_match_jax():
    """Sequence and frame headers of every stream parse to the JAX
    package's fields (film grain parameters included where present)."""
    from ffpic_tpu.coding import av1_headers as jax_h
    for name in ("10bit_64", "superres_64x128", "all_filters_128",
                 "intrabc_320x256", "lossless_32_444"):
        obus = stream(name)
        seq, fh, obu, _ = _headers(obus)
        jseq = jax_h.parse_sequence_header([
            o for o in jax_h.parse_obus(obus)
            if o["type"] == jax_h.OBU_SEQUENCE_HEADER][0]["payload"])
        jfh, _ = jax_h.parse_frame_header(obu["payload"], jseq)
        assert vars(seq) == vars(jseq), name
        assert vars(fh) == vars(jfh), name
