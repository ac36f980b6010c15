"""The port's copy of the host layer held against its originals in
ffpic_tpu: the JPEG marker parse and native Huffman decode
(``formats.jpg.parse_and_decode``), the native library loader, the
integer tables (``ops.golden``) and the plain forward DCT, the
encoder's tables and helpers (``formats.jpg_encode``) and the stage
tracer.
"""

import io
import os
import sys
import threading

import numpy as np
import pytest

from ffpic_tpu import native as jax_native
from ffpic_tpu.coding.huffman import HuffmanTable
from ffpic_tpu.formats import jpg as jax_jpg
from ffpic_tpu.formats import jpg_encode as jax_enc
from ffpic_tpu.ops import golden as jax_golden
from ffpic_tpu.utils import bitstream as jax_bits
from ffpic_tpu.utils import trace as jax_trace
from ffpic_tpu_torch import native, testing
from ffpic_tpu_torch.formats import jpg, jpg_encode
from ffpic_tpu_torch.ops import golden
from ffpic_tpu_torch.utils import trace
import reference_native  # noqa: F401  (readies ffpic_tpu first)


def _pil_jpeg(h, w, q, seed, **kw) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(testing.synth_rgb(h, w, seed)).save(buf, "JPEG",
                                                        quality=q, **kw)
    return buf.getvalue()


CASES = {
    "baseline_420": lambda: testing.synth_jpeg_420(72, 104, 85, 1),
    "restart_420": lambda: _pil_jpeg(120, 200, 90, 3, subsampling="4:2:0",
                                     restart_marker_blocks=3),
    "baseline_444": lambda: _pil_jpeg(40, 56, 75, 4, subsampling="4:4:4"),
    "progressive_420": lambda: _pil_jpeg(96, 136, 80, 5, subsampling="4:2:0",
                                         progressive=True),
}


def _same_header(got, want):
    assert (got.width, got.height, got.precision, got.mode) == \
        (want.width, want.height, want.precision, want.mode)
    assert (got.mcus_x, got.mcus_y, got.restart_interval) == \
        (want.mcus_x, want.mcus_y, want.restart_interval)
    assert [vars(c) for c in got.comps] == [vars(c) for c in want.comps]
    assert got.scans == want.scans
    assert got.dht_raw == want.dht_raw
    assert sorted(got.dqt) == sorted(want.dqt)
    for k in want.dqt:
        assert got.dqt[k].dtype == np.int32
        np.testing.assert_array_equal(got.dqt[k], want.dqt[k])


@pytest.mark.parametrize("case", sorted(CASES))
def test_parse_and_decode_matches_jax(case):
    """Same header, quant tables, packed arrays (or PackedIneligible)
    and dense raster-order coefficient planes as the original."""
    data = CASES[case]()
    jax_native.available()          # the original's native path
    want, wend = jax_jpg.parse_and_decode(data)
    got, gend = jpg.parse_and_decode(data)
    assert gend == wend and want.coeffs_raster
    _same_header(got, want)
    assert len(got.coeffs) == len(want.coeffs)
    for a, b in zip(got.coeffs, want.coeffs):
        np.testing.assert_array_equal(a, b)

    if case.startswith("progressive"):
        for mod in (jax_jpg, jpg):
            with pytest.raises(mod.PackedIneligible):
                mod.parse_and_decode(data, packed=True)
        return
    want, _ = jax_jpg.parse_and_decode(data, packed=True)
    want_packed = tuple(np.array(a) for a in want.packed[:3])
    got, _ = jpg.parse_and_decode(data, packed=True)
    _same_header(got, want)
    assert got.coeffs == [] and got.packed[3] == want.packed[3]
    for a, b in zip(got.packed[:3], want_packed):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_jpeg_420_plan_matches_jax(case):
    """The pipeline's copied plan step takes the route the original
    takes: packed, dense, or none (not 4:2:0)."""
    from ffpic_tpu.pipeline import _jpeg_420_plan as jax_plan
    from ffpic_tpu_torch.pipeline import _jpeg_420_plan
    data = CASES[case]()
    jax_native.available()
    got, want = _jpeg_420_plan(data), jax_plan(data)
    assert (got is None) == (want is None) == (case == "baseline_444")
    if want is not None:
        assert (got.packed is None) == (want.packed is None)


def test_parse_rejects_missing_soi():
    with pytest.raises(ValueError, match="SOI"):
        jpg.parse_and_decode(b"\x00\x01\x02")


def test_find_scan_end_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(50):
        data = bytes(rng.choice([0x00, 0xFF, 0xD0, 0xD9, 0x12], 64))
        for pos in (0, 5, 63):
            assert jpg._find_scan_end(data, pos) == \
                jax_jpg._find_scan_end(data, pos)


def test_native_loader_threads(monkeypatch, tmp_path):
    """Eight threads ask for the library at once while it is not built:
    all wait for one build and get the same library."""
    monkeypatch.setattr(native, "BUILD", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    barrier = threading.Barrier(8)
    libs, errors = [], []

    def worker():
        try:
            barrier.wait(timeout=60)
            libs.append(native._load())
        except Exception as e:          # noqa: BLE001 - reported below
            errors.append(e)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(libs) == 8 and len({id(lib) for lib in libs}) == 1
    assert [f for f in os.listdir(tmp_path) if f.endswith(".so")] == \
        [os.path.basename(libs[0]._name)]
    data = testing.synth_jpeg_420(32, 48, 80, 2)
    assert jpg.parse_and_decode(data, packed=True)[0].packed[3] > 0


def test_to_device_copies_read_only_arrays():
    """A read-only array (a view of ``bytes``, as inflated PNG rows are)
    reaches a CPU tensor as a copy, without torch's warning about
    sharing memory it cannot write; a writable one is shared."""
    import warnings

    import torch
    from ffpic_tpu_torch.utils.device import to_device
    ro = np.frombuffer(bytes(range(12)), np.uint8).reshape(3, 4)
    assert not ro.flags.writeable
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t = to_device(ro, torch.device("cpu"))
    assert t.dtype == torch.uint8 and torch.equal(t, torch.arange(12).view(
        3, 4).to(torch.uint8))
    rw = np.arange(6, dtype=np.int32)
    shared = to_device(rw, torch.device("cpu"))
    rw[0] = 9
    assert int(shared[0]) == 9


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """No compiler: the build raises, nothing falls back."""
    monkeypatch.setattr(native, "BUILD", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
    with pytest.raises(RuntimeError, match="native build failed"):
        native.available()


def test_native_destuff_matches_jax():
    data = CASES["restart_420"]()
    j, _ = jpg.parse_and_decode(data, packed=True)
    sos = data.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")
    scan = data[start:jpg._find_scan_end(data, start)]
    jax_native.available()
    got, want = native.jpeg_destuff(scan), jax_native.jpeg_destuff(scan)
    assert j.restart_interval and len(got[1]) > 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_golden_tables_match_jax():
    for name in ("IDCT_P13", "FDCT_P13", "ZIGZAG"):
        a, b = getattr(golden, name), getattr(jax_golden, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_fdct8x8_matches_jax():
    """The port's plain forward DCT against the reference's numpy golden
    model ``fdct8x8``, which the port's encoder used to copy."""
    import torch
    from ffpic_tpu_torch.ops.jpeg_kernels import forward_dct
    rng = np.random.default_rng(9)
    blocks = rng.integers(-128, 128, (300, 8, 8)).astype(np.int16)
    blocks[:4] = np.array([-128, 127, 0, 1])[:, None, None]
    np.testing.assert_array_equal(forward_dct(torch.from_numpy(blocks)),
                                  jax_golden.fdct8x8(blocks))


def test_encoder_tables_match_jax():
    for name in ("Y_QUANT", "UV_QUANT", "Y_DC_COUNT", "Y_DC_SYM",
                 "Y_AC_COUNT", "Y_AC_SYM", "UV_DC_COUNT", "UV_DC_SYM",
                 "UV_AC_COUNT", "UV_AC_SYM"):
        np.testing.assert_array_equal(getattr(jpg_encode, name),
                                      getattr(jax_enc, name))
    for cnt, sym in ((jax_enc.Y_DC_COUNT, jax_enc.Y_DC_SYM),
                     (jax_enc.Y_AC_COUNT, jax_enc.Y_AC_SYM),
                     (jax_enc.UV_DC_COUNT, jax_enc.UV_DC_SYM),
                     (jax_enc.UV_AC_COUNT, jax_enc.UV_AC_SYM)):
        assert jpg_encode.encode_map(cnt, sym) == \
            HuffmanTable(cnt, sym).encode_map()
    for q in (None, 1, 30, 50, 90, 100):
        np.testing.assert_array_equal(
            jpg_encode._scale_quant(jpg_encode.Y_QUANT, q),
            jax_enc._scale_quant(jax_enc.Y_QUANT, q))
    rgb = testing.synth_rgb(40, 52, 3)
    for a, b in zip(jpg_encode._rgb_to_yuv420(rgb),
                    jax_enc._rgb_to_yuv420(rgb)):
        np.testing.assert_array_equal(a, b)


def test_bitwriter_matches_jax():
    """Random codes, with runs of 1-bits that make 0xFF bytes to stuff."""
    rng = np.random.default_rng(11)
    got, want = jpg_encode.BitWriter(), jax_bits.BitWriter(
        jax_bits.MSB, stuff_jpeg=True)
    for _ in range(2000):
        n = int(rng.integers(0, 17))
        v = (1 << n) - 1 if rng.random() < 0.3 else int(rng.integers(0, 1 << 16))
        v &= (1 << n) - 1
        got.write_bits(v, n)
        want.write_bits(v, n)
    got.align_byte(fill=1)
    want.align_byte(fill=1)
    assert b"\xff\x00" in bytes(want.buf)
    assert bytes(got.buf) == want.getvalue()


def test_trace_is_the_ports_own():
    assert trace.stage is not jax_trace.stage
    trace.reset()
    with trace.stage("off"):
        pass
    assert trace.report() == {}
    trace.enable()
    try:
        for _ in range(3):
            with trace.stage("on"):
                pass
    finally:
        trace.enable(False)
    rep = trace.report()
    assert list(rep) == ["on"] and rep["on"]["count"] == 3
    trace.reset()
    assert trace.report() == {}
