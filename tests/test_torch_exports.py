"""The port's package exports and the small utilities of ROADMAP Queue 1
items 2, 15 and 17, held against ffpic_tpu on the CPU.

``ffpic_tpu_torch.formats``, ``.utils`` and ``.coding`` export the
reference's ``__all__`` name for name, each name the port's own object;
the top level adds ``start_profiler`` and ``stop_profiler``, which run a
``torch.profiler`` run on the CPU and write a Chrome trace.  The copies
of ``coding/huffman.py``, ``coding/deflate.py``, ``ops/color_utils.py``
and ``ops/golden.py``'s numpy models give the reference's results on
seeded inputs, and ``ops.resize.resize_batch_rgba`` the reference's
batch within the resize's 1 LSB.
"""

import importlib
import json
import os
import zlib

import numpy as np
import pytest
import torch

import ffpic_tpu
import ffpic_tpu_torch
from ffpic_tpu.coding import deflate as jax_deflate
from ffpic_tpu.coding import huffman as jax_huffman
from ffpic_tpu.ops import color_utils as jax_color_utils
from ffpic_tpu.ops import golden as jax_golden
from ffpic_tpu.utils.bitstream import BitReader as JaxBitReader
from ffpic_tpu.utils.bitstream import BitWriter as JaxBitWriter
from ffpic_tpu_torch.coding import deflate, huffman
from ffpic_tpu_torch.ops import color_utils, golden
from ffpic_tpu_torch.utils import trace
from ffpic_tpu_torch.utils.bitstream import BitReader, BitWriter
import reference_native  # noqa: F401  (readies ffpic_tpu first)


@pytest.mark.parametrize("sub", ["formats", "utils", "coding"])
def test_subpackage_exports_are_the_references(sub):
    """Each subpackage's ``__all__`` is the reference's, in its order,
    and every name resolves to an object of the port (none of
    ``ffpic_tpu``'s)."""
    ref = importlib.import_module(f"ffpic_tpu.{sub}")
    mine = importlib.import_module(f"ffpic_tpu_torch.{sub}")
    assert mine.__all__ == ref.__all__
    for name in mine.__all__:
        obj = getattr(mine, name)
        assert obj.__module__.startswith("ffpic_tpu_torch."), (name, obj)
        assert obj is not getattr(ref, name)
    ns = {}
    exec(f"from ffpic_tpu_torch.{sub} import *", ns)
    assert set(mine.__all__) <= set(ns)


def test_formats_exports_are_the_registrys():
    from ffpic_tpu_torch import formats
    from ffpic_tpu_torch.formats import registry
    for name in ("load", "load_all", "probe", "info", "encode", "register",
                 "find_codec", "registered_codecs", "Codec"):
        assert getattr(formats, name) is getattr(registry, name)
    assert formats.registered_codecs() == list(registry.ORDER)


def test_top_level_exports_the_profiler_hooks():
    """The top level keeps every name of the reference's ``__all__`` and
    adds the profiler hooks, which the trace module exports too."""
    assert set(ffpic_tpu.__all__) <= set(ffpic_tpu_torch.__all__)
    for name in ("start_profiler", "stop_profiler"):
        assert name in ffpic_tpu_torch.__all__
        assert name in trace.__all__
        assert getattr(ffpic_tpu_torch, name) is getattr(trace, name)


def test_profiler_writes_a_chrome_trace_on_the_cpu(tmp_path):
    """A run started and stopped on the CPU (CPU activity only) writes a
    Chrome trace into ``logdir`` that holds the work done meanwhile; a
    second start while one runs and a stop without one raise."""
    logdir = tmp_path / "trace"
    ffpic_tpu_torch.start_profiler(str(logdir))
    try:
        with pytest.raises(RuntimeError, match="already"):
            ffpic_tpu_torch.start_profiler(str(logdir))
        with torch.profiler.record_function("ffpic_smoke_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    finally:
        path = ffpic_tpu_torch.stop_profiler()
    assert os.path.dirname(path) == str(logdir)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "ffpic_smoke_span" in names
    with pytest.raises(RuntimeError, match="no profiler"):
        ffpic_tpu_torch.stop_profiler()


# --- coding/huffman.py -----------------------------------------------------

def _dht(seed: int):
    """A DHT-style table (counts, symbols) of a seeded frequency set."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 120))
    syms = rng.choice(256, n, replace=False)
    freqs = {int(s): int(f) for s, f in zip(syms, rng.integers(1, 5000, n))}
    t = jax_huffman.HuffmanTable.from_frequencies(freqs)
    return freqs, t.counts, t.symbols


@pytest.mark.parametrize("seed", range(4))
def test_huffman_matches_the_reference(seed):
    """``from_frequencies``, the table, the LUT, and symbols encoded and
    decoded over the port's bit reader and writer equal the
    reference's."""
    freqs, counts, symbols = _dht(seed)
    mine = huffman.HuffmanTable.from_frequencies(freqs)
    ref = jax_huffman.HuffmanTable(counts, symbols)
    assert (mine.counts, mine.symbols) == (ref.counts, ref.symbols)
    assert mine.codes == ref.codes and mine.maxlen == ref.maxlen
    np.testing.assert_array_equal(mine.lut_sym, ref.lut_sym)
    np.testing.assert_array_equal(mine.lut_len, ref.lut_len)
    msg = np.random.default_rng(seed + 10).choice(sorted(freqs), 300)
    w, jw = BitWriter(), JaxBitWriter()
    enc, jenc = huffman.HuffmanEncoder(w), jax_huffman.HuffmanEncoder(jw)
    for s in msg:
        enc.encode_symbol(mine, int(s))
        jenc.encode_symbol(ref, int(s))
    w.align_byte()
    jw.align_byte()
    data, jdata = w.getvalue(), jw.getvalue()
    assert data == jdata
    dec = huffman.HuffmanDecoder(BitReader(data))
    jdec = jax_huffman.HuffmanDecoder(JaxBitReader(jdata))
    got = [dec.decode_symbol(mine) for _ in msg]
    assert got == [jdec.decode_symbol(ref) for _ in msg] == list(msg)
    with pytest.raises(ValueError):
        huffman.HuffmanTable([1] * 16, [0])


# --- coding/deflate.py -----------------------------------------------------

def _stream(kind: str) -> bytes:
    """A zlib stream of seeded text or noise with stored, fixed or
    dynamic blocks."""
    rng = np.random.default_rng(3)
    text = b"".join(bytes(rng.integers(97, 101, int(rng.integers(1, 40)),
                                       dtype=np.uint8)) * 3
                    for _ in range(200))
    if kind == "stored":
        return zlib.compress(bytes(rng.integers(0, 256, 3000,
                                                dtype=np.uint8)), 0)
    if kind == "fixed":
        c = zlib.compressobj(9, zlib.DEFLATED, 15, 9, zlib.Z_FIXED)
        return c.compress(text) + c.flush()
    return zlib.compress(text if kind == "dynamic" else b"", 9)


@pytest.mark.parametrize("kind", ["stored", "fixed", "dynamic", "empty"])
def test_inflate_matches_zlib_and_the_reference(kind):
    data = _stream(kind)
    got = deflate.inflate(data)
    assert got == zlib.decompress(data) == jax_deflate.inflate(data)


def test_inflate_refuses_a_bad_checksum_as_the_reference():
    data = bytearray(_stream("dynamic"))
    data[-1] ^= 1
    for fn in (deflate.inflate, jax_deflate.inflate):
        with pytest.raises(ValueError, match="adler32"):
            fn(bytes(data))


# --- ops/color_utils.py and ops/golden.py ----------------------------------

def test_color_utils_match_the_reference():
    rng = np.random.default_rng(4)
    rgba = rng.integers(0, 256, (37, 41, 4), dtype=np.uint8)
    rgba[:4, :4, :3] = 77                     # grays
    rgba[4, :3, :3] = [[255, 254, 255], [0, 0, 1], [9, 9, 0]]
    for a, b in zip(color_utils.rgba_to_hsv(rgba),
                    jax_color_utils.rgba_to_hsv(rgba)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    bg = rng.integers(0, 256, (37, 41, 4), dtype=np.uint8)
    np.testing.assert_array_equal(color_utils.alpha_blend(rgba, bg),
                                  jax_color_utils.alpha_blend(rgba, bg))
    for fn in (color_utils.alpha_blend, jax_color_utils.alpha_blend):
        with pytest.raises(ValueError):
            fn(rgba, bg[..., :3])


def test_golden_models_match_the_reference():
    rng = np.random.default_rng(5)
    coef = rng.integers(-1024, 1024, (6, 8, 8))
    coef[0] = 0
    coef[1] = 32767                            # the int16 wraps
    pix = rng.integers(-128, 128, (6, 8, 8)).astype(np.int16)
    dst = rng.integers(-4096, 4096, (5, 4, 4))
    quant = rng.integers(1, 256, (8, 8))
    for name, args in (("idct8x8_16", (coef,)), ("fdct8x8", (pix,)),
                       ("hevc_dst4x4", (dst,)), ("hevc_dst4x4", (dst, 10)),
                       ("dequant", (coef, quant))):
        got, want = getattr(golden, name)(*args), \
            getattr(jax_golden, name)(*args)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    y = rng.integers(0, 256, (17, 23))
    for sv, sh in ((1, 1), (2, 2), (1, 2)):
        u = rng.integers(0, 256, (-(-17 // sv), -(-23 // sh)))
        v = rng.integers(0, 256, u.shape)
        np.testing.assert_array_equal(
            golden.yuv_to_bgra_planes(y, u, v, sv, sh),
            jax_golden.yuv_to_bgra_planes(y, u, v, sv, sh))


# --- ops/resize.resize_batch_rgba ------------------------------------------

def test_resize_batch_rgba_matches_the_reference_within_1():
    """numpy images of several sizes to ``device``; within 1 LSB of the
    reference's batch (the resize's recorded gap), with another
    ``method`` too (``lanczos3``)."""
    from ffpic_tpu.ops.resize import resize_batch_rgba as jax_resize
    from ffpic_tpu_torch.ops.resize import resize_batch_rgba
    rng = np.random.default_rng(6)
    imgs = [rng.integers(0, 256, s, dtype=np.uint8)
            for s in ((40, 52, 4), (23, 31, 4), (64, 64, 4))]
    got = resize_batch_rgba(imgs, (24, 20), device="cpu")
    want = np.asarray(jax_resize(imgs, (24, 20)))
    assert tuple(got.shape) == want.shape == (3, 24, 20, 4)
    assert np.abs(got.numpy().astype(int) - want).max() <= 1
    tens = resize_batch_rgba([torch.from_numpy(i) for i in imgs], (24, 20))
    assert torch.equal(tens, got)
    got = resize_batch_rgba(imgs, (24, 20), method="lanczos3", device="cpu")
    want = np.asarray(jax_resize(imgs, (24, 20), "lanczos3"))
    assert np.abs(got.numpy().astype(int) - want).max() <= 1
