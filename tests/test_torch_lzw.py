"""The port's LZW (``ffpic_tpu_torch.coding.lzw`` and the native
``host_lzw.c``) held against ffpic_tpu's on the same streams, on the CPU.

GIF streams come from the reference's encoder (``gif._lzw_encode_gif``)
and TIFF streams from ``testing.lzw_encode_tiff``, over seeded symbols
across code-size growth and full tables: the port's native decoder, its
plain Python loop and the reference's decoder give the same bytes.  A
code past the table, a first code after a clear that is not a literal,
and a GIF minimum code size over 12, raise ``ValueError`` in the port.  ``lz77_decode``, which has
no caller, equals the reference's.
"""

import numpy as np
import pytest

from ffpic_tpu import native as jax_native
from ffpic_tpu.coding import lzw as jax_lzw
from ffpic_tpu.formats.gif import _lzw_encode_gif
from ffpic_tpu_torch import native, testing
from ffpic_tpu_torch.coding import lzw
import reference_native  # noqa: F401  (readies ffpic_tpu first)

STREAMS = [(1, 4), (2, 2), (3, 2), (257, 4), (1000, 4), (5000, 16),
           (40000, 256), (60000, 3)]


@pytest.fixture(autouse=True)
def _native_first():
    jax_native.available()


def _symbols(n: int, nsym: int) -> np.ndarray:
    return np.random.default_rng(n * 7 + nsym).integers(0, nsym, n)


@pytest.mark.parametrize("n,nsym", STREAMS)
def test_gif_native_python_and_reference_agree(n, nsym):
    idx = _symbols(n, nsym).astype(np.int32)
    mcs = max(2, int(np.ceil(np.log2(max(nsym, 2)))))
    enc = _lzw_encode_gif(idx, mcs)
    got = lzw.lzw_decode_gif(enc, mcs, n)
    assert got == lzw.lzw_decode_gif_py(enc, mcs, n)
    assert got == jax_lzw.lzw_decode_gif(enc, mcs, n)
    np.testing.assert_array_equal(np.frombuffer(got, np.uint8), idx)


@pytest.mark.parametrize("n,nsym", STREAMS)
def test_tiff_native_python_and_reference_agree(n, nsym):
    data = _symbols(n, nsym).astype(np.uint8).tobytes()
    enc = testing.lzw_encode_tiff(data)
    got = lzw.lzw_decode_tiff(enc, n)
    assert got == lzw.lzw_decode_tiff_py(enc, n) == data
    assert got == jax_lzw.lzw_decode_tiff(enc, n)


@pytest.mark.parametrize("max_out", [0, 1, 17, 999])
def test_output_is_cut_at_max_out(max_out):
    """The native decoders stop at ``max_out`` bytes, as the reference's
    native decoders do."""
    idx = _symbols(1000, 4).astype(np.int32)
    enc = _lzw_encode_gif(idx, 2)
    got = lzw.lzw_decode_gif(enc, 2, max_out)
    assert got == jax_native.lzw_gif(enc, 2, max_out)
    assert bytes(got) == idx[:max_out].astype(np.uint8).tobytes()
    data = idx.astype(np.uint8).tobytes()
    tenc = testing.lzw_encode_tiff(data)
    assert lzw.lzw_decode_tiff(tenc, max_out) == \
        jax_native.lzw_tiff(tenc, max_out) == data[:max_out]


# GIF, 2-bit symbols: clear (4), then a code past next_code (6)
BAD_GIF_PAST = bytes([0x04 | (0x07 << 3), 0])
# GIF, 2-bit symbols: clear (4), 6, 0, 6 -- the first code after the
# clear is next_code itself, not a literal
BAD_GIF_FIRST = (4 | 6 << 3 | 0 << 6 | 6 << 9).to_bytes(2, "little")
# TIFF: clear (256), a literal, then code 300 > next_code 258
BAD_TIFF_PAST = ((256 << 18) | (65 << 9) | 300).to_bytes(4, "big")[1:] + b"\0"
# TIFF: clear (256), 258, 65, 258 -- again a first code that is no literal
BAD_TIFF_FIRST = (((256 << 27) | (258 << 18) | (65 << 9) | 258) << 4) \
    .to_bytes(5, "big")


@pytest.mark.parametrize("decode,stream", [
    (lambda d: lzw.lzw_decode_gif(d, 2, 64), BAD_GIF_PAST),
    (lambda d: lzw.lzw_decode_gif_py(d, 2, 64), BAD_GIF_PAST),
    (lambda d: lzw.lzw_decode_gif(d, 2, 64), BAD_GIF_FIRST),
    (lambda d: lzw.lzw_decode_gif_py(d, 2, 64), BAD_GIF_FIRST),
    (lambda d: lzw.lzw_decode_tiff(d, 64), BAD_TIFF_PAST),
    (lambda d: lzw.lzw_decode_tiff_py(d, 64), BAD_TIFF_PAST),
    (lambda d: lzw.lzw_decode_tiff(d, 64), BAD_TIFF_FIRST),
    (lambda d: lzw.lzw_decode_tiff_py(d, 64), BAD_TIFF_FIRST),
], ids=["gif-past", "gif-past-py", "gif-first", "gif-first-py",
        "tiff-past", "tiff-past-py", "tiff-first", "tiff-first-py"])
def test_crafted_streams_raise_value_error(decode, stream):
    """A code past the table, and a first code after a clear that is not
    a literal, raise ``ValueError`` in the native decoders and in their
    plain loops.  The reference takes the second: its entry then points
    at itself, and the next use of the code walks it forever (its native
    decoders write past their stack, its Python loops exhaust memory),
    so it is not called on these streams."""
    with pytest.raises(ValueError, match="corrupt LZW"):
        decode(stream)


@pytest.mark.parametrize("seed", range(6))
def test_corrupt_streams_raise_value_error(seed):
    """Streams of random bytes either decode or raise ``ValueError``, the
    port's native decoders, their plain loops and the reference's native
    decoders alike."""
    rng = np.random.default_rng(seed)
    for _ in range(20):
        blob = rng.integers(0, 256, int(rng.integers(1, 200))) \
            .astype(np.uint8).tobytes()
        for port, plain, ref in (
                (lambda b: lzw.lzw_decode_gif(b, 4, 500),
                 lambda b: lzw.lzw_decode_gif_py(b, 4, 500),
                 lambda b: jax_native.lzw_gif(b, 4, 500)),
                (lambda b: lzw.lzw_decode_tiff(b, 500),
                 lambda b: lzw.lzw_decode_tiff_py(b, 500),
                 lambda b: jax_native.lzw_tiff(b, 500))):
            try:
                want = ref(blob)
            except ValueError:
                for f in (port, plain):
                    with pytest.raises(ValueError):
                        f(blob)
            else:
                assert port(blob) == want == plain(blob)[:500]


@pytest.mark.parametrize("mcs", [13, 20, 255])
def test_gif_min_code_size_over_12_is_refused(mcs):
    with pytest.raises(ValueError, match="minimum code size"):
        native.lzw_gif(b"\x00" * 8, mcs, 16)


def _lz77_stream(rng, groups: int) -> bytes:
    """Flag bytes, each before eight items: a literal (bit 1) or a
    (length - 3, offset - 1) pair reaching back into what is out."""
    out, have = bytearray(), 0
    for _ in range(groups):
        flags = int(rng.integers(0, 256)) | (0xFF if have == 0 else 0)
        out.append(flags)
        for bit in range(8):
            if flags & (1 << bit):
                out.append(int(rng.integers(0, 256)))
                have += 1
            else:
                off = int(rng.integers(1, min(have, 4096) + 1))
                length = int(rng.integers(3, 19))
                word = ((off - 1) << 4) | (length - 3)
                out += bytes([word & 255, word >> 8])
                have += length
    return bytes(out)


@pytest.mark.parametrize("groups", [1, 5, 60])
def test_lz77_matches_reference(groups):
    blob = _lz77_stream(np.random.default_rng(groups), groups)
    for cap in (5, 1 << 28):
        assert lzw.lz77_decode(blob, cap) == jax_lzw.lz77_decode(blob, cap)


def test_native_library_builds_host_lzw():
    """``host_lzw.c`` is one of the library's sources, so its hash name
    changes with it."""
    assert any(s.endswith("host_lzw.c") for s in native.SOURCES)
    lib = native._load()
    assert lib.ffpic_lzw_gif.restype is not None
