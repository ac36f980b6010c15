"""The host-only codecs of ffpic_tpu_torch (BMP, GIF, TGA, PNM, PSD, TIFF,
ICO) held against ffpic_tpu's on the same bytes, on the CPU.

For every file of ``CASES`` (written by PIL, by the port's encoders or by
``ffpic_tpu_torch.testing``'s writers, small and made from a seed):
``load``'s pixels, sizes, format, ``meta`` and frames, ``info()`` and the
header-only parse (``skip_decode``, with CUDA hidden) equal the JAX
package's; the JPEG strips of a TIFF go through the port's ``jpg.load``
(K2 and K4's plain versions here), their colour up to XLA's choice of
contracting its products into FMAs.  Also: the four encoders' bytes
(BMP, TGA, PNM, GIF), the writers of ``testing`` against PIL, the probe
order over a file of every format the reference knows (AVIF, BPG, JPEG
2000, SVG and EXR give the reference's pixels or its kind of error), the TIFF and PSD counts
past the end of a file and the pixel budget (``ValueError`` before
anything is allocated), and a seeded corruption loop over every codec.
"""

import functools
import io
import re
import struct

import numpy as np
import pytest
import torch
from PIL import Image

import ffpic_tpu
import ffpic_tpu_torch
from ffpic_tpu import native as jax_native
from ffpic_tpu.formats.pic import Pic as JaxPic
from ffpic_tpu_torch import testing
from ffpic_tpu_torch.formats import registry, staging, tiff_tags
from ffpic_tpu_torch.formats.pic import Pic, PixelFormat
import reference_native  # noqa: F401  (readies ffpic_tpu first)


@pytest.fixture(autouse=True)
def _native_first():
    jax_native.available()


def _pil(img, fmt, **kw) -> bytes:
    b = io.BytesIO()
    img.save(b, fmt, **kw)
    return b.getvalue()


def _rgb(h=29, w=37, seed=3):
    return testing.synth_rgb(h, w, seed)


def _rgba(h=29, w=37, seed=3):
    rng = np.random.default_rng(seed)
    return np.dstack([_rgb(h, w, seed),
                      rng.integers(0, 256, (h, w), dtype=np.uint8)])


def _blocky(h, w, seed):
    """Content of 16x16 flat blocks: a JPEG's chroma survives it."""
    rng = np.random.default_rng(seed)
    return np.kron(rng.integers(0, 256, (-(-h // 16), -(-w // 16), 3)),
                   np.ones((16, 16, 1)))[:h, :w].astype(np.uint8)


def _palette_img(h=29, w=37, seed=3):
    return Image.fromarray(_rgb(h, w, seed)).convert(
        "P", palette=Image.ADAPTIVE)


def _idx(bits: int):
    idx, pal = testing.quantize_332(_rgb(31, 45, 5))
    return (idx.astype(np.int64) % (1 << bits)).astype(np.uint8), \
        pal[:1 << bits]


def _bmp_core() -> bytes:
    """A BMP with the 12-byte BITMAPCOREHEADER, 24 bpp."""
    rgb = _rgb(9, 11, 4)
    pitch = -(-11 * 3 // 4) * 4
    rows = np.zeros((9, pitch), np.uint8)
    rows[:, :33] = rgb[::-1, :, [2, 1, 0]].reshape(9, 33)
    off = 14 + 12
    return (struct.pack("<2sIHHI", b"BM", off + rows.nbytes, 0, 0, off)
            + struct.pack("<IhhHH", 12, 11, 9, 1, 24) + rows.tobytes())


def _gif_anim(disposals) -> bytes:
    rng = np.random.default_rng(7)
    frames = []
    for k, _ in enumerate(disposals):
        a = np.full((24, 32, 3), 40 * k, np.uint8)
        a[4 + k:14 + k, 6:20] = rng.integers(0, 256, 3)
        frames.append(Image.fromarray(a).convert("P"))
    return _pil(frames[0], "GIF", save_all=True, append_images=frames[1:],
                duration=[30, 60, 90][:len(frames)], loop=3,
                disposal=list(disposals), comment=b"ffpic test")


def _gif_partial_frames() -> bytes:
    """An animation whose later frames cover part of the screen, one of
    them with a transparent index: PIL writes the changed box only."""
    base = _blocky(32, 48, 9)
    second = base.copy()
    second[8:20, 10:30] = [250, 10, 10]
    third = second.copy()
    third[0:6, 0:6] = [10, 250, 10]
    frames = [Image.fromarray(a).convert("P", palette=Image.ADAPTIVE)
              for a in (base, second, third)]
    return _pil(frames[0], "GIF", save_all=True, append_images=frames[1:],
                duration=50, transparency=0, disposal=[1, 2, 3])


def _port_gif_anim() -> bytes:
    rgba = _rgba(24, 28, 11)
    rgba[:8, :, 3] = 0
    frames = [Pic(pixels=np.roll(rgba, 5 * k, axis=1), width=28, height=24,
                  delay_ms=40) for k in (1, 2)]
    anim = Pic(pixels=rgba, width=28, height=24, frames=frames, delay_ms=40)
    return ffpic_tpu_torch.encode(anim, "GIF", device="cpu", loops=2)


def _pam(depth: int, maxval: int = 255) -> bytes:
    rng = np.random.default_rng(depth)
    arr = rng.integers(0, maxval + 1, (7, 9, depth))
    dt = ">u2" if maxval > 255 else np.uint8
    tupl = {1: "GRAYSCALE", 2: "GRAYSCALE_ALPHA", 3: "RGB",
            4: "RGB_ALPHA"}[depth]
    hdr = (f"P7\n# pam\nWIDTH 9\nHEIGHT 7\nDEPTH {depth}\nMAXVAL {maxval}\n"
           f"TUPLTYPE {tupl}\nENDHDR\n").encode()
    return hdr + arr.astype(dt).tobytes()


def _ico_pil() -> bytes:
    return _pil(Image.fromarray(_rgba(32, 32, 12)), "ICO",
                sizes=[(32, 32), (16, 16)])


def _ico_mixed(first: str) -> bytes:
    rgba = _rgba(32, 32, 13)
    rgba[::5, ::3, 3] = 0
    png = testing.encode_png(_rgba(48, 48, 14), 6, 8, filters=(1, 2))
    return testing.encode_ico([png, rgba] if first == "png"
                              else [rgba, png])


def _ico_palette() -> bytes:
    """An ICO whose one entry is a 4 bpp palette BMP with an AND mask."""
    idx, pal = _idx(4)
    idx = idx[:16, :16]
    w = h = 16
    quads = np.zeros((16, 4), np.uint8)
    quads[:, :3] = pal[:, [2, 1, 0]]
    xor = np.packbits(np.unpackbits(idx[::-1, :, None], axis=-1)[..., 4:]
                      .reshape(h, w * 4), axis=1)
    mask = np.zeros((h, 4), np.uint8)
    mask[::2, 0] = 0xF0
    blob = (struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, 4, 0, 0, 0, 0, 0, 0)
            + quads.tobytes() + xor.tobytes() + mask.tobytes())
    return (struct.pack("<HHH", 0, 1, 1)
            + struct.pack("<BBBBHHII", w, h, 16, 0, 1, 4, len(blob), 22)
            + blob)


CASES = {
    # BMP
    "bmp_pil_24": lambda: _pil(Image.fromarray(_rgb()), "BMP"),
    "bmp_pil_8": lambda: _pil(_palette_img(), "BMP"),
    "bmp_pil_1": lambda: _pil(Image.fromarray(_rgb()).convert("1"), "BMP"),
    "bmp_4": lambda: testing.encode_bmp_palette(*_idx(4), bpp=4),
    "bmp_rle8": lambda: testing.encode_bmp_palette(*_idx(8), rle=True),
    "bmp_rle4": lambda: testing.encode_bmp_palette(*_idx(4), bpp=4,
                                                   rle=True),
    "bmp_16_555": lambda: testing.encode_bmp(_rgb(), 16),
    "bmp_16_565": lambda: testing.encode_bmp(
        _rgb(), 16, masks=(0xF800, 0x07E0, 0x001F)),
    "bmp_32_bitfields": lambda: testing.encode_bmp(
        _rgba(), 32, masks=(0xFF0000, 0xFF00, 0xFF, 0)),
    "bmp_32": lambda: testing.encode_bmp(_rgba(), 32),
    "bmp_24_top_down": lambda: testing.encode_bmp(_rgb(), 24, top_down=True),
    "bmp_port_encoder": lambda: ffpic_tpu_torch.encode(
        Pic(pixels=_rgba(), width=37, height=29), "BMP", device="cpu"),
    "bmp_core_header": _bmp_core,
    # TGA
    "tga_pil_24": lambda: _pil(Image.fromarray(_rgb()), "TGA"),
    "tga_pil_rle": lambda: _pil(Image.fromarray(_blocky(29, 37, 2)), "TGA",
                                compression="tga_rle"),
    "tga_pil_colormap": lambda: _pil(_palette_img(), "TGA"),
    "tga_pil_colormap_rle": lambda: _pil(_palette_img(), "TGA",
                                         compression="tga_rle"),
    "tga_pil_gray": lambda: _pil(Image.fromarray(_rgb()[..., 0]), "TGA"),
    "tga_pil_gray_rle": lambda: _pil(Image.fromarray(_rgb()[..., 0]), "TGA",
                                     compression="tga_rle"),
    "tga_rle_32": lambda: testing.encode_tga(_rgba()),
    "tga_raw_32_top": lambda: testing.encode_tga(_rgba(), rle=False,
                                                 top_origin=True),
    "tga_port_encoder": lambda: ffpic_tpu_torch.encode(
        Pic(pixels=_rgba(), width=37, height=29), "TGA", device="cpu"),
    # PNM
    "pnm_pil_p6": lambda: _pil(Image.fromarray(_rgb()), "PPM"),
    "pnm_pil_p5": lambda: _pil(Image.fromarray(_rgb()[..., 1]), "PPM"),
    "pnm_pil_p4": lambda: _pil(Image.fromarray(_rgb()).convert("1"), "PPM"),
    "pnm_pil_p5_16": lambda: _pil(Image.fromarray(
        (_rgb()[..., 0].astype(np.uint16) * 257)), "PPM"),
    "pnm_p1": lambda: b"P1\n# bits\n4 3\n0 1 1 0\n1 0 0 1\n0 0 1 1\n",
    "pnm_p2": lambda: b"P2\n# comment\n3 2\n15\n0 5 10\n15 3 7\n",
    "pnm_p3": lambda: b"P3 2 2 100\n0 50 100 100 0 50\n25 75 99 1 2 3\n",
    "pnm_pam_1": lambda: _pam(1),
    "pnm_pam_2": lambda: _pam(2),
    "pnm_pam_3_16": lambda: _pam(3, 1000),
    "pnm_pam_4": lambda: _pam(4),
    "pnm_port_encoder": lambda: ffpic_tpu_torch.encode(
        Pic(pixels=_rgba(), width=37, height=29), "PNM", device="cpu"),
    # GIF
    "gif_pil_interlaced": lambda: _pil(_palette_img(31, 40), "GIF"),
    "gif_pil_progressive_off": lambda: _pil(_palette_img(31, 40), "GIF",
                                            interlace=0),
    "gif_pil_transparent": lambda: _pil(_palette_img(20, 24), "GIF",
                                        transparency=3),
    "gif_pil_anim_disposal": lambda: _gif_anim([1, 2, 3]),
    "gif_pil_partial_frames": _gif_partial_frames,
    "gif_port_encoder": lambda: ffpic_tpu_torch.encode(
        Pic(pixels=_rgba(), width=37, height=29), "GIF", device="cpu"),
    "gif_port_anim": _port_gif_anim,
    # TIFF
    "tiff_pil_raw": lambda: _pil(Image.fromarray(_rgb()), "TIFF"),
    "tiff_pil_lzw": lambda: _pil(Image.fromarray(_rgb()), "TIFF",
                                 compression="tiff_lzw"),
    "tiff_pil_packbits": lambda: _pil(Image.fromarray(_rgb()), "TIFF",
                                      compression="packbits"),
    "tiff_pil_deflate": lambda: _pil(Image.fromarray(_rgb()), "TIFF",
                                     compression="tiff_deflate"),
    "tiff_pil_predictor": lambda: _pil(Image.fromarray(_rgb()), "TIFF",
                                       compression="tiff_lzw",
                                       tiffinfo={317: 2}),
    "tiff_pil_gray": lambda: _pil(Image.fromarray(_rgb()[..., 2]), "TIFF"),
    "tiff_pil_gray16": lambda: _pil(Image.fromarray(
        _rgb()[..., 2].astype(np.uint16) * 251), "TIFF"),
    "tiff_pil_bilevel": lambda: _pil(Image.fromarray(_rgb()).convert("1"),
                                     "TIFF"),
    "tiff_pil_palette": lambda: _pil(_palette_img(), "TIFF"),
    "tiff_pil_rgba": lambda: _pil(Image.fromarray(_rgba()), "TIFF"),
    "tiff_pil_multipage": lambda: _pil(
        Image.fromarray(_rgb(10, 12, 1)), "TIFF", save_all=True,
        append_images=[Image.fromarray(_rgb(10, 12, k)) for k in (2, 3)]),
    "tiff_pil_jpeg": lambda: _pil(Image.fromarray(_blocky(48, 64, 5)),
                                  "TIFF", compression="jpeg", quality=90),
    "tiff_pil_jpeg_gray": lambda: _pil(Image.fromarray(
        _blocky(48, 64, 6)[..., 0]), "TIFF", compression="jpeg"),
    "tiff_lzw_predictor": lambda: testing.encode_tiff(
        _rgb(), "lzw", predictor=2, rows_per_strip=8),
    "tiff_deflate_predictor_be": lambda: testing.encode_tiff(
        _rgb(), "deflate", predictor=2, byteorder=">"),
    "tiff_packbits_strips": lambda: testing.encode_tiff(
        _rgb(), "packbits", rows_per_strip=5),
    "tiff_tiles": lambda: testing.encode_tiff(_rgb(40, 52, 8), "lzw",
                                              tile=(32, 16)),
    "tiff_bilevel_packbits": lambda: testing.encode_tiff(
        _rgb()[..., 0] > 120, "packbits"),
    "tiff_jpeg_strips": lambda: testing.encode_tiff(
        _rgb(56, 70, 9), "jpeg", rows_per_strip=16, quality=85),
    "tiff_jpeg_tiles": lambda: testing.encode_tiff(
        _rgb(40, 52, 10), "jpeg", tile=(32, 32)),
    "tiff_jpeg_gray": lambda: testing.encode_tiff(
        _rgb(40, 52, 11)[..., 1], "jpeg", rows_per_strip=16),
    "tiff_multipage_mixed": lambda: testing.encode_tiff(
        [_rgb(12, 14, 1), _rgb(12, 14, 2)[..., 0]], "lzw"),
    # PSD
    "psd_raw_rgb": lambda: testing.encode_psd(_rgb(), rle=False),
    "psd_rle_rgb": lambda: testing.encode_psd(_rgb()),
    "psd_rle_rgba": lambda: testing.encode_psd(_rgba()),
    "psd_rle_runs": lambda: testing.encode_psd(_blocky(29, 37, 4)),
    "psd_raw_gray": lambda: testing.encode_psd(_rgb()[..., 0], rle=False),
    # ICO
    "ico_pil": _ico_pil,
    "ico_png_then_bmp": lambda: _ico_mixed("png"),
    "ico_bmp_then_png": lambda: _ico_mixed("bmp"),
    "ico_palette_mask": _ico_palette,
}
JPEG_CASES = {k for k in CASES if "jpeg" in k}


@functools.lru_cache(maxsize=None)
def _data(name: str) -> bytes:
    return CASES[name]()


@functools.lru_cache(maxsize=None)
def _decoded(name: str):
    """(port's pictures, reference's pictures) of a case, decoded once."""
    data = _data(name)
    return (ffpic_tpu_torch.load_all(data, device="cpu"),
            ffpic_tpu.load_all(data))


def _rgba_of(p) -> np.ndarray:
    return np.ascontiguousarray(p.to_rgba32())


@pytest.mark.parametrize("name", sorted(CASES))
def test_load_matches_jax(name):
    got, want = _decoded(name)
    assert len(got) == len(want) >= 1
    assert ffpic_tpu_torch.probe(_data(name)).name == got[0].codec \
        == want[0].codec
    for k, (g, w) in enumerate(zip(got, want)):
        assert isinstance(g.pixels, torch.Tensor)
        assert g.pixels.device.type == "cpu" and g.pixels.dtype == torch.uint8
        assert (g.width, g.height, g.depth, g.pitch, g.format, g.delay_ms) \
            == (w.width, w.height, w.depth, w.pitch, w.format, w.delay_ms)
        assert g.meta == w.meta
        if name in JPEG_CASES:
            testing.assert_equal_up_to_contraction(
                lambda k=k: _rgba_of(ffpic_tpu_torch.load_all(
                    _data(name), device="cpu")[k]), _rgba_of(w))
        else:
            np.testing.assert_array_equal(_rgba_of(g), _rgba_of(w))
    assert got[0].n_frames == want[0].n_frames == len(got)


@pytest.mark.parametrize("name", sorted(CASES))
def test_info_matches_jax(name):
    got, want = _decoded(name)
    for g, w in zip(got, want):
        assert ffpic_tpu_torch.info(g) == ffpic_tpu.info(w)


@pytest.mark.parametrize("name", sorted(CASES))
def test_skip_decode_matches_jax(name, monkeypatch):
    """The header-only parse needs no CUDA and equals the reference's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = _data(name)
    got = ffpic_tpu_torch.load_all(data, skip_decode=True)
    want = ffpic_tpu.load_all(data, skip_decode=True)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.pixels is None
        assert (g.width, g.height, g.codec) == (w.width, w.height, w.codec)
        assert g.meta == w.meta
        assert ffpic_tpu_torch.info(g) == ffpic_tpu.info(w)


@pytest.mark.parametrize("name", ["bmp_32", "gif_port_encoder", "tga_rle_32",
                                  "pnm_p3", "psd_rle_rgb", "tiff_jpeg_strips",
                                  "ico_png_then_bmp"])
def test_host_codec_device_none_means_cuda(name, monkeypatch):
    """A host codec registers its host ``decode``, which takes ``device``
    as a required keyword, and no ``load`` of its own.  ``load`` and
    ``decode_batch`` with no device mean CUDA, as for every other codec,
    and raise without it: a TIFF's JPEG strips and an ICO's PNG entry do
    not go to the plain versions unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = _data(name)
    codec = ffpic_tpu_torch.probe(data)
    assert codec.load is None
    assert codec.decode.__module__ == \
        f"ffpic_tpu_torch.formats.{name.split('_')[0]}"
    with pytest.raises(TypeError, match="device"):
        codec.decode(data)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ffpic_tpu_torch.load(data)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ffpic_tpu_torch.decode_batch([data])
    assert ffpic_tpu_torch.load(data, skip_decode=True).width > 0


# --- the four encoders -------------------------------------------------------

def _pics(seed: int, fmt=PixelFormat.RGBA32):
    rgba = _rgba(23, 31, seed)
    if fmt == PixelFormat.BGRA32:
        rgba = np.ascontiguousarray(rgba[..., [2, 1, 0, 3]])
    return (Pic(pixels=torch.from_numpy(rgba), width=31, height=23,
                format=fmt),
            JaxPic(pixels=rgba, width=31, height=23, format=fmt))


@pytest.mark.parametrize("codec", ["BMP", "TGA", "PNM", "GIF"])
@pytest.mark.parametrize("fmt", [PixelFormat.RGBA32, PixelFormat.BGRA32])
def test_encoder_bytes_match_jax(codec, fmt):
    mine, theirs = _pics(21, fmt)
    assert ffpic_tpu_torch.encode(mine, codec, device="cpu") == \
        ffpic_tpu.encode(theirs, codec)


@pytest.mark.parametrize("content", ["few_colours", "transparent",
                                     "animation"])
def test_gif_encoder_bytes_match_jax(content):
    """Past 256 colours (median cut), with a transparent index, and an
    animation with delays and a NETSCAPE loop count."""
    mine, theirs = _pics(22)
    if content == "few_colours":
        base = np.kron(np.random.default_rng(2).integers(0, 5, (4, 4)),
                       np.ones((8, 8))).astype(np.uint8) * 50
        rgba = np.stack([base, base // 2, 255 - base,
                         np.full_like(base, 255)], -1)
        mine = Pic(pixels=rgba, width=32, height=32)
        theirs = JaxPic(pixels=rgba, width=32, height=32)
    elif content == "transparent":
        rgba = mine.pixels.numpy().copy()
        rgba[:9, :, 3] = 0
        mine = Pic(pixels=rgba, width=31, height=23)
        theirs = JaxPic(pixels=rgba, width=31, height=23)
    else:
        rgba = mine.pixels.numpy()
        mine.frames = [Pic(pixels=np.roll(rgba, 7, axis=1), width=31,
                           height=23, delay_ms=70)]
        theirs.frames = [JaxPic(pixels=np.roll(rgba, 7, axis=1), width=31,
                                height=23, delay_ms=70)]
        mine.delay_ms = theirs.delay_ms = 70
    assert ffpic_tpu_torch.encode(mine, "GIF", device="cpu", loops=4) == \
        ffpic_tpu.encode(theirs, "GIF", loops=4)


# --- the writers of testing against PIL --------------------------------------

@pytest.mark.parametrize("writer", [
    "tiff_none", "tiff_lzw", "tiff_lzw_predictor", "tiff_deflate_predictor",
    "tiff_packbits", "tiff_gray_lzw", "tiff_tiles", "tiff_multipage",
    "bmp_24", "bmp_rle8", "bmp_8", "bmp_16_565", "tga_rle_32", "tga_rle_24",
    "psd_rle", "psd_raw", "ico_bmp_png"])
def test_writers_against_pil(writer):
    """Each writer of ``testing`` gives a file PIL decodes to its source
    pixels (PIL ignores a 32 bpp BMP's or an ICO BMP entry's alpha byte
    and the predictor outside LZW and deflate, so those are left out)."""
    rgb = _rgb(33, 47, 17)
    rgba = _rgba(33, 47, 17)
    idx, pal = testing.quantize_332(rgb)
    want, pages = rgb, None
    kind = writer.split("_")[0]
    if writer == "tiff_none":
        data = testing.encode_tiff(rgb, rows_per_strip=10)
    elif writer == "tiff_lzw":
        data = testing.encode_tiff(rgb, "lzw", rows_per_strip=10)
    elif writer == "tiff_lzw_predictor":
        data = testing.encode_tiff(rgb, "lzw", predictor=2)
    elif writer == "tiff_deflate_predictor":
        data = testing.encode_tiff(rgb, "deflate", predictor=2)
    elif writer == "tiff_packbits":
        data = testing.encode_tiff(_blocky(33, 47, 3), "packbits")
        want = _blocky(33, 47, 3)
    elif writer == "tiff_gray_lzw":
        data = testing.encode_tiff(rgb[..., 0], "lzw")
        want = np.repeat(rgb[..., :1], 3, -1)
    elif writer == "tiff_tiles":
        data = testing.encode_tiff(rgb, "lzw", tile=(16, 16))
    elif writer == "tiff_multipage":
        pages = [rgb, rgb[::-1].copy()]
        data = testing.encode_tiff(pages, "deflate")
    elif writer == "bmp_24":
        data = testing.encode_bmp(rgb)
    elif writer in ("bmp_rle8", "bmp_8"):
        data = testing.encode_bmp_palette(idx, pal, rle=writer == "bmp_rle8")
        want = pal[idx]
    elif writer == "bmp_16_565":
        data = testing.encode_bmp(rgb, 16, masks=(0xF800, 0x07E0, 0x001F))
        want = ffpic_tpu.load(data).to_rgba32()[..., :3]
    elif writer == "tga_rle_32":
        data, want = testing.encode_tga(rgba), rgba
    elif writer == "tga_rle_24":
        data = testing.encode_tga(_blocky(33, 47, 4))
        want = _blocky(33, 47, 4)
    elif writer == "psd_rle":
        data, want = testing.encode_psd(rgba), rgba
    elif writer == "psd_raw":
        data = testing.encode_psd(rgb, rle=False)
    else:
        png = testing.encode_png(rgba[:32, :32], 6, 8, filters=(1, 2))
        data = testing.encode_ico([png])
        want = rgba[:32, :32]
    img = Image.open(io.BytesIO(data))
    mode = "RGBA" if want.shape[-1] == 4 else "RGB"
    for k, page in enumerate(pages or [want]):
        if pages:
            img.seek(k)
        np.testing.assert_array_equal(np.asarray(img.convert(mode)), page)
    assert ffpic_tpu.probe(data).name.lower().startswith(kind[:3])


@pytest.mark.parametrize("n,symbols", [(1, 2), (5, 2), (700, 4),
                                       (30000, 256), (120000, 3)])
def test_tiff_lzw_writer_decodes(n, symbols):
    """``testing.lzw_encode_tiff`` round-trips through the port's native
    decoder and the reference's Python one across code-size growth and
    the clear on a full table."""
    from ffpic_tpu.coding import lzw as jax_lzw
    from ffpic_tpu_torch.coding import lzw
    data = np.random.default_rng(n).integers(0, symbols, n) \
        .astype(np.uint8).tobytes()
    enc = testing.lzw_encode_tiff(data)
    assert lzw.lzw_decode_tiff(enc, n) == data
    assert jax_lzw.lzw_decode_tiff(enc, n) == data


# --- probe order -------------------------------------------------------------

def _every_format() -> dict:
    """A file, or a header its probe takes, of every codec the reference
    registers."""
    rgb = _rgb(16, 16, 1)
    vps = bytes([32 << 1, 1])          # NAL type 32 (VPS), layer 0, tid 1
    return {
        "JPG": testing.synth_jpeg_420(16, 16, 80, 1),
        "PNG": testing.encode_png(rgb, 2, 8),
        "GIF": _pil(_palette_img(16, 16), "GIF"),
        "WEBP": testing.webp_fixture("lossless_160x120.webp"),
        "BMP": testing.encode_bmp(rgb),
        "HEIF": (24).to_bytes(4, "big") + b"ftypheic" + bytes(12),
        "AVIF": _pil(Image.fromarray(rgb), "AVIF"),
        "AVIF_ANIMATED": testing.avif_fixture("avis_96x64_grain.avif"),
        "BPG": b"BPG\xfb" + bytes(32),
        "JP2": b"\x00\x00\x00\x0cjP  \r\n\x87\n" + bytes(32),
        "J2K": b"\xff\x4f\xff\x51" + bytes(32),
        "SVG": b'<?xml version="1.0"?>\n<svg width="4" height="4"></svg>',
        "SVG_BARE": b'  <svg width="4" height="4"></svg>',
        "PNM": b"P6\n2 2\n255\n" + bytes(12),
        "TIFF": testing.encode_tiff(rgb),
        "EXR": b"\x76\x2f\x31\x01" + bytes(32),
        "PSD": testing.encode_psd(rgb),
        "ICO": _ico_pil(),
        "HEVC": b"\x00\x00\x00\x01" + vps + bytes(16),
        "HEVC_SHORT_START": b"\x00\x00\x01" + vps + bytes(16),
        "TGA": testing.encode_tga(_rgba(16, 16, 2)),
    }


def test_registered_in_the_reference_order():
    """The port's list is the reference's probe table
    (``ffpic_tpu/formats/all_formats.py``), whatever order either
    package's modules were imported in (the reference's live list
    follows its import order)."""
    import ffpic_tpu.formats.all_formats as table
    with open(table.__file__) as f:
        mods = re.findall(r"^from ffpic_tpu\.formats import (\w+)", f.read(),
                          re.M)
    names = [ffpic_tpu.find_codec("HEVC" if m == "hevc_raw" else m).name
             for m in mods]
    assert ffpic_tpu_torch.registered_codecs() == names == \
        list(registry.ORDER)
    assert sorted(names) == sorted(ffpic_tpu.registered_codecs())


@pytest.mark.parametrize("kind", sorted(_every_format()))
def test_probe_order_matches_jax(kind):
    data = _every_format()[kind]
    got = ffpic_tpu_torch.probe(data).name
    assert got == ffpic_tpu.probe(data).name == kind.split("_")[0].replace(
        "J2K", "JP2")
    if got in ("AVIF", "BPG", "JP2", "SVG", "EXR"):
        # ported: the reference's pixels, or its kind of error
        for mine, ref in ((lambda: ffpic_tpu_torch.load(
                               data, device="cpu").pixels.numpy(),
                           lambda: ffpic_tpu.load(data).np_pixels()),
                          (lambda: ffpic_tpu_torch.decode_batch(
                               [data], device="cpu").numpy(),
                           lambda: np.asarray(ffpic_tpu.decode_batch(
                               [data])))):
            try:
                want = ref()
            except (ValueError, NotImplementedError) as e:
                with pytest.raises(type(e)):
                    mine()
            else:
                np.testing.assert_array_equal(mine(), want)
    elif got == "HEVC":
        # a VPS and no picture: ported, it raises the reference's error
        for load in (ffpic_tpu.load,
                     lambda d: ffpic_tpu_torch.load(d, device="cpu"),
                     lambda d: ffpic_tpu_torch.decode_batch([d],
                                                            device="cpu")):
            with pytest.raises(ValueError, match="no decodable HEVC"):
                load(data)


@pytest.mark.parametrize("data", [b"", b"\x00" * 4, b"hello world, not an "
                                  b"image", bytes(range(7))])
def test_only_unknown_bytes_are_unrecognized(data):
    for probe in (ffpic_tpu.probe, ffpic_tpu_torch.probe):
        with pytest.raises(ValueError, match="unrecognized"):
            probe(data)
    with pytest.raises(ValueError, match="unrecognized"):
        ffpic_tpu_torch.decode_batch([data], device="cpu")


# --- deliberate differences on corrupt files ---------------------------------

def _tiff_with_count(count: int) -> bytes:
    """A TIFF of a few hundred bytes whose StripOffsets tag claims
    ``count`` LONG values at an offset inside the file."""
    data = bytearray(testing.encode_tiff(_rgb(8, 8, 1)))
    ifd = struct.unpack_from("<I", data, 4)[0]
    n = struct.unpack_from("<H", data, ifd)[0]
    for i in range(n):
        off = ifd + 2 + 12 * i
        if struct.unpack_from("<H", data, off)[0] == 273:
            struct.pack_into("<I", data, off + 4, count)
            struct.pack_into("<I", data, off + 8, 8)
    return bytes(data)


def test_tiff_oversized_count_raises_before_building_a_format(monkeypatch):
    """A count of 2**30 entries: the port raises ``ValueError`` before any
    ``struct`` format is built from it (the reference builds a format
    string of a gigabyte first, ``ffpic_tpu/formats/tiff.py:66``, and is
    not run here)."""
    data = _tiff_with_count(1 << 30)
    assert len(data) < 1024
    built = []
    real = struct.unpack_from

    def spy(fmt, *a, **k):
        built.append(len(fmt))
        return real(fmt, *a, **k)
    monkeypatch.setattr(tiff_tags.struct, "unpack_from", spy)
    with pytest.raises(ValueError, match="claims 1073741824 values"):
        ffpic_tpu_torch.load(data, device="cpu")
    assert max(built) < 64
    # a count that fits decodes as the reference does
    ok = testing.encode_tiff(_rgb(8, 8, 1))
    np.testing.assert_array_equal(
        ffpic_tpu_torch.load(ok, device="cpu").to_rgba32(),
        ffpic_tpu.load(ok).to_rgba32())


def test_psd_row_counts_past_the_end_raise():
    data = bytearray(testing.encode_psd(_rgb(8, 8, 1)))
    struct.pack_into(">I", data, 14, 1 << 28)           # height
    struct.pack_into(">I", data, 18, 1)                 # width
    with pytest.raises(ValueError, match="row counts past the end"):
        ffpic_tpu_torch.load(bytes(data), device="cpu")


@pytest.mark.parametrize("codec", ["GIF", "BMP", "PSD"])
def test_pixel_budget(codec):
    """A header that claims more than 2**28 pixels raises ``ValueError``
    before the picture is allocated; its header-only parse still works."""
    if codec == "GIF":
        data = bytearray(_pil(_palette_img(16, 16), "GIF"))
        struct.pack_into("<HH", data, 6, 65535, 65535)
    elif codec == "BMP":
        data = bytearray(testing.encode_bmp_palette(*_idx(8), rle=True))
        struct.pack_into("<ii", data, 18, 1 << 15, 1 << 15)
    else:
        data = bytearray(testing.encode_psd(_rgb(8, 8, 1)))
        struct.pack_into(">II", data, 14, 1 << 15, 1 << 15)
    with pytest.raises(ValueError, match="pixel budget"):
        ffpic_tpu_torch.load(bytes(data), device="cpu")
    pic = ffpic_tpu_torch.load(bytes(data), skip_decode=True)
    assert pic.width * pic.height > staging.MAX_PIXELS


def test_truncated_pnm_header_is_value_error():
    """The reference lets ``StopIteration`` out of a PNM header cut short;
    the port's registry turns it into ``ValueError``."""
    with pytest.raises(StopIteration):
        ffpic_tpu.load(b"P6\n12")
    with pytest.raises(ValueError, match="corrupt PNM"):
        ffpic_tpu_torch.load(b"P6\n12", device="cpu")


def test_gif_min_code_size_over_12_raises():
    """The native GIF decoder's tables hold codes of 12 bits: the port's
    wrapper refuses a larger minimum code size, which the reference's C
    takes and writes past its tables with (the reference is not run)."""
    data = bytearray(ffpic_tpu_torch.encode(
        Pic(pixels=_rgba(16, 16, 4) | 255, width=16, height=16), "GIF",
        device="cpu"))
    at = 13 + 3 * (2 << (data[10] & 7))      # the image descriptor
    assert data[at] == 0x2C and not data[at + 9] & 0x80
    data[at + 10] = 13                       # its LZW minimum code size
    with pytest.raises(ValueError, match="minimum code size"):
        ffpic_tpu_torch.load(bytes(data), device="cpu")


# --- corruption --------------------------------------------------------------

CORRUPT = ["bmp_rle8", "bmp_pil_24", "tga_rle_32", "pnm_pil_p6", "pnm_p2",
           "gif_pil_anim_disposal", "psd_rle_rgb", "tiff_lzw_predictor",
           "tiff_pil_packbits", "tiff_pil_deflate", "tiff_jpeg_strips",
           "tiff_tiles", "ico_png_then_bmp", "ico_palette_mask"]


@pytest.mark.parametrize("name", CORRUPT)
def test_corruption_gives_value_error(name):
    """Random byte changes from a fixed seed: each load decodes or raises
    ``ValueError`` or ``NotImplementedError``, nothing else; one more
    file a case carries a tag count of 2**30 (TIFF) or a header cut
    short."""
    data = _data(name)
    rng = np.random.default_rng(sum(map(ord, name)))
    trials = [bytes(data[:len(data) // 3]), bytes(data[:20])]
    for _ in range(25):
        d = bytearray(data)
        for _ in range(int(rng.integers(1, 12))):
            d[int(rng.integers(0, len(d)))] = int(rng.integers(0, 256))
        trials.append(bytes(d))
    if name.startswith("tiff"):
        trials.append(_tiff_with_count(1 << 30))
    for d in trials:
        try:
            ffpic_tpu_torch.load(d, device="cpu")
        except (ValueError, NotImplementedError):
            pass


# --- decode_batch ------------------------------------------------------------

def _members(h: int, w: int) -> dict:
    rgb = _rgb(h, w, 30)
    rgba = _rgba(h, w, 31)
    idx, pal = testing.quantize_332(_rgb(h, w, 32))
    return {
        "bmp": testing.encode_bmp(rgb),
        "bmp_rle8": testing.encode_bmp_palette(idx, pal, rle=True),
        "gif": ffpic_tpu_torch.encode(Pic(pixels=rgba, width=w, height=h),
                                      "GIF", device="cpu"),
        "tga": testing.encode_tga(rgba),
        "pnm": _pil(Image.fromarray(_rgb(h, w, 33)), "PPM"),
        "psd": testing.encode_psd(rgba),
        "tiff_lzw": testing.encode_tiff(_rgb(h, w, 34), "lzw", predictor=2,
                                        rows_per_strip=16),
        "tiff_jpeg": testing.encode_tiff(_rgb(h, w, 35), "jpeg",
                                         rows_per_strip=16),
        "ico": testing.encode_ico([testing.encode_png(
            _rgba(h, w, 36), 6, 8, filters=(1, 2)), _rgba(16, 16, 37)]),
        "jpeg": testing.synth_jpeg_420(h, w, 85, 38),
        "png": testing.encode_png(rgba, 6, 8, filters=(0, 1, 2, 3, 4)),
    }


def _batch_both(srcs, **kw):
    got = ffpic_tpu_torch.decode_batch(srcs, device="cpu", **kw)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
    return got.numpy(), np.asarray(ffpic_tpu.decode_batch(srcs, **kw))


@pytest.mark.parametrize("mix", ["host_only", "with_jpeg_png"])
def test_decode_batch_matches_jax(mix, monkeypatch):
    """Exact at size=None (the JPEG members' and the TIFF's JPEG strips'
    colour up to XLA's contraction choice); the host members staged in
    one copy."""
    m = _members(40, 56)
    names = ["bmp", "gif", "tga", "pnm", "psd", "tiff_lzw", "ico",
             "bmp_rle8"]
    if mix == "with_jpeg_png":
        names = ["jpeg", "bmp", "png", "tiff_jpeg", "gif", "jpeg", "ico"]
    srcs = [m[k] for k in names]
    from ffpic_tpu_torch import pipeline
    staged = []
    real = pipeline.stage_rgba

    def spy(arrays, device):
        staged.append(len(arrays))
        return real(arrays, device)
    monkeypatch.setattr(pipeline, "stage_rgba", spy)
    got, want = _batch_both(srcs)
    assert got.shape == (len(srcs), 40, 56, 4)
    hosted = [k for k in names if k not in ("jpeg", "png", "ico")]
    assert staged == [len(hosted)]
    if mix == "host_only":
        np.testing.assert_array_equal(got, want)
    else:
        testing.assert_equal_up_to_contraction(
            lambda: ffpic_tpu_torch.decode_batch(srcs, device="cpu"), want)


def test_decode_batch_sized_matches_jax():
    """Members of several sizes at size=(224, 224): within 1 LSB."""
    a, b = _members(40, 56), _members(33, 47)
    srcs = [a["bmp"], b["gif"], a["tiff_jpeg"], b["psd"], a["jpeg"],
            b["ico"], a["tga"], b["png"], b["pnm"], a["bmp_rle8"]]
    got, want = _batch_both(srcs, size=(224, 224))
    assert got.shape == (len(srcs), 224, 224, 4)
    assert np.abs(got.astype(int) - want).max() <= 1


def test_decode_batch_takes_the_first_picture():
    """A GIF animation and a multipage TIFF give their first picture, as
    the reference's batch does."""
    srcs = [_data("gif_pil_anim_disposal"), _data("tiff_multipage_mixed")]
    for s in srcs:
        first = ffpic_tpu_torch.load(s, device="cpu")
        assert first.n_frames > 1
        got = ffpic_tpu_torch.decode_batch([s, s], device="cpu")
        np.testing.assert_array_equal(got[1].numpy(), first.to_rgba32())
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(ffpic_tpu.decode_batch([s, s])))


@pytest.mark.parametrize("name", ["gif", "bmp", "tiff"])
def test_decode_batch_corrupt_member_is_value_error(name):
    srcs = [_members(40, 56)["bmp"]]
    bad = {"gif": b"GIF89a" + bytes(64),
           "bmp": b"BM" + bytes(60),
           "tiff": _tiff_with_count(1 << 30)}[name]
    with pytest.raises(ValueError):
        ffpic_tpu_torch.decode_batch(srcs + [bad], device="cpu")


# --- reference faults the port mirrors on purpose (ROADMAP.md Queue 3) -------

def test_mirrored_tiff_predictor_whatever_the_compression():
    """Both packages undo a horizontal predictor on uncompressed and
    PackBits strips too; TIFF 6.0 defines the predictor for LZW, and
    libtiff (through PIL) leaves such strips as stored."""
    rgb = _rgb(12, 20, 6)
    for comp in ("none", "packbits"):
        data = testing.encode_tiff(rgb, comp, predictor=2)
        got = ffpic_tpu_torch.load(data, device="cpu").to_rgba32()
        np.testing.assert_array_equal(got, ffpic_tpu.load(data).to_rgba32())
        np.testing.assert_array_equal(got[..., :3], rgb)
        pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        assert not np.array_equal(pil, rgb)


def test_mirrored_bmp_32bpp_unused_byte_as_alpha():
    """A 32 bpp BI_RGB BMP's fourth byte, which the format leaves unused,
    is read as alpha by both packages (PIL reads 255)."""
    rgba = _rgba(9, 13, 7)
    data = testing.encode_bmp(rgba, 32)
    got = ffpic_tpu_torch.load(data, device="cpu").to_rgba32()
    np.testing.assert_array_equal(got, ffpic_tpu.load(data).to_rgba32())
    np.testing.assert_array_equal(got, rgba)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    assert (pil[..., 3] == 255).all() and not (rgba[..., 3] == 255).all()


def _gif_disposal_2() -> bytes:
    """An 8 x 8 screen whose background colour (index 0) is not black: a
    full frame of index 1 with disposal 2, then a 2 x 2 frame of index
    2 at (0, 0)."""
    from ffpic_tpu_torch.formats.gif import _lzw_encode_gif, _sub_blocks
    pal = bytes([200, 100, 50, 10, 20, 30, 250, 250, 250, 0, 0, 0])
    out = bytearray(b"GIF89a" + struct.pack("<HHBBB", 8, 8, 0x81, 0, 0) + pal)
    for disposal, (w, h), index in ((2, (8, 8), 1), (0, (2, 2), 2)):
        out += struct.pack("<BBBBHBB", 0x21, 0xF9, 4, disposal << 2, 5, 0, 0)
        out += struct.pack("<BHHHHB", 0x2C, 0, 0, w, h, 0) + bytes([2])
        out += _sub_blocks(_lzw_encode_gif(np.full((h, w), index), 2))
    return bytes(out + b"\x3b")


def test_mirrored_gif_disposal_2_clears_to_transparent():
    """Disposal 2 ("restore to background colour") leaves the frame's box
    as (0, 0, 0, 0) in both packages, not the background colour."""
    data = _gif_disposal_2()
    got = ffpic_tpu_torch.load_all(data, device="cpu")
    want = ffpic_tpu.load_all(data)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.to_rgba32(), w.to_rgba32())
    second = got[1].to_rgba32()
    np.testing.assert_array_equal(second[:2, :2], [[[250, 250, 250, 255]] * 2]
                                  * 2)
    assert (second[2:] == 0).all() and (second[:, 2:] == 0).all()


# --- the Python JPEG entropy decoder and the checksums' references ----------

def _jpeg_oracle_files() -> dict:
    rgb = _rgb(72, 88, 21)
    return {
        "baseline_420": _pil(Image.fromarray(rgb), "JPEG", quality=85),
        "dri": testing.encode_jpeg(rgb, 80, restart_interval=3),
        "baseline_422": _pil(Image.fromarray(rgb), "JPEG", quality=90,
                             subsampling="4:2:2"),
        "progressive_444": _pil(Image.fromarray(rgb), "JPEG", quality=85,
                                progressive=True, subsampling="4:4:4"),
    }


@pytest.mark.parametrize("kind", sorted(_jpeg_oracle_files()))
def test_jpg_host_oracle_matches_native(kind, monkeypatch):
    """``formats/jpg_host.py`` (the Python ``JpegEntropyDecoder`` over
    ``HuffLUT`` tables and ``ScanBitReader``) decodes each scan that the
    port's ``jpg.parse_and_decode`` hands the native Huffman decoder to
    the same coefficients: zigzag planes, restored by
    ``dezigzag_planes``, equal to the native raster planes."""
    from ffpic_tpu_torch import native
    from ffpic_tpu_torch.formats import jpg, jpg_host
    scans = []
    real = native.jpeg_decode_scan

    def spy(data, dht_raw, comps, scan_comps, ss, se, ah, al, ri, *rest):
        scans.append((data, dict(dht_raw), scan_comps, ss, se, ah, al, ri))
        return real(data, dht_raw, comps, scan_comps, ss, se, ah, al, ri,
                    *rest)

    monkeypatch.setattr(native, "jpeg_decode_scan", spy)
    j, _ = jpg.parse_and_decode(_jpeg_oracle_files()[kind])
    assert scans and (len(scans) > 1) == (kind == "progressive_444")
    zz = [np.zeros_like(c) for c in j.coeffs]
    dec = jpg_host.JpegEntropyDecoder(j.comps, zz)
    for data, dht_raw, scan_comps, ss, se, ah, al, ri in scans:
        dec.restart_interval = ri
        luts = {key: jpg_host.HuffLUT(*v) for key, v in dht_raw.items()}
        dec.decode_scan(data, scan_comps,
                        {t: lut for (c, t), lut in luts.items() if c == 0},
                        {t: lut for (c, t), lut in luts.items() if c == 1},
                        ss, se, ah, al)
    for native_c, oracle in zip(j.coeffs, zz):
        np.testing.assert_array_equal(
            native_c.reshape(*native_c.shape[:2], 8, 8),
            jpg_host.dezigzag_planes(oracle))
    assert any(c.any() for c in zz)


@pytest.mark.parametrize("n", [0, 1, 255, 5553, 70000])
def test_checksum_references_match_zlib(n):
    """``crc32_py`` and ``adler32_py`` equal zlib's, from a start value
    too (Adler's sums wrap past 65521 at the larger sizes)."""
    import zlib
    from ffpic_tpu.utils import checksum as jax_checksum
    from ffpic_tpu_torch.utils import checksum
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    for start_crc, start_adler in ((0, 1), (0x1234ABCD, 0xFFF0FFF0)):
        want_crc = zlib.crc32(data, start_crc)
        want_adler = zlib.adler32(data, start_adler)
        assert checksum.crc32_py(data, start_crc) == want_crc == \
            checksum.crc32(data, start_crc)
        assert checksum.adler32_py(data, start_adler) == want_adler == \
            checksum.adler32(data, start_adler)
        assert jax_checksum.crc32_py(data, start_crc) == want_crc
