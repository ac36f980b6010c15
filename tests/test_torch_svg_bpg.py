"""The port's SVG codec (``formats/svg.py`` with ``svg_raster.py``) and
BPG header parser (``formats/bpg.py``) held against ffpic_tpu's on the
same bytes, on the CPU, with tolerance 0: both run the same numpy.

SVG: documents of paths, curves, arcs, gradients, transforms, strokes,
opacity, ``use``/``defs`` and viewBoxes (``testing.svg_still`` and the
cases of ``tests/test_svg.py``): ``load``'s pixels and meta, ``info()``
and the header-only parse equal the JAX package's; malformed documents
raise ``ValueError`` in both.  BPG: headers of every pixel format, bit
depth, alpha and extension tags give the reference's meta and
``info()`` under ``skip_decode``; a pixel decode raises
``NotImplementedError`` in ``load`` and in ``decode_batch`` alike, as
the reference's does.
"""

import numpy as np
import pytest
import torch

import ffpic_tpu
import ffpic_tpu_torch
from ffpic_tpu.formats import svg_raster as jax_raster
from ffpic_tpu_torch import testing
from ffpic_tpu_torch.formats import svg_raster
import reference_native  # noqa: F401  (readies ffpic_tpu first)


def _doc(body: str, w: int = 48, h: int = 40, extra: str = "") -> bytes:
    return (f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" '
            f'height="{h}" {extra}>{body}</svg>').encode()


SVGS = {
    "still_0": lambda: testing.svg_still(96, 64, 0),
    "still_1": lambda: testing.svg_still(80, 60, 1),
    "evenodd_donut": lambda: _doc(
        '<path fill-rule="evenodd" d="M4 4 H40 V36 H4 Z M12 12 H30 V28 H12 '
        'Z" fill="#808000"/>'),
    "curves": lambda: _doc(
        '<path d="M2 30 C 10 0, 30 0, 46 30 S 30 38, 20 34 Q 10 30 2 30 Z" '
        'fill="rgb(10, 200, 30)" stroke="navy" stroke-width="1.5"/>'),
    "arcs": lambda: _doc(
        '<path d="M10 20 A 8 6 30 1 1 30 20 a 5 5 0 0 0 10 0" fill="none" '
        'stroke="red" stroke-width="2" stroke-linecap="square"/>'),
    "transforms": lambda: _doc(
        '<g transform="translate(24 20) rotate(30) scale(1.5 0.8)">'
        '<rect x="-8" y="-6" width="16" height="12" fill="teal"/>'
        '<g transform="matrix(1 0.2 -0.3 1 2 3) skewX(10)">'
        '<circle r="5" fill="orange" fill-opacity="0.7"/></g></g>'),
    "gradients": lambda: _doc(
        '<defs><linearGradient id="g" gradientUnits="userSpaceOnUse" '
        'x1="0" y1="0" x2="48" y2="40"><stop offset="0" stop-color="blue"/>'
        '<stop offset="0.5" stop-color="#ff0" stop-opacity="0.5"/>'
        '<stop offset="1" stop-color="yellow"/></linearGradient>'
        '<radialGradient id="r" cx="0.3" cy="0.3" r="0.6">'
        '<stop offset="0" stop-color="white"/><stop offset="1" '
        'stop-color="black"/></radialGradient></defs>'
        '<rect width="48" height="40" fill="url(#g)"/>'
        '<ellipse cx="24" cy="20" rx="14" ry="10" fill="url(#r)"/>'),
    "opacity_style_use": lambda: _doc(
        '<defs><rect id="r" width="10" height="10"/></defs>'
        '<g opacity="0.5" style="fill:#c04020">'
        '<use href="#r" x="4" y="4"/><use href="#r" x="20" y="12"/></g>'
        '<polygon points="30,2 46,18 34,30" fill="green" '
        'display="none"/><polyline points="2,38 12,28 22,36 46,24" '
        'fill="none" stroke="black" stroke-width="3" '
        'stroke-linejoin="round"/>'),
    "viewbox": lambda: _doc('<rect x="1" y="1" width="10" height="7" '
                            'rx="2" fill="purple"/><line x1="0" y1="16" '
                            'x2="24" y2="0" stroke="lime"/>',
                            extra='viewBox="0 0 24 16"'),
    "viewbox_only": lambda: (b'<svg xmlns="http://www.w3.org/2000/svg" '
                             b'viewBox="0 0 30 20"><circle cx="15" cy="10" '
                             b'r="8" fill="gold"/></svg>'),
    "malformed_path": lambda: _doc('<path d="M garbage !! 12 13 L"/>'
                                   '<rect width="4" height="4" fill="red"/>'),
}


@pytest.mark.parametrize("name", sorted(SVGS))
def test_svg_load_matches_jax(name):
    data = SVGS[name]()
    want = ffpic_tpu.load(data)
    got = ffpic_tpu_torch.load(data, device="cpu")
    assert got.codec == want.codec == "SVG"
    assert (got.width, got.height, got.pitch) == \
        (want.width, want.height, want.pitch)
    assert isinstance(got.pixels, torch.Tensor)
    np.testing.assert_array_equal(got.pixels.numpy(), want.np_pixels())
    assert got.meta == want.meta
    assert ffpic_tpu_torch.info(got) == ffpic_tpu.info(want)
    head = ffpic_tpu_torch.load(data, skip_decode=True)
    assert head.pixels is None
    assert head.meta == ffpic_tpu.load(data, skip_decode=True).meta


@pytest.mark.parametrize("bad", [
    b"<svg width='4' height='4'><rect></svg>",
    b"<?xml version='1.0'?>\n<svg width='4'",
])
def test_malformed_svg_raises_value_error_as_jax(bad):
    for load in (ffpic_tpu.load,
                 lambda d: ffpic_tpu_torch.load(d, device="cpu")):
        with pytest.raises(ValueError):
            load(bad)


def test_svg_raster_helpers_match_jax():
    """The parsers the rasterizer is built on give the reference's
    values."""
    for s in ("#abc", "#a1b2c3", "rgb(10%, 20, 30)", "none", "tomato",
              "transparent", "url(#g)", "bogus"):
        assert svg_raster.parse_color(s) == jax_raster.parse_color(s)
    for s in ("translate(3 4) scale(2)", "rotate(45 10 10) skewY(5)",
              "matrix(1,2,3,4,5,6)"):
        np.testing.assert_array_equal(svg_raster.parse_transform(s),
                                      jax_raster.parse_transform(s))
    d = "M0 0 L10 0 10 10 Z m 2 2 h 3 v 3 c 1 1 2 2 3 3 t 4 4 A 2 3 0 0 1 9 9"
    got, want = svg_raster.parse_path(d, 2.0), jax_raster.parse_path(d, 2.0)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# --- BPG ------------------------------------------------------------------

BPGS = {
    "420_8": lambda: testing.bpg_header(1920, 1080),
    "gray_alpha_10": lambda: testing.bpg_header(300, 17, 0, True, 10),
    "444_12_ext": lambda: testing.bpg_header(
        70000, 5, 3, False, 12, ((1, b"exif-data"), (5, b"\x00" * 200))),
}


@pytest.mark.parametrize("name", sorted(BPGS))
def test_bpg_header_matches_jax_and_pixels_raise(name):
    data = BPGS[name]()
    got = ffpic_tpu_torch.load(data, skip_decode=True)
    want = ffpic_tpu.load(data, skip_decode=True)
    assert got.codec == want.codec == "BPG"
    assert (got.width, got.height, got.pitch) == \
        (want.width, want.height, want.pitch)
    assert got.meta == want.meta and got.pixels is None
    assert ffpic_tpu_torch.info(got) == ffpic_tpu.info(want)
    for decode in (lambda: ffpic_tpu.load(data),
                   lambda: ffpic_tpu_torch.load(data, device="cpu"),
                   lambda: ffpic_tpu.decode_batch([data]),
                   lambda: ffpic_tpu_torch.decode_batch([data],
                                                        device="cpu")):
        with pytest.raises(NotImplementedError, match="BPG"):
            decode()


# --- the apps reach the still codecs through the registry --------------------

def test_picinfo_and_transcode_reach_the_still_codecs(tmp_path, capsys):
    """``picinfo`` (with and without ``-s``) prints the reference's text
    for a JPEG 2000, an OpenEXR, an SVG and a BPG file, and ``transcode
    -c EXR`` writes the reference's bytes."""
    import io
    from PIL import Image
    from ffpic_tpu.apps import picinfo as jax_picinfo
    from ffpic_tpu.apps import transcode as jax_transcode
    from ffpic_tpu_torch.apps import picinfo, transcode
    buf = io.BytesIO()
    Image.fromarray(testing.synth_rgb(40, 56, 2)).save(
        buf, "JPEG2000", irreversible=False)
    blobs = {"a.jp2": buf.getvalue(),
             "b.exr": testing.still_fixture("exr_dwaa_64x48.exr"),
             "c.svg": testing.svg_still(40, 30, 1),
             "d.bpg": testing.bpg_header(40, 30)}
    paths = []
    for name, data in blobs.items():
        (tmp_path / name).write_bytes(data)
        paths.append(str(tmp_path / name))

    def run(main, argv):
        rc = main(argv)
        cap = capsys.readouterr()
        return rc, cap.out, cap.err
    for flag in ([], ["-s"]):
        want = run(jax_picinfo.main, flag + paths)
        assert run(picinfo.main, flag + ["--device", "cpu"] + paths) == want
        assert "codec EXR" in want[1] and "codec JP2" in want[1]
    for src in paths[:3]:
        mine, ref = tmp_path / "mine.exr", tmp_path / "ref.exr"
        want = run(jax_transcode.main, [src, "-c", "EXR", "-o", str(ref)])
        got = run(transcode.main, [src, "-c", "EXR", "-o", str(mine),
                                   "--device", "cpu"])
        assert got == (want[0], want[1].replace(str(ref), str(mine)),
                       want[2]) and got[0] == 0
        assert mine.read_bytes() == ref.read_bytes()
