"""The port's apps (``picinfo``, ``transbmp``, ``transcode``, ``show``) and
display sinks held against ffpic_tpu's, on the CPU (``--device cpu``):
the same lines on stdout and stderr, the same exit codes and the same
bytes in the files they write.  ``picinfo --skip_decode`` runs with CUDA
hidden.  Also: every module of the port imports, and the new codecs
decode, with the JAX package blocked and no jax loaded.
"""

import functools
import io
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import ffpic_tpu
import ffpic_tpu_torch
from ffpic_tpu import display as jax_display
from ffpic_tpu import native as jax_native
from ffpic_tpu.apps import picinfo as jax_picinfo
from ffpic_tpu.apps import show as jax_show
from ffpic_tpu.apps import transbmp as jax_transbmp
from ffpic_tpu.apps import transcode as jax_transcode
from ffpic_tpu_torch import display, testing
from ffpic_tpu_torch.apps import picinfo, show, transbmp, transcode
from ffpic_tpu_torch.formats.pic import Pic
import reference_native  # noqa: F401  (readies ffpic_tpu first)

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _native_first():
    jax_native.available()


@functools.lru_cache(maxsize=None)
def _blobs() -> dict:
    """One small file of each new codec, an animation and a multipage
    TIFF, a PNG, and bytes no codec takes."""
    rgb = testing.synth_rgb(21, 30, 4)
    rgba = np.dstack([rgb, np.full((21, 30), 200, np.uint8)])
    idx, pal = testing.quantize_332(rgb)
    anim = Pic(pixels=rgba, width=30, height=21, delay_ms=50, frames=[
        Pic(pixels=rgba[::-1].copy(), width=30, height=21, delay_ms=50)])
    b = io.BytesIO()
    Image.fromarray(rgb).save(b, "PPM")
    blobs = {
        "a.bmp": testing.encode_bmp_palette(idx, pal, rle=True),
        "b.gif": ffpic_tpu_torch.encode(anim, "GIF", device="cpu"),
        "c.tga": testing.encode_tga(rgba),
        "d.ppm": b.getvalue(),
        "e.psd": testing.encode_psd(rgb),
        "f.tif": testing.encode_tiff([rgb, rgb[::-1].copy()], "lzw",
                                     predictor=2),
        "g.ico": testing.encode_ico([testing.encode_png(rgba, 6, 8,
                                                        filters=(1, 2)),
                                     rgba[:16, :16]]),
        "h.png": testing.encode_png(rgba),
        "junk.bin": b"not an image at all",
    }
    return blobs


def _files(d: pathlib.Path) -> dict:
    """``_blobs`` written into ``d``: {name: path}."""
    out = {}
    for name, data in _blobs().items():
        (d / name).write_bytes(data)
        out[name] = str(d / name)
    return out


@pytest.fixture
def files(tmp_path):
    return _files(tmp_path)


def _run(main, argv, capsys):
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


@pytest.mark.parametrize("skip", [False, True])
def test_picinfo_prints_what_the_reference_prints(files, skip, capsys,
                                                  monkeypatch):
    paths = list(files.values())
    flag = ["-s"] if skip else []
    want = _run(jax_picinfo.main, flag + paths, capsys)
    if skip:     # a header-only parse needs no CUDA
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        got = _run(picinfo.main, flag + paths, capsys)
    else:
        got = _run(picinfo.main, flag + ["--device", "cpu"] + paths, capsys)
    assert got == want
    assert got[0] == 1 and "junk.bin: unrecognized image format" in got[2]
    assert "codec TIFF" in got[1] and "+1 extra frame(s)" in got[1]


def test_picinfo_decode_needs_cuda_by_default(files, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        picinfo.main([files["a.bmp"]])


@pytest.mark.parametrize("name", ["a.bmp", "b.gif", "c.tga", "d.ppm",
                                  "e.psd", "f.tif", "g.ico", "h.png"])
def test_transbmp_writes_the_reference_bytes(files, name, tmp_path, capsys):
    src = files[name]
    out_mine, out_ref = tmp_path / "mine.bmp", tmp_path / "ref.bmp"
    want = _run(jax_transbmp.main, [src, "-o", str(out_ref)], capsys)
    got = _run(transbmp.main, [src, "-o", str(out_mine), "--device", "cpu"],
               capsys)
    assert got == (want[0], want[1].replace(str(out_ref), str(out_mine)),
                   want[2])
    assert out_mine.read_bytes() == out_ref.read_bytes()
    # without -o: the bmpwriter's name beside the input
    rc, text, _ = _run(transbmp.main, [src, "--device", "cpu"], capsys)
    pic = ffpic_tpu.load(src)
    named = pathlib.Path(f"{src} ({pic.width} * {pic.height}).bmp")
    assert rc == 0 and named.read_bytes() == out_ref.read_bytes()
    assert text == f"wrote {named} ({pic.width}x{pic.height})\n"


def test_transbmp_reports_unrecognized(files, capsys):
    got = _run(transbmp.main, [files["junk.bin"], "--device", "cpu"], capsys)
    assert got == _run(jax_transbmp.main, [files["junk.bin"]], capsys)
    assert got[0] == 1


@pytest.mark.parametrize("codec,src", [
    ("bmp", "e.psd"), ("png", "a.bmp"), ("tga", "g.ico"), ("pnm", "f.tif"),
    ("gif", "c.tga"), ("jpg", "d.ppm"), ("gif", "b.gif"),
    ("nonesuch", "a.bmp"), ("psd", "a.bmp"), ("bmp", "junk.bin")])
def test_transcode_writes_the_reference_bytes(files, codec, src, tmp_path,
                                              capsys):
    out_mine, out_ref = tmp_path / "mine.out", tmp_path / "ref.out"
    want = _run(jax_transcode.main, [files[src], "-c", codec, "-o",
                                     str(out_ref)], capsys)
    got = _run(transcode.main, [files[src], "-c", codec, "-o",
                                str(out_mine), "--device", "cpu"], capsys)
    if codec == "nonesuch":     # the registry's list of codecs is in both
        assert got[0] == want[0] == 1
        assert "no codec named 'nonesuch'" in got[2]
        return
    assert got == (want[0], want[1].replace(str(out_ref), str(out_mine)),
                   want[2])
    if want[0] == 0:
        assert out_mine.read_bytes() == out_ref.read_bytes()
    else:
        assert not out_mine.exists()


@pytest.mark.parametrize("sink", ["bmp", "png"])
def test_show_file_sinks_write_the_reference_bytes(files, sink, tmp_path,
                                                   capsys):
    """``show --sink bmp|png`` writes a file a frame, named after the
    input, with the reference's bytes (the GIF has two frames)."""
    for name in ("b.gif", "e.psd"):
        want = _run(jax_show.main, [files[name], "--sink", sink], capsys)
        written = {p: pathlib.Path(p).read_bytes() for p in
                   [line[len("wrote "):] for line in want[1].splitlines()]}
        for p in written:
            os.remove(p)
        got = _run(show.main, [files[name], "--sink", sink, "--device",
                               "cpu"], capsys)
        assert got == want
        assert {p: pathlib.Path(p).read_bytes() for p in written} == written
        assert len(written) == (2 if name == "b.gif" else 1)


def test_display_registry_and_window_sink(monkeypatch, tmp_path):
    """The same sinks as the reference's; ``window`` imports PIL when it
    is called and shows the RGBA pixels."""
    assert sorted(display._sinks) == sorted(jax_display._sinks)
    with pytest.raises(KeyError, match="no display sink"):
        display.get_sink("sdl")
    shown = []
    monkeypatch.setattr(Image.Image, "show",
                        lambda self, title=None: shown.append(
                            (np.asarray(self), title)))
    rgba = np.dstack([testing.synth_rgb(5, 6, 1),
                      np.full((5, 6), 9, np.uint8)])
    pic = Pic(pixels=torch.from_numpy(rgba), width=6, height=5)
    assert display.show(pic, sink="window", title="t") is None
    assert shown[0][1] == "t"
    np.testing.assert_array_equal(shown[0][0], rgba)
    monkeypatch.chdir(tmp_path)
    assert display.show(pic, sink="bmp") == "out (6 * 5).bmp"
    assert (tmp_path / "out (6 * 5).bmp").read_bytes() == \
        ffpic_tpu.encode(ffpic_tpu.Pic(pixels=rgba, width=6, height=5), "BMP")


def test_new_modules_need_neither_jax_nor_ffpic_tpu(tmp_path):
    """With the JAX package blocked, every module of the port imports
    (walked with ``pkgutil``), each new codec's file loads and decodes in
    a batch, and picinfo, transbmp, transcode and show run; no module of
    ffpic_tpu and no jax is loaded."""
    paths = _files(tmp_path)
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['ffpic_tpu'] = None\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import ffpic_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    ffpic_tpu_torch.__path__, 'ffpic_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "need = {'ffpic_tpu_torch.coding.lzw', 'ffpic_tpu_torch.display',\n"
        "        'ffpic_tpu_torch.apps.picinfo',\n"
        "        'ffpic_tpu_torch.apps.show',\n"
        "        'ffpic_tpu_torch.apps.transbmp',\n"
        "        'ffpic_tpu_torch.apps.transcode',\n"
        "        'ffpic_tpu_torch.make_avif_fixtures'} | {\n"
        "    'ffpic_tpu_torch.formats.' + c for c in\n"
        "    ('bmp', 'gif', 'tga', 'pnm', 'psd', 'tiff', 'ico', 'jp2',\n"
        "     'exr', 'svg', 'svg_raster', 'bpg', 'avif', 'av1_recon',\n"
        "     'av1_intra', 'av1_loopfilter', 'av1_cdef', 'av1_lr',\n"
        "     'av1_superres', 'av1_mc', 'jpg_host')} | {\n"
        "    'ffpic_tpu_torch.coding.' + c for c in\n"
        "    ('huffman', 'deflate', 'jpeg2000', 'exr_codec', 'av1_tile',\n"
        "     'av1_msac', 'av1_headers', 'av1_itx', 'av1_mv', 'av1_refs',\n"
        "     'av1_grain', 'av1_grain_tables', 'av1_inter', 'av1_enc',\n"
        "     'av1_msac_enc')}\n"
        "assert need <= set(names), need - set(names)\n"
        f"paths = {[p for k, p in sorted(paths.items())
                    if k != 'junk.bin']!r}\n"
        "from ffpic_tpu_torch import decode_batch, load\n"
        "for p in paths:\n"
        "    assert load(p, device='cpu').pixels is not None, p\n"
        "out = decode_batch(paths, size=(16, 16), device='cpu')\n"
        "assert tuple(out.shape) == (len(paths), 16, 16, 4), out.shape\n"
        "from ffpic_tpu_torch.apps import picinfo, show, transbmp, transcode\n"
        f"d = {str(tmp_path)!r}\n"
        "assert picinfo.main(['--device', 'cpu'] + paths) == 0\n"
        "assert transbmp.main([paths[0], '-o', d + '/o.bmp',\n"
        "                      '--device', 'cpu']) == 0\n"
        "assert transcode.main([paths[1], '-c', 'tga', '-o', d + '/o.tga',\n"
        "                       '--device', 'cpu']) == 0\n"
        "assert show.main([paths[2], '--sink', 'png',\n"
        "                  '--device', 'cpu']) == 0\n"
        "bad = [m for m in sys.modules if m.startswith('ffpic_tpu.')"
        " or m == 'jax' or m.startswith('jax.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=str(tmp_path))
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), \
        r.stderr[-3000:]
