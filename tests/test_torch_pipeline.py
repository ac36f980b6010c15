"""ffpic_tpu_torch.decode_batch (CPU, plain versions) against
ffpic_tpu.decode_batch on the same JPEG bytes.

Exact for size=None on each route (the colour up to XLA's choice of
contracting its products into FMAs, ``testing.
assert_equal_up_to_contraction``): the fused packed route (a bucket of
baseline members), the single packed member, the dense route of
progressive members, and members of another sampling, which both
packages decode through their registry.  With size=(224, 224), within
1 LSB (see test_torch_resize.py).  Also: the port imports no jax,
``device=None`` raises without CUDA, and what is outside the slice
raises NotImplementedError.
"""

import functools
import io
import pathlib
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import ffpic_tpu
import ffpic_tpu_torch
from ffpic_tpu import native
from ffpic_tpu_torch import testing
import reference_native  # noqa: F401  (readies ffpic_tpu first)

REPO = pathlib.Path(__file__).resolve().parent.parent


@functools.lru_cache(maxsize=None)
def _jpeg(h: int, w: int, q: int, seed: int, progressive: bool = False,
          subsampling: str = "4:2:0") -> bytes:
    if not progressive and subsampling == "4:2:0":
        return testing.synth_jpeg_420(h, w, q, seed)
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(testing.synth_rgb(h, w, seed)).save(
        buf, "JPEG", quality=q, subsampling=subsampling,
        progressive=progressive)
    return buf.getvalue()


def _port(srcs, **kw) -> np.ndarray:
    got = ffpic_tpu_torch.decode_batch(srcs, device="cpu", **kw)
    assert got.device.type == "cpu" and got.dtype == torch.uint8
    return got.numpy()


def _both(srcs, **kw):
    # load the native decoder and fill the codec registry before
    # ffpic_tpu.decode_batch's thread pool does: a worker that loses the
    # loader's race parses without it, one that loses the registry's
    # finds no codec (ROADMAP Queue 3)
    native.available()
    ffpic_tpu.registered_codecs()
    want = np.asarray(ffpic_tpu.decode_batch(srcs, **kw))
    return _port(srcs, **kw), want


def _same_as_jax(srcs, **kw) -> np.ndarray:
    """The port's decode equals ffpic_tpu.decode_batch's, the colour up
    to XLA's contraction choice; returns the port's."""
    got, want = _both(srcs, **kw)
    testing.assert_equal_up_to_contraction(lambda: _port(srcs, **kw), want)
    return got


@pytest.mark.parametrize("srcs", [
    pytest.param([(160, 224, 50, 1), (160, 224, 85, 2), (160, 224, 95, 3)],
                 id="packed_fused"),
    pytest.param([(120, 200, 80, 4)], id="single_member"),
    pytest.param([(160, 224, 60, 5, True), (160, 224, 90, 6, True),
                  (160, 224, 75, 7)], id="progressive_dense_and_packed"),
])
@pytest.mark.parametrize("mode", ["bt601", "reference"])
def test_decode_batch_matches_jax(srcs, mode):
    _same_as_jax([_jpeg(*s) for s in srcs], mode=mode)


def test_decode_batch_sized_matches_jax():
    """Mixed geometries and routes, resized on device: within 1 LSB."""
    srcs = [_jpeg(160, 224, 50, 1), _jpeg(120, 200, 80, 4),
            _jpeg(160, 224, 60, 5, True), _jpeg(160, 224, 85, 2)]
    got, want = _both(srcs, size=(224, 224))
    assert got.shape == (4, 224, 224, 4)
    assert np.abs(got.astype(int) - want).max() <= 1


def test_decode_batch_reads_paths(tmp_path):
    path = tmp_path / "a.jpg"
    path.write_bytes(_jpeg(160, 224, 85, 2))
    got = ffpic_tpu_torch.decode_batch([str(path)], device="cpu")
    want = ffpic_tpu_torch.decode_batch([_jpeg(160, 224, 85, 2)],
                                        device="cpu")
    assert torch.equal(got, want)


def test_port_imports_no_jax():
    """Decoding through the port in a fresh interpreter loads no jax:
    JPEG batches on both routes, a lossy WebP under both VP8 switches,
    a batch of lossless WebPs, a HEIF grid with alpha written by the
    port's encoder, loaded and batched under both HEVC switches, and a
    resized batch through ``normalize_for_model`` into a ``VIT_TINY``
    forward."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import os\n"
        "from ffpic_tpu_torch import decode_batch, testing\n"
        "from ffpic_tpu_torch.ops import cuda_entropy, jpeg_entropy_device\n"
        "d = testing.synth_jpeg_420(64, 96, 80, 0)\n"
        "out = decode_batch([d, d], size=(32, 32), device='cpu')\n"
        "assert tuple(out.shape) == (2, 32, 32, 4), out.shape\n"
        "os.environ['FFPIC_DEVICE_ENTROPY'] = '1'\n"
        "r = testing.encode_jpeg(testing.synth_rgb(32, 48, 1), 80,\n"
        "                        restart_interval=2)\n"
        "out = decode_batch([r] * 4, device='cpu')\n"
        "assert tuple(out.shape) == (4, 32, 48, 4), out.shape\n"
        "from ffpic_tpu_torch import load\n"
        "from ffpic_tpu_torch.formats import vp8, vp8l, vp8l_enc, webp\n"
        "from ffpic_tpu_torch.ops import cuda_vp8, vp8_kernels\n"
        "os.environ['FFPIC_VP8_DEVICE'] = '1'\n"
        "os.environ['FFPIC_VP8_DEVICE_COLOR'] = '1'\n"
        "w = testing.webp_fixture('odd_333x199.webp')\n"
        "assert tuple(load(w, device='cpu').pixels.shape) == (199, 333, 4)\n"
        "l = testing.webp_fixture('lossless_160x120.webp')\n"
        "out = decode_batch([l, l], device='cpu')\n"
        "assert tuple(out.shape) == (2, 120, 160, 4), out.shape\n"
        "from ffpic_tpu_torch import encode\n"
        "from ffpic_tpu_torch.formats import (basemedia, heif, heif_enc,\n"
        "    hevc, hevc_recon)\n"
        "from ffpic_tpu_torch.coding import (cabac, cabac_enc, golomb,\n"
        "    hevc_consts, hevc_enc, hevc_scaling, hevc_slice)\n"
        "from ffpic_tpu_torch.ops import cuda_hevc, hevc_kernels\n"
        "from ffpic_tpu_torch import make_heif_fixtures\n"
        "os.environ['FFPIC_HEVC_DEVICE'] = '1'\n"
        "os.environ['FFPIC_HEIF_DEVICE_COLOR'] = '1'\n"
        "h = encode(testing.heif_pic(80, 72, 3, True), 'HEIF', qp=30,\n"
        "           tile=64, device='cpu')\n"
        "assert tuple(load(h, device='cpu').pixels.shape) == (72, 80, 4)\n"
        "out = decode_batch([h, h], device='cpu')\n"
        "assert tuple(out.shape) == (2, 72, 80, 4), out.shape\n"
        "from ffpic_tpu_torch.models import vit\n"
        "from ffpic_tpu_torch.ops import cuda_resize, resize\n"
        "b = decode_batch([d, h], size=(64, 64), device='cpu')\n"
        "x = resize.normalize_for_model(b)\n"
        "logits = vit.ViT(vit.VIT_TINY, device='cpu')(x)\n"
        "assert tuple(logits.shape) == (2, 10), logits.shape\n"
        "assert bool(logits.isfinite().all())\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=str(REPO))
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]


def test_port_sources_import_no_jax():
    """No module of the port (nor chip_smoke.py) imports jax or anything
    of the JAX package ffpic_tpu (ffpic_tpu_torch is the port itself)."""
    bad = re.compile(r"^\s*(import jax\b|from jax\b|"
                     r"(from|import) ffpic_tpu(\.|\s|,|$))", re.M)
    files = list((REPO / "ffpic_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 12
    hits = [f"{f}: {m.group(0).strip()}" for f in files
            for m in bad.finditer(f.read_text())]
    assert not hits, hits
    assert bad.search("from ffpic_tpu.native import x\n")
    assert bad.search("import ffpic_tpu\n")
    assert not bad.search("from ffpic_tpu_torch import native\n")


def test_port_runs_with_ffpic_tpu_blocked(tmp_path):
    """With the JAX package blocked, the port decodes a packed batch, a
    single member, a progressive member and a 4:4:4 member on the CPU,
    loads a 4:4:4 file and encodes it as JPEG and PNG, loads the PNG and
    decodes a batch of JPEG and PNG members (one of Sub/Up rows, one of
    all five filters), loads a WebP with alpha and an animated one,
    encodes the animation, decodes a JPEG, WebP and PNG batch, encodes a
    JPEG's picture as HEIF, loads it and decodes it beside a JPEG and a
    WebP, and loads no module of ffpic_tpu and no jax."""
    files = {"a": _jpeg(64, 96, 80, 0), "b": _jpeg(64, 96, 60, 1),
             "c": _jpeg(40, 72, 90, 2), "p": _jpeg(64, 96, 70, 3, True),
             "s": _jpeg(64, 96, 75, 4, subsampling="4:4:4")}
    for k, v in files.items():
        (tmp_path / f"{k}.jpg").write_bytes(v)
    rgba = np.concatenate([testing.synth_rgb(64, 96, 5),
                           np.full((64, 96, 1), 200, np.uint8)], -1)
    (tmp_path / "u.png").write_bytes(testing.encode_png(rgba,
                                                        filters=(1, 2)))
    code = (
        "import sys\n"
        "sys.modules['ffpic_tpu'] = None\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"d = {str(tmp_path)!r}\n"
        "from ffpic_tpu_torch import Pic, decode_batch, encode, load\n"
        "for names, shape in (('aba', (3, 64, 96, 4)), ('c', (1, 40, 72, 4)),"
        " ('pa', (2, 64, 96, 4)), ('sa', (2, 64, 96, 4))):\n"
        "    out = decode_batch([f'{d}/{k}.jpg' for k in names], device='cpu')\n"
        "    assert tuple(out.shape) == shape, (names, out.shape)\n"
        "pic = load(f'{d}/s.jpg', device='cpu', upsample='fancy')\n"
        "assert tuple(pic.pixels.shape) == (64, 96, 4), pic.pixels.shape\n"
        "data = encode(pic, 'JPG', quality=80, device='cpu')\n"
        "assert load(data, device='cpu').width == 96\n"
        "png = encode(pic, 'PNG', device='cpu')\n"
        "assert (load(png, device='cpu').pixels == pic.pixels).all()\n"
        "out = decode_batch([f'{d}/a.jpg', png, f'{d}/u.png'], device='cpu')\n"
        "assert tuple(out.shape) == (3, 64, 96, 4), out.shape\n"
        "from ffpic_tpu_torch import testing\n"
        "w = load(testing.webp_fixture('alpha_1080p.webp'), device='cpu')\n"
        "assert tuple(w.pixels.shape) == (1080, 1920, 4), w.pixels.shape\n"
        "a = testing.webp_fixture('animated_96x64.webp')\n"
        "assert load(a, device='cpu').n_frames == 3\n"
        "e = encode(load(a, device='cpu'), 'WEBP', device='cpu')\n"
        "assert load(e, device='cpu').n_frames == 3\n"
        "out = decode_batch([f'{d}/a.jpg', e, png], size=(32, 32),\n"
        "                   device='cpu')\n"
        "assert tuple(out.shape) == (3, 32, 32, 4), out.shape\n"
        "h = encode(load(f'{d}/a.jpg', device='cpu'), 'HEIF', qp=30,\n"
        "           device='cpu')\n"
        "assert load(h, device='cpu').width == 96\n"
        "out = decode_batch([f'{d}/a.jpg', h, e], size=(32, 32),\n"
        "                   device='cpu')\n"
        "assert tuple(out.shape) == (3, 32, 32, 4), out.shape\n"
        "bad = [m for m in sys.modules if m.startswith('ffpic_tpu.')"
        " or m == 'jax' or m.startswith('jax.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=str(tmp_path))
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]


def test_device_none_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ffpic_tpu_torch.decode_batch([_jpeg(120, 200, 80, 4)])


@pytest.mark.parametrize("case", ["webp", "gif", "mesh", "heif", "h265"])
def test_outside_the_slice_raises(case):
    """WebP, HEIF, GIF and raw ``.265`` streams are ported: a member that
    is only a WebP header raises the registry's ValueError for a corrupt
    file, a HEIF without a meta box the parser's ValueError, a GIF with
    no image in it the registry's "decode produced no pictures", a raw
    stream of parameter sets alone the reference's "no decodable HEVC
    access units" (``tests/test_torch_hevc_inter.py`` decodes real
    ones), not NotImplementedError.  ``mesh`` is ported
    (``tests/test_torch_mesh.py``): anything but a DeviceMesh raises
    TypeError."""
    kw = {}
    srcs = [_jpeg(120, 200, 80, 4)]
    if case == "webp":
        srcs.append(b"RIFF" + (60).to_bytes(4, "little") + b"WEBPVP8 "
                    + bytes(52))
        with pytest.raises(ValueError, match="corrupt WEBP"):
            ffpic_tpu_torch.decode_batch(srcs, device="cpu")
        return
    if case == "heif":
        srcs.append((24).to_bytes(4, "big") + b"ftypheic" + bytes(12))
        with pytest.raises(ValueError, match="no meta box"):
            ffpic_tpu_torch.decode_batch(srcs, device="cpu")
        return
    if case == "gif":
        srcs.append(b"GIF89a" + bytes(64))
        with pytest.raises(ValueError, match="no pictures"):
            ffpic_tpu_torch.decode_batch(srcs, device="cpu")
        return
    if case == "h265":
        enc, _nalus = testing.hevc_stream("single", 64, 64)
        from ffpic_tpu_torch.coding.hevc_enc import make_nalu
        raw = b"".join(b"\0\0\0\1" + n for n in (
            make_nalu(33, enc.sps_rbsp), make_nalu(34, enc.pps_rbsp)))
        assert ffpic_tpu.probe(raw).name == "HEVC"
        with pytest.raises(ValueError, match="no decodable HEVC"):
            ffpic_tpu.load(raw)
        with pytest.raises(ValueError, match="no decodable HEVC"):
            ffpic_tpu_torch.decode_batch(srcs + [raw], device="cpu")
        with pytest.raises(ValueError, match="no decodable HEVC"):
            ffpic_tpu_torch.load(raw, device="cpu")
        return
    kw["mesh"] = object()
    with pytest.raises(TypeError, match="mesh must be a DeviceMesh"):
        ffpic_tpu_torch.decode_batch(srcs, device="cpu", **kw)


def test_mixed_sizes_need_size():
    with pytest.raises(ValueError, match="mixed sizes"):
        ffpic_tpu_torch.decode_batch(
            [_jpeg(160, 224, 50, 1), _jpeg(120, 200, 80, 4)], device="cpu")


def test_synth_jpeg_matches_jax_encoder():
    """testing.synth_jpeg_420 writes the bytes encode_baseline writes."""
    from ffpic_tpu.formats.jpg_encode import encode_baseline
    from ffpic_tpu.formats.pic import Pic
    rgb = testing.synth_rgb(72, 104, 8)
    rgba = np.concatenate([rgb, np.full((72, 104, 1), 255, np.uint8)], -1)
    for q in (30, 90):
        assert testing.synth_jpeg_420(72, 104, q, 8) == encode_baseline(
            Pic(pixels=rgba, width=104, height=72), q)



@pytest.mark.parametrize("size", [None, (224, 224)])
def test_decode_batch_other_samplings_match_jax(size):
    """4:4:4, 4:2:2 and gray members beside 4:2:0 ones: both packages
    decode them through their registry, with its defaults (reference
    colour, nearest upsampling) whatever ``mode`` the batch asks for,
    8-aligned wide."""
    srcs = [_jpeg(160, 224, 85, 2),
            _jpeg(160, 224, 75, 3, subsampling="4:4:4"),
            _jpeg(160, 224, 80, 4, subsampling="4:2:2"),
            testing.encode_jpeg(testing.synth_rgb(160, 224, 5)[..., 1], 80,
                                ((1, 1),)),
            _jpeg(160, 224, 60, 5, True, subsampling="4:4:4")]
    if size is None:
        got = _same_as_jax(srcs, mode="bt601")
        assert got.shape == (5, 160, 224, 4)
        assert np.array_equal(got[1], ffpic_tpu_torch.load(
            srcs[1], device="cpu").np_pixels())
    else:
        got, want = _both(srcs, size=size, mode="bt601")
        assert got.shape == (5, 224, 224, 4)
        assert np.abs(got.astype(int) - want).max() <= 1


def test_decode_batch_device_work_stays_on_the_callers_thread(monkeypatch):
    """The worker pool only parses: every staging copy and every device
    decode of a batch, registry members included, runs on the caller's
    thread, so on the caller's current CUDA stream (torch keeps one per
    thread; ``chip_smoke.py`` runs such a batch under a side stream)."""
    from ffpic_tpu_torch import pipeline
    from ffpic_tpu_torch.formats import jpg
    threads = {"parse": set(), "device": set()}

    def spy(kind, fn):
        def wrapped(*a, **k):
            threads[kind].add(threading.get_ident())
            return fn(*a, **k)
        return wrapped

    monkeypatch.setenv("FFPIC_THREADS", "4")
    monkeypatch.setattr(pipeline, "_prep", spy("parse", pipeline._prep))
    for mod, name in ((pipeline, "to_device"), (jpg, "to_device"),
                      (jpg, "to_pic"),
                      (pipeline.jk, "decode_batch_420_packed_fused")):
        monkeypatch.setattr(mod, name, spy("device", getattr(mod, name)))
    srcs = [_jpeg(64, 96, 85, 2),
            _jpeg(64, 96, 75, 3, subsampling="4:4:4"),
            _jpeg(64, 96, 80, 4, subsampling="4:2:2"),
            testing.encode_jpeg(testing.synth_rgb(64, 96, 5)[..., 1], 80,
                                ((1, 1),))]
    got = ffpic_tpu_torch.decode_batch(srcs, size=(32, 32), device="cpu")
    assert got.shape == (4, 32, 32, 4)
    assert threading.get_ident() not in threads["parse"]
    assert threads["device"] == {threading.get_ident()}


def test_decode_batch_registry_member_width_is_8_aligned():
    """A 4:4:4 member 1000 wide is 1000 wide through the registry only
    when 1000 is a multiple of 8, so beside a 4:2:0 member of 1001 it
    makes mixed sizes, as in the reference."""
    a = _jpeg(24, 1001, 80, 1)
    b = _jpeg(24, 1001, 80, 2, subsampling="4:4:4")
    for decode in (ffpic_tpu.decode_batch,
                   lambda s: ffpic_tpu_torch.decode_batch(s, device="cpu")):
        with pytest.raises(ValueError, match="mixed sizes"):
            decode([a, b])


def test_decode_batch_420_uses_cb_table_for_cr():
    """A 4:2:0 file whose Cr table differs from Cb's: decode_batch's
    4:2:0 route dequantises both chroma components with component 1's
    table in both packages (ROADMAP Queue 3), so it agrees with
    ffpic_tpu.decode_batch and differs from load, which takes each
    component's own table."""
    rgb = testing.synth_rgb(64, 96, 6)
    data = testing.encode_jpeg(rgb, 85, cr_quality=30)
    got = _same_as_jax([data, data], mode="reference")
    own = ffpic_tpu_torch.load(data, device="cpu").np_pixels()
    testing.assert_equal_up_to_contraction(
        lambda: ffpic_tpu_torch.load(data, device="cpu").np_pixels(),
        np.asarray(ffpic_tpu.load(data).np_pixels()))
    assert not np.array_equal(got[0], own)


@functools.lru_cache(maxsize=None)
def _png(h: int, w: int, seed: int, filters=(1, 2)) -> bytes:
    rgba = np.concatenate([testing.synth_rgb(h, w, seed),
                           testing.synth_rgb(h, w, seed + 50)[..., :1]], -1)
    return testing.encode_png(rgba, 6, 8, filters=filters)


@pytest.mark.parametrize("size", [None, (96, 128)])
def test_decode_batch_jpeg_and_png_match_jax(size):
    """JPEG and PNG members in one batch: the PNGs (one of Sub/Up rows,
    which takes K6's route, one of all five filters, one gray 16-bit
    Adam7 with a key) through the registry's PNG codec in both
    packages, the JPEGs as before; exact (the JPEG colour up to XLA's
    contraction choice), or within 1 LSB when resized."""
    gray = testing.encode_png(
        np.random.default_rng(3).integers(0, 65536, (160, 224)), 0, 16,
        filters=(0, 1, 2, 3, 4), interlace=1, trns=1234)
    srcs = [_jpeg(160, 224, 85, 2), _png(160, 224, 1),
            _png(160, 224, 2, (0, 1, 2, 3, 4)), _jpeg(160, 224, 60, 5, True),
            gray, _jpeg(160, 224, 95, 3)]
    if size is None:
        got = _same_as_jax(srcs, mode="bt601")
        assert got.shape == (6, 160, 224, 4)
        np.testing.assert_array_equal(
            got[1], ffpic_tpu_torch.load(srcs[1], device="cpu").np_pixels())
    else:
        got, want = _both(srcs, size=size)
        assert got.shape == (6, 96, 128, 4)
        assert np.abs(got.astype(int) - want).max() <= 1


def test_corrupt_png_member_raises_value_error():
    bad = bytearray(_png(32, 48, 1))
    bad[bad.index(b"IDAT") + 20] ^= 0xFF
    with pytest.raises(ValueError, match="CRC"):
        ffpic_tpu_torch.decode_batch([_jpeg(120, 200, 80, 4), bytes(bad)],
                                     device="cpu")


def _progressive_planes(srcs):
    from ffpic_tpu_torch.formats import jpg
    js = [jpg.parse_and_decode(d)[0] for d in srcs]
    return js, [np.stack([j.coeffs[c].reshape(-1) for j in js])
                for c in range(3)]


def _noisy_progressive(seed: int) -> bytes:
    from PIL import Image
    rgb = np.random.default_rng(seed).integers(0, 256, (160, 224, 3))
    buf = io.BytesIO()
    Image.fromarray(rgb.astype(np.uint8)).save(
        buf, "JPEG", quality=100, subsampling="4:2:0", progressive=True)
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_sparse_route_follows_the_reference_rule(kind, monkeypatch):
    """Progressive 4:2:0 members take the sparse route (K8, then K2 and
    K3) exactly when the reference's rule does -- the three planes'
    ``pack_coeffs`` pairs under 0.7 of their dense bytes, computed with
    ffpic_tpu's own ``pack_coeffs`` -- from pairs packed per member and
    joined as ``pack_coeffs`` packs the stack; and both routes give
    ffpic_tpu's pixels exactly."""
    from ffpic_tpu.ops import jpeg_kernels as jax_jk
    from ffpic_tpu_torch import pipeline
    srcs = ([_jpeg(160, 224, 60, 5, True), _jpeg(160, 224, 90, 6, True)]
            if kind == "sparse" else
            [_noisy_progressive(1), _noisy_progressive(2)])
    js, planes = _progressive_planes(srcs)
    dense_bytes = sum(p.nbytes for p in planes)
    ref = [jax_jk.pack_coeffs(p) for p in planes]
    want_sparse = sum(a.nbytes + b.nbytes for a, b in ref) < dense_bytes * 0.7
    assert want_sparse == (kind == "sparse")
    packed = pipeline.sparse_pairs([pipeline.member_pairs(j) for j in js],
                                   [c.size for c in js[0].coeffs])
    assert (packed is not None) == want_sparse
    joined = (np.concatenate([a for a, _b in ref]),
              np.concatenate([b for _a, b in ref]), [len(a) for a, _b in ref])
    if packed is not None:
        np.testing.assert_array_equal(packed[0], joined[0])
        np.testing.assert_array_equal(packed[1], joined[1])
        assert packed[2] == joined[2]
    routes = []
    for name in ("decode_batch_420_sparse", "decode_batch_420_dense"):
        real = getattr(pipeline.jk, name)

        def spy(*a, _real=real, _name=name, **k):
            routes.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(pipeline.jk, name, spy)
    got = _same_as_jax(srcs, mode="reference")
    assert routes[0] == ("decode_batch_420_sparse" if want_sparse
                         else "decode_batch_420_dense")
    cpu = torch.device("cpu")
    routes.clear()
    dense = pipeline.decode_planes(js, "reference", cpu)
    sparse = pipeline.decode_pairs(js, joined, "reference", cpu)
    assert routes == ["decode_batch_420_dense", "decode_batch_420_sparse",
                      "decode_batch_420_dense"]
    np.testing.assert_array_equal(got, dense.numpy())
    np.testing.assert_array_equal(got, sparse.numpy())


# --- the decode_batch signature (the reference's) ---------------------------

def test_decode_batch_signature_is_the_references():
    """(srcs, size, dtype, mode, mesh, *, device): a positional call
    reaches the same arguments as the keyword form; dtype takes uint8
    only; device is keyword-only."""
    import inspect
    srcs = [_jpeg(64, 96, 80, 1), _jpeg(64, 96, 60, 2)]
    got = ffpic_tpu_torch.decode_batch(srcs, None, "uint8", "reference",
                                       device="cpu")
    want = ffpic_tpu_torch.decode_batch(srcs, mode="reference", device="cpu")
    assert torch.equal(got, want)
    assert not torch.equal(got, ffpic_tpu_torch.decode_batch(srcs,
                                                             device="cpu"))
    assert torch.equal(ffpic_tpu_torch.decode_batch(
        srcs, dtype=torch.uint8, device="cpu"), ffpic_tpu_torch.decode_batch(
        srcs, device="cpu"))
    with pytest.raises(ValueError, match="dtype"):
        ffpic_tpu_torch.decode_batch(srcs, dtype="float32", device="cpu")
    with pytest.raises(TypeError):
        ffpic_tpu_torch.decode_batch(srcs, None, "uint8", "bt601", None,
                                     "cpu")
    names = list(inspect.signature(ffpic_tpu_torch.decode_batch).parameters)
    assert names == list(inspect.signature(
        ffpic_tpu.decode_batch).parameters) + ["device"]


# --- the device-entropy route ------------------------------------------------

@functools.lru_cache(maxsize=None)
def _dri(h: int, w: int, q: int, seed: int, rows: int = 1,
         opt: bool = False) -> bytes:
    """A baseline 4:2:0 JPEG with a restart marker every ``rows`` MCU
    rows (PIL), as the reference's device-entropy tests make them."""
    from PIL import Image
    buf = io.BytesIO()
    kw = {"restart_marker_rows": rows} if rows else {}
    Image.fromarray(testing.synth_rgb(h, w, seed)).save(
        buf, "JPEG", quality=q, subsampling="4:2:0", optimize=opt, **kw)
    return buf.getvalue()


def _entropy_env(monkeypatch, **env):
    for k in ("FFPIC_DEVICE_ENTROPY", "FFPIC_SPEC_ENTROPY", "FFPIC_HYBRID",
              "FFPIC_HYBRID_FRAC"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


ENTROPY_BATCHES = {
    # 5 DRI members (mixed tables) and one without restart markers
    "five_dri_one_plain": ([(96, 128, 85, 1), (96, 128, 70, 2, 1, True),
                            (96, 128, 92, 3, 2), (96, 128, 60, 4),
                            (96, 128, 85, 5, 1, True), (96, 128, 80, 6, 0)],
                           {"FFPIC_DEVICE_ENTROPY": "1"}, None),
    # all DRI, 8 of them in three sizes: the hybrid split keeps 4
    "hybrid_eight_sized": ([(96, 128, 85, 1), (64, 96, 90, 2),
                            (96, 128, 70, 3), (80, 112, 75, 4),
                            (96, 128, 95, 5), (64, 96, 60, 6),
                            (96, 128, 80, 7), (80, 112, 88, 8)],
                           {"FFPIC_DEVICE_ENTROPY": "1"}, (80, 96)),
    # DRI-less members of one geometry and tables: the speculative group
    "spec_group": ([(96, 128, 85, 1, 0), (96, 128, 70, 2, 0),
                    (96, 128, 92, 3, 0), (96, 128, 60, 4, 0),
                    (96, 128, 80, 5, 1)],
                   {"FFPIC_DEVICE_ENTROPY": "1", "FFPIC_SPEC_ENTROPY": "1"},
                   None),
    "switched_off": ([(96, 128, 85, 1), (96, 128, 70, 2), (96, 128, 92, 3),
                      (96, 128, 60, 4)], {"FFPIC_DEVICE_ENTROPY": "0"},
                     None),
}


@pytest.mark.parametrize("name", sorted(ENTROPY_BATCHES))
def test_device_entropy_route_matches_jax(name, monkeypatch):
    """decode_batch(device="cpu") under the reference's switches against
    ffpic_tpu.decode_batch under the same: the colour up to XLA's
    contraction choice, or within 1 LSB with size=; and exactly the
    port's host route (FFPIC_DEVICE_ENTROPY=0)."""
    specs, env, size = ENTROPY_BATCHES[name]
    srcs = [_dri(*s) for s in specs]
    _entropy_env(monkeypatch, **env)
    kw = {"size": size} if size else {}
    taken = _route_spy(monkeypatch)
    got, want = _both(srcs, **kw)
    assert taken == {"five_dri_one_plain": [("decode_batch_dri_mixed", 5)],
                     "hybrid_eight_sized": [("decode_batch_dri_mixed", 4)],
                     "spec_group": [("decode_batch_spec", 4)],
                     "switched_off": []}[name]
    if size:
        assert got.shape == (len(srcs), *size, 4)
        assert np.abs(got.astype(int) - want).max() <= 1
    else:
        testing.assert_equal_up_to_contraction(lambda: _port(srcs), want)
    monkeypatch.setenv("FFPIC_DEVICE_ENTROPY", "0")
    np.testing.assert_array_equal(got, _port(srcs, **kw))


def _route_spy(monkeypatch):
    from ffpic_tpu_torch import pipeline
    taken = []
    for name in ("decode_batch_dri_mixed", "decode_batch_spec"):
        real = getattr(pipeline.jed, name)

        def spy(datas, js, *a, _real=real, _name=name, **k):
            out = _real(datas, js, *a, **k)
            taken.append((_name, len(datas)))      # it returned
            return out
        monkeypatch.setattr(pipeline.jed, name, spy)
    return taken


@pytest.mark.parametrize("n,env,members", [
    (8, {}, 4), (8, {"FFPIC_HYBRID_FRAC": "0.75"}, 6),
    (8, {"FFPIC_HYBRID": "0"}, 8), (6, {}, 4), (5, {}, 5), (3, {}, 0)])
def test_device_entropy_routing_follows_the_reference(n, env, members,
                                                      monkeypatch):
    """The members the device route takes: all DRI members when there
    are 4 or more, and of an all-DRI batch of 6 or more only the first
    k = max(4, round(n * FFPIC_HYBRID_FRAC)) when n - k >= 2
    (``ffpic_tpu/pipeline.py:126-142``)."""
    _entropy_env(monkeypatch, FFPIC_DEVICE_ENTROPY="1", **env)
    taken = _route_spy(monkeypatch)
    srcs = [_dri(32, 48, 60 + 5 * i, i) for i in range(n)]
    got = _port(srcs)
    assert taken == ([("decode_batch_dri_mixed", members)] if members
                     else [])
    monkeypatch.setenv("FFPIC_DEVICE_ENTROPY", "0")
    np.testing.assert_array_equal(got, _port(srcs))


def test_device_entropy_headers_skip_dri_less_members(monkeypatch):
    """Without FFPIC_SPEC_ENTROPY a member whose bytes hold no DRI marker
    (FF DD) cannot take the device route, and its header is not parsed
    for it; with the marker it is."""
    from ffpic_tpu_torch import pipeline
    _entropy_env(monkeypatch, FFPIC_DEVICE_ENTROPY="1")
    heads = []
    real = pipeline.jpg.parse_and_decode

    def spy(data, *a, **k):
        if k.get("skip_decode"):
            heads.append(len(data))
        return real(data, *a, **k)
    monkeypatch.setattr(pipeline.jpg, "parse_and_decode", spy)
    plain = [_jpeg(32, 48, 70 + i, i) for i in range(4)]
    dri = _dri(32, 48, 80, 7)
    assert all(b"\xff\xdd" not in d for d in plain) and b"\xff\xdd" in dri
    _port(plain + [dri])
    assert heads == [len(dri)]
    monkeypatch.setenv("FFPIC_SPEC_ENTROPY", "1")
    heads.clear()
    _port(plain + [dri])
    assert set(heads) == {len(d) for d in plain + [dri]}


def test_device_entropy_errors(monkeypatch):
    """The route's ``Declined`` (the spec decoder's failed
    self-synchronisation) leaves the members to the host path; any other
    error propagates: a plain ValueError, a RuntimeError (what a build
    or a launch raises)."""
    from ffpic_tpu_torch import pipeline
    _entropy_env(monkeypatch, FFPIC_DEVICE_ENTROPY="1",
                 FFPIC_SPEC_ENTROPY="1")
    srcs = [_dri(32, 48, 70 + i, i, 0) for i in range(4)]
    want = _port(srcs)

    def fail(kind):
        def raise_(*a, **k):
            raise kind("from inside the route")
        return raise_
    monkeypatch.setattr(pipeline.jed, "spec_stages",
                        fail(pipeline.jed.Declined))
    np.testing.assert_array_equal(_port(srcs), want)
    for kind in (ValueError, RuntimeError):
        monkeypatch.setattr(pipeline.jed, "spec_stages", fail(kind))
        with pytest.raises(kind, match="inside the route"):
            _port(srcs)
    dri = [_dri(32, 48, 70 + i, i) for i in range(4)]
    monkeypatch.setattr(pipeline.jed, "decode_lanes", fail(RuntimeError))
    with pytest.raises(RuntimeError, match="inside the route"):
        _port(dri)


@pytest.mark.parametrize("route", ["dri", "spec"])
def test_device_entropy_wrapper_checks_propagate(route, monkeypatch):
    """A kernel wrapper's check that refuses its launch inside the route
    (here: the staged tensors are not on CUDA) raises out of
    decode_batch; the members do not quietly take the host path."""
    from ffpic_tpu_torch import pipeline
    _entropy_env(monkeypatch, FFPIC_DEVICE_ENTROPY="1",
                 FFPIC_SPEC_ENTROPY="1")
    monkeypatch.setattr(pipeline.jed, "_on_cuda", lambda t: True)
    srcs = [_dri(32, 48, 70 + i, i, 1 if route == "dri" else 0)
            for i in range(4)]
    with pytest.raises(ValueError, match="expected a CUDA tensor") as e:
        _port(srcs)
    assert not isinstance(e.value, pipeline.jed.Declined)


def test_device_entropy_splits_what_one_launch_cannot_take(monkeypatch):
    """``jed.launch_runs`` splits the route's members into launches by
    their coefficients (and bytes), in order, and leaves a file too
    large alone to the host path; the pixels stay those of the host
    route."""
    from ffpic_tpu_torch import pipeline
    _entropy_env(monkeypatch, FFPIC_DEVICE_ENTROPY="1", FFPIC_HYBRID="0")
    srcs = [_dri(32, 48, 60 + 5 * i, i) for i in range(5)] + \
        [_dri(64, 96, 90, 9)]
    small = 2 * 3 * 6 * 64                  # a 32x48 member's coefficients
    monkeypatch.setattr(pipeline.jed, "LAUNCH_COEFFS", 2 * small + 1)
    taken = _route_spy(monkeypatch)
    got = _port(srcs, size=(32, 48))
    assert taken == [("decode_batch_dri_mixed", 2)] * 2 + \
        [("decode_batch_dri_mixed", 1)]
    monkeypatch.setattr(pipeline.jed, "LAUNCH_COEFFS", 10 ** 9)
    monkeypatch.setattr(pipeline.jed, "LAUNCH_BYTES",
                        max(len(s) for s in srcs[:5]) * 2)
    taken.clear()
    _port(srcs, size=(32, 48))
    assert [n for _r, n in taken] == [2, 2, 1]
    monkeypatch.setenv("FFPIC_DEVICE_ENTROPY", "0")
    np.testing.assert_array_equal(got, _port(srcs, size=(32, 48)))


def test_device_entropy_overlaps_the_pool(monkeypatch):
    """The device route runs on the caller's thread while the pool
    parses the other members: the pool has started before the route
    returns, and does no route work."""
    from ffpic_tpu_torch import pipeline
    _entropy_env(monkeypatch, FFPIC_DEVICE_ENTROPY="1", FFPIC_HYBRID="0")
    monkeypatch.setenv("FFPIC_THREADS", "4")
    started = threading.Event()
    seen = {}
    real_route = pipeline.jed.decode_batch_dri_mixed
    real_prep = pipeline._prep

    def route(*a, **k):
        seen["route"] = threading.get_ident()
        seen["pool_started"] = started.wait(timeout=30)
        return real_route(*a, **k)

    def prep(*a, **k):
        seen.setdefault("prep", set()).add(threading.get_ident())
        started.set()
        return real_prep(*a, **k)
    monkeypatch.setattr(pipeline.jed, "decode_batch_dri_mixed", route)
    monkeypatch.setattr(pipeline, "_prep", prep)
    srcs = [_dri(32, 48, 70 + i, i) for i in range(4)] + \
        [_jpeg(32, 48, 80, 9), _jpeg(32, 48, 85, 10)]
    got = _port(srcs)
    assert got.shape == (6, 32, 48, 4)
    assert seen["route"] == threading.get_ident() and seen["pool_started"]
    assert threading.get_ident() not in seen["prep"]
    monkeypatch.setenv("FFPIC_DEVICE_ENTROPY", "0")
    np.testing.assert_array_equal(got, _port(srcs))


def _heif(w, h, seed, **kw) -> bytes:
    return ffpic_tpu_torch.encode(testing.heif_pic(w, h, seed, alpha=True),
                                  "HEIF", device="cpu", **kw)


@pytest.mark.parametrize("env", [{}, {"FFPIC_HEVC_DEVICE": "1"},
                                 {"FFPIC_HEIF_DEVICE_COLOR": "1"}])
@pytest.mark.parametrize("size", [None, (48, 48)])
def test_decode_batch_heif_members_match_jax(env, size, monkeypatch):
    """HEIF members (a grid with alpha, a single item) beside 4:2:0 JPEG
    ones, under the HEVC switches: the reference's pixels (the device
    colour up to contraction; sized within 1 LSB)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    srcs = [_heif(96, 64, 1, qp=28, tile=64), _jpeg(64, 96, 85, 2),
            _heif(96, 64, 2, qp=33)]
    if size is None:
        _same_as_jax(srcs)
    else:
        got, want = _both(srcs, size=size)
        assert got.shape == (3, 48, 48, 4)
        assert np.abs(got.astype(int) - want).max() <= 1


def test_decode_batch_heif_workers_launch_on_the_callers_stream(monkeypatch):
    """Under FFPIC_HEVC_DEVICE the pool's workers (and a grid's tile
    workers) run the residual transform inside the stream context the
    caller's thread had: ``torch.cuda.stream`` is entered with the
    stream captured there (None on the CPU), in every worker."""
    import torch as _torch
    from ffpic_tpu_torch.ops import hevc_kernels
    seen = []

    class Spy:
        def __init__(self, stream):
            self.stream = stream

        def __enter__(self):
            seen.append((threading.get_ident(), self.stream))

        def __exit__(self, *a):
            return False
    monkeypatch.setattr(_torch.cuda, "stream", Spy)
    calls = []
    real = hevc_kernels.residuals_packed

    def spy(*a, **k):
        calls.append(threading.get_ident())
        return real(*a, **k)
    monkeypatch.setattr(hevc_kernels, "residuals_packed", spy)
    monkeypatch.setenv("FFPIC_HEVC_DEVICE", "1")
    monkeypatch.setenv("FFPIC_THREADS", "3")
    srcs = [_heif(64, 64, 3, qp=30, tile=32), _heif(64, 64, 4, qp=30),
            _heif(64, 64, 5, qp=30)]
    ffpic_tpu_torch.decode_batch(srcs, device="cpu")
    assert len(calls) >= 4
    entered = {t for t, _ in seen}
    assert set(calls) <= entered and threading.get_ident() not in calls
    assert all(s is None for _, s in seen)
