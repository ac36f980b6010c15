"""Write the AVIF fixtures of ``ffpic_tpu_torch/testdata`` from a seed.

    python3 -m ffpic_tpu_torch.make_avif_fixtures [--seed 0] [--out DIR]

Machines without PIL read the committed files through
``testing.avif_fixture``; this script is how they were made.  It needs
PIL with AVIF (libavif with libaom).  Content is ``avif_content``:
waves with a few flat rectangles and mild noise, so that deblocking
and loop restoration have work to do (smooth waves alone leave them
idle and compress to about 18 KB).

* ``avif_1080p_420.avif``: 1920x1080 4:2:0 8-bit, quality 60, speed 6
  (PIL's libavif leaves CDEF off for stills; with libaom's
  ``enable-cdef`` the numpy CDEF of both packages takes about 24 s of a
  1080p load on a sandbox CPU, too long for the card's smoke run: the
  CPU tests hold CDEF on small streams);
* ``avif_1080p_444_alpha.avif``: 1920x1080 4:4:4 with an alpha item
  (a radial ramp), quality 70, speed 6;
* ``avif_1080p_grid.avif``: a 2x2 grid of 960x540 ``av01`` tiles, each
  coded by PIL and assembled with the port's ``heif_enc`` (a grid item,
  its ``dimg`` tiles and an nclx ``colr``), as non-PIL encoders write
  grids;
* ``avif_1080p_sb128.avif``: 1920x1080 4:2:0 at speed 0, 128x128
  superblocks (PIL's libavif codes them at speed 6 too) with loop
  restoration, which libaom turns on at the slower speeds;
* ``avis_track_64x48.avif``: three 64x48 frames that PIL writes as an
  ``av01`` track behind a still cover;
* ``avis_1080p_grain.avif``: an animated AVIF at full width, three
  1920x1080 4:2:0 frames of ``avif_content`` panning by 5 pixels a frame,
  quality 60, speed 6, with libaom's ``film-grain-test`` 1, so that
  every frame carries film grain; libaom turns CDEF on in animations
  and picks OBMC and local warp where they pay.  Only ``chip_smoke.py``
  decodes it (more than a minute on one CPU core);
* small animated AVIFs for the CPU tests (``SMALL_TRACKS``), each a few
  KB: ``avis_96x64_grain.avif`` (``film-grain-test`` 1),
  ``avis_176x128.avif`` (four frames, no grain), ``avis_128x96_444.avif``
  (4:4:4) and ``avis_176x128_grain.avif`` (``film-grain-test`` 2,
  quality 50);
* raw AV1 streams (temporal units of OBUs) that libaom's encoder writes
  through ``tools/aom_oracle.encode_frames`` at its default lag, so
  that they hold hidden frames, ``show_existing_frame`` and compound
  blocks: ``av1_10bit_64x48.obu`` (10-bit 4:2:0, six frames) and
  ``av1_gop_96x64.obu`` (8-bit 4:2:0, six frames);
* ``avif_fixtures.json``: each file's sha256; for the stills the shape
  and sha256 of the port's ``load`` pixels on the CPU; for the animated
  files each frame's shape, pixels' sha256 and ``delay_ms`` from the
  port's ``load_all`` on the CPU; for the raw streams each shown
  frame's planes' sha256 from the port's ``Av1Decoder``.  The tier-1
  tests ``tests/test_torch_avif.py::test_fixture_hashes`` and
  ``tests/test_torch_av1_inter.py`` recompute them with each package
  for every file but the 1080p animation, whose
  hashes ``chip_smoke.py`` checks (they were checked once against the
  JAX package's ``load_all`` when the file was made): the JAX package's
  pixels must give the same hashes.

PIL stamps an animated file with the time it was written, so a remake
gives other file hashes for those (their pixels do not change);
``--manifest-only`` rewrites the manifest of the files in ``--out``.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import struct

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "testdata")

STILLS = ("avif_1080p_420.avif", "avif_1080p_444_alpha.avif",
          "avif_1080p_grid.avif", "avif_1080p_sb128.avif")
TRACK = "avis_track_64x48.avif"
GRAIN_1080P = "avis_1080p_grain.avif"
SMALL_TRACKS = ("avis_96x64_grain.avif", "avis_176x128.avif",
                "avis_128x96_444.avif", "avis_176x128_grain.avif")
TRACKS = (TRACK, GRAIN_1080P) + SMALL_TRACKS
STREAMS = ("av1_10bit_64x48.obu", "av1_gop_96x64.obu")
MANIFEST = "avif_fixtures.json"


def avif_content(h: int, w: int, seed: int) -> np.ndarray:
    """(h, w, 3) uint8: diagonal waves, flat rectangles and noise of
    amplitude 12, all from ``seed``."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([
        128 + 90 * np.sin(x / 97.0 + y / 151.0),
        128 + 90 * np.sin(x / 61.0 - y / 83.0 + 1.0),
        128 + 90 * np.cos((x + y) / 131.0)], -1)
    for _ in range(12):
        y0, x0 = rng.integers(0, h - h // 8), rng.integers(0, w - w // 8)
        img[y0:y0 + rng.integers(h // 32, h // 8),
            x0:x0 + rng.integers(w // 32, w // 8)] = rng.integers(0, 256, 3)
    img += rng.integers(-12, 13, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _pil_avif(arr: np.ndarray, mode=None, **kw) -> bytes:
    from PIL import Image
    b = io.BytesIO()
    im = Image.fromarray(arr, mode) if mode else Image.fromarray(arr)
    im.save(b, "AVIF", **kw)
    return b.getvalue()


def _av01_tile(arr: np.ndarray, quality: int):
    """One tile coded by PIL: its ``av01`` payload and ``av1C`` record."""
    from ffpic_tpu_torch.formats import heif
    data = _pil_avif(arr, quality=quality, speed=6)
    s = heif.parse_structure(data)
    pid = s["primary"]
    return (heif.read_item(data, s, pid),
            s["items"][pid]["properties"]["av1C"])


def grid_avif(img: np.ndarray, rows: int, cols: int,
              quality: int = 60) -> bytes:
    """A grid AVIF of ``img`` cut into rows x cols equal tiles."""
    from ffpic_tpu_torch.formats import heif_enc as he
    H, W = img.shape[:2]
    th, tw = H // rows, W // cols
    grid = bytes((0, 1, rows - 1, cols - 1)) + struct.pack(">II", W, H)
    colr = he._box("colr", b"nclx" + struct.pack(">HHHB", 1, 13, 6, 0x80))
    items = [(1, b"grid", grid, [(he._ispe(W, H), False)])]
    refs = [("dimg", 1, list(range(2, 2 + rows * cols)))]
    for k in range(rows * cols):
        r, c = divmod(k, cols)
        payload, av1c = _av01_tile(
            np.ascontiguousarray(img[r * th:(r + 1) * th,
                                     c * tw:(c + 1) * tw]), quality)
        items.append((2 + k, b"av01", payload, [
            (he._box("av1C", av1c), True), (he._ispe(tw, th), False),
            (colr, False)]))
    return he._assemble(items, refs, 1, brand=b"avif",
                        compat=b"avifmif1miaf")


def track_avif(seed: int) -> bytes:
    """Three 64x48 frames that PIL writes as an animated AVIF."""
    from PIL import Image
    frames = [Image.fromarray(avif_content(48, 64, seed + i))
              for i in range(3)]
    b = io.BytesIO()
    frames[0].save(b, "AVIF", save_all=True, append_images=frames[1:],
                   duration=100)
    return b.getvalue()


def pan_frames(h: int, w: int, n: int, seed: int, step: int = 5) -> list:
    """``n`` (h, w, 3) uint8 windows of one ``avif_content`` canvas, each
    ``step`` pixels right of and one below the one before."""
    big = avif_content(h + n, w + step * n, seed)
    return [np.ascontiguousarray(big[i:i + h, step * i:step * i + w])
            for i in range(n)]


def animated_avif(frames, **kw) -> bytes:
    """The frames as PIL's animated AVIF (an ``av01`` track behind a
    still cover), 100 ms each."""
    from PIL import Image
    ims = [Image.fromarray(f) for f in frames]
    b = io.BytesIO()
    ims[0].save(b, "AVIF", save_all=True, append_images=ims[1:],
                duration=100, **kw)
    return b.getvalue()


def grain(test_vector: int) -> dict:
    """libaom's film grain test vector ``test_vector`` as PIL's option."""
    return {"advanced": (("film-grain-test", str(test_vector)),)}


def planes_stream(n: int, h: int, w: int, bd: int, seed: int,
                  step: int = 3) -> list:
    """``n`` frames of [Y, U, V] 4:2:0 planes at ``bd`` bits: a panning
    wave with noise in luma, waves in chroma."""
    rng = np.random.default_rng(seed)
    mx = (1 << bd) - 1
    y, x = np.mgrid[0:h, 0:w + step * n].astype(np.float64)
    luma = np.clip(mx / 2 + mx / 3 * np.sin(x / 9.0 + y / 13.0)
                   + rng.integers(-(mx // 16), mx // 16, y.shape),
                   0, mx).astype(np.uint16)
    chroma = np.clip(mx / 2 + mx / 4 * np.cos(x / 7.0 - y / 11.0),
                     0, mx).astype(np.uint16)
    out = []
    for i in range(n):
        c = np.ascontiguousarray(chroma[::2, step * i:step * i + w:2])
        out.append([np.ascontiguousarray(luma[:, step * i:step * i + w]),
                    c, np.ascontiguousarray(c[:, ::-1])])
    return out


def aom_stream(frames, bd: int) -> bytes:
    """The frames through libaom's encoder at its default lag (ctypes,
    ``tools/aom_oracle.encode_frames``): a raw OBU stream."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(HERE), "tools"))
    import aom_oracle
    return aom_oracle.encode_frames(frames, bit_depth=bd, speed=6)


def make(seed: int) -> dict:
    """{file name: bytes} of every fixture."""
    img = avif_content(1080, 1920, seed)
    h, w = img.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    alpha = np.clip(255 - np.hypot(yy - h / 2, xx - w / 2) / 4,
                    0, 255).astype(np.uint8)
    return {
        "avif_1080p_420.avif": _pil_avif(img, quality=60, speed=6),
        "avif_1080p_444_alpha.avif": _pil_avif(
            np.dstack([avif_content(1080, 1920, seed + 1), alpha]), "RGBA",
            quality=70, speed=6, subsampling="4:4:4"),
        "avif_1080p_grid.avif": grid_avif(avif_content(1080, 1920, seed + 2),
                                          2, 2),
        "avif_1080p_sb128.avif": _pil_avif(avif_content(1080, 1920,
                                                        seed + 3),
                                           quality=60, speed=0),
        TRACK: track_avif(seed + 4),
        GRAIN_1080P: animated_avif(pan_frames(1080, 1920, 3, seed + 5),
                                   quality=60, speed=6, **grain(1)),
        "avis_96x64_grain.avif": animated_avif(
            pan_frames(64, 96, 3, seed + 10), quality=60, speed=6,
            **grain(1)),
        "avis_176x128.avif": animated_avif(
            pan_frames(128, 176, 4, seed + 11), quality=60, speed=6),
        "avis_128x96_444.avif": animated_avif(
            pan_frames(96, 128, 3, seed + 12), quality=60, speed=6,
            subsampling="4:4:4"),
        "avis_176x128_grain.avif": animated_avif(
            pan_frames(128, 176, 3, seed + 13), quality=50, speed=6,
            **grain(2)),
        "av1_10bit_64x48.obu": aom_stream(
            planes_stream(6, 48, 64, 10, seed + 3), 10),
        "av1_gop_96x64.obu": aom_stream(
            planes_stream(6, 64, 96, 8, seed + 14), 8),
    }


def pixels_entry(px: np.ndarray) -> dict:
    """The shape and sha256 of (H, W, 4) pixels."""
    return dict(shape=list(px.shape), pixels_sha256=hashlib.sha256(
        np.ascontiguousarray(px)).hexdigest())


def planes_sha256(planes) -> str:
    """The sha256 of a frame's planes, each as contiguous bytes in
    order."""
    h = hashlib.sha256()
    for p in planes:
        h.update(np.ascontiguousarray(p).tobytes())
    return h.hexdigest()


def manifest(files: dict) -> dict:
    """Each file's sha256; for the stills the shape and sha256 of the
    port's ``load`` pixels on the CPU, for the animations each frame's
    with its ``delay_ms`` from ``load_all``, for the raw streams each
    shown frame's ``planes_sha256`` from ``Av1Decoder``."""
    import ffpic_tpu_torch
    from ffpic_tpu_torch.formats.av1_recon import Av1Decoder
    out = {}
    for name, blob in files.items():
        ent = {"sha256": hashlib.sha256(blob).hexdigest()}
        if name in STILLS:
            ent.update(pixels_entry(
                ffpic_tpu_torch.load(blob, device="cpu").np_pixels()))
        elif name in TRACKS:
            ent["frames"] = [
                dict(pixels_entry(p.np_pixels()), delay_ms=p.delay_ms)
                for p in ffpic_tpu_torch.load_all(blob, device="cpu")]
        elif name in STREAMS:
            ent["frames"] = [{"planes_sha256": planes_sha256(planes)}
                             for planes, _ in Av1Decoder().decode_obus(blob)]
        out[name] = ent
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--manifest-only", action="store_true",
                    help="rewrite the manifest of the files in --out")
    a = ap.parse_args(argv)
    os.makedirs(a.out, exist_ok=True)
    if a.manifest_only:
        files = {}
        for name in STILLS + TRACKS + STREAMS:
            with open(os.path.join(a.out, name), "rb") as f:
                files[name] = f.read()
    else:
        files = make(a.seed)
    for name, blob in files.items():
        if not a.manifest_only:
            with open(os.path.join(a.out, name), "wb") as f:
                f.write(blob)
        print(f"{name}: {len(blob)} bytes")
    with open(os.path.join(a.out, MANIFEST), "w") as f:
        json.dump(manifest(files), f, indent=1, sort_keys=True)
        f.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
