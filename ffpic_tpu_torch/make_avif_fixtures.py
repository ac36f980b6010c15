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
  ``av01`` track behind a still cover, for the check that the port
  refuses what it cannot decode yet;
* ``avif_fixtures.json``: each file's sha256 and, for the stills, the
  shape and sha256 of the port's ``load`` pixels on the CPU.  The
  tier-1 test ``tests/test_torch_avif.py::test_fixture_hashes``
  recomputes both with each package: the JAX package's pixels must
  give the same hash.
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
    }


def manifest(files: dict) -> dict:
    """Each file's sha256, and for the stills the shape and sha256 of
    the port's ``load`` pixels on the CPU."""
    import ffpic_tpu_torch
    out = {}
    for name, blob in files.items():
        ent = {"sha256": hashlib.sha256(blob).hexdigest()}
        if name in STILLS:
            px = ffpic_tpu_torch.load(blob, device="cpu").np_pixels()
            ent.update(shape=list(px.shape),
                       pixels_sha256=hashlib.sha256(
                           np.ascontiguousarray(px)).hexdigest())
        out[name] = ent
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=OUT)
    a = ap.parse_args(argv)
    os.makedirs(a.out, exist_ok=True)
    files = make(a.seed)
    for name, blob in files.items():
        with open(os.path.join(a.out, name), "wb") as f:
            f.write(blob)
        print(f"{name}: {len(blob)} bytes")
    with open(os.path.join(a.out, MANIFEST), "w") as f:
        json.dump(manifest(files), f, indent=1, sort_keys=True)
        f.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
