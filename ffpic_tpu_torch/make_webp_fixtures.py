"""Write the WebP fixtures of ``ffpic_tpu_torch/testdata`` with PIL
(libwebp), from a seed.

    python3 -m ffpic_tpu_torch.make_webp_fixtures [--seed 0] [--out DIR]

Machines without PIL (or without its WebP support) read the committed
files through ``testing.webp_fixture``; this script is how they were
made.  Content is photo-like: a few smooth waves per channel, mild
noise and some hard-edged rectangles, so that the encoder uses both
whole-macroblock and 4x4 prediction modes and all four segments.

* ``lossy_1080p.webp``: 1920x1080 VP8 at quality 80;
* ``lossy_512.webp``: 512x512 VP8 at quality 80;
* ``alpha_1080p.webp``: 1920x1080 RGBA, VP8X + ALPH (VP8L-compressed
  alpha: steps, a ramp and a transparent band, vertically
  filtered) + VP8 at 80;
* ``odd_333x199.webp``: 333x199 VP8 at quality 60 (odd sizes, partial
  macroblocks on both edges);
* ``lossless_160x120.webp``: 160x120 RGBA VP8L at method 6 (predictor,
  colour and subtract-green transforms);
* ``animated_96x64.webp``: 96x64, three lossy RGBA frames of 40-60 ms
  (VP8X + ANIM + ANMF, each frame VP8 + ALPH, its steps unfiltered).

libwebp chooses each ALPH filter from the content.  The reference
decoder undoes the horizontal and vertical filters without libwebp's
rule for the first column and the first row (``ROADMAP.md`` Queue 3),
and the port mirrors it: ``alpha_1080p`` shows that difference,
vertically filtered; the animation's alpha, unfiltered, does not, so
that its blending is checked against libwebp exactly.
"""

from __future__ import annotations

import argparse
import io
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "testdata")


def photo(h: int, w: int, seed: int) -> np.ndarray:
    """(h, w, 3) uint8 photo-like content from ``seed``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32) / max(h, w)
    img = np.empty((h, w, 3), np.float32)
    for c in range(3):
        acc = np.zeros((h, w), np.float32)
        for _ in range(4):
            fy, fx = rng.uniform(0.5, 8.0, 2)
            acc += rng.uniform(20, 45) * np.sin(
                2 * np.pi * (fy * yy + fx * xx) + rng.uniform(0, 2 * np.pi))
        img[..., c] = 128 + acc + rng.normal(0, 3, (h, w))
    for _ in range(12):
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        dy, dx = rng.integers(h // 20 + 1, h // 4 + 2), \
            rng.integers(w // 20 + 1, w // 4 + 2)
        img[y0:y0 + dy, x0:x0 + dx] = rng.uniform(0, 255, 3)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def alpha_steps(h: int, w: int, n: int = 16) -> np.ndarray:
    """(h, w) uint8 steps of 4 levels, ``n`` across."""
    yy, xx = np.mgrid[0:h, 0:w]
    return ((xx // (w // n + 1) + yy // (h * 3 // (4 * n) + 1)) % 4 * 80
            + 15).astype(np.uint8)


def alpha_plane(h: int, w: int) -> np.ndarray:
    """(h, w) uint8: steps on the left half, a horizontal ramp on the
    right, a transparent band of columns in it.  At 1920x1080 libwebp
    picks the vertical filter for it."""
    xx = np.mgrid[0:h, 0:w][1]
    a = np.where(xx < w // 2, alpha_steps(h, w), xx * 255 // w)
    a[:, 25 * w // 32:26 * w // 32] = 0
    return a.astype(np.uint8)


def _save(arr: np.ndarray, **kw) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "WEBP", **kw)
    return buf.getvalue()


def fixtures(seed: int) -> dict[str, bytes]:
    """{file name: bytes} of every fixture."""
    from PIL import Image
    big = photo(1080, 1920, seed)
    small = photo(64, 96, seed + 5)
    frames = [Image.fromarray(np.dstack([np.roll(small, 16 * k, axis=1),
                                         alpha_steps(64, 96, 8)]))
              for k in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:],
                   duration=[40, 50, 60], loop=0, lossless=False,
                   quality=75)
    return {
        "lossy_1080p.webp": _save(big, quality=80, method=4),
        "lossy_512.webp": _save(photo(512, 512, seed + 1), quality=80,
                                method=4),
        "alpha_1080p.webp": _save(np.dstack([big, alpha_plane(1080, 1920)]),
                                  quality=80, method=4),
        "odd_333x199.webp": _save(photo(199, 333, seed + 2), quality=60,
                                  method=4),
        "lossless_160x120.webp": _save(
            np.dstack([photo(120, 160, seed + 3),
                       alpha_plane(120, 160)]), lossless=True, quality=100,
            method=6),
        "animated_96x64.webp": buf.getvalue(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    for name, data in fixtures(args.seed).items():
        with open(os.path.join(args.out, name), "wb") as f:
            f.write(data)
        print(f"{name}: {len(data)} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
