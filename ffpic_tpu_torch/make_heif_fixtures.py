"""Write the HEIF fixture of ``ffpic_tpu_torch/testdata`` with the port's
own HEVC/HEIF encoder, from a seed.

    python3 -m ffpic_tpu_torch.make_heif_fixtures [--seed 0] [--out DIR]

``heic_12mp_grid.heic``: a 4032x3024 iPhone-style grid of 48 tiles of
512x512 at quality 50 (QP 26, CTB 32, 8-bit 4:2:0), the JAX package's
bench content (``tools/make_corpus.py:84-97``): ``synth_rgb(3024, 4032,
seed=11 + seed)``, a copy of ``tools/make_corpus.py:20-32``, through
``formats.heif_enc.encode_heif(quality=50, tile=512)``.  With seed 0
the file is the JAX bench's ``corpus/heic_12mp_grid.heic`` byte for
byte; the script checks its sha256 (``SHA256``).  The encoder is
Python and takes minutes for the 48 tiles, too slow to remake the file
where it is used, so it is committed.
"""

from __future__ import annotations

import argparse
import hashlib
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "testdata")
NAME = "heic_12mp_grid.heic"
# sha256 of the seed-0 file, which is also the JAX bench's
SHA256 = "3b947ef12c91efaf706053cd3831d8b4c141d267e139a4ceacf52880389d8e6f"


def synth_rgb(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Photo-like (h, w, 3) uint8: smooth waves, sensor-like noise and
    two hard edges (``tools/make_corpus.py:20-32``)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([
        128 + 100 * np.sin(xx / 37.0) * np.cos(yy / 23.0),
        128 + 80 * np.cos(xx / 11.0 + yy / 41.0),
        128 + 110 * np.sin((xx + yy) / 53.0),
    ], axis=-1)
    img += rng.normal(0, 12, size=img.shape)  # sensor-ish noise
    # hard edges
    img[h // 3:h // 3 + max(4, h // 40), :, :] = 240
    img[:, w // 2:w // 2 + max(4, w // 40), :] = 16
    return np.clip(img, 0, 255).astype(np.uint8)


def make(seed: int = 0) -> bytes:
    """The 12 MP grid HEIC's bytes."""
    from ffpic_tpu_torch.formats.heif_enc import encode_heif
    from ffpic_tpu_torch.formats.pic import Pic
    a12 = synth_rgb(3024, 4032, seed=11 + seed)
    rgba = np.dstack([a12, np.full(a12.shape[:2], 255, np.uint8)])
    return encode_heif(Pic(pixels=rgba, width=4032, height=3024),
                       quality=50, tile=512)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    blob = make(args.seed)
    digest = hashlib.sha256(blob).hexdigest()
    if args.seed == 0 and digest != SHA256:
        raise SystemExit(f"{NAME}: sha256 {digest}, expected {SHA256}")
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, NAME)
    with open(path, "wb") as f:
        f.write(blob)
    print(f"{path}: {len(blob)} bytes, sha256 {digest}")


if __name__ == "__main__":
    main()
