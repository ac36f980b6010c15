"""Write the JPEG 2000 and OpenEXR fixtures of ``ffpic_tpu_torch/testdata``
from a seed.

    python3 -m ffpic_tpu_torch.make_still_fixtures [--seed 0] [--out DIR]

Machines without PIL or the OpenEXR library read the committed files
through ``testing.still_fixture``; this script is how they were made.
It needs PIL with openjpeg, and ``g++`` with OpenEXR 3.1's headers and
libraries, from which it builds a small writer (``EXR_TOOL``) in a
temporary directory.  Content is ``still_rgb``: smooth waves and flat
rectangles without noise, so that the lossless files stay small.

* ``jp2_1080p_53.jp2``: 1920x1080 RGB, reversible 5/3 with the RCT, one
  tile, one layer (openjpeg through PIL);
* ``jp2_1080p_97.jp2``: 1920x1080 RGB, irreversible 9/7 with the ICT,
  512x512 tiles, 3 quality layers (rates 80, 40, 20);
* ``exr_1080p_piz.exr``: 1920x1080 RGBA, half, PIZ, written by the
  port's ``encode`` (its Python Huffman coder takes about 20 s here,
  too long to run on the card's machine in a smoke run);
* ``exr_1080p_dwaa.exr``, ``exr_1080p_dwab.exr``: 1920x1080 half R, G,
  B, the linear light of ``still_rgb``, DWAA and DWAB (OpenEXR's
  writer: no Python encoder exists in either package);
* ``exr_dwaa_64x48.exr`` and ``exr_dwab_40x272.exr``: small DWAA and
  DWAB files of five half channels (B, G, R take the lossy DCT, A the
  RLE and Q the zlib class), the second taller than one 256-line block,
  for the tests on the CPU.
"""

from __future__ import annotations

import argparse
import io
import os
import shutil
import subprocess
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "testdata")

EXR_TOOL = r"""
#include <ImfOutputFile.h>
#include <ImfHeader.h>
#include <ImfChannelList.h>
#include <ImfFrameBuffer.h>
#include <ImfCompression.h>
#include <half.h>
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>
using namespace Imf;
// out.exr W H compression name...: the channels' halves on stdin,
// one plane after another, in the order named
int main(int argc, char **argv) {
    if (argc < 6) return 2;
    int W = atoi(argv[2]), H = atoi(argv[3]), comp = atoi(argv[4]);
    int nc = argc - 5;
    std::vector<std::vector<half>> data(nc);
    Header hdr(W, H);
    hdr.compression() = (Compression)comp;
    FrameBuffer fb;
    for (int c = 0; c < nc; c++) {
        data[c].resize((size_t)W * H);
        if (fread(data[c].data(), 2, (size_t)W * H, stdin) != (size_t)W * H)
            return 3;
        hdr.channels().insert(argv[5 + c], Channel(HALF));
        fb.insert(argv[5 + c], Slice(HALF, (char *)data[c].data(), 2,
                                     2 * (size_t)W));
    }
    OutputFile f(argv[1], hdr);
    f.setFrameBuffer(fb);
    f.writePixels(H);
    return 0;
}
"""
DWAA, DWAB = 8, 9


def still_rgb(h: int, w: int, seed: int) -> np.ndarray:
    """(h, w, 3) uint8: a few smooth waves per channel and flat
    rectangles, no noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32) / max(h, w)
    img = np.empty((h, w, 3), np.float32)
    for c in range(3):
        acc = np.zeros((h, w), np.float32)
        for _ in range(3):
            fy, fx = rng.uniform(0.5, 4.0, 2)
            acc += rng.uniform(20, 40) * np.sin(
                2 * np.pi * (fy * yy + fx * xx) + rng.uniform(0, 2 * np.pi))
        img[..., c] = 128 + acc
    for _ in range(10):
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        dy, dx = rng.integers(h // 20 + 1, h // 4 + 2), \
            rng.integers(w // 20 + 1, w // 4 + 2)
        img[y0:y0 + dy, x0:x0 + dx] = rng.uniform(0, 255, 3)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def still_alpha(h: int, w: int) -> np.ndarray:
    """(h, w) uint8: a horizontal ramp with an opaque band."""
    xx = np.mgrid[0:h, 0:w][1]
    a = 64 + xx * 191 // max(w - 1, 1)
    a[h // 3:h // 2] = 255
    return a.astype(np.uint8)


def small_halves(nc: int, h: int, w: int, seed: int) -> list:
    """``nc`` (h, w) float16 planes: smooth waves and mild noise, the
    content of ``tests/test_exr_oracle.py``'s DWA cases."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for c in range(nc):
        smooth = np.sin(xx / (5.0 + c)) * np.cos(yy / (7.0 + c)) * (c + 1.5)
        out.append((smooth + rng.random((h, w)) * 0.25).astype(np.float16))
    return out


def _jp2(rgb: np.ndarray, **kw) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG2000", **kw)
    return buf.getvalue()


def _tool(tmp: str) -> str:
    src = os.path.join(tmp, "exr_tool.cpp")
    exe = os.path.join(tmp, "exr_tool")
    with open(src, "w") as f:
        f.write(EXR_TOOL)
    if not shutil.which("g++"):
        raise RuntimeError("g++ is needed to build the OpenEXR writer")
    subprocess.run(["g++", "-O2", "-o", exe, src, "-I/usr/include/OpenEXR",
                    "-I/usr/include/Imath", "-lOpenEXR-3_1", "-lImath-3_1",
                    "-lIex-3_1"], check=True, capture_output=True)
    return exe


def _openexr(tool: str, tmp: str, planes: dict, comp: int) -> bytes:
    """OpenEXR's file of the named (h, w) float16 planes."""
    h, w = next(iter(planes.values())).shape
    path = os.path.join(tmp, "out.exr")
    raw = b"".join(np.ascontiguousarray(p, np.float16).tobytes()
                   for p in planes.values())
    subprocess.run([tool, path, str(w), str(h), str(comp), *planes],
                   input=raw, check=True, capture_output=True)
    with open(path, "rb") as f:
        return f.read()


def fixtures(seed: int) -> dict[str, bytes]:
    """{file name: bytes} of every fixture."""
    import ffpic_tpu_torch
    from ffpic_tpu_torch.formats.exr import _srgb_to_linear
    from ffpic_tpu_torch.formats.pic import Pic
    h, w = 1080, 1920
    rgb = still_rgb(h, w, seed)
    rgba = np.dstack([rgb, still_alpha(h, w)])
    lin = _srgb_to_linear(rgb.astype(np.float32) / 255.0).astype(np.float16)
    out = {
        "jp2_1080p_53.jp2": _jp2(rgb, irreversible=False, mct=1),
        "jp2_1080p_97.jp2": _jp2(rgb, irreversible=True, mct=1,
                                 tile_size=(512, 512), quality_mode="rates",
                                 quality_layers=[80, 40, 20]),
        "exr_1080p_piz.exr": ffpic_tpu_torch.encode(
            Pic(pixels=rgba, width=w, height=h), "EXR", compression="piz",
            device="cpu"),
    }
    with tempfile.TemporaryDirectory() as tmp:
        tool = _tool(tmp)
        planes = {"B": lin[..., 2], "G": lin[..., 1], "R": lin[..., 0]}
        out["exr_1080p_dwaa.exr"] = _openexr(tool, tmp, planes, DWAA)
        out["exr_1080p_dwab.exr"] = _openexr(tool, tmp, planes, DWAB)
        for name, comp, (ph, pw), s in (
                ("exr_dwaa_64x48.exr", DWAA, (48, 64), seed + 3),
                ("exr_dwab_40x272.exr", DWAB, (272, 40), seed + 4)):
            out[name] = _openexr(tool, tmp, dict(zip(
                "BGRAQ", small_halves(5, ph, pw, s))), comp)
    return out


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
