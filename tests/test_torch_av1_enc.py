"""The port's AV1 still encoder (``coding/av1_msac_enc.py``,
``coding/av1_enc.py``) and ``encode(pic, "AVIF")`` held against
ffpic_tpu's on the CPU: the same bytes, byte for byte.

``MsacEnc`` on seeded transcripts of symbols, bools, literals and
Golomb codes (and the port's own ``Msac`` reads them back);
``encode_av1`` at 8 and 10 bits, 4:2:0, 4:4:4 and monochrome, lossless
and lossy, on odd sizes; ``avif.encode`` at quality 100 (lossless,
identity colour) and 75 on a 64x48 and an odd-sized ``Pic``, whose
decodes equal the reference's too; and ``transcode -c avif``.
"""

import random

import numpy as np
import pytest
import torch

import ffpic_tpu
import ffpic_tpu_torch
from ffpic_tpu import native as jax_native
from ffpic_tpu.coding import av1_enc as jax_enc
from ffpic_tpu.coding import av1_msac_enc as jax_msac_enc
from ffpic_tpu.formats.pic import Pic as JaxPic
from ffpic_tpu_torch.coding import av1_enc, av1_msac_enc
from ffpic_tpu_torch.coding.av1_msac import Msac
from ffpic_tpu_torch.formats import av1_recon
from ffpic_tpu_torch.formats.pic import Pic
import reference_native  # noqa: F401  (readies ffpic_tpu first)


@pytest.fixture(autouse=True)
def _native_first():
    jax_native.available()


def _cdfs():
    return [[24000, 16000, 8000, 0, 0], [20000, 0, 0],
            [30000, 26000, 21000, 15000, 9000, 4000, 0, 0]]


@pytest.mark.parametrize("seed", range(4))
def test_msac_enc_matches_jax(seed):
    """The same transcript through both encoders gives the same bytes,
    and the port's decoder reads it back."""
    rng = random.Random(seed)
    for _ in range(12):
        encs = (av1_msac_enc.MsacEnc(allow_update=True),
                jax_msac_enc.MsacEnc(allow_update=True))
        cdfs = (_cdfs(), _cdfs())
        ops = []
        for _ in range(rng.randrange(1, 120)):
            k = rng.randrange(4)
            if k == 0:
                c = rng.randrange(3)
                op = ("s", c, rng.randrange(len(cdfs[0][c]) - 1))
            elif k == 1:
                op = ("b", rng.randrange(2))
            elif k == 2:
                nb = rng.randrange(1, 13)
                op = ("l", rng.randrange(1 << nb), nb)
            else:
                op = ("g", rng.randrange(3000))
            ops.append(op)
            for enc, cd in zip(encs, cdfs):
                if op[0] == "s":
                    enc.encode_symbol(cd[op[1]], op[2])
                elif op[0] == "b":
                    enc.encode_bool(op[1])
                elif op[0] == "l":
                    enc.encode_literal(op[1], op[2])
                else:
                    enc.encode_golomb(op[1])
        got, want = (e.done() for e in encs)
        assert got == want
        dec, cd = Msac(got, allow_update=True), _cdfs()
        for op in ops:
            if op[0] == "s":
                assert dec.decode_symbol(cd[op[1]]) == op[2]
            elif op[0] == "b":
                assert dec.decode_bool(1 << 14) == op[1]
            elif op[0] == "l":
                assert dec.decode_literal(op[2]) == op[1]
            else:
                assert dec.decode_golomb() == op[1]


@pytest.mark.parametrize("bd,sub,q,mono,wh", [
    (8, (1, 1), 0, False, (33, 17)), (8, (0, 0), 0, False, (40, 24)),
    (8, (1, 1), 60, False, (64, 48)), (10, (1, 1), 40, False, (37, 29)),
    (10, (0, 0), 0, False, (24, 16)), (8, (1, 1), 90, True, (24, 24))])
def test_encode_av1_matches_jax(bd, sub, q, mono, wh):
    """``encode_av1``'s OBUs equal the reference's; lossless streams
    decode back to their planes exactly in the port."""
    rng = np.random.default_rng(bd + q + wh[0])
    w, h = wh
    dt = np.uint8 if bd == 8 else np.uint16
    planes = [rng.integers(0, 1 << bd, (h, w)).astype(dt)]
    if not mono:
        cw, ch = (w + sub[0]) >> sub[0], (h + sub[1]) >> sub[1]
        planes += [rng.integers(0, 1 << bd, (ch, cw)).astype(dt)
                   for _ in range(2)]
    got = av1_enc.encode_av1(planes, bd, sub, q, monochrome=mono)
    assert got == jax_enc.encode_av1(planes, bd, sub, q, monochrome=mono)
    if q == 0:
        out, _ = av1_recon.decode_frame(got)
        for a, p in zip(out, planes):
            np.testing.assert_array_equal(a, p)


def _pixels(h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    rgb = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                    (x + y) % 256], -1) + rng.integers(-20, 21, (h, w, 3))
    return np.dstack([np.clip(rgb, 0, 255).astype(np.uint8),
                      np.full((h, w), 255, np.uint8)])


@pytest.mark.parametrize("quality", [100, 75])
@pytest.mark.parametrize("hw", [(48, 64), (37, 53)])
def test_avif_encode_matches_jax(quality, hw):
    """``encode(pic, "AVIF")`` of a ``Pic`` (host or tensor pixels) gives
    the reference's bytes, and the port decodes them to the reference's
    pixels (quality 100 back to the input exactly)."""
    px = _pixels(*hw, sum(hw))
    h, w = hw
    want = ffpic_tpu.encode(JaxPic(width=w, height=h, depth=32, pitch=w * 4,
                                   pixels=px), "AVIF", quality=quality)
    for pixels in (px, torch.from_numpy(px)):
        pic = Pic(width=w, height=h, depth=32, pitch=w * 4, pixels=pixels)
        got = ffpic_tpu_torch.encode(pic, "AVIF", quality=quality,
                                     device="cpu")
        assert got == want
    back = ffpic_tpu_torch.load(got, device="cpu").pixels.numpy()
    np.testing.assert_array_equal(back, ffpic_tpu.load(want).np_pixels())
    if quality == 100:
        np.testing.assert_array_equal(back, px)


def test_transcode_to_avif_matches_jax(tmp_path):
    """``python -m ffpic_tpu_torch.apps.transcode FILE -c avif`` writes
    the reference app's bytes."""
    from ffpic_tpu.apps import transcode as jax_transcode
    from ffpic_tpu_torch import testing
    from ffpic_tpu_torch.apps import transcode
    src = tmp_path / "in.png"
    src.write_bytes(testing.encode_png(_pixels(24, 40, 3), 6, 8))
    ours, ref = tmp_path / "ours.avif", tmp_path / "ref.avif"
    assert transcode.main([str(src), "-c", "avif", "-o", str(ours),
                           "--device", "cpu"]) == 0
    assert jax_transcode.main([str(src), "-c", "avif", "-o", str(ref)]) == 0
    assert ours.read_bytes() == ref.read_bytes()
