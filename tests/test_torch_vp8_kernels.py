"""The VP8 device stages of ffpic_tpu_torch (CPU, plain versions) held
against ffpic_tpu's on the same arrays, exactly: ``vp8_idct4x4`` and
``vp8_iwht4x4`` (and the port's numpy models of them in ``ops.golden``)
on asymmetric int16 blocks over the whole int16 range;
``vp8_residuals_plain`` (K12's function) on ``testing.vp8_cases``
(``test_torch_webp.py`` feeds it a real file's parse);
``vp8_yuv_to_rgba_plain`` (K13's)
at small odd sizes, with and without alpha.  Every stage is integer, so
the tolerance is zero.  The CUDA kernels run only on a GPU
(``chip_smoke.py``); here their wrappers are checked to refuse CPU
tensors and the entries to take the plain versions for CPU tensors.
"""

import numpy as np
import pytest
import torch

from ffpic_tpu.formats.webp import _yuv_to_rgb_libwebp
from ffpic_tpu.ops import golden as jax_golden
from ffpic_tpu.ops import vp8_kernels as jax_vk
from ffpic_tpu_torch import testing
from ffpic_tpu_torch.ops import cuda_vp8, golden
from ffpic_tpu_torch.ops import vp8_kernels as vk
import reference_native  # noqa: F401  (readies ffpic_tpu first)

SIZES = [1, 2, 15, 17, 33, 40]


def _blocks(seed: int, shape) -> np.ndarray:
    """Random int16 blocks over the whole range, with the int16 extremes
    planted, none of them symmetric (a transposed transform would pass
    a symmetric block)."""
    rng = np.random.default_rng(seed)
    b = rng.integers(-32768, 32768, (*shape, 4, 4)).astype(np.int16)
    b.reshape(-1, 16)[:, 1] = 32767
    b.reshape(-1, 16)[:, 4] = -32768
    assert not np.array_equal(b, np.swapaxes(b, -1, -2))
    return b


@pytest.mark.parametrize("seed,shape", [(0, (7,)), (1, (3, 5, 24)),
                                        (2, (2, 2, 2, 9))])
def test_idct4x4_matches_jax(seed, shape):
    b = _blocks(seed, shape)
    got = vk.vp8_idct4x4(torch.from_numpy(b))
    assert got.dtype == torch.int16
    want = np.asarray(jax_vk.vp8_idct4x4(b))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(golden.vp8_idct4x4(b), want)
    np.testing.assert_array_equal(golden.vp8_idct4x4(b),
                                  jax_golden.vp8_idct4x4(b))


@pytest.mark.parametrize("seed,shape", [(3, (7,)), (4, (3, 5)),
                                        (5, (2, 2, 11))])
def test_iwht4x4_matches_jax(seed, shape):
    b = _blocks(seed, shape)
    got = vk.vp8_iwht4x4(torch.from_numpy(b))
    assert got.dtype == torch.int16
    want = np.asarray(jax_vk.vp8_iwht4x4(b))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(golden.vp8_iwht4x4(b), want)
    np.testing.assert_array_equal(golden.vp8_iwht4x4(b),
                                  jax_golden.vp8_iwht4x4(b))


def test_idct4x4_is_not_symmetric_in_its_passes():
    """One coefficient in row 0, column 1 and its transpose give
    transposed residuals: the passes keep their orientation."""
    a = np.zeros((4, 4), np.int16)
    a[0, 1] = 1000
    got = vk.vp8_idct4x4(torch.from_numpy(a)).numpy()
    got_t = vk.vp8_idct4x4(torch.from_numpy(a.T.copy())).numpy()
    np.testing.assert_array_equal(got_t, got.T)
    assert not np.array_equal(got, got.T)
    np.testing.assert_array_equal(got, np.asarray(jax_vk.vp8_idct4x4(a)))


@pytest.mark.parametrize("name", sorted(testing.vp8_cases()["residuals"]))
def test_residuals_match_jax(name):
    levels, dq, has_y2 = testing.vp8_cases()["residuals"][name]
    got = vk.vp8_residuals_plain(torch.from_numpy(levels),
                                 torch.from_numpy(dq),
                                 torch.from_numpy(has_y2))
    assert got.dtype == torch.int16 and tuple(got.shape) == (
        *levels.shape[:2], 24, 4, 4)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_vk.vp8_residuals(levels, dq, has_y2)))


def test_residual_cases_cover_their_edges():
    """The cases hold what they claim: products that overflow int16 and
    int32, both has_y2 values, four segments' factors, a 1x1 and a 1xN
    grid."""
    res = testing.vp8_cases()["residuals"]
    lv, dq, hy = res["wrap_int16_4seg"]
    prod = lv[..., :16, 1:].astype(np.int64) * dq[..., 1, None, None]
    assert np.abs(prod).max() > 32767
    assert len({tuple(r) for r in dq.reshape(-1, 6)}) == 4
    assert hy.any() and not hy.all()
    lv, dq, _ = res["wrap_int32"]
    assert np.abs(lv[..., 0].astype(np.int64) * dq[..., :1]).max() > 2 ** 31
    assert res["mb1x1_y2"][0].shape[:2] == (1, 1)
    assert res["mb1x37_mixed"][0].shape[:2] == (1, 37)


def test_residuals_entry_takes_the_plain_version_on_the_cpu():
    levels, dq, has_y2 = testing.vp8_cases()["residuals"]["mb1x37_mixed"]
    args = [torch.from_numpy(a) for a in (levels, dq, has_y2)]
    assert torch.equal(vk.vp8_residuals(*args),
                       vk.vp8_residuals_plain(*args))


@pytest.mark.parametrize("h", SIZES)
@pytest.mark.parametrize("w", SIZES)
def test_yuv_to_rgba_matches_jax(h, w):
    rng = np.random.default_rng(100 * h + w)
    ph, pw = -(-h // 16) * 16, -(-w // 16) * 16
    Y = rng.integers(0, 256, (ph, pw)).astype(np.uint8)
    U = rng.integers(0, 256, (ph // 2, pw // 2)).astype(np.uint8)
    V = rng.integers(0, 256, (ph // 2, pw // 2)).astype(np.uint8)
    want = np.array(jax_vk.vp8_yuv_to_rgba(Y, U, V, h, w))
    t = [torch.from_numpy(p) for p in (Y, U, V)]
    got = vk.vp8_yuv_to_rgba_plain(*t, h, w)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (h, w, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    # with an alpha plane: the JAX path's alpha write that follows it
    alpha = rng.integers(0, 256, (h, w)).astype(np.uint8)
    want[..., 3] = alpha
    np.testing.assert_array_equal(
        vk.vp8_yuv_to_rgba_plain(*t, h, w, torch.from_numpy(alpha)).numpy(),
        want)
    # and the reference's host numpy colour
    r, g, b = _yuv_to_rgb_libwebp(Y, U, V, h, w)
    np.testing.assert_array_equal(want[..., :3], np.dstack([r, g, b]))


@pytest.mark.parametrize("name", sorted(testing.vp8_cases()["color"]))
def test_yuv_to_rgba_cases_match_jax(name):
    Y, U, V, h, w, alpha = testing.vp8_cases()["color"][name]
    want = np.array(jax_vk.vp8_yuv_to_rgba(Y, U, V, h, w))
    if alpha is not None:
        want[..., 3] = alpha
    got = vk.vp8_yuv_to_rgba(
        *[torch.from_numpy(p) for p in (Y, U, V)], h, w,
        None if alpha is None else torch.from_numpy(alpha))
    np.testing.assert_array_equal(got.numpy(), want)


def test_yuv_to_rgba_never_reads_the_padding():
    """Chroma is cropped before its edges are replicated: the MB padding
    of U and V (and of Y) can hold anything."""
    Y, U, V, h, w, _ = testing.vp8_cases()["color"]["17x33_alpha"]
    ch, cw = (h + 1) // 2, (w + 1) // 2
    base = vk.vp8_yuv_to_rgba_plain(
        *[torch.from_numpy(p) for p in (Y, U, V)], h, w)
    Y2, U2, V2 = Y.copy(), U.copy(), V.copy()
    Y2[h:], Y2[:, w:] = 0, 255
    U2[ch:], U2[:, cw:] = 255, 0
    V2[ch:], V2[:, cw:] = 0, 255
    assert torch.equal(base, vk.vp8_yuv_to_rgba_plain(
        *[torch.from_numpy(p) for p in (Y2, U2, V2)], h, w))


@pytest.mark.parametrize("call", [
    lambda t: cuda_vp8.vp8_residuals(
        torch.zeros((1, 1, 25, 16), dtype=torch.int32),
        torch.zeros((1, 1, 6), dtype=torch.int32),
        torch.zeros((1, 1), dtype=torch.bool)),
    lambda t: cuda_vp8.vp8_yuv_to_rgba(t, t[:8, :8], t[:8, :8], 16, 16),
])
def test_cuda_vp8_wrappers_refuse_cpu_tensors(call):
    t = torch.zeros((16, 16), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        call(t)


# --- K13 over a list of frames ----------------------------------------------

def _frame(rng, h: int, w: int, with_alpha: bool) -> tuple:
    """MB-padded numpy planes of random bytes, alpha or None."""
    ph, pw = -(-h // 16) * 16, -(-w // 16) * 16
    Y = rng.integers(0, 256, (ph, pw), dtype=np.uint8)
    U = rng.integers(0, 256, (ph // 2, pw // 2), dtype=np.uint8)
    V = rng.integers(0, 256, (ph // 2, pw // 2), dtype=np.uint8)
    a = rng.integers(0, 256, (h, w), dtype=np.uint8) if with_alpha else None
    return Y, U, V, h, w, a


def _jax_rgba(Y, U, V, h, w, a) -> np.ndarray:
    """The JAX package's K13: its colour, then webp.py's alpha write."""
    want = np.array(jax_vk.vp8_yuv_to_rgba(Y, U, V, h, w))
    if a is not None:
        want[..., 3] = a
    return want


def _t(frame) -> tuple:
    Y, U, V, h, w, a = frame
    return (*[torch.from_numpy(p) for p in (Y, U, V)], h, w,
            None if a is None else torch.from_numpy(a))


# (h, w, alpha): 1x1, 1x2, 2x1, 17x33, and 81x119, which ends inside
# its tiles as 1081x1919 does (1081 % 16 == 81 % 16, 1919 % 32 ==
# 119 % 32), small enough for the CPU
BATCH_LISTS = {
    "tiny_mixed": [(1, 1, False), (1, 2, True), (2, 1, False),
                   (17, 33, True)],
    "odd_alpha": [(81, 119, True), (17, 33, False), (1, 2, False),
                  (81, 119, False), (2, 1, True)],
    "one_size": [(17, 33, True), (17, 33, False), (17, 33, True)],
}


@pytest.mark.parametrize("name", sorted(BATCH_LISTS))
def test_yuv_to_rgba_batch_plain_matches_jax(name):
    rng = np.random.default_rng(len(name))
    frames = [_frame(rng, *s) for s in BATCH_LISTS[name]]
    got = vk.vp8_yuv_to_rgba_batch_plain([_t(f) for f in frames])
    one_size = len({(f[3], f[4]) for f in frames}) == 1
    assert isinstance(got, torch.Tensor) == one_size
    for g, f in zip(got, frames):
        assert g.dtype == torch.uint8 and tuple(g.shape) == (f[3], f[4], 4)
        np.testing.assert_array_equal(g.numpy(), _jax_rgba(*f))
    # the entry takes the plain version for CPU tensors, into a given out
    out = [torch.zeros((f[3], f[4], 4), dtype=torch.uint8) for f in frames]
    assert vk.vp8_yuv_to_rgba_batch([_t(f) for f in frames], out) is out
    for o, f in zip(out, frames):
        np.testing.assert_array_equal(o.numpy(), _jax_rgba(*f))


def test_batch_outputs_shapes_and_refusals():
    rng = np.random.default_rng(3)
    same = [_t(_frame(rng, 5, 7, False)) for _ in range(3)]
    out, views = vk.batch_outputs(same)
    assert tuple(out.shape) == (3, 5, 7, 4) and len(views) == 3
    mixed = same[:1] + [_t(_frame(rng, 7, 5, True))]
    out, views = vk.batch_outputs(mixed)
    assert [tuple(v.shape) for v in out] == [(5, 7, 4), (7, 5, 4)]
    for bad in (torch.zeros((3, 5, 7, 3), dtype=torch.uint8),
                torch.zeros((2, 5, 7, 4), dtype=torch.uint8),
                torch.zeros((3, 5, 7, 4), dtype=torch.int32),
                torch.zeros((3, 5, 8, 4), dtype=torch.uint8)[:, :, :7]):
        with pytest.raises(ValueError, match="out"):
            vk.batch_outputs(same, bad)
    with pytest.raises(ValueError, match="no frames"):
        vk.vp8_yuv_to_rgba_batch([])


def test_stage_frames_aligns_every_plane_and_skips_the_padding():
    """Each staged plane starts at a multiple of 16 bytes of one buffer,
    its rows at a pitch of a multiple of 16; only the cropped planes are
    copied, so poisoned MB padding changes nothing."""
    rng = np.random.default_rng(4)
    frames = [_frame(rng, h, w, al) for h, w, al in
              ((1, 1, True), (17, 33, False), (81, 119, True), (2, 1, False),
               (16, 32, True))]
    poisoned = []
    for Y, U, V, h, w, a in frames:
        ch, cw = (h + 1) // 2, (w + 1) // 2
        Y2, U2, V2 = Y.copy(), U.copy(), V.copy()
        for p, r, c in ((Y2, h, w), (U2, ch, cw), (V2, ch, cw)):
            p[r:], p[:, c:] = 0, 255
        poisoned.append((Y2, U2, V2, h, w, a))
    staged = vk.stage_frames(poisoned, torch.device("cpu"))
    base = staged[0][0].untyped_storage().data_ptr()
    for (Y, U, V, h, w, a), s in zip(frames, staged):
        ch, cw = (h + 1) // 2, (w + 1) // 2
        assert s[3:5] == (h, w) and (s[5] is None) == (a is None)
        for p, want in zip((s[0], s[1], s[2], s[5]),
                           (Y[:h, :w], U[:ch, :cw], V[:ch, :cw], a)):
            if want is None:
                continue
            assert p.untyped_storage().data_ptr() == base
            assert (p.data_ptr() - base) % vk.ALIGN == 0
            assert p.stride(0) % vk.ALIGN == 0 and p.stride(1) == 1
            np.testing.assert_array_equal(p.numpy(), want)
        np.testing.assert_array_equal(
            vk.vp8_yuv_to_rgba_batch([s])[0].numpy(),
            _jax_rgba(Y, U, V, h, w, a))
    with pytest.raises(ValueError, match="needs"):
        vk.stage_frames([(frames[1][0][:8], *frames[1][1:])],
                        torch.device("cpu"))


# A numpy model of csrc/vp8_decode.cu's K13 at the level of its CTAs and
# threads: the launcher's prefix of tiles, each CTA's binary search for
# its frame, the chroma tile staged with its clamped halo (16-byte chunks
# where the plane's rows allow, bytes otherwise) into a poisoned shared
# array, and each thread's runs of kRun pixels through the separable mix,
# whole (one 8-byte load, two 16-byte stores) or pixel by pixel.  Every
# read of a plane is checked to stay inside the cropped planes, every
# write inside the frame.

def _cu_src() -> str:
    from pathlib import Path
    return (Path(vk.__file__).parent.parent / "csrc" / "vp8_decode.cu") \
        .read_text()


def _cu_int(name: str) -> int:
    import re
    return int(re.search(rf"(?:constexpr int {name} =|#define {name}) (\d+)",
                         _cu_src()).group(1))


class _Plane:
    """A plane as the kernel sees it: bytes at an address and pitch, of
    which only ``rows`` x ``cols`` may be read."""

    def __init__(self, arr, rows, cols, addr, pitch):
        self.arr, self.rows, self.cols = arr, rows, cols
        self.addr, self.pitch = addr, pitch

    def read(self, r, c, n=1):
        assert 0 <= r < self.rows and 0 <= c and c + n <= self.cols, \
            (r, c, n, self.rows, self.cols)
        return self.arr[r, c:c + n].astype(np.int64)


def _k13_model(frames, rows: int, cols: int, run: int) -> list:
    """``frames``: (Y, U, V, alpha or None, h, w, out address), the
    planes as ``_Plane``s -> each frame's RGBA as the kernel writes it
    (unwritten pixels 7)."""
    kcr, kcc = rows // 2 + 2, cols // 2
    tiles_x = [-(-f[5] // cols) for f in frames]
    counts = [tx * -(-f[4] // rows) for tx, f in zip(tiles_x, frames)]
    tile0 = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(int)
    outs = [np.full((f[4], f[5], 4), 7, np.int64) for f in frames]
    for b in range(int(sum(counts))):
        lo, hi = 0, len(frames) - 1
        while lo < hi:
            mid = (lo + hi + 1) >> 1
            lo, hi = (mid, hi) if tile0[mid] <= b else (lo, mid - 1)
        Y, U, V, A, h, w, out_addr = frames[lo]
        ch, cw = (h + 1) // 2, (w + 1) // 2
        t = b - tile0[lo]
        ty, tx = divmod(t, tiles_x[lo])
        y0, x0 = ty * rows, tx * cols
        cy0, cx0 = y0 // 2, x0 // 2
        sc = np.full((2, kcr, kcc + 32), -10 ** 6, np.int64)   # poison
        wide = (U.addr | V.addr | U.pitch | V.pitch) % 16 == 0
        for p, pl in enumerate((U, V)):
            for r in range(kcr):
                row = min(max(cy0 - 1 + r, 0), ch - 1)
                for c in range(kcc // 16):
                    cc = cx0 + 16 * c
                    at = 16 + 16 * c
                    if wide and cc + 16 <= cw:
                        sc[p, r, at:at + 16] = pl.read(row, cc, 16)
                    else:
                        sc[p, r, at:at + 16] = [
                            pl.read(row, min(cc + k, cw - 1))[0]
                            for k in range(16)]
                sc[p, r, 15] = pl.read(row, max(cx0 - 1, 0))[0]
                sc[p, r, 16 + kcc] = pl.read(row, min(cx0 + kcc, cw - 1))[0]
        y8 = (Y.addr | Y.pitch) % 8 == 0
        a8 = A is None or (A.addr | A.pitch) % 8 == 0
        o16 = out_addr % 16 == 0 and w % 4 == 0
        for r in range(rows):
            for c in range(cols // run):
                y, x = y0 + r, x0 + run * c
                if y >= h or x >= w:
                    continue
                ra = (r >> 1) + 1
                rb = ra + 1 if r & 1 else ra - 1
                k0 = run // 2 * c
                m = []
                for p in range(2):
                    s = 3 * sc[p, ra, 15 + k0:21 + k0] + sc[p, rb, 15 + k0:
                                                             21 + k0]
                    assert s.min() >= 0, "a read of unstaged shared memory"
                    t3 = 3 * s[1:5] + 8
                    m.append(np.stack([(t3 + s[:4]) >> 4,
                                       (t3 + s[2:]) >> 4], 1).reshape(-1))
                n = min(run, w - x)
                yv = Y.read(y, x, run) if n == run and y8 else np.concatenate(
                    [Y.read(y, x + k) for k in range(n)])
                av = (np.full(n, 255) if A is None else
                      A.read(y, x, run) if n == run and a8 else
                      np.concatenate([A.read(y, x + k) for k in range(n)]))
                u, v = m[0][:n], m[1][:n]
                yy = (yv[:n] * 19077) >> 8
                px = np.stack([
                    yy + ((v * 26149) >> 8) - 14234,
                    yy - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708,
                    yy + ((u * 33050) >> 8) - 17685], 1)
                px = np.clip(px >> 6, 0, 255)
                # whole runs go out as two 16-byte stores where o16, else
                # (and at a row's end) a 4-byte store a pixel: the same
                # pixels, none past the frame
                outs[lo][y, x:x + n, :3] = px
                outs[lo][y, x:x + n, 3] = av[:n]
    return outs


def _model_frames(frames, offsets, out_addrs):
    """The model's frames: each plane a view ``off`` bytes into a row of
    its own (pitch = its width + off + 5, so most pitches are not
    aligned), or at the staged layout's 16-byte pitch when off is 0."""
    out = []
    for (Y, U, V, h, w, a), off, oa in zip(frames, offsets, out_addrs):
        ch, cw = (h + 1) // 2, (w + 1) // 2
        planes = []
        for k, (p, r, c) in enumerate(((Y, h, w), (U, ch, cw), (V, ch, cw),
                                       (a, h, w))):
            if p is None:
                planes.append(None)
                continue
            pitch = -(-c // 16) * 16 if off == 0 else c + off + 5
            planes.append(_Plane(p, r, c, 4096 * (k + 1) + off, pitch))
        out.append((*planes, h, w, oa))
    return out


@pytest.mark.parametrize("tile", [None, (16, 64), (2, 32), (64, 256)])
@pytest.mark.parametrize("aligned", [True, False])
def test_yuv_to_rgba_kernel_model_matches_jax(tile, aligned):
    """The kernel's tiling over one list of frames of mixed sizes and
    alpha equals JAX's K13 a frame: tiles with clamped halos, frames
    that end inside a tile (odd widths and heights, w % 8 != 0), 1x1,
    1x2 and 2x1 frames, in the CTA order of one launch; with the planes
    and outputs 16-byte aligned (the staged layout) or off every
    boundary (the narrow path)."""
    rows, cols = tile or (_cu_int("kTileRows"), _cu_int("kTileCols"))
    run = _cu_int("kRun")
    rng = np.random.default_rng(rows * 1000 + cols)
    sizes = ((1, 1, False), (1, 2, True), (2, 1, True), (17, 33, True),
             (35, 70, False), (40, 136, True), (81, 119, False))
    frames = [_frame(rng, *s) for s in sizes]
    offsets = [0 if aligned else 1 + k % 7 for k in range(len(frames))]
    out_addrs = [0 if aligned else 4 + 8 * k for k in range(len(frames))]
    got = _k13_model(_model_frames(frames, offsets, out_addrs), rows, cols,
                     run)
    for g, f in zip(got, frames):
        np.testing.assert_array_equal(g, _jax_rgba(*f))


def test_k13_layout_matches_the_kernel():
    """``cuda_vp8``'s descriptor words and frame limit are
    ``vp8_decode.cu``'s: eleven 64-bit words (88 bytes) a ColorFrame,
    ``kMaxFrames`` a launch; the words land where the struct has them."""
    import re
    src = _cu_src()
    assert f"sizeof(ColorFrame) == {8 * cuda_vp8.FRAME_WORDS}" in src
    assert _cu_int("kMaxFrames") == cuda_vp8.MAX_FRAMES
    body = re.search(r"struct ColorFrame \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"(\w+)[,;]", body)
    assert fields == ["y", "u", "v", "a", "out", "ys", "us", "vs", "as", "h",
                      "w", "tile0", "tiles_x"]
    rng = np.random.default_rng(5)
    frames = [_t(_frame(rng, 17, 33, True)), _t(_frame(rng, 3, 5, False))]
    outs = [torch.empty((f[3], f[4], 4), dtype=torch.uint8) for f in frames]
    words = cuda_vp8.frame_words(frames, outs)
    assert words.shape == (2, cuda_vp8.FRAME_WORDS)
    (Y, U, V, h, w, a), o = frames[0], outs[0]
    assert list(words[0]) == [Y.data_ptr(), U.data_ptr(), V.data_ptr(),
                              a.data_ptr(), o.data_ptr(), Y.stride(0),
                              U.stride(0), V.stride(0), a.stride(0),
                              h | w << 32, 0]
    assert words[1][3] == 0 and words[1][8] == 0


@pytest.mark.parametrize("call", [
    lambda t: cuda_vp8.vp8_yuv_to_rgba_batch(
        [(t, t[:8, :8], t[:8, :8], 16, 16, None)]),
    lambda t: cuda_vp8.vp8_yuv_to_rgba_batch(
        [(t, t[:8, :8], t[:8, :8], 16, 16, t)], [t.new_zeros(16, 16, 4)]),
])
def test_k13_batch_wrapper_refuses_cpu_tensors(call):
    t = torch.zeros((16, 16), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        call(t)
