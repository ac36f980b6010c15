"""B12, VP8 luma intra reconstruction: ffpic_tpu_torch.ops.vp8_wavefront
(CPU, the plain version ``vp8_wavefront_plain``, K18's function) held
against ffpic_tpu.ops.vp8_wavefront's ``make_wavefront`` and against the
port's host reconstruction ``native.vp8_recon`` on the same inputs.

Inputs: the committed WebP fixtures' VP8 frames, decoded up to their
residuals by the port's ``VP8Decoder`` (``testing.wavefront_inputs``),
and ``testing.wavefront_cases``' random grids (every ymode and B-mode,
residuals in +-300).  Everything is integer: the tolerance is zero.

JAX compiles ``make_wavefront`` for 15-20 s a geometry on the CPU, so
three geometries are compiled here, each by one test.  The CUDA kernel
K18 runs only on a GPU (``chip_smoke.py``'s ``[check K18]``); here its
wrapper is checked to refuse CPU tensors, other dtypes and shapes, and
the entry to take the plain version for CPU tensors.
"""

import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ffpic_tpu.ops.vp8_wavefront import make_wavefront as jax_make_wavefront
from ffpic_tpu_torch import native, testing
from ffpic_tpu_torch.ops import cuda_vp8
from ffpic_tpu_torch.ops import vp8_wavefront as wf
import reference_native  # noqa: F401  (readies ffpic_tpu first)

FRAMES = [(name, k) for name in testing.WAVEFRONT_FIXTURES
          for k in range(len(testing.vp8_bitstreams(
              testing.webp_fixture(name))))]


def _plain(res, ymode, bmodes) -> np.ndarray:
    return wf.vp8_wavefront_plain(torch.from_numpy(res),
                                  torch.from_numpy(ymode),
                                  torch.from_numpy(bmodes)).numpy()


def _jax(res, ymode, bmodes) -> np.ndarray:
    run = jax_make_wavefront(*ymode.shape)
    return np.asarray(run(res, ymode, bmodes))


@pytest.mark.parametrize("name", ["lossy_512.webp", "odd_333x199.webp"])
def test_plain_matches_jax_on_fixtures(name):
    inp = testing.wavefront_inputs(name)
    want = _jax(inp["residual"], inp["ymode"], inp["bmodes"])
    got = _plain(inp["residual"], inp["ymode"], inp["bmodes"])
    assert got.dtype == np.uint8 and np.array_equal(got, want)


def test_plain_matches_jax_on_a_random_grid():
    res, ymode, bmodes = testing.wavefront_cases()["mb3x4_bpred"]
    assert np.array_equal(_plain(res, ymode, bmodes),
                          _jax(res, ymode, bmodes))


@pytest.mark.parametrize("name,frame", FRAMES)
def test_plain_matches_host_recon_on_fixtures(name, frame):
    inp = testing.wavefront_inputs(name, frame)
    got = _plain(inp["residual"], inp["ymode"], inp["bmodes"])
    assert got.shape == (16 * inp["mb"][0], 16 * inp["mb"][1])
    assert np.array_equal(got, inp["Y"])


def _host_luma(res, ymode, bmodes) -> np.ndarray:
    mbh, mbw = ymode.shape
    r24 = np.zeros((mbh, mbw, 24, 4, 4), np.int16)
    r24[:, :, :16] = res
    y = np.zeros((16 * mbh, 16 * mbw), np.uint8)
    u = np.zeros((8 * mbh, 8 * mbw), np.uint8)
    v = np.zeros((8 * mbh, 8 * mbw), np.uint8)
    native.vp8_recon(y, u, v, r24, ymode, bmodes,
                     np.zeros((mbh, mbw), np.int32), mbh, mbw)
    return y


@pytest.mark.parametrize("name", list(testing.wavefront_cases()))
def test_plain_matches_host_recon_on_cases(name):
    res, ymode, bmodes = testing.wavefront_cases()[name]
    assert np.array_equal(_plain(res, ymode, bmodes),
                          _host_luma(res, ymode, bmodes))


def test_virtual_edges_and_dc_fallbacks():
    """Zero residuals: DC with neither edge is 128; V under the virtual
    row 127; H beside the virtual column 129, or beside the MB to its
    left; TM from 127 above, 129 left and the corner (127 on the top
    row, 129 below it)."""
    z = np.zeros((2, 3, 16, 4, 4), np.int32)
    ymode = np.array([[0, 1, 2], [2, 3, 0]], np.int32)
    y = _plain(z, ymode, np.zeros((2, 3, 16), np.int32))
    assert (y[:16, :16] == 128).all()
    assert (y[:16, 16:32] == 127).all()          # V: the virtual row
    assert (y[:16, 32:] == 127).all()            # H: V's right column
    assert (y[16:, :16] == 129).all()            # H: the virtual column
    # TM at (1, 1): left 129, above 128 | 127, corner 128
    left, corner = 129, int(y[15, 15])
    assert (y[16:, 16:32] == np.clip(left + y[15, 16:32].astype(int)
                                     - corner, 0, 255)).all()
    # DC at (1, 2): the 16 above and the 16 left
    s = int(y[15, 32:].sum()) + int(y[16:, 31].sum())
    assert (y[16:, 32:] == (s + 16) >> 5).all()


def test_b_modes_index_as_jax():
    m = torch.tensor([-11, -10, -1, 0, 9, 10, 12])
    assert wf.b_modes(m).tolist() == [0, 0, 9, 0, 9, 9, 9]


def test_kernel_tap_table_is_the_plain_versions():
    """K18's table of edge indices (``kB4Taps`` in ``csrc/vp8_decode.cu``)
    holds the plain version's ``B4_TAPS`` for B-modes 2..9, a byte an
    index, low byte first."""
    src = (Path(wf.__file__).parent.parent / "csrc" / "vp8_decode.cu") \
        .read_text()
    body = re.search(r"kB4Taps\[8\]\[16\] = \{(.*?)\n\};", src, re.S).group(1)
    words = [int(w, 16) for w in re.findall(r"0x([0-9a-f]{8})", body)]
    got = np.array([[(w >> (8 * k)) & 255 for k in range(4)]
                    for w in words]).reshape(8, 16, 4)
    assert np.array_equal(got, wf.B4_TAPS[2:].numpy())


def test_make_wavefront_takes_the_plain_version_on_cpu_tensors():
    res, ymode, bmodes = testing.wavefront_cases()["mb3x4_bpred"]
    run = wf.make_wavefront(3, 4)
    t = [torch.from_numpy(a).to("cpu") for a in (res, ymode, bmodes)]
    assert torch.equal(run(*t), wf.vp8_wavefront_plain(*t))
    assert cuda_vp8.launches["vp8_wavefront"] == 0
    with pytest.raises(ValueError, match="shape"):
        wf.make_wavefront(3, 5)(*t)
    with pytest.raises(ValueError):
        wf.make_wavefront(0, 4)


def test_make_wavefront_numpy_inputs_need_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    res, ymode, bmodes = testing.wavefront_cases()["mb1x7"]
    with pytest.raises(RuntimeError, match="CUDA"):
        wf.make_wavefront(1, 7)(res, ymode, bmodes)


def test_k18_wrapper_refuses_what_the_kernel_does_not_take():
    res, ymode, bmodes = (torch.from_numpy(a) for a in
                          testing.wavefront_cases()["mb1x7"])
    with pytest.raises(ValueError, match="CUDA"):
        cuda_vp8.vp8_wavefront(res, ymode, bmodes)
    with pytest.raises(ValueError, match="int32"):
        cuda_vp8.vp8_wavefront(res.to(torch.int16), ymode, bmodes)
    with pytest.raises(ValueError, match="int32"):
        cuda_vp8.vp8_wavefront(res, ymode, bmodes.to(torch.int64))
    with pytest.raises(ValueError, match="bmodes"):
        cuda_vp8.vp8_wavefront(res, ymode, bmodes[:, :, :8])
    with pytest.raises(ValueError, match="ymode"):
        cuda_vp8.vp8_wavefront(res, ymode[None], bmodes)
    assert cuda_vp8.launches["vp8_wavefront"] == 0


# --- K18's schedule, run on the CPU ------------------------------------------
#
# A model of csrc/vp8_decode.cu's K18 at the level of its lanes, numpy
# standing for the warp's registers: row groups claimed from a ticket by
# CTAs started in a random order, their warps stepped in a random order;
# each MB's record (4 words of 4 pixels beside a tag) through a CTA's
# shared ring, with the writer held back while the ring is full, or
# through device memory from a CTA's last row; lane 2 sb + h's two rows,
# the shuffles of each B_PRED step, the edge words, the prmt/dp4a
# prediction with the kernel's tap table (kB4Taps, with the 16x16 V and H
# rows the kernel builds), and the residual add in int32.  It checks the
# kernel's design (who holds which pixel, which lane a shuffle reads,
# which record an MB waits on, the ring's tags and indexing) against the
# plain version; the kernel itself runs only on the card.

_M32 = 0xFFFFFFFF
_LANES = np.arange(32)


def _byte_perm(x, y, s):
    x, y, s = (np.asarray(a, np.uint64) for a in (x, y, s))
    v = (y << np.uint64(32)) | x
    out = np.zeros(np.broadcast(x, y, s).shape, np.uint64)
    for i in range(4):
        n = (s >> np.uint64(4 * i)) & np.uint64(7)
        out |= ((v >> (np.uint64(8) * n)) & np.uint64(255)) << np.uint64(8 * i)
    return out


def _dp4a_ones(a, c):
    a = np.asarray(a, np.uint64)
    return sum((a >> np.uint64(8 * i)) & np.uint64(255) for i in range(4)) \
        + np.asarray(c, np.uint64)


def _bytes(words) -> np.ndarray:
    """The bytes of 32-bit words, low byte first."""
    w = np.asarray(words, np.uint64)
    return np.stack([(w >> np.uint64(8 * i)) & np.uint64(255)
                     for i in range(4)], -1).reshape(-1).astype(np.int64)


def _word(px) -> np.uint64:
    """Four bytes as a 32-bit word, the first lowest."""
    return np.uint64(sum(int(v) << (8 * i) for i, v in enumerate(px)))


def _add32(pred: int, res: int) -> int:
    """clip(pred + res) with the sum wrapped to int32."""
    s = (pred + res) & _M32
    return min(max(s - (1 << 32) if s >= 1 << 31 else s, 0), 255)


def _kernel_source() -> str:
    return (Path(wf.__file__).parent.parent / "csrc" / "vp8_decode.cu") \
        .read_text()


def _sel_msk(src: str):
    """The kernel's per-pixel prmt selectors and byte masks of B-modes
    2..9, from its tap table."""
    body = re.search(r"kB4Taps\[8\]\[16\] = \{(.*?)\n\};", src, re.S).group(1)
    q = np.array([int(w, 16) for w in re.findall(r"0x([0-9a-f]{8})", body)],
                 np.uint64).reshape(8, 16)
    sel, msk = np.zeros_like(q), np.zeros_like(q)
    for b in range(4):
        t = (q >> np.uint64(8 * b)) & np.uint64(255)
        sel |= (t & np.uint64(7)) << np.uint64(4 * b)
        msk |= np.where(t >= 8, np.uint64(255), np.uint64(0)) \
            << np.uint64(8 * b)
    return sel, msk


def _k18_model(res, ymode, bmodes, rows: int, ring_slots: int, seed: int):
    sel_t, msk_t = _sel_msk(_kernel_source())
    mbh, mbw = ymode.shape
    out = np.zeros((16 * mbh, 16 * mbw), np.uint8)
    rec = np.zeros((mbh, mbw, 4), np.uint64)     # device memory records
    res = res.reshape(mbh, mbw, 32, 8).astype(np.int64)
    sb, h = _LANES >> 1, _LANES & 1
    sy, sx = sb >> 2, sb & 3
    u16, u24, u32 = (np.uint64(v) for v in (16, 24, 32))

    def bpred_lane(patch, sres, own, k, lane):
        """Lane `lane`'s pixel in step k of a B_PRED MB, or None."""
        a, r, c = lane >> 4, (lane >> 2) & 3, lane & 3
        ky = max(0, (k - 2) >> 1) + a
        kx = k - 2 * ky
        mode = int(own[(8 * ky + 2 * kx) & 31])
        if ky > min(3, k >> 1) or kx < 0:
            return None
        by, bx = 1 + 4 * ky, 4 + 4 * kx
        wa = _word(patch[by - 1, bx:bx + 4])
        we = _word(patch[0 if kx == 3 else by - 1, bx + 4:bx + 8])
        x = int(patch[by - 1, bx - 1])
        wl = _word(patch[by:by + 4, bx - 1])
        v = [_byte_perm(x, wa, 0x6540), _byte_perm(wa, we, 0x6543),
             _byte_perm(we, wl, 0x6543), wl >> u24]
        dc = int(_dp4a_ones(wa, _dp4a_ones(wl, 4)) >> 3)
        lx = int((wl >> np.uint64(8 * r)) & 255) - x
        tab = max(mode - 2, 0)
        s_, m_ = sel_t[tab, 4 * r + c], msk_t[tab, 4 * r + c]
        g = (_byte_perm(v[0], v[1], s_) & ~m_ & np.uint64(_M32)) | \
            (_byte_perm(v[2], v[3], s_) & m_)
        avg = int(_dp4a_ones(g, 2) >> 2)
        tm = min(max(lx + int((wa >> np.uint64(8 * c)) & 255), 0), 255)
        pred = dc if mode == 0 else tm if mode == 1 else avg
        return by + r, bx + c, _add32(pred, int(sres[16 * (4 * ky + kx)
                                                     + 4 * r + c]))

    def row(my, warp, ring, taken):
        has_up, from_global = my > 0, warp == 0

        def await_record(m):
            if from_global:
                while not all(rec[my - 1, m] >> u32):
                    yield
                return rec[my - 1, m] & np.uint64(_M32)
            slot = ring[warp - 1][m % ring_slots]
            while not all((slot >> u32) == m + 1):
                yield
            return slot & np.uint64(_M32)

        up = (yield from await_record(0)) if has_up \
            else np.full(4, 0x7f7f7f7f, np.uint64)
        left = np.full(4, 0x81818181, np.uint64)
        corner = 129 if has_up else 127
        for mx in range(mbw):
            nxt = np.full(4, 0x7f7f7f7f, np.uint64)
            upr = np.uint64(0x7f7f7f7f)
            if has_up and mx + 1 < mbw:
                nxt = yield from await_record(mx + 1)
                taken[warp] = mx + 2
                upr = nxt[0]
            elif has_up:
                upr = (up[3] >> u24) * np.uint64(0x01010101)
            ym = int(ymode[my, mx])
            r = res[my, mx]                  # (32 lanes, 8 residuals)
            q = np.zeros((2, 32), np.uint64)
            if ym == 4:
                # the warp's patch: row 0 corner, above, above-right; rows
                # 1..16 the left pixel, then the MB's row
                patch = np.zeros((17, 24), np.int64)
                patch[0, 3] = corner
                patch[0, 4:20] = _bytes(up)
                patch[0, 20:24] = _bytes(np.array([upr]))
                patch[1:, 3] = _bytes(left)
                sres = r.reshape(256)
                bm = bmodes[my, mx, sb].astype(np.int64)
                own = np.clip(np.where(bm < 0, bm + 10, bm), 0, 9)
                for k in range(10):
                    new = [bpred_lane(patch, sres, own, k, lane)
                           for lane in range(32)]
                    for px in new:               # the step's __syncwarp
                        if px is not None:
                            patch[px[0], px[1]] = px[2]
                for rr in range(2):
                    q[rr] = [_word(patch[1 + 4 * sy[i] + 2 * h[i] + rr,
                                         4 + 4 * sx[i]:8 + 4 * sx[i]])
                             for i in range(32)]
            else:
                m = min(max(ym, 0), 3)
                su, sl = int(_dp4a_ones(up, 0).sum()), \
                    int(_dp4a_ones(left, 0).sum())
                dc = ((su + sl + 16) >> 5 if has_up and mx > 0 else
                      (su + 8) >> 4 if has_up else
                      (sl + 8) >> 4 if mx > 0 else 128)
                for i in range(32):
                    above_px = _bytes(np.array([up[sx[i]]]))
                    for rr in range(2):
                        lpx = int(_bytes(np.array([left[sy[i]]]))[
                            2 * h[i] + rr])
                        pred = [dc, above_px, lpx][m] if m < 3 else [
                            min(max(lpx + int(p_) - corner, 0), 255)
                            for p_ in above_px]
                        pred = np.broadcast_to(np.asarray(pred), 4)
                        q[rr, i] = _word([_add32(int(pred[c]),
                                                 int(r[i, 4 * rr + c]))
                                          for c in range(4)])
            for i in range(32):
                y, x0 = 16 * my + 4 * sy[i] + 2 * h[i], 16 * mx + 4 * sx[i]
                for rr in range(2):
                    out[y + rr, x0:x0 + 4] = [(int(q[rr, i]) >> (8 * c)) & 255
                                              for c in range(4)]
            bottom = q[1][2 * (12 + np.arange(4)) + 1]
            if my + 1 < mbh and warp == rows - 1:
                rec[my, mx] = np.uint64(1 << 32) | bottom
            elif my + 1 < mbh:
                while mx - taken[warp + 1] >= ring_slots:
                    yield
                ring[warp][mx % ring_slots][:] = \
                    (np.uint64(mx + 1) << u32) | bottom
            rc = _byte_perm(q[0], q[1], 0x7773) & np.uint64(0xffff)
            left = rc[8 * np.arange(4) + 6] | (rc[8 * np.arange(4) + 7] << u16)
            corner = int(up[3] >> u24) if has_up else 127
            if has_up:
                up = nxt
            yield

    rng = random.Random(seed)
    groups = (mbh + rows - 1) // rows
    ticket = [0]

    def claim():
        g = ticket[0]
        ticket[0] += 1
        if g >= groups:
            return None
        ring = [[np.zeros(4, np.uint64) for _ in range(ring_slots)]
                for _ in range(rows - 1)]
        taken = [0] * rows
        return [row(g * rows + w, w, ring, taken) for w in range(rows)
                if g * rows + w < mbh]

    unstarted, live, moves = groups, [], 0
    while unstarted or live:
        moves += 1
        assert moves < 10 ** 6, "K18's schedule made no progress"
        if unstarted and (not live or rng.random() < 0.2):
            unstarted -= 1
            warps = claim()
            if warps:
                live.append(warps)
            continue
        warps = rng.choice(live)
        w = rng.choice(warps)
        try:
            next(w)
        except StopIteration:
            warps.remove(w)
        if not warps:
            live.remove(warps)
            more = claim()
            if more:
                live.append(more)
    return out


def _kernel_constant(name: str) -> int:
    return int(re.search(rf"(?:constexpr int {name} =|#define {name}) (\d+)",
                         _kernel_source()).group(1))


def _long_runs():
    """2 x 11 MBs, B_PRED but for one 16x16 MB a row: B_PRED MBs whose
    left or top-right neighbour is a 16x16 MB, in rows long enough that a
    record ring of 2 slots holds its writer back."""
    rng = np.random.default_rng(18)
    ymode = np.full((2, 11), 4, np.int32)
    ymode[0, 6], ymode[1, 2] = 0, 3
    return (rng.integers(-300, 301, (2, 11, 16, 4, 4)).astype(np.int32),
            ymode, rng.integers(0, 10, (2, 11, 16)).astype(np.int32))


@pytest.mark.parametrize("shape", ["kernel", "rows2_ring2"])
@pytest.mark.parametrize("name", [*testing.wavefront_cases(), "long_runs"])
def test_k18_lane_model_matches_the_plain_version(name, shape):
    """K18's schedule on the CPU (``_k18_model``), with the kernel's row
    group and record ring sizes, and with 2 rows a CTA and a record ring
    of 2 slots (the writer then waits on it), in an adversarial order of
    CTAs and warps: equal to the plain version."""
    rows, ring = ((_kernel_constant("kRowWarps"),
                   _kernel_constant("kRing"))
                  if shape == "kernel" else (2, 2))
    res, ymode, bmodes = (_long_runs() if name == "long_runs"
                          else testing.wavefront_cases()[name])
    want = _plain(res, ymode, bmodes)
    for seed in range(2):
        assert np.array_equal(_k18_model(res, ymode, bmodes, rows, ring,
                                         seed), want)
