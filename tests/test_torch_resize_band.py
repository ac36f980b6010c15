"""K16's band kernel for cubic and Lanczos (``resize_band`` in
``csrc/resize.cu``), as a numpy model of its plan and arithmetic on the
CPU, held against ``resize_rgba_plain`` bit for bit.

The model follows the kernel CTA by CTA: the band of input rows that the
runs of its output rows span, in steps of ``kStep`` rows (the k of an
mma.m16n8k16 product), their weights staged in the kernel's order (0
outside each row's run, scaled by 2^946), each byte widened once to the
subnormal v x 2^-1074 and each output's sum a chain of FMAs over the
band's rows in ascending order (what the product does on Hopper:
``compare_kernels``' fp64 probe), scaled back by 2^128 and rounded to
f32 once; then pass 2 over each group of K output columns
(``cuda_resize.group_taps``, ``kGroup`` columns a group), each line
value converted once and summed into the group's columns in window
order.  The launch's rule (the rows a CTA,
or ``resize<0,1>`` where two rows' lines do not fit) and the
shared-memory layout are modelled from the constants of ``resize.cu``.
The tiles of the card's check of the mma's rounding are shown to tell
the forward chain of FMAs from other orders and roundings.
No tolerance: every comparison is exact.
"""

import os
import re

import numpy as np
import pytest
import torch

from ffpic_tpu_torch import testing
from ffpic_tpu_torch.ops import cuda_resize
from ffpic_tpu_torch.ops import resize as rs
import reference_native  # noqa: F401  (readies ffpic_tpu first)

CPU = torch.device("cpu")
WIDE = ("bicubic", "lanczos3", "lanczos5")
SMS = 132                                   # an H100 SXM's SMs


def _cu() -> str:
    with open(os.path.join(os.path.dirname(cuda_resize.__file__), "..",
                           "csrc", "resize.cu")) as f:
        return f.read()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr \w+ {name} = (\d+)", _cu()).group(1))


def band_pitch(line_w: int, ch: int) -> int:
    """A line's floats in shared memory (``launch_band``)."""
    return -(-line_w * ch // 4) * 4 + 4 if line_w else 0


def band_smem(rows: int, vk: int, pitch: int) -> int:
    """``band_smem``: the rows' weights, then their lines."""
    return rows * vk * 8 + rows * pitch * 4


def band_launch(line_w: int, ch: int, spans, h: int, n: int,
                sms: int = SMS) -> tuple:
    """``launch_band``'s choice: (rows a CTA of ``resize_band``, 0 where
    the launch takes ``resize<0,1>``; its dynamic shared memory)."""
    chunk, most = _const("kStep"), _const("kBandRows")
    max_smem, batch = _const("kMaxSmem"), _const("kBatch")
    pitch = band_pitch(line_w, ch)

    def vk(r):
        return -(-int(spans[r - 1]) // chunk) * chunk
    fit = 0
    while fit < most and band_smem(fit + 1, vk(fit + 1), pitch) + 1024 \
            <= max_smem:
        fit += 1
    if fit < 2:
        vk1 = -(-int(spans[0]) // batch) * batch
        return 0, vk1 * 8 + line_w * ch * 4
    spread = -(-h * n // sms)
    rows = fit if spread >= fit else max(2, spread)
    return rows, band_smem(rows, vk(rows), pitch)


def window_weights(table: torch.Tensor) -> np.ndarray:
    """``group_taps``' weights (G, steps, 32, 4) back in window order: (G,
    16 steps, GROUP), [g, t, n] the weight of index g * GROUP + n for
    the window's input t."""
    table = table.numpy()
    groups, steps = table.shape[:2]
    out = np.zeros((groups, steps, 16, cuda_resize.GROUP), table.dtype)
    lane, v = np.arange(32)[:, None], np.arange(4)[None, :]
    out[:, :, lane % 4 + 4 * v, lane // 4] = table
    return out.reshape(groups, 16 * steps, cuda_resize.GROUP)


def _pass1_plan(start, count, y0: int, rows: int) -> tuple:
    """A CTA's band: (lo, span), span a whole number of steps."""
    step = _const("kStep")
    st, ct = start[y0:y0 + rows], count[y0:y0 + rows]
    live = ct > 0
    lo = int(st[live].min()) if live.any() else 0
    hi = int((st + ct)[live].max()) if live.any() else 0
    lo = min(lo, hi)
    return lo, -(-(hi - lo) // step) * step


def _staged(wt, start, count, y0: int, rows: int, lo: int,
            span: int) -> np.ndarray:
    """The CTA's staged weights (rows, span) as the kernel lays them out:
    place j of a row holds its weight for input row lo + 16 (j // 16) +
    4 (j % 4) + (j // 4) % 4, 0 outside its run."""
    j = np.arange(span)
    row_of = lo + (j // 16) * 16 + (j % 4) * 4 + (j // 4) % 4
    staged = np.zeros((rows, span))
    for r in range(rows):
        i = row_of - start[y0 + r]
        ok = (i >= 0) & (i < count[y0 + r])
        staged[r, ok] = wt[y0 + r, i[ok]]
    return staged


def _lane_order(span: int) -> np.ndarray:
    """The places band_pass1 reads the staged weights from, in the order
    of the band's input rows: step s, input row k of the step is lane q =
    k % 4's weight i = k // 4, at 16 s + 4 q + i."""
    k = np.arange(span)
    return (k // 16) * 16 + (k % 16 % 4) * 4 + (k % 16) // 4


def band_model(img: np.ndarray, size, method: str, rows_cta: int):
    """``resize_band``'s arithmetic on one (H, W, C) uint8 image, CTA by
    CTA, and the order of each output's taps: (uint8 (h, w, C), {("v",
    y): [input rows summed with nonzero weight, in order], ("h", x):
    [...]})."""
    k = cuda_resize.GROUP
    h, w = size
    height, width, ch = img.shape
    out = np.zeros((h, w, ch), np.uint8)
    order = {}
    if height != h:
        st, ct, wt = (t.numpy() for t in rs.taps(height, h, CPU, method))
    if width != w:
        first, table = cuda_resize.group_taps(width, w, CPU, method)
        first = first.numpy()
        gw = window_weights(table)
    for y0 in range(0, h, rows_cta):
        rows = min(rows_cta, h - y0)
        if height != h:
            lo, span = _pass1_plan(st, ct, y0, rows)
            weights = _staged(wt, st, ct, y0, rows, lo, span)[
                :, _lane_order(span)]
            acc = np.zeros((rows, width, ch))
            for i in range(span):          # steps of kStep, in order
                # the byte as the subnormal v x 2^-1074, the weight times
                # 2^946: each product and sum the plain one's times 2^-128
                x = img[min(lo + i, height - 1)].astype(np.float64) * \
                    2.0 ** -1074
                for r in range(rows):
                    acc[r] += weights[r, i] * 2.0 ** 946 * x
                    if weights[r, i]:
                        order.setdefault(("v", y0 + r), []).append(lo + i)
            f = (acc * 2.0 ** 128).astype(np.float32)
        else:
            f = img[y0:y0 + rows].astype(np.float32)
        if width != w:
            groups, u = gw.shape[:2]
            acc2 = np.zeros((rows, groups, k, ch))
            for t in range(u):            # the window, reads clamped
                x = f[:, np.minimum(first + t, width - 1), :].astype(
                    np.float64)
                acc2 += gw[None, :, t, :, None] * x[:, :, None, :]
            f = acc2.reshape(rows, groups * k, ch)[:, :w].astype(np.float32)
        out[y0:y0 + rows] = np.clip(np.rint(f), 0, 255).astype(np.uint8)
    if width != w:
        for j in range(w):
            g, col = divmod(j, k)
            order[("h", j)] = [int(first[g]) + t for t in range(gw.shape[1])
                               if gw[g, t, col]]
    return out, order


@pytest.mark.parametrize("method", WIDE)
@pytest.mark.parametrize("n_in,n_out", [(1920, 224), (1080, 224), (33, 97),
                                        (7, 11), (37, 1), (1, 5), (97, 61),
                                        (61, 97), (5000, 2), (300, 40)])
def test_group_taps_hold_each_tap_once_in_order(method, n_in, n_out):
    """Pass 2's table: every output's taps in its group's window, each
    once, at its input's place and with its weight (f32, as exact as the
    taps), 0 elsewhere; the window inside the input unless the input is
    narrower, then from its first column; groups of ``GROUP`` with the
    last padded by outputs of no taps; and the table in a product's B
    order is the window order read through the lanes: [g, s, l, v] is
    output g * GROUP + l // 4 at input 16 s + l % 4 + 4 v."""
    k = cuda_resize.GROUP
    first, table = cuda_resize.group_taps(n_in, n_out, CPU, method)
    first, gw = first.numpy(), window_weights(table)
    start, count, wts = (t.numpy() for t in rs.taps(n_in, n_out, CPU,
                                                     method))
    groups, u, kk = gw.shape
    assert table.dtype == torch.float32 and table.shape == (groups,
                                                            u // 16, 32, 4)
    assert kk == k and groups == -(-n_out // k) and first.shape == (groups,)
    assert u % 16 == 0 and (first >= 0).all()
    assert (first + u <= n_in).all() or (n_in < u and not first.any())
    for j in range(groups * k):
        g, col = divmod(j, k)
        want = np.zeros(u, np.float32)
        if j < n_out and count[j]:
            at = start[j] - first[g]
            assert 0 <= at and at + count[j] <= min(u, n_in - first[g])
            want[at:at + count[j]] = wts[j, :count[j]]
        assert np.array_equal(gw[g, :, col], want), (j, g, col)
    t = table.numpy()
    for lane in range(32):
        for v in range(4):
            assert np.array_equal(t[:, :, lane, v], gw.reshape(
                groups, u // 16, 16, k)[:, :, lane % 4 + 4 * v, lane // 4])


@pytest.mark.parametrize("method", WIDE)
@pytest.mark.parametrize("n_in,n_out", [(1080, 224), (199, 97), (160, 224),
                                        (37, 1), (1, 5), (5000, 2)])
def test_band_rows_sum_each_tap_once_in_order(method, n_in, n_out):
    """Pass 1's plan at every rows a CTA up to ``kBandRows``: each CTA's
    band lies inside the image and inside ``band_spans``' entry, a whole
    number of steps; the staged weights, read in the lanes' order, give
    each output row its run's weights at its input rows, each once, and
    0 elsewhere, so a row sums its taps in ascending input order."""
    step, most = _const("kStep"), _const("kBandRows")
    start, count, wts = (t.numpy() for t in rs.taps(n_in, n_out, CPU,
                                                     method))
    img = [torch.zeros((n_in, 3, 1), dtype=torch.uint8)]
    spans = cuda_resize.band_spans(img, n_out, method)
    for rows_cta in range(1, most + 1):
        for y0 in range(0, n_out, rows_cta):
            rows = min(rows_cta, n_out - y0)
            lo, span = _pass1_plan(start, count, y0, rows)
            assert span % step == 0
            assert span <= -(-spans[rows_cta - 1] // step) * step
            assert 0 <= lo and (span == 0 or lo < n_in)
            order = _lane_order(span)
            assert sorted(order) == list(range(span))
            weights = _staged(wts, start, count, y0, rows, lo, span)[
                :, order]
            for r in range(rows):
                y = y0 + r
                s, c = start[y] - lo, count[y]
                assert 0 <= s and s + c <= span
                assert np.array_equal(weights[r, s:s + c], wts[y, :c])
                assert not weights[r, :s].any()
                assert not weights[r, s + c:].any()


@pytest.mark.parametrize("method", WIDE)
@pytest.mark.parametrize("name", list(testing.resize_cases()))
def test_band_model_is_the_plain_version(method, name):
    """The model of ``resize_band``'s arithmetic equals
    ``resize_rgba_plain`` bit for bit on every ``resize_cases`` entry (3
    and 4 channels, kept axes, growing, one pixel), at the rows a CTA of
    the launch rule on config 5's batch and at 2 rows; every output sums
    its taps' inputs once each in ascending order."""
    img, size = testing.resize_cases()[name]
    for im in img.reshape(-1, *img.shape[-3:])[:1]:
        want = rs.resize_rgba_plain(torch.from_numpy(im), size,
                                    method).numpy()
        for rows in (2, _const("kBandRows")):
            got, order = band_model(im, size, method, rows)
            assert np.array_equal(got, want), rows
        for axis, n_in, n_out in (("v", im.shape[0], size[0]),
                                  ("h", im.shape[1], size[1])):
            if n_in == n_out:
                continue
            start, count, wts = rs.taps(n_in, n_out, CPU, method)
            for j in range(n_out):
                s, c = int(start[j]), int(count[j])
                nz = [s + i for i in range(c) if wts[j, i]]
                assert order.get((axis, j), []) == nz, (axis, j)


def test_band_model_one_channel_and_a_tall_band():
    """One channel, a 700-row band to 2 rows (one CTA whose band is the
    whole image) and a width kept: the model equals the plain version."""
    rng = np.random.default_rng(25)
    for img, size in (((rng.integers(0, 256, (91, 130, 1))), (40, 33)),
                      (rng.integers(0, 256, (700, 30, 3)), (2, 7)),
                      (rng.integers(0, 256, (90, 64, 4)), (31, 64))):
        img = img.astype(np.uint8)
        for method in WIDE:
            want = rs.resize_rgba_plain(torch.from_numpy(img), size,
                                        method).numpy()
            assert np.array_equal(band_model(img, size, method, 7)[0], want)
            assert np.array_equal(band_model(img, size, method, 2)[0], want)


def test_host_constants_are_the_kernels():
    """``cuda_resize``'s copies of ``resize.cu``'s constants agree."""
    assert cuda_resize.GROUP == _const("kGroup")
    assert cuda_resize.BAND_SPANS == _const("kBandSpans")
    assert _const("kBandRows") <= cuda_resize.BAND_SPANS


@pytest.mark.parametrize("ch", [1, 3, 4])
def test_band_shared_memory_layout(ch):
    """Shared memory of a band CTA at 1, 3 and 4 channels: the staged
    weights of its rows first (a lane's four of a step 32-byte aligned,
    as the kernel reads them in pairs), then the lines, each starting on
    16 bytes and 16 bytes further round the banks than the one before;
    config 5's widest slot takes ``kBandRows`` rows at every method, its
    lanczos5 band in the kernel's most shared memory."""
    step, most = _const("kStep"), _const("kBandRows")
    max_smem = _const("kMaxSmem")
    for width in (1920, 1919, 333, 1):
        pitch = band_pitch(width, ch)
        assert pitch >= width * ch and pitch % 4 == 0
        for rows in range(1, most + 1):
            for vk in (4, 20, 80, 5000):
                vk = -(-vk // step) * step
                line_at = rows * vk * 8
                assert (vk * 8) % 32 == 0          # a lane's four weights
                assert line_at % 16 == 0 and (line_at + pitch * 4) % 16 == 0
                assert band_smem(rows, vk, pitch) == line_at + \
                    rows * pitch * 4
    # at config 5's width the 7 rows start in 7 of the 8 16-byte groups
    # of banks, so pass 2's lanes of one group, a row each, do not collide
    assert {band_pitch(1920, ch) * 4 * r % 128 for r in range(most)} == \
        {16 * r for r in range(most)} or ch != 4
    img = [torch.zeros((1080, 3, ch), dtype=torch.uint8)]
    for method in WIDE:
        spans = cuda_resize.band_spans(img, 224, method)
        rows, smem = band_launch(1920, ch, spans, 224, 8)
        assert rows == most and smem + 1024 <= max_smem
    spans = cuda_resize.band_spans(img, 224, "lanczos5")
    assert band_launch(1920, 4, spans, 224, 8)[1] == 219632


def test_band_launch_rule():
    """The rows a CTA: the most that fit, cut to spread a small launch
    over the SMs, never under 2; ``resize<0,1>`` where two rows' lines
    do not fit (8064 and 12000 RGBA pixels wide), whose one row fits."""
    max_smem = _const("kMaxSmem")
    img = [torch.zeros((1080, 3, 4), dtype=torch.uint8)]
    spans = cuda_resize.band_spans(img, 224, "lanczos5")
    assert band_launch(1920, 4, spans, 224, 8)[0] == 7
    assert band_launch(1920, 4, spans, 224, 1)[0] == 2
    assert band_launch(1920, 4, spans, 224, 2)[0] == 4
    assert band_launch(0, 4, spans, 224, 1)[0] == 2
    assert band_launch(3600, 4, spans, 224, 8)[0] == 3
    for width in (8064, 12000):
        rows, smem = band_launch(width, 4, spans, 224, 2)
        assert rows == 0 and smem + 1024 <= max_smem
    tall = [torch.zeros((5000, 3, 1), dtype=torch.uint8)]
    spans = cuda_resize.band_spans(tall, 2, "lanczos5")
    assert band_launch(300, 1, spans, 2, 1)[0] == 2


def _fma_chain(a, b, c, order) -> float:
    """``c`` then ``__fma_rn(a[k], b[k], .)`` for k in ``order``, each
    step rounded once (a float of the exact fraction)."""
    from fractions import Fraction
    acc = float(c)
    for k in order:
        acc = float(Fraction(float(a[k])) * Fraction(float(b[k]))
                    + Fraction(acc))
    return acc


@pytest.mark.parametrize("kind", ["ints", "random", "ties", "subnormal"])
def test_mma_check_tiles_tell_the_orders_apart(kind):
    """The tiles on which ``chip_smoke.py`` holds mma.m16n8k16 .f64 to the
    forward chain of FMAs (``compare_kernels.mma16_forward_shares``) tell
    that chain from what another mma could do: all agree on integer
    tiles (a check of the fragment layout); random tiles part it from
    the reverse chain and from one rounding of the exact sum, tie tiles
    from one rounding, subnormal tiles from an mma that flushes
    subnormal operands to zero."""
    from fractions import Fraction
    from ffpic_tpu_torch import compare_kernels as ck
    tiles = 4
    a, b, c = ck._mma16_tiles(np.random.default_rng(25), tiles, kind)
    a, b = a.reshape(tiles, 16, 16), b.reshape(tiles, 8, 16)
    c = c.reshape(tiles, 16, 8)
    apart = {"rev": 0, "one": 0, "ftz": 0}
    for t in range(tiles):
        for r in range(16):
            for j in range(8):
                ar, bj, cc = a[t, r], b[t, j], c[t, r, j]
                fwd = _fma_chain(ar, bj, cc, range(16))
                apart["rev"] += fwd != _fma_chain(ar, bj, cc,
                                                  range(15, -1, -1))
                apart["one"] += fwd != float(Fraction(float(cc)) + sum(
                    Fraction(float(ar[k])) * Fraction(float(bj[k]))
                    for k in range(16)))
                flushed = np.where(np.abs(ar) < 2.0 ** -1022, 0.0, ar)
                apart["ftz"] += fwd != _fma_chain(flushed, bj, cc,
                                                  range(16))
    want = {"ints": set(), "random": {"rev", "one"}, "ties": {"one"},
            "subnormal": {"ftz"}}[kind]
    assert {k for k, v in apart.items() if v} >= want
    if kind == "ints":
        assert not any(apart.values())
