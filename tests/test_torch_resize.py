"""ffpic_tpu_torch.ops.resize against ffpic_tpu.ops.resize (JAX's
``jax.image.resize``, bilinear, antialiased when shrinking) on the same
random uint8 images: ``resize_rgba`` and ``normalize_for_model``, whose
CPU entries run the plain versions (K16's and K17's functions: banded
taps summed in float64 in ascending order).

The port mirrors what XLA's CPU backend compiles the jitted originals
to (``jax.jit(...).lower(...).compile().as_text()`` and its LLVM IR):
``/ 255.0`` is a product by ``f32(1/255)``, which without a resize fuses
with ``- mean`` into one FMA; the weight matrix is recomputed inside the
jit, its column total summed as XLA's tree of 32-row reduce-windows.

Weight matrix: equal to the jitted one (read back through the jitted
``normalize_for_model`` of one-hot rows) at config 5's sizes and when
growing.  At some other sizes LLVM makes other FMA choices (at 97 -> 61
it unrolls the fusion that divides by the total, folds the sample
positions to constants and fuses ``1 - |d| / scale`` there too), which
the port does not follow: a few weights differ, by up to 1.5e-6.

Tolerance of ``resize_rgba``: 1 LSB.  The sums run in another order and
width than XLA's f32 dot, so a value can land on the other side of .5
before rounding.  Observed on these inputs: 0 to 0.022 % of the outputs
are off by 1 (1.0e-5 for 1080x1920->224, 2.0e-4 for 512x400->512x224).

``resize_batch`` (``decode_batch``'s resize of its slots, K16 in one
launch on the card) equals each slot resized alone, and JAX's per-slot
resizes stacked to 1 LSB; K16's descriptors (``cuda_resize.slot_words``)
read as the kernel reads them give the same bytes.  The kernels take
each tap as one fused multiply-add where the plain versions round a
product and then a sum: ``test_every_product_is_exact_in_double`` shows
with Fractions that every weight times every value the sums take (a
byte, or an f32) is exact in float64, so the two round alike.

Tolerance of ``normalize_for_model``: without a resize the port equals
the test's own FMA form ``fma(x, f32(1/255), -mean) / std`` and JAX bit
for bit.  With a resize, 2**-21 on x = rgb / 255 (the error times
``std``): four ulps of 1.0 for the order of XLA's f32 dot (observed up
to 1.6e-7).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffpic_tpu.ops.resize import normalize_for_model as jax_normalize
from ffpic_tpu.ops.resize import resize_rgba as jax_resize_rgba
from ffpic_tpu_torch import testing
from ffpic_tpu_torch.ops import cuda_resize
from ffpic_tpu_torch.ops import resize as port_resize
from ffpic_tpu_torch.ops.resize import _weight_mat, resize_rgba, taps
import reference_native  # noqa: F401  (readies ffpic_tpu first)


def _jitted_weight_mat(n_in: int, n_out: int) -> np.ndarray:
    """The (n_in, n_out) weights of the jitted ``normalize_for_model``:
    row i of the input 255 in column i (255 * f32(1/255) is 1.0), mean 0
    and std 1, resized along H only, so each output is one weight."""
    b = np.zeros((1, n_in, n_in, 4), np.uint8)
    b[0, np.arange(n_in), np.arange(n_in), :3] = 255
    out = np.asarray(jax_normalize(jnp.asarray(b), (n_out, n_in),
                                   (0.0,) * 3, (1.0,) * 3))
    assert (out[..., 0] == out[..., 2]).all()
    return out[0, :, :, 0].T


@pytest.mark.parametrize("n_in,n_out", [(512, 224), (160, 224), (1080, 224),
                                        (1920, 224), (7, 5)])
def test_weight_mat_matches_jax(n_in, n_out):
    got = _weight_mat(n_in, n_out, torch.device("cpu")).numpy()
    want = _jitted_weight_mat(n_in, n_out)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("n_in,n_out", [(97, 61), (1080, 512)])
def test_weight_mat_gap_where_llvm_unrolls(n_in, n_out):
    """The step the port does not mirror: at these sizes LLVM makes
    other FMA choices in the fusion that divides by the total, and a few
    weights differ from the jitted ones."""
    got = _weight_mat(n_in, n_out, torch.device("cpu")).numpy()
    want = _jitted_weight_mat(n_in, n_out)
    diff = np.abs(got.astype(np.float64) - want)
    assert 0 < (diff > 0).sum() < 0.02 * diff.size
    assert diff.max() <= 2e-6


@pytest.mark.parametrize("n", [1, 31, 32, 33, 97, 224, 1080, 1920])
def test_column_sum_is_xla_tree(n):
    """``_xla_column_sum`` equals the jitted ``jnp.sum(axis=0)`` bit for
    bit on values whose sums round at every add."""
    rng = np.random.default_rng(n)
    w = (rng.random((n, 37)) * rng.choice([1e-3, 1.0, 1e3], (n, 37))) \
        .astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=0))(w))
    got = port_resize._xla_column_sum(torch.from_numpy(w)).numpy()
    assert np.array_equal(got, want)


def test_fma32_rounds_once():
    """``_fma32`` of f32 operands equals the exactly rounded a * b + c
    (Fractions), including sums far below an ulp of the larger term."""
    from fractions import Fraction
    rng = np.random.default_rng(5)
    a = rng.standard_normal(4000).astype(np.float32)
    b = (rng.standard_normal(4000) * 2.0 ** rng.integers(-30, 30, 4000)) \
        .astype(np.float32)
    c = (-a.astype(np.float64) * b * (1 + rng.standard_normal(4000)
                                      * 2.0 ** -rng.integers(10, 40, 4000))) \
        .astype(np.float32)
    c[:1000] = 1.0
    got = port_resize._fma32(torch.from_numpy(a), torch.from_numpy(b),
                             torch.from_numpy(c)).numpy()
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(exact))
        cands = [lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(-np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(v.view(np.int32)) & 1))
        assert g == best, (x, y, z)


@pytest.mark.parametrize("src,dst", [
    ((512, 512), (224, 224)),      # shrink: antialiased
    ((160, 160), (224, 224)),      # grow
    ((300, 512), (224, 224)),      # grow one axis, shrink the other
    ((512, 400), (512, 224)),      # an unchanged axis is skipped
    ((1080, 1920), (224, 224)),    # config 5: 1080p to ViT-B/16's input
])
def test_resize_rgba_matches_jax(src, dst):
    rng = np.random.default_rng(sum(src) + sum(dst))
    img = rng.integers(0, 256, (*src, 4), dtype=np.uint8)
    want = np.asarray(jax_resize_rgba(jnp.asarray(img), dst)).astype(int)
    got = resize_rgba(torch.from_numpy(img), dst)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (*dst, 4)
    diff = np.abs(got.numpy().astype(int) - want)
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-3


def test_resize_rgba_takes_the_references_positional_method():
    """The reference's own pipeline calls ``resize_rgba(s, size,
    "bilinear")`` positionally: both packages take it, within the 1 LSB
    of ``test_resize_rgba_matches_jax``; another method, positional too,
    gives JAX's result (nearest exactly; the others in
    ``tests/test_torch_resize_methods.py``)."""
    rng = np.random.default_rng(10)
    img = rng.integers(0, 256, (96, 160, 4), dtype=np.uint8)
    want = np.asarray(jax_resize_rgba(jnp.asarray(img), (64, 64),
                                      "bilinear")).astype(int)
    got = resize_rgba(torch.from_numpy(img), (64, 64), "bilinear")
    assert got.dtype == torch.uint8 and tuple(got.shape) == (64, 64, 4)
    assert np.abs(got.numpy().astype(int) - want).max() <= 1
    assert torch.equal(got, resize_rgba(torch.from_numpy(img), (64, 64)))
    near = resize_rgba(torch.from_numpy(img), (64, 64), "nearest")
    assert np.array_equal(near.numpy(), np.asarray(jax_resize_rgba(
        jnp.asarray(img), (64, 64), "nearest")))


def test_resize_rgba_batched_equals_per_image():
    rng = np.random.default_rng(9)
    imgs = torch.from_numpy(rng.integers(0, 256, (3, 96, 128, 4),
                                         dtype=np.uint8))
    batched = resize_rgba(imgs, (64, 64))
    assert torch.equal(batched,
                       torch.stack([resize_rgba(i, (64, 64)) for i in imgs]))


def test_resize_ignores_and_keeps_the_callers_matmul_precision(monkeypatch):
    """With the caller's float32 matmul precision at "medium" (TF32 or
    bf16 products where a backend has them), resize_rgba gives the same
    result as at "highest", and leaves the caller's setting as it was:
    it computes in float64 and never sets the global, which another
    thread may be reading, even for the length of the call."""
    rng = np.random.default_rng(9)
    img = torch.from_numpy(rng.integers(0, 256, (2, 96, 128, 4),
                                        dtype=np.uint8))
    prev = torch.get_float32_matmul_precision()
    real_set = torch.set_float32_matmul_precision
    try:
        real_set("highest")
        want = resize_rgba(img, (80, 64))
        real_set("medium")
        sets = []
        monkeypatch.setattr(torch, "set_float32_matmul_precision",
                            lambda p: sets.append(p) or real_set(p))
        got = resize_rgba(img, (80, 64))
        assert sets == []
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        real_set(prev)
    assert torch.equal(got, want)
    jax_want = np.stack([np.asarray(jax_resize_rgba(jnp.asarray(x.numpy()),
                                                    (80, 64), "bilinear"))
                         for x in img])
    assert np.abs(got.numpy().astype(int) - jax_want).max() <= 1


@pytest.mark.parametrize("n_in,n_out", [(1080, 224), (1920, 224), (160, 224),
                                        (333, 97), (7, 11), (37, 1), (1, 5)])
def test_taps_hold_the_weight_matrix(n_in, n_out):
    """Each output's run (start, count, weights) rebuilds its column of
    the dense matrix exactly, and no nonzero weight lies outside it; the
    weights are f32 values held as float64."""
    start, count, wts = port_resize.taps(n_in, n_out)
    assert wts.dtype == torch.float64
    assert torch.equal(wts.float().double(), wts)   # f32 values
    dense = torch.zeros(n_in, n_out)
    for j in range(n_out):
        s, c = int(start[j]), int(count[j])
        assert s >= 0 and s + c <= n_in
        assert not wts[j, c:].any()
        dense[s:s + c, j] = wts[j, :c]
    assert torch.equal(dense, _weight_mat(n_in, n_out, torch.device("cpu")))


def _jax_resize_each(img, size):
    flat = img.reshape(-1, *img.shape[-3:])
    return np.stack([np.asarray(jax_resize_rgba(jnp.asarray(i), size))
                     for i in flat]).reshape(*img.shape[:-3], *size,
                                             img.shape[-1])


@pytest.mark.parametrize("name", list(testing.resize_cases()))
def test_resize_cases_match_jax(name):
    img, size = testing.resize_cases()[name]
    got = resize_rgba(torch.from_numpy(img), size)
    assert got.dtype == torch.uint8
    assert tuple(got.shape) == (*img.shape[:-3], *size, img.shape[-1])
    diff = np.abs(got.numpy().astype(int) - _jax_resize_each(img, size))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-3


def _resized(shape, size) -> bool:
    return size is not None and tuple(size) != tuple(shape[-3:-1])


def _assert_normalize_unresized(got, batch, mean, std, want):
    """The port's ``got`` is the test's own FMA form,
    ``fma(x, f32(1/255), -mean) / std`` (the product and the difference
    are exact in float64, so one rounding to f32), and JAX's ``want``
    equals it bit for bit."""
    x = torch.from_numpy(batch[..., :3]).double()
    m = torch.tensor(mean, dtype=torch.float32).double()
    fused = (x * port_resize.INV255 - m).float() \
        / torch.tensor(std, dtype=torch.float32)
    assert torch.equal(got, fused)
    bad = want != got.numpy()
    assert not bad.any(), int(bad.sum())


@pytest.mark.parametrize("name", list(testing.normalize_cases()))
def test_normalize_for_model_matches_jax(name):
    """Without a resize, with a shrink, a grow, one axis kept, odd sizes,
    3 channels, and the reference's and ImageNet's mean and std."""
    batch, size, mean, std = testing.normalize_cases()[name]
    got = port_resize.normalize_for_model(torch.from_numpy(batch), size,
                                          mean, std)
    want = np.asarray(jax_normalize(jnp.asarray(batch), size, mean, std))
    assert got.dtype == torch.float32 and got.shape == want.shape
    if not _resized(batch.shape, size):
        _assert_normalize_unresized(got, batch, mean, std, want)
        return
    err_x = (np.abs(got.numpy().astype(np.float64) - want)
             * np.asarray(std)).max()
    assert err_x <= 2.0 ** -21, err_x


def test_normalize_default_mean_std_and_size_none():
    rng = np.random.default_rng(4)
    batch = rng.integers(0, 256, (2, 40, 56, 4), dtype=np.uint8)
    got = port_resize.normalize_for_model(torch.from_numpy(batch))
    want = np.asarray(jax_normalize(jnp.asarray(batch)))
    _assert_normalize_unresized(got, batch, (0.5,) * 3, (0.5,) * 3, want)


def test_entries_take_the_plain_versions_on_the_cpu():
    img, size = testing.resize_cases()["odd_down"]
    t = torch.from_numpy(img)
    assert torch.equal(resize_rgba(t, size),
                       port_resize.resize_rgba_plain(t, size))
    b = torch.from_numpy(testing.normalize_cases()["keep_w"][0])
    assert torch.equal(port_resize.normalize_for_model(b, (64, 128)),
                       port_resize.normalize_plain(b, (64, 128)))
    with pytest.raises(ValueError, match="device"):
        resize_rgba(t.to("meta"), size)


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    """The kernels' wrappers take CUDA tensors only, and check the rest
    before any build or launch."""
    img = torch.zeros(2, 8, 8, 4, dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_resize.resize_rgba(img, (4, 4))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_resize.normalize_resize(img, (4, 4))
    assert cuda_resize.launches == {"resize_rgba": 0, "normalize_resize": 0}


def test_cropped_slots_resize_like_contiguous_ones():
    """decode_batch resizes cropped views of its decodes: the plain
    version reads them as the contiguous copy."""
    rng = np.random.default_rng(6)
    full = torch.from_numpy(rng.integers(0, 256, (64, 80, 4), dtype=np.uint8))
    crop = full[:50, :72]
    assert torch.equal(resize_rgba(crop, (24, 40)),
                       resize_rgba(crop.contiguous(), (24, 40)))


def _mixed_slots():
    """Slots of three sizes as ``decode_batch`` holds them: a contiguous
    image, a crop of a larger decode (rows at the larger pitch) and a
    slot of another size."""
    rng = np.random.default_rng(15)
    big = torch.from_numpy(rng.integers(0, 256, (120, 170, 4), np.uint8))
    return [torch.from_numpy(rng.integers(0, 256, (96, 128, 4), np.uint8)),
            big[5:101, 3:163],
            torch.from_numpy(rng.integers(0, 256, (50, 61, 4), np.uint8))]


def test_resize_batch_matches_jax_stack():
    """``resize_batch`` over slots of other sizes equals each slot resized
    alone by ``resize_rgba_plain``, and JAX's per-slot resizes stacked
    (``jnp.stack``) to 1 LSB."""
    slots, size = _mixed_slots(), (48, 64)
    got = port_resize.resize_batch(slots, size)
    assert torch.equal(got, port_resize.resize_batch_plain(slots, size))
    assert torch.equal(got, torch.stack([port_resize.resize_rgba_plain(
        s, size) for s in slots]))
    want = np.asarray(jnp.stack([jax_resize_rgba(jnp.asarray(s.numpy()),
                                                 size) for s in slots]))
    diff = np.abs(got.numpy().astype(int) - want)
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


_EXACT_SIZES = sorted({(1080, 224), (1920, 224), *(
    (n_in, n_out) for img, size in testing.resize_cases().values()
    for n_in, n_out in zip(img.shape[-3:-1], size) if n_in != n_out)})


@pytest.mark.parametrize("n_in,n_out", _EXACT_SIZES)
def test_every_product_is_exact_in_double(n_in, n_out):
    """Every tap weight (an f32) times every value the sums take is exact
    in float64, so the kernels' one fused multiply-add a tap rounds as
    the plain versions' product and then sum: checked with Fractions
    against every byte (K16's first axis) and against f32 values of
    full 24-bit significands up to 255 (K17's inputs and either pass's
    f32 results).  Nonzero weights are at least 2**-108, which the
    kernels' integer widening of f32 values takes as given."""
    from fractions import Fraction
    wts = taps(n_in, n_out)[2].numpy()
    ws = np.unique(wts[wts != 0])
    assert (ws.astype(np.float32).astype(np.float64) == ws).all()
    assert ws.min() >= 2.0 ** -108
    rng = np.random.default_rng(n_in * 7 + n_out)
    f32 = np.unique(np.concatenate([
        (rng.random(64) * 255).astype(np.float32),
        (rng.random(64) * 2.0 ** -rng.integers(0, 30, 64)).astype(np.float32),
        np.float32(1 / 255) * np.arange(256, dtype=np.float32)]))
    values = [float(v) for v in np.arange(256)] + [float(v) for v in f32]
    for w in ws.tolist():
        fw = Fraction(w)
        for x in values:
            assert Fraction(w * x) == fw * Fraction(x), (w, x)


def _read_slots(words, tensors: dict, size, channels: int) -> torch.Tensor:
    """K16's launch as its CTAs read ``words``: each slot's pixels at its
    address and row pitch, each axis's taps at their addresses (``tensors``:
    data_ptr -> tensor) with K and the input size from the last word, an
    axis with null addresses kept; sums in float64 in ascending order,
    rounded to f32 after each axis, then to bytes."""
    def axis(ws):
        start, count, wts, last = (int(v) for v in ws)
        n_in, k = last >> 32, last & 0xFFFFFFFF
        if not start:
            return n_in, None
        wt = tensors[wts]
        assert wt.shape[1] == k
        return n_in, (tensors[start], tensors[count], wt)

    out = []
    for row in words:
        img = tensors[int(row[0])]
        assert img.stride(0) == int(row[1])
        (hi, vt), (wi, ht) = axis(row[2:6]), axis(row[6:10])
        assert img.shape[:2] == (hi, wi)
        x = img.double()
        for dim, t, n_out in ((0, vt, size[0]), (1, ht, size[1])):
            if t is None:
                continue
            start, count, wt = t
            acc = []
            for j in range(n_out):
                s_, c_ = int(start[j]), int(count[j])
                part = torch.zeros_like(x.select(dim, 0))
                for i in range(c_):
                    part = part + wt[j, i] * x.select(dim, s_ + i)
                acc.append(part)
            x = torch.stack(acc, dim).float().double()
        out.append(torch.round(x.float()).clamp(0, 255).to(torch.uint8))
    assert all(o.shape[-1] == channels for o in out)
    return torch.stack(out)


def test_slot_words_model_the_per_slot_resize():
    """``cuda_resize.slot_words``, the descriptors of K16's one launch,
    read back as the kernel reads them (``_read_slots``), give the bytes
    of the per-slot loop they replace; the widest changing W and the most
    input rows a band of ``ROWS`` output rows spans size its shared
    memory, and every band's runs fit that span."""
    slots, size = _mixed_slots(), (48, 64)
    dev = torch.device("cpu")
    words, line_w, vk, held = cuda_resize.slot_words(slots, size, dev)
    assert words.shape == (3, cuda_resize.SLOT_WORDS)
    assert line_w == 170 - 10 and vk == max(
        cuda_resize.band_rows(n, 48) for n in (96, 50))
    tensors = {t.data_ptr(): t for t in (*slots, *held)}
    assert torch.equal(_read_slots(words, tensors, size, 4),
                       port_resize.resize_batch_plain(slots, size))
    for n in (96, 50):
        start, count, _ = taps(n, 48)
        for j in range(0, 48, cuda_resize.ROWS):
            band = [(int(start[k]), int(start[k] + count[k]))
                    for k in range(j, min(j + cuda_resize.ROWS, 48))
                    if count[k]]
            if band:
                assert max(b for _, b in band) - min(a for a, _ in band) \
                    <= vk
    src = open(os.path.join(os.path.dirname(cuda_resize.__file__), "..",
                            "csrc", "resize.cu")).read()
    assert f"constexpr int kRows = {cuda_resize.ROWS};" in src
    assert f"constexpr int kMaxSlots = {cuda_resize.MAX_SLOTS};" in src
    kept, _, kept_vk, _ = cuda_resize.slot_words([slots[0]], (96, 64), dev)
    assert kept[0, 2:5].tolist() == [0, 0, 0] and kept[0, 5] == 96 << 32
    assert kept_vk == 0


def test_slot_words_hold_every_table_they_point_at():
    """A launch over 70 slots of distinct sizes needs more tap tables
    than ``taps`` caches, so the cache drops the first slots' tables
    while the later ones' descriptors are built.  ``slot_words`` returns
    every tensor its descriptors point at: each address of a tap table
    is one of them, and it holds that slot's taps."""
    rng = np.random.default_rng(70)
    big = torch.from_numpy(rng.integers(0, 256, (110, 150, 4), np.uint8))
    slots = [big[:40 + k, :80 - k // 2 + 3 * (k % 2)] for k in range(70)]
    size = (16, 12)
    words, _, _, held = cuda_resize.slot_words(slots, size,
                                               torch.device("cpu"))
    assert len({(s.shape[0], s.shape[1]) for s in slots}) == 70
    assert len({(s.shape[0], size[0]) for s in slots} |
               {(s.shape[1], size[1]) for s in slots}) > taps.cache_info() \
        .maxsize
    tables = {t.data_ptr(): t for t in held}
    for s, row in zip(slots, words):
        for n_in, n_out, ws in ((s.shape[0], size[0], row[2:5]),
                                (s.shape[1], size[1], row[6:9])):
            want = taps.__wrapped__(n_in, n_out)
            for addr, t in zip(ws.tolist(), want):
                assert addr in tables and torch.equal(tables[addr], t)


def test_kernel_bit_conversions_are_exact():
    """``resize.cu``'s conversions without a conversion instruction, run
    here as numpy integer operations with the constants read from the
    source: a byte c of a word as the f32 2^23 + v (``__byte_perm`` with
    0x4B000000), less 2^23, is the byte, and times f32(1/255) K17's
    input; an f32 that is 0 or positive normal moved into a double (the
    exponent rebased by 896, the mantissa moved up 29 bits) is that f32's
    value exactly, over bytes, their K17 values and f32 values from
    2**-100 to 255."""
    import re
    src = open(os.path.join(os.path.dirname(cuda_resize.__file__), "..",
                            "csrc", "resize.cu")).read()
    perm = re.search(r"__byte_perm\(v, (0x[0-9A-F]+)u, (0x[0-9a-f]+) \+ c\)",
                     src)
    rebase = re.search(r"\(b >> 3\) \+ (0x[0-9A-F]+)u\) : 0,\s*"
                       r"\(int\)\(b << 29\)", src)
    assert perm and rebase and "8388608.0f" in src
    magic, sel, bias = (int(g, 16) for g in (*perm.groups(), rebase[1]))

    def byte_perm(x: int, y: int, s: int) -> int:
        b = x.to_bytes(4, "little") + y.to_bytes(4, "little")
        return int.from_bytes(bytes(b[(s >> 4 * k) & 7] for k in range(4)),
                              "little")

    def f32_as_f64(f) -> float:
        b = int(np.float32(f).view(np.uint32))
        hi = ((b >> 3) + bias) & 0xFFFFFFFF if b else 0
        bits = (hi << 32) | ((b << 29) & 0xFFFFFFFF)
        return float(np.uint64(bits).view(np.float64))

    rng = np.random.default_rng(3)
    inv255 = np.float32(port_resize.INV255)
    for word in [0, 0xFFFFFFFF, *rng.integers(0, 2 ** 32, 300).tolist()]:
        for c in range(4):
            m = byte_perm(int(word), magic, sel + c)
            f = np.uint32(m).view(np.float32) - np.float32(8388608.0)
            assert f == (word >> 8 * c) & 255
            assert f32_as_f64(f) == float(f)
            k17 = np.float32(f * inv255)
            assert f32_as_f64(k17) == float(k17)
    for f in (rng.random(5000) * 255).astype(np.float32).tolist() + [
            2.0 ** -100, 1.0, 255.0]:
        assert f32_as_f64(f) == float(np.float32(f))
