"""K16's other resize methods: ``ops.resize.resize_rgba`` and
``resize_batch_rgba`` with every method ``jax.image.resize`` takes
(``nearest``, ``linear``/``bilinear``, ``cubic``/``bicubic``,
``lanczos3``, ``lanczos5``), held against ffpic_tpu's on the CPU.

Tolerance against JAX: ``nearest`` exact (one tap of weight 1 at the
index XLA computes); the others 1 LSB of uint8, because the weights
differ from XLA's jitted ones by an ulp or so (its FMA choices and its
``sin`` against PyTorch's) and the sums run in another order and width,
so a value can land on the other side of .5.  The weight matrices are
held to ``jax._src.image.scale.compute_weight_mat`` run op by op, within
8 f32 ulps of each weight (observed: 0 for cubic, up to 5 for Lanczos,
whose ``sin`` differs).

K16's plain version on every method: its taps rebuild the dense weights
exactly, its descriptors read back as the kernel reads them give its
bytes (``test_torch_resize._read_slots``), its result equals a dense
float64 model of the two passes, every product it sums is exact in
float64 (so the kernel's one FMA a tap rounds as the plain version's
product and sum), and a CTA's weights and lines fit shared memory at
config 5's widest slot.  Cubic and Lanczos weights have negative lobes,
so K16 takes its pass-1 results into pass 2 by a conversion, exact for
any f32; bilinear and nearest weights are never negative, which K17's
integer widening of its (bilinear) pass-1 results relies on.

K16 launches one of three kernels by method (``cuda_resize._resize``):
nearest's gather, whose plain model ``ops.resize.gather_nearest`` (an
``index_select`` by the ``start`` tables, which the entries run on the
CPU for nearest) equals the tap sum and JAX on every
``testing.resize_cases`` entry, the band kernel by cubic and Lanczos
(``resize<0,1>`` where two of its rows do not fit; its numpy model is
``tests/test_torch_resize_band.py``), and the banded kernel by bilinear.
"""

import os
import re
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffpic_tpu.ops.resize import resize_batch_rgba as jax_resize_batch
from ffpic_tpu.ops.resize import resize_rgba as jax_resize_rgba
from ffpic_tpu_torch import testing
from ffpic_tpu_torch.ops import cuda_resize
from ffpic_tpu_torch.ops import resize as rs
from test_torch_resize import _read_slots
from test_torch_resize_band import band_launch
import reference_native  # noqa: F401  (readies ffpic_tpu first)

METHODS = ("nearest", "bilinear", "bicubic", "lanczos3", "lanczos5")
SIZES = [((96, 128), (224, 224)),     # grow
         ((300, 200), (64, 72)),      # shrink: antialiased
         ((61, 97), (61, 40)),        # an unchanged axis is skipped
         ((37, 23), (50, 17))]        # grow one axis, shrink the other


def _img(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, (*shape, 4),
                                                dtype=np.uint8)


@pytest.mark.parametrize("method", METHODS)
def test_resize_rgba_matches_jax(method):
    for k, (src, dst) in enumerate(SIZES):
        img = _img(src, k)
        want = np.asarray(jax_resize_rgba(jnp.asarray(img), dst, method))
        got = rs.resize_rgba(torch.from_numpy(img), dst, method).numpy()
        assert got.dtype == np.uint8 and got.shape == (*dst, 4)
        diff = np.abs(got.astype(int) - want.astype(int))
        if method == "nearest":
            assert not diff.any()
        else:
            assert diff.max() <= 1 and (diff > 0).mean() < 2e-3, (src, dst)


@pytest.mark.parametrize("method", METHODS)
def test_resize_batch_rgba_matches_jax(method):
    """A list of numpy images of three sizes, as the reference's entry
    takes it, to one (N, h, w, 4) batch."""
    imgs = [_img((48, 64), 1), _img((90, 33), 2), _img((20, 21), 3)]
    want = np.asarray(jax_resize_batch(imgs, (40, 40), method))
    got = rs.resize_batch_rgba(imgs, (40, 40), method, device="cpu")
    assert torch.equal(got, rs.resize_batch_plain(
        [torch.from_numpy(i) for i in imgs], (40, 40), method))
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert diff.max() <= (0 if method == "nearest" else 1)


def test_method_names_are_jaxs():
    """JAX's aliases give the same bytes; another name raises
    ``ValueError`` in both packages."""
    img = torch.from_numpy(_img((50, 70), 4))
    for names in (("bilinear", "linear", "trilinear", "triangle"),
                  ("bicubic", "cubic", "tricubic")):
        outs = [rs.resize_rgba(img, (30, 31), n) for n in names]
        assert all(torch.equal(outs[0], o) for o in outs[1:])
    for bad in ("area", "gaussian", "Bilinear"):
        with pytest.raises(ValueError, match="Unknown resize method"):
            rs.resize_rgba(img, (30, 31), bad)
        with pytest.raises(ValueError, match="Unknown resize method"):
            rs.resize_batch_rgba([img], (30, 31), bad)
        with pytest.raises(ValueError):
            jax_resize_rgba(jnp.asarray(img.numpy()), (30, 31), bad)


@pytest.mark.parametrize("method", ["bicubic", "lanczos3", "lanczos5"])
@pytest.mark.parametrize("n_in,n_out", [(1080, 224), (64, 224), (97, 61)])
def test_weight_mat_matches_jax_op_by_op(method, n_in, n_out):
    """``_kernel_weight_mat`` against ``compute_weight_mat`` run op by
    op: within 8 ulps of each weight (XLA's ``sin`` against PyTorch's;
    observed 0 for cubic, up to 5 for Lanczos)."""
    from jax._src.image import scale
    kernel = scale._kernels[scale.ResizeMethod.from_string(method)]
    want = np.asarray(scale.compute_weight_mat(
        n_in, n_out, jnp.float32(n_out / n_in), jnp.float32(0.0), kernel,
        True))
    got = rs.weight_mat(n_in, n_out, method).numpy()
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert (np.abs(got - want) <= 8 * ulp).all()


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n_in,n_out", [(1080, 224), (1920, 224), (33, 97),
                                        (7, 11), (37, 1), (1, 5)])
def test_taps_hold_the_weight_matrix(method, n_in, n_out):
    start, count, wts = rs.taps(n_in, n_out, torch.device("cpu"), method)
    assert torch.equal(wts.float().double(), wts)
    dense = torch.zeros(n_in, n_out)
    for j in range(n_out):
        s, c = int(start[j]), int(count[j])
        assert s >= 0 and s + c <= n_in and not wts[j, c:].any()
        dense[s:s + c, j] = wts[j, :c]
    assert torch.equal(dense, rs.weight_mat(n_in, n_out, method))
    if method == "nearest":
        assert set(count.tolist()) == {1} and (wts[:, 0] == 1).all()
    if method in ("nearest", "bilinear"):
        assert not (dense < 0).any()


@pytest.mark.parametrize("method", METHODS)
def test_plain_version_is_the_dense_two_pass_model(method):
    """``resize_rgba_plain`` equals the dense float64 model: H by the
    (in, out) weights, rounded to f32, then W, rounded to f32, then to
    bytes; on a step edge whose negative lobes take pass 1 below 0 and
    the result past 255."""
    img = np.zeros((40, 50, 4), np.uint8)
    img[:, 25:] = 255
    img[17:, :, 1] = 255
    img[..., 3] = np.arange(50, dtype=np.uint8) * 5
    for dst in ((23, 31), (90, 120)):
        x = torch.from_numpy(img).double()
        wv = rs.weight_mat(40, dst[0], method).double()
        wh = rs.weight_mat(50, dst[1], method).double()
        p1 = torch.einsum("iwc,ih->hwc", x, wv).float()
        p2 = torch.einsum("hwc,wj->hjc", p1.double(), wh).float()
        want = torch.round(p2).clamp(0, 255).to(torch.uint8)
        got = rs.resize_rgba_plain(torch.from_numpy(img), dst, method)
        assert torch.equal(got, want)
        if method in ("bicubic", "lanczos3", "lanczos5"):
            assert (p1 < 0).any() and (p2 > 255).any()


@pytest.mark.parametrize("method", METHODS)
def test_slot_words_model_every_method(method):
    """K16's descriptors of a mixed launch, read as the kernel reads them,
    give the plain version's bytes by ``method``."""
    rng = np.random.default_rng(8)
    big = torch.from_numpy(rng.integers(0, 256, (90, 120, 4), np.uint8))
    slots = [big[:64, :80], big[3:90, 5:61],
             torch.from_numpy(rng.integers(0, 256, (30, 47, 4), np.uint8))]
    size = (48, 40)
    words, _, vk, held = cuda_resize.slot_words(slots, size,
                                                torch.device("cpu"), method)
    tensors = {t.data_ptr(): t for t in (*slots, *held)}
    assert torch.equal(_read_slots(words, tensors, size, 4),
                       rs.resize_batch_plain(slots, size, method))
    assert vk == max(cuda_resize.band_rows(n, 48, method) for n in (64, 87,
                                                                    30))


@pytest.mark.parametrize("method", METHODS)
def test_shared_memory_holds_config5_bands(method):
    """A CTA of two output rows over config 5's widest slot (1080 x 1920
    RGBA to 224 x 224) fits the banded kernel's shared memory at every
    method: its band's weights (``band_rows``, rounded up to ``kBatch``)
    and its lines, read from ``resize.cu``.  By cubic and Lanczos the
    band kernel takes ``kBandRows`` rows a CTA there, its scaled weights
    and padded lines in the most shared memory a CTA has; at 8064 RGBA
    pixels wide two of its rows do not fit, and the launch takes
    ``resize<0,1>``, whose one row does."""
    src = open(os.path.join(os.path.dirname(cuda_resize.__file__), "..",
                            "csrc", "resize.cu")).read()
    max_smem = int(re.search(r"kMaxSmem = (\d+)", src).group(1))
    batch = int(re.search(r"kBatch = (\d+)", src).group(1))
    vk = cuda_resize.band_rows(1080, 224, method)
    vk = -(-vk // batch) * batch
    rows = cuda_resize.ROWS
    assert rows * vk * 8 + rows * 1920 * 4 * 4 + 1024 <= max_smem
    taps = {"nearest": 1, "bilinear": 10, "bicubic": 20, "lanczos3": 29,
            "lanczos5": 49}[method]
    assert abs(rs.taps(1080, 224, torch.device("cpu"), method)[2].shape[1]
               - taps) <= 1
    if rs.kernel_of(method) not in cuda_resize.BAND_KERNELS:
        return
    band_rows = int(re.search(r"kBandRows = (\d+)", src).group(1))
    img = [torch.zeros((1080, 3, 4), dtype=torch.uint8)]
    spans = cuda_resize.band_spans(img, 224, method)
    got, smem = band_launch(1920, 4, spans, 224, 8)
    assert got == band_rows and smem + 1024 <= max_smem
    got, smem = band_launch(8064, 4, spans, 224, 2)
    assert got == 0 and smem + 1024 <= max_smem


@pytest.mark.parametrize("n_in,n_out", [(1080, 224), (1920, 224), (33, 97),
                                        (7, 11), (37, 1), (1, 5), (224, 1080),
                                        (5, 5), (1, 1), (97, 61), (61, 97),
                                        (3, 1000), (1000, 3)])
def test_nearest_is_one_tap_of_weight_one(n_in, n_out):
    """Every output of ``nearest`` has one tap (``count == 1``) of weight
    1.0 at ``start``, shrinking, growing and at one pixel, so K16's
    gather by ``start`` is the tap sum."""
    start, count, wts = rs.taps(n_in, n_out, torch.device("cpu"), "nearest")
    assert (count == 1).all() and wts.shape[1] == 1 and (wts == 1).all()
    assert (start >= 0).all() and (start < n_in).all()


@pytest.mark.parametrize("name", list(testing.resize_cases()))
def test_gather_is_the_tap_sum_and_jax(name):
    """``gather_nearest`` (the plain model of K16's gather, which the
    entries run on the CPU for nearest) equals the float64 tap sum
    (``resize_rgba_plain``) and the JAX package's ``resize_rgba(...,
    "nearest")`` on every ``testing.resize_cases`` entry, 3 and 4
    channels."""
    img, size = testing.resize_cases()[name]
    x = torch.from_numpy(img)
    got = rs.gather_nearest(x, size)
    assert torch.equal(got, rs.resize_rgba_plain(x, size, "nearest"))
    assert torch.equal(rs.resize_rgba(x, size, "nearest"), got)
    flat = img.reshape(-1, *img.shape[-3:])
    want = np.stack([np.asarray(jax_resize_rgba(jnp.asarray(im), size,
                                                "nearest")) for im in flat])
    assert np.array_equal(got.numpy().reshape(want.shape), want)


@pytest.mark.parametrize("method", METHODS)
def test_launch_takes_the_methods_kernel(method, monkeypatch):
    """``cuda_resize._resize`` launches nearest's gather, the band kernel
    by cubic and Lanczos and the banded kernel by bilinear, once with
    ``slot_words``' descriptors, counted as ``resize_rgba``, the
    instance's out-argument last; the band kernel's launch also passes
    its pass-2 tables (``group_words``) and ``band_spans``, and its
    instance and rows are what the launcher reports (``resize_band`` at
    the rows of ``launch_band``'s rule, modelled here; ``resize<0,1>``
    for an 8064-wide slot); K17 stays on the banded kernel."""
    import ctypes
    calls = []

    def launch(fn, counter, *a):
        n = a[2] if fn == "ffpic_resize_band" else a[1]
        words = np.ctypeslib.as_array((ctypes.c_int64 * (n * 10))
                                      .from_address(a[0].value)).copy()
        extra = None
        if fn == "ffpic_resize_band":
            groups = np.ctypeslib.as_array((ctypes.c_int64 * (n * 3))
                                           .from_address(a[1].value)).copy()
            spans = np.ctypeslib.as_array((ctypes.c_int32 * 16)
                                          .from_address(a[8].value)).copy()
            extra = (groups.reshape(n, 3), spans)
            rows = band_launch(a[7], a[3], spans, a[5], n)[0]
            ctypes.c_int.from_address(a[9].value).value = rows
        calls.append((fn, counter, a, words.reshape(n, 10), extra))
    monkeypatch.setattr(cuda_resize, "_launch", launch)
    rng = np.random.default_rng(3)
    slots = [torch.from_numpy(rng.integers(0, 256, s, dtype=np.uint8))
             for s in ((50, 70, 4), (31, 44, 4))]
    size = (20, 24)
    out = torch.empty((2, *size, 4), dtype=torch.uint8)
    cuda_resize._resize(slots, size, out, method)
    cuda_resize._run("ffpic_normalize_resize", "normalize_resize", slots,
                     size, out, "bilinear",
                     lambda line_w, vk: (line_w, vk, None, None))
    (fn, counter, a, words, extra), (fn17, counter17, a17, words17, _) = \
        calls
    assert counter == "resize_rgba" and counter17 == "normalize_resize"
    assert fn17 == "ffpic_normalize_resize" and len(a17) == 10
    cpu = torch.device("cpu")
    plain_words, line_w, vk, _ = cuda_resize.slot_words(slots, size, cpu,
                                                        method)
    assert np.array_equal(words17, cuda_resize.slot_words(
        slots, size, cpu, "bilinear")[0])
    assert np.array_equal(words, plain_words)
    assert isinstance(a[-1], ctypes.c_void_p)
    kernel = rs.kernel_of(method)
    if kernel == "nearest":
        assert fn == "ffpic_resize_nearest" and len(a) == 7
        assert cuda_resize.instance["resize_rgba"] == "resize_gather<0>"
    elif kernel in cuda_resize.BAND_KERNELS:
        assert fn == "ffpic_resize_band" and len(a) == 10
        assert a[2:4] == (2, 4) and a[5:8] == (*size, line_w)
        assert np.array_equal(extra[0], cuda_resize.group_words(
            slots, size, cpu, method)[0])
        assert np.array_equal(extra[1],
                              cuda_resize.band_spans(slots, size[0], method))
        assert cuda_resize.instance == {"resize_rgba": "resize_band",
                                        "rows": 2}
        calls.clear()
        wide = torch.zeros((3, 8064, 4), dtype=torch.uint8)
        cuda_resize._resize([wide], (2, 5),
                            torch.empty((1, 2, 5, 4), dtype=torch.uint8),
                            method)
        assert calls[0][0] == "ffpic_resize_band"
        assert cuda_resize.instance == {"resize_rgba": "resize<0,1>",
                                        "rows": 1}
        return
    else:
        assert fn == "ffpic_resize_rgba" and a[6:8] == (line_w, vk)
        assert len(a) == 9
        assert cuda_resize.instance["resize_rgba"] == "resize<0,0>"
    assert a[1:3] == (2, 4) and a[4:6] == size


@pytest.mark.parametrize("method", ["bicubic", "lanczos3", "lanczos5"])
def test_every_product_is_exact_in_double(method):
    """Every tap weight times every value the sums take (a byte, or an
    f32 of full significand, negative too) is exact in float64, so the
    kernel's fused multiply-add rounds as the plain version's product
    and sum."""
    ws = np.unique(rs.taps(97, 29, torch.device("cpu"), method)[2].numpy())
    ws = ws[ws != 0]
    assert (ws < 0).any()
    rng = np.random.default_rng(2)
    f32 = np.concatenate([(rng.random(24) * 600 - 300),
                          rng.random(8) * 2.0 ** -rng.integers(0, 40, 8)]) \
        .astype(np.float32)
    values = [float(v) for v in range(256)] + [float(v) for v in f32]
    for w in ws.tolist():
        fw = Fraction(w)
        for x in values:
            assert Fraction(w * x) == fw * Fraction(x), (w, x)


def test_normalize_for_model_stays_bilinear():
    """``normalize_for_model`` resizes bilinearly, as the reference's."""
    from ffpic_tpu.ops.resize import normalize_for_model as jax_norm
    batch = _img((2, 60, 80), 11)
    got = rs.normalize_for_model(torch.from_numpy(batch), (32, 32))
    want = np.asarray(jax_norm(jnp.asarray(batch), (32, 32)))
    assert np.abs(got.numpy() - want).max() <= 2.0 ** -20
