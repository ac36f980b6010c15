"""ffpic_tpu_torch.ops.jpeg_kernels (plain PyTorch versions, CPU) held
against ffpic_tpu.ops.jpeg_kernels on the same numpy inputs.

Every stage is held exact: the unpack scatter, the sparse route's
scatter-add and host packing, dequant + integer IDCT
(also against the Pallas kernel in interpret mode), colour conversion
over all 256^3 in-range (y, u, v) inputs (against ``color_convert``
jitted alone, where XLA contracts its products into FMAs), the block
map, and the fused batch route with per-image quant tables of
different qualities, whose colour is held up to XLA's contraction
choice inside the larger jits (``testing.
assert_equal_up_to_contraction``).  The
CUDA kernels themselves run only on a GPU (``chip_smoke.py``); here the
wrappers are checked to refuse CPU tensors.
"""

import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffpic_tpu.formats import jpg as jax_jpg
from ffpic_tpu.ops import jpeg_kernels as jax_jk
from ffpic_tpu_torch import testing
from ffpic_tpu_torch.formats import jpg as tjpg
from ffpic_tpu_torch.formats.jpg_encode import encode_baseline
from ffpic_tpu_torch.formats.pic import Pic
from ffpic_tpu_torch.ops import _build, cuda_jpeg, golden
from ffpic_tpu_torch.ops import jpeg_kernels as jk
import reference_native  # noqa: F401  (readies ffpic_tpu first)

MODES = ("reference", "bt601", "rgb")
ORDERS = ("rgba", "bgra")


@functools.lru_cache(maxsize=None)
def _jpeg(kind: str) -> bytes:
    """Small 4:2:0 inputs: synthetic baseline at three qualities, a
    restart-interval stream, and one whose last blocks are all zero."""
    if kind.startswith("q"):
        return testing.synth_jpeg_420(160, 224, int(kind[1:]), 11)
    if kind == "dri":
        from PIL import Image
        rgb = testing.synth_rgb(120, 200, 3)
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, "JPEG", quality=90,
                                  subsampling="4:2:0",
                                  restart_marker_blocks=3)
        assert b"\xff\xdd" in buf.getvalue()
        return buf.getvalue()
    if kind == "trailing_zero":
        rgb = testing.synth_rgb(96, 128, 4)
        rgb[48:] = 128                      # flat mid-grey: all-zero blocks
        return encode_baseline(Pic(pixels=rgb, width=128, height=96), 80,
                               device="cpu")
    raise KeyError(kind)


def _packed(kind: str):
    j, _ = jax_jpg.parse_and_decode(_jpeg(kind), packed=True)
    c, k, v, nnz = j.packed
    j.packed = (c.copy(), k.copy(), v.copy(), nnz)
    return j


def _quant(j, comp: int) -> np.ndarray:
    return j.dqt[j.comps[comp].tq].astype(np.int32)


def _rand_coeff_blocks(rng, n, lo=-1024, hi=1024):
    blocks = rng.integers(lo, hi, size=(n, 8, 8)).astype(np.int16)
    mask = rng.random((n, 8, 8)) < 0.7
    mask[:, 0, 0] = False
    return np.where(mask, 0, blocks).astype(np.int16)


def _idct_case(case: str):
    rng = np.random.default_rng(5)
    if case == "random":
        return (_rand_coeff_blocks(rng, 512),
                rng.integers(1, 255, (8, 8)).astype(np.int32))
    if case == "extreme":                   # tests/test_idct.py:50
        blocks = np.full((4, 8, 8), 32767, np.int16)
        blocks[1] = -32768
        blocks[2, :, ::2] = -32768
        blocks[3, ::2, :] = 12345
        return blocks, np.full((8, 8), 255, np.int32)
    if case == "full_int16":
        return (rng.integers(-32768, 32768, (2048, 8, 8)).astype(np.int16),
                rng.integers(1, 65536, (8, 8)).astype(np.int32))
    raise KeyError(case)


def _jax_idct(blocks: np.ndarray, quant: np.ndarray) -> np.ndarray:
    return np.asarray(jax_jk.dequant_idct_blocks(jnp.asarray(blocks),
                                                 jnp.asarray(quant)))


def _port_idct(blocks: np.ndarray, quant: np.ndarray) -> np.ndarray:
    q = torch.from_numpy(quant.reshape(1, 64))
    out = jk.dequant_idct_blocks(torch.from_numpy(blocks)[None], q, q,
                                 blocks.shape[0])
    return out[0].numpy()


@pytest.mark.parametrize("case", ["random", "extreme", "full_int16"])
def test_dequant_idct_matches_jax(case):
    blocks, quant = _idct_case(case)
    np.testing.assert_array_equal(_port_idct(blocks, quant),
                                  _jax_idct(blocks, quant))


@pytest.mark.parametrize("case", ["random", "extreme", "full_int16",
                                  "q65535"])
def test_idct_evenodd_matches_jax(case):
    """The even/odd grouping of the K2 kernel, with its 32-bit wraps,
    gives JAX's bits, also at the largest table entry."""
    if case == "q65535":
        blocks, _ = _idct_case("full_int16")
        quant = np.full((8, 8), 65535, np.int32)
    else:
        blocks, quant = _idct_case(case)
    q = torch.from_numpy(quant.reshape(1, 64))
    got = testing.idct_evenodd(torch.from_numpy(blocks)[None], q, q,
                               blocks.shape[0])[0]
    np.testing.assert_array_equal(got.numpy(), _jax_idct(blocks, quant))


@pytest.mark.parametrize("name", sorted(testing.idct_cases()))
def test_idct_tiles_match_jax(name):
    """K2's tile edges (nblocks not a multiple of 32, the luma/chroma
    boundary inside, at and next to tile edges, N=1 and N=3 with their
    own tables): the plain version and the kernel's even/odd model
    against JAX, image by image, each part with its own table."""
    coeffs, yq, cq, n_luma = testing.idct_cases()[name]
    args = [torch.from_numpy(a) for a in (coeffs, yq, cq)]
    got = jk.dequant_idct_blocks(*args, n_luma).numpy()
    for i in range(coeffs.shape[0]):
        for sl, q in ((slice(0, n_luma), yq[i]), (slice(n_luma, None), cq[i])):
            if coeffs[i, sl].size:
                np.testing.assert_array_equal(
                    got[i, sl], _jax_idct(coeffs[i, sl], q.reshape(8, 8)))
    np.testing.assert_array_equal(
        testing.idct_evenodd(*args, n_luma).numpy(), got)


def test_dequant_idct_matches_pallas_interpret():
    from ffpic_tpu.ops.pallas_jpeg import (blocks_to_nlast,
                                           dequant_idct_pallas,
                                           nlast_to_blocks)
    rng = np.random.default_rng(1234)
    blocks = rng.integers(-512, 512, (600, 8, 8)).astype(np.int16)
    q = rng.integers(1, 64, (8, 8)).astype(np.int32)
    want = nlast_to_blocks(dequant_idct_pallas(
        blocks_to_nlast(blocks), jnp.asarray(q), interpret=True), 600)
    np.testing.assert_array_equal(_port_idct(blocks, q), want)


def test_dequant_idct_per_image_tables():
    """Each image's luma blocks take its own luma table and the rest its
    chroma table (a kernel that used image 0's table would fail)."""
    rng = np.random.default_rng(2)
    n, nb, n_luma = 3, 40, 24
    blocks = _rand_coeff_blocks(rng, n * nb).reshape(n, nb, 8, 8)
    yq = rng.integers(1, 255, (n, 64)).astype(np.int32)
    cq = rng.integers(1, 255, (n, 64)).astype(np.int32)
    got = jk.dequant_idct_blocks(torch.from_numpy(blocks),
                                 torch.from_numpy(yq), torch.from_numpy(cq),
                                 n_luma).numpy()
    for i in range(n):
        for sl, q in ((slice(0, n_luma), yq[i]), (slice(n_luma, nb), cq[i])):
            want = jax_jk.dequant_idct_blocks(jnp.asarray(blocks[i, sl]),
                                              jnp.asarray(q.reshape(8, 8)))
            np.testing.assert_array_equal(got[i, sl], np.asarray(want))


@pytest.mark.parametrize("kind", ["q85", "dri", "trailing_zero"])
def test_unpack_matches_jax(kind):
    j = _packed(kind)
    counts, ks, vals, nnz = j.packed
    if kind == "trailing_zero":
        assert counts[-64:].max() == 0 and counts[:64].max() > 0
    shapes = tuple((c.nby, c.nbx) for c in j.comps)
    want = jax_jk._unpack_coeffs(jnp.asarray(counts), jnp.asarray(ks),
                                 jnp.asarray(vals), jax_jpg.packed_block_map(j),
                                 shapes)
    got = jk.unpack_coeffs(torch.from_numpy(counts)[None],
                           torch.from_numpy(ks)[None],
                           torch.from_numpy(vals)[None],
                           tjpg.packed_block_map(j, "cpu"),
                           sum(a * b for a, b in shapes))[0]
    base = 0
    for (nby, nbx), w in zip(shapes, want):
        np.testing.assert_array_equal(
            got[base:base + nby * nbx].numpy(), np.asarray(w).reshape(-1, 8, 8))
        base += nby * nbx
    assert nnz == int(counts.sum())


def _hostile(rng, n, g, e):
    """Counts that run past E, zigzag positions past 63, random values,
    zero padding after the counts' total, a shuffled block map."""
    counts = rng.integers(0, 5, (n, g)).astype(np.uint8)
    counts[0, 7] = counts[1, g // 2] = 255
    ks = rng.integers(0, 256, (n, e)).astype(np.uint8)
    vals = rng.integers(-32768, 32768, (n, e)).astype(np.int16)
    total = counts.astype(np.int64).sum(1)
    for i in range(n):
        ks[i, total[i]:] = 0
        vals[i, total[i]:] = 0
    return counts, ks, vals, rng.permutation(g).astype(np.int32)


def test_unpack_hostile_matches_jax():
    rng = np.random.default_rng(3)
    n, g, e = 3, 1001, 2048
    counts, ks, vals, bmap = _hostile(rng, n, g, e)
    assert (counts.astype(np.int64).sum(1) < e).any()
    assert (counts.astype(np.int64).sum(1) > e).any()
    got = jk.unpack_coeffs(torch.from_numpy(counts), torch.from_numpy(ks),
                           torch.from_numpy(vals), torch.from_numpy(bmap), g)
    for i in range(n):
        (want,) = jax_jk._unpack_coeffs(
            jnp.asarray(counts[i]), jnp.asarray(ks[i]), jnp.asarray(vals[i]),
            jnp.asarray(bmap), ((g, 1),))
        np.testing.assert_array_equal(got[i].numpy(),
                                      np.asarray(want).reshape(g, 8, 8))


def test_unpack_ignores_padding_past_total():
    """Entries past the counts' total are padding; nonzero ones change
    nothing (the host always zeroes them)."""
    rng = np.random.default_rng(4)
    counts, ks, vals, bmap = _hostile(rng, 2, 300, 2048)
    args = [torch.from_numpy(a) for a in (counts, ks, vals, bmap)]
    clean = jk.unpack_coeffs(*args, 300)
    total = counts.astype(np.int64).sum(1)
    i = int(np.argmin(total))
    ks[i, total[i]:] = 9
    vals[i, total[i]:] = 77
    dirty = jk.unpack_coeffs(*[torch.from_numpy(a) for a in
                               (counts, ks, vals, bmap)], 300)
    assert torch.equal(clean, dirty)


def test_split_packed_odd_offset():
    """The vals region of a fused buffer may start at an odd byte."""
    rng = np.random.default_rng(6)
    n, g, e = 3, 1001, 2048
    assert n * (g + e) % 2 == 1
    buf = rng.integers(0, 256, n * (g + 3 * e)).astype(np.uint8)
    counts, ks, vals = jk.split_packed(torch.from_numpy(buf), n, g, e)
    want = np.frombuffer(buf[n * (g + e):].tobytes(), "<i2").reshape(n, e)
    np.testing.assert_array_equal(vals.numpy(), want)
    np.testing.assert_array_equal(counts.numpy(), buf[:n * g].reshape(n, g))
    np.testing.assert_array_equal(ks.numpy(),
                                  buf[n * g:n * (g + e)].reshape(n, e))
    np.testing.assert_array_equal(
        jk.count_starts(counts).numpy(),
        np.cumsum(counts.numpy(), 1) - counts.numpy())


@pytest.mark.parametrize("name", sorted(testing.scan_cases()))
def test_count_starts_matches_jax(name):
    """K1a's plain version against the reference's int32
    ``cumsum(counts) - counts``, per image."""
    counts, n, g = testing.scan_cases()[name]
    got = jk.count_starts(torch.from_numpy(counts).view(n, g)).numpy()
    for i, row in enumerate(counts.reshape(n, g)):
        c = jnp.asarray(row).astype(jnp.int32)
        np.testing.assert_array_equal(got[i], np.asarray(jnp.cumsum(c) - c))


@pytest.mark.parametrize("name", sorted(testing.scan_cases()))
def test_count_scan_ranges_partition_rows(name):
    """K1a's cut, run rank by rank on the CPU: the ranges of
    ``cuda_jpeg.count_scan_ranges`` cover [0, g) once, in rank order,
    and each rank's scan of its range, offset by the totals of the lower
    ranks, gives the plain count_starts."""
    counts, n, g = testing.scan_cases()[name]
    counts = torch.from_numpy(counts).view(n, g).to(torch.int64)
    ranges = cuda_jpeg.count_scan_ranges(n, g)
    assert ranges.shape == (n, cuda_jpeg.SCAN_CLUSTER, 2)
    assert (ranges[:, 0, 0] == 0).all() and (ranges[:, -1, 1] == g).all()
    assert torch.equal(ranges[:, 1:, 0], ranges[:, :-1, 1])
    assert (ranges[..., 0] <= ranges[..., 1]).all()
    got = torch.empty(n, g, dtype=torch.int64)
    for i in range(n):
        totals = [int(counts[i, lo:hi].sum()) for lo, hi in ranges[i].tolist()]
        for rank, (lo, hi) in enumerate(ranges[i].tolist()):
            seg = counts[i, lo:hi]
            got[i, lo:hi] = sum(totals[:rank]) + torch.cumsum(seg, 0) - seg
    assert torch.equal(got.to(torch.int32), jk.count_starts(counts))


def test_count_scan_ranges_word_aligned():
    """Inside a row every cut falls on a 16-byte word of the flat
    counts, so only the row's own edges are ragged."""
    n, g = 5, 4998
    ranges = cuda_jpeg.count_scan_ranges(n, g)
    flat = ranges + (torch.arange(n) * g)[:, None, None]
    inner = flat[:, 1:, 0][ranges[:, 1:, 0] < g]
    assert inner.numel() and (inner % 16 == 0).all()


def _split(case):
    buf, n, g, e, bmap = case
    counts, ks, vals = jk.split_packed(torch.from_numpy(buf), n, g, e)
    return counts, ks, vals, torch.from_numpy(bmap), n, g, e


@pytest.mark.parametrize("name", sorted(testing.unpack_cases()))
def test_unpack_tiles_match_plain(name):
    """K1b's decomposition, run tile by tile on the CPU: each CTA's entry
    range from ``cuda_jpeg.unpack_entry_ranges``, each entry given to
    the last block of its tile whose start is <= it, gives what the
    plain unpack_coeffs gives.  The ranges tile [0, min(total, E))."""
    counts, ks, vals, bmap, n, g, e = _split(testing.unpack_cases()[name])
    starts = jk.count_starts(counts).to(torch.int64)
    ranges = cuda_jpeg.unpack_entry_ranges(starts.to(torch.int32), counts, e)
    tiles = -(-g // cuda_jpeg.UNPACK_TILE)
    assert ranges.shape == (n, tiles, 2)
    end = (starts[:, -1] + counts[:, -1]).clamp(max=e)
    assert torch.equal(ranges[:, 0, 0], starts[:, 0].clamp(max=e))
    assert torch.equal(ranges[:, -1, 1], end)
    assert torch.equal(ranges[:, 1:, 0], ranges[:, :-1, 1])
    zz = torch.as_tensor(golden.ZIGZAG, dtype=torch.int64)
    acc = torch.zeros(n, g * 64, dtype=torch.int64)
    for i in range(n):
        for t in range(tiles):
            g0, g1 = t * cuda_jpeg.UNPACK_TILE, min(
                (t + 1) * cuda_jpeg.UNPACK_TILE, g)
            j = torch.arange(int(ranges[i, t, 0]), int(ranges[i, t, 1]))
            b = torch.searchsorted(starts[i, g0:g1], j, right=True) - 1
            assert (b >= 0).all()
            bm = bmap.to(torch.int64)[g0 + b]
            keep = (bm >= 0) & (bm < g)
            flat = bm * 64 + zz[ks[i, j].to(torch.int64).clamp(max=63)]
            acc[i].index_add_(0, flat[keep], vals[i, j].to(torch.int64)[keep])
    got = jk._wrap(acc, 16).to(torch.int16).view(n, g, 8, 8)
    assert torch.equal(got, jk.unpack_coeffs(counts, ks, vals, bmap, g))


@pytest.mark.parametrize("name", sorted(testing.assemble_cases()))
def test_assemble_color_crop_matches_jax(name):
    """The plain K3 with an output size: block grid to planes, nearest
    chroma repeat and colour on the cropped image, against JAX's
    color_convert (jitted) on the same planes, cropped."""
    samples, nby, nbx, (h, w) = testing.assemble_cases()[name]
    n = samples.shape[0]
    shapes = ((nby, nbx), (nby // 2, nbx // 2), (nby // 2, nbx // 2))
    ny, nc = nby * nbx, nby * nbx // 4

    def plane(blocks, by, bx):
        return blocks.reshape(n, by, bx, 8, 8).transpose(0, 1, 3, 2, 4) \
            .reshape(n, by * 8, bx * 8)

    yp = plane(samples[:, :ny], nby, nbx)
    up, vp = (plane(samples[:, ny + k * nc:ny + (k + 1) * nc], nby // 2,
                    nbx // 2).repeat(2, 1).repeat(2, 2) for k in (0, 1))
    for mode in MODES:
        want = np.asarray(jax.jit(functools.partial(
            jax_jk.color_convert, order="rgba", mode=mode))(
                yp[:, :h, :w], up[:, :h, :w], vp[:, :h, :w]))
        got = jk.assemble_color(torch.from_numpy(samples), shapes, "rgba",
                                mode, hw=(h, w))
        assert got.shape == (n, h, w, 4)
        np.testing.assert_array_equal(got.numpy(), want)


@functools.lru_cache(maxsize=1)
def _colour_inputs():
    """All 256^3 in-range (y, u, v) triples, then 2^20 random int16."""
    g = np.arange(256, dtype=np.int16)
    y, u, v = (a.reshape(-1) for a in np.meshgrid(g, g, g, indexing="ij"))
    rng = np.random.default_rng(7)
    r = rng.integers(-32768, 32768, (3, 1 << 20)).astype(np.int16)
    return tuple(np.concatenate([a, b]) for a, b in zip((y, u, v), r))


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("mode", MODES)
def test_color_convert_exhaustive(mode, order):
    """Against color_convert as every JAX caller runs it, inside a jit,
    where XLA fuses each product and sum into an FMA."""
    y, u, v = _colour_inputs()
    want = np.asarray(jax.jit(functools.partial(
        jax_jk.color_convert, order=order, mode=mode))(y, u, v))
    got = jk.color_convert(torch.from_numpy(y), torch.from_numpy(u),
                           torch.from_numpy(v), order=order, mode=mode)
    np.testing.assert_array_equal(got.numpy(), want)


def test_contraction_helper_is_exact_where_the_roundings_agree():
    """``testing.assert_equal_up_to_contraction`` takes JAX's value under
    either rounding, element by element, and nothing else: a 1-LSB error
    where fused and unfused colour agree fails, and so does a value next
    to both where they differ."""
    y, u, v = (torch.from_numpy(a) for a in _colour_inputs())
    run_all = functools.partial(jk.color_convert, y, u, v, "rgba",
                                "reference")
    fused = run_all()
    with testing.unfused_colour():
        unfused = run_all()
    differ = (fused != unfused).any(-1)
    assert 0 < int(differ.sum()) < differ.numel()
    pick = torch.cat([torch.nonzero(differ)[:, 0],
                      torch.nonzero(~differ)[:2000, 0]])
    y, u, v = y[pick], u[pick], v[pick]

    def run():
        return jk.color_convert(y, u, v, "rgba", "reference")

    fused, unfused = fused[pick], unfused[pick]
    testing.assert_equal_up_to_contraction(run, fused)
    testing.assert_equal_up_to_contraction(run, unfused)
    mixed = torch.where(torch.arange(len(pick))[:, None] % 2 == 0, fused,
                        unfused)
    testing.assert_equal_up_to_contraction(run, mixed)
    agree = int(torch.nonzero(((fused == unfused)
                               & (fused < 255))[:, 1])[-1])
    bad = fused.clone()
    bad[agree, 1] += 1
    with pytest.raises(AssertionError, match="1 of .* neither rounding"):
        testing.assert_equal_up_to_contraction(run, bad)
    k = int(torch.nonzero(fused[:, 1] != unfused[:, 1])[0])
    bad = fused.clone()
    bad[k, 1] = torch.maximum(fused[k, 1], unfused[k, 1]) + 1
    with pytest.raises(AssertionError, match="neither rounding"):
        testing.assert_equal_up_to_contraction(run, bad)


@pytest.mark.parametrize("samplings,mx,my,actual", [
    (((2, 2), (1, 1), (1, 1)), 14, 10, None),
    (((1, 1), (1, 1), (1, 1)), 9, 7, None),
    (((2, 1), (1, 1), (1, 1)), 5, 6, None),
    (((1, 1),), 12, 9, (9, 11)),
])
def test_mcu_block_map_matches_jax(samplings, mx, my, actual):
    want = np.asarray(jax_jk.mcu_block_map(samplings, mx, my, actual))
    got = tjpg.mcu_block_map(samplings, mx, my, actual)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_packed_block_map_is_a_cached_permutation():
    j = _packed("q85")
    bmap = tjpg.packed_block_map(j, "cpu")
    nblocks = sum(c.nby * c.nbx for c in j.comps)
    assert bmap.dtype == torch.int32
    assert torch.equal(torch.sort(bmap).values,
                       torch.arange(nblocks, dtype=torch.int32))
    assert tjpg.packed_block_map(j, "cpu") is bmap


def test_stack_packed_fused_matches_jax():
    packed = [_packed(k).packed for k in ("q50", "q85", "q95")]
    buf, g, e = jk.stack_packed_fused(packed)
    wbuf, wg, we = jax_jk.stack_packed_fused(packed)
    assert (g, e) == (wg, we)
    np.testing.assert_array_equal(buf, wbuf)


@pytest.mark.parametrize("mode", ["bt601", "reference"])
def test_decode_batch_420_packed_fused_matches_jax(mode):
    """N=3 of mixed quality through the fused route, exact."""
    js = [_packed(k) for k in ("q50", "q85", "q95")]
    shapes = tuple((c.nby, c.nbx) for c in js[0].comps)
    buf, g, e = jax_jk.stack_packed_fused([j.packed for j in js])
    bmap = jax_jpg.packed_block_map(js[0])
    yq = np.stack([_quant(j, 0).reshape(8, 8) for j in js])[:, None, None]
    cq = np.stack([_quant(j, 1).reshape(8, 8) for j in js])[:, None, None]
    assert not np.array_equal(yq[0], yq[2])
    want = jax_jk.decode_batch_420_packed_fused(
        jnp.asarray(buf), bmap, jnp.asarray(yq), jnp.asarray(cq), 3, g, e,
        shapes, order="rgba", mode=mode)
    tbuf, tmap, tyq, tcq = jk.from_jax_inputs(buf, bmap, yq, cq, "cpu")
    assert tyq.shape == (3, 64) and tyq.dtype == torch.int32
    testing.assert_equal_up_to_contraction(
        lambda: jk.decode_batch_420_packed_fused(
            tbuf, tmap, tyq, tcq, 3, g, e, shapes, order="rgba", mode=mode),
        want)


def test_decode_batch_420_packed_fused_crop_matches_jax():
    """N=3 through the fused route, written straight at the images'
    own size (151x219 inside the 160x224 grid), exact."""
    js = [_packed(k) for k in ("q50", "q85", "q95")]
    shapes = tuple((c.nby, c.nbx) for c in js[0].comps)
    buf, g, e = jax_jk.stack_packed_fused([j.packed for j in js])
    bmap = jax_jpg.packed_block_map(js[0])
    yq = np.stack([_quant(j, 0).reshape(8, 8) for j in js])[:, None, None]
    cq = np.stack([_quant(j, 1).reshape(8, 8) for j in js])[:, None, None]
    want = jax_jk.decode_batch_420_packed_fused(
        jnp.asarray(buf), bmap, jnp.asarray(yq), jnp.asarray(cq), 3, g, e,
        shapes, order="bgra", mode="bt601")
    tbuf, tmap, tyq, tcq = jk.from_jax_inputs(buf, bmap, yq, cq, "cpu")
    testing.assert_equal_up_to_contraction(
        lambda: jk.decode_batch_420_packed_fused(
            tbuf, tmap, tyq, tcq, 3, g, e, shapes, order="bgra",
            mode="bt601", hw=(151, 219)),
        np.asarray(want)[:, :151, :219])


def test_decode_batch_420_dense_matches_jax():
    """Dense coefficient planes (the progressive route's input), exact."""
    js = []
    for k in ("q50", "q95"):
        j, _ = jax_jpg.parse_and_decode(_jpeg(k))
        js.append(j)
    (nby, nbx), (cy, cx), _ = shapes = tuple((c.nby, c.nbx)
                                             for c in js[0].comps)
    ycoef = np.stack([j.coeffs[0].reshape(nby, nbx, 8, 8) for j in js])
    ucoef = np.stack([j.coeffs[1].reshape(cy, cx, 8, 8) for j in js])
    vcoef = np.stack([j.coeffs[2].reshape(cy, cx, 8, 8) for j in js])
    yq = np.stack([_quant(j, 0).reshape(8, 8) for j in js])[:, None, None]
    cq = np.stack([_quant(j, 1).reshape(8, 8) for j in js])[:, None, None]
    want = jax_jk.decode_batch_420(*map(jnp.asarray, (ycoef, ucoef, vcoef,
                                                       yq, cq)),
                                   order="bgra", mode="reference")
    coeffs = np.concatenate([a.reshape(2, -1, 8, 8)
                             for a in (ycoef, ucoef, vcoef)], axis=1)
    testing.assert_equal_up_to_contraction(
        lambda: jk.decode_batch_420_dense(
            torch.from_numpy(coeffs), torch.from_numpy(yq.reshape(2, 64)),
            torch.from_numpy(cq.reshape(2, 64)), shapes, order="bgra",
            mode="reference"),
        want)


@functools.lru_cache(maxsize=1)
def _scatter_cases():
    return testing.scatter_cases()


def _jax_planes(planes, n, sizes):
    """The reference's ``_scatter_plane`` of each plane, stacked as its
    ``decode_batch_420_sparse`` stacks them: (n, sum(sizes), 8, 8)."""
    return np.concatenate([
        np.asarray(jax_jk._scatter_plane(jnp.asarray(i), jnp.asarray(v),
                                         (n, nb, 1))).reshape(n, nb, 8, 8)
        for (i, v), nb in zip(planes, sizes)], axis=1)


@pytest.mark.parametrize("name", sorted(testing.scatter_cases()))
def test_scatter_plane_matches_jax(name):
    """K8's plain version, a plane at a time and over all planes at once
    (``scatter_planes``), against the reference's ``_scatter_plane``:
    packed pairs with their (0, 0) padding, duplicates whose sums wrap,
    negative and out-of-range indices (one in [-n, 0) lands at idx + n,
    the rest are dropped), the int32 extremes, an odd count, three
    planes crowded at the edges of images, units and planes, and three
    shuffled planes of the 8 x 1080p batch's sizes."""
    planes, n, sizes = _scatter_cases()[name]
    want = _jax_planes(planes, n, sizes)
    cut = np.cumsum([0, *sizes])
    for (idx, val), nb, a, b in zip(planes, sizes, cut[:-1], cut[1:]):
        got = jk.scatter_plane(torch.from_numpy(idx), torch.from_numpy(val),
                               (n, nb))
        assert got.dtype == torch.int16 and got.shape == (n, nb, 8, 8)
        np.testing.assert_array_equal(got.numpy(), want[:, a:b])
    got = jk.scatter_planes([(torch.from_numpy(i), torch.from_numpy(v))
                             for i, v in planes], n, sizes)
    assert got.shape == (n, int(cut[-1]), 8, 8)
    np.testing.assert_array_equal(got.numpy(), want)


SCATTER_UNIT = 4096     # K8's kScatterUnit (csrc/jpeg_decode.cu)


def _keys(idx, val, total):
    """K8's key of each pair: its flat index (one in [-total, 0) taken
    as idx + total), or ``total`` for a zero value or a dropped index."""
    i = idx.astype(np.int64)
    i = np.where(i < 0, i + total, i)
    return np.where((val == 0) | (i < 0) | (i >= total), total, i)


def _k8_model(planes, n, sizes, ctas):
    """K8 (``scatter_planes_kernel``) in numpy on a grid of ``ctas``
    CTAs: each plane's units of SCATTER_UNIT coefficients, the plane's
    CTAs and each one's even run of them, its slice of pairs from the warp's 32-ary search (the first
    pair of its run, of the unit after it, of the plane's tail), and its
    checks: every key of the slice in its run, the keys not decreasing
    from the pair before the slice to its end, every key of its share of
    the tail ``total``.  Returns (whether a check failed, the planes as
    the kernel leaves them): the fast path's sums, or, when a check
    failed, the general path's, which are the plain version's."""
    def lower_bound(k, t):
        lo, hi = 0, len(k)
        while hi - lo > 32:
            s = (hi - lo + 31) >> 5
            at = np.minimum(lo + s * np.arange(1, 33), hi) - 1
            ge = np.flatnonzero(k[at] >= t)
            if not ge.size:
                return hi
            j = int(ge[0])
            hi = min(lo + s * (j + 1), hi) - 1
            lo += s * j
        ge = [e for e in range(lo, hi) if k[e] >= t]
        return ge[0] if ge else hi

    totals = [n * nb * 64 for nb in sizes]
    keys = [_keys(i, v, t) for (i, v), t in zip(planes, totals)]
    first = np.cumsum([0] + [-(-t // SCATTER_UNIT) for t in totals])
    # the launcher's CTAs a plane: in proportion to 3 a pair and 1 a
    # coefficient, one at least, a unit each at most, the largest cut
    # back until they fit the grid
    work = [3 * len(i) + t for (i, _), t in zip(planes, totals)]
    g = [max(1, min(int(first[c + 1] - first[c]),
                    int(ctas * w / sum(work))))
         for c, w in enumerate(work)]
    while sum(g) > ctas:
        g[int(np.argmax(g))] -= 1
    accs = [np.zeros(t, np.int64) for t in totals]
    bad = False
    for c, (k, (idx, val), total) in enumerate(zip(keys, planes, totals)):
        uc = int(first[c + 1] - first[c])
        for i in range(g[c]):
            ua = first[c] + uc * i // g[c]
            ub = first[c] + uc * (i + 1) // g[c]
            q_lo = (ua - first[c]) * SCATTER_UNIT
            q_hi = min((ub - first[c]) * SCATTER_UNIT, total)
            a, z = lower_bound(k, q_lo), lower_bound(k, q_hi)
            t0 = lower_bound(k, total)
            sl = k[a:z]
            bad |= bool(((sl < q_lo) | (sl >= q_hi)).any())
            e = np.arange(max(a - 1, 0), max(z - 1, 0))
            bad |= bool((k[e] > k[e + 1]).any())
            m = sl < total
            np.add.at(accs[c], sl[m], val[a:z][m].astype(np.int64))
            share = -(-(len(k) - t0) // uc)
            lo = t0 + (ua - first[c]) * share
            hi = min(len(k), t0 + (ub - first[c]) * share)
            bad |= bool((k[lo:hi] < total).any())
    if bad:
        return True, _jax_planes(planes, n, sizes)
    return False, np.concatenate([a.astype(np.int16).reshape(n, nb, 8, 8)
                                  for a, nb in zip(accs, sizes)], axis=1)


@pytest.mark.parametrize("name", sorted(testing.scatter_cases()))
def test_scatter_planes_kernel_model_matches_jax(name):
    """K8's design, modelled in numpy (``_k8_model``) on grids of 3, 7
    and 1,056 CTAs, against the reference: its checks fail exactly when
    a plane's keys are out of order (so the host's pairs always take the
    fast path, and shuffled, duplicated or hostile ones the general
    path), and the fast path's slices sum to the reference's planes."""
    planes, n, sizes = _scatter_cases()[name]
    unsorted = any(bool((np.diff(_keys(i, v, n * nb * 64)) < 0).any())
                   for (i, v), nb in zip(planes, sizes))
    assert unsorted == (name not in ("packed", "straddle"))
    want = _jax_planes(planes, n, sizes)
    for ctas in (3, 7, 1056):
        bad, got = _k8_model(planes, n, sizes, ctas)
        assert bad == unsorted
        np.testing.assert_array_equal(got, want)


def test_scatter_plane_index_semantics():
    """What the reference's scatter does at the edges, found by running
    it: -1 is the last coefficient, -n the first, -n-1 and n are
    dropped, and two adds of 30000 wrap."""
    idx = np.array([0, 0, -128, -1, 127, -129, 128], np.int32)
    val = np.array([30000, 30000, 13, 11, 37, 5, 7], np.int16)
    want = np.zeros(128, np.int64)
    want[0], want[127] = 60013 - 65536, 48
    for out in (np.asarray(jax_jk._scatter_plane(jnp.asarray(idx),
                                                 jnp.asarray(val),
                                                 (2, 1, 1))),
                jk.scatter_plane(torch.from_numpy(idx), torch.from_numpy(val),
                                 (2, 1)).numpy()):
        np.testing.assert_array_equal(out.reshape(-1), want)


@pytest.mark.parametrize("minimum", [2048, 16])
def test_pack_coeffs_matches_jax(minimum):
    rng = np.random.default_rng(8)
    plane = rng.integers(-50, 50, (2, 30, 40, 8, 8)).astype(np.int16)
    plane[rng.random(plane.shape) < 0.9] = 0
    got = jk.pack_coeffs(plane, minimum)
    want = jax_jk.pack_coeffs(plane, minimum)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[0].size == jk._bucket(int((plane != 0).sum()), minimum)


@pytest.mark.parametrize("mode", ["bt601", "reference", "rgb"])
def test_decode_batch_420_sparse_matches_jax(mode):
    """Dense planes of two qualities packed by ``pack_coeffs``, through
    the sparse route, against the reference's sparse route (the colour
    up to XLA's contraction choice) and, exactly, the port's dense
    route."""
    js = [jax_jpg.parse_and_decode(_jpeg(k))[0] for k in ("q50", "q95")]
    (nby, nbx), (cy, cx), _ = shapes = tuple((c.nby, c.nbx)
                                             for c in js[0].comps)
    planes = [np.stack([j.coeffs[c].reshape(a, b, 8, 8) for j in js])
              for c, (a, b) in enumerate(shapes)]
    yq = np.stack([_quant(j, 0) for j in js])
    cq = np.stack([_quant(j, 1) for j in js])
    packed = [jk.pack_coeffs(p) for p in planes]
    want = jax_jk.decode_batch_420_sparse(
        packed, tuple((2, a, b) for a, b in shapes),
        jnp.asarray(yq.reshape(2, 1, 1, 8, 8)),
        jnp.asarray(cq.reshape(2, 1, 1, 8, 8)), order="rgba", mode=mode)
    args = ([(torch.from_numpy(i), torch.from_numpy(v)) for i, v in packed],
            2, shapes, torch.from_numpy(yq), torch.from_numpy(cq))
    testing.assert_equal_up_to_contraction(
        lambda: jk.decode_batch_420_sparse(*args, order="rgba", mode=mode),
        want)
    dense = torch.from_numpy(np.concatenate([p.reshape(2, -1, 8, 8)
                                             for p in planes], axis=1))
    assert torch.equal(
        jk.decode_batch_420_sparse(*args, order="rgba", mode=mode,
                                   hw=(151, 219)),
        jk.decode_batch_420_dense(dense, *args[3:], shapes, order="rgba",
                                  mode=mode, hw=(151, 219)))


@pytest.mark.parametrize("call", [
    lambda t: cuda_jpeg.count_scan(t.flatten().to(torch.uint8), 1, 64),
    lambda t: cuda_jpeg.unpack(t.flatten().to(torch.uint8),
                               torch.zeros(1, 64, dtype=torch.int32),
                               torch.arange(64, dtype=torch.int32), 1, 64, 0,
                               64),
    lambda t: cuda_jpeg.dequant_idct(t, torch.ones(1, 64, dtype=torch.int32),
                                     torch.ones(1, 64, dtype=torch.int32), 1),
    lambda t: cuda_jpeg.assemble_color(t, 4, 8),
    lambda t: cuda_jpeg.assemble_mcu(t[0], ((4, 4), (2, 4), (2, 4)),
                                     ((1, 1), (2, 1), (2, 1)), 32, 32),
    lambda t: cuda_jpeg.fdct(t),
    lambda t: cuda_jpeg.scatter_plane(torch.zeros(4, dtype=torch.int32),
                                      torch.zeros(4, dtype=torch.int16), t),
    lambda t: cuda_jpeg.scatter_planes(
        [(torch.zeros(4, dtype=torch.int32),
          torch.zeros(4, dtype=torch.int16))] * 3, t, [32, 8, 8]),
], ids=["count_scan", "unpack", "dequant_idct", "assemble_color",
        "assemble_mcu", "fdct", "scatter_plane", "scatter_planes"])
def test_cuda_wrappers_refuse_cpu_tensors(call):
    t = torch.zeros(1, 48, 8, 8, dtype=torch.int16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        call(t)


@pytest.mark.parametrize("n,g", [(0, 6), (65536, 6), (1, 0)])
def test_count_scan_refuses_what_its_grid_cannot_take(n, g):
    buf = torch.zeros(16, dtype=torch.uint8)
    with pytest.raises(ValueError, match="one launch takes"):
        cuda_jpeg.count_scan(buf, n, g)


def test_dequant_idct_refuses_more_images_than_its_grid():
    q = torch.ones(65536, 64, dtype=torch.int32)
    with pytest.raises(ValueError, match="one launch takes"):
        cuda_jpeg.dequant_idct(torch.zeros(65536, 0, 8, 8, dtype=torch.int16),
                               q, q, 0)


def test_dispatch_refuses_other_devices():
    t = torch.zeros(1, 6, 8, 8, dtype=torch.int16, device="meta")
    q = torch.ones(1, 64, dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        jk.decode_batch_420_dense(t, q, q, ((2, 2), (1, 1), (1, 1)))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc: the build raises, nothing falls back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library_path()
