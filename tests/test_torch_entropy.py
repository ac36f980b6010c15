"""ffpic_tpu_torch.ops.jpeg_entropy_device (CPU, plain versions) against
ffpic_tpu.ops.jpeg_entropy_device on the same inputs.

Exact throughout: the copied numpy helpers give equal arrays; the plain
loops give JAX's coefficients (``flat[:-1]``; the trailing dump slot
holds only JAX's garbage), JAX's step count (the maximum of the port's
per-lane counts) and every output of the speculative passes; the
speculative decoder raises ValueError exactly when JAX's does.  The
edge cases that the CUDA kernels are held to on the card
(``testing.entropy_cases``) run here through the plain versions against
JAX, and their properties are checked from the host decoder's
coefficients.
"""

import functools
import io

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp
from ffpic_tpu.formats import jpg as jax_jpg
from ffpic_tpu.ops import jpeg_entropy_device as J
from ffpic_tpu_torch import testing
from ffpic_tpu_torch.formats import jpg
from ffpic_tpu_torch.ops import jpeg_entropy_device as P
from ffpic_tpu_torch.ops.golden import ZIGZAG
import reference_native  # noqa: F401  (readies ffpic_tpu first)


@functools.lru_cache(maxsize=None)
def _pil(h=96, w=128, quality=85, rows=0, blocks=0, opt=False, seed=0):
    """A baseline 4:2:0 JPEG written by PIL (restart markers every
    ``rows`` MCU rows or ``blocks`` MCUs), as the reference's tests make
    them."""
    rng = np.random.default_rng(seed)
    arr = np.kron(rng.integers(0, 256, (h // 16, w // 16, 3)),
                  np.ones((16, 16, 1))).astype(np.uint8)
    arr = np.clip(arr.astype(int) + rng.integers(-20, 20, arr.shape), 0,
                  255).astype(np.uint8)
    kw = {}
    if rows:
        kw["restart_marker_rows"] = rows
    if blocks:
        kw["restart_marker_blocks"] = blocks
    b = io.BytesIO()
    Image.fromarray(arr).save(b, "JPEG", quality=quality, subsampling="4:2:0",
                              optimize=opt, **kw)
    return b.getvalue()


def _both_heads(data):
    return (jax_jpg.parse_and_decode(data, skip_decode=True)[0],
            jpg.parse_and_decode(data, skip_decode=True)[0])


def _host_coeffs(data) -> np.ndarray:
    j, _ = jpg.parse_and_decode(data)
    return np.concatenate([c.reshape(-1) for c in j.coeffs])


# --- the copied numpy helpers ----------------------------------------------

@pytest.mark.parametrize("opt", [False, True])
def test_luts_and_frame_match_jax(opt):
    data = _pil(quality=75, rows=1, opt=opt, seed=3)
    jj, pj = _both_heads(data)
    for (tc, th), (counts, syms) in jj.dht_raw.items():
        np.testing.assert_array_equal(
            P.build_lut16(counts, syms, tc == 1),
            J.build_lut16(counts, syms, tc == 1))
    np.testing.assert_array_equal(P.build_luts_from_dht(pj.dht_raw),
                                  J.build_luts_from_dht(jj.dht_raw))
    for _ in range(2):                  # built, then from the cache
        np.testing.assert_array_equal(P.luts_for(pj),
                                      J.build_luts_from_dht(jj.dht_raw))
    want, got = J.prepare_frame(jj), P.prepare_frame(pj)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    assert P.extract_scan(data) == J.extract_scan(data)


def test_luts_without_chroma_tables_match_jax():
    gray = testing.encode_jpeg(testing.synth_rgb(32, 48, 1)[..., 0], 80,
                               ((1, 1),))
    jj, pj = _both_heads(gray)
    np.testing.assert_array_equal(P.build_luts_from_dht(pj.dht_raw),
                                  J.build_luts_from_dht(jj.dht_raw))


@pytest.mark.parametrize("n", [1, 3, 4, 1001])
def test_sliding_u32_matches_jax(n):
    buf = np.random.default_rng(n).integers(0, 256, n).astype(np.uint8)
    np.testing.assert_array_equal(P.sliding_u32(buf), J.sliding_u32(buf))


def _progressive():
    b = io.BytesIO()
    Image.fromarray(testing.synth_rgb(64, 96, 1)).save(
        b, "JPEG", quality=80, progressive=True)
    return b.getvalue()


@pytest.mark.parametrize("name", ["dri_rows", "dri_blocks_opt", "plain",
                                  "plain_opt", "444_dri", "progressive",
                                  "gray", "cr_table_dri"])
def test_eligibility_and_keys_match_jax(name):
    data = {
        "dri_rows": lambda: _pil(rows=1),
        "dri_blocks_opt": lambda: _pil(blocks=4, opt=True),
        "plain": lambda: _pil(),
        "plain_opt": lambda: _pil(opt=True, seed=2),
        "444_dri": lambda: testing.encode_jpeg(
            testing.synth_rgb(32, 48, 1), 80, testing.SAMPLINGS["444"],
            restart_interval=2),
        "progressive": _progressive,
        "gray": lambda: testing.encode_jpeg(
            testing.synth_rgb(32, 48, 1)[..., 0], 80, ((1, 1),),
            restart_interval=3),
        "cr_table_dri": lambda: testing.encode_jpeg(
            testing.synth_rgb(32, 48, 1), 80, cr_quality=30,
            restart_interval=3),
    }[name]()
    jj, pj = _both_heads(data)
    assert P.eligible(pj) == J.eligible(jj)
    assert P.spec_eligible(pj) == J.spec_eligible(jj)
    assert P.group_key(pj) == J.group_key(jj)
    assert P.spec_group_key(pj) == J.spec_group_key(jj)


# --- decode_lanes_bmap -------------------------------------------------------

@pytest.mark.parametrize("quality,rows", [(85, 1), (95, 1), (30, 2), (85, 4)])
def test_decode_coeffs_device_matches_jax(quality, rows):
    data = _pil(quality=quality, rows=rows, seed=quality + rows)
    want, _js, _c, wsteps = J.decode_coeffs_device([data, data])
    got, _js, _c, steps = P.decode_coeffs_device([data, data], device="cpu")
    np.testing.assert_array_equal(got[:-1].numpy(), np.asarray(want)[:-1])
    assert int(steps.max()) == int(wsteps)
    host = _host_coeffs(data)
    np.testing.assert_array_equal(got[:host.size].numpy(), host)


def test_decode_coeffs_device_mixed_matches_jax():
    """Mixed sizes and mixed Huffman tables (optimize=True) in one
    launch: each image's section equals JAX's, though the port lays the
    images out geometry group by geometry group."""
    datas = [_pil(64, 96, 85, blocks=4), _pil(128, 80, 70, blocks=4, opt=True),
             _pil(96, 96, 92, blocks=4, opt=True, seed=5),
             _pil(48, 48, 80, blocks=4), _pil(64, 96, 60, blocks=4, seed=7)]
    jjs = [jax_jpg.parse_and_decode(d, skip_decode=True)[0] for d in datas]
    pjs = [jpg.parse_and_decode(d, skip_decode=True)[0] for d in datas]
    want, woff, wsteps = J.decode_coeffs_device_mixed(datas, jjs)
    got, off, steps = P.decode_coeffs_device_mixed(datas, pjs, device="cpu")
    want = np.asarray(want)
    assert off != woff                          # grouped by geometry
    for i, d in enumerate(datas):
        n = _host_coeffs(d).size
        np.testing.assert_array_equal(got[off[i]:off[i] + n].numpy(),
                                      want[woff[i]:woff[i] + n])
        np.testing.assert_array_equal(got[off[i]:off[i] + n].numpy(),
                                      _host_coeffs(d))
    assert int(steps.max()) == int(wsteps)


def _jax_lanes(st, lanes, out_size, bpm):
    """JAX's decode_lanes_bmap over the port's staged inputs and lane
    table."""
    c = lanes.numpy()
    flat, steps = J.decode_lanes_bmap(
        jnp.asarray(st.u32win.numpy().astype(np.uint32)),
        jnp.asarray(st.luts.numpy().view(np.uint32)),
        jnp.asarray(st.zz.numpy()), jnp.asarray(st.comp_of_sub.numpy()),
        jnp.asarray(st.tclass_of_sub.numpy()), jnp.asarray(st.bmap.numpy()),
        *(jnp.asarray(c[:, i]) for i in range(4)), bpm, out_size, 1 << 22,
        lut_idx=jnp.asarray(c[:, 4]), bmap_base=jnp.asarray(c[:, 5]),
        k0=jnp.asarray(c[:, 6]), sub0=jnp.asarray(c[:, 7]),
        pred0=jnp.asarray(c[:, 8:11]), bit_stop=jnp.asarray(c[:, 11]))
    return np.asarray(flat), int(steps)


def _stage_spec(datas, chunk):
    """The port's staged inputs of a speculative decode and its chunk
    table, as ``spec_stages`` makes them."""
    pj = jpg.parse_and_decode(datas[0], skip_decode=True)[0]
    consts = P.prepare_frame(pj)
    concat, offs, _b = P._destuff(datas)
    st = P.Staged(concat, P.build_luts_from_dht(pj.dht_raw), consts,
                  consts["bmap"], torch.device("cpu"))
    bit0, bit_end, lane_img = P.spec_chunks(
        np.diff([*offs, len(concat)]), chunk)
    return st, consts, bit0, bit_end, lane_img


def test_decode_lanes_bmap_mid_mcu_entry_matches_jax():
    """The emission lanes of a speculative decode start mid-MCU (nonzero
    k0, sub0 and DC predictors) and stop at bit_stop: the plain loop
    gives JAX's coefficients and step count on them."""
    case = testing.entropy_cases()["spec_mid_mcu"]
    r = P.spec_stages(case["datas"], case["chunk_bytes"], device="cpu")
    lanes = r["lanes"]
    assert bool(r["ok"])
    assert (lanes[:, 6] != 0).any() and (lanes[:, 7] != 0).any()
    assert (lanes[:, 8:11] != 0).any() and (lanes[:, 11] < P.NO_STOP).all()
    st, consts, *_ = _stage_spec(case["datas"], case["chunk_bytes"])
    out_size = r["flat"].numel()
    flat, steps = P.decode_lanes(st, lanes, r["plan"], out_size)
    want, wsteps = _jax_lanes(st, lanes, out_size, consts["bpm"])
    np.testing.assert_array_equal(flat[:-1].numpy(), want[:-1])
    assert int(steps.max()) == wsteps
    assert torch.equal(flat, r["flat"])


# --- the speculative passes --------------------------------------------------

def test_spec_passes_match_jax():
    """spec_snap_lanes, spec_scan_lanes (from the guessed entries and
    from shifted ones) and spec_merge_lanes: every output equal."""
    data = testing.encode_jpeg(testing.synth_rgb(128, 160, 6), 75)
    st, consts, bit0, bit_end, lane_img = _stage_spec([data, data], 512)
    bpm = consts["bpm"]
    u32 = jnp.asarray(st.u32win.numpy().astype(np.uint32))
    luts = jnp.asarray(st.luts.numpy().view(np.uint32))
    cos = jnp.asarray(st.comp_of_sub.numpy())
    tos = jnp.asarray(st.tclass_of_sub.numpy())
    b0, be = torch.from_numpy(bit0), torch.from_numpy(bit_end)
    snap = P.spec_snap_lanes(st.u32win, st.luts, st.comp_of_sub,
                             st.tclass_of_sub, b0, be, bpm)
    wsnap = J.spec_snap_lanes(u32, luts, cos, tos,
                              jnp.asarray(bit0, jnp.int32),
                              jnp.asarray(bit_end, jnp.int32), jnp.int32(bpm))
    for k, (lo, hi) in enumerate(((0, 1), (1, 2), (2, 3), (3, 4), (4, 7))):
        np.testing.assert_array_equal(
            snap[..., lo:hi].numpy().reshape(np.asarray(wsnap[k]).shape),
            np.asarray(wsnap[k]))
    rng = np.random.default_rng(0)
    k0 = rng.integers(0, 64, len(bit0))
    sub0 = rng.integers(0, bpm, len(bit0))
    for kk, ss in ((np.zeros_like(k0), np.zeros_like(k0)), (k0, sub0)):
        got = P.spec_scan_lanes(st.u32win, st.luts, st.comp_of_sub,
                                st.tclass_of_sub, b0, be, torch.from_numpy(kk),
                                torch.from_numpy(ss), bpm, 1 << 22)
        want = J.spec_scan_lanes(u32, luts, cos, tos,
                                 jnp.asarray(bit0, jnp.int32),
                                 jnp.asarray(bit_end, jnp.int32),
                                 jnp.asarray(kk, jnp.int32),
                                 jnp.asarray(ss, jnp.int32), jnp.int32(bpm),
                                 1 << 22)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # merge from the predecessors' exits, and from entries one bit off
    # (another trajectory, which self-synchronises too)
    eb, ek, es = (t.numpy() for t in got[:3])
    first = np.r_[True, lane_img[1:] != lane_img[:-1]]
    for shift in (0, 1):
        ent = [np.where(first, bit0, np.roll(eb, 1)) + shift,
               np.where(first, 0, np.roll(ek, 1)),
               np.where(first, 0, np.roll(es, 1))]
        got = P.spec_merge_lanes(st.u32win, st.luts, st.comp_of_sub,
                                 st.tclass_of_sub,
                                 *(torch.from_numpy(e) for e in ent), bpm,
                                 snap)
        want = J.spec_merge_lanes(u32, luts, cos, tos,
                                  *(jnp.asarray(e, jnp.int32) for e in ent),
                                  jnp.int32(bpm), *wsnap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("chunk", [512, 1024, 4096])
def test_decode_coeffs_device_spec_matches_jax(chunk):
    data = _pil(quality=85, seed=77)
    want, *_ = J.decode_coeffs_device_spec([data, data], chunk_bytes=chunk,
                                           unroll=2)
    got, _js, _c, lanes = P.decode_coeffs_device_spec(
        [data, data], chunk_bytes=chunk, device="cpu")
    np.testing.assert_array_equal(got[:-1].numpy(), np.asarray(want)[:-1])
    host = _host_coeffs(data)
    np.testing.assert_array_equal(got[:host.size].numpy(), host)


@pytest.mark.parametrize("quality,seed", [(95, 80), (85, 81)])
def test_spec_fallback_contract_matches_jax(quality, seed):
    """256-byte chunks: the port raises ValueError exactly when JAX does,
    and otherwise gives JAX's (and the host decoder's) coefficients."""
    data = _pil(quality=quality, seed=seed)
    try:
        want = np.asarray(J.decode_coeffs_device_spec(
            [data], chunk_bytes=256, unroll=2)[0])
    except ValueError:
        want = None
    if want is None:
        with pytest.raises(ValueError, match="self-synchronize"):
            P.decode_coeffs_device_spec([data], chunk_bytes=256,
                                        device="cpu")
        return
    got = P.decode_coeffs_device_spec([data], chunk_bytes=256,
                                      device="cpu")[0]
    np.testing.assert_array_equal(got[:-1].numpy(), want[:-1])


def test_spec_fallback_contract_raises_on_one_case():
    """At least one of the contract cases takes the fallback in both."""
    data = _pil(quality=95, seed=80)
    with pytest.raises(ValueError):
        J.decode_coeffs_device_spec([data], chunk_bytes=256, unroll=2)
    with pytest.raises(ValueError):
        P.decode_coeffs_device_spec([data], chunk_bytes=256, device="cpu")


# --- the kernels' edge cases, through the plain versions ---------------------

CASES = testing.entropy_cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_entropy_cases_match_jax(name):
    """Each edge case's stage outputs (``testing.entropy_stages`` on the
    CPU) against JAX's functions on the same inputs."""
    case = CASES[name]
    got = testing.entropy_stages(case, "cpu")
    datas = case["datas"]
    if case["kind"] == "dri":
        jjs = [jax_jpg.parse_and_decode(d, skip_decode=True)[0]
               for d in datas]
        want, woff, wsteps = J.decode_coeffs_device_mixed(datas, jjs)
        pjs = [jpg.parse_and_decode(d, skip_decode=True)[0] for d in datas]
        _f, off, _s = P.decode_coeffs_device_mixed(datas, pjs, device="cpu")
        want = np.asarray(want)
        for i, j in enumerate(pjs):
            n = P.prepare_frame(j)["comp_space"] * 64
            np.testing.assert_array_equal(
                got["flat"][off[i]:off[i] + n].numpy(),
                want[woff[i]:woff[i] + n])
        assert int(got["steps"].max()) == int(wsteps)
        return
    st, consts, bit0, bit_end, lane_img = _stage_spec(datas,
                                                      case["chunk_bytes"])
    L = len(bit0)
    starts = np.searchsorted(lane_img, np.arange(len(datas)))
    lasts = np.concatenate([starts[1:], [L]]) - 1
    first = np.zeros(L, bool)
    first[starts] = True
    out_size = len(datas) * consts["comp_space"] * 64 + 1
    wflat, wok = J.spec_decode_full(
        jnp.asarray(st.u32win.numpy().astype(np.uint32)),
        jnp.asarray(st.luts.numpy().view(np.uint32)),
        jnp.asarray(st.zz.numpy()), jnp.asarray(st.comp_of_sub.numpy()),
        jnp.asarray(st.tclass_of_sub.numpy()), jnp.asarray(st.bmap.numpy()),
        jnp.asarray(bit0, jnp.int32), jnp.asarray(bit_end, jnp.int32),
        jnp.asarray(first), jnp.asarray(starts[lane_img], jnp.int32),
        jnp.asarray(lasts[lane_img], jnp.int32),
        jnp.asarray(lane_img * consts["comp_space"] * 64, jnp.int32),
        consts["bpm"], out_size, consts["blocks_per_img"], 1 << 22, 1)
    assert bool(got["ok"]) == bool(wok)
    np.testing.assert_array_equal(got["flat"][:-1].numpy(),
                                  np.asarray(wflat)[:-1])
    # the plain composite gives what the stage entries gave
    flat, ok = P.spec_decode_full(
        st.u32win, st.luts, st.zz, st.comp_of_sub, st.tclass_of_sub,
        st.bmap, torch.from_numpy(bit0), torch.from_numpy(bit_end),
        torch.from_numpy(first), torch.from_numpy(starts[lane_img]),
        torch.from_numpy(lasts[lane_img]),
        torch.from_numpy(lane_img * consts["comp_space"] * 64),
        consts["bpm"], out_size, consts["blocks_per_img"], 1 << 22)
    assert torch.equal(flat, got["flat"]) and bool(ok) == bool(got["ok"])


def test_entropy_cases_reach_their_edges():
    """The cases hold what their names promise, read from the host
    decoder's coefficients and the stage outputs."""
    spill = CASES["dri_spill"]["datas"][0]
    j, _ = jpg.parse_and_decode(spill)
    blocks = np.concatenate([c.reshape(-1, 64)[:, ZIGZAG] for c in j.coeffs])
    y = j.coeffs[0].reshape(-1, 64)[:, ZIGZAG]
    # luma AC of size 10 (code 0/A is 16 bits) and DC differences of
    # size 11 (a 9-bit code): more than 16 bits, the RUN_CODE entries
    assert (np.abs(y[:, 1:]) >= 512).any()
    dc = y[:, 0].astype(np.int64)
    assert (np.abs(np.diff(dc)) >= 1024).any()
    assert ((blocks[:, 62] != 0) & (blocks[:, 63] == 0)).any()  # EOB at 63
    assert (blocks[:, 63] != 0).any()                           # no EOB
    runs = 0
    for b in blocks:
        nz = np.flatnonzero(b[1:]) + 1
        runs += int((np.diff(np.r_[0, nz]) - 1 >= 16).sum())
    assert runs > 0                                             # ZRL
    np.testing.assert_array_equal(
        testing.entropy_stages(CASES["dri_spill"], "cpu")["flat"][
            :blocks.size].numpy(), _host_coeffs(spill))
    zero = testing.entropy_stages(CASES["dri_zero_lanes"], "cpu")
    assert (zero["steps"] == 0).any()
    mixed = [jpg.parse_and_decode(d, skip_decode=True)[0]
             for d in CASES["dri_mixed"]["datas"]]
    assert len({(j.mcus_x, j.mcus_y) for j in mixed}) == 2
    assert len({P._dht_key(j) for j in mixed}) == 2
    assert not bool(testing.entropy_stages(CASES["spec_fail"], "cpu")["ok"])
    # the invalid run stops its lane early: the same segment decodes
    # fewer symbols than in the intact file beside it
    inv = testing.entropy_stages(CASES["dri_invalid"], "cpu")["steps"]
    half = inv.numel() // 2
    assert (inv[:half] < inv[half:]).any()


# --- K9 and K10's staged inputs: the fast tables and the CTA plan ------------

def _random_dht(seed: int, is_ac: bool):
    """A valid Huffman table from a seed: distinct symbols of the table's
    class (AC: EOB, ZRL and run/size pairs of size 1..10; DC: sizes
    0..11), codes of 1..16 bits whose Kraft sum stays below 1, so no code
    is all ones."""
    rng = np.random.default_rng(seed)
    pool = ([0x00, 0xF0] + [(r << 4) | s for r in range(16)
                            for s in range(1, 11)]) if is_ac else \
        list(range(12))
    syms = [int(x) for x in rng.permutation(pool)]
    counts, room, used = [0] * 16, 1.0, 0
    for length in rng.integers(1, 17, size=len(syms) * 4):
        if used == len(syms):
            break
        if room - 2.0 ** -int(length) > 2.0 ** -17:
            counts[int(length) - 1] += 1
            room -= 2.0 ** -int(length)
            used += 1
    return counts, syms[:used]


def _table_sets(name: str) -> list:
    """(4, 65536) LUT stacks: each table set of an ``entropy_cases``
    batch, of the q85/q95 8 x 1080p DRI batch (``encode_jpeg`` writes
    the same tables at every size and quality, so small files carry
    them), or of seeded random valid DHTs."""
    if name == "random_dht":
        return [np.stack([P.build_lut16(*_random_dht(10 * s + t, t % 2 == 1),
                                        t % 2 == 1) for t in range(4)])
                for s in range(3)]
    if name == "dri_batch":
        datas = [testing.encode_jpeg(testing.synth_rgb(16, 32, q), q,
                                     restart_interval=1) for q in (85, 95)]
    else:
        datas = CASES[name]["datas"]
    heads = {P._dht_key(j): j for j in
             (jpg.parse_and_decode(d, skip_decode=True)[0] for d in datas)}
    return [P.luts_for(j) for j in heads.values()]


@pytest.mark.parametrize("bits", [10, 11, 12])
@pytest.mark.parametrize("name", sorted(CASES) + ["dri_batch",
                                                  "random_dht"])
def test_fast_table_lookup_equals_lut16(name, bits):
    """Every 16-bit window of every table, looked up through the fast
    table and, on a miss, the 16-bit LUT (as K9 and K10 look it up),
    gives build_lut16's entry; every hit's code (and combined magnitude)
    fits in the fast table's bits, and no hit is a spill; the miss marker
    is no LUT entry."""
    windows = np.arange(65536)
    for luts in _table_sets(name):
        fast = P.fast_tables(luts, bits)
        assert fast.shape == (4, 1 << bits) and fast.dtype == np.uint32
        e = fast[:, windows >> (16 - bits)]
        hit = e != P.FAST_MISS
        np.testing.assert_array_equal(np.where(hit, e, luts), luts)
        assert ((e[hit] >> 24) <= bits).all()
        assert (((e[hit] >> 16) & 0xFF) != P.RUN_CODE).all()
        assert not (luts == P.FAST_MISS).any()
        assert hit.any() and (luts[:, :1 << 15] != 0).any()


def test_fast_tables_cached_and_staged():
    """``fast_for`` gives ``fast_tables(luts_for(j))`` from its cache, and
    ``stage_dri`` stages each group's fast tables beside its LUTs."""
    datas = CASES["dri_mixed"]["datas"]
    js = [jpg.parse_and_decode(d, skip_decode=True)[0] for d in datas]
    for j in js:
        assert P.fast_for(j) is P.fast_for(j)
        np.testing.assert_array_equal(P.fast_for(j),
                                      P.fast_tables(P.luts_for(j)))
    st, lanes, plan, out_size, _off = P.stage_dri(datas, js,
                                                  torch.device("cpu"))
    assert st.luts.shape[0] == 8 and st.fast.shape == (8, 1 << P.FAST_BITS)
    np.testing.assert_array_equal(
        st.fast.numpy().view(np.uint32),
        P.fast_tables(st.luts.numpy().view(np.uint32)))
    flat, steps = P.decode_lanes(st, lanes, plan, out_size)
    want, wsteps = P.decode_lanes_plain(st, lanes, out_size)
    assert torch.equal(flat, want) and torch.equal(steps, wsteps)


def _check_plan(plan: np.ndarray, lut_idx: np.ndarray, max_lanes: int):
    assert plan.dtype == np.int32 and plan.shape[1] == 3
    group, first, count = plan.T
    assert (count >= 1).all() and (count <= max_lanes).all()
    # every lane once, in order
    np.testing.assert_array_equal(np.concatenate(
        [np.arange(f, f + c) for f, c in zip(first, count)]),
        np.arange(len(lut_idx)))
    for g, f, c in plan:
        assert (lut_idx[f:f + c] == g).all()


def test_cta_plan_on_dri_mixed():
    """The staged plan of ``dri_mixed`` (two table sets and two
    geometries in one launch): each CTA one group, at most CTA_LANES
    lanes, every lane once in order; with 32 lanes a CTA, a group
    boundary still splits the CTAs."""
    datas = CASES["dri_mixed"]["datas"]
    js = [jpg.parse_and_decode(d, skip_decode=True)[0] for d in datas]
    _st, lanes, plan, _n, _off = P.stage_dri(datas, js, torch.device("cpu"))
    lut_idx = lanes[:, 4].numpy()
    assert len(set(lut_idx.tolist())) == 2
    plan = plan.numpy()
    assert 1 <= P.CTA_LANES <= 32
    _check_plan(plan, lut_idx, P.CTA_LANES)
    np.testing.assert_array_equal(plan, P.cta_plan(lut_idx))
    wide = P.cta_plan(lut_idx, 32)
    _check_plan(wide, lut_idx, 32)
    assert len(wide) > -(-len(lut_idx) // 32)


@pytest.mark.parametrize("max_lanes", [1, 8, 32])
def test_cta_plan_random_groups(max_lanes):
    rng = np.random.default_rng(max_lanes)
    for n in (1, 31, 32, 33, 200):
        lut_idx = np.repeat(rng.integers(0, 3, n),
                            rng.integers(1, 50, n))[:n]
        _check_plan(P.cta_plan(lut_idx, max_lanes), lut_idx, max_lanes)
    assert P.cta_plan(np.zeros(0)).shape == (0, 3)


def test_spec_stages_plan_matches_its_lanes():
    """The speculative route's emission lanes take one table group, and
    ``spec_stages`` stages their CTA plan with them."""
    case = testing.entropy_cases()["spec_mid_mcu"]
    r = P.spec_stages(case["datas"], case["chunk_bytes"], device="cpu")
    lut_idx = r["lanes"][:, 4].numpy()
    assert (lut_idx == 0).all()
    np.testing.assert_array_equal(r["plan"].numpy(), P.cta_plan(lut_idx))


def _wrong_plans(plan: np.ndarray) -> dict:
    one_group = plan.copy()
    one_group[:, 0] = 0
    too_wide = np.array([[0, 0, P.CTA_THREADS + 1]], np.int32)
    return {"one_group": one_group, "short": plan[:-1],
            "overlap": np.r_[plan[:1], plan],
            "too_wide": too_wide}


@pytest.mark.parametrize("kind", ["one_group", "short", "overlap",
                                  "too_wide"])
def test_decode_lanes_refuses_a_plan_that_does_not_match(kind):
    """``decode_lanes`` takes K9's CTA plan with the lanes; on the CPU a
    plan that does not cover them once each, in order, with each lane's
    own group and at most CTA_THREADS a row raises (the kernel traps on
    a lane of another group, ``chip_smoke.plan_trap_check``)."""
    datas = CASES["dri_mixed"]["datas"]
    js = [jpg.parse_and_decode(d, skip_decode=True)[0] for d in datas]
    st, lanes, plan, out_size, _off = P.stage_dri(datas, js,
                                                  torch.device("cpu"))
    P.check_plan(plan.numpy(), lanes[:, 4].numpy())
    for m in (1, 8, P.CTA_THREADS):
        P.check_plan(P.cta_plan(lanes[:, 4].numpy(), m), lanes[:, 4].numpy())
    wrong = torch.from_numpy(_wrong_plans(plan.numpy())[kind])
    with pytest.raises(ValueError, match="CTA plan"):
        P.decode_lanes(st, lanes, wrong, out_size)


# --- K11's snapshot cursor, run on the CPU -----------------------------------

def _merge_with_a_cursor(st, ent, snap):
    """K11's merge loop (csrc/jpeg_entropy.cu: ``spec_merge_kernel`` and
    its ``SnapCursor``) on the CPU, lanes side by side, each symbol the
    plain step: before each symbol the cursor moves past the used slots
    whose bit lies below the state's, taking each slot's (bit, k, sub)
    from the copy it read of it while on the slot before (slot p + 1,
    clamped to the last slot; p == SNAP is past them); a match is a used
    slot equal to the state; the walk stops at a match, once no used slot
    is left (with none used at all, at a bit past -1) or past MERGE_STEPS
    symbols.  Returns (L, 6) as ``spec_merge``."""
    i64 = torch.int64
    tabs = P._spec_tables(st.u32win, st.luts, st.comp_of_sub,
                          st.tclass_of_sub)
    snap = snap.to(i64)
    L = snap.shape[0]
    rows = torch.arange(L)
    bit, k, sub = (ent[:, i].to(i64).clone() for i in range(3))
    blk = torch.zeros(L, dtype=i64)
    dcs = torch.zeros((L, 3), dtype=i64)

    def slot(i):
        j = i.clamp(max=P.SNAP - 1)
        return snap[rows, j, 0], snap[rows, j, 1], snap[rows, j, 2]

    p = torch.zeros(L, dtype=i64)
    cur = list(slot(p))
    nxt = list(slot(p + 1))
    matched = torch.zeros(L, dtype=torch.bool)
    midx = torch.zeros(L, dtype=i64)
    active = torch.ones(L, dtype=torch.bool)
    t = 0
    while bool(active.any()):
        while True:
            used = (p < P.SNAP) & (cur[0] != -1)
            move = active & used & (cur[0] < bit)
            if not bool(move.any()):
                break
            cur = [torch.where(move, n, c) for n, c in zip(nxt, cur)]
            p = p + move
            nxt = [torch.where(move, a, n) for a, n in zip(slot(p + 1), nxt)]
        hit = active & used & (cur[0] == bit) & (cur[1] == k) & (cur[2] == sub)
        matched |= hit
        midx = torch.where(hit, p, midx)
        past = ~used & ((p > 0) | (bit > -1))
        active &= ~(hit | past | (t > P.MERGE_STEPS))
        bit, k, sub, blk, dcs = P._advance(tabs, st.bpm, active, bit, k, sub,
                                           blk, dcs)
        t += 1
    return torch.cat([torch.stack([matched.to(i64), midx, blk], dim=1), dcs],
                     dim=1).to(torch.int32)


@pytest.mark.parametrize("entries", ["true", "shifted", "random",
                                     "few_snapshots"])
@pytest.mark.parametrize("name", ["spec_mid_mcu", "spec_fail",
                                  "spec_invalid"])
def test_k11_snapshot_cursor_matches_spec_merge_lanes(name, entries):
    """K11's cursor over the snapshots, read one slot ahead, gives
    ``spec_merge_lanes``' first match (its argmax over all slots), blocks
    and DC sums: from the true entries, from entries 1-3 bits past them,
    from random k and sub, and with each lane's snapshots cut to a random
    number of used slots (none for some)."""
    case = testing.entropy_cases()[name]
    r = P.spec_stages(case["datas"], case["chunk_bytes"], device="cpu")
    st, ent, snap = r["staged"], r["ent"].clone(), r["snap"].clone()
    rng = np.random.default_rng(14)
    L = ent.shape[0]
    if entries == "shifted":
        ent[:, 0] += torch.from_numpy(rng.integers(1, 4, L)).to(torch.int32)
    elif entries == "random":
        ent[:, 1] = torch.from_numpy(rng.integers(0, 64, L)).to(torch.int32)
        ent[:, 2] = torch.from_numpy(rng.integers(0, st.bpm, L)) \
            .to(torch.int32)
    elif entries == "few_snapshots":
        used = (snap[..., 0] != -1).sum(dim=1).numpy()
        keep = rng.integers(0, used + 1)
        keep[: max(1, L // 8)] = 0
        for i in range(L):
            snap[i, keep[i]:] = -1
    want = P.spec_merge_plain(st, ent, snap)
    got = _merge_with_a_cursor(st, ent, snap)
    assert torch.equal(got, want)
    if entries == "true":
        assert bool(want[:, 0].any())


def test_k11_wrapper_refuses_what_the_kernel_does_not_take():
    """K11's wrapper takes CUDA tensors and the fast tables it copies
    into shared memory; on the CPU it refuses before any launch."""
    from ffpic_tpu_torch.ops import cuda_entropy
    case = testing.entropy_cases()["spec_mid_mcu"]
    r = P.spec_stages(case["datas"], case["chunk_bytes"], device="cpu")
    st = r["staged"]
    cuda_entropy.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        cuda_entropy.spec_merge(st.data, st.n, st.luts, st.fast,
                                st.comp_of_sub, st.tclass_of_sub, r["ent"],
                                r["snap"], st.bpm)
    with pytest.raises(TypeError):
        cuda_entropy.spec_merge(st.data, st.n, st.luts, st.comp_of_sub,
                                st.tclass_of_sub, r["ent"], r["snap"],
                                st.bpm)
    assert cuda_entropy.launches["spec_merge"] == 0


def test_merge_work_replays_each_walk_to_its_match():
    """``testing.merge_work`` (K11's symbols and bytes in ``chip_smoke``)
    runs on the CPU: every walk from its true entry ends on the slot K11
    matched, the longest within MERGE_STEPS; a lane that met no slot
    raises."""
    case = testing.entropy_cases()["spec_mid_mcu"]
    r = P.spec_stages(case["datas"], case["chunk_bytes"], device="cpu")
    assert bool(r["merged"][:, 0].all())
    lut_bytes = 4 * r["staged"].luts.numel()
    w = testing.merge_work(r["staged"], r, lut_bytes)
    assert 0 < w["longest"] <= min(w["symbols"], P.MERGE_STEPS)
    assert w["scan_bytes"] + w["snap_bytes"] < w["bytes"]
    unmatched = dict(r, merged=r["merged"].clone())
    unmatched["merged"][0, 0] = 0
    with pytest.raises(AssertionError, match="did not meet"):
        testing.merge_work(r["staged"], unmatched, lut_bytes)
