"""Device Huffman decode of baseline 4:2:0 JPEGs: one lane per restart
segment (DRI streams) or per speculative chunk (DRI-less streams).

The PyTorch counterpart of ``ffpic_tpu/ops/jpeg_entropy_device.py``.
The host destuffs each scan (``native.jpeg_destuff``) and stages the raw
entropy bytes; the device decodes them into the flat int16 coefficients
of the concatenated per-component space, which the dense route
(``jpeg_kernels.decode_batch_420_dense``: K2, K3) turns into pixels.  It
holds

* the host helpers, copied with their originals named: ``build_lut16``
  (``:56``), ``sliding_u32`` (``:112``, used by the plain versions
  only), ``prepare_frame`` (``:736``, on the port's
  ``formats.jpg.mcu_block_map``), ``build_luts_from_dht`` (``:761``),
  ``extract_scan`` (``:774``, on the port's ``jpg._find_scan_end``),
  ``eligible``, ``spec_eligible``, ``spec_group_key``, ``group_key``
  (``:1012-1072``) and the constants ``RUN_EOB``/``RUN_ZRL``/``RUN_CODE``,
  ``SNAP``, ``SNAP_STRIDE``;
* the plain PyTorch versions, lane-vectorised loops step for step as in
  JAX: ``decode_lanes_bmap`` (``:139``), ``_spec_symbol_step`` (``:312``),
  ``spec_scan_lanes`` (``:374``), ``spec_snap_lanes`` (``:424``),
  ``spec_merge_lanes`` (``:490``) and ``spec_decode_full`` (``:558``);
* the stage entries ``decode_lanes``, ``spec_scan`` and ``spec_merge``,
  which take the staged bytes and dispatch on their device: the CUDA
  kernels of ``ops.cuda_entropy`` (K9 ``entropy_decode``, K10
  ``spec_scan``, K11 ``spec_merge``; they raise rather than fall back) on
  a CUDA tensor, the plain versions (``decode_lanes_plain``,
  ``spec_scan_plain``, ``spec_merge_plain``, which take any device) on a
  CPU one;
* K9-K11's staged inputs of their own: ``fast_tables`` (cached per
  table set by ``fast_for``, beside ``luts_for``), the fast tables that
  each CTA holds in shared memory, and ``cta_plan``, the rows (group,
  first lane, lane count) that give each K9 CTA one table group
  (``check_plan`` holds a plan to its lanes on the CPU);
* ``launch_runs``, which splits a route's files into launches, and
  ``Declined``, the one error after which a caller's host path takes the
  files;
* the orchestration, each entry with ``device=``: ``spec_stages`` (the
  speculative decoder's stages, each result kept for the tests),
  ``stage_dri`` (the staging of ``decode_coeffs_device_mixed``),
  ``decode_coeffs_device`` (``:795``), ``decode_coeffs_device_mixed``
  (``:853``), ``decode_batch_dri_mixed`` (``:938``), ``assemble_planes``
  (``:981``), ``decode_batch_device_entropy`` (``:997``),
  ``decode_coeffs_device_spec`` (``:632``),
  ``decode_batch_device_entropy_spec`` (``:709``), ``decode_batch_spec``
  (``:1042``) and ``decode_batch_dri`` (``:1075``).

Every coefficient is bit-exact with JAX.  Three differences of form:
``decode_lanes_bmap``, ``decode_coeffs_device`` and
``decode_coeffs_device_mixed`` return each lane's symbol count (JAX
returns their maximum, the loop's step count); a lane writes only what it emits
(JAX also writes garbage to the trailing dump slot, which no result
reads); ``unroll`` is accepted and does nothing (it amortised the TPU's
while-loop overhead, which a CUDA thread does not have).

The lane table that K9 takes is ``(L, LANE_COLS)`` int32, one row a lane:
bit0, blk0, blk_end, img_base, lut_idx, bmap_base, k0, sub0, pred0 (3)
and bit_stop (``NO_STOP`` when the lane has none).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ffpic_tpu_torch.ops.golden import ZIGZAG
from ffpic_tpu_torch.ops.jpeg_kernels import _on_cuda, _wrap
from ffpic_tpu_torch.utils.device import resolve_device, to_device
from ffpic_tpu_torch.utils.trace import stage

RUN_EOB = 0xFF
RUN_ZRL = 0xFE
RUN_CODE = 0xFD

SNAP = 256         # snapshot slots per chunk
SNAP_STRIDE = 8    # record every 8th symbol boundary: SNAP*SNAP_STRIDE =
# 2048 symbols per chunk; a chunk that does not merge within them makes
# ok False and the caller takes the host path
MERGE_STEPS = SNAP * SNAP_STRIDE + 16

LANE_COLS = 12
NO_STOP = 2 ** 31 - 1
# K9-K11 look a symbol up first in a fast table in shared memory,
# indexed by the first FAST_BITS bits of the window (fast_tables); a
# FAST_MISS entry sends the lookup to the 16-bit LUT. 11 bits (32 KB a
# CTA, so 7 CTAs fit an SM) and 2 lanes a K9 CTA, from tune_entropy's
# runs on an H100 (PERF.md)
FAST_BITS = 11
FAST_MISS = 0xFFFFFFFF
CTA_LANES = 2      # the most lanes a K9 CTA takes (cta_plan)
CTA_THREADS = 32   # K9's CTA width: no plan row may hold more lanes
MAX_STEPS = 1 << 22
PAD = 8            # zero bytes staged after the scan bytes
# what one launch takes: bit positions are int32 (K9-K11), and K2 takes
# at most INT_MAX // 64 blocks
LAUNCH_BYTES = (2 ** 31 - 1) // 8 - PAD
LAUNCH_COEFFS = (2 ** 31 - 1) // 64 * 64


class Declined(ValueError):
    """The device route does not take these files: a speculative decode
    that did not self-synchronise, a scan it cannot stage.  The only
    error of the route that a caller with a host path catches; any other
    (a wrapper's check, a build, a launch) propagates."""


# ---------------------------------------------------------------------------
# host helpers (numpy)
# ---------------------------------------------------------------------------

def build_lut16(counts, syms, is_ac: bool) -> np.ndarray:
    """uint32[65536]: (consume << 24) | (flags << 16) | uint16(value).

    flags 0..63 = zero-run with combined EXTENDed value (for DC: flags
    0, value = diff); RUN_EOB/RUN_ZRL/RUN_CODE sentinels as in
    host_jpeg.c; entry 0 = invalid code."""
    counts = np.asarray(counts, np.int64)
    code_len = np.zeros(65536, np.uint8)
    code_sym = np.zeros(65536, np.int32)
    code = 0
    k = 0
    for bitlen in range(1, 17):
        for _ in range(int(counts[bitlen - 1])):
            base = code << (16 - bitlen)
            span = 1 << (16 - bitlen)
            code_len[base:base + span] = bitlen
            code_sym[base:base + span] = syms[k]
            code += 1
            k += 1
        code <<= 1

    w = np.arange(65536, dtype=np.uint32)
    l = code_len.astype(np.uint32)
    sym = code_sym
    run = (sym >> 4) & 15
    sz = (sym & 15).astype(np.uint32)
    out = np.zeros(65536, np.uint32)
    valid = l > 0

    if is_ac:
        size0 = valid & (sz == 0)
        zrl = size0 & (run == 15)
        eob = size0 & (run != 15)
        out[zrl] = (l[zrl] << 24) | (RUN_ZRL << 16)
        out[eob] = (l[eob] << 24) | (RUN_EOB << 16) \
            | run[eob].astype(np.uint32)
    else:
        size0 = valid & (sym == 0)
        out[size0] = l[size0] << 24

    comb = valid & (sz > 0) & (l + sz <= 16)
    mag = (w >> (16 - l - sz)) & ((1 << sz) - 1)
    val = np.where(mag < (1 << (sz - np.where(sz > 0, 1, 0))),
                   mag.astype(np.int64) - (1 << sz) + 1,
                   mag.astype(np.int64))
    runf = np.zeros_like(run) if not is_ac else run
    out[comb] = ((l + sz)[comb].astype(np.uint32) << 24) \
        | (runf[comb].astype(np.uint32) << 16) \
        | (val[comb].astype(np.int64) & 0xFFFF).astype(np.uint32)

    spill = valid & (sz > 0) & (l + sz > 16)
    out[spill] = (l[spill] << 24) | (RUN_CODE << 16) \
        | (sym[spill] & 0xFFFF).astype(np.uint32)
    return out


def sliding_u32(buf: np.ndarray) -> np.ndarray:
    """uint32[i] = big-endian bytes buf[i..i+4) (zero-padded), the
    32-bit bit windows the plain versions gather from.  The kernels form
    each window from the staged bytes instead."""
    b = np.concatenate([buf, np.zeros(8, np.uint8)])
    n = len(b) - 8
    out = np.empty(n, np.uint32)
    out[:] = b[:n]
    out <<= 8
    out |= b[1:n + 1]
    out <<= 8
    out |= b[2:n + 2]
    out <<= 8
    out |= b[3:n + 3]
    return out


def prepare_frame(j) -> dict:
    """Per-geometry constants from a parsed JPEG: block map, lane
    tables.  Requires a baseline 4:2:0-style interleaved scan."""
    from ffpic_tpu_torch.formats.jpg import mcu_block_map

    samplings = tuple((c.v, c.h) for c in j.comps)
    bpm = sum(v * h for v, h in samplings)
    comp_of_sub = []
    tclass_of_sub = []
    for ci, (v, h) in enumerate(samplings):
        comp_of_sub += [ci] * (v * h)
        tclass_of_sub += [0 if ci == 0 else 1] * (v * h)
    bmap = mcu_block_map(samplings, j.mcus_x, j.mcus_y)
    return {
        "bpm": bpm,
        "comp_of_sub": np.array(comp_of_sub, np.int32),
        "tclass_of_sub": np.array(tclass_of_sub, np.int32),
        "bmap": bmap,
        "blocks_per_img": j.mcus_x * j.mcus_y * bpm,
        "comp_space": sum((j.mcus_y * v) * (j.mcus_x * h)
                          for v, h in samplings),
    }


def build_luts_from_dht(dht: dict) -> np.ndarray:
    """(4, 65536) uint32 stack: DC-Y, AC-Y, DC-chroma, AC-chroma."""
    out = np.zeros((4, 65536), np.uint32)
    out[0] = build_lut16(*dht[(0, 0)], is_ac=False)
    out[1] = build_lut16(*dht[(1, 0)], is_ac=True)
    if (0, 1) in dht:
        out[2] = build_lut16(*dht[(0, 1)], is_ac=False)
        out[3] = build_lut16(*dht[(1, 1)], is_ac=True)
    else:
        out[2], out[3] = out[0], out[1]
    return out


@functools.lru_cache(maxsize=16)
def _cached_luts(key: tuple) -> np.ndarray:
    dht = {k: (list(c), list(s)) for k, c, s in key}
    out = build_luts_from_dht(dht)
    out.setflags(write=False)
    return out


def luts_for(j) -> np.ndarray:
    """``build_luts_from_dht(j.dht_raw)``, built once per table set (a
    batch's members usually share one; the build takes milliseconds)."""
    return _cached_luts(_dht_key(j))


def fast_tables(luts, bits: int = FAST_BITS) -> np.ndarray:
    """(T, 2**bits) uint32 fast tables of a (T, 65536) LUT stack, which
    K9-K11 hold in shared memory.  Entry p is the LUT entry of every
    16-bit window whose first ``bits`` bits are p, where all those
    windows hold the same entry and its code (with a combined magnitude)
    fits in ``bits`` bits; else FAST_MISS, which no LUT entry equals.
    Entry 0, an invalid code, is a hit where the whole prefix is
    invalid; a spill (``RUN_CODE``: the magnitude follows outside the
    window) never is.  So a hit is the 16-bit lookup by construction, and
    a miss takes it."""
    x = np.asarray(luts, np.uint32).reshape(len(luts), 1 << bits,
                                            1 << (16 - bits))
    e = x[..., 0]
    hit = (x == e[..., None]).all(axis=-1) & ((e >> 24) <= bits) \
        & (((e >> 16) & 0xFF) != RUN_CODE)
    return np.where(hit, e, np.uint32(FAST_MISS)).astype(np.uint32)


@functools.lru_cache(maxsize=16)
def _cached_fast(key: tuple) -> np.ndarray:
    out = fast_tables(_cached_luts(key))
    out.setflags(write=False)
    return out


def fast_for(j) -> np.ndarray:
    """``fast_tables(luts_for(j))``, built once per table set."""
    return _cached_fast(_dht_key(j))


def cta_plan(lut_idx, max_lanes: int = CTA_LANES) -> np.ndarray:
    """K9's CTA plan for lanes whose table groups are ``lut_idx``, in
    lane order: (C, 3) int32 rows (group, first lane, lane count), each
    a run of at most ``max_lanes`` consecutive lanes of one group, so
    that a CTA holds one group's fast tables; together they cover every
    lane once, in order."""
    g = np.asarray(lut_idx, np.int64).reshape(-1)
    n = len(g)
    if n == 0:
        return np.zeros((0, 3), np.int32)
    starts = np.flatnonzero(np.r_[True, g[1:] != g[:-1]])
    ends = np.r_[starts[1:], n]
    per_run = (ends - starts + max_lanes - 1) // max_lanes
    run = np.repeat(np.arange(len(starts)), per_run)
    nth = np.arange(len(run)) - np.repeat(np.cumsum(per_run) - per_run,
                                          per_run)
    first = starts[run] + nth * max_lanes
    count = np.minimum(max_lanes, ends[run] - first)
    return np.stack([g[first], first, count], axis=1).astype(np.int32)


def check_plan(plan, lut_idx) -> None:
    """Raise ValueError unless ``plan``'s rows (group, first lane, lane
    count) cover the lanes of ``lut_idx`` once each, in order, at most
    CTA_THREADS a row, each lane's lut_idx its row's group."""
    plan = np.asarray(plan, np.int64).reshape(-1, 3)
    g = np.asarray(lut_idx, np.int64).reshape(-1)
    count = plan[:, 2]
    ok = bool((count >= 1).all() and (count <= CTA_THREADS).all()
              and np.array_equal(plan[:, 1], np.cumsum(count) - count)
              and int(count.sum()) == len(g))
    if not ok or not np.array_equal(np.repeat(plan[:, 0], count), g):
        raise ValueError("K9's CTA plan does not match the lanes: "
                         "make it with cta_plan(lut_idx)")


def extract_scan(data: bytes) -> bytes:
    """Raw entropy-coded bytes of the first SOS scan."""
    from ffpic_tpu_torch.formats.jpg import _find_scan_end
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        m = data[pos + 1]
        if m == 0xDA:
            ln = int.from_bytes(data[pos + 2:pos + 4], "big")
            start = pos + 2 + ln
            return data[start:_find_scan_end(data, start)]
        if m in (0xD8, 0x01) or 0xD0 <= m <= 0xD7:
            pos += 2
            continue
        ln = int.from_bytes(data[pos + 2:pos + 4], "big")
        pos += 2 + ln
    raise Declined("no SOS scan found")


def _is_420_scan(j) -> bool:
    return (j.mode == "baseline" and j.precision == 8 and len(j.comps) == 3
            and [(c.v, c.h) for c in j.comps] == [(2, 2), (1, 1), (1, 1)]
            and len(j.scans) == 1
            and len(j.scans[0].get("comps", ())) == 3)


def eligible(j) -> bool:
    """Can this parsed JPEG take the device-entropy path?  Baseline
    8-bit single interleaved 4:2:0 scan with restart intervals."""
    return j.restart_interval > 0 and _is_420_scan(j)


def spec_eligible(j) -> bool:
    """Same scan shape as eligible() but WITHOUT restart markers --
    the self-sync speculative path's domain."""
    return j.restart_interval == 0 and _is_420_scan(j)


def _dht_key(j) -> tuple:
    return tuple(sorted((k, bytes(c), bytes(s))
                        for k, (c, s) in j.dht_raw.items()))


def spec_group_key(j) -> tuple:
    """Spec batches share one LUT stack + geometry
    (decode_coeffs_device_spec builds its constants from js[0])."""
    return (j.mcus_x, j.mcus_y, _dht_key(j))


def group_key(j) -> tuple:
    """Bucket key: geometry + Huffman tables + DRI (quant tables may
    differ per image -- they ride along per image)."""
    return (j.mcus_x, j.mcus_y, j.restart_interval, _dht_key(j))


def launch_runs(members, datas) -> list[list]:
    """``members``, (index, header) pairs of eligible files, split in
    order into runs that one launch takes: each run's file bytes (which
    bound its scan bytes) within ``LAUNCH_BYTES`` and its coefficients
    within ``LAUNCH_COEFFS``.  A file too large alone is left out, for
    the host path."""
    runs, run, nbytes, ncoef = [], [], 0, 0
    for i, j in members:
        b = len(datas[i])
        c = j.mcus_x * j.mcus_y * sum(x.h * x.v for x in j.comps) * 64
        if b > LAUNCH_BYTES or c + 1 > LAUNCH_COEFFS:
            continue
        if run and (nbytes + b > LAUNCH_BYTES
                    or ncoef + c + 1 > LAUNCH_COEFFS):
            runs.append(run)
            run, nbytes, ncoef = [], 0, 0
        run.append((i, j))
        nbytes += b
        ncoef += c
    return runs + [run] if run else runs


def lane_table(bit0, blk0, blk_end, img_base, lut_idx=None, bmap_base=None,
               k0=None, sub0=None, pred0=None, bit_stop=None) -> np.ndarray:
    """The (L, LANE_COLS) int32 lane table from per-lane arrays; the
    optional ones default as in ``decode_lanes_bmap``."""
    n = len(bit0)
    z = np.zeros(n, np.int64)
    cols = [bit0, blk0, blk_end, img_base,
            z if lut_idx is None else lut_idx,
            z if bmap_base is None else bmap_base,
            z if k0 is None else k0, z if sub0 is None else sub0]
    p = np.zeros((n, 3), np.int64) if pred0 is None else np.asarray(pred0)
    cols += [p[:, 0], p[:, 1], p[:, 2],
             np.full(n, NO_STOP) if bit_stop is None else bit_stop]
    return np.stack([np.asarray(c, np.int64) for c in cols],
                    axis=1).astype(np.int32).reshape(n, LANE_COLS)


# ---------------------------------------------------------------------------
# plain versions (torch, any device)
# ---------------------------------------------------------------------------

def _u32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values, held in any integer dtype (int32 storage
    included) -> their int64 values."""
    return x.to(torch.int64) & 0xFFFFFFFF


def _gather(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[idx]`` with the index clamped into range, as a JAX gather
    clamps it."""
    return t[idx.clamp(0, t.shape[0] - 1)]


def _symbol(u32win, lut_flat, tbl_base, bitpos, k):
    """The LUT lookup and the spill read shared by every loop: (e,
    consume, flags, val, is_dc, is_code, r_sp, sz_sp, ext), int64."""
    w32 = _gather(u32win, bitpos >> 3)
    s = bitpos & 7
    win16 = (w32 >> (16 - s)) & 0xFFFF
    is_dc = k == 0
    tbl = tbl_base + torch.where(is_dc, 0, 1)
    e = _u32(lut_flat[tbl * 65536 + win16])
    consume = e >> 24
    flags = (e >> 16) & 0xFF
    v16 = e & 0xFFFF
    val = v16 - 2 * (v16 & 0x8000)                  # sign-extend
    is_code = flags == RUN_CODE
    r_sp = torch.where(is_dc, 0, val >> 4)
    sz_sp = torch.where(is_dc, val, val & 15)
    pos2 = bitpos + consume
    w2 = _gather(u32win, pos2 >> 3)
    s2 = pos2 & 7
    szu = sz_sp.clamp(1, 16)                        # avoid shift-by-32
    one = torch.ones_like(szu)
    mag = (w2 >> (32 - s2 - szu)) & ((one << szu) - 1)
    ext = torch.where(mag < (one << (sz_sp - 1).clamp(0, 15)),
                      mag - (one << sz_sp.clamp(0, 16)) + 1, mag)
    ext = torch.where(sz_sp > 0, ext, 0)
    return e, consume, flags, val, is_dc, is_code, r_sp, sz_sp, ext


def _onehot(comp: torch.Tensor) -> torch.Tensor:
    return comp[:, None] == torch.arange(3, device=comp.device)


def decode_lanes_bmap(u32win, luts, zz, comp_of_sub, tclass_of_sub, bmap,
                      bit0, blk0, blk_end, img_base, bpm: int, out_size: int,
                      max_steps: int, unroll: int = 1, lut_idx=None,
                      bmap_base=None, k0=None, sub0=None, pred0=None,
                      bit_stop=None):
    """Decode all lanes to coefficients (plain version of K9).

    u32win: ``sliding_u32`` windows of the concatenated destuffed
    streams (int64 or uint32 values); luts: (G*4, 65536) uint32 values
    in any integer dtype (per table group: DC-Y, AC-Y, DC-C, AC-C); zz:
    int[64]; comp_of_sub/tclass_of_sub: int[bpm]; bmap: int[...] maps an
    in-image MCU-order block index to the image's concatenated
    per-component block index (per-image sections when bmap_base is
    given); bit0/blk0/blk_end/img_base: int[L] per-lane start bit,
    block counter bounds and flat offset of the lane's image.  lut_idx
    and bmap_base pick each lane's table group and block-map section;
    k0/sub0/pred0 (L, 3) give a lane that starts mid-MCU its entry
    state; bit_stop ends a lane at the first symbol boundary at or past
    it.  A lane stops at blk >= blk_end, an invalid code, an AC overrun,
    bit_stop, or after max_steps symbols.  Returns (int16[out_size]
    flat coefficients, int32[L] symbols each lane decoded)."""
    dev = bit0.device
    L = bit0.shape[0]
    i64 = torch.int64

    def lane(x, default=0):
        return (torch.full((L,), default, dtype=i64, device=dev) if x is None
                else x.to(i64))

    u32 = _u32(u32win)
    lut_flat = luts.reshape(-1)
    zz, cos, tos, bmap = (t.to(i64) for t in (zz, comp_of_sub, tclass_of_sub,
                                              bmap))
    lut_idx, bmap_base = lane(lut_idx), lane(bmap_base)
    img_base, blk_end = lane(img_base), lane(blk_end)
    bitpos, blk, k, sub = lane(bit0), lane(blk0), lane(k0), lane(sub0)
    pred = (torch.zeros((L, 3), dtype=i64, device=dev) if pred0 is None
            else pred0.to(i64))
    stop = lane(bit_stop, NO_STOP)
    out = torch.zeros(out_size, dtype=torch.int16, device=dev)
    steps = torch.zeros(L, dtype=i64, device=dev)
    done = (blk >= blk_end) | (bitpos >= stop)
    step = 0
    while step < max_steps and not bool(done.all()):
        active = ~done
        subc = sub.clamp(0, bpm - 1)
        tcls = tos[subc]
        e, consume, flags, val, is_dc, is_code, r_sp, sz_sp, ext = _symbol(
            u32, lut_flat, lut_idx * 4 + tcls * 2, bitpos, k)
        invalid = (e == 0) & active
        total_consume = consume + torch.where(is_code, sz_sp, 0)

        # DC step
        dc_diff = torch.where(is_code, ext, val)
        comp = cos[subc]
        pred_new = _wrap(pred + (dc_diff * (active & is_dc))[:, None]
                         * _onehot(comp), 32)
        dc_value = pred_new.gather(1, comp[:, None])[:, 0]

        # AC step
        is_comb = flags < 64
        is_eob = flags == RUN_EOB
        is_zrl = flags == RUN_ZRL
        run = torch.where(is_comb, flags, r_sp)
        kk = k + run
        ac_value = torch.where(is_comb, val, ext)
        ac_emit = ~is_dc & (is_comb | is_code) & (kk <= 63)
        overrun = ~is_dc & (is_comb | is_code) & (kk > 63) & active

        emit = active & (is_dc | ac_emit)
        emit_pos = torch.where(is_dc, 0, zz[kk.clamp(0, 63)])
        emit_val = torch.where(is_dc, dc_value, ac_value)
        flat_idx = img_base + _gather(bmap, bmap_base + blk) * 64 + emit_pos
        emit &= (flat_idx >= 0) & (flat_idx < out_size)
        out[flat_idx[emit]] = _wrap(emit_val[emit], 16).to(torch.int16)

        # state transitions
        k_next = torch.where(is_dc, 1, torch.where(is_zrl, k + 16, kk + 1))
        block_end = ~is_dc & (is_eob | (k_next > 63))
        k_next = torch.where(block_end, 0, k_next)
        sub_next = torch.where(block_end, sub + 1, sub)
        sub_next = torch.where(sub_next >= bpm, 0, sub_next)
        blk_next = torch.where(block_end, blk + 1, blk)

        bitpos = torch.where(active, bitpos + total_consume, bitpos)
        blk = torch.where(active, blk_next, blk)
        sub = torch.where(active, sub_next, sub)
        k = torch.where(active, k_next, k)
        pred = torch.where(active[:, None], pred_new, pred)
        steps += active
        done = done | invalid | overrun | (blk >= blk_end) | (bitpos >= stop)
        step += 1
    return out, steps.to(torch.int32)


def _spec_symbol_step(u32win, lut_flat, comp_of_sub, tclass_of_sub, bpm,
                      bitpos, k, sub):
    """One speculative symbol transition from (bitpos, k, sub), shared
    by the scan, snapshot and merge loops.  An invalid code advances one
    bit and an AC overrun ends the block (a prefix-free code
    self-synchronises within a few symbols).  Returns (advance_bits,
    k_next, sub_next, block_end, dc_take, dc_diff, comp), int64/bool."""
    subc = sub.clamp(0, bpm - 1)
    e, consume, flags, val, is_dc, is_code, r_sp, sz_sp, ext = _symbol(
        u32win, lut_flat, tclass_of_sub[subc] * 2, bitpos, k)
    invalid = e == 0
    adv = torch.where(invalid, 1, consume + torch.where(is_code, sz_sp, 0))
    dc_diff = torch.where(is_code, ext, val)
    comp = comp_of_sub[subc]
    dc_take = is_dc & ~invalid

    is_comb = flags < 64
    is_eob = flags == RUN_EOB
    is_zrl = flags == RUN_ZRL
    run = torch.where(is_comb, flags, r_sp)
    kk = k + run
    k_next = torch.where(is_dc, 1, torch.where(is_zrl, k + 16, kk + 1))
    block_end = ~is_dc & (is_eob | (k_next > 63)) & ~invalid
    k_next = torch.where(block_end, 0, k_next)
    k_next = torch.where(invalid, k, k_next)
    sub_next = torch.where(block_end, sub + 1, sub)
    sub_next = torch.where(sub_next >= bpm, 0, sub_next)
    return adv, k_next, sub_next, block_end, dc_take, dc_diff, comp


def _spec_tables(u32win, luts, comp_of_sub, tclass_of_sub):
    return (_u32(u32win), luts.reshape(-1), comp_of_sub.to(torch.int64),
            tclass_of_sub.to(torch.int64))


def _advance(tabs, bpm, active, bitpos, k, sub, blk, dcs):
    """One masked speculative step of every active lane."""
    adv, k_next, sub_next, block_end, dc_take, dc_diff, comp = \
        _spec_symbol_step(*tabs, bpm, bitpos, k, sub)
    dcs = _wrap(dcs + (dc_diff * (dc_take & active))[:, None]
                * _onehot(comp), 32)
    bitpos = torch.where(active, bitpos + adv, bitpos)
    k = torch.where(active, k_next, k)
    sub = torch.where(active, sub_next, sub)
    blk = blk + (block_end & active)
    return bitpos, k, sub, blk, dcs


def spec_scan_lanes(u32win, luts, comp_of_sub, tclass_of_sub, bit0, bit_end,
                    k0, sub0, bpm: int, max_steps: int, unroll: int = 1):
    """Speculative per-chunk scan (plain; K10's exit half): each lane
    decodes symbols from bit0 (entry state k0/sub0) to the first symbol
    boundary at or past bit_end, emitting nothing.  Returns (exit_bit,
    exit_k, exit_sub, blk_cnt, dcsum (L, 3)), int64."""
    tabs = _spec_tables(u32win, luts, comp_of_sub, tclass_of_sub)
    i64 = torch.int64
    bitpos, k, sub = bit0.to(i64), k0.to(i64), sub0.to(i64)
    bit_end = bit_end.to(i64)
    blk = torch.zeros_like(bitpos)
    dcs = torch.zeros((bitpos.shape[0], 3), dtype=i64, device=bitpos.device)
    done = bitpos >= bit_end
    step = 0
    while step < max_steps and not bool(done.all()):
        bitpos, k, sub, blk, dcs = _advance(tabs, bpm, ~done, bitpos, k, sub,
                                            blk, dcs)
        done = done | (bitpos >= bit_end)
        step += 1
    return bitpos, k, sub, blk, dcs


def spec_snap_lanes(u32win, luts, comp_of_sub, tclass_of_sub, bit0, bit_end,
                    bpm: int, unroll: int = 16):
    """Record the first SNAP symbol-boundary states of each chunk's
    speculative decode from (bit0, k=0, sub=0), every SNAP_STRIDE-th
    boundary (plain; K10's snapshot half).  Returns (L, SNAP, 7) int64
    rows (bit, k, sub, blk, dc0, dc1, dc2), unused slots -1: JAX's
    (sbit, sk, ssub, sblk, sdc) are its views [..., 0] .. [..., 4:7].
    The exit boundary is recorded when its index is a multiple of
    SNAP_STRIDE below SNAP*SNAP_STRIDE."""
    tabs = _spec_tables(u32win, luts, comp_of_sub, tclass_of_sub)
    i64 = torch.int64
    dev = bit0.device
    L = bit0.shape[0]
    bitpos, bit_end = bit0.to(i64), bit_end.to(i64)
    k = torch.zeros(L, dtype=i64, device=dev)
    sub, blk, bidx = k.clone(), k.clone(), k.clone()
    dcs = torch.zeros((L, 3), dtype=i64, device=dev)
    snap = torch.full((L, SNAP, 7), -1, dtype=i64, device=dev)
    rows = torch.arange(L, device=dev)
    done = bitpos >= bit_end
    while not bool(done.all()):
        active = ~done
        w = active & (bidx % SNAP_STRIDE == 0) & (bidx < SNAP * SNAP_STRIDE)
        col = (bidx // SNAP_STRIDE).clamp(0, SNAP - 1)
        rec = torch.stack([bitpos, k, sub, blk, dcs[:, 0], dcs[:, 1],
                           dcs[:, 2]], dim=1)
        snap[rows[w], col[w]] = rec[w]
        bidx = bidx + active
        done = done | (bitpos >= bit_end) | (bidx >= SNAP * SNAP_STRIDE)
        bitpos, k, sub, blk, dcs = _advance(tabs, bpm, ~done, bitpos, k, sub,
                                            blk, dcs)
    return snap


def spec_merge_lanes(u32win, luts, comp_of_sub, tclass_of_sub, ent_b, ent_k,
                     ent_s, bpm: int, snap, unroll: int = 8):
    """Short re-decode from each lane's true entry state (its
    predecessor's exit) until it meets a recorded boundary of its own
    snapshot list (plain version of K11): the first slot whose (bit, k,
    sub) equals the state, checked before each symbol; a lane gives up
    past its last recorded bit or after MERGE_STEPS symbols.  Returns
    (matched bool, midx, mblk, mdc (L, 3)), the last three int64."""
    tabs = _spec_tables(u32win, luts, comp_of_sub, tclass_of_sub)
    i64 = torch.int64
    dev = ent_b.device
    L = ent_b.shape[0]
    sbit, sk, ssub = snap[..., 0], snap[..., 1], snap[..., 2]
    maxbit = sbit.max(dim=1).values
    bitpos, k, sub = ent_b.to(i64), ent_k.to(i64), ent_s.to(i64)
    blk = torch.zeros(L, dtype=i64, device=dev)
    midx = torch.zeros(L, dtype=i64, device=dev)
    dcs = torch.zeros((L, 3), dtype=i64, device=dev)
    matched = torch.zeros(L, dtype=torch.bool, device=dev)
    done = torch.zeros(L, dtype=torch.bool, device=dev)
    steps = 0
    while not bool(done.all()):
        active = ~done
        hit = ((sbit == bitpos[:, None]) & (sk == k[:, None])
               & (ssub == sub[:, None]))
        new_match = active & hit.any(dim=1)
        matched = matched | new_match
        first_hit = hit.to(torch.int32).argmax(dim=1)
        midx = torch.where(new_match, first_hit, midx)
        done = done | new_match | (bitpos > maxbit) | (steps > MERGE_STEPS)
        bitpos, k, sub, blk, dcs = _advance(tabs, bpm, ~done, bitpos, k, sub,
                                            blk, dcs)
        steps += 1
    return matched, midx, blk, dcs


def spec_entries(exits: torch.Tensor, first: torch.Tensor,
                 bit0: torch.Tensor) -> torch.Tensor:
    """(L, 3) int32 true entry states (bit, k, sub): each lane's
    predecessor's exit (the first three columns of ``exits``), or (bit0,
    0, 0) for an image's first lane -- JAX's roll over all lanes, which
    the first lanes make a roll within each image."""
    prev = torch.roll(exits[:, :3].to(torch.int64), 1, dims=0)
    own = torch.stack([bit0.to(torch.int64), torch.zeros_like(prev[:, 0]),
                       torch.zeros_like(prev[:, 0])], dim=1)
    return torch.where(first[:, None], own, prev).to(torch.int32)


def spec_stitch(exits, snap, merged, img_start, img_last,
                blocks_per_img: int):
    """The segmented prefix sums of ``spec_decode_full`` (JAX ``:606-620``)
    as torch ops: each lane's true block count and DC-diff sums (pass 2
    to the merge, then pass 1 from it), hence its absolute first block
    ``blk0`` and DC predictors ``pred0`` (L, 3); and ``ok``, a 0-d bool
    tensor, False when a chunk did not merge or the block totals do not
    reconcile.  ``exits`` (L, 7): exit bit, k, sub, blocks, DC sums;
    ``merged`` (L, 6): matched, midx, blocks, DC sums; int32 sums wrap
    as in JAX."""
    i64 = torch.int64
    exits, merged, snap = (t.to(i64) for t in (exits, merged, snap))
    rows = torch.arange(exits.shape[0], device=exits.device)
    midx = merged[:, 1]
    at = snap[rows, midx]
    cnt = _wrap(merged[:, 2] + (exits[:, 3] - at[:, 3]), 32)
    dcs = _wrap(merged[:, 3:6] + (exits[:, 4:7] - at[:, 4:7]), 32)
    img_start, img_last = img_start.to(i64), img_last.to(i64)
    inc = _wrap(torch.cumsum(cnt, 0), 32)
    blk0g = _wrap(inc - cnt, 32)
    blk0 = _wrap(blk0g - blk0g[img_start], 32)
    total = _wrap(inc[img_last] - blk0g[img_start], 32)
    ok = (merged[:, 0] != 0).all() & (total >= blocks_per_img).all() \
        & (blk0 >= 0).all() & (blk0 <= blocks_per_img).all()
    dexc = _wrap(torch.cumsum(dcs, 0) - dcs, 32)
    pred0 = _wrap(dexc - dexc[img_start], 32)
    return blk0, pred0, ok


def spec_decode_full(u32win, luts, zz, comp_of_sub, tclass_of_sub, bmap,
                     bit0, bit_end, first, img_start, img_last, img_base,
                     bpm: int, out_size: int, blocks_per_img: int,
                     max_steps: int, unroll: int = 1):
    """The speculative pipeline through the plain versions: snapshot
    and scan from guessed block-aligned entries, merge from each
    predecessor's exit, the segmented prefix sums, then the emission
    pass (``decode_lanes_bmap`` with entry states and bit_stop).
    Returns (flat int16 coefficients, ok 0-d bool tensor)."""
    zeros = torch.zeros_like(bit0)
    snap = spec_snap_lanes(u32win, luts, comp_of_sub, tclass_of_sub, bit0,
                           bit_end, bpm)
    eb, ek, es, cnt1, dcs1 = spec_scan_lanes(
        u32win, luts, comp_of_sub, tclass_of_sub, bit0, bit_end, zeros,
        zeros, bpm, max_steps)
    exits = torch.cat([torch.stack([eb, ek, es, cnt1], dim=1), dcs1], dim=1)
    ent = spec_entries(exits, first, bit0)
    matched, midx, mblk, mdc = spec_merge_lanes(
        u32win, luts, comp_of_sub, tclass_of_sub, ent[:, 0], ent[:, 1],
        ent[:, 2], bpm, snap)
    merged = torch.cat([torch.stack([matched.to(torch.int64), midx, mblk],
                                    dim=1), mdc], dim=1)
    blk0, pred0, ok = spec_stitch(exits, snap, merged, img_start, img_last,
                                  blocks_per_img)
    flat, _steps = decode_lanes_bmap(
        u32win, luts, zz, comp_of_sub, tclass_of_sub, bmap, ent[:, 0], blk0,
        torch.full_like(blk0, blocks_per_img), img_base, bpm, out_size,
        max_steps, k0=ent[:, 1], sub0=ent[:, 2], pred0=pred0, bit_stop=eb)
    return flat, ok


# ---------------------------------------------------------------------------
# stage entries: the kernels on CUDA, the plain versions on the CPU
# ---------------------------------------------------------------------------

class Staged:
    """A batch's entropy inputs on one device: ``data`` the destuffed
    bytes with PAD zero bytes after them (uint8), ``n`` their count
    without the padding, ``luts`` (G*4, 65536) and their ``fast`` tables
    (G*4, 2**FAST_BITS) uint32 values as int32 (``fast_tables(luts)``
    unless given), ``zz``, ``comp_of_sub``, ``tclass_of_sub`` and
    ``bmap`` int32."""

    def __init__(self, concat: np.ndarray, luts: np.ndarray, consts: dict,
                 bmap: np.ndarray, device: torch.device,
                 fast: np.ndarray | None = None):
        if len(concat) == 0:
            raise Declined("device entropy decode: empty scan")
        self.n = len(concat)
        self.device = device
        padded = np.zeros(self.n + PAD, np.uint8)
        padded[:self.n] = concat
        self.data = to_device(padded, device)
        self.luts = to_device(np.ascontiguousarray(luts, np.uint32)
                              .view(np.int32), device)
        if fast is None:
            fast = fast_tables(luts)
        self.fast = to_device(np.ascontiguousarray(fast, np.uint32)
                              .view(np.int32), device)
        self.zz = to_device(np.asarray(ZIGZAG, np.int32), device)
        self.comp_of_sub = to_device(consts["comp_of_sub"], device)
        self.tclass_of_sub = to_device(consts["tclass_of_sub"], device)
        self.bmap = to_device(np.ascontiguousarray(bmap, np.int32), device)
        self.bpm = consts["bpm"]
        self._u32win = None

    @property
    def u32win(self) -> torch.Tensor:
        """The plain versions' sliding windows, made once."""
        if self._u32win is None:
            self._u32win = torch.from_numpy(sliding_u32(
                self.data[:self.n].cpu().numpy()).astype(np.int64)).to(
                    self.device)
        return self._u32win


def decode_lanes(st: Staged, lanes: torch.Tensor, plan: torch.Tensor,
                 out_size: int, max_steps: int = MAX_STEPS):
    """Decode the lanes of the (L, LANE_COLS) int32 table ``lanes`` into
    int16[out_size] flat coefficients: K9 on CUDA, ``decode_lanes_bmap``
    on the CPU.  ``plan`` is K9's CTA plan of the lanes (``cta_plan`` of
    their lut_idx column, (C, 3) int32 on the same device).  On the CPU
    it is checked against the lanes (ValueError); on CUDA a lane whose
    lut_idx is not its CTA's group stops the launch (``cuda_entropy.
    entropy_decode``).  Returns (flat, int32[L] symbols each lane
    decoded)."""
    if _on_cuda(st.data):
        from ffpic_tpu_torch.ops import cuda_entropy
        return cuda_entropy.entropy_decode(
            st.data, st.n, st.luts, st.fast, st.zz, st.comp_of_sub,
            st.tclass_of_sub, st.bmap, lanes, plan, st.bpm, out_size,
            max_steps)
    check_plan(plan.numpy(), lanes[:, 4].numpy())
    return decode_lanes_plain(st, lanes, out_size, max_steps)


def decode_lanes_plain(st: Staged, lanes: torch.Tensor, out_size: int,
                       max_steps: int = MAX_STEPS):
    """``decode_lanes`` through ``decode_lanes_bmap`` on any device."""
    c = lanes.to(torch.int64)
    return decode_lanes_bmap(
        st.u32win, st.luts, st.zz, st.comp_of_sub, st.tclass_of_sub, st.bmap,
        c[:, 0], c[:, 1], c[:, 2], c[:, 3], st.bpm, out_size, max_steps,
        lut_idx=c[:, 4], bmap_base=c[:, 5], k0=c[:, 6], sub0=c[:, 7],
        pred0=c[:, 8:11], bit_stop=c[:, 11])


def spec_scan(st: Staged, chunks: torch.Tensor, max_steps: int = MAX_STEPS):
    """Both passes from each chunk's (bit0, k=0, sub=0), ``chunks`` (L,
    2) int32 (bit0, bit_end): K10 on CUDA, ``spec_snap_lanes`` and
    ``spec_scan_lanes`` on the CPU.  Returns (exits (L, 7) int32: exit
    bit, k, sub, blocks, DC sums; snapshots (L, SNAP, 7) int32)."""
    if _on_cuda(st.data):
        from ffpic_tpu_torch.ops import cuda_entropy
        return cuda_entropy.spec_scan(st.data, st.n, st.luts, st.fast,
                                      st.comp_of_sub, st.tclass_of_sub,
                                      chunks, st.bpm, max_steps)
    return spec_scan_plain(st, chunks, max_steps)


def spec_scan_plain(st: Staged, chunks: torch.Tensor,
                    max_steps: int = MAX_STEPS):
    """``spec_scan`` through ``spec_snap_lanes`` and ``spec_scan_lanes``
    on any device."""
    bit0, bit_end = chunks[:, 0], chunks[:, 1]
    zeros = torch.zeros_like(bit0)
    snap = spec_snap_lanes(st.u32win, st.luts, st.comp_of_sub,
                           st.tclass_of_sub, bit0, bit_end, st.bpm)
    eb, ek, es, cnt, dcs = spec_scan_lanes(
        st.u32win, st.luts, st.comp_of_sub, st.tclass_of_sub, bit0, bit_end,
        zeros, zeros, st.bpm, max_steps)
    exits = torch.cat([torch.stack([eb, ek, es, cnt], dim=1), dcs], dim=1)
    return exits.to(torch.int32), snap.to(torch.int32)


def spec_merge(st: Staged, ent: torch.Tensor, snap: torch.Tensor):
    """Merge from the true entries ``ent`` (L, 3) int32 against the
    snapshots: K11 on CUDA, ``spec_merge_lanes`` on the CPU.  Returns
    (L, 6) int32: matched, midx, blocks, DC sums."""
    if _on_cuda(st.data):
        from ffpic_tpu_torch.ops import cuda_entropy
        return cuda_entropy.spec_merge(st.data, st.n, st.luts, st.fast,
                                       st.comp_of_sub, st.tclass_of_sub, ent,
                                       snap, st.bpm)
    return spec_merge_plain(st, ent, snap)


def spec_merge_plain(st: Staged, ent: torch.Tensor, snap: torch.Tensor):
    """``spec_merge`` through ``spec_merge_lanes`` on any device."""
    matched, midx, mblk, mdc = spec_merge_lanes(
        st.u32win, st.luts, st.comp_of_sub, st.tclass_of_sub, ent[:, 0],
        ent[:, 1], ent[:, 2], st.bpm, snap)
    return torch.cat([torch.stack([matched.to(torch.int64), midx, mblk],
                                  dim=1), mdc], dim=1).to(torch.int32)


# ---------------------------------------------------------------------------
# host orchestration
# ---------------------------------------------------------------------------

def _parse(datas) -> list:
    from ffpic_tpu_torch.formats import jpg
    return [jpg.parse_and_decode(d, skip_decode=True)[0] for d in datas]


def _destuff(datas):
    """Destuffed scans: (concat uint8, per-image byte offsets, per-image
    segment bounds)."""
    from ffpic_tpu_torch import native
    bufs, offs, bounds = [], [], []
    off = 0
    for d in datas:
        scan = extract_scan(d)
        try:
            buf, b = native.jpeg_destuff(scan)
        except ValueError as e:          # more segments than it splits
            raise Declined(str(e)) from e
        bufs.append(buf)
        bounds.append(b)
        offs.append(off)
        off += len(buf)
    return np.concatenate(bufs), offs, bounds


def quant_stack(js, comp: int, device) -> torch.Tensor:
    """(N, 64) int32 quant tables of component ``comp`` of each image,
    raster order, on ``device``."""
    return to_device(np.stack([j.dqt[j.comps[comp].tq]
                               for j in js]).astype(np.int32), device)


def _dense(flat, js, qjs, order, mode, device):
    """The dense stage over ``flat``, one image after the other from
    offset 0 in ``js``'s geometry (all the same): a view, K2 + K3 on
    CUDA; per-image quant tables from ``qjs``.  Padded (N, H8, W8, 4)."""
    from ffpic_tpu_torch.ops.jpeg_kernels import decode_batch_420_dense
    j = js[0]
    shapes = tuple((c.nby, c.nbx) for c in j.comps)
    nb = sum(a * b for a, b in shapes)
    coeffs = flat[:len(js) * nb * 64].view(len(js), nb, 8, 8)
    return decode_batch_420_dense(coeffs, quant_stack(qjs, 0, device),
                                  quant_stack(qjs, 1, device), shapes,
                                  order=order, mode=mode)


def assemble_planes(flat, n_imgs: int, j):
    """Split the flat output into per-component coefficient tensors (N,
    nby, nbx, 8, 8) -- views."""
    comp_space = 0
    spans = []
    for c in j.comps:
        spans.append((comp_space, c.nby, c.nbx))
        comp_space += c.nby * c.nbx
    body = flat[:-1].view(n_imgs, comp_space * 64)
    return [body[:, base * 64:(base + nby * nbx) * 64]
            .view(n_imgs, nby, nbx, 8, 8) for base, nby, nbx in spans]


def decode_coeffs_device(datas, max_steps: int = MAX_STEPS, unroll: int = 1,
                         device=None):
    """Device entropy decode of a batch of same-geometry baseline JPEGs
    with restart intervals, one lane per restart segment (K9 on CUDA),
    every image decoded with the first one's tables, geometry and
    restart interval, as the reference does.  Returns (flat
    int16[N * comp_space * 64 + 1] on the device, js, consts, steps:
    int32[L] each lane's symbol count, whose maximum is JAX's steps)."""
    dev = resolve_device(device, "decode_coeffs_device")
    with stage("torch.entropy.parse"):
        js = _parse(datas)
    j0 = js[0]
    if j0.restart_interval <= 0:
        raise Declined("device entropy path needs DRI > 0")
    st, lanes, plan, out_size, _off = stage_dri(datas, [j0] * len(datas),
                                                dev)
    with stage("torch.entropy.device"):
        flat, steps = decode_lanes(st, lanes, plan, out_size, max_steps)
    return flat, js, prepare_frame(j0), steps


def stage_dri(datas, js, device):
    """Stage a mixed batch of eligible DRI JPEGs for ONE entropy launch
    -- any sizes and any Huffman tables together (per-lane table-group
    and block-map indices; eligible() guarantees 4:2:0, so bpm and the
    sub-block maps agree).  The images are laid out geometry group by
    geometry group (groups in order of first appearance), so that each
    group's coefficients are one contiguous run.  Returns (Staged, lanes
    (L, LANE_COLS) int32 on ``device``, their CTA plan (``cta_plan``, on
    ``device``), out_size, per-image flat offsets in input order)."""
    order: dict = {}
    for i, j in enumerate(js):
        order.setdefault((j.mcus_x, j.mcus_y), []).append(i)
    seq = [i for idxs in order.values() for i in idxs]

    with stage("torch.entropy.lut"):
        lut_list, fast_list, lut_key_to_idx, img_lut = [], [], {}, {}
        for i in seq:
            key = _dht_key(js[i])
            if key not in lut_key_to_idx:
                lut_key_to_idx[key] = len(lut_list)
                lut_list.append(luts_for(js[i]))
                fast_list.append(fast_for(js[i]))
            img_lut[i] = lut_key_to_idx[key]
        luts = np.concatenate(lut_list, axis=0)        # (G*4, 65536)
        fast = np.concatenate(fast_list, axis=0)

    geo, bmap_parts, bmap_off, boff = {}, [], {}, 0
    for gk, idxs in order.items():
        geo[gk] = prepare_frame(js[idxs[0]])
        bmap_off[gk] = boff
        bmap_parts.append(np.asarray(geo[gk]["bmap"]))
        boff += bmap_parts[-1].shape[0]
    c0 = geo[next(iter(order))]

    with stage("torch.entropy.destuff"):
        concat, offs, all_bounds = _destuff([datas[i] for i in seq])
    bpm = c0["bpm"]
    rows, img_out_off = [], [0] * len(js)
    out_off = 0
    for pos, i in enumerate(seq):
        j = js[i]
        gk = (j.mcus_x, j.mcus_y)
        cst = geo[gk]
        img_out_off[i] = out_off
        dri_blocks = j.restart_interval * bpm
        bounds = all_bounds[pos]
        for s in range(len(bounds) - 1):
            rows.append(((offs[pos] + bounds[s]) * 8, s * dri_blocks,
                         min((s + 1) * dri_blocks, cst["blocks_per_img"]),
                         out_off, img_lut[i], bmap_off[gk]))
        out_off += cst["comp_space"] * 64
    r = np.array(rows, np.int64).reshape(-1, 6).T
    with stage("torch.entropy.h2d"):
        st = Staged(concat, luts, c0, np.concatenate(bmap_parts), device,
                    fast)
        lanes = to_device(lane_table(*r[:4], lut_idx=r[4], bmap_base=r[5]),
                          device)
        plan = to_device(cta_plan(r[4]), device)
    return st, lanes, plan, out_off + 1, img_out_off


def decode_coeffs_device_mixed(datas, js, max_steps: int = MAX_STEPS,
                               unroll: int = 1, device=None):
    """ONE entropy launch (K9 on CUDA) for a mixed batch of eligible DRI
    JPEGs, staged by ``stage_dri``.  Returns (flat int16 coefficients,
    per-image flat offsets in input order, int32[L] each lane's symbol
    count)."""
    dev = resolve_device(device, "decode_coeffs_device_mixed")
    st, lanes, plan, out_size, img_out_off = stage_dri(datas, js, dev)
    with stage("torch.entropy.device"):
        flat, steps = decode_lanes(st, lanes, plan, out_size, max_steps)
    return flat, img_out_off, steps


def decode_batch_dri_mixed(datas, js, order="rgba", mode="bt601",
                           unroll: int | None = None, device=None):
    """Mixed DRI batch: one merged entropy launch, then one dense
    decode (K2 + K3) per geometry group over its contiguous run of the
    flat output, per-image quant tables.  Returns {image index: uint8
    (H8, W8, 4) tensor} (MCU-padded size)."""
    dev = resolve_device(device, "decode_batch_dri_mixed")
    flat, img_off, _steps = decode_coeffs_device_mixed(datas, js,
                                                       device=dev)
    groups: dict = {}
    for i, j in enumerate(js):
        groups.setdefault((j.mcus_x, j.mcus_y), []).append(i)
    out = {}
    with stage("torch.entropy.dense"):
        for idxs in groups.values():
            gjs = [js[i] for i in idxs]
            res = _dense(flat[img_off[idxs[0]]:], gjs, gjs, order, mode, dev)
            for k, i in enumerate(idxs):
                out[i] = res[k]
    return out


def decode_batch_device_entropy(datas, order="rgba", mode="bt601",
                                unroll: int = 1, device=None):
    """End to end for same-geometry DRI JPEGs: device entropy decode,
    then the dense stage with the first image's quant tables for all, as
    the reference does.  Returns uint8 (N, H8, W8, 4)."""
    dev = resolve_device(device, "decode_batch_device_entropy")
    flat, js, _consts, _steps = decode_coeffs_device(datas, device=dev)
    return _dense(flat, js, [js[0]] * len(js), order, mode, dev)


def decode_batch_dri(datas, js, order="rgba", mode="bt601",
                     unroll: int | None = None, device=None):
    """Batched decode for same-key DRI JPEGs: device entropy, then the
    dense stage with per-image quant tables.  Returns uint8 (N, H8, W8,
    4)."""
    dev = resolve_device(device, "decode_batch_dri")
    flat, js2, _consts, _steps = decode_coeffs_device(datas, device=dev)
    return _dense(flat, js2, js, order, mode, dev)


def spec_chunks(lens, chunk_bytes: int):
    """The chunk table of the speculative decoder over scans of byte
    lengths ``lens`` laid end to end: (bit0, bit_end, lane_img) int64.
    The tail joins the last chunk, so every chunk is at least about half
    a chunk long and a predecessor's exit lands inside the next one."""
    bit0, bit_end, lane_img = [], [], []
    off = 0
    for i, n in enumerate(lens):
        nch = max(1, n // chunk_bytes)
        for c in range(nch):
            bit0.append((off + c * chunk_bytes) * 8)
            bit_end.append((off + ((c + 1) * chunk_bytes
                                   if c + 1 < nch else n)) * 8)
            lane_img.append(i)
        off += n
    return (np.array(bit0, np.int64), np.array(bit_end, np.int64),
            np.array(lane_img, np.int64))


def spec_stages(datas, chunk_bytes: int = 1024, max_steps: int = MAX_STEPS,
                device=None) -> dict:
    """The speculative decoder's stages for DRI-LESS baseline JPEGs of
    one geometry and one set of tables: chunks of ``chunk_bytes``
    decoded speculatively (``spec_scan``: K10), merged from each
    predecessor's exit (``spec_merge``: K11), stitched by segmented
    prefix sums (torch), then emitted (``decode_lanes``: K9); the plain
    versions on the CPU.  Returns what each stage made, on the device:
    ``exits``, ``snap``, ``merged``, the emission's ``lanes`` (one table
    group) and CTA ``plan``, ``flat`` and ``steps``, and ``ok`` (a 0-d bool tensor, not read back), with
    ``js``, ``consts``, the lane count ``L``, the ``staged`` inputs, the
    ``chunks`` table (bit0, bit_end) and the true entries ``ent``."""
    dev = resolve_device(device, "spec_stages")
    with stage("torch.entropy.parse"):
        js = _parse(datas)
    j0 = js[0]
    consts = prepare_frame(j0)
    with stage("torch.entropy.lut"):
        luts, fast = luts_for(j0), fast_for(j0)
    with stage("torch.entropy.destuff"):
        concat, offs, _bounds = _destuff(datas)
    bit0, bit_end, lane_img = spec_chunks(np.diff([*offs, len(concat)]),
                                          chunk_bytes)
    L = len(bit0)
    starts = np.searchsorted(lane_img, np.arange(len(datas)))
    lasts = np.concatenate([starts[1:], [L]]) - 1
    first = np.zeros(L, bool)
    first[starts] = True
    comp_space = consts["comp_space"]
    blocks_per_img = consts["blocks_per_img"]
    out_size = len(datas) * comp_space * 64 + 1
    with stage("torch.entropy.h2d"):
        st = Staged(concat, luts, consts, consts["bmap"], dev, fast)
        table = to_device(np.stack([
            bit0, bit_end, first, starts[lane_img], lasts[lane_img],
            lane_img * comp_space * 64], axis=1).astype(np.int32), dev)
        plan = to_device(cta_plan(np.zeros(L, np.int64)), dev)
    with stage("torch.entropy.device"):
        exits, snap = spec_scan(st, table[:, :2].contiguous(), max_steps)
        ent = spec_entries(exits, table[:, 2] != 0, table[:, 0])
        merged = spec_merge(st, ent, snap)
        blk0, pred0, ok = spec_stitch(exits, snap, merged, table[:, 3],
                                      table[:, 4], blocks_per_img)
        i64 = torch.int64
        zeros = torch.zeros_like(blk0)
        lanes = torch.cat([
            torch.stack([ent[:, 0].to(i64), blk0, zeros + blocks_per_img,
                         table[:, 5].to(i64), zeros, zeros,
                         ent[:, 1].to(i64), ent[:, 2].to(i64)], dim=1),
            pred0, exits[:, :1].to(i64)], dim=1).to(torch.int32)
        flat, steps = decode_lanes(st, lanes, plan, out_size, max_steps)
    return {"exits": exits, "snap": snap, "merged": merged, "lanes": lanes,
            "plan": plan, "flat": flat, "steps": steps, "ok": ok, "js": js,
            "consts": consts, "L": L, "staged": st,
            "chunks": table[:, :2].contiguous(), "ent": ent}


def decode_coeffs_device_spec(datas, chunk_bytes: int = 1024,
                              max_steps: int = MAX_STEPS, unroll: int = 1,
                              device=None):
    """Device entropy decode for DRI-LESS baseline JPEGs (``spec_stages``).
    Raises ``Declined`` when a chunk failed to self-synchronise or the
    block totals do not reconcile (``ok`` is read back once; the caller
    takes the host path).  Returns (flat int16 coefficients, js,
    consts, lanes)."""
    r = spec_stages(datas, chunk_bytes, max_steps, device)
    if not bool(r["ok"]):
        raise Declined(
            "speculative entropy decode: a chunk failed to "
            "self-synchronize or block totals do not reconcile -- "
            "host path fallback")
    return r["flat"], r["js"], r["consts"], r["L"]


def decode_batch_device_entropy_spec(datas, order="rgba", mode="bt601",
                                     chunk_bytes: int = 1024,
                                     unroll: int | None = None, device=None):
    """End-to-end DRI-less device decode: speculative entropy, then the
    dense stage, per-image quant tables.  Returns uint8 (N, H8, W8, 4)."""
    dev = resolve_device(device, "decode_batch_device_entropy_spec")
    flat, js, _consts, _lanes = decode_coeffs_device_spec(
        datas, chunk_bytes=chunk_bytes, device=dev)
    return _dense(flat, js, js, order, mode, dev)


def decode_batch_spec(datas, js, order="rgba", mode="bt601",
                      chunk_bytes: int = 4096, unroll: int | None = None,
                      device=None):
    """Batched decode for same-(geometry, tables) DRI-LESS JPEGs via the
    speculative device entropy path, per-image quant tables.  Raises
    ``Declined`` when the self-sync cannot be verified (the caller falls
    back to the host path).  Returns uint8 (N, H8, W8, 4)."""
    dev = resolve_device(device, "decode_batch_spec")
    flat, js2, _consts, _lanes = decode_coeffs_device_spec(
        datas, chunk_bytes=chunk_bytes, device=dev)
    return _dense(flat, js2, js, order, mode, dev)
