"""ctypes wrappers of the CUDA kernels in ``csrc/jpeg_entropy.cu``: K9
``entropy_decode``, K10 ``spec_scan`` and K11 ``spec_merge``.

As in ``ops.cuda_jpeg``: each wrapper takes CUDA tensors only, checks
device, dtype, shape and layout and raises on anything else, allocates
its outputs with ``torch.empty``, launches on the current stream and
raises if the launch reports an error, without synchronising.  A check
raises ValueError, which ``decode_batch``'s device-entropy route lets
through: only ``jpeg_entropy_device.Declined`` sends files to the host
path.  ``launches`` counts each kernel's launches.  The plain PyTorch versions
live in ``ops.jpeg_entropy_device``; the kernels never run on the CPU.

Common inputs: ``data``, the destuffed scan bytes (uint8, ``n`` of them,
then at least ``PAD`` zero bytes, 4-byte aligned); ``luts``, (G*4,
65536) uint32 table entries stored as int32; ``fast``, their fast tables
(``jpeg_entropy_device.fast_tables``: (G*4, 2**b) int32, b the built
kernels' width, FAST_BITS unless built otherwise: the launchers refuse
another), which K9-K11 copy into shared memory; ``comp_of_sub`` and
``tclass_of_sub``, int32[bpm], the table classes 0 or 1 (K9-K11 read a
class past 1 as 1).
"""

from __future__ import annotations

import ctypes

import torch

from ffpic_tpu_torch.ops import _build
from ffpic_tpu_torch.ops.jpeg_entropy_device import (LANE_COLS, PAD, SNAP,
                                                     SNAP_STRIDE)

launches = {"entropy_decode": 0, "spec_scan": 0, "spec_merge": 0}
MAX_BPM = 16       # sub-blocks an MCU that K9-K11 take (JPEG: 10)

_vp = ctypes.c_void_p
_int = ctypes.c_int
_SIGNATURES = {
    "ffpic_entropy_decode": [_vp, _int, _vp, _vp, _int, _int, _vp, _vp, _vp,
                             _vp, _int, _vp, _int, _vp, _int, _int, _vp,
                             _int, _int, _vp, _int, _vp],
    "ffpic_spec_scan": [_vp, _int, _vp, _vp, _int, _vp, _vp, _int, _vp, _int,
                        _int, _vp, _vp, _int, _int, _vp],
    "ffpic_spec_merge": [_vp, _int, _vp, _vp, _int, _vp, _vp, _int, _vp,
                         _int, _vp, _int, _vp, _vp],
}
_launch = _build.launcher(_SIGNATURES, launches)
_INT_MAX = 2 ** 31 - 1


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check(t, name: str, dtype: torch.dtype, shape: tuple | None = None):
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got "
                         f"{getattr(t, 'device', type(t))}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 4:
        raise ValueError(f"{name}: must be contiguous and 4-byte aligned")


def _common(data, n: int, luts, comp_of_sub, tclass_of_sub, groups=None,
            fast=None):
    _check(data, "data", torch.uint8)
    if not 0 < n <= _INT_MAX // 8 - PAD or data.numel() < n + PAD:
        raise ValueError(f"data: {data.numel()} bytes for {n} scan bytes "
                         f"and {PAD} of padding")
    _check(luts, "luts", torch.int32)
    if luts.dim() != 2 or luts.shape[1] != 65536 or luts.shape[0] % 4 or \
            (groups is not None and luts.shape[0] != 4 * groups):
        raise ValueError(f"luts: expected (G*4, 65536), got "
                         f"{tuple(luts.shape)}")
    if fast is not None:
        _check(fast, "fast", torch.int32)
        if fast.dim() != 2 or fast.shape[0] != luts.shape[0] or \
                fast.shape[1] < 2 or fast.shape[1] & (fast.shape[1] - 1):
            raise ValueError(f"fast: expected ({luts.shape[0]}, 2**bits), "
                             f"got {tuple(fast.shape)}")
        if fast.data_ptr() % 16:
            raise ValueError("fast: must be 16-byte aligned (the CTAs copy "
                             "it into shared memory 16 bytes at a time)")
    bpm = comp_of_sub.numel()
    _check(comp_of_sub, "comp_of_sub", torch.int32, (bpm,))
    _check(tclass_of_sub, "tclass_of_sub", torch.int32, (bpm,))
    if bpm == 0:
        raise ValueError("comp_of_sub: empty")
    if fast is not None and bpm > MAX_BPM:
        raise ValueError(f"comp_of_sub: {bpm} sub-blocks, K9-K11 take "
                         f"at most {MAX_BPM}")
    return _vp(data.data_ptr()), _vp(luts.data_ptr()), \
        _vp(comp_of_sub.data_ptr()), _vp(tclass_of_sub.data_ptr())


def _fast_bits(fast) -> int:
    return fast.shape[1].bit_length() - 1


def entropy_decode(data, n: int, luts, fast, zz, comp_of_sub, tclass_of_sub,
                   bmap, lanes, plan, bpm: int, out_size: int,
                   max_steps: int):
    """K9: decode the lanes of ``lanes`` ((L, LANE_COLS) int32, as
    ``jpeg_entropy_device.lane_table``) into int16[out_size] flat
    coefficients, zeroed first.  ``plan`` ((C, 3) int32 rows group,
    first lane, lane count; ``jpeg_entropy_device.cta_plan``) gives one
    CTA each: it decodes its lanes with its group's tables.  A lane
    whose lut_idx is not its row's group stops the launch (``__trap``):
    the stream's next synchronisation raises, and the process's CUDA
    context is lost, as after any device fault.  A lane no row covers
    decodes nothing (the caller's duty: checking it here would wait for
    the card).  Block-map reads are clamped into ``bmap``.  Returns (flat,
    int32[L] symbols each lane decoded)."""
    ptrs = _common(data, n, luts, comp_of_sub, tclass_of_sub, fast=fast)
    if bpm != comp_of_sub.numel():
        raise ValueError(f"bpm {bpm} != {comp_of_sub.numel()} sub-blocks")
    _check(zz, "zz", torch.int32, (64,))
    _check(bmap, "bmap", torch.int32)
    _check(lanes, "lanes", torch.int32)
    if lanes.dim() != 2 or lanes.shape[1] != LANE_COLS:
        raise ValueError(f"lanes: expected (L, {LANE_COLS}), got "
                         f"{tuple(lanes.shape)}")
    nl = lanes.shape[0]
    _check(plan, "plan", torch.int32)
    if plan.dim() != 2 or plan.shape[1] != 3 or (nl > 0) != (plan.shape[0]
                                                         > 0):
        raise ValueError(f"plan: expected (C, 3), C > 0 for {nl} lanes, "
                         f"got {tuple(plan.shape)}")
    if not 0 < out_size <= _INT_MAX or bmap.numel() == 0 or \
            bmap.numel() > _INT_MAX or not 0 <= max_steps <= _INT_MAX:
        raise ValueError(f"out_size {out_size}, bmap {bmap.numel()}, "
                         f"max_steps {max_steps}")
    steps = torch.zeros(nl, dtype=torch.int32, device=data.device)
    if nl == 0:
        return torch.zeros(out_size, dtype=torch.int16,
                           device=data.device), steps
    out = torch.empty(out_size, dtype=torch.int16, device=data.device)
    _launch("ffpic_entropy_decode", "entropy_decode", ptrs[0], n, ptrs[1],
            _vp(fast.data_ptr()), luts.shape[0] // 4, _fast_bits(fast),
            _vp(zz.data_ptr()), ptrs[2], ptrs[3], _vp(bmap.data_ptr()),
            bmap.numel(), _vp(lanes.data_ptr()), nl, _vp(plan.data_ptr()),
            plan.shape[0], bpm, _vp(out.data_ptr()), out_size, max_steps,
            _vp(steps.data_ptr()), LANE_COLS)
    return out, steps


def spec_scan(data, n: int, luts, fast, comp_of_sub, tclass_of_sub, chunks,
              bpm: int, max_steps: int):
    """K10: from each chunk's (bit0, k=0, sub=0) of ``chunks`` ((L, 2)
    int32 bit0, bit_end), walk to the first symbol boundary at or past
    bit_end (or max_steps symbols), recording every SNAP_STRIDE-th
    boundary below SNAP*SNAP_STRIDE.  One table group.  Returns (exits
    (L, 7) int32: exit bit, k, sub, blocks, DC sums; snapshots (L, SNAP,
    7) int32, unused slots -1)."""
    ptrs = _common(data, n, luts, comp_of_sub, tclass_of_sub, groups=1,
                   fast=fast)
    if bpm != comp_of_sub.numel() or not 0 <= max_steps <= _INT_MAX:
        raise ValueError(f"bpm {bpm}, max_steps {max_steps}")
    _check(chunks, "chunks", torch.int32)
    if chunks.dim() != 2 or chunks.shape[1] != 2:
        raise ValueError(f"chunks: expected (L, 2), got "
                         f"{tuple(chunks.shape)}")
    nl = chunks.shape[0]
    exits = torch.empty((nl, 7), dtype=torch.int32, device=data.device)
    snap = torch.empty((nl, SNAP, 7), dtype=torch.int32, device=data.device)
    if nl:
        _launch("ffpic_spec_scan", "spec_scan", ptrs[0], n, ptrs[1],
                _vp(fast.data_ptr()), _fast_bits(fast), ptrs[2], ptrs[3],
                bpm,
                _vp(chunks.data_ptr()), nl, max_steps, _vp(exits.data_ptr()),
                _vp(snap.data_ptr()), SNAP, SNAP_STRIDE)
    return exits, snap


def spec_merge(data, n: int, luts, fast, comp_of_sub, tclass_of_sub, ent,
               snap, bpm: int):
    """K11: from each lane's true entry ``ent`` ((L, 3) int32 bit, k,
    sub), walk until the state meets one of the lane's snapshots (K10's
    ``snap``), with K10's step and fast tables.  One table group.
    Returns (L, 6) int32: matched, midx, blocks, DC sums."""
    ptrs = _common(data, n, luts, comp_of_sub, tclass_of_sub, groups=1,
                   fast=fast)
    if bpm != comp_of_sub.numel():
        raise ValueError(f"bpm {bpm} != {comp_of_sub.numel()} sub-blocks")
    _check(ent, "ent", torch.int32)
    nl = ent.shape[0] if ent.dim() == 2 else -1
    if ent.dim() != 2 or ent.shape[1] != 3:
        raise ValueError(f"ent: expected (L, 3), got {tuple(ent.shape)}")
    _check(snap, "snap", torch.int32, (nl, SNAP, 7))
    merged = torch.empty((nl, 6), dtype=torch.int32, device=data.device)
    if nl:
        _launch("ffpic_spec_merge", "spec_merge", ptrs[0], n, ptrs[1],
                _vp(fast.data_ptr()), _fast_bits(fast), ptrs[2], ptrs[3],
                bpm, _vp(ent.data_ptr()), nl,
                _vp(snap.data_ptr()), SNAP, _vp(merged.data_ptr()))
    return merged
