"""Batched JPEG decode into one ``(N, H, W, 4)`` uint8 device tensor.

The PyTorch counterpart of ``ffpic_tpu.pipeline.decode_batch`` for
batches of JPEGs:

1. Host pass, in a thread pool (the native parsers release the GIL):
   3-component 4:2:0 baseline files are Huffman-decoded into the packed
   emission, progressive ones into dense coefficient planes.  Any other
   JPEG (another sampling, gray) is Huffman-decoded there into dense
   planes of its first picture.  The pool does no device work: every
   copy and launch below runs on the caller's thread, so on the
   caller's current stream.
2. Each other JPEG is decoded as the port's registry decodes it, as
   ``ffpic_tpu/pipeline.py:182-212`` does through ``registry.load``:
   ``jpg.to_pic`` with the registry's defaults (``mode="reference"``,
   nearest upsampling, not ``decode_batch``'s ``mode``), 8-aligned wide,
   malformed files raising ``ValueError``.  Its pixels stay on the
   device.
3. Per 4:2:0 image size (one block geometry and one crop), ONE staged
   transfer through pinned memory and one device decode: the packed
   members through ``decode_batch_420_packed_fused`` (a single member is
   the same route with N=1), the dense ones through
   ``decode_batch_420_dense``.  Both write the cropped images.
4. Optional resize to ``size``, and stacking in input order; a batch
   that one decode covers in input order is returned as it is.

The host layer (``formats.jpg``, ``native``) is the port's own copy of
``ffpic_tpu``'s; ``_read`` and ``_jpeg_420_plan`` are copied from
``ffpic_tpu/pipeline.py:29-70``.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

from ffpic_tpu_torch.formats import jpg, registry
from ffpic_tpu_torch.formats.jpg import packed_block_map
from ffpic_tpu_torch.ops import jpeg_kernels as jk
from ffpic_tpu_torch.ops.resize import resize_rgba
from ffpic_tpu_torch.utils.device import resolve_device, to_device
from ffpic_tpu_torch.utils.trace import device_trace, stage

_CODECS_ITEM = ("ROADMAP.md Queue 1 items 1 and 7-9 (the other codecs of the "
                "registry)")


def _read(src) -> bytes:
    if isinstance(src, (bytes, bytearray, memoryview)):
        return bytes(src)
    with open(src, "rb") as f:
        return f.read()


def _jpeg_420_plan(data: bytes):
    """The coefficient plan of a baseline or progressive 3-component
    4:2:0 JPEG, else None: the packed emission (``j.packed``) for a
    single-scan baseline file, dense raster-order planes otherwise."""
    try:
        j, _ = jpg.parse_and_decode(data, packed=True)
    except jpg.PackedIneligible:
        try:
            j, _ = jpg.parse_and_decode(data)
        except ValueError:
            return None
    except ValueError:
        return None
    if len(j.comps) != 3:
        return None
    if [(c.v, c.h) for c in j.comps] != [(2, 2), (1, 1), (1, 1)]:
        return None
    return j


def _quant(members, comp: int, device) -> torch.Tensor:
    return to_device(np.stack([j.dqt[j.comps[comp].tq]
                               for _i, j in members]).astype(np.int32), device)


def _prep(data: bytes) -> tuple[jpg.JpegFile, bool]:
    """A member's host work: (its 4:2:0 plan, True), or, for any other
    JPEG, (the dense planes of its first picture, False)."""
    j = _jpeg_420_plan(data)
    if j is None:
        if not jpg.probe(data):
            raise NotImplementedError(
                "decode_batch: only JPEG members are ported; other formats "
                f"wait for {_CODECS_ITEM}")
        with registry.corrupt_as_value_error("JPG"):
            return jpg.parse_and_decode(data)[0], False
    if j.packed is not None:
        # the packed emission is a view of per-thread native scratch that
        # the next parse on this thread overwrites
        c, k, v, nnz = j.packed
        j.packed = (np.array(c), np.array(k), np.array(v), nnz)
    return j, True


def decode_batch(srcs: Sequence, size: tuple[int, int] | None = None,
                 mode: str = "bt601", device=None, mesh=None) -> torch.Tensor:
    """Decode a batch of JPEGs (paths or bytes) to one ``(N, H, W, 4)``
    uint8 RGBA tensor on ``device`` (default CUDA; it raises when CUDA
    is absent).  ``size=(h, w)`` resizes each image; without it all
    images must share one size.  ``mode`` is the colour conversion of
    the 4:2:0 members: "bt601", "reference" or "rgb"."""
    if mesh is not None:
        raise NotImplementedError(
            "decode_batch(mesh=) waits for ROADMAP.md Queue 1 item 11")
    if os.environ.get("FFPIC_DEVICE_ENTROPY") == "1":
        raise NotImplementedError(
            "device entropy decode waits for ROADMAP.md Queue 1 item 10")
    dev = resolve_device(device, "decode_batch")
    n = len(srcs)
    slots: list = [None] * n

    env_t = os.environ.get("FFPIC_THREADS")
    nw = max(1, min(int(env_t) if env_t else (os.cpu_count() or 1), n or 1))
    with stage("torch.host_parse"):
        datas = [_read(s) for s in srcs]
        if nw > 1:
            with ThreadPoolExecutor(max_workers=nw) as ex:
                plans = list(ex.map(_prep, datas))
        else:
            plans = [_prep(d) for d in datas]

    # one bucket per 4:2:0 image size: one block geometry and one crop
    buckets: dict[tuple, list] = {}
    for i, (j, is_420) in enumerate(plans):
        if is_420:
            buckets.setdefault((j.height, j.width), []).append((i, j))
            continue
        with stage("torch.device_decode"), \
                registry.corrupt_as_value_error("JPG"):
            slots[i] = jpg.to_pic(j, dev).pixels

    outs = []
    for allmembers in buckets.values():
        j0 = allmembers[0][1]
        shapes = tuple((c.nby, c.nbx) for c in j0.comps)
        hw = (j0.height, j0.width)
        for packed in (True, False):
            members = [(i, j) for i, j in allmembers
                       if (j.packed is not None) == packed]
            if not members:
                continue
            with stage("torch.pack"):
                if packed:
                    host, g, e = jk.stack_packed_fused(
                        [j.packed for _i, j in members])
                else:
                    host = np.stack([np.concatenate(
                        [c.reshape(-1, 64) for c in j.coeffs])
                        for _i, j in members]).reshape(len(members), -1, 8, 8)
            with stage("torch.h2d"):
                yq = _quant(members, 0, dev)
                cq = _quant(members, 1, dev)
                staged = to_device(host, dev)
                if packed:
                    bmap = packed_block_map(j0, dev)
            with stage("torch.device_decode"), device_trace("decode_420", dev):
                if packed:
                    out = jk.decode_batch_420_packed_fused(
                        staged, bmap, yq, cq, len(members), g, e, shapes,
                        order="rgba", mode=mode, hw=hw)
                else:
                    out = jk.decode_batch_420_dense(
                        staged, yq, cq, shapes, order="rgba", mode=mode,
                        hw=hw)
            outs.append(out)
            for k, (i, _j) in enumerate(members):
                slots[i] = out[k]

    with stage("torch.finish"), device_trace("resize_stack", dev):
        if size is None:
            if len(outs) == 1 and outs[0].shape[0] == n:
                return outs[0]      # one decode, in input order
            if len({tuple(s.shape) for s in slots}) != 1:
                raise ValueError(
                    "mixed sizes: pass size=(H, W) to resize on device")
            return torch.stack(slots)
        return torch.stack([resize_rgba(s, tuple(size)) for s in slots])
