"""Batched decode of JPEGs, PNGs, WebPs, HEIFs and the host-only
codecs' files (BMP, GIF, TGA, PNM, PSD, TIFF, ICO, JPEG 2000, SVG,
OpenEXR, AVIF, raw HEVC) into one ``(N, H, W, 4)`` uint8 device
tensor.

The PyTorch counterpart of ``ffpic_tpu.pipeline.decode_batch`` for
batches of those formats (a BPG member, whose pixels neither package
decodes, raises ``NotImplementedError``; bytes no codec probes the
registry's ``ValueError``):

0. The device-entropy route (``_entropy_runs``, ``_run_entropy``; on
   by default on CUDA; ``FFPIC_DEVICE_ENTROPY``, ``FFPIC_SPEC_ENTROPY``,
   ``FFPIC_HYBRID``, ``FFPIC_HYBRID_FRAC`` as in the reference): DRI
   baseline 4:2:0 members, 4 or more, ship their destuffed entropy
   bytes and are Huffman-decoded on the device in one launch
   (``ops.jpeg_entropy_device``: K9, then K2 and K3 per geometry), and,
   when asked, groups of 4 or more DRI-less ones through the
   speculative decoder (K10, K11, K9, K2, K3).  Once a pass over the
   headers has fixed its members, the pool of step 1 starts on the
   others, and the route stages its bytes and enqueues its launches on
   the caller's thread meanwhile.
1. Host pass over the other members, in a thread pool (the native
   parsers release the GIL):
   3-component 4:2:0 baseline files are Huffman-decoded into the packed
   emission, progressive ones into dense coefficient planes, whose
   nonzeros are packed there too (``member_pairs``).  Any other
   JPEG (another sampling, gray) is Huffman-decoded there into dense
   planes of its first picture; a PNG is parsed, inflated and, where
   its rows use Average or Paeth, unfiltered (``formats.png.parse``); a
   WebP is decoded to RGBA, or under ``FFPIC_VP8_DEVICE_COLOR`` to its
   planes (``formats.webp.parse``, the registry's defaults); a HEIF is
   decoded to RGBA, or under ``FFPIC_HEIF_DEVICE_COLOR`` to its tiles'
   planes (``formats.heif.parse``, the registry's defaults, its grid
   tiles in a pool of their own; the frames of an image sequence are
   not decoded, since only the primary picture is kept); a BMP, GIF,
   TGA, PNM, PSD, TIFF, ICO, JPEG 2000, SVG, OpenEXR, AVIF or raw
   HEVC stream is decoded whole by its codec's ``decode``, as the
   reference's ``registry.load``, and its first picture kept (a GIF's
   first composited frame, a TIFF's first IFD, an ICO's first entry, an
   EXR's first part, an animated AVIF's first track frame, a stream's
   first picture in presentation order).
   The
   pool does no device work, except that under ``FFPIC_VP8_DEVICE`` a
   WebP's and under ``FFPIC_HEVC_DEVICE`` a HEIF's or a raw HEVC
   stream's residual transform launches there, under
   ``FFPIC_HEIF_DEVICE_COLOR`` a raw HEVC stream's colour (K15 a
   picture; its pixels stay on the device), a TIFF's JPEG strips decode
   there (K2, K4, then a read-back) and an ICO's PNG entry (K6, K7; its
   pixels stay on the device), all on the caller's current stream (the launch counts are
   taken under a lock): every other copy and launch below runs on the
   caller's thread, so on the caller's current stream.
2. Each other JPEG, each PNG and each WebP is decoded as the port's
   registry decodes it, as ``ffpic_tpu/pipeline.py:180-190, 211-212``
   does through ``registry.load``: ``jpg.to_pic`` with the registry's
   defaults (``mode="reference"``, nearest upsampling, not
   ``decode_batch``'s ``mode``), 8-aligned wide, ``png.to_pic`` (K6 for
   None/Sub/Up rows, K7), or the first picture of ``webp.to_pics`` (the
   staging copy), or the picture of ``heif.to_pics`` (the staging copy,
   or K15 per tile under ``FFPIC_HEIF_DEVICE_COLOR``); malformed files
   raise ``ValueError``.  Its pixels stay on the device.  The WebP
   stills that kept their planes (``FFPIC_VP8_DEVICE_COLOR``) are
   staged together (``webp.stage_planes``: one pinned buffer, one copy,
   span ``torch.h2d``) and coloured in one K13 launch
   (``vp8_kernels.vp8_yuv_to_rgba_batch``, span
   ``torch.device_decode``): one (k, H, W, 4) tensor where their sizes
   agree, which is the batch itself when every member is such a still
   and ``size`` is None, else a tensor each.  The host codecs' pixels
   are staged together (``staging.stage_rgba``: one pinned buffer, one
   copy, span ``torch.h2d``), as one (k, H, W, 4) tensor where their
   sizes agree, which is again the batch itself when every member is
   such a file and ``size`` is None.
3. Per 4:2:0 image size (one block geometry and one crop), ONE staged
   transfer through pinned memory and one device decode: the packed
   members through ``decode_batch_420_packed_fused`` (a single member is
   the same route with N=1); the dense ones (progressive) by the
   reference's rule (``ffpic_tpu/pipeline.py:283-299``): the pool's
   (index, value) pairs through ``decode_batch_420_sparse`` when they
   take under 0.7 of the dense bytes, else the planes through
   ``decode_batch_420_dense``.  Both routes give the same pixels.  All
   write the cropped images.
4. Optional resize to ``size`` of every slot, each as the reference
   resizes it (``ffpic_tpu/pipeline.py:309-311``):
   ``ops.resize.resize_batch``, K16 on the card (one launch over the
   slots, whatever their sizes, reading a cropped slot in place and
   writing the (N, h, w, 4) batch in input order), the plain version on
   the CPU.  Without
   ``size`` a batch that one decode covers in input order is returned as
   it is.

With ``mesh`` (a ``parallel.make_mesh`` DeviceMesh; the reference's
branch, ``ffpic_tpu/pipeline.py:94,175,272-281,313-315``) there is no
device-entropy route, 4:2:0 members keep dense planes with no sparse
rule, each block geometry is one ``parallel.sharded_decode_420`` over
the mesh's data axis (gathered, as the reference's host assembles the
batch), and the batch comes back as a DTensor split over ``data``
(``shard_batch`` then its first N rows), on the mesh's device.

The host layer (``formats.jpg``, ``formats.png``, ``formats.webp``,
``formats.heif``, the host codecs that register a ``decode``,
``native``) is the port's own copy of ``ffpic_tpu``'s; ``_read`` and
``_jpeg_420_plan`` are copied from ``ffpic_tpu/pipeline.py:29-70``.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

from ffpic_tpu_torch import native
from ffpic_tpu_torch.formats import heif, jpg, png, registry, webp
from ffpic_tpu_torch.formats.jpg import packed_block_map
from ffpic_tpu_torch.formats.staging import stage_rgba
from ffpic_tpu_torch.ops import jpeg_entropy_device as jed
from ffpic_tpu_torch.ops import jpeg_kernels as jk
from ffpic_tpu_torch.ops.resize import resize_batch
from ffpic_tpu_torch.ops.vp8_kernels import vp8_yuv_to_rgba_batch
from ffpic_tpu_torch.utils.device import resolve_device, to_device
from ffpic_tpu_torch.utils.trace import device_trace, stage

# dense members are staged as packed pairs when those take less than
# this share of their dense bytes (the reference's threshold)
SPARSE_SHARE = 0.7


def _read(src) -> bytes:
    if isinstance(src, (bytes, bytearray, memoryview)):
        return bytes(src)
    with open(src, "rb") as f:
        return f.read()


def _jpeg_420_plan(data: bytes, use_packed: bool = True):
    """The coefficient plan of a baseline or progressive 3-component
    4:2:0 JPEG, else None: the packed emission (``j.packed``) for a
    single-scan baseline file when ``use_packed``, dense raster-order
    planes otherwise."""
    try:
        if not use_packed:
            raise jpg.PackedIneligible
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


def _prep(data: bytes, device=None, mesh: bool = False):
    """A member's host work, as (plan, kind, pairs): its 4:2:0 plan
    ("420"), the dense planes of any other JPEG's first picture ("jpg"),
    a parsed PNG ("png"), a parsed WebP ("webp"), a parsed HEIF ("heif")
    or the RGBA pixels of the first picture of a host codec's decode
    ("rgba": a codec with a host ``decode``, which decodes the member
    whole, as the reference's registry.load does; a host array, or a
    tensor on ``device`` for an ICO whose entry is a PNG); ``device`` is
    where a WebP's ``FFPIC_VP8_DEVICE`` or a HEIF's ``FFPIC_HEVC_DEVICE``
    residual transform, a TIFF's JPEG strips and an ICO's PNG entry
    run.
    ``pairs`` is a dense 4:2:0 plan's ``member_pairs``, else None.
    With ``mesh`` a 4:2:0 plan is always dense, with no pairs (the
    reference's mesh branch, ``ffpic_tpu/pipeline.py:175``).
    Bytes no codec probes raise the registry's ``ValueError``."""
    j = _jpeg_420_plan(data, use_packed=not mesh)
    if j is None:
        codec = registry.probe(data)
        name = codec.name
        with registry.corrupt_as_value_error(name):
            if name == "JPG":
                return jpg.parse_and_decode(data)[0], "jpg", None
            if name == "PNG":
                return png.parse(data), "png", None
            if name == "WEBP":
                return webp.parse(data, device=device), "webp", None
            if name == "HEIF":
                return heif.parse(data, device=device,
                                  sequence=False), "heif", None
            # every other codec decodes on the host
            pics = codec.decode(data, device=device)
            if not pics:
                raise ValueError("decode produced no pictures")
            return pics[0].pixels, "rgba", None
    if j.packed is None:
        return j, "420", None if mesh else member_pairs(j)
    # the packed emission is a view of per-thread native scratch that
    # the next parse on this thread overwrites
    c, k, v, nnz = j.packed
    j.packed = (np.array(c), np.array(k), np.array(v), nnz)
    return j, "420", None


def member_pairs(j) -> list:
    """A dense 4:2:0 member's nonzeros, plane by plane, as unpadded (flat
    index int32, value int16) pairs in index order
    (``native.pack_nonzero``): the host work of the reference's sparse
    rule, done for each member in the worker pool."""
    return [native.pack_nonzero(c) for c in j.coeffs]


def sparse_pairs(pairs, sizes):
    """The reference's staging rule for dense members
    (``ffpic_tpu/pipeline.py:283-286``), from the members'
    ``member_pairs`` and the coefficients of one member's planes
    (``sizes``): None when the pairs take at least ``SPARSE_SHARE`` of
    the planes' int16 bytes, else (idx int32, val int16, lens), each
    plane's pairs as ``pack_coeffs`` gives them for its stack over the
    members (indices offset by member, zero-padded to a ``_bucket``
    length), one plane after the other; ``lens`` their lengths."""
    n = len(pairs)
    nnz = [sum(len(p[c][0]) for p in pairs) for c in range(len(sizes))]
    lens = [jk._bucket(k) for k in nnz]
    if 6 * sum(lens) >= 2 * n * sum(sizes) * SPARSE_SHARE:
        return None
    idx = np.empty(sum(lens), np.int32)
    val = np.empty(sum(lens), np.int16)
    at = 0
    for c, (size, length) in enumerate(zip(sizes, lens)):
        end = at + length
        for m, p in enumerate(pairs):
            i, v = p[c]
            np.add(i, m * size, out=idx[at:at + len(i)])
            val[at:at + len(v)] = v
            at += len(i)
        idx[at:end] = 0
        val[at:end] = 0
        at = end
    return idx, val, lens


def decode_dense_members(js, pairs, mode: str, device) -> torch.Tensor:
    """Dense 4:2:0 members of one image size (progressive files; ``js``
    their ``JpegFile``s, ``pairs`` their ``member_pairs``) -> (n, h, w,
    4) uint8 on ``device``, by the reference's rule: the sparse route
    (``decode_pairs``) when ``sparse_pairs`` takes them, else the dense
    one (``decode_planes``)."""
    with stage("torch.pack"):
        packed = sparse_pairs(pairs, [c.size for c in js[0].coeffs])
    if packed is None:
        return decode_planes(js, mode, device)
    return decode_pairs(js, packed, mode, device)


def decode_planes(js, mode: str, device) -> torch.Tensor:
    """The dense route: the members' planes stacked, staged in one copy,
    then K2 and K3."""
    n, j0 = len(js), js[0]
    with stage("torch.stack"):
        host = np.stack([np.concatenate([c.reshape(-1, 64) for c in j.coeffs])
                         for j in js]).reshape(n, -1, 8, 8)
    with stage("torch.h2d"):
        yq, cq = (jed.quant_stack(js, c, device) for c in (0, 1))
        staged = to_device(host, device)
    with stage("torch.device_decode"), device_trace("decode_420", device):
        return jk.decode_batch_420_dense(
            staged, yq, cq, tuple((c.nby, c.nbx) for c in j0.comps),
            order="rgba", mode=mode, hw=(j0.height, j0.width))


def decode_pairs(js, packed, mode: str, device) -> torch.Tensor:
    """The sparse route: ``sparse_pairs``'s pairs staged in two copies,
    each plane rebuilt by K8, then K2 and K3."""
    j0 = js[0]
    idx, val, lens = packed
    with stage("torch.h2d"):
        yq, cq = (jed.quant_stack(js, c, device) for c in (0, 1))
        idx, val = to_device(idx, device), to_device(val, device)
    with stage("torch.device_decode"), device_trace("decode_420", device):
        cut = np.cumsum([0, *lens]).tolist()
        planes = [(idx[a:b], val[a:b]) for a, b in zip(cut[:-1], cut[1:])]
        return jk.decode_batch_420_sparse(
            planes, len(js), tuple((c.nby, c.nbx) for c in j0.comps), yq, cq,
            order="rgba", mode=mode, hw=(j0.height, j0.width))


def _entropy_runs(datas) -> list:
    """The plan of the device-entropy route of
    ``ffpic_tpu/pipeline.py:88-167``, from the members' headers: DRI
    baseline 4:2:0 members (``jed.eligible``) merged into one entropy
    launch when there are 4 or more; with ``FFPIC_SPEC_ENTROPY=1`` each
    group of 4 or more DRI-less members of one ``spec_group_key`` through
    the speculative decoder.  ``FFPIC_HYBRID`` (default on) keeps ``n -
    k`` members of an all-DRI batch of 6 or more for the host, k = max(4,
    round(n * FFPIC_HYBRID_FRAC)) (default 0.5), when n - k >= 2.  A run
    larger than one launch takes is split (``jed.launch_runs``).  Returns
    [(route, [(index, header), ...])]."""
    n = len(datas)
    dri_list: list = []
    spec_groups: dict = {}
    use_spec = os.environ.get("FFPIC_SPEC_ENTROPY") == "1"
    with stage("torch.entropy.headers"):
        for i, data in enumerate(datas):
            # DRI is the marker FF DD, which entropy-coded data never
            # holds (its FF bytes are stuffed): without those bytes the
            # file has no restart interval, and only the speculative
            # route could take it
            if data[:2] != b"\xff\xd8" or (
                    not use_spec and b"\xff\xdd" not in data):
                continue
            try:
                # a malformed header is left to the host path, which
                # raises its ValueError
                with registry.corrupt_as_value_error("JPG"):
                    jh, _ = jpg.parse_and_decode(data, skip_decode=True)
            except (ValueError, NotImplementedError):
                continue
            if jed.eligible(jh):
                dri_list.append((i, jh))
            elif use_spec and jed.spec_eligible(jh):
                spec_groups.setdefault(jed.spec_group_key(jh),
                                       []).append((i, jh))
    runs = []
    if len(dri_list) >= 4:
        members = dri_list
        if (os.environ.get("FFPIC_HYBRID", "1") != "0"
                and len(dri_list) == n and n >= 6):
            k = max(4, int(round(n * float(
                os.environ.get("FFPIC_HYBRID_FRAC", "0.5")))))
            if n - k >= 2:
                members = dri_list[:k]
        runs += [(jed.decode_batch_dri_mixed, r)
                 for r in jed.launch_runs(members, datas)]
    for m in spec_groups.values():
        if len(m) >= 4:
            runs += [(jed.decode_batch_spec, r)
                     for r in jed.launch_runs(m, datas)]
    return runs


def _run_entropy(runs, datas, slots, mode: str, dev) -> list:
    """Run ``_entropy_runs``'s routes on the caller's thread, filling
    ``slots`` with the members they decode, cropped views.  A route that
    raises ``jed.Declined`` (the spec decoder's failed
    self-synchronisation, a scan it cannot stage) or
    ``NotImplementedError`` leaves its members to the host path: their
    indices are returned.  Anything else propagates."""
    declined = []
    for route, members in runs:
        try:
            with device_trace("device_entropy", dev):
                out = route([datas[i] for i, _ in members],
                            [jh for _, jh in members], order="rgba",
                            mode=mode, device=dev)
        except (jed.Declined, NotImplementedError):
            declined += [i for i, _ in members]
            continue
        for k, (i, jh) in enumerate(members):
            slots[i] = out[k][:jh.height, :jh.width]
    return declined


def decode_batch(srcs: Sequence, size: tuple[int, int] | None = None,
                 dtype="uint8", mode: str = "bt601", mesh=None, *,
                 device=None) -> torch.Tensor:
    """Decode a batch of images (paths or bytes: JPEG, PNG, WebP, HEIF,
    BMP, GIF, TGA, PNM, PSD, TIFF, ICO, raw HEVC) to one
    ``(N, H, W, 4)`` uint8 RGBA tensor on ``device`` (default CUDA; it raises
    when CUDA is absent).  The reference's signature
    (``ffpic_tpu/pipeline.py:73-74``), ``device`` keyword-only.
    ``size=(h, w)`` resizes each image; without it all images must
    share one size.  ``dtype`` is "uint8" (or ``torch.uint8``), the only
    one the reference produces.  ``mode`` is the colour conversion of
    the 4:2:0 JPEG members: "bt601", "reference" or "rgb".  Other
    members decode with their registry's defaults (a WebP: libwebp's
    colour; an animation: its first canvas; a HEIF: bt601 or its nclx).

    ``FFPIC_DEVICE_ENTROPY``: the device-entropy route
    (``_entropy_runs``) is on by default on CUDA, forced by "1" (the
    plain versions on the CPU) and off with "0".

    ``mesh``: a ``parallel.make_mesh`` DeviceMesh; every rank calls with
    the same ``srcs`` and gets the DTensor of the batch split over
    ``data`` (the module's docstring).  ``device`` then defaults to the
    mesh's, and one of another type raises ``ValueError``."""
    if dtype not in ("uint8", torch.uint8):
        raise ValueError(f"decode_batch: dtype {dtype!r}; only uint8")
    if mesh is not None:
        from ffpic_tpu_torch.parallel import mesh as pm
        if not isinstance(mesh, pm.DeviceMesh):
            raise TypeError(f"decode_batch: mesh must be a DeviceMesh "
                            f"(parallel.make_mesh), not {type(mesh).__name__}")
        dev = pm.mesh_device(mesh)
        if device is not None and torch.device(device).type != dev.type:
            raise ValueError(f"decode_batch: device {device!r} is not the "
                             f"mesh's {mesh.device_type!r}")
    else:
        dev = resolve_device(device, "decode_batch")
    n = len(srcs)
    slots: list = [None] * n

    with stage("torch.read"):
        datas = [_read(s) for s in srcs]
    env_de = os.environ.get("FFPIC_DEVICE_ENTROPY")
    runs = (_entropy_runs(datas) if mesh is None and env_de != "0"
            and (env_de == "1" or dev.type == "cuda") else [])
    routed = {i for _route, members in runs for i, _ in members}
    todo = [i for i in range(n) if i not in routed]

    env_t = os.environ.get("FFPIC_THREADS")
    nw = max(1, min(int(env_t) if env_t else (os.cpu_count() or 1),
                    len(todo) or 1))
    # a worker that launches (FFPIC_VP8_DEVICE, FFPIC_HEVC_DEVICE) does so
    # on this thread's current stream, not on its own default stream
    stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None

    def prep(d):
        with torch.cuda.stream(stream):
            return _prep(d, dev, mesh is not None)
    if nw > 1:
        # the pool parses the host members while this thread stages the
        # device route and enqueues its launches
        with ThreadPoolExecutor(max_workers=nw) as ex:
            pending = ex.map(prep, [datas[i] for i in todo])
            declined = _run_entropy(runs, datas, slots, mode, dev)
            with stage("torch.host_parse"):
                plans = list(pending)
    else:
        declined = _run_entropy(runs, datas, slots, mode, dev)
        with stage("torch.host_parse"):
            plans = [_prep(datas[i], dev, mesh is not None) for i in todo]
    if declined:
        with stage("torch.host_parse"):
            plans += [_prep(datas[i], dev) for i in declined]
        todo, plans = zip(*sorted(zip(todo + declined, plans),
                                  key=lambda t: t[0]))

    # one bucket per 4:2:0 image size: one block geometry and one crop;
    # with a mesh, per block geometry, as the reference buckets them
    buckets: dict[tuple, list] = {}
    stills = []         # WebP stills that kept their planes, in input order
    host_rgba = []      # host codecs' pixels still on the host, in order
    for i, (plan, kind, pairs) in zip(todo, plans):
        if kind == "420":
            key = ((plan.comps[0].nby, plan.comps[0].nbx) if mesh is not None
                   else (plan.height, plan.width))
            buckets.setdefault(key, []).append((i, plan, pairs))
            continue
        if kind == "webp" and plan.yuva is not None:
            stills.append((i, plan))
            continue
        if kind == "rgba":
            if isinstance(plan, np.ndarray):
                host_rgba.append((i, plan))
            else:
                slots[i] = plan
            continue
        with stage("torch.device_decode"), \
                registry.corrupt_as_value_error(kind.upper()):
            if kind == "webp":
                slots[i] = webp.to_pics(plan, dev)[0].pixels
            elif kind == "heif":
                slots[i] = heif.to_pics(plan, dev)[0].pixels
            else:
                slots[i] = (jpg if kind == "jpg" else png).to_pic(
                    plan, dev).pixels

    outs = []
    if host_rgba:
        with stage("torch.h2d"):
            batch, views = stage_rgba([a for _i, a in host_rgba], dev)
        if batch is not None:
            outs.append(batch)
        for (i, _a), v in zip(host_rgba, views):
            slots[i] = v
    if stills:
        with stage("torch.h2d"):
            frames = webp.stage_planes([f for _i, f in stills], dev)
        with stage("torch.device_decode"), \
                device_trace("vp8_yuv_to_rgba", dev):
            out = vp8_yuv_to_rgba_batch(frames)
        if isinstance(out, torch.Tensor):
            outs.append(out)
        for k, (i, _f) in enumerate(stills):
            slots[i] = out[k]
    for allmembers in buckets.values():
        if mesh is not None:
            out = decode_sharded(mesh, [j for _i, j, _p in allmembers], mode)
            for k, (i, j, _p) in enumerate(allmembers):
                slots[i] = out[k, :j.height, :j.width]
            continue
        j0 = allmembers[0][1]
        shapes = tuple((c.nby, c.nbx) for c in j0.comps)
        hw = (j0.height, j0.width)
        for packed in (True, False):
            members = [(i, j, p) for i, j, p in allmembers
                       if (j.packed is not None) == packed]
            if not members:
                continue
            js = [j for _i, j, _p in members]
            if not packed:
                out = decode_dense_members(js, [p for _i, _j, p in members],
                                           mode, dev)
            else:
                with stage("torch.pack"):
                    host, g, e = jk.stack_packed_fused([j.packed for j in js])
                with stage("torch.h2d"):
                    yq, cq = (jed.quant_stack(js, c, dev) for c in (0, 1))
                    staged = to_device(host, dev)
                    bmap = packed_block_map(j0, dev)
                with stage("torch.device_decode"), \
                        device_trace("decode_420", dev):
                    out = jk.decode_batch_420_packed_fused(
                        staged, bmap, yq, cq, len(members), g, e, shapes,
                        order="rgba", mode=mode, hw=hw)
            outs.append(out)
            for k, (i, _j, _p) in enumerate(members):
                slots[i] = out[k]

    with stage("torch.finish"), device_trace("resize_stack", dev):
        batch = _finish(slots, size, outs, n)
        if mesh is None:
            return batch
        # every rank decoded the batch whole; each keeps its rows
        return pm.first_rows(pm.shard_batch(mesh, batch), n)


def _finish(slots, size, outs, n: int) -> torch.Tensor:
    """The batch from its slots: stacked, or resized to ``size``; a
    decode or launch that gave the whole batch in input order is taken
    as it is."""
    if size is None:
        if len(outs) == 1 and outs[0].shape[0] == n:
            return outs[0]          # one decode or launch, in input order
        if len({tuple(s.shape) for s in slots}) != 1:
            raise ValueError(
                "mixed sizes: pass size=(H, W) to resize on device")
        return torch.stack(slots)
    return resize_batch(slots, tuple(size))


def decode_sharded(mesh, js, mode: str) -> torch.Tensor:
    """The mesh branch's decode of one 4:2:0 block geometry
    (``ffpic_tpu/pipeline.py:272-281``): the members' dense planes and
    per-image quant tables stacked, one ``sharded_decode_420`` over the
    mesh's data axis, then gathered, since every rank assembles the
    whole batch as the reference's host does: (n, 8 nby, 8 nbx, 4)."""
    from ffpic_tpu_torch.parallel.mesh import mesh_device, sharded_decode_420
    j0 = js[0]
    nby, nbx = j0.comps[0].nby, j0.comps[0].nbx
    with stage("torch.stack"):
        planes = [np.stack([j.coeffs[c].reshape(g[0], g[1], 8, 8)
                            for j in js])
                  for c, g in enumerate(((nby, nbx),
                                         (nby // 2, nbx // 2),
                                         (nby // 2, nbx // 2)))]
        yq, cq = (np.stack([j.dqt[j.comps[c].tq].reshape(8, 8)
                            for j in js])[:, None, None] for c in (0, 1))
    with stage("torch.device_decode"), device_trace("decode_420",
                                                      mesh_device(mesh)):
        return sharded_decode_420(mesh, *planes, yq, cq, order="rgba",
                                  mode=mode).full_tensor()
