"""Time named kernels of this tree beside those of an older checkout, on
one NVIDIA GPU.

    python3 -m ffpic_tpu_torch.compare_kernels --parent DIR \
        [--kernels k6,k8,jpeg] [--rounds 1]
    python3 DIR/ffpic_tpu_torch/compare_kernels.py --tree DIR [--kernels ...]

``DIR`` holds an older checkout of the repository, e.g. the parent
commit unpacked from ``git archive`` into a directory that
``.gitignore`` lists.  Each round runs this file on the older tree,
this tree, this tree and the older tree in turn, each in a fresh process
that imports that tree's package alone and builds its kernels (nvcc,
into that tree's ``ffpic_tpu_torch/build/``).  A run makes the same
inputs from a seed (or the committed fixtures), checks each kernel's
output, and times the groups that ``--kernels`` names (all of them by
default):

* ``k7``: K7 for every (colour type, bit depth) at 1920x1080, its rows
  contiguous and at a pitch of the stride + 1 bytes, warm and with L2
  flushed, each against its plain version; a device copy of the 8-bit
  RGBA rows (K7's function there) beside it;
* ``k14``: K14 over the 12 MP HEIF fixture's 48 tiles, a launch a tile
  (48 in a row, each tile staged alone) and one launch over all of
  them, against the plain version; ``load`` of the fixture by the host
  route and under ``FFPIC_HEVC_DEVICE`` (median of 5, host clock, with
  the ``hevc.*`` spans);
* ``k18``: K18 on the 1080p lossy fixture's frame (warm and L2
  flushed) and the 512x512 one, each equal to the host ``vp8_recon``
  luma; one-row frames (``mbh = 1``: no row waits on another) of 120 and
  60 macroblocks, all B_PRED or all 16x16, each against the plain
  version.  From them the cost c of one macroblock step
  (``c_*_us``: the 120-MB row's time over 120, and ``c_*_diff_us``: the
  difference of the two rows over 60, without the launch), and the
  hand-off latency L implied at 1080p: T = S c + R L, with S = 2 (mbh -
  1) + mbw macroblock steps on the longest path, R = mbh - 1 of them row
  hand-offs, and c the frame's mix of the two costs by its share of
  B_PRED macroblocks; and ``L_path_us``, the L for which the longest
  path through the frame's macroblock graph, each macroblock weighted
  by its own mode's c and each row hand-off by L (``path_us``), takes
  the measured time (absent where even L = 0 takes longer;
  ``path_L0_us`` is that path's time at L = 0);
* ``entropy``: K9 on the 8 x 1080p DRI batch, K10 and K11 on its
  DRI-less files (4 KB chunks), warm and L2 flushed; K11 against its
  plain version (its ns a symbol: ``chip_smoke.py``'s ``[time entropy
  kernels]``);
* ``vp8``: K12 on the 1080p frame's levels and K13 on 1080p planes,
  warm and L2 flushed, each against its plain version;
* ``k13``: K13 on one 1080p frame without and with alpha, on one of
  1081 x 1919, on one of 1080 x 1918 whose RGBA rows do not start on a
  16-byte boundary (its planes 3 bytes into their rows), on a 4096 x
  4096 frame, each against its plain version; and the webp batch's 8
  frames (the 1080p lossy and alpha fixtures, 4 of each) as each tree's
  ``decode_batch`` runs them, against the CPU route: in trees with
  ``vp8_kernels.vp8_yuv_to_rgba_batch`` one launch into the (8, H, W,
  4) tensor from the planes staged by ``webp.stage_planes``, in older
  trees a launch a member from its own planes, then ``torch.stack``;
  each warm and L2 flushed, with its bound by bytes, the batch's
  launches, and the batch's colour stage with its staging from the
  host's planes (host clock, median of 7);
* ``k16``: config 5's resize of 8 slots of 1080p RGBA to 224 x 224 as
  ``decode_batch`` runs it (``ops.resize.resize_batch``, one launch),
  against ``resize_batch_plain``; K16 on one slot, on a 48 MP slot
  (8064 x 6048, one output row a CTA) and on the 8 in one tensor, and
  each of its passes alone there: 1080x1920 -> 224x1920 (pass 1, the
  vertical taps) and 1080x1920 -> 1080x224 (pass 2, the horizontal
  taps, over each input row copied); K17 with its resize on the 8
  slots (the JPEG chain's call) and without one on the 8 x 224 x 224
  batch (config 5's call); the 8 slots by every other method of
  ``RESIZE_METHODS`` (``resize_batch(..., method)``, one launch each,
  against its plain version: cubic and Lanczos on the band kernel in
  trees that have it), one slot to 224 x 224 by cubic and Lanczos
  (``resize_rgba`` of one image), and lanczos5's passes alone; each
  warm and L2 flushed;
* ``k15``: ``heif.color`` of the 12 MP fixture under
  ``FFPIC_HEIF_DEVICE_COLOR`` on its staged tiles as ``heif.to_pics``
  runs it (``hevc_kernels.hevc_tiles_to_rgba``, one launch that also
  fills the canvas), warm and L2 flushed (2 and 5 loads), against the
  CPU route's pixels; and ``load`` of the fixture under that switch
  (median of 5, host clock).

* ``k6``: K6 (``cuda_png.unfilter_subup``) on the 1080p Sub/Up RGBA
  file's rows, the same rows all None, all Sub and all Up, rows of
  random filters, and 64 rows of 20,000 px of 16-bit RGBA (Sub and Up in
  turn), warm and L2 flushed, each against its plain version, with its
  launches a call and, on the 1080p rows, each kernel's device time from
  ``torch.profiler``; in trees with ``cuda_png.unfilter_bands``, K6 at
  other bands (rows x chunk bytes) on three of them;
* ``k8``: K8 over the sparse route's three planes of the 8 x 1080p batch
  as each tree's ``decode_batch_420_sparse`` rebuilds them (one launch,
  or a launch and a memset a plane), over the same pairs shuffled, and
  over as many pairs a plane at random keys, warm and L2 flushed, each
  against its plain version, with the launches and the profiler's
  split; the route (K8, K2, K3); ``torch.zeros`` + ``index_add_``;
* ``jpeg``: K1a, K1b, K2 and K3 on the 8 x 1080p batch (checked against
  the plain route), K4 (fancy) on a 4000 x 3000 4:2:2 layout and K5 on
  the batch's blocks, warm and L2 flushed.

* ``fp64``: the probes of ``probes/fp64_rates.cu`` (this file's tree,
  built alone; the same whatever ``--tree``): instructions a clock an SM
  of DFMA (normal and subnormal operands) and of f32 <-> f64
  conversions, FMAs a clock an SM of mma.m16n8k16 with f64, and the
  share of its results equal to the forward and reverse chain of
  ``__fma_rn`` over k and to the exactly rounded sum, on integer,
  random, tie-breaking, byte-times-weight and subnormal tiles
  (``chip_smoke.py`` holds the forward shares at 1.0).

``k16`` and ``k15`` need both trees to have those one-launch entries.

Each run prints one ``RESULT`` JSON line; the rounds end with a table of
each number's median per tree, and the card's name and power limit.
Needs CUDA and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

H, W = 1080, 1920
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUPS = ("k7", "k14", "k18", "entropy", "vp8", "k13", "k16", "k15", "k6",
          "k8", "jpeg", "fp64")
KERNELS = {"k7": ("assemble_rgba",), "k14": ("hevc_residuals",),
           "k18": ("vp8_wavefront",),
           "entropy": ("entropy_decode", "spec_scan", "spec_merge"),
           "vp8": ("vp8_residuals", "vp8_yuv_to_rgba"),
           "k13": ("vp8_yuv_to_rgba",),
           "k16": ("resize", "resize_gather", "resize_band"),
           "k15": ("hevc_yuv_to_rgba",),
           "k6": ("unfilter_rows", "unfilter_cols", "unfilter_subup"),
           "k8": ("scatter_plane", "scatter_planes"),
           "jpeg": ("count_scan", "unpack", "dequant_idct", "assemble_color",
                    "assemble_mcu", "fdct"),
           "fp64": ()}


# jax.image.resize's methods (one name each), which K16 takes
RESIZE_METHODS = ("nearest", "bilinear", "bicubic", "lanczos3", "lanczos5")


def _timed(fn, flush, warm: int = 50, cold: int = 20) -> dict:
    from ffpic_tpu_torch.utils.timing import gpu_ms, gpu_ms_cold
    return {"ms": gpu_ms(fn, warm), "ms_cold": gpu_ms_cold(fn, cold, flush)}


def _device_ms(fn, calls: int = 20) -> dict:
    """Device time a call of ``fn`` of each kernel and memset it runs, in
    ms, from one ``torch.profiler`` run over ``calls`` calls (empty where
    the profiler records no device time)."""
    import torch
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0)
        m = re.search(r"(\w+_kernel)", e.key)
        name = m.group(1) if m else "memset" if "emset" in e.key else None
        if us and name:
            out[name] = out.get(name, 0.0) + us / 1e3 / calls
    return out


def _k14_launch(hk, cuda_hevc, parts, bd, dev):
    """A launch of ``parts`` ((tu_meta, levels) of one or more tiles) as
    ``hevc_kernels.residuals_grid`` stages it."""
    import numpy as np
    import torch
    meta = np.concatenate([m for m, _ in parts])
    lv_d, plan, _ = hk.stage_residuals(parts, dev)
    return (lambda: cuda_hevc.hevc_residuals(lv_d, bd, *plan)), \
        torch.from_numpy(meta).to(dev), lv_d


def _k7(dev, flush) -> dict:
    import numpy as np
    import torch
    from ffpic_tpu_torch.ops import cuda_png
    from ffpic_tpu_torch.ops import png_kernels as pk
    rng = np.random.default_rng(12)
    out = {}
    for ct, depths in pk.LEGAL.items():
        for bd in depths:
            stride = (W * pk.NCH[ct] * bd + 7) // 8
            rec = torch.from_numpy(rng.integers(0, 256, (H, stride),
                                                dtype=np.uint8)).to(dev)
            pal = rng.integers(0, 256, (256, 4)).astype(np.uint8)
            key = np.full(256, -1, np.int32)
            if ct == 3:
                key[:100] = rng.integers(0, 256, 100)
            elif ct in (0, 2):
                key[:pk.NCH[ct]] = pk.unpack_samples(
                    rec[:1].cpu(), bd, pk.NCH[ct])[0].numpy()
            wide = torch.zeros((H, stride + 1), dtype=torch.uint8, device=dev)
            wide[:, :stride] = rec
            for layout, r in (("contiguous", rec),
                              ("pitch+1", wide[:, :stride])):
                def fn(r=r, pal=pal, key=key, ct=ct, bd=bd):
                    return cuda_png.assemble_rgba(r, pal, key, ct, bd, W, H)
                if not torch.equal(fn(), pk.expand_rgba(r, pal, key, ct, bd,
                                                        W, H)):
                    raise AssertionError(f"K7 <{ct},{bd}> {layout} differs "
                                         "from its plain version")
                t = _timed(fn, flush)
                out[f"<{ct},{bd}> {layout} ms"] = t["ms"]
                out[f"<{ct},{bd}> {layout} ms_cold"] = t["ms_cold"]
            if (ct, bd) == (6, 8):
                t = _timed(lambda rec=rec: rec.clone().view(H, W, 4), flush)
                out["device copy <6,8> contiguous ms"] = t["ms"]
                out["device copy <6,8> contiguous ms_cold"] = t["ms_cold"]
    return out


def _k14(dev, flush) -> dict:
    import torch
    import ffpic_tpu_torch
    from ffpic_tpu_torch import testing
    from ffpic_tpu_torch.formats import heif
    from ffpic_tpu_torch.ops import cuda_hevc
    from ffpic_tpu_torch.ops import hevc_kernels as hk
    from ffpic_tpu_torch.utils import trace
    data = testing.heif_fixture()
    s = heif.parse_structure(data)
    tiles = [t for r, f, tos in s["refs"] if r == "dimg" for t in tos]
    tus = [testing.heif_tile_tus(data, t, s) for t in tiles]
    bd = tus[0][2]
    per_tile = [_k14_launch(hk, cuda_hevc, [(m, lv)], bd, dev)[0]
                for m, lv, _ in tus]
    one, m_d, lv_d = _k14_launch(hk, cuda_hevc,
                                 [(m, lv) for m, lv, _ in tus], bd, dev)
    if not torch.equal(one(), hk.hevc_residuals_plain(m_d, lv_d, bd)):
        raise AssertionError("K14 over the 48 tiles differs from its plain "
                             "version")

    def tiles48():
        for fn in per_tile:
            fn()
    out = {}
    for name, fn, warm, cold in (("48 launches", tiles48, 2, 5),
                                 ("one launch", one, 20, 10)):
        t = _timed(fn, flush, warm, cold)
        out[f"{name} ms"] = t["ms"]
        out[f"{name} ms_cold"] = t["ms_cold"]
    del per_tile, one, m_d, lv_d

    mp = 4032 * 3024 / 1e6
    for route, env in (("host", {}), ("hevc_device",
                                      {"FFPIC_HEVC_DEVICE": "1"})):
        saved = {k: os.environ.pop(k, None) for k in
                 ("FFPIC_HEVC_DEVICE", "FFPIC_HEIF_DEVICE_COLOR")}
        os.environ.update(env)
        try:
            ffpic_tpu_torch.load(data)
            trace.reset()
            trace.enable()
            walls = []
            for _ in range(5):
                t1 = time.perf_counter()
                ffpic_tpu_torch.load(data)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t1)
            trace.enable(False)
            spans = trace.report()
        finally:
            for k in env:
                os.environ.pop(k)
            os.environ.update({k: v for k, v in saved.items() if v})
        wall = statistics.median(walls)
        out[f"load {route} ms"] = wall * 1e3
        out[f"load {route} mps"] = mp / wall
        for span, v in spans.items():
            out[f"load {route} {span} ms"] = v["mean"] * 1e3
    return out


def path_us(ymode, c_bpred: float, c_16x16: float, hand_off: float) -> float:
    """The longest path through a frame's macroblock graph: MB (y, x)
    after (y, x - 1) and after (y - 1, min(x + 1, mbw - 1)) plus a row
    hand-off, each MB weighted by its mode's step cost."""
    mbh, mbw = ymode.shape
    above = [0.0] * mbw
    for y in range(mbh):
        row, done = [0.0] * mbw, 0.0
        for x in range(mbw):
            start = done
            if y:
                start = max(start, above[min(x + 1, mbw - 1)] + hand_off)
            done = start + (c_bpred if ymode[y, x] == 4 else c_16x16)
            row[x] = done
        above = row
    return above[-1]


def path_hand_off(ymode, c_bpred: float, c_16x16: float, t_us: float):
    """The hand-off L for which ``path_us`` takes t_us, or None where
    even L = 0 takes longer."""
    lo, hi = 0.0, t_us
    if path_us(ymode, c_bpred, c_16x16, lo) > t_us:
        return None
    for _ in range(40):
        mid = (lo + hi) / 2
        if path_us(ymode, c_bpred, c_16x16, mid) > t_us:
            hi = mid
        else:
            lo = mid
    return lo


def _k18(dev, flush) -> dict:
    import numpy as np
    import torch
    from ffpic_tpu_torch import testing
    from ffpic_tpu_torch.ops import cuda_vp8
    from ffpic_tpu_torch.ops import vp8_wavefront as wf
    from ffpic_tpu_torch.utils.timing import gpu_ms

    def to(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrays]

    out = {}
    big = small = None
    for name in ("lossy_1080p.webp", "lossy_512.webp"):
        inp = testing.wavefront_inputs(name)
        t = to(inp["residual"], inp["ymode"], inp["bmodes"])
        if not torch.equal(cuda_vp8.vp8_wavefront(*t).cpu(),
                           torch.from_numpy(inp["Y"])):
            raise AssertionError(f"K18 on {name} differs from the host luma")
        if big is None:
            big, big_t = inp, t
        else:
            small, small_t = inp, t
    t = _timed(lambda: cuda_vp8.vp8_wavefront(*big_t), flush)
    out["1080p ms"], out["1080p ms_cold"] = t["ms"], t["ms_cold"]
    out["512 ms"] = gpu_ms(lambda: cuda_vp8.vp8_wavefront(*small_t), 50)

    rng = np.random.default_rng(18)
    rows = {}
    for kind in ("bpred", "16x16"):
        for mbw in (120, 60):
            res = rng.integers(-300, 301, (1, mbw, 16, 4, 4)).astype(np.int32)
            ym = (np.full((1, mbw), 4) if kind == "bpred"
                  else rng.integers(0, 4, (1, mbw))).astype(np.int32)
            bm = rng.integers(0, 10, (1, mbw, 16)).astype(np.int32)
            r = to(res, ym, bm)
            if not torch.equal(cuda_vp8.vp8_wavefront(*r),
                               wf.vp8_wavefront_plain(*r)):
                raise AssertionError(f"K18 on a {kind} row of {mbw} differs "
                                     "from its plain version")
            rows[kind, mbw] = ms = gpu_ms(
                lambda r=r: cuda_vp8.vp8_wavefront(*r), 50)
            out[f"row {kind} x{mbw} ms"] = ms
        out[f"c_{kind}_us"] = rows[kind, 120] * 1e3 / 120
        out[f"c_{kind}_diff_us"] = (rows[kind, 120] - rows[kind, 60]) \
            * 1e3 / 60
    for name, inp, ms in (("1080p", big, out["1080p ms"]),
                          ("512", small, out["512 ms"])):
        mbh, mbw = inp["mb"]
        steps, handoffs = 2 * (mbh - 1) + mbw, mbh - 1
        f = float((inp["ymode"] == 4).mean())
        out[f"{name} bpred_share"] = f
        out[f"{name} us_per_chain_step"] = ms * 1e3 / steps
        for how in ("", "_diff"):
            c = f * out[f"c_bpred{how}_us"] + (1 - f) * out[f"c_16x16{how}_us"]
            out[f"{name} L{how}_us"] = (ms * 1e3 - steps * c) / handoffs
        out[f"{name} path_L0_us"] = path_us(inp["ymode"], out["c_bpred_us"],
                                            out["c_16x16_us"], 0.0)
        hand_off = path_hand_off(inp["ymode"], out["c_bpred_us"],
                                 out["c_16x16_us"], ms * 1e3)
        if hand_off is not None:
            out[f"{name} L_path_us"] = hand_off
    return out


def _entropy(dev, flush) -> dict:
    import torch
    from ffpic_tpu_torch import testing
    from ffpic_tpu_torch.formats import jpg
    from ffpic_tpu_torch.ops import jpeg_entropy_device as jed
    dri = [testing.encode_jpeg(testing.synth_rgb(H, W, k + 1), q,
                               restart_interval=W // 16)
           for k, q in ((0, 85), (1, 95))]
    jpegs = [testing.synth_jpeg_420(H, W, 85, 1),
             testing.synth_jpeg_420(H, W, 95, 2)]
    dri_srcs = [dri[k % 2] for k in range(8)]
    spec_srcs = [jpegs[k % 2] for k in range(8)]
    js8 = [jpg.parse_and_decode(d, skip_decode=True)[0] for d in dri_srcs]
    st, lanes, plan, out_size, _off = jed.stage_dri(dri_srcs, js8, dev)
    rs = jed.spec_stages(spec_srcs, 4096, device=dev)
    ss = rs["staged"]
    if not bool(rs["ok"]):
        raise AssertionError("the spec batch did not self-synchronise")
    if not torch.equal(jed.spec_merge(ss, rs["ent"], rs["snap"]),
                       jed.spec_merge_plain(ss, rs["ent"], rs["snap"])):
        raise AssertionError("K11 differs from its plain version")
    out = {}
    for name, fn in (
            ("K9 dri batch", lambda: jed.decode_lanes(st, lanes, plan,
                                                      out_size)),
            ("K10 spec batch", lambda: jed.spec_scan(ss, rs["chunks"])),
            ("K11 spec batch", lambda: jed.spec_merge(ss, rs["ent"],
                                                      rs["snap"]))):
        t = _timed(fn, flush)
        out[f"{name} ms"], out[f"{name} ms_cold"] = t["ms"], t["ms_cold"]
    return out


def _vp8(dev, flush) -> dict:
    import numpy as np
    import torch
    from ffpic_tpu_torch import testing
    from ffpic_tpu_torch.ops import cuda_vp8
    from ffpic_tpu_torch.ops import vp8_kernels as vk
    inp = testing.wavefront_inputs("lossy_1080p.webp")
    lv, dq, hy = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                  for a in (inp["levels"], inp["dq_per_mb"], inp["has_y2"]))
    if not torch.equal(cuda_vp8.vp8_residuals(lv, dq, hy),
                       vk.vp8_residuals_plain(lv, dq, hy)):
        raise AssertionError("K12 differs from its plain version")
    rng = np.random.default_rng(13)
    planes = [torch.from_numpy(rng.integers(0, 256, s, dtype=np.uint8))
              .to(dev) for s in ((1088, 1920), (544, 960), (544, 960))]
    if not torch.equal(cuda_vp8.vp8_yuv_to_rgba(*planes, H, W),
                       vk.vp8_yuv_to_rgba_plain(*planes, H, W)):
        raise AssertionError("K13 differs from its plain version")
    out = {}
    for name, fn in (("K12 1080p", lambda: cuda_vp8.vp8_residuals(lv, dq,
                                                                  hy)),
                     ("K13 1080p", lambda: cuda_vp8.vp8_yuv_to_rgba(
                         *planes, H, W))):
        t = _timed(fn, flush)
        out[f"{name} ms"], out[f"{name} ms_cold"] = t["ms"], t["ms_cold"]
    return out


def _k13(dev, flush) -> dict:
    import numpy as np
    import torch
    from ffpic_tpu_torch import testing
    from ffpic_tpu_torch.formats import webp
    from ffpic_tpu_torch.ops import cuda_vp8
    from ffpic_tpu_torch.ops import vp8_kernels as vk
    from ffpic_tpu_torch.utils.timing import HBM_BYTES_PER_S
    one_launch = hasattr(vk, "vp8_yuv_to_rgba_batch")
    rng = np.random.default_rng(17)

    def planes(h, w, alpha=False, at=0):
        """MB-padded planes of random bytes on the card, each row starting
        ``at`` bytes into a wider one (a view at a pitch of its own)."""
        ph, pw = -(-h // 16) * 16, -(-w // 16) * 16
        out = []
        for r, c in ((ph, pw), (ph // 2, pw // 2), (ph // 2, pw // 2)):
            t = torch.from_numpy(rng.integers(0, 256, (r, c + at + 8),
                                              dtype=np.uint8)).to(dev)
            out.append(t[:, at:at + c] if at else t[:, :c].contiguous())
        a = torch.from_numpy(rng.integers(0, 256, (h, w), dtype=np.uint8)) \
            .to(dev) if alpha else None
        return (*out, h, w, a)

    def nbytes(h, w, alpha):
        return (5 + alpha) * h * w + 2 * ((h + 1) // 2) * ((w + 1) // 2)

    # the webp batch: the 1080p lossy and alpha fixtures, 4 of each, as
    # parse leaves them under FFPIC_VP8_DEVICE_COLOR
    saved = os.environ.pop("FFPIC_VP8_DEVICE_COLOR", None)
    os.environ["FFPIC_VP8_DEVICE_COLOR"] = "1"
    try:
        fs = [webp.parse(testing.webp_fixture(n), device=dev)
              for n in ("lossy_1080p.webp", "alpha_1080p.webp")] * 4
    finally:
        os.environ.pop("FFPIC_VP8_DEVICE_COLOR")
        if saved is not None:
            os.environ["FFPIC_VP8_DEVICE_COLOR"] = saved
    want = torch.stack([webp.to_pics(f, torch.device("cpu"))[0].pixels
                        for f in fs[:2]] * 4)
    if one_launch:
        # this tree's decode_batch: one staging, one launch into the batch
        staged = webp.stage_planes(fs, dev)

        def batch():
            return vk.vp8_yuv_to_rgba_batch(staged)

        def batch_staged():
            return vk.vp8_yuv_to_rgba_batch(webp.stage_planes(fs, dev))
    else:
        # an older tree's: each member's planes copied alone, a launch a
        # member into a tensor of its own, then the stack
        from ffpic_tpu_torch.utils.device import to_device
        staged = [(*[to_device(p, dev) for p in f.yuva[:3]], f.height,
                   f.width, to_device(f.yuva[3], dev)
                   if f.yuva[3] is not None else None) for f in fs]

        def batch():
            return torch.stack([cuda_vp8.vp8_yuv_to_rgba(*f)
                                for f in staged])

        def batch_staged():
            return torch.stack([webp.to_pics(f, dev)[0].pixels for f in fs])
    cases = {"1080p": planes(H, W), "1080p alpha": planes(H, W, True),
             "odd 1081x1919": planes(1081, 1919, True),
             # RGBA rows 8 bytes off a 16-byte boundary (w % 4 == 2),
             # planes 3 bytes into their rows
             "unaligned 1080x1918": planes(H, 1918, False, 3),
             "4096x4096": planes(4096, 4096)}
    out = {}
    for name, f in cases.items():
        got = cuda_vp8.vp8_yuv_to_rgba(*f)
        if not torch.equal(got, vk.vp8_yuv_to_rgba_plain(*f)):
            raise AssertionError(f"K13 {name} differs from its plain version")
        t = _timed(lambda f=f: cuda_vp8.vp8_yuv_to_rgba(*f), flush)
        out[f"{name} ms"], out[f"{name} ms_cold"] = t["ms"], t["ms_cold"]
        out[f"{name} bound_ms"] = nbytes(f[3], f[4], f[5] is not None) \
            / HBM_BYTES_PER_S * 1e3
    before = cuda_vp8.launches["vp8_yuv_to_rgba"]
    got = batch()
    torch.cuda.synchronize()
    out["webp batch 8 launches"] = \
        cuda_vp8.launches["vp8_yuv_to_rgba"] - before
    if tuple(got.shape) != (8, H, W, 4) or not torch.equal(got.cpu(), want):
        raise AssertionError("K13 on the webp batch differs from the CPU "
                             "route")
    if not torch.equal(batch_staged(), got):
        raise AssertionError("the staged webp batch differs")
    t = _timed(batch, flush, 20, 10)
    out["webp batch 8 ms"], out["webp batch 8 ms_cold"] = t["ms"], t["ms_cold"]
    out["webp batch 8 bound_ms"] = (4 * nbytes(H, W, False) + 4 * nbytes(
        H, W, True)) / HBM_BYTES_PER_S * 1e3
    batch_staged()
    walls = []
    for _ in range(7):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        batch_staged()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    out["webp batch 8 with staging host ms"] = statistics.median(walls) * 1e3
    return out


def _k16(dev, flush) -> dict:
    import numpy as np
    import torch
    from ffpic_tpu_torch.ops import cuda_resize
    from ffpic_tpu_torch.ops import resize as rs
    size, n = (224, 224), 8
    rng = np.random.default_rng(16)
    slots = [torch.from_numpy(rng.integers(0, 256, (H, W, 4), dtype=np.uint8))
             .to(dev) for _ in range(n)]
    batch = torch.stack(slots)
    def path():
        return rs.resize_batch(slots, size)
    if not torch.equal(path(), rs.resize_batch_plain(slots, size)):
        raise AssertionError("K16 on the 8 slots differs from its plain "
                             "version")
    # a 48 MP photo: too wide for the lines of two output rows a CTA
    wide = torch.from_numpy(rng.integers(0, 256, (6048, 8064, 4),
                                         dtype=np.uint8)).to(dev)
    if not torch.equal(cuda_resize.resize_rgba(wide, size),
                       rs.resize_rgba_plain(wide, size)):
        raise AssertionError("K16 on the 48 MP slot differs from its plain "
                             "version")
    small = batch[:, :224].contiguous()
    sized = torch.from_numpy(rng.integers(0, 256, (n, *size, 4),
                                          dtype=np.uint8)).to(dev)
    for x, sz in ((batch[:1], (224, W)), (batch[:1], (H, 224)),
                  (small, (112, 224))):
        if not torch.equal(cuda_resize.resize_rgba(x, sz),
                           rs.resize_rgba_plain(x, sz)):
            raise AssertionError(f"K16 to {sz} differs from its plain "
                                 "version")
    for x, sz in ((batch, size), (sized, None)):
        if not torch.equal(cuda_resize.normalize_resize(x, sz),
                           rs.normalize_plain(x, sz)):
            raise AssertionError(f"K17 to {sz} differs from its plain "
                                 "version")
    out = {}
    for name, fn in (
            ("path 8 slots", path),
            ("one slot", lambda: cuda_resize.resize_rgba(slots[0], size)),
            ("48 MP slot", lambda: cuda_resize.resize_rgba(wide, size)),
            ("8 slots one tensor", lambda: cuda_resize.resize_rgba(batch,
                                                                   size)),
            ("pass 1 one slot", lambda: cuda_resize.resize_rgba(
                batch[:1], (224, W))),
            ("pass 1 8 slots", lambda: cuda_resize.resize_rgba(batch,
                                                               (224, W))),
            ("pass 2 one slot", lambda: cuda_resize.resize_rgba(
                batch[:1], (H, 224))),
            ("pass 2 8 slots", lambda: cuda_resize.resize_rgba(batch,
                                                               (H, 224))),
            ("K17 with resize 8 slots", lambda: cuda_resize.normalize_resize(
                batch, size)),
            ("K17 8 x 224", lambda: cuda_resize.normalize_resize(sized))):
        t = _timed(fn, flush, 20, 10)
        out[f"{name} ms"], out[f"{name} ms_cold"] = t["ms"], t["ms_cold"]
    # the other methods over the 8 slots, cubic and Lanczos on one slot
    # (resize_rgba's single image), and lanczos5's passes alone
    cases = [*((f"{m} 8 slots", m, size, None) for m in RESIZE_METHODS
               if m != "bilinear"),
             *((f"{m} one slot", m, size, slots[0])
               for m in ("bicubic", "lanczos3", "lanczos5")),
             ("lanczos5 pass 1 one slot", "lanczos5", (224, W), batch[:1]),
             ("lanczos5 pass 2 one slot", "lanczos5", (H, 224), batch[:1])]
    for name, method, sz, x in cases:
        def fn(m=method, sz=sz, x=x):
            return rs.resize_batch(slots, sz, m) if x is None else \
                cuda_resize.resize_rgba(x, sz, m)
        want = rs.resize_batch_plain(slots, sz, method) if x is None else \
            rs.resize_rgba_plain(x, sz, method)
        if not torch.equal(fn(), want):
            raise AssertionError(f"K16 {name} differs from its plain "
                                 "version")
        t = _timed(fn, flush, 20, 10)
        out[f"{name} ms"], out[f"{name} ms_cold"] = t["ms"], t["ms_cold"]
    return out


# probes/fp64_rates.cu's rate modes: (mode, name, instructions an
# iteration, b)
FP64_MODES = ((0, "dfma", 8, 0.9999999),
              (1, "dfma subnormal", 8, 0.3 * 2.0 ** 946),
              (2, "cvt f32 to f64", 8, 0.0),
              (3, "cvt f64 to f32", 8, 0.9999999))
# the tiles on which mma.m16n8k16 .f64 is held against the chain of FMAs
MMA_KINDS = ("ints", "random", "ties", "bytes", "subnormal")


def _mma16_tiles(rng, tiles: int, kind: str):
    """A (16 x 16), B (16 x 8, a column after another) and C (16 x 8) of
    ``tiles`` m16n8k16 products: ``ints`` small integers (exact in every
    order: checks the fragment layout), ``random`` full significands
    over 2^-30..2^30 with random signs (cancellation), ``ties`` C = 1 +
    m 2^-52 with a product of 2^-53 (half an ulp of C), one of +-2^-85
    and one of +-2^-100, so one rounding of the exact sum and a chain of
    FMAs round apart, ``bytes``: bytes times f32 weights of either sign
    added to f32 values, and ``subnormal``: the same as K16's pass 1
    takes them, the bytes as subnormals v x 2^-1074, the weights times
    2^946, the sums times 2^-128."""
    import numpy as np
    if kind == "ints":
        return (rng.integers(-8, 9, (tiles, 256)).astype(np.float64),
                rng.integers(-8, 9, (tiles, 128)).astype(np.float64),
                rng.integers(-64, 65, (tiles, 128)).astype(np.float64))
    if kind == "random":
        def rand(shape):
            return (rng.uniform(1, 2, shape) * rng.choice([-1.0, 1.0], shape)
                    * 2.0 ** rng.integers(-30, 31, shape))
        return rand((tiles, 256)), rand((tiles, 128)), rand((tiles, 128))
    if kind in ("bytes", "subnormal"):
        a = rng.integers(0, 256, (tiles, 256)).astype(np.float64)
        b = (rng.standard_normal((tiles, 128)) * 0.1).astype(np.float32) \
            .astype(np.float64)
        c = (rng.standard_normal((tiles, 128)) * 100).astype(np.float32) \
            .astype(np.float64)
        if kind == "subnormal":             # K16's pass 1: bytes as
            a, b, c = a * 2.0 ** -1074, b * 2.0 ** 946, c * 2.0 ** -128
        return a, b, c
    a = np.zeros((tiles, 16, 16))
    b = np.zeros((tiles, 8, 16))
    a[:, :, 0], b[:, :, 0] = 2.0 ** -27, 2.0 ** -26
    a[:, :, 1] = rng.choice([-1.0, 1.0], (tiles, 16)) * 2.0 ** -40
    b[:, :, 1] = 2.0 ** -45
    a[:, :, 9] = rng.choice([-1.0, 1.0], (tiles, 16)) * 2.0 ** -60
    b[:, :, 9] = 2.0 ** -40
    c = 1.0 + rng.integers(0, 4, (tiles, 128)) * 2.0 ** -52
    return a.reshape(tiles, 256), b.reshape(tiles, 128), c


def fp64_probe():
    """``probes/fp64_rates.cu`` of this file's tree, built alone into
    ``build/probes`` and loaded: (the library, the compiler's output)."""
    import ctypes
    from ffpic_tpu_torch.ops import _build
    cu = os.path.join(HERE, "ffpic_tpu_torch", "probes", "fp64_rates.cu")
    where = os.path.join(_build.BUILD, "probes")
    os.makedirs(where, exist_ok=True)
    so = os.path.join(where, "fp64_rates.so")
    log = _build.compile_library([cu], so)
    lib = ctypes.CDLL(so)
    vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.ffpic_probe_rates.argtypes = [i, i, i, i, d, d, ctypes.c_float, vp,
                                      vp, vp]
    lib.ffpic_probe_mma_rate.argtypes = [i, i, vp, vp, vp]
    lib.ffpic_probe_mma16.argtypes = [vp] * 6 + [i, vp]
    return lib, log


def mma16_run(lib, dev, kind: str, rng, tiles: int = 1024) -> tuple:
    """``tiles`` of ``_mma16_tiles``' ``kind`` through the probe's
    mma.m16n8k16 .f64 on the card: (A, B, C as numpy, and the mma's
    results, the forward and the reverse chain of ``__fma_rn`` over k,
    each (tiles, 16, 8))."""
    import torch
    a, b, c = _mma16_tiles(rng, tiles, kind)
    ta, tb, tc = (torch.from_numpy(x).to(dev) for x in (a, b, c))
    got = [torch.empty(tiles * 128, dtype=torch.float64, device=dev)
           for _ in range(3)]
    rc = lib.ffpic_probe_mma16(
        ta.data_ptr(), tb.data_ptr(), tc.data_ptr(),
        *(g.data_ptr() for g in got), tiles,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if rc:
        raise RuntimeError(f"mma probe: error {rc}")
    return (a, b, c, *(g.cpu().numpy().reshape(tiles, 16, 8) for g in got))


def mma16_forward_shares(lib, dev, seed: int = 25) -> dict:
    """{kind: share of mma.m16n8k16 .f64 results equal to the forward
    chain of FMAs} over every ``MMA_KINDS`` (K16's ``resize_band`` is
    bit-exact only where each is 1.0)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = {}
    for kind in MMA_KINDS:
        *_, mma, fwd, _rev = mma16_run(lib, dev, kind, rng)
        out[kind] = float((mma == fwd).mean())
    return out


def _fp64(dev, flush) -> dict:
    """``fp64_probe``: each rate mode's instructions a clock an SM (one
    CTA of 1,024 threads an SM, clock64 cycles of the slowest CTA, the
    best of 3), mma.m16n8k16 .f64's FMAs a clock an SM, and the share of
    its results equal to the forward and the reverse chain of FMAs and
    to the exactly rounded sum (from fractions on the host), on
    ``_mma16_tiles`` of each of ``MMA_KINDS``."""
    from fractions import Fraction
    import numpy as np
    import torch
    lib, log = fp64_probe()
    for ln in log.splitlines():
        if "registers" in ln or "Compiling" in ln or "spill" in ln:
            print(f"[fp64 ptxas] {ln.strip()}", file=sys.stderr)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    threads, iters = 1024, 2048
    cycles = torch.zeros(sms, dtype=torch.int64, device=dev)
    sink = torch.empty(sms * threads, dtype=torch.float64, device=dev)
    out = {}
    for mode, name, n_ops, b in FP64_MODES:
        best = None
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            rc = lib.ffpic_probe_rates(mode, iters, sms, threads, 1e-3, b,
                                       0.9999999, cycles.data_ptr(),
                                       sink.data_ptr(), stream)
            end.record()
            torch.cuda.synchronize()
            if rc:
                raise RuntimeError(f"fp64 probe mode {mode}: error {rc}")
            c = int(cycles.max())
            if best is None or c < best[0]:
                best = (c, start.elapsed_time(end))
        out[f"{name} a clock an SM"] = threads * iters * n_ops / best[0]
        # the SM clock over the launch (an upper bound on the time, so a
        # lower bound on the clock)
        out[f"{name} clock GHz"] = best[0] / best[1] / 1e6
    mma_sink = torch.empty(sms * 256, dtype=torch.float64, device=dev)
    best = None
    for _ in range(3):
        rc = lib.ffpic_probe_mma_rate(iters // 2, sms, cycles.data_ptr(),
                                      mma_sink.data_ptr(), stream)
        torch.cuda.synchronize()
        if rc:
            raise RuntimeError(f"mma rate probe: error {rc}")
        c = int(cycles.max())
        best = c if best is None else min(best, c)
    # 8 warps a CTA, each iters // 2 steps of 8 products of 2048 FMA
    out["mma m16n8k16 fma a clock an SM"] = 8 * (iters // 2) * 8 * 2048 / \
        best
    rng = np.random.default_rng(25)
    for kind in MMA_KINDS:
        a, b, c, mma, fwd, rev = mma16_run(lib, dev, kind, rng)
        out[f"mma16 {kind} equal forward chain share"] = float(
            (mma == fwd).mean())
        out[f"mma16 {kind} equal reverse chain share"] = float(
            (mma == rev).mean())
        tiles = len(a)
        a3, b3 = a.reshape(tiles, 16, 16), b.reshape(tiles, 8, 16)
        c3 = c.reshape(tiles, 16, 8)
        hits = total = 0
        for t in range(0, tiles, 32):
            for r in range(16):
                for j in range(8):
                    exact = Fraction(float(c3[t, r, j])) + sum(
                        Fraction(float(a3[t, r, k])) *
                        Fraction(float(b3[t, j, k])) for k in range(16))
                    hits += float(exact) == float(mma[t, r, j])
                    total += 1
        out[f"mma16 {kind} equal exact rounding share"] = hits / total
    return out


def _k15(dev, flush) -> dict:
    import torch
    import ffpic_tpu_torch
    from ffpic_tpu_torch import testing
    from ffpic_tpu_torch.formats import heif
    from ffpic_tpu_torch.ops import hevc_kernels as hk
    data = testing.heif_fixture()
    saved = {k: os.environ.pop(k, None) for k in
             ("FFPIC_HEVC_DEVICE", "FFPIC_HEIF_DEVICE_COLOR")}
    os.environ["FFPIC_HEIF_DEVICE_COLOR"] = "1"
    try:
        want = ffpic_tpu_torch.load(data, device="cpu").pixels
        f = heif.parse(data, False, "bt601", dev)
        staged = heif._stage_tiles(f, dev)

        def colour():
            return hk.hevc_tiles_to_rgba(staged, f.mode)
        if not torch.equal(colour().cpu(), want):
            raise AssertionError("heif.color of the fixture differs from the "
                                 "CPU route")
        out = {}
        # 2 loads a timing: a design with a launch a tile takes the host
        # about 1 ms a load to enqueue, so gpu_ms's spin kernel holds only
        # a few loads; older trees' numbers were timed so too
        t = _timed(colour, flush, 2, 5)
        out["heif.color 12mp ms"] = t["ms"]
        out["heif.color 12mp ms_cold"] = t["ms_cold"]
        ffpic_tpu_torch.load(data)
        walls = []
        for _ in range(5):
            t1 = time.perf_counter()
            ffpic_tpu_torch.load(data)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
        out["load device_color ms"] = statistics.median(walls) * 1e3
    finally:
        os.environ.pop("FFPIC_HEIF_DEVICE_COLOR")
        os.environ.update({k: v for k, v in saved.items() if v})
    return out


def _k6(dev, flush) -> dict:
    import numpy as np
    import torch
    from ffpic_tpu_torch import testing
    from ffpic_tpu_torch.formats import png
    from ffpic_tpu_torch.ops import cuda_png
    from ffpic_tpu_torch.ops import png_kernels as pk
    px = np.concatenate([testing.synth_rgb(H, W, 31),
                         testing.synth_rgb(H, W, 32)[..., :1]], -1)
    subup = np.array(png.parse(testing.encode_png(
        px, 6, 8, filters=(1, 2))).passes[0].rows)
    rng = np.random.default_rng(6)
    cases = {"1080p subup": (subup, 4)}
    for name, tag in (("1080p all none", 0), ("1080p all sub", 1),
                      ("1080p all up", 2)):
        rows = subup.copy()
        rows[:, 0] = tag
        cases[name] = (rows, 4)
    noise = rng.integers(0, 256, (H, 4 * W + 1)).astype(np.uint8)
    noise[:, 0] = rng.integers(0, 3, H)
    cases["1080p random filters"] = (noise, 4)
    # the widest row the tests hold: 20,000 px of 16-bit RGBA
    wide = rng.integers(0, 256, (64, 160_001)).astype(np.uint8)
    wide[:, 0] = np.arange(64) % 2 + 1
    cases["20000px rgba16 x64 subup"] = (wide, 8)
    out = {}
    for name, (rows, bpp) in cases.items():
        t = torch.from_numpy(rows).to(dev)

        def fn(t=t, bpp=bpp):
            return cuda_png.unfilter_subup(t, bpp)
        if not torch.equal(fn(), pk.unfilter_subup(t, bpp)):
            raise AssertionError(f"K6 on {name} differs from its plain "
                                 "version")
        cuda_png.reset_launches()
        fn()
        out[f"{name} launches"] = cuda_png.launches["unfilter_subup"]
        r = _timed(fn, flush)
        out[f"{name} ms"], out[f"{name} ms_cold"] = r["ms"], r["ms_cold"]
        if name.startswith("1080p"):
            for k, ms in _device_ms(fn).items():
                out[f"{name} profiler {k} ms"] = ms
    # trees whose K6 takes its bands from cuda_png.unfilter_bands: other
    # bands of rows x chunk bytes, each checked
    bands = getattr(cuda_png, "unfilter_bands", None)
    if bands is not None:
        try:
            for rows, chunk in ((1, 7680), (2, 7680), (3, 7680), (8, 3840),
                                (4, 3840), (16, 1536)):
                cuda_png.unfilter_bands = lambda h, s, r=rows, c=chunk: (r,
                                                                         c)
                for name in ("1080p subup", "1080p all up",
                             "1080p random filters"):
                    t = torch.from_numpy(cases[name][0]).to(dev)
                    if not torch.equal(cuda_png.unfilter_subup(t, 4),
                                       pk.unfilter_subup(t, 4)):
                        raise AssertionError(f"K6 at {rows}x{chunk} on "
                                             f"{name} differs")
                    out[f"bands {rows}x{chunk} {name} ms"] = _timed(
                        lambda t=t: cuda_png.unfilter_subup(t, 4), flush,
                        20, 5)["ms"]
        finally:
            cuda_png.unfilter_bands = bands
    return out


def _k8(dev, flush) -> dict:
    import numpy as np
    import torch
    from ffpic_tpu_torch import pipeline, testing
    from ffpic_tpu_torch.formats import jpg
    from ffpic_tpu_torch.ops import cuda_jpeg
    from ffpic_tpu_torch.ops import jpeg_kernels as jk
    n = 8
    jpegs = [testing.synth_jpeg_420(H, W, 85, 1),
             testing.synth_jpeg_420(H, W, 95, 2)]
    js = [jpg.parse_and_decode(jpegs[k % 2])[0] for k in range(n)]
    shapes = tuple((c.nby, c.nbx) for c in js[0].comps)
    sizes = [a * b for a, b in shapes]
    idx, val, lens = pipeline.sparse_pairs(
        [pipeline.member_pairs(j) for j in js],
        [c.size for c in js[0].coeffs])
    cut = np.cumsum([0, *lens]).tolist()
    rng = np.random.default_rng(8)
    routes = {}
    # the same number of pairs a plane, a fifth of the coefficients, at
    # random: the host's order, and shuffled
    uni = []
    for (a, b), nb in zip(zip(cut[:-1], cut[1:]), sizes):
        total = n * nb * 64
        k = np.sort(rng.choice(total, min(b - a, total), replace=False))
        vv = rng.integers(1, 100, k.size).astype(np.int16)
        uni.append((torch.from_numpy(k.astype(np.int32)).to(dev),
                    torch.from_numpy(vv).to(dev)))
    routes["uniform"] = uni
    for name, order in (("sorted", None), ("unsorted", "shuffle")):
        planes = []
        for a, b in zip(cut[:-1], cut[1:]):
            p = rng.permutation(b - a) if order else np.arange(b - a)
            planes.append((torch.from_numpy(idx[a:b][p]).to(dev),
                           torch.from_numpy(val[a:b][p]).to(dev)))
        routes[name] = planes
    yq, cq = (torch.from_numpy(np.stack([j.dqt[j.comps[c].tq] for j in js])
                               .astype(np.int32)).to(dev) for c in (0, 1))
    coeffs = torch.empty((n, sum(sizes), 8, 8), dtype=torch.int16,
                         device=dev)
    offs = np.cumsum([0, *sizes]).tolist()

    def k8(planes):
        # each tree's decode_batch_420_sparse rebuilds the planes so:
        # one launch over the three, or a launch (and a memset) a plane
        if hasattr(cuda_jpeg, "scatter_planes"):
            return cuda_jpeg.scatter_planes(planes, coeffs, sizes)
        for (it, vt), nb, off in zip(planes, sizes, offs):
            cuda_jpeg.scatter_plane(it, vt, coeffs[:, off:off + nb])
        return coeffs

    want = torch.cat([jk.scatter_plane(it, vt, (n, nb)) for (it, vt), nb
                      in zip(routes["sorted"], sizes)], dim=1)
    out = {"pairs": float(sum(lens))}
    for name, planes in routes.items():
        if name == "uniform":
            if not torch.equal(k8(planes), torch.cat(
                    [jk.scatter_plane(it, vt, (n, nb))
                     for (it, vt), nb in zip(planes, sizes)], dim=1)):
                raise AssertionError("K8 on uniform pairs differs from its "
                                     "plain version")
            r = _timed(lambda p=planes: k8(p), flush)
            out["K8 uniform ms"], out["K8 uniform ms_cold"] = r["ms"], \
                r["ms_cold"]
            continue
        if not torch.equal(k8(planes), want):
            raise AssertionError(f"K8 on the {name} planes differs from its "
                                 "plain version")
        cuda_jpeg.reset_launches()
        k8(planes)
        out[f"K8 {name} launches"] = cuda_jpeg.launches["scatter_plane"]
        warm, cold = (50, 20) if name == "sorted" else (3, 3)
        r = _timed(lambda p=planes: k8(p), flush, warm, cold)
        out[f"K8 {name} ms"], out[f"K8 {name} ms_cold"] = r["ms"], r["ms_cold"]
        if name == "sorted":
            for k, ms in _device_ms(lambda: k8(planes)).items():
                out[f"K8 {name} profiler {k} ms"] = ms
    planes = routes["sorted"]

    def route():
        return jk.decode_batch_420_sparse(planes, n, shapes, yq, cq, "rgba",
                                          "bt601", (H, W))
    plain = jk.decode_batch_420_dense(want, yq, cq, shapes, "rgba", "bt601",
                                      (H, W))
    if not torch.equal(route(), plain):
        raise AssertionError("the sparse route differs from K2 + K3 on the "
                             "plain planes")
    r = _timed(route, flush)
    out["route K8+K2+K3 ms"], out["route K8+K2+K3 ms_cold"] = \
        r["ms"], r["ms_cold"]
    longs = [(it.to(torch.int64), vt) for it, vt in planes]

    def library():
        for (il, vt), nb in zip(longs, sizes):
            torch.zeros(n * nb * 64, dtype=torch.int16,
                        device=dev).index_add_(0, il, vt)
    r = _timed(library, flush)
    out["library zeros+index_add_ ms"] = r["ms"]
    out["library zeros+index_add_ ms_cold"] = r["ms_cold"]
    return out


def _jpeg(dev, flush) -> dict:
    import numpy as np
    import torch
    from ffpic_tpu_torch import testing
    from ffpic_tpu_torch.formats import jpg
    from ffpic_tpu_torch.formats.jpg import packed_block_map
    from ffpic_tpu_torch.ops import cuda_jpeg
    from ffpic_tpu_torch.ops import jpeg_kernels as jk
    n = 8
    jpegs = [testing.synth_jpeg_420(H, W, 85, 1),
             testing.synth_jpeg_420(H, W, 95, 2)]
    plans = [jpg.parse_and_decode(jpegs[k % 2], packed=True)[0]
             for k in range(n)]
    j0 = plans[0]
    shapes = tuple((c.nby, c.nbx) for c in j0.comps)
    (nby, nbx), _, _ = shapes
    nblocks = sum(a * b for a, b in shapes)
    buf_np, g, e = jk.stack_packed_fused([j.packed for j in plans])
    buf = torch.from_numpy(buf_np).to(dev)
    bmap = packed_block_map(j0, dev)
    yq, cq = (torch.from_numpy(np.stack([j.dqt[j.comps[c].tq] for j in plans])
                               .astype(np.int32)).to(dev) for c in (0, 1))
    starts = cuda_jpeg.count_scan(buf, n, g)
    coeffs = cuda_jpeg.unpack(buf, starts, bmap, n, g, e, nblocks)
    samples = cuda_jpeg.dequant_idct(coeffs, yq, cq, nby * nbx)
    counts, ks, vals = jk.split_packed(buf, n, g, e)
    plain = jk.decode_batch_420(jk.unpack_coeffs(counts, ks, vals, bmap,
                                                 nblocks),
                                yq, cq, shapes, "rgba", "bt601", (H, W))
    if not torch.equal(cuda_jpeg.assemble_color(samples, nby, nbx, "rgba",
                                                "bt601", (H, W)), plain):
        raise AssertionError("K1a-K3 differ from the plain route")
    # K4 on a 4000x3000 4:2:2 layout, K5 on 1080p's blocks (random samples)
    rng = np.random.default_rng(4)
    sh422, sa422 = ((375, 500), (375, 250), (375, 250)), ((1, 1), (1, 2),
                                                          (1, 2))
    s422 = torch.from_numpy(rng.integers(
        0, 256, (sum(a * b for a, b in sh422), 8, 8)).astype(np.int16)).to(dev)
    blocks = torch.from_numpy(rng.integers(
        -128, 128, (nblocks * n, 8, 8)).astype(np.int16)).to(dev)
    out = {}
    for name, fn in (
            ("K1a count_scan", lambda: cuda_jpeg.count_scan(buf, n, g)),
            ("K1b unpack", lambda: cuda_jpeg.unpack(buf, starts, bmap, n, g,
                                                    e, nblocks)),
            ("K2 dequant_idct", lambda: cuda_jpeg.dequant_idct(
                coeffs, yq, cq, nby * nbx)),
            ("K3 assemble_color", lambda: cuda_jpeg.assemble_color(
                samples, nby, nbx, "rgba", "bt601", (H, W))),
            ("K4 assemble_mcu 12mp 422 fancy", lambda: cuda_jpeg.assemble_mcu(
                s422, sh422, sa422, 3000, 4000, "rgba", "bt601", 128,
                "fancy")),
            ("K5 fdct 8x1080p blocks", lambda: cuda_jpeg.fdct(blocks))):
        r = _timed(fn, flush)
        out[f"{name} ms"], out[f"{name} ms_cold"] = r["ms"], r["ms_cold"]
    return out


def run(tree: str, groups) -> dict:
    """One tree's numbers (see the module's docstring)."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    import ffpic_tpu_torch
    from ffpic_tpu_torch.ops import _build
    pkg = os.path.dirname(os.path.abspath(ffpic_tpu_torch.__file__))
    if pkg != os.path.join(os.path.abspath(tree), "ffpic_tpu_torch"):
        raise RuntimeError(f"imported {pkg}, not the tree's package")
    t0 = time.perf_counter()
    so = _build.library_path()
    _build.load()
    build_s = time.perf_counter() - t0
    names = tuple(k for g in groups for k in KERNELS[g])
    with open(so[:-3] + ".log") as f:
        lines = [ln.strip() for ln in f if "Used" in ln or "Compiling" in ln]
    ptxas = [ln for k, ln in enumerate(lines)
             if any(n + "_kernel" in ln or
                    (k and "Compiling" in lines[k - 1] and
                     n + "_kernel" in lines[k - 1]) for n in names)]
    dev = torch.device("cuda")
    flush = torch.empty(100 * 2 ** 20, dtype=torch.uint8, device=dev)
    run_group = {"k7": _k7, "k14": _k14, "k18": _k18, "entropy": _entropy,
                 "vp8": _vp8, "k13": _k13, "k16": _k16, "k15": _k15,
                 "k6": _k6, "k8": _k8, "jpeg": _jpeg, "fp64": _fp64}
    return {"tree": os.path.abspath(tree), "build_s": build_s,
            "ptxas": ptxas,
            "groups": {g: run_group[g](dev, flush) for g in groups}}


def _rows(result: dict) -> dict:
    return {f"{g} {k}": v for g, nums in result["groups"].items()
            for k, v in nums.items()}


def _one(tree: str, kernels: str) -> dict:
    r = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree",
                        tree, "--kernels", kernels], capture_output=True,
                       text=True, timeout=900)
    sys.stderr.write(r.stderr[-4000:])
    if r.returncode != 0:
        raise RuntimeError(f"run on {tree} failed ({r.returncode})")
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    print(line, flush=True)
    return json.loads(line[len("RESULT "):])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="an older checkout to compare with")
    ap.add_argument("--tree", help="time this checkout alone (one run)")
    ap.add_argument("--kernels", default=",".join(GROUPS),
                    help=f"groups to time, of {','.join(GROUPS)}")
    ap.add_argument("--rounds", type=int, default=1)
    a = ap.parse_args()
    groups = [g for g in a.kernels.split(",") if g]
    if not groups or set(groups) - set(GROUPS):
        ap.error(f"--kernels: name groups of {','.join(GROUPS)}")
    import torch
    if not torch.cuda.is_available():
        print("compare_kernels: CUDA is not available", file=sys.stderr)
        return 1
    if a.tree:
        print("RESULT " + json.dumps(run(a.tree, groups)), flush=True)
        return 0
    if not a.parent:
        ap.error("give --parent DIR or --tree DIR")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    got, ptxas = {"parent": [], "change": []}, {}
    for _ in range(a.rounds):
        for who, tree in (("parent", a.parent), ("change", HERE),
                          ("change", HERE), ("parent", a.parent)):
            result = _one(tree, ",".join(groups))
            ptxas.setdefault(who, result["ptxas"])
            got[who].append(_rows(result))
    for who, lines in ptxas.items():
        for ln in lines:
            print(f"[ptxas {who}] {ln}")
    med = {who: {k: statistics.median(r[k] for r in runs if k in r)
                 for k in {k for r in runs for k in r}}
           for who, runs in got.items()}
    print(f"{'number':58s} {'parent':>10s} {'change':>10s} {'ratio':>7s}")
    for k in sorted(med["parent"].keys() | med["change"].keys()):
        p, c = med["parent"].get(k), med["change"].get(k)
        cells = ["-" if v is None else f"{v:.4f}" for v in (p, c)]
        ratio = f"{c / p:7.3f}" if p and c is not None else ""
        print(f"{k:58s} {cells[0]:>10s} {cells[1]:>10s} {ratio}")
    print("SUMMARY " + json.dumps({"device": smi, "median": med}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
