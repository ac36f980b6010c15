#!/usr/bin/env python3
"""Smoke run of ffpic_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``ffpic_tpu_torch/csrc`` (nvcc, one
process per source) and the host decoder
``ffpic_tpu_torch/native/host_jpeg.c`` (cc), holds each kernel against
its plain PyTorch version on the card (bit-exact) at its paths' shapes
and at the edges of its tiling (``testing.scan_cases``,
``unpack_cases``, ``idct_cases``, ``assemble_cases``, ``mcu_cases``),
and drives three paths, each with the launch counts set to 0 just before
it and read just after:

* ``decode_batch`` over 8 baseline 4:2:0 1920x1080 JPEGs made from a
  seed (K1a count_scan, K1b unpack, K2 dequant_idct, K3 assemble_color),
  with the dense route checked against the plain route;
* ``load`` of one 4000x3000 baseline 4:2:2 JPEG with restart markers
  (``mode="bt601", upsample="fancy"``: K2, K4 assemble_mcu), checked
  against the CPU route and its source; other samplings (4:4:4, 4:2:0
  fancy, 4:4:0, 4:1:1, gray, a Cr table of its own) and a
  ``decode_batch`` mixing 4:2:0 and 4:4:4 members (also under a side
  stream while the default stream is busy) are checked too;
* ``encode`` of a 1920x1080 image at q90 (K5 fdct), whose bytes must
  be the CPU route's and decode back within 30 dB.

It times each kernel, warm and with L2 flushed, beside its bound, its
plain version, (``count_scan``) one ``torch.cumsum`` and the launch
floor (the fastest empty launch in the same loop), and each path end to
end with its host spans.  One line per phase; then the kernel table as
one JSON line, and last ``{"ok": true, "device": {...}}``.  Any failure
raises and exits non-zero; without CUDA it exits 1 at once.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

H, W, N = 1080, 1920, 8
BIG_H, BIG_W = 3000, 4000           # the load path: a 12 MP phone photo
CU = "ffpic_tpu_torch/csrc/jpeg_decode.cu"
CODEC_CU = "ffpic_tpu_torch/csrc/jpeg_codec.cu"
REPLACES = {
    "count_scan": "ffpic_tpu/ops/jpeg_kernels.py:313",
    "unpack": "ffpic_tpu/ops/jpeg_kernels.py:323",
    "dequant_idct": "ffpic_tpu/ops/pallas_jpeg.py:32",
    "assemble_color": "ffpic_tpu/ops/jpeg_kernels.py:144",
    "assemble_mcu": "ffpic_tpu/ops/jpeg_kernels.py:196",
    "fdct": "ffpic_tpu/ops/jpeg_kernels.py:83",
}
SOURCES = {"assemble_mcu": CODEC_CU, "fdct": CODEC_CU}
PATH_420 = ("count_scan", "unpack", "dequant_idct", "assemble_color")


def log(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def max_abs_err(a, b) -> int:
    import torch
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) \
        if a.numel() else 0


def exact(name: str, got, want, errs: dict) -> None:
    err = max_abs_err(got, want)
    errs[name] = max(errs.get(name, 0), err)
    if err:
        raise AssertionError(f"{name}: kernel differs from its plain version "
                             f"by up to {err}")


def ptxas_report(text: str) -> dict:
    """``nvcc -Xptxas -v`` output -> {kernel: {registers, smem_bytes,
    stack_bytes, spill_bytes}}, a template instance named with its
    arguments, e.g. ``assemble_color<1,0>`` (mode, order) or
    ``assemble_mcu<1,0,1>`` (mode, order, fancy)."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"(count_scan|unpack|dequant_idct|assemble_color|"
                          r"assemble_mcu|fdct)_kernel((?:L[ib]\d+E)*)",
                          m.group(1).replace("_kernelI", "_kernel"))
            args = re.findall(r"L[ib](\d+)E", k.group(2))
            name = k.group(1) + (f"<{','.join(args)}>" if args else "")
            out[name] = {}
        elif name and "stack frame" in line:
            stack, st, ld = map(int, re.findall(r"(\d+) bytes", line))
            out[name].update(stack_bytes=stack, spill_bytes=st + ld)
        elif name and "registers" in line:
            out[name]["registers"] = int(re.search(r"(\d+) registers",
                                                   line).group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[name]["smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def codec_paths(dev, jpegs, floor_ms: float, errs: dict) -> dict:
    """The JPEG codec on the card: K4 and K5 (and K2 on per-component
    views) against their plain versions, the ``load`` and ``encode``
    paths each driven with fresh launch counts and checked, a
    ``decode_batch`` with a 4:4:4 member, and the timings.  Returns
    {kernel: timing entry} and the launches of each path."""
    import numpy as np
    import torch
    import ffpic_tpu_torch
    from ffpic_tpu_torch import Pic, testing
    from ffpic_tpu_torch.formats import jpg
    from ffpic_tpu_torch.formats.jpg_encode import _rgb_to_yuv420, _to_blocks
    from ffpic_tpu_torch.ops import cuda_jpeg
    from ffpic_tpu_torch.ops import jpeg_kernels as jk
    from ffpic_tpu_torch.ops.resize import resize_rgba
    from ffpic_tpu_torch.utils import trace
    from ffpic_tpu_torch.utils.timing import (F32_OPS_PER_S, INT32_OPS_PER_S,
                                              bound, gpu_ms, gpu_ms_cold)

    modes, orders = ("reference", "bt601", "rgb"), ("rgba", "bgra")

    def ups(samplings):
        return ("nearest", "fancy") if testing.fancy_ok(samplings) \
            else ("nearest",)

    # --- inputs ------------------------------------------------------------
    t0 = time.perf_counter()
    big_rgb = testing.synth_rgb(BIG_H, BIG_W, 21)
    t1 = time.perf_counter()
    big = testing.encode_jpeg(big_rgb, 90, testing.SAMPLINGS["422"],
                              restart_interval=64)
    t2 = time.perf_counter()
    log("inputs codec", load_jpeg=f"{BIG_W}x{BIG_H} 4:2:2 q90 DRI 64",
        bytes=len(big), synth_rgb_seconds=f"{t1 - t0:.3f}",
        encode_seconds=f"{t2 - t1:.3f}",
        synthesis_seconds=f"{t2 - t0:.3f}")
    j, _ = jpg.parse_and_decode(big)
    shapes = tuple((c.nby, c.nbx) for c in j.comps)
    hmax, vmax = max(c.h for c in j.comps), max(c.v for c in j.comps)
    samplings = tuple((vmax // c.v, hmax // c.h) for c in j.comps)
    nblocks = sum(a * b for a, b in shapes)
    ow = (BIG_W + 7) & ~7
    coeffs = torch.from_numpy(np.concatenate(
        [c.reshape(-1, 64) for c in j.coeffs]).reshape(-1, 8, 8)).to(dev)
    quants = np.stack([j.dqt[c.tq] for c in j.comps])
    qd = torch.from_numpy(quants).to(dev)
    if not np.array_equal(quants[1], quants[2]):
        raise AssertionError("the load file's chroma must share a table")

    # --- K2 on the load path's layouts ---------------------------------------
    c4 = coeffs.view(1, -1, 8, 8)
    ny = shapes[0][0] * shapes[0][1]
    samples4 = cuda_jpeg.dequant_idct(c4, qd[0:1], qd[1:2], ny)
    exact("dequant_idct", samples4,
          jk.dequant_idct_blocks(c4, qd[0:1], qd[1:2], ny), errs)
    rng = np.random.default_rng(5)
    rq = torch.from_numpy(rng.integers(1, 65536, (3, 64),
                                       dtype=np.int32)).to(dev)
    views = torch.empty_like(c4)
    bounds = [0, ny, ny + shapes[1][0] * shapes[1][1], nblocks]
    for c in range(3):
        a, b = bounds[c], bounds[c + 1]
        cuda_jpeg.dequant_idct(c4[:, a:b], rq[c:c + 1], rq[c:c + 1], b - a,
                               out=views[:, a:b])
        exact("dequant_idct", views[:, a:b], jk.dequant_idct_blocks(
            c4[:, a:b], rq[c:c + 1], rq[c:c + 1], b - a), errs)
    log("check K2 views", shapes=shapes, tables="distinct Cb/Cr, full "
        "range", per_component="exact", shared_tables_12mp="exact")
    samples = samples4[0]

    # --- K4 against its plain version ---------------------------------------
    n = 0
    for name, (smp, sh, sa, oh, cw) in testing.mcu_cases().items():
        smp = torch.from_numpy(smp).to(dev)
        for up in ups(sa):
            for mode in modes:
                for order in orders:
                    for gray in ((128, 0) if len(sh) == 1 else (128,)):
                        exact("assemble_mcu", cuda_jpeg.assemble_mcu(
                            smp, sh, sa, oh, cw, order, mode, gray, up),
                            jk.assemble_mcu(smp, sh, sa, oh, cw, order,
                                            mode, gray, up), errs)
                        n += 1
    for up in ("nearest", "fancy"):
        for mode in modes:
            for order in orders:
                exact("assemble_mcu", cuda_jpeg.assemble_mcu(
                    samples, shapes, samplings, BIG_H, ow, order, mode, 128,
                    up), jk.assemble_mcu(samples, shapes, samplings, BIG_H,
                                         ow, order, mode, 128, up), errs)
                n += 1
    log("check K4", assemble_mcu="exact", launches=n,
        cases=",".join(testing.mcu_cases()) + f",{BIG_W}x{BIG_H}_422",
        modes="x".join(modes), orders="x".join(orders),
        upsample="nearest,fancy(factors<=2)", gray_chroma="128,0")

    # --- K5 against its plain version ---------------------------------------
    enc_rgb = testing.synth_rgb(H, W, 22)
    enc_blocks = torch.from_numpy(np.concatenate(
        [_to_blocks(p).reshape(-1, 8, 8)
         for p in _rgb_to_yuv420(enc_rgb)[:3]])).to(dev)
    for blk in (torch.from_numpy(rng.integers(-128, 128, (5000, 8, 8),
                                              dtype=np.int16)).to(dev),
                torch.from_numpy(rng.integers(-32768, 32768, (5000, 8, 8),
                                              dtype=np.int16)).to(dev),
                enc_blocks, enc_blocks[:33]):
        exact("fdct", cuda_jpeg.fdct(blk), jk.forward_dct(blk), errs)
    log("check K5", fdct="exact", cases="level-shifted,full-int16,"
        f"encode-{enc_blocks.shape[0]}-blocks,33-blocks")

    # --- the load path -------------------------------------------------------
    torch.cuda.synchronize()
    cuda_jpeg.reset_launches()
    pic = ffpic_tpu_torch.load(big, mode="bt601", upsample="fancy")
    torch.cuda.synchronize()
    launches_load = dict(cuda_jpeg.launches)
    px = pic.pixels
    if (tuple(px.shape) != (BIG_H, ow, 4) or px.dtype != torch.uint8
            or px.device.type != dev.type):
        raise AssertionError(f"load gave {tuple(px.shape)} {px.dtype} on "
                             f"{px.device}")
    if launches_load["dequant_idct"] < 1 or launches_load["assemble_mcu"] < 1:
        raise AssertionError(f"load did not run K2 and K4: {launches_load}")
    cpu_pic = ffpic_tpu_torch.load(big, device="cpu", mode="bt601",
                                   upsample="fancy")
    if not torch.equal(px.cpu(), cpu_pic.pixels):
        raise AssertionError("load on the card differs from the CPU route")
    psnr_load = testing.psnr(px[:, :BIG_W, :3], big_rgb)
    if psnr_load < 30 or not torch.all(px[..., 3] == 255):
        raise AssertionError(f"load: PSNR {psnr_load:.2f} dB")
    log("load path", shape=tuple(px.shape), launches=launches_load,
        cpu_route="exact", psnr_db=f"{psnr_load:.2f}")

    # the other samplings, each file through load on the card and the CPU
    gray = testing.encode_jpeg(testing.synth_rgb(H, W, 26)[..., 0], 85,
                               ((1, 1),))
    checks = {
        "1080p_444": (testing.encode_jpeg(testing.synth_rgb(H, W, 23), 85,
                                          testing.SAMPLINGS["444"]),
                      {"mode": "bt601"}),
        "420_fancy": (jpegs[0], {"upsample": "fancy"}),
        "440": (testing.encode_jpeg(testing.synth_rgb(H, W, 24), 85,
                                    testing.SAMPLINGS["440"]),
                {"upsample": "fancy", "order": "bgra"}),
        "411_nearest": (testing.encode_jpeg(testing.synth_rgb(H, W, 25), 85,
                                            testing.SAMPLINGS["411"],
                                            restart_interval=16), {}),
        "gray": (gray, {}),
        "gray_quirks": (gray, {"quirks": True}),
        "cr_table": (testing.encode_jpeg(testing.synth_rgb(H, W, 27), 85,
                                         cr_quality=40), {"mode": "rgb"}),
    }
    for name, (data, kw) in checks.items():
        cuda_jpeg.reset_launches()
        got = ffpic_tpu_torch.load(data, **kw).pixels
        torch.cuda.synchronize()
        k2 = cuda_jpeg.launches["dequant_idct"]
        want = ffpic_tpu_torch.load(data, device="cpu", **kw).pixels
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"load {name}: the card differs from the "
                                 "CPU route")
        if name == "cr_table" and k2 != 3:
            raise AssertionError(f"a distinct Cr table takes 3 K2 launches, "
                                 f"got {k2}")
    log("check load", cases=",".join(checks), cpu_route="exact",
        cr_table_k2_launches=3)

    # decode_batch with 4:4:4 members beside 4:2:0 ones
    mixed = [jpegs[0], checks["1080p_444"][0], jpegs[1], gray]
    got = ffpic_tpu_torch.decode_batch(mixed, device=dev)
    decode_plain = ffpic_tpu_torch.decode_batch(mixed, device="cpu")
    if not torch.equal(got.cpu(), decode_plain):
        raise AssertionError("mixed decode_batch: the card differs from the "
                             "CPU route")
    sized = ffpic_tpu_torch.decode_batch(mixed, size=(224, 224),
                                         device=dev)
    want = torch.stack([resize_rgba(p.to(dev), (224, 224))
                        for p in decode_plain])
    sized_cpu = ffpic_tpu_torch.decode_batch(mixed, size=(224, 224),
                                             device="cpu")
    diff_cpu = max_abs_err(sized.cpu(), sized_cpu)
    if not torch.equal(sized, want) or diff_cpu > 1:
        raise AssertionError("mixed decode_batch size=(224, 224) differs")
    # the same batch under a side stream, read there at once, while the
    # default stream spins: a copy or launch of decode_batch that is not
    # on the caller's stream would be read before it ran
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)             # ~0.2 s on the default stream
    with torch.cuda.stream(side):
        on_side = ffpic_tpu_torch.decode_batch(mixed, device=dev).clone()
    torch.cuda.synchronize()
    if not torch.equal(on_side.cpu(), decode_plain):
        raise AssertionError("mixed decode_batch under a side stream differs "
                             "from the CPU route")
    log("check decode_batch mixed", members="420,444,420,gray",
        shape=tuple(sized.shape), cpu_route_unsized="exact",
        sized_vs_card_resize_of_cpu_route="exact",
        sized_vs_cpu_route_max_abs=diff_cpu, side_stream="exact")

    # --- the encode path -----------------------------------------------------
    enc_pic = Pic(pixels=torch.from_numpy(enc_rgb).to(dev), width=W, height=H)
    torch.cuda.synchronize()
    cuda_jpeg.reset_launches()
    data = ffpic_tpu_torch.encode(enc_pic, "JPG", quality=90)
    launches_enc = dict(cuda_jpeg.launches)
    if launches_enc["fdct"] != 1:
        raise AssertionError(f"encode: K5 launches {launches_enc}")
    if data != ffpic_tpu_torch.encode(enc_pic, "JPG", quality=90,
                                      device="cpu"):
        raise AssertionError("encode on the card differs from the CPU route")
    back = ffpic_tpu_torch.load(data, mode="bt601").pixels
    psnr_enc = testing.psnr(back[:, :W, :3], enc_rgb)
    if psnr_enc < 30:
        raise AssertionError(f"encode round trip: PSNR {psnr_enc:.2f} dB")
    log("encode path", bytes=len(data), launches=launches_enc,
        cpu_route="same bytes", round_trip_psnr_db=f"{psnr_enc:.2f}")

    # --- timing --------------------------------------------------------------
    flush = torch.empty(100 * 2 ** 20, dtype=torch.uint8, device=dev)
    npx = BIG_H * ow
    work = {   # name: (kernel, plain, bytes, ops, type of the ops)
        "assemble_mcu": (
            lambda: cuda_jpeg.assemble_mcu(samples, shapes, samplings, BIG_H,
                                           ow, "rgba", "bt601", 128, "fancy"),
            lambda: jk.assemble_mcu(samples, shapes, samplings, BIG_H, ow,
                                    "rgba", "bt601", 128, "fancy"),
            128 * nblocks + 4 * npx, 30 * npx, "f32"),
        "dequant_idct": (
            lambda: cuda_jpeg.dequant_idct(c4, qd[0:1], qd[1:2], ny),
            lambda: jk.dequant_idct_blocks(c4, qd[0:1], qd[1:2], ny),
            256 * nblocks + 512, (64 + 2 * 1024) * nblocks, "int32"),
        "fdct": (lambda: cuda_jpeg.fdct(enc_blocks),
                 lambda: jk.forward_dct(enc_blocks),
                 256 * enc_blocks.shape[0], 2048 * enc_blocks.shape[0],
                 "int32"),
    }
    rates = {"int32": INT32_OPS_PER_S, "f32": F32_OPS_PER_S}
    timed = {}
    for name, (kern, pl, nbytes, ops, ops_type) in work.items():
        b_ms, b_by = bound(nbytes, ops, rates[ops_type])
        t = timed[name] = {
            "ms": gpu_ms(kern, 50), "ms_cold": gpu_ms_cold(kern, 20, flush),
            "plain_ms": gpu_ms(pl, 3), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "launch_floor_ms": floor_ms,
            "ops_type": ops_type, "bytes": nbytes, "ops": ops}
        t["share"] = b_ms / t["ms"]
        t["share_cold"] = b_ms / t["ms_cold"]
        log("time kernel", name=name, at=("encode" if name == "fdct"
                                          else "load"),
            ms=f"{t['ms']:.4f}", ms_cold=f"{t['ms_cold']:.4f}",
            plain_ms=f"{t['plain_ms']:.4f}", bound_ms=f"{b_ms:.4f}",
            bound_by=b_by, ops_ms=f"{ops / rates[ops_type] * 1e3:.4f}",
            ops_type=ops_type, share_warm=f"{t['share']:.3f}",
            share_cold=f"{t['share_cold']:.3f}", bytes=nbytes,
            launch_floor_ms=f"{floor_ms:.4f}", library_ms="null")
    del flush
    dev_ms = gpu_ms(lambda: jk.decode_mcu_planes(
        coeffs, shapes, quants, samplings, BIG_H, ow, "rgba", "bt601", 128,
        "fancy"), 20)

    def spans(fn, runs):
        trace.reset()
        trace.enable()
        walls = []
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        trace.enable(False)
        stages = {k: round(v["mean"] * 1e3, 3)
                  for k, v in trace.report().items()}
        return sorted(walls)[len(walls) // 2], walls, stages

    wall, walls, stages = spans(lambda: ffpic_tpu_torch.load(
        big, mode="bt601", upsample="fancy"), 5)
    mp = BIG_H * BIG_W / 1e6
    log("time load", megapixels=mp, device_ms=f"{dev_ms:.4f}",
        device_busy_share=f"{dev_ms / (wall * 1e3):.4f}",
        end_to_end_ms=f"{wall * 1e3:.3f}",
        end_to_end_ms_runs=json.dumps([round(w * 1e3, 3)
                                       for w in walls]).replace(" ", ""),
        jpeg_12mp_422_load_mps=f"{mp / wall:.2f}",
        stage_ms=json.dumps(stages).replace(" ", ""))
    wall, walls, stages = spans(lambda: ffpic_tpu_torch.encode(
        enc_pic, "JPG", quality=90), 3)
    log("time encode", megapixels=H * W / 1e6,
        device_ms=f"{timed['fdct']['ms']:.4f}",
        end_to_end_ms=f"{wall * 1e3:.3f}",
        end_to_end_ms_runs=json.dumps([round(w * 1e3, 3)
                                       for w in walls]).replace(" ", ""),
        jpeg_1080p_encode_mps=f"{H * W / 1e6 / wall:.3f}",
        stage_ms=json.dumps(stages).replace(" ", ""))
    return timed, {"load": launches_load, "encode": launches_enc}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    from ffpic_tpu_torch import decode_batch, native, testing
    from ffpic_tpu_torch.formats.jpg import packed_block_map
    from ffpic_tpu_torch.ops import _build, cuda_jpeg
    from ffpic_tpu_torch.ops import jpeg_kernels as jk
    from ffpic_tpu_torch.ops.resize import resize_rgba
    from ffpic_tpu_torch.pipeline import _prep
    from ffpic_tpu_torch.utils import trace
    from ffpic_tpu_torch.utils.timing import (F32_OPS_PER_S, INT32_OPS_PER_S,
                                              bound, gpu_ms, gpu_ms_cold)

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    log("env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count())

    # nvcc (the CUDA kernels) and cc (the host decoder) side by side
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        host = ex.submit(native.available)
        so = _build.library_path()
        _build.load()
        host.result()
    log("build", seconds=f"{time.perf_counter() - t0:.3f}",
        lib=os.path.basename(so), host_lib=os.path.basename(native._build()))
    with open(so[:-3] + ".log") as f:
        ptxas = ptxas_report(f.read())
    for name, info in ptxas.items():
        log("ptxas", kernel=name, **info)

    t0 = time.perf_counter()
    jpegs = [testing.synth_jpeg_420(H, W, 85, 1),
             testing.synth_jpeg_420(H, W, 95, 2)]
    srcs = [jpegs[k % 2] for k in range(N)]
    log("inputs", jpegs=f"2x{W}x{H} q85/q95", batch=N,
        bytes=[len(b) for b in jpegs],
        seconds=f"{time.perf_counter() - t0:.3f}")

    # --- kernels against their plain versions, on the card ---------------
    plans = [_prep(d)[0] for d in srcs]
    j0 = plans[0]
    shapes = tuple((c.nby, c.nbx) for c in j0.comps)
    (nby, nbx), _, _ = shapes
    nblocks = sum(a * b for a, b in shapes)
    buf_np, g, e = jk.stack_packed_fused([j.packed for j in plans])
    buf = torch.from_numpy(buf_np).to(dev)
    bmap = packed_block_map(j0, dev)
    yq = torch.from_numpy(np.stack([j.dqt[j.comps[0].tq] for j in plans])
                          .astype(np.int32)).to(dev)
    cq = torch.from_numpy(np.stack([j.dqt[j.comps[1].tq] for j in plans])
                          .astype(np.int32)).to(dev)
    if torch.equal(yq[0], yq[1]):
        raise AssertionError("the two qualities must give different tables")
    errs: dict = {}

    counts, ks, vals = jk.split_packed(buf, N, g, e)
    starts = cuda_jpeg.count_scan(buf, N, g)
    exact("count_scan", starts, jk.count_starts(counts), errs)
    coeffs = cuda_jpeg.unpack(buf, starts, bmap, N, g, e, nblocks)
    coeffs_p = jk.unpack_coeffs(counts, ks, vals, bmap, nblocks)
    exact("unpack", coeffs, coeffs_p, errs)
    rng = np.random.default_rng(0)
    # the edges of K1b's tiling: tiles cut inside MCUs, a part-full last
    # tile, a block with 64 nonzeros, all nonzeros in one block, N=1 and
    # N=3, tiles staged in several passes, and the hostile buffer (counts
    # up to 255 running past E, zigzag positions past 63, nonzero
    # padding, an odd vals offset, a shuffled block map)
    for case in testing.unpack_cases().values():
        cbuf, cn, cg, ce, cmap = case
        cbuf = torch.from_numpy(cbuf).to(dev)
        cmap = torch.from_numpy(cmap).to(dev)
        cc, cks, cv = jk.split_packed(cbuf, cn, cg, ce)
        cstarts = cuda_jpeg.count_scan(cbuf, cn, cg)
        exact("count_scan", cstarts, jk.count_starts(cc), errs)
        exact("unpack", cuda_jpeg.unpack(cbuf, cstarts, cmap, cn, cg, ce, cg),
              jk.unpack_coeffs(cc, cks, cv, cmap, cg), errs)
    # the edges of K1a's cluster cut: fewer words than CTAs, rows that
    # share a word, unaligned rows, all 255 and all 0, CTAs that loop;
    # each buffer exactly n*g bytes
    for cnt, cn, cg in testing.scan_cases().values():
        cnt = torch.from_numpy(cnt).to(dev)
        exact("count_scan", cuda_jpeg.count_scan(cnt, cn, cg),
              jk.count_starts(cnt.view(cn, cg)), errs)
    log("check K1", count_scan="exact", unpack="exact",
        nonzeros=[j.packed[3] for j in plans[:2]], e=e,
        edge_cases=",".join([*testing.unpack_cases(), *testing.scan_cases()]))

    samples = cuda_jpeg.dequant_idct(coeffs_p, yq, cq, nby * nbx)
    samples_p = jk.dequant_idct_blocks(coeffs_p, yq, cq, nby * nbx)
    exact("dequant_idct", samples, samples_p, errs)
    ext = np.full((4, 8, 8), 32767, np.int16)       # tests/test_idct.py:50
    ext[1] = -32768
    ext[2, :, ::2] = -32768
    ext[3, ::2, :] = 12345
    ext = torch.from_numpy(ext[None]).to(dev)
    q255 = torch.full((1, 64), 255, dtype=torch.int32, device=dev)
    exact("dequant_idct", cuda_jpeg.dequant_idct(ext, q255, q255, 4),
          jk.dequant_idct_blocks(ext, q255, q255, 4), errs)
    rblk = torch.from_numpy(rng.integers(-32768, 32768, (4, 4096, 8, 8),
                                         dtype=np.int16)).to(dev)
    rq = torch.from_numpy(rng.integers(1, 65536, (2, 4, 64),
                                       dtype=np.int32)).to(dev)
    exact("dequant_idct", cuda_jpeg.dequant_idct(rblk, rq[0], rq[1], 3000),
          jk.dequant_idct_blocks(rblk, rq[0], rq[1], 3000), errs)
    # the edges of K2's tiles: part-full last tiles, the luma/chroma
    # boundary at 0, at nblocks and at 32k +- 1, N=1 and N=3
    for cco, cyq, ccq, cnl in testing.idct_cases().values():
        cco, cyq, ccq = (torch.from_numpy(a).to(dev) for a in (cco, cyq, ccq))
        exact("dequant_idct", cuda_jpeg.dequant_idct(cco, cyq, ccq, cnl),
              jk.dequant_idct_blocks(cco, cyq, ccq, cnl), errs)
    log("check K2", dequant_idct="exact", cases="8x1080p,extreme,random," +
        ",".join(testing.idct_cases()))
    # the dense route (progressive members): K2 + K3 on the main path's
    # coefficients against the plain route
    dense = jk.decode_batch_420_dense(coeffs_p, yq, cq, shapes, "rgba",
                                      "bt601", (H, W))
    if not torch.equal(dense, jk.decode_batch_420(coeffs_p, yq, cq, shapes,
                                                  "rgba", "bt601", (H, W))):
        raise AssertionError("the dense route differs from the plain route")
    log("check dense route", shape=tuple(dense.shape), plain_route="exact")
    del dense

    exact("assemble_color", cuda_jpeg.assemble_color(
        samples_p, nby, nbx, "rgba", "bt601", (H, W)),
        jk.assemble_color(samples_p, shapes, "rgba", "bt601", (H, W)), errs)
    # every (y, u, v) in [0, 255]^3: a 4096x4096 4:2:0 image whose 2048^2
    # chroma samples take each (u, v) 64 times, with the 4 luma pixels
    # under each chroma sample covering 4 of y's 256 values
    s = torch.arange(2048 * 2048, device=dev).view(2048, 2048)
    u = ((s % 65536) // 256).to(torch.int16)
    v = (s % 256).to(torch.int16)
    quad = torch.arange(4, device=dev).view(2, 2)
    y = ((s // 65536)[:, None, :, None] * 4 + quad[None, :, None, :]) \
        .reshape(4096, 4096).to(torch.int16)

    def blocks(p):
        hb, wb = p.shape[0] // 8, p.shape[1] // 8
        return p.view(hb, 8, wb, 8).permute(0, 2, 1, 3).reshape(-1, 8, 8)

    full = torch.cat([blocks(y), blocks(u), blocks(v)])[None].contiguous()
    rnd = torch.from_numpy(rng.integers(-32768, 32768, (2, 96, 8, 8),
                                        dtype=np.int16)).to(dev)
    for mode in ("reference", "bt601", "rgb"):
        for order in ("rgba", "bgra"):
            for smp, gy, gx in ((full, 512, 512), (rnd, 8, 8)):
                exact("assemble_color",
                      cuda_jpeg.assemble_color(smp, gy, gx, order, mode),
                      jk.assemble_color(
                          smp, ((gy, gx), (gy // 2, gx // 2)) + (
                              (gy // 2, gx // 2),), order, mode), errs)
    del full, s, u, v, y
    for smp, gy, gx, hw in testing.assemble_cases().values():
        smp = torch.from_numpy(smp).to(dev)
        shp = ((gy, gx), (gy // 2, gx // 2), (gy // 2, gx // 2))
        for mode in ("reference", "bt601", "rgb"):
            for order in ("rgba", "bgra"):
                exact("assemble_color",
                      cuda_jpeg.assemble_color(smp, gy, gx, order, mode, hw),
                      jk.assemble_color(smp, shp, order, mode, hw), errs)
    log("check K3", assemble_color="exact", cases="256^3 x 3 modes x 2 "
        "orders + random int16 + " + ",".join(testing.assemble_cases()))

    # --- the main path ----------------------------------------------------
    torch.cuda.synchronize()
    cuda_jpeg.reset_launches()
    out = decode_batch(srcs, device="cuda")
    torch.cuda.synchronize()
    launches = dict(cuda_jpeg.launches)
    if (tuple(out.shape) != (N, H, W, 4) or out.dtype != torch.uint8
            or out.device.type != "cuda"):
        raise AssertionError(f"decode_batch gave {tuple(out.shape)} "
                             f"{out.dtype} on {out.device}")
    if min(launches[k] for k in PATH_420) < 1:
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    plain = jk.decode_batch_420(coeffs_p, yq, cq, shapes, "rgba",
                                "bt601", hw=(H, W))
    if not torch.equal(out, plain):
        raise AssertionError("decode_batch differs from the plain route, by "
                             f"up to {max_abs_err(out, plain)}")
    psnr = []
    for k in range(2):
        src = torch.from_numpy(testing.synth_rgb(H, W, k + 1)).to(dev)
        mse = (out[k, ..., :3].double() - src.double()).pow(2).mean().item()
        psnr.append(round(float(10 * np.log10(255 ** 2 / mse)), 2))
    if min(psnr) < 30 or not torch.all(out[..., 3] == 255):
        raise AssertionError(f"decoded pixels do not match their source: "
                             f"PSNR {psnr} dB")
    small = [testing.synth_jpeg_420(160, 224, q, 7 + q) for q in (50, 75, 95)]
    if not torch.equal(decode_batch(small, device="cuda").cpu(),
                       decode_batch(small, device="cpu")):
        raise AssertionError("small batch: CUDA differs from the CPU route")
    log("main path", shape=tuple(out.shape), launches=launches,
        plain_route="exact", psnr_db=psnr, small_cpu_vs_cuda="exact")
    sized = decode_batch(srcs, size=(224, 224), device="cuda")
    want = torch.stack([resize_rgba(p, (224, 224)) for p in plain])
    if tuple(sized.shape) != (N, 224, 224, 4) or not torch.equal(sized, want):
        raise AssertionError("size=(224, 224) differs from the plain route")
    log("main path size=(224,224)", shape=tuple(sized.shape),
        plain_route="exact")

    # --- timing -----------------------------------------------------------
    # each kernel at the main path's shapes: warm, and with L2 flushed;
    # its bound from the bytes it must move and the ops it must do
    flush = torch.empty(100 * 2 ** 20, dtype=torch.uint8, device=dev)
    entries = int((cuda_jpeg.unpack_entry_ranges(starts, counts, e)
                   .diff(dim=-1)).sum())
    ng, nb_all = N * g, N * nblocks
    npx, nch = N * H * W, N * ((H + 1) // 2) * ((W + 1) // 2)
    # ops are the work of each kernel's function, whatever implements
    # it: K2 is charged the direct 8x8 product, (64 + 2*1024) per block,
    # though its even/odd passes do less; a multiply-add is 2 ops
    work = {    # name: (kernel, plain, bytes, ops, type of the ops)
        "count_scan": (lambda: cuda_jpeg.count_scan(buf, N, g),
                       lambda: jk.count_starts(counts), 5 * ng, ng,
                       "int32"),
        "unpack": (lambda: cuda_jpeg.unpack(buf, starts, bmap, N, g, e,
                                            nblocks),
                   lambda: jk.unpack_coeffs(counts, ks, vals, bmap, nblocks),
                   5 * ng + 4 * g + 3 * entries + 128 * nb_all, entries,
                   "int32"),
        "dequant_idct": (lambda: cuda_jpeg.dequant_idct(coeffs, yq, cq,
                                                        nby * nbx),
                         lambda: jk.dequant_idct_blocks(coeffs, yq, cq,
                                                        nby * nbx),
                         256 * nb_all + 512 * N, (64 + 2 * 1024) * nb_all,
                         "int32"),
        "assemble_color": (lambda: cuda_jpeg.assemble_color(
            samples, nby, nbx, "rgba", "bt601", (H, W)),
            lambda: jk.assemble_color(samples, shapes, "rgba", "bt601",
                                      (H, W)),
            2 * npx + 4 * nch + 4 * npx, 13 * npx, "f32"),
    }
    rates = {"int32": INT32_OPS_PER_S, "f32": F32_OPS_PER_S}
    library = {"count_scan": lambda: torch.cumsum(counts, dim=1,
                                                  dtype=torch.int32)}
    # the launch floor: the fastest launch the card takes in the same
    # loop, the least any kernel here can read
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    floors = {"sleep1": gpu_ms(lambda: torch.cuda._sleep(1), 50),
              "add1": gpu_ms(lambda: one.add_(1), 50)}
    floor_ms = min(floors.values())
    log("time launch floor", ms=f"{floor_ms:.4f}",
        **{k: f"{v:.4f}" for k, v in floors.items()})
    # what the card's memory gives a plain stream: a device copy of the
    # main path's coefficients, the bytes K2 moves
    copy_dst = torch.empty_like(coeffs)

    def copy():
        copy_dst.copy_(coeffs)

    log("time copy yardstick", bytes=4 * coeffs.numel(),
        ms=f"{gpu_ms(copy, 50):.4f}",
        ms_cold=f"{gpu_ms_cold(copy, 20, flush):.4f}")
    del copy_dst
    timed = {}
    for name, (kern, pl, nbytes, ops, ops_type) in work.items():
        rate = rates[ops_type]
        b_ms, b_by = bound(nbytes, ops, rate)
        timed[name] = {
            "ms": gpu_ms(kern, 50), "ms_cold": gpu_ms_cold(kern, 20, flush),
            "plain_ms": gpu_ms(pl, 5 if name != "count_scan" else 20),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": (gpu_ms(library[name], 50) if name in library
                           else None),
            "launch_floor_ms": floor_ms,
            "ops_type": ops_type,
            "bytes": nbytes, "ops": ops}
        t = timed[name]
        t["share"] = b_ms / t["ms"]
        t["share_cold"] = b_ms / t["ms_cold"]
        log("time kernel", name=name, ms=f"{t['ms']:.4f}",
            ms_cold=f"{t['ms_cold']:.4f}", plain_ms=f"{t['plain_ms']:.4f}",
            bound_ms=f"{b_ms:.4f}", bound_by=b_by,
            ops_ms=f"{ops / rate * 1e3:.4f}", ops_type=ops_type,
            share_warm=f"{t['share']:.3f}",
            share_cold=f"{t['share_cold']:.3f}", bytes=nbytes,
            launch_floor_ms=f"{floor_ms:.4f}",
            library_ms=("null" if t["library_ms"] is None
                        else f"{t['library_ms']:.4f}"))
    del flush
    dev_ms = gpu_ms(lambda: jk.decode_batch_420_packed_fused(
        buf, bmap, yq, cq, N, g, e, shapes, "rgba", "bt601", (H, W)), 20)
    plain_dev_ms = gpu_ms(lambda: jk.decode_batch_420(
        jk.unpack_coeffs(counts, ks, vals, bmap, nblocks), yq, cq, shapes,
        "rgba", "bt601", (H, W)), 3)
    resize_ms = gpu_ms(lambda: torch.stack(
        [resize_rgba(p, (224, 224)) for p in out]), 10)
    # resize as ops/resize.py runs it: uint8 in and out once, and the
    # f32 products of the two dense weight matrices (1080->224 over
    # rows, then 1920->224 over columns), 2 ops a multiply-add
    resize_bound = bound(
        4 * N * (H * W + 224 * 224),
        2 * 4 * N * (W * H * 224 + 224 * W * 224), F32_OPS_PER_S)
    mp = N * H * W / 1e6
    trace.reset()
    trace.enable()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        decode_batch(srcs, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    trace.enable(False)
    stages = {k: round(v["mean"] * 1e3, 3) for k, v in trace.report().items()}
    wall = sorted(walls)[len(walls) // 2]
    log("time path", megapixels=mp, device_ms=f"{dev_ms:.4f}",
        device_busy_share=f"{dev_ms / (wall * 1e3):.4f}",
        device_pipeline_mps=f"{mp / dev_ms * 1e3:.1f}",
        plain_device_ms=f"{plain_dev_ms:.4f}",
        resize_224_ms=f"{resize_ms:.4f}",
        resize_224_bound_ms=f"{resize_bound[0]:.4f}",
        resize_224_bound_by=resize_bound[1],
        end_to_end_ms=f"{wall * 1e3:.3f}",
        end_to_end_ms_runs=json.dumps([round(w * 1e3, 3) for w in walls]).replace(" ", ""),
        jpeg_1080p_420_decode_end_to_end_mps=f"{mp / wall:.2f}",
        host_entropy_packed_mps=f"{mp / (stages['torch.host_parse'] / 1e3):.2f}",
        stage_ms=json.dumps(stages).replace(" ", ""))

    codec_timed, path_launches = codec_paths(dev, jpegs, floor_ms, errs)

    # the instances the paths run: bt601, rgba (and fancy for K4)
    built = {"assemble_color": "assemble_color<1,0>",
             "assemble_mcu": "assemble_mcu<1,0,1>"}
    # each kernel's launches on the path it serves: decode_batch for
    # K1a-K3, load for K4, encode for K5; K2's on load beside them
    launches["assemble_mcu"] = path_launches["load"]["assemble_mcu"]
    launches["fdct"] = path_launches["encode"]["fdct"]
    timed["dequant_idct"]["at_load_12mp"] = codec_timed.pop("dequant_idct")
    timed["dequant_idct"]["at_load_12mp"]["launches"] = \
        path_launches["load"]["dequant_idct"]
    timed.update(codec_timed)
    kernels = [{"name": name, "route": "cuda",
                "source": SOURCES.get(name, CU),
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": errs[name], **timed[name],
                "ptxas": ptxas[built.get(name, name)]}
               for name in REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
