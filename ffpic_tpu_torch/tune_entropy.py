"""Time K9 ``entropy_decode`` and K10 ``spec_scan`` at several fast-table
widths and CTA widths on one NVIDIA GPU.

    python3 -m ffpic_tpu_torch.tune_entropy

Builds ``csrc/jpeg_entropy.cu`` once per (fast-table bits, K10 chunks a
CTA) pair, with ``-DFFPIC_FAST_BITS`` and ``-DFFPIC_SPEC_LANES``, all
nvcc runs started together, into ``build/tune/``, and launches each
build through the wrappers of ``ops.cuda_entropy``.  K9 runs the 8 x
1080p DRI batch (q85/q95, a restart marker every MCU row, as
``chip_smoke.py`` makes it) with fast tables of each build's width and
CTA plans of at most 8, 4, 2 and 1 lanes (``jpeg_entropy_device.
cta_plan``); K10 the same pixels without restart markers in 4 KB
chunks.  Every variant is checked bit for bit against the plain
versions (``decode_lanes_plain``, ``spec_scan_plain``), then all are
timed in turns (each variant, then the same in reverse order), warm and
with L2 flushed.  Prints one line per variant, with ns a symbol on the
longest lane, and the card's name and power limit.  Needs CUDA and
nvcc.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ffpic_tpu_torch import testing
from ffpic_tpu_torch.formats import jpg
from ffpic_tpu_torch.ops import _build, cuda_entropy
from ffpic_tpu_torch.ops import jpeg_entropy_device as jed
from ffpic_tpu_torch.utils.timing import gpu_ms, gpu_ms_cold

BITS = (10, 11, 12)
SPEC_LANES = (16, 8, 4)
K9_SPEC_LANES = 8      # K9 does not depend on it: one build a width
PLAN_LANES = (8, 4, 2, 1)
MACROS = ("FFPIC_FAST_BITS", "FFPIC_SPEC_LANES")
H, W, N = 1080, 1920, 8


def _build_variants(out: str) -> dict:
    """{(bits, spec lanes): the library built with those macros}."""
    cu = os.path.join(_build.CSRC, "jpeg_entropy.cu")
    with open(cu) as f:
        src = f.read()
    for macro in MACROS:
        if f"#ifndef {macro}" not in src:
            raise RuntimeError(f"jpeg_entropy.cu no longer reads {macro}: "
                               "the variants would all be one kernel")
    keys = [(b, s) for b in BITS for s in SPEC_LANES]
    sos = {k: os.path.join(out, "entropy_%d_%d.so" % k) for k in keys}
    with ThreadPoolExecutor(len(keys)) as ex:
        list(ex.map(lambda k: _build.compile_library(
            [cu], sos[k], extra=[f"-D{MACROS[0]}={k[0]}",
                                 f"-D{MACROS[1]}={k[1]}"]), keys))
    return {k: ctypes.CDLL(sos[k]) for k in keys}


@contextlib.contextmanager
def _library(lib):
    """``cuda_entropy``'s wrappers launch from ``lib`` meanwhile."""
    counts = dict(cuda_entropy.launches)
    saved = cuda_entropy._launch
    cuda_entropy._launch = _build.launcher(cuda_entropy._SIGNATURES, counts,
                                           library=lambda: lib)
    try:
        yield
    finally:
        cuda_entropy._launch = saved


def _spec_walks(st, chunks) -> np.ndarray:
    """Each chunk's symbol count from its first bit to its exit boundary,
    replayed with the plain step on the card."""
    tabs = jed._spec_tables(st.u32win, st.luts, st.comp_of_sub,
                            st.tclass_of_sub)
    bit, end = chunks[:, 0].to(torch.int64), chunks[:, 1].to(torch.int64)
    k, sub, blk = (torch.zeros_like(bit) for _ in range(3))
    dcs = torch.zeros((bit.shape[0], 3), dtype=torch.int64, device=bit.device)
    steps = torch.zeros_like(bit)
    while bool((bit < end).any()):
        active = bit < end
        bit, k, sub, blk, dcs = jed._advance(tabs, st.bpm, active, bit, k,
                                             sub, blk, dcs)
        steps += active
    return steps.cpu().numpy()


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("tune_entropy: CUDA is not available")
    out = os.path.join(_build.BUILD, "tune")
    os.makedirs(out, exist_ok=True)
    libs = _build_variants(out)
    dev = torch.device("cuda")
    rgb = [testing.synth_rgb(H, W, k + 1) for k in range(2)]
    dri = [testing.encode_jpeg(rgb[k], q, restart_interval=W // 16)
           for k, q in ((0, 85), (1, 95))]
    plain = [testing.encode_jpeg(rgb[k], q) for k, q in ((0, 85), (1, 95))]
    datas = [dri[k % 2] for k in range(N)]
    js = [jpg.parse_and_decode(d, skip_decode=True)[0] for d in datas]
    st, lanes, _plan, out_size, _off = jed.stage_dri(datas, js, dev)
    lut_idx = lanes[:, 4].cpu().numpy()
    rs = jed.spec_stages([plain[k % 2] for k in range(N)], 4096, device=dev)
    ss, chunks = rs["staged"], rs["chunks"]
    want9 = jed.decode_lanes_plain(st, lanes, out_size)
    want10 = jed.spec_scan_plain(ss, chunks)
    longest9 = int(want9[1].max())
    longest10 = int(_spec_walks(ss, chunks).max())

    def fast_of(staged, bits):
        luts = staged.luts.cpu().numpy().view(np.uint32)
        return torch.from_numpy(jed.fast_tables(luts, bits).view(np.int32)) \
            .to(dev)

    fast = {b: fast_of(st, b) for b in BITS}
    sfast = {b: fast_of(ss, b) for b in BITS}
    plans = {m: torch.from_numpy(jed.cta_plan(lut_idx, m)).to(dev)
             for m in PLAN_LANES}

    def k9(bits, plan_lanes):
        def run():
            return cuda_entropy.entropy_decode(
                st.data, st.n, st.luts, fast[bits], st.zz, st.comp_of_sub,
                st.tclass_of_sub, st.bmap, lanes, plans[plan_lanes], st.bpm,
                out_size, jed.MAX_STEPS)
        return (bits, K9_SPEC_LANES), run, want9

    def k10(bits, spec_lanes):
        def run():
            return cuda_entropy.spec_scan(
                ss.data, ss.n, ss.luts, sfast[bits], ss.comp_of_sub,
                ss.tclass_of_sub, chunks, ss.bpm, jed.MAX_STEPS)
        return (bits, spec_lanes), run, want10

    runs = {}
    for bits in BITS:
        for m in PLAN_LANES:
            runs[("K9", bits, m)] = k9(bits, m)
        for s in SPEC_LANES:
            runs[("K10", bits, s)] = k10(bits, s)
    for key, (lib_key, run, want) in runs.items():
        with _library(libs[lib_key]):
            got = run()
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{key} differs from the plain version")
    flush = torch.empty(100 * 2 ** 20, dtype=torch.uint8, device=dev)
    times = {key: [] for key in runs}
    for key in list(runs) + list(runs)[::-1]:
        lib_key, run, _want = runs[key]
        with _library(libs[lib_key]):
            times[key].append((gpu_ms(run, 10), gpu_ms_cold(run, 5, flush)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    print(f"[entropy inputs] k9_lanes={lanes.shape[0]} "
          f"k9_longest_lane_symbols={longest9} k10_chunks={chunks.shape[0]} "
          f"k10_longest_chunk_symbols={longest10}")
    for (kernel, bits, width), t in times.items():
        warm, cold = np.array(t).T
        longest = longest9 if kernel == "K9" else longest10
        print(f"[entropy variant] kernel={kernel} fast_bits={bits} "
              f"lanes_per_cta={width} exact=yes "
              f"ms_warm={','.join(f'{x:.4f}' for x in warm)} "
              f"ms_cold={','.join(f'{x:.4f}' for x in cold)} "
              f"ns_per_symbol={warm.mean() * 1e6 / longest:.1f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
