"""Time the K1b ``unpack`` kernel at several tilings on one NVIDIA GPU.

    python3 -m ffpic_tpu_torch.tune_unpack_tile

Builds one copy of ``csrc/jpeg_decode.cu`` per (packed blocks a CTA,
threads a CTA) pair -- kUnpackTile and kUnpackThreads substituted, all
nvcc runs started together -- into ``build/tune/``, checks each copy's
``unpack`` bit for bit against the plain version on the main path's
8 x 1080p packed batch, then times them in turns (each tiling, then the
same in reverse order), warm and with L2 flushed.  Prints one line per
tiling and the card's name and power limit.  Needs CUDA and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np
import torch

from ffpic_tpu_torch import testing
from ffpic_tpu_torch.formats.jpg import packed_block_map
from ffpic_tpu_torch.ops import _build, cuda_jpeg
from ffpic_tpu_torch.ops import jpeg_kernels as jk
from ffpic_tpu_torch.pipeline import _prep
from ffpic_tpu_torch.utils.timing import gpu_ms, gpu_ms_cold

TILINGS = ((64, 256), (32, 128), (128, 256), (128, 512))
H, W, N = 1080, 1920, 8


def _build_tilings(out: str) -> dict:
    with open(os.path.join(_build.CSRC, "jpeg_decode.cu")) as f:
        src = f.read()
    procs = {}
    for tile, threads in TILINGS:
        s = src.replace("constexpr int kUnpackTile = 64;",
                        f"constexpr int kUnpackTile = {tile};")
        s = s.replace("constexpr int kUnpackThreads = 256;",
                      f"constexpr int kUnpackThreads = {threads};")
        cu = os.path.join(out, f"unpack_{tile}x{threads}.cu")
        with open(cu, "w") as f:
            f.write(s)
        procs[(tile, threads)] = subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, "-shared", "-I", _build.CSRC,
             "-o", cu[:-3] + ".so", cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for key, p in procs.items():
        log = p.communicate(timeout=600)[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for tiling {key}:\n{log}")
        fn = ctypes.CDLL(os.path.join(out, "unpack_%dx%d.so" % key)).ffpic_unpack
        fn.argtypes = cuda_jpeg._SIGNATURES["ffpic_unpack"]
        fn.restype = ctypes.c_int
        fns[key] = fn
    return fns


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("tune_unpack_tile: CUDA is not available")
    out = os.path.join(_build.BUILD, "tune")
    os.makedirs(out, exist_ok=True)
    fns = _build_tilings(out)
    dev = torch.device("cuda")
    jpegs = [testing.synth_jpeg_420(H, W, 85, 1),
             testing.synth_jpeg_420(H, W, 95, 2)]
    plans = [_prep(jpegs[k % 2])[0] for k in range(N)]
    nblocks = sum(c.nby * c.nbx for c in plans[0].comps)
    buf_np, g, e = jk.stack_packed_fused([j.packed for j in plans])
    buf = torch.from_numpy(buf_np).to(dev)
    bmap = packed_block_map(plans[0], dev)
    counts, ks, vals = jk.split_packed(buf, N, g, e)
    starts = jk.count_starts(counts)
    want = jk.unpack_coeffs(counts, ks, vals, bmap, nblocks)
    res = torch.empty_like(want)
    flush = torch.empty(100 * 2 ** 20, dtype=torch.uint8, device=dev)

    def launcher(key):
        def run():
            rc = fns[key](buf.data_ptr(), starts.data_ptr(), bmap.data_ptr(),
                          res.data_ptr(), N, g, e, nblocks, key[0],
                          torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"tiling {key}: launch error {rc}")
        return run

    times = {key: [] for key in fns}
    for key in fns:
        launcher(key)()
        torch.cuda.synchronize()
        if not torch.equal(res, want):
            raise AssertionError(f"tiling {key} differs from the plain version")
    for key in list(fns) + list(fns)[::-1]:
        run = launcher(key)
        times[key].append((gpu_ms(run, 50), gpu_ms_cold(run, 20, flush)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    for (tile, threads), t in times.items():
        warm, cold = np.array(t).T
        print(f"[unpack tiling] blocks_per_cta={tile} threads={threads} "
              f"exact=yes ms_warm={','.join(f'{x:.4f}' for x in warm)} "
              f"ms_cold={','.join(f'{x:.4f}' for x in cold)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
