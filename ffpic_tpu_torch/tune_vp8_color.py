"""Time K13 ``vp8_yuv_to_rgba`` at several tilings on one NVIDIA GPU.

    python3 -m ffpic_tpu_torch.tune_vp8_color

Builds ``csrc/vp8_decode.cu`` once per variant of K13's constants
``kTileRows`` (output rows a CTA), ``kTileCols`` (output pixels a row)
and ``kMinCtas`` (the CTAs an SM that ``__launch_bounds__`` asks
registers for), each a copy of the source with those constants
replaced, all nvcc runs started together,
into ``build/tune/``, and launches each build through the wrappers of
``ops.cuda_vp8``.  Each variant colours the webp batch's 8 frames (the
1080p lossy and alpha fixtures' planes, 4 of each, staged as
``decode_batch`` stages them) in one launch, one 1080p frame, one
1081 x 1919 frame (every RGBA row off 16 bytes), one 1080 x 1918 frame
whose planes lie 3 bytes into their rows and one 4096 x 4096 frame;
each output is checked bit for bit against the plain version, then all
are timed in turns (each variant, then the same in reverse order),
warm and with L2 flushed.  Prints each variant's registers and spills,
one line per variant and case, and the card's name and power limit.
Needs CUDA and nvcc.
"""

from __future__ import annotations

import os
import subprocess

import numpy as np
import torch

from ffpic_tpu_torch import testing
from ffpic_tpu_torch.formats import webp
from ffpic_tpu_torch.ops import _build, cuda_vp8
from ffpic_tpu_torch.ops import vp8_kernels as vk
from ffpic_tpu_torch.utils.timing import gpu_ms, gpu_ms_cold

# (kTileRows, kTileCols, kMinCtas); the first is the source's
VARIANTS = ((32, 128, 8), (32, 128, 1), (32, 128, 6), (16, 128, 8),
            (64, 128, 6), (32, 256, 8), (64, 64, 8))
CONSTANTS = ("kTileRows", "kTileCols", "kMinCtas")


def _build_variants(out: str) -> dict:
    """{variant: the library built from the source with its constants}."""
    built = _build.build_variants("vp8_decode.cu", CONSTANTS, VARIANTS, out)
    for v, (_, log) in built.items():
        # ptxas's lines for K13: the entry, its stack and spills, registers
        lines = log.splitlines()
        at = next(k for k, ln in enumerate(lines)
                  if "vp8_yuv_to_rgba_kernel" in ln)
        print(f"[k13 ptxas] variant={v} " + " | ".join(
            ln.split(":", 1)[-1].strip() for ln in lines[at + 2:at + 4]))
    return {v: lib for v, (lib, _) in built.items()}


def _frame(rng, h: int, w: int, dev) -> tuple:
    """An h x w frame of random MB-padded planes on the card."""
    ph, pw = -(-h // 16) * 16, -(-w // 16) * 16
    return (*[torch.from_numpy(rng.integers(0, 256, s, dtype=np.uint8))
              .to(dev) for s in ((ph, pw), (ph // 2, pw // 2),
                                 (ph // 2, pw // 2))], h, w, None)


def _pitched(frame) -> tuple:
    """``frame``'s planes as views 3 bytes into wider rows."""
    views = []
    for p in frame[:3]:
        wide = torch.zeros((p.shape[0], p.shape[1] + 16), dtype=torch.uint8,
                           device=p.device)
        wide[:, 3:3 + p.shape[1]] = p
        views.append(wide[:, 3:3 + p.shape[1]])
    return (*views, *frame[3:])


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("tune_vp8_color: CUDA is not available")
    out = os.path.join(_build.BUILD, "tune")
    os.makedirs(out, exist_ok=True)
    libs = _build_variants(out)
    dev = torch.device("cuda")
    os.environ["FFPIC_VP8_DEVICE_COLOR"] = "1"
    fs = [webp.parse(testing.webp_fixture(n), device=dev)
          for n in ("lossy_1080p.webp", "alpha_1080p.webp")] * 4
    rng = np.random.default_rng(17)
    cases = {"webp batch 8": webp.stage_planes(fs, dev),
             "1080p": [_frame(rng, 1080, 1920, dev)],
             "odd 1081x1919": [_frame(rng, 1081, 1919, dev)],
             "unaligned 1080x1918": [_pitched(_frame(rng, 1080, 1918,
                                                     dev))],
             "4096x4096": [_frame(rng, 4096, 4096, dev)]}
    wants = {k: vk.vp8_yuv_to_rgba_batch_plain(f) for k, f in cases.items()}
    outs = {k: vk.batch_outputs(f)[0] for k, f in cases.items()}
    for v in VARIANTS:
        with _build.launching_from(cuda_vp8, libs[v]):
            for k, frames in cases.items():
                got = cuda_vp8.vp8_yuv_to_rgba_batch(frames, outs[k])
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(got, wants[k])):
                    raise AssertionError(f"K13 {v} on {k} differs from the "
                                         "plain version")
    flush = torch.empty(100 * 2 ** 20, dtype=torch.uint8, device=dev)
    times = {v: {k: [] for k in cases} for v in VARIANTS}
    for v in list(VARIANTS) + list(VARIANTS)[::-1]:
        with _build.launching_from(cuda_vp8, libs[v]):
            for k, frames in cases.items():
                def run(frames=frames, o=outs[k]):
                    return cuda_vp8.vp8_yuv_to_rgba_batch(frames, o)
                times[v][k].append((gpu_ms(run, 30), gpu_ms_cold(run, 10,
                                                                  flush)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    for (rows, cols, ctas), per_case in times.items():
        for k, t in per_case.items():
            warm, cold = np.array(t).T
            print(f"[k13 variant] rows={rows} cols={cols} ctas={ctas} "
                  f"case={k.replace(' ', '_')} exact=yes "
                  f"ms_warm={','.join(f'{x:.4f}' for x in warm)} "
                  f"ms_cold={','.join(f'{x:.4f}' for x in cold)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
