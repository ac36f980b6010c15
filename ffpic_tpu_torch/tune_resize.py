"""Time K16's band kernel (``resize_band``, cubic and Lanczos) at several
of its constants on one NVIDIA GPU.

    python3 -m ffpic_tpu_torch.tune_resize

Builds ``csrc/resize.cu`` once per variant of the band kernel's constants
(``kBandRows``, the most output rows a CTA; ``kBandThreads``, threads a
CTA; ``kPrefetch``, pass 1's steps of input rows prefetched into L2),
each a copy of the source with those
constants replaced, all nvcc runs started together, into
``build/tune/``, and launches each build through the wrappers of
``ops.cuda_resize``.  Each variant resizes config 5's 8 slots of 1080 x
1920 RGBA to 224 x 224 by bicubic, lanczos3 and lanczos5 in one launch,
each pass alone over the 8 slots (to 224 x 1920 and to 1080 x 224) by
bicubic and lanczos5, and lanczos5's passes alone on one slot; each
output is checked bit for bit against the plain version, then all are
timed in turns (each variant, then the same in reverse order), warm and
with L2 flushed.  Prints each variant's registers and spills, one line
per variant and case, and the card's name and power limit.  Needs CUDA
and nvcc.
"""

from __future__ import annotations

import os
import subprocess

import numpy as np
import torch

from ffpic_tpu_torch.ops import _build, cuda_resize
from ffpic_tpu_torch.ops import resize as rs
from ffpic_tpu_torch.utils.timing import gpu_ms, gpu_ms_cold

# (kBandRows, kBandThreads, kPrefetch); the first is the source's
VARIANTS = ((7, 512, 2), (7, 512, 0), (7, 512, 4), (7, 384, 2), (7, 256, 2),
            (6, 512, 2), (5, 512, 2))
CONSTANTS = ("kBandRows", "kBandThreads", "kPrefetch")
METHODS = ("bicubic", "lanczos3", "lanczos5")


def _build_variants(out: str) -> dict:
    """{variant: the library built from the source with its constants}."""
    built = _build.build_variants("resize.cu", CONSTANTS, VARIANTS, out)
    for v, (_, log) in built.items():
        lines = log.splitlines()
        for at, ln in enumerate(lines):
            if "Compiling" in ln and "resize_band_kernel" in ln:
                print(f"[band ptxas] variant={v} " + " | ".join(
                    x.split(":", 1)[-1].strip() for x in lines[at + 1:at + 4]
                    if "stack" in x or "registers" in x))
    return {v: lib for v, (lib, _) in built.items()}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("tune_resize: CUDA is not available")
    out = os.path.join(_build.BUILD, "tune")
    os.makedirs(out, exist_ok=True)
    libs = _build_variants(out)
    dev = torch.device("cuda")
    rng = np.random.default_rng(16)
    slots = [torch.from_numpy(rng.integers(0, 256, (1080, 1920, 4),
                                           dtype=np.uint8)).to(dev)
             for _ in range(8)]
    cases = {f"{m} 8 slots": (slots, (224, 224), m) for m in METHODS}
    for m in ("bicubic", "lanczos5"):
        cases[f"{m} pass 1 8 slots"] = (slots, (224, 1920), m)
        cases[f"{m} pass 2 8 slots"] = (slots, (1080, 224), m)
    cases["lanczos5 pass 1 one slot"] = (slots[:1], (224, 1920), "lanczos5")
    cases["lanczos5 pass 2 one slot"] = (slots[:1], (1080, 224), "lanczos5")
    wants = {name: rs.resize_batch_plain(s, size, m)
             for name, (s, size, m) in cases.items()}
    rows, exact = {}, {}
    for v in VARIANTS:
        with _build.launching_from(cuda_resize, libs[v]):
            for name, (s, size, m) in cases.items():
                got = cuda_resize.resize_batch(s, size, m)
                torch.cuda.synchronize()
                exact[v] = exact.get(v, True) and torch.equal(got,
                                                              wants[name])
                rows[v, name] = (cuda_resize.instance["resize_rgba"],
                                 cuda_resize.instance["rows"])
    flush = torch.empty(100 * 2 ** 20, dtype=torch.uint8, device=dev)
    times = {v: {name: [] for name in cases} for v in VARIANTS}
    for v in list(VARIANTS) + list(VARIANTS)[::-1]:
        with _build.launching_from(cuda_resize, libs[v]):
            for name, (s, size, m) in cases.items():
                def run(s=s, size=size, m=m):
                    return cuda_resize.resize_batch(s, size, m)
                times[v][name].append((gpu_ms(run, 20),
                                       gpu_ms_cold(run, 10, flush)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    for v, per_case in times.items():
        for name, t in per_case.items():
            warm, cold = np.array(t).T
            kernel, r = rows[v, name]
            print("[band variant] " + " ".join(
                f"{n}={x}" for n, x in zip(CONSTANTS, v)) +
                f" case={name.replace(' ', '_')} "
                f"exact={'yes' if exact[v] else 'NO'} kernel={kernel} "
                f"rows_cta={r} "
                f"ms_warm={','.join(f'{x:.4f}' for x in warm)} "
                f"ms_cold={','.join(f'{x:.4f}' for x in cold)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
