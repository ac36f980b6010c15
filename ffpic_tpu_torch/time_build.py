"""Time the build of the CUDA kernel library two ways on one machine.

    python3 -m ffpic_tpu_torch.time_build [--rounds 2]

``parallel`` is what ``ops._build`` does: one nvcc per ``.cu`` under
``csrc/``, all started together, then one link.  ``single`` is one
nvcc over all the files, which compiles them one after another.  Each
round builds single, parallel, parallel, single into a fresh temporary
directory under ``build/`` and checks that each library loads.  Prints
each build's wall time, the machine's CPU count and, where
``nvidia-smi`` answers, the card's name and power limit, then one JSON
line with the medians.  Needs nvcc, not a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import tempfile
import time

from ffpic_tpu_torch.ops import _build


def _single(cus: list[str], out: str) -> None:
    _build._run([_build._nvcc(), *_build.FLAGS, "-shared", "-o", out, *cus])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    cus = [s for s in _build.sources() if s.endswith(".cu")]
    builds = {"single": _single, "parallel": _build.compile_library}
    times: dict[str, list[float]] = {k: [] for k in builds}
    os.makedirs(_build.BUILD, exist_ok=True)
    for _ in range(args.rounds):
        for name in ("single", "parallel", "parallel", "single"):
            with tempfile.TemporaryDirectory(dir=_build.BUILD) as d:
                out = os.path.join(d, "lib.so")
                t0 = time.perf_counter()
                builds[name](cus, out)
                dt = time.perf_counter() - t0
                ctypes.CDLL(out)
            times[name].append(dt)
            print(f"{name}: {dt:.3f} s", flush=True)
    if shutil.which("nvidia-smi"):
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip())
    print(json.dumps({"sources": [os.path.basename(c) for c in cus],
                      "cpus": os.cpu_count(),
                      **{f"{k}_s": v for k, v in times.items()},
                      **{f"{k}_median_s": statistics.median(v)
                         for k, v in times.items()}}))


if __name__ == "__main__":
    main()
