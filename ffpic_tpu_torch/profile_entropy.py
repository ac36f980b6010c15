"""Where the host time of ``decode_batch``'s device-entropy route goes,
on one CUDA card.

    python3 -m ffpic_tpu_torch.profile_entropy [--runs 7]

Makes ``chip_smoke.py``'s dri batch (8 x 1920x1080 baseline 4:2:0,
q85 and q95 in turn, ``testing.encode_jpeg`` with a restart marker
every MCU row), then times ``decode_batch`` of it three ways, one run
of each in turn so that the host's drift falls on all alike: every
member on the card (``FFPIC_HYBRID=0``), the default hybrid split, and
the host route (``FFPIC_DEVICE_ENTROPY=0``).  Prints for each the
host-clock walls to a synchronised card and the mean host spans
(``utils.trace``); then, for each, one run under ``torch.profiler``:
the host calls that took the most time of their own (the CUDA runtime
calls among them), and the host's CPU count.  Last, one JSON line with
the medians.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import torch

from ffpic_tpu_torch import decode_batch, testing
from ffpic_tpu_torch.utils import trace

WAYS = {"all_device": {"FFPIC_HYBRID": "0"}, "hybrid": {},
        "host": {"FFPIC_DEVICE_ENTROPY": "0"}}
SWITCHES = ("FFPIC_DEVICE_ENTROPY", "FFPIC_SPEC_ENTROPY", "FFPIC_HYBRID",
            "FFPIC_HYBRID_FRAC")


def _environ(env: dict) -> None:
    for k in SWITCHES:
        os.environ.pop(k, None)
    os.environ.update(env)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=7)
    args = ap.parse_args()
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=False)
    print(r.stdout.strip(), f"cpus={os.cpu_count()}",
          f"affinity={len(os.sched_getaffinity(0))}", flush=True)
    dri = [testing.encode_jpeg(testing.synth_rgb(1080, 1920, k + 1), q,
                               restart_interval=120)
           for k, q in ((0, 85), (1, 95))]
    srcs = [dri[k % 2] for k in range(8)]
    for env in WAYS.values():                       # build, warm up
        _environ(env)
        decode_batch(srcs)
    torch.cuda.synchronize()
    walls = {w: [] for w in WAYS}
    spans = {w: {} for w in WAYS}
    for _ in range(args.runs):
        for way, env in WAYS.items():
            _environ(env)
            trace.reset()
            trace.enable()
            t0 = time.perf_counter()
            decode_batch(srcs)
            torch.cuda.synchronize()
            walls[way].append((time.perf_counter() - t0) * 1e3)
            trace.enable(False)
            for k, v in trace.report().items():
                spans[way].setdefault(k, []).append(v["total"] * 1e3)
    mp = 8 * 1080 * 1920 / 1e6
    medians = {}
    for way in WAYS:
        med = statistics.median(walls[way])
        medians[way] = med
        print(f"[wall] way={way} median_ms={med:.3f} mps={mp / med * 1e3:.2f}"
              f" runs={json.dumps([round(w, 3) for w in walls[way]])}"
              f" spans_ms={json.dumps({k: round(statistics.mean(v), 3) for k, v in spans[way].items()}, separators=(',', ':'))}",
              flush=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for way, env in WAYS.items():
        _environ(env)
        with torch.profiler.profile(activities=acts) as prof:
            decode_batch(srcs)
            torch.cuda.synchronize()
        rows = sorted(prof.key_averages(),
                      key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
        print(f"[profile] way={way} top_self_cpu_ms=" + json.dumps(
            {e.key: [round(e.self_cpu_time_total / 1e3, 3), e.count]
             for e in rows}, separators=(",", ":")), flush=True)
    print(json.dumps({"median_ms": medians, "runs": args.runs}))


if __name__ == "__main__":
    main()
