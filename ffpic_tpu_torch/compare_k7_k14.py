"""Time K7 ``assemble_rgba`` and K14 ``hevc_residuals`` of this tree beside
those of an older checkout, on one NVIDIA GPU.

    python3 -m ffpic_tpu_torch.compare_k7_k14 --parent DIR [--rounds 1]
    python3 -m ffpic_tpu_torch.compare_k7_k14 --tree DIR    # one run

``DIR`` holds an older checkout of the repository, e.g. the parent
commit unpacked from ``git archive`` into a directory that
``.gitignore`` lists.  Each round runs this file on the older tree,
this tree, this tree and the older tree in turn, each in a fresh process
that imports that tree's package alone and builds its kernels (nvcc,
into that tree's ``ffpic_tpu_torch/build/``).  A run makes the same
inputs from a seed and, after checking each kernel's output against its
plain version, times:

* K7 for every (colour type, bit depth) at 1920x1080, its rows
  contiguous and at a pitch of the stride + 1 bytes, warm and with L2
  flushed; a device copy of the 8-bit RGBA rows (K7's function there)
  beside it;
* K14 over the 12 MP HEIF fixture's 48 tiles: a launch a tile (48 in a
  row, each tile staged alone) and one launch over all of them;
* ``load`` of the fixture by the host route and under
  ``FFPIC_HEVC_DEVICE`` (median of 5, host clock, with the
  ``hevc.residuals_device`` span).

Each run prints one ``RESULT`` JSON line; the rounds end with a table of
each number's median per tree, and the card's name and power limit.
Needs CUDA and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

H, W = 1080, 1920
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _k14_launch(hk, cuda_hevc, parts, bd, dev):
    """A launch of ``parts`` ((tu_meta, levels) of one or more tiles) as
    the tree stages it: the one-launch plan (``residuals_grid``'s tree),
    or the plan before it, which took one picture's arrays."""
    import numpy as np
    import torch
    meta = np.concatenate([m for m, _ in parts])
    if hasattr(hk, "residuals_grid"):
        lv_d, plan, _ = hk.stage_residuals(parts, dev)
        return (lambda: cuda_hevc.hevc_residuals(lv_d, bd, *plan)), \
            torch.from_numpy(meta).to(dev), lv_d
    m_d, lv_d, plan = hk.stage_residuals(
        meta, np.concatenate([lv for _, lv in parts]), dev)
    return (lambda: cuda_hevc.hevc_residuals(m_d, lv_d, bd, *plan)), m_d, lv_d


def run(tree: str) -> dict:
    """One tree's numbers (see the module's docstring)."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch
    import ffpic_tpu_torch
    from ffpic_tpu_torch import testing
    from ffpic_tpu_torch.formats import heif
    from ffpic_tpu_torch.ops import _build, cuda_hevc, cuda_png
    from ffpic_tpu_torch.ops import hevc_kernels as hk
    from ffpic_tpu_torch.ops import png_kernels as pk
    from ffpic_tpu_torch.utils import trace
    from ffpic_tpu_torch.utils.timing import gpu_ms, gpu_ms_cold
    pkg = os.path.dirname(os.path.abspath(ffpic_tpu_torch.__file__))
    if pkg != os.path.join(os.path.abspath(tree), "ffpic_tpu_torch"):
        raise RuntimeError(f"imported {pkg}, not the tree's package")
    t0 = time.perf_counter()
    so = _build.library_path()
    _build.load()
    build_s = time.perf_counter() - t0
    with open(so[:-3] + ".log") as f:
        ptxas = [ln.strip() for ln in f if "Used" in ln or "Compiling" in ln]
    dev = torch.device("cuda")
    flush = torch.empty(100 * 2 ** 20, dtype=torch.uint8, device=dev)
    out = {"tree": os.path.abspath(tree), "build_s": build_s,
           "ptxas": [ln for k, ln in enumerate(ptxas)
                     if "assemble_rgba" in ln or "hevc_residuals" in ln
                     or (k and ("assemble_rgba" in ptxas[k - 1]
                                or "hevc_residuals" in ptxas[k - 1]))]}

    # --- K7 ------------------------------------------------------------------
    rng = np.random.default_rng(12)
    k7 = {}
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
                k7[f"<{ct},{bd}> {layout}"] = {
                    "ms": gpu_ms(fn, 50),
                    "ms_cold": gpu_ms_cold(fn, 20, flush)}
            if (ct, bd) == (6, 8):
                def copy(rec=rec):
                    return rec.clone().view(H, W, 4)
                k7["device copy <6,8> contiguous"] = {
                    "ms": gpu_ms(copy, 50),
                    "ms_cold": gpu_ms_cold(copy, 20, flush)}
    out["k7"] = k7

    # --- K14 -----------------------------------------------------------------
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
    out["k14"] = {
        "48 launches": {"ms": gpu_ms(tiles48, 2),
                        "ms_cold": gpu_ms_cold(tiles48, 5, flush)},
        "one launch": {"ms": gpu_ms(one, 20),
                       "ms_cold": gpu_ms_cold(one, 10, flush)}}
    del per_tile, one, m_d, lv_d, flush

    # --- the fixture's load ---------------------------------------------
    loads = {}
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
        loads[route] = {"ms": wall * 1e3, "mps": mp / wall,
                        "runs_ms": [w * 1e3 for w in walls],
                        "spans_ms": {k: v["mean"] * 1e3
                                     for k, v in spans.items()}}
    out["load"] = loads
    return out


def _rows(result: dict) -> dict:
    rows = {}
    for name, t in result["k7"].items():
        rows[f"K7 {name} ms"] = t["ms"]
        rows[f"K7 {name} ms_cold"] = t["ms_cold"]
    for name, t in result["k14"].items():
        rows[f"K14 {name} ms"] = t["ms"]
        rows[f"K14 {name} ms_cold"] = t["ms_cold"]
    for route, t in result["load"].items():
        rows[f"load {route} ms"] = t["ms"]
        rows[f"load {route} mps"] = t["mps"]
        for span, ms in t["spans_ms"].items():
            rows[f"load {route} {span} ms"] = ms
    return rows


def _one(tree: str) -> dict:
    r = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree",
                        tree], capture_output=True, text=True, timeout=900)
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
    ap.add_argument("--rounds", type=int, default=1)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("compare_k7_k14: CUDA is not available", file=sys.stderr)
        return 1
    if a.tree:
        print("RESULT " + json.dumps(run(a.tree)), flush=True)
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
            result = _one(tree)
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
