"""The port's native host kernels: builds and loads host_jpeg.c (the
JPEG entropy decoder and the sparse coefficient packer) and host_png.c
(the PNG scanline unfilter).

Copied from the JPEG and PNG parts of ``ffpic_tpu/native/__init__.py``
(``_build``, ``_load``, ``available``, ``jpeg_decode_scan``,
``jpeg_decode_scan_packed``, ``jpeg_destuff``, ``png_unfilter``,
``pack_nonzero``), with these changes:

* only ``host_jpeg.c`` and ``host_png.c`` (this directory) are compiled,
  with ``cc``, into one library in ``ffpic_tpu_torch/build/``, named by
  a hash of both sources and the flags; the library is written under a
  temporary name and renamed, so another process never loads a
  half-written file;
* the loader holds a lock, so threads that ask for the library while
  the first one builds it wait for it instead of seeing none;
* a failed build raises: there is no Python Huffman decoder to fall
  back to;
* ``png_unfilter`` refuses a buffer shorter than its rows instead of
  reading past it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = [os.path.join(_DIR, f) for f in ("host_jpeg.c", "host_png.c")]
BUILD = os.path.join(os.path.dirname(_DIR), "build")
FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-fvisibility=hidden"]

_lock = threading.Lock()
_lib = None

_vp = ctypes.c_void_p
_int = ctypes.c_int
_long = ctypes.c_long
_SIGNATURES = {
    "ffpic_jpeg_decode_scan": (_int, [_vp, _long, _vp, _vp, _vp, _int, _vp,
                                      _vp, _int, _int, _vp, _vp, _vp, _vp,
                                      _int, _vp, _vp, _vp, _int, _int, _int,
                                      _int, _int, _vp]),
    "ffpic_jpeg_decode_scan_packed": (_long, [_vp, _long, _vp, _vp, _vp, _int,
                                              _vp, _vp, _int, _int, _vp, _vp,
                                              _int, _vp, _vp, _vp, _int, _vp,
                                              _vp, _vp]),
    "ffpic_jpeg_destuff": (_int, [_vp, _long, _vp, _vp, _vp]),
    "ffpic_png_unfilter": (_int, [_vp, _vp, _long, _long, _int]),
    "ffpic_pack_nonzero": (_long, [_vp, _long, _vp, _vp]),
}


def _build() -> str:
    """Path of the built library, compiling it first if needed."""
    cc = os.environ.get("CC", "cc")
    h = hashlib.sha256(" ".join([cc, *FLAGS]).encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD, f"libffpic_torch_host_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [cc, *FLAGS, "-o", tmp, *SOURCES]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.CalledProcessError, FileNotFoundError,
            subprocess.TimeoutExpired) as e:
        err = getattr(e, "stderr", b"") or b""
        raise RuntimeError(f"native build failed: {' '.join(cmd)}\n"
                           f"{err.decode(errors='replace')}") from e
    os.replace(tmp, so)
    return so


def _load() -> ctypes.CDLL:
    """The library, built and loaded once per process; a thread that
    asks while another builds it waits for that build."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = res
                fn.argtypes = args
            _lib = lib
        return _lib


def available() -> bool:
    """Build and load the library: True, or it raises."""
    return _load() is not None


def _tables(dht: dict):
    """DHT {(class, id): (counts, symbols)} -> the 8-slot arrays the C
    decoder takes (class 0 ids 0..3, then class 1 ids 0..3)."""
    counts = np.zeros((8, 16), np.uint8)
    syms = np.zeros((8, 256), np.uint8)
    present = np.zeros(8, np.int32)
    for (tc, th), (cnt, sy) in dht.items():
        if th > 3:
            raise ValueError("huffman table id > 3")
        slot = tc * 4 + th
        counts[slot, :] = cnt
        syms[slot, :len(sy)] = sy
        present[slot] = 1
    return counts, syms, present


def _i32(values) -> np.ndarray:
    return np.array(list(values), np.int32)


def _p(a: np.ndarray) -> int:
    return a.ctypes.data


def jpeg_decode_scan(scan: bytes, dht: dict, frame_comps, scan_comps,
                     ss: int, se: int, ah: int, al: int,
                     restart_interval: int, mcus_x: int, mcus_y: int,
                     planes: list[np.ndarray]) -> None:
    """Decode one scan into raster-order coefficient planes.

    dht: {(class, id): (counts, symbols)}.
    planes: per-frame-component (nby, nbx, 64) int16 arrays in natural
    raster order (modified in place).
    """
    lib = _load()
    counts, syms, present = _tables(dht)
    for p in planes:
        if p.dtype != np.int16 or not p.flags["C_CONTIGUOUS"]:
            raise ValueError("planes must be C-contiguous int16")
    ch = _i32(c.h for c in frame_comps)
    cv = _i32(c.v for c in frame_comps)
    nbx = _i32(c.nbx for c in frame_comps)
    nby = _i32(c.nby for c in frame_comps)
    nbxa = _i32(c.nbx_actual for c in frame_comps)
    nbya = _i32(c.nby_actual for c in frame_comps)
    sc_comp = _i32(s.comp_idx for s in scan_comps)
    sc_dc = _i32(s.dc_tbl for s in scan_comps)
    sc_ac = _i32(s.ac_tbl for s in scan_comps)
    plane_ptrs = (ctypes.c_void_p * len(planes))(*[_p(p) for p in planes])
    scan_buf = np.frombuffer(scan, np.uint8)
    rc = lib.ffpic_jpeg_decode_scan(
        _p(scan_buf), len(scan), _p(counts), _p(syms), _p(present),
        len(frame_comps), _p(ch), _p(cv), mcus_x, mcus_y, _p(nbx), _p(nby),
        _p(nbxa), _p(nbya), len(scan_comps), _p(sc_comp), _p(sc_dc),
        _p(sc_ac), ss, se, ah, al, restart_interval,
        ctypes.cast(plane_ptrs, ctypes.c_void_p))
    if rc != 0:
        raise ValueError(f"native jpeg scan decode failed rc={rc}")


_packed_tls = threading.local()    # per-thread scratch: the packed
# emission returns views into it, and decode_batch parses from a host
# worker pool


def jpeg_decode_scan_packed(scan: bytes, dht: dict, frame_comps,
                            scan_comps, restart_interval: int,
                            mcus_x: int, mcus_y: int):
    """Packed-emission decode of ONE interleaved baseline scan.

    Returns (counts uint8[G], ks uint8[E], vals int16[E], nnz) in MCU
    decode order -- see host_jpeg.c ffpic_jpeg_decode_scan_packed --
    with ks and vals zero past nnz up to a power-of-two length.  The
    arrays are views of per-thread scratch that the next call on the
    same thread overwrites.
    """
    lib = _load()
    counts, syms, present = _tables(dht)
    ch = _i32(c.h for c in frame_comps)
    cv = _i32(c.v for c in frame_comps)
    nbxa = _i32(c.nbx_actual for c in frame_comps)
    nbya = _i32(c.nby_actual for c in frame_comps)
    sc_comp = _i32(s.comp_idx for s in scan_comps)
    sc_dc = _i32(s.dc_tbl for s in scan_comps)
    sc_ac = _i32(s.ac_tbl for s in scan_comps)
    if len(scan_comps) > 1:
        g = mcus_x * mcus_y * int(sum(c.h * c.v for c in frame_comps))
    else:
        c0 = frame_comps[scan_comps[0].comp_idx]
        g = c0.nbx_actual * c0.nby_actual
    cap = g * 64
    # reused scratch: fresh multi-MB allocations per frame cost more in
    # page faults than the decode itself
    sc = getattr(_packed_tls, "sc", None)
    if sc is None:
        sc = _packed_tls.sc = {}
    if sc.get("cap", 0) < cap:
        sc["counts"] = np.empty(cap // 64, np.uint8)
        sc["ks"] = np.empty(cap, np.uint8)
        sc["vals"] = np.empty(cap, np.int16)
        sc["cap"] = cap
    out_counts = sc["counts"][:g]
    out_ks = sc["ks"]
    out_vals = sc["vals"]
    scan_buf = np.frombuffer(scan, np.uint8)
    n = lib.ffpic_jpeg_decode_scan_packed(
        _p(scan_buf), len(scan), _p(counts), _p(syms), _p(present),
        len(frame_comps), _p(ch), _p(cv), mcus_x, mcus_y, _p(nbxa),
        _p(nbya), len(scan_comps), _p(sc_comp), _p(sc_dc), _p(sc_ac),
        restart_interval, _p(out_counts), _p(out_ks), _p(out_vals))
    if n < 0:
        raise ValueError(f"native packed jpeg scan decode failed rc={n}")
    # pad to a power-of-two length; the tail is zeroed in place (zigzag
    # position 0, value 0), no copy of the payload
    cap2 = 2048
    while cap2 < n:
        cap2 <<= 1
    cap2 = min(cap2, cap)
    out_ks[n:cap2] = 0
    out_vals[n:cap2] = 0
    return out_counts, out_ks[:cap2], out_vals[:cap2], int(n)


def jpeg_destuff(scan: bytes):
    """Destuff the entropy stream (0xFF00 -> 0xFF, split at RSTn).
    Returns (bytes_array uint8, seg_bounds int64[n_segs+1])."""
    lib = _load()
    n = len(scan)
    src = np.frombuffer(scan, np.uint8)
    out = np.empty(max(n, 1), np.uint8)
    bounds = np.zeros(65537, np.int64)
    out_len = ctypes.c_long(0)
    n_segs = lib.ffpic_jpeg_destuff(_p(src), n, _p(out), _p(bounds),
                                    ctypes.addressof(out_len))
    if n_segs < 0:
        raise ValueError(f"destuff failed ({n_segs})")
    return out[:out_len.value], bounds[:n_segs + 1].copy()


def png_unfilter(raw: np.ndarray, height: int, stride: int,
                 bpp: int) -> np.ndarray:
    """Reconstruct PNG scanlines. raw: height*(stride+1) bytes of
    filter-tagged rows; returns (height, stride) uint8."""
    lib = _load()
    raw = np.ascontiguousarray(raw, np.uint8).reshape(-1)
    if raw.size < height * (stride + 1):
        raise ValueError(f"{raw.size} bytes cannot hold {height} rows of "
                         f"{stride} + 1")
    out = np.empty(height * stride, np.uint8)
    rc = lib.ffpic_png_unfilter(_p(raw), _p(out), height, stride, bpp)
    if rc != 0:
        raise ValueError("invalid PNG filter type")
    return out.reshape(height, stride)


def pack_nonzero(plane: np.ndarray):
    """Pack nonzero coefficients of an int16 array into
    (flat_idx int32[], val int16[]), in index order.  Returns (idx, val)."""
    lib = _load()
    flat = np.ascontiguousarray(plane.reshape(-1), np.int16)
    n = flat.size
    idx = np.empty(n, np.int32)
    val = np.empty(n, np.int16)
    nnz = lib.ffpic_pack_nonzero(_p(flat), n, _p(idx), _p(val))
    return idx[:nnz], val[:nnz]
