"""The port's native host kernels: builds and loads host_jpeg.c (the
JPEG entropy decoder and the sparse coefficient packer), host_png.c
(the PNG scanline unfilter), host_vp8.c (the VP8 token, header and
probability parsers, residual transform, intra reconstruction, loop
filter and colour conversion), host_vp8l.c (the VP8L entropy
decoder), host_hevc.c (the HEVC CABAC slice syntax pass, intra
reconstruction and YUV to RGBA colour), host_lzw.c (the GIF and
TIFF LZW decoders), host_jp2.c (the JPEG 2000 EBCOT tier-1
code-block decoder), host_av1.c (the AV1 symbol parse of a superblock
or a block, intra reconstruction, deblocking and CICP colour) and
host_av1_itx.c (the AV1 inverse transforms).

Copied from the JPEG, PNG and WebP parts of
``ffpic_tpu/native/__init__.py`` (``_build``, ``_load``, ``available``,
``jpeg_decode_scan``, ``jpeg_decode_scan_packed``, ``jpeg_destuff``,
``png_unfilter``, ``pack_nonzero``, ``vp8_loop_filter``,
``vp8_tokens``, ``vp8_residuals``, ``vp8_coeff_probs``,
``vp8_recon_fused``, ``vp8_recon``, ``vp8_mb_headers``,
``vp8l_entropy``, ``vp8_color_libwebp``, ``hevc_decode_slice``,
``hevc_picture_state``, ``hevc_decode_segment``, ``hevc_recon``,
``hevc_color``), its LZW part (``lzw_gif``, ``lzw_tiff``), its JPEG
2000 part (``jp2_block``, ``:665-680``) and its AV1 part
(``av1_recon``, ``av1_block_parse``, ``av1_block_mode``,
``av1_color_cicp``, ``av1_sb_parse``, ``av1_deblock_pass``,
``av1_itx_batch``, ``av1_wht_batch``, ``:772-989``), with these
changes:

* only these nine sources (this directory) are compiled, with ``cc``,
  one process a source, all started together, and linked into one
  library in ``ffpic_tpu_torch/build/``, named by a hash of the sources
  and the flags; the library is written under a temporary name and
  renamed, so another process never loads a half-written file;
* the loader holds a lock, so threads that ask for the library while
  the first one builds it wait for it instead of seeing none, and the
  build holds a file lock in ``build/``, so processes that ask at once
  (pytest's workers) wait for one build instead of each compiling;
* a failed build raises: there is no Python Huffman decoder to fall
  back to;
* ``png_unfilter`` refuses a buffer shorter than its rows instead of
  reading past it;
* the VP8 wrappers raise ``ValueError`` on a plane the C code would
  write that is not C-contiguous uint8, on residuals of another shape
  and on planes too small for the picture (the original asserts, or
  passes them on);
* the HEVC wrappers raise ``ValueError`` on planes that are not
  C-contiguous int32, on a ``tu_meta`` that is not (m, 8), on levels or
  residuals shorter than the TUs' n² sums and on picture state of the
  wrong size (the original asserts, or passes them on);
* the AV1 wrappers raise ``ValueError`` on an array the C code reads or
  writes that is not C-contiguous of the type it takes, or not of the
  shape or length its layout fixes: the symbol parses' msac state,
  records and output buffers (the superblock parse's sized by its
  superblock), the op list and planes of ``av1_recon``, the deblock
  pass's plane and mode grids, the transforms' coefficients and the
  colour's planes (the original asserts on two of them and passes the
  others on).  Like every ctypes call here, the C runs with the GIL
  released, so a grid's tiles and ``decode_batch``'s pool decode side
  by side.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = [os.path.join(_DIR, f) for f in ("host_jpeg.c", "host_png.c",
                                           "host_vp8.c", "host_vp8l.c",
                                           "host_hevc.c", "host_lzw.c",
                                           "host_jp2.c", "host_av1.c",
                                           "host_av1_itx.c")]
BUILD = os.path.join(os.path.dirname(_DIR), "build")
FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-fvisibility=hidden"]

_lock = threading.Lock()
_lib = None

_vp = ctypes.c_void_p
_int = ctypes.c_int
_long = ctypes.c_long
_u32 = ctypes.c_uint32
_f32 = ctypes.c_float
_f64 = ctypes.c_double
_ll = ctypes.c_longlong
_char = ctypes.c_char_p
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
    "ffpic_vp8_loop_filter": (None, [_vp, _vp, _vp, _int, _int, _vp, _vp,
                                     _int, _int]),
    "ffpic_vp8_tokens": (_int, [_vp, _long, _vp, _vp, _int, _vp, _vp, _vp,
                                _int, _int, _vp, _vp]),
    "ffpic_vp8_residuals": (None, [_vp, _vp, _vp, _vp, _vp, _int, _int,
                                   _vp]),
    "ffpic_vp8_coeff_probs": (None, [_vp, _long, _vp, _vp, _vp, _vp, _vp,
                                     _vp]),
    "ffpic_vp8_recon_fused": (None, [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                                     _vp, _vp, _vp, _int, _int]),
    "ffpic_vp8_recon": (None, [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _int,
                               _int]),
    "ffpic_vp8_mb_headers": (None, [_vp, _long, _long, _u32, _u32, _int,
                                    _int, _int, _int, _vp, _int, _int, _vp,
                                    _vp, _vp, _vp, _vp, _vp]),
    "ffpic_vp8l_entropy": (_int, [_vp, _long, _vp, _vp, _int, _int, _int,
                                  _vp, _vp, _vp]),
    "vp8_color_libwebp": (None, [_vp, _long, _vp, _vp, _long, _int, _int,
                                 _vp, _vp]),
    "ffpic_hevc_decode_slice": (_long, [_vp, _long, _vp, _vp, _vp, _vp,
                                        _long, _vp, _long, _vp, _long, _vp,
                                        _vp, _vp, _vp, _vp, _vp]),
    "ffpic_hevc_decode_segment": (_long, [_vp, _long, _vp, _vp, _vp, _vp,
                                          _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                                          _vp, _vp, _long, _vp, _long, _vp,
                                          _long, _vp, _vp, _vp, _vp, _vp,
                                          _vp]),
    "ffpic_hevc_recon2": (_int, [_vp, _vp, _vp, _int, _int, _int, _int,
                                 _int, _int, _int, _vp, _long, _vp, _long,
                                 _vp, _vp]),
    "ffpic_lzw_gif": (_long, [_vp, _long, _int, _vp, _long]),
    "ffpic_lzw_tiff": (_long, [_vp, _long, _vp, _long]),
    "ffpic_jp2_block": (_int, [_vp, _long, _int, _int, _int, _int, _int,
                               _int, _vp]),
    "ffpic_yuv_to_rgba": (None, [_vp, _vp, _vp, _int, _int, _int, _int,
                                 _int, _int, _f32, _f32, _f32, _f32, _int,
                                 _int, _vp]),
    "av1_recon": (None, [_vp, _ll] + [_vp] * 10 + [_int]),
    "av1_block_parse": (None, [_char, _ll, _vp, _vp, _vp, _vp, _int, _vp,
                               _vp, _vp, _ll, _vp]),
    "av1_block_mode": (None, [_char, _ll, _vp, _vp, _vp, _vp, _vp]),
    "av1_color_cicp": (_int, [_vp, _long, _vp, _long, _vp, _long, _int,
                              _int, _int, _int, _int, _int, _int, _int,
                              _int, _int, _f64, _f64, _vp]),
    "av1_sb_parse": (None, [_char, _ll] + [_vp] * 10),
    "av1_deblock_pass": (None, [_vp] + [_int] * 4 + [_vp] * 8),
    "av1_itx_batch": (_int, [_vp, _long] + [_int] * 8
                      + [ctypes.c_int32] * 4 + [_vp, _vp]),
    "av1_wht_batch": (None, [_vp, _long, _vp]),
}


def _cc(cmd: list[str]) -> None:
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.CalledProcessError, FileNotFoundError,
            subprocess.TimeoutExpired) as e:
        err = getattr(e, "stderr", b"") or b""
        raise RuntimeError(f"native build failed: {' '.join(cmd)}\n"
                           f"{err.decode(errors='replace')}") from e


def _build() -> str:
    """Path of the built library, compiling it first if needed: one
    ``cc -c`` a source side by side, then one link, under a file lock
    that one process at a time holds."""
    cc = os.environ.get("CC", "cc")
    h = hashlib.sha256(" ".join([cc, *FLAGS]).encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    tag = h.hexdigest()[:16]
    so = os.path.join(BUILD, f"libffpic_torch_host_{tag}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD, exist_ok=True)
    with open(os.path.join(BUILD, "host.lock"), "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(so):          # another process built it
            return so
        tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
        objs = [f"{tmp}.{os.path.basename(src)}.o" for src in SOURCES]
        compile_flags = [f for f in FLAGS if f != "-shared"]
        try:
            with ThreadPoolExecutor(len(SOURCES)) as ex:
                list(ex.map(_cc, ([cc, *compile_flags, "-c", "-o", o, src]
                                  for src, o in zip(SOURCES, objs))))
            _cc([cc, *FLAGS, "-o", tmp, *objs])
        finally:
            for o in objs:
                if os.path.exists(o):
                    os.remove(o)
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


def _c(a: np.ndarray, dtype) -> np.ndarray:
    """``a`` as a C-contiguous array of ``dtype`` (a copy only if needed)."""
    return np.ascontiguousarray(a, dtype)


def _plane(a: np.ndarray, name: str) -> int:
    """Pointer to a plane the C code writes in place."""
    if a.dtype != np.uint8 or not a.flags["C_CONTIGUOUS"]:
        raise ValueError(f"{name} must be a C-contiguous uint8 plane")
    return _p(a)


def vp8_loop_filter(Y: np.ndarray, U: np.ndarray, V: np.ndarray,
                    levels: np.ndarray, inner: np.ndarray,
                    simple: bool, sharpness: int) -> None:
    """In-place VP8 loop filter over whole planes (host_vp8.c)."""
    lib = _load()
    mbh, mbw = levels.shape
    levels, inner = _c(levels, np.int32), _c(inner, np.uint8)
    lib.ffpic_vp8_loop_filter(_plane(Y, "Y"), _plane(U, "U"), _plane(V, "V"),
                              mbh, mbw, _p(levels), _p(inner),
                              1 if simple else 0, sharpness)


def vp8_tokens(rest: bytes, part_off, part_len, probs: np.ndarray,
               skip: np.ndarray, has_y2: np.ndarray,
               mbh: int, mbw: int):
    """Native VP8 token-partition decode (host_vp8.c).  Returns
    (levels (mbh,mbw,25,16) int32, nnz_total (mbh,mbw,25) int32)."""
    lib = _load()
    levels = np.zeros((mbh, mbw, 25, 16), np.int32)
    nnz = np.zeros((mbh, mbw, 25), np.int32)
    rest_b = np.frombuffer(rest, np.uint8)
    off = _c(part_off, np.int64)
    ln = _c(part_len, np.int64)
    probs, skip, has_y2 = (_c(probs, np.uint8), _c(skip, np.uint8),
                           _c(has_y2, np.uint8))
    rc = lib.ffpic_vp8_tokens(_p(rest_b), len(rest), _p(off), _p(ln),
                              len(off), _p(probs), _p(skip), _p(has_y2),
                              mbh, mbw, _p(levels), _p(nnz))
    if rc != 0:
        raise ValueError(f"vp8 token decode failed ({rc})")
    return levels, nnz


def _seg(seg):
    return None if seg is None else _c(seg, np.int32)


def vp8_residuals(levels: np.ndarray, nnz: np.ndarray, dq: np.ndarray,
                  seg, has_y2: np.ndarray, mbh: int, mbw: int) -> np.ndarray:
    """Native dequant + Y2 IWHT + 4x4 IDCT over the whole image with
    zero/DC-only block fast paths (host_vp8.c).  Returns
    (mbh, mbw, 24, 4, 4) int16 residuals."""
    lib = _load()
    out = np.empty((mbh, mbw, 24, 4, 4), np.int16)
    levels, nnz, dq = (_c(levels, np.int32), _c(nnz, np.int32),
                       _c(dq, np.int32))
    seg, has_y2 = _seg(seg), _c(has_y2, np.uint8)
    lib.ffpic_vp8_residuals(_p(levels), _p(nnz), _p(dq),
                            None if seg is None else _p(seg), _p(has_y2),
                            mbh, mbw, _p(out))
    return out


def vp8_coeff_probs(part0: bytes, br, update_probs: np.ndarray,
                    probs: np.ndarray) -> None:
    """Native RFC 6386 13.4 coefficient-probability update parse;
    resumes the Python BoolDecoder ``br`` in place and updates
    ``probs`` (4,8,3,11) in place."""
    lib = _load()
    if probs.dtype != np.uint8 or not probs.flags["C_CONTIGUOUS"]:
        raise ValueError("probs must be C-contiguous uint8")
    buf = np.frombuffer(part0, np.uint8)
    pos = ctypes.c_long(br.pos)
    value = ctypes.c_uint32(br.value)
    rng = ctypes.c_uint32(br.range)
    bc = ctypes.c_int(br.bit_count)
    upd = _c(update_probs, np.uint8)
    lib.ffpic_vp8_coeff_probs(_p(buf), len(part0), ctypes.addressof(pos),
                              ctypes.addressof(value), ctypes.addressof(rng),
                              ctypes.addressof(bc), _p(upd), _p(probs))
    br.pos, br.value, br.range, br.bit_count = (
        pos.value, value.value, rng.value, bc.value)


def vp8_recon_fused(Y, U, V, levels, nnz, dq, seg, has_y2,
                    ymode, bmodes, uvmode, mbh: int, mbw: int) -> None:
    """Fused native residual transform + intra recon (host_vp8.c):
    one MB walk, no whole-image residual intermediate."""
    lib = _load()
    levels, nnz, dq = (_c(levels, np.int32), _c(nnz, np.int32),
                       _c(dq, np.int32))
    seg, has_y2 = _seg(seg), _c(has_y2, np.uint8)
    ymode, bmodes, uvmode = (_c(ymode, np.int32), _c(bmodes, np.int32),
                             _c(uvmode, np.int32))
    lib.ffpic_vp8_recon_fused(
        _plane(Y, "Y"), _plane(U, "U"), _plane(V, "V"), _p(levels), _p(nnz),
        _p(dq), None if seg is None else _p(seg), _p(has_y2), _p(ymode),
        _p(bmodes), _p(uvmode), mbh, mbw)


def vp8_recon(Y, U, V, residual, ymode, bmodes, uvmode,
              mbh: int, mbw: int) -> None:
    """Native intra prediction + residual add (host_vp8.c), writing
    the planes in place."""
    lib = _load()
    residual = _c(residual, np.int16)
    if residual.shape != (mbh, mbw, 24, 4, 4):
        raise ValueError(f"residual {residual.shape}: expected "
                         f"{(mbh, mbw, 24, 4, 4)}")
    ymode, bmodes, uvmode = (_c(ymode, np.int32), _c(bmodes, np.int32),
                             _c(uvmode, np.int32))
    lib.ffpic_vp8_recon(_plane(Y, "Y"), _plane(U, "U"), _plane(V, "V"),
                        _p(residual), _p(ymode), _p(bmodes), _p(uvmode),
                        mbh, mbw)


def vp8_mb_headers(part0: bytes, state, mbh: int, mbw: int,
                   seg_update: bool, seg_probs, mb_no_skip: bool,
                   prob_skip: int, kf_bmode_probs: np.ndarray):
    """Native VP8 MB-header parse resuming a bool-decoder state
    (pos, value, range, bit_count).  Returns (seg, skip, ymode,
    uvmode, bmodes(mbh,mbw,4,4)) int32 arrays."""
    lib = _load()
    pos, value, rng, bit_count = state
    seg = np.zeros((mbh, mbw), np.int32)
    skip = np.zeros((mbh, mbw), np.int32)
    ymode = np.zeros((mbh, mbw), np.int32)
    uvmode = np.zeros((mbh, mbw), np.int32)
    bmodes = np.zeros((mbh, mbw, 16), np.int32)
    buf = np.frombuffer(part0, np.uint8)
    seg_probs, kf = _c(seg_probs, np.uint8), _c(kf_bmode_probs, np.uint8)
    lib.ffpic_vp8_mb_headers(
        _p(buf), len(part0), pos, value, rng, bit_count, mbh, mbw,
        1 if seg_update else 0, _p(seg_probs), 1 if mb_no_skip else 0,
        prob_skip, _p(kf), _p(seg), _p(skip), _p(ymode), _p(uvmode),
        _p(bmodes))
    return seg, skip, ymode, uvmode, bmodes.reshape(mbh, mbw, 4, 4)


def vp8l_entropy(data: bytes, pos: int, bit: int, w: int, h: int,
                 allow_meta: bool, clcl_order, dist_map):
    """Native VP8L entropy-image decode.  Returns (argb (h,w,4) uint8,
    new_pos, new_bit)."""
    lib = _load()
    out = np.empty((h, w, 4), np.uint8)
    buf = np.frombuffer(data, np.uint8)
    p = ctypes.c_long(pos)
    b = ctypes.c_int(bit)
    clcl, dmap = _c(clcl_order, np.uint8), _c(dist_map, np.int16)
    rc = lib.ffpic_vp8l_entropy(_p(buf), len(data), ctypes.addressof(p),
                                ctypes.addressof(b), w, h,
                                1 if allow_meta else 0, _p(clcl), _p(dmap),
                                _p(out))
    if rc != 0:
        raise ValueError(f"corrupt VP8L stream ({rc})")
    return out, p.value, b.value


def vp8_color_libwebp(Y, U, V, H: int, W: int, A=None):
    """libwebp-exact host YUV420->RGBA (host_vp8.c): fancy chroma
    upsample + fixed-point matrix; bit-identical to the numpy path in
    formats/webp.py."""
    lib = _load()
    Y = _c(Y, np.uint8)
    ch, cw = (H + 1) // 2, (W + 1) // 2
    U = _c(U[:ch, :cw], np.uint8)
    V = _c(V[:ch, :cw], np.uint8)
    if Y.shape[0] < H or Y.shape[1] < W or U.shape != (ch, cw) \
            or V.shape != (ch, cw):
        raise ValueError(f"planes {Y.shape}, {U.shape}, {V.shape} cannot "
                         f"hold a {W}x{H} picture")
    out = np.empty((H, W, 4), np.uint8)
    a_ptr = None
    if A is not None:
        A = _c(A, np.uint8)
        if A.shape != (H, W):
            raise ValueError(f"alpha {A.shape}: expected {(H, W)}")
        a_ptr = _p(A)
    lib.vp8_color_libwebp(_p(Y), Y.shape[1], _p(U), _p(V), U.shape[1], H, W,
                          a_ptr, _p(out))
    return out


# --- HEVC (host_hevc.c) ----------------------------------------------------

def _i32_plane(a: np.ndarray, name: str) -> None:
    if not isinstance(a, np.ndarray) or a.dtype != np.int32 \
            or a.ndim != 2 or not a.flags["C_CONTIGUOUS"]:
        raise ValueError(f"{name} must be a 2-D C-contiguous int32 plane")


def _tu_levels(tu_meta: np.ndarray, levels: np.ndarray, name: str):
    """``tu_meta`` as C-contiguous (m, 8) int32 and ``levels`` (or
    residuals) as int16 holding at least the TUs' n² sum."""
    tu_meta = _c(tu_meta, np.int32)
    if tu_meta.ndim != 2 or tu_meta.shape[1] != 8:
        raise ValueError(f"tu_meta {tu_meta.shape}: expected (m, 8)")
    need = int((tu_meta[:, 2].astype(np.int64) ** 2).sum())
    levels = _c(levels, np.int16).reshape(-1)
    if levels.size < need:
        raise ValueError(f"{name}: {levels.size} values for TUs of {need}")
    return tu_meta, levels


def hevc_decode_slice(data: bytes, params, init_state: np.ndarray,
                      init_mps: np.ndarray):
    """Native HEVC I-slice syntax decode (host_hevc.c).  Returns
    (ops (n,6) int32, tu_meta (m,8) int32, levels int16 packed,
    sao (ctbs,21) int32, ct_depth, luma_mode, qp_map int8 maps,
    bypass_map uint8)."""
    lib = _load()
    if len(params) != 21:
        raise ValueError(f"{len(params)} slice parameters: expected 21")
    w, h, ctb_log2 = params[0], params[1], params[2]
    mw, mh = (w + 3) // 4, (h + 3) // 4
    ctbs = (((w + (1 << ctb_log2) - 1) >> ctb_log2)
            * ((h + (1 << ctb_log2) - 1) >> ctb_log2))
    n44 = mw * mh
    # np.empty: the C side fully initializes every entry it reports
    # (levels are memset per TU, maps are memset at entry)
    ops = np.empty((3 * n44 + 64, 6), np.int32)
    tu_meta = np.empty((3 * n44 + 64, 8), np.int32)
    levels = np.empty(2 * w * h + 4096, np.int16)
    sao = np.zeros((ctbs, 21), np.int32)     # zeros: sparse writes
    ct_depth = np.empty(n44, np.int8)
    luma_mode = np.empty(n44, np.int8)
    qp_map = np.empty(n44, np.int8)
    bypass_map = np.empty(n44, np.uint8)
    n_tus = np.zeros(1, np.int64)
    buf = np.frombuffer(data, np.uint8)
    prm = _c(params, np.int32)
    st, mp = _c(init_state, np.uint8), _c(init_mps, np.uint8)
    n_ops = lib.ffpic_hevc_decode_slice(
        _p(buf), len(data), _p(prm), _p(st), _p(mp), _p(ops), len(ops),
        _p(tu_meta), len(tu_meta), _p(levels), len(levels), _p(sao),
        _p(ct_depth), _p(luma_mode), _p(qp_map), _p(bypass_map), _p(n_tus))
    if n_ops < 0:
        raise ValueError(f"hevc native slice decode failed ({n_ops})")
    m = int(n_tus[0])
    return (ops[:n_ops], tu_meta[:m], levels, sao,
            ct_depth.reshape(mh, mw), luma_mode.reshape(mh, mw),
            qp_map.reshape(mh, mw), bypass_map.reshape(mh, mw))


def hevc_picture_state(w: int, h: int, ctb_log2: int, layout) -> dict:
    """Persistent per-picture buffers for multi-segment native decode
    (ffpic_hevc_decode_segment): syntax maps, availability zones, WPP
    context snapshot, tile-scan address maps."""
    mw, mh = (w + 3) // 4, (h + 3) // 4
    ctbs = (((w + (1 << ctb_log2) - 1) >> ctb_log2)
            * ((h + (1 << ctb_log2) - 1) >> ctb_log2))
    ident = layout is None or not getattr(layout, "n_tiles", 1) > 1
    return dict(
        mw=mw, mh=mh, ctbs=ctbs,
        zone=np.full(mw * mh, -1, np.int32),
        slice_of=np.full(ctbs, -1, np.int32),
        ct_depth=np.full(mw * mh, -1, np.int8),
        luma_mode=np.full(mw * mh, -1, np.int8),
        qp_map=np.zeros(mw * mh, np.int8),
        bypass_map=np.zeros(mw * mh, np.uint8),
        sao=np.zeros((ctbs, 21), np.int32),
        wpp_sm=np.zeros(137, np.uint8),
        wpp_meta=np.zeros(2, np.int32),
        ts_to_rs=(None if ident
                  else _c(layout.ts_to_rs, np.int32)),
        rs_to_ts=(None if ident
                  else _c(layout.rs_to_ts, np.int32)),
        tile_of=(None if ident
                 else _c(layout.tile_of_rs, np.int32)),
    )


_STATE = {"zone": (np.int32, "n44"), "slice_of": (np.int32, "ctbs"),
          "ct_depth": (np.int8, "n44"), "luma_mode": (np.int8, "n44"),
          "qp_map": (np.int8, "n44"), "bypass_map": (np.uint8, "n44"),
          "sao": (np.int32, "sao"), "wpp_sm": (np.uint8, 137),
          "wpp_meta": (np.int32, 2)}


def _check_state(state: dict) -> None:
    """The buffers ``hevc_picture_state`` made, of their types and sizes
    (the C code writes them in place)."""
    sizes = {"n44": state["mw"] * state["mh"], "ctbs": state["ctbs"],
             "sao": state["ctbs"] * 21}
    for key, (dtype, size) in _STATE.items():
        a = state[key]
        want = sizes.get(size, size)
        if a.dtype != dtype or not a.flags["C_CONTIGUOUS"] \
                or a.size != want:
            raise ValueError(f"picture state {key!r}: expected {want} "
                             f"C-contiguous {np.dtype(dtype).name}")
    for key in ("ts_to_rs", "rs_to_ts", "tile_of"):
        a = state[key]
        if a is not None and (a.dtype != np.int32
                              or not a.flags["C_CONTIGUOUS"]
                              or a.size < state["ctbs"]):
            raise ValueError(f"picture state {key!r}: expected "
                             f"{state['ctbs']} C-contiguous int32")


def hevc_decode_segment(data: bytes, params, segp, sub_bounds,
                        state: dict, sm_fresh: np.ndarray,
                        sm_io: np.ndarray):
    """Decode one slice segment (native); returns (ops, tu_meta,
    levels) — maps/sao/zone accumulate in `state`, contexts carry in
    sm_io."""
    lib = _load()
    if len(params) != 21:
        raise ValueError(f"{len(params)} slice parameters: expected 21")
    _check_state(state)
    if sm_io.dtype != np.uint8 or not sm_io.flags["C_CONTIGUOUS"] \
            or sm_io.size != 137:
        raise ValueError("sm_io must be 137 C-contiguous uint8")
    w, h = params[0], params[1]
    n44 = state["mw"] * state["mh"]
    ops = np.empty((3 * n44 + 64, 6), np.int32)
    tu_meta = np.empty((3 * n44 + 64, 8), np.int32)
    levels = np.empty(2 * w * h + 4096, np.int16)
    n_tus = np.zeros(1, np.int64)
    buf = np.frombuffer(data, np.uint8)
    prm = _c(params, np.int32)
    sg = _c(segp, np.int32)
    sb = _c(sub_bounds, np.int32)
    fresh = _c(sm_fresh, np.uint8)

    def ptr(a):
        return None if a is None else _p(a)
    n_ops = lib.ffpic_hevc_decode_segment(
        _p(buf), len(data), _p(prm), _p(sg), _p(sb),
        ptr(state["ts_to_rs"]), ptr(state["rs_to_ts"]),
        ptr(state["tile_of"]), _p(state["slice_of"]), _p(fresh),
        _p(sm_io), _p(state["wpp_sm"]), _p(state["wpp_meta"]),
        _p(state["zone"]), _p(ops), len(ops), _p(tu_meta), len(tu_meta),
        _p(levels), len(levels), _p(state["sao"]), _p(state["ct_depth"]),
        _p(state["luma_mode"]), _p(state["qp_map"]),
        _p(state["bypass_map"]), _p(n_tus))
    if n_ops < 0:
        raise ValueError(f"hevc native segment decode failed ({n_ops})")
    m = int(n_tus[0])
    nlv = int((tu_meta[:m, 2].astype(np.int64) ** 2).sum()) if m else 0
    return ops[:n_ops].copy(), tu_meta[:m].copy(), levels[:nlv].copy()


def hevc_recon(planes, bd: int, strong: bool, ops: np.ndarray,
               tu_meta: np.ndarray, levels: np.ndarray,
               residuals: np.ndarray | None = None) -> None:
    """Native HEVC reconstruction (host_hevc.c): runs the op list
    (prediction + residual add) in place on int32 planes.  With
    `residuals` (int16, packed like `levels`), the transforms are
    skipped and the precomputed values (from the ``hevc_residuals``
    kernel or its plain version) are added instead."""
    lib = _load()
    for k, p in enumerate(planes):
        _i32_plane(p, f"plane {k}")
    Y = planes[0]
    U = planes[1] if len(planes) > 1 else np.zeros((1, 1), np.int32)
    V = planes[2] if len(planes) > 1 else np.zeros((1, 1), np.int32)
    if U.shape != V.shape:
        raise ValueError(f"chroma planes {U.shape} and {V.shape} differ")
    ops = _c(ops, np.int32)
    if ops.ndim != 2 or ops.shape[1] != 6:
        raise ValueError(f"ops {ops.shape}: expected (n, 6)")
    tu_meta, levels = _tu_levels(tu_meta, levels, "levels")
    resid = None
    if residuals is not None:
        _, resid = _tu_levels(tu_meta, residuals, "residuals")
    rc = lib.ffpic_hevc_recon2(
        _p(Y), _p(U), _p(V), Y.shape[1], Y.shape[0], U.shape[1],
        U.shape[0], len(planes), bd, 1 if strong else 0, _p(ops),
        len(ops), _p(tu_meta), len(tu_meta), _p(levels),
        None if resid is None else _p(resid))
    if rc != 0:
        raise ValueError(f"hevc native recon failed ({rc})")


def hevc_color(planes, bd: int, coeffs, limited: bool,
               trunc: bool) -> np.ndarray:
    """Native YUV420/400 int32 planes -> RGBA uint8 (host_hevc.c
    ffpic_yuv_to_rgba); bit-identical to the numpy float32 path in
    formats/heif.py (same op order/constants)."""
    lib = _load()
    for k, p in enumerate(planes):
        _i32_plane(p, f"plane {k}")
    Y = planes[0]
    mono = len(planes) < 2
    U = planes[1] if not mono else np.zeros((1, 1), np.int32)
    V = planes[2] if not mono else np.zeros((1, 1), np.int32)
    h, w = Y.shape
    if not mono and (U.shape != V.shape or U.shape[0] < (h + 1) // 2
                     or U.shape[1] < (w + 1) // 2):
        raise ValueError(f"chroma planes {U.shape}, {V.shape} cannot "
                         f"cover a {w}x{h} luma plane")
    out = np.empty((h, w, 4), np.uint8)
    a_rv, a_gu, a_gv, a_bu = coeffs
    lib.ffpic_yuv_to_rgba(_p(Y), _p(U), _p(V), w, h, U.shape[1],
                          U.shape[0], 1 if mono else 0, bd, a_rv, a_gu,
                          a_gv, a_bu, 1 if limited else 0,
                          1 if trunc else 0, _p(out))
    return out


def lzw_gif(data: bytes, min_code_size: int, max_out: int) -> bytearray:
    """GIF LZW (host_lzw.c ffpic_lzw_gif): at most ``max_out`` bytes.
    A minimum code size over 12, for which the C tables are too small
    (the original passes it on), and a code past the table raise
    ``ValueError``."""
    lib = _load()
    if not 0 <= min_code_size <= 12:
        raise ValueError(f"LZW minimum code size {min_code_size} > 12")
    src = np.frombuffer(data, np.uint8)
    out = np.empty(max_out, np.uint8)
    n = lib.ffpic_lzw_gif(_p(src), len(data), min_code_size, _p(out),
                          max_out)
    if n < 0:
        raise ValueError("corrupt LZW stream")
    return bytearray(out[:n].tobytes())


def lzw_tiff(data: bytes, max_out: int) -> bytearray:
    """TIFF LZW (host_lzw.c ffpic_lzw_tiff): at most ``max_out`` bytes; a
    code past the table raises ``ValueError``."""
    lib = _load()
    src = np.frombuffer(data, np.uint8)
    out = np.empty(max_out, np.uint8)
    n = lib.ffpic_lzw_tiff(_p(src), len(data), _p(out), max_out)
    if n < 0:
        raise ValueError("corrupt LZW stream")
    return bytearray(out[:n].tobytes())


def jp2_block(data: bytes, n_passes: int, mb: int, zbp: int,
              w: int, h: int, orient: int) -> np.ndarray:
    """EBCOT tier-1 code-block decode (host_jp2.c ffpic_jp2_block):
    returns (h, w) int32 signed coefficients."""
    lib = _load()
    src = np.frombuffer(data, np.uint8)
    out = np.empty((h, w), np.int32)
    rc = lib.ffpic_jp2_block(_p(src), len(data), n_passes, mb, zbp, w, h,
                             orient, _p(out))
    if rc != 0:
        raise ValueError(f"jp2 native block decode failed ({rc})")
    return out


# --- AV1 (host_av1.c, host_av1_itx.c) --------------------------------------

_OP_NF = 21          # av1_recon op record width (formats/av1_recon.py)


def _arr(a, dtype, name: str, shape=None, min_len: int = 0) -> int:
    """Pointer to ``a``, which the C code reads or writes in place: a
    C-contiguous ``dtype`` array of ``shape`` (None for any; -1 for any
    extent on that axis) and at least ``min_len`` elements."""
    if not isinstance(a, np.ndarray) or a.dtype != dtype \
            or not a.flags["C_CONTIGUOUS"]:
        raise ValueError(f"{name} must be a C-contiguous "
                         f"{np.dtype(dtype).name} array")
    if shape is not None and (a.ndim != len(shape) or any(
            want not in (-1, got) for want, got in zip(shape, a.shape))):
        raise ValueError(f"{name} {a.shape}: expected {shape}")
    if a.size < min_len:
        raise ValueError(f"{name}: {a.size} elements, needs {min_len}")
    return _p(a)


def _msac_state(st) -> int:
    return _arr(st, np.int64, "msac state", (5,))


def av1_recon(op_arr, planes, pw, ph, res_buf, dr, smw, taps,
              pal_buf, bd: int):
    """Native AV1 intra reconstruction (host_av1.c:av1_recon): replay
    the precomputed op list sequentially over the int32 plane
    buffers (mutated in place)."""
    lib = _load()
    if not 1 <= len(planes) <= 3:
        raise ValueError(f"{len(planes)} planes: expected 1 to 3")
    for i, pl in enumerate(planes):
        _i32_plane(pl, f"plane {i}")
    _arr(pw, np.int32, "pw", (3,))
    _arr(ph, np.int32, "ph", (3,))
    if any((int(ph[i]), int(pw[i])) != pl.shape
           for i, pl in enumerate(planes)):
        raise ValueError("pw/ph do not match the planes' shapes")
    p = [_p(pl) for pl in planes] + [None] * (3 - len(planes))
    lib.av1_recon(_arr(op_arr, np.int32, "op_arr", (-1, _OP_NF)),
                  op_arr.shape[0], p[0], p[1], p[2], _p(pw), _p(ph),
                  _arr(res_buf, np.int32, "res_buf"),
                  _arr(dr, np.int32, "dr", (91,)),
                  _arr(smw, np.int32, "smw", (124,)),
                  _arr(taps, np.int32, "taps", min_len=5 * 8 * 7),
                  _arr(pal_buf, np.int32, "pal_buf"), bd)


def av1_block_parse(data: bytes, st, ptrs, blk, pp, nplanes: int,
                    ops, coef, tbmeta, clip: int, inout):
    """Whole-block AV1 residual parse (host_av1.c:av1_block_parse):
    C iterates the residual() TB geometry, decodes coefficients and
    emits recon ops, maintaining BlockDecoded bitmaps / a,l contexts
    / chroma tx grids / MaxLuma in place."""
    lib = _load()
    if not isinstance(data, bytes):
        raise ValueError("data must be bytes")
    pp_p = _arr(pp, np.int32, "pp", (-1, 22))
    if not 1 <= nplanes <= min(3, pp.shape[0]):
        raise ValueError(f"nplanes {nplanes} for {pp.shape[0]} plane rows")
    ops_p = _arr(ops, np.int32, "ops", (-1, _OP_NF))
    lib.av1_block_parse(
        data, len(data), _msac_state(st), _arr(ptrs, np.int64, "ptrs"),
        _arr(blk, np.int32, "blk", (18,)), pp_p, nplanes, ops_p,
        _arr(coef, np.int32, "coef"),
        _arr(tbmeta, np.int32, "tbmeta", (ops.shape[0], 9)), clip,
        _arr(inout, np.int32, "inout", (5,)))


def av1_block_mode(data: bytes, st, mode_ptrs, blk, out, pal):
    """Per-block AV1 mode-info symbol decode (host_av1.c:
    av1_block_mode): seg/skip/cdef/deltas/modes/CfL/filter-intra/
    tx-depth against the shared mode CDF arenas; mutates the context
    grids and msac state in place."""
    lib = _load()
    if not isinstance(data, bytes):
        raise ValueError("data must be bytes")
    lib.av1_block_mode(
        data, len(data), _msac_state(st),
        _arr(mode_ptrs, np.int64, "mode_ptrs"),
        _arr(blk, np.int32, "blk", (33,)),
        _arr(out, np.int32, "out", (23,)),
        _arr(pal, np.int32, "pal", min_len=36 + 2 * 64 * 64))


def av1_sb_parse(data: bytes, st, ptrs, mode_ptrs, x_ptrs, sbp,
                 ops, coef, tbmeta, pal, io):
    """Whole-superblock AV1 parse (host_av1.c av1_sb_parse): the
    partition walk, per-block mode-info, grid record writes and the
    residual TB walk fused into one C call per superblock.  Mutates
    the CDF arenas, context grids and msac state in place; returns
    via the io record (counts, qindex/delta-lf state, error code).
    The output buffers hold a superblock of ``sbp[2]`` (16 or 32)
    4x4 units a side, as ``TileDecoder._decode_sb_native`` sizes them."""
    lib = _load()
    if not isinstance(data, bytes):
        raise ValueError("data must be bytes")
    sbp_p = _arr(sbp, np.int32, "sbp", (36,))
    sb4 = int(sbp[2])
    if sb4 not in (16, 32):
        raise ValueError(f"superblock of {sb4} units: expected 16 or 32")
    nmax = 3 * sb4 * sb4 + 64
    px = (sb4 * 4) ** 2
    lib.av1_sb_parse(
        data, len(data), _msac_state(st), _arr(ptrs, np.int64, "ptrs"),
        _arr(mode_ptrs, np.int64, "mode_ptrs"),
        _arr(x_ptrs, np.int64, "x_ptrs", (11,)), sbp_p,
        _arr(ops, np.int32, "ops", (-1, _OP_NF), nmax * _OP_NF),
        _arr(coef, np.int32, "coef", min_len=3 * px + 4096),
        _arr(tbmeta, np.int32, "tbmeta", (-1, 9), nmax * 9),
        _arr(pal, np.int32, "pal", min_len=2 * px + 16384),
        _arr(io, np.int32, "io", (13,)))


def av1_color_cicp(planes, h: int, w: int, sx: int, sy: int, bd: int,
                   limited: bool, mode: int,
                   kr: float = 0.0, kb: float = 0.0) -> np.ndarray:
    """CICP YUV -> RGBA uint8 (host_av1.c av1_color_cicp), bit-exact
    vs the numpy float32 oracle in formats/avif.py (_yuv_to_rgba_np):
    integer 3/4-1/4 chroma upsample then float32 matrix with
    floor(x+0.5).  mode: 0=matrix(kr,kb), 1=identity GBR, 2=mono."""
    lib = _load()

    def prep(p):
        if not isinstance(p, np.ndarray) or p.ndim != 2:
            raise ValueError("planes must be 2-D arrays")
        if p.dtype == np.uint8 and p.strides[1] == 1:
            return p, 1
        if p.dtype == np.uint16 and p.strides[1] == 2:
            return p, 2
        return np.ascontiguousarray(p, np.uint16), 2

    Y, ey = prep(planes[0])
    if len(planes) > 1:
        U, eu = prep(planes[1])
        V, ev = prep(planes[2])
        if not (ey == eu == ev):            # mixed dtypes: widen all
            Y = np.ascontiguousarray(Y, np.uint16); ey = 2
            U = np.ascontiguousarray(U, np.uint16)
            V = np.ascontiguousarray(V, np.uint16)
    else:
        U = V = Y
    ch, cw = U.shape
    if Y.shape[0] < h or Y.shape[1] < w or V.shape != U.shape \
            or ch < (h + sy) >> sy or cw < (w + sx) >> sx:
        raise ValueError(f"planes {Y.shape}, {U.shape}, {V.shape} do not "
                         f"cover {h}x{w} at subsampling ({sx}, {sy})")
    out = np.empty((h, w, 4), np.uint8)
    rc = lib.av1_color_cicp(
        Y.ctypes.data, Y.strides[0] // ey, U.ctypes.data,
        U.strides[0] // ey, V.ctypes.data, V.strides[0] // ey, ey,
        h, w, ch, cw, sx, sy, bd, 1 if limited else 0, mode,
        float(kr), float(kb), _p(out))
    if rc != 0:
        raise MemoryError("av1_color_cicp allocation failed")
    return out


def av1_deblock_pass(arr, h: int, w: int, plane: int, pass_: int,
                     prm, txw, txh, bc0, br0, skip, seg, dlf):
    """One AV1 deblock pass (host_av1.c av1_deblock_pass) over an
    int32 plane in place; 1:1 with the numpy/scalar oracles in
    formats/av1_loopfilter.py."""
    lib = _load()
    _i32_plane(arr, "arr")
    if arr.shape != (h, w):
        raise ValueError(f"arr {arr.shape}: expected ({h}, {w})")
    _arr(prm, np.int32, "prm", (81,))
    mi = (int(prm[0]), int(prm[1]))
    lib.av1_deblock_pass(
        _p(arr), h, w, plane, pass_, _p(prm),
        _arr(txw, np.uint8, "txw", mi), _arr(txh, np.uint8, "txh", mi),
        _arr(bc0, np.uint16, "bc0", mi), _arr(br0, np.uint16, "br0", mi),
        _arr(skip, np.uint8, "skip", mi), _arr(seg, np.uint8, "seg", mi),
        _arr(dlf, np.int8, "dlf", (*mi, 4)))


def av1_itx_batch(coeffs, aw: int, ah: int, w: int, h: int,
                  hk: int, vk: int, rect2: bool, row_shift: int,
                  rlo: int, rhi: int, clo: int, chi: int, cos_tab):
    """Lane-major batched AV1 inverse transforms
    (host_av1_itx.c av1_itx_batch): one call per
    (tx_size, tx_type) group, bit-exact with the numpy int32 lane
    path in coding/av1_itx.py (wrap semantics included).  coeffs is
    (B, ah, aw) int32; returns (B, h, w) int32."""
    lib = _load()
    src = _arr(coeffs, np.int32, "coeffs", (-1, ah, aw))
    B = coeffs.shape[0]
    out = np.empty((B, h, w), np.int32)
    rc = lib.av1_itx_batch(src, B, aw, ah, w, h, hk, vk, int(rect2),
                           row_shift, rlo, rhi, clo, chi,
                           _arr(cos_tab, np.int32, "cos_tab", (65,)),
                           _p(out))
    if rc:
        raise MemoryError("av1_itx_batch allocation failed")
    return out


def av1_wht_batch(coeffs):
    """Lossless 4x4 inverse Walsh-Hadamard batch
    (host_av1_itx.c av1_wht_batch): (B, 4, 4) int32 -> same."""
    lib = _load()
    src = _arr(coeffs, np.int32, "coeffs", (-1, 4, 4))
    B = coeffs.shape[0]
    out = np.empty((B, 4, 4), np.int32)
    lib.av1_wht_batch(src, B, _p(out))
    return out
