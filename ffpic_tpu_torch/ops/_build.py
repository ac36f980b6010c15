"""Build the CUDA kernels in ``ffpic_tpu_torch/csrc`` at first use.

``nvcc`` compiles every ``.cu`` file for Hopper (``sm_90a``), one
process per file, all started together, and links the objects into one
shared library with a plain C interface, which ``ops.cuda_jpeg`` loads
with ctypes.  The library lands in ``ffpic_tpu_torch/build/``, named by
a hash of the sources (``.cuh`` headers included) and flags (the scheme
of ``ffpic_tpu/native/__init__.py``), so an edited kernel rebuilds and
an unchanged one loads at once.  A failed build raises; nothing falls
back.  The compiler's output (``-Xptxas -v``: registers, spills) is
kept beside the library as ``.log``.  ``python3 -m
ffpic_tpu_torch.time_build`` times this build against one nvcc over
all the files.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (on PATH or under CUDA_HOME): the "
                       "CUDA kernels cannot be built")


def sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _run(cmd: list[str]) -> str:
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"nvcc timed out: {' '.join(cmd)}") from e
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
    return r.stdout + r.stderr


def compile_library(cus: list[str], out: str, extra=()) -> str:
    """Build the ``.cu`` files ``cus`` into the shared library ``out``:
    one nvcc per file, all started together (``extra`` flags after
    FLAGS), then one link.  Returns the compiler's output."""
    objs = [f"{out}.{os.path.basename(s)}.o" for s in cus]
    try:
        with ThreadPoolExecutor(len(cus)) as ex:
            logs = list(ex.map(_run, [[_nvcc(), *FLAGS, *extra, "-c", "-o",
                                       o, s] for s, o in zip(cus, objs)]))
        logs.append(_run([_nvcc(), *ARCH, "-shared", "-o", out, *objs]))
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    return "".join(logs)


def build_variants(source: str, constants: tuple, variants, out: str) -> dict:
    """{variant: (library, compiler output)}: ``csrc/<source>`` built once
    per variant, a tuple of values for the ``constexpr int`` named by
    ``constants``, each a copy of the source with those values in
    ``out``, all nvcc runs started together (the tune scripts)."""
    with open(os.path.join(CSRC, source)) as f:
        src = f.read()
    stem = os.path.splitext(source)[0]
    sos = {}
    for v in variants:
        text = src
        for name, value in zip(constants, v):
            text, n = re.subn(rf"constexpr int {name} = \d+;",
                              f"constexpr int {name} = {value};", text)
            if n != 1:
                raise RuntimeError(f"{source} defines {name} {n} times")
        cu = os.path.join(out, f"{stem}_{'_'.join(map(str, v))}.cu")
        with open(cu, "w") as f:
            f.write(text)
        sos[v] = (cu, cu[:-3] + ".so")
    with ThreadPoolExecutor(len(sos)) as ex:
        logs = list(ex.map(lambda v: compile_library([sos[v][0]], sos[v][1]),
                           sos))
    return {v: (ctypes.CDLL(sos[v][1]), log) for v, log in zip(sos, logs)}


@contextlib.contextmanager
def launching_from(module, lib):
    """``module``'s wrappers (its ``_launch`` over its ``_SIGNATURES``)
    launch from the library ``lib`` meanwhile, counted apart from
    ``module.launches``."""
    saved = module._launch
    module._launch = launcher(module._SIGNATURES, dict(module.launches),
                              library=lambda: lib)
    try:
        yield
    finally:
        module._launch = saved


def library_path() -> str:
    """Path of the built library, compiling it first if needed."""
    srcs = sources()
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD, f"libffpic_cuda_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    log = compile_library([s for s in srcs if s.endswith(".cu")], tmp)
    with open(so[:-3] + ".log", "w") as f:
        f.write(log)
    os.replace(tmp, so)        # atomic: a concurrent loader sees all or none
    return so


def load() -> ctypes.CDLL:
    """The kernel library, built and loaded once per process."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(library_path())
        return _lib


def launcher(signatures: dict, launches: dict, library=load):
    """``launch(name, counter, *args)``: call the C entry ``name`` of
    ``library()``, the kernel library unless given (argument types from
    ``signatures``, the current CUDA stream appended), raise if it
    returns an error, else add one to ``launches[counter]`` (under a
    lock: ``decode_batch`` may launch from several threads)."""
    import torch
    count_lock = threading.Lock()

    def launch(name: str, counter: str, *args) -> None:
        fn = getattr(library(), name)
        fn.argtypes = signatures[name]
        fn.restype = ctypes.c_int
        rc = fn(*args,
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
        with count_lock:
            launches[counter] += 1
    return launch
