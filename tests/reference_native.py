"""Ready the JAX package's process-wide state once per test process,
before any test runs: its native host library loaded, its codec
registry filled.

Every test module of the port imports this at its top, and pytest-xdist
has every worker collect every module before it runs a test, so each
worker does this while it collects.  Two races in the reference
(``ROADMAP.md`` Queue 3) are then out of the tests' way; the reference
itself is not changed:

* ``ffpic_tpu.native._build`` takes the library's path as a finished
  library as soon as the file exists, though the linker of a concurrent
  build has only just created it (a library of 0 bytes then fails to
  load), and ``_load`` marks itself tried before it builds, so a process
  that fails once, or first asks while ``FFPIC_NO_NATIVE`` is set, runs
  without the library for good.  Here one process at a time asks, under
  an exclusive ``flock`` on a file in the temporary directory: the
  first builds while the others wait, and they load a finished file.
* ``ffpic_tpu.formats.registry._ensure_init`` marks the list as filled
  before it fills it, so a thread of ``decode_batch``'s pool can find
  no codec.  Here the list is filled before any pool starts.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import tempfile

import ffpic_tpu
from ffpic_tpu import native

LOCK = os.path.join(tempfile.gettempdir(), "ffpic_tpu_native_build.lock")


def _retry() -> None:
    """One more load after a failed one: a library file that does not
    load (a build cut off before it wrote the file) is removed first, so
    the loader builds it anew.  A build that fails is left to
    ``tests/test_native_build.py`` to report."""
    try:
        so = native._build()
        if so is not None:
            try:
                ctypes.CDLL(so)
            except OSError:
                os.remove(so)
    except (OSError, RuntimeError):
        return
    native._tried = False
    native.available()


def ready() -> bool:
    """Load the reference's native library (building it under the lock if
    need be) and fill its codec registry.  True when the library is
    loaded."""
    with open(LOCK, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            if not native.available() \
                    and not os.environ.get("FFPIC_NO_NATIVE"):
                _retry()
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
    ffpic_tpu.registered_codecs()
    return native.available()


LOADED = ready()
