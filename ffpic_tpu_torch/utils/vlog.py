"""Named-module logging registry.

Copied from ``ffpic_tpu/utils/vlog.py`` (``get_logger``, ``set_level``,
``redirect``): per-module named loggers under ``ffpic.<name>`` with
independently settable levels, a global default from the ``FFPIC_LOG``
environment variable (e.g. ``FFPIC_LOG=debug`` or
``FFPIC_LOG=webp:debug,vp8:warn``), and an optional stream redirect.
"""

from __future__ import annotations

import logging
import os
import sys

_LEVELS = {
    "emerg": logging.CRITICAL,
    "alert": logging.CRITICAL,
    "crit": logging.CRITICAL,
    "err": logging.ERROR,
    "error": logging.ERROR,
    "warning": logging.WARNING,
    "warn": logging.WARNING,
    "notice": logging.INFO,
    "info": logging.INFO,
    "debug": logging.DEBUG,
}

_registry: dict[str, logging.Logger] = {}
_handler: logging.Handler | None = None


def _parse_env() -> tuple[int, dict[str, int]]:
    spec = os.environ.get("FFPIC_LOG", "")
    default = logging.WARNING
    per_module: dict[str, int] = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        if ":" in part:
            name, lvl = part.split(":", 1)
            per_module[name] = _LEVELS.get(lvl.lower(), logging.WARNING)
        else:
            default = _LEVELS.get(part.lower(), logging.WARNING)
    return default, per_module


def get_logger(name: str) -> logging.Logger:
    """Register (or fetch) the named module logger."""
    global _handler
    if name in _registry:
        return _registry[name]
    logger = logging.getLogger(f"ffpic.{name}")
    default, per_module = _parse_env()
    logger.setLevel(per_module.get(name, default))
    if _handler is None:
        _handler = logging.StreamHandler(sys.stderr)
        _handler.setFormatter(
            logging.Formatter("[%(name)s] %(levelname)s: %(message)s")
        )
        logging.getLogger("ffpic").addHandler(_handler)
        logging.getLogger("ffpic").propagate = False
    _registry[name] = logger
    return logger


def set_level(name: str, level: str) -> None:
    get_logger(name).setLevel(_LEVELS[level.lower()])


def redirect(stream) -> None:
    """Redirect all ffpic logging to the given stream."""
    global _handler
    root = logging.getLogger("ffpic")
    if _handler is not None:
        root.removeHandler(_handler)
    _handler = logging.StreamHandler(stream)
    _handler.setFormatter(logging.Formatter("[%(name)s] %(levelname)s: %(message)s"))
    root.addHandler(_handler)
