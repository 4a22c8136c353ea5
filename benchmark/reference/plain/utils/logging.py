"""Leveled logger (the counterpart of nextsim_tpu/utils/logging.py).

Mirrors the reference's 5-level LOG macro (reference: core/include/debug.hpp:
66-68), which logs to stderr on MPI rank 0 unless debugging.log-all is set.
The port runs one process until the multi-device slice (ROADMAP A.14), so
every run is rank 0.
"""

from __future__ import annotations

import logging as _pylogging
import sys

LEVELS = {
    "error": _pylogging.ERROR,
    "warning": _pylogging.WARNING,
    "info": _pylogging.INFO,
    "verbose": _pylogging.DEBUG,  # reference 'verbose' maps onto DEBUG-5
    "debug": _pylogging.DEBUG,
}

_logger = None


def get_logger(level: str | None = None, log_all: bool = False) -> _pylogging.Logger:
    """Return the shared logger. The handler is installed once; an explicit
    ``level`` re-applies on every call so a Simulator built with
    debugging.log-level=debug lowers the level even if the logger was first
    created at info by an earlier run in the same process."""
    global _logger
    if _logger is None:
        logger = _pylogging.getLogger("nextsim_tpu")
        handler = _pylogging.StreamHandler(sys.stderr)
        handler.setFormatter(
            _pylogging.Formatter("[%(asctime)s] %(levelname)s %(message)s", "%H:%M:%S")
        )
        logger.addHandler(handler)
        logger.setLevel(_pylogging.INFO)
        _logger = logger
    if level is not None:
        _logger.setLevel(LEVELS.get(level, _pylogging.INFO))
    return _logger
