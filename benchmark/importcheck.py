"""The check that nothing the benchmark runs loads JAX or the JAX package:
every loaded module's top-level name (the part before the first dot) is
compared whole, so ``nextsim_tpu_torch`` is not ``nextsim_tpu``."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "nextsim_tpu")


def forbidden(names=FORBIDDEN, modules=None) -> list:
    """The loaded modules whose top-level name is one of ``names``."""
    loaded = sys.modules if modules is None else modules
    return sorted(m for m in loaded if m.split(".")[0] in names)
