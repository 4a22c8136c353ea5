"""``jnp.maximum``, ``jnp.minimum`` and ``jnp.clip`` against a bound, with
JAX's gradient at a tie; ``scalar`` for the math of a parameter that may be
a tensor.

``torch.clamp(x, min=c)`` and ``jnp.maximum(x, c)`` agree in value, but not
in reverse mode where ``x == c`` exactly: clamp passes the whole gradient to
``x``, ``jnp.maximum`` (and ``torch.maximum``) half of it. Such ties are
ordinary in the model (ice-free cells at exactly 0, a calm wind), so the
port writes every bound that the JAX package writes with ``jnp.maximum``,
``jnp.minimum`` or ``jnp.clip`` with these helpers.

When no gradient is recorded for ``x`` they are ``torch.clamp``: the same
values and the same single launch as before. When one is, they take
``torch.maximum`` / ``torch.minimum`` against the bound as a 0-dim tensor
(made on ``x``'s device, with no copy from the host), whose gradient splits
at a tie as JAX's does. A bound that is itself a tensor always takes
``torch.maximum`` / ``torch.minimum``, so a parameter that requires grad
keeps its gradient.
"""

from __future__ import annotations

import math

import torch


def _recording(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _bound(x, c):
    return c if isinstance(c, torch.Tensor) else x.new_full((), c)


def maximum(x: torch.Tensor, c) -> torch.Tensor:
    """``jnp.maximum(x, c)``."""
    if isinstance(c, torch.Tensor) or _recording(x):
        return torch.maximum(x, _bound(x, c))
    return torch.clamp(x, min=c)


def minimum(x: torch.Tensor, c) -> torch.Tensor:
    """``jnp.minimum(x, c)``."""
    if isinstance(c, torch.Tensor) or _recording(x):
        return torch.minimum(x, _bound(x, c))
    return torch.clamp(x, max=c)


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``: ``minimum(maximum(x, lo), hi)``."""
    if isinstance(lo, torch.Tensor) or isinstance(hi, torch.Tensor) or _recording(x):
        return minimum(maximum(x, lo), hi)
    return torch.clamp(x, lo, hi)


def scalar(name: str, x):
    """``math.<name>(x)`` for a number; ``torch.<name>(x)`` for a tensor, a
    parameter that a caller differentiates (``math`` would read it as a float
    and cut its gradient without a word)."""
    return getattr(torch if isinstance(x, torch.Tensor) else math, name)(x)
