"""``jnp.maximum``, ``jnp.minimum`` and ``jnp.clip`` against a bound, with
JAX's gradient at a tie; ``scalar`` for the math of a parameter that may be
a tensor; ``pow`` and ``atan2``, whose bits do not depend on where an
element sits in its tensor.

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


#: elements of a CPU ``pow`` call that PyTorch runs on one thread
#: (``at::internal::GRAIN_SIZE``)
_ONE_THREAD = 32768
#: a multiple of the elements one pass of PyTorch's vectorized CPU loop takes
#: (two vectors): two AVX-512 vectors of 32 bfloat16 lanes, four of 16 floats
_LANES = 64


def _elementwise(fn, x: torch.Tensor, y) -> torch.Tensor:
    """``fn(x, y)`` for a tensor ``x`` and a tensor or number ``y``, with the
    bits of every element taken by the CPU's vectorized loop (``pow``)."""
    if x.device.type != "cpu":
        return fn(x, y)
    shape = torch.broadcast_shapes(x.shape, y.shape) if isinstance(y, torch.Tensor) else x.shape
    n = math.prod(shape)
    pad = -n % _LANES

    def flat(t):
        return torch.cat([t.expand(shape).reshape(-1), t.new_ones(pad)])

    xs = flat(x).split(_ONE_THREAD)
    ys = flat(y).split(_ONE_THREAD) if isinstance(y, torch.Tensor) else [y] * len(xs)
    return torch.cat([fn(a, b) for a, b in zip(xs, ys)])[:n].view(shape)


def pow(x: torch.Tensor, e) -> torch.Tensor:
    """``x ** e`` for a float or tensor exponent ``e``, with bits that depend
    on the element alone.

    On the CPU, PyTorch's vectorized ``pow`` rounds otherwise than its scalar
    loop, which takes the elements left over at the end of each thread's
    chunk: a tensor and a block cut out of it would differ in the last bit
    here and there, and so would a run on a device mesh and one on a single
    device. So the flattened elements are padded with ones to whole vectors
    and taken in calls small enough for one thread: every element goes
    through the vectorized loop. On a CUDA device every element takes the
    same path, and ``torch.pow`` is used as it is."""
    return _elementwise(torch.pow, x, e)


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``torch.atan2(y, x)`` with bits that depend on the element alone: the
    CPU's vectorized ``atan2`` rounds otherwise than its scalar loop, as
    ``pow``'s does, and is taken the same way."""
    return _elementwise(torch.atan2, y, x)
