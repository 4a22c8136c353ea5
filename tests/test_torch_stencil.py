"""Parity of the PyTorch port's B-grid stencils (nextsim_tpu_torch/ops/
stencil.py) with the JAX package's (nextsim_tpu/ops/stencil.py).

Both run op by op on the CPU in float32 from the same numpy inputs. Every
operator is a pad-and-slice shift with the same term order, so they agree
bitwise: eager JAX rounds each elementwise op once, as torch does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextsim_tpu.ops import stencil as jst
from nextsim_tpu_torch.ops import stencil as tst

NY, NX = 13, 21
DX = 10e3


def _planes(seed):
    rng = np.random.default_rng(seed)
    cell = lambda: rng.standard_normal((NY, NX)).astype(np.float32)  # noqa: E731
    node = lambda: rng.standard_normal((NY + 1, NX + 1)).astype(np.float32)  # noqa: E731
    mask = (rng.random((NY, NX)) > 0.2).astype(np.float32)
    return cell, node, mask


CASES = {
    "cell_corners": lambda c, n, m: ((n(),), {}),
    "strain_rates": lambda c, n, m: ((n(), n(), DX), {}),
    "cells_to_node_sum": lambda c, n, m: ((c(),), {}),
    "node_max_of_cells": lambda c, n, m: ((c(),), {}),
    "stress_divergence": lambda c, n, m: ((c(), c(), c(), np.abs(c()) * 1e8, DX), {}),
    "node_grad_scalar": lambda c, n, m: ((c(), n(), DX), {}),
    "neighbor_mean_nodes": lambda c, n, m: ((n(), (n() > 0).astype(np.float32)), {}),
    "cell_mean_of_nodes": lambda c, n, m: ((n(),), {}),
    "node_mean_of_cells": lambda c, n, m: ((c(), m), {}),
    "laplacian_cells": lambda c, n, m: ((c(), m, DX), {}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_stencil_matches_jax_bitwise(name):
    cell, node, mask = _planes(sorted(CASES).index(name))
    args, _ = CASES[name](cell, node, mask)
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    targs = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args]
    ref = getattr(jst, name)(*jargs)
    out = getattr(tst, name)(*targs)
    ref = ref if isinstance(ref, tuple) else (ref,)
    out = out if isinstance(out, tuple) else (out,)
    assert len(ref) == len(out)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_pad1_is_zero_pad():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(tst.pad1(torch.from_numpy(a)).numpy(), np.pad(a, 1))
