"""nextsim_tpu_torch — the PyTorch/CUDA port of nextsim_tpu.

The same sea-ice model as the JAX package ``nextsim_tpu`` (BBM / (m)EVP
dynamics on a structured B-grid, Eulerian transport and ridging), written
for PyTorch and an NVIDIA Hopper GPU. The module layout mirrors the JAX
package one for one (``nextsim_tpu_torch/ops/momentum.py`` is the
counterpart of ``nextsim_tpu/ops/momentum.py``); the blocked Pallas substep
kernel becomes the hand-written CUDA kernel in ``csrc/momentum_substep.cu``.

This package imports ``torch`` and never ``jax``: the host-only modules it
shares with the JAX package (config schema, grid, constants, dates) are
carried as copies, pinned to their originals by the tests.
"""

__version__ = "0.1.0"

from nextsim_tpu_torch.config.schema import Config  # noqa: F401
from nextsim_tpu_torch.core.state import State, state_from_numpy, state_to_numpy  # noqa: F401
from nextsim_tpu_torch.grid.grid import Grid  # noqa: F401
from nextsim_tpu_torch.model.simulator import Simulator  # noqa: F401
