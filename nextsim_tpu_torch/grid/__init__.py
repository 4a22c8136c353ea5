from nextsim_tpu_torch.grid.grid import Grid  # noqa: F401
from nextsim_tpu_torch.grid.projection import PolarStereo  # noqa: F401
