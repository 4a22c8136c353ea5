from nextsim_tpu_torch.forcing.base import Forcing  # noqa: F401
