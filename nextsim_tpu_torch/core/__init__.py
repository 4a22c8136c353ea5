from nextsim_tpu_torch.core.state import State, Diag  # noqa: F401
