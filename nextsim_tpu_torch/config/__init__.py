from nextsim_tpu_torch.config.schema import Config, OPTIONS  # noqa: F401
