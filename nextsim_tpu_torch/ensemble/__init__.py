"""Ensembles: perturbed forcing, the batched ensemble and its driver (the
counterpart of nextsim_tpu/ensemble/)."""

from nextsim_tpu_torch.ensemble.perturbation import (  # noqa: F401
    EnsembleForcing,
    PerturbationParams,
    spectral_noise,
)
