"""Model state initialisation (the counterpart of
nextsim_tpu/model/init_state.py).

The idealised schemes of the reference's initIce family (constantIce,
reference: model/finiteelement.cpp:11662-11753, for ``constant`` and
``constant_partial``), the constant slab ocean (initSlabOcean,
fe.cpp:11307-11351) and checkConsistency (fe.cpp:11515-11634). The
dataset-driven ice schemes are not ported yet and raise.

The per-cell random field of the cohesion comes from a ``torch.Generator``,
which cannot reproduce ``jax.random.uniform``; pass ``random_number`` to start
from a given field (e.g. the JAX package's).
"""

from __future__ import annotations

import numpy as np
import torch

from nextsim_tpu_torch.core import constants as phys
from nextsim_tpu_torch.core.state import State


def freezing_point(cfg, sss):
    """Freezing point of sea water (reference: fe.cpp freezingPoint)."""
    if cfg["thermo.freezingpoint-type"] == "unesco":
        return (-0.0575 + 1.710523e-3 * torch.sqrt(sss) - 2.154996e-4 * sss) * sss
    return -cfg["thermo.freezingpoint_mu"] * sss


def init_state(cfg, grid, dtype=torch.float32, device="cpu", seed: int = 7,
               random_number=None) -> State:
    state = State.zeros(grid, dtype=dtype, cfg=cfg, device=device)
    mask = torch.as_tensor(grid.mask, dtype=dtype, device=device)

    state = _init_slab_ocean(cfg, grid, state)
    state = _init_ice(cfg, grid, state, mask)

    # per-cell uniform random for the cohesion alea (reference:
    # fe.cpp:11459-11475 - uniform_01 on root, broadcast)
    if random_number is None:
        gen = torch.Generator().manual_seed(seed)
        rnd = torch.rand(grid.shape, generator=gen, dtype=dtype)
    else:
        rnd = torch.tensor(np.asarray(random_number), dtype=dtype)  # a copy
        if tuple(rnd.shape) != grid.shape:
            raise ValueError(f"random_number is {tuple(rnd.shape)}; the grid is {grid.shape}")
    state = state.replace(random_number=rnd.to(device))

    return check_consistency(cfg, state, mask)


def _init_slab_ocean(cfg, grid, state) -> State:
    ocean_type = cfg["setup.ocean-type"]
    if ocean_type != "constant":
        raise NotImplementedError(
            f"setup.ocean-type={ocean_type!r} initialises from the ocean "
            "datasets, which the PyTorch port has not ported yet (ROADMAP A.9)"
        )
    # (reference: fe.cpp:11312-11315)
    mu = cfg["thermo.freezingpoint_mu"]
    return state.replace(
        sst=torch.full_like(state.sst, 1.0), sss=torch.full_like(state.sss, 1.8 / mu)
    )


def _init_ice(cfg, grid, state, mask) -> State:
    ice_type = cfg["setup.ice-type"]
    if ice_type in ("constant", "constant_partial"):
        return _constant_ice(cfg, grid, state, mask, partial=ice_type == "constant_partial")
    raise NotImplementedError(
        f"setup.ice-type={ice_type!r} initialises from the ice datasets, which "
        "the PyTorch port has not ported yet (ROADMAP A.9); use constant or "
        "constant_partial"
    )


def _constant_ice(cfg, grid, state, mask, partial: bool) -> State:
    """(reference: constantIce, fe.cpp:11662-11753)"""
    c_const = cfg["ideal_simul.init_concentration"]
    h_const = cfg["ideal_simul.init_thickness"]
    hs_const = cfg["ideal_simul.init_snow_thickness"]

    conc = torch.full_like(state.conc, c_const)
    thick = torch.full_like(state.conc, c_const * h_const)  # ice volume
    snow = torch.full_like(state.conc, hs_const)

    conc_young = torch.zeros_like(conc)
    h_young = torch.zeros_like(conc)
    hs_young = torch.zeros_like(conc)

    use_young = cfg["thermo.newice_type"] == 4
    if cfg["thermo.use_thermo_forcing"]:
        sst_limit = cfg["ideal_simul.init_SST_limit"]
        warm = state.sst > freezing_point(cfg, state.sss) + sst_limit
    else:
        warm = torch.zeros_like(conc, dtype=torch.bool)
    conc = torch.where(warm, 0.0, conc)
    thick = torch.where(warm, 0.0, thick)
    snow = torch.where(warm, 0.0, snow)

    if use_young:
        yc = cfg["ideal_simul.init_young_conc"]
        h_young_min = cfg["thermo.h_young_min"]
        h_young_max = cfg["thermo.h_young_max"]
        conc_young = torch.where(torch.logical_not(warm), yc, 0.0).to(conc.dtype)
        h_young = (h_young_min + 0.5 * (h_young_max - h_young_min)) * conc_young
        hs_young = hs_const * conc_young

    if partial:
        # no ice for x < xmin + 0.3*(xmax-xmin) (fe.cpp:11707-11744)
        x, _ = grid.cell_xy()
        nodes_x, _ = grid.node_xy()
        xmin, xmax = float(nodes_x.min()), float(nodes_x.max())
        bare = torch.as_tensor(x < xmin + 0.3 * (xmax - xmin), device=conc.device)
        conc = torch.where(bare, 0.0, conc)
        thick = torch.where(bare, 0.0, thick)
        snow = torch.where(bare, 0.0, snow)

    return state.replace(
        conc=conc * mask,
        thick=thick * mask,
        snow_thick=snow * mask,
        conc_young=conc_young * mask,
        h_young=h_young * mask,
        hs_young=hs_young * mask,
        damage=torch.zeros_like(conc),
        ridge_ratio=torch.zeros_like(conc),
    )


def check_consistency(cfg, state, mask) -> State:
    """Bounds enforcement after init (reference: checkConsistency,
    fe.cpp:11515-11634): clamp conc/vols, zero ice where conc < cmin, set
    ice temperatures consistent with the freezing point."""
    mu = cfg["thermo.freezingpoint_mu"]
    tfr_ice = -mu * phys.si

    conc = torch.clamp(state.conc, 0.0, 1.0) * mask
    thick = torch.clamp(state.thick, min=0.0) * mask
    snow = torch.clamp(state.snow_thick, min=0.0) * mask
    no_ice = (conc < phys.cmin) | (thick <= 0.0)
    conc = torch.where(no_ice, 0.0, conc)
    thick = torch.where(no_ice, 0.0, thick)
    snow = torch.where(no_ice, 0.0, snow)

    tice = torch.clamp(state.tice, max=tfr_ice)  # not warmer than the melting point

    return state.replace(conc=conc, thick=thick, snow_thick=snow, tice=tice)
