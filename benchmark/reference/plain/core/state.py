"""The model state as frozen dataclasses of tensors.

``State`` carries every prognostic field of the reference's variable set
(reference: model/model_variable.hpp:51-90) on the structured grid, with the
same field names as ``nextsim_tpu.core.state.State``: cell-centered tracers
(ny, nx), stacked multi-layer fields (3, ny, nx) and node-staggered velocity
(ny+1, nx+1). ``Diag`` carries the D_* diagnostic fields (reference:
model/model_variable.hpp:91-134).

Both are immutable: a step builds a new ``State`` with ``replace``, as the
JAX package does.

A batched ensemble keeps its members on a leading axis at rest (``(N, ny,
nx)``, ``(N, 3, ny, nx)``: the JAX package's layout, which its checkpoint
and statistics read). Its step carries the member axis just before the
plane's two axes instead (``member_minor``: ``(N, ny, nx)``, ``(3, N, ny,
nx)``, ``(nbins, N, ny, nx)``), so that the operators, written for planes
with any leading axes, index a component as ``tice[0]`` and stack one as
``torch.stack([...])`` exactly as for one state; ``member_first`` converts
back. ``state_from_numpy`` / ``state_to_numpy`` move a state
across the framework boundary as a dict of numpy arrays. numpy has no
bfloat16: a bfloat16 plane goes to the host as float32 (exact), and to the
files the JAX package writes raw as ``|V2`` records (``bf16_records``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class State:
    # --- cell tracers (ny, nx) -------------------------------------------
    conc: Any  # ice concentration of thick ("old") ice [0..1]
    thick: Any  # ice volume per cell area (effective thickness) [m]
    snow_thick: Any  # snow volume per cell area [m]
    damage: Any  # BBM damage [0..1]
    ridge_ratio: Any  # ridged-ice volume fraction [0..1]
    tice: Any  # (3, ny, nx) ice temperatures: surface, mid (Winton T1), bottom (T2) [C]
    sigma: Any  # (3, ny, nx) stress components sxx, syy, sxy [Pa]
    sst: Any  # slab-ocean temperature [C]
    sss: Any  # slab-ocean salinity [g/kg]
    tsurf_young: Any  # young-ice surface temperature [C]
    h_young: Any  # young-ice volume per cell area [m]
    hs_young: Any  # young-ice snow volume [m]
    conc_young: Any  # young-ice concentration [0..1]
    random_number: Any  # per-cell uniform random for cohesion
    fyi_fraction: Any  # first-year-ice fraction
    age_det: Any  # observable (detectable) ice age [s]
    age: Any  # volume-weighted ice age [s]
    conc_upd: Any  # concentration update from assimilation
    conc_myi: Any  # multiyear-ice concentration
    thick_myi: Any  # multiyear-ice volume
    conc_summer: Any  # summer-minimum concentration tracker
    thick_summer: Any  # summer-minimum volume tracker
    freeze_days: Any  # consecutive freezing days counter
    freeze_onset: Any  # freeze-onset flag (0/1)
    del_vi_tend: Any  # daily ice-volume tendency accumulator [m]
    pond_volume: Any  # melt pond volume [m water]
    lid_volume: Any  # melt pond lid volume [m water]
    drag_ui: Any  # ice-atmosphere momentum drag coef (stability-adjusted)
    drag_ti: Any  # ice-atmosphere thermo drag coef
    drag_ui_young: Any
    drag_ti_young: Any
    time_relaxation_damage: Any  # damage healing time [s]
    # --- node fields (ny+1, nx+1) ----------------------------------------
    vt_u: Any  # ice velocity x [m/s]
    vt_v: Any  # ice velocity y [m/s]
    ut_u: Any  # time-integrated velocity x [m]
    ut_v: Any
    # --- optional FSD bins (None unless wave_coupling.num_fsd_bins > 0) ---
    conc_fsd: Any = None  # (nbins, ny, nx) area-based FSD
    conc_mech_fsd: Any = None  # mechanical FSD (distinguish_mech_fsd)

    @staticmethod
    def zeros(grid, dtype=torch.float32, cfg=None, *, device) -> "State":
        ny, nx = grid.shape
        kw = dict(dtype=dtype, device=device)
        cell = lambda: torch.zeros((ny, nx), **kw)  # noqa: E731
        node = lambda: torch.zeros((ny + 1, nx + 1), **kw)  # noqa: E731
        full = lambda shape, v: torch.full(shape, v, **kw)  # noqa: E731
        quad_drag_coef_air = 0.0020 if cfg is None else _quad_drag_air(cfg)
        drag_ice_t = 1.3e-3 if cfg is None else cfg["thermo.drag_ice_t"]
        t_relax = 25.0 * 86400.0 if cfg is None else cfg["dynamics.time_relaxation_damage"] * 86400.0
        mu = 0.055 if cfg is None else cfg["thermo.freezingpoint_mu"]
        tfr_ice = -mu * 5.0  # freezing point of ice (si=5 g/kg)
        return State(
            conc=cell(), thick=cell(), snow_thick=cell(),
            damage=cell(), ridge_ratio=cell(),
            tice=full((3, ny, nx), tfr_ice),
            sigma=torch.zeros((3, ny, nx), **kw),
            sst=cell() - 1.8, sss=cell() + 32.0,
            tsurf_young=full((ny, nx), tfr_ice),
            h_young=cell(), hs_young=cell(), conc_young=cell(),
            random_number=cell(),
            fyi_fraction=cell(), age_det=cell(), age=cell(), conc_upd=cell(),
            conc_myi=cell(), thick_myi=cell(), conc_summer=cell(), thick_summer=cell(),
            freeze_days=cell(), freeze_onset=cell(), del_vi_tend=cell(),
            pond_volume=cell(), lid_volume=cell(),
            drag_ui=full((ny, nx), quad_drag_coef_air),
            drag_ti=full((ny, nx), drag_ice_t),
            drag_ui_young=full((ny, nx), quad_drag_coef_air),
            drag_ti_young=full((ny, nx), drag_ice_t),
            time_relaxation_damage=full((ny, nx), t_relax),
            vt_u=node(), vt_v=node(), ut_u=node(), ut_v=node(),
        )

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Diag:
    """Per-step diagnostic fields (reference D_* variables)."""

    # nodal
    tau_ax: Any  # atmosphere->ice stress x at nodes [N/m2]
    tau_ay: Any
    tau_wx: Any  # ice->ocean stress x at nodes [N/m2]
    tau_wy: Any
    # cell
    tau_ow: Any  # open-water atm drag bulk coefficient
    qa: Any; qsw: Any; qlw: Any; qsh: Any; qlh: Any  # noqa: E702
    qo: Any; qnosun: Any; qsw_ocean: Any; qassim: Any  # noqa: E702
    dels: Any; fwflux: Any; fwflux_ice: Any; brine: Any  # noqa: E702
    evap: Any; rain: Any  # noqa: E702
    vice_melt: Any; del_vi_young: Any; del_hi: Any; del_hi_young: Any  # noqa: E702
    newice: Any; mlt_top: Any; mlt_bot: Any; snow2ice: Any  # noqa: E702
    albedo: Any; sialb: Any; pond_fraction: Any  # noqa: E702
    divergence: Any
    del_ci_ridge_myi: Any; del_vi_mlt_myi: Any; del_ci_mlt_myi: Any  # noqa: E702
    del_vi_rplnt_myi: Any; del_ci_rplnt_myi: Any  # noqa: E702

    def replace(self, **kw) -> "Diag":
        return dataclasses.replace(self, **kw)


def _quad_drag_air(cfg) -> float:
    """Atmosphere quadratic drag coefficient by forcing source (reference:
    model/finiteelement.cpp:1094-1160 selects per atmosphere-type)."""
    atm = cfg["setup.atmosphere-type"]
    table = {
        "asr": cfg["dynamics.ASR_quad_drag_coef_air"],
        "era5": cfg["dynamics.ERA5_quad_drag_coef_air"],
        "generic_ps": cfg["dynamics.ERA5_quad_drag_coef_air"],
        "cfsr": cfg["dynamics.CFSR_quad_drag_coef_air"],
        "cfsr_hi": cfg["dynamics.CFSR_quad_drag_coef_air"],
        "ecmwf_nrt": cfg["dynamics.ECMWF_quad_drag_coef_air"],
        "ecmwf_nrt_arome": cfg["dynamics.ECMWF_quad_drag_coef_air"],
        "ecmwf_nrt_arome_ensemble": cfg["dynamics.ECMWF_quad_drag_coef_air"],
        # CONSTANT uses the ASR coefficient (reference: finiteelement.cpp:1286)
        "constant": cfg["dynamics.ASR_quad_drag_coef_air"],
    }
    return table.get(atm, cfg["dynamics.ECMWF_quad_drag_coef_air"])


def member_minor(states: State) -> State:
    """A member-first stack (every field ``(N, ...)``) with the member axis
    moved just before the plane's two axes, contiguous: a plane stays ``(N,
    ny, nx)``, a stacked field ``(N, c, ny, nx)`` becomes ``(c, N, ny,
    nx)``."""
    return _move_members(states, 0, -3)


def member_first(states: State) -> State:
    """The inverse of ``member_minor``."""
    return _move_members(states, -3, 0)


def _move_members(states: State, src: int, dst: int) -> State:
    return states.replace(**{f.name: getattr(states, f.name).movedim(src, dst).contiguous()
                             for f in dataclasses.fields(states)
                             if getattr(states, f.name) is not None and getattr(states, f.name).ndim > 3})


def state_from_numpy(
    arrays: Dict[str, np.ndarray], device="cuda", dtype: Optional[torch.dtype] = None
) -> State:
    """Build a ``State`` from a dict of numpy arrays keyed by field name
    (e.g. a JAX ``State`` converted leaf by leaf). Fields that are absent or
    None stay None; ``dtype`` (default: each array's own) casts every leaf."""
    kw = {}
    for f in dataclasses.fields(State):
        a = arrays.get(f.name)
        if a is not None:
            t = host_tensor(a)  # a copy: the state owns its planes
            a = t.to(device=device, dtype=dtype or t.dtype).contiguous()
        kw[f.name] = a
    return State(**kw)


def host_array(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy of the tensor ``t``. numpy has no bfloat16: a
    bfloat16 tensor comes as float32, which holds each of its values
    exactly."""
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def bf16_records(a) -> np.ndarray:
    """``a`` (a tensor, or a float32 array of bfloat16 numbers) as the raw
    ``|V2`` records numpy writes for a JAX bfloat16 array: its bfloat16 bits
    (round to nearest even, exact for bfloat16 numbers), two bytes each.
    The JAX package's bfloat16 restarts and snapshots hold them."""
    t = a.detach().cpu() if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view("V2")


def file_arrays(arrays: dict, dtype: torch.dtype) -> dict:
    """Host ``arrays`` of a run in ``dtype`` as the JAX package's npz files
    hold them: in a bfloat16 run every float32 array (a bfloat16 plane on
    the host) becomes its ``|V2`` records; anything else is unchanged."""
    if dtype != torch.bfloat16:
        return arrays
    return {k: bf16_records(v) if isinstance(v, np.ndarray) and v.dtype == np.float32 else v
            for k, v in arrays.items()}


def host_tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor of the host array ``a`` (a copy); ``|V2`` records (see
    ``bf16_records``) come back as bfloat16, bitwise."""
    a = np.array(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_host(tree):
    """A host-numpy copy of every tensor in ``tree``: a tensor, a dataclass
    (``State``, ``Forcing``), a dict or a tuple of them; None and non-tensor
    leaves pass through. A bfloat16 tensor comes as float32 (``host_array``)."""
    if isinstance(tree, torch.Tensor):
        return host_array(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: to_host(getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_host(v) for v in tree)
    return tree


def state_to_numpy(state: State) -> Dict[str, np.ndarray]:
    """The inverse of ``state_from_numpy``: every non-None field as a host
    numpy array."""
    return {
        f.name: host_array(getattr(state, f.name))
        for f in dataclasses.fields(State)
        if getattr(state, f.name) is not None
    }
