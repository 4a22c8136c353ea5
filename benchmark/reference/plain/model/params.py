"""Build static parameter objects from the config (the counterpart of
nextsim_tpu/model/params.py).

Mirrors initOptAndParam (reference: model/finiteelement.cpp:1047-1491) plus
the post-mesh cohesion scaling (reference: fe.cpp:6993-7000):

    scale_coef = sqrt(0.1 / dx)          # lab scale 0.1 m vs mesh resolution
    C_fix      = C_lab * scale_coef
    C_alea     = alea_factor * C_fix
    compr_strength *= scale_coef

The JAX package's TPU substep-loop options (``tpu.substep_kernel``,
``tpu.substep_unroll``, ``tpu.pallas_*``) select and tune its XLA and Pallas
loops; the port has one substep loop, the CUDA kernel, and reads none of
them.
"""

from __future__ import annotations

import math

from benchmark.reference.plain.core.state import _quad_drag_air
from benchmark.reference.plain.ops.momentum import DynParams
from benchmark.reference.plain.ops.rheology import BBMParams, EVPParams


def scale_coef(dx: float) -> float:
    return math.sqrt(0.1 / dx)


def cohesion_params(cfg, dx: float):
    """Returns (C_fix, C_alea) in Pa."""
    sc = scale_coef(dx)
    c_fix = cfg["dynamics.C_lab"] * sc
    c_alea = cfg["dynamics.alea_factor"] * c_fix
    return c_fix, c_alea


def dyn_params(cfg, dx: float) -> DynParams:
    sc = scale_coef(dx)
    bbm = BBMParams(
        young=cfg["dynamics.young"],
        nu0=cfg["dynamics.nu0"],
        compaction_param=cfg["dynamics.compaction_param"],
        compr_strength=cfg["dynamics.compr_strength"] * sc,
        tan_phi=cfg["dynamics.tan_phi"],
        compression_factor=cfg["dynamics.compression_factor"],
        exponent_compression_factor=cfg["dynamics.exponent_compression_factor"],
        undamaged_time_relaxation_sigma=cfg["dynamics.undamaged_time_relaxation_sigma"],
        exponent_relaxation_sigma=cfg["dynamics.exponent_relaxation_sigma"],
    )
    evp = EVPParams(
        e=cfg["dynamics.evp.e"],
        Pstar=cfg["dynamics.evp.Pstar"],
        C=cfg["dynamics.evp.C"],
        delta_min=cfg["dynamics.evp.dmin"],
    )
    # coupled ocean: no turning angle (reference: fe.cpp:1171-1175)
    turning = (
        0.0 if cfg["setup.ocean-type"] == "coupled" else cfg["dynamics.oceanic_turning_angle"]
    )
    return DynParams(
        dynamics_type=cfg["setup.dynamics-type"],
        substeps=cfg["dynamics.substeps"],
        min_h=cfg["dynamics.min_h"],
        quad_drag_coef_water=cfg["dynamics.quad_drag_coef_water"],
        lin_drag_coef_water=cfg["dynamics.lin_drag_coef_water"],
        quad_drag_coef_air=_quad_drag_air(cfg),
        lin_drag_coef_air=cfg["dynamics.lin_drag_coef_air"],
        ocean_turning_angle_deg=turning,
        use_coriolis=cfg["dynamics.use_coriolis"],
        basal_stress=cfg["setup.basal_stress-type"],
        k1=cfg["dynamics.Lemieux_basal_k1"],
        k2=cfg["dynamics.Lemieux_basal_k2"],
        Cb=cfg["dynamics.Lemieux_basal_Cb"],
        u0=cfg["dynamics.Lemieux_basal_u_0"],
        mevp_alpha=cfg["dynamics.mevp.alpha"],
        mevp_beta=cfg["dynamics.mevp.beta"],
        nit_ow=cfg["numerics.nit_ow"],
        use_young_ice=cfg["thermo.newice_type"] == 4,
        bbm=bbm,
        evp=evp,
    )
