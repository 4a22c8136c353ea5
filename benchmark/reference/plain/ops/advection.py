"""Flux-form tracer advection on the B-grid (the counterpart of
nextsim_tpu/ops/advection.py).

This operator replaces the reference's Lagrangian transport (tracers ride
the moving mesh, reference: finiteelement.cpp:10539-10573, and are remapped
conservatively at regrid, fe.cpp:3108): the grid is fixed and a monotone
second-order (van-Leer-limited MUSCL) dimensionally split finite-volume
scheme moves the tracers every step.

* ``advect_conservative``: for area densities (conc, ice volume, ...).
* ``advect_intensive``: advective form for intensive tracers (damage,
  stress, temperatures, SST/SSS); limited second order or donor-cell upwind.

Face velocities are the mean of the two face nodes; on coastlines both face
nodes are Dirichlet so the normal flux is identically zero.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.plain.core import ties


def face_velocities(u_node, v_node) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u_face (ny, nx+1), v_face (ny+1, nx)) normal velocities."""
    u_face = 0.5 * (u_node[..., :-1, :] + u_node[..., 1:, :])
    v_face = 0.5 * (v_node[..., :-1] + v_node[..., 1:])
    return u_face, v_face


def _vanleer_slope(qm, qc, qp):
    """van Leer harmonic slope limiter (per cell)."""
    dm = qc - qm
    dp = qp - qc
    prod = dm * dp
    denom = dm + dp
    safe = torch.where(torch.abs(denom) < 1e-30, 1e-30, denom)
    # a subnormal product counts as zero, as on XLA's backends, which flush
    # subnormals: it has lost the bits that keep the harmonic mean within
    # 2 min(|dm|, |dp|), and the overshoot would carry a tracer below zero
    return torch.where(prod >= torch.finfo(prod.dtype).tiny, 2.0 * prod / safe, 0.0)


def _flux_x(q, u_face, dtdx, second_order: bool):
    """Upwind/MUSCL fluxes through x-faces; q (..., ny, nx) -> flux
    (..., ny, nx+1), flux = u * q_face * dt/dx (dimensionless transported
    amount). Leading dimensions are planes advected side by side."""
    qp = F.pad(q, (1, 1))  # land ghost cells; coast faces have u=0
    qW = qp[..., :-1]  # cell left of face
    qE = qp[..., 1:]  # cell right of face
    if second_order:
        qpp = F.pad(q, (2, 2))
        slope = _vanleer_slope(qpp[..., :-2], qpp[..., 1:-1], qpp[..., 2:])  # (..., ny, nx+2)
        sW = slope[..., :-1]
        sE = slope[..., 1:]
        c = u_face * dtdx
        q_face = torch.where(
            u_face >= 0.0,
            qW + 0.5 * (1.0 - c) * sW,
            qE - 0.5 * (1.0 + c) * sE,
        )
    else:
        q_face = torch.where(u_face >= 0.0, qW, qE)
    return u_face * q_face * dtdx


def _flux_y(q, v_face, dtdx, second_order: bool):
    qp = F.pad(q, (0, 0, 1, 1))
    qS = qp[..., :-1, :]
    qN = qp[..., 1:, :]
    if second_order:
        qpp = F.pad(q, (0, 0, 2, 2))
        slope = _vanleer_slope(qpp[..., :-2, :], qpp[..., 1:-1, :], qpp[..., 2:, :])
        sS = slope[..., :-1, :]
        sN = slope[..., 1:, :]
        c = v_face * dtdx
        q_face = torch.where(
            v_face >= 0.0,
            qS + 0.5 * (1.0 - c) * sS,
            qN - 0.5 * (1.0 + c) * sN,
        )
    else:
        q_face = torch.where(v_face >= 0.0, qS, qN)
    return v_face * q_face * dtdx


def advect_conservative(
    q, u_face, v_face, dt: float, dx: float, mask, second_order: bool = True
):
    """One dimensionally-split conservative transport step of density q
    (x then y). Land cells (mask=0) neither give nor receive. ``q`` is
    (ny, nx) or a stack (..., ny, nx) of planes: every operation is
    pointwise in the plane, so a stack gives each plane's own bits."""
    dtdx = dt / dx
    fx = _flux_x(q, u_face, dtdx, second_order)
    q = q - (fx[..., 1:] - fx[..., :-1])
    fy = _flux_y(q, v_face, dtdx, second_order)
    q = q - (fy[..., 1:, :] - fy[..., :-1, :])
    return q * mask


def advect_intensive(q, u_face, v_face, dt: float, dx: float, mask, second_order: bool = False):
    """Advective-form update: dq/dt + u.grad(q) = 0.

    ``second_order``: van-Leer-limited MUSCL in advective form — the
    flux-form update plus the compression correction +q*div(u)*dt, per split
    direction. ``second_order=False``: donor-cell upwind (strictly monotone).
    """
    dtdx = dt / dx
    if second_order:
        fx = _flux_x(q, u_face, dtdx, True)
        q = q - (fx[..., 1:] - fx[..., :-1]) + q * ((u_face[..., 1:] - u_face[..., :-1]) * dtdx)
        fy = _flux_y(q, v_face, dtdx, True)
        q = q - (fy[..., 1:, :] - fy[..., :-1, :]) + q * ((v_face[..., 1:, :] - v_face[..., :-1, :]) * dtdx)
        return q * mask
    # edge padding needs a leading batch dimension in F.pad
    qp = F.pad(q[None], (1, 1, 1, 1), mode="replicate")[0]
    # face-upwind differences; u_face (ny, nx+1)
    uW = u_face[..., :-1]
    uE = u_face[..., 1:]
    vS = v_face[..., :-1, :]
    vN = v_face[..., 1:, :]
    dW = qp[..., 1:-1, 1:-1] - qp[..., 1:-1, :-2]
    dE = qp[..., 1:-1, 2:] - qp[..., 1:-1, 1:-1]
    dS = qp[..., 1:-1, 1:-1] - qp[..., :-2, 1:-1]
    dN = qp[..., 2:, 1:-1] - qp[..., 1:-1, 1:-1]
    adv = (
        ties.maximum(uW, 0.0) * dW
        + ties.minimum(uE, 0.0) * dE
        + ties.maximum(vS, 0.0) * dS
        + ties.minimum(vN, 0.0) * dN
    )
    return (q - dtdx * adv) * mask


def divergence(u_face, v_face, dx: float):
    """Cell-centered velocity divergence [1/s]."""
    return (u_face[..., 1:] - u_face[..., :-1] + v_face[..., 1:, :] - v_face[..., :-1, :]) / dx
