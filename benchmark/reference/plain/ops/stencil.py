"""B-grid stencil operators (the counterpart of nextsim_tpu/ops/stencil.py).

These are the structured-grid equivalents of the reference's P1 finite-element
operators on triangles (reference: model/finiteelement.cpp:4167-4176 strain
rates, 10446-10467 stress divergence, 10311-10320 lumped accumulations,
10580-10611 open-water smoother). Every operator is a pad-and-slice shift
with the same factored arithmetic and term order as the JAX package, so on
the CPU they agree with it to rounding.

Array layout: cells (ny, nx); nodes (ny+1, nx+1); index [j, i] = [y, x];
cell (j, i) has corner nodes SW=(j,i), SE=(j,i+1), NW=(j+1,i), NE=(j+1,i+1).
Every operator takes planes with leading axes (a member axis, (N, ny, nx))
and works on the last two: each leading index gives the bits of its own
plane.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.plain.core import ties


def pad1(a: torch.Tensor) -> torch.Tensor:
    """Zero-pad the last two axes by one on every side (``jnp.pad(a, 1)`` of
    a plane)."""
    return F.pad(a, (1, 1, 1, 1))


def cell_corners(nodal):
    """Return the 4 corner-node views (SW, SE, NW, NE), each of cell shape."""
    return (
        nodal[..., :-1, :-1],
        nodal[..., :-1, 1:],
        nodal[..., 1:, :-1],
        nodal[..., 1:, 1:],
    )


def strain_rates(u, v, dx: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cell-centered strain rates (eps11, eps22, eps12) from corner
    velocities."""
    u_sw, u_se, u_nw, u_ne = cell_corners(u)
    v_sw, v_se, v_nw, v_ne = cell_corners(v)
    r = 1.0 / (2.0 * dx)
    # factored diagonal differences: dx+dy = 2(ne-sw), dx-dy = 2(se-nw)
    ua = u_ne - u_sw
    ub = u_se - u_nw
    va = v_ne - v_sw
    vb = v_se - v_nw
    dudx = (ua + ub) * r
    dudy = (ua - ub) * r
    dvdx = (va + vb) * r
    dvdy = (va - vb) * r
    return dudx, dvdy, 0.5 * (dudy + dvdx)


def cells_to_node_sum(cell_field) -> torch.Tensor:
    """Scatter-add a cell field to its 4 corner nodes (adjoint of corner
    gather); node (j,i) accumulates cells (j-1..j, i-1..i)."""
    p = pad1(cell_field)
    return p[..., :-1, :-1] + p[..., :-1, 1:] + p[..., 1:, :-1] + p[..., 1:, 1:]


def node_max_of_cells(cell_field) -> torch.Tensor:
    """Max over the (up to) 4 cells adjacent to each node."""
    p = pad1(cell_field)
    return torch.maximum(
        torch.maximum(p[..., :-1, :-1], p[..., :-1, 1:]), torch.maximum(p[..., 1:, :-1], p[..., 1:, 1:])
    )


def stress_divergence(sxx, syy, sxy, volume, dx: float):
    """Nodal gradient terms of the momentum RHS (reference:
    finiteelement.cpp:10460-10466, sign per Danilov et al. 2015), in the
    factored S/D form Dx(F1)+Dy(F2) = S[--] - D[-+] + D[+-] - S[++] for
    S=F1+F2, D=F1-F2. Returns (grad_u, grad_v) with the minus applied."""
    r = 1.0 / (2.0 * dx)
    vsxy = volume * sxy

    def dxy_pair(f1, f2):
        ps = pad1(f1 + f2)
        pd = pad1(f1 - f2)
        return (
            ps[..., :-1, :-1] - pd[..., :-1, 1:] + pd[..., 1:, :-1] - ps[..., 1:, 1:]
        ) * r

    grad_u = dxy_pair(volume * sxx, vsxy)
    grad_v = dxy_pair(vsxy, volume * syy)
    return -grad_u, -grad_v


def node_grad_scalar(cell_coef, node_scalar, dx: float):
    """Nodal 'gradient of m*g*ssh' term (reference: finiteelement.cpp:
    10320-10340): the cell-centered gradient of the node scalar times the
    cell coefficient, scattered to the 4 corner nodes."""
    s_sw, s_se, s_nw, s_ne = cell_corners(node_scalar)
    r = 1.0 / (2.0 * dx)
    gs_x = (s_se + s_ne - s_sw - s_nw) * r
    gs_y = (s_nw + s_ne - s_sw - s_se) * r
    return -cells_to_node_sum(cell_coef * gs_x), -cells_to_node_sum(cell_coef * gs_y)


def neighbor_mean_nodes(u, node_ok) -> torch.Tensor:
    """Mean of the 4 von-Neumann node neighbours, restricted to valid nodes
    (``node_ok`` is 1.0 where a neighbour may contribute)."""
    up = pad1(u * node_ok)
    wp = pad1(node_ok)
    num = up[..., :-2, 1:-1] + up[..., 2:, 1:-1] + up[..., 1:-1, :-2] + up[..., 1:-1, 2:]
    den = wp[..., :-2, 1:-1] + wp[..., 2:, 1:-1] + wp[..., 1:-1, :-2] + wp[..., 1:-1, 2:]
    return num / ties.maximum(den, 1.0)


def cell_mean_of_nodes(nodal) -> torch.Tensor:
    """Average of the 4 corner nodes (reference: finiteelement.cpp:
    10274-10277)."""
    a, b, c, d = cell_corners(nodal)
    return 0.25 * (a + b + c + d)


def node_mean_of_cells(cell_field, cell_weight) -> torch.Tensor:
    """Weight-averaged cell->node interpolation (reference:
    finiteelement.cpp:10373-10390)."""
    num = cells_to_node_sum(cell_field * cell_weight)
    den = cells_to_node_sum(cell_weight)
    return num / ties.maximum(den, 1e-30)


def laplacian_cells(field, mask, dx: float) -> torch.Tensor:
    """5-point masked Laplacian on cells, no flux across land faces
    (reference: diffuse(), finiteelement.cpp:2760-2815)."""
    fp = pad1(field)
    mp = pad1(mask)
    c = fp[..., 1:-1, 1:-1]
    out = (
        mp[..., :-2, 1:-1] * (fp[..., :-2, 1:-1] - c)
        + mp[..., 2:, 1:-1] * (fp[..., 2:, 1:-1] - c)
        + mp[..., 1:-1, :-2] * (fp[..., 1:-1, :-2] - c)
        + mp[..., 1:-1, 2:] * (fp[..., 1:-1, 2:] - c)
    )
    return mask * out / (dx * dx)
