"""WIM-on-its-own-grid: regular-grid <-> regular-grid regridding (the
counterpart of nextsim_tpu/wim/regrid.py).

The reference runs the WIM either on the neXtSIM mesh or on its own regular
grid (reference: modules/wim/src/gridinfo.cpp — GridInfo built from
wimgrid.* parameters, gridinfo.cpp:26-80, or derived from the mesh extent at
the mesh resolution, gridinfo.cpp:84-124, with mesh<->grid interpolation each
exchange). Here both grids are regular stereographic, so the exchange is a
mask-aware bilinear regrid: the plan (indices and weights) is host numpy,
computed once at setup; the gather runs on the fields' device.

``nextwim.coupling-option=naive`` selects this path (the reference's name
for WIM-on-its-own-grid with interpolation both ways); ``break_on_mesh`` /
``run_on_mesh`` run co-located on the model grid (a structured model grid
makes those two equivalent).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nextsim_tpu_torch.core import ties
from nextsim_tpu_torch.grid.grid import Grid


def _bilinear_plan(src: Grid, tx: np.ndarray, ty: np.ndarray):
    """Precompute bilinear gather indices/weights for sampling a
    cell-centred field of ``src`` at target points (tx, ty) [m]."""
    u = (tx - src.x0) / src.dx - 0.5
    v = (ty - src.y0) / src.dx - 0.5
    i0 = np.clip(np.floor(u).astype(np.int32), 0, src.nx - 2)
    j0 = np.clip(np.floor(v).astype(np.int32), 0, src.ny - 2)
    wx = np.clip(u - i0, 0.0, 1.0).astype(np.float32)
    wy = np.clip(v - j0, 0.0, 1.0).astype(np.float32)
    return j0, i0, wy, wx


class Regridder:
    """Mask-aware bilinear maps between the model grid and the WIM grid.

    Land cells carry zero weight (the reference interpolates its land mask
    onto the WIM grid the same way, gridinfo.cpp:111-123), so ice/wave
    fields are never contaminated by land zeros at the coast.
    """

    def __init__(self, model_grid: Grid, wim_grid: Grid, dtype=torch.float32, *, device):
        self.model_grid = model_grid
        self.wim_grid = wim_grid
        self.dtype = dtype
        self.device = torch.device(device)
        wx_pts, wy_pts = wim_grid.cell_xy()
        self._to_wim = self._on_device(_bilinear_plan(model_grid, wx_pts, wy_pts))
        mx_pts, my_pts = model_grid.cell_xy()
        self._to_model = self._on_device(_bilinear_plan(wim_grid, mx_pts, my_pts))
        self._model_mask = torch.as_tensor(np.asarray(model_grid.mask), dtype=dtype, device=self.device)
        self._wim_mask = torch.as_tensor(np.asarray(wim_grid.mask), dtype=dtype, device=self.device)

    def _on_device(self, plan):
        """The host plan as tensors: int64 indices and the four corner
        weights. The weights are products of float32 numbers formed in
        float32 on the host, as the JAX package forms them, and only then
        cast to the fields' dtype (exactly)."""
        j0, i0, wy, wx = plan
        idx = lambda a: torch.as_tensor(a.astype(np.int64), device=self.device)  # noqa: E731
        wgt = lambda a: torch.as_tensor(a, dtype=self.dtype, device=self.device)  # noqa: E731
        corners = ((1.0 - wy) * (1.0 - wx), (1.0 - wy) * wx, wy * (1.0 - wx), wy * wx)
        return idx(j0), idx(i0), tuple(wgt(c) for c in corners)

    @staticmethod
    def _apply(plan, field, src_mask):
        j0, i0, (c00, c01, c10, c11) = plan

        def gather(dj, di):
            return field[j0 + dj, i0 + di], src_mask[j0 + dj, i0 + di]

        f00, m00 = gather(0, 0)
        f01, m01 = gather(0, 1)
        f10, m10 = gather(1, 0)
        f11, m11 = gather(1, 1)
        w00 = c00 * m00
        w01 = c01 * m01
        w10 = c10 * m10
        w11 = c11 * m11
        tot = w00 + w01 + w10 + w11
        num = w00 * f00 + w01 * f01 + w10 * f10 + w11 * f11
        return num / ties.maximum(tot, 1e-12)

    def to_wim(self, field):
        """Model-grid cell field -> WIM grid (zero on WIM land)."""
        return self._apply(self._to_wim, field, self._model_mask) * self._wim_mask

    def to_model(self, field):
        """WIM-grid cell field -> model grid (zero on model land)."""
        return self._apply(self._to_model, field, self._wim_mask) * self._model_mask


def make_wim_grid(cfg, model_grid: Grid) -> Grid:
    """Build the WIM's own grid.

    With ``wimgrid.nx > 0`` the grid comes from explicit parameters
    (gridinfo.cpp:26-80 manual generation); otherwise it spans the model
    grid's extent at ``wimgrid.dx`` resolution, rounded up like the
    reference's from-mesh constructor (gridinfo.cpp:95-108). The WIM land
    mask is the interpolated model mask thresholded at 0.5.
    """
    dx = float(cfg["wimgrid.dx"])
    if cfg["wimgrid.nx"] > 0:
        nx, ny = int(cfg["wimgrid.nx"]), int(cfg["wimgrid.ny"])
        x0, y0 = float(cfg["wimgrid.xmin"]), float(cfg["wimgrid.ymin"])
    else:
        x0, y0 = model_grid.x0, model_grid.y0
        nx = max(2, math.ceil(model_grid.nx * model_grid.dx / dx))
        ny = max(2, math.ceil(model_grid.ny * model_grid.dx / dx))

    # sample the model land mask at WIM cell centres
    wx = x0 + (np.arange(nx) + 0.5) * dx
    wy = y0 + (np.arange(ny) + 0.5) * dx
    wx, wy = np.meshgrid(wx, wy)
    j0, i0, wyw, wxw = _bilinear_plan(model_grid, wx, wy)
    m = np.asarray(model_grid.mask, np.float32)
    interp = (
        (1 - wyw) * (1 - wxw) * m[j0, i0]
        + (1 - wyw) * wxw * m[j0, i0 + 1]
        + wyw * (1 - wxw) * m[j0 + 1, i0]
        + wyw * wxw * m[j0 + 1, i0 + 1]
    )
    mask = (interp >= 0.5).astype(np.float32)
    return Grid(
        nx=nx, ny=ny, dx=dx, x0=x0, y0=y0, mask=mask,
        open_mask=np.zeros_like(mask), projection=model_grid.projection,
    )
