"""The structured quad grid that replaces the reference's triangle mesh.

The reference solves on an adaptive Lagrangian triangle mesh (reference:
core/src/gmshmesh.cpp, contrib/bamg) with velocity on P1 nodes and tracers on
P0 elements. The TPU-native equivalent is a fixed Arakawa **B-grid** on a
polar-stereographic plane:

* tracers / stress / damage at cell centers, shape ``(ny, nx)``
* velocity at cell corners (nodes), shape ``(ny+1, nx+1)``

which preserves the reference's staggering semantics (strain rates from
corner velocities; stress divergence scattered back to corners; lumped nodal
mass from adjacent cells) while making every operator a shift-based stencil
that XLA tiles onto the VPU and GSPMD shards with automatic halo exchange.

Masking convention:

* ``mask``      (ny, nx) float 1.0 = ocean cell, 0.0 = land.  The outermost
  ring of cells is always land (enforced here) so periodic `roll`
  wraparound only ever touches zero-masked cells — no special boundary
  branches inside the jitted step.
* ``node_mask`` (ny+1, nx+1) 1.0 where the node touches >=1 ocean cell.
* ``node_dirichlet`` 1.0 where velocity is pinned to zero: nodes touching a
  land cell (coastline + closed domain edge), matching the reference's
  Dirichlet flags (reference: model/finiteelement.cpp:150-271 semantics).
  With ``grid.boundary=open`` the domain-edge ring instead becomes Neumann:
  nodes stay free and the adjoining cells are flagged in ``open_mask`` (not
  updated by advection, like elements touching M_neumann_flags in
  reference: model/finiteelement.cpp:3958-3962).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from benchmark.reference.plain.grid.projection import NPS_NEXTSIM, PolarStereo


@dataclasses.dataclass(frozen=True)
class Grid:
    nx: int  # number of cells in x
    ny: int  # number of cells in y
    dx: float  # cell size [m] (uniform, square cells)
    x0: float  # x of the *west edge* of cell column 0 [m, projection coords]
    y0: float  # y of the *south edge* of cell row 0 [m]
    mask: np.ndarray  # (ny, nx) 1=ocean
    open_mask: np.ndarray  # (ny, nx) 1=open-boundary cell (not updated)
    projection: PolarStereo = NPS_NEXTSIM

    # ---------------- geometry -------------------------------------------
    @property
    def cell_area(self) -> float:
        return self.dx * self.dx

    @property
    def shape(self):  # cells
        return (self.ny, self.nx)

    @property
    def node_shape(self):
        return (self.ny + 1, self.nx + 1)

    def cell_xy(self):
        """Cell-center coordinates, each (ny, nx)."""
        x = self.x0 + (np.arange(self.nx) + 0.5) * self.dx
        y = self.y0 + (np.arange(self.ny) + 0.5) * self.dx
        return np.broadcast_to(x[None, :], self.shape).copy(), np.broadcast_to(
            y[:, None], self.shape
        ).copy()

    def node_xy(self):
        """Node coordinates, each (ny+1, nx+1)."""
        x = self.x0 + np.arange(self.nx + 1) * self.dx
        y = self.y0 + np.arange(self.ny + 1) * self.dx
        return (
            np.broadcast_to(x[None, :], self.node_shape).copy(),
            np.broadcast_to(y[:, None], self.node_shape).copy(),
        )

    def cell_latlon(self):
        x, y = self.cell_xy()
        lat, lon = self.projection.inverse(x, y)
        return np.asarray(lat), np.asarray(lon)

    def node_latlon(self):
        x, y = self.node_xy()
        lat, lon = self.projection.inverse(x, y)
        return np.asarray(lat), np.asarray(lon)

    # ---------------- derived masks --------------------------------------
    @property
    def node_mask(self) -> np.ndarray:
        """1.0 where the node touches at least one ocean cell."""
        padded = np.pad(self.mask, 1)
        # node (j,i) touches cells (j-1..j, i-1..i) in cell coords
        touch = (
            padded[:-1, :-1] + padded[:-1, 1:] + padded[1:, :-1] + padded[1:, 1:]
        )
        return (touch > 0).astype(self.mask.dtype)

    @property
    def node_dirichlet(self) -> np.ndarray:
        """1.0 where velocity is pinned to zero (coast/closed-edge nodes)."""
        land = 1.0 - self.mask
        # open-boundary cells don't pin their nodes
        land = land * (1.0 - self.open_mask)
        padded = np.pad(land, 1, constant_values=0.0)
        touch_land = (
            padded[:-1, :-1] + padded[:-1, 1:] + padded[1:, :-1] + padded[1:, 1:]
        )
        dir_mask = (touch_land > 0) & (self.node_mask > 0)
        return dir_mask.astype(self.mask.dtype)

    # ---------------- constructors ----------------------------------------
    @staticmethod
    def square(
        nx: int = 128,
        ny: int = 128,
        dx: float = 2e3,
        x0: float = 0.0,
        y0: float = 0.0,
        boundary: str = "closed",
        projection: PolarStereo = NPS_NEXTSIM,
        land: Optional[np.ndarray] = None,
    ) -> "Grid":
        """Closed square basin with a one-cell land ring — the analog of the
        reference's toy domain (config-files/nextsim.toy.cfg:
        mesh.filename=square_with_point.msh)."""
        mask = np.ones((ny, nx), dtype=np.float32)
        mask[0, :] = mask[-1, :] = 0.0
        mask[:, 0] = mask[:, -1] = 0.0
        if land is not None:
            mask = mask * (1.0 - land.astype(np.float32))
        open_mask = np.zeros_like(mask)
        if boundary == "open":
            # second ring becomes open-boundary cells
            ring = np.zeros_like(mask)
            ring[1, :] = ring[-2, :] = 1.0
            ring[:, 1] = ring[:, -2] = 1.0
            open_mask = ring * mask
        return Grid(nx=nx, ny=ny, dx=dx, x0=x0, y0=y0, mask=mask, open_mask=open_mask, projection=projection)

    @staticmethod
    def from_config(cfg) -> "Grid":
        """Build the grid requested by ``grid.*`` / ``mesh.*`` options."""
        preset = cfg["grid.preset"]
        if not preset:
            # map reference mesh filenames onto presets
            mesh_file = cfg["mesh.filename"]
            if "arctic" in mesh_file.lower():
                preset = "arctic"
            else:
                preset = "square"
        if preset == "square":
            return Grid.square(
                nx=cfg["grid.nx"],
                ny=cfg["grid.ny"],
                dx=cfg["grid.resolution"],
                x0=cfg["grid.x0"],
                y0=cfg["grid.y0"],
                boundary=cfg["grid.boundary"],
            )
        if preset == "arctic":
            from benchmark.reference.plain.grid.arctic import arctic_grid

            return arctic_grid(
                dx=cfg["grid.resolution"], nx=cfg["grid.nx"], ny=cfg["grid.ny"]
            )
        if preset == "arctic_etopo":
            # real coastline + water depth from ETOPO (reference: the meshed
            # coastline, mesh/README.md, + initBathymetry fe.cpp:13749-13777)
            from benchmark.reference.plain.forcing.bathymetry import arctic_etopo_grid

            grid, _depth = arctic_etopo_grid(
                dx=cfg["grid.resolution"], nx=cfg["grid.nx"], ny=cfg["grid.ny"],
                filename=cfg["setup.bathymetry-file"],
            )
            return grid
        raise ValueError(f"unknown grid preset {preset!r}")
