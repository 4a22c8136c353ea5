"""Pan-Arctic benchmark domain.

The reference's operational domains are unstructured 10 km pan-Arctic meshes
(reference: config-files/nextsim.cfg:13 `mesh.filename=small_arctic_10km.msh`;
the .msh files ship separately and are not in the repository). Here the
equivalent is a square polar-stereographic box centered on the pole with an
ocean mask approximated by latitude. For the real coastline use
``grid.preset=arctic_etopo``, which builds the mask + water depth from an
ETOPO-style NetCDF (nextsim_tpu/forcing/bathymetry.py: largest-connected-
ocean cleanup; depth feeds the Lemieux grounding scheme via Forcing.depth).

This synthetic mask keeps the benchmark workload (active-cell count, coast
fraction) representative without requiring data downloads.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.plain.grid.grid import Grid
from benchmark.reference.plain.grid.projection import NPS_NEXTSIM


def arctic_grid(dx: float = 10e3, nx: int = 608, ny: int = 608, lat_min: float = 68.0) -> Grid:
    """Pole-centered box; ocean where lat > lat_min, one-cell land ring."""
    x0 = -0.5 * nx * dx
    y0 = -0.5 * ny * dx
    g = Grid.square(nx=nx, ny=ny, dx=dx, x0=x0, y0=y0, projection=NPS_NEXTSIM)
    lat, _ = g.cell_latlon()
    mask = g.mask * (lat > lat_min).astype(np.float32)
    return Grid(nx=nx, ny=ny, dx=dx, x0=x0, y0=y0, mask=mask, open_mask=g.open_mask, projection=NPS_NEXTSIM)
