"""Bathymetry ingest and real-coastline land masks (the counterpart of
nextsim_tpu/forcing/bathymetry.py; host numpy, as there).

The reference gets its coastline from the unstructured mesh (land is simply
not meshed; reference: mesh/README.md) and its water depth from the ETOPO
dataset at init (reference: initBathymetry, model/finiteelement.cpp:
13749-13777, `etopo_elements` descriptor in model/dataset.cpp). On the
structured grid both come from the same place: an ETOPO-style NetCDF
(regular lat/lon, elevation `z` positive up) sampled at cell centers gives

* ``Forcing.depth`` — water depth [m, positive down] for the Lemieux
  grounding scheme (ops/momentum.py:_basal_cbu), and
* ``Grid.mask``     — the land-sea mask: ocean where the sampled depth
  exceeds ``min_depth``, cleaned up to the largest connected ocean component
  so isolated "lakes" created by sampling don't host unreachable ice.

`grid.preset = arctic_etopo` builds the pan-Arctic box with this real
coastline (file: ``setup.bathymetry-file`` under NEXTSIM_DATA_DIR).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def _etopo_reader(grid, data_dir: str, filename: str):
    import dataclasses

    from benchmark.reference.plain.forcing.datasets import REGISTRY, _DatasetReader

    spec = REGISTRY["etopo"]
    if filename and filename != spec.filename_mask:
        spec = dataclasses.replace(spec, filename_mask=filename)
    return _DatasetReader(spec, grid, data_dir)


def etopo_path(cfg=None, data_dir: Optional[str] = None,
               filename: Optional[str] = None) -> str:
    data_dir = data_dir or os.environ.get("NEXTSIM_DATA_DIR", ".")
    if filename is None:
        filename = (
            cfg["setup.bathymetry-file"] if cfg is not None
            else "ETOPO_Arctic_2arcmin.nc"
        )
    return os.path.join(data_dir, filename)


def load_depth(grid, data_dir: Optional[str] = None,
               filename: Optional[str] = None) -> np.ndarray:
    """Water depth [m, positive down] at cell centers from the ETOPO file
    (negative values = land elevation)."""
    data_dir = data_dir or os.environ.get("NEXTSIM_DATA_DIR", ".")
    filename = filename or "ETOPO_Arctic_2arcmin.nc"
    path = os.path.join(data_dir, filename)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"bathymetry file {path} not found: set NEXTSIM_DATA_DIR (or "
            f"setup.bathymetry-file) to an ETOPO-style NetCDF with elevation "
            f"variable 'z' on a regular lat/lon grid"
        )
    reader = _etopo_reader(grid, data_dir, filename)
    fields = reader.fields_at(0.0)
    if "depth" not in fields:
        raise ValueError(f"no 'z' elevation variable found in {path}")
    return np.asarray(fields["depth"], np.float64)


def mask_from_depth(
    depth: np.ndarray,
    min_depth: float = 0.0,
    keep_largest: bool = True,
) -> np.ndarray:
    """Land-sea mask from sampled depth: ocean where depth > min_depth,
    optionally reduced to the largest 4-connected ocean component (the
    reference's meshed domain is a single connected ocean; stray sampled
    lakes would otherwise hold dynamically-dead ice)."""
    ocean = depth > min_depth
    if keep_largest and ocean.any():
        from scipy import ndimage

        labels, n = ndimage.label(ocean)
        if n > 1:
            sizes = ndimage.sum(ocean, labels, index=np.arange(1, n + 1))
            ocean = labels == (1 + int(np.argmax(sizes)))
    return ocean.astype(np.float32)


def arctic_etopo_grid(
    dx: float = 10e3,
    nx: int = 608,
    ny: int = 608,
    data_dir: Optional[str] = None,
    filename: Optional[str] = None,
    min_depth: float = 0.0,
    lat_min: float = 0.0,
) -> Tuple["Grid", np.ndarray]:
    """Pole-centered pan-Arctic box with the real ETOPO coastline.

    Returns (grid, depth): the grid's mask is the connected ocean with the
    boundary ring closed (as for every preset), and depth is the per-cell
    water depth for the grounding scheme.
    """
    from benchmark.reference.plain.grid.grid import Grid
    from benchmark.reference.plain.grid.projection import NPS_NEXTSIM

    x0 = -0.5 * nx * dx
    y0 = -0.5 * ny * dx
    base = Grid.square(nx=nx, ny=ny, dx=dx, x0=x0, y0=y0, projection=NPS_NEXTSIM)
    depth = load_depth(base, data_dir=data_dir, filename=filename)
    mask = mask_from_depth(depth, min_depth=min_depth)
    if lat_min > 0.0:
        lat, _ = base.cell_latlon()
        mask = mask * (lat > lat_min).astype(np.float32)
    mask = mask * base.mask  # keep the closed boundary ring
    grid = Grid(
        nx=nx, ny=ny, dx=dx, x0=x0, y0=y0, mask=mask,
        open_mask=base.open_mask, projection=NPS_NEXTSIM,
    )
    return grid, np.maximum(depth, 0.0).astype(np.float32)
