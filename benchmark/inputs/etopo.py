"""The approximate pan-Arctic ETOPO stand-in the benchmark writes for its
cells: hand-encoded coarse polygons of the circum-Arctic landmasses
rasterized onto a regular 0.25 x 0.5 degree lat/lon grid (161 x 720), with a
distance-to-coast shelf and basin depth profile. A frozen copy of the
port's ``tools/synthetic_etopo.py`` (polygons, depth profile, even-odd
point-in-polygon test), so the benchmark's inputs do not move when the
program's tools do. Variables lat(lat), lon(lon), z(lat, lon), elevation
positive up [m], as the ``etopo`` dataset is read.
"""

from __future__ import annotations

import os
import sys

import numpy as np

# --- approximate landmass outlines, (lon, lat) vertex lists ----------------
# Vertices are coarse by design; southern edges are closed well below the
# domain so polygons stay simple. Longitudes in [-180, 180].

EURASIA = [
    # Scandinavia + Kola, then east along the Siberian coast to Bering Strait
    (5.0, 58.0), (5.0, 62.0), (12.0, 65.5), (17.0, 69.3), (25.0, 71.1),
    (31.0, 69.8), (37.0, 66.2), (44.0, 66.8), (44.0, 68.5), (54.0, 68.9),
    (59.5, 68.9),  # Kara gate (south of Novaya Zemlya)
    (69.0, 66.5), (72.5, 66.6), (71.0, 70.0), (72.8, 71.9),  # Ob/Yamal
    (78.5, 70.9), (83.0, 71.5), (80.5, 73.5), (86.5, 75.4), (95.0, 76.1),
    (100.3, 77.6), (105.0, 77.3),  # Taymyr (northernmost mainland)
    (106.0, 75.0), (113.5, 73.8), (119.8, 73.0), (126.0, 72.3),
    (129.5, 71.2), (139.0, 71.5), (147.0, 72.3), (152.0, 70.9),
    (160.0, 69.7), (170.0, 69.6), (176.5, 67.8),
    (180.0, 65.8), (180.0, 40.0), (5.0, 40.0),
]
CHUKOTKA_TIP = [  # west of Bering Strait across the dateline
    (-180.0, 65.8), (-175.5, 64.8), (-172.5, 64.5), (-170.0, 60.0),
    (-180.0, 40.0),
]
NORTH_AMERICA = [
    # Alaska (east of Bering Strait) along the mainland coast to Labrador
    (-168.0, 65.5), (-166.5, 68.3), (-161.0, 70.3), (-156.5, 71.3),  # Barrow
    (-141.0, 69.6), (-135.0, 69.0), (-128.0, 69.7), (-122.0, 69.4),
    (-115.0, 68.5), (-107.5, 68.0), (-102.0, 68.3), (-96.0, 67.5),
    (-90.5, 68.5), (-85.5, 66.5),  # to Hudson Bay mouth
    (-82.0, 64.8), (-88.0, 62.0), (-92.0, 57.0),  # Hudson Bay west shore
    (-86.0, 55.5), (-79.0, 54.5), (-77.5, 62.3),  # Hudson Bay east shore
    (-69.5, 61.0), (-64.5, 60.3), (-60.0, 55.0),  # Ungava/Labrador
    (-55.0, 40.0), (-168.0, 40.0),
]
# Canadian Arctic Archipelago: a few big islands with real channel gaps
BAFFIN = [
    (-80.0, 66.2), (-74.0, 66.5), (-71.5, 69.5), (-67.5, 70.0),
    (-61.5, 66.5), (-64.5, 63.0), (-68.0, 62.3), (-73.5, 64.3), (-78.0, 64.5),
]
VICTORIA = [
    (-118.0, 69.5), (-113.5, 70.0), (-110.0, 70.5), (-102.0, 71.0),
    (-105.0, 72.5), (-111.5, 73.0), (-117.5, 72.5), (-120.5, 71.5),
]
BANKS = [(-125.5, 71.2), (-121.5, 71.3), (-119.5, 73.2), (-124.5, 74.2)]
ELLESMERE_AXEL = [
    (-90.0, 76.5), (-82.0, 77.0), (-78.0, 78.5), (-75.0, 79.5),
    (-70.0, 80.5), (-62.0, 82.0), (-70.0, 83.1), (-85.0, 82.5),
    (-92.5, 81.5), (-96.5, 80.0), (-92.0, 78.0),
]
DEVON_SOMERSET = [
    (-95.5, 72.8), (-90.0, 73.0), (-82.0, 74.5), (-80.5, 75.5),
    (-89.0, 76.0), (-95.0, 75.0),
]
MELVILLE_PARRY = [
    (-117.0, 75.0), (-110.0, 74.5), (-104.5, 75.3), (-108.0, 76.3),
    (-115.5, 76.5),
]
GREENLAND = [
    (-45.0, 59.8),  # Cape Farewell
    (-53.0, 65.0), (-54.5, 69.5), (-56.0, 72.0), (-58.0, 75.0),
    (-66.5, 76.0), (-69.5, 77.5), (-66.0, 79.0), (-61.5, 81.2),  # Nares west
    (-50.0, 82.5), (-35.0, 83.5),  # north coast
    (-25.0, 82.5), (-18.0, 81.5), (-20.5, 79.0), (-18.5, 76.5),
    (-21.0, 74.0), (-24.5, 72.5), (-21.5, 70.0), (-27.0, 68.5),
    (-33.0, 67.5), (-41.0, 64.5), (-42.5, 62.0),
]
ICELAND = [
    (-24.0, 65.5), (-22.0, 66.4), (-16.5, 66.5), (-13.8, 65.4),
    (-15.0, 64.0), (-19.0, 63.4), (-22.5, 63.8),
]
SVALBARD = [
    (10.5, 76.5), (13.5, 77.5), (10.8, 79.0), (12.0, 79.8), (16.5, 80.1),
    (22.5, 80.5), (27.0, 80.1), (23.0, 78.5), (21.0, 77.0), (17.0, 76.6),
]
FRANZ_JOSEF = [(45.0, 80.0), (52.0, 79.9), (62.0, 80.5), (58.0, 81.8), (48.0, 81.3)]
NOVAYA_ZEMLYA = [
    (53.5, 70.5), (55.5, 70.8), (58.5, 72.0), (63.5, 74.5), (68.5, 76.2),
    (66.0, 77.0), (61.0, 75.6), (56.5, 73.7), (53.0, 71.8), (51.5, 71.2),
]
SEVERNAYA_ZEMLYA = [
    (95.0, 78.0), (99.0, 78.2), (105.5, 78.7), (99.5, 79.7), (102.5, 80.6),
    (96.5, 81.2), (92.5, 80.2), (97.5, 79.4), (93.5, 78.8),
]
NEW_SIBERIAN = [
    (135.5, 74.0), (142.5, 73.8), (147.0, 74.8), (150.5, 74.9),
    (146.5, 75.7), (139.0, 75.2),
]
WRANGEL = [(-180.0, 70.8), (-177.5, 71.0), (-177.8, 71.5), (-180.0, 71.4)]
WRANGEL_W = [(178.5, 70.9), (180.0, 70.8), (180.0, 71.4), (179.0, 71.3)]

LANDMASSES = [
    EURASIA, CHUKOTKA_TIP, NORTH_AMERICA, BAFFIN, VICTORIA, BANKS,
    ELLESMERE_AXEL, DEVON_SOMERSET, MELVILLE_PARRY, GREENLAND, ICELAND,
    SVALBARD, FRANZ_JOSEF, NOVAYA_ZEMLYA, SEVERNAYA_ZEMLYA, NEW_SIBERIAN,
    WRANGEL, WRANGEL_W,
]


def _contains(poly: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Even-odd point-in-polygon test of points (x, y) against the closed
    polygon ``poly`` (n, 2): the crossings test of matplotlib's
    point_in_path (Haines), edge by edge in the same float64 arithmetic."""
    inside = np.zeros(x.shape, bool)
    vx0, vy0 = poly[-1]  # the closing edge, last vertex -> first
    yflag0 = vy0 >= y
    for vx1, vy1 in poly:
        yflag1 = vy1 >= y
        crosses = (yflag0 != yflag1) & (
            ((vy1 - y) * (vx0 - vx1) >= (vx1 - x) * (vy0 - vy1)) == yflag1
        )
        inside ^= crosses
        yflag0, vx0, vy0 = yflag1, vx1, vy1
    return inside


def land_mask(lon2: np.ndarray, lat2: np.ndarray) -> np.ndarray:
    """Rasterize the landmass polygons (True = land)."""
    x = np.asarray(lon2, np.float64).ravel()
    y = np.asarray(lat2, np.float64).ravel()
    land = np.zeros(x.size, bool)
    for poly in LANDMASSES:
        land |= _contains(np.asarray(poly, np.float64), x, y)
    return land.reshape(lon2.shape)


def build(dlat: float = 0.25, dlon: float = 0.5, seed: int = 0):
    """Return (lats, lons, z): elevation grid, positive up [m]."""
    lats = np.arange(50.0, 90.0 + 1e-9, dlat)
    lons = np.arange(-180.0, 180.0, dlon)
    lat2, lon2 = np.meshgrid(lats, lons, indexing="ij")
    land = land_mask(lon2, lat2)

    # coastline roughness: flip cells near the coast with lat/lon noise so
    # coasts are not polygon-straight at 10 km (stress concentrators)
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal(land.shape)
    from scipy import ndimage

    noise = ndimage.gaussian_filter(noise, sigma=2.0, mode="wrap")
    edge = ndimage.binary_dilation(land, iterations=2) & ~ndimage.binary_erosion(
        land, iterations=2
    )
    land = np.where(edge, noise > 0.0, land)

    # depth from distance-to-coast: shelf (~60 m at the coast) deepening to
    # a 4000 m central basin over ~600 km; land rises to ~400 m inland.
    # sampling ~ dlat*111 km per row; use the row-mean spacing as the metric
    km_per_cell = 111.0 * dlat
    d_ocean = ndimage.distance_transform_edt(~land) * km_per_cell
    d_land = ndimage.distance_transform_edt(land) * km_per_cell
    depth = 60.0 + (4000.0 - 60.0) * np.tanh(d_ocean / 400.0)
    z = np.where(land, 100.0 + 300.0 * np.tanh(d_land / 300.0), -depth)
    return lats, lons, z.astype(np.float32)


def write(path: str, dlat: float = 0.25, dlon: float = 0.5, seed: int = 0):
    from scipy.io import netcdf_file

    lats, lons, z = build(dlat, dlon, seed)
    with netcdf_file(path, "w", version=2) as nc:
        nc.history = (
            b"synthetic approximate-Arctic bathymetry "
            b"(benchmark/inputs/etopo.py) - NOT survey data"
        )
        nc.createDimension("lat", len(lats))
        nc.createDimension("lon", len(lons))
        nc.createVariable("lat", "f4", ("lat",))[:] = lats
        nc.createVariable("lon", "f4", ("lon",))[:] = lons
        nc.createVariable("z", "f4", ("lat", "lon"))[:] = z
    return path
