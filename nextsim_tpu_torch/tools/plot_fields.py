"""Plot model output fields (the counterpart of tools/plot_fields.py) — the
analog of the reference's Matlab tooling (reference:
matlab/neXtSIM_bin_revert.m + resplot.m, which read the Exporter binary and
plot fields for eyeball validation).

Reads the port's npz snapshots, reference-format .bin/.dat pairs (through
nextsim_tpu_torch.output.ref_binary) or moorings NetCDF files, and writes
PNG maps. matplotlib is needed for the plot only, and is imported there.

Usage:
    python -m nextsim_tpu_torch.tools.plot_fields <field_XXX.npz | field_XXX.bin | Moorings_*.nc> [out.png]
"""

from __future__ import annotations

import os
import sys

import numpy as np

DEFAULT_FIELDS = ["conc", "thick", "damage", "speed"]


def load_any(path):
    if path.endswith(".npz"):
        with np.load(path) as z:
            data = {k: z[k] for k in z.files if k != "__meta__"}
    elif path.endswith(".bin") or path.endswith(".dat"):
        from nextsim_tpu_torch.output.ref_binary import read_file

        raw = read_file(path.rsplit(".", 1)[0])
        name_map = {"Concentration": "conc", "Thickness": "thick",
                    "Damage": "damage", "Snow": "snow_thick"}
        data = {}
        for k, v in raw.items():
            n = int(np.sqrt(v.size))
            if n * n == v.size:
                data[name_map.get(k, k)] = v.reshape(n, n)
        # velocity
        if "M_VT" in raw:
            m = raw["M_VT"]
            n = int(np.sqrt(m.size // 2))
            data["vt_u"] = m[: n * n].reshape(n, n)
            data["vt_v"] = m[n * n:].reshape(n, n)
    elif path.endswith(".nc"):
        from scipy.io import netcdf_file

        data = {}
        with netcdf_file(path, "r", mmap=False) as nc:
            for k, v in nc.variables.items():
                arr = np.asarray(v[:])
                if arr.ndim == 3:
                    data[k] = arr[-1].copy()  # last record
                elif arr.ndim == 2:
                    data[k] = arr.copy()
    else:
        raise ValueError(f"unknown file type: {path}")
    if "vt_u" in data and "speed" not in data:
        data["speed"] = np.hypot(data["vt_u"], data["vt_v"])
    if "siu" in data and "speed" not in data:
        data["speed"] = np.hypot(data["siu"], data["siv"])
    return data


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    path = argv[0]
    out = argv[1] if len(argv) > 1 else os.path.splitext(path)[0] + ".png"
    data = load_any(path)
    try:
        import matplotlib
    except ImportError:
        print("plot_fields: matplotlib is not installed; no plot written", file=sys.stderr)
        return 1
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    aliases = {"conc": ["conc", "sic"], "thick": ["thick", "sit"],
               "damage": ["damage"], "speed": ["speed"]}
    panels = []
    for want in DEFAULT_FIELDS:
        for k in aliases.get(want, [want]):
            if k in data:
                panels.append((want, data[k]))
                break
    fig, axes = plt.subplots(1, max(1, len(panels)), figsize=(4 * max(1, len(panels)), 4))
    axes = np.atleast_1d(axes)
    cmaps = {"conc": "Blues_r", "thick": "viridis", "damage": "inferno", "speed": "magma"}
    for ax, (name, arr) in zip(axes, panels):
        im = ax.imshow(np.squeeze(arr), origin="lower", cmap=cmaps.get(name))
        ax.set_title(name)
        fig.colorbar(im, ax=ax, shrink=0.8)
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    plt.close(fig)
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
