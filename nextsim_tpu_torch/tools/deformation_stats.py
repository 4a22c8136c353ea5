"""Sea-ice deformation statistics — the scientific validation channel (the
counterpart of tools/deformation_stats.py).

The reference's BBM rheology is validated against observed deformation-rate
scaling (Rampal et al. 2016; Olason et al. 2024): the PDFs of divergence,
shear and total deformation are heavy-tailed and multifractal in space. This
tool computes those statistics from a snapshot's velocity field.

Usage:
    python -m nextsim_tpu_torch.tools.deformation_stats <field_XXX.npz> [dx_meters]

Prints percentiles and a tail-exponent estimate as JSON and, where
matplotlib is installed, writes a PDF plot beside the snapshot.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

# one source of truth shared with validation/ref_compare.py's statistical channel
from nextsim_tpu_torch.validation.deformation import deformation_rates, stats


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    path = argv[0]
    dx = float(argv[1]) if len(argv) > 1 else 10e3
    with np.load(path) as data:
        u, v = np.asarray(data["vt_u"]), np.asarray(data["vt_v"])
        mask = (np.asarray(data["conc"]) > 0.15) if "conc" in data.files else None
    div, shear, total = deformation_rates(u, v, dx)
    result = {
        "divergence": stats(np.abs(div), mask),
        "shear": stats(shear, mask),
        "total": stats(total, mask),
    }
    print(json.dumps(result, indent=1))
    plot_pdf(total, mask, os.path.splitext(path)[0] + "_deformation.png")
    return result


def plot_pdf(total, mask, out: str):
    """The total deformation rate's PDF on log axes, as a PNG at ``out``;
    without matplotlib, a note on stderr and no file."""
    try:
        import matplotlib
    except ImportError:
        print("deformation_stats: matplotlib is not installed; no plot written", file=sys.stderr)
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    vals = (total[mask > 0.5] if mask is not None else total.ravel()) * 86400.0
    vals = vals[vals > 0]
    if not vals.size:
        return None
    fig, ax = plt.subplots(figsize=(5, 4))
    bins = np.logspace(np.log10(max(vals.min(), 1e-5)), np.log10(vals.max()), 40)
    ax.hist(vals, bins=bins, density=True)
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("total deformation rate [1/day]")
    ax.set_ylabel("PDF")
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    plt.close(fig)
    print(out)
    return out


if __name__ == "__main__":
    main()
