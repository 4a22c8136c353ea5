"""Cross-validation against reference (neXtSIM C++) output (the counterpart
of nextsim_tpu/validation/).

`ref_compare` reads the reference Exporter's {mesh,field}_*.bin/.dat pairs
(reference: core/src/exporter.cpp, exportResults fe.cpp:14111-14325),
interpolates the P0 element / P1 nodal triangle-mesh fields onto our
structured grid, and diffs them against a model run. See
docker/README.md for the recipe that produces reference output on any
machine with the reference's build dependencies.
"""

from nextsim_tpu_torch.validation.ref_compare import (  # noqa: F401
    RefSnapshot,
    TriLocator,
    build_matching_grid,
    compare_snapshot,
    list_snapshots,
    load_snapshot,
    snapshot_to_grid,
)
