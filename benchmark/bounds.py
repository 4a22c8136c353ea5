"""The benchmark's yardstick for the substep kernel: operations and bytes of
one momentum substep loop, counted from shapes, and the H100's peaks.

A frozen copy of ``chip_smoke.py``'s ``SUBSTEP_OPS`` and ``kernel_bound_ms``,
with the plane lists it read from the program (``momentum_cuda.tile_planes``
and ``_STATE_USED``) written out here, so that the bound does not move when
the program changes what its kernel keeps on a tile. Operations: a division,
a square root, a clamp, a comparison or a selection counts as one, from the
rheology's equations as the kernel computes them (per cell, per node).
"""

from __future__ import annotations

#: operations of one substep (per cell, per node)
SUBSTEP_OPS = {"bbm": (97, 94), "evp": (51, 94), "mevp": (51, 94)}
#: of those, the operations with a float32 scalar operand (bfloat16 computes them in float32)
SUBSTEP_SCALAR_OPS = {"bbm": (28, 10), "evp": (15, 10), "mevp": (15, 10)}

#: published peaks of one H100 SXM (NVIDIA's data sheet; dense, no sparsity)
H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
H100_BF16_OPS_PER_S = 133.8e12  # bfloat16 outside the tensor cores (H100 white paper, SXM5)
H100_F64_OPS_PER_S = 34e12

_NODE = ("grad_ssh_u", "grad_ssh_v", "tau_ax", "tau_ay", "dte_over_mass_const", "beta_cor_const",
         "dom_cos", "dom_sin", "ocn_rot_x", "ocn_rot_y", "ocean_u", "ocean_v", "c_bu", "rlmass", "solve",
         "vtm_u", "vtm_v")
_STATE = ("vt_u", "vt_v", "ut_u", "ut_v", "sxx", "syy", "sxy", "damage")
#: the planes each rheology reads on a tile, and the state planes it updates
TILE_PLANES = {
    "bbm": _STATE + ("volume", "conc", "cohesion", "bbm_expC", "bbm_pmax", "bbm_heal", "bbm_rtd") + _NODE[:15],
    "evp": _STATE[:7] + ("volume", "thick", "evp_P") + _NODE[:15],
    "mevp": ("vt_u", "vt_v", "sxx", "syy", "sxy", "volume", "thick", "evp_P") + _NODE[:15] + ("vtm_u", "vtm_v"),
}
STATE_USED = {"bbm": _STATE, "evp": _STATE[:7], "mevp": ("vt_u", "vt_v", "sxx", "syy", "sxy")}
_ITEMSIZE = {"float64": 8, "float32": 4, "bfloat16": 2}


def _is_node(name: str) -> bool:
    return name.startswith(("vt", "ut")) or name in _NODE


def substep_ops(ny: int, nx: int, steps: int, dyn_type: str = "bbm", members: int = 1) -> int:
    """Operations of ``steps`` substeps of ``members`` members on an
    ``ny`` x ``nx`` grid of cells (``ny + 1`` x ``nx + 1`` nodes)."""
    per_cell, per_node = SUBSTEP_OPS[dyn_type]
    return members * steps * (per_cell * ny * nx + per_node * (ny + 1) * (nx + 1))


def kernel_bound_ms(ny: int, nx: int, steps: int, dtype: str = "float32", dyn_type: str = "bbm",
                    members: int = 1, shared=()) -> tuple:
    """The least time an H100 could take for one substep loop of ``members``
    members: (bound_ms, "bytes" or "operations", bytes_ms, operations_ms).
    Bytes: every plane the rheology reads once (a plane the members share,
    named in ``shared``, once for all) and every state plane it updates
    written once a member. Operations: ``substep_ops`` at the float64 rate
    for float64 and the float32 rate for float32; in bfloat16, the scalar
    operations at the float32 rate and the rest at the bfloat16 rate."""
    itemsize = _ITEMSIZE[dtype]
    cells, nodes = ny * nx, (ny + 1) * (nx + 1)
    moved = TILE_PLANES[dyn_type] + STATE_USED[dyn_type]
    n_bytes = itemsize * sum((nodes if _is_node(n) else cells) * (1 if n in shared else members) for n in moved)
    ops = substep_ops(ny, nx, steps, dyn_type, members)
    bytes_ms = 1e3 * n_bytes / H100_BYTES_PER_S
    if dtype == "bfloat16":
        scalar_cell, scalar_node = SUBSTEP_SCALAR_OPS[dyn_type]
        scalar_ops = members * steps * (scalar_cell * cells + scalar_node * nodes)
        ops_ms = 1e3 * (scalar_ops / H100_F32_OPS_PER_S + (ops - scalar_ops) / H100_BF16_OPS_PER_S)
    else:
        ops_ms = 1e3 * ops / (H100_F64_OPS_PER_S if dtype == "float64" else H100_F32_OPS_PER_S)
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms > ops_ms else "operations"), bytes_ms, ops_ms


#: the peak that a whole step's share is taken against, by the state's dtype
PEAK_OPS_PER_S = {"float32": H100_F32_OPS_PER_S, "float64": H100_F64_OPS_PER_S,
                  "bfloat16": H100_BF16_OPS_PER_S}
